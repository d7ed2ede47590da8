"""Drive the PyTorch/CUDA port on one CUDA card, check it, and time it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (or any
sm_90a card) and ``nvcc``. It imports nothing of JAX or of the JAX
package. Phases, each failing the run (non-zero exit, no result line) on
any error:

1. the card's name and power limit, and the CUDA version;
2. build every kernel source (one ``nvcc`` per source, all at once), then
   at the serving shape (4 lanes x 8 frames x 480x640) over {dcp, cap} x
   {topk 1, 4} x {f32, uint8, bf16} with refine, two cells without refine
   (one with gamma != 1) and two plateau cells (quantised uint8 frames
   whose t ties across the 2-D tiles, top-1 and top-4), each cell with an
   all-padding lane and a warm second batch chained on the first batch's
   carries: run the megakernel's tiled passes and the ten passes they
   replaced, every pass held against its plain PyTorch version on the
   card; the tiled sequence against the ten passes with max error 0 in J,
   t, a_seq and both carries; the whole against its plain version; then
   the same on seven small cells that take the tiled passes' other code
   paths (narrow and wide windows, 4-byte copies, tail tiles, gf_r >= 33,
   frames off a 16-byte boundary); and four cells at the tiles' limit of
   shared memory (He et al.'s gf_r = 60 on 480x640 frames, r = 37 and
   gf_r = 46 just over it, r = 36 with gf_r = 45 just within): the
   wrapper must run the ten passes where a halo does not fit a block and
   the tiled passes where it does;
3. serve 4 streams x 48 uint8 frames at 480x640 on 4 lanes through
   ``ElasticServer.serve_many`` with the fused config, then one stream
   through ``serve``, with the launch counters zeroed just before each path
   and read just after it; every tiled pass must have launched once per
   tick on each path, and no pass of the ten and no staged kernel;
4. aggregate fps of that ``serve_many`` over a longer window (4 streams x
   192 frames) whose sink only records the order, so phase 3's per-frame
   checks stay out of its wall;
5. time every pass of both sequences with CUDA events at the serving
   shape, beside its bound, its direct-sum floor, its plain version and
   the matching PyTorch call, the tiled passes also by device busy time;
   then the whole tiled megakernel and the ten passes in turns in this
   run, with their device busy time; print the tiled passes' blocks an SM;
6. the staged chain (the default ``kernel_mode="auto"``) at the serving
   shape, DCP, top-1, refine, over uint8, float32 and bfloat16 ingest and
   one uint8 cell with gamma != 1, each with an all-padding lane and two
   chained batches: every staged kernel call of the lane step held against
   its plain version on the same inputs; the whole step against the staged
   plain chain on the card; and, at float32 output, against the fused step
   (B1) on the same frames; neither step may make a synchronising CUDA
   call; then the atmospheric light (B6a) alone against its plain version
   with error 0 on ramp and plateau frames, 32 and 1 frames of 480x640 and
   32 of 481x643, float32 and bfloat16, each called twice in a row; then
   the window strips of the dark channel and box filter (B3a, B4) alone
   against their plain versions with max error 0 on the serving shape,
   481x643, r = 0, windows wider than the frame, frames off a 16-byte
   boundary, float32 and bfloat16, He et al.'s gf_r = 60 and r = 875
   through ``ops.box_filter_2d``, and both sides of the strips' radius
   limit, the launch counters showing the strips or the row window
   (``wide_launches``);
7. phases 3 and 4 again with the default config (staged): per tick one
   dark channel, six box filters, one atmospheric light, one recover and
   one state sync (``staged.merge_ema``: the candidates' EMA), and no
   megakernel pass; the aggregate fps over 4 streams x 192 frames;
8. time the four staged kernels as phase 5 does, with their device busy
   time and that of the PyTorch call (B3a and B4 also a call in a replayed
   CUDA graph, with their blocks an SM, B4 with its direct-sum floor, and
   their row window, the route past the strips' limit, by events), B6a
   and ``argmin`` + gather also a
   call in a replayed CUDA graph (their event time is the host's launch
   rate) and their device time with L2 flushed before each call
   (repeated calls find t in L2; the flush reads 512 MB), and the whole
   staged and fused lane steps back to back;
9. staged CAP and staged top-k at the serving shape: cells {cap, dcp} x
   {topk 1, 4} x {uint8, bfloat16}, held as phase 6 holds its cells (every
   staged kernel call against its plain version, the step against the
   staged plain chain and, at float32 output, against the fused step; no
   synchronising call); then the top-k atmospheric light alone on 8
   frames at k above one tile's pixels, up to H*W (ramp and all-ties t),
   against its plain version; then the min filter's strips (B3b) alone
   against the plain version with max error 0 and value for value against
   the row window they replaced, float32 and bfloat16, on CAP's depth at
   the serving shape, a plane with +-inf and +-0 at r in {0, 7, 20}, a
   batch off 16 bytes, a window wider than the frame, and both sides of
   the strips' radius limit (the row window past it, by shape); then the
   warp top-k (B6b) alone at k in {1, 2, 4, its limit 16, 17} on ramp,
   all-ties and signed-zero t, 32 x 480x640 and 4 x 481x643, float32 and
   bfloat16: bit-equal to the block rounds (its route past k = 16, chosen
   by k) and to the plain picks summed with the kernels' arithmetic, within
   tolerance of the plain version;
10. ``serve_many`` (and ``serve``) of 4 x 48 uint8 frames with
   ``DehazeConfig(algorithm="cap", topk=4, io_dtype="uint8")`` and the
   default ``kernel_mode``: per tick one min filter (its strips), six box
   filters, one top-k atmospheric light (the warp top-k), one recover, one
   state sync, and no row window, block rounds, dark channel, argmin
   atmospheric light or megakernel pass;
11. the fused transmission stage (B7a, B7b): at 4 x 8 x 480x640 with
   per-lane saved A, {dcp, cap} x {topk 1, 4} x {uint8, bfloat16,
   float32} with refine, one cell without refine and a plateau cell
   (t ties across the 2-D tiles): its tiled sequence and its ten passes,
   every pass against its plain version, the tiled sequence against the
   ten passes with max error 0 in t, t_min and cand, the wrapper's route
   from the launch counters, t and the candidates bit-equal to the
   megakernel's on the same frames and A; three wide-window cells (gf_r
   60 at 480x640 and r 37: the ten passes; r 36 with gf_r 45: the tiles)
   and ``transmission_tiled_fits`` against the library's at each limit;
   then the data-parallel sharded step on ``make_host_mesh(1, 1)`` (one
   rank, NCCL; the group is destroyed at the end of the phase), with the
   fused config: the frame-sharded step over 32 uint8 frames (B7a) and the
   lane-sharded step with ``lane_native=False`` over 4 x 8 frames (B7b),
   each two chained batches, held as the cells are, the step against the
   single-device fused step (t and J 2e-4, a_seq 1e-5), one tiled
   transmission sequence a step (four launches), one state sync and no
   other kernel, no synchronising call; then the same two steps with
   ``kernel_mode="pallas"``, their staged branch, two chained batches each,
   against the single-device staged steps (J and t 2e-4, a_seq 1e-5) and
   their t against the fused sharded steps' (2e-4), one masked min filter
   (B8a) and six masked box filters (B8b) a step, their strips, one state
   sync, and no other kernel, no synchronising call;
12. time the min filter's strips and the warp top-k beside the kernels
   they replaced (the row window, the block rounds) in turns (old, new,
   new, old), each with its device busy time, a call in a replayed CUDA
   graph and its blocks an SM, the top-k also with L2 flushed, beside the
   PyTorch call (also by device busy time and as a graph call); the
   staged CAP top-4 lane step back to back with its device busy time;
   both transmission stages' tiled sequence and ten passes in turns, with
   device busy time, bound, direct-sum floor and blocks an SM; and each
   tiled transmission pass alone;
13. spatial sharding on one rank: 32 uint8 frames at 480x640 cut into
   virtual n_h x n_w tilings {(2, 1), (1, 2), (2, 2)} (DCP top-1 and CAP
   top-4, r = 7, gf_r = 20, halo 47), each tile's halo-extended (pre-map,
   luma) planes sliced from the whole frame, zero and invalid past its
   edge, as the exchange delivers them; per tile the masked tiled
   sequence and the ten masked passes (B9), every pass against its plain
   pass, the tiled sequence against the ten with max error 0 in t, tk_t,
   tk_rgb and tk_idx and no NaN, the wrapper's route from the launch
   counters, the whole against its plain version; then the step's
   per-shard function (``spatial_shard_stage``: one halo stage) on every
   tile and the lists in rank order through the step's state sync
   (``staged.merge_ema``: the cross-shard merge and the EMA, the frames as
   one lane), held bit for bit against its plain version; the stitched t
   against the unsharded stage's (B7a) on the same frames within 2e-4, the
   lists' candidate through the cross-shard merge alone (B10) bit-equal to
   B7a's and within 1e-6 of B10's plain version; a plateau cell
   (quantised frames, (2, 2), top-4) and a packed bfloat16-plane cell
   (against B9's plain version); corner tiles without refine and of
   bfloat16 frames, and a halo too wide for the tiles (gf_r 46: the ten
   masked passes), and ``halo_tiled_fits`` against the library's at each
   limit; one B9 a tile (its tiled sequence) and one state sync a step (no
   B10), no synchronising call; the staged branch (``spatial_shard_stage(...,
   fused=False)``, ``kernel_mode="pallas"``) on the DCP top-1 and CAP
   top-4 2x2 cells: 4 B8a, 24 B8b and 1 state sync a step, no
   synchronising call, the stitched t within 2e-4 of the unsharded staged
   stage (the frame-sharded step's) on the same frames, the state sync
   bit-equal to its plain version, the lists' candidate through B10
   bit-equal to that stage's picks through B10; then B8a and B8b alone
   (the masked strips) against their plain versions with error 0 and
   against the row window they replaced, value for value: both corner
   tiles and an interior 4x4 tile (all valid), float32 and bfloat16,
   +-inf and NaN in the invalid pixels, r in {0, 2, 7, 20}, and both sides
   of each masked kind's strip limit (the row window past it, by shape);
   this measures no scaling;
14. time B9 on a corner tile of the 2x2 tiling and an interior tile of a
   4x4 one, tiled sequence and ten masked passes in turns, and each tiled
   halo pass alone; B8a and B8b on the corner tile, the masked strips and
   the row window in turns (old, new, new, old), as phase 12 times B3b;
   B10; the staged spatial tile stage on the corner tile with the masked
   strips and with the plain masked filters in turns, and its top-k
   candidates' sort alone;
15. the zero-copy overlapped serve tick on the fused and the default
   (staged) path: ``serve_many`` of phase 3's 4 x 48 uint8 frames with
   ``tick_overlap`` off and on, and of 3 streams of unequal lengths on 4
   lanes (an idle lane, partial batches), and ``serve`` of one stream at
   uint8 and at float32 (whose uploaded batches receive J), each
   overlapped run equal to its blocking run bit for bit (J and the final
   states), every tick overlapped, no skip or straggler, exact order, the
   launches a tick of phases 3 and 7; the overlapped ``serve_many``
   fetching fewer bytes where lanes hold padding; ``stage`` of 4 lanes
   plus ``tick`` making no synchronising call; a ``torch.profiler`` trace
   of 6 overlapped ticks with every frame H2D and J D2H of 1 MB or more on
   a stream other than the kernels' (the share of their time that runs
   beside a kernel printed); ``serve_many`` of 4 x 192 frames blocking,
   overlapped, overlapped, blocking (fps, ms a tick, loop phases, D2H
   bytes printed, not gated); and the serve CLI, ``REPRO_TICK_OVERLAP=1
   python -m repro_torch.launch.serve --resolution 480p --streams 4
   --lanes 4 --frames 64 --io-dtype uint8 --expect-overlap
   --fail-on-skipped``, which must exit 0;
16. the elastic serving tier on the fused and the default (staged) path,
   blocking and overlapped, at the serving config (4 streams' uint8
   480x640 frames, batch 8): an autoscaled ``serve_many`` (ladder (2, 4),
   cap 4, ``dwell_up=1``, ``dwell_down=2``) of a ramp of 7 streams (5 of
   48 frames, 2 of 192) bit-equal to a fixed 4-lane serve of the same
   streams (every J by its digest, the final states, the cursors), with 2
   or more switches, no warm failure, every frame once in order, no skip
   or straggler, the warm-ups on a thread other than the serve thread,
   and launches equal to (ticks + warm-up calls) x the launches a tick of
   phases 3 and 7; a rung switch (grow and shrink, the scheduler's own
   ``_maybe_autoscale`` over warmed adapters) making no synchronising
   call; deadline-aware eviction on 1 lane (a tardy stream of 96 frames
   whose deadline has passed, a waiter of 32, ``evict_tardy_after=2``):
   one eviction, three admissions, every frame once in order, the waiter
   done before the tardy stream's last frame, and the tardy stream's
   final state bit-equal to an uninterrupted serve's; the fleet (8
   streams of 48 frames on 2 hosts x 2 lanes, first-fit and hash) each
   bit-equal to a one-host serve on 2 lanes, no migration, a spillover
   under first-fit; then, printed and not gated, the aggregate fps of the
   autoscaled serve beside the fixed-cap serve and of the 2 x 2 fleet
   beside 1 x 4 in turns (fused, overlapped), the serve thread's seconds
   in each switch and each rung's warm-up seconds; and the serve CLI as
   two subprocesses that must exit 0, ``--resolution 480p --streams 6
   --lanes 4 --autoscale --ladder 2,4 --ramp --expect-switches 2
   --io-dtype uint8 --fail-on-skipped`` and ``--resolution 480p --streams
   8 --hosts 2 --lanes 4 --frames 32 --expect-spillover 1
   --fail-on-skipped``;
17. the state sync (``staged.cuda_merge_ema``, one kernel for the
   candidate rows' merge and the §3.3 EMA) alone against its plain
   version (``staged.plain_merge_ema``, the composition it replaced), both
   scan forms, period 8 and 1, max error 0 in a_seq and A and equal ids and
   flags, also with the state written in place: at the serving shape (4
   lanes x 8 frames, one row a frame; a warm lane with ids that skip, a
   cold lane behind padding frames, an all-padding lane), on phase 13's
   (2, 2) lists (DCP top-1, M = 4; CAP top-4, M = 16) as one lane of 32
   frames and as 4 lanes of 8, and on a 4 x 4 tiling's top-4 lists (M =
   64); then in turns (old, new, new, old) against the composition it
   replaced on the card (the PyTorch scan alone at the serving shape, B10
   and the scan on phase 13's lists), each by CUDA events, a call in a
   replayed CUDA graph and device busy time; and the staged DCP lane step
   back to back with the kernel and with the old composition, in turns,
   bit-equal, with its device kernels, copies and busy time a step. It
   runs right after phase 14: after phase 15's profiler trace of a
   threaded serve, later traces of a lone kernel come back empty or short;
18. frames over several batch axes, the single-rank path only: on a
   one-rank NCCL mesh of shape (1, 1, 1) ``("pod", "data", "model")``, the
   frame-sharded step with ``batch_axes=("pod", "data")``, fused and
   staged (``kernel_mode="pallas"``), without and with
   ``height_axis="model"``. Every axis has size 1 on one card, so the
   state sync gathers over one axis's group (no group over several axes
   is made, no block reordered) and no tile is cut: the check is that
   such a placement builds and runs the one-axis path. Two chained batches of 32 uint8 frames each,
   equal bit for bit to the one-axis step of phases 11 and 13 on
   ``make_host_mesh(1, 1)``, no synchronising call; ``ops.launch_count``
   of each step call equal to phase 11's launches a step, and of one
   fused and one staged ``serve_many`` tick (4 streams x 8 frames) equal
   to phases 3 and 7's launches a tick; ``ops.fused_dehaze_dcp`` bit-equal
   to ``ops.fused_dehaze(..., algorithm="dcp")`` on the card, and a
   nonzero ``frames_per_block`` refused; each multi-axis step's ms back to
   back beside the one-axis step's, in turns;
19. the tuning registry (``kernels.tuning``). Phases 2-18 run with no
   table (``REPRO_TORCH_KERNEL_TUNING`` names a path that does not
   exist), so they drive the default knobs as before. Every library
   variant of the megakernel (tile 32x64 or 64x32 x ``guided_ab``'s
   minimum blocks an SM 3 or 2, built with phase 2's builds) and both grid
   orders, bit-equal to the default on phase 2's 16 serving-shape cells
   (two chained batches, the plateau cells), the counters showing the
   tiled passes; each variant's shared-memory mirrors against its
   library's fits tests on both sides of the limits; B9's variants
   bit-equal on phase 13's corner tiles; B6a and B6b at every
   ``tile_pixels`` bit-equal on phase 6's and 9's frames; ``tuning
   --search --no-persist`` at the serving shapes, with fewer timed runs
   than the exhaustive sweep and no candidate skipped; ``--validate
   --require-kind <this card>`` on the committed
   ``results/kernel_tuning_torch.json``, and each of its entries for this
   card timed against the default knobs in turns, a replayed CUDA graph
   by the card's clock (``tuning.against_default``), failing where an entry is slower by more
   than the turns' spread; the serve CLI with
   ``REPRO_TUNE_REQUIRE_TABLE=1`` and an empty table exiting non-zero, and
   with ``--tune`` (its table in a temporary directory) exiting 0; a
   fused and a staged ``serve_many`` on that table running its winners
   (the statics the megakernel ran, the tiles the atmospheric light took)
   with no table lookup or read in a serve after the first; each
   candidate's ms beside the default's in turns (default, candidate,
   candidate, default) by CUDA events and a call in a replayed CUDA graph,
   printed, not gated;
20. the vision zoo's serving path, which no hand-written kernel runs
   (every conv, pool, norm, attention and matmul is a PyTorch op): for
   each of ``resnet-50``, ``convnext-b``, ``efficientnet-b7`` and
   ``vit-l16`` at its published ``config()`` (full width and depth, its
   published dtype), the params initialised on the card from a seed, and
   the ``serve_b1`` and ``serve_b128`` cells (``(B, 224, 224, 3)`` float32
   images from the port's ``ImageStream`` through ``prefetch_to_device``):
   logits of shape ``(B, 1000)``, finite; ms a forward by CUDA events (3
   warm-up and 10 timed calls on one batch), images/s, the peak of
   ``torch.cuda.max_memory_allocated`` less the bytes earlier phases
   hold, and the ms of the conv weights'
   relayout copies a forward (HWIO to the channels-last OIHW the
   convolution takes; timed alone). At the published dtype ``serve_b128``'s
   row 0 has ``serve_b1``'s top-1 on the same image. ``config(dtype=
   "float32")``'s ``serve_b1`` forward on the card (TF32 off) against the
   same params and image on the CPU within 1e-3 x max |logit|. ResNet-50's
   params saved with ``CheckpointManager`` and restored into a ``like`` on
   the card, bit-equal, with the save and restore seconds;
21. the training path and the LM family, which no hand-written kernel
   runs (every matmul, attention, norm, routing op and AdamW's update is a
   PyTorch op; TF32 off): each vision id's published ``config()`` trains
   4 steps (AdamW, the train CLI's schedule, warmup 1, lr 1e-3) on one
   repeated ``cls_224`` batch of 32 images (the published 256 is cut;
   ResNet-50 also at 256) from ``ImageStream`` through
   ``prefetch_to_device``: finite losses, ``opt.step`` 4, BatchNorm's
   running stats moved (ResNet-50, EfficientNet-B7); each LM id at its
   published widths, heads, ``d_ff``, vocab, experts, top-k and
   ``chunk_attn`` with its layers cut (llama3-8b, granite-20b and
   moonshot-v1-16b-a3b at 2, llama4-scout-17b-a16e at 1) trains 4 steps
   at lr 3e-4 (Llama 3's published peak) on one repeated batch of
   ``train_4k``'s 4096 tokens (batch 1 of 256): the first nll within 1.5
   of ln(vocab), step 1's lr 0, finite losses, the loss after step 4
   below step 2's; ms a step (CUDA events, steps 2-4), images or tokens a
   second and the peak of ``max_memory_allocated``. Then each LM id
   serves at batch 1 (llama3-8b, granite-20b, moonshot at 2 layers and a
   4096-token prompt; llama4-scout at 4 layers, layer 3 global, and a
   16384-token prompt, above its 8192-token chunk): ``make_prefill`` then
   16 greedy ``make_decode_step`` tokens, ``cache["pos"]`` the prompt plus
   16, finite logits, no synchronising call in a decode step (the sync
   debug mode); prefill ms and decode ms a token. At each LM id's and
   ResNet-50's ``smoke_config()`` (float32) one train step on the card
   against the same params and batch on the CPU: every leaf's update
   within 1e-4 x lr plus one float32 rounding, except where the gradient
   allows more (|g| under 1e-6, at most 0.1 % of the elements, or the
   two gradients, each within 1e-4 x its leaf's max |g|, apart by more
   than 1e-4 relative), counted; the LM's prefill plus a decode step
   within 1e-4 x max |logit|. Last ``repro_torch.launch.train.run`` with
   ``--device cuda --smoke`` for ``resnet-50`` and ``llama3-8b``: 3 steps
   checkpointed at step 3, then ``--steps 6`` printing "resumed from step
   3", its restored params and moments bit-equal to the saved ones,
   ``opt.step`` 3 after the restore and 6 at the end, finite losses;
22. the diffusion family (no kernel; TF32 off): DiT-L/2 and the
   SDXL-class U-Net at their published ``config()`` (bfloat16, remat,
   params from a seed on the card; latents, timesteps, labels and context
   from ``DiffusionStream`` through ``prefetch_to_device``, noise and the
   U-Net's pooled from a seeded generator on the card). Sampling:
   ``gen_fast`` (512 px, batch 16) all 4 DDIM steps and ``gen_1024``
   (batch 4) 5 of its 50, on the ``linspace(999, 1, steps + 1)`` ladder,
   classifier-free guidance doubling the rows: finite latents of the
   input's shape, no synchronising call in a sample step (the sync debug
   mode), ms a denoise step (CUDA events, steps after the first),
   denoise steps a second and the peak of ``max_memory_allocated``. Training:
   ``make_train_step(make_loss_fn(cfg), cosine_schedule(1e-4, 1, 4))``,
   4 steps on one repeated ``train_256`` batch (DiT at the published
   256, the U-Net at the cut batch of ``DIFF_TRAIN``) and the U-Net's
   ``train_1024`` (cut too): finite losses, ``opt.step`` 4, step 1's loss
   mean(noise^2) within 1e-3 relative (both models zero-init their output
   projection), the loss after step 4 below step 2's; ms a step, images a
   second, peak, enqueue, busy and kernels. At each ``smoke_config()``
   (float32, zero-init leaves filled from a seed; the U-Net's at
   ``ch=64``, so that its GroupNorms hold two channels a group or more
   and the timestep and pooled reach the output) the forward and one
   sample step on the card against the CPU within 1e-4 x max |out| and
   one train step's update by phase 21's rule, every leaf. Then
   ``examples/sample_dit_torch.py`` on the card. The cuts are printed in
   a ``cuts`` line, and the phase's seconds and the whole script's;
23. the LM's model axis, the dry run and a sharded train step (no
   kernel; each part in processes of its own, so no gloo or fake group
   meets the phases' NCCL group): (a) a one-rank run (float32, TF32 off,
   published widths with the layers cut: llama3-8b 2, moonshot 1 with
   its 64 experts, llama4-scout 4 with layer 3 global) writes its logits
   and caches, then two gloo ranks sharing the card on a (1 data, 2
   model) mesh, each drawing its param pieces in turn, run the same
   params and tokens: llama3's tensor-parallel forward of 256 tokens with
   ``seq_shard`` off and on and with ``embed_shard="dm"``, llama3's
   prefill of 4096 tokens and 8 decode tokens under ``decode_seq_shard``,
   moonshot's prefill of 512 (the expert all-to-all) and 8 decode tokens
   (the replicated body), llama4's prefill of one 8192-token chunk and 8
   decode tokens past it under ``decode_seq_shard`` (the window mask);
   the MoE ids at capacity factor E / k, so no token drops on either
   side; logits within 1e-4 x max |logit| and caches within 1e-5 of the
   one-rank run, decode ms a token at two ranks against one; (b) beside
   it, ``python -m repro_torch.launch.dryrun --both-meshes --force`` for
   llama4-scout ``long_500k`` (``decode_seq_shard``), moonshot
   ``train_4k``, unet-sdxl ``gen_fast``, resnet-50 ``cls_224`` and
   dehaze-dcp ``stream_2160p``, every record ok, ``--summary``'s rows
   printed; (c) llama3-8b's smoke config, one train step on two gloo ranks
   (data 2, model 1, ZeRO-1 moments) against one rank's step on the whole
   batch by phase 21's update rule; the phase's seconds;
24. print ``{"kernels": [...]}`` (each kernel's launches on the path it
   names: the megakernel's tiled passes on the fused serving path, the
   transmission stage's tiled passes on the sharded steps, the halo
   stage's on the spatial steps, B8a and B8b on the staged sharded and
   spatial steps, the state sync on the staged serving path (and its
   launches on every other path), and the ten passes, the staged kernels'
   routes past their limits, ``staged.wide.*``, and B10, which run on
   none of them at the serving shape; the fused and staged serving kernels also with their
   launches on phase 15's overlapped ``serve_many`` and on phase 16's
   overlapped autoscaled and first-fit fleet serves; the sharded steps'
   kernels also with their launches on phase 18's multi-axis steps; the
   knobs' kernels with their variants' launches and times in phase 19),
   the card line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
PEAK_F32_NONFMA_PER_S = 33.5e12  # the same, one add (not a fused multiply-add) a lane
L, B, H, W = 4, 8, 480, 640
SOURCE = "src/repro_torch/kernels/csrc/fused_dehaze.cu"
CFG_KW = dict(radius=7, omega=0.95, beta=1.0, gf_radius=20, gf_eps=1e-3,
              t0=0.1, gamma=1.0, period=8, lam=0.05)

STAGED_SOURCE = "src/repro_torch/kernels/csrc/staged.cu"

# The TPU kernel each staged kernel replaces (file:line).
STAGED_REPLACES = {
    "dark_channel": "src/repro/kernels/dark_channel.py:45",
    "min_filter": "src/repro/kernels/dark_channel.py:110",
    "box_filter": "src/repro/kernels/boxfilter.py:133",
    "atmolight": "src/repro/kernels/atmolight.py:92",
    "atmolight_topk": "src/repro/kernels/atmolight.py:146",
    "recover": "src/repro/kernels/recover.py:32",
}
# Launches a tick of each counter (names as :func:`all_launches` gives
# them) on each path; every counter not named launches no time.
STAGED_PER_TICK = {"staged.dark_channel": 1, "staged.box_filter": 6,
                   "staged.atmolight": 1, "staged.recover": 1,
                   "staged.merge_ema": 1}
CAP_PER_TICK = {"staged.min_filter": 1, "staged.box_filter": 6,
                "staged.atmolight_topk": 1, "staged.recover": 1,
                "staged.merge_ema": 1}

# The fused transmission stage of the sharded step (B7a and its lane form
# B7b): the TPU kernels it replaces.
TRANSMISSION_REPLACES = {
    "fused_transmission": "src/repro/kernels/fused.py:520",
    "fused_transmission_lanes": "src/repro/kernels/fused.py:566",
}

# The spatially sharded step's kernels (B8a, B8b, B10 in staged.cu, B9 the
# halo form of the transmission stage): the TPU kernels they replace.
SPATIAL_REPLACES = {
    "staged.masked_min_filter": "src/repro/kernels/dark_channel.py:87",
    "staged.masked_box_filter": "src/repro/kernels/boxfilter.py:106",
    "staged.merge_topk": "src/repro/kernels/atmolight.py:213",
    "fused_transmission_halo": "src/repro/kernels/fused.py:744",
}

# The state sync that ends every step but the lane-native megakernel's
# (staged.cu st_merge_ema): the cross-shard merge's TPU kernel and the two
# §3.3 scans of the JAX package (jnp ops, no Pallas kernel) it merges with.
MERGE_EMA_SOURCE = STAGED_SOURCE
MERGE_EMA_REPLACES = ("src/repro/kernels/atmolight.py:213; "
                      "src/repro/core/normalize.py:68,126")

# The part of the TPU kernels each tiled pass of the transmission stage and
# of its halo form replaces (file:line).
TILED_TRANSMISSION_REPLACES = {
    "tmap_tile": "src/repro/kernels/fused.py:163",
    "candidate": "src/repro/kernels/fused.py:166",
    "guided_ab": "src/repro/kernels/fused.py:126",
    "refine_tmap": "src/repro/kernels/fused.py:144",
}
TILED_HALO_REPLACES = {
    "tmap_tile": "src/repro/kernels/fused.py:658",
    "topk_block": "src/repro/kernels/fused.py:678",
    "topk_list": "src/repro/kernels/fused.py:678",
    "guided_ab": "src/repro/kernels/fused.py:618",
    "refine_tmap": "src/repro/kernels/fused.py:634",
}

# The part of the TPU kernel each pass replaces (file:line): the tiled
# passes of the megakernel, then the ten passes they replaced (the fused
# transmission stage's, and the tiled passes' comparator).
REPLACES = {
    "fused_dehaze_lanes": "src/repro/kernels/fused.py:353",
    "tmap_tile": "src/repro/kernels/fused.py:163",
    "select_ema": "src/repro/kernels/fused.py:180",
    "guided_ab": "src/repro/kernels/fused.py:126",
    "refine_recover": "src/repro/kernels/fused.py:243",
    "premap": "src/repro/kernels/fused.py:163",
    "min_rows": "src/repro/kernels/fused.py:164",
    "min_cols_tmap": "src/repro/kernels/fused.py:165",
    "topk_block": "src/repro/kernels/fused.py:166",
    "topk_merge": "src/repro/kernels/fused.py:173",
    "ema": "src/repro/kernels/fused.py:180",
    "box_rows4": "src/repro/kernels/fused.py:126",
    "box_cols_ab": "src/repro/kernels/fused.py:140",
    "box_rows2": "src/repro/kernels/fused.py:144",
    "recover": "src/repro/kernels/fused.py:243",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ramps(seed: int, n: int, h: int = H, w: int = W) -> np.ndarray:
    """n frames, each its own permutation ramp over its h*w pixels (a ramp
    over all frames at once would space levels near the float32 ulp), with
    channel scales (1.0, 0.9, 0.8)."""
    r = np.random.default_rng(seed)
    g = np.stack([(r.permutation(h * w).reshape(h, w) + 1.0) / (h * w + 1.0)
                  for _ in range(n)])
    return np.stack([g, 0.9 * g, 0.8 * g], axis=-1).astype(np.float32)


def to_wire(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    from repro_torch.kernels import ref
    if dtype == torch.uint8:
        return ref.quantize_frames(x, "uint8")
    return torch.from_numpy(x).to(dtype)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest absolute difference; 0 where the values are equal, so
    equal infinities count as no error (NaN where a NaN differs)."""
    if not a.numel():
        return 0.0
    a, b = a.float(), b.float()
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


def sync_err(got, want) -> float:
    """The state sync's outputs (a_seq, A, last_update, initialized): the
    largest error of the float tensors, inf where an integer or a flag
    differs."""
    return max(max_err(g, w) if g.dtype.is_floating_point
               else (0.0 if torch.equal(g, w) else float("inf"))
               for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# Phase 2: every pass and the whole against the plain version
# ---------------------------------------------------------------------------

PASS_TOL = {                      # pass -> (tolerance, relative to magnitude?)
    "premap": (0.0, False), "min_rows": (0.0, False),
    "min_cols_tmap": (0.0, False), "topk_block": (0.0, False),
    "topk_merge": (1e-6, False), "ema": (1e-6, False),
    "box_rows4": (1e-5, True), "box_cols_ab": (1e-3, False),
    "box_rows2": (1e-5, True), "recover": (1e-3, False),
    # The tiled passes: t_raw, g and the tile keys exact; the candidate and
    # the EMA as topk_merge and ema; a/b and J/t as box_cols_ab and recover.
    "tmap_tile": (0.0, False), "select_ema": (1e-6, False),
    "guided_ab": (1e-3, False), "refine_recover": (1e-3, False),
}


def pass_error(name: str, got, want, tols=PASS_TOL) -> float:
    """Max error of one pass's outputs (relative to max(1, |want|) for the
    window sums, whose magnitude grows with the window); integer outputs
    (keys) must be equal."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g is None:
            continue
        if not g.dtype.is_floating_point:
            err = max(err, 0.0 if torch.equal(g, w) else float("inf"))
            continue
        # Equal entries differ by 0, also where both are infinite (the
        # masked passes' invalid pixels).
        d = torch.where(g.float() == w.float(), 0.0, (g.float() - w.float()).abs())
        if tols[name][1]:
            d = d / w.float().abs().clamp_min(1.0)
        err = max(err, float(d.max()))
    return err


def checked_pass_dict(cuda, plain, tols, errs, label, view=None, seen=None):
    """``cuda``'s passes, each call also running its plain pass on the same
    inputs and holding the two to ``tols`` (t, J and the candidates stored
    in bfloat16 to 2e-2 and one bfloat16 step); the CUDA outputs go on.
    ``view(name, outputs)`` picks the part of them that is compared;
    ``seen`` keeps each pass's last outputs."""
    def checked(name):
        def run(*args):
            got = cuda[name](*args)
            want = plain[name](*args)
            a, b = (got, want) if view is None else (view(name, got), view(name, want))
            err = pass_error(name, a, b, tols)
            tol = tols[name][0]
            s = args[-1]
            if s.out_dtype == torch.bfloat16:
                if name in ("recover", "refine_recover", "tmap", "refine_tmap"):
                    tol = 2e-2
                elif name in ("candidate", "topk_list"):
                    tol = BF16_STEP
            check(err <= tol, f"pass {name} ({label}): error {err} > {tol}")
            errs[name] = max(errs.get(name, 0.0), err)
            if seen is not None:
                seen[name] = got
            return got
        return run
    return {name: checked(name) for name in cuda}


def checked_passes(s, errs):
    """Every pass of the megakernel's two sequences, held to PASS_TOL."""
    from repro_torch.kernels import fused as fk
    return checked_pass_dict(fk.CUDA_PASSES, fk.PLAIN_PASSES, PASS_TOL, errs,
                             f"{s.algorithm} k={s.topk} {s.in_dtype} refine={s.refine}")


def phase_parity():
    """Every phase-2 cell: the tiled sequence and the ten-pass sequence,
    each pass held against its plain pass; the tiled sequence against the
    ten passes (max error 0 in J, t, a_seq and both carries), against the
    wrapper and against the plain version of the whole."""
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import ref
    cells = [(alg, k, dt, True, 1.0, False)
             for alg in ("dcp", "cap") for k in (1, 4)
             for dt in (torch.float32, torch.uint8, torch.bfloat16)]
    # gamma != 1 without refine: the tone curve's slope near black turns a
    # refine-order difference of 1e-5 in J into 1e-2, while without refine
    # J is exact before the curve.
    cells += [("dcp", 1, torch.float32, False, 1.0, False),
              ("cap", 1, torch.uint8, False, 1.0 / 2.2, False)]
    # Plateaus: quantised frames whose t ties across the 2-D tiles, so the
    # top-1 merge must compare whole (t, index) keys, not tile numbers.
    cells += [("dcp", k, torch.uint8, True, 1.0, True) for k in (1, 4)]
    ramp = ramps(0, 2 * L * B).reshape(2, L, B, H, W, 3)
    plateau = plateau_frames(2 * L * B).reshape(2, L, B, H, W, 3)
    pass_errs = {}
    whole_errs = {"J_t": 0.0, "a_seq_carry": 0.0, "tiled_vs_ten_pass": 0.0}
    for alg, k, dt, refine, gamma, flat in cells:
        kw = dict(CFG_KW, algorithm=alg, topk=k, refine=refine, gamma=gamma)
        cf_k = cf_p = torch.ones(L, 3, device="cuda")
        ci_k = ci_p = torch.tensor([[-(2 ** 30), 0]] * L, dtype=torch.int32,
                                   device="cuda")
        frames = plateau if flat else ramp
        for batch in range(2):
            img = to_wire(frames[batch].reshape(-1, 3), dt).reshape(
                L, B, H, W, 3).cuda()
            ids = (torch.arange(B, dtype=torch.int32) + B * batch).repeat(L, 1)
            ids[L - 1] = -1                                   # padding lane
            ids = ids.cuda()
            s = fk.make_static(img, **kw)
            passes = checked_passes(s, pass_errs)
            got = fk.run_tiled_passes(img, ids, cf_k, ci_k, s, passes)
            ten = fk.run_passes(img, ids, cf_k, ci_k, s, passes)
            whole = fk.fused_dehaze_lanes(img, ids, cf_k, ci_k, **kw)
            torch.cuda.synchronize()
            want = ref.fused_dehaze_lanes(img, ids, cf_p, ci_p, **kw)
            cell = (f"{alg} k={k} {dt} refine={refine} gamma={gamma:.3f}"
                    f"{' plateau' if flat else ''} b{batch}")
            e_ten = max(max_err(g1, g2) for g1, g2 in zip(got, ten))
            check(e_ten == 0.0 and all(torch.equal(g1, g2)
                                       for g1, g2 in zip(got, ten)),
                  f"{cell}: tiled passes vs ten passes max error {e_ten}")
            for g1, g2 in zip(got, whole):                    # same kernels
                check(torch.equal(g1, g2), "pass chain != wrapper")
            e_jt = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
            e_a = max(max_err(got[2], want[2]), max_err(got[3], want[3]))
            tol = 2e-2 if dt == torch.bfloat16 else 1e-3
            check(e_jt <= tol, f"{cell}: J/t max error {e_jt} > {tol}")
            check(e_a <= 1e-5, f"{cell}: a_seq/carry max error {e_a} > 1e-5")
            check(torch.equal(got[4], want[4]),
                  f"{cell}: last_update/initialized differ")
            check(torch.equal(got[3][L - 1], cf_k[L - 1])
                  and torch.equal(got[4][L - 1], ci_k[L - 1]),
                  f"{cell}: the all-padding lane's carry changed")
            if not refine:
                check(torch.equal(got[1], want[1]),
                      f"{cell}: t differs without refine")
            whole_errs["J_t"] = max(whole_errs["J_t"], e_jt)
            whole_errs["a_seq_carry"] = max(whole_errs["a_seq_carry"], e_a)
            whole_errs["tiled_vs_ten_pass"] = max(
                whole_errs["tiled_vs_ten_pass"], e_ten)
            cf_k, ci_k, cf_p, ci_p = got[3], got[4], want[3], want[4]
        print(f"parity {alg} k={k} {str(dt):15s} refine={refine} "
              f"gamma={gamma:.3f}{' plateau' if flat else ''}: ok", flush=True)
    check_tiled_shapes(pass_errs, whole_errs)
    check_wide_windows(pass_errs, whole_errs)
    print("parity max errors: passes " + json.dumps(pass_errs)
          + " whole " + json.dumps(whole_errs), flush=True)
    return pass_errs, whole_errs


def check_tiled_shapes(pass_errs, whole_errs) -> None:
    """The tiled passes' other code paths, on 2 lanes x 2 frames: windows
    narrower than a register run (r = 0, 3; gf_r = 0, 4), 4-byte copies
    (frame widths off 4-float boundaries), tail tiles, windows wider than
    the frame, vertical sums that cannot overwrite their inputs (gf_r 33,
    40), and frames that do not start on a 16-byte boundary; each pass
    against its plain pass, the sequence against the ten passes (max
    error 0)."""
    from repro_torch.kernels import fused as fk
    # (algorithm, topk, dtype, r, gf_r, H, W, misaligned frames)
    cells = [("dcp", 1, torch.float32, 3, 4, 50, 70, False),
             ("cap", 4, torch.uint8, 0, 0, 50, 70, False),
             ("dcp", 1, torch.float32, 12, 25, 20, 30, False),
             ("dcp", 1, torch.uint8, 7, 40, 50, 70, False),
             ("dcp", 4, torch.bfloat16, 5, 33, 37, 131, False),
             ("dcp", 1, torch.uint8, 7, 20, 50, 70, True),
             ("cap", 1, torch.float32, 7, 20, 50, 70, True)]
    for alg, k, dt, r, gr, h, w, shifted in cells:
        x = to_wire(ramps(11, 4, h, w).reshape(-1, 3), dt).reshape(-1).cuda()
        if shifted:                  # one element past a 16-byte boundary
            buf = torch.empty(x.numel() + 1, dtype=dt, device="cuda")
            buf[1:] = x
            x = buf[1:]
        img = x.view(2, 2, h, w, 3)
        kw = dict(CFG_KW, radius=r, gf_radius=gr, algorithm=alg, topk=k,
                  refine=True)
        s = fk.make_static(img, **kw)
        ids = torch.arange(2, dtype=torch.int32, device="cuda").repeat(2, 1)
        cf = torch.ones(2, 3, device="cuda")
        ci = torch.tensor([[-(2 ** 30), 0]] * 2, dtype=torch.int32, device="cuda")
        passes = checked_passes(s, pass_errs)
        got = fk.run_tiled_passes(img, ids, cf, ci, s, passes)
        ten = fk.run_passes(img, ids, cf, ci, s, passes)
        torch.cuda.synchronize()
        e = max(max_err(g1, g2) for g1, g2 in zip(got, ten))
        check(e == 0.0 and all(torch.equal(g1, g2) for g1, g2 in zip(got, ten)),
              f"tiled vs ten passes, {alg} k={k} {dt} r={r} gf_r={gr} {h}x{w}"
              f"{' misaligned' if shifted else ''}: max error {e}")
        whole_errs["tiled_vs_ten_pass"] = max(whole_errs["tiled_vs_ten_pass"], e)
    print(f"tiled passes on {len(cells)} small cells (narrow and wide windows, "
          "4-byte copies, tails, no overwrite, misaligned frames): equal to "
          "the ten passes", flush=True)


def check_wide_windows(pass_errs, whole_errs) -> None:
    """Windows whose halo does not fit a tiled pass's block: the wrapper
    must run the ten passes (chosen from the shape, before any launch) and
    a tiled pass called alone must raise; at the widest windows that fit it
    runs the tiled passes. He et al.'s guided filter (gf_r = 60) on 2 x 2
    frames of 480x640, the first radius and gf_radius over the limit on
    small frames, and the largest that fit; every pass against its plain
    pass, the wrapper against the ten passes (max error 0) and against the
    plain version of the whole."""
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import ref
    # (algorithm, topk, dtype, r, gf_r, H, W, the tiled passes fit)
    cells = [("dcp", 1, torch.uint8, 7, 60, H, W, False),
             ("cap", 4, torch.float32, 37, 20, 50, 70, False),
             ("dcp", 1, torch.bfloat16, 3, 46, 50, 70, False),
             ("dcp", 1, torch.float32, 36, 45, 50, 70, True)]
    for alg, k, dt, r, gr, h, w, fits in cells:
        img = to_wire(ramps(12, 4, h, w).reshape(-1, 3), dt).reshape(
            2, 2, h, w, 3).cuda()
        kw = dict(CFG_KW, radius=r, gf_radius=gr, algorithm=alg, topk=k,
                  refine=True)
        s = fk.make_static(img, **kw)
        cell = f"{alg} k={k} {dt} r={r} gf_r={gr} {h}x{w}"
        check(fk.tiled_fits(s) == fits, f"{cell}: tiled_fits != {fits}")
        ids = torch.arange(2, dtype=torch.int32, device="cuda").repeat(2, 1)
        cf = torch.ones(2, 3, device="cuda")
        ci = torch.tensor([[-(2 ** 30), 0]] * 2, dtype=torch.int32, device="cuda")
        fk.reset_launches()
        got = fk.fused_dehaze_lanes(img, ids, cf, ci, **kw)
        torch.cuda.synchronize()
        ran = {n: c for n, c in fk.launches.items() if c}
        want_ran = (dict.fromkeys(fk.TILED_PASSES, 1) if fits else
                    dict.fromkeys(fk.PASSES, 1))
        if fits and k > 1:
            want_ran["topk_block"] = 1
        check(ran == want_ran, f"{cell}: launches {ran}, expected {want_ran}")
        ten = fk.run_passes(img, ids, cf, ci, s, checked_passes(s, pass_errs))
        torch.cuda.synchronize()
        e = max(max_err(g1, g2) for g1, g2 in zip(got, ten))
        check(e == 0.0 and all(torch.equal(g1, g2) for g1, g2 in zip(got, ten)),
              f"{cell}: wrapper vs ten passes max error {e}")
        want = ref.fused_dehaze_lanes(img, ids, cf, ci, **kw)
        e_jt = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        e_a = max(max_err(got[2], want[2]), max_err(got[3], want[3]))
        tol = 2e-2 if dt == torch.bfloat16 else 1e-3
        check(e_jt <= tol and e_a <= 1e-5 and torch.equal(got[4], want[4]),
              f"{cell}: against the plain version J/t {e_jt}, a_seq {e_a}")
        if not fits:
            try:
                t_raw, g, keys = fk.cuda_tmap_tile(img, cf, s)
                fk.cuda_guided_ab(g, t_raw, s)
            except RuntimeError:
                pass
            else:
                fail(f"{cell}: a tiled pass launched a halo that does not fit")
        whole_errs["J_t"] = max(whole_errs["J_t"], e_jt)
        whole_errs["a_seq_carry"] = max(whole_errs["a_seq_carry"], e_a)
    fk.reset_launches()
    print(f"wide windows on {len(cells)} cells (gf_r 60 at 480x640; r 37, "
          "gf_r 46 over the tiles' limit, r 36 + gf_r 45 within it): the "
          "wrapper ran the ten passes where the tiles do not fit, the tiled "
          "passes where they do, equal to the ten passes", flush=True)


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def reset_launches() -> None:
    from repro_torch.kernels import fused as fk, staged as sk
    fk.reset_launches()
    sk.reset_launches()


def all_launches() -> dict:
    """Every launch counter since the last reset: the megakernel's passes
    (and ``fused_dehaze_lanes``, its whole runs: its first pass's count),
    ``staged.<kernel>`` (and ``staged.wide.<kernel>``, the dark channel's
    and box filter's launches of the row window), ``fused_transmission.<pass>`` (and
    ``fused_transmission``, the stage's whole runs), and
    ``fused_transmission_halo.<pass>`` (and ``fused_transmission_halo``,
    the halo stage's whole runs)."""
    from repro_torch.kernels import fused as fk, ops, staged as sk
    counts = ops.launch_counters()
    counts["fused_dehaze_lanes"] = counts["tmap_tile"]
    counts.update({f"staged.wide.{k}": n for k, n in sk.wide_launches.items()})
    counts["fused_transmission"] = (fk.transmission_launches["tmap_tile"]
                                    + fk.transmission_launches["premap"])
    counts["fused_transmission_halo"] = (fk.halo_launches["tmap_tile"]
                                         + fk.halo_launches["min_rows"])
    return counts


def fused_per_tick() -> dict:
    """The serving config (top-1, refine): each tiled pass once a tick, and
    none of the ten passes."""
    from repro_torch.kernels import fused as fk
    return {name: 1 for name in ("fused_dehaze_lanes",) + fk.TILED_PASSES}


def transmission_per_tick() -> dict:
    """The sharded steps' config (top-1, refine): each pass of the tiled
    transmission sequence but ``topk_block`` once a step, none of the ten
    passes, and the state sync once."""
    return {f"fused_transmission.{name}": 1 for name in
            ("tmap_tile", "candidate", "guided_ab", "refine_tmap")} | {
                "fused_transmission": 1, "staged.merge_ema": 1}


def path_launches(path: str, ticks: int, per_tick: dict) -> dict:
    """The launch counts since the last reset, read just after ``path``
    ran ``ticks`` steps: each counter must show ``per_tick`` launches a
    step (0 for a counter ``per_tick`` does not name)."""
    counts = all_launches()
    for name, n in counts.items():
        want = per_tick.get(name, 0) * ticks
        check(want == 0 or n > 0,
              f"kernel {name} never launched on the {path} path")
        check(n == want, f"kernel {name}: {n} launches on the {path} "
              f"path of {ticks} steps, expected {want}")
    print(f"launches on {path} ({ticks} steps; every other counter 0): "
          + json.dumps({k: n for k, n in counts.items() if n}), flush=True)
    return counts


def phase_serve(cfg, vids, per_tick: dict, label: str = ""):
    from repro_torch.core import init_atmo_state
    from repro_torch.kernels import ref
    from repro_torch.stream import ElasticServer, StreamRequest
    n_frames = len(vids[0])
    lane0, order, bad = {}, {}, []

    def sink(sid, fid, frame):
        # Runs on monitor threads: record problems, the main thread fails.
        if tuple(frame.shape) != (H, W, 3) or frame.dtype != torch.float32:
            bad.append(f"{sid}:{fid} output {tuple(frame.shape)} {frame.dtype}")
        elif not (bool(torch.isfinite(frame).all())
                  and 0.0 <= float(frame.min()) and float(frame.max()) <= 1.0):
            bad.append(f"{sid}:{fid} output not finite in [0, 1]")
        order.setdefault(sid, []).append(fid)
        if sid == "cam0":
            lane0[fid] = frame

    srv = ElasticServer(cfg, batch=8, timeout_s=2.0)
    reset_launches()
    rep = srv.serve_many([StreamRequest(f"cam{i}", iter(v))
                          for i, v in enumerate(vids)], n_lanes=4, sink=sink)
    many = path_launches(label + "serve_many", rep.ticks, per_tick)
    check(not bad, "; ".join(bad[:5]))
    check(rep.skipped == 0, f"serve_many skipped {rep.skipped} frames")
    check(rep.frames == 4 * n_frames, f"serve_many served {rep.frames}")
    for i in range(4):
        check(order[f"cam{i}"] == list(range(n_frames)),
              f"cam{i}: frames not exactly once in order")

    single = {}
    solo = ElasticServer(cfg, batch=8, timeout_s=2.0)
    reset_launches()
    rep1 = solo.serve(iter(vids[0]), stream_id="cam0",
                      sink=lambda fid, f: single.setdefault(fid, f))
    one = path_launches(label + "serve", rep1.ticks, per_tick)
    check(rep1.skipped == 0 and sorted(single) == list(range(n_frames)),
          "serve: frames missing or skipped")
    e_single = max(max_err(single[f], lane0[f]) for f in range(n_frames))
    check(e_single <= 1e-5, f"serve vs serve_many lane: {e_single} > 1e-5")

    # The first batch of cam0 against the plain version from a fresh state.
    st = init_atmo_state("cuda")
    want = ref.fused_dehaze(
        torch.from_numpy(vids[0][:8]).cuda(), torch.arange(8, device="cuda",
                                                           dtype=torch.int32),
        st.A, st.last_update, st.initialized, algorithm=cfg.algorithm,
        radius=cfg.patch_radius, omega=cfg.omega, beta=cfg.beta,
        cap_w=(cfg.cap_w0, cfg.cap_w1, cfg.cap_w2), refine=cfg.refine,
        gf_radius=cfg.gf_radius, gf_eps=cfg.gf_eps, t0=cfg.t0,
        gamma=cfg.gamma, period=cfg.update_period, lam=cfg.lam,
        topk=cfg.topk)[0].cpu()
    e_ref = max(max_err(lane0[f], want[f]) for f in range(8))
    check(e_ref <= 1e-3, f"served frames vs plain version: {e_ref} > 1e-3")
    print(f"{label}serve_many (frames checked in the sink): {rep.frames} frames, "
          f"{rep.ticks} ticks, {rep.skipped} skipped, {rep.wall_s} s; "
          f"serve: {rep1.frames} frames, {rep1.wall_s} s; serve == lane "
          f"within {e_single}; vs plain {e_ref}", flush=True)
    return many, one, rep.ticks


# ---------------------------------------------------------------------------
# Phase 4: aggregate fps of the main path
# ---------------------------------------------------------------------------

def phase_throughput(cfg, vids, per_tick: dict, label: str = "",
                     repeats: int = 4, tick_overlap: bool = False):
    """``serve_many`` of 4 fresh streams, each its video ``repeats`` times
    over, with a sink that only records the order, on the blocking or
    (``tick_overlap``) the overlapped tick path. The step is the one phase
    3 (or 7, or 15) built and ran (the step cache is shared)."""
    from repro_torch.stream import ElasticServer, StreamRequest
    order = {}

    def sink(sid, fid, frame):
        order.setdefault(sid, []).append(fid)

    srv = ElasticServer(cfg, batch=8, timeout_s=2.0)
    n = repeats * len(vids[0])
    reset_launches()
    rep = srv.serve_many(
        [StreamRequest(f"tput{i}", itertools.chain.from_iterable([v] * repeats))
         for i, v in enumerate(vids)], n_lanes=4, sink=sink,
        tick_overlap=tick_overlap)
    path_launches(label + "serve_many (throughput)", rep.ticks, per_tick)
    check(rep.skipped == 0 and rep.frames == 4 * n,
          f"throughput serve: {rep.frames} frames, {rep.skipped} skipped")
    check(rep.overlap_ticks == (rep.ticks if tick_overlap else 0)
          and rep.stragglers == 0,
          f"throughput serve: {rep.overlap_ticks} of {rep.ticks} ticks "
          f"overlapped, {rep.stragglers} stragglers")
    for i in range(4):
        check(order[f"tput{i}"] == list(range(n)),
              f"tput{i}: frames not exactly once in order")
    print(f"{label}serve_many throughput"
          f"{' (overlap)' if tick_overlap else ''}: {rep.frames} frames, {rep.ticks} ticks, "
          f"{rep.wall_s} s, {rep.wall_s / rep.ticks * 1e3} ms per tick, "
          f"aggregate {rep.fps} fps, d2h {rep.d2h_bytes} bytes, "
          f"loop phases (s) " + json.dumps(rep.phases), flush=True)
    return rep


# ---------------------------------------------------------------------------
# Phase 5: times, bounds and yardsticks at the serving shape
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_busy_ms(fn, reps: int = 5):
    """Device time of ``fn`` a call: the durations of the kernels and
    copies a ``torch.profiler`` trace of ``reps`` calls shows, summed; None
    where the trace shows no device activity or the profiler fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    except Exception as e:       # a measurement only: report, go on
        print(f"device time not measured: {e!r}", flush=True)
        return None
    return us / reps / 1e3 if us else None


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of ``fn`` a call without the host: ``reps`` calls
    captured in one CUDA graph, the graph replayed between CUDA events
    (the gaps between its kernels included)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, reps=5, warmup=1) / reps


def flushed_busy_ms(fn, reps: int = 10):
    """Device time of ``fn``'s own kernels a call with its inputs out of
    L2: each call follows a read of a 512 MB buffer (ten times the H100's
    L2; a sum, which leaves L2 full of clean lines, none of them ``fn``'s
    and none dirty to write back while ``fn`` runs). From a
    ``torch.profiler`` trace, leaving out the kernels that a trace of the
    sum alone shows and the sum's reduction kernel by name (a trace of one
    kernel has come back empty late in a long run); None where the trace
    shows nothing or fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    junk = torch.zeros(128 << 20, dtype=torch.float32, device="cuda")

    def kernels(run):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return [(e.name, e.device_time_total) for e in prof.events()
                if e.device_type == DeviceType.CUDA]

    def calls():
        for _ in range(reps):
            junk.sum()
            fn()

    fn()
    torch.cuda.synchronize()
    try:
        flush = {name for name, _ in kernels(junk.sum)}
        us = sum(t for name, t in kernels(calls)
                 if name not in flush and "sum_functor" not in name)
    except Exception as e:       # a measurement only: report, go on
        print(f"device time not measured: {e!r}", flush=True)
        return None
    return us / reps / 1e3 if us else None


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def phase_times():
    """Every pass of both sequences at the serving config (DCP, top-1,
    refine, uint8 in, float32 out), then the whole tiled megakernel and the
    ten-pass sequence in turns (ten, tiled, tiled, ten), with their device
    busy time. ``bound_ms`` counts each input read once and each output
    written once, and the float32 operations of a sliding-window algorithm
    (O(1) per pixel per window pass) at the card's peak; ``floor_ms`` is
    the operations of the direct window sums the kernels keep (2r+1 terms
    an output a direction) over the non-FMA float32 rate."""
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import ref
    kw = dict(CFG_KW, algorithm="dcp", topk=1, refine=True)
    img = to_wire(ramps(2, L * B).reshape(-1, 3), torch.uint8).reshape(
        L, B, H, W, 3).cuda()
    ids = torch.arange(B, dtype=torch.int32).repeat(L, 1).cuda()
    cf = torch.ones(L, 3, device="cuda")
    ci = torch.tensor([[-(2 ** 30), 0]] * L, dtype=torch.int32, device="cuda")
    s = fk.make_static(img, **kw)
    C, P = fk.CUDA_PASSES, fk.PLAIN_PASSES
    pre, g = C["premap"](img, cf, s)
    rows = C["min_rows"](pre, s)
    t_raw = C["min_cols_tmap"](rows, s)
    keys = C["topk_block"](t_raw, s)
    cand = C["topk_merge"](keys, img, s)
    a_seq, cf2, ci2 = C["ema"](cand, ids, cf, ci, s)
    rows4 = C["box_rows4"](g, t_raw, s)
    ab = C["box_cols_ab"](rows4, s)
    rows2 = C["box_rows2"](ab, s)
    J, t = C["recover"](img, t_raw, g, rows2, a_seq, s)
    tt_raw, tg, tkeys = C["tmap_tile"](img, cf, s)
    ta_seq, tcf, tci = C["select_ema"](tkeys, img, ids, cf, ci, s)
    tab = C["guided_ab"](tg, tt_raw, s)
    tJ, tt = C["refine_recover"](img, tt_raw, tg, tab, ta_seq, s)
    npx = L * B * H * W
    k, kg = 2 * s.radius + 1, 2 * s.gf_radius + 1
    neg = (-pre)[:, None].contiguous()
    neg_rows = (-rows)[:, None].contiguous()
    planes4 = torch.stack([g, t_raw, g * t_raw, g * g], 1).contiguous()
    planes2 = ab.transpose(0, 1).contiguous()
    yard = {
        "min_rows": lambda: F.max_pool2d(neg, (k, 1), 1, (s.radius, 0)),
        "min_cols_tmap": lambda: F.max_pool2d(neg_rows, (1, k), 1, (0, s.radius)),
        "topk_block": lambda: torch.topk(t_raw.reshape(L * B, -1), 1,
                                         largest=False),
        "box_rows4": lambda: F.avg_pool2d(planes4, (kg, 1), 1, (s.gf_radius, 0),
                                          count_include_pad=False),
        "box_cols_ab": lambda: F.avg_pool2d(planes4, (1, kg), 1, (0, s.gf_radius),
                                            count_include_pad=False),
        "box_rows2": lambda: F.avg_pool2d(planes2, (kg, 1), 1, (s.gf_radius, 0),
                                          count_include_pad=False),
    }
    frames = 3 * L * B
    # name -> (args, bytes moved, sliding-window operations, direct-sum
    # operations)
    work = {
        "premap": ((img, cf), nbytes(img, pre, g), 10 * npx, 10 * npx),
        "min_rows": ((pre,), nbytes(pre, rows), 3 * npx, k * npx),
        "min_cols_tmap": ((rows,), nbytes(rows, t_raw), 5 * npx, (k + 2) * npx),
        "topk_block": ((t_raw,), nbytes(t_raw, keys), 4 * npx, 4 * npx),
        "topk_merge": ((keys, img), nbytes(keys, cand) + 3 * L * B * s.topk,
                       keys.numel(), keys.numel()),
        "ema": ((cand, ids, cf, ci), nbytes(cand, ids, cf, ci, a_seq, cf2, ci2),
                10 * frames, 10 * frames),
        "box_rows4": ((g, t_raw), nbytes(g, t_raw, rows4), 10 * npx,
                      (2 + 4 * kg) * npx),
        "box_cols_ab": ((rows4,), nbytes(rows4, ab), 20 * npx, (4 * kg + 12) * npx),
        "box_rows2": ((ab,), nbytes(ab, rows2), 4 * npx, 2 * kg * npx),
        "recover": ((img, t_raw, g, rows2, a_seq),
                    nbytes(img, g, rows2, a_seq, J, t), 24 * npx,
                    (2 * kg + 19) * npx),
        "tmap_tile": ((img, cf), nbytes(img, cf, tt_raw, tg, tkeys), 22 * npx,
                      (2 * k + 16) * npx),
        "select_ema": ((tkeys, img, ids, cf, ci),
                       nbytes(tkeys, ids, cf, ci, ta_seq, tcf, tci) + 3 * L * B * s.topk,
                       tkeys.numel() + 10 * frames, tkeys.numel() + 10 * frames),
        "guided_ab": ((tg, tt_raw), nbytes(tg, tt_raw, tab), 30 * npx,
                      (8 * kg + 14) * npx),
        "refine_recover": ((img, tt_raw, tg, tab, ta_seq),
                           nbytes(img, tg, tab, ta_seq, tJ, tt), 28 * npx,
                           (4 * kg + 19) * npx),
    }
    rows_out = {}
    for name, (args, nb, ops, direct) in work.items():
        ms = time_ms(lambda: C[name](*args, s))
        plain_ms = time_ms(lambda: P[name](*args, s), reps=5, warmup=1)
        lib = yard.get(name)
        rows_out[name] = dict(ms=ms, plain_ms=plain_ms,
                              library_ms=time_ms(lib) if lib else None,
                              device_busy_ms=(device_busy_ms(lambda: C[name](*args, s))
                                              if name in fk.TILED_PASSES else None),
                              bytes=nb, ops=ops, direct_ops=direct)
    whole_args = (img, ids, cf, ci)
    nb = nbytes(img, ids, cf, ci, J, t, a_seq, cf2, ci2)
    tiled = lambda: fk.fused_dehaze_lanes(*whole_args, **kw)   # noqa: E731
    ten = lambda: fk.run_passes(*whole_args, s)                # noqa: E731
    turns = [(name, time_ms(fn)) for name, fn in
             (("ten_pass", ten), ("tiled", tiled), ("tiled", tiled), ("ten_pass", ten))]
    mean = {n: sum(v for m, v in turns if m == n) / 2 for n in ("tiled", "ten_pass")}
    busy = {"tiled": device_busy_ms(tiled), "ten_pass": device_busy_ms(ten)}
    rows_out["fused_dehaze_lanes"] = dict(
        ms=mean["tiled"], device_busy_ms=busy["tiled"],
        plain_ms=time_ms(lambda: ref.fused_dehaze_lanes(*whole_args, **kw),
                         reps=3, warmup=1),
        library_ms=None, bytes=nb,
        ops=sum(work[n][2] for n in fk.TILED_PASSES),
        direct_ops=sum(work[n][3] for n in fk.TILED_PASSES),
        ten_pass_ms=mean["ten_pass"], ten_pass_busy_ms=busy["ten_pass"],
        turns_ms=[v for _, v in turns])
    for r in rows_out.values():
        t_bytes = r["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = r["ops"] / PEAK_F32_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["floor_ms"] = r["direct_ops"] / PEAK_F32_NONFMA_PER_S * 1e3
    print("tiled passes, blocks an SM (tmap_tile, guided_ab, refine_recover): "
          f"{list(fk.tiled_occupancy(s))}", flush=True)
    print("megakernel passes at the serving shape (ms, device busy ms, bound "
          "ms, direct-sum floor ms):", flush=True)
    for name, r in rows_out.items():
        print(f"  {name:20s} {r['ms']:9.4f}  "
              f"{'-' if r['device_busy_ms'] is None else '%.4f' % r['device_busy_ms']:>8s}  "
              f"{r['bound_ms']:8.4f}  {r['floor_ms']:8.4f}", flush=True)
    whole = rows_out["fused_dehaze_lanes"]
    print(f"whole megakernel, turns (ten, tiled, tiled, ten) {whole['turns_ms']} "
          f"ms: tiled {whole['ms']} ms (device busy {whole['device_busy_ms']}), "
          f"ten passes {whole['ten_pass_ms']} ms (device busy "
          f"{whole['ten_pass_busy_ms']})", flush=True)
    check(whole["ms"] <= whole["ten_pass_ms"],
          f"tiled megakernel {whole['ms']} ms slower than the ten passes "
          f"{whole['ten_pass_ms']} ms")
    return rows_out


# ---------------------------------------------------------------------------
# Phase 6: the staged chain (kernel_mode "auto") against its plain versions
# and against the fused step
# ---------------------------------------------------------------------------

BF16_STEP = 2.0 ** -8             # one bfloat16 step for values in [0.5, 1)


def staged_tolerance(name: str, args) -> float:
    """Kernel against plain version: selections bit-equal; the box
    filter's means bit-equal too (the plain version adds the kernel's terms
    in the kernel's order); the state sync bit-equal (its EMA rounds each
    product and sum as PyTorch's ops do, and one row a frame passes
    through); the top-k mean 1e-6 in float32 for any k (the
    kernel's compensated float32 sum and the plain float64 mean are each
    within a few float32 steps of the exact mean), one bfloat16 step in
    bfloat16; recover 1e-6 in float32 at gamma 1 (1e-5 through powf), one
    bfloat16 step in bfloat16."""
    if name in ("dark_channel", "min_filter", "box_filter", "atmolight",
                "merge_ema"):
        return 0.0
    if args[0].dtype == torch.bfloat16:
        return BF16_STEP
    if name == "atmolight_topk":
        return 1e-6
    return 1e-6 if args[4] == 1.0 else 1e-5


def run_staged(step, frames, ids, state, ops: str, errs=None, cell=""):
    """One staged step with the staged ops routed to ``ops``: "plain"
    (the plain versions, on the card) or "checked" (each call runs the
    kernel and its plain version on the same inputs, holds them to
    :func:`staged_tolerance` and returns the kernel's result)."""
    from repro_torch.kernels import staged as sk
    names = sk.KERNELS + sk.STATE_KERNELS
    saved = {name: getattr(sk, f"{name}_op") for name in names}

    def checked(name):
        kernel, plain = sk.PAIRS[name]

        def op(*args):
            got = kernel(*args)
            want = plain(*args)
            err = (sync_err(got, want) if isinstance(got, tuple)
                   else max_err(got, want))
            tol = staged_tolerance(name, args)
            check(err <= tol, f"staged {name} ({cell}): error {err} > {tol}")
            errs[name] = max(errs.get(name, 0.0), err)
            return got
        return op

    try:
        for name in names:
            if ops == "plain":
                setattr(sk, f"{name}_op", sk.PAIRS[name][1])
            elif ops == "checked":
                setattr(sk, f"{name}_op", checked(name))
        return step(frames, ids, state)
    finally:
        for name, fn in saved.items():
            setattr(sk, f"{name}_op", fn)


# Phase 6's cells (DCP, top-1) and phase 9's: (algorithm, topk, dtype, gamma).
STAGED_CELLS = [("dcp", 1, torch.uint8, 1.0), ("dcp", 1, torch.float32, 1.0),
                ("dcp", 1, torch.bfloat16, 1.0), ("dcp", 1, torch.uint8, 1.0 / 2.2)]
CAP_TOPK_CELLS = [(alg, k, dt, 1.0) for alg in ("cap", "dcp") for k in (1, 4)
                  for dt in (torch.uint8, torch.bfloat16)]


def phase_staged_parity(cells, label: str = "staged"):
    """The staged lane step at the serving shape with refine, each cell two
    chained batches with an all-padding lane."""
    from repro_torch.core import (DehazeConfig, init_atmo_state_lanes,
                                  make_multi_stream_step)
    frames = ramps(3, 2 * L * B).reshape(2, L, B, H, W, 3)
    errs, whole = {}, {"vs_plain_J_t": 0.0, "vs_plain_a_seq": 0.0,
                       "vs_fused_J_t": 0.0, "vs_fused_a_seq": 0.0}
    for alg, k, dt, gamma in cells:
        io = str(dt).replace("torch.", "")
        kw = dict(algorithm=alg, topk=k, io_dtype=io, gamma=gamma)
        step = make_multi_stream_step(DehazeConfig(**kw), device="cuda")
        fused_step = make_multi_stream_step(
            DehazeConfig(kernel_mode="fused", **kw), device="cuda")
        states = {s: init_atmo_state_lanes(L, "cuda")
                  for s in ("kernel", "plain", "fused")}
        for batch in range(2):
            cell = f"{alg} k={k} {io} gamma={gamma:.3f} b{batch}"
            img = to_wire(frames[batch].reshape(-1, 3), dt).reshape(
                L, B, H, W, 3).cuda()
            ids = (torch.arange(B, dtype=torch.int32) + B * batch).repeat(L, 1)
            ids[L - 1] = -1                                   # padding lane
            ids = ids.cuda()
            got = run_staged(step, img, ids, states["kernel"], "checked",
                             errs, cell)
            torch.cuda.synchronize()
            plain = run_staged(step, img, ids, states["plain"], "plain")
            fused = fused_step(img, ids, states["fused"])
            torch.cuda.synchronize()
            bf16 = got.frames.dtype == torch.bfloat16
            e_jt = max(max_err(got.frames, plain.frames),
                       max_err(got.transmission, plain.transmission))
            e_a = max(max_err(got.atmo_light, plain.atmo_light),
                      max_err(got.state.A, plain.state.A))
            tol = 2e-2 if bf16 else 1e-3
            check(e_jt <= tol, f"staged {cell}: J/t vs plain chain {e_jt} > {tol}")
            check(e_a <= (2e-2 if bf16 else 1e-5),
                  f"staged {cell}: a_seq/A vs plain chain {e_a}")
            check(torch.equal(got.state.last_update, plain.state.last_update)
                  and torch.equal(got.state.initialized,
                                  plain.state.initialized),
                  f"staged {cell}: last_update/initialized differ")
            check(torch.equal(got.state.A[L - 1], states["kernel"].A[L - 1])
                  and not bool(got.state.initialized[L - 1]),
                  f"staged {cell}: the all-padding lane's state changed")
            whole["vs_plain_J_t"] = max(whole["vs_plain_J_t"], e_jt)
            whole["vs_plain_a_seq"] = max(whole["vs_plain_a_seq"], e_a)
            if not bf16:                 # the fused step, at float32 output
                f_jt = max(max_err(got.frames, fused.frames),
                           max_err(got.transmission, fused.transmission))
                f_a = max(max_err(got.atmo_light, fused.atmo_light),
                          max_err(got.state.A, fused.state.A))
                check(f_jt <= 1e-3, f"staged {cell}: J/t vs fused {f_jt} > 1e-3")
                check(f_a <= 1e-5, f"staged {cell}: a_seq vs fused {f_a} > 1e-5")
                check(torch.equal(got.state.last_update,
                                  fused.state.last_update),
                      f"staged {cell}: last_update differs from fused")
                whole["vs_fused_J_t"] = max(whole["vs_fused_J_t"], f_jt)
                whole["vs_fused_a_seq"] = max(whole["vs_fused_a_seq"], f_a)
            states = {"kernel": got.state, "plain": plain.state,
                      "fused": fused.state}
        print(f"{label} parity {alg} k={k} {io} gamma={gamma:.3f}: ok", flush=True)
        check_no_sync(step, img, ids, states["kernel"], f"staged {alg} k={k} {io}")
        check_no_sync(fused_step, img, ids, states["fused"], f"fused {alg} k={k} {io}")
    print(f"{label} parity max errors: kernels " + json.dumps(errs)
          + " whole " + json.dumps(whole), flush=True)
    return errs, whole


def check_large_topk(errs) -> None:
    """The top-k atmospheric light at k above one tile's pixels, where the
    merge exhausts whole tile lists, up to k = H*W: 8 frames, ramp and
    all-ties t, float32 and bfloat16, against the plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import staged as sk
    n = 8
    u8 = to_wire(ramps(5, n).reshape(-1, 3), torch.uint8).reshape(n, H, W, 3)
    x = ref.upcast_frames(u8).cuda()
    ramp_t = 1.0 - 0.95 * sk.cuda_dark_channel(x, 7)
    cases = [(x, t, k) for t in (ramp_t, torch.full_like(ramp_t, 0.375))
             for k in (sk.TOPK_TILE + 1, 5000, H * W)]
    cases.append((x.bfloat16(), ramp_t.bfloat16(), sk.TOPK_TILE + 1))
    for args in cases:
        got = sk.cuda_atmolight_topk(*args)
        torch.cuda.synchronize()
        want = sk.plain_atmolight_topk(*args)
        err = max_err(got, want)
        tol = staged_tolerance("atmolight_topk", args)
        check(err <= tol, f"staged atmolight_topk k={args[2]} "
              f"{args[0].dtype}: error {err} > {tol}")
        errs["wide.atmolight_topk"] = max(errs.get("wide.atmolight_topk", 0.0), err)
    print("staged atmolight_topk (block rounds) at k up to H*W: ok, max error "
          f"{errs['wide.atmolight_topk']}", flush=True)


def check_min_strips(errs) -> None:
    """The min filter's strips (B3b) alone against the plain version with
    max error 0, and against the row window (``window_kernel``, the
    kernel they replaced) value for value, float32 and bfloat16: CAP's
    depth at the serving shape (r = 7), a plane with +inf, -inf, -0.0 and
    +0.0 at 481x643 (tail strips and bands) at r in {0, 7, 20}, a batch off
    a 16-byte boundary, a window wider than a 17x13 frame, and both sides of
    the strips' radius limit (the row window past it, chosen by shape)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import staged as sk
    rng = np.random.default_rng(14)
    u8 = to_wire(ramps(15, L * B).reshape(-1, 3), torch.uint8).reshape(L * B, H, W, 3)
    depth = ref.cap_depth(ref.upcast_frames(u8).cuda(), *ref.CAP_COEFFS)

    def plane(shape, dt):
        v = rng.standard_normal(shape, dtype=np.float32)
        flat = v.reshape(-1)
        for value in (np.inf, -np.inf, -0.0, 0.0):    # scattered specials
            flat[rng.choice(flat.size, flat.size // 97, replace=False)] = value
        return torch.from_numpy(v).to(dt).cuda()

    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).replace("torch.", "")
        cases = [(depth.to(dt), 7, f"CAP depth serving {tag}")]
        special = plane((4, 481, 643), dt)
        cases += [(special, r, f"+-inf, +-0 481x643 {tag}") for r in (0, 7, 20)]
        cases += [(plane((5, 481, 643), dt)[1:], 7, f"off 16 B 481x643 {tag}"),
                  (plane((3, 17, 13), dt), 12, f"wider than 17x13 {tag}")]
        cases += [(plane((2, 400, 300), dt), r, f"limit {r} {tag}")
                  for r in strip_limit_radii("min_filter", dt)]
        for x, r, label in cases:
            check_window_route("min_filter", sk.cuda_min_filter, x, r, label, errs)
            if sk.strips_fit("min_filter", r, dt):
                got, old = sk.cuda_min_filter(x, r), wide_route("min_filter", x, r)
                check(torch.equal(got, old), f"min filter strips {label} r={r}: "
                      "differ from the row window")
    reset_launches()


def plain_topk_compensated(img: torch.Tensor, t: torch.Tensor, k: int) -> torch.Tensor:
    """The top-k light with the kernels' arithmetic: the plain picks
    (``staged.topk_select``, a sort of every key), their rgb summed in
    ascending key order with Neumaier's compensation in float32 (one
    PyTorch operation a step, no contraction), divided by a k tensor (a
    scalar divisor may become a reciprocal multiply) and cast once; equal
    to the kernels bit for bit."""
    from repro_torch.kernels import staged as sk
    n = img.shape[0]
    idx = sk.key_index(sk.topk_select(t, k))
    px = torch.gather(img.float().reshape(n, -1, 3), 1, idx[..., None].expand(n, k, 3))
    s = torch.zeros(n, 3, device=img.device)
    c = torch.zeros_like(s)
    for j in range(k):
        x = px[:, j]
        total = s + x
        lost = torch.where(s.abs() >= x.abs(), (s - total) + x, (x - total) + s)
        c = c + lost
        s = total
    return ((s + c) / torch.full_like(s, float(k))).to(img.dtype)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


def check_warp_topk(errs) -> None:
    """The warp top-k (B6b) alone: bit-equal to the block rounds (the
    kernels it replaced, its route past its limit) and to the plain picks
    with the kernels' arithmetic (:func:`plain_topk_compensated`), and
    within tolerance of the plain version, at k in {1, 2, 4, its limit,
    limit + 1} on ramp, all-ties and signed-zero t (half the pixels -0.0 or
    +0.0), 32 frames of 480x640 and 4 of 481x643 (no whole number of
    tiles), float32 and bfloat16; the launch counters show the route."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import staged as sk
    rng = np.random.default_rng(16)
    limit = sk.WARP_TOPK_MAX
    for n, h, w in ((L * B, H, W), (4, 481, 643)):
        u8 = to_wire(ramps(17, n, h, w).reshape(-1, 3), torch.uint8).reshape(n, h, w, 3)
        x = ref.upcast_frames(u8).cuda()
        ramp_t = 1.0 - 0.95 * sk.cuda_dark_channel(x, 7)
        zeros = torch.from_numpy(rng.random((n, h, w)) < 0.5).cuda()
        signs = torch.from_numpy(rng.random((n, h, w)) < 0.5).cuda()
        signed_zero = torch.where(zeros, torch.where(signs, -0.0, 0.0), ramp_t)
        for label, t in (("ramp", ramp_t), ("ties", torch.full_like(ramp_t, 0.375)),
                         ("signed zeros", signed_zero)):
            for dt in (torch.float32, torch.bfloat16):
                xd, td = x.to(dt), t.to(dt)
                for k in (1, 2, 4, limit, limit + 1):
                    cell = f"{n}x{h}x{w} {label} {dt} k={k}"
                    reset_launches()
                    got = sk.cuda_atmolight_topk(xd, td, k)
                    torch.cuda.synchronize()
                    wide = k > limit
                    check(sk.launches["atmolight_topk"] == 1
                          and sk.wide_launches["atmolight_topk"] == int(wide),
                          f"staged atmolight_topk {cell}: route not picked by k")
                    old = sk._atmolight_topk(xd, td, k, wide=True)
                    exact = plain_topk_compensated(xd, td, k)
                    check(torch.equal(bits(got), bits(old)) and torch.equal(bits(got), bits(exact)),
                          f"staged atmolight_topk {cell}: not bit-equal to the block "
                          f"rounds ({max_err(got, old)}) or the compensated plain picks "
                          f"({max_err(got, exact)})")
                    want = sk.plain_atmolight_topk(xd, td, k)
                    err = max_err(got, want)
                    tol = staged_tolerance("atmolight_topk", (xd, td, k))
                    check(err <= tol, f"staged atmolight_topk {cell}: error {err} > {tol}")
                    key = "wide.atmolight_topk" if wide else "atmolight_topk"
                    errs[key] = max(errs.get(key, 0.0), err)
        print(f"staged atmolight_topk {n}x{h}x{w}: the warp top-k (k <= {limit}) and the "
              "block rounds bit-equal to each other and to the compensated plain picks",
              flush=True)
    reset_launches()


def check_atmolight(errs) -> None:
    """B6a alone against its plain version, error 0: ramp and plateau
    frames (uint8-quantised, upcast, t from the dark channel), 32 and 1
    frames of 480x640 and 32 of 481x643 (P not a multiple of the tile),
    float32 and bfloat16, each called twice in a row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import staged as sk
    for n, h, w in ((L * B, H, W), (1, H, W), (L * B, 481, 643)):
        for label, x_np in (("ramp", ramps(10, n, h, w)),
                            ("plateau", plateau_frames(n, h, w))):
            x = ref.upcast_frames(to_wire(x_np.reshape(-1, 3), torch.uint8)).reshape(
                n, h, w, 3).cuda()
            t = 1.0 - 0.95 * sk.cuda_dark_channel(x, 7)
            for dt in (torch.float32, torch.bfloat16):
                xd, td = x.to(dt), t.to(dt)
                first, second = sk.cuda_atmolight(xd, td), sk.cuda_atmolight(xd, td)
                torch.cuda.synchronize()
                want = sk.plain_atmolight(xd, td)
                err = max(max_err(first, want), max_err(second, want))
                check(err == 0.0 and torch.equal(first, want) and torch.equal(second, want),
                      f"staged atmolight {n}x{h}x{w} {label} {dt}: error {err}")
                errs["atmolight"] = max(errs.get("atmolight", 0.0), err)
    print("staged atmolight (B6a) alone, 32 and 1 frames of 480x640 and 32 "
          "of 481x643, ramp and plateau, float32 and bfloat16, twice each: "
          "error 0", flush=True)


def check_strips(errs) -> None:
    """The window strips of the dark channel and the box filter (B3a, B4)
    alone against their plain versions with max error 0, float32 and
    bfloat16: the serving shape (32 frames of 480x640, r = 7 and gf_r =
    20), 481x643 (tail strips and bands), r = 0, windows wider than a 17x13
    frame, frames off a 16-byte boundary (a batch sliced from its second
    frame), He et al.'s gf_r = 60 on 480x640 and the largest radius the
    row window takes (875 on 1816 rows) through ``ops.box_filter_2d``, and
    both sides of the strips' radius limit. The launch counters, zeroed
    before each call, show which kernel ran: the strips where
    ``strips_fit``, the row window (``wide_launches``) past it; the C
    library's ``st_strips_fit`` agrees with ``strips_fit`` at each limit."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import staged as sk
    rng = np.random.default_rng(12)

    def plane(shape, dt):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dt).cuda()

    def frames(shape, dt):
        n, h, w = shape
        return torch.from_numpy(ramps(13, n, h, w)).to(dt).cuda()

    # (dark?, input, radius, via ops?, label)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).replace("torch.", "")
        for shape, label in (((L * B, H, W), "serving"), ((4, 481, 643), "481x643")):
            cases += [(False, plane(shape, dt), 20, False, f"{label} {tag}"),
                      (True, frames(shape, dt), 7, False, f"{label} {tag}")]
        cases += [(False, plane((4, 481, 643), dt), 0, False, f"r=0 {tag}"),
                  (True, frames((4, 481, 643), dt), 0, False, f"r=0 {tag}"),
                  (False, plane((3, 17, 13), dt), 12, False, f"wider than 17x13 {tag}"),
                  (True, frames((3, 17, 13), dt), 12, False, f"wider than 17x13 {tag}"),
                  (False, plane((5, 17, 13), dt)[1:], 3, False, f"off 16 B 17x13 {tag}"),
                  (True, frames((5, 17, 13), dt)[1:], 3, False, f"off 16 B 17x13 {tag}"),
                  (False, plane((5, 481, 643), dt)[1:], 20, False, f"off 16 B 481x643 {tag}"),
                  (True, frames((5, 481, 643), dt)[1:], 7, False, f"off 16 B 481x643 {tag}"),
                  (False, plane((L * B, H, W), dt), 60, True, f"gf_r=60 ops {tag}")]
    cases.append((False, plane((1, 1816, 64), torch.float32), 875, True,
                  "r=875 on 1816 rows ops float32"))
    for dark, dt in itertools.product((False, True), (torch.float32, torch.bfloat16)):
        tag = str(dt).replace("torch.", "")
        for r in strip_limit_radii("dark_channel" if dark else "box_filter", dt):
            x = frames((1, 100, 80), dt) if dark else plane((2, 400, 300), dt)
            cases.append((dark, x, r, False, f"limit {r} {tag}"))
    for dark, x, r, via_ops, label in cases:
        name = "dark_channel" if dark else "box_filter"
        if via_ops:
            run = lambda x_, r_: (ops.dark_channel if dark else ops.box_filter_2d)(  # noqa: E731
                x_, r_, mode="auto")
        else:
            run = sk.PAIRS[name][0]
        check_window_route(name, run, x, r, label, errs)
    reset_launches()


def strip_limit_radii(name: str, dt: torch.dtype):
    """The largest radius the strips of ``name`` take on ``dt`` planes and
    the next, after checking that the C library's ``st_strips_fit`` agrees
    with ``strips_fit`` on both."""
    from repro_torch.kernels import staged as sk
    limit = max(r for r in range(1000) if sk.strips_fit(name, r, dt))
    for r in (limit, limit + 1):
        check(bool(sk._lib().st_strips_fit(sk.STRIP_KINDS[name], r, sk._DTYPES[dt]))
              == sk.strips_fit(name, r, dt) == (r == limit),
              f"strips_fit({name}, {r}, {dt}) disagrees with st_strips_fit")
    return limit, limit + 1


def check_window_route(name, run, x, r, label, errs) -> None:
    """``run(x, r)`` must launch one staged ``name`` kernel, the strips where
    ``strips_fit`` and the row window (``wide_launches``) past it, and equal
    the plain version with max error 0; its error goes to ``errs[name]``
    (``errs["wide." + name]`` for the row window)."""
    from repro_torch.kernels import staged as sk
    check(x.is_contiguous(), f"{label}: input not contiguous")
    reset_launches()
    got = run(x, r)
    torch.cuda.synchronize()
    wide = not sk.strips_fit(name, r, x.dtype)
    check(sk.launches[name] == 1 and sk.wide_launches[name] == int(wide)
          and sum(sk.launches.values()) == 1,
          f"staged {name} {label} r={r}: launches {sk.launches[name]}, "
          f"row window {sk.wide_launches[name]}, expected 1 and {int(wide)}")
    err = max_err(got, sk.PAIRS[name][1](x, r))
    check(err == 0.0, f"staged {name} {label} r={r}: error {err}")
    key = f"wide.{name}" if wide else name
    errs[key] = max(errs.get(key, 0.0), err)
    print(f"staged {name} {label} r={r}: "
          f"{'row window' if wide else 'strips'}, error 0", flush=True)


def wide_route(name: str, x: torch.Tensor, r: int) -> torch.Tensor:
    """The staged window kernel ``name`` (dark channel, min or box filter)
    by its row window (``window_kernel``) at any radius: the route past the
    strips' limit, and the min filter's only route before the strips."""
    from repro_torch.kernels import staged as sk
    out = torch.empty(x.shape[:3], dtype=x.dtype, device=x.device)
    sk._launch(name, x.data_ptr(), out.data_ptr(), *x.shape[:3], r, sk._DTYPES[x.dtype],
               wide=True)
    return out


def check_no_sync(step, frames, ids, state, label: str) -> None:
    """One step on device-resident inputs must make no synchronising CUDA
    call: a sync would also wait for the D2H copies of earlier ticks that
    the serve loop's completion threads have queued."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(frames, ids, state)
    except RuntimeError as e:
        fail(f"{label} step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------------------
# Phase 8: the staged kernels' times at the serving shape
# ---------------------------------------------------------------------------

def phase_staged_times():
    """Each staged kernel on the serving config's inputs (uint8 frames
    upcast to float32, 32 frames of 480x640). The bound counts each input
    read once and each output written once; of the atmospheric light's
    frames it counts the one pixel a frame that this data needs (its
    argmin t), not all of I."""
    from repro_torch.core import (DehazeConfig, init_atmo_state_lanes,
                                  make_multi_stream_step)
    from repro_torch.kernels import ref
    from repro_torch.kernels import staged as sk
    n = L * B
    npx = n * H * W
    x = ref.upcast_frames(to_wire(ramps(4, n).reshape(-1, 3), torch.uint8)
                          ).reshape(n, H, W, 3).cuda()
    dark = sk.cuda_dark_channel(x, 7)
    t_raw = 1.0 - 0.95 * dark
    mean = sk.cuda_box_filter(t_raw, 20)
    a = sk.cuda_atmolight(x, t_raw)
    J = sk.cuda_recover(x, t_raw, a, 0.1, 1.0)
    rows = torch.arange(n, device="cuda")
    # name -> (args, bytes moved, float32 operations, PyTorch call)
    work = {
        "dark_channel": ((x, 7), nbytes(x, dark), 4 * npx,
                         lambda: F.max_pool2d(-x.amin(-1)[:, None], 15, 1, 7)),
        "box_filter": ((t_raw, 20), nbytes(t_raw, mean), 5 * npx,
                       lambda: F.avg_pool2d(t_raw[:, None], 41, 1, 20,
                                            count_include_pad=False)),
        # t, then the picked pixel of I and a, each n x 3 floats
        "atmolight": ((x, t_raw), nbytes(t_raw, a, a), npx,
                      lambda: x.reshape(n, -1, 3)[
                          rows, t_raw.reshape(n, -1).argmin(-1)]),
        "recover": ((x, t_raw, a, 0.1, 1.0), nbytes(x, t_raw, a, J),
                    16 * npx, None),
    }
    out = {}
    # Whole lane steps on device-resident uint8 frames, back to back: the
    # CUDA-event time includes the gaps where the host launches slower than
    # the card runs.
    u8 = to_wire(ramps(4, n).reshape(-1, 3), torch.uint8).reshape(
        L, B, H, W, 3).cuda()
    ids = torch.arange(B, dtype=torch.int32).repeat(L, 1).cuda()
    for mode in ("auto", "fused"):
        step = make_multi_stream_step(
            DehazeConfig(io_dtype="uint8", kernel_mode=mode), device="cuda")
        state = init_atmo_state_lanes(L, "cuda")
        ms = time_ms(lambda: step(u8, ids, state))
        busy = device_busy_ms(lambda: step(u8, ids, state))
        print(f"lane step {mode} ({L} x {B} x {H}x{W} uint8) back to back: "
              f"{ms} ms a step, device busy "
              + ("not measured" if busy is None else
                 f"{busy} ms a step (idle share {1.0 - busy / ms})"),
              flush=True)
    for name, (args, nb, ops, lib) in work.items():
        kernel, plain = sk.PAIRS[name]
        t_bytes = nb / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
        out[name] = dict(
            ms=time_ms(lambda: kernel(*args)),
            plain_ms=time_ms(lambda: plain(*args), reps=5, warmup=1),
            library_ms=time_ms(lib) if lib else None,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            # The kernels' own time a call, and the library call's: where
            # ms is well above it, the host's launch rate sets ms.
            device_busy_ms=device_busy_ms(lambda: kernel(*args)),
            library_busy_ms=device_busy_ms(lib) if lib else None)
    # The window strips (B3a, B4): blocks an SM, and B4's direct-sum floor
    # (2 (2r + 1) float32 adds an output, none recomputed, at the card's
    # rate of adds); and the row window, their route past the strips'
    # radius, on the same inputs.
    for name, r in (("dark_channel", 7), ("box_filter", 20)):
        out[name]["blocks_per_sm"] = sk.strips_occupancy(name, r, torch.float32, H)
        # The device's time a call, without the host: a profiler trace of
        # five calls has lost one kernel's record now and then.
        out[name]["graph_ms"] = graph_ms(lambda: sk.PAIRS[name][0](*work[name][0]))
        out[f"wide.{name}"] = dict(out[name], ms=time_ms(lambda: wide_route(name, *work[name][0])),
                                   graph_ms=None, device_busy_ms=None, blocks_per_sm=None)
    out["box_filter"]["floor_ms"] = 2 * 41 * npx / PEAK_F32_NONFMA_PER_S * 1e3
    card = card_line()
    for name in ("dark_channel", "box_filter"):
        k = out[name]
        print(f"staged {name} (strips, {npx} px float32): {k['ms']} ms, in a CUDA "
              f"graph {k['graph_ms']} ms a call, device busy {k['device_busy_ms']} ms, "
              f"bound {k['bound_ms']} ms "
              f"({k['bound_by']})" + (f", direct-sum floor {k['floor_ms']} ms"
                                      if "floor_ms" in k else "")
              + f", PyTorch call {k['library_ms']} ms (device busy "
              f"{k['library_busy_ms']} ms), {k['blocks_per_sm']} blocks an SM; "
              f"{card}", flush=True)
    # B6a's two launches, and argmin + gather, are bound by the host's
    # launch rate in ms: their device time, from a CUDA graph's replay.
    a = out["atmolight"]
    args, lib = work["atmolight"][0], work["atmolight"][3]
    a["graph_ms"] = graph_ms(lambda: sk.cuda_atmolight(*args))
    a["library_graph_ms"] = graph_ms(lib)
    # Repeated calls find t in L2 (39.3 MB of a 50 MB L2), so their device
    # time can beat the HBM bound: also with L2 flushed before each call.
    a["flushed_busy_ms"] = flushed_busy_ms(lambda: sk.cuda_atmolight(*args))
    a["library_flushed_busy_ms"] = flushed_busy_ms(lib)
    share = (a["bound_ms"] / a["flushed_busy_ms"]
             if a["flushed_busy_ms"] else None)
    print(f"staged atmolight (B6a): {a['ms']} ms, in a CUDA graph "
          f"{a['graph_ms']} ms a call, device busy {a['device_busy_ms']} ms, "
          f"L2 flushed {a['flushed_busy_ms']} ms (bound share {share}); "
          f"argmin + gather {a['library_ms']} ms, in a CUDA graph "
          f"{a['library_graph_ms']} ms, device busy {a['library_busy_ms']} ms, "
          f"L2 flushed {a['library_flushed_busy_ms']} ms; bound "
          f"{a['bound_ms']} ms", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 11: the fused transmission stage (B7a, B7b) and the data-parallel
# sharded steps that run it
# ---------------------------------------------------------------------------

TRANSMISSION_TOL = dict(PASS_TOL, candidate=(1e-6, False), tmap=(1e-4, False),
                        refine_tmap=(1e-4, False))


def check_transmission(frames, a_saved, kw, errs, label, fits: bool = True):
    """The stage on (L, B, H, W, 3) frames and per-lane A (L, 3): where the
    tiled sequence fits (``fits``, which ``transmission_tiled_fits`` and the
    library must both say), the tiled sequence and the ten passes, every
    pass against its plain pass, the tiled sequence against the ten passes
    with max error 0 in t, t_min and cand; the wrapper must run the tiled
    sequence where it fits and the ten passes where not (the launch
    counters show which), equal to the pass chains; the whole against the
    plain version; t and the candidates against the megakernel's (B1) on
    the same frames and saved A, bit for bit. Where the tiles do not fit,
    a tiled pass called alone must raise."""
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import ref
    full = dict(kw, t0=0.1, gamma=1.0, period=1, lam=0.0)
    s = fk.make_static(frames, **full)
    check(fk.transmission_tiled_fits(s) == fits
          and bool(fk._lib().fd_transmission_tiled_fits(ctypes.byref(s.params()))) == fits,
          f"{label}: transmission_tiled_fits != {fits} (Python or library)")
    seen = {}
    ten = fk.run_transmission_passes(frames, a_saved, s, checked_pass_dict(
        fk.TRANSMISSION_CUDA_PASSES, fk.TRANSMISSION_PLAIN_PASSES,
        TRANSMISSION_TOL, errs, label, seen=seen))
    b1_cand = fk.CUDA_PASSES["topk_merge"](seen["topk_block"], frames, s)
    got = ten
    if fits:
        got = fk.run_tiled_transmission_passes(frames, a_saved, s, checked_pass_dict(
            fk.TILED_TRANSMISSION_CUDA_PASSES, fk.TILED_TRANSMISSION_PLAIN_PASSES,
            TRANSMISSION_TOL, errs, label))
        torch.cuda.synchronize()
        e_ten = max(max_err(g1, g2) for g1, g2 in zip(got, ten))
        check(e_ten == 0.0 and all(torch.equal(g1, g2) for g1, g2 in zip(got, ten)),
              f"{label}: tiled sequence vs ten passes max error {e_ten}")
        errs["tiled_vs_ten_pass"] = max(errs.get("tiled_vs_ten_pass", 0.0), e_ten)
    else:
        try:
            fk.cuda_tmap_tile(frames, a_saved, s, counts=fk.transmission_launches)
            if s.refine:
                fk.cuda_guided_ab(seen["premap"][1], seen["min_cols_tmap"], s,
                                  counts=fk.transmission_launches)
        except RuntimeError:
            pass
        else:
            fail(f"{label}: a tiled pass launched a halo that does not fit")
    torch.cuda.synchronize()
    fk.reset_launches()
    whole = fk.fused_transmission_lanes(frames, a_saved, **kw)
    ran = {n: c for n, c in fk.transmission_launches.items() if c}
    route = fk.TILED_TRANSMISSION_PASSES if fits else fk.TRANSMISSION_PASSES
    want_ran = {n: 1 for n in route
                if not (n == "topk_block" and fits and s.topk == 1)
                and not (n in ("guided_ab", "box_rows4", "box_cols_ab", "box_rows2")
                         and not s.refine)}
    check(ran == want_ran, f"{label}: launches {ran}, expected {want_ran}")
    for g1, g2 in zip(got, whole):
        check(torch.equal(g1, g2), f"{label}: pass chain != wrapper")
    torch.cuda.synchronize()
    want = ref.fused_transmission_lanes(frames, a_saved, **kw)
    e = [max_err(g1, g2) for g1, g2 in zip(whole, want)]
    bf16 = s.out_dtype == torch.bfloat16
    check(e[0] <= (2e-2 if bf16 else 1e-3) and e[1] <= 1e-5
          and e[2] <= (BF16_STEP if bf16 else 1e-5),
          f"{label}: t/t_min/cand vs plain version {e}")
    errs["whole"] = max(errs.get("whole", 0.0), *e)
    ci = torch.tensor([[-(2 ** 30), 0]] * s.L, dtype=torch.int32, device="cuda")
    ids = torch.arange(s.B, dtype=torch.int32, device="cuda").repeat(s.L, 1)
    _, b1_t, *_ = fk.fused_dehaze_lanes(frames, ids, a_saved, ci, **full)
    check(torch.equal(whole[0], b1_t), f"{label}: t differs from the megakernel's")
    check(torch.equal(whole[2].reshape(-1, 3), b1_cand.to(whole[2].dtype)),
          f"{label}: candidates differ from the megakernel's")
    fk.reset_launches()


def transmission_kw(alg: str, k: int, refine: bool = True, r: int = 7,
                    gf_r: int = 20) -> dict:
    from repro_torch.kernels import ref
    return dict(algorithm=alg, radius=r, omega=0.95, beta=1.0, cap_w=ref.CAP_COEFFS,
                refine=refine, gf_radius=gf_r, gf_eps=1e-3, topk=k, out_dtype=None)


def check_transmission_cells(errs) -> int:
    """The stage's cells at 4 x 8 x 480x640, per-lane saved A: {dcp, cap} x
    {topk 1, 4} x {uint8, bfloat16, float32} with refine, one without
    refine, and a plateau cell whose t ties across the 2-D tiles; then
    windows at the tiles' limit (He et al.'s gf_r = 60 at 480x640 and r =
    37 on float32 frames: the ten passes; r = 36 with gf_r = 45: the tiled
    sequence); then ``transmission_tiled_fits`` against the library's on
    both sides of each limit. Returns the number of cells."""
    from repro_torch.kernels import fused as fk
    ramp = ramps(13, L * B).reshape(-1, 3)
    plateau = plateau_frames(L * B).reshape(-1, 3)
    a_lanes = torch.tensor([[0.9, 0.85, 0.8], [1.0, 1.0, 1.0], [0.7, 0.75, 0.8],
                            [0.95, 0.9, 0.85]], device="cuda")
    cells = [(alg, k, dt, True, False) for alg in ("dcp", "cap") for k in (1, 4)
             for dt in (torch.uint8, torch.bfloat16, torch.float32)]
    cells += [("dcp", 1, torch.uint8, False, False), ("dcp", 1, torch.uint8, True, True)]
    for alg, k, dt, refine, flat in cells:
        img = to_wire(plateau if flat else ramp, dt).reshape(L, B, H, W, 3).cuda()
        check_transmission(img, a_lanes, transmission_kw(alg, k, refine), errs,
                           f"B7 {alg} k={k} {dt} refine={refine}"
                           f"{' plateau' if flat else ''}")
    # (algorithm, topk, dtype, r, gf_r, H, W, the tiled sequence fits)
    wide = [("dcp", 1, torch.uint8, 7, 60, H, W, False),
            ("cap", 4, torch.float32, 37, 20, 50, 70, False),
            ("dcp", 1, torch.float32, 36, 45, 50, 70, True)]
    for alg, k, dt, r, gr, h, w, fits in wide:
        img = to_wire(ramps(14, 4, h, w).reshape(-1, 3), dt).reshape(2, 2, h, w, 3).cuda()
        check_transmission(img, a_lanes[:2], transmission_kw(alg, k, True, r, gr), errs,
                           f"B7 wide {alg} k={k} {dt} r={r} gf_r={gr} {h}x{w}", fits)
    # The limits: the largest radius a dtype's tmap_tile takes, gf_r 45.
    for dt, r_max in ((torch.float32, 36), (torch.bfloat16, 52), (torch.uint8, 66)):
        img = torch.empty((1, 1, 50, 70, 3), dtype=dt, device="cuda")
        for r, gr in ((r_max, 20), (r_max + 1, 20), (7, 45), (7, 46)):
            s = fk.make_static(img, t0=0.1, gamma=1.0, period=1, lam=0.0,
                               **transmission_kw("dcp", 1, True, r, gr))
            lib = bool(fk._lib().fd_transmission_tiled_fits(ctypes.byref(s.params())))
            check(lib == fk.transmission_tiled_fits(s) == (r <= r_max and gr <= 45),
                  f"transmission_tiled_fits({dt}, r={r}, gf_r={gr}) disagrees "
                  "with the library or the limit")
    print(f"B7 on {len(cells)} cells at {L}x{B}x{H}x{W} and {len(wide)} wide-window "
          "cells: tiled sequence == ten passes (max error 0), wrapper routes "
          "by shape, t and candidates == the megakernel's; passes "
          + json.dumps(errs), flush=True)
    return len(cells) + len(wide)


# The staged branch of the sharded steps (kernel_mode "pallas"): one
# masked min filter (B8a) and the guided filter's six masked means (B8b) a
# step, their strips, and no other kernel.
STAGED_SHARDED_PER_STEP = {"staged.masked_min_filter": 1, "staged.masked_box_filter": 6,
                           "staged.merge_ema": 1}


def phase_sharded():
    """The stage's cells (:func:`check_transmission_cells`), then the
    frame-sharded (B7a) and lane-sharded (B7b, ``lane_native=False``) steps
    on a one-rank NCCL mesh, each two chained batches, held against the
    single-device fused steps; then the same two steps with
    ``kernel_mode="pallas"`` (their staged branch: B8a and B8b), held
    against the single-device staged steps, and their t against the fused
    sharded steps'."""
    import torch.distributed as dist
    from repro_torch.core import (DehazeConfig, PlacementSpec, init_atmo_state,
                                  init_atmo_state_lanes, make_dehaze_step,
                                  make_multi_stream_step,
                                  make_sharded_dehaze_step, make_step)
    from repro_torch.launch.mesh import make_host_mesh
    cell_errs = {}
    n_cells = check_transmission_cells(cell_errs)
    cfg = DehazeConfig(kernel_mode="fused", io_dtype="uint8")
    kw = dict(algorithm=cfg.algorithm, radius=cfg.patch_radius, omega=cfg.omega,
              beta=cfg.beta, cap_w=(cfg.cap_w0, cfg.cap_w1, cfg.cap_w2),
              refine=cfg.refine, gf_radius=cfg.gf_radius, gf_eps=cfg.gf_eps,
              topk=cfg.topk, out_dtype=cfg.out_dtype)
    frames = to_wire(ramps(5, 2 * L * B).reshape(-1, 3), torch.uint8).reshape(
        2, L, B, H, W, 3).cuda()
    mesh = make_host_mesh(1, 1)
    errs, whole = {"cells": cell_errs}, {}
    launches = {name: {} for name in TRANSMISSION_REPLACES}

    def batch_inputs(batch: int, lanes: bool):
        img = frames[batch] if lanes else frames[batch].reshape(L * B, H, W, 3)
        ids = torch.arange(L * B, dtype=torch.int32, device="cuda") + L * B * batch
        ids = ids.reshape(L, B) if lanes else ids
        if lanes:
            ids[L - 1] = -1                                   # padding lane
        return img, ids

    def new_state(lanes: bool):
        return init_atmo_state_lanes(L, "cuda") if lanes else init_atmo_state("cuda")

    def vs_single(name, batch, out, want) -> dict:
        torch.cuda.synchronize()
        e_jt = max(max_err(out.frames, want.frames),
                   max_err(out.transmission, want.transmission))
        e_a = max(max_err(out.atmo_light, want.atmo_light),
                  max_err(out.state.A, want.state.A))
        check(e_jt <= 2e-4, f"{name} b{batch}: J/t vs single device {e_jt}")
        check(e_a <= 1e-5, f"{name} b{batch}: a_seq/A vs single device {e_a}")
        check(torch.equal(out.state.last_update, want.state.last_update)
              and torch.equal(out.state.initialized, want.state.initialized),
              f"{name} b{batch}: last_update/initialized differ")
        return {"J_t": e_jt, "a_seq_A": e_a}

    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        paths = {
            "fused_transmission": (make_sharded_dehaze_step(cfg, mesh),
                                   make_dehaze_step(cfg), False),
            "fused_transmission_lanes": (
                make_step(cfg, PlacementSpec.lane_sharded(), mesh,
                          lane_native=False),
                make_multi_stream_step(cfg), True),
        }
        for name, (step, single, lanes) in paths.items():
            e_out = {"J_t": 0.0, "a_seq_A": 0.0}
            state = ref_state = new_state(lanes)
            for batch in range(2):
                img, ids = batch_inputs(batch, lanes)
                a_lanes = (state.A if lanes else state.A.reshape(1, 3)).contiguous()
                check_transmission(img if lanes else img[None], a_lanes, kw,
                                   errs.setdefault(name, {}), f"{name} b{batch}")
                reset_launches()
                out = step(img, ids, state)
                for c, v in path_launches(f"{name} step", 1,
                                          transmission_per_tick()).items():
                    launches[name][c] = launches[name].get(c, 0) + v
                want = single(img, ids, ref_state)
                e = vs_single(name, batch, out, want)
                e_out = {k: max(e_out[k], e[k]) for k in e_out}
                state, ref_state = out.state, want.state
            check_no_sync(step, img, ids, state, f"sharded {name}")
            whole[name] = e_out
            print(f"sharded {name}: passes " + json.dumps(errs[name])
                  + " vs single device " + json.dumps(e_out), flush=True)
        # The staged branch: the frame- and lane-sharded steps with
        # kernel_mode "pallas" against the single-device staged steps, and
        # their t against the fused sharded steps' on the same state.
        cfg_s = DehazeConfig(kernel_mode="pallas", io_dtype="uint8")
        staged_paths = {
            "staged_frame_sharded": (make_sharded_dehaze_step(cfg_s, mesh),
                                     make_dehaze_step(cfg_s),
                                     paths["fused_transmission"][0], False),
            "staged_lane_sharded": (
                make_step(cfg_s, PlacementSpec.lane_sharded(), mesh, lane_native=False),
                make_multi_stream_step(cfg_s), paths["fused_transmission_lanes"][0], True),
        }
        for name, (step, single, fused_step, lanes) in staged_paths.items():
            e_out = {"J_t": 0.0, "a_seq_A": 0.0, "t_vs_fused": 0.0}
            launches[name] = {}
            state = ref_state = new_state(lanes)
            for batch in range(2):
                img, ids = batch_inputs(batch, lanes)
                reset_launches()
                out = step(img, ids, state)
                for c, v in path_launches(f"{name} step", 1,
                                          STAGED_SHARDED_PER_STEP).items():
                    launches[name][c] = launches[name].get(c, 0) + v
                want = single(img, ids, ref_state)
                t_fused = fused_step(img, ids, state).transmission
                e = vs_single(name, batch, out, want)
                e["t_vs_fused"] = max_err(out.transmission, t_fused)
                check(e["t_vs_fused"] <= 2e-4,
                      f"{name} b{batch}: t vs the fused sharded step {e['t_vs_fused']}")
                e_out = {k: max(e_out[k], e[k]) for k in e_out}
                state, ref_state = out.state, want.state
            check_no_sync(step, img, ids, state, f"sharded {name}")
            whole[name] = e_out
            print(f"sharded {name} (kernel_mode pallas): vs single device and the "
                  "fused step " + json.dumps(e_out), flush=True)
    finally:
        dist.destroy_process_group()
    return errs, whole, launches, n_cells


# ---------------------------------------------------------------------------
# Phase 12: this slice's kernels timed at the serving shape
# ---------------------------------------------------------------------------

def rates(r: dict, nb: int, ops: int, direct: int = 0) -> dict:
    """``r`` with its bound (each input read once, each output written once,
    and a sliding-window algorithm's float32 operations at the card's
    peak, whichever takes longer) and, where ``direct``, the direct window
    sums' floor (their operations at the non-FMA float32 rate)."""
    t_bytes = nb / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    r.update(bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations")
    if direct:
        r["floor_ms"] = direct / PEAK_F32_NONFMA_PER_S * 1e3
    return r


def turns(tiled, ten) -> dict:
    """A tiled sequence and the ten passes it replaced, timed in turns (ten,
    tiled, tiled, ten), with their device busy times and their device time
    a call in a replayed CUDA graph (the profiler drops a record now and
    then, section 7 of PERF.md)."""
    order = [(n, time_ms(fn)) for n, fn in
             (("ten", ten), ("tiled", tiled), ("tiled", tiled), ("ten", ten))]
    mean = {n: sum(v for m, v in order if m == n) / 2 for n in ("tiled", "ten")}
    return dict(ms=mean["tiled"], ten_pass_ms=mean["ten"],
                device_busy_ms=device_busy_ms(tiled),
                ten_pass_busy_ms=device_busy_ms(ten), graph_ms=graph_ms(tiled),
                ten_pass_graph_ms=graph_ms(ten), turns_ms=[v for _, v in order])


def phase_slice3_times():
    """The min filter on CAP's depth (r = 7) and the top-k atmospheric
    light (k = 4) on DCP's t_raw, 32 frames of 480x640 float32 after the
    uint8 upcast: the strips and the warp top-k beside the kernels they
    replaced (the row window, the block rounds: their routes past the new
    limits), timed in turns (old, new, new, old), each also by device busy
    time, as a call in a replayed CUDA graph and with its blocks an SM, the
    top-k also with L2 flushed, beside the PyTorch call; the staged CAP
    top-4 lane step back to back; the transmission stage over 32 uint8
    frames (B7a) and 4 x 8 (B7b), its tiled sequence and its ten passes in
    turns, and each tiled pass alone at B7b's shape with its blocks an SM.
    Bounds count each input read once and each output written once; of the
    top-k's frames they count the k pixels a frame this data needs."""
    from repro_torch.core import (DehazeConfig, init_atmo_state_lanes,
                                  make_multi_stream_step)
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import ref
    from repro_torch.kernels import staged as sk
    n, k = L * B, 4
    npx = n * H * W
    u8 = to_wire(ramps(6, n).reshape(-1, 3), torch.uint8).reshape(
        L, B, H, W, 3).cuda()
    x = ref.upcast_frames(u8).reshape(n, H, W, 3)
    depth = ref.cap_depth(x, *ref.CAP_COEFFS)
    mins = sk.cuda_min_filter(depth, 7)
    t_raw = 1.0 - 0.95 * sk.cuda_dark_channel(x, 7)
    a = sk.cuda_atmolight_topk(x, t_raw, k)

    def topk_library():
        j = torch.topk(t_raw.reshape(n, -1), k, largest=False).indices
        return torch.gather(x.reshape(n, -1, 3), 1, j[..., None].expand(n, k, 3)).mean(1)

    out = {}
    card = card_line()
    for name, new, old, plain, lib, nb, ops, blocks in (
            ("min_filter", lambda: sk.cuda_min_filter(depth, 7),
             lambda: wide_route("min_filter", depth, 7),
             lambda: sk.plain_min_filter(depth, 7),
             lambda: -F.max_pool2d(-depth[:, None], 15, 1, 7),
             nbytes(depth, mins), 2 * npx,
             (sk.strips_occupancy("min_filter", 7, torch.float32, H),
              sk.window_occupancy(7, H))),
            ("atmolight_topk", lambda: sk.cuda_atmolight_topk(x, t_raw, k),
             lambda: sk._atmolight_topk(x, t_raw, k, wide=True),
             lambda: sk.plain_atmolight_topk(x, t_raw, k), topk_library,
             nbytes(t_raw, a) + n * k * 12, npx,
             (sk.topk_occupancy(k), sk.topk_occupancy(sk.WARP_TOPK_MAX + 1)))):
        order = [(m, time_ms(fn)) for m, fn in (("old", old), ("new", new), ("new", new),
                                                ("old", old))]
        mean = {m: sum(v for q, v in order if q == m) / 2 for m in ("new", "old")}
        plain_ms = time_ms(plain, reps=5, warmup=1)
        lib_r = dict(ms=time_ms(lib), device_busy_ms=device_busy_ms(lib), graph_ms=graph_ms(lib))
        for route, fn, blk in (("new", new, blocks[0]), ("old", old, blocks[1])):
            r = dict(ms=mean[route], plain_ms=plain_ms, library_ms=lib_r["ms"],
                     library_busy_ms=lib_r["device_busy_ms"],
                     library_graph_ms=lib_r["graph_ms"], device_busy_ms=device_busy_ms(fn),
                     graph_ms=graph_ms(fn), blocks_per_sm=blk, turns_ms=[v for _, v in order])
            if name == "atmolight_topk":
                r["flushed_busy_ms"] = flushed_busy_ms(fn)
            out[f"staged.{name}" if route == "new" else f"staged.wide.{name}"] = rates(r, nb, ops)
        if name == "atmolight_topk":
            lib_flushed = flushed_busy_ms(lib)
            for key in ("staged.atmolight_topk", "staged.wide.atmolight_topk"):
                out[key]["library_flushed_busy_ms"] = lib_flushed
        new_r, old_r = out[f"staged.{name}"], out[f"staged.wide.{name}"]
        print(f"staged {name} ({npx} px float32, turns old/new/new/old "
              f"{new_r['turns_ms']} ms): new {new_r['ms']} ms, in a CUDA graph "
              f"{new_r['graph_ms']}, device busy {new_r['device_busy_ms']}"
              + (f", L2 flushed {new_r['flushed_busy_ms']}" if "flushed_busy_ms" in new_r
                 else "") + f", {new_r['blocks_per_sm']} blocks an SM; old {old_r['ms']} ms, "
              f"in a CUDA graph {old_r['graph_ms']}, device busy {old_r['device_busy_ms']}"
              + (f", L2 flushed {old_r['flushed_busy_ms']}" if "flushed_busy_ms" in old_r
                 else "") + f", {old_r['blocks_per_sm']} blocks an SM; bound "
              f"{new_r['bound_ms']} ms ({new_r['bound_by']}); PyTorch call "
              f"{new_r['library_ms']} ms, in a CUDA graph {new_r['library_graph_ms']}, "
              f"device busy {new_r['library_busy_ms']}"
              + (f", L2 flushed {new_r['library_flushed_busy_ms']}"
                 if "library_flushed_busy_ms" in new_r else "") + f"; {card}", flush=True)
    # The staged CAP top-4 lane step on device-resident uint8 frames, back
    # to back (the host's launches included).
    step = make_multi_stream_step(DehazeConfig(algorithm="cap", topk=4, io_dtype="uint8"),
                                  device="cuda")
    state = init_atmo_state_lanes(L, "cuda")
    ids = torch.arange(B, dtype=torch.int32).repeat(L, 1).cuda()
    ms = time_ms(lambda: step(u8, ids, state))
    busy = device_busy_ms(lambda: step(u8, ids, state))
    print(f"lane step staged CAP top-4 ({L} x {B} x {H}x{W} uint8) back to back: {ms} ms a "
          "step, device busy " + ("not measured" if busy is None else
                                  f"{busy} ms a step (idle share {1.0 - busy / ms})")
          + f"; {card}", flush=True)

    kw = transmission_kw("dcp", 1)
    a_lanes = torch.tensor([[0.9, 0.85, 0.8]] * L, device="cuda")
    kg, kr = 2 * kw["gf_radius"] + 1, 2 * kw["radius"] + 1
    # The stage's float32 operations, sliding-window and direct: tmap_tile,
    # guided_ab and refine_tmap as phase 5 counts the megakernel's passes
    # (refine_tmap is refine_recover less J's 15 an output).
    ops_px = {"tmap_tile": (22, 2 * kr + 16), "guided_ab": (30, 8 * kg + 14),
              "refine_tmap": (13, 4 * kg + 4)}
    stage_ops = sum(v[0] for v in ops_px.values()) * npx
    stage_direct = sum(v[1] for v in ops_px.values()) * npx
    flat = u8.reshape(n, H, W, 3)
    for name, img, a_in in (("fused_transmission", flat[None], a_lanes[:1]),
                            ("fused_transmission_lanes", u8, a_lanes)):
        s = fk.make_static(img, t0=0.1, gamma=1.0, period=1, lam=0.0, **kw)
        t7, tmin7, cand7 = fk.fused_transmission_lanes(img, a_in, **kw)
        check(fk.transmission_tiled_fits(s), f"{name}: the serving shape must fit")
        r = turns(lambda: fk.fused_transmission_lanes(img, a_in, **kw),
                  lambda: fk.run_transmission_passes(img, a_in, s))
        r.update(plain_ms=time_ms(lambda: ref.fused_transmission_lanes(img, a_in, **kw),
                                  reps=3, warmup=1),
                 library_ms=None, blocks_per_sm=list(fk.transmission_occupancy(s)))
        out[name] = rates(r, nbytes(img, a_in, t7, tmin7, cand7), stage_ops, stage_direct)
    # Each tiled pass alone at B7b's shape.
    s = fk.make_static(u8, t0=0.1, gamma=1.0, period=1, lam=0.0, **kw)
    C, P = fk.TILED_TRANSMISSION_CUDA_PASSES, fk.TILED_TRANSMISSION_PLAIN_PASSES
    t_raw7, g7, keys7 = C["tmap_tile"](u8, a_lanes, s)
    tmin7, cand7 = C["candidate"](keys7, u8, s)
    ab7 = C["guided_ab"](g7, t_raw7, s)
    t7 = C["refine_tmap"](t_raw7, g7, ab7, s)
    blocks = dict(zip(("tmap_tile", "guided_ab", "refine_tmap"), fk.transmission_occupancy(s)))
    work = {"tmap_tile": ((u8, a_lanes), nbytes(u8, a_lanes, t_raw7, g7, keys7)),
            "candidate": ((keys7, u8), nbytes(keys7, tmin7, cand7) + 3 * n),
            "guided_ab": ((g7, t_raw7), nbytes(g7, t_raw7, ab7)),
            "refine_tmap": ((t_raw7, g7, ab7), nbytes(g7, ab7, t7))}
    for name, (args, nb) in work.items():
        fn = lambda a_=args, c=C[name]: c(*a_, s)          # noqa: E731
        ops, direct = ((v * npx for v in ops_px[name]) if name in ops_px
                       else (keys7.numel(), 0))
        r = dict(ms=time_ms(fn), plain_ms=time_ms(lambda a_=args, p=P[name]: p(*a_, s),
                                                  reps=5, warmup=1),
                 library_ms=None, device_busy_ms=device_busy_ms(fn),
                 graph_ms=graph_ms(fn), blocks_per_sm=blocks.get(name))
        out[f"fused_transmission.{name}"] = rates(r, nb, ops, direct)
    for name in ("fused_transmission", "fused_transmission_lanes"):
        r = out[name]
        print(f"{name} ({'32' if name == 'fused_transmission' else '4 x 8'} x "
              f"{H}x{W} uint8, turns ten/tiled/tiled/ten {r['turns_ms']} ms): tiled "
              f"{r['ms']} ms (device busy {r['device_busy_ms']}, CUDA graph "
              f"{r['graph_ms']}), ten passes {r['ten_pass_ms']} ms (device busy "
              f"{r['ten_pass_busy_ms']}, CUDA graph {r['ten_pass_graph_ms']}), bound "
              f"{r['bound_ms']} ms ({r['bound_by']}), direct-sum floor "
              f"{r['floor_ms']} ms, blocks an SM {r['blocks_per_sm']}; {card}",
              flush=True)
    for name in ("tmap_tile", "candidate", "guided_ab", "refine_tmap"):
        r = out[f"fused_transmission.{name}"]
        print(f"  tiled pass {name:12s} {r['ms']:.4f} ms, device busy "
              f"{r['device_busy_ms']}, CUDA graph {r['graph_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms, floor "
              f"{r.get('floor_ms', 0.0):.4f} ms, blocks an SM {r['blocks_per_sm']}",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 13: spatial sharding on one rank (virtual tilings)
# ---------------------------------------------------------------------------

HALO_TOL = dict(TRANSMISSION_TOL, topk_list=TRANSMISSION_TOL["candidate"])
SPATIAL_TILINGS = ((2, 1), (1, 2), (2, 2))


def halo_tile(plane, halo_h: int, halo_w: int, n_h: int, n_w: int, i: int,
              j: int):
    """Tile (i, j) of an n_h x n_w tiling of (N, H, W) planes, extended by
    the halos, zero past the frame's edge, with its row and column
    validity: what the halo exchange delivers to that rank."""
    n, hh, ww = plane.shape
    h, w = hh // n_h, ww // n_w
    padded = F.pad(plane, (halo_w, halo_w, halo_h, halo_h))
    ext = padded[:, i * h:(i + 1) * h + 2 * halo_h,
                 j * w:(j + 1) * w + 2 * halo_w].contiguous()
    rows = torch.arange(i * h - halo_h, (i + 1) * h + halo_h, device=plane.device)
    cols = torch.arange(j * w - halo_w, (j + 1) * w + halo_w, device=plane.device)
    return ext, (rows >= 0) & (rows < hh), (cols >= 0) & (cols < ww)


def spatial_tiles(frames, x, pre, guide, halo: int, tiling):
    """Every tile's arguments of the per-shard function after the exchange,
    in rank order: ``(core frames, core compute view, pre_ext, guide_ext,
    row validity, column validity or None, row0, col0)``."""
    n_h, n_w = tiling
    hh, hw = (halo if n_h > 1 else 0), (halo if n_w > 1 else 0)
    h, w = H // n_h, W // n_w
    tiles = []
    for i in range(n_h):
        for j in range(n_w):
            pre_ext, vr, vc = halo_tile(pre, hh, hw, n_h, n_w, i, j)
            guide_ext, _, _ = halo_tile(guide, hh, hw, n_h, n_w, i, j)
            core = (slice(None), slice(i * h, (i + 1) * h), slice(j * w, (j + 1) * w))
            tiles.append((frames[core].contiguous(), x[core].contiguous(),
                          pre_ext, guide_ext, vr, vc if n_w > 1 else None,
                          i * h, j * w))
    return tiles


def check_halo_tile(tile, kw, errs, label, fits: bool = True):
    """B9 on one tile: where the masked tiled sequence fits (``fits``, which
    ``halo_tiled_fits`` and the library must both say), it and the ten
    masked passes, every pass against its plain pass (a tiled pass's
    extended planes on the region it writes), the tiled sequence against
    the ten passes with max error 0 in t, tk_t, tk_rgb and tk_idx, and no
    NaN; the wrapper must run the tiled sequence where it fits and the ten
    passes where not (the launch counters show which), equal to the pass
    chains; the whole against its plain version (t 1e-3, lists 1e-5,
    indices exact; bfloat16 t 2e-2 and rows one bfloat16 step)."""
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import ref
    from repro_torch.kernels import staged as sk
    img, _, pre, guide, vr, vc = tile[:6]
    s = fk.make_halo_static(img, pre, guide, **kw)
    check(fk.halo_tiled_fits(s) == fits
          and bool(fk._lib().fd_halo_tiled_fits(ctypes.byref(s.params()))) == fits,
          f"{label}: halo_tiled_fits != {fits} (Python or library)")
    vh = sk.validity_bytes(vr, s.h_ext, img.device)
    vw = sk.validity_bytes(vc, s.w_ext, img.device)

    def region(name, out):
        if name not in ("tmap_tile", "guided_ab"):
            return out
        ys, xs = s.region(name)
        planes = out if name == "guided_ab" else out[0]
        planes = planes[..., ys, xs]
        return planes if name == "guided_ab" else (planes,) + tuple(out[1:])

    args = (img, pre, guide, vh, vw, s)
    got = ten = fk.run_halo_passes(*args, checked_pass_dict(
        fk.HALO_CUDA_PASSES, fk.HALO_PLAIN_PASSES, HALO_TOL, errs, label))
    if fits:
        got = fk.run_tiled_halo_passes(*args, checked_pass_dict(
            fk.TILED_HALO_CUDA_PASSES, fk.TILED_HALO_PLAIN_PASSES, HALO_TOL, errs,
            label, view=region))
        torch.cuda.synchronize()
        e_ten = max(max_err(g1, g2) for g1, g2 in zip(got, ten))
        check(e_ten == 0.0 and all(torch.equal(g1, g2) for g1, g2 in zip(got, ten)),
              f"{label}: tiled halo sequence vs ten masked passes max error {e_ten}")
        check(not any(bool(torch.isnan(v.float()).any()) for v in got),
              f"{label}: NaN in the tiled halo sequence's outputs")
        errs["tiled_vs_ten_pass"] = max(errs.get("tiled_vs_ten_pass", 0.0), e_ten)
    torch.cuda.synchronize()
    fk.reset_launches()
    whole = fk.fused_transmission_halo(img, pre, guide, vr, vc, **kw)
    ran = {n: c for n, c in fk.halo_launches.items() if c}
    route = fk.TILED_HALO_PASSES if fits else fk.HALO_PASSES
    want_ran = {n: 1 for n in route
                if not (n == "topk_block" and fits and s.topk == 1)
                and not (n in ("guided_ab", "box_rows4", "box_cols_ab", "box_rows2")
                         and not s.refine)}
    check(ran == want_ran, f"{label}: launches {ran}, expected {want_ran}")
    fk.reset_launches()
    for g1, g2 in zip(got, whole):
        check(torch.equal(g1, g2), f"{label}: halo pass chain != wrapper")
    torch.cuda.synchronize()
    want = ref.fused_transmission_halo(img, pre, guide, vr, vc, **kw)
    e = [max_err(g1, g2) for g1, g2 in zip(whole[:3], want[:3])]
    bf16 = s.out_dtype == torch.bfloat16
    check(e[0] <= (2e-2 if bf16 else 1e-3) and e[1] <= 1e-5
          and e[2] <= (BF16_STEP if bf16 else 1e-5) and torch.equal(whole[3], want[3]),
          f"{label}: B9 vs plain version t/tk_t/tk_rgb {e}, indices "
          f"{'equal' if torch.equal(whole[3], want[3]) else 'differ'}")
    errs["whole"] = max(errs.get("whole", 0.0), *e)


def spatial_step(cfg, tiles, fused: bool = True):
    """What the spatially sharded step computes after the exchange, for
    every tile in rank order: the per-shard function (its halo stage, or
    where not ``fused`` its staged branch), then the lists gathered in rank
    order through the state sync (the merge and the EMA of the
    frame-sharded step: its frames as one lane, ids 0.., a fresh state).
    Returns the tiles' t, ``(a_seq, new state)`` and the gathered lists
    ``(tk_t, gidx, tk_rgb)``; fails on a synchronising call."""
    from repro_torch.core import init_atmo_state
    from repro_torch.core import pipeline
    from repro_torch.core.pipeline import spatial_shard_stage
    n = tiles[0][0].shape[0]
    ids = torch.arange(n, dtype=torch.int32, device="cuda")
    state = init_atmo_state("cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [spatial_shard_stage(cfg, *tile, W, fused=fused) for tile in tiles]
        tk_t, tk_rgb, gidx = (torch.cat([o[q] for o in outs], dim=1)
                              for q in (1, 2, 3))
        synced = pipeline._state_sync(cfg, tk_rgb, ids, state, True, tk_t, gidx)
    except RuntimeError as e:
        fail(f"spatial step: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [o[0] for o in outs], synced, (tk_t, gidx, tk_rgb)


def check_spatial_sync(synced, lists, k: int, cfg, label: str, errs) -> torch.Tensor:
    """The spatial step's state sync (``staged.merge_ema``) against its plain
    version on the same lists, bit for bit; returns the lists' merged
    candidate through B10 (``staged.cuda_merge_topk``), held to its plain
    version within 1e-6."""
    from repro_torch.core import init_atmo_state
    from repro_torch.kernels import staged as sk
    a_seq, st = synced
    tk_t, gidx, tk_rgb = lists
    n = tk_t.shape[0]
    st0 = init_atmo_state("cuda")
    want = sk.plain_merge_ema(
        tk_t[None], gidx[None], tk_rgb[None], k,
        torch.arange(n, dtype=torch.int32, device="cuda")[None], st0.A[None],
        st0.last_update[None], st0.initialized[None], cfg.update_period, cfg.lam, True)
    e_sync = sync_err((a_seq[None], st.A[None], st.last_update[None],
                       st.initialized[None]), want)
    check(e_sync == 0.0, f"{label}: the state sync vs its plain version {e_sync} != 0")
    errs["merge_ema"] = max(errs.get("merge_ema", 0.0), e_sync)
    cand = sk.cuda_merge_topk(tk_t, gidx, tk_rgb, k)
    torch.cuda.synchronize()
    e_merge = max_err(cand, sk.plain_merge_topk(tk_t, gidx, tk_rgb, k))
    check(e_merge <= 1e-6, f"{label}: B10 vs plain version {e_merge} > 1e-6")
    errs["merge_topk"] = max(errs.get("merge_topk", 0.0), e_merge)
    return cand


def stitch(parts, tiling):
    n_h, n_w = tiling
    return torch.cat([torch.cat(parts[i * n_w:(i + 1) * n_w], dim=2)
                      for i in range(n_h)], dim=1)


def plateau_frames(n: int, h: int = H, w: int = W) -> np.ndarray:
    """Quantised frames (``tests/test_parity_matrix.py``): equal-t plateaus
    across the tile boundaries, per-pixel rgb still varying inside them."""
    q = np.round(np.random.default_rng(8).random((n, h, w, 3)) * 4) / 4
    return (q * 0.8 + 0.1).astype(np.float32)


def check_halo_cells(errs, frames, a_saved) -> None:
    """Corner tiles of 8 frames off the step's config: without refine (DCP
    top-2), bfloat16 frames (t and the rows in bfloat16; CAP top-1), and a
    halo too wide for the tiles (gf_r = 46: the ten masked passes, chosen
    by shape), each held as :func:`check_halo_tile` holds the step's tiles;
    then ``halo_tiled_fits`` against the library's on both sides of each
    limit (radius 88, gf_r 45)."""
    from repro_torch.core import DehazeConfig
    from repro_torch.core import algorithms as alg
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import ref
    # (label, frames, algorithm, topk, refine, gf_r, corner, the tiles fit)
    cells = [("no refine", frames[:8], "dcp", 2, False, 20, 0, True),
             ("bfloat16 frames", frames[:8].to(torch.bfloat16) / 255.0, "cap", 1,
              True, 20, 3, True),
             ("wide gf_r=46", frames[:8], "dcp", 4, True, 46, 0, False)]
    for label, img, alg_, k, refine, gr, corner, fits in cells:
        cfg = DehazeConfig(algorithm=alg_, topk=k, kernel_mode="fused")
        x = ref.upcast_frames(img)
        pre, guide = alg.premap(x, a_saved, cfg), alg.luminance(x)
        kw = dict(algorithm=alg_, radius=7, omega=cfg.omega, beta=cfg.beta,
                  refine=refine, gf_radius=gr, gf_eps=cfg.gf_eps, topk=k,
                  out_dtype=None)
        tile = spatial_tiles(img, x, pre, guide, 7 + 2 * gr, (2, 2))[corner]
        check_halo_tile(tile, kw, errs, f"{label} corner tile", fits=fits)
    img = torch.empty((1, 40, 50, 3), dtype=torch.uint8, device="cuda")
    for r, gr in ((88, 20), (89, 20), (7, 45), (7, 46)):
        plane = torch.empty((1, 40 + 2 * (r + 2 * gr), 50 + 2 * (r + 2 * gr)),
                            device="cuda")
        s = fk.make_halo_static(img, plane, plane, radius=r, refine=True,
                                gf_radius=gr, gf_eps=1e-3)
        lib = bool(fk._lib().fd_halo_tiled_fits(ctypes.byref(s.params())))
        check(lib == fk.halo_tiled_fits(s) == (r <= 88 and gr <= 45),
              f"halo_tiled_fits(r={r}, gf_r={gr}) disagrees with the library "
              "or the limit")
    print("B9 corner tiles without refine and of bfloat16 frames: tiled == "
          "ten masked passes; gf_r 46: the ten masked passes by shape; fits "
          "limits r 88, gf_r 45 agree with the library", flush=True)


def phase_spatial():
    """Spatial sharding on one rank over virtual tilings (see the module
    docstring, phase 13)."""
    from repro_torch.core import DehazeConfig
    from repro_torch.core import algorithms as alg
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import ref
    from repro_torch.kernels import staged as sk
    n = L * B
    a_saved = torch.tensor([0.9, 0.85, 0.8], device="cuda")
    ramp_u8 = to_wire(ramps(7, n).reshape(-1, 3), torch.uint8).reshape(
        n, H, W, 3).cuda()
    plateau = to_wire(plateau_frames(n).reshape(-1, 3), torch.uint8).reshape(
        n, H, W, 3).cuda()
    # (label, algorithm, topk, frames, tiling, plane dtype, against B7a?)
    cells = [(f"{alg_}-{k}-{n_h}x{n_w}", alg_, k, ramp_u8, (n_h, n_w),
              torch.float32, True)
             for alg_, k in (("dcp", 1), ("cap", 4))
             for n_h, n_w in SPATIAL_TILINGS]
    cells += [("plateau-dcp-4-2x2", "dcp", 4, plateau, (2, 2), torch.float32, True),
              ("packed-bf16-dcp-4-2x2", "dcp", 4, ramp_u8, (2, 2), torch.bfloat16,
               False)]
    errs, vs_b7 = {}, {"t": 0.0}
    staged_launches, staged_steps = {}, 0
    sync_lists = {}
    launches = {"fused_transmission_halo": 0, "staged.merge_topk": 0,
                "staged.merge_ema": 0}
    launches |= {f"fused_transmission_halo.{p}": 0 for p in fk.TILED_HALO_PASSES}
    corner_tiles = None
    for label, alg_, k, frames, tiling, plane_dt, against_b7 in cells:
        cfg = DehazeConfig(algorithm=alg_, topk=k, kernel_mode="fused",
                           io_dtype="uint8")
        halo = cfg.patch_radius + 2 * cfg.gf_radius
        kw = dict(algorithm=alg_, radius=cfg.patch_radius, omega=cfg.omega,
                  beta=cfg.beta, refine=cfg.refine, gf_radius=cfg.gf_radius,
                  gf_eps=cfg.gf_eps, topk=k, out_dtype=cfg.out_dtype)
        x = ref.upcast_frames(frames)
        pre = alg.premap(x, a_saved, cfg).to(plane_dt)
        guide = alg.luminance(x).to(plane_dt)
        tiles = spatial_tiles(frames, x, pre, guide, halo, tiling)
        for r, tile in enumerate(tiles):
            check_halo_tile(tile, kw, errs, f"{label} tile {r}")
        reset_launches()
        t_parts, synced, lists = spatial_step(cfg, tiles)
        per_step = {f"fused_transmission_halo.{p}": len(tiles)
                    for p in fk.TILED_HALO_PASSES if p != "topk_block" or k > 1}
        per_step |= {"fused_transmission_halo": len(tiles), "staged.merge_ema": 1}
        counts = path_launches(f"spatial {label}", 1, per_step)
        for name in launches:
            launches[name] += counts[name]
        cand = check_spatial_sync(synced, lists, k, cfg, label, errs)
        if tiling == (2, 2) and frames is ramp_u8 and against_b7:
            sync_lists[f"{alg_}-{k}"] = (lists, k)
        if against_b7:
            t7, _, cand7 = fk.fused_transmission(frames, a_saved, **kw)
            torch.cuda.synchronize()
            e_t = max_err(stitch(t_parts, tiling), t7)
            same = torch.equal(cand, cand7.float())
            check(e_t <= 2e-4, f"{label}: stitched t vs B7a {e_t} > 2e-4")
            check(same, f"{label}: merged candidate differs from B7a's by "
                  f"{max_err(cand, cand7)}")
            vs_b7["t"] = max(vs_b7["t"], e_t)
        print(f"spatial {label}: ok", flush=True)
        if label == "dcp-1-2x2":
            corner_tiles = (tiles[0], tiles[3])
        if tiling == (2, 2) and against_b7 and frames is ramp_u8:
            staged_steps += check_staged_spatial(alg_, k, frames, x, pre, guide, tiles,
                                                 a_saved, staged_launches, vs_b7, errs)
    check_halo_cells(errs, ramp_u8, a_saved)
    x = ref.upcast_frames(ramp_u8)
    cfg = DehazeConfig(kernel_mode="fused", io_dtype="uint8")
    interior = spatial_tiles(ramp_u8, x, alg.premap(x, a_saved, cfg), alg.luminance(x),
                             cfg.patch_radius + 2 * cfg.gf_radius, (4, 4))[5]
    check_masked_strips(errs, corner_tiles, interior)
    print("spatial passes " + json.dumps(errs) + " vs B7a and the unsharded staged "
          "stage " + json.dumps(vs_b7) + " launches " + json.dumps(launches)
          + " staged spatial steps " + json.dumps(staged_launches), flush=True)
    return errs, vs_b7, launches, len(cells), staged_launches, staged_steps, sync_lists


# A staged spatial step of a 2 x 2 tiling (kernel_mode "pallas"): per tile
# one masked min filter and six masked box filters (their strips), and the
# state sync once a step.
STAGED_SPATIAL_PER_STEP = {"staged.masked_min_filter": 4, "staged.masked_box_filter": 24,
                           "staged.merge_ema": 1}


def check_staged_spatial(alg_, k, frames, x, pre, guide, tiles, a_saved, counts,
                         vs, errs) -> int:
    """The staged branch of the spatial step (``spatial_shard_stage(...,
    fused=False)`` with kernel_mode "pallas") on the 2 x 2 tiles: launches
    as :data:`STAGED_SPATIAL_PER_STEP`, no synchronising call; the
    stitched t within 2e-4 of the unsharded staged stage on the same frames
    (the frame-sharded step's, every row valid), the state sync bit-equal
    to its plain version, and the lists' merged candidate through B10
    bit-equal to that stage's k picks through B10 (and within 1e-6 of their
    mean, the frame-sharded step's candidate). Adds the launches to
    ``counts``; returns the steps run (1)."""
    from repro_torch.core import DehazeConfig
    from repro_torch.core.pipeline import spatial_shard_stage
    from repro_torch.kernels import ops
    label = f"staged {alg_}-{k}-2x2"
    cfg = DehazeConfig(algorithm=alg_, topk=k, kernel_mode="pallas", io_dtype="uint8")
    reset_launches()
    t_parts, synced, lists = spatial_step(cfg, tiles, fused=False)
    for name, n in path_launches(f"spatial {label}", 1, STAGED_SPATIAL_PER_STEP).items():
        counts[name] = counts.get(name, 0) + n
    cand = check_spatial_sync(synced, lists, k, cfg, label, errs)
    valid = torch.ones(H, dtype=torch.bool, device="cuda")
    t, tk_t, tk_rgb, gidx = spatial_shard_stage(cfg, frames, x, pre, guide, valid, None,
                                                0, 0, W, fused=False)
    whole = ops.merge_topk_candidates(tk_t, gidx, tk_rgb, k, mode="pallas")
    torch.cuda.synchronize()
    e_t = max_err(stitch(t_parts, (2, 2)), t)
    check(e_t <= 2e-4, f"{label}: stitched t vs the unsharded staged stage {e_t} > 2e-4")
    check(torch.equal(cand, whole), f"{label}: merged candidate differs from the "
          f"unsharded stage's picks by {max_err(cand, whole)}")
    e_mean = max_err(cand, tk_rgb.mean(1))
    check(e_mean <= 1e-6, f"{label}: merged candidate vs the stage's mean {e_mean}")
    vs["staged_t"] = max(vs.get("staged_t", 0.0), e_t)
    print(f"spatial {label}: ok (t vs the unsharded staged stage {e_t}, candidate "
          "bit-equal)", flush=True)
    return 1


def masked_planes(plane, vr, vc, rng):
    """``plane`` with its invalid pixels (rows ``vr``, columns ``vc``
    invalid) set to +inf, -inf or NaN: what the kernels must never read."""
    mask = vr[:, None] & (vc[None, :] if vc is not None else True)
    bad = torch.from_numpy(rng.choice(np.array([np.inf, -np.inf, np.nan], np.float32),
                                      tuple(plane.shape))).to(plane.device, plane.dtype)
    return torch.where(mask, plane, bad).contiguous()


def check_masked_strips(errs, corner_tiles, interior) -> None:
    """B8a and B8b alone: the masked strips (and the row window past their
    limit, by shape) against their plain versions with error 0 (the mean
    bit for bit) and against the row window they replaced value for value,
    no NaN; on both 2 x 2 corner tiles' planes (rows and columns invalid at
    the top and left, and at the bottom and right), an interior 4 x 4
    tile's (all valid: the blocks skip the mask), float32 and bfloat16,
    the corner planes with +-inf and NaN in their invalid pixels, at r in
    {0, 2, 7, 20}, and at each masked kind's strip limit and one past it on
    a 2 x 100 x 90 corner of a plane. The C library's ``st_strips_fit``
    agrees with ``strips_fit`` at each limit."""
    rng = np.random.default_rng(19)
    cells = []
    for t_i, tile in enumerate(corner_tiles + (interior,)):
        _, _, pre_ext, guide_ext, vr, vc = tile[:6]
        where = "interior" if t_i == 2 else f"corner {t_i}"
        for dt in (torch.float32, torch.bfloat16):
            tag = f"{where} {str(dt).replace('torch.', '')}"
            cells += [(pre_ext.to(dt), vr, vc, f"pre-map {tag}"),
                      (guide_ext.to(dt), vr, vc, f"luma {tag}")]
            if t_i < 2:
                cells.append((masked_planes(guide_ext.to(dt), vr, vc, rng), vr, vc,
                              f"+-inf/NaN invalid {tag}"))
    for name in ("masked_min_filter", "masked_box_filter"):
        for x, vr, vc, label in cells:
            for r in (0, 2, 7, 20):
                check_masked_route(name, x, vr, vc, r, label, errs)
        for dt in (torch.float32, torch.bfloat16):
            x, vr, vc = cells[0][0][:2, :100, :90].to(dt), cells[0][1][:100], cells[0][2][:90]
            x = masked_planes(x.contiguous(), vr, vc, rng)
            for r in strip_limit_radii(name, dt):
                check_masked_route(name, x, vr, vc, r, f"limit {dt}", errs)
    print(f"B8a/B8b alone on {len(cells)} planes x r in (0, 2, 7, 20) and the strips' "
          "limits: equal to the plain versions and the row window, error 0", flush=True)
    reset_launches()


def check_masked_route(name, x, vr, vc, r, label, errs) -> None:
    """``cuda_<name>`` must launch one masked kernel, the strips where
    ``strips_fit`` and the row window (``wide_launches``) past it, equal
    the plain version with error 0 (``torch.equal``), equal the row window
    run by hand, and hold no NaN; its error goes to ``errs[name]``
    (``errs["wide." + name]`` for the row window)."""
    from repro_torch.kernels import staged as sk
    reset_launches()
    got = sk.PAIRS[name][0](x, vr, r, vc)
    torch.cuda.synchronize()
    wide = not sk.strips_fit(name, r, x.dtype)
    check(sk.launches[name] == 1 and sk.wide_launches[name] == int(wide)
          and sum(sk.launches.values()) == 1,
          f"staged {name} {label} r={r}: launches {sk.launches[name]}, row window "
          f"{sk.wide_launches[name]}, expected 1 and {int(wide)}")
    want = sk.PAIRS[name][1](x, vr, r, vc)
    old = sk._masked_window(name, x, vr, r, vc, wide=True)
    torch.cuda.synchronize()
    err = max_err(got, want)
    check(err == 0.0 and torch.equal(got, want), f"staged {name} {label} r={r}: error {err}")
    check(torch.equal(got, old), f"staged {name} {label} r={r}: differs from the row "
          f"window by {max_err(got, old)}")
    check(not bool(torch.isnan(got.float()).any()), f"staged {name} {label} r={r}: NaN")
    key = f"wide.{name}" if wide else name
    errs[key] = max(errs.get(key, 0.0), err)


# ---------------------------------------------------------------------------
# Phase 14: the spatial kernels timed
# ---------------------------------------------------------------------------

def phase_spatial_times():
    """B9 on a corner tile of the 2x2 tiling and on an interior tile of a
    4x4 one (DCP top-4, 32 uint8 frames of 480x640, float32 planes), its
    masked tiled sequence and its ten masked passes in turns, and on the
    corner tile each tiled pass alone; B8a on the corner tile's pre-map
    plane (r = 7) and B8b on its luma plane (r = 20), the masked strips
    and the row window they replaced in turns (old, new, new, old), each
    also by device busy time, as a call in a replayed CUDA graph and with
    its blocks an SM; B10 on the four 2x2 tiles' lists (M = 16, k = 4); the
    staged spatial tile stage on the corner tile with the masked strips
    and with the plain masked filters in turns, and its top-k candidates'
    sort alone. Bounds count each input read once and each output written
    once."""
    from repro_torch.core import DehazeConfig
    from repro_torch.core import algorithms as alg
    from repro_torch.core.pipeline import spatial_shard_stage
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import ref
    from repro_torch.kernels import staged as sk
    n, k = L * B, 4
    cfg = DehazeConfig(topk=k, kernel_mode="fused", io_dtype="uint8")
    halo = cfg.patch_radius + 2 * cfg.gf_radius
    frames = to_wire(ramps(9, n).reshape(-1, 3), torch.uint8).reshape(
        n, H, W, 3).cuda()
    x = ref.upcast_frames(frames)
    a_saved = torch.tensor([0.9, 0.85, 0.8], device="cuda")
    pre, guide = alg.premap(x, a_saved, cfg), alg.luminance(x)
    tiles = spatial_tiles(frames, x, pre, guide, halo, (2, 2))
    interior = spatial_tiles(frames, x, pre, guide, halo, (4, 4))[5]
    kw = dict(algorithm="dcp", radius=7, omega=0.95, beta=1.0, refine=True,
              gf_radius=20, gf_eps=1e-3, topk=k, out_dtype=None)
    outs = [spatial_shard_stage(cfg, *tile, W, fused=True) for tile in tiles]
    tk_t, tk_rgb, gidx = (torch.cat([o[q] for o in outs], dim=1) for q in (1, 2, 3))
    cand = sk.cuda_merge_topk(tk_t, gidx, tk_rgb, k)

    def merge_library():
        by_idx = torch.sort(gidx, dim=1, stable=True).indices
        by_t = torch.sort(torch.gather(tk_t, 1, by_idx), dim=1, stable=True).indices
        pick = torch.gather(by_idx, 1, by_t)[:, :k]
        return torch.gather(tk_rgb, 1, pick[..., None].expand(-1, -1, 3)).mean(1)

    out = {}
    kr, kg = 2 * kw["radius"] + 1, 2 * kw["gf_radius"] + 1
    for name, tile in (("fused_transmission_halo", tiles[0]),
                       ("fused_transmission_halo.interior", interior)):
        args = tile[:1] + tile[2:6]         # less the compute view
        res = fk.fused_transmission_halo(*args, **kw)
        s = fk.make_halo_static(*args[:3], **kw)
        check(fk.halo_tiled_fits(s), f"{name}: the serving shape must fit")
        vh = sk.validity_bytes(args[3], s.h_ext, "cuda")
        vw = sk.validity_bytes(args[4], s.w_ext, "cuda")
        px = {p: (r[0].stop - r[0].start) * (r[1].stop - r[1].start) * s.N
              for p in ("tmap_tile", "guided_ab", "refine_tmap")
              for r in (s.region(p),)}
        # Sliding-window operations as phase 12 counts them, less the
        # pre-map (an input here), each on the part of the plane its pass
        # writes; the direct sums' likewise.
        ops = 12 * px["tmap_tile"] + 30 * px["guided_ab"] + 13 * px["refine_tmap"]
        direct = ((2 * kr + 2) * px["tmap_tile"] + (8 * kg + 14) * px["guided_ab"]
                  + (4 * kg + 4) * px["refine_tmap"])
        r = turns(lambda a=args: fk.fused_transmission_halo(*a, **kw),
                  lambda a=args: fk.run_halo_passes(*a[:3], vh, vw, s))
        r.update(plain_ms=time_ms(lambda a=args: ref.fused_transmission_halo(*a, **kw),
                                  reps=3, warmup=1),
                 library_ms=None, blocks_per_sm=list(fk.halo_occupancy(s)))
        out[name] = rates(r, nbytes(*args, *res), ops, direct)
        if name == "fused_transmission_halo":      # each tiled pass alone
            C, P = fk.TILED_HALO_CUDA_PASSES, fk.TILED_HALO_PLAIN_PASSES
            img, pre_e, guide_e = args[:3]
            t_ext, t_core, _ = C["tmap_tile"](pre_e, vh, vw, s)
            keys = C["topk_block"](t_core, s)
            lists = C["topk_list"](keys, img, s)
            ab = C["guided_ab"](guide_e, t_ext, vh, vw, s)
            t9 = C["refine_tmap"](t_core, guide_e, ab, vh, vw, s)
            blocks = dict(zip(("tmap_tile", "guided_ab", "refine_tmap"),
                              fk.halo_occupancy(s)))
            # Bytes: each plane read on the part of it that a pass needs
            # (its output region, widened by the window: the region of the
            # pass before), each output written on its region.
            core_px, pe, ge = t_core.numel(), pre_e.element_size(), guide_e.element_size()
            for p, a_, nb, o, d in (
                    ("tmap_tile", (pre_e, vh, vw),
                     (pe + 4) * px["tmap_tile"] + 4 * core_px,
                     12 * px["tmap_tile"], (2 * kr + 2) * px["tmap_tile"]),
                    ("topk_block", (t_core,), nbytes(t_core, keys), 4 * core_px, 0),
                    ("topk_list", (keys, img), nbytes(keys, *lists) + 3 * s.N * s.topk,
                     keys.numel(), 0),
                    ("guided_ab", (guide_e, t_ext, vh, vw),
                     (ge + 4) * px["tmap_tile"] + 8 * px["guided_ab"],
                     30 * px["guided_ab"], (8 * kg + 14) * px["guided_ab"]),
                    ("refine_tmap", (t_core, guide_e, ab, vh, vw),
                     8 * px["guided_ab"] + (ge + t9.element_size()) * core_px,
                     13 * px["refine_tmap"], (4 * kg + 4) * px["refine_tmap"])):
                fn = lambda a=a_, c=C[p]: c(*a, s)          # noqa: E731
                rp = dict(ms=time_ms(fn),
                          plain_ms=time_ms(lambda a=a_, q=P[p]: q(*a, s), reps=3, warmup=1),
                          library_ms=None, device_busy_ms=device_busy_ms(fn),
                          graph_ms=graph_ms(fn), blocks_per_sm=blocks.get(p))
                out[f"fused_transmission_halo.{p}"] = rates(rp, nb, o, d)
    _, _, pre_ext, guide_ext, vr, vc = tiles[0][:6]
    mask = (vr[:, None] & vc[None, :])
    # The masks as the kernels' bytes, so the wrapper converts nothing.
    vr, vc = vr.to(torch.uint8), vc.to(torch.uint8)
    mins = sk.cuda_masked_min_filter(pre_ext, vr, 7, vc)
    means = sk.cuda_masked_box_filter(guide_ext, vr, 20, vc)
    mask_f = mask.float()[None, None]
    h_ext = pre_ext.shape[1]
    # B8a and B8b: the masked strips and the row window they replaced
    # (window_kernel) in turns, old/new/new/old, as phase 12 times B3b.
    work = {}
    work["masked_min_filter"] = (
        (pre_ext, vr, 7, vc),
        lambda: -F.max_pool2d(-torch.where(mask, pre_ext, torch.inf)[:, None], 15, 1, 7),
        nbytes(pre_ext, mins, vr, vc), 2 * pre_ext.numel())
    work["masked_box_filter"] = (
        (guide_ext, vr, 20, vc),
        lambda: (F.avg_pool2d(torch.where(mask, guide_ext, 0.0)[:, None], 41, 1, 20)
                 / F.avg_pool2d(mask_f, 41, 1, 20).clamp_min(1.0 / 41 ** 2)),
        nbytes(guide_ext, means, vr, vc), 5 * guide_ext.numel())
    for name, (args, lib, nb, ops) in work.items():
        new = lambda a=args, n_=name: sk.PAIRS[n_][0](*a)                      # noqa: E731
        old = lambda a=args, n_=name: sk._masked_window(n_, *a, wide=True)     # noqa: E731
        order = [(m, time_ms(fn)) for m, fn in (("old", old), ("new", new), ("new", new),
                                                ("old", old))]
        mean = {m: sum(v for q, v in order if q == m) / 2 for m in ("new", "old")}
        plain_ms = time_ms(lambda a=args, n_=name: sk.PAIRS[n_][1](*a), reps=5, warmup=1)
        lib_r = dict(ms=time_ms(lib), device_busy_ms=device_busy_ms(lib), graph_ms=graph_ms(lib))
        blocks = (sk.strips_occupancy(name, args[2], torch.float32, h_ext),
                  sk.window_occupancy(args[2], h_ext, name))
        for route, fn, blk in (("new", new, blocks[0]), ("old", old, blocks[1])):
            r = dict(ms=mean[route], plain_ms=plain_ms, library_ms=lib_r["ms"],
                     library_busy_ms=lib_r["device_busy_ms"],
                     library_graph_ms=lib_r["graph_ms"], device_busy_ms=device_busy_ms(fn),
                     graph_ms=graph_ms(fn), blocks_per_sm=blk, turns_ms=[v for _, v in order])
            key = f"staged.{name}" if route == "new" else f"staged.wide.{name}"
            out[key] = rates(r, nb, ops)
    work = {"staged.merge_topk": (
        lambda: sk.cuda_merge_topk(tk_t, gidx, tk_rgb, k),
        lambda: sk.plain_merge_topk(tk_t, gidx, tk_rgb, k),
        merge_library, nbytes(tk_t, gidx, tk_rgb, cand), tk_t.numel() * k)}
    for name, (kernel, plain, lib, nb, ops) in work.items():
        # device_busy_ms: the kernels' own time a call; where it is well
        # below ms, the host's launch rate sets ms.
        out[name] = rates(dict(ms=time_ms(kernel), plain_ms=time_ms(plain, reps=5, warmup=1),
                               library_ms=time_ms(lib) if lib else None,
                               device_busy_ms=device_busy_ms(kernel)), nb, ops)
    # The staged spatial tile stage (spatial_shard_stage's staged branch,
    # kernel_mode "pallas") on the corner tile with the masked strips and
    # with the plain masked filters ("ref"), in turns; the stable sort of
    # its top-k candidates alone. Bound: each plane read once, t written
    # once.
    stage = {m: (lambda c=DehazeConfig(topk=k, kernel_mode=m, io_dtype="uint8"):
                 spatial_shard_stage(c, *tiles[0], W, fused=False))
             for m in ("pallas", "ref")}
    t_stage, *lists = stage["pallas"]()
    order = [(m, time_ms(stage[m], reps=10)) for m in ("ref", "pallas", "pallas", "ref")]
    mean = {m: sum(v for q, v in order if q == m) / 2 for m in ("pallas", "ref")}
    t_raw_core = 1.0 - 0.95 * mins[:, halo:-halo, halo:-halo]
    x_core = tiles[0][1]
    out["staged_spatial_stage"] = rates(dict(
        ms=mean["pallas"], plain_ms=mean["ref"], library_ms=None, turns_ms=[v for _, v in order],
        device_busy_ms=device_busy_ms(stage["pallas"]),
        plain_busy_ms=device_busy_ms(stage["ref"]),
        topk_candidates_ms=time_ms(lambda: ref.topk_candidates(t_raw_core.contiguous(),
                                                               x_core, k))),
        nbytes(pre_ext, guide_ext, t_stage, *lists), 0)
    card = card_line()
    for name in ("fused_transmission_halo", "fused_transmission_halo.interior"):
        r = out[name]
        print(f"B9 {'corner (2x2)' if name == 'fused_transmission_halo' else 'interior (4x4)'}"
              f" tile, turns ten/tiled/tiled/ten {r['turns_ms']} ms: tiled {r['ms']} ms "
              f"(device busy {r['device_busy_ms']}, CUDA graph {r['graph_ms']}), ten "
              f"masked passes {r['ten_pass_ms']} ms (device busy "
              f"{r['ten_pass_busy_ms']}, CUDA graph {r['ten_pass_graph_ms']}), bound "
              f"{r['bound_ms']} ms ({r['bound_by']}), direct-sum floor {r['floor_ms']} "
              f"ms, blocks an SM {r['blocks_per_sm']}; {card}", flush=True)
    for name in ("masked_min_filter", "masked_box_filter"):
        new_r, old_r = out[f"staged.{name}"], out[f"staged.wide.{name}"]
        print(f"staged {name} on the corner tile ({tuple(pre_ext.shape)} float32, turns "
              f"old/new/new/old {new_r['turns_ms']} ms): strips {new_r['ms']} ms, in a CUDA "
              f"graph {new_r['graph_ms']}, device busy {new_r['device_busy_ms']}, "
              f"{new_r['blocks_per_sm']} blocks an SM; row window {old_r['ms']} ms, in a CUDA "
              f"graph {old_r['graph_ms']}, device busy {old_r['device_busy_ms']}, "
              f"{old_r['blocks_per_sm']} blocks an SM; bound {new_r['bound_ms']} ms "
              f"({new_r['bound_by']}); plain {new_r['plain_ms']} ms; PyTorch call "
              f"{new_r['library_ms']} ms, in a CUDA graph {new_r['library_graph_ms']}; {card}",
              flush=True)
    r = out["staged_spatial_stage"]
    print(f"staged spatial tile stage (corner tile, top-{k}, turns ref/pallas/pallas/ref "
          f"{r['turns_ms']} ms): masked strips {r['ms']} ms (device busy "
          f"{r['device_busy_ms']}), plain masked filters {r['plain_ms']} ms (device busy "
          f"{r['plain_busy_ms']}); its top-k candidates' stable sort alone "
          f"{r['topk_candidates_ms']} ms; bound {r['bound_ms']} ms; {card}", flush=True)
    print("spatial kernel times " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 15: the zero-copy overlapped serve tick
# ---------------------------------------------------------------------------

def serve_many_once(cfg, vids, per_tick: dict, label: str, overlap: bool,
                    keep: bool = True):
    """``serve_many`` of ``vids`` on 4 lanes, the blocking or (``overlap``)
    the overlapped tick path, launch counters zeroed just before and read
    just after: every frame once and in order, no skip, no straggler, every
    tick on the path asked for. Returns the report, the delivered frames
    (``keep``), the final store states and the launch counts."""
    from repro_torch.stream import ElasticServer, StreamRequest
    outs, order = {}, {}

    def sink(sid, fid, frame):
        order.setdefault(sid, []).append(fid)
        if keep:
            outs[(sid, fid)] = frame

    srv = ElasticServer(cfg, batch=8, timeout_s=2.0)
    reset_launches()
    rep = srv.serve_many([StreamRequest(f"cam{i}", iter(v))
                          for i, v in enumerate(vids)], n_lanes=4, sink=sink,
                         tick_overlap=overlap)
    counts = path_launches(label, rep.ticks, per_tick)
    check(rep.skipped == 0 and rep.stragglers == 0,
          f"{label}: {rep.skipped} skipped, {rep.stragglers} stragglers")
    check(rep.overlap_ticks == (rep.ticks if overlap else 0),
          f"{label}: {rep.overlap_ticks} of {rep.ticks} ticks overlapped")
    for i, v in enumerate(vids):
        check(order.get(f"cam{i}") == list(range(len(v))),
              f"{label}: cam{i} frames not exactly once in order")
    finals = {f"cam{i}": srv.store.get(f"cam{i}") for i in range(len(vids))}
    return rep, outs, finals, counts


def check_same_serves(label: str, blocking, overlapped) -> None:
    """The overlapped serve's frames and final states against the blocking
    one's: equal bit for bit (max error 0)."""
    (_, outs_b, fin_b, _), (_, outs_o, fin_o, _) = blocking, overlapped
    check(outs_b.keys() == outs_o.keys(), f"{label}: other frames delivered")
    err = max(max_err(outs_o[k], outs_b[k]) for k in outs_b)
    check(err == 0.0, f"{label}: overlapped J differs from blocking by {err}")
    for sid, st in fin_b.items():
        for f in ("A", "last_update", "initialized"):
            check(torch.equal(getattr(fin_o[sid], f), getattr(st, f)),
                  f"{label}: final {sid}.{f} differs")


def check_overlap_sync_free(cfg, lane_native: bool) -> None:
    """``stage`` of 4 lanes plus ``tick`` on the overlapped adapter make no
    synchronising CUDA call (host frames and ids in pageable memory, the
    state on the device, as the serve loop passes them)."""
    from repro_torch.core import init_atmo_state_lanes
    from repro_torch.stream.elastic import _cached_multi_step
    from repro_torch.stream.iobuf import LaneTickStep
    dev = torch.device("cuda")
    adapter = LaneTickStep(_cached_multi_step(cfg, L, lane_native, dev,
                                              donate="state"), L)
    lanes = [torch.from_numpy(np.random.default_rng(5 + i).integers(
        0, 256, (B, H, W, 3), dtype=np.uint8)) for i in range(L)]
    ids = torch.arange(L * B, dtype=torch.int32).reshape(L, B)
    state = init_atmo_state_lanes(L, "cuda")

    def stage_and_tick(state):
        for i, f in enumerate(lanes):
            adapter.stage(i, f)
        return adapter.tick(ids, state).state

    state = stage_and_tick(state)               # buffers, pinned blocks
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stage_and_tick(state)
    except RuntimeError as e:
        fail(f"overlapped stage + tick synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def overlap_trace(cfg, vids, per_tick: dict) -> dict:
    """A ``torch.profiler`` trace of 6 overlapped ticks (4 streams x 48
    frames): the frames' H2D and J's D2H (every copy of 1 MB or more) must
    run on streams other than the kernels' stream; returns the share of the
    copies' time that runs while a kernel runs on the kernels' stream."""
    from torch.profiler import ProfilerActivity, profile
    trace = ROOT / "build" / "overlap_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rep, _, _, _ = serve_many_once(cfg, vids, per_tick,
                                       "overlap (profiled) serve_many", True,
                                       keep=False)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(kernels, "the profiler recorded no kernel")
    by_stream = {}
    for e in kernels:
        st = e["args"].get("stream")
        by_stream[st] = by_stream.get(st, 0.0) + e["dur"]
    compute = max(by_stream, key=by_stream.get)
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and e["args"].get("bytes", 0) >= 1 << 20]
    kinds = {k: [e for e in copies if k in e["name"]] for k in ("HtoD", "DtoH")}
    for k, evs in kinds.items():
        check(evs, f"no {k} copy of 1 MB or more in the overlapped trace")
        on_compute = [e for e in evs if e["args"].get("stream") == compute]
        check(not on_compute, f"{len(on_compute)} of {len(evs)} {k} copies "
              f"on the kernels' stream {compute}")
    def union(evs):
        merged = []
        for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in evs):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    merged = union([e for e in kernels if e["args"].get("stream") == compute])

    def shared(a, b):
        return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)

    # The device's idle share over the span of its work: neither a kernel
    # nor a copy (of any size) running.
    device = union(kernels + [e for e in events if e.get("cat") == "gpu_memcpy"])
    span = device[-1][1] - device[0][0]
    out = {"ticks": rep.ticks, "kernel_stream": compute,
           "copy_streams": sorted({e["args"].get("stream") for e in copies}),
           "kernels_us": sum(b - a for a, b in merged), "span_us": span,
           "idle_share": 1.0 - sum(b - a for a, b in device) / span}
    for k, evs in kinds.items():
        total = sum(e["dur"] for e in evs)
        out[k] = {"copies": len(evs), "bytes": sum(e["args"]["bytes"] for e in evs),
                  "us": total,
                  "concurrent_share": sum(shared(e["ts"], e["ts"] + e["dur"])
                                          for e in evs) / total}
    return out


def phase_overlap(vids, paths) -> dict:
    """Phase 15 (module docstring): ``paths`` maps a path's name to its
    config and its per-tick launches. Returns the overlapped
    ``serve_many``'s launch counts by path, the throughput turns, the
    trace's copy shares and the CLI's tick-I/O line."""
    from repro_torch.core.pipeline import donation_spec, resolve_lane_native
    from repro_torch.stream import ElasticServer
    res = {"launches": {}, "turns": {}}
    edge = [vids[0], vids[1][:29], vids[2][:13]]   # an idle lane, partial batches
    for name, (cfg, per_tick) in paths.items():
        runs = [serve_many_once(cfg, vids, per_tick, f"{name} {tag} serve_many", ov)
                for tag, ov in (("blocking", False), ("overlap", True))]
        check_same_serves(f"{name} serve_many", *runs)
        check(runs[1][0].d2h_bytes == runs[0][0].d2h_bytes,
              f"{name}: full lanes fetched {runs[1][0].d2h_bytes} bytes "
              f"overlapped, {runs[0][0].d2h_bytes} blocking")
        res["launches"][name] = runs[1][3]
        del runs
        edges = [serve_many_once(cfg, edge, per_tick,
                                 f"{name} {tag} serve_many (3 streams, 4 lanes)", ov)
                 for tag, ov in (("blocking", False), ("overlap", True))]
        check_same_serves(f"{name} serve_many, 3 streams on 4 lanes", *edges)
        check(edges[1][0].d2h_bytes < edges[0][0].d2h_bytes,
              f"{name}: the idle lane's and partial batches' padding was fetched")
        del edges
        # One stream through serve: uint8, and float32, whose uploaded
        # batches receive J (donation_spec offers the frames).
        for dtype, frames in (("uint8", vids[0]), ("float32", vids[0] / np.float32(255))):
            cfg_d = dataclasses.replace(cfg, io_dtype=dtype)
            check((0 in donation_spec(cfg_d)) == (dtype == "float32"),
                  f"donation_spec({dtype}) = {donation_spec(cfg_d)}")
            got = []
            for ov in (False, True):
                srv, outs = ElasticServer(cfg_d, batch=8, timeout_s=2.0), {}
                reset_launches()
                rep = srv.serve(iter(frames), stream_id="cam0", tick_overlap=ov,
                                sink=lambda fid, f: outs.setdefault(fid, f))
                path_launches(f"{name} serve {dtype}{' overlap' if ov else ''}",
                              rep.ticks, per_tick)
                check(rep.overlap_ticks == (rep.ticks if ov else 0)
                      and rep.skipped == 0 and sorted(outs) == list(range(len(frames))),
                      f"{name} serve {dtype} overlap={ov}: {rep.overlap_ticks} of "
                      f"{rep.ticks} overlapped, {rep.skipped} skipped")
                got.append((outs, srv.store.get("cam0")))
            err = max(max_err(got[1][0][f], got[0][0][f]) for f in got[0][0])
            check(err == 0.0 and torch.equal(got[1][1].A, got[0][1].A),
                  f"{name} serve {dtype}: overlapped vs blocking error {err}")
        check_overlap_sync_free(cfg, resolve_lane_native(cfg))
        print(f"{name}: overlapped serve_many and serve equal the blocking ones "
              "bit for bit (4 streams, 3 streams on 4 lanes, serve uint8 and "
              "float32); stage + tick make no synchronising call", flush=True)
        # Throughput in turns: blocking, overlap, overlap, blocking. The
        # order-only sink drops each frame, so its pinned block goes back
        # to the pinned pool: the second overlapped run must not grow it.
        turns = []
        for ov in (False, True, True, False):
            r = phase_throughput(cfg, vids, per_tick, f"{name} ", tick_overlap=ov)
            turns.append({"overlap": ov, "fps": r.fps,
                          "ms_per_tick": r.wall_s / r.ticks * 1e3,
                          "d2h_bytes": r.d2h_bytes, "phases": r.phases,
                          "pinned_pool_bytes": torch.cuda.host_memory_stats().get(
                              "allocated_bytes.current")})
        pool = [t["pinned_pool_bytes"] for t in turns]
        if None in pool:
            print(f"{name}: pinned pool not measured (host_memory_stats keys "
                  f"{sorted(torch.cuda.host_memory_stats())[:12]})", flush=True)
        else:
            check(pool[2] <= pool[1], f"{name}: the second overlapped run grew "
                  f"the pinned pool from {pool[1]} to {pool[2]} bytes")
            print(f"{name}: pinned pool after each turn {pool} bytes", flush=True)
        res["turns"][name] = turns
    # The spout alone: batching 4 x 192 frames as the throughput runs do.
    from repro_torch.stream import Spout
    t0 = time.perf_counter()
    n_batches = sum(1 for v in vids for _ in Spout(
        itertools.chain.from_iterable([v] * 4), batch=8))
    res["spout_ms_per_tick"] = (time.perf_counter() - t0) * 1e3 * L / n_batches
    print(f"spout batching alone: {res['spout_ms_per_tick']} ms a tick of "
          f"{L} lanes", flush=True)
    res["trace"] = overlap_trace(paths["fused"][0], vids, paths["fused"][1])
    print("overlapped copies (fused, 6 ticks): " + json.dumps(res["trace"]), flush=True)

    env = dict(os.environ, REPRO_TICK_OVERLAP="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + [
                   p for p in [os.environ.get("PYTHONPATH")] if p]))
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--resolution", "480p",
         "--streams", "4", "--lanes", "4", "--frames", "64", "--io-dtype",
         "uint8", "--expect-overlap", "--fail-on-skipped"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    print(cli.stdout, end="", flush=True)
    check(cli.returncode == 0, f"serve CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
    res["cli"] = next(line for line in cli.stdout.splitlines()
                      if line.startswith("tick_io:"))
    return res


# ---------------------------------------------------------------------------
# Phase 16: the elastic serving tier (autoscale, eviction, fleet)
# ---------------------------------------------------------------------------

def recording_autoscalers():
    """Make ``serve_many`` build autoscalers that record themselves (for
    their warm-up logs and switches); returns the list they go into."""
    from repro_torch.stream import autoscale, elastic
    made = []

    class Recording(autoscale.LaneAutoscaler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    elastic.LaneAutoscaler = Recording
    return made


def elastic_serve(cfg, streams, per_tick: dict, label: str, warm_calls=None,
                  digests: bool = True, **kw):
    """``serve_many`` of ``streams`` ((sid, frames, request kwargs)), the
    launch counters zeroed just before and read just after: every frame
    once and in order, float32 (H, W, 3) in the sink, no skip or
    straggler, every tick on the tick path asked for (frames are compared
    by their CRC-32, which every bit of a frame enters). ``warm_calls()``
    gives the warm-up calls the run made, which launch the kernels of a
    tick each. Returns the report, each frame's digest by (sid, fid), the
    order of (sid, fid) deliveries, the final store states and cursors,
    the launch counts and the server."""
    from repro_torch.stream import ElasticServer, StreamRequest
    outs, seq, bad = {}, [], []
    lock = threading.Lock()

    def sink(sid, fid, frame):
        if tuple(frame.shape) != (H, W, 3) or frame.dtype != torch.float32:
            bad.append(f"{sid}:{fid} output {tuple(frame.shape)} {frame.dtype}")
        digest = zlib.crc32(frame.numpy()) if digests else None
        with lock:
            seq.append((sid, fid))
            outs[(sid, fid)] = digest

    srv = ElasticServer(cfg, batch=8, timeout_s=2.0)
    reset_launches()
    rep = srv.serve_many([StreamRequest(sid, iter(f), **rkw)
                          for sid, f, rkw in streams], sink=sink, **kw)
    extra = warm_calls() if warm_calls else 0
    counts = path_launches(f"{label} ({rep.ticks} ticks, {extra} warm-ups)",
                           rep.ticks + extra, per_tick)
    check(not bad, f"{label}: " + "; ".join(bad[:5]))
    check(rep.skipped == 0 and rep.stragglers == 0,
          f"{label}: {rep.skipped} skipped, {rep.stragglers} stragglers")
    overlap = bool(kw.get("tick_overlap"))
    check(rep.overlap_ticks == (rep.ticks if overlap else 0),
          f"{label}: {rep.overlap_ticks} of {rep.ticks} ticks overlapped")
    lengths = {}
    for sid, frames, _ in streams:
        lengths[sid] = len(frames)
        got = [fid for s, fid in seq if s == sid]
        check(got == list(range(len(frames))),
              f"{label}: {sid} frames not exactly once in order")
    check(rep.frames == sum(lengths.values()), f"{label}: {rep.frames} frames")
    finals = {sid: (srv.store.get(sid), srv.store.cursor(sid)) for sid in lengths}
    return rep, outs, seq, finals, counts, srv


def check_same_elastic(label: str, got, want) -> None:
    """Two serves' frames (digests) and final states and cursors: equal."""
    _, outs_g, _, fin_g, _, _ = got
    _, outs_w, _, fin_w, _, _ = want
    check(outs_g.keys() == outs_w.keys(), f"{label}: other frames delivered")
    diff = [k for k in outs_w if outs_g[k] != outs_w[k]]
    check(not diff, f"{label}: {len(diff)} frames differ, first {diff[:3]}")
    for sid, (st, cur) in fin_w.items():
        st_g, cur_g = fin_g[sid]
        check(cur_g == cur, f"{label}: {sid} cursor {cur_g} != {cur}")
        for f in ("A", "last_update", "initialized"):
            check(torch.equal(getattr(st_g, f), getattr(st, f)),
                  f"{label}: final {sid}.{f} differs")


def check_switch_sync_free(cfg, lane_native: bool) -> None:
    """The scheduler's rung switch on the overlapped path (``_maybe_autoscale``:
    the lookup of the warmed rung's adapter, the state gathered into the
    new rung's, the commit), grow then shrink, makes no synchronising CUDA
    call and moves the live lanes' state rows bit for bit."""
    from repro_torch.core import init_atmo_state_lanes
    from repro_torch.stream import (LaneAutoscaler, MultiStreamScheduler,
                                    ScalePolicy, StreamStateStore,
                                    TickBufferPool)
    from repro_torch.stream.elastic import _cached_multi_step
    dev = torch.device("cuda")
    pool = TickBufferPool(lambda n: _cached_multi_step(
        cfg, n, lane_native, dev, donate="state"), device=dev)
    scaler = LaneAutoscaler(pool.adapter, (2, 4), policy=ScalePolicy(
        rungs=(2, 4), dwell_up=1, dwell_down=1))
    sched = MultiStreamScheduler(scaler.acquire_initial(), StreamStateStore(),
                                 n_lanes=2, autoscaler=scaler)
    scaler.ensure_warming((B, H, W, 3), torch.uint8)
    scaler.wait_warm(timeout=120.0, raise_on_error=True)
    packed = init_atmo_state_lanes(2, dev)
    packed.A.copy_(torch.tensor([[0.5, 0.6, 0.7], [0.8, 0.9, 1.0]]))
    packed.last_update.copy_(torch.tensor([16, 24], dtype=torch.int32))
    packed.initialized.fill_(True)
    rows = packed.clone()
    sched._lanes, sched._pending = ["a", "b"], ["queued"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grown = sched._maybe_autoscale(packed)
        sched._lanes, sched._pending = [None, "b", None, None], []
        shrunk = sched._maybe_autoscale(grown)
    except RuntimeError as e:
        fail(f"a rung switch synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check([(x["from"], x["to"]) for x in scaler.switches] == [(2, 4), (4, 2)],
          f"switch check: switches {scaler.switches}")
    check(sched._step is pool.adapter(2) and sched.n_lanes == 2,
          "switch check: the shrink did not return to rung 2's adapter")
    for f in ("A", "last_update", "initialized"):
        check(torch.equal(getattr(grown, f)[:2], getattr(rows, f))
              and torch.equal(getattr(shrunk, f)[0], getattr(rows, f)[1]),
              f"switch check: {f} rows not moved bit for bit")


def phase_elastic(vids, paths) -> dict:
    """Phase 16 (module docstring): ``paths`` maps a path's name to its
    config and its per-tick launches. Returns launch counts, switch and
    warm-up times, the fps turns and the CLI lines."""
    from repro_torch.core.pipeline import resolve_lane_native
    from repro_torch.stream import DEADLINE_CLOCK, ScalePolicy
    scalers = recording_autoscalers()
    main_thread = threading.get_ident()
    ramp = [(f"r{i}", vids[i % 4], {}) for i in range(5)] + [
        (f"r{i}", np.concatenate([vids[i % 4]] * 4), {}) for i in (5, 6)]
    policy = ScalePolicy(rungs=(2, 4), dwell_up=1, dwell_down=2,
                         evict_tardy_after=None)
    fleet = [(f"f{i}", vids[i % 4], {}) for i in range(8)]
    res = {"launches": {}, "switches": [], "warm": [], "turns": {}}
    t_lap = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        print(f"phase 16: {what} took {now - t_lap[0]:.1f} s", flush=True)
        t_lap[0] = now

    def warm_calls():
        return sum(len(sc.warm_log) for sc in scalers)

    for name, (cfg, per_tick) in paths.items():
        for ov in (False, True):
            tag = f"{name} {'overlap' if ov else 'blocking'}"
            # The autoscaled ramp against the fixed-cap serve.
            fixed = elastic_serve(cfg, ramp, per_tick, f"{tag} fixed 4-lane ramp",
                                  n_lanes=4, tick_overlap=ov)
            scalers.clear()
            auto = elastic_serve(cfg, ramp, per_tick, f"{tag} autoscaled ramp",
                                 warm_calls=warm_calls, n_lanes=4,
                                 autoscale=True, policy=policy, tick_overlap=ov)
            rep = auto[0]
            check(rep.ladder_switches >= 2 and rep.warm_failures == 0
                  and rep.n_lanes == 2,
                  f"{tag}: {rep.ladder_switches} switches, {rep.warm_failures} "
                  f"warm failures, {rep.n_lanes} lanes at the end")
            logs = [e for sc in scalers for e in sc.warm_log]
            check(logs and all(e["thread"] != main_thread for e in logs),
                  f"{tag}: warm-ups {logs} not off the serve thread")
            check_same_elastic(f"{tag} autoscaled vs fixed", auto, fixed)
            res["switches"] += [dict(x, path=tag) for sc in scalers
                                for x in sc.switches]
            res["warm"] += [{"path": tag, "rung": e["rung"], "s": e["s"]}
                            for e in logs]
            if ov:
                res["launches"][name, "autoscale"] = auto[4]
            del fixed, auto
            # Deadline-aware eviction on one lane.
            tardy = np.concatenate([vids[0], vids[0]])
            ev = elastic_serve(
                cfg, [("tardy", tardy, {"deadline": DEADLINE_CLOCK() - 1.0}),
                      ("waiter", vids[1][:32], {})], per_tick,
                f"{tag} eviction", digests=False, n_lanes=1,
                policy=ScalePolicy(evict_tardy_after=2), tick_overlap=ov)
            rep, _, seq = ev[:3]
            check(rep.evictions == 1 and rep.admissions == 3,
                  f"{tag} eviction: {rep.evictions} evictions, "
                  f"{rep.admissions} admissions")
            check(seq.index(("waiter", 31)) < seq.index(("tardy", 95)),
                  f"{tag} eviction: the waiter finished after the tardy stream")
            solo = elastic_serve(cfg, [("tardy", tardy, {})], per_tick,
                                 f"{tag} uninterrupted", digests=False,
                                 n_lanes=1, tick_overlap=ov)
            for f in ("A", "last_update", "initialized"):
                check(torch.equal(getattr(ev[3]["tardy"][0], f),
                                  getattr(solo[3]["tardy"][0], f)),
                      f"{tag} eviction: the tardy stream's final {f} differs")
            # The fleet against one host.
            one = elastic_serve(cfg, fleet, per_tick, f"{tag} 1 host x 2 lanes",
                                n_lanes=2, tick_overlap=ov)
            for pol in ("first-fit", "hash"):
                got = elastic_serve(cfg, fleet, per_tick,
                                    f"{tag} fleet 2 x 2 ({pol})", n_lanes=2,
                                    n_hosts=2, placement_policy=pol,
                                    tick_overlap=ov)
                rep = got[0]
                check(rep.n_hosts == 2 and rep.migrations == 0
                      and (pol != "first-fit" or rep.spillovers >= 1),
                      f"{tag} fleet ({pol}): {rep.migrations} migrations, "
                      f"{rep.spillovers} spillovers")
                check_same_elastic(f"{tag} fleet ({pol}) vs 1 host", got, one)
                if ov and pol == "first-fit":
                    res["launches"][name, "fleet"] = got[4]
            del one, got
            lap(tag)
        check_switch_sync_free(cfg, resolve_lane_native(cfg))
        print(f"{name}: autoscaled ramps equal fixed 4-lane serves, eviction "
              "resumes bit-exactly, 2 x 2 fleets equal 1 x 2 serves, blocking "
              "and overlapped; a rung switch makes no synchronising call",
              flush=True)

    # Printed, not gated: fps in turns on the fused overlapped path.
    cfg, per_tick = paths["fused"]
    runs = {"autoscaled": dict(streams=ramp, n_lanes=4, autoscale=True,
                               policy=policy),
            "fixed 4 lanes": dict(streams=ramp, n_lanes=4),
            "fleet 2 x 2": dict(streams=fleet, n_lanes=2, n_hosts=2),
            "1 host x 4": dict(streams=fleet, n_lanes=4)}
    for pair in (("autoscaled", "fixed 4 lanes"), ("fleet 2 x 2", "1 host x 4")):
        for run in (pair[0], pair[1], pair[1], pair[0]):
            kw = dict(runs[run])
            scalers.clear()
            r = elastic_serve(cfg, kw.pop("streams"), per_tick,
                              f"fused overlap {run} (throughput)",
                              warm_calls=warm_calls, digests=False,
                              tick_overlap=True, **kw)[0]
            res["turns"].setdefault(run, []).append(r.fps)

    lap("fps turns")

    # The CLI's two gates, as two processes at once (their own fps lines
    # are printed, not compared).
    env = {k: v for k, v in os.environ.items() if k != "REPRO_TICK_OVERLAP"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src")] + [
        p for p in [os.environ.get("PYTHONPATH")] if p])
    procs = [(args, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--resolution",
         "480p"] + args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
        for args in (["--streams", "6", "--lanes", "4", "--autoscale",
                      "--ladder", "2,4", "--ramp", "--expect-switches", "2",
                      "--io-dtype", "uint8", "--fail-on-skipped"],
                     ["--streams", "8", "--hosts", "2", "--lanes", "4",
                      "--frames", "32", "--expect-spillover", "1",
                      "--fail-on-skipped"])]
    res["cli"] = []
    for args, proc in procs:
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        print(out, end="", flush=True)
        check(proc.returncode == 0,
              f"serve CLI {' '.join(args)} exited {proc.returncode}: "
              f"{err[-2000:]}")
        res["cli"] += [line for line in out.splitlines()
                       if line.startswith(("ladder_switches=", "spillovers=",
                                           "frames="))]
    lap("serve CLI")
    return res


# ---------------------------------------------------------------------------
# Phase 18: frames over several batch axes, ops.launch_count, the aliases
# ---------------------------------------------------------------------------

# all_launches' names that sum other counters (a stage's whole runs) or
# split one (the routes past the strips' limits): ops.launch_count has
# neither.
DERIVED_COUNTERS = ("fused_dehaze_lanes", "fused_transmission",
                    "fused_transmission_halo")


def per_call(counts: dict, calls: int) -> dict:
    """``counts`` (all_launches' names, over ``calls`` calls) as
    ``ops.launch_count`` gives one call's: the kernels that launched, a
    call's share each, and the total."""
    out = {}
    for name, n in counts.items():
        if n and name not in DERIVED_COUNTERS and not name.startswith("staged.wide."):
            check(n % calls == 0, f"{name}: {n} launches over {calls} calls")
            out[name] = n // calls
    out["total"] = sum(out.values())
    return out


def phase_multiaxis(vids, serve_counts) -> dict:
    """The frame-sharded step over two batch axes, ``("pod", "data")``, on
    a one-rank NCCL mesh of shape (1, 1, 1) ``("pod", "data", "model")``:
    a check of the single-rank path only, since every axis has size 1 (the
    gather takes one axis's group, no group over several axes is made and
    no tile is cut). Fused and staged (``kernel_mode="pallas"``), without
    and with ``height_axis="model"``, each two
    chained batches of 32 uint8 frames equal bit for bit to the one-axis
    step of phases 11 and 13 (``("data",)`` on ``make_host_mesh(1, 1)``),
    no synchronising call; ``ops.launch_count`` of every step call equal to
    phase 11's launches a step, and of one fused and one staged
    ``serve_many`` tick (4 streams x 8 frames) equal to phases 3 and 7's
    launches a tick (``serve_counts``: path -> (counts, ticks, config));
    ``ops.fused_dehaze_dcp`` on the card bit-equal to ``ops.fused_dehaze(...,
    algorithm="dcp")``; then each multi-axis step's ms back to back beside
    the one-axis step's, in turns (one, multi, multi, one)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import (DehazeConfig, PlacementSpec, init_atmo_state,
                                  make_sharded_dehaze_step, make_step)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import batch_axes_for, make_host_mesh
    from repro_torch.stream import ElasticServer, StreamRequest
    card = card_line()
    # launches: the multi-axis steps' kernels over their 8 checked calls.
    res = {"steps": {}, "serve": {}, "launches": {}}
    frames = to_wire(ramps(18, 2 * L * B).reshape(-1, 3), torch.uint8).reshape(
        2, L * B, H, W, 3).cuda()
    one = make_host_mesh(1, 1)
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        pod = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
        check(batch_axes_for(pod, L * B) == ("pod", "data"),
              f"batch_axes_for: {batch_axes_for(pod, L * B)}")
        for mode, per_step in (("fused", transmission_per_tick()),
                               ("pallas", STAGED_SHARDED_PER_STEP)):
            cfg = DehazeConfig(kernel_mode=mode, io_dtype="uint8")
            want_counts = per_call(per_step, 1)
            for height in (None, "model"):
                label = f"{mode} ('pod', 'data')" + (" height 'model'" if height else "")
                multi = make_step(cfg, PlacementSpec.frame_sharded(
                    ("pod", "data"), height, None), pod)
                single = make_sharded_dehaze_step(cfg, one, height_axis=height)
                st_m = st_1 = init_atmo_state("cuda")
                for batch in range(2):
                    ids = torch.arange(L * B, dtype=torch.int32, device="cuda") + L * B * batch
                    outs = []
                    got_counts = ops.launch_count(
                        lambda: outs.append(multi(frames[batch], ids, st_m)))
                    check(got_counts == want_counts, f"{label} b{batch}: launch_count "
                          f"{got_counts}, phase 11 a step {want_counts}")
                    for name, n in got_counts.items():
                        if name != "total":
                            res["launches"][name] = res["launches"].get(name, 0) + n
                    out = outs[0]
                    want = single(frames[batch], ids, st_1)
                    torch.cuda.synchronize()
                    for k in ("frames", "transmission", "atmo_light"):
                        check(torch.equal(getattr(out, k), getattr(want, k)),
                              f"{label} b{batch}: {k} differs from the one-axis step")
                    for k in ("A", "last_update", "initialized"):
                        check(torch.equal(getattr(out.state, k), getattr(want.state, k)),
                              f"{label} b{batch}: state.{k} differs from the one-axis step")
                    st_m, st_1 = out.state, want.state
                check(not hasattr(pod, "_batch_groups"),
                      f"{label}: a group over several axes on a one-rank mesh")
                check_no_sync(multi, frames[1], ids, st_m, label)
                turns = [time_ms(lambda f=fn: f(frames[1], ids, st_m))
                         for fn in (single, multi, multi, single)]
                res["steps"][label] = {"ms": (turns[1] + turns[2]) / 2,
                                       "one_axis_ms": (turns[0] + turns[3]) / 2,
                                       "turns_ms": turns, "launch_count": got_counts}
                print(f"phase 18 {label} step (32 x {H}x{W} uint8, back to back), turns "
                      f"one-axis/multi/multi/one-axis {turns} ms: multi-axis "
                      f"{res['steps'][label]['ms']} ms, one-axis "
                      f"{res['steps'][label]['one_axis_ms']} ms; bit-equal "
                      f"(single-rank path, every axis of size 1); "
                      f"launch_count {got_counts}; {card}", flush=True)
    finally:
        dist.destroy_process_group()

    # One serve tick on each serving path through ops.launch_count.
    for path, (counts, ticks, cfg) in serve_counts.items():
        srv = ElasticServer(cfg, batch=B, timeout_s=2.0)
        reps = []
        got = ops.launch_count(lambda: reps.append(srv.serve_many(
            [StreamRequest(f"cam{i}", iter(v[:B])) for i, v in enumerate(vids)],
            n_lanes=L)))
        check(reps[0].ticks == 1 and reps[0].frames == L * B and reps[0].skipped == 0,
              f"{path} serve_many tick: {reps[0].ticks} ticks, {reps[0].frames} frames")
        want = per_call(counts, ticks)
        check(got == want, f"{path} serve tick: launch_count {got}, phases 3/7 "
              f"a tick {want}")
        res["serve"][path] = got
        print(f"phase 18 {path} serve_many tick: launch_count {got} == phases 3/7 "
              f"a tick", flush=True)

    # The back-compat alias against its entry point on the card.
    st = init_atmo_state("cuda")
    kw = dict(radius=CFG_KW["radius"], omega=CFG_KW["omega"], refine=True,
              gf_radius=CFG_KW["gf_radius"], gf_eps=CFG_KW["gf_eps"], t0=CFG_KW["t0"],
              gamma=CFG_KW["gamma"], period=CFG_KW["period"], lam=CFG_KW["lam"],
              mode="fused")
    ids = torch.arange(B, dtype=torch.int32, device="cuda")
    outs = []
    alias_counts = ops.launch_count(lambda: outs.append(ops.fused_dehaze_dcp(
        frames[0][:B], ids, st.A, st.last_update, st.initialized, **kw)))
    got = outs[0]
    want = ops.fused_dehaze(frames[0][:B], ids, st.A, st.last_update,
                            st.initialized, algorithm="dcp", **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "ops.fused_dehaze_dcp differs from ops.fused_dehaze(algorithm='dcp')")
    want_alias = per_call(fused_per_tick(), 1)
    check(alias_counts == want_alias,
          f"ops.fused_dehaze_dcp launch_count {alias_counts}, expected {want_alias}")
    try:
        ops.fused_dehaze_dcp(frames[0][:B], ids, st.A, st.last_update,
                             st.initialized, frames_per_block=2, **kw)
        fail("ops.fused_dehaze_dcp took frames_per_block=2")
    except ValueError:
        pass
    print(f"phase 18 ops.fused_dehaze_dcp == ops.fused_dehaze(algorithm='dcp') bit "
          f"for bit on {B} uint8 frames; launch_count {alias_counts}", flush=True)
    return res


# ---------------------------------------------------------------------------
# Phase 17: the state sync (st_merge_ema) alone, and timed
# ---------------------------------------------------------------------------

# The serving shape's lanes: a warm lane whose ids skip, a cold lane behind
# padding frames, an all-padding lane and a cold consecutive lane.
SYNC_IDS = [[9, 10, 13, 14, 15, 16, 24, 25], [-1, -1, 0, 1, 2, 3, -1, 5],
            [-1] * 8, [40, 41, 42, 43, 44, 45, 46, 47]]


def sync_state(lanes: int, warm: bool = True):
    """A lane-batched state, lane 0 warm (A (0.8, 0.85, 0.9), last update
    2) where ``warm``, the others fresh."""
    from repro_torch.core import init_atmo_state_lanes
    st = init_atmo_state_lanes(lanes, "cuda")
    if warm:
        st.A[0] = torch.tensor([0.8, 0.85, 0.9], device="cuda")
        st.last_update[0] = 2
        st.initialized[0] = True
    return st


def sync_cells(sync_lists):
    """(label, args) of the state sync's cells, args as ``staged.
    cuda_merge_ema`` takes them up to the period: the serving shape (4
    lanes x 8 frames, one row a frame: the staged serve's); phase 13's
    (2, 2) lists (DCP top-1, M = 4, k = 1; CAP top-4, M = 16, k = 4) as the
    frame-sharded spatial step's one lane of 32 frames (ids 0..31, a fresh
    state) and as 4 lanes x 8 frames (the lane-sharded spatial step's, the
    serving shape's ids and states); and 4 x 8 frames of a 4 x 4 tiling's
    top-4 lists (M = 64, k = 4, t in plateaus tied across the rows). Rows'
    rgb are uint8 levels / 255, as frames give them."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(17)
    ids = torch.tensor(SYNC_IDS, dtype=torch.int32).cuda()

    def rgb(*lead):
        return ref.upcast_frames(torch.randint(0, 256, lead + (3,), generator=g,
                                               dtype=torch.uint8)).cuda()

    def state_args(st):
        return (st.A, st.last_update, st.initialized)
    cells = [("serving (4 x 8, M = 1)",
              (None, None, rgb(L, B, 1), 1, ids, *state_args(sync_state(L))))]
    for name, ((tk_t, gidx, tk_rgb), k) in sync_lists.items():
        n, m = tk_t.shape
        cells.append((f"spatial {name} 2x2 (1 x {n}, M = {m})",
                       (tk_t[None], gidx[None], tk_rgb[None], k,
                        torch.arange(n, dtype=torch.int32, device="cuda")[None],
                        *state_args(sync_state(1, warm=False)))))
        cells.append((f"spatial {name} 2x2 (4 x 8, M = {m})",
                       tuple(v.reshape(L, B, m).contiguous() for v in (tk_t, gidx))
                       + (tk_rgb.reshape(L, B, m, 3).contiguous(), k, ids,
                          *state_args(sync_state(L)))))
    m = 64
    t64 = (torch.randint(0, 8, (L, B, m), generator=g) / 8).float().cuda()
    g64 = torch.stack([torch.randperm(H * W, generator=g)[:m]
                       for _ in range(L * B)]).reshape(L, B, m).int().cuda()
    cells.append(("4x4 tiling top-4 (4 x 8, M = 64)",
                  (t64, g64, rgb(L, B, m), 4, ids, *state_args(sync_state(L)))))
    return cells


def phase_merge_ema(sync_lists, cfg_staged, vids):
    """The state sync (``staged.cuda_merge_ema``) against its plain version
    (``staged.plain_merge_ema``, the composition it replaces) on every cell
    of :func:`sync_cells`, both forms, period 8 (the serving config's) and
    1: max error 0 in a_seq and A, last_update and initialized equal; the
    same with the new state written into the state read (a donated state).
    Then, in turns (old, new, new, old), the kernel against the composition
    it replaces on the card: at the serving shape the PyTorch associative
    scan alone, on phase 13's lists (one lane of 32 frames) B10
    (``cuda_merge_topk``) and the scan; each by CUDA events, a call in a
    replayed CUDA graph and device busy time. Last the staged DCP lane step
    (the serving config) back to back with the kernel and with the old
    composition (``merge_ema_op`` set to the plain version), in turns, with
    its device kernels and busy time a step from a profiler trace."""
    from repro_torch.core import AtmoState, make_multi_stream_step
    from repro_torch.core import normalize
    from repro_torch.kernels import staged as sk
    period, lam = CFG_KW["period"], CFG_KW["lam"]
    errs = {}
    cells = sync_cells(sync_lists)
    for label, args in cells:
        for per in (period, 1):
            for assoc in (True, False):
                got = sk.cuda_merge_ema(*args, per, lam, assoc)
                want = sk.plain_merge_ema(*args, per, lam, assoc)
                out = tuple(v.clone() for v in args[-3:])
                inplace = sk.cuda_merge_ema(*args[:-3], *out, per, lam, assoc, out=out)
                torch.cuda.synchronize()
                e = max(sync_err(got, want), sync_err(inplace, want))
                check(e == 0.0, f"state sync {label} period {per} "
                      f"{'associative' if assoc else 'sequential'}: error {e} != 0")
                errs[label] = max(errs.get(label, 0.0), e)
    print("state sync (st_merge_ema) vs plain, max errors: " + json.dumps(errs),
          flush=True)

    def timed(new, old) -> dict:
        order = [(q, time_ms(fn)) for q, fn in (("old", old), ("new", new),
                                               ("new", new), ("old", old))]
        mean = {q: sum(v for r, v in order if r == q) / 2 for q in ("new", "old")}
        busy = {q: device_busy_ms(fn) for q, fn in (("new", new), ("old", old))}
        return dict(ms=mean["new"], replaced_ms=mean["old"],
                    turns_ms=[v for _, v in order], device_busy_ms=busy["new"],
                    replaced_busy_ms=busy["old"], graph_ms=graph_ms(new),
                    replaced_graph_ms=graph_ms(old))

    times = {}
    for key, (label, args) in (("serving", cells[0]),
                               *((f"spatial {name}", cells[1 + 2 * i])
                                 for i, name in enumerate(sync_lists))):
        tk_t, gidx, tk_rgb, k, ids, A, lu, init = args
        l_, b_, m = tk_rgb.shape[:3]
        st = AtmoState(A, lu, init)
        new = (lambda a=args: sk.cuda_merge_ema(*a, period, lam, True))
        if m == 1:
            def old(r=tk_rgb[:, :, 0], i=ids, s_=st):
                return normalize.ema_scan_associative(r, i, s_, period, lam)
        else:
            def old(a=(tk_t[0], gidx[0], tk_rgb[0], k), i=ids, s_=st):
                cand = sk.cuda_merge_topk(*a)
                return normalize.ema_scan_associative(cand[None], i, s_, period, lam)
        r = timed(new, old)
        res = new()
        r["plain_ms"] = time_ms(lambda a=args: sk.plain_merge_ema(*a, period, lam, True),
                                reps=5, warmup=1)
        r["library_ms"] = None
        # Bytes: the lists, ids and state read once, a_seq and the state
        # written once; operations: the M^2 key compares a frame.
        times[key] = rates(r, nbytes(*(v for v in args if isinstance(v, torch.Tensor)),
                                     *res), l_ * b_ * m * m)
        times[key]["shape"] = [l_, b_, m, k]
    card = card_line()
    for key, r in times.items():
        print(f"state sync {key} (L, B, M, k = {r['shape']}), turns old/new/new/old "
              f"{r['turns_ms']} ms: st_merge_ema {r['ms']} ms, graph {r['graph_ms']}, "
              f"device busy {r['device_busy_ms']}; replaced {r['replaced_ms']} ms, graph "
              f"{r['replaced_graph_ms']}, device busy {r['replaced_busy_ms']}; plain "
              f"{r['plain_ms']} ms; bound {r['bound_ms']} ms ({r['bound_by']}); {card}",
              flush=True)

    # The staged DCP lane step at the serving config, back to back on
    # device-resident uint8 frames, with the kernel and with the old
    # composition (the plain version: the merge's identity at M = 1 and the
    # PyTorch scan), in turns.
    step = make_multi_stream_step(cfg_staged, device="cuda")
    u8 = torch.from_numpy(np.stack([v[:B] for v in vids])).cuda()
    ids = torch.arange(B, dtype=torch.int32).repeat(L, 1).cuda()
    state = sync_state(L)
    kernel_op = sk.merge_ema_op

    def run(route):
        sk.merge_ema_op = kernel_op if route == "new" else sk.plain_merge_ema
        try:
            return step(u8, ids, state)
        finally:
            sk.merge_ema_op = kernel_op

    def with_route(route):
        return lambda: run(route)
    new_out, old_out = run("new"), run("old")
    torch.cuda.synchronize()
    e = max(max_err(new_out.atmo_light, old_out.atmo_light),
            max_err(new_out.frames, old_out.frames), max_err(new_out.state.A, old_out.state.A))
    check(e == 0.0, f"staged step with the state sync kernel vs the old composition: {e}")
    order = [(q, time_ms(with_route(q))) for q in ("old", "new", "new", "old")]
    mean = {q: sum(v for r, v in order if r == q) / 2 for q in ("new", "old")}
    step_r = {"ms": mean["new"], "replaced_ms": mean["old"],
              "turns_ms": [v for _, v in order]}
    for q in ("new", "old"):
        busy, kern, copies = busy_and_kernels(with_route(q))
        step_r["device_busy_ms" if q == "new" else "replaced_busy_ms"] = busy
        step_r["kernels_per_step" if q == "new" else "replaced_kernels_per_step"] = kern
        step_r["copies_per_step" if q == "new" else "replaced_copies_per_step"] = copies
    print(f"staged DCP lane step ({L} x {B} x {H}x{W} uint8, back to back), turns "
          f"old/new/new/old {step_r['turns_ms']} ms: with st_merge_ema {step_r['ms']} ms "
          f"a step, device busy {step_r['device_busy_ms']} ms, "
          f"{step_r['kernels_per_step']} kernels and {step_r['copies_per_step']} copies "
          f"a step; with the old composition {step_r['replaced_ms']} ms, device busy "
          f"{step_r['replaced_busy_ms']} ms, {step_r['replaced_kernels_per_step']} "
          f"kernels and {step_r['replaced_copies_per_step']} copies a step; {card}",
          flush=True)
    return {"errs": errs, "err": max(errs.values()), "times": times, "step": step_r}


# ---------------------------------------------------------------------------
# Phase 19: the tuning registry (the kernels' knobs)
# ---------------------------------------------------------------------------

def fused_variants():
    """Every knob set of the megakernel's tiled passes but the default:
    ``(tile, blocks_per_sm, lane_major)``."""
    from repro_torch.kernels import fused as fk
    default = (fk.DEFAULT_TILE, fk.BLOCKS_PER_SM[0], True)
    return [(t, b, lm) for t in fk.TILES for b in fk.BLOCKS_PER_SM
            for lm in (True, False) if (t, b, lm) != default]


def variant_name(tile: str, bps: int, lane_major: bool = True) -> str:
    return f"{tile}/{bps}" + ("" if lane_major else "/frame_major")


def variant_builds():
    """(source, defines) of every library variant but the defaults: built
    with phase 2's sources, all at once."""
    from repro_torch.kernels import fused as fk
    return [("fused_dehaze.cu", fk.variant_defines(t, b))
            for t in fk.TILES for b in fk.BLOCKS_PER_SM
            if fk.variant_defines(t, b)]


def add_counts(total: dict, name: str, counts: dict) -> None:
    into = total.setdefault(name, {})
    for k, n in counts.items():
        if n:
            into[k] = into.get(k, 0) + n


def check_variant_fits() -> None:
    """Each variant's shared-memory mirrors (``tiled_smem_fits``,
    ``transmission_tiled_fits``, ``halo_tiled_fits``) against its library's
    fits tests on both sides of the limits, and its library's constants."""
    from repro_torch.kernels import fused as fk
    img = {dt: torch.empty((1, 2, 50, 70, 3), dtype=dt, device="cuda")
           for dt in (torch.float32, torch.bfloat16, torch.uint8)}
    agree = 0
    for tile in fk.TILES:
        for bps in fk.BLOCKS_PER_SM:
            lib = fk.lib_for(fk.make_static(img[torch.uint8], radius=1, refine=True,
                                            gf_radius=1, gf_eps=1e-3, t0=0.1, gamma=1.0,
                                            period=1, lam=0.0, tile=tile,
                                            blocks_per_sm=bps))
            check((lib.fd_tile_h(), lib.fd_tile_w(), lib.fd_guided_min_blocks())
                  == (*fk.TILES[tile], bps), f"variant {tile}/{bps}: library constants")
            for dt, x in img.items():
                for r in (7, 20, 30, 36, 37, 52, 53, 66, 67):
                    for gr in (16, 17, 20, 32, 33, 45, 46):
                        s = fk.make_static(x, radius=r, refine=True, gf_radius=gr,
                                           gf_eps=1e-3, t0=0.1, gamma=1.0, period=1,
                                           lam=0.0, tile=tile, blocks_per_sm=bps)
                        p = ctypes.byref(s.params())
                        check(fk.tiled_smem_fits(s) == fk.tiled_fits(s)
                              and fk.transmission_tiled_fits(s)
                              == bool(lib.fd_transmission_tiled_fits(p)),
                              f"variant {tile}/{bps} {dt} r={r} gf_r={gr}: "
                              "mirror != library fits")
                        agree += 1
            for r, gr in ((88, 20), (89, 20), (7, 44), (7, 45), (7, 46)):
                plane = torch.empty((1, 40 + 2 * (r + 2 * gr), 50 + 2 * (r + 2 * gr)),
                                    device="cuda")
                s = fk.make_halo_static(img[torch.uint8][0, :1, :40, :50], plane, plane,
                                        radius=r, refine=True, gf_radius=gr,
                                        gf_eps=1e-3, tile=tile, blocks_per_sm=bps)
                check(fk.halo_tiled_fits(s)
                      == bool(lib.fd_halo_tiled_fits(ctypes.byref(s.params()))),
                      f"variant {tile}/{bps} halo r={r} gf_r={gr}: mirror != library")
                agree += 1
    print(f"variant fits: {agree} shapes, every mirror equal to its library's "
          "fits test", flush=True)


def check_b1_variants(launches: dict) -> None:
    """Every megakernel variant bit-equal to the default on phase 2's
    serving-shape cells (two chained batches, an all-padding lane, the
    plateau cells), through the wrapper; the counters must show the tiled
    passes (the ten where a variant's tiles do not fit)."""
    from repro_torch.kernels import fused as fk
    cells = [(alg, k, dt, True, 1.0, False)
             for alg in ("dcp", "cap") for k in (1, 4)
             for dt in (torch.float32, torch.uint8, torch.bfloat16)]
    cells += [("dcp", 1, torch.float32, False, 1.0, False),
              ("cap", 1, torch.uint8, False, 1.0 / 2.2, False)]
    cells += [("dcp", k, torch.uint8, True, 1.0, True) for k in (1, 4)]
    ramp = ramps(0, 2 * L * B).reshape(2, L, B, H, W, 3)
    plateau = plateau_frames(2 * L * B).reshape(2, L, B, H, W, 3)
    variants = fused_variants()
    runs = 0
    for alg, k, dt, refine, gamma, flat in cells:
        kw = dict(CFG_KW, algorithm=alg, topk=k, refine=refine, gamma=gamma)
        carries = {v: (torch.ones(L, 3, device="cuda"),
                       torch.tensor([[-(2 ** 30), 0]] * L, dtype=torch.int32,
                                    device="cuda"))
                   for v in [None] + variants}
        frames = plateau if flat else ramp
        for batch in range(2):
            img = to_wire(frames[batch].reshape(-1, 3), dt).reshape(
                L, B, H, W, 3).cuda()
            ids = (torch.arange(B, dtype=torch.int32) + B * batch).repeat(L, 1)
            ids[L - 1] = -1
            ids = ids.cuda()
            want = fk.fused_dehaze_lanes(img, ids, *carries[None], **kw)
            carries[None] = want[3:]
            for tile, bps, lm in variants:
                s = fk.make_static(img, tile=tile, blocks_per_sm=bps,
                                   lane_major=lm, **kw)
                fk.reset_launches()
                got = fk.fused_dehaze_lanes(img, ids, *carries[tile, bps, lm],
                                            tile=tile, blocks_per_sm=bps,
                                            lane_major=lm, **kw)
                torch.cuda.synchronize()
                cell = (f"{variant_name(tile, bps, lm)} {alg} k={k} {dt} "
                        f"refine={refine}{' plateau' if flat else ''} b{batch}")
                ran = {n: c for n, c in fk.launches.items() if c}
                fits = fk.tiled_fits(s)
                route = dict.fromkeys(fk.TILED_PASSES if fits else fk.PASSES, 1)
                if fits and k > 1:
                    route["topk_block"] = 1
                if fits and not refine:
                    del route["guided_ab"]
                check(ran == route, f"{cell}: launches {ran}, expected {route}")
                check(fk.variant_launches == {s.variant: sum(ran.values())},
                      f"{cell}: variant launches {fk.variant_launches}")
                e = max(max_err(g, w) for g, w in zip(got, want))
                check(e == 0.0 and all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"{cell}: not bit-equal to the default variant (max error {e})")
                add_counts(launches, variant_name(tile, bps, lm),
                           {"fused_dehaze_lanes": ran.get("tmap_tile", 0)}
                           | {f"fused_dehaze_lanes.{n}": c for n, c in ran.items()})
                carries[tile, bps, lm] = got[3:]
                runs += 1
    fk.reset_launches()
    print(f"B1 variants {[variant_name(*v) for v in variants]}: {runs} runs on "
          f"{len(cells)} serving-shape cells x 2 batches, bit-equal to the "
          "default (J, t, a_seq, both carries), the tiled passes launched",
          flush=True)


def b9_cells():
    """Phase 13's corner tiles: a 2 x 2 tiling of 32 uint8 frames, tiles 0
    and 3 (two corners), DCP top-1 and CAP top-4 on ramps and DCP top-4 on
    plateaus, the serving configuration."""
    from repro_torch.core import DehazeConfig
    from repro_torch.core import algorithms as alg
    from repro_torch.kernels import ref
    n = L * B
    a_saved = torch.tensor([0.9, 0.85, 0.8], device="cuda")
    ramp_u8 = to_wire(ramps(7, n).reshape(-1, 3), torch.uint8).reshape(
        n, H, W, 3).cuda()
    plateau = to_wire(plateau_frames(n).reshape(-1, 3), torch.uint8).reshape(
        n, H, W, 3).cuda()
    out = []
    for label, alg_, k, frames in (("dcp-1", "dcp", 1, ramp_u8),
                                   ("cap-4", "cap", 4, ramp_u8),
                                   ("plateau-dcp-4", "dcp", 4, plateau)):
        cfg = DehazeConfig(algorithm=alg_, topk=k, kernel_mode="fused",
                           io_dtype="uint8")
        kw = dict(algorithm=alg_, radius=cfg.patch_radius, omega=cfg.omega,
                  beta=cfg.beta, refine=cfg.refine, gf_radius=cfg.gf_radius,
                  gf_eps=cfg.gf_eps, topk=k, out_dtype=cfg.out_dtype)
        x = ref.upcast_frames(frames)
        tiles = spatial_tiles(frames, x, alg.premap(x, a_saved, cfg),
                              alg.luminance(x),
                              cfg.patch_radius + 2 * cfg.gf_radius, (2, 2))
        out += [(f"{label} tile {i}", tiles[i], kw) for i in (0, 3)]
    return out


def check_b9_variants(cells, launches: dict) -> None:
    """Every (tile, blocks an SM) of the halo stage bit-equal to the default
    on phase 13's corner tiles, the counters showing the masked tiled
    passes."""
    from repro_torch.kernels import fused as fk
    variants = [(t, b) for t, b, lm in fused_variants() if lm]
    for label, tile, kw in cells:
        img, _, pre, guide, vr, vc = tile[:6]
        want = fk.fused_transmission_halo(img, pre, guide, vr, vc, **kw)
        for t, b in variants:
            s = fk.make_halo_static(img, pre, guide, tile=t, blocks_per_sm=b, **kw)
            check(fk.halo_tiled_fits(s), f"B9 {t}/{b} {label}: must fit")
            fk.reset_launches()
            got = fk.fused_transmission_halo(img, pre, guide, vr, vc, tile=t,
                                             blocks_per_sm=b, **kw)
            torch.cuda.synchronize()
            ran = {n: c for n, c in fk.halo_launches.items() if c}
            route = {n: 1 for n in fk.TILED_HALO_PASSES
                     if n != "topk_block" or kw["topk"] > 1}
            check(ran == route, f"B9 {t}/{b} {label}: launches {ran}, expected {route}")
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"B9 {t}/{b} {label}: not bit-equal to the default "
                  f"({max(max_err(g, w) for g, w in zip(got, want))})")
            add_counts(launches, variant_name(t, b),
                       {"fused_transmission_halo": ran["tmap_tile"]}
                       | {f"fused_transmission_halo.{n}": c for n, c in ran.items()})
    fk.reset_launches()
    print(f"B9 variants {[variant_name(*v) for v in variants]} on phase 13's corner "
          "tiles (DCP-1, CAP-4, plateau DCP-4; tiles 0 and 3): bit-equal to the "
          "default, the masked tiled passes launched", flush=True)


def check_b6_variants(launches: dict) -> None:
    """B6a at every ``tile_pixels`` bit-equal to the default on phase 6's
    frames (ramp and plateau, 32 and 1 frames of 480x640, 32 of 481x643,
    float32 and bfloat16) and B6b on phase 9's (ramp, all-ties and
    signed-zero t, k 1, 2, 4 and the warp limit, 480x640 and 481x643)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import staged as sk
    others = sk.TOP1_TILES[1:]
    cases = []
    for n, h, w in ((L * B, H, W), (1, H, W), (L * B, 481, 643)):
        for x_np in (ramps(10, n, h, w), plateau_frames(n, h, w)):
            x = ref.upcast_frames(to_wire(x_np.reshape(-1, 3), torch.uint8)).reshape(
                n, h, w, 3).cuda()
            cases.append((x, 1.0 - 0.95 * sk.cuda_dark_channel(x, 7), (1,)))
    rng = np.random.default_rng(16)
    for n, h, w in ((L * B, H, W), (4, 481, 643)):
        u8 = to_wire(ramps(17, n, h, w).reshape(-1, 3), torch.uint8).reshape(n, h, w, 3)
        x = ref.upcast_frames(u8).cuda()
        ramp_t = 1.0 - 0.95 * sk.cuda_dark_channel(x, 7)
        zeros = torch.from_numpy(rng.random((n, h, w)) < 0.5).cuda()
        signs = torch.from_numpy(rng.random((n, h, w)) < 0.5).cuda()
        for t in (ramp_t, torch.full_like(ramp_t, 0.375),
                  torch.where(zeros, torch.where(signs, -0.0, 0.0), ramp_t)):
            cases.append((x, t, (1, 2, 4, sk.WARP_TOPK_MAX)))
    calls = 0
    for x, t, ks in cases:
        for dt in (torch.float32, torch.bfloat16):
            xd, td = x.to(dt), t.to(dt)
            for k in ks:
                name = "atmolight_topk" if k > 1 else "atmolight"
                fn = (lambda p: sk.cuda_atmolight_topk(xd, td, k, p)) if k > 1 \
                    else (lambda p: sk.cuda_atmolight(xd, td, p))
                want = fn(sk.TOP1_TILE)
                for p in others:
                    sk.reset_launches()
                    got = fn(p)
                    torch.cuda.synchronize()
                    check(torch.equal(bits(got), bits(want)),
                          f"staged {name} tile_pixels={p} {tuple(x.shape)} {dt} "
                          f"k={k}: not bit-equal to the default tile")
                    check(sk.launches[name] == 1 and not any(sk.wide_launches.values()),
                          f"staged {name} tile_pixels={p}: route")
                    add_counts(launches, f"tile_pixels={p}", {f"staged.{name}": 1})
                    calls += 1
    sk.reset_launches()
    print(f"B6a/B6b at tile_pixels {list(others)}: {calls} calls on phase 6's and "
          "9's frames, bit-equal to the default tile", flush=True)


def knob_turns(default, candidate) -> dict:
    """A default call and a candidate's in turns (default, candidate,
    candidate, default) by CUDA events, and each a call in a replayed
    CUDA graph."""
    order = [(n, time_ms(fn)) for n, fn in (("default", default), ("candidate", candidate),
                                            ("candidate", candidate), ("default", default))]
    mean = {n: sum(v for m, v in order if m == n) / 2 for n in ("default", "candidate")}
    return {"ms": mean["candidate"], "default_ms": mean["default"],
            "graph_ms": graph_ms(candidate), "default_graph_ms": graph_ms(default),
            "turns_ms": [v for _, v in order]}


def knob_times(b9_cell) -> dict:
    """Every candidate's ms beside the default's at the search's shapes:
    B1 at 4 x 8 and 1 x 8 x 480x640 uint8 (DCP top-1, refine), B9 on phase
    13's 2 x 2 corner tile, B6a and B6b (k = 4) on 32 float32 frames of
    480x640."""
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import staged as sk
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(0, 256, (L, B, H, W, 3), dtype=np.uint8)).cuda()
    ids = torch.arange(B, dtype=torch.int32, device="cuda").repeat(L, 1)
    cf = torch.ones(L, 3, device="cuda")
    ci = torch.tensor([[-(2 ** 30), 0]] * L, dtype=torch.int32, device="cuda")
    kw = dict(CFG_KW, algorithm="dcp", topk=1, refine=True)
    out = {}
    for t, b, lm in fused_variants():
        out[f"B1 {L}x{B} {variant_name(t, b, lm)}"] = knob_turns(
            lambda: fk.fused_dehaze_lanes(img, ids, cf, ci, **kw),
            lambda: fk.fused_dehaze_lanes(img, ids, cf, ci, tile=t, blocks_per_sm=b,
                                          lane_major=lm, **kw))
    # One stream of 8 frames: the fused_dcp bucket the search tunes.
    one = (img[:1], ids[:1], cf[:1], ci[:1])
    for t, b, lm in fused_variants():
        if lm:
            out[f"B1 1x{B} {variant_name(t, b)}"] = knob_turns(
                lambda: fk.fused_dehaze_lanes(*one, **kw),
                lambda: fk.fused_dehaze_lanes(*one, tile=t, blocks_per_sm=b, **kw))
    label, tile, hkw = b9_cell
    himg, _, pre, guide, vr, vc = tile[:6]
    for t, b, lm in fused_variants():
        if lm:
            out[f"B9 {variant_name(t, b)}"] = knob_turns(
                lambda: fk.fused_transmission_halo(himg, pre, guide, vr, vc, **hkw),
                lambda: fk.fused_transmission_halo(himg, pre, guide, vr, vc, tile=t,
                                                   blocks_per_sm=b, **hkw))
    x = torch.from_numpy(rng.random((L * B, H, W, 3), np.float32)).cuda()
    tt = torch.from_numpy(rng.random((L * B, H, W), np.float32)).cuda()
    for p in sk.TOP1_TILES[1:]:
        out[f"B6a tile_pixels={p}"] = knob_turns(
            lambda: sk.cuda_atmolight(x, tt), lambda: sk.cuda_atmolight(x, tt, p))
        out[f"B6b k=4 tile_pixels={p}"] = knob_turns(
            lambda: sk.cuda_atmolight_topk(x, tt, 4),
            lambda: sk.cuda_atmolight_topk(x, tt, 4, p))
    card = card_line()
    for name, r in out.items():
        print(f"knob {name}: {r['ms']} ms (default {r['default_ms']} ms; turns "
              f"{r['turns_ms']}), graph {r['graph_ms']} ms (default "
              f"{r['default_graph_ms']} ms); {card}", flush=True)
    return out


def run_cli(module: str, args, env_extra: dict, timeout: int = 300):
    """``python -m <module> <args>`` from the checkout, ``env_extra`` over
    the environment; returns the completed process (output printed)."""
    env = dict(os.environ, **env_extra)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src")] + [
        p for p in [os.environ.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-m", module] + list(args), cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=timeout)
    print(proc.stdout[-6000:], end="", flush=True)
    return proc


def tuned_serves(table: Path, vids) -> dict:
    """A fused and a staged ``serve_many`` (4 streams on 4 lanes, batch 8,
    uint8) with ``table`` the tuning table: the statics the megakernel ran
    and the tiles the atmospheric light took must be the table's winners
    for this card, and after a first serve a second one may make no table
    lookup and read no table."""
    from repro_torch.core import DehazeConfig
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import staged as sk
    from repro_torch.kernels import tuning
    from repro_torch.stream import ElasticServer, StreamRequest
    kind = torch.cuda.get_device_name(0)
    entries = json.loads(table.read_text())["device_kinds"][kind]
    lanes_win = entries["fused_lanes"][f"{L}x{B}x{H}x{W}xu8"]["params"]
    atmo_win = entries["atmolight"][f"{L * B}x{H}x{W}"]["params"]
    seen = {"statics": set(), "tiles": set()}
    run_tiled = fk.run_tiled_passes
    atmo = sk.cuda_atmolight

    def recording_tiled(img, ids, cf, ci, s, *a, **k):
        seen["statics"].add((s.tile, s.blocks_per_sm, s.lane_major))
        return run_tiled(img, ids, cf, ci, s, *a, **k)

    def recording_atmo(img, t, tile_pixels=sk.TOP1_TILE):
        seen["tiles"].add(tile_pixels)
        return atmo(img, t, tile_pixels)

    res = {}
    old = os.environ.get("REPRO_TORCH_KERNEL_TUNING")
    os.environ["REPRO_TORCH_KERNEL_TUNING"] = str(table)
    fk.run_tiled_passes, sk.cuda_atmolight = recording_tiled, recording_atmo
    try:
        for path, cfg in (("fused", DehazeConfig(kernel_mode="fused", io_dtype="uint8")),
                          ("staged", DehazeConfig(io_dtype="uint8"))):
            srv = ElasticServer(cfg, batch=B, timeout_s=2.0)
            srv.serve_many([StreamRequest(f"w{i}", iter(v[:B])) for i, v in enumerate(vids)],
                           n_lanes=L)
            reads, lookups = tuning.table_reads, tuning.lookups
            rep = srv.serve_many([StreamRequest(f"cam{i}", iter(v))
                                  for i, v in enumerate(vids)], n_lanes=L)
            res[path] = {"ticks": rep.ticks, "fps": rep.fps,
                         "table_reads": tuning.table_reads - reads,
                         "lookups": tuning.lookups - lookups}
            check(rep.skipped == 0, f"tuned {path} serve skipped {rep.skipped}")
            check(res[path]["table_reads"] == 0 and res[path]["lookups"] == 0,
                  f"tuned {path} serve: {res[path]['lookups']} lookups and "
                  f"{res[path]['table_reads']} table reads in {rep.ticks} ticks "
                  "after the first serve")
    finally:
        fk.run_tiled_passes, sk.cuda_atmolight = run_tiled, atmo
        if old is None:
            del os.environ["REPRO_TORCH_KERNEL_TUNING"]
        else:
            os.environ["REPRO_TORCH_KERNEL_TUNING"] = old
    want = (lanes_win["tile"], lanes_win["blocks_per_sm"],
            lanes_win["grid_order"] == "lane_major")
    check(seen["statics"] == {want}, f"tuned fused serve ran {seen['statics']}, "
          f"the table's winner is {lanes_win}")
    check(seen["tiles"] == {atmo_win["tile_pixels"]},
          f"tuned staged serve's atmospheric light took tiles {seen['tiles']}, "
          f"the table's winner is {atmo_win}")
    res["winners"] = {"fused_lanes": lanes_win, "atmolight": atmo_win}
    print("tuned serve_many (the --tune table): " + json.dumps(res), flush=True)
    return res


def phase_tuning(vids) -> dict:
    """The tuning registry (see the module docstring, phase 19)."""
    import contextlib
    import io
    import tempfile
    from repro_torch.kernels import tuning
    from repro_torch.launch import serve
    t0 = time.perf_counter()

    def lap(what):
        print(f"phase 19 {what}: {time.perf_counter() - t0:.1f} s", flush=True)

    launches: dict = {}
    check_variant_fits()
    check_b1_variants(launches)
    lap("B1 variants")
    cells = b9_cells()
    check_b9_variants(cells, launches)
    check_b6_variants(launches)
    lap("B9, B6a, B6b variants")
    res = {"launches": launches}
    kind = torch.cuda.get_device_name(0)
    committed = ROOT / "results" / "kernel_tuning_torch.json"
    old = os.environ.get("REPRO_TORCH_KERNEL_TUNING")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        try:
            # The search at the serving shapes, measuring only.
            os.environ["REPRO_TORCH_KERNEL_TUNING"] = str(Path(tmp) / "none.json")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = tuning.main(["--search", "--no-persist"])
            search = json.loads(buf.getvalue())
            stats = search["stats"]
            check(rc == 0 and stats["timed_runs"] < stats["exhaustive_runs"],
                  f"tuning --search: rc {rc}, timed {stats['timed_runs']} of "
                  f"{stats['exhaustive_runs']} exhaustive runs")
            # At the serving shapes every candidate fits: a skip is a
            # variant that failed to build or run.
            check(stats["skipped"] == {},
                  f"tuning --search skipped candidates: {stats['skipped']}")
            check(search["device_kind"] == kind and not Path(tmp, "none.json").exists(),
                  "tuning --search: device kind or --no-persist")
            res["search"] = {k: v for k, v in search.items()
                             if k not in ("path", "method")}
            print("tuning --search --no-persist (serving shapes): "
                  + json.dumps(res["search"]), flush=True)
            lap("search")
            # The committed table: valid, and measured on this card.
            os.environ["REPRO_TORCH_KERNEL_TUNING"] = str(committed)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = tuning.main(["--validate", "--require-kind", kind])
            check(rc == 0, f"tuning --validate --require-kind {kind!r}: "
                  f"{buf.getvalue()}")
            # REPRO_TUNE_REQUIRE_TABLE with an empty table: the serve CLI
            # exits non-zero.
            empty = Path(tmp) / "empty.json"
            empty.write_text("{}\n")
            os.environ["REPRO_TORCH_KERNEL_TUNING"] = str(empty)
            os.environ["REPRO_TUNE_REQUIRE_TABLE"] = "1"
            err = io.StringIO()
            try:
                with contextlib.redirect_stderr(err), \
                        contextlib.redirect_stdout(io.StringIO()):
                    rc = serve.main(["--resolution", "480p", "--streams", "4",
                                     "--lanes", "4", "--frames", "16",
                                     "--io-dtype", "uint8"])
            finally:
                del os.environ["REPRO_TUNE_REQUIRE_TABLE"]
            check(rc != 0 and "REPRO_TUNE_REQUIRE_TABLE" in err.getvalue(),
                  f"serve CLI with REPRO_TUNE_REQUIRE_TABLE=1 and no table: rc {rc}")
            # The serve CLI's --tune, its table in the temp dir.
            table = Path(tmp) / "tuned.json"
            cli = run_cli("repro_torch.launch.serve",
                          ["--tune", "--resolution", "480p", "--streams", "4",
                           "--lanes", "4", "--frames", "64", "--io-dtype", "uint8",
                           "--fail-on-skipped"],
                          {"REPRO_TORCH_KERNEL_TUNING": str(table)})
            check(cli.returncode == 0, f"serve CLI --tune exited {cli.returncode}: "
                  f"{cli.stderr[-2000:]}")
            check(not tuning.validate_table(tuning.load_table(table)),
                  "serve CLI --tune: its table does not validate")
            res["cli"] = [line for line in cli.stdout.splitlines()
                          if line.startswith(("tune:", "frames="))]
            lap("CLIs")
            res["serves"] = tuned_serves(table, vids)
            lap("tuned serves")
        finally:
            if old is None:
                os.environ.pop("REPRO_TORCH_KERNEL_TUNING", None)
            else:
                os.environ["REPRO_TORCH_KERNEL_TUNING"] = old
    res["times"] = knob_times(cells[0])
    lap("times")
    res["committed"] = held_against_default(committed, kind)
    lap("committed entries")
    return res


def held_against_default(committed: Path, kind: str) -> dict:
    """Every entry of the committed table for this card timed against the
    default knobs at its bucket, in turns of a replayed CUDA graph by the
    card's clock (``tuning.against_default``); fails where an entry is slower than the
    default by more than the turns' spread."""
    from repro_torch.kernels import tuning
    out = {}
    entries = json.loads(committed.read_text())["device_kinds"][kind]
    for op, buckets in sorted(entries.items()):
        for bucket, entry in sorted(buckets.items()):
            params = entry["params"]
            v = tuning.against_default(op, bucket, params, device="cuda")
            out[f"{op} {bucket}"] = dict(v, params=params)
            print(f"committed {op} {bucket} {params}: {v['candidate_us']} us, "
                  f"default {v['default_us']} us, spread {v['spread_us']} us "
                  f"({v['rounds']} rounds of turns); {card_line()}", flush=True)
            check(not v["slower"], f"committed {op} {bucket} {params} is slower "
                  f"than the default by more than the noise: {v}")
    return out


VISION_IDS = ("resnet-50", "convnext-b", "efficientnet-b7", "vit-l16")
VISION_TOL = 1e-3        # card vs CPU, float32, x max |logit|


def vision_model(arch: str, cfg):
    """``(param table, forward(params, images) -> logits)`` of a vision id."""
    from repro_torch.models import convnext, efficientnet, resnet, vit
    if arch == "vit-l16":
        return vit.vit_param_table(cfg), vit.make_forward(cfg)
    if arch == "convnext-b":
        return convnext.convnext_param_table(cfg), convnext.make_forward(cfg)
    mod, table = {"resnet-50": (resnet, resnet.resnet_param_table),
                  "efficientnet-b7": (efficientnet,
                                      efficientnet.efficientnet_param_table)}[arch]
    fwd = mod.make_forward(cfg, training=False)
    return table(cfg), lambda p, x: fwd(p, x)[0]


def conv_weights(params) -> list:
    """Every conv weight a forward hands ``F.conv2d``, in HWIO: the 4-D
    leaves (ViT's 4-D attention weights under ``layers`` are dense) and
    each layer of the 5-D stacked ones."""
    from repro_torch.tree import tree_flatten_with_path
    out = []
    for path, t in tree_flatten_with_path(params)[0]:
        if t.ndim == 5:
            out.extend(t.unbind(0))
        elif t.ndim == 4 and not path.startswith("['layers']"):
            out.append(t)
    return out


def phase_vision() -> dict:
    """Phase 20 (module docstring): the four vision ids' serving cells."""
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import ImageStream, prefetch_to_device
    from repro_torch.models import common as cm
    from repro_torch.tree import tree_leaves, tree_map
    out = {"serve": {}, "check": {}}
    torch.set_num_threads(os.cpu_count() or 1)
    with torch.inference_mode():
        for k, arch in enumerate(VISION_IDS):
            mod = configs.get_module(arch)
            cfg = mod.config()
            table, fwd = vision_model(arch, cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()     # earlier phases' tensors
            t0 = time.perf_counter()
            params = cm.init_params(table, 20 + k)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            weights = conv_weights(params)
            relayout_ms = time_ms(lambda: [w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last) for w in weights], reps=10)
            batches = {}
            for shape in ("serve_b1", "serve_b128"):
                cell = configs.VISION_SHAPES[shape]
                n, res = cell["batch"], cell["img_res"]
                stream = ImageStream(n, res, res, cfg.n_classes, seed=k)
                got = list(prefetch_to_device(itertools.islice(stream, 2), size=2))
                check(len(got) == 2, f"{arch} {shape}: prefetch gave {len(got)} batches")
                for b in got:
                    img = b["images"]
                    check(img.is_cuda and img.dtype == torch.float32
                          and tuple(img.shape) == (n, res, res, 3),
                          f"{arch} {shape}: batch {tuple(img.shape)} {img.dtype}")
                    logits = fwd(params, img)
                    check(tuple(logits.shape) == (n, 1000),
                          f"{arch} {shape}: logits {tuple(logits.shape)}")
                    check(bool(torch.isfinite(logits).all()),
                          f"{arch} {shape}: non-finite logits")
                img = got[0]["images"]
                batches[shape] = img
                ms = time_ms(lambda: fwd(params, img), reps=10)
                out["serve"][arch, shape] = {
                    "ms": ms, "images_per_s": n / ms * 1e3,
                    "dtype": cfg.dtype, "batch": n}
            out["serve"][arch, "peak_bytes"] = torch.cuda.max_memory_allocated() - base
            out["serve"][arch, "relayout_ms"] = relayout_ms
            out["serve"][arch, "conv_weights"] = len(weights)
            out["serve"][arch, "init_s"] = init_s
            # serve_b128's row 0 against serve_b1 on the same image.
            big = batches["serve_b128"]
            one = fwd(params, big[:1]).float()
            row0 = fwd(params, big)[:1].float()
            top2 = one.topk(2, dim=-1).values[0]
            out["check"][arch, "top1"] = {
                "b1": int(one.argmax()), "b128_row0": int(row0.argmax()),
                "margin": float(top2[0] - top2[1]),
                "max_diff": float((one - row0).abs().max())}
            check(int(one.argmax()) == int(row0.argmax()),
                  f"{arch}: serve_b128 row 0 top-1 {int(row0.argmax())} != serve_b1 "
                  f"{int(one.argmax())} (margin {float(top2[0] - top2[1])})")
            del params, weights
            # float32 on the card (TF32 off) against the CPU.
            cfg32 = mod.config(dtype="float32")
            table32, fwd32 = vision_model(arch, cfg32)
            p32 = cm.init_params(table32, 40 + k)
            img1 = batches["serve_b1"]
            card = fwd32(p32, img1).float().cpu()
            host = fwd32(tree_map(lambda t: t.cpu(), p32), img1.cpu()).float()
            scale = float(host.abs().max())
            err = float((card - host).abs().max())
            out["check"][arch, "float32"] = {"max_abs_err": err, "max_abs_logit": scale,
                                             "rel": err / scale}
            check(err <= VISION_TOL * scale,
                  f"{arch}: float32 card vs CPU {err} > {VISION_TOL} x {scale}")
            del p32, batches
            torch.cuda.empty_cache()
        # ResNet-50's params through the checkpoint manager.
        table, _ = vision_model("resnet-50", configs.get_module("resnet-50").config())
        params = cm.init_params(table, 60)
        ck_dir = ROOT / "build" / "vision_checkpoint"
        mgr = CheckpointManager(str(ck_dir), keep=1)
        t0 = time.perf_counter()
        mgr.save(0, params)
        save_s = time.perf_counter() - t0
        like = tree_map(torch.empty_like, params)
        t0 = time.perf_counter()
        restored, _, step = mgr.restore(like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        leaves, want = tree_leaves(restored), tree_leaves(params)
        check(step == 0 and len(leaves) == len(want), "checkpoint: leaves")
        for a, b in zip(leaves, want):
            check(a.is_cuda and a.dtype == b.dtype and torch.equal(a, b),
                  "checkpoint: a leaf differs after the round trip")
        nbytes_ = sum(t.numel() * t.element_size() for t in want)
        out["checkpoint"] = {"save_s": save_s, "restore_s": restore_s,
                             "bytes": nbytes_, "leaves": len(want)}
        shutil.rmtree(ck_dir, ignore_errors=True)
    return out


def print_vision(vi: dict, card: str) -> None:
    """Phase 20's lines (module docstring)."""
    for arch in VISION_IDS:
        for shape in ("serve_b1", "serve_b128"):
            r = vi["serve"][arch, shape]
            print(f"phase 20 {arch} {shape} ({r['dtype']}, TF32 off): {r['ms']} ms a "
                  f"forward (CUDA events, 3 warm-up + 10 timed), {r['images_per_s']} "
                  f"images/s", flush=True)
        print(f"phase 20 {arch}: peak memory {vi['serve'][arch, 'peak_bytes']} bytes "
              f"(max_memory_allocated over init and both cells, less what earlier "
              f"phases hold); conv weight relayout "
              f"{vi['serve'][arch, 'relayout_ms']} ms a forward "
              f"({vi['serve'][arch, 'conv_weights']} weights, timed alone); init "
              f"{vi['serve'][arch, 'init_s']} s", flush=True)
        f32, t1 = vi["check"][arch, "float32"], vi["check"][arch, "top1"]
        print(f"phase 20 {arch}: float32 card vs CPU max |diff| {f32['max_abs_err']} = "
              f"{f32['rel']} x max |logit| {f32['max_abs_logit']} (tolerance "
              f"{VISION_TOL}); top-1 serve_b1 {t1['b1']} serve_b128 row 0 "
              f"{t1['b128_row0']} (margin {t1['margin']}, max |diff| {t1['max_diff']})",
              flush=True)
    c = vi["checkpoint"]
    print(f"phase 20 checkpoint (resnet-50, {c['leaves']} leaves, {c['bytes']} bytes): "
          f"save {c['save_s']} s, restore to the card {c['restore_s']} s, bit-equal",
          flush=True)
    print(f"phase 20 card: {card}", flush=True)


# Phase 21: the training path and the LM family on the card. The cuts of
# the published cells (printed with the numbers, and in PERF.md).
VISION_TRAIN_BATCH = 32          # cls_224's global batch of 256, cut
LM_TRAIN_LAYERS = {"llama3-8b": 2, "granite-20b": 2, "moonshot-v1-16b-a3b": 2,
                   "llama4-scout-17b-a16e": 1}
LM_TRAIN_TOKENS = 4096           # train_4k's sequence, batch 1 of its 256
LM_SERVE = {"llama3-8b": (2, 4096), "granite-20b": (2, 4096),
            "moonshot-v1-16b-a3b": (2, 4096),
            "llama4-scout-17b-a16e": (4, 16384)}   # (layers, prompt tokens)
TRAIN_STEPS, DECODE_TOKENS = 4, 16
VISION_LR = 1e-3                 # the train CLI's default
LM_LR = 3e-4                     # Llama 3's published peak lr (arXiv:2407.21783)
UPDATE_RTOL = 1e-4               # card vs CPU: x lr, elementwise
LOGIT_RTOL = 1e-4                # card vs CPU: x max |logit|
TINY_G, MAX_TINY = 1e-6, 1e-3
LM_IDS = tuple(LM_TRAIN_LAYERS)
TRAIN_CUTS = (
    f"vision cls_224: batch {VISION_TRAIN_BATCH} of the published 256 (ResNet-50 "
    f"also at 256), {TRAIN_STEPS} steps on one repeated batch at lr {VISION_LR}; "
    f"LM train_4k at lr {LM_LR}: "
    f"{LM_TRAIN_TOKENS} tokens at batch 1 of the published 256, layers "
    f"{LM_TRAIN_LAYERS} (widths, heads, d_ff, vocab, experts, top-k and "
    f"chunk_attn published), {TRAIN_STEPS} steps on one repeated batch; LM "
    f"serving: (layers, prompt) {LM_SERVE} at batch 1, {DECODE_TOKENS} decode "
    f"tokens (llama4's 16384-token prompt is prefill_32k's 32768, cut)")


class Clock:
    """Milliseconds of a call: CUDA events on a card, the host clock on the
    CPU (a rehearsal of the phase)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __call__(self, fn):
        if not self.cuda:
            t0 = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e3
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)


def peak_reset(device) -> int:
    """Bytes allocated now, the peak counter reset (0 off a card)."""
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_bytes(device, base: int):
    return torch.cuda.max_memory_allocated() - base if device.type == "cuda" else None


def first_batch(stream, device):
    """The stream's first batch through ``prefetch_to_device``."""
    from repro_torch.data import prefetch_to_device
    got = list(prefetch_to_device(itertools.islice(stream, 1), size=1, device=device))
    check(len(got) == 1, "prefetch gave no batch")
    return got[0]


def run_steps(loss, params, batch, has_bn: bool, clock, lr: float,
              n: int = TRAIN_STEPS):
    """``n`` train steps (the CLI's schedule: warmup 1, so step 1 has lr 0)
    on one repeated batch: (params, opt, each step's scalar metrics, ms a
    step)."""
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw_init, cosine_schedule
    step = make_train_step(loss, cosine_schedule(lr, max(n // 10, 1), n),
                           has_bn=has_bn)
    opt = adamw_init(params)
    metrics, ms = [], []
    for _ in range(n):
        (params, opt, m), t = clock(lambda: step(params, opt, batch))
        metrics.append({k: float(v) for k, v in m.items()
                        if isinstance(v, torch.Tensor) and v.ndim == 0})
        ms.append(t)
    return params, opt, metrics, ms


def train_vision_cell(arch: str, batch_n: int, res: int, device, clock, seed: int,
                      small: bool) -> dict:
    """One vision id's train step on ``batch_n`` images of ``res`` px."""
    from repro_torch.launch import train
    from repro_torch.models import common as cm
    cfg, table, loss, data, has_bn = train.build(arch, small, batch_n, 0, res)
    base = peak_reset(device)
    params = cm.init_params(table, seed, device=device)
    batch = first_batch(data, device)
    stats = ({k: params["stem_bn"][k].clone() for k in ("mean", "var")}
             if has_bn else {})
    params, opt, metrics, ms = run_steps(loss, params, batch, has_bn, clock,
                                         VISION_LR)
    losses = [m["loss"] for m in metrics]
    print(f"[phase 21] train {arch} b{batch_n}: ms {ms}, losses {losses}", flush=True)
    check(bool(np.isfinite(losses).all()), f"{arch} b{batch_n}: losses {losses}")
    check(int(opt.step) == TRAIN_STEPS, f"{arch}: opt.step {int(opt.step)}")
    for k, before in stats.items():
        check(not torch.equal(before, params["stem_bn"][k]),
              f"{arch}: BN running {k} did not move")
    steady = float(np.mean(ms[1:]))
    return {"dtype": cfg.dtype, "batch": batch_n, "res": res, "losses": losses,
            "ms": ms, "ms_steady": steady, "images_per_s": batch_n / steady * 1e3,
            "peak_bytes": peak_bytes(device, base), "bn_moved": bool(stats)}


def lm_cfg(arch: str, small: bool, layers: int):
    """The published config with ``layers`` layers (``small``: the smoke
    config)."""
    from repro_torch import configs
    mod = configs.get_module(arch)
    if small:
        return mod.smoke_config()
    return dataclasses.replace(mod.config(), n_layers=layers)


def train_lm_cell(arch: str, layers: int, tokens: int, device, clock, seed: int,
                  small: bool) -> dict:
    """One LM id's train step at full width and ``layers`` layers, batch 1."""
    from repro_torch.data import TokenStream
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as T
    cfg = lm_cfg(arch, small, layers)
    table = T.lm_param_table(cfg)
    base = peak_reset(device)
    params = cm.init_params(table, seed, device=device)
    batch = first_batch(TokenStream(1, tokens, cfg.vocab, seed=seed), device)
    loss = T.make_loss_fn(cfg)
    params, opt, metrics, ms = run_steps(loss, params, batch, False, clock, LM_LR)
    with torch.no_grad():
        after = float(loss(params, batch)[0])
    losses = [m["loss"] for m in metrics]
    print(f"[phase 21] train {arch} at {cfg.n_layers} layers: ms {ms}, losses "
          f"{losses}, after {after}", flush=True)
    nll0 = metrics[0]["nll"]
    check(bool(np.isfinite(losses + [after]).all()), f"{arch}: losses {losses} {after}")
    check(abs(nll0 - math.log(cfg.vocab)) < 1.5,
          f"{arch}: first nll {nll0} vs ln(vocab) {math.log(cfg.vocab)}")
    check(metrics[0]["lr"] == 0.0, f"{arch}: step 1's lr {metrics[0]['lr']}")
    check(after < losses[1], f"{arch}: loss after step {TRAIN_STEPS} {after} is not "
          f"below step 2's {losses[1]}")
    check(int(opt.step) == TRAIN_STEPS, f"{arch}: opt.step {int(opt.step)}")
    steady = float(np.mean(ms[1:]))
    out = {"layers": cfg.n_layers, "params": cm.param_count(table), "tokens": tokens,
           "dtype": cfg.dtype, "losses": losses, "loss_after": after, "nll0": nll0,
           "ms": ms, "ms_steady": steady, "tokens_per_s": tokens / steady * 1e3,
           "peak_bytes": peak_bytes(device, base)}
    del params, opt, batch
    return out


def count_syncs(fn) -> int:
    """Synchronising CUDA calls ``fn`` makes (``torch.cuda``'s sync debug
    mode at its warning level)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's one-time note ("a prototype feature") is not a sync
    return sum("called a synchronizing" in str(w.message) for w in caught)


def serve_lm_cell(arch: str, layers: int, prompt: int, device, clock, seed: int,
                  small: bool) -> dict:
    """Prefill ``prompt`` tokens at batch 1, then DECODE_TOKENS greedy
    decode steps; the second decode step runs under the sync debug mode
    (no synchronising call: ``pos`` stays on the card), the others timed."""
    from repro_torch.data import TokenStream
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as T
    cfg = lm_cfg(arch, small, layers)
    base = peak_reset(device)
    params = cm.init_params(T.lm_param_table(cfg), seed, device=device)
    toks = first_batch(TokenStream(1, prompt, cfg.vocab, seed=seed), device)["tokens"]
    prefill = T.make_prefill(cfg, max_len=prompt + DECODE_TOKENS)
    decode = T.make_decode_step(cfg)
    (last, cache), prefill_ms = clock(lambda: prefill(params, toks))
    check(tuple(last.shape) == (1, cfg.vocab), f"{arch}: prefill logits {tuple(last.shape)}")
    check(bool(torch.isfinite(last).all()), f"{arch}: non-finite prefill logits")
    tok = last.argmax(-1)[:, None]
    ms, syncs = [], None
    for i in range(DECODE_TOKENS):
        if i == 1 and device.type == "cuda":
            out = []
            syncs = count_syncs(lambda: out.append(decode(params, cache, tok)))
            lg, cache = out[0]
        else:
            (lg, cache), t = clock(lambda: decode(params, cache, tok))
            ms.append(t)
        check(tuple(lg.shape) == (1, 1, cfg.vocab) and bool(torch.isfinite(lg).all()),
              f"{arch}: decode step {i + 1} logits")
        tok = lg[:, -1].argmax(-1)[:, None]
    pos = int(cache["pos"])
    print(f"[phase 21] serve {arch}: prefill {prefill_ms} ms, decode {ms}, "
          f"syncs {syncs}", flush=True)
    check(pos == prompt + DECODE_TOKENS, f"{arch}: cache pos {pos}")
    check(syncs in (None, 0), f"{arch}: a decode step made {syncs} synchronising calls")
    out = {"layers": cfg.n_layers, "prompt": prompt, "dtype": cfg.dtype,
           "prefill_ms": prefill_ms, "decode_ms": ms,
           "decode_ms_steady": float(np.mean(ms[1:])), "syncs": syncs, "pos": pos,
           "cache_bytes": 2 * cache["k"].numel() * cache["k"].element_size(),
           "peak_bytes": peak_bytes(device, base)}
    del params, cache
    return out


def update_check(p0: list, got: list, want: list, g_got: list, g_want: list,
                 paths: list, lr: float, label: str) -> dict:
    """``got``'s update (from ``p0``) against ``want``'s elementwise within
    UPDATE_RTOL x lr plus one float32 rounding of the new value, except
    where the gradient allows more: ``want``'s |g| below TINY_G (AdamW's
    division by sqrt(v) + eps can turn a rounding difference into a sign;
    at most MAX_TINY of all such elements) or the two gradients, each
    leaf within UPDATE_RTOL x its max |g|, apart by more than UPDATE_RTOL
    relative (the update is a ratio of gradient sums). BN running stats
    within 1e-4 x max(1, max |leaf|). Counts returned and printed."""
    tiny_n = drift_n = total = 0
    worst = 0.0
    for path, a0, a, b, ga, gb in zip(paths, p0, got, want, g_got, g_want):
        a0, a, b, ga, gb = (t.detach().double().cpu() for t in (a0, a, b, ga, gb))
        check(bool(torch.isfinite(a).all()), f"{label} {path}: non-finite")
        if path.endswith(("['mean']", "['var']")):
            err = float((a - b).abs().max())
            check(err <= 1e-4 * max(1.0, float(b.abs().max())),
                  f"{label} {path}: BN stat off by {err}")
            continue
        gerr = (ga - gb).abs()
        check(float(gerr.max()) <= UPDATE_RTOL * float(gb.abs().max()) + 1e-30,
              f"{label} {path}: gradient off by {float(gerr.max())}")
        tiny = gb.abs() < TINY_G
        drift = gerr > UPDATE_RTOL * gb.abs()
        ulp = torch.from_numpy(np.spacing(b.abs().float().numpy())).double()
        diff = ((a - a0) - (b - a0)).abs()
        bad = diff > UPDATE_RTOL * lr + ulp
        check(not bool((bad & ~tiny & ~drift).any()),
              f"{label} {path}: update off by {float(diff.max())} (lr {lr})")
        tiny_n += int((bad & tiny).sum())
        drift_n += int((bad & drift & ~tiny).sum())
        total += a.numel()
        worst = max(worst, float(diff.max()) / lr)
    check(tiny_n <= MAX_TINY * total, f"{label}: {tiny_n} of {total} tiny-g exceptions")
    return {"elements": total, "tiny_excepted": tiny_n, "drift_excepted": drift_n,
            "max_diff_over_lr": worst}


def card_vs_cpu_cell(arch: str, device, seed: int) -> dict:
    """One train step of ``arch``'s smoke config (float32) on the card
    against the same params and batch on the CPU; for an LM also a
    prefill (max_len 32) of 8 tokens plus one decode step."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as T
    from repro_torch.models.steps import make_train_step, value_and_grad
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map
    cpu = torch.device("cpu")
    lm = configs.get_module(arch).FAMILY == "lm"
    cfg, table, loss, _, has_bn = train.build(arch, True, 1, 16, 0)
    rng = np.random.default_rng(seed)
    if lm:
        toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
        host = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    else:
        host = {"images": rng.random((8, cfg.img_res, cfg.img_res, 3)).astype(np.float32),
                "labels": (np.arange(8) % cfg.n_classes).astype(np.int32)}
    p_cpu = cm.init_params(table, seed, device=cpu)
    sides = {}
    for name, dev in (("card", device), ("cpu", cpu)):
        params = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
        batch = tree_map(lambda a: torch.from_numpy(a).to(dev), host)
        grads = value_and_grad(loss, params, batch)[2]
        step = make_train_step(loss, cosine_schedule(1e-3, 0, 10), has_bn=has_bn)
        new, opt, m = step(params, adamw_init(params), batch)
        sides[name] = (tree_leaves(new), tree_leaves(grads), float(m["lr"]),
                       float(m["loss"]))
    paths = [p for p, _ in tree_flatten_with_path(p_cpu)[0]]
    out = update_check(tree_leaves(p_cpu), sides["card"][0], sides["cpu"][0],
                       sides["card"][1], sides["cpu"][1], paths, sides["cpu"][2],
                       f"{arch} card vs CPU")
    out["loss_rel"] = abs(sides["card"][3] - sides["cpu"][3]) / abs(sides["cpu"][3])
    check(out["loss_rel"] <= 1e-5, f"{arch}: loss card vs CPU {out['loss_rel']}")
    if lm:
        logits = {}
        for name, dev in (("card", device), ("cpu", cpu)):
            params = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
            t = torch.from_numpy(host["tokens"]).to(dev)
            last, cache = T.make_prefill(cfg, max_len=32)(params, t[:, :8])
            lg, cache = T.make_decode_step(cfg)(params, cache, t[:, 8:9])
            check(int(cache["pos"]) == 9, f"{arch}: pos {int(cache['pos'])}")
            logits[name] = (last.cpu(), lg.cpu())
        for (a, b) in zip(logits["card"], logits["cpu"]):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            check(err <= LOGIT_RTOL * scale,
                  f"{arch}: serve logits card vs CPU {err} > {LOGIT_RTOL} x {scale}")
            out["serve_rel"] = max(out.get("serve_rel", 0.0), err / scale)
    return out


def resume_cell(arch: str, device) -> dict:
    """``train.py --device <card> --smoke``: 3 steps checkpointed at step 3,
    then ``--steps 6`` resuming from it."""
    import contextlib
    import io
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves, tree_map
    ck = ROOT / "build" / "train_resume" / arch
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--arch", arch, "--smoke", "--device", str(device), "--ckpt-every", "3",
            "--ckpt-dir", str(ck), "--log-every", "1"]
    log1, log2 = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(log1):
        first = train.run(argv + ["--steps", "3"])
    saved = tree_map(torch.clone, {"params": first["params"], "opt": first["opt"]})
    seen = {}

    def on_resume(restored, step):
        seen["step"], seen["opt_step"] = step, int(restored["opt"].step)
        seen["equal"] = all(a.dtype == b.dtype and a.device == b.device
                            and torch.equal(a, b)
                            for a, b in zip(tree_leaves(restored), tree_leaves(saved)))
        seen["leaves"] = len(tree_leaves(restored))

    with contextlib.redirect_stdout(log2):
        second = train.run(argv + ["--steps", "6"], on_resume=on_resume)
    check("resumed from step 3" in log2.getvalue(), f"{arch}: no resume line")
    check(seen.get("equal") is True, f"{arch}: restored state differs from the saved one")
    check(seen["opt_step"] == 3 and int(second["opt"].step) == 6,
          f"{arch}: opt.step {seen['opt_step']} -> {int(second['opt'].step)}")
    losses = first["losses"] + second["losses"]
    check(len(losses) == 6 and bool(np.isfinite(losses).all()), f"{arch}: losses {losses}")
    shutil.rmtree(ck, ignore_errors=True)
    return {"losses": losses, "leaves": seen["leaves"],
            "log": log2.getvalue().strip().splitlines()}


def phase_train(device: torch.device = None, small: bool = False) -> dict:
    """Phase 21 (module docstring). ``small``: the smoke configs at tiny
    sizes, a rehearsal that also runs on the CPU."""
    from repro_torch import configs
    device = torch.device("cuda") if device is None else device
    clock = Clock(device)
    out = {"vision": {}, "lm_train": {}, "lm_serve": {}, "card_vs_cpu": {},
           "resume": {}}
    torch.set_num_threads(os.cpu_count() or 1)
    for k, arch in enumerate(VISION_IDS):
        res = configs.get_module(arch).smoke_config().img_res if small else \
            configs.VISION_SHAPES["cls_224"]["img_res"]
        batches = [8 if small else VISION_TRAIN_BATCH]
        if arch == "resnet-50":
            batches.append(16 if small else configs.VISION_SHAPES["cls_224"]["batch"])
        for n in batches:
            out["vision"][arch, n] = train_vision_cell(arch, n, res, device, clock,
                                                       70 + k, small)
    for k, arch in enumerate(LM_IDS):
        tokens = 16 if small else LM_TRAIN_TOKENS
        out["lm_train"][arch] = train_lm_cell(arch, LM_TRAIN_LAYERS[arch], tokens,
                                              device, clock, 80 + k, small)
    for k, arch in enumerate(LM_IDS):
        layers, prompt = LM_SERVE[arch]
        if small:
            prompt = 24 if arch.startswith("llama4") else 16
        out["lm_serve"][arch] = serve_lm_cell(arch, layers, prompt, device, clock,
                                              90 + k, small)
    if device.type == "cuda":
        for k, arch in enumerate(LM_IDS + ("resnet-50",)):
            out["card_vs_cpu"][arch] = card_vs_cpu_cell(arch, device, 100 + k)
    for arch in ("resnet-50", "llama3-8b"):
        out["resume"][arch] = resume_cell(arch, device)
    return out


def print_train(tr: dict, card: str) -> None:
    """Phase 21's lines (module docstring), each with the card."""
    for (arch, n), r in tr["vision"].items():
        print(f"phase 21 train {arch} cls_224 b{n} ({r['dtype']}, {r['res']} px, TF32 "
              f"off; {card}): {r['ms_steady']} ms a step (steps 2-{TRAIN_STEPS}, CUDA "
              f"events; each {r['ms']}), {r['images_per_s']} images/s, peak "
              f"{r['peak_bytes']} bytes; losses {r['losses']}; BN stats moved "
              f"{r['bn_moved']}", flush=True)
    for arch, r in tr["lm_train"].items():
        print(f"phase 21 train {arch} train_4k at {r['layers']} layers ({r['params']} "
              f"params, {r['dtype']}, {r['tokens']} tokens, batch 1; {card}): "
              f"{r['ms_steady']} ms a step (steps 2-{TRAIN_STEPS}; each {r['ms']}), "
              f"{r['tokens_per_s']} tokens/s, peak {r['peak_bytes']} bytes; first nll "
              f"{r['nll0']}; losses {r['losses']}, after step {TRAIN_STEPS} "
              f"{r['loss_after']}", flush=True)
    for arch, r in tr["lm_serve"].items():
        print(f"phase 21 serve {arch} at {r['layers']} layers ({r['dtype']}, prompt "
              f"{r['prompt']}, batch 1; {card}): prefill {r['prefill_ms']} ms, decode "
              f"{r['decode_ms_steady']} ms a token (CUDA events, decode steps 3-"
              f"{DECODE_TOKENS}; each {r['decode_ms']}), synchronising calls in a "
              f"decode step {r['syncs']} (no host read of pos), pos {r['pos']}, KV "
              f"cache {r['cache_bytes']} bytes, peak {r['peak_bytes']} bytes",
              flush=True)
    for arch, r in tr["card_vs_cpu"].items():
        print(f"phase 21 card vs CPU {arch} (smoke config, float32, TF32 off): one "
              f"step's update, max |diff| / lr {r['max_diff_over_lr']}, excepted "
              f"{r['tiny_excepted']} (|g| < {TINY_G}) + {r['drift_excepted']} "
              f"(gradients apart > {UPDATE_RTOL} relative) of {r['elements']}; loss "
              f"rel {r['loss_rel']}"
              + (f"; prefill + decode logits rel {r['serve_rel']}" if "serve_rel" in r
                 else ""), flush=True)
    for arch, r in tr["resume"].items():
        print(f"phase 21 resume {arch} (train.py --smoke, 3 steps then --steps 6): "
              f"restored {r['leaves']} leaves bit-equal, losses {r['losses']}; "
              f"{r['log'][:2]}", flush=True)
    print(f"phase 21 cuts: {TRAIN_CUTS}", flush=True)
    print(f"phase 21 card: {card}", flush=True)


def busy_and_kernels(fn, reps: int = 5):
    """Device busy ms, device kernels and device copies (memcpy, memset) a
    call of ``fn`` from a ``torch.profiler`` trace of ``reps`` calls; None
    for each where the trace shows nothing or the profiler fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except Exception as e:       # a measurement only: report, go on
        print(f"device time not measured: {e!r}", flush=True)
        return None, None, None
    if not evs:
        return None, None, None
    copies = sum(1 for e in evs if e.name.startswith(("Memcpy", "Memset")))
    return (sum(e.device_time_total for e in evs) / reps / 1e3,
            (len(evs) - copies) / reps, copies / reps)


# Phase 22: the diffusion family on the card, at each id's published
# config (bfloat16, remat on). The cuts of the published cells (printed
# with the numbers, and in PERF.md): the batches are fixed here from runs
# of tools/diffusion_probe.py on an H100 (the largest that fit; none is
# caught and retried at run time).
DIFF_IDS = ("dit-l2", "unet-sdxl")
DIFF_GEN = {"gen_fast": 4, "gen_1024": 5}     # DDIM steps run (of 4 and 50)
DIFF_TRAIN = {("dit-l2", "train_256"): 256, ("unet-sdxl", "train_256"): 128,
              ("unet-sdxl", "train_1024"): 4}     # batch (published 256, 32)
DIFF_LR = 1e-4
DIFF_NOISE_RTOL = 1e-3          # step 1's loss against mean(noise^2)
# The U-Net's width in diff_card_vs_cpu: at the smoke ch=16 each of its
# GroupNorms' 32 groups holds one channel, which removes the time
# embedding's per-channel add and with it the whole conditioning path.
DIFF_CHECK_UNET_CH = 64
DIFF_PUBLISHED_BATCH = {"train_256": 256, "train_1024": 32}
DIFF_CUTS = (
    f"gen_fast: all {DIFF_GEN['gen_fast']} DDIM steps; gen_1024: "
    f"{DIFF_GEN['gen_1024']} of its 50 DDIM steps; training {TRAIN_STEPS} steps at "
    f"lr {DIFF_LR} on one repeated batch, batch "
    + ", ".join(f"{b} of {DIFF_PUBLISHED_BATCH[s]} for {a} {s}"
                for (a, s), b in DIFF_TRAIN.items())
    + "; DiT's train_1024 is not run")


def diff_module(arch: str):
    from repro_torch.models import dit, unet
    return dit if arch == "dit-l2" else unet


def diff_cfg(arch: str, res: int, small: bool):
    """The published config (the U-Net's at ``res``; DiT takes ``res`` as
    the forward's ``img_res``), or with ``small`` the smoke config."""
    from repro_torch import configs
    mod = configs.get_module(arch)
    if small:
        return mod.smoke_config()
    return mod.config(img_res=res) if arch == "unet-sdxl" else mod.config()


def diff_table(arch: str, cfg):
    m = diff_module(arch)
    return m.dit_param_table(cfg) if arch == "dit-l2" else m.unet_param_table(cfg)


def diff_batch(arch: str, cfg, n: int, res: int, device, seed: int) -> dict:
    """``n`` examples of ``res`` px: latents, timesteps, labels (DiT) or
    context (U-Net) from ``DiffusionStream`` through ``prefetch_to_device``;
    noise (and the U-Net's pooled) from a seeded generator on ``device``,
    with the keys and shapes of the reference's diffusion cells."""
    from repro_torch.data import DiffusionStream
    lat = res // 8
    if arch == "dit-l2":
        stream = DiffusionStream(n, lat, cfg.latent_ch, n_classes=cfg.n_classes,
                                 seed=seed)
    else:
        stream = DiffusionStream(n, lat, cfg.latent_ch, ctx_len=cfg.ctx_len,
                                 ctx_dim=cfg.ctx_dim, seed=seed)
    batch = first_batch(stream, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    batch["noise"] = torch.randn((n, lat, lat, cfg.latent_ch), generator=gen,
                                 device=device)
    if arch == "unet-sdxl":
        batch["pooled"] = torch.randn((n, cfg.ctx_dim), generator=gen, device=device)
    return batch


def diff_cond(arch: str, batch: dict) -> tuple:
    return ((batch["labels"],) if arch == "dit-l2"
            else (batch["context"], batch["pooled"]))


def enqueue_and_busy(fn) -> dict:
    """The host's ms to enqueue one call of ``fn`` (a warm one; no
    synchronise inside), and the device busy ms, kernels and copies of one
    traced call (busy_and_kernels)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    busy, kernels, copies = busy_and_kernels(fn, reps=1)
    return {"enqueue_ms": host, "busy_ms": busy, "kernels": kernels, "copies": copies}


def sample_diff_cell(arch: str, shape: str, device, clock, seed: int,
                     small: bool) -> dict:
    """DIFF_GEN[shape] DDIM steps of ``make_sample_step`` on the shape's
    batch (CFG doubles it), the ``linspace(999, 1, steps + 1)`` int32
    ladder of examples/sample_dit.py; then one more call of the last step
    under the sync debug mode (``tools/diffusion_probe.py --top`` traces
    a sample step)."""
    from repro_torch import configs
    from repro_torch.models import common as cm
    sh = configs.DIFFUSION_SHAPES[shape]
    res = 64 if small else sh["img_res"]
    n = 2 if small else sh["batch"]
    cfg = diff_cfg(arch, res, small)
    m = diff_module(arch)
    base = peak_reset(device)
    params = cm.init_params(diff_table(arch, cfg), seed, device=device)
    batch = diff_batch(arch, cfg, n, res, device, seed)
    step = (m.make_sample_step(cfg, img_res=res) if arch == "dit-l2"
            else m.make_sample_step(cfg))
    n_steps = DIFF_GEN[shape]
    ladder = np.linspace(999, 1, sh["steps"] + 1).astype(np.int32)
    ts = [torch.full((n,), int(v), dtype=torch.int32, device=device)
          for v in ladder[:n_steps + 1]]
    cond = diff_cond(arch, batch)
    z, ms = batch["latents"], []
    for i in range(n_steps):
        z, t = clock(lambda: step(params, z, ts[i], ts[i + 1], *cond))
        ms.append(t)
    check(tuple(z.shape) == tuple(batch["latents"].shape) and z.dtype == torch.float32,
          f"{arch} {shape}: latents {tuple(z.shape)} {z.dtype}")
    check(bool(torch.isfinite(z).all()), f"{arch} {shape}: non-finite latents")
    last = lambda: step(params, z, ts[n_steps - 1], ts[n_steps], *cond)  # noqa: E731
    syncs = count_syncs(last) if device.type == "cuda" else None
    check(syncs in (None, 0), f"{arch} {shape}: a sample step made {syncs} "
          "synchronising calls")
    peak = peak_bytes(device, base)
    steady = float(np.mean(ms[1:]))
    print(f"[phase 22] {arch} {shape}: ms {ms}, syncs {syncs}", flush=True)
    out = {"res": res, "batch": n, "rows": 2 * n, "steps": n_steps,
           "of_steps": sh["steps"], "dtype": cfg.dtype, "ms": ms, "ms_steady": steady,
           "denoise_per_s": n / steady * 1e3, "syncs": syncs, "peak_bytes": peak,
           "latent_std": float(z.std())}
    del params, batch, z
    return out


def train_diff_cell(arch: str, shape: str, n: int, device, clock, seed: int,
                    small: bool) -> dict:
    """TRAIN_STEPS AdamW steps of ``make_train_step(make_loss_fn(cfg),
    cosine_schedule(DIFF_LR, 1, 4))`` on one repeated batch of ``n``: step
    1's loss is mean(noise^2) (both models zero-init their output, and
    step 1's lr is 0), the loss after the last step below step 2's."""
    from repro_torch import configs
    from repro_torch.models import common as cm
    res = 64 if small else configs.DIFFUSION_SHAPES[shape]["img_res"]
    cfg = diff_cfg(arch, res, small)
    m = diff_module(arch)
    table = diff_table(arch, cfg)
    base = peak_reset(device)
    params = cm.init_params(table, seed, device=device)
    batch = diff_batch(arch, cfg, n, res, device, seed)
    loss = (m.make_loss_fn(cfg, img_res=res) if arch == "dit-l2"
            else m.make_loss_fn(cfg))
    mse0 = float(batch["noise"].double().square().mean())
    params, opt, metrics, ms = run_steps(loss, params, batch, False, clock, DIFF_LR)
    peak = peak_bytes(device, base)
    with torch.no_grad():
        after = float(loss(params, batch)[0])
    losses = [mm["loss"] for mm in metrics]
    print(f"[phase 22] train {arch} {shape} b{n}: ms {ms}, losses {losses}, after "
          f"{after}, mean(noise^2) {mse0}", flush=True)
    check(bool(np.isfinite(losses + [after]).all()), f"{arch} {shape}: losses {losses}")
    check(int(opt.step) == TRAIN_STEPS, f"{arch} {shape}: opt.step {int(opt.step)}")
    check(abs(losses[0] - mse0) <= DIFF_NOISE_RTOL * mse0,
          f"{arch} {shape}: step 1's loss {losses[0]} vs mean(noise^2) {mse0}")
    check(after < losses[1], f"{arch} {shape}: loss after step {TRAIN_STEPS} {after} "
          f"is not below step 2's {losses[1]}")
    prof = {}
    if device.type == "cuda":
        from repro_torch.models.steps import make_train_step
        from repro_torch.optim import cosine_schedule
        step = make_train_step(loss, cosine_schedule(DIFF_LR, 1, TRAIN_STEPS))
        prof = enqueue_and_busy(lambda: step(params, opt, batch))
    steady = float(np.mean(ms[1:]))
    out = {"res": res, "batch": n, "dtype": cfg.dtype, "params": cm.param_count(table),
           "losses": losses, "loss_after": after, "mse0": mse0, "ms": ms,
           "ms_steady": steady, "images_per_s": n / steady * 1e3, "peak_bytes": peak,
           **prof}
    del params, opt, batch
    return out


def fill_zero_leaves(params, seed: int):
    """``params`` (CPU) with every all-zero leaf drawn from a seeded normal
    (x 0.1 for vectors, x 1/sqrt(rows) for matrices): the zero-init output
    leaves would make every comparison of the output empty."""
    from repro_torch.tree import tree_map
    gen = torch.Generator().manual_seed(seed)

    def one(t):
        if t.any():
            return t
        scale = 0.1 if t.ndim == 1 else 1.0 / math.sqrt(t.shape[-2])
        return (torch.randn(t.shape, generator=gen) * scale).to(t.dtype)
    return tree_map(one, params)


def diff_card_vs_cpu(arch: str, device, seed: int) -> dict:
    """At the smoke config (float32; the U-Net's at DIFF_CHECK_UNET_CH),
    the same params (zero leaves filled) and inputs: the forward and one
    sample step on the card against the CPU within LOGIT_RTOL x max |out|,
    and one train step's update by ``update_check``, every leaf. cuDNN runs
    deterministic here: ``update_check`` excuses elements by the gradients
    of a separate backward pass, which must equal the train step's (the
    default backward convolutions do not repeat bit for bit)."""
    from repro_torch.models import common as cm
    from repro_torch.models.steps import make_train_step, value_and_grad
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map
    cpu = torch.device("cpu")
    cfg = diff_cfg(arch, 0, True)
    if arch == "unet-sdxl":
        cfg = dataclasses.replace(cfg, ch=DIFF_CHECK_UNET_CH)
    m = diff_module(arch)
    p_cpu = fill_zero_leaves(cm.init_params(diff_table(arch, cfg), seed, device=cpu),
                             seed)
    host = diff_batch(arch, cfg, 2, cfg.img_res, cpu, seed)
    t_next = (host["timesteps"] - 250).clamp(min=0)
    sides, out = {}, {}
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, dev in (("card", device), ("cpu", cpu)):
            params = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
            batch = tree_map(lambda t: t.to(dev), host)
            cond = diff_cond(arch, batch)
            with torch.no_grad():
                fwd = m.make_forward(cfg)(params, batch["latents"],
                                          batch["timesteps"], *cond)
            z = m.make_sample_step(cfg)(params, batch["latents"], batch["timesteps"],
                                        t_next.to(dev), *cond)
            grads = value_and_grad(m.make_loss_fn(cfg), params, batch)[2]
            step = make_train_step(m.make_loss_fn(cfg), cosine_schedule(1e-3, 0, 10))
            new, _, mm = step(params, adamw_init(params), batch)
            sides[name] = (fwd.cpu(), z.cpu(), tree_leaves(new), tree_leaves(grads),
                           float(mm["lr"]), float(mm["loss"]))
    finally:
        torch.backends.cudnn.deterministic = was
    for k, label in ((0, "forward"), (1, "sample")):
        a, b = sides["card"][k], sides["cpu"][k]
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        check(scale > 0 and err <= LOGIT_RTOL * scale,
              f"{arch} {label} card vs CPU {err} > {LOGIT_RTOL} x {scale}")
        out[f"{label}_rel"] = err / scale
    paths = [p for p, _ in tree_flatten_with_path(p_cpu)[0]]
    out.update(update_check(tree_leaves(p_cpu), sides["card"][2], sides["cpu"][2],
                            sides["card"][3], sides["cpu"][3], paths,
                            sides["cpu"][4], f"{arch} card vs CPU"))
    out["loss_rel"] = abs(sides["card"][5] - sides["cpu"][5]) / abs(sides["cpu"][5])
    check(out["loss_rel"] <= 1e-5, f"{arch}: loss card vs CPU {out['loss_rel']}")
    return out


def sample_example(device) -> list:
    """``examples/sample_dit_torch.py --device <device>``, run in this
    process as ``python`` runs it; its output lines (its assertions raise)."""
    import contextlib
    import io
    import runpy
    path = ROOT / "examples" / "sample_dit_torch.py"
    out, argv = io.StringIO(), sys.argv
    sys.argv = [str(path), "--device", str(device)]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = argv
    lines = out.getvalue().strip().splitlines()
    check(bool(lines) and lines[-1].endswith("OK"), f"sample_dit_torch.py: {lines}")
    return lines


def phase_diffusion(device: torch.device = None, small: bool = False) -> dict:
    """Phase 22 (module docstring). ``small``: the smoke configs at tiny
    sizes, a rehearsal that also runs on the CPU."""
    device = torch.device("cuda") if device is None else device
    clock = Clock(device)
    t0 = time.perf_counter()
    out = {"gen": {}, "train": {}, "card_vs_cpu": {}}
    torch.set_num_threads(os.cpu_count() or 1)
    def stamp(what: str) -> None:
        print(f"[phase 22] {what} done at {time.perf_counter() - t0:.1f} s", flush=True)

    for k, arch in enumerate(DIFF_IDS):
        for shape in DIFF_GEN:
            out["gen"][arch, shape] = sample_diff_cell(arch, shape, device, clock,
                                                       110 + k, small)
            stamp(f"{arch} {shape}")
    for k, ((arch, shape), n) in enumerate(DIFF_TRAIN.items()):
        out["train"][arch, shape] = train_diff_cell(arch, shape, 2 if small else n,
                                                    device, clock, 120 + k, small)
        stamp(f"train {arch} {shape}")
    if device.type == "cuda":
        for k, arch in enumerate(DIFF_IDS):
            out["card_vs_cpu"][arch] = diff_card_vs_cpu(arch, device, 130 + k)
        stamp("card vs CPU")
    out["example"] = sample_example(device)
    out["seconds"] = time.perf_counter() - t0
    return out


def print_diffusion(df: dict, card: str) -> None:
    """Phase 22's lines (module docstring), each with the card."""
    for (arch, shape), r in df["gen"].items():
        print(f"phase 22 sample {arch} {shape} ({r['dtype']}, {r['res']} px, batch "
              f"{r['batch']}, CFG rows {r['rows']}, {r['steps']} of {r['of_steps']} "
              f"DDIM steps, TF32 off; {card}): {r['ms_steady']} ms a denoise step "
              f"(CUDA events, steps 2-{r['steps']}; each {r['ms']}), "
              f"{r['denoise_per_s']} denoise steps/s (images x steps), peak "
              f"{r['peak_bytes']} bytes, synchronising calls in a sample step "
              f"{r['syncs']}; latent std {r['latent_std']}", flush=True)
    for (arch, shape), r in df["train"].items():
        print(f"phase 22 train {arch} {shape} ({r['params']} params, {r['dtype']}, "
              f"remat, {r['res']} px, batch {r['batch']}, TF32 off; {card}): "
              f"{r['ms_steady']} ms a step (steps 2-{TRAIN_STEPS}, CUDA events; each "
              f"{r['ms']}), {r['images_per_s']} images/s, peak {r['peak_bytes']} "
              f"bytes; losses {r['losses']} (step 1 vs mean(noise^2) {r['mse0']}), "
              f"after step {TRAIN_STEPS} {r['loss_after']}; host enqueue "
              f"{r.get('enqueue_ms')} ms, device busy {r.get('busy_ms')} ms, kernels "
              f"{r.get('kernels')}, copies {r.get('copies')} a step", flush=True)
    for arch, r in df["card_vs_cpu"].items():
        print(f"phase 22 card vs CPU {arch} (smoke config"
              f"{', ch=%d' % DIFF_CHECK_UNET_CH if arch == 'unet-sdxl' else ''}"
              f", float32, TF32 off): "
              f"forward rel {r['forward_rel']}, sample step rel {r['sample_rel']} "
              f"(bound {LOGIT_RTOL}); one step's update, max |diff| / lr "
              f"{r['max_diff_over_lr']}, excepted {r['tiny_excepted']} (|g| < "
              f"{TINY_G}) + {r['drift_excepted']} (gradients apart > {UPDATE_RTOL} "
              f"relative) of {r['elements']}; loss rel {r['loss_rel']}", flush=True)
    print(f"phase 22 example sample_dit_torch.py: {df['example'][-2:]}", flush=True)
    print(f"phase 22 cuts: {DIFF_CUTS}", flush=True)
    print(f"phase 22 took {df['seconds']:.1f} s; card: {card}", flush=True)


# --- phase 23: the LM's model axis, the dry run, a sharded train step --------

MA_FWD_TOKENS = 256              # the tensor-parallel forwards' sequence
MA_DECODE = 8                    # decode tokens after each prefill
MA_TOL_LOGIT = 1e-4              # x max |logit| of the one-rank run
MA_TOL_CACHE = 1e-5
MA_WORLD = 2                     # two gloo ranks sharing the card
# (label, arch, layers, config overrides, kind, prompt): the layers cut as
# in phase 21; the MoE ids' capacity factor E / k ("no_drop"), so that no
# expert can overflow (a rank's capacity is then its token count) and one
# rank drops no token where two do not either. llama4's prompt is one
# 8192-token chunk; its decode tokens pass it, so the window mask acts.
MA_CASES = (
    ("llama3 tp", "llama3-8b", 2, {}, "forward", MA_FWD_TOKENS),
    ("llama3 tp seq_shard", "llama3-8b", 2, {"seq_shard": True}, "forward",
     MA_FWD_TOKENS),
    ("llama3 tp embed dm", "llama3-8b", 2, {"embed_shard": "dm"}, "forward",
     MA_FWD_TOKENS),
    ("llama3 flash-decoding", "llama3-8b", 2, {"decode_seq_shard": True},
     "serve", 4096),
    ("moonshot experts", "moonshot-v1-16b-a3b", 1,
     {"moe_capacity_factor": "no_drop"}, "serve", 512),
    ("llama4 flash-decoding", "llama4-scout-17b-a16e", 4,
     {"decode_seq_shard": True, "moe_capacity_factor": "no_drop"}, "serve", 8192),
)
# One cell a family, the riskiest of each (phase 23(b)).
DRYRUN_CELLS = (("llama4-scout-17b-a16e", "long_500k", ("decode_seq_shard=True",)),
                ("moonshot-v1-16b-a3b", "train_4k", ()),
                ("unet-sdxl", "gen_fast", ()),
                ("resnet-50", "cls_224", ()),
                ("dehaze-dcp", "stream_2160p", ()))


def ma_cfg(arch: str, layers: int, over: dict):
    """The published config, float32, ``layers`` layers, ``over`` on top."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get_module(arch).config(), n_layers=layers,
                              dtype="float32", remat=False)
    if over.get("moe_capacity_factor") == "no_drop":
        over = dict(over, moe_capacity_factor=cfg.moe_experts / cfg.moe_topk)
    return dataclasses.replace(cfg, **over)


def ma_tokens(cfg, n: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, cfg.vocab, (1, n), generator=g).to(device)


def ma_params(cfg, seed: int, device, mesh=None):
    """``init_params``' values: whole, or with ``mesh`` this rank's pieces
    (each leaf drawn whole on the card, cut and freed, so a rank never
    holds the whole tree)."""
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten
    table = T.lm_param_table(cfg)
    if mesh is None:
        return cm.init_params(table, seed, device=device)
    specs = tree_leaves(T.lm_param_specs(cfg, mesh, serving=True), is_leaf=cm.is_spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves, treedef = tree_flatten(table, is_leaf=lambda s: isinstance(s, cm.ParamSpec))
    out = []
    for spec, ps in zip(leaves, specs):
        if spec.init == "normal":
            w = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
            w = (w * (spec.scale * cm.fanin_scale(spec))).to(dtype=spec.dtype)
        else:
            w = (torch.zeros if spec.init == "zeros" else torch.ones)(
                spec.shape, dtype=spec.dtype, device=device)
        out.append(cm.local_shard(w, ps, mesh).contiguous())
        del w
    torch.cuda.empty_cache()
    return tree_unflatten(treedef, out)


def ma_case_run(case, params, device, mesh, clock) -> dict:
    """One case of phase 23(a) on this process (``params`` whole, or this
    rank's pieces on ``mesh``): the logits (whole over the vocabulary)
    and, for a serve, the cache and the decode ms."""
    from repro_torch.models import transformer as T
    label, arch, layers, over, kind, prompt = case
    cfg = ma_cfg(arch, layers, over)
    axes = ("data",) if mesh is not None else None
    toks = ma_tokens(cfg, prompt + MA_DECODE, 231, device)
    out = {}
    with torch.no_grad():
        if kind == "forward":
            out["logits"] = [T.make_forward(cfg, mesh, axes)(params, toks[:, :prompt])[0]]
            return out
        prefill = T.make_prefill(cfg, mesh, axes, max_len=prompt + MA_DECODE)
        decode = T.make_decode_step(cfg, mesh, axes)
        last, cache = prefill(params, toks[:, :prompt])
        logits, ms = [last], []
        for i in range(MA_DECODE):
            (lg, cache), t = clock(lambda: decode(params, cache, toks[:, prompt + i:][:, :1]))
            logits.append(lg[:, 0])
            ms.append(t)
        out.update(logits=logits, k=cache["k"], v=cache["v"], pos=int(cache["pos"]),
                   decode_ms=ms)
    return out


def ma_train_run(device, mesh=None) -> dict:
    """Phase 23(c): one train step of llama3-8b's smoke config (float32) on
    4 sequences: whole on one rank, or on (data 2, model 1) with the batch
    split and ZeRO-1 moments. Returns p0, the new params, the gradients
    (meaned over the ranks) and the lr."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.cells import _zero1_pspecs
    from repro_torch.models import common as cm
    from repro_torch.models import parallel as par
    from repro_torch.models import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.tree import tree_leaves, tree_map
    cfg = configs.get_module("llama3-8b").smoke_config()
    table = T.lm_param_table(cfg)
    p0 = cm.init_params(table, 232, device=device)
    g = torch.Generator(device="cpu").manual_seed(233)
    toks = torch.randint(0, cfg.vocab, (4, 16), generator=g)
    batch = {"tokens": toks.to(device), "labels": toks.roll(-1, 1).to(device)}
    sched = cosine_schedule(1e-3, 0, 10)
    params = tree_map(lambda t: t.clone(), p0)
    if mesh is None:
        loss = T.make_loss_fn(cfg)
        grads = steps.value_and_grad(loss, params, batch)[2]
        new, opt, m = steps.make_train_step(loss, sched)(params, adamw_init(params), batch)
    else:
        sizes = cm.mesh_sizes(mesh)
        pspecs = cm.param_pspecs(table, T.lm_rules(cfg), sizes)
        mspecs = _zero1_pspecs(table, pspecs, ("data",), sizes["data"])
        pl = steps.TrainPlacement(mesh, ("data",), pspecs, mspecs)
        i = mesh.get_local_rank("data")
        local = tree_map(lambda t: t[2 * i:2 * i + 2], batch)
        loss = T.make_loss_fn(cfg, mesh, ("data",))
        grads = tree_map(lambda t: par.all_reduce_(t.contiguous(), mesh.get_group("data"))
                         / sizes["data"], steps.value_and_grad(loss, params, local)[2])
        opt = steps.init_opt_state(params, pl)
        new, opt, m = steps.make_train_step(loss, sched, placement=pl)(params, opt, local)
        moment_elems = sum(t.numel() for t in tree_leaves(opt.mu))
        dist.barrier()
    return {"p0": tree_leaves(p0), "new": tree_leaves(new), "grads": tree_leaves(grads),
            "lr": float(m["lr"]), "loss": float(m["loss"]),
            "moment_elems": None if mesh is None else moment_elems,
            "param_elems": sum(t.numel() for t in tree_leaves(p0))}


def phase23_child(argv) -> int:
    """A process of phase 23(a)/(c): ``ref`` (one rank, no mesh; writes
    the outputs) or ``rank R`` of MA_WORLD gloo ranks sharing the card
    (compares its outputs with ref's, writes its errors and times)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    role, rank, tmp = argv[0], int(argv[1]), Path(argv[2])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    clock = Clock(device)
    if role == "ref":
        for n, case in enumerate(MA_CASES):
            params = ma_params(ma_cfg(*case[1:4]), 230, device)
            out = ma_case_run(case, params, device, None, clock)
            del params
            torch.save({k: ([t.cpu() for t in v] if k == "logits" else
                            v.cpu() if isinstance(v, torch.Tensor) else v)
                        for k, v in out.items()}, tmp / f"ref{n}.pt")
            del out
            torch.cuda.empty_cache()
        tr = ma_train_run(device)
        torch.save({k: ([t.cpu() for t in v] if isinstance(v, list) else v)
                    for k, v in tr.items()}, tmp / "ref_train.pt")
        return 0
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), MA_WORLD),
                            rank=rank, world_size=MA_WORLD)
    mesh = init_device_mesh("cpu", (1, MA_WORLD), mesh_dim_names=("data", "model"))
    res = {"cases": {}}
    for n, case in enumerate(MA_CASES):
        # Each rank draws its pieces in turn: a leaf is whole while it is cut.
        for r in range(MA_WORLD):
            if r == rank:
                params = ma_params(ma_cfg(*case[1:4]), 230, device, mesh)
            dist.barrier()
        out = ma_case_run(case, params, device, mesh, clock)
        del params
        ref = torch.load(tmp / f"ref{n}.pt")
        errs = [float((a.cpu() - b).abs().max()) / float(b.abs().max())
                for a, b in zip(out["logits"], ref["logits"])]
        r = {"logit_rel": max(errs)}
        if "k" in out:
            i = mesh.get_local_rank("model")
            for name in ("k", "v"):
                want = ref[name]
                n_loc = out[name].shape[2]
                if case[3].get("decode_seq_shard"):
                    want = want[:, :, i * n_loc:(i + 1) * n_loc]
                elif out[name].shape[3] != want.shape[3]:
                    h = out[name].shape[3]
                    want = want[:, :, :, i * h:(i + 1) * h]
                r[f"{name}_err"] = float((out[name].cpu() - want).abs().max())
            r.update(pos=out["pos"], decode_ms=out["decode_ms"],
                     ref_decode_ms=ref["decode_ms"], cache_shape=list(out["k"].shape))
        res["cases"][case[0]] = r
        del out, ref
        torch.cuda.empty_cache()
    train_mesh = init_device_mesh("cpu", (MA_WORLD, 1), mesh_dim_names=("data", "model"))
    tr = ma_train_run(device, train_mesh)
    want = torch.load(tmp / "ref_train.pt")
    res["train"] = update_check(want["p0"], tr["new"], want["new"], tr["grads"],
                                want["grads"], [str(i) for i in range(len(tr["new"]))],
                                want["lr"], "phase 23 sharded train")
    res["train"].update(loss=tr["loss"], ref_loss=want["loss"],
                        moment_elems=tr["moment_elems"], param_elems=tr["param_elems"])
    (tmp / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def phase_model_axis() -> dict:
    """Phase 23 (module docstring). The dry runs (CPU only) start first and
    run beside (a) and (c), each part in processes of its own, so that no
    fake or gloo group meets the phases' NCCL group."""
    import gc
    t0 = time.perf_counter()
    # The children need most of the card: this process gives back what
    # its allocator holds from the earlier phases.
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0] if torch.cuda.is_available() else None
    tmp = ROOT / "build" / "phase23"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), GLOO_SOCKET_IFNAME="lo",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    dry_dir = tmp / "dryrun"
    dry = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s,
         "--both-meshes", "--force", "--results-dir", str(dry_dir / f"{a}__{s}"),
         *sum((["--override", o] for o in over), [])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a, s, over in DRYRUN_CELLS]
    me = [sys.executable, str(Path(__file__).resolve()), "--phase23-child"]
    ref = subprocess.run(me + ["ref", "0", str(tmp)], env=env, capture_output=True,
                         text=True, timeout=600)
    check(ref.returncode == 0, f"phase 23 one-rank run: {ref.stdout[-2000:]} "
          f"{ref.stderr[-3000:]}")
    ranks = [subprocess.Popen(me + ["rank", str(r), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(MA_WORLD)]
    logs = [p.communicate(timeout=900)[0] for p in ranks]
    for r, (p, log) in enumerate(zip(ranks, logs)):
        check(p.returncode == 0, f"phase 23 rank {r}: {log[-4000:]}")
    t_ranks = time.perf_counter() - t0
    out = {"ranks": [json.loads((tmp / f"rank{r}.json").read_text())
                     for r in range(MA_WORLD)]}
    for r, res in enumerate(out["ranks"]):
        for label, c in res["cases"].items():
            check(c["logit_rel"] <= MA_TOL_LOGIT,
                  f"phase 23 {label} rank {r}: logits {c['logit_rel']} x max |logit|")
            for name in ("k_err", "v_err"):
                if name in c:
                    check(c[name] <= MA_TOL_CACHE, f"phase 23 {label} rank {r}: "
                          f"cache {name} {c[name]}")
            if "pos" in c:
                prompt = [x for x in MA_CASES if x[0] == label][0][5]
                check(c["pos"] == prompt + MA_DECODE, f"phase 23 {label}: pos {c['pos']}")
        tr = res["train"]
        check(abs(tr["loss"] - tr["ref_loss"]) <= 1e-5 * abs(tr["ref_loss"]),
              f"phase 23 sharded train rank {r}: loss {tr['loss']} vs {tr['ref_loss']}")
        check(tr["moment_elems"] * MA_WORLD >= tr["param_elems"]
              and tr["moment_elems"] < tr["param_elems"],
              f"phase 23 ZeRO-1: {tr['moment_elems']} moment elements of "
              f"{tr['param_elems']}")
    out["dryrun"] = {}
    for (a, s, over), p in zip(DRYRUN_CELLS, dry):
        log = p.communicate(timeout=900)[0]
        check(p.returncode == 0, f"phase 23 dry run {a} {s}: {log[-4000:]}")
        recs = [json.loads(f.read_text()) for f in sorted((dry_dir / f"{a}__{s}").glob("*.json"))
                if f.name != "model_flops.json"]
        check(len(recs) == 2 and all(r["status"] == "ok" for r in recs),
              f"phase 23 dry run {a} {s}: {[r.get('status') for r in recs]} {log[-3000:]}")
        summ = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                               "--summary", "--results-dir", str(dry_dir / f"{a}__{s}")],
                              env=env, capture_output=True, text=True, timeout=120)
        out["dryrun"][a, s] = {"over": over, "summary": summ.stdout.strip().splitlines()[1:],
                               "wall_s": [r["wall_s"] for r in recs],
                               "calls": [r["collective_calls"] for r in recs]}
    out["seconds"] = time.perf_counter() - t0
    out["ranks_seconds"] = t_ranks
    out["free_bytes"] = free
    return out


def print_model_axis(ma: dict, card: str) -> None:
    """Phase 23's lines (module docstring), each with the card."""
    for r, res in enumerate(ma["ranks"]):
        for label, c in res["cases"].items():
            line = (f"phase 23 model axis {label} rank {r} of {MA_WORLD} (gloo on one "
                    f"card, float32, TF32 off; {card}): logits within "
                    f"{c['logit_rel']} x max |logit| of one rank")
            if "pos" in c:
                line += (f", cache k {c['k_err']} v {c['v_err']} (local {c['cache_shape']}),"
                         f" pos {c['pos']}; decode ms a token {float(np.mean(c['decode_ms'][1:]))}"
                         f" at {MA_WORLD} ranks (each {c['decode_ms']}) against "
                         f"{float(np.mean(c['ref_decode_ms'][1:]))} on one")
            print(line, flush=True)
        tr = res["train"]
        print(f"phase 23 sharded train rank {r} (llama3-8b smoke, data {MA_WORLD} x model 1, "
              f"ZeRO-1 moments {tr['moment_elems']} of {tr['param_elems']} elements): "
              f"update vs one rank, max |diff| / lr {tr['max_diff_over_lr']}, excepted "
              f"{tr['tiny_excepted']} + {tr['drift_excepted']} of {tr['elements']}; loss "
              f"{tr['loss']} vs {tr['ref_loss']}", flush=True)
    for (a, s), d in ma["dryrun"].items():
        print(f"phase 23 dry run {a} {s} {' '.join(d['over'])} (fake 256/512-rank groups, "
              f"CPU, H100 datasheet constants): wall {d['wall_s']} s, collectives "
              f"{d['calls']}", flush=True)
        for row in d["summary"]:
            print(f"phase 23 dry run | {row}", flush=True)
    print(f"phase 23 took {ma['seconds']:.1f} s (the ranks' part "
          f"{ma['ranks_seconds']:.1f} s; {ma['free_bytes']} bytes of the card "
          f"free at its start); card: {card}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    from repro_torch.core import DehazeConfig
    from repro_torch.kernels import _build, fused as fk, staged as sk
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phases 2-18 drive the kernels' default knobs, as before the tuning
    # registry: no table (a path that does not exist). Phase 19 drives the
    # tables.
    os.environ["REPRO_TORCH_KERNEL_TUNING"] = str(ROOT / "build" / "no_tuning_table.json")
    builds = [(p.name, ()) for p in sorted(_build.CSRC.glob("*.cu"))] + variant_builds()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(lambda b: _build.build(*b), builds))
    print(f"built {[p.name for p in built]} (the megakernel's tuning variants "
          f"{[' '.join(d) for _, d in variant_builds()]} too) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(fk.TILE_PIXELS == fk._lib().fd_tile_pixels(), "tile size mismatch")
    sk._lib()                                # checks its tile constants

    def stamp(phases: str) -> None:
        """The script's clock after ``phases``: where its time limit goes."""
        print(f"[{time.perf_counter() - t_start:.1f} s] {phases} done", flush=True)

    pass_errs, whole_errs = phase_parity()
    stamp("phase 2")
    cfg = DehazeConfig(kernel_mode="fused", io_dtype="uint8")
    rng = np.random.default_rng(1)
    vids = [rng.integers(0, 256, (48, H, W, 3), dtype=np.uint8)
            for _ in range(4)]
    launches, launches_serve, ticks = phase_serve(cfg, vids, fused_per_tick())
    rep = phase_throughput(cfg, vids, fused_per_tick())
    times = phase_times()
    stamp("phases 3-5")

    staged_errs, _ = phase_staged_parity(STAGED_CELLS)
    check_atmolight(staged_errs)
    check_strips(staged_errs)
    stamp("phase 6")
    cfg_staged = DehazeConfig(io_dtype="uint8")            # kernel_mode "auto"
    s_launches, s_launches_serve, s_ticks = phase_serve(
        cfg_staged, vids, STAGED_PER_TICK, "staged ")
    s_rep = phase_throughput(cfg_staged, vids, STAGED_PER_TICK, "staged ")
    s_times = phase_staged_times()
    stamp("phases 7-8")

    cap_errs, _ = phase_staged_parity(CAP_TOPK_CELLS, "staged CAP/top-k")
    check_large_topk(cap_errs)
    check_min_strips(cap_errs)
    check_warp_topk(cap_errs)
    cfg_cap = DehazeConfig(algorithm="cap", topk=4, io_dtype="uint8")
    c_launches, c_launches_serve, c_ticks = phase_serve(
        cfg_cap, vids, CAP_PER_TICK, "staged CAP top-4 ")
    stamp("phases 9-10")
    t_errs, t_whole, t_launches, t_cells = phase_sharded()
    stamp("phase 11")
    c_times = phase_slice3_times()
    stamp("phase 12")
    (sp_errs, sp_vs_b7, sp_launches, sp_steps, st_launches, st_steps,
     sync_lists) = phase_spatial()
    stamp("phase 13")
    sp_times = phase_spatial_times()
    stamp("phase 14")
    # Phase 17 runs here: after phase 15's profiler trace of a threaded
    # serve, traces of a lone kernel come back empty or short.
    me = phase_merge_ema(sync_lists, cfg_staged, vids)
    stamp("phase 17")
    serving_paths = {"fused": (cfg, fused_per_tick()),
                     "staged": (cfg_staged, STAGED_PER_TICK)}
    ov = phase_overlap(vids, serving_paths)
    stamp("phase 15")
    el = phase_elastic(vids, serving_paths)
    stamp("phase 16")
    ma = phase_multiaxis(vids, {
        "fused": (launches, ticks, cfg), "staged": (s_launches, s_ticks, cfg_staged)})
    stamp("phase 18")
    tu = phase_tuning(vids)
    stamp("phase 19")
    vi = phase_vision()
    stamp("phase 20")
    tr = phase_train()
    stamp("phase 21")
    df = phase_diffusion()
    stamp("phase 22")
    mx = phase_model_axis()
    stamp("phase 23")

    kernels = []

    def entry(name, source, replaces, r, err, many, serve, ticks_, path):
        """One kernel's record; ``many`` and ``serve`` hold the launch
        counts of the run of ``path`` (``ticks_`` steps) named."""
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path, "launches": many[name],
            "launches_serve": serve[name] if serve else None,
            "launches_per_tick": many[name] / ticks_,
            "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("floor_ms", "device_busy_ms", "library_busy_ms",
                                 "graph_ms", "library_graph_ms", "flushed_busy_ms",
                                 "library_flushed_busy_ms", "ten_pass_ms",
                                 "ten_pass_busy_ms", "ten_pass_graph_ms",
                                 "blocks_per_sm")
               if r.get(k) is not None}})
        print(f"{name:36s} {r['ms']:9.4f} ms  bound {r['bound_ms']:8.4f} ms "
              f"({r['bound_by']})  plain {r['plain_ms']:9.3f} ms  library "
              f"{'-' if r['library_ms'] is None else '%.4f ms' % r['library_ms']}"
              f"  launches {many[name]} ({many[name] / ticks_:g}/step on {path})"
              + ("" if serve is None else f", {serve[name]} on serve"),
              flush=True)

    # The megakernel: the tiled passes on the fused serving path (phase 3).
    for name in ("fused_dehaze_lanes",) + fk.TILED_PASSES:
        err = (max(whole_errs.values()) if name == "fused_dehaze_lanes"
               else pass_errs[name])
        full = name if name == "fused_dehaze_lanes" else f"fused_dehaze_lanes.{name}"
        entry(full, SOURCE, REPLACES[name], times[name], err,
              {full: launches[name]}, {full: launches_serve[name]}, ticks,
              "fused serve_many / serve")
    # The ten passes run on no path at the serving shape: they are the
    # megakernel's and the transmission stage's route for windows too wide
    # for the tiles (phases 2 and 11) and the tiled sequences' comparator.
    # Their launches are those on the sharded steps (phase 11), where the
    # transmission stage would run them.
    b7 = {name: sum(t_launches[path].get(f"fused_transmission.{name}", 0)
                    for path in t_launches) for name in fk.transmission_launches}
    b7_steps = sum(t_launches[path]["fused_transmission"] for path in t_launches)
    for name in fk.PASSES:
        full = f"fused_dehaze_lanes.{name}"
        entry(full, SOURCE, REPLACES[name], times[name], pass_errs[name],
              {full: b7[name] if name in fk.TRANSMISSION_PASSES else 0}, None,
              b7_steps, "none at the serving shape: windows too wide for the "
              "tiles (phases 2 and 11) and the tiled sequences' comparator; "
              "launches on the sharded steps")
    # The transmission stage's tiled passes on the sharded steps (phase 11).
    for name in ("tmap_tile", "candidate", "guided_ab", "refine_tmap"):
        full = f"fused_transmission.{name}"
        entry(full, SOURCE, TILED_TRANSMISSION_REPLACES[name], c_times[full],
              max(e.get(name, 0.0) for e in t_errs.values()), {full: b7[name]},
              None, b7_steps, "sharded steps (B7a, B7b)")
    # The staged kernels, and each one's route past its new kernel's limits
    # (``staged.wide.<name>``: the row window, the top-k's block rounds),
    # which runs on no path at the serving shape.
    for name in ("dark_channel", "box_filter", "atmolight", "recover"):
        entry(f"staged.{name}", STAGED_SOURCE, STAGED_REPLACES[name],
              s_times[name], staged_errs[name], s_launches, s_launches_serve,
              s_ticks, "staged serve_many / serve")
    for name in ("dark_channel", "box_filter"):
        entry(f"staged.wide.{name}", STAGED_SOURCE, STAGED_REPLACES[name],
              s_times[f"wide.{name}"], staged_errs[f"wide.{name}"], s_launches,
              s_launches_serve, s_ticks, "none: radii past the strips' limit "
              "(phase 6); 0 on staged serve_many / serve")
    for name in ("min_filter", "atmolight_topk"):
        entry(f"staged.{name}", STAGED_SOURCE, STAGED_REPLACES[name],
              c_times[f"staged.{name}"], cap_errs[name], c_launches,
              c_launches_serve, c_ticks, "staged CAP top-4 serve_many / serve")
        entry(f"staged.wide.{name}", STAGED_SOURCE, STAGED_REPLACES[name],
              c_times[f"staged.wide.{name}"], cap_errs[f"wide.{name}"], c_launches,
              c_launches_serve, c_ticks, "none: " + (
                  "radii past the strips' limit" if name == "min_filter"
                  else f"k > {sk.WARP_TOPK_MAX}") + " (phase 9); 0 on staged CAP top-4 "
              "serve_many / serve")
    for name in TRANSMISSION_REPLACES:
        entry(name, SOURCE, TRANSMISSION_REPLACES[name], c_times[name],
              max(t_errs[name]["whole"], t_errs[name]["tiled_vs_ten_pass"],
                  *t_whole[name].values()),
              {name: t_launches[name]["fused_transmission"]}, None, 2,
              f"sharded step ({name})")
    # Phase 13's path: its spatial steps (B9 one launch a tile, B10 one a
    # step). B8a/B8b: the staged branch of the sharded steps (phase 11,
    # 1 + 6 a step) and of the spatial steps (phase 13, 4 + 24 a 2 x 2
    # step); their row window (past the strips' limit) on none of them.
    b8_paths = [p for p in t_launches if p.startswith("staged_")]
    b8 = {f"staged.{w}{n}": sum(t_launches[p][f"staged.{w}{n}"] for p in b8_paths)
          + st_launches[f"staged.{w}{n}"]
          for n in ("masked_min_filter", "masked_box_filter") for w in ("", "wide.")}
    b8_steps = 2 * len(b8_paths) + st_steps
    b8_path = ("staged sharded steps (frame, lanes; 1 + 6 a step) and staged spatial "
               "steps (2x2 tiles; 4 + 24 a step)")
    sp_err = {"staged.masked_min_filter": sp_errs["masked_min_filter"],
              "staged.masked_box_filter": sp_errs["masked_box_filter"],
              "staged.merge_topk": sp_errs["merge_topk"],
              "fused_transmission_halo": max(
                  sp_errs["whole"], sp_vs_b7["t"], sp_errs["tiled_vs_ten_pass"],
                  *(v for kk, v in sp_errs.items() if kk in fk.halo_launches))}
    for name in SPATIAL_REPLACES:
        source = SOURCE if name == "fused_transmission_halo" else STAGED_SOURCE
        if name == "staged.merge_topk":
            entry(name, source, SPATIAL_REPLACES[name], sp_times[name], sp_err[name],
                  sp_launches, None, sp_steps, "none: ops.merge_topk_candidates (the "
                  "JAX op's counterpart, phases 13-14) only; every step merges its "
                  "rows in staged.merge_ema")
        elif name.startswith("staged.masked"):
            entry(name, source, SPATIAL_REPLACES[name], sp_times[name], sp_err[name],
                  b8, None, b8_steps, b8_path)
            wide = name.replace("staged.", "staged.wide.")
            entry(wide, source, SPATIAL_REPLACES[name], sp_times[wide],
                  sp_errs[wide.replace("staged.", "")], b8, None, b8_steps,
                  "none: radii past the masked strips' limit (phase 13); 0 on " + b8_path)
        else:
            entry(name, source, SPATIAL_REPLACES[name], sp_times[name],
                  sp_err[name], sp_launches, None, sp_steps,
                  "spatial steps (virtual tilings)")
    for name in fk.TILED_HALO_PASSES:
        full = f"fused_transmission_halo.{name}"
        entry(full, SOURCE, TILED_HALO_REPLACES[name], sp_times[full],
              sp_errs[name], sp_launches, None, sp_steps,
              "spatial steps (virtual tilings)")
    # The state sync: timed at the serving shape (phase 17); one launch a
    # tick of the staged serves and a step of the sharded and spatial steps.
    name = "staged.merge_ema"
    entry(name, MERGE_EMA_SOURCE, MERGE_EMA_REPLACES, me["times"]["serving"],
          max(me["err"], staged_errs["merge_ema"], cap_errs["merge_ema"],
              sp_errs["merge_ema"]), s_launches, s_launches_serve, s_ticks,
          "staged serve_many / serve")
    kernels[-1].update(
        launches_other_paths={
            "staged CAP top-4 serve_many / serve": [c_launches[name],
                                                    c_launches_serve[name]],
            **{f"sharded {p}": t_launches[p][name] for p in t_launches},
            "spatial steps": sp_launches[name], "staged spatial steps": st_launches[name]},
        replaced_ms=me["times"]["serving"]["replaced_ms"],
        replaced_graph_ms=me["times"]["serving"]["replaced_graph_ms"],
        replaced_busy_ms=me["times"]["serving"]["replaced_busy_ms"],
        spatial={k: v for k, v in me["times"].items() if k != "serving"},
        staged_step=me["step"])
    # The overlapped serve_many's launches (phase 15) beside the blocking
    # path's, on the fused and the default (staged) serving paths.
    for e in kernels:
        if e["path"] == "fused serve_many / serve":
            e["launches_overlap"] = ov["launches"]["fused"][
                e["name"].replace("fused_dehaze_lanes.", "")]
        elif e["path"] == "staged serve_many / serve":
            e["launches_overlap"] = ov["launches"]["staged"][e["name"]]
    print("launches on the overlapped serve_many (phase 15): " + json.dumps(
        {e["name"]: e["launches_overlap"] for e in kernels
         if "launches_overlap" in e}), flush=True)
    # Phase 16's overlapped autoscaled ramp and first-fit 2 x 2 fleet.
    for e in kernels:
        name = {"fused serve_many / serve": "fused",
                "staged serve_many / serve": "staged"}.get(e["path"])
        if name is not None:
            key = e["name"].replace("fused_dehaze_lanes.", "") \
                if name == "fused" else e["name"]
            for run in ("autoscale", "fleet"):
                e[f"launches_{run}"] = el["launches"][name, run][key]
    print("launches on the autoscaled ramp and the 2 x 2 fleet (phase 16): "
          + json.dumps({e["name"]: [e["launches_autoscale"], e["launches_fleet"]]
                        for e in kernels if "launches_autoscale" in e}),
          flush=True)
    for x in el["switches"]:
        print(f"ladder switch {x['path']}: {x['from']} -> {x['to']} lanes, "
              f"{x['wall_s'] * 1e3} ms on the serve thread", flush=True)
    for x in el["warm"]:
        print(f"rung warm-up {x['path']}: {x['rung']} lanes, {x['s']} s",
              flush=True)
    # Phase 18's multi-axis steps (their 8 checked calls).
    for e in kernels:
        if e["name"] in ma["launches"]:
            e["launches_multiaxis"] = ma["launches"][e["name"]]
    print("launches on the multi-axis sharded steps (phase 18): " + json.dumps(
        {e["name"]: e["launches_multiaxis"] for e in kernels
         if "launches_multiaxis" in e}), flush=True)
    # Phase 19's variants: their launches in its checks, and their times
    # beside the default's.
    by_kernel: dict = {}
    for variant, counts in tu["launches"].items():
        for name, n in counts.items():
            by_kernel.setdefault(name, {})[variant] = n
    knob_ms = {"fused_dehaze_lanes": "B1 ", "fused_transmission_halo": "B9 ",
               "staged.atmolight": "B6a ", "staged.atmolight_topk": "B6b "}
    for e in kernels:
        if e["name"] in by_kernel:
            e["launches_variants"] = by_kernel[e["name"]]
        if e["name"] in knob_ms:
            e["variant_ms"] = {k: {f: r[f] for f in ("ms", "default_ms", "graph_ms",
                                                      "default_graph_ms")}
                               for k, r in tu["times"].items()
                               if k.startswith(knob_ms[e["name"]])}
    print("launches of the knobs' variants (phase 19): " + json.dumps(
        {e["name"]: e["launches_variants"] for e in kernels
         if "launches_variants" in e}), flush=True)
    for run, fps in el["turns"].items():
        print(f"phase 16 turns (fused, overlapped): {run} aggregate fps {fps}",
              flush=True)
    for line in el["cli"]:
        print(f"serve CLI (phase 16): {line}", flush=True)
    for name, turns in ov["turns"].items():
        print(f"serve_many turns ({name}; blocking, overlap, overlap, blocking): "
              f"fps {[t['fps'] for t in turns]}, ms per tick "
              f"{[t['ms_per_tick'] for t in turns]}", flush=True)
    print(f"serve CLI (overlap, 4 x 64 uint8 480p): {ov['cli']}", flush=True)
    print(f"serve_many aggregate fps: fused {rep.fps} ({rep.frames} frames, "
          f"{rep.wall_s} s), staged {s_rep.fps} ({s_rep.frames} frames, "
          f"{s_rep.wall_s} s); total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print_vision(vi, card)
    print_train(tr, card)
    print_diffusion(df, card)
    print_model_axis(mx, card)
    print(f"whole script: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase23-child"]:
        sys.exit(phase23_child(sys.argv[2:]))
    sys.exit(main())
