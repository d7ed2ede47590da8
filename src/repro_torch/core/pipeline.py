"""Dehazing step builders: the paper's component chain as one step call.

``make_step(cfg, placement)`` builds the step a
:class:`~repro_torch.core.placement.PlacementSpec` declares: the plain
batched step (``single``) or the lane-batched multi-stream step
(``lane_batched``), fused or staged. With ``kernel_mode="fused"`` and a
config the megakernel covers, the single step is the megakernel's L=1
view and the lane step runs all L lanes in one megakernel call
(lane-native). Otherwise (``"auto"``, the default, ``"pallas"``, ``"ref"``
and the fused fallback) the step is the staged component chain; its lane
step runs each component once over all L*B frames, with each lane's own
saved A in the DCP pre-divide and a per-lane EMA.

Every step runs on one device, fixed when it is built: ``device=None``
means CUDA (and raises without a card), ``device="cpu"`` the CPU. The step
moves its inputs there.

The sharded placements (``frame_sharded``, ``lane_sharded``) build an
SPMD step over a ``torch.distributed`` device mesh
(``launch.mesh.make_host_mesh``, or any mesh with the placement's axes):
every rank calls it with its own block and the replicated state.
Frame-sharded, each rank computes t and its frames' A candidates (fused:
the megakernel's transmission passes, one sequence; staged: the masked
filters of ``kernels.ops`` and a stable top-k), the candidates and ids
are all-gathered over the frame axes (``batch_axes``: one axis's group,
or for several axes one group over them, its blocks in the reference's
row-major order over the axes as given), and every rank scans the §3.3
EMA over the whole batch and keeps its slice.
Lane-sharded, every rank serves whole lanes and scans them locally.

A height or width axis of size > 1 splits each frame into tiles: the
(pre-map, luma) planes (or the RGB block) are halo-exchanged over the
axis's group, :func:`spatial_shard_stage` computes the tile's t and its k
best candidates with global indices (fused: the halo stage's kernels;
staged: the masked filters' kernels), and the lists are all-gathered over the
spatial groups (frame-sharded, then over the frame axes too) and merged on
every rank. Recovery runs the plain chain, as in the reference.

Every step but the lane-native megakernel's ends in one state sync
(``ops.merge_ema``: the candidate rows' merge and the per-lane §3.3 EMA,
one kernel on the card): the staged steps' one row a frame, the sharded
steps' gathered rows, the spatial steps' gathered lists.

Each step resolves its kernels' tuning knobs (``kernels.tuning``) at its
first call at a shape and keeps them for its life (``ops``' ``tuned``):
a tick makes no lookup. A step built before a table or an override
changed keeps the knobs it had; the serving tiers key their cached steps
by ``tuning.state_token()`` too, so a serve after such a change builds
new ones.

**Buffer donation** (``make_step(..., donate=...)``, the serving tiers'
contract; :func:`donation_spec`) is a buffer-reuse contract the port keeps
itself, where the reference asks ``jax.jit`` for it: a donated state's
tensors receive the new state in place, and J goes into a donated frame
buffer. The sharded steps take no donation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core import algorithms as alg
from repro_torch.core import env as _env
from repro_torch.core import spatial
from repro_torch.core.config import DehazeConfig
from repro_torch.core.normalize import (AtmoState, get_lane_state,
                                        pack_atmo_states)
from repro_torch.core.placement import PlacementSpec
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device; otherwise ``torch.device``.
    A CUDA request without a CUDA device raises ``RuntimeError``: nothing
    falls back to the CPU. ``"meta"`` (shapes only, for the dry run's
    traces) is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless device='cpu' is passed, and no "
            "CUDA device is available")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass
class DehazeOutput:
    frames: torch.Tensor        # (B, H, W, 3) haze-free J
    transmission: torch.Tensor  # (B, H, W) refined t
    atmo_light: torch.Tensor    # (B, 3) per-frame normalized A
    state: AtmoState


def _ingest(frames: torch.Tensor, cfg: DehazeConfig):
    """``(x, odt)``: the compute view of ``frames`` (float ingest passes
    through, uint8 upcasts through ``kernels.ref.upcast_frames``) and the
    resolved J/t output dtype. The megakernel takes the raw wire frames."""
    odt = kref.resolve_out_dtype(frames.dtype, cfg.out_dtype)
    x = frames if frames.dtype.is_floating_point \
        else kref.upcast_frames(frames)
    return x, odt


def _on(device: torch.device, frames, frame_ids, state: AtmoState):
    return (torch.as_tensor(frames).to(device),
            torch.as_tensor(frame_ids).to(device=device, dtype=torch.int32),
            state.to(device))


# ---------------------------------------------------------------------------
# Buffer donation
# ---------------------------------------------------------------------------

# Step argument positions (frames, frame_ids, state): the donation argnums
# index into this signature, as on the reference.
_ARG_FRAMES, _ARG_IDS, _ARG_STATE = 0, 1, 2
_DONATE = (False, True, "state")


def donation_spec(cfg: DehazeConfig) -> Tuple[int, ...]:
    """The step arguments a donating step may reuse, the reference's
    argnums: the EMA state (2) always (``out.state`` has its shapes and
    dtypes, and the serve loops thread it sequentially), the frame batch
    (0) only where the wire dtype is the resolved J dtype (float32 in and
    out, bfloat16 in and out): J then goes into the frames' buffer. A
    uint8 stream, or an ``out_dtype`` other than the wire's, never offers
    its frames."""
    cfg = cfg.validate()
    io = kref.as_torch_dtype(cfg.io_dtype)
    if kref.resolve_out_dtype(io, cfg.out_dtype) == io:
        return (_ARG_FRAMES, _ARG_STATE)
    return (_ARG_STATE,)


def _donate_state(given: AtmoState, used: AtmoState,
                  new: AtmoState) -> AtmoState:
    """Write ``new`` into ``used``'s tensors (the state the step read, on
    its device) and return a state over them. Where ``used``'s tensors
    are ``given``'s own (it lay on the step's device), ``given`` is
    consumed."""
    for name in ("A", "last_update", "initialized"):
        dst, src = getattr(used, name), getattr(new, name)
        if src is not dst:
            dst.copy_(src)
    if any(getattr(used, n) is getattr(given, n)
           for n in ("A", "last_update", "initialized")):
        given.consume()
    return AtmoState(A=used.A, last_update=used.last_update,
                     initialized=used.initialized)


def make_step(cfg: DehazeConfig, placement: Optional[PlacementSpec] = None,
              mesh=None, *, device: DeviceLike = None,
              associative: bool = True, lane_native: Optional[bool] = None,
              donate=False):
    """Build the step a placement declares:
    ``step(frames, frame_ids, state) -> DehazeOutput``.

    - ``single``: frames (B, H, W, 3), ids (B,), one stream's state;
    - ``lane_batched``: frames (L, B, H, W, 3), ids (L, B), a lane-batched
      state; ``lane_native`` follows :func:`resolve_lane_native` when None;
    - ``frame_sharded`` / ``lane_sharded``: the SPMD step over ``mesh`` (a
      device mesh with the placement's axes, required): each rank passes
      its own frames and ids and the replicated (frame-sharded) or its own
      lanes' (lane-sharded) state, and gets its block's output and the new
      state. The device is the mesh's; an explicit ``device`` of another
      type raises ``ValueError``. With several ``batch_axes`` of size > 1,
      the first build on a mesh is collective: every rank of the default
      group builds it, in the same order, since it makes the process
      groups of the frame axes (kept on the mesh for later builds).

    ``donate`` is the buffer-reuse contract of the serving tiers (README,
    "Tick I/O & overlap"):

    - ``False`` (default): nothing the caller passed is written;
    - ``"state"``: the step writes the new EMA state into the tensors of
      the state it read, so ``out.state`` shares their storage (the same
      ``data_ptr``) and the state chain allocates nothing from tick to
      tick. A state that lay on the step's device is consumed: reading
      its fields raises ``RuntimeError`` (reads dispatched before the
      call are safe). A host state is copied up first and stays the
      caller's;
    - ``True``: the state as under ``"state"``, and J written into the
      frame buffer the step read (on its device) where
      :func:`donation_spec` offers the frames, with no other full-size
      buffer for J.

    The sharded placements take no donation and raise ``ValueError``.
    """
    placement = (placement if placement is not None
                 else PlacementSpec()).validate()
    cfg = cfg.validate()
    if donate not in _DONATE:
        raise ValueError(
            f"donate must be False, True or 'state', got {donate!r}")
    if donate is not False and placement.sharded:
        raise ValueError(
            "donate= is a serving-tier contract for local batches; "
            f"mesh-sharded placement {placement} manages its own buffers")
    if placement.sharded:
        if mesh is None:
            raise ValueError(f"placement {placement} names mesh axes "
                             f"{placement.mesh_axes}; make_step needs the mesh")
        dev = resolve_device(mesh.device_type)
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device_type} device")
        step = _make_sharded_step(cfg, mesh, placement,
                                  associative=associative,
                                  lane_native=lane_native)
    else:
        dev = resolve_device(device)
        step = _make_local_step(cfg, placement, associative, lane_native)

    if donate is False:
        def on_device(frames, frame_ids, state: AtmoState) -> DehazeOutput:
            return step(*_on(dev, frames, frame_ids, state))
        return on_device

    frames_donated = donate is True and _ARG_FRAMES in donation_spec(cfg)
    # The staged steps write the new state straight into the state's
    # tensors (their state sync's kernel takes them as its output).
    in_place = ({"donate_state": True} if getattr(step, "donates_state", False)
                else {})

    def donating(frames, frame_ids, state: AtmoState) -> DehazeOutput:
        x, ids, st = _on(dev, frames, frame_ids, state)
        out = None
        if (frames_donated and x.is_contiguous()
                and x.dtype == kref.resolve_out_dtype(x.dtype, cfg.out_dtype)):
            out = x
        res = step(x, ids, st, out=out, **in_place)
        return dataclasses.replace(res, state=_donate_state(state, st,
                                                             res.state))
    return donating


def _make_local_step(cfg: DehazeConfig, placement: PlacementSpec,
                     associative: bool, lane_native: Optional[bool]):
    if placement.lanes:
        return _make_lane_step(cfg, associative=associative,
                               lane_native=lane_native)
    return _make_single_step(cfg, associative=associative)


def _fused_covers(cfg: DehazeConfig) -> bool:
    """Does ``cfg`` select the megakernel (``kernel_mode="fused"`` and a
    config it covers)?"""
    return cfg.kernel_mode == "fused" and alg.supports_fused(cfg)


def _make_single_step(cfg: DehazeConfig, associative: bool = True):
    """``step(frames, frame_ids, state, out=None)``: J goes into ``out``
    where given (so do the lane steps')."""
    if _fused_covers(cfg):
        tuned: dict = {}                     # the knobs, once a shape

        def fused_step(frames, frame_ids, state: AtmoState,
                       out=None) -> DehazeOutput:
            J, t, a_seq, new_state = alg.fused_dehaze(
                frames, frame_ids, state, cfg, out=out, tuned=tuned)
            return DehazeOutput(J, t, a_seq.to(J.dtype), new_state)
        return fused_step
    return _make_staged_step(cfg, associative=associative, lanes=False)


def _lane_view(state: AtmoState) -> AtmoState:
    """One stream's state as a one-lane state (views of its tensors)."""
    return AtmoState(A=state.A[None], last_update=state.last_update[None],
                     initialized=state.initialized[None])


def _state_sync(cfg: DehazeConfig, tk_rgb: torch.Tensor,
                frame_ids: torch.Tensor, state: AtmoState, associative: bool,
                tk_t: Optional[torch.Tensor] = None,
                tk_gidx: Optional[torch.Tensor] = None,
                state_out: Optional[AtmoState] = None):
    """The §3.3 state sync that ends every step but the lane-native
    megakernel's, through ``ops.merge_ema`` (one kernel on the card): each
    frame's M candidate rows -> its candidate (the mean rgb of the k
    smallest (t, global index) rows; the row itself at M = 1) -> the EMA.
    ``tk_rgb`` (L, B, M, 3) with (L, B) ids and a lane-batched state, or
    (B, M, 3) with (B,) ids and one stream's state; ``tk_t``/``tk_gidx``
    the rows' t and global indices (None at M = 1). -> ``(a_seq (..., B, 3)
    float32, new state)``; where ``state_out`` is given the new state goes
    into its tensors and is returned as ``state_out`` itself."""
    if frame_ids.dim() == 1:
        a_seq, new = _state_sync(
            cfg, tk_rgb[None], frame_ids[None], _lane_view(state), associative,
            None if tk_t is None else tk_t[None],
            None if tk_gidx is None else tk_gidx[None],
            None if state_out is None else _lane_view(state_out))
        if state_out is not None:
            return a_seq[0], state_out
        return a_seq[0], AtmoState(A=new.A[0], last_update=new.last_update[0],
                                   initialized=new.initialized[0])
    k = cfg.topk if tk_rgb.shape[2] > 1 else 1
    return ops.merge_ema(tk_t, tk_gidx, tk_rgb, k, frame_ids, state,
                         cfg.update_period, cfg.lam, associative,
                         mode=cfg.kernel_mode, out_state=state_out)


def _make_staged_step(cfg: DehazeConfig, associative: bool, lanes: bool):
    """The staged component chain over frames (B, H, W, 3) with one
    stream's state, or (``lanes``) over (L, B, H, W, 3) with a lane-batched
    state: every component runs once over all frames; the DCP pre-divide
    takes each lane's saved A and the EMA runs per lane. With
    ``donate_state`` the new state goes into ``state``'s own tensors."""
    t_est = alg.get_transmission_estimator(cfg.algorithm)
    tuned: dict = {}                         # the knobs, once a shape

    def step(frames, frame_ids, state: AtmoState, out=None,
             donate_state: bool = False) -> DehazeOutput:
        x, odt = _ingest(frames, cfg)
        # Component 1: transmission from the *saved* shared A (§3.3).
        t_raw = t_est(x, state.A, cfg)
        # Component 2: per-frame candidates, then cross-frame normalization.
        a_new = alg.estimate_atmospheric_light(x, t_raw, cfg, tuned)
        a_seq, new_state = _state_sync(cfg, a_new[..., None, :], frame_ids,
                                       state, associative,
                                       state_out=state if donate_state else None)
        a_seq = a_seq.to(x.dtype)
        if cfg.recompute_t_with_final_a and cfg.algorithm == "dcp":
            t_raw = t_est(x, a_seq, cfg)
        t = alg.refine_transmission(x, t_raw, cfg)
        # Component 3: haze-free generation (into ``out``, a buffer of
        # J's dtype: the recovery runs in x's, which is then the same).
        J = alg.generate_haze_free(x, t, a_seq, cfg, out=out)
        return DehazeOutput(J.to(odt), t.to(odt), a_seq.to(odt), new_state)

    step.donates_state = True
    return step


def make_dehaze_step(cfg: DehazeConfig, associative: bool = True, *,
                     device: DeviceLike = None):
    """``step(frames (B,H,W,3), frame_ids (B,), state) -> DehazeOutput``:
    :func:`make_step` with the single placement."""
    return make_step(cfg, PlacementSpec.single(), device=device,
                     associative=associative)


def resolve_lane_native(cfg: DehazeConfig) -> bool:
    """Lane-native megakernel for the multi-stream step? Yes whenever the
    fused megakernel covers the config; ``REPRO_LANE_NATIVE=0`` forces the
    per-lane path, ``=1`` forces lane-native and raises if the config
    cannot take it."""
    cfg = cfg.validate()
    fused_ok = _fused_covers(cfg)
    forced = _env.lane_native()
    if forced:
        if not fused_ok:
            raise ValueError(
                "REPRO_LANE_NATIVE=1 requires kernel_mode='fused' and a "
                "config the megakernel covers (algorithms.supports_fused); "
                f"got kernel_mode={cfg.kernel_mode!r}, "
                f"algorithm={cfg.algorithm!r}")
        return True
    if forced is not None:
        return False
    return fused_ok


def _make_lane_step(cfg: DehazeConfig, associative: bool = True,
                    lane_native: Optional[bool] = None):
    if lane_native is None:
        lane_native = resolve_lane_native(cfg)
    if lane_native:
        if not _fused_covers(cfg):
            raise ValueError(
                "lane_native=True requires kernel_mode='fused' and a config "
                "the megakernel covers (algorithms.supports_fused)")
        tuned: dict = {}                     # the knobs, once a shape

        def lane_step(frames, frame_ids, state: AtmoState,
                      out=None) -> DehazeOutput:
            J, t, a_seq, new_state = alg.fused_dehaze_lanes(
                frames, frame_ids, state, cfg, out=out, tuned=tuned)
            return DehazeOutput(J, t, a_seq.to(J.dtype), new_state)
        return lane_step

    if not _fused_covers(cfg):
        return _make_staged_step(cfg, associative=associative, lanes=True)

    # A fused config with the lane-native kernel forced off: the
    # megakernel's single-stream view, lane by lane.
    single = _make_single_step(cfg, associative=associative)

    def per_lane_step(frames, frame_ids, state: AtmoState,
                      out=None) -> DehazeOutput:
        outs = [single(frames[i], frame_ids[i], get_lane_state(state, i),
                       out=None if out is None else out[i])
                for i in range(frames.shape[0])]
        return DehazeOutput(
            frames=(torch.stack([o.frames for o in outs]) if out is None
                    else out),
            transmission=torch.stack([o.transmission for o in outs]),
            atmo_light=torch.stack([o.atmo_light for o in outs]),
            state=pack_atmo_states([o.state for o in outs]))
    return per_lane_step


def make_multi_stream_step(cfg: DehazeConfig, associative: bool = True,
                           lane_native: Optional[bool] = None, *,
                           device: DeviceLike = None):
    """``step(frames (L,B,H,W,3), frame_ids (L,B), state) ->
    DehazeOutput`` with a leading lane axis: :func:`make_step` with the
    lane-batched placement. Padding lanes (ids -1 everywhere) pass their
    state through untouched."""
    return make_step(cfg, PlacementSpec.lane_batched(), device=device,
                     associative=associative, lane_native=lane_native)


# ---------------------------------------------------------------------------
# The data-parallel sharded step
# ---------------------------------------------------------------------------

def _mesh_axis_size(mesh, name: str) -> int:
    """Size of the mesh axis ``name``."""
    if name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no {name!r}")
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Rank-ordered concatenation of every rank's ``x`` along axis 0."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Rank-ordered concatenation of every rank's ``x`` along axis 1."""
    stacked = _all_gather(x[None], group)            # (n, B, M, ...)
    return stacked.movedim(0, 1).reshape(
        (x.shape[0], -1) + tuple(x.shape[2:]))


def batch_group(mesh, batch_axes: Tuple[str, ...]):
    """``(group, order, index)`` for the batch axes ``batch_axes``: the
    group of the ranks that differ only in those axes, ``order[i]`` the
    place in the group's own order of the rank at place ``i`` of the
    reference's order (row-major over the axes in the order given;
    ``None`` where the two agree), and ``index`` this rank's place in the
    reference's order.

    With one axis of size > 1 (or none: then the first axis) the group is
    that axis's group. With several, the first call for a set of such axes
    makes one group for each coordinate of the other mesh axes, every rank
    making every group in the same order (``dist.new_group`` is
    collective), and keeps them on the mesh for later calls."""
    sizes = [_mesh_axis_size(mesh, ax) for ax in batch_axes]
    index = 0
    for ax, n in zip(batch_axes, sizes):
        index = index * n + (mesh.get_local_rank(ax) if n > 1 else 0)
    live = [ax for ax, n in zip(batch_axes, sizes) if n > 1]
    if len(live) <= 1:
        return mesh.get_group(live[0] if live else batch_axes[0]), None, index
    names = list(mesh.mesh_dim_names)
    dims = [names.index(ax) for ax in live]
    others = [d for d in range(len(names)) if d not in dims]
    n = math.prod(sizes)
    # Each row: one group's ranks, in the reference's order.
    rows = mesh.mesh.permute(others + dims).reshape(-1, n).tolist()
    me = dist.get_rank()
    (ranks,) = [r for r in rows if me in r]
    cache = vars(mesh).setdefault("_batch_groups", {})
    key = tuple(sorted(dims))
    if key not in cache:
        for row in rows:
            g = dist.new_group(ranks=row)
            if me in row:
                cache[key] = g
    group = cache[key]
    got = dist.get_process_group_ranks(group)        # the group's order
    order = [got.index(r) for r in ranks]
    return group, (None if order == list(range(n)) else order), index


def _batch_gather(mesh, batch_axes: Tuple[str, ...]):
    """``(gather, index)`` for the frame axes ``batch_axes``: ``gather(x)``
    concatenates every frame shard's ``x`` along axis 0 in the reference's
    order (``lax.all_gather(x, batch_axes, tiled=True)``: row-major over
    the axes in the order given) and ``index`` is this rank's place in it,
    over :func:`batch_group`'s group; the gathered blocks are put in the
    reference's order where the group's own order differs."""
    group, order, index = batch_group(mesh, batch_axes)
    if order is None:
        return (lambda x: _all_gather(x, group)), index
    n = len(order)

    def gather(x):
        blocks = _all_gather(x, group).view((n,) + tuple(x.shape))
        return torch.cat([blocks[i] for i in order])
    return gather, index


def spatial_shard_stage(cfg: DehazeConfig, frames: torch.Tensor,
                        x: torch.Tensor, pre_ext: torch.Tensor,
                        guide_ext: torch.Tensor, valid_h: torch.Tensor,
                        valid_w: Optional[torch.Tensor], row0: int, col0: int,
                        width: int, fused: bool,
                        tuned: Optional[dict] = None):
    """What one spatial shard computes after the halo exchange.

    ``frames`` (N, h, w, 3) is the shard's core block in the wire dtype
    and ``x`` its compute view; ``pre_ext``/``guide_ext`` (N, h_ext, w_ext)
    the exchanged (pre-map, luma) planes with their (h_ext,) row and
    (w_ext,) column validity (None: every column); ``(row0, col0)`` the
    core's origin in the frame and ``width`` the frame's width. ``fused``
    runs the halo stage's kernels (``alg.fused_transmission_halo``), else
    the staged chain on the masked filters of ``kernels.ops`` under
    ``cfg.kernel_mode`` (their kernels, or ``core.spatial``'s plain
    filters under ``"ref"``: one masked min filter, and six masked means
    for the guided filter). Returns
    ``(t (N, h, w), tk_t (N, k), tk_rgb (N, k, 3) float32, tk_gidx (N, k)
    int32)``: the refined t and the shard's k smallest (t_raw, index) rows,
    ascending, each index the pixel's flat index in the whole frame.
    ``tuned``: the caller's resolved kernel knobs (``ops.fused_dehaze``)."""
    h_loc, w_loc = frames.shape[1], frames.shape[2]
    if fused:
        t, tk_t, tk_rgb, tk_idx = alg.fused_transmission_halo(
            frames, pre_ext, guide_ext, valid_h, valid_w, cfg, tuned)
    else:
        hh = (pre_ext.shape[1] - h_loc) // 2
        hw = (pre_ext.shape[2] - w_loc) // 2
        t_raw_ext = kref.tmap_from_dark(
            ops.masked_min_filter_2d(pre_ext, valid_h, cfg.patch_radius,
                                     valid_w, mode=cfg.kernel_mode),
            cfg.algorithm, cfg.omega, cfg.beta).to(x.dtype)
        t_raw = t_raw_ext[:, hh:hh + h_loc, hw:hw + w_loc]
        tk_t, tk_rgb, tk_idx = kref.topk_candidates(t_raw, x, cfg.topk)
        if cfg.refine:
            t_ext = ops.masked_guided_filter(
                guide_ext, t_raw_ext, valid_h, cfg.gf_radius, cfg.gf_eps,
                valid_w, mode=cfg.kernel_mode)
            t = torch.clamp(t_ext[:, hh:hh + h_loc, hw:hw + w_loc], 0.0, 1.0)
        else:
            t = t_raw
    tk_idx = tk_idx.to(torch.int32)
    gidx = (tk_idx // w_loc + row0) * width + (tk_idx % w_loc + col0)
    return t, tk_t, tk_rgb.to(torch.float32), gidx.to(torch.int32)


def _make_sharded_step(cfg: DehazeConfig, mesh, placement: PlacementSpec,
                       associative: bool = True,
                       lane_native: Optional[bool] = None):
    """The SPMD step of a sharded placement (see the module docstring and
    ``make_step``)."""
    lanes = placement.lanes
    if not lanes and not placement.batch_axes:
        raise ValueError("a sharded non-lane placement needs batch_axes (the "
                         f"state sync gathers candidates over them); got "
                         f"{placement}")
    for ax in placement.mesh_axes:
        _mesh_axis_size(mesh, ax)                    # names a mesh axis
    height_axis, width_axis = placement.height_axis, placement.width_axis
    n_h = _mesh_axis_size(mesh, height_axis) if height_axis else 1
    n_w = _mesh_axis_size(mesh, width_axis) if width_axis else 1
    shard_h, shard_w = n_h > 1, n_w > 1
    # The mesh axes that split a frame: the exchange and the merge run on
    # these only.
    spatial_axes = tuple(ax for ax, on in ((height_axis, shard_h),
                                           (width_axis, shard_w)) if on)
    halo = cfg.patch_radius + (2 * cfg.gf_radius if cfg.refine else 0)
    use_fused = _fused_covers(cfg)
    if lanes and lane_native is None:
        # The lane-native megakernel has no halo form.
        lane_native = resolve_lane_native(cfg) and not spatial_axes
    ref_cfg = dataclasses.replace(cfg, kernel_mode="ref")
    halo_dtype = kref.as_torch_dtype(cfg.halo_dtype)
    tuned: dict = {}                         # the knobs, once a shape

    def halo_premap_and_guide(x, a_saved, keep_halo_dtype: bool):
        """The halo-extended (pre-map, luma) planes and the row and column
        validity: exchange the stacked two-channel plane (``halo_packed``)
        or the RGB block and map it after; in ``halo_dtype`` on the wire,
        kept so into the halo kernels when ``keep_halo_dtype`` (they upcast
        on load), else cast back to ``x``'s dtype."""
        def exchange(p):
            p = p.to(halo_dtype)
            valid_w = None
            if shard_h:
                p, valid_h = spatial.halo_exchange_height(p, halo, mesh,
                                                          height_axis)
            else:
                valid_h = torch.ones(p.shape[1], dtype=torch.bool,
                                     device=p.device)
            if shard_w:
                p, valid_w = spatial.halo_exchange_width(p, halo, mesh,
                                                         width_axis)
            return p, valid_h, valid_w

        if cfg.halo_packed:
            packed = torch.stack([alg.premap(x, a_saved, cfg),
                                  alg.luminance(x)], dim=-1)
            p_ext, valid_h, valid_w = exchange(packed)
            if not keep_halo_dtype:
                p_ext = p_ext.to(x.dtype)
            return (p_ext[..., 0].contiguous(), p_ext[..., 1].contiguous(),
                    valid_h, valid_w)
        x_ext, valid_h, valid_w = exchange(x)
        x_ext = x_ext.to(x.dtype)
        return (alg.premap(x_ext, a_saved, cfg), alg.luminance(x_ext),
                valid_h, valid_w)

    def spatial_t_and_lists(frames, x, a_saved):
        """Exchange, the shard's stage, then the lists' all-gathers over
        the spatial groups: (t, tk_rgb, (tk_t, tk_gidx)), each frame's M =
        shards x k rows in rank order, for the state sync to merge."""
        pre_ext, guide_ext, valid_h, valid_w = halo_premap_and_guide(
            x, a_saved, keep_halo_dtype=use_fused and cfg.halo_packed)
        h_loc, w_loc = frames.shape[1], frames.shape[2]
        row0 = mesh.get_local_rank(height_axis) * h_loc if shard_h else 0
        col0 = mesh.get_local_rank(width_axis) * w_loc if shard_w else 0
        t, tk_t, tk_rgb, tk_gidx = spatial_shard_stage(
            cfg, frames, x, pre_ext, guide_ext, valid_h, valid_w, row0, col0,
            w_loc * n_w, use_fused, tuned)
        for ax in spatial_axes:
            group = mesh.get_group(ax)
            tk_t, tk_rgb, tk_gidx = (_all_gather_rows(v, group)
                                     for v in (tk_t, tk_rgb, tk_gidx))
        return t, tk_rgb, (tk_t, tk_gidx)

    def staged_t_and_candidates(x, a_saved):
        """The staged chain on whole frames (every row valid, no exchange)
        -> (refined t, per-frame candidates (N, 3) float32, the mean of
        the k picks)."""
        valid = torch.ones(x.shape[1], dtype=torch.bool, device=x.device)
        t, _, tk_rgb, _ = spatial_shard_stage(
            cfg, x, x, alg.premap(x, a_saved, cfg), alg.luminance(x), valid,
            None, 0, 0, x.shape[2], fused=False)
        return t, tk_rgb.mean(1)

    def finish(x, t, a_seq, new_state, odt) -> DehazeOutput:
        a_seq = a_seq.to(x.dtype)
        out = alg.generate_haze_free(x, t, a_seq, ref_cfg)
        return DehazeOutput(out.to(odt), t.to(odt), a_seq.to(odt), new_state)

    if not lanes:
        gather, rank = _batch_gather(mesh, placement.batch_axes)

        def local_step(frames, frame_ids, state: AtmoState) -> DehazeOutput:
            b_loc = frames.shape[0]
            x, odt = _ingest(frames, cfg)
            lists = ()
            if spatial_axes:
                t, rows, lists = spatial_t_and_lists(frames, x, state.A)
            elif use_fused:
                t, _, rgb = alg.fused_transmission(frames, state.A, cfg)
                rows = rgb[:, None]
            else:
                t, rgb = staged_t_and_candidates(x, state.A)
                rows = rgb[:, None]
            # The §3.3 state sync: every rank gathers the whole batch's rows
            # (the merge is per frame, so where it runs does not matter) and
            # merges and scans them as one lane.
            rows_all = gather(rows.to(torch.float32))
            lists = [gather(v) for v in lists]
            ids_all = gather(frame_ids)
            a_seq_all, new_state = _state_sync(cfg, rows_all, ids_all, state,
                                               True, *lists)
            a_seq = a_seq_all[rank * b_loc:(rank + 1) * b_loc]
            return finish(x, t, a_seq, new_state, odt)
        return local_step

    def lane_local_step(frames, frame_ids, state: AtmoState) -> DehazeOutput:
        # Whole lanes live on this rank: the EMA scans are rank-local.
        l_loc, b = frames.shape[:2]
        if use_fused and lane_native and not spatial_axes:
            out, t, a_seq, new_state = alg.fused_dehaze_lanes(
                frames, frame_ids, state, cfg, tuned=tuned)
            return DehazeOutput(out, t, a_seq.to(out.dtype), new_state)
        x, odt = _ingest(frames, cfg)
        lists = ()
        if use_fused and not spatial_axes:
            t, _, rgb = alg.fused_transmission_lanes(frames, state.A, cfg)
            rows = rgb[:, :, None]
        else:
            # Lanes flattened onto the frame axis, each frame with its
            # lane's saved A.
            flat_x = x.reshape((l_loc * b,) + tuple(x.shape[2:]))
            a_pf = state.A.to(torch.float32).repeat_interleave(b, 0)
            a_pf = a_pf[:, None, None, :]
            if spatial_axes:
                flat = frames.reshape((l_loc * b,) + tuple(frames.shape[2:]))
                t, rows, lists = spatial_t_and_lists(flat, flat_x, a_pf)
            else:
                t, rgb = staged_t_and_candidates(flat_x, a_pf)
                rows = rgb[:, None]
            t = t.reshape((l_loc, b) + tuple(t.shape[1:]))
            rows = rows.reshape((l_loc, b) + tuple(rows.shape[1:]))
            lists = [v.reshape(l_loc, b, -1) for v in lists]
        a_seq, new_state = _state_sync(cfg, rows, frame_ids, state,
                                       associative, *lists)
        return finish(x, t, a_seq, new_state, odt)
    return lane_local_step


def make_sharded_dehaze_step(cfg: DehazeConfig, mesh,
                             batch_axes: Tuple[str, ...] = ("data",),
                             height_axis: Optional[str] = "model",
                             width_axis: Optional[str] = None):
    """The frame-sharded step over ``mesh``: :func:`make_step` with
    ``PlacementSpec.frame_sharded``. Each rank passes its own frames (B/n
    of them, rank r holding frames r*B/n onwards) and ids and the
    replicated state."""
    placement = PlacementSpec.frame_sharded(batch_axes=tuple(batch_axes),
                                            height_axis=height_axis,
                                            width_axis=width_axis)
    return make_step(cfg, placement, mesh)


__all__ = ["DehazeOutput", "PlacementSpec", "resolve_device", "make_step",
           "donation_spec",
           "make_dehaze_step", "make_multi_stream_step",
           "make_sharded_dehaze_step", "resolve_lane_native",
           "spatial_shard_stage"]
