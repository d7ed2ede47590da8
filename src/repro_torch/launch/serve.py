"""The serve CLI: the paper's full pipeline over synthetic hazy streams.

Spout -> dehaze step (the port's kernels) -> monitor (reorder + timeout
skip) -> sink, with per-stream EMA state, on one CUDA card (``--device
cpu`` runs the kernels' plain versions, for the tests).

Single stream:
  PYTHONPATH=src python -m repro_torch.launch.serve --algorithm dcp \\
      --resolution 480p --frames 96 --workers 3 --batch 8

Multi-tenant (N videos continuously batched over L lanes), on the
zero-copy overlapped tick path, failing if any tick fell back to the
blocking path:
  REPRO_TICK_OVERLAP=1 PYTHONPATH=src python -m repro_torch.launch.serve \\
      --streams 4 --lanes 4 --resolution 480p --frames 64 --io-dtype uint8 \\
      --expect-overlap --fail-on-skipped

Elastic autoscaling (the lane count walks a ladder of warmed rungs under
load; ``--ramp`` makes a burst of short clips and two long tails, so the
burst forces a grow and the tail a shrink; the rungs are primed first):
  PYTHONPATH=src python -m repro_torch.launch.serve --resolution 480p \\
      --streams 6 --lanes 4 --autoscale --ladder 2,4 --ramp \\
      --expect-switches 2 --io-dtype uint8 --fail-on-skipped

Fleet serving (2 hosts x 4 lanes behind one global-EDF front door, threads
over one card; sticky placement keeps each stream's EMA on one host, and
overflow spills to the other):
  PYTHONPATH=src python -m repro_torch.launch.serve --resolution 480p \\
      --streams 8 --hosts 2 --lanes 4 --frames 32 --expect-spillover 1 \\
      --fail-on-skipped

A non-float32 ``--io-dtype`` with ``--streams > 1`` also replays cam0
alone through a fresh single-stream server and fails on a drift above
1e-5. ``--expect-switches`` fails on fewer switches or on any rung that
failed to warm, ``--expect-spillover`` on fewer spillovers, and a fleet
on any migration.

Tuned serving (a measured search of the kernels' knobs at this serve's
shapes into the port's tuning table, ``REPRO_TORCH_KERNEL_TUNING``,
default ``results/kernel_tuning_torch.json``, under this card's name; then
the serve resolves the winners):
  PYTHONPATH=src python -m repro_torch.launch.serve --tune \
      --resolution 480p --streams 4 --lanes 4 --frames 64 --io-dtype uint8 \
      --fail-on-skipped

With ``REPRO_TUNE_REQUIRE_TABLE=1`` a serve whose knobs have neither a
table entry for this card nor a ``REPRO_TUNE_<OP>`` override exits 1.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import DehazeConfig
from repro_torch.data import HazeVideoSpec, generate_haze_video
from repro_torch.kernels import ref as kref
from repro_torch.stream import (ElasticServer, ScalePolicy, StreamRequest,
                                ladder_rungs)

RESOLUTIONS = {"120p": (120, 160), "240p": (240, 320), "480p": (480, 640),
               "576p": (576, 1024)}


def _make_videos(n: int, h: int, w: int, frames, seed0: int = 100):
    """N synthetic videos with distinct scenes and base atmospheric lights,
    so each lane follows its own coherence trajectory (the reference's
    recipe, bit for bit). ``frames`` is a length or one per stream."""
    lengths = frames if isinstance(frames, (list, tuple)) else [frames] * n
    vids = []
    for i in range(n):
        base = 0.75 + 0.05 * (i % 4)
        vids.append(generate_haze_video(HazeVideoSpec(
            height=h, width=w, n_frames=lengths[i], seed=seed0 + i,
            a_noise=0.0, a_base=(base, base, min(1.0, base + 0.02)))))
    return vids


def _wire_hazy(vid, io_dtype: str) -> torch.Tensor:
    """The stream put on the wire: the float32 hazy video quantised or cast
    to the serving ingest dtype (as it is for float32), on the host."""
    if io_dtype == "float32":
        return torch.from_numpy(vid.hazy)
    return kref.quantize_frames(vid.hazy, io_dtype)


def _print_tick_io(rep) -> None:
    """One line of tick-I/O accounting (README, "Tick I/O & overlap"): the
    ticks on the zero-copy path, the D2H volume, and where the loop's time
    went (host staging, device step dispatch, delivery)."""
    ph = rep.phases or {}
    phase_txt = " ".join(f"{k}={ph[k] * 1e3:.1f}ms" for k in sorted(ph))
    print(f"tick_io: overlap_ticks={rep.overlap_ticks}/{rep.ticks} "
          f"d2h_bytes={rep.d2h_bytes} stragglers={rep.stragglers}"
          + (f" {phase_txt}" if phase_txt else ""))


def _overlap_failed(args, rep) -> bool:
    """``--expect-overlap``: a tick on the blocking path is a silent
    fallback, which this gate turns into a failure."""
    if args.expect_overlap and rep.overlap_ticks < rep.ticks:
        print(f"FAIL: expected every tick on the overlapped path, got "
              f"{rep.overlap_ticks}/{rep.ticks} (silent fallback to the "
              f"blocking path)", file=sys.stderr)
        return True
    return False


def _server(args, cfg) -> ElasticServer:
    return ElasticServer(cfg, n_workers=args.workers, batch=args.batch,
                         timeout_s=args.timeout_ms / 1e3, device=args.device)


def _serve_single(args, cfg, h: int, w: int):
    vid = _make_videos(1, h, w, args.frames)[0]
    srv = _server(args, cfg)
    outs = {}
    t0 = time.perf_counter()
    rep = srv.serve(iter(_wire_hazy(vid, args.io_dtype)),
                    sink=lambda fid, f: outs.setdefault(fid, f))
    wall = time.perf_counter() - t0

    keys = sorted(outs)
    got = np.stack([outs[k].float().numpy() for k in keys])
    err_hazy = np.abs(vid.hazy[keys] - vid.clear[keys]).mean()
    err_out = np.abs(got - vid.clear[keys]).mean()
    print(f"algorithm={args.algorithm} resolution={args.resolution} "
          f"workers={rep.n_lanes}")
    print(f"frames={rep.frames} skipped={rep.skipped} "
          f"fps={rep.fps:.2f} wall={wall:.2f}s")
    _print_tick_io(rep)
    print(f"L1 vs ground truth: hazy={err_hazy:.4f} dehazed={err_out:.4f}")
    print(f"final shared A = {srv.store.get('default').A.numpy()}")
    return (1 if _overlap_failed(args, rep) else 0), rep.skipped


def _ramp_lengths(args) -> list:
    """``--ramp``: a burst of short clips, then two long tails (the
    reference's lengths)."""
    if not args.ramp:
        return [args.frames] * args.streams
    n_long = min(2, args.streams)
    return [max(args.batch, args.frames // 4)] * (args.streams - n_long) \
        + [args.frames] * n_long


def _gates(args, rep) -> int:
    """The fleet's and the ladder's report lines and gates: 1 on a
    migration, on a rung that failed to warm when switches are expected,
    on fewer switches or spillovers than expected."""
    rc = 0
    if args.hosts > 1:
        print(f"spillovers={rep.spillovers} migrations={rep.migrations}")
        if rep.migrations != 0:
            print(f"FAIL: sticky placement violated: {rep.migrations} EMA "
                  f"migration(s)", file=sys.stderr)
            rc = 1
    if args.autoscale:
        print(f"ladder_switches={rep.ladder_switches} "
              f"switch_wall={rep.switch_wall_s * 1e3:.1f}ms "
              f"evictions={rep.evictions} final_lanes={rep.n_lanes} "
              f"warm_failures={rep.warm_failures}")
        if args.expect_switches and rep.warm_failures:
            print(f"FAIL: {rep.warm_failures} ladder rung(s) failed to warm "
                  f"(retried once); the expected switches cannot be "
                  f"trusted", file=sys.stderr)
            rc = 1
    if rep.ladder_switches < args.expect_switches:
        print(f"FAIL: expected >= {args.expect_switches} ladder switches, "
              f"got {rep.ladder_switches}", file=sys.stderr)
        rc = 1
    if rep.spillovers < args.expect_spillover:
        print(f"FAIL: expected >= {args.expect_spillover} spillover "
              f"admission(s), got {rep.spillovers}", file=sys.stderr)
        rc = 1
    return rc


def _serve_many(args, cfg, h: int, w: int):
    vids = _make_videos(args.streams, h, w, _ramp_lengths(args))
    wires = [_wire_hazy(v, args.io_dtype) for v in vids]
    lanes = args.lanes if args.lanes > 0 else args.streams
    srv = _server(args, cfg)
    counts: dict = {}
    cam0_out: dict = {}

    def sink(sid: str, fid: int, f) -> None:
        counts[sid] = counts.get(sid, 0) + 1
        if sid == "cam0":
            cam0_out[fid] = f.float()

    policy = None
    if args.autoscale:
        rungs = tuple(int(r) for r in args.ladder.split(","))
        policy = ScalePolicy(rungs=rungs, dwell_up=1, dwell_down=2)
        # Prime every rung (kernel builds, steps in the cache) so that the
        # switches gate on load, not on build time racing short streams.
        warm = _wire_hazy(_make_videos(1, h, w, args.batch, seed0=90)[0],
                          args.io_dtype)
        for r in ladder_rungs(rungs, lanes):
            srv.serve_many([StreamRequest(f"_warm{r}", iter(warm))],
                           n_lanes=r)

    rep = srv.serve_many([StreamRequest(f"cam{i}", iter(wire))
                          for i, wire in enumerate(wires)],
                         n_lanes=lanes, sink=sink, autoscale=args.autoscale,
                         policy=policy, n_hosts=args.hosts)
    print(f"algorithm={args.algorithm} resolution={args.resolution} "
          f"streams={args.streams} lanes={rep.n_lanes} batch={args.batch} "
          f"hosts={rep.n_hosts}")
    print(f"frames={rep.frames} skipped={rep.skipped} ticks={rep.ticks} "
          f"aggregate_fps={rep.aggregate_fps:.2f} wall={rep.wall_s:.2f}s")
    _print_tick_io(rep)
    rc = _gates(args, rep)
    for sid in sorted(rep.per_stream):
        if sid.startswith("_warm"):
            continue
        r = rep.per_stream[sid]
        a = srv.store.get(sid).A.numpy().round(3)
        print(f"  {sid}: frames={r.frames} emitted={counts.get(sid, 0)} "
              f"skipped={r.skipped} fps={r.fps:.2f} A={a}")
    if _overlap_failed(args, rep):
        rc = 1
    if args.io_dtype != "float32" and cam0_out:
        # Replay cam0 alone through a fresh server on the same quantised
        # stream: the lane path must dehaze it as the single-stream path
        # does.
        ref_out: dict = {}
        _server(args, cfg).serve(
            iter(wires[0]), stream_id="cam0",
            sink=lambda fid, f: ref_out.setdefault(fid, f.float()))
        common = sorted(set(cam0_out) & set(ref_out))
        drift = max((float((cam0_out[k] - ref_out[k]).abs().max())
                     for k in common), default=0.0)
        print(f"io_dtype={args.io_dtype} parity(cam0): "
              f"frames={len(common)} maxerr={drift:.2e}")
        if not common or drift > 1e-5:
            print(f"FAIL: cam0 parity drift {drift:.2e} > 1e-5 between the "
                  f"lane-batched and single-stream serves at "
                  f"io_dtype={args.io_dtype}", file=sys.stderr)
            rc = 1
    return rc, rep.skipped


def _tune_for_serve(args, h: int, w: int) -> int:
    """``--tune``: measured-search the kernels' knobs at this serve's
    shapes (the megakernel's ``fused_<alg>`` at (batch, H, W), with
    ``--streams > 1`` ``fused_lanes`` at (lanes, batch, H, W), and the
    staged path's atmospheric light at its flat (frames, H, W)) into the
    tuning table under this card's name, so the serve resolves freshly
    measured winners instead of the defaults or a stale table. Returns 1
    where a candidate was skipped for any reason but not fitting a block
    (a variant that failed to build or run), else 0."""
    from repro_torch.kernels import tuning

    device = torch.device(args.device or "cuda")
    stats = tuning.TuneStats()
    kw = dict(method="search", persist=True, stats=stats, device=device)
    tuning.autotune_fused(shapes=((args.batch, h, w),),
                          algorithms=(args.algorithm,), topks=(1,),
                          io_dtypes=(args.io_dtype,), **kw)
    lanes = 1
    if args.streams > 1:
        lanes = args.lanes if args.lanes > 0 else args.streams
        tuning.autotune_fused_lanes(shapes=((lanes, args.batch, h, w),),
                                    io_dtype=args.io_dtype, **kw)
    tuning.autotune_atmolight(shapes=((lanes * args.batch, h, w),), ks=(1,),
                              **kw)
    print(f"tune: device_kind={tuning.device_kind(device)} "
          f"table={tuning.table_path()} timed_runs={stats.timed_runs} "
          f"(exhaustive would be {stats.exhaustive_runs}) "
          f"skipped={stats.skipped}", flush=True)
    failed = {k: n for k, n in stats.skipped.items() if k != "TileDoesNotFit"}
    if failed:
        print(f"FAIL: --tune skipped candidates that fit: {failed}",
              file=sys.stderr)
        return 1
    return 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve synthetic hazy video through the port.")
    ap.add_argument("--algorithm", default="dcp", choices=["dcp", "cap"])
    ap.add_argument("--resolution", default="240p",
                    choices=sorted(RESOLUTIONS))
    ap.add_argument("--frames", type=int, default=64,
                    help="frames per stream")
    ap.add_argument("--streams", type=int, default=1,
                    help="concurrent videos (> 1 uses the lane-batched "
                         "multi-tenant scheduler)")
    ap.add_argument("--lanes", type=int, default=0,
                    help="lanes for --streams > 1 (0: one per stream; per "
                         "host with --hosts > 1; the cap with --autoscale)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="fleet hosts: > 1 serves through the fleet tier "
                         "(global EDF, sticky placement, spillover)")
    ap.add_argument("--expect-spillover", type=int, default=0,
                    help="exit non-zero unless at least this many "
                         "admissions spilled over to another host")
    ap.add_argument("--autoscale", action="store_true",
                    help="elastic lane count: --lanes is the cap and the "
                         "serve walks the --ladder under load")
    ap.add_argument("--ladder", default="4,8,16,32",
                    help="comma-separated lane-count rungs (capped by "
                         "--lanes)")
    ap.add_argument("--ramp", action="store_true",
                    help="stagger the stream lengths (a burst of short "
                         "clips, two long tails) to force a grow and a "
                         "shrink")
    ap.add_argument("--expect-switches", type=int, default=0,
                    help="exit non-zero unless at least this many ladder "
                         "switches were committed and every rung warmed")
    ap.add_argument("--workers", type=int, default=3,
                    help="logical workers of single-stream serving")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--timeout-ms", type=float, default=20.0,
                    help="monitor reader timeout (paper: 20 ms)")
    ap.add_argument("--update-period", type=int, default=8)
    ap.add_argument("--lam", type=float, default=0.05)
    ap.add_argument("--kernel-mode", default="auto")
    ap.add_argument("--io-dtype", default="float32",
                    choices=["float32", "bfloat16", "uint8"],
                    help="wire dtype of the streams (quantised on the "
                         "host); with --streams > 1 a non-float32 run also "
                         "replays cam0 single-stream and fails on drift")
    ap.add_argument("--device", default=None,
                    help="the device to serve on (default: CUDA; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--expect-overlap", action="store_true",
                    help="exit non-zero unless every tick took the "
                         "zero-copy overlapped path (pair with "
                         "REPRO_TICK_OVERLAP=1)")
    ap.add_argument("--fail-on-skipped", action="store_true",
                    help="exit non-zero if any frame was timeout-skipped")
    ap.add_argument("--tune", action="store_true",
                    help="run the successive-halving measured search of "
                         "the kernels' knobs for this serve's shapes and "
                         "wire dtype first (winners persist under this "
                         "card's name in the tuning table), then serve "
                         "with them")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); return the exit
    code: 0, 1 on a failed gate (overlap, parity, skips, switches,
    spillover, migrations), on a ``--tune`` candidate that failed to build
    or run, or on a knob that ``REPRO_TUNE_REQUIRE_TABLE`` found
    unmeasured."""
    from repro_torch.kernels.tuning import AutotuneError
    args = _parser().parse_args(argv)
    h, w = RESOLUTIONS[args.resolution]
    cfg = DehazeConfig(algorithm=args.algorithm,
                       update_period=args.update_period, lam=args.lam,
                       kernel_mode=args.kernel_mode, io_dtype=args.io_dtype)
    if args.tune and _tune_for_serve(args, h, w):
        return 1
    serve = _serve_many if args.streams > 1 else _serve_single
    try:
        rc, skipped = serve(args, cfg, h, w)
    except AutotuneError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    if args.fail_on_skipped and skipped > 0:
        print(f"FAIL: {skipped} frame(s) timeout-skipped", file=sys.stderr)
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
