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

A non-float32 ``--io-dtype`` with ``--streams > 1`` also replays cam0
alone through a fresh single-stream server and fails on a drift above
1e-5. ``--autoscale``, ``--hosts > 1`` and ``--tune`` are not ported yet
(ROADMAP.md queue A) and exit non-zero.
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
from repro_torch.stream import ElasticServer, StreamRequest

RESOLUTIONS = {"120p": (120, 160), "240p": (240, 320), "480p": (480, 640),
               "576p": (576, 1024)}


def _make_videos(n: int, h: int, w: int, frames: int, seed0: int = 100):
    """N synthetic videos with distinct scenes and base atmospheric lights,
    so each lane follows its own coherence trajectory (the reference's
    recipe, bit for bit)."""
    vids = []
    for i in range(n):
        base = 0.75 + 0.05 * (i % 4)
        vids.append(generate_haze_video(HazeVideoSpec(
            height=h, width=w, n_frames=frames, seed=seed0 + i,
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


def _serve_many(args, cfg, h: int, w: int):
    vids = _make_videos(args.streams, h, w, args.frames)
    wires = [_wire_hazy(v, args.io_dtype) for v in vids]
    lanes = args.lanes if args.lanes > 0 else args.streams
    srv = _server(args, cfg)
    counts: dict = {}
    cam0_out: dict = {}

    def sink(sid: str, fid: int, f) -> None:
        counts[sid] = counts.get(sid, 0) + 1
        if sid == "cam0":
            cam0_out[fid] = f.float()

    rep = srv.serve_many([StreamRequest(f"cam{i}", iter(wire))
                          for i, wire in enumerate(wires)],
                         n_lanes=lanes, sink=sink)
    print(f"algorithm={args.algorithm} resolution={args.resolution} "
          f"streams={args.streams} lanes={rep.n_lanes} batch={args.batch}")
    print(f"frames={rep.frames} skipped={rep.skipped} ticks={rep.ticks} "
          f"aggregate_fps={rep.aggregate_fps:.2f} wall={rep.wall_s:.2f}s")
    _print_tick_io(rep)
    for sid in sorted(rep.per_stream):
        r = rep.per_stream[sid]
        a = srv.store.get(sid).A.numpy().round(3)
        print(f"  {sid}: frames={r.frames} emitted={counts.get(sid, 0)} "
              f"skipped={r.skipped} fps={r.fps:.2f} A={a}")
    rc = 1 if _overlap_failed(args, rep) else 0
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
                    help="lanes for --streams > 1 (0: one per stream)")
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
    for flag, what in (("--autoscale", "elastic lane autoscaling"),
                       ("--tune", "the tile-tuning search")):
        ap.add_argument(flag, action="store_true",
                        help=f"{what}: not ported yet (exits non-zero)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="fleet hosts; > 1 is not ported yet (exits "
                         "non-zero)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); return the exit
    code: 0, 1 on a failed gate (overlap, parity, skips), 2 for an option
    that is not ported yet."""
    args = _parser().parse_args(argv)
    unported = [name for name, on in (("--autoscale", args.autoscale),
                                      ("--hosts > 1", args.hosts > 1),
                                      ("--tune", args.tune)) if on]
    if unported:
        print(f"{', '.join(unported)}: not ported yet (ROADMAP.md queue A)",
              file=sys.stderr)
        return 2
    h, w = RESOLUTIONS[args.resolution]
    cfg = DehazeConfig(algorithm=args.algorithm,
                       update_period=args.update_period, lam=args.lam,
                       kernel_mode=args.kernel_mode, io_dtype=args.io_dtype)
    serve = _serve_many if args.streams > 1 else _serve_single
    rc, skipped = serve(args, cfg, h, w)
    if args.fail_on_skipped and skipped > 0:
        print(f"FAIL: {skipped} frame(s) timeout-skipped", file=sys.stderr)
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
