"""End-to-end serving driver, PyTorch port (the twin of
``examples/video_dehaze_serve.py``): the paper's five-layer network --
spout -> parallel workers -> monitor -- over a live synthetic stream, with
straggler mitigation and restart-safe stream state.

Run:  PYTHONPATH=src python examples/video_dehaze_serve_torch.py [--device cpu]

The default device is CUDA; without a card the server raises (nothing
falls back to the CPU) unless ``--device cpu`` is given.
"""
import argparse

import numpy as np

from repro_torch.core import DehazeConfig
from repro_torch.data import HazeVideoSpec, generate_haze_video
from repro_torch.stream import ElasticServer, StreamRequest, StreamStateStore

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="default: CUDA")
dev = ap.parse_args().device

video = generate_haze_video(HazeVideoSpec(height=120, width=160,
                                          n_frames=48, a_noise=0.0))

cfg = DehazeConfig(algorithm="cap", update_period=8, lam=0.05)
server = ElasticServer(cfg, n_workers=3, batch=8, timeout_s=0.02, device=dev)

# --- serve the first half ---------------------------------------------------
emitted = []
rep1 = server.serve(iter(video.hazy[:24]),
                    sink=lambda fid, f: emitted.append(fid))
print(f"chunk 1: {rep1.frames} frames @ {rep1.fps:.1f} fps "
      f"(skipped {rep1.skipped})")

# --- simulate a crash + restart: stream state survives ------------------------
snapshot = server.store.to_numpy_pytree()      # checkpointable pytree
restarted = ElasticServer(cfg, n_workers=2, batch=8, device=dev)
restarted.store = StreamStateStore.from_jax_pytree(snapshot)
print(f"restarted at cursor {restarted.store.cursor('default')} with "
      f"A = {restarted.store.get('default').A.numpy().round(3)}")

rep2 = restarted.serve(iter(video.hazy[24:]),
                       sink=lambda fid, f: emitted.append(fid))
print(f"chunk 2: {rep2.frames} frames @ {rep2.fps:.1f} fps")

assert emitted == sorted(emitted), "monitor must emit in order"
assert restarted.store.cursor("default") == 48
print(f"emitted {len(emitted)} ordered frames across a restart — OK")

# --- multi-tenant: 4 cameras continuously batched over 2 device lanes --------
# Each stream keeps its own coherent A trajectory (one lane row of the
# lane-batched AtmoState); with fewer lanes than streams the scheduler
# queues the surplus and reuses lanes as streams end.
cameras = [generate_haze_video(HazeVideoSpec(
    height=120, width=160, n_frames=16 + 8 * i, seed=10 + i, a_noise=0.0,
    a_base=(0.72 + 0.05 * i,) * 3)) for i in range(4)]

fleet = ElasticServer(cfg, batch=8, timeout_s=0.02, device=dev)
mrep = fleet.serve_many([StreamRequest(f"cam{i}", iter(v.hazy))
                         for i, v in enumerate(cameras)], n_lanes=2)
print(f"fleet: {mrep.frames} frames from {mrep.admissions} streams over "
      f"{mrep.n_lanes} lanes in {mrep.ticks} ticks "
      f"@ {mrep.aggregate_fps:.1f} aggregate fps")
for sid in sorted(mrep.per_stream):
    r = mrep.per_stream[sid]
    print(f"  {sid}: {r.frames} frames, skipped {r.skipped}, "
          f"A = {np.asarray(fleet.store.get(sid).A.numpy()).round(3)}")
assert mrep.frames == sum(16 + 8 * i for i in range(4))
print("OK")
