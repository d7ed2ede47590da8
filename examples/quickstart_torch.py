"""Quickstart, PyTorch port: dehaze a synthetic hazy clip with the
component framework (the twin of ``examples/quickstart.py``).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The default device is CUDA; without a card the step raises (nothing falls
back to the CPU) unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (DehazeConfig, init_atmo_state, make_dehaze_step,
                              resolve_device)
from repro_torch.data import HazeVideoSpec, generate_haze_video

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="default: CUDA")
dev = resolve_device(ap.parse_args().device)

# 1. A synthetic foggy clip with ground truth (Eq. 1 physics).
video = generate_haze_video(HazeVideoSpec(height=120, width=160,
                                          n_frames=16, a_noise=0.0))
print(f"clip: {video.hazy.shape}, true A ~ {video.A.mean(axis=0).round(3)}")

# 2. Configure the paper's pipeline: DCP transmission estimator, guided
#    refinement, cross-frame atmospheric-light normalization (§3.3).
cfg = DehazeConfig(algorithm="dcp", update_period=4, lam=0.05)
step = make_dehaze_step(cfg, device=dev)

# 3. One step processes a batch of frames through all three components;
#    the AtmoState carries the shared A between batches.
state = init_atmo_state(dev)
ids = torch.arange(16, dtype=torch.int32, device=dev)
out = step(torch.from_numpy(video.hazy[:8]).to(dev), ids[:8], state)
out2 = step(torch.from_numpy(video.hazy[8:]).to(dev), ids[8:], out.state)

dehazed = torch.cat([out.frames, out2.frames]).cpu().numpy()
err_before = np.abs(video.hazy - video.clear).mean()
err_after = np.abs(dehazed - video.clear).mean()
print(f"L1 error vs ground truth: hazy={err_before:.4f} -> "
      f"dehazed={err_after:.4f}")
print(f"estimated A after 16 frames: {out2.state.A.cpu().numpy().round(3)} "
      f"(true {video.A[-1].round(3)})")
assert err_after < err_before
print("OK")
