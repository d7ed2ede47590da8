"""Diffusion serving, PyTorch port (the twin of ``examples/sample_dit.py``):
a DDIM sampling loop on a reduced DiT, batched requests through the stream
monitor (out-of-order completion, ordered emission) -- the paper's layer-5
pattern applied to a diffusion workload.

Run:  PYTHONPATH=src python examples/sample_dit_torch.py [--device cpu]

The default device is CUDA; without a card it raises (nothing falls back
to the CPU) unless ``--device cpu`` is given.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs as cfgreg
from repro_torch.core import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import dit as D
from repro_torch.stream import Monitor

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="default: CUDA")
dev = resolve_device(ap.parse_args().device)

cfg = cfgreg.get_module("dit-l2").smoke_config()
params = cm.init_params(D.dit_param_table(cfg), 0, device=dev)
sample_step = D.make_sample_step(cfg, guidance=2.0)

B, STEPS = 4, 8
lat = cfg.latent_res
gen = torch.Generator(device=dev).manual_seed(1)
z = torch.randn((B, lat, lat, 4), generator=gen, device=dev)
y = torch.arange(B, device=dev) % cfg.n_classes

ts = np.linspace(999, 1, STEPS + 1).astype(np.int32)
t0 = time.perf_counter()
for i in range(STEPS):
    t = torch.full((B,), int(ts[i]), dtype=torch.int32, device=dev)
    t_next = torch.full((B,), int(ts[i + 1]), dtype=torch.int32, device=dev)
    z = sample_step(params, z, t, t_next, y)
if dev.type == "cuda":
    torch.cuda.synchronize(dev)
dt = time.perf_counter() - t0
assert not bool(torch.isnan(z).any())
print(f"sampled {B} latents x {STEPS} DDIM steps in {dt:.2f}s "
      f"({B * STEPS / dt:.1f} denoise-steps/s); latent std "
      f"{float(z.std()):.3f}")

# Requests complete out of order (different step counts); the monitor
# (paper §3.2 layer 5) restores submission order at the sink.
emitted = []
mon = Monitor(lambda rid, _: emitted.append(rid), timeout_s=5.0)
for rid in reversed(range(6)):          # worst case: reverse completion
    mon.put(rid, None)
    mon.poll()
mon.close()
mon.drain()
assert emitted == list(range(6))
print("ordered emission of out-of-order completions — OK")
