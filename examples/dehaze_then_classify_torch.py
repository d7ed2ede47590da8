"""Dehazing as a pre-processing component for video analytics, PyTorch
port (the twin of ``examples/dehaze_then_classify.py``; the paper's
motivating use case §1): hazy frames -> dehazer -> ViT backbone.

The resize to the backbone's resolution is ``F.interpolate(mode=
"bilinear", antialias=True)``: like the JAX script's ``jax.image.resize(
..., "bilinear")`` it antialiases when it shrinks (64 -> 32 px here), but
its filter weights are PyTorch's, so the logits are not the JAX script's;
the claim asserted is the script's own: the dehazed frames' logits lie
closer to the clear scene's than the hazy frames' do.

Run:  PYTHONPATH=src python examples/dehaze_then_classify_torch.py [--device cpu]

The default device is CUDA; without a card the step raises (nothing falls
back to the CPU) unless ``--device cpu`` is given.
"""
import argparse

import torch
import torch.nn.functional as F

from repro_torch import configs as cfgreg
from repro_torch.core import (DehazeConfig, init_atmo_state, make_dehaze_step,
                              resolve_device)
from repro_torch.data import HazeVideoSpec, generate_haze_video
from repro_torch.models import common as cm
from repro_torch.models import vit as V

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="default: CUDA")
dev = resolve_device(ap.parse_args().device)

# Hazy input stream.
video = generate_haze_video(HazeVideoSpec(height=64, width=64, n_frames=8,
                                          a_noise=0.0))
frames = torch.from_numpy(video.hazy).to(dev)

# Component 1-3: the dehazer.
dehaze = make_dehaze_step(DehazeConfig(algorithm="dcp", gf_radius=8), device=dev)
out = dehaze(frames, torch.arange(8, dtype=torch.int32, device=dev),
             init_atmo_state(dev))

# Component 4: a ViT backbone (reduced config).
cfg = cfgreg.get_module("vit-l16").smoke_config()
params = cm.init_params(V.vit_param_table(cfg), 0, device=dev)
classify = V.make_forward(cfg)


def resize(x, res):
    """NHWC bilinear resize, antialiased when it shrinks."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(res, res), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


with torch.no_grad():
    logits_hazy = classify(params, resize(frames, cfg.img_res))
    logits_clean = classify(params, resize(out.frames, cfg.img_res))
    # The dehazed features should be closer to the ground-truth-clear
    # features than the hazy ones: dehazing reduces the domain gap for the
    # backbone.
    logits_gt = classify(params, resize(torch.from_numpy(video.clear).to(dev),
                                        cfg.img_res))
gap_hazy = float((logits_hazy - logits_gt).abs().mean())
gap_dehazed = float((logits_clean - logits_gt).abs().mean())
print(f"feature gap vs clear-scene logits: hazy={gap_hazy:.4f} "
      f"dehazed={gap_dehazed:.4f}")
assert gap_dehazed < gap_hazy
print("dehazing shrinks the backbone's domain gap — OK")
