"""Synthetic hazy-video generator driven by the paper's physics (Eq. 1-2).

Produces procedurally animated clear scenes, smooth depth maps, and a
slowly drifting + per-frame-noisy atmospheric light — the exact failure
mode Fig. 6 shows (independent per-frame A estimates flicker). Ground
truth (J, t, A per frame) is returned for quantitative evaluation, which
no real foggy video can provide.

The port's own copy of the JAX package's ``data/haze_video.py`` (numpy
only): the same seed gives the same video bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class HazeVideoSpec:
    height: int = 240
    width: int = 320
    n_frames: int = 64
    beta: float = 1.0
    a_base: Tuple[float, float, float] = (0.90, 0.92, 0.95)
    a_drift_amp: float = 0.04      # slow sinusoidal drift of A (scene change)
    a_noise: float = 0.02          # per-frame estimation-noise analogue
    motion: float = 2.0            # scene translation px/frame
    # Fraction of near-black "shadow" pixels. Real scenes satisfy the dark
    # channel prior (He et al.) through shadows/dark texture; purely smooth
    # procedural albedo would not, so we inject it explicitly.
    dark_speckle: float = 0.03
    seed: int = 0


def _smooth_noise(rng: np.random.Generator, h: int, w: int,
                  octaves: int = 4) -> np.ndarray:
    """Multi-octave value noise in [0, 1] (cheap Perlin stand-in)."""
    out = np.zeros((h, w), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        gh, gw = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        grid = rng.random((gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1, h)
        xs = np.linspace(0, gw - 1, w)
        y0 = np.clip(ys.astype(int), 0, gh - 2)
        x0 = np.clip(xs.astype(int), 0, gw - 2)
        fy = (ys - y0)[:, None].astype(np.float32)
        fx = (xs - x0)[None, :].astype(np.float32)
        v = (grid[y0][:, x0] * (1 - fy) * (1 - fx)
             + grid[y0 + 1][:, x0] * fy * (1 - fx)
             + grid[y0][:, x0 + 1] * (1 - fy) * fx
             + grid[y0 + 1][:, x0 + 1] * fy * fx)
        out += amp * v
        total += amp
        amp *= 0.5
    return out / total


@dataclasses.dataclass
class HazeVideo:
    """Materialized synthetic video with ground truth."""
    hazy: np.ndarray     # (N, H, W, 3)
    clear: np.ndarray    # (N, H, W, 3)
    t: np.ndarray        # (N, H, W)
    A: np.ndarray        # (N, 3)

    def __iter__(self) -> Iterator[np.ndarray]:
        return iter(self.hazy)


def generate_haze_video(spec: HazeVideoSpec) -> HazeVideo:
    rng = np.random.default_rng(spec.seed)
    h, w = spec.height, spec.width
    # Static "world" textures larger than the viewport; the camera pans.
    pad = int(spec.motion * spec.n_frames) + 8
    albedo = np.stack([_smooth_noise(rng, h + pad, w + pad) for _ in range(3)],
                      axis=-1)
    albedo = 0.15 + 0.7 * albedo
    if spec.dark_speckle > 0:
        shadow = rng.random((h + pad, w + pad)) < spec.dark_speckle
        albedo = np.where(shadow[..., None], albedo * 0.05, albedo)
    depth_world = 0.3 + 2.2 * _smooth_noise(rng, h + pad, w + pad)

    hazy = np.empty((spec.n_frames, h, w, 3), np.float32)
    clear = np.empty_like(hazy)
    t_all = np.empty((spec.n_frames, h, w), np.float32)
    a_all = np.empty((spec.n_frames, 3), np.float32)
    base = np.asarray(spec.a_base, np.float32)
    for i in range(spec.n_frames):
        off = int(spec.motion * i)
        J = albedo[off:off + h, off:off + w]
        d = depth_world[off:off + h, off:off + w]
        t = np.exp(-spec.beta * d).astype(np.float32)
        drift = spec.a_drift_amp * np.sin(2 * np.pi * i / max(spec.n_frames, 1))
        noise = spec.a_noise * rng.standard_normal(3).astype(np.float32)
        A = np.clip(base + drift + noise, 0.6, 1.0)
        I = J * t[..., None] + A * (1.0 - t[..., None])
        hazy[i] = np.clip(I, 0.0, 1.0)
        clear[i] = J
        t_all[i] = t
        a_all[i] = A
    return HazeVideo(hazy=hazy, clear=clear, t=t_all, A=a_all)
