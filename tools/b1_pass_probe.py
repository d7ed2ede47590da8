"""What holds each tiled pass of the fused megakernel (B1) back, on the card.

    python3 tools/b1_pass_probe.py

Run from the root of a checkout on a machine with an sm_90a card and
``nvcc``. It builds variants of ``src/repro_torch/kernels/csrc/fused_dehaze.cu``,
each a text patch of a copy under ``build/b1_probe/``, all at once, and
times every tiled pass of each variant with CUDA events at the serving
shape (4 lanes x 8 frames x 480x640, uint8 in, float32 out, DCP, top-1,
refine, r = 7, gf_r = 20):

- ``base``: the source as it is;
- ``hot_loads``: every ``cp.async`` copy into a tile reads the same bytes
  of the first 16 KB of its input instead of its own (all loads hit the
  cache: no HBM traffic in, the data still real numbers);
- ``no_window``: each register-blocked window run takes its first input
  for every output instead of summing 2r+1 (the window sums' shared-memory
  loads and adds gone);
- ``no_div``: every IEEE division a multiplication (the means, a, the
  pre-map and J);
- ``two_blocks``: the shared-memory carveout cut to 72 % of the SM's, so
  that fewer blocks fit an SM (the run prints how many).

A patch that no longer matches the source as often as it says (``None``:
at least once) fails the run. The variants compute wrong results: they
are timed, never checked. The variants run in two rounds, the second in
reverse order, and each time is the mean of both. It prints one line a variant, then the card's name and power limit,
and last a JSON object of every time (ms) and the blocks an SM.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

L, B, H, W = 4, 8, 480, 640
CFG_KW = dict(algorithm="dcp", topk=1, refine=True, radius=7, omega=0.95,
              beta=1.0, gf_radius=20, gf_eps=1e-3, t0=0.1, gamma=1.0,
              period=8, lam=0.05)

WINDOW_RUN = ("__device__ __forceinline__ void window_run(const Fetch& fetch, "
              "int w, float (&acc)[NP][R]) {\n")
FIRST_INPUT_ONLY = WINDOW_RUN + """    {
        float v0[NP];
        fetch(0, v0);
#pragma unroll
        for (int q = 0; q < NP; ++q)
#pragma unroll
            for (int j = 0; j < R; ++j) acc[q][j] = v0[q];
        return;
    }
"""

# variant -> [(text, replacement, occurrences)]. hot_loads reads real
# pixels, not zero-filled copies: the divisions' speed depends on the data.
VARIANTS = {
    "base": [],
    "hot_loads": [("in ? src + x : base",
                   "base + (((q * rows + i) * cols + j) & 4095)", 1),
                  ("bytes + b, static_cast<int>",
                   "bytes + (b & 16383), static_cast<int>", 1)],
    "no_window": [(WINDOW_RUN, FIRST_INPUT_ONLY, 1)],
    "no_div": [("__fdiv_rn(", "__fmul_rn(", None)],
    "two_blocks": [("cudaSharedmemCarveoutMaxShared", "72", 1)],
}
PASSES = ("tmap_tile", "select_ema", "guided_ab", "refine_recover", "whole")


def build_all(out_dir: Path) -> dict:
    """Patched copies of the source, compiled in parallel -> library paths."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "fused_dehaze.cu").read_text()
    nvcc = _build.find_nvcc()
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new, count in patches:
            found = text.count(old)
            if found == 0 or (count is not None and found != count):
                raise SystemExit(f"{name}: patch {old[:40]!r} matches "
                                 f"{found} times, expected {count}")
            text = text.replace(old, new)
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        for h in _build.CSRC.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / "fused_dehaze.cu").write_text(text)
        lib = d / "fused_dehaze.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(d / "fused_dehaze.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{out}")
        libs[name] = lib
    return libs


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


def time_passes(fk, img, ids, cf, ci, s) -> dict:
    t_raw, g, keys = fk.cuda_tmap_tile(img, cf, s)
    a_seq, _, _ = fk.cuda_select_ema(keys, img, ids, cf, ci, s)
    ab = fk.cuda_guided_ab(g, t_raw, s)
    return {
        "tmap_tile": time_ms(lambda: fk.cuda_tmap_tile(img, cf, s)),
        "select_ema": time_ms(
            lambda: fk.cuda_select_ema(keys, img, ids, cf, ci, s)),
        "guided_ab": time_ms(lambda: fk.cuda_guided_ab(g, t_raw, s)),
        "refine_recover": time_ms(
            lambda: fk.cuda_refine_recover(img, t_raw, g, ab, a_seq, s)),
        "whole": time_ms(lambda: fk.run_tiled_passes(img, ids, cf, ci, s)),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import fused as fk
    libs = build_all(ROOT / "build" / "b1_probe")
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 256, (L, B, H, W, 3), np.uint8)).cuda()
    ids = torch.arange(B, dtype=torch.int32).repeat(L, 1).cuda()
    cf = torch.ones(L, 3, device="cuda")
    ci = torch.tensor([[-(2 ** 30), 0]] * L, dtype=torch.int32, device="cuda")
    s = fk.make_static(img, **CFG_KW)
    bound = {name: fk.bind(ctypes.CDLL(str(path))) for name, path in libs.items()}
    times = {name: {p: 0.0 for p in PASSES} for name in bound}
    blocks = {}
    order = list(bound)
    for round_ in (order, order[::-1]):
        for name in round_:
            fk._lib_handle = bound[name]         # the wrappers launch this build
            blocks[name] = list(fk.tiled_occupancy(s))
            for p, ms in time_passes(fk, img, ids, cf, ci, s).items():
                times[name][p] += ms / 2
    fk._lib_handle = None
    for name in order:
        print(f"{name:11s} blocks an SM {blocks[name]}  " + "  ".join(
            f"{p} {times[name][p]:.4f}" for p in PASSES) + " ms", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(card[0] if card else torch.cuda.get_device_name(0))
    print(json.dumps({"ms": times, "blocks_an_sm": blocks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
