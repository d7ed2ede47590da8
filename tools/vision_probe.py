"""Where a vision forward's time goes on the card (phase 20's cells).

    python3 tools/vision_probe.py

For each vision id at its published config and each serving cell
(``serve_b1``, ``serve_b128``; random params from a seed, TF32 off as in
``chip_smoke.py``): the ms a forward by CUDA events, the host's ms to
enqueue one forward (no synchronise inside), the device busy ms a forward
and the device kernels and copies a forward from a ``torch.profiler``
trace, the idle share (1 - busy / ms), and the five kernel names with the
most device time and their share of it. Needs one CUDA card; imports
nothing of JAX.
"""
from __future__ import annotations

import collections
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def top_kernels(fn, reps: int = 3, n: int = 5):
    """``[(name, ms a call, share of device time)]`` of the ``n`` kernel
    names with the most device time in a trace of ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.device_time_total
    total = sum(by_name.values()) or 1
    return [(name[:80], us / reps / 1e3, us / total)
            for name, us in by_name.most_common(n)]


def enqueue_ms(fn, reps: int = 10) -> float:
    """Host ms to enqueue one call of ``fn``, the device left running."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("vision_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.models import common as cm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    with torch.inference_mode():
        for k, arch in enumerate(cs.VISION_IDS):
            cfg = configs.get_module(arch).config()
            table, fwd = cs.vision_model(arch, cfg)
            params = cm.init_params(table, 20 + k)
            for shape in ("serve_b1", "serve_b128"):
                cell = configs.VISION_SHAPES[shape]
                n, res = cell["batch"], cell["img_res"]
                img = torch.rand(n, res, res, 3, device="cuda",
                                 generator=torch.Generator("cuda").manual_seed(k))
                call = lambda: fwd(params, img)  # noqa: E731
                ms = cs.time_ms(call, reps=10)
                host = enqueue_ms(call)
                busy, kernels, copies = cs.busy_and_kernels(call, reps=3)
                print(f"{arch} {shape} ({cfg.dtype}): {ms} ms a forward, host "
                      f"enqueue {host} ms, device busy {busy} ms, idle share "
                      f"{None if busy is None else 1 - busy / ms}, kernels "
                      f"{kernels}, copies {copies} a forward", flush=True)
                for name, kms, share in top_kernels(call):
                    print(f"    {kms:.4f} ms ({share:.3f}) {name}", flush=True)
            del params
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
