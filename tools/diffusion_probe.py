"""Which batches of the diffusion family's training cells fit on the card,
and where a sample step's and a train step's time goes (phase 22's cells).

    python3 tools/diffusion_probe.py [--fit] [--top]

``--fit``: for each training cell of ``chip_smoke.py`` phase 22 (DiT-L/2
``train_256``, the U-Net's ``train_256`` and ``train_1024``, each at its
published config: bfloat16, remat, random params from a seed, TF32 off),
two train steps at each batch from the published one down by halves,
until one fits: the peak of ``max_memory_allocated`` and step 2's ms by
CUDA events for each that fits, "out of memory" for each that does not.
``--top``: for each sample cell (``gen_fast``, ``gen_1024``) and each
training cell at phase 22's batches, the host's ms to enqueue one call,
the ms a call by CUDA events, the device busy ms, kernels and copies a
call, the idle share and the five kernel names with the most device time.
Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vision_probe import enqueue_ms, top_kernels  # noqa: E402


def train_setup(arch: str, shape: str, n: int, seed: int = 7):
    """(step callable, its state) of one training cell at batch ``n``."""
    from repro_torch import configs
    from repro_torch.models import common as cm
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw_init, cosine_schedule
    dev = torch.device("cuda")
    res = configs.DIFFUSION_SHAPES[shape]["img_res"]
    cfg = cs.diff_cfg(arch, res, False)
    m = cs.diff_module(arch)
    params = cm.init_params(cs.diff_table(arch, cfg), seed, device=dev)
    batch = cs.diff_batch(arch, cfg, n, res, dev, seed)
    loss = m.make_loss_fn(cfg, img_res=res) if arch == "dit-l2" else m.make_loss_fn(cfg)
    step = make_train_step(loss, cosine_schedule(cs.DIFF_LR, 1, cs.TRAIN_STEPS))
    state = {"params": params, "opt": adamw_init(params), "batch": batch}

    def call():
        state["params"], state["opt"], _ = step(state["params"], state["opt"],
                                                state["batch"])
    return call, state


def fits(arch: str, shape: str) -> dict:
    """Batch -> (peak bytes, step 2's ms) or None (out of memory), from the
    published batch down by halves to the first that fits."""
    out = {}
    n = cs.DIFF_PUBLISHED_BATCH[shape]
    while n >= 1:
        cs.peak_reset(torch.device("cuda"))
        call = state = None
        try:
            call, state = train_setup(arch, shape, n)
            call()
            _, ms = cs.Clock(torch.device("cuda"))(call)
            torch.cuda.synchronize()
            out[n] = (torch.cuda.max_memory_allocated(), ms)
        except torch.cuda.OutOfMemoryError:
            out[n] = None
        state = call = None
        gc.collect()
        torch.cuda.empty_cache()
        print(f"fit {arch} {shape} batch {n}: "
              + ("out of memory" if out[n] is None else
                 f"peak {out[n][0]} bytes, step 2 {out[n][1]} ms"), flush=True)
        if out[n] is not None:
            break
        n //= 2
    return out


def sample_setup(arch: str, shape: str, seed: int = 7):
    from repro_torch import configs
    from repro_torch.models import common as cm
    dev = torch.device("cuda")
    sh = configs.DIFFUSION_SHAPES[shape]
    res, n = sh["img_res"], sh["batch"]
    cfg = cs.diff_cfg(arch, res, False)
    m = cs.diff_module(arch)
    params = cm.init_params(cs.diff_table(arch, cfg), seed, device=dev)
    batch = cs.diff_batch(arch, cfg, n, res, dev, seed)
    step = m.make_sample_step(cfg, img_res=res) if arch == "dit-l2" \
        else m.make_sample_step(cfg)
    t = torch.full((n,), 999, dtype=torch.int32, device=dev)
    t_next = torch.full((n,), 979, dtype=torch.int32, device=dev)
    cond = cs.diff_cond(arch, batch)
    return lambda: step(params, batch["latents"], t, t_next, *cond)


def report(label: str, call) -> None:
    host = enqueue_ms(call, reps=2)
    _, ms = cs.Clock(torch.device("cuda"))(call)
    busy, kernels, copies = cs.busy_and_kernels(call, reps=2)
    print(f"{label}: {ms} ms a call, host enqueue {host} ms, device busy {busy} ms, "
          f"idle share {None if busy is None else 1 - busy / ms}, kernels {kernels}, "
          f"copies {copies} a call", flush=True)
    for name, kms, share in top_kernels(call, reps=2):
        print(f"    {kms:.4f} ms ({share:.3f}) {name}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--top", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("diffusion_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    if args.fit:
        for arch, shape in cs.DIFF_TRAIN:
            fits(arch, shape)
    if args.top:
        for arch in cs.DIFF_IDS:
            for shape in cs.DIFF_GEN:
                report(f"sample {arch} {shape}", sample_setup(arch, shape))
                gc.collect()
                torch.cuda.empty_cache()
        for (arch, shape), n in cs.DIFF_TRAIN.items():
            call, _ = train_setup(arch, shape, n)
            report(f"train {arch} {shape} b{n}", call)
            call = None
            gc.collect()
            torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
