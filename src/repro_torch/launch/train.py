"""Training driver: synthetic data -> train_step -> checkpoints, resumable.

The port's copy of the JAX package's ``launch/train.py``, for the LM and
vision families (the diffusion family trains through
``models.steps.make_train_step`` over its ``make_loss_fn``; this CLI
refuses it with ``SystemExit``, as the reference's does), on one CUDA card (``--device cpu`` runs it on the CPU;
without a card and without that flag it raises, it never falls back).
Params come from ``init_params`` with seed 0, batches from the synthetic
streams through ``prefetch_to_device``, the schedule is
``cosine_schedule(lr, max(steps // 10, 1), steps)``. Fault tolerance:
checkpoints every --ckpt-every steps (atomic, async), auto-resumes from
the latest. A resumed run starts the data stream over from its first
batch, as the reference's does, so it does not see the batches an
uninterrupted run sees after the same step.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --smoke --steps 50 --batch 4 --seq-len 32 --ckpt-dir /tmp/ck
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch import configs as cfgreg
from repro_torch.checkpoint import AsyncCheckpointer, CheckpointManager
from repro_torch.core.pipeline import resolve_device
from repro_torch.data import ImageStream, TokenStream, prefetch_to_device
from repro_torch.models import common as cm
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw_init, cosine_schedule


def build(arch: str, smoke: bool, batch: int, seq_len: int, img_res: int):
    """``(cfg, param table, loss_fn, data stream, has_bn)`` of ``arch``."""
    mod = cfgreg.get_module(arch)
    cfg = mod.smoke_config() if smoke else mod.config()
    fam = mod.FAMILY
    if fam == "lm":
        from repro_torch.models import transformer as T
        table = T.lm_param_table(cfg)
        loss = T.make_loss_fn(cfg, None, None)
        data = TokenStream(batch, seq_len, cfg.vocab)
        has_bn = False
    elif fam == "vision":
        res = img_res or cfg.img_res
        if arch.startswith("vit"):
            from repro_torch.models import vit as M
            table = M.vit_param_table(cfg, img_res=res)
        elif arch.startswith("resnet"):
            from repro_torch.models import resnet as M
            table = M.resnet_param_table(cfg)
        elif arch.startswith("efficientnet"):
            from repro_torch.models import efficientnet as M
            table = M.efficientnet_param_table(cfg)
        else:
            from repro_torch.models import convnext as M
            table = M.convnext_param_table(cfg)
        loss = M.make_loss_fn(cfg)
        data = ImageStream(batch, res, res, cfg.n_classes)
        has_bn = arch.startswith(("resnet", "efficientnet"))
    else:
        raise SystemExit(
            f"this CLI trains the LM and vision families, not {fam} "
            f"({arch}); the diffusion models train through "
            "repro_torch.models.steps.make_train_step over "
            "repro_torch.models.dit.make_loss_fn or "
            "repro_torch.models.unet.make_loss_fn, whose batches carry "
            '"noise" (and the U-Net\'s "context" and "pooled")')
    return cfg, table, loss, data, has_bn


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--img-res", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="the device to train on (default: CUDA; 'cpu' "
                         "for the tests)")
    return ap


def run(argv: Optional[Sequence[str]] = None,
        on_resume: Optional[Callable[[Dict[str, Any], int], None]] = None
        ) -> Dict[str, Any]:
    """Train on ``argv`` (the CLI's flags) and return ``{"start", "losses",
    "params", "opt"}``: the step resumed from (0 for a fresh run), each
    step's loss as a float, and the final state. ``on_resume(restored,
    step)`` sees the restored ``{"params", "opt"}`` before the first step
    consumes it."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg, table, loss, data, has_bn = build(
        args.arch, args.smoke, args.batch, args.seq_len, args.img_res)
    params = cm.init_params(table, 0, device=dev)
    opt = adamw_init(params)
    n_params = cm.param_count(table)
    print(f"arch={args.arch} params={n_params/1e6:.2f}M smoke={args.smoke}")

    step_fn = make_train_step(
        loss, cosine_schedule(args.lr, max(args.steps // 10, 1), args.steps),
        has_bn=has_bn)

    start = 0
    ck = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        ck = AsyncCheckpointer(mgr)
        if mgr.latest_step() is not None:
            restored, _, start = mgr.restore({"params": params, "opt": opt})
            if on_resume is not None:
                on_resume(restored, start)
            params, opt = restored["params"], restored["opt"]
            print(f"resumed from step {start}")

    it = prefetch_to_device(iter(data), size=2, device=dev)
    losses = []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = next(it)
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(metrics["loss"])
        if (step + 1) % args.log_every == 0 or step == start:
            m = {k: float(v) for k, v in metrics.items()
                 if isinstance(v, torch.Tensor) and v.ndim == 0}
            print(f"step {step + 1}: " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(m.items())), flush=True)
        if ck is not None and (step + 1) % args.ckpt_every == 0:
            ck.save(step + 1, {"params": params, "opt": opt},
                    {"arch": args.arch})
    if ck is not None:
        ck.wait()
    losses = [float(l) for l in losses]
    dt = time.perf_counter() - t0
    done = args.steps - start
    print(f"trained {done} steps in {dt:.1f}s "
          f"({done / max(dt, 1e-9):.2f} steps/s)")
    return {"start": start, "losses": losses, "params": params, "opt": opt}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
