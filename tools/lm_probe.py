"""Where an LM train step's and decode step's time goes on the card
(``chip_smoke.py`` phase 21's cells).

    python3 tools/lm_probe.py

For each LM id at phase 21's cuts (published widths, layers cut; random
params from a seed, TF32 off as in ``chip_smoke.py``): the train step on
``train_4k``'s 4096 tokens at batch 1, and a decode step at batch 1 on a
cache prefilled with phase 21's prompt. For each, the ms a call by CUDA
events, the host's ms to enqueue one call (no synchronise inside), the
device busy ms, kernels and copies a call from a ``torch.profiler``
trace, the idle share (1 - busy / ms), and the five kernel names with the
most device time and their share of it. Needs one CUDA card; imports
nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vision_probe import enqueue_ms, top_kernels  # noqa: E402

DECODE_CALLS = 40        # every timed and traced decode call, within the cache


def report(label: str, call, reps: int) -> None:
    ms = cs.time_ms(call, reps=reps, warmup=1)
    host = enqueue_ms(call, reps=reps)
    busy, kernels, copies = cs.busy_and_kernels(call, reps=3)
    print(f"{label}: {ms} ms a call, host enqueue {host} ms, device busy {busy} "
          f"ms, idle share {None if busy is None else 1 - busy / ms}, kernels "
          f"{kernels}, copies {copies} a call", flush=True)
    for name, kms, share in top_kernels(call):
        print(f"    {kms:.4f} ms ({share:.3f}) {name}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as T
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw_init, cosine_schedule
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    for k, arch in enumerate(cs.LM_IDS):
        base = configs.get_module(arch).config()
        cfg = dataclasses.replace(base, n_layers=cs.LM_TRAIN_LAYERS[arch])
        params = cm.init_params(T.lm_param_table(cfg), 110 + k)
        toks = torch.randint(0, cfg.vocab, (1, cs.LM_TRAIN_TOKENS + 1),
                             device="cuda", generator=gen)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        step = make_train_step(T.make_loss_fn(cfg), cosine_schedule(cs.LM_LR, 1, 10))
        state = [params, adamw_init(params)]

        def train_call():
            state[0], state[1], _ = step(state[0], state[1], batch)

        report(f"{arch} train_4k at {cfg.n_layers} layers ({cfg.dtype}, "
               f"{cs.LM_TRAIN_TOKENS} tokens)", train_call, reps=3)
        del params, state, step
        torch.cuda.empty_cache()

        layers, prompt = cs.LM_SERVE[arch]
        cfg = dataclasses.replace(base, n_layers=layers)
        params = cm.init_params(T.lm_param_table(cfg), 120 + k)
        toks = torch.randint(0, cfg.vocab, (1, prompt), device="cuda", generator=gen)
        last, cache = T.make_prefill(cfg, max_len=prompt + DECODE_CALLS)(params, toks)
        decode = T.make_decode_step(cfg)
        tok = last.argmax(-1)[:, None]
        box = [cache]

        def decode_call():
            _, box[0] = decode(params, box[0], tok)

        report(f"{arch} decode at {layers} layers ({cfg.dtype}, cache of "
               f"{prompt} + {DECODE_CALLS})", decode_call, reps=5)
        del params, cache, box
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
