"""Train a ~100M-param LM for a few hundred steps on synthetic tokens,
PyTorch port (the twin of ``examples/train_lm.py``: the end-to-end
training driver).

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]

The default device is CUDA; without a card it raises (nothing falls back
to the CPU) unless ``--device cpu`` is given.
"""
import argparse
import time

from repro_torch.core import resolve_device
from repro_torch.data import TokenStream, prefetch_to_device
from repro_torch.models import common as cm
from repro_torch.models import transformer as T
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw_init, cosine_schedule

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=64)
ap.add_argument("--layers", type=int, default=12)
ap.add_argument("--d-model", type=int, default=768)
ap.add_argument("--device", default=None, help="default: CUDA")
args = ap.parse_args()
dev = resolve_device(args.device)

# Default: ~92M params (12L x 768d, llama3-family shape, GQA 2:1).
cfg = T.LMConfig(name="lm-100m", n_layers=args.layers, d_model=args.d_model,
                 n_heads=args.d_model // 64, n_kv_heads=args.d_model // 128,
                 head_dim=64, d_ff=3 * args.d_model, vocab=512,
                 dtype="float32", kv_block=128, remat=False)
table = T.lm_param_table(cfg)
params = cm.init_params(table, 0, device=dev)
print(f"params: {cm.param_count(table) / 1e6:.1f}M")

step = make_train_step(T.make_loss_fn(cfg), cosine_schedule(1e-3, 10, args.steps))
opt = adamw_init(params)

data = prefetch_to_device(iter(TokenStream(args.batch, args.seq, cfg.vocab)),
                          size=2, device=dev)
t0 = time.perf_counter()
first = None
for i in range(args.steps):
    params, opt, m = step(params, opt, next(data))
    if first is None:
        first = float(m["nll"])
    if (i + 1) % 20 == 0:
        toks = args.batch * args.seq * (i + 1)
        dt = time.perf_counter() - t0
        print(f"step {i + 1}: nll={float(m['nll']):.4f} "
              f"lr={float(m['lr']):.2e} tok/s={toks / dt:,.0f}", flush=True)
print(f"nll {first:.3f} -> {float(m['nll']):.3f} "
      f"in {time.perf_counter() - t0:.1f}s")
assert float(m["nll"]) < first * 0.7, "loss must drop on the Markov stream"
print("OK")
