"""granite-20b [dense] -- llama-arch code model, MQA (kv=1).

[arXiv:2405.04324; hf]
52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152. The port's copy of
the JAX package's ``configs/granite_20b.py``, field for field.
"""
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
ARCH_ID = "granite-20b"


def config(**kw) -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
        head_dim=128, d_ff=24576, vocab=49152, **kw)


def smoke_config(**kw) -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=1, head_dim=8, d_ff=128, vocab=128, dtype="float32",
        kv_block=32, remat=False, **kw)
