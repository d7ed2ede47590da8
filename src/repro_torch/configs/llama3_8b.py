"""llama3-8b [dense] -- GQA, 128k vocab.

[arXiv:2407.21783; unverified]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256. The port's copy of
the JAX package's ``configs/llama3_8b.py``, field for field.
"""
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
ARCH_ID = "llama3-8b"


def config(**kw) -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=14336, vocab=128256, **kw)


def smoke_config(**kw) -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=128, dtype="float32",
        kv_block=32, remat=False, **kw)
