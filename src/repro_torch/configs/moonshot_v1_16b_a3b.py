"""moonshot-v1-16b-a3b [moe] -- kimi/moonlight, 64e top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]
48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
The port's copy of the JAX package's ``configs/moonshot_v1_16b_a3b.py``,
field for field.
"""
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
ARCH_ID = "moonshot-v1-16b-a3b"


def config(**kw) -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=1408, vocab=163840, moe_experts=64, moe_topk=6,
        **kw)


def smoke_config(**kw) -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=32, vocab=128, moe_experts=8,
        moe_topk=2, dtype="float32", kv_block=32, remat=False, **kw)
