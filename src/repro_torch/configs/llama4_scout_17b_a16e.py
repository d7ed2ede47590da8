"""llama4-scout-17b-a16e [moe] -- MoE 16e top-1, chunked local attention.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.
Chunked attention (8192-token chunks) with a RoPE-less global layer every
4th layer -- this is what makes the long_500k cell sub-quadratic
(DESIGN.md §4). The assigned config has no shared expert; noted there.
The port's copy of the JAX package's ``configs/llama4_scout_17b_a16e.py``,
field for field.
"""
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
ARCH_ID = "llama4-scout-17b-a16e"


def config(**kw) -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        head_dim=128, d_ff=8192, vocab=202048, moe_experts=16, moe_topk=1,
        chunk_attn=8192, global_every=4, **kw)


def smoke_config(**kw) -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=4, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=32, vocab=128, moe_experts=4,
        moe_topk=1, chunk_attn=8, global_every=4, dtype="float32",
        kv_block=32, remat=False, **kw)
