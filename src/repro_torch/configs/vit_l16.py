"""vit-l16 [vision] -- ViT-L/16 classifier.

[arXiv:2010.11929; paper]
img_res=224 patch=16 n_layers=24 d_model=1024 n_heads=16 d_ff=4096. The
port's copy of the JAX package's ``configs/vit_l16.py``, field for field.
"""
from repro_torch.models.vit import ViTConfig

FAMILY = "vision"
ARCH_ID = "vit-l16"


def config(**kw) -> ViTConfig:
    return ViTConfig(name=ARCH_ID, img_res=224, patch=16, n_layers=24,
                     d_model=1024, n_heads=16, d_ff=4096, **kw)


def smoke_config(**kw) -> ViTConfig:
    return ViTConfig(name=ARCH_ID + "-smoke", img_res=32, patch=8,
                     n_layers=2, d_model=64, n_heads=4, d_ff=128,
                     n_classes=16, dtype="float32", remat=False, **kw)
