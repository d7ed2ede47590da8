"""dit-l2 [diffusion] -- DiT-L/2 latent diffusion transformer.

[arXiv:2212.09748; paper]
img_res=256 patch=2 n_layers=24 d_model=1024 n_heads=16. The port's copy
of the JAX package's ``configs/dit_l2.py``, field for field.
"""
from repro_torch.models.dit import DiTConfig

FAMILY = "diffusion"
ARCH_ID = "dit-l2"


def config(**kw) -> DiTConfig:
    return DiTConfig(name=ARCH_ID, img_res=256, patch=2, n_layers=24,
                     d_model=1024, n_heads=16, **kw)


def smoke_config(**kw) -> DiTConfig:
    return DiTConfig(name=ARCH_ID + "-smoke", img_res=32, patch=2,
                     n_layers=2, d_model=64, n_heads=4, n_classes=16,
                     dtype="float32", remat=False, **kw)
