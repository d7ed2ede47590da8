"""unet-sdxl [diffusion] -- SDXL-class latent U-Net.

[arXiv:2307.01952; paper]
img_res=1024 latent_res=128 ch=320 ch_mult=1-2-4 n_res_blocks=2
transformer_depth=1-2-10 ctx_dim=2048. The port's copy of the JAX
package's ``configs/unet_sdxl.py``, field for field.
"""
from repro_torch.models.unet import UNetConfig

FAMILY = "diffusion"
ARCH_ID = "unet-sdxl"


def config(**kw) -> UNetConfig:
    base = dict(img_res=1024, ch=320, ch_mult=(1, 2, 4), n_res_blocks=2,
                transformer_depth=(1, 2, 10), ctx_dim=2048, ctx_len=77)
    base.update(kw)
    return UNetConfig(name=ARCH_ID, **base)


def smoke_config(**kw) -> UNetConfig:
    return UNetConfig(name=ARCH_ID + "-smoke", img_res=64, ch=16,
                      ch_mult=(1, 2), n_res_blocks=1,
                      transformer_depth=(1, 2), ctx_dim=32, ctx_len=7,
                      head_dim=8, dtype="float32", remat=False, **kw)
