"""convnext-b [vision] -- modernized convnet.

[arXiv:2201.03545; paper]
img_res=224 depths=3-3-27-3 dims=128-256-512-1024. The port's copy of the
JAX package's ``configs/convnext_b.py``, field for field.
"""
from repro_torch.models.convnext import ConvNeXtConfig

FAMILY = "vision"
ARCH_ID = "convnext-b"


def config(**kw) -> ConvNeXtConfig:
    return ConvNeXtConfig(name=ARCH_ID, img_res=224, depths=(3, 3, 27, 3),
                          dims=(128, 256, 512, 1024), **kw)


def smoke_config(**kw) -> ConvNeXtConfig:
    return ConvNeXtConfig(name=ARCH_ID + "-smoke", img_res=32,
                          depths=(2, 2), dims=(16, 32), n_classes=16,
                          dtype="float32", **kw)
