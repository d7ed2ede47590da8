"""resnet-50 [vision] -- bottleneck residual network.

[arXiv:1512.03385; paper]
img_res=224 depths=3-4-6-3 width=64 bottleneck expansion 4. The port's
copy of the JAX package's ``configs/resnet_50.py``, field for field.
"""
from repro_torch.models.resnet import ResNetConfig

FAMILY = "vision"
ARCH_ID = "resnet-50"


def config(**kw) -> ResNetConfig:
    return ResNetConfig(name=ARCH_ID, img_res=224, depths=(3, 4, 6, 3),
                        width=64, **kw)


def smoke_config(**kw) -> ResNetConfig:
    return ResNetConfig(name=ARCH_ID + "-smoke", img_res=32, depths=(2, 2),
                        width=8, n_classes=16, **kw)
