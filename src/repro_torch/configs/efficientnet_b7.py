"""efficientnet-b7 [vision] -- compound-scaled MBConv network.

[arXiv:1905.11946; paper]
img_res=600 width_mult=2.0 depth_mult=3.1. The port's copy of the JAX
package's ``configs/efficientnet_b7.py``, field for field.
"""
from repro_torch.models.efficientnet import EfficientNetConfig

FAMILY = "vision"
ARCH_ID = "efficientnet-b7"


def config(**kw) -> EfficientNetConfig:
    return EfficientNetConfig(name=ARCH_ID, img_res=600, width_mult=2.0,
                              depth_mult=3.1, **kw)


def smoke_config(**kw) -> EfficientNetConfig:
    return EfficientNetConfig(name=ARCH_ID + "-smoke", img_res=32,
                              width_mult=0.35, depth_mult=0.35, **kw)
