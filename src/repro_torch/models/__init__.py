"""Architecture zoo of the port (param-pytree models on torch tensors):
the common layer and the vision models. The LM and diffusion models and
the train step (``transformer``, ``dit``, ``unet``, ``steps``) are not
ported yet."""
from repro_torch.models import common, convnext, efficientnet, resnet, vit

__all__ = ["common", "vit", "resnet", "efficientnet", "convnext"]
