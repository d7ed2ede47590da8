"""Architecture zoo of the port (param-pytree models on torch tensors):
the common layer, the vision models, the LM (``transformer``) and the
train step (``steps``). The diffusion models (``dit``, ``unet``) are not
ported yet."""
from repro_torch.models import (common, convnext, efficientnet, resnet, steps,
                                transformer, vit)

__all__ = ["common", "vit", "resnet", "efficientnet", "convnext",
           "transformer", "steps"]
