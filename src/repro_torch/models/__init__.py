"""Architecture zoo of the port (param-pytree models on torch tensors):
the common layer, the vision models, the LM (``transformer``), the
diffusion models (``dit``, ``unet``) and the train step (``steps``)."""
from repro_torch.models import (common, convnext, dit, efficientnet, resnet,
                                steps, transformer, unet, vit)

__all__ = ["common", "vit", "resnet", "efficientnet", "convnext",
           "transformer", "dit", "unet", "steps"]
