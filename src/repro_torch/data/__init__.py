"""Data for the port, numpy code that yields the JAX package's arrays bit
for bit: the synthetic hazy video of the paper's physics
(``haze_video.py``) and the model zoo's synthetic streams with their
prefetch to the device (``synthetic.py``)."""
from repro_torch.data.haze_video import (HazeVideo, HazeVideoSpec,
                                         generate_haze_video)
from repro_torch.data.synthetic import (DiffusionStream, ImageStream,
                                        TokenStream, prefetch_to_device)

__all__ = ["HazeVideo", "HazeVideoSpec", "generate_haze_video",
           "TokenStream", "ImageStream", "DiffusionStream",
           "prefetch_to_device"]
