"""Data for the port: the synthetic hazy video of the paper's physics
(numpy, the port's own copy of the JAX package's ``data/haze_video.py``).
The JAX package's ``data/synthetic.py`` streams are not ported yet
(ROADMAP.md queue A)."""
from repro_torch.data.haze_video import (HazeVideo, HazeVideoSpec,
                                         generate_haze_video)

__all__ = ["HazeVideo", "HazeVideoSpec", "generate_haze_video"]
