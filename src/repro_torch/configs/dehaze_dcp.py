"""dehaze-dcp — the paper's own pipeline with the DCP T-estimator.

He et al. dark channel prior [13] projected onto the component framework
(paper §3.1), with the §3.3 atmospheric-light update strategy. The port's
copy of the JAX package's ``configs/dehaze_dcp.py``: it returns the port's
:class:`~repro_torch.core.DehazeConfig`, field for field the reference's.
"""
from repro_torch.core.config import DehazeConfig

FAMILY = "dehaze"
ARCH_ID = "dehaze-dcp"


def config(**kw) -> DehazeConfig:
    return DehazeConfig(algorithm="dcp", **kw)


def smoke_config(**kw) -> DehazeConfig:
    """A small same-family configuration for CPU tests: ``"ref"`` runs the
    port's plain versions."""
    return DehazeConfig(algorithm="dcp", gf_radius=4, kernel_mode="ref", **kw)
