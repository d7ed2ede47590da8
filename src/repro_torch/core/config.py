"""Configuration for the dehazing pipeline (paper §3), PyTorch port.

Field for field the same as the JAX package's ``DehazeConfig`` — names,
defaults and ``validate()`` — so one configuration describes a stream on
either side and a stream's state can move between them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DehazeConfig:
    """Static configuration for one dehazing stream (frozen, hashable: it
    keys the serving tier's step cache)."""
    # Which T-estimator instantiation (paper gives DCP and CAP).
    algorithm: str = "dcp"                 # "dcp" | "cap"

    # Shared component parameters.
    patch_radius: int = 7                  # Ω(x) window radius (15x15 patch)
    t0: float = 0.1                        # Eq. 8 transmission lower bound
    topk: int = 1                          # A-estimator candidates; 1 == Eq. 6
    refine: bool = True                    # guided-filter refinement of t
    gf_radius: int = 20
    gf_eps: float = 1e-3
    gamma: float = 1.0                     # serving epilogue tone curve

    # DCP (He et al. [13]).
    omega: float = 0.95                    # haze retention factor

    # CAP (Zhu et al. [23]) — published linear model coefficients.
    beta: float = 1.0
    cap_w0: float = 0.121779
    cap_w1: float = 0.959710
    cap_w2: float = -0.780245

    # Cross-frame atmospheric light update strategy (paper §3.3).
    update_period: int = 8                 # l: frames between A refreshes
    lam: float = 0.05                      # λ in A_m = λ A_new + (1-λ) A_k

    # Dataflow options.
    recompute_t_with_final_a: bool = False # extra accuracy pass (beyond paper)
    kernel_mode: str = "auto"              # ref | pallas | interpret | fused | auto
    #   In the port: "ref" is the plain PyTorch chain on any device, "fused"
    #   the hand-written CUDA megakernel, "pallas" (and "auto") the staged
    #   chain of hand-written CUDA kernels; on CPU tensors each kernel's
    #   plain version runs. "interpret" has no counterpart (kernels.ops).
    dtype: str = "float32"

    # The spatially sharded step's halo wire (core/pipeline.py): exchange
    # the (pre-map, luma) planes stacked as one two-channel plane instead of
    # the RGB block, and the dtype the exchanged planes travel in.
    halo_packed: bool = False
    halo_dtype: str = "float32"

    # Frame I/O dtype contract: the wire dtype of the frame stream (uint8 is
    # round(v*255) of the [0,1] image, upcast inside the kernel) and the J/t
    # output dtype ("auto": follow float ingest, float32 for uint8).
    io_dtype: str = "float32"   # float32 | bfloat16 | uint8
    out_dtype: str = "auto"     # auto | float32 | bfloat16

    def validate(self) -> "DehazeConfig":
        assert self.algorithm in ("dcp", "cap"), self.algorithm
        assert self.kernel_mode in ("auto", "ref", "pallas", "interpret",
                                    "fused"), self.kernel_mode
        assert 0.0 <= self.lam <= 1.0
        assert self.update_period >= 1
        assert self.patch_radius >= 0 and self.gf_radius >= 0
        assert 0.0 < self.t0 < 1.0
        assert self.io_dtype in ("float32", "bfloat16", "uint8"), self.io_dtype
        assert self.out_dtype in ("auto", "float32", "bfloat16"), self.out_dtype
        return self
