"""PyTorch/CUDA port of the component-based video dehazing system.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core``, ``kernels``, ``stream``) and is held to it by the
``tests/test_torch_*.py`` differential tests. It imports ``torch`` and
never ``jax`` or anything of ``repro``. Entry points run on CUDA unless
the caller passes ``device="cpu"``; the fused megakernel and the staged
component kernels are hand-written CUDA for Hopper (``kernels/csrc``),
built with ``nvcc`` at first use.
"""
from repro_torch import core, kernels, stream  # noqa: F401
