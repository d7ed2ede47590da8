"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the dispatch layer (PyTorch port of ``repro.kernels``).

Modules:
  ref     — plain PyTorch versions of every kernel (the port's oracles)
  fused   — the fused dehaze megakernel (``csrc/fused_dehaze.cu``): CUDA
            passes, plain passes, and the wrappers
  staged  — the staged component kernels (``csrc/staged.cu``): dark
            channel, box filter, atmospheric light, recover; CUDA wrappers
            and plain versions
  ops     — dispatch wrappers (ref | pallas | fused), resolving the
            kernels' tuning knobs
  tuning  — the knobs' device-kind-keyed table, layered lookup and
            measured search (``python -m repro_torch.kernels.tuning``;
            not imported here, so that ``-m`` runs it as ``__main__``)
  _build  — nvcc build + ctypes load of ``csrc/*.cu`` at first use
"""
from repro_torch.kernels import fused, ops, ref, staged  # noqa: F401
