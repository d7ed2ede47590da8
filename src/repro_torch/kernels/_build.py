"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source (with the shared headers it includes) is compiled by ``nvcc``
into a shared library with a plain C interface and loaded with ``ctypes``:
no PyTorch headers, so a build takes seconds. Libraries go to
``build/repro_torch_kernels/`` at the root of the checkout (an installed
copy, which has no checkout around it, uses
``$XDG_CACHE_HOME/repro_torch_kernels``, by default under ``~/.cache``),
named by a hash of the source, the headers and the flags, so an edited
``.cu`` or ``.cuh`` rebuilds and an unchanged one loads the library already
there.
A missing ``nvcc`` or a failed build raises; nothing falls back.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir() -> Path:
    root = Path(__file__).resolve().parents[3]       # <checkout>/src/repro_torch/kernels
    if (root / "pyproject.toml").is_file() and (root / "src").is_dir():
        return root / "build" / "repro_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(cache) / "repro_torch_kernels"


BUILD_DIR = _build_dir()

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false")

DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    :data:`DEFAULT_NVCC`. Raises ``RuntimeError`` when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the CUDA "
        "kernels of repro_torch cannot be built")


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library exists; return its path.

    The library is written under a temporary name and renamed into place,
    so a concurrent build never loads a half-written file. A failed build
    raises ``RuntimeError`` carrying nvcc's output. The library's name
    carries a hash of the source text, the shared headers (``csrc/*.cuh``)
    and :data:`NVCC_FLAGS`."""
    text = (CSRC / source).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(text + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{Path(source).stem}-{key}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{source}:\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``, once per process."""
    with _lock:
        lib: Optional[ctypes.CDLL] = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib


__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build", "load"]
