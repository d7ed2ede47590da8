"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source (with the shared headers it includes) is compiled by ``nvcc``
into a shared library with a plain C interface and loaded with ``ctypes``:
no PyTorch headers, so a build takes seconds. Libraries go to
``build/repro_torch_kernels/`` at the root of the checkout (an installed
copy, which has no checkout around it, uses
``$XDG_CACHE_HOME/repro_torch_kernels``, by default under ``~/.cache``),
named by a hash of the source, the headers, the flags and a variant's
``-D`` defines, so an edited ``.cu`` or ``.cuh`` rebuilds, each variant is
a library of its own, and an unchanged one loads the library already
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
from typing import Dict, Optional, Sequence, Tuple

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
_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


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


def _define_flags(defines: Sequence[str]) -> Tuple[str, ...]:
    """``-D`` flags of a variant, in a fixed order (``NAME=VALUE`` each)."""
    for d in defines:
        if not d or any(c.isspace() for c in d) or d.startswith("-"):
            raise ValueError(f"malformed define {d!r}: expected NAME or NAME=VALUE")
    return tuple(f"-D{d}" for d in sorted(defines))


def build(source: str, defines: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<source>`` with ``-D`` ``defines`` unless its library
    exists; return its path.

    Each set of defines is a library of its own (a variant: the tiled
    passes' tile, say): the library's name carries a hash of the source
    text, the shared headers (``csrc/*.cuh``), :data:`NVCC_FLAGS` and the
    defines, so variants never collide and ``defines=()`` names the
    library a build without them always had. The library is written under
    a temporary name and renamed into place, so a concurrent build never
    loads a half-written file. A failed build raises ``RuntimeError``
    carrying nvcc's output."""
    flags = _define_flags(defines)
    text = (CSRC / source).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    salt = repr(NVCC_FLAGS) + (repr(flags) if flags else "")
    key = hashlib.sha256(text + salt.encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{Path(source).stem}-{key}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{source} {' '.join(flags)}:\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    return out


def load(source: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>`` with ``defines``, once
    per process and set of defines."""
    key = (source, _define_flags(defines))
    with _lock:
        lib: Optional[ctypes.CDLL] = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(source, defines)))
            _loaded[key] = lib
        return lib


__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build", "load"]
