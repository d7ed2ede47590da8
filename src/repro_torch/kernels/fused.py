"""The fused dehaze megakernel on Hopper: wrappers, passes and plain passes.

``fused_dehaze_lanes`` is the port of the JAX package's
``kernels/fused.py::fused_dehaze_lanes_pallas`` and ``fused_dehaze`` its
L=1 view (``fused_dehaze_pallas``). On a CUDA tensor the wrapper runs the
hand-written kernels of ``csrc/fused_dehaze.cu`` (see the design note at
the top of that file) and raises if a build or a launch fails; on a CPU
tensor it runs the plain version, ``kernels.ref.fused_dehaze_lanes``.
Nothing falls back from one to the other.

The megakernel is a short sequence of tiled passes over all L*B frames,
:data:`TILED_PASSES`, run by :func:`run_tiled_passes`: ``tmap_tile``
(pre-map, windowed min, t_raw and, at top-1, each tile's smallest key),
``topk_block`` at k > 1, ``select_ema`` (the candidates and the EMA),
``guided_ab`` (the guided filter's a and b; refine only) and
``refine_recover`` (the refined t and J). Each block holds a tile of one
frame and its window halo in shared memory. The ten passes it replaced,
:data:`PASSES` run by :func:`run_passes`, stay: the megakernel runs them
for windows whose halo does not fit a block (:func:`tiled_fits`, decided
from the static shape before anything launches), and on the card they are
the tiled sequence's comparator (bit-equal outputs). Each pass has a CUDA
wrapper in :data:`CUDA_PASSES` and a plain PyTorch counterpart with the
same signature in :data:`PLAIN_PASSES`; a sequence runs through either, so
the CPU tests check the wiring the card runs, and ``chip_smoke.py`` holds
every pass against its plain counterpart on the card. :data:`launches`
counts kernel launches per pass, each where its kernel launches; every run
of the tiled sequence launches ``tmap_tile`` exactly once (of the ten
passes, ``premap``), so its count is also the count of whole tiled runs.

The fused transmission stage of the data-parallel sharded step,
``fused_transmission_lanes`` (the port of ``fused_transmission_lanes_pallas``)
and its L=1 view ``fused_transmission`` (``fused_transmission_pallas``),
is the megakernel's tiled passes without the EMA and J:
:data:`TILED_TRANSMISSION_PASSES`, run by
:func:`run_tiled_transmission_passes` (``tmap_tile`` with the lanes' saved
A, ``topk_block`` at k > 1, ``candidate``, the megakernel's merge kernel
writing t_min and the candidate in the output dtype, ``guided_ab``, and
``refine_tmap``, the last tiled pass with neither wire rows nor J). Where
a window's halo does not fit a block (:func:`transmission_tiled_fits`,
from the static shape) it runs the ten passes' form,
:data:`TRANSMISSION_PASSES` run by :func:`run_transmission_passes`, which
on the card is also the tiled sequence's comparator. Both sequences count
their launches in :data:`transmission_launches`, apart from the
megakernel's; ``tmap_tile`` and ``premap`` each launch once a run, so they
count the runs of each.

The spatially sharded step's stage, :func:`fused_transmission_halo` (the
port of ``fused_transmission_halo_pallas``), takes one shard's core frames
and its halo-extended (pre-map, luma) planes with their validity vectors,
and writes the core's t and the k ascending (t, rgb, local index) rows. It
runs the masked form of the same tiles, :data:`TILED_HALO_PASSES` by
:func:`run_tiled_halo_passes`: each tiled kernel with a mask policy, the
inputs +inf (min) or +0 (sums) where a pixel is invalid, the divisors from
prefix counts of a tile's valid rows and columns, and each pass only on the
part of the extended plane that the core needs (:meth:`HaloStatic.region`).
Windows too wide for a block (:func:`halo_tiled_fits`) run the ten masked
passes, :data:`HALO_PASSES` by :func:`run_halo_passes`, also the tiled
sequence's comparator. Both count their launches in :data:`halo_launches`.

The tiled passes take the tuning knobs of ``kernels.tuning`` through their
static (:class:`Static`, :class:`HaloStatic`): the tile and ``guided_ab``'s
minimum blocks an SM pick a library variant (:func:`lib_for`), the grid
order is an argument. Every tile-shaped mirror here (the tile keys, the
shared-memory sums that decide the route) follows the static's tile.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.staged import (KEY_LAST, MAX_SMEM, TOPK_MAX_TILES,
                                        TOPK_TILE, flip_key_order, key_index,
                                        key_t, launch_lock, topk_keys_signed,
                                        topk_mean,
                                        validity_bytes, window_counts,
                                        window_sum)

SOURCE = "fused_dehaze.cu"

#: Pixels per top-k tile: ``kTopkTile`` in ``csrc/dehaze_common.cuh``
#: (checked at load).
TILE_PIXELS = TOPK_TILE

#: The tiled passes' tuning knobs (``kernels.tuning``), default first: the
#: tile, rows x columns (each a library variant, built with ``-D
#: FD_TILE_H/FD_TILE_W``; both keep 256 threads a block), ``guided_ab``'s
#: minimum blocks an SM in its ``__launch_bounds__`` (``-D
#: FD_GUIDED_MIN_BLOCKS``), and the order of the grid's planes (a run-time
#: argument: lane x B + frame, or frame x L + lane). No knob changes an
#: output bit.
TILES = {"32x64": (32, 64), "64x32": (64, 32)}
DEFAULT_TILE = "32x64"
BLOCKS_PER_SM = (3, 2)
GRID_ORDERS = ("lane_major", "frame_major")

#: Output tile of a tiled pass's block by default, rows x columns
#: (``kTileH`` x ``kTileW`` in ``csrc/fused_dehaze.cu``, checked at load).
#: A tiled pass whose halo needs more shared memory than a block has
#: refuses to launch and its wrapper raises: at this tile with refine from
#: gf_radius 46, and from radius 37 with float32 frames (53 bfloat16, 67
#: uint8). :func:`tiled_fits` says so beforehand, and
#: :func:`fused_dehaze_lanes` then runs the ten passes, which take any
#: radius.
TILE_H, TILE_W = TILES[DEFAULT_TILE]


def tile_count(h: int, w: int, tile: str = DEFAULT_TILE) -> int:
    """``tile``'s tiles over h x w pixels."""
    th, tw = TILES[tile]
    return -(-h // th) * -(-w // tw)


def check_knobs(tile: str, blocks_per_sm: int) -> None:
    """Raise ``ValueError`` naming a tile or a minimum of blocks an SM that
    the tiled passes do not take."""
    if tile not in TILES:
        raise ValueError(f"tile={tile!r}: the tiled passes take {sorted(TILES)}")
    if blocks_per_sm not in BLOCKS_PER_SM:
        raise ValueError(f"blocks_per_sm={blocks_per_sm!r}: the tiled passes "
                         f"take {list(BLOCKS_PER_SM)}")


def variant_defines(tile: str, blocks_per_sm: int) -> Tuple[str, ...]:
    """The ``-D`` defines of the library variant for these knobs: none for
    the defaults, so the default is the library built without them."""
    check_knobs(tile, blocks_per_sm)
    th, tw = TILES[tile]
    defines = () if tile == DEFAULT_TILE else (f"FD_TILE_H={th}", f"FD_TILE_W={tw}")
    if blocks_per_sm != BLOCKS_PER_SM[0]:
        defines += (f"FD_GUIDED_MIN_BLOCKS={blocks_per_sm}",)
    return defines


#: The megakernel's tiled passes and the ten passes they replaced (the
#: megakernel's route for windows too wide for a block, and the tiled
#: sequence's comparator).
PASSES = ("premap", "min_rows", "min_cols_tmap", "topk_block", "topk_merge",
          "ema", "box_rows4", "box_cols_ab", "box_rows2", "recover")
TILED_PASSES = ("tmap_tile", "select_ema", "guided_ab", "refine_recover")

#: The fused transmission stage: its tiled passes (``topk_block`` at k > 1
#: only, ``guided_ab`` with refine only), and the ten passes' form, its
#: route for windows too wide for a block and the tiled passes' comparator.
#: ``topk_block`` and ``candidate`` are the same kernels in both.
TILED_TRANSMISSION_PASSES = ("tmap_tile", "topk_block", "candidate",
                             "guided_ab", "refine_tmap")
TRANSMISSION_PASSES = ("premap", "min_rows", "min_cols_tmap", "topk_block",
                       "candidate", "box_rows4", "box_cols_ab", "box_rows2",
                       "tmap")

#: The halo form's masked tiled passes and its ten masked passes (the same
#: roles); ``topk_block`` and ``topk_list`` are the same kernels in both.
TILED_HALO_PASSES = ("tmap_tile", "topk_block", "topk_list", "guided_ab",
                     "refine_tmap")
HALO_PASSES = ("min_rows", "min_cols_tmap", "topk_block", "topk_list",
               "box_rows4", "box_cols_ab", "box_rows2", "tmap")

#: Kernel launches since the last :func:`reset_launches`, by pass name: of
#: the megakernel, of the fused transmission stage and of its halo form.
launches: Dict[str, int] = {name: 0 for name in PASSES + TILED_PASSES}
transmission_launches: Dict[str, int] = dict.fromkeys(
    TILED_TRANSMISSION_PASSES + TRANSMISSION_PASSES, 0)
halo_launches: Dict[str, int] = dict.fromkeys(
    TILED_HALO_PASSES + HALO_PASSES, 0)
#: Launches of every pass above by library variant, ``"<tile>/<blocks an
#: SM>"`` (the default ``"32x64/3"`` too); kept apart from the per-pass
#: counts, which are the same whatever the variant.
variant_launches: Dict[str, int] = {}

_IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    with launch_lock:
        for counts in (launches, transmission_launches, halo_launches):
            for k in counts:
                counts[k] = 0
        variant_launches.clear()


class _Params(ctypes.Structure):
    """Mirror of ``DehazeParams`` in ``csrc/fused_dehaze.cu``."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "L", "B", "H", "W", "in_dtype", "out_dtype", "algorithm", "radius",
        "refine", "gf_radius", "period", "topk", "lane_major")]
        + [(n, ctypes.c_float) for n in (
            "omega", "neg_beta", "w0", "w1", "w2", "luma0", "luma1", "luma2",
            "a_floor", "gf_eps", "t0", "gamma", "lam", "one_minus_lam",
            "u8_scale")])


@dataclasses.dataclass(frozen=True)
class Static:
    """Every static argument of one megakernel call (shapes, dtypes, the
    algorithm's constants and the tiled passes' knobs: the library variant
    ``tile``/``blocks_per_sm`` and the grid's plane order)."""
    L: int
    B: int
    H: int
    W: int
    in_dtype: torch.dtype
    out_dtype: torch.dtype
    algorithm: str
    radius: int
    omega: float
    beta: float
    cap_w: Tuple[float, float, float]
    refine: bool
    gf_radius: int
    gf_eps: float
    t0: float
    gamma: float
    period: int
    lam: float
    topk: int
    tile: str = DEFAULT_TILE
    blocks_per_sm: int = BLOCKS_PER_SM[0]
    lane_major: bool = True

    @property
    def n_frames(self) -> int:
        return self.L * self.B

    @property
    def variant(self) -> str:
        return f"{self.tile}/{self.blocks_per_sm}"

    @functools.lru_cache(maxsize=64)
    def params(self) -> _Params:
        """The kernels' argument struct (made once a static; the entry
        points copy it)."""
        # Python floats are rounded to float32 here, exactly as PyTorch
        # rounds a Python scalar operand of a float32 tensor operation.
        return _Params(
            L=self.L, B=self.B, H=self.H, W=self.W,
            in_dtype=_IN_CODES[self.in_dtype],
            out_dtype=_OUT_CODES[self.out_dtype],
            algorithm=0 if self.algorithm == "dcp" else 1, radius=self.radius,
            refine=int(self.refine), gf_radius=self.gf_radius,
            period=self.period, topk=self.topk,
            lane_major=int(self.lane_major), omega=self.omega,
            neg_beta=-self.beta, w0=self.cap_w[0], w1=self.cap_w[1],
            w2=self.cap_w[2], luma0=ref.LUMA_WEIGHTS[0],
            luma1=ref.LUMA_WEIGHTS[1], luma2=ref.LUMA_WEIGHTS[2],
            a_floor=1e-3, gf_eps=self.gf_eps, t0=self.t0, gamma=self.gamma,
            lam=self.lam, one_minus_lam=1.0 - self.lam,
            u8_scale=1.0 / ref.U8_SCALE)


def make_static(img: torch.Tensor, *, algorithm: str = "dcp", radius: int,
                omega: float = 0.95, beta: float = 1.0,
                cap_w: Sequence[float] = ref.CAP_COEFFS, refine: bool,
                gf_radius: int, gf_eps: float, t0: float, gamma: float,
                period: int, lam: float, topk: int = 1,
                out_dtype: Optional[str] = None, tile: str = DEFAULT_TILE,
                blocks_per_sm: int = BLOCKS_PER_SM[0],
                lane_major: bool = True) -> Static:
    """Validate a (L, B, H, W, 3) wire-dtype batch and the static
    arguments; raise ``ValueError`` on anything the kernel does not take."""
    check_knobs(tile, blocks_per_sm)
    if img.dim() != 5 or img.shape[-1] != 3:
        raise ValueError(f"expected (L, B, H, W, 3) frames, got {tuple(img.shape)}")
    if img.dtype not in _IN_CODES:
        raise ValueError(f"unsupported frame dtype {img.dtype}")
    if algorithm not in ("dcp", "cap"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    L, B, H, W, _ = img.shape
    if not 1 <= topk <= H * W:
        raise ValueError(f"topk={topk} outside [1, H*W={H * W}]")
    if -(-(H * W) // TILE_PIXELS) > TOPK_MAX_TILES:
        raise ValueError(f"H*W={H * W} needs more than {TOPK_MAX_TILES} "
                         f"top-k tiles of {TILE_PIXELS} pixels")
    if radius < 0 or gf_radius < 0:
        raise ValueError("window radii must be >= 0")
    return Static(L=L, B=B, H=H, W=W, in_dtype=img.dtype,
                  out_dtype=ref.resolve_out_dtype(img.dtype, out_dtype),
                  algorithm=algorithm, radius=radius, omega=omega, beta=beta,
                  cap_w=tuple(float(c) for c in cap_w), refine=bool(refine),
                  gf_radius=gf_radius, gf_eps=gf_eps, t0=t0, gamma=gamma,
                  period=period, lam=lam, topk=topk, tile=tile,
                  blocks_per_sm=blocks_per_sm, lane_major=bool(lane_major))


# ---------------------------------------------------------------------------
# The CUDA passes
# ---------------------------------------------------------------------------

#: The default variant's library (bound at first use) and the others',
#: by ``(tile, blocks_per_sm)``.
_lib_handle: Optional[ctypes.CDLL] = None
_variant_handles: Dict[Tuple[str, int], ctypes.CDLL] = {}


def _lib() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/fused_dehaze.cu``, the default
    variant."""
    global _lib_handle
    if _lib_handle is None:
        from repro_torch.kernels import _build
        _lib_handle = bind(_build.load(SOURCE))
    return _lib_handle


def lib_for(s=None) -> ctypes.CDLL:
    """The library variant that the static ``s`` (a :class:`Static` or
    :class:`HaloStatic`; None: the default) names, built and bound at first
    use. A variant that fails to build raises."""
    tile = DEFAULT_TILE if s is None else s.tile
    bps = BLOCKS_PER_SM[0] if s is None else s.blocks_per_sm
    if (tile, bps) == (DEFAULT_TILE, BLOCKS_PER_SM[0]):
        return _lib()
    lib = _variant_handles.get((tile, bps))
    if lib is None:
        from repro_torch.kernels import _build
        lib = bind(_build.load(SOURCE, variant_defines(tile, bps)), tile, bps)
        _variant_handles[tile, bps] = lib
    return lib


def bind(lib: ctypes.CDLL, tile: str = DEFAULT_TILE,
         blocks_per_sm: int = BLOCKS_PER_SM[0]) -> ctypes.CDLL:
    """Declare the entry points of a build of ``csrc/fused_dehaze.cu`` and
    check its tile constants against the variant asked for (``tile``,
    ``blocks_per_sm``); returns ``lib``."""
    vp, pp, ci = ctypes.c_void_p, ctypes.POINTER(_Params), ctypes.c_int
    hp, ip = ctypes.POINTER(_HaloParams), ctypes.POINTER(ci)
    sigs = {
        "fd_premap": [vp, vp, vp, vp, pp, vp],
        "fd_min_rows": [vp, vp, pp, vp],
        "fd_min_cols_tmap": [vp, vp, pp, vp],
        "fd_topk_block": [vp, vp, pp, vp],
        "fd_topk_merge": [vp, ci, ci, vp, vp, ci, vp, pp, vp],
        "fd_ema": [vp, vp, vp, vp, vp, vp, vp, pp, vp],
        "fd_box_rows4": [vp, vp, vp, pp, vp],
        "fd_box_cols_ab": [vp, vp, pp, vp],
        "fd_box_rows2": [vp, vp, pp, vp],
        "fd_recover": [vp, vp, vp, vp, vp, vp, vp, pp, vp],
        "fd_tmap": [vp, vp, vp, vp, pp, vp],
        "fd_tmap_tile": [vp, vp, vp, vp, vp, pp, vp],
        "fd_select_ema": [vp, vp, vp, vp, vp, vp, vp, vp, pp, vp],
        "fd_guided_ab": [vp, vp, vp, pp, vp],
        "fd_refine_recover": [vp, vp, vp, vp, vp, vp, vp, pp, vp],
        "fd_refine_tmap": [vp, vp, vp, vp, pp, vp],
        "fd_halo_min_rows": [vp, vp, vp, vp, hp, vp],
        "fd_halo_min_cols_tmap": [vp, vp, vp, hp, vp],
        "fd_halo_topk_block": [vp, vp, hp, vp],
        "fd_halo_topk_list": [vp, ci, ci, vp, vp, vp, vp, hp, vp],
        "fd_halo_box_rows4": [vp, vp, vp, vp, vp, hp, vp],
        "fd_halo_box_cols_ab": [vp, vp, vp, vp, hp, vp],
        "fd_halo_box_rows2": [vp, vp, vp, vp, hp, vp],
        "fd_halo_tmap": [vp, vp, vp, vp, vp, vp, hp, vp],
        "fd_halo_tmap_tile": [vp, vp, vp, vp, vp, vp, hp, vp],
        "fd_halo_guided_ab": [vp, vp, vp, vp, vp, hp, vp],
        "fd_halo_refine_tmap": [vp, vp, vp, vp, vp, vp, hp, vp],
        "fd_tiled_fits": [pp],
        "fd_transmission_tiled_fits": [pp],
        "fd_halo_tiled_fits": [hp],
        "fd_tiled_occupancy": [pp, ip],
        "fd_transmission_occupancy": [pp, ip],
        "fd_halo_occupancy": [hp, ip],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    consts = ("fd_tile_pixels", "fd_max_tiles", "fd_tile_h", "fd_tile_w",
              "fd_guided_min_blocks")
    for name in consts:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    got = tuple(getattr(lib, name)() for name in consts)
    want = (TILE_PIXELS, TOPK_MAX_TILES, *TILES[tile], blocks_per_sm)
    if got != want:
        raise RuntimeError(f"{SOURCE} tiles {got}, expected {want}")
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(name: str, counts: Dict[str, int], s, *args,
            kernel: Optional[str] = None) -> None:
    """Call ``fd_<kernel or name>`` of the static ``s``'s library variant on
    the current stream; count it as ``counts[name]`` and under the
    variant; raise on a non-zero cudaError_t."""
    fn = f"fd_{kernel or name}"
    rc = getattr(lib_for(s), fn)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed: cudaError_t {rc}")
    with launch_lock:       # staged.launch_lock: one lock for every counter
        counts[name] += 1
        variant_launches[s.variant] = variant_launches.get(s.variant, 0) + 1


def _check_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def _j_out(s: Static, device, out: Optional[torch.Tensor]) -> torch.Tensor:
    """J's (L, B, H, W, 3) buffer: ``out`` where given (checked: the shape,
    the output dtype, contiguous, on ``device``; it may be the wire frames
    themselves, each element read before it is written), else a new one."""
    shape = (s.L, s.B, s.H, s.W, 3)
    if out is None:
        return torch.empty(shape, dtype=s.out_dtype, device=device)
    if (tuple(out.shape) != shape or out.dtype != s.out_dtype
            or out.device != torch.device(device) or not out.is_contiguous()):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on {out.device} "
                         f"is not a contiguous {shape} {s.out_dtype} on {device}")
    return out


def _out_kw(out: Optional[torch.Tensor]) -> dict:
    """``out=`` for a pass only where J has a given buffer."""
    return {} if out is None else {"out": out}


def _plane(s: Static, n: int = 0, dtype=torch.float32, device=None):
    shape = (s.n_frames, s.H, s.W) if n == 0 else (n, s.n_frames, s.H, s.W)
    return torch.empty(shape, dtype=dtype, device=device)


def cuda_premap(img, carry_f, s: Static, counts=launches):
    _check_cuda(img, carry_f)
    pre = _plane(s, device=img.device)
    g = _plane(s, device=img.device) if s.refine else None
    p = s.params()
    _launch("premap", counts, s, img.data_ptr(), carry_f.data_ptr(), pre.data_ptr(),
            _ptr(g), ctypes.byref(p))
    return pre, g


def cuda_min_rows(pre, s: Static, counts=launches):
    _check_cuda(pre)
    out = torch.empty_like(pre)
    p = s.params()
    _launch("min_rows", counts, s, pre.data_ptr(), out.data_ptr(), ctypes.byref(p))
    return out


def cuda_min_cols_tmap(rows, s: Static, counts=launches):
    _check_cuda(rows)
    t_raw = torch.empty_like(rows)
    p = s.params()
    _launch("min_cols_tmap", counts, s, rows.data_ptr(), t_raw.data_ptr(), ctypes.byref(p))
    return t_raw


def _tile_keep(s: Static) -> int:
    """Keys a top-k tile keeps (a tile has TILE_PIXELS pixels)."""
    return min(s.topk, TILE_PIXELS)


def cuda_topk_block(t_raw, s: Static, counts=launches):
    """(N, H, W) t_raw -> (N, n_tiles, min(k, TILE_PIXELS)) int64 keys
    (unsigned bits)."""
    _check_cuda(t_raw)
    n_tiles = -(-(s.H * s.W) // TILE_PIXELS)
    keys = torch.empty((s.n_frames, n_tiles, _tile_keep(s)),
                       dtype=torch.int64, device=t_raw.device)
    p = s.params()
    _launch("topk_block", counts, s, t_raw.data_ptr(), keys.data_ptr(), ctypes.byref(p))
    return keys


def _lists(keys: torch.Tensor) -> Tuple[int, int]:
    """(n_lists, kk) of a frame's keys: ``topk_block``'s (N, n_lists, kk)
    lists, or a tiled pass's (N, tiles) single keys a tile (top-1)."""
    return (keys.shape[1], keys.shape[2]) if keys.dim() == 3 else (keys.shape[1], 1)


def cuda_topk_merge(keys, img, s: Static, counts=launches):
    _check_cuda(keys, img)
    cand = torch.empty((s.n_frames, 3), dtype=torch.float32, device=img.device)
    p = s.params()
    _launch("topk_merge", counts, s, keys.data_ptr(), *_lists(keys), img.data_ptr(),
            cand.data_ptr(), _OUT_CODES[torch.float32], None, ctypes.byref(p))
    return cand


def cuda_candidate(keys, img, s: Static, counts=transmission_launches):
    """The merge kernel for the transmission stage, on ``topk_block``'s
    lists or, at top-1, ``tmap_tile``'s tile keys: ``(t_min (N,) float32,
    cand (N, 3) in the output dtype)``."""
    _check_cuda(keys, img)
    t_min = torch.empty((s.n_frames,), dtype=torch.float32, device=img.device)
    cand = torch.empty((s.n_frames, 3), dtype=s.out_dtype, device=img.device)
    p = s.params()
    _launch("candidate", counts, s, keys.data_ptr(), *_lists(keys), img.data_ptr(),
            cand.data_ptr(), _OUT_CODES[s.out_dtype], t_min.data_ptr(),
            ctypes.byref(p), kernel="topk_merge")
    return t_min, cand


def cuda_ema(cand, ids, carry_f, carry_i, s: Static, counts=launches):
    _check_cuda(cand, ids, carry_f, carry_i)
    dev = cand.device
    a_seq = torch.empty((s.L, s.B, 3), dtype=torch.float32, device=dev)
    cf = torch.empty((s.L, 3), dtype=torch.float32, device=dev)
    ci = torch.empty((s.L, 2), dtype=torch.int32, device=dev)
    p = s.params()
    _launch("ema", counts, s, cand.data_ptr(), ids.data_ptr(), carry_f.data_ptr(),
            carry_i.data_ptr(), a_seq.data_ptr(), cf.data_ptr(), ci.data_ptr(),
            ctypes.byref(p))
    return a_seq, cf, ci


def cuda_box_rows4(g, t_raw, s: Static, counts=launches):
    _check_cuda(g, t_raw)
    out = _plane(s, 4, device=g.device)
    p = s.params()
    _launch("box_rows4", counts, s, g.data_ptr(), t_raw.data_ptr(), out.data_ptr(),
            ctypes.byref(p))
    return out


def cuda_box_cols_ab(rows4, s: Static, counts=launches):
    _check_cuda(rows4)
    ab = _plane(s, 2, device=rows4.device)
    p = s.params()
    _launch("box_cols_ab", counts, s, rows4.data_ptr(), ab.data_ptr(), ctypes.byref(p))
    return ab


def cuda_box_rows2(ab, s: Static, counts=launches):
    _check_cuda(ab)
    out = torch.empty_like(ab)
    p = s.params()
    _launch("box_rows2", counts, s, ab.data_ptr(), out.data_ptr(), ctypes.byref(p))
    return out


def cuda_recover(img, t_raw, g, rows2, a_seq, s: Static, counts=launches,
                 out=None):
    _check_cuda(img, t_raw, a_seq)
    dev = img.device
    J = _j_out(s, dev, out)
    t = torch.empty((s.L, s.B, s.H, s.W), dtype=s.out_dtype, device=dev)
    p = s.params()
    _launch("recover", counts, s, img.data_ptr(), t_raw.data_ptr(), _ptr(g), _ptr(rows2),
            a_seq.data_ptr(), J.data_ptr(), t.data_ptr(), ctypes.byref(p))
    return J, t


def cuda_tmap(t_raw, g, rows2, s: Static, counts=transmission_launches):
    """The refined t (t_raw without refine) in the output dtype, no J."""
    _check_cuda(t_raw)
    t = torch.empty((s.L, s.B, s.H, s.W), dtype=s.out_dtype,
                    device=t_raw.device)
    p = s.params()
    _launch("tmap", counts, s, t_raw.data_ptr(), _ptr(g), _ptr(rows2),
            t.data_ptr(), ctypes.byref(p))
    return t


def tiled_fits(s: Static) -> bool:
    """Whether every tiled pass that ``s`` runs fits a block's shared
    memory (``fd_tiled_fits``; launches nothing). Where it does not,
    :func:`fused_dehaze_lanes` runs the ten passes."""
    return bool(lib_for(s).fd_tiled_fits(ctypes.byref(s.params())))


# The tiled passes' shared memory as the CUDA source reckons it
# (``tmap_smem``, ``guided_smem``, ``recover_smem``, ``refine_tmap_smem``,
# ``halo_*_smem``) for a static's tile, which decides from the static
# shape alone which sequence a transmission stage runs; ``chip_smoke.py``
# holds these against each library variant's fits tests.
_TILE_THREADS, _RUN_V = 256, 16


@dataclasses.dataclass(frozen=True)
class _Geometry:
    """One tile's shared-memory arithmetic (``halo_rows`` .. ``count_ints``
    in the CUDA source), in floats or ints."""
    th: int
    tw: int

    @property
    def stage_stride(self) -> int:          # a staged output row
        return self.tw + 1

    def halo_rows(self, r: int) -> int:
        return self.th + 2 * r

    def halo_cols(self, r: int) -> int:
        return self.tw + 2 * r

    def run_stride(self, r: int) -> int:
        return self.halo_cols(r) | 1

    def in_floats(self, planes: int, r: int) -> int:
        return planes * max(self.halo_rows(r) * self.halo_cols(r),
                            self.th * self.stage_stride)

    def planes_and_runs(self, planes: int, sums: int, r: int) -> int:
        runs = sums * self.th * self.run_stride(r)
        if self.halo_cols(r) * (self.th // _RUN_V) <= _TILE_THREADS:   # sums overwrite
            return max(self.in_floats(planes, r), runs)
        return self.in_floats(planes, r) + runs

    def refine_floats(self, refine: bool, r: int) -> int:
        return self.th * self.tw + (self.planes_and_runs(2, 2, r) if refine
                                    else self.th * self.stage_stride)

    def count_ints(self, r: int) -> int:
        return self.halo_rows(r) + self.halo_cols(r) + 2


def _geometry(s) -> _Geometry:
    return _Geometry(*TILES[s.tile])


def _wire_row_bytes(n: int, es: int) -> int:
    return ((3 * n * es + 15) // 16 + 1) * 16


def transmission_smem(s: Static) -> Tuple[int, int, int]:
    """Shared memory (bytes) of a block of the tiled transmission sequence's
    ``tmap_tile``, ``guided_ab`` and ``refine_tmap`` at ``s``'s tile."""
    g, r, es = _geometry(s), s.radius, s.in_dtype.itemsize
    wire = max(g.halo_rows(r) * _wire_row_bytes(g.halo_cols(r), es),
               4 * g.th * g.run_stride(r))
    return (wire + 4 * g.in_floats(1, r) + 4 * g.halo_rows(r),
            4 * g.planes_and_runs(2, 4, s.gf_radius),
            4 * g.refine_floats(s.refine, s.gf_radius))


def tiled_smem(s: Static) -> Tuple[int, int, int]:
    """Shared memory (bytes) of a block of the megakernel's ``tmap_tile``,
    ``guided_ab`` and ``refine_recover`` at ``s``'s tile: the transmission
    sequence's, ``refine_recover`` with the tile's wire rows."""
    tmap, guided, refine = transmission_smem(s)
    g = _geometry(s)
    return tmap, guided, refine + g.th * _wire_row_bytes(g.tw, s.in_dtype.itemsize)


def tiled_smem_fits(s: Static) -> bool:
    """:func:`tiled_fits` from :func:`tiled_smem` (launches and loads
    nothing; ``chip_smoke.py`` holds it against ``fd_tiled_fits`` of each
    library variant)."""
    tmap, guided, recover = tiled_smem(s)
    return (tmap <= MAX_SMEM and (not s.refine or guided <= MAX_SMEM)
            and recover <= MAX_SMEM and 4 * 3 * s.B <= MAX_SMEM)


def transmission_tiled_fits(s: Static) -> bool:
    """Whether the transmission stage runs its tiled sequence for ``s``
    (``fd_transmission_tiled_fits``; launches nothing): every pass's block
    fits its shared memory and, at top-1, the merge takes the frame's tile
    keys. From the shape alone: radius <= 36 on float32 frames (52
    bfloat16, 66 uint8) and, with refine, gf_radius <= 45. Past it the ten
    passes, which take any radius."""
    tmap, guided, refine = transmission_smem(s)
    return (tmap <= MAX_SMEM and (not s.refine or guided <= MAX_SMEM)
            and refine <= MAX_SMEM
            and (s.topk > 1 or tile_count(s.H, s.W, s.tile) <= TOPK_MAX_TILES))


def _occupancy(fn: str, s) -> Tuple[int, int, int]:
    blocks = (ctypes.c_int * 3)()
    rc = getattr(lib_for(s), fn)(ctypes.byref(s.params()), blocks)
    if rc != 0:
        raise RuntimeError(f"{fn} failed: cudaError_t {rc}")
    return tuple(blocks)


def tiled_occupancy(s: Static) -> Tuple[int, int, int]:
    """Blocks an SM of ``tmap_tile``, ``guided_ab`` and ``refine_recover``
    for ``s``, from the card's occupancy calculator (launches nothing)."""
    return _occupancy("fd_tiled_occupancy", s)


def transmission_occupancy(s: Static) -> Tuple[int, int, int]:
    """Blocks an SM of the transmission stage's ``tmap_tile``,
    ``guided_ab`` and ``refine_tmap`` for ``s`` (launches nothing)."""
    return _occupancy("fd_transmission_occupancy", s)


def cuda_tmap_tile(img, carry_f, s: Static, counts=launches):
    """-> ``(t_raw, g (refine; else None), keys)``: (N, H, W) float32
    planes and, at top-1, each tile's smallest key, (N, tiles) int64
    (unsigned bits), tiles in row-major order; None at k > 1."""
    _check_cuda(img, carry_f)
    t_raw = _plane(s, device=img.device)
    g = _plane(s, device=img.device) if s.refine else None
    keys = None
    if s.topk == 1:
        keys = torch.empty((s.n_frames, tile_count(s.H, s.W, s.tile)),
                           dtype=torch.int64, device=img.device)
    p = s.params()
    _launch("tmap_tile", counts, s, img.data_ptr(), carry_f.data_ptr(),
            t_raw.data_ptr(), _ptr(g), _ptr(keys), ctypes.byref(p))
    return t_raw, g, keys


def cuda_select_ema(keys, img, ids, carry_f, carry_i, s: Static,
                    counts=launches):
    """Tile keys (``tmap_tile``'s at top-1, ``topk_block``'s lists above)
    -> ``(a_seq (L, B, 3), carry_f' (L, 3), carry_i' (L, 2))``."""
    _check_cuda(keys, img, ids, carry_f, carry_i)
    dev = img.device
    a_seq = torch.empty((s.L, s.B, 3), dtype=torch.float32, device=dev)
    cf = torch.empty((s.L, 3), dtype=torch.float32, device=dev)
    ci = torch.empty((s.L, 2), dtype=torch.int32, device=dev)
    p = s.params()
    _launch("select_ema", counts, s, keys.data_ptr(), img.data_ptr(),
            ids.data_ptr(), carry_f.data_ptr(), carry_i.data_ptr(),
            a_seq.data_ptr(), cf.data_ptr(), ci.data_ptr(), ctypes.byref(p))
    return a_seq, cf, ci


def cuda_guided_ab(g, t_raw, s: Static, counts=launches):
    """-> the guided filter's a and b, (2, N, H, W) float32."""
    _check_cuda(g, t_raw)
    ab = _plane(s, 2, device=g.device)
    p = s.params()
    _launch("guided_ab", counts, s, g.data_ptr(), t_raw.data_ptr(), ab.data_ptr(),
            ctypes.byref(p))
    return ab


def cuda_refine_recover(img, t_raw, g, ab, a_seq, s: Static, counts=launches,
                        out=None):
    """-> ``(J, t)`` in the output dtype; t is t_raw without refine. J goes
    into ``out`` where given (:func:`_j_out`)."""
    _check_cuda(img, t_raw, a_seq)
    dev = img.device
    J = _j_out(s, dev, out)
    t = torch.empty((s.L, s.B, s.H, s.W), dtype=s.out_dtype, device=dev)
    p = s.params()
    _launch("refine_recover", counts, s, img.data_ptr(), t_raw.data_ptr(), _ptr(g),
            _ptr(ab), a_seq.data_ptr(), J.data_ptr(), t.data_ptr(),
            ctypes.byref(p))
    return J, t


def cuda_refine_tmap(t_raw, g, ab, s: Static, counts=transmission_launches):
    """``refine_recover`` without the wire rows and J: the refined t (t_raw
    without refine) in the output dtype."""
    _check_cuda(t_raw)
    t = torch.empty((s.L, s.B, s.H, s.W), dtype=s.out_dtype, device=t_raw.device)
    p = s.params()
    _launch("refine_tmap", counts, s, t_raw.data_ptr(), _ptr(g), _ptr(ab),
            t.data_ptr(), ctypes.byref(p))
    return t


# ---------------------------------------------------------------------------
# The plain passes (same signatures, any device)
# ---------------------------------------------------------------------------

def _frames(img: torch.Tensor, s: Static) -> torch.Tensor:
    return ref.upcast_frames(img).reshape(s.n_frames, s.H, s.W, 3)


def plain_premap(img, carry_f, s: Static):
    x = _frames(img, s)
    a0 = torch.clamp_min(carry_f.to(torch.float32), 1e-3)
    a0 = a0.repeat_interleave(s.B, 0)[:, None, None, :]
    pre = ref.premap(x, a0, s.algorithm, s.cap_w)
    return pre, (ref.luminance(x) if s.refine else None)


def plain_min_rows(pre, s: Static):
    k = 2 * s.radius + 1
    return -F.max_pool2d(-pre[:, None], (k, 1), stride=1,
                         padding=(s.radius, 0))[:, 0]


def plain_min_cols_tmap(rows, s: Static):
    k = 2 * s.radius + 1
    dark = -F.max_pool2d(-rows[:, None], (1, k), stride=1,
                         padding=(0, s.radius))[:, 0]
    return ref.tmap_from_dark(dark, s.algorithm, s.omega, s.beta)


def tile_keys(t_raw: torch.Tensor, k: int) -> torch.Tensor:
    """(N, H, W) t -> per tile of :data:`TILE_PIXELS` pixels, its min(k,
    TILE_PIXELS) smallest keys in ascending order, all-ones where the tile
    has fewer pixels: bit for bit what the top-k tile kernel writes."""
    n = t_raw.shape[0]
    P = t_raw.shape[1] * t_raw.shape[2]
    n_tiles = -(-P // TILE_PIXELS)
    padded = torch.full((n, n_tiles * TILE_PIXELS), KEY_LAST,
                        dtype=torch.int64, device=t_raw.device)
    padded[:, :P] = topk_keys_signed(t_raw)
    best = torch.sort(padded.reshape(n, n_tiles, TILE_PIXELS), dim=-1
                      ).values[..., :min(k, TILE_PIXELS)]
    return flip_key_order(best)


def plain_topk_block(t_raw, s: Static):
    return tile_keys(t_raw, s.topk)


def _merge(keys, img, s: Static):
    """Merge the tile key lists (unsigned 64-bit keys held in int64):
    ``(the k smallest in signed order, the mean of I over them)``."""
    x = _frames(img, s).reshape(s.n_frames, -1, 3)
    flat = flip_key_order(keys.reshape(s.n_frames, -1))
    best = torch.sort(flat, dim=-1).values[:, :s.topk]
    return best, topk_mean(x, key_index(best))


def plain_topk_merge(keys, img, s: Static):
    return _merge(keys, img, s)[1]


def plain_candidate(keys, img, s: Static):
    best, cand = _merge(keys, img, s)
    return key_t(best[:, 0]), cand.to(s.out_dtype)


def plain_ema(cand, ids, carry_f, carry_i, s: Static):
    A = carry_f.to(torch.float32)
    k = carry_i[:, 0].to(torch.int32)
    inited = carry_i[:, 1] != 0
    c = cand.reshape(s.L, s.B, 3).to(torch.float32)
    ids = ids.reshape(s.L, s.B).to(torch.int32)
    seq = []
    for b in range(s.B):
        A, k, inited = ref.ema_step(c[:, b], ids[:, b], A, k, inited,
                                    period=s.period, lam=s.lam)
        seq.append(A)
    ci = torch.stack([k, inited.to(torch.int32)], dim=-1)
    return torch.stack(seq, dim=1), A, ci


def plain_box_rows4(g, t_raw, s: Static):
    r = s.gf_radius
    return torch.stack([window_sum(v, r, -2)
                        for v in (g, t_raw, g * t_raw, g * g)])


def plain_box_cols_ab(rows4, s: Static):
    cnt = window_counts(s.H, s.W, s.gf_radius, rows4.device)
    mean_g, mean_p, corr_gp, corr_gg = (window_sum(v, s.gf_radius, -1) / cnt
                                        for v in rows4)
    var_g = corr_gg - mean_g * mean_g
    cov_gp = corr_gp - mean_g * mean_p
    a = cov_gp / (var_g + s.gf_eps)
    return torch.stack([a, mean_p - a * mean_g])


def plain_box_rows2(ab, s: Static):
    return torch.stack([window_sum(v, s.gf_radius, -2) for v in ab])


def _refined_t(t_raw, g, rows2, s: Static):
    """clip(mean_a * g + mean_b, 0, 1) from the a/b row sums; t_raw
    without refine."""
    if not s.refine:
        return t_raw
    cnt = window_counts(s.H, s.W, s.gf_radius, t_raw.device)
    mean_a = window_sum(rows2[0], s.gf_radius, -1) / cnt
    mean_b = window_sum(rows2[1], s.gf_radius, -1) / cnt
    return torch.clamp(mean_a * g + mean_b, 0.0, 1.0)


def plain_recover(img, t_raw, g, rows2, a_seq, s: Static, out=None):
    J_out = None if out is None else _j_out(s, img.device, out)
    x = _frames(img, s)
    t = _refined_t(t_raw, g, rows2, s)
    tt = torch.clamp_min(t, s.t0)[..., None]
    A = a_seq.reshape(s.n_frames, 3)[:, None, None, :]
    J = torch.clamp((x - A) / tt + A, 0.0, 1.0)
    if s.gamma != 1.0:
        J = J ** s.gamma
    shape = (s.L, s.B, s.H, s.W)
    J = J.reshape(shape + (3,)).to(s.out_dtype)
    if J_out is not None:
        J = J_out.copy_(J)
    return J, t.reshape(shape).to(s.out_dtype)


def plain_tmap(t_raw, g, rows2, s: Static):
    return _refined_t(t_raw, g, rows2, s).reshape(
        s.L, s.B, s.H, s.W).to(s.out_dtype)


def _tile_min_keys(keys: torch.Tensor, tile: str = DEFAULT_TILE) -> torch.Tensor:
    """(N, h, w) signed-order keys -> each ``tile``'s smallest, (N, tiles)
    in row-major tile order (unsigned bits)."""
    th, tw = TILES[tile]
    n, h, w = keys.shape
    ty, tx = -(-h // th), -(-w // tw)
    padded = torch.full((n, ty * th, tx * tw), KEY_LAST,
                        dtype=torch.int64, device=keys.device)
    padded[:, :h, :w] = keys
    best = padded.reshape(n, ty, th, tx, tw).amin(dim=(2, 4))
    return flip_key_order(best.reshape(n, ty * tx))


def tile2d_keys(t_raw: torch.Tensor, tile: str = DEFAULT_TILE) -> torch.Tensor:
    """(N, H, W) t -> each ``tile``'s smallest key, (N, tiles) in row-major
    tile order: bit for bit what ``tmap_tile`` writes at top-1."""
    n, h, w = t_raw.shape
    return _tile_min_keys(topk_keys_signed(t_raw).reshape(n, h, w), tile)


def plain_tmap_tile(img, carry_f, s: Static):
    pre, g = plain_premap(img, carry_f, s)
    t_raw = plain_min_cols_tmap(plain_min_rows(pre, s), s)
    return t_raw, g, (tile2d_keys(t_raw, s.tile) if s.topk == 1 else None)


def plain_select_ema(keys, img, ids, carry_f, carry_i, s: Static):
    return plain_ema(plain_topk_merge(keys, img, s), ids, carry_f, carry_i, s)


def plain_guided_ab(g, t_raw, s: Static):
    return plain_box_cols_ab(plain_box_rows4(g, t_raw, s), s)


def plain_refine_recover(img, t_raw, g, ab, a_seq, s: Static, out=None):
    rows2 = plain_box_rows2(ab, s) if s.refine else None
    return plain_recover(img, t_raw, g, rows2, a_seq, s, out=out)


def plain_refine_tmap(t_raw, g, ab, s: Static):
    return plain_tmap(t_raw, g, plain_box_rows2(ab, s) if s.refine else None, s)


Passes = Dict[str, Callable]

#: Every pass of both sequences, by name.
CUDA_PASSES: Passes = {name: globals()[f"cuda_{name}"]
                       for name in PASSES + TILED_PASSES}
PLAIN_PASSES: Passes = {name: globals()[f"plain_{name}"]
                        for name in PASSES + TILED_PASSES}

#: The transmission stage's passes, every CUDA one counted in
#: :data:`transmission_launches`.
TRANSMISSION_CUDA_PASSES: Passes = {
    name: functools.partial(globals()[f"cuda_{name}"],
                            counts=transmission_launches)
    for name in TRANSMISSION_PASSES}
TRANSMISSION_PLAIN_PASSES: Passes = {
    name: globals()[f"plain_{name}"] for name in TRANSMISSION_PASSES}
TILED_TRANSMISSION_CUDA_PASSES: Passes = {
    name: functools.partial(globals()[f"cuda_{name}"],
                            counts=transmission_launches)
    for name in TILED_TRANSMISSION_PASSES}
TILED_TRANSMISSION_PLAIN_PASSES: Passes = {
    name: globals()[f"plain_{name}"] for name in TILED_TRANSMISSION_PASSES}


def run_tiled_passes(img, frame_ids, carry_f, carry_i, s: Static,
                     passes: Passes = CUDA_PASSES, out=None):
    """The megakernel's pass sequence, through ``passes``. Returns
    ``(J, t, a_seq, carry_f', carry_i')``; J goes into ``out`` where given
    (the wire frames too, where their dtype is J's: the last pass reads
    each frame element before it writes J's)."""
    t_raw, g, keys = passes["tmap_tile"](img, carry_f, s)
    if s.topk > 1:
        keys = passes["topk_block"](t_raw, s)
    a_seq, cf, ci = passes["select_ema"](keys, img, frame_ids, carry_f,
                                         carry_i, s)
    ab = passes["guided_ab"](g, t_raw, s) if s.refine else None
    J, t = passes["refine_recover"](img, t_raw, g, ab, a_seq, s, **_out_kw(out))
    return J, t, a_seq, cf, ci


def run_passes(img, frame_ids, carry_f, carry_i, s: Static,
               passes: Passes = CUDA_PASSES, out=None):
    """The ten-pass sequence the tiled passes replaced, through ``passes``:
    the same outputs as :func:`run_tiled_passes`, bit for bit."""
    pre, g = passes["premap"](img, carry_f, s)
    t_raw = passes["min_cols_tmap"](passes["min_rows"](pre, s), s)
    cand = passes["topk_merge"](passes["topk_block"](t_raw, s), img, s)
    a_seq, cf, ci = passes["ema"](cand, frame_ids, carry_f, carry_i, s)
    rows2 = None
    if s.refine:
        ab = passes["box_cols_ab"](passes["box_rows4"](g, t_raw, s), s)
        rows2 = passes["box_rows2"](ab, s)
    J, t = passes["recover"](img, t_raw, g, rows2, a_seq, s, **_out_kw(out))
    return J, t, a_seq, cf, ci


def run_tiled_transmission_passes(img, a_saved, s: Static,
                                  passes: Passes = TILED_TRANSMISSION_CUDA_PASSES):
    """The fused transmission stage's tiled sequence, through ``passes``:
    (L, B, H, W, 3) frames and per-lane saved A (L, 3) -> ``(t (L, B, H, W)
    and cand (L, B, 3) in the output dtype, t_min (L, B) float32)``; the
    megakernel's passes with the saved A for its carry, without the EMA
    and J."""
    t_raw, g, keys = passes["tmap_tile"](img, a_saved, s)
    if s.topk > 1:
        keys = passes["topk_block"](t_raw, s)
    t_min, cand = passes["candidate"](keys, img, s)
    ab = passes["guided_ab"](g, t_raw, s) if s.refine else None
    t = passes["refine_tmap"](t_raw, g, ab, s)
    return t, t_min.reshape(s.L, s.B), cand.reshape(s.L, s.B, 3)


def run_transmission_passes(img, a_saved, s: Static,
                            passes: Passes = TRANSMISSION_CUDA_PASSES):
    """The fused transmission stage's ten-pass sequence, through ``passes``:
    the same outputs as :func:`run_tiled_transmission_passes`, bit for
    bit, for windows of any width."""
    pre, g = passes["premap"](img, a_saved, s)
    t_raw = passes["min_cols_tmap"](passes["min_rows"](pre, s), s)
    t_min, cand = passes["candidate"](passes["topk_block"](t_raw, s), img, s)
    rows2 = None
    if s.refine:
        ab = passes["box_cols_ab"](passes["box_rows4"](g, t_raw, s), s)
        rows2 = passes["box_rows2"](ab, s)
    t = passes["tmap"](t_raw, g, rows2, s)
    return t, t_min.reshape(s.L, s.B), cand.reshape(s.L, s.B, 3)


# ---------------------------------------------------------------------------
# The halo form (B9): one spatial shard's transmission stage
# ---------------------------------------------------------------------------

class _HaloParams(ctypes.Structure):
    """Mirror of ``HaloParams`` in ``csrc/fused_dehaze.cu``."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "N", "h", "w", "halo_h", "halo_w", "in_dtype", "pre_dtype",
        "guide_dtype", "out_dtype", "algorithm", "radius", "refine",
        "gf_radius", "topk")]
        + [(n, ctypes.c_float) for n in (
            "omega", "neg_beta", "gf_eps", "u8_scale")])


@dataclasses.dataclass(frozen=True)
class HaloStatic:
    """Every static argument of one halo-stage call: N frames of an h x w
    core, planes extended by ``halo_h`` rows and ``halo_w`` columns a side."""
    N: int
    h: int
    w: int
    halo_h: int
    halo_w: int
    in_dtype: torch.dtype
    pre_dtype: torch.dtype
    guide_dtype: torch.dtype
    out_dtype: torch.dtype
    algorithm: str
    radius: int
    omega: float
    beta: float
    refine: bool
    gf_radius: int
    gf_eps: float
    topk: int
    tile: str = DEFAULT_TILE
    blocks_per_sm: int = BLOCKS_PER_SM[0]

    @property
    def variant(self) -> str:
        return f"{self.tile}/{self.blocks_per_sm}"

    @property
    def h_ext(self) -> int:
        return self.h + 2 * self.halo_h

    @property
    def w_ext(self) -> int:
        return self.w + 2 * self.halo_w

    def core(self, plane: torch.Tensor) -> torch.Tensor:
        """The core block of (..., h_ext, w_ext) planes."""
        return plane[..., self.halo_h:self.halo_h + self.h,
                     self.halo_w:self.halo_w + self.w]

    def region(self, name: str) -> Tuple[slice, slice]:
        """The rows and columns of the extended plane that the tiled pass
        ``name`` writes (``halo_region`` in the CUDA source): the core
        widened by 2 gf_r a side for ``tmap_tile``'s t_raw (the core alone
        without refine), by gf_r for ``guided_ab``'s a and b, the core for
        ``refine_tmap``. Each pass reads only what the pass before wrote;
        the rest of its output planes is left unwritten."""
        m = {"tmap_tile": 2 * self.gf_radius if self.refine else 0,
             "guided_ab": self.gf_radius, "refine_tmap": 0}[name]
        return (slice(max(self.halo_h - m, 0), min(self.halo_h + self.h + m, self.h_ext)),
                slice(max(self.halo_w - m, 0), min(self.halo_w + self.w + m, self.w_ext)))

    def region_shape(self, name: str) -> Tuple[int, int]:
        ys, xs = self.region(name)
        return ys.stop - ys.start, xs.stop - xs.start

    @functools.lru_cache(maxsize=64)
    def params(self) -> _HaloParams:
        return _HaloParams(
            N=self.N, h=self.h, w=self.w, halo_h=self.halo_h,
            halo_w=self.halo_w, in_dtype=_IN_CODES[self.in_dtype],
            pre_dtype=_OUT_CODES[self.pre_dtype],
            guide_dtype=_OUT_CODES[self.guide_dtype],
            out_dtype=_OUT_CODES[self.out_dtype],
            algorithm=0 if self.algorithm == "dcp" else 1, radius=self.radius,
            refine=int(self.refine), gf_radius=self.gf_radius, topk=self.topk,
            omega=self.omega, neg_beta=-self.beta, gf_eps=self.gf_eps,
            u8_scale=1.0 / ref.U8_SCALE)


def make_halo_static(img: torch.Tensor, pre_ext: torch.Tensor,
                     guide_ext: torch.Tensor, *, algorithm: str = "dcp",
                     radius: int, omega: float = 0.95, beta: float = 1.0,
                     refine: bool, gf_radius: int, gf_eps: float,
                     topk: int = 1, out_dtype: Optional[str] = None,
                     tile: str = DEFAULT_TILE,
                     blocks_per_sm: int = BLOCKS_PER_SM[0]) -> HaloStatic:
    """Validate (N, h, w, 3) core frames, (N, h_ext, w_ext) planes and the
    static arguments; raise ``ValueError`` on anything the kernels do not
    take."""
    check_knobs(tile, blocks_per_sm)
    if img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f"expected (N, h, w, 3) frames, got {tuple(img.shape)}")
    if img.dtype not in _IN_CODES:
        raise ValueError(f"unsupported frame dtype {img.dtype}")
    n, h, w, _ = img.shape
    if pre_ext.dim() != 3 or tuple(guide_ext.shape) != tuple(pre_ext.shape) \
            or pre_ext.shape[0] != n:
        raise ValueError(f"planes {tuple(pre_ext.shape)}, "
                         f"{tuple(guide_ext.shape)} are not (N, h_ext, w_ext) "
                         f"with N = {n}")
    halo_h, halo_w = (pre_ext.shape[1] - h) // 2, (pre_ext.shape[2] - w) // 2
    if (pre_ext.shape[1], pre_ext.shape[2]) != (h + 2 * halo_h, w + 2 * halo_w) \
            or min(halo_h, halo_w) < 0:
        raise ValueError(f"planes {tuple(pre_ext.shape[1:])} do not extend "
                         f"the core {(h, w)} evenly")
    for t in (pre_ext, guide_ext):
        if t.dtype not in _OUT_CODES:
            raise ValueError(f"unsupported plane dtype {t.dtype}")
    if algorithm not in ("dcp", "cap"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if not 1 <= topk <= h * w:
        raise ValueError(f"topk={topk} outside [1, h*w={h * w}]")
    if -(-(h * w) // TILE_PIXELS) > TOPK_MAX_TILES:
        raise ValueError(f"h*w={h * w} needs more than {TOPK_MAX_TILES} "
                         f"top-k tiles of {TILE_PIXELS} pixels")
    if radius < 0 or gf_radius < 0:
        raise ValueError("window radii must be >= 0")
    return HaloStatic(N=n, h=h, w=w, halo_h=halo_h, halo_w=halo_w,
                      in_dtype=img.dtype, pre_dtype=pre_ext.dtype,
                      guide_dtype=guide_ext.dtype,
                      out_dtype=ref.resolve_out_dtype(img.dtype, out_dtype),
                      algorithm=algorithm, radius=radius, omega=omega,
                      beta=beta, refine=bool(refine), gf_radius=gf_radius,
                      gf_eps=gf_eps, topk=topk, tile=tile,
                      blocks_per_sm=blocks_per_sm)


def _halo_launch(name: str, s, *args) -> None:
    _launch(name, halo_launches, s, *args, kernel=f"halo_{name}")


def _ext_planes(s: HaloStatic, n: int, device) -> torch.Tensor:
    return torch.empty((n, s.N, s.h_ext, s.w_ext), dtype=torch.float32,
                       device=device)


def cuda_halo_min_rows(pre_ext, vh, vw, s: HaloStatic):
    _check_cuda(pre_ext, vh, vw)
    out = _ext_planes(s, 1, pre_ext.device)[0]
    p = s.params()
    _halo_launch("min_rows", s, pre_ext.data_ptr(), vh.data_ptr(), vw.data_ptr(),
                 out.data_ptr(), ctypes.byref(p))
    return out


def cuda_halo_min_cols_tmap(rows, s: HaloStatic):
    """-> ``(t_raw on the extended plane, its core (N, h, w))``."""
    _check_cuda(rows)
    t_ext = torch.empty_like(rows)
    t_core = torch.empty((s.N, s.h, s.w), dtype=torch.float32,
                         device=rows.device)
    p = s.params()
    _halo_launch("min_cols_tmap", s, rows.data_ptr(), t_ext.data_ptr(),
                 t_core.data_ptr(), ctypes.byref(p))
    return t_ext, t_core


def cuda_halo_topk_block(t_core, s: HaloStatic):
    _check_cuda(t_core)
    keys = torch.empty((s.N, -(-(s.h * s.w) // TILE_PIXELS),
                        min(s.topk, TILE_PIXELS)), dtype=torch.int64,
                       device=t_core.device)
    p = s.params()
    _halo_launch("topk_block", s, t_core.data_ptr(), keys.data_ptr(),
                 ctypes.byref(p))
    return keys


def cuda_halo_topk_list(keys, img, s: HaloStatic):
    """``topk_block``'s lists or, at top-1, ``tmap_tile``'s tile keys ->
    ``(tk_t (N, k) float32, tk_rgb (N, k, 3) in the output dtype, tk_idx
    (N, k) int32)``, ascending in (t, local flat index)."""
    _check_cuda(keys, img)
    dev = img.device
    tk_t = torch.empty((s.N, s.topk), dtype=torch.float32, device=dev)
    tk_rgb = torch.empty((s.N, s.topk, 3), dtype=s.out_dtype, device=dev)
    tk_idx = torch.empty((s.N, s.topk), dtype=torch.int32, device=dev)
    p = s.params()
    _halo_launch("topk_list", s, keys.data_ptr(), *_lists(keys), img.data_ptr(),
                 tk_t.data_ptr(), tk_rgb.data_ptr(), tk_idx.data_ptr(),
                 ctypes.byref(p))
    return tk_t, tk_rgb, tk_idx


def cuda_halo_box_rows4(guide_ext, t_ext, vh, vw, s: HaloStatic):
    _check_cuda(guide_ext, t_ext, vh, vw)
    out = _ext_planes(s, 4, t_ext.device)
    p = s.params()
    _halo_launch("box_rows4", s, guide_ext.data_ptr(), t_ext.data_ptr(),
                 vh.data_ptr(), vw.data_ptr(), out.data_ptr(), ctypes.byref(p))
    return out


def cuda_halo_box_cols_ab(rows4, vh, vw, s: HaloStatic):
    _check_cuda(rows4, vh, vw)
    ab = _ext_planes(s, 2, rows4.device)
    p = s.params()
    _halo_launch("box_cols_ab", s, rows4.data_ptr(), vh.data_ptr(), vw.data_ptr(),
                 ab.data_ptr(), ctypes.byref(p))
    return ab


def cuda_halo_box_rows2(ab, vh, vw, s: HaloStatic):
    _check_cuda(ab, vh, vw)
    out = torch.empty_like(ab)
    p = s.params()
    _halo_launch("box_rows2", s, ab.data_ptr(), vh.data_ptr(), vw.data_ptr(),
                 out.data_ptr(), ctypes.byref(p))
    return out


def cuda_halo_tmap(t_core, guide_ext, rows2, vh, vw, s: HaloStatic):
    """The core's refined t (t_raw without refine) in the output dtype."""
    _check_cuda(t_core, guide_ext, vh, vw)
    t = torch.empty((s.N, s.h, s.w), dtype=s.out_dtype, device=t_core.device)
    p = s.params()
    _halo_launch("tmap", s, t_core.data_ptr(), guide_ext.data_ptr(), _ptr(rows2),
                 vh.data_ptr(), vw.data_ptr(), t.data_ptr(), ctypes.byref(p))
    return t


def halo_smem(s: HaloStatic) -> Tuple[int, int, int]:
    """Shared memory (bytes) of a block of the masked tiled sequence's
    ``tmap_tile``, ``guided_ab`` and ``refine_tmap`` (no wire rows; the
    sums' passes hold the mask counts)."""
    g, r, gr = _geometry(s), s.radius, s.gf_radius
    counts = 4 * g.count_ints(gr)
    return (4 * (g.th * g.run_stride(r) + g.in_floats(1, r) + g.count_ints(r)),
            4 * g.planes_and_runs(2, 4, gr) + counts,
            4 * g.refine_floats(s.refine, gr) + (counts if s.refine else 0))


def halo_tiled_fits(s: HaloStatic) -> bool:
    """Whether the halo stage runs its masked tiled sequence for ``s``
    (``fd_halo_tiled_fits``; launches nothing): every pass's block fits its
    shared memory and, at top-1, the list merge takes the tile keys. From
    the shape alone: radius <= 88 and, with refine, gf_radius <= 45. Past
    it the ten masked passes, which take any radius."""
    tmap, guided, refine = halo_smem(s)
    return (tmap <= MAX_SMEM and (not s.refine or guided <= MAX_SMEM)
            and refine <= MAX_SMEM
            and (s.topk > 1
                 or tile_count(*s.region_shape("tmap_tile"), s.tile) <= TOPK_MAX_TILES))


def halo_occupancy(s: HaloStatic) -> Tuple[int, int, int]:
    """Blocks an SM of the halo stage's ``tmap_tile``, ``guided_ab`` and
    ``refine_tmap`` for ``s`` (launches nothing)."""
    return _occupancy("fd_halo_occupancy", s)


def cuda_halo_tmap_tile(pre_ext, vh, vw, s: HaloStatic):
    """-> ``(t_raw on the extended plane, written on its tmap_tile region,
    its core (N, h, w), and at top-1 each region tile's smallest key of a
    core pixel under its core index, (N, tiles) int64; None at k > 1)``."""
    _check_cuda(pre_ext, vh, vw)
    dev = pre_ext.device
    t_ext = _ext_planes(s, 1, dev)[0]
    t_core = torch.empty((s.N, s.h, s.w), dtype=torch.float32, device=dev)
    keys = None
    if s.topk == 1:
        keys = torch.empty((s.N, tile_count(*s.region_shape("tmap_tile"), s.tile)),
                           dtype=torch.int64, device=dev)
    p = s.params()
    _halo_launch("tmap_tile", s, pre_ext.data_ptr(), vh.data_ptr(), vw.data_ptr(),
                 t_ext.data_ptr(), t_core.data_ptr(), _ptr(keys), ctypes.byref(p))
    return t_ext, t_core, keys


def cuda_halo_guided_ab(guide_ext, t_ext, vh, vw, s: HaloStatic):
    """-> the masked a and b, (2, N, h_ext, w_ext) float32, written on the
    ``guided_ab`` region."""
    _check_cuda(guide_ext, t_ext, vh, vw)
    ab = _ext_planes(s, 2, t_ext.device)
    p = s.params()
    _halo_launch("guided_ab", s, guide_ext.data_ptr(), t_ext.data_ptr(),
                 vh.data_ptr(), vw.data_ptr(), ab.data_ptr(), ctypes.byref(p))
    return ab


def cuda_halo_refine_tmap(t_core, guide_ext, ab, vh, vw, s: HaloStatic):
    """The core's refined t (t_raw without refine) in the output dtype."""
    _check_cuda(t_core, guide_ext, vh, vw)
    t = torch.empty((s.N, s.h, s.w), dtype=s.out_dtype, device=t_core.device)
    p = s.params()
    _halo_launch("refine_tmap", s, t_core.data_ptr(), guide_ext.data_ptr(), _ptr(ab),
                 vh.data_ptr(), vw.data_ptr(), t.data_ptr(), ctypes.byref(p))
    return t


def _valid_2d(vh, vw) -> torch.Tensor:
    return (vh != 0)[:, None] & (vw != 0)[None, :]


def _valid_count(v, r: int) -> torch.Tensor:
    """Windowed count of the valid entries of a validity vector."""
    return window_sum((v != 0).to(torch.float32)[None], r, -1)[0]


def _masked_count(vh, vw, s: HaloStatic) -> torch.Tensor:
    """(h_ext, w_ext) divisor max(rowcnt * colcnt, 1)."""
    r = s.gf_radius
    return torch.clamp_min(_valid_count(vh, r)[:, None]
                           * _valid_count(vw, r)[None, :], 1.0)


def plain_halo_min_rows(pre_ext, vh, vw, s: HaloStatic):
    k = 2 * s.radius + 1
    masked = torch.where(_valid_2d(vh, vw), pre_ext.to(torch.float32),
                         torch.full((), torch.inf, device=pre_ext.device))
    return -F.max_pool2d(-masked[:, None], (k, 1), stride=1,
                         padding=(s.radius, 0))[:, 0]


def plain_halo_min_cols_tmap(rows, s: HaloStatic):
    k = 2 * s.radius + 1
    dark = -F.max_pool2d(-rows[:, None], (1, k), stride=1,
                         padding=(0, s.radius))[:, 0]
    t_ext = ref.tmap_from_dark(dark, s.algorithm, s.omega, s.beta)
    return t_ext, s.core(t_ext).contiguous()


def plain_halo_topk_block(t_core, s: HaloStatic):
    return tile_keys(t_core, s.topk)


def plain_halo_topk_list(keys, img, s: HaloStatic):
    best = torch.sort(flip_key_order(keys.reshape(s.N, -1)), dim=-1
                      ).values[:, :s.topk]
    idx = key_index(best)
    x = ref.upcast_frames(img).reshape(s.N, -1, 3)
    rgb = torch.gather(x, 1, idx[..., None].expand(s.N, s.topk, 3))
    return key_t(best), rgb.to(s.out_dtype), idx.to(torch.int32)


def plain_halo_box_rows4(guide_ext, t_ext, vh, vw, s: HaloStatic):
    mask = _valid_2d(vh, vw)
    g = guide_ext.to(torch.float32)
    zero = torch.zeros((), device=g.device)
    # `where`, not multiply: t_raw is +-inf where a window has no valid pixel.
    return torch.stack([window_sum(torch.where(mask, v, zero), s.gf_radius, -2)
                        for v in (g, t_ext, g * t_ext, g * g)])


def plain_halo_box_cols_ab(rows4, vh, vw, s: HaloStatic):
    cnt = _masked_count(vh, vw, s)
    mean_g, mean_p, corr_gp, corr_gg = (window_sum(v, s.gf_radius, -1) / cnt
                                        for v in rows4)
    var_g = corr_gg - mean_g * mean_g
    cov_gp = corr_gp - mean_g * mean_p
    a = cov_gp / (var_g + s.gf_eps)
    return torch.stack([a, mean_p - a * mean_g])


def plain_halo_box_rows2(ab, vh, vw, s: HaloStatic):
    mask = _valid_2d(vh, vw)
    zero = torch.zeros((), device=ab.device)
    return torch.stack([window_sum(torch.where(mask, v, zero), s.gf_radius, -2)
                        for v in ab])


def plain_halo_tmap(t_core, guide_ext, rows2, vh, vw, s: HaloStatic):
    if not s.refine:
        return t_core.to(s.out_dtype)
    cnt = _masked_count(vh, vw, s)
    mean_a = window_sum(rows2[0], s.gf_radius, -1) / cnt
    mean_b = window_sum(rows2[1], s.gf_radius, -1) / cnt
    t = torch.clamp(mean_a * guide_ext.to(torch.float32) + mean_b, 0.0, 1.0)
    return s.core(t).to(s.out_dtype)


def halo_tile_keys(t_core: torch.Tensor, s: HaloStatic) -> torch.Tensor:
    """(N, h, w) core t -> each tile of ``tmap_tile``'s region of the
    extended plane, its smallest key of a core pixel under the core index,
    (N, tiles) in row-major tile order: bit for bit what ``halo_tmap_tile``
    writes at top-1 (all ones for a tile without a core pixel)."""
    ys, xs = s.region("tmap_tile")
    plane = torch.full((s.N, ys.stop - ys.start, xs.stop - xs.start), KEY_LAST,
                       dtype=torch.int64, device=t_core.device)
    y0, x0 = s.halo_h - ys.start, s.halo_w - xs.start
    plane[:, y0:y0 + s.h, x0:x0 + s.w] = topk_keys_signed(t_core).reshape(
        s.N, s.h, s.w)
    return _tile_min_keys(plane, s.tile)


def plain_halo_tmap_tile(pre_ext, vh, vw, s: HaloStatic):
    t_ext, t_core = plain_halo_min_cols_tmap(
        plain_halo_min_rows(pre_ext, vh, vw, s), s)
    return t_ext, t_core, (halo_tile_keys(t_core, s) if s.topk == 1 else None)


def plain_halo_guided_ab(guide_ext, t_ext, vh, vw, s: HaloStatic):
    return plain_halo_box_cols_ab(
        plain_halo_box_rows4(guide_ext, t_ext, vh, vw, s), vh, vw, s)


def plain_halo_refine_tmap(t_core, guide_ext, ab, vh, vw, s: HaloStatic):
    rows2 = plain_halo_box_rows2(ab, vh, vw, s) if s.refine else None
    return plain_halo_tmap(t_core, guide_ext, rows2, vh, vw, s)


HALO_CUDA_PASSES: Passes = {name: globals()[f"cuda_halo_{name}"]
                            for name in HALO_PASSES}
HALO_PLAIN_PASSES: Passes = {name: globals()[f"plain_halo_{name}"]
                             for name in HALO_PASSES}
TILED_HALO_CUDA_PASSES: Passes = {name: globals()[f"cuda_halo_{name}"]
                                  for name in TILED_HALO_PASSES}
TILED_HALO_PLAIN_PASSES: Passes = {name: globals()[f"plain_halo_{name}"]
                                   for name in TILED_HALO_PASSES}


def run_tiled_halo_passes(img, pre_ext, guide_ext, vh, vw, s: HaloStatic,
                          passes: Passes = TILED_HALO_CUDA_PASSES):
    """The halo stage's masked tiled sequence, through ``passes``: core
    frames (N, h, w, 3), extended planes (N, h_ext, w_ext) and validity
    bytes (h_ext,), (w_ext,) -> ``(t (N, h, w), tk_t (N, k), tk_rgb
    (N, k, 3), tk_idx (N, k))``."""
    t_ext, t_core, keys = passes["tmap_tile"](pre_ext, vh, vw, s)
    if s.topk > 1:
        keys = passes["topk_block"](t_core, s)
    tk_t, tk_rgb, tk_idx = passes["topk_list"](keys, img, s)
    ab = passes["guided_ab"](guide_ext, t_ext, vh, vw, s) if s.refine else None
    t = passes["refine_tmap"](t_core, guide_ext, ab, vh, vw, s)
    return t, tk_t, tk_rgb, tk_idx


def run_halo_passes(img, pre_ext, guide_ext, vh, vw, s: HaloStatic,
                    passes: Passes = HALO_CUDA_PASSES):
    """The halo stage's ten masked passes, through ``passes``: the same
    arguments and outputs as :func:`run_tiled_halo_passes`, bit for bit,
    for windows of any width."""
    rows = passes["min_rows"](pre_ext, vh, vw, s)
    t_ext, t_core = passes["min_cols_tmap"](rows, s)
    tk_t, tk_rgb, tk_idx = passes["topk_list"](
        passes["topk_block"](t_core, s), img, s)
    rows2 = None
    if s.refine:
        rows4 = passes["box_rows4"](guide_ext, t_ext, vh, vw, s)
        ab = passes["box_cols_ab"](rows4, vh, vw, s)
        rows2 = passes["box_rows2"](ab, vh, vw, s)
    t = passes["tmap"](t_core, guide_ext, rows2, vh, vw, s)
    return t, tk_t, tk_rgb, tk_idx


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def fused_dehaze_lanes(img: torch.Tensor, frame_ids: torch.Tensor,
                       carry_f: torch.Tensor, carry_i: torch.Tensor, *,
                       algorithm: str = "dcp", radius: int,
                       omega: float = 0.95, beta: float = 1.0,
                       cap_w: Sequence[float] = ref.CAP_COEFFS,
                       refine: bool, gf_radius: int, gf_eps: float,
                       t0: float, gamma: float, period: int, lam: float,
                       topk: int = 1, out_dtype: Optional[str] = None,
                       out: Optional[torch.Tensor] = None,
                       tile: str = DEFAULT_TILE,
                       blocks_per_sm: int = BLOCKS_PER_SM[0],
                       lane_major: bool = True):
    """Lane-native dehaze of L streams: (L, B, H, W, 3) wire frames, (L, B)
    ids (< 0 = padding), carry rows ``carry_f (L, 3)`` f32 / ``carry_i
    (L, 2)`` int32 -> ``(J, t, a_seq (L, B, 3) f32, carry_f', carry_i')``
    with J/t in ``ref.resolve_out_dtype(img.dtype, out_dtype)``. J goes
    into ``out`` where given, which may be ``img`` itself where the dtypes
    agree (buffer donation). ``tile``, ``blocks_per_sm`` and
    ``lane_major`` are the tiled passes' knobs (:data:`TILES`,
    :data:`BLOCKS_PER_SM`; the plane order), checked on any device.

    CPU tensors run the plain version; CUDA tensors run the kernels (built
    at first use, the knobs' library variant) or raise: the tiled passes,
    or the ten passes where a window's halo does not fit a block
    (:func:`tiled_fits`)."""
    kw = dict(algorithm=algorithm, radius=radius, omega=omega, beta=beta,
              cap_w=cap_w, refine=refine, gf_radius=gf_radius, gf_eps=gf_eps,
              t0=t0, gamma=gamma, period=period, lam=lam, topk=topk,
              out_dtype=out_dtype)
    s = make_static(img, tile=tile, blocks_per_sm=blocks_per_sm,
                    lane_major=lane_major, **kw)
    if frame_ids.shape != (s.L, s.B):
        raise ValueError(f"frame_ids {tuple(frame_ids.shape)} != (L, B) = "
                         f"{(s.L, s.B)}")
    if carry_f.shape != (s.L, 3) or carry_i.shape != (s.L, 2):
        raise ValueError("carry rows must be (L, 3) and (L, 2)")
    if img.device.type == "cpu":
        return ref.fused_dehaze_lanes(img, frame_ids, carry_f, carry_i,
                                      out=None if out is None
                                      else _j_out(s, img.device, out), **kw)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    _check_cuda(img)
    dev = img.device
    ids = frame_ids.to(device=dev, dtype=torch.int32).contiguous()
    cf = carry_f.to(device=dev, dtype=torch.float32).contiguous()
    ci = carry_i.to(device=dev, dtype=torch.int32).contiguous()
    run = run_tiled_passes if tiled_fits(s) else run_passes
    return run(img, ids, cf, ci, s, out=out)


def fused_dehaze(img: torch.Tensor, frame_ids: torch.Tensor,
                 A_saved: torch.Tensor, last_update: torch.Tensor,
                 initialized: torch.Tensor, out=None, **kw):
    """Single stream, the L=1 view of :func:`fused_dehaze_lanes`:
    (B, H, W, 3) -> ``(J, t, a_seq (B, 3), A_fin (3,), k_fin ())``."""
    dev = img.device
    carry_f = A_saved.to(device=dev, dtype=torch.float32).reshape(1, 3)
    carry_i = torch.stack([last_update.to(device=dev, dtype=torch.int32),
                           initialized.to(device=dev, dtype=torch.int32)]
                          ).reshape(1, 2)
    J, t, a_seq, cf, ci = fused_dehaze_lanes(
        img[None], frame_ids.reshape(1, -1), carry_f, carry_i,
        out=None if out is None else out[None], **kw)
    return J[0], t[0], a_seq[0], cf[0], ci[0, 0]


# Back-compat alias (the reference's first name of the DCP-only kernel).
fused_dehaze_dcp = fused_dehaze


def fused_transmission_lanes(img: torch.Tensor, A_saved: torch.Tensor, *,
                             algorithm: str = "dcp", radius: int,
                             omega: float = 0.95, beta: float = 1.0,
                             cap_w: Sequence[float] = ref.CAP_COEFFS,
                             refine: bool, gf_radius: int, gf_eps: float,
                             topk: int = 1, out_dtype: Optional[str] = None):
    """The fused transmission stage of L lanes: (L, B, H, W, 3) wire frames
    and per-lane saved A (L, 3) -> ``(t (L, B, H, W), t_min (L, B) float32,
    cand (L, B, 3))``, t and cand in ``ref.resolve_out_dtype(img.dtype,
    out_dtype)``; frame row i of the flat L*B batch reads lane i // B's A.

    CPU tensors run the plain version; CUDA tensors run the kernels (built
    at first use) or raise: :func:`run_transmission`."""
    kw = dict(algorithm=algorithm, radius=radius, omega=omega, beta=beta,
              cap_w=cap_w, refine=refine, gf_radius=gf_radius, gf_eps=gf_eps,
              topk=topk, out_dtype=out_dtype)
    # The EMA and recovery constants do not reach the stage's passes.
    s = make_static(img, t0=0.1, gamma=1.0, period=1, lam=0.0, **kw)
    if tuple(A_saved.shape) != (s.L, 3):
        raise ValueError(f"A_saved {tuple(A_saved.shape)} != (L, 3) = "
                         f"{(s.L, 3)}")
    if img.device.type == "cpu":
        return ref.fused_transmission_lanes(img, A_saved, **kw)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    _check_cuda(img)
    a = A_saved.to(device=img.device, dtype=torch.float32).contiguous()
    return run_transmission(img, a, s)


def run_transmission(img, a_saved, s: Static):
    """The transmission stage on the card: the tiled sequence where
    :func:`transmission_tiled_fits`, else the ten passes, chosen from the
    static shape before anything launches."""
    run = (run_tiled_transmission_passes if transmission_tiled_fits(s)
           else run_transmission_passes)
    return run(img, a_saved, s)


def fused_transmission(img: torch.Tensor, A_saved: torch.Tensor, **kw):
    """One stream, the L=1 view of :func:`fused_transmission_lanes`:
    (B, H, W, 3) frames, saved A (3,) -> ``(t (B, H, W), t_min (B,),
    cand (B, 3))``."""
    t, t_min, cand = fused_transmission_lanes(img[None], A_saved.reshape(1, 3),
                                              **kw)
    return t[0], t_min[0], cand[0]


def fused_transmission_halo(img: torch.Tensor, pre_ext: torch.Tensor,
                            guide_ext: torch.Tensor, valid: torch.Tensor,
                            valid_w: Optional[torch.Tensor] = None, *,
                            algorithm: str = "dcp", radius: int,
                            omega: float = 0.95, beta: float = 1.0,
                            refine: bool, gf_radius: int, gf_eps: float,
                            topk: int = 1, out_dtype: Optional[str] = None,
                            tile: str = DEFAULT_TILE,
                            blocks_per_sm: int = BLOCKS_PER_SM[0]):
    """One spatial shard's transmission stage: (N, h, w, 3) core frames in
    any wire dtype, (N, h_ext, w_ext) pre-map and luma planes (float32 or
    bfloat16), (h_ext,) row validity and (w_ext,) column validity (None:
    all valid) -> ``(t (N, h, w), tk_t (N, k) float32, tk_rgb (N, k, 3),
    tk_idx (N, k) int32)``, the k smallest (t_raw, local flat index) of the
    core, ascending; t and tk_rgb in ``ref.resolve_out_dtype(img.dtype,
    out_dtype)``. ``tile`` and ``blocks_per_sm`` are the tiled passes'
    knobs, as for :func:`fused_dehaze_lanes`.

    CPU tensors run the plain version (``kernels.ref``); CUDA tensors run
    the kernels (built at first use) or raise: :func:`run_halo`."""
    kw = dict(algorithm=algorithm, radius=radius, omega=omega, beta=beta,
              refine=refine, gf_radius=gf_radius, gf_eps=gf_eps, topk=topk,
              out_dtype=out_dtype)
    s = make_halo_static(img, pre_ext, guide_ext, tile=tile,
                         blocks_per_sm=blocks_per_sm, **kw)
    if img.device.type == "cpu":
        return ref.fused_transmission_halo(img, pre_ext, guide_ext, valid,
                                           valid_w, **kw)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    _check_cuda(img, pre_ext, guide_ext)
    vh = validity_bytes(valid, s.h_ext, img.device)
    vw = validity_bytes(valid_w, s.w_ext, img.device)
    return run_halo(img, pre_ext, guide_ext, vh, vw, s)


def run_halo(img, pre_ext, guide_ext, vh, vw, s: HaloStatic):
    """The halo stage on the card: the masked tiled sequence where
    :func:`halo_tiled_fits`, else the ten masked passes, chosen from the
    static shape before anything launches."""
    run = run_tiled_halo_passes if halo_tiled_fits(s) else run_halo_passes
    return run(img, pre_ext, guide_ext, vh, vw, s)
