"""The staged component kernels on Hopper: wrappers and plain versions.

The chain ``kernel_mode="auto"`` runs (the ``pallas`` substrate of the JAX
package): the paper's three components as separate kernels, with the
guided filter composed from box filters in ``kernels.ops``. One section per
JAX module, each porting one Pallas kernel to ``csrc/staged.cu``:

  dark channel      ``kernels/dark_channel.py::dark_channel_pallas``
  min filter        ``kernels/dark_channel.py::min_filter_2d_pallas`` (CAP)
  box filter        ``kernels/boxfilter.py::box_filter_2d_pallas``
  atmospheric light ``kernels/atmolight.py::atmolight_pallas`` (top-1)
  top-k light       ``kernels/atmolight.py::atmolight_topk_pallas`` (k > 1)
  recover           ``kernels/recover.py::recover_pallas``

and the spatially sharded step's kernels:

  masked min filter ``kernels/dark_channel.py::masked_min_filter_2d_pallas``
  masked box filter ``kernels/boxfilter.py::masked_box_filter_2d_pallas``
  top-k merge       ``kernels/atmolight.py::merge_topk_pallas``

and the state sync of every step whose §3.3 EMA ran in PyTorch ops:

  merge and EMA     ``kernels/atmolight.py::merge_topk_pallas`` with
                    ``core/normalize.py::ema_scan`` / ``ema_scan_associative``

For each, ``cuda_<name>`` launches the hand-written kernel on CUDA tensors
(built at first use; a failed build or launch raises) and adds one to
:data:`launches`; the window kernels (the dark channel, the min and box
filters and their masked forms) past their window strips' radius, and the
top-k light past the warp top-k's k, take a second route (the row window,
the block rounds), chosen from the shape before the launch and also
counted in :data:`wide_launches`;
``plain_<name>`` is a plain PyTorch version that follows
the Pallas kernel's arithmetic (upcast to float32, compute, one cast at the
end, the Pallas kernel's output dtype); ``<name>_op`` takes a CPU tensor
to the plain version and any other to the kernel. Nothing falls back from
one to the other.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch
import torch.nn.functional as F

SOURCE = "staged.cu"

#: The staged chain's kernels, and the spatially sharded step's.
KERNELS = ("dark_channel", "min_filter", "box_filter", "atmolight",
           "atmolight_topk", "recover")
SPATIAL_KERNELS = ("masked_min_filter", "masked_box_filter", "merge_topk")
#: The state sync (the candidate rows' merge and the §3.3 EMA in one
#: kernel), which ends the staged chain's steps, the sharded steps and the
#: spatial steps alike.
STATE_KERNELS = ("merge_ema",)

#: Kernel launches since the last :func:`reset_launches`, by kernel.
launches: Dict[str, int] = {name: 0 for name in
                            KERNELS + SPATIAL_KERNELS + STATE_KERNELS}

#: Of those, the launches of the route past the new kernels' limits: the
#: window kernels' row window, for radii the strips do not take
#: (:func:`strips_fit`), and the top-k light's block rounds, for k the
#: warp top-k does not take (:func:`warp_topk_fits`).
wide_launches: Dict[str, int] = {"dark_channel": 0, "min_filter": 0,
                                 "box_filter": 0, "atmolight_topk": 0,
                                 "masked_min_filter": 0,
                                 "masked_box_filter": 0}

#: Output tile of a row-window block and the shared memory a block may use
#: (``kTileX``/``kTileY``/``kMaxSmem`` in the CUDA sources, checked at load).
TILE_X, TILE_Y, MAX_SMEM = 32, 64, 232448

#: The window strips of the dark channel, the min and box filters and
#: their masked forms: output columns of a strip, input rows staged at a
#: time, most output rows of a band (the box filters', the dark channel's,
#: the min filters'), the horizontal sums' row stride and the vertical run
#: (``kStripW``/``kPieceRows``/``kBandRows``/``kDarkBandRows``/
#: ``kMinBandRows`` in the CUDA source, checked at load;
#: ``kSumStride``/``kRunY`` enter :func:`strip_smem`).
STRIP_W, PIECE_ROWS = 64, 32
BAND_ROWS, DARK_BAND_ROWS, MIN_BAND_ROWS = 128, 64, 128
_SUM_STRIDE, _RUN_Y = STRIP_W + 1, 8

#: The kernels that run as window strips, and each one's code in
#: ``st_strips_fit`` / ``st_strips_occupancy`` / ``st_window_occupancy``.
STRIP_KINDS = {"box_filter": 0, "dark_channel": 1, "min_filter": 2,
               "masked_box_filter": 3, "masked_min_filter": 4}

#: Pixels a top-k tile and tiles a frame the top-k merge takes
#: (``kTopkTile``/``kTopkMaxLists`` in ``csrc/dehaze_common.cuh``, checked
#: at load by this module and by ``kernels.fused``).
TOPK_TILE, TOPK_MAX_TILES = 2048, 8192

#: Contiguous pixels a tile of the top-1 atmospheric light reduces to one
#: key, and of the warp top-k to its k smallest, by default (``kTop1Tile``
#: in the CUDA source, checked at load).
TOP1_TILE = 4096

#: The tiles the two take, default first: their tuning knob
#: ``tile_pixels`` (``kernels.tuning``, ops ``atmolight`` and
#: ``atmolight_topk``), a template parameter of their tile kernels. No tile
#: changes an output bit.
TOP1_TILES = (TOP1_TILE, 2048, 8192)

#: The largest k the warp top-k takes (``kWarpTopkMax``, checked at load):
#: each lane keeps its pixels' k smallest keys in registers (lists of 2, 4,
#: 8 or 16), so k is bounded by the registers a lane can give them.
WARP_TOPK_MAX = 16

#: The largest k the merge-and-EMA kernel takes (``kMergeEmaMaxK``, checked
#: at load): each warp keeps a frame's k picks in shared memory.
MERGE_EMA_MAX_K = 1024

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


#: Taken around every update of the counters: serve, warm-up and fleet
#: host threads launch at once, and ``+= 1`` on a dict entry is a read and
#: a write that two threads can interleave.
launch_lock = threading.Lock()


def reset_launches() -> None:
    with launch_lock:
        for counts in (launches, wide_launches):
            for k in counts:
                counts[k] = 0


# ---------------------------------------------------------------------------
# Build, bind, launch
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/staged.cu``."""
    global _lib_handle
    if _lib_handle is None:
        from repro_torch.kernels import _build
        lib = _build.load(SOURCE)
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        sigs = {
            "st_dark_channel": [vp, vp, i, i, i, i, i, vp],
            "st_dark_channel_wide": [vp, vp, i, i, i, i, i, vp],
            "st_min_filter": [vp, vp, i, i, i, i, i, vp],
            "st_min_filter_wide": [vp, vp, i, i, i, i, i, vp],
            "st_box_filter": [vp, vp, i, i, i, i, i, vp],
            "st_box_filter_wide": [vp, vp, i, i, i, i, i, vp],
            "st_atmolight": [vp, vp, vp, vp, i, i, i, i, i, i, vp],
            "st_atmolight_topk": [vp, vp, vp, vp, i, i, i, i, i, i, i, vp],
            "st_atmolight_topk_wide": [vp, vp, vp, vp, i, i, i, i, i, i, vp],
            "st_recover": [vp, vp, vp, vp, i, i, i, f, f, i, i, i, vp],
            "st_masked_min_filter": [vp, vp, vp, vp, i, i, i, i, i, vp],
            "st_masked_min_filter_wide": [vp, vp, vp, vp, i, i, i, i, i, vp],
            "st_masked_box_filter": [vp, vp, vp, vp, i, i, i, i, i, vp],
            "st_masked_box_filter_wide": [vp, vp, vp, vp, i, i, i, i, i, vp],
            "st_merge_topk": [vp, vp, vp, vp, vp, i, i, i, vp],
            "st_merge_ema": [vp] * 11 + [i, i, i, i, i, f, f, i, vp],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.st_strips_fit.argtypes = [i, i, i]
        lib.st_strips_fit.restype = ctypes.c_int
        lib.st_strips_occupancy.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        lib.st_window_occupancy.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.st_topk_occupancy.argtypes = [i, ctypes.POINTER(i)]
        for name in ("st_strips_occupancy", "st_window_occupancy",
                     "st_topk_occupancy"):
            getattr(lib, name).restype = ctypes.c_int
        consts = ("st_tile_x", "st_tile_y", "st_max_smem", "st_topk_tile",
                  "st_topk_max_tiles", "st_top1_tile", "st_strip_w",
                  "st_piece_rows", "st_band_rows", "st_dark_band_rows",
                  "st_min_band_rows", "st_warp_topk_max", "st_merge_ema_max_k")
        for name in consts:
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        got = tuple(getattr(lib, name)() for name in consts)
        want = (TILE_X, TILE_Y, MAX_SMEM, TOPK_TILE, TOPK_MAX_TILES, TOP1_TILE,
                STRIP_W, PIECE_ROWS, BAND_ROWS, DARK_BAND_ROWS, MIN_BAND_ROWS,
                WARP_TOPK_MAX, MERGE_EMA_MAX_K)
        if got != want:
            raise RuntimeError(f"{SOURCE} constants {got}, expected {want}")
        _lib_handle = lib
    return _lib_handle


def _launch(name: str, *args, wide: bool = False) -> None:
    """Call ``st_<name>`` (``st_<name>_wide`` where ``wide``) on the current
    stream; count it; raise on a non-zero cudaError_t."""
    entry = f"st_{name}_wide" if wide else f"st_{name}"
    rc = getattr(_lib(), entry)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed: cudaError_t {rc}")
    with launch_lock:
        launches[name] += 1
        if wide:
            wide_launches[name] += 1


def _check_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def _dtype_code(t: torch.Tensor) -> int:
    try:
        return _DTYPES[t.dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {t.dtype}; the staged kernels "
                         "take float32 or bfloat16") from None


def _check_sizes(n: int, h: int, w: int) -> None:
    if min(n, h, w) < 1 or n > 65535 or h * w >= 2 ** 32:
        raise ValueError(f"(N, H, W) = {(n, h, w)} outside the kernels' "
                         "range (1 <= N <= 65535, 1 <= H*W < 2**32)")


def _check_frames(img: torch.Tensor) -> None:
    if img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) frames, got {tuple(img.shape)}")
    _check_sizes(*img.shape[:3])


def _check_window(h: int, radius: int) -> None:
    """The radii the window kernels take: any whose row-window tile fits a
    block, min(TILE_Y + 2r, H) x TILE_X float32 (r up to 875 on frames of
    1816 rows or more, any r on shorter ones). Each window kernel runs the
    strips where :func:`strips_fit`, which holds only for radii the row
    window also takes, and the row window past them."""
    if radius < 0:
        raise ValueError("window radius must be >= 0")
    if min(TILE_Y + 2 * radius, h) * TILE_X * 4 > MAX_SMEM:
        raise ValueError(f"radius {radius} over {h} rows needs more shared "
                         f"memory than a block has ({MAX_SMEM} bytes)")


def strip_smem(radius: int, kind: str, dtype: torch.dtype) -> int:
    """Shared memory of a window-strip block of the tallest band of
    ``kind`` (a key of :data:`STRIP_KINDS`; ``strip_smem`` in the CUDA
    source): a piece in float32 at an odd row stride (two for the float32
    box and min filters and their masked forms, copied straight in while
    the other is used), then the band's horizontal sums, with room for a
    last vertical run past the band's end; the masked forms then the int
    prefix counts of the strip's valid input columns and the band's valid
    input rows and their validity bytes."""
    band = (DARK_BAND_ROWS if kind == "dark_channel" else
            MIN_BAND_ROWS if kind.endswith("min_filter") else BAND_ROWS)
    cols, rows = STRIP_W + 2 * radius, band + 2 * radius
    pieces = 2 if kind != "dark_channel" and dtype == torch.float32 else 1
    smem = (pieces * 4 * PIECE_ROWS * (cols | 1)
            + 4 * (rows + _RUN_Y - 1) * _SUM_STRIDE)
    if kind.startswith("masked_"):
        smem += 4 * (cols + 1) + 4 * (rows + 1) + cols + rows
    return smem


def strips_fit(kind: str, radius: int, dtype: torch.dtype) -> bool:
    """Whether the window strips take the kernel ``kind`` (a key of
    :data:`STRIP_KINDS`) at this radius on ``dtype`` planes
    (``st_strips_fit``): a block of the tallest band fits its shared
    memory. From the shape alone, before any launch: r <= 175 (box and min
    filters, float32), 243 (bfloat16), 170 and 236 (their masked forms),
    265 (dark channel). Past it the wrappers launch the row-window
    kernel."""
    return radius >= 0 and strip_smem(radius, kind, dtype) <= MAX_SMEM


def _occupancy(entry: str, *args) -> int:
    blocks = ctypes.c_int()
    rc = getattr(_lib(), entry)(*args, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{entry} failed: cudaError_t {rc}")
    return blocks.value


def strips_occupancy(kind: str, radius: int, dtype: torch.dtype,
                     h: int) -> int:
    """Blocks an SM of the strips of ``kind`` on frames of ``h`` rows, from
    the card's occupancy calculator (launches nothing)."""
    return _occupancy("st_strips_occupancy", STRIP_KINDS[kind], radius,
                      _DTYPES[dtype], h)


def window_occupancy(radius: int, h: int, kind: str = "min_filter") -> int:
    """Blocks an SM of the row window of ``kind`` (a key of
    :data:`STRIP_KINDS`) on frames of ``h`` rows."""
    return _occupancy("st_window_occupancy", STRIP_KINDS[kind], radius, h)


def topk_occupancy(k: int) -> int:
    """Blocks an SM of the top-k light's tile kernel on the route of k
    (:func:`warp_topk_fits`)."""
    return _occupancy("st_topk_occupancy", k)


def _on_kernel(x: torch.Tensor) -> bool:
    """CPU tensors take the plain version (the caller asked for the CPU);
    every other tensor takes the kernel, which raises off CUDA."""
    return x.device.type != "cpu"


# ---------------------------------------------------------------------------
# Window sums (the plain box filter; also the megakernel's plain passes)
# ---------------------------------------------------------------------------

def window_sum(v: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Sum over the clipped window of radius r along dim -2 or -1."""
    pad = (0, 0, r, r) if dim == -2 else (r, r)
    return F.pad(v, pad).unfold(dim, 2 * r + 1, 1).sum(-1)


def window_counts(h: int, w: int, r: int, device) -> torch.Tensor:
    """(H, W) closed-form in-bounds counts of the clipped (2r+1)² window."""
    def axis(n):
        i = torch.arange(n, device=device)
        return (torch.clamp_max(i + r, n - 1) - torch.clamp_min(i - r, 0)
                + 1).to(torch.float32)
    return axis(h)[:, None] * axis(w)[None, :]


# ---------------------------------------------------------------------------
# Order-preserving (t, flat index) keys (the plain side of make_key in
# csrc/dehaze_common.cuh; also the megakernel's plain top-k passes)
# ---------------------------------------------------------------------------

_LOW32 = 0xFFFFFFFF
_I64_MIN = torch.iinfo(torch.int64).min

# The signed-order key after every pixel's key: the kernel's all-ones
# unsigned key, which pads a tile's list past its pixels.
KEY_LAST = torch.iinfo(torch.int64).max


def topk_keys_signed(t_raw: torch.Tensor) -> torch.Tensor:
    """(N, H, W) t -> (N, H*W) int64 keys in *signed* order: the kernel's
    unsigned key ``(ordered bits of t) << 32 | flat index`` with its top
    bit flipped, so int64 comparison is the kernel's unsigned comparison
    (smallest t first, ties to the lowest index)."""
    n = t_raw.shape[0]
    flat = t_raw.reshape(n, -1).to(torch.float32)
    flat = torch.where(flat == 0, torch.zeros_like(flat), flat)   # -0 == +0
    u = flat.contiguous().view(torch.int32).to(torch.int64) & _LOW32
    ordered = torch.where(u >= 2 ** 31, _LOW32 - u, u + 2 ** 31)
    idx = torch.arange(flat.shape[1], device=flat.device)
    return (ordered - 2 ** 31) * 2 ** 32 + idx


def flip_key_order(keys: torch.Tensor) -> torch.Tensor:
    """Signed-order keys <-> the kernel's unsigned keys held in int64 (the
    top bit flipped; its own inverse)."""
    return keys ^ _I64_MIN


def key_index(keys: torch.Tensor) -> torch.Tensor:
    """Flat pixel index of signed-order keys."""
    return keys & _LOW32


def key_t(keys: torch.Tensor) -> torch.Tensor:
    """float32 t of signed-order keys (``key_to_t`` of the CUDA header:
    -0.0 comes back as +0.0)."""
    ordered = (keys >> 32) + 2 ** 31
    u = torch.where(ordered >= 2 ** 31, ordered - 2 ** 31, _LOW32 - ordered)
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def topk_select(t_raw: torch.Tensor, k: int) -> torch.Tensor:
    """(N, H, W) t -> (N, k) signed-order keys of the k smallest (t, flat
    index), ascending: the selection of ``atmolight.topk_select`` and
    ``lax.top_k(-t, k)``."""
    return torch.sort(topk_keys_signed(t_raw), dim=-1).values[:, :k]


def topk_mean(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, P, 3) pixels, (N, k) picks -> (N, 3) float32: the mean over the
    picks, summed in float64 and rounded once, so it is within half a
    float32 step of the exact mean for any k (the kernels' compensated
    float32 sum stays within a few steps of it)."""
    n, k = idx.shape
    picked = torch.gather(x, 1, idx[..., None].expand(n, k, 3))
    return picked.to(torch.float64).mean(1).to(torch.float32)


# ---------------------------------------------------------------------------
# Dark channel (dark_channel.py::dark_channel_pallas)
# ---------------------------------------------------------------------------

def cuda_dark_channel(img: torch.Tensor, radius: int) -> torch.Tensor:
    _check_frames(img)
    _check_cuda(img)
    dt = _dtype_code(img)
    n, h, w, _ = img.shape
    _check_window(h, radius)
    out = torch.empty((n, h, w), dtype=img.dtype, device=img.device)
    _launch("dark_channel", img.data_ptr(), out.data_ptr(), n, h, w, radius, dt,
            wide=not strips_fit("dark_channel", radius, img.dtype))
    return out


def plain_dark_channel(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Channel min, then the (2r+1)² windowed min with +inf border."""
    _check_frames(img)
    _dtype_code(img)
    v = img.to(torch.float32).amin(-1)[:, None]
    k = 2 * radius + 1
    return (-F.max_pool2d(-v, k, stride=1, padding=radius))[:, 0].to(img.dtype)


def dark_channel_op(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, H, W, 3) -> (N, H, W) in the input dtype."""
    return (cuda_dark_channel if _on_kernel(img)
            else plain_dark_channel)(img, radius)


def _check_plane(x: torch.Tensor) -> None:
    if x.dim() != 3:
        raise ValueError(f"expected (N, H, W) planes, got {tuple(x.shape)}")
    _check_sizes(*x.shape)


# ---------------------------------------------------------------------------
# Min filter (dark_channel.py::min_filter_2d_pallas), staged CAP
# ---------------------------------------------------------------------------

def cuda_min_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    _check_plane(x)
    _check_cuda(x)
    dt = _dtype_code(x)
    n, h, w = x.shape
    _check_window(h, radius)
    out = torch.empty_like(x)
    _launch("min_filter", x.data_ptr(), out.data_ptr(), n, h, w, radius, dt,
            wide=not strips_fit("min_filter", radius, x.dtype))
    return out


def plain_min_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    """The (2r+1)² windowed min with +inf border, in float32, cast back."""
    _check_plane(x)
    _dtype_code(x)
    k = 2 * radius + 1
    v = x.to(torch.float32)[:, None]
    return (-F.max_pool2d(-v, k, stride=1, padding=radius))[:, 0].to(x.dtype)


def min_filter_op(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, H, W) -> (N, H, W) windowed min in the input dtype."""
    return (cuda_min_filter if _on_kernel(x) else plain_min_filter)(x, radius)


# ---------------------------------------------------------------------------
# Box filter (boxfilter.py::box_filter_2d_pallas)
# ---------------------------------------------------------------------------


def cuda_box_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    _check_plane(x)
    _check_cuda(x)
    dt = _dtype_code(x)
    n, h, w = x.shape
    _check_window(h, radius)
    out = torch.empty_like(x)
    _launch("box_filter", x.data_ptr(), out.data_ptr(), n, h, w, radius, dt,
            wide=not strips_fit("box_filter", radius, x.dtype))
    return out


def ascending_window_sum(v: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Sum over the window of radius r along dim -2 or -1, zero-padded, as
    the kernels add it: from a +0 plane, one shifted slice at a time in
    ascending order. A +0 term leaves a sum from +0 unchanged, so this is
    the clipped window's ascending sum bit for bit."""
    n = v.shape[dim]
    p = F.pad(v, (0, 0, r, r) if dim == -2 else (r, r))
    s = torch.zeros_like(v)
    for k in range(2 * r + 1):
        s = s + p.narrow(dim, k, n)
    return s


def plain_box_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Direct sums over the clipped window in the kernel's order
    (horizontal, then vertical, each ascending from +0) divided by the
    closed-form in-bounds count: the kernel's result bit for bit."""
    _check_plane(x)
    _dtype_code(x)
    v = x.to(torch.float32)
    s = ascending_window_sum(ascending_window_sum(v, radius, -1), radius, -2)
    cnt = window_counts(x.shape[1], x.shape[2], radius, x.device)
    return (s / cnt).to(x.dtype)


def box_filter_op(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, H, W) -> (N, H, W) windowed mean in the input dtype."""
    return (cuda_box_filter if _on_kernel(x) else plain_box_filter)(x, radius)


# ---------------------------------------------------------------------------
# Atmospheric light, top-1 (atmolight.py::atmolight_pallas)
# ---------------------------------------------------------------------------

def _check_pair(img: torch.Tensor, t: torch.Tensor) -> None:
    _check_frames(img)
    if tuple(t.shape) != tuple(img.shape[:-1]):
        raise ValueError(f"t {tuple(t.shape)} does not match frames "
                         f"{tuple(img.shape)}")
    _dtype_code(img)
    _dtype_code(t)


def check_tile_pixels(tile_pixels: int) -> None:
    """Raise ``ValueError`` naming a tile the atmospheric light's kernels do
    not take (:data:`TOP1_TILES`)."""
    if tile_pixels not in TOP1_TILES:
        raise ValueError(f"tile_pixels={tile_pixels!r}: the atmospheric "
                         f"light's tiles are {list(TOP1_TILES)}")


def cuda_atmolight(img: torch.Tensor, t_raw: torch.Tensor,
                   tile_pixels: int = TOP1_TILE) -> torch.Tensor:
    _check_pair(img, t_raw)
    check_tile_pixels(tile_pixels)
    _check_cuda(img, t_raw)
    n, h, w, _ = img.shape
    keys = torch.empty((n, -(-(h * w) // tile_pixels)), dtype=torch.int64,
                       device=img.device)
    out = torch.empty((n, 3), dtype=img.dtype, device=img.device)
    _launch("atmolight", img.data_ptr(), t_raw.data_ptr(), keys.data_ptr(),
            out.data_ptr(), n, h, w, _dtype_code(img), _dtype_code(t_raw),
            tile_pixels)
    return out


def plain_atmolight(img: torch.Tensor, t_raw: torch.Tensor,
                    tile_pixels: int = TOP1_TILE) -> torch.Tensor:
    """I at the per-frame argmin of t (first index on ties; -0.0 == +0.0),
    which no tile changes (``tile_pixels`` is checked, as the kernel's)."""
    _check_pair(img, t_raw)
    check_tile_pixels(tile_pixels)
    n = img.shape[0]
    j = t_raw.to(torch.float32).reshape(n, -1).argmin(-1)
    x = img.to(torch.float32).reshape(n, -1, 3)
    return x[torch.arange(n, device=img.device), j].to(img.dtype)


def atmolight_op(img: torch.Tensor, t_raw: torch.Tensor,
                 tile_pixels: int = TOP1_TILE) -> torch.Tensor:
    """(N, H, W, 3), (N, H, W) -> (N, 3) in the frames' dtype; the kernel
    reduces tiles of ``tile_pixels``."""
    return (cuda_atmolight if _on_kernel(img) else plain_atmolight)(
        img, t_raw, tile_pixels)


# ---------------------------------------------------------------------------
# Atmospheric light, top-k (atmolight.py::atmolight_topk_pallas)
# ---------------------------------------------------------------------------

def _check_topk(img: torch.Tensor, t: torch.Tensor, k: int) -> None:
    _check_pair(img, t)
    p = img.shape[1] * img.shape[2]
    if not 1 <= k <= p:
        raise ValueError(f"k={k} outside [1, H*W={p}]")
    if -(-p // TOPK_TILE) > TOPK_MAX_TILES:
        raise ValueError(f"H*W={p} needs more than {TOPK_MAX_TILES} top-k "
                         f"tiles of {TOPK_TILE} pixels")


def warp_topk_fits(k: int) -> bool:
    """Whether the warp top-k takes k (1 <= k <= :data:`WARP_TOPK_MAX`),
    from k alone, before any launch; past it the wrapper launches the
    block rounds of ``csrc/dehaze_common.cuh``, which take any k up to
    H*W."""
    return 1 <= k <= WARP_TOPK_MAX


def cuda_atmolight_topk(img: torch.Tensor, t_raw: torch.Tensor,
                        k: int, tile_pixels: int = TOP1_TILE) -> torch.Tensor:
    """The warp top-k over tiles of ``tile_pixels`` where
    :func:`warp_topk_fits`, else the block rounds (their own tiles)."""
    return _atmolight_topk(img, t_raw, k, not warp_topk_fits(k), tile_pixels)


def _atmolight_topk(img: torch.Tensor, t_raw: torch.Tensor, k: int,
                    wide: bool, tile_pixels: int = TOP1_TILE) -> torch.Tensor:
    """The top-k light by the route named: the block rounds (``wide``, any
    k) or the warp top-k; each takes its key lists' scratch."""
    _check_topk(img, t_raw, k)
    check_tile_pixels(tile_pixels)
    _check_cuda(img, t_raw)
    n, h, w, _ = img.shape
    lists = ((n, -(-(h * w) // TOPK_TILE), min(k, TOPK_TILE)) if wide
             else (n, -(-(h * w) // tile_pixels), k))
    keys = torch.empty(lists, dtype=torch.int64, device=img.device)
    out = torch.empty((n, 3), dtype=img.dtype, device=img.device)
    args = (img.data_ptr(), t_raw.data_ptr(), keys.data_ptr(), out.data_ptr(),
            n, h, w, k, _dtype_code(img), _dtype_code(t_raw))
    _launch("atmolight_topk", *args, *(() if wide else (tile_pixels,)),
            wide=wide)
    return out


def plain_atmolight_topk(img: torch.Tensor, t_raw: torch.Tensor,
                         k: int, tile_pixels: int = TOP1_TILE) -> torch.Tensor:
    """The mean of I over the k smallest (t, flat index) of each frame
    (-0.0 == +0.0; :func:`topk_mean`), cast to the frames' dtype, which no
    tile changes (``tile_pixels`` is checked, as the kernel's)."""
    _check_topk(img, t_raw, k)
    check_tile_pixels(tile_pixels)
    n = img.shape[0]
    idx = key_index(topk_select(t_raw, k))
    x = img.to(torch.float32).reshape(n, -1, 3)
    return topk_mean(x, idx).to(img.dtype)


def atmolight_topk_op(img: torch.Tensor, t_raw: torch.Tensor,
                      k: int, tile_pixels: int = TOP1_TILE) -> torch.Tensor:
    """(N, H, W, 3), (N, H, W) -> (N, 3) in the frames' dtype; the warp
    top-k reduces tiles of ``tile_pixels``."""
    return (cuda_atmolight_topk if _on_kernel(img)
            else plain_atmolight_topk)(img, t_raw, k, tile_pixels)


# ---------------------------------------------------------------------------
# Recover (recover.py::recover_pallas)
# ---------------------------------------------------------------------------

def _check_recover(img, t, A) -> None:
    _check_pair(img, t)
    if tuple(A.shape) != (img.shape[0], 3):
        raise ValueError(f"A {tuple(A.shape)} != (N, 3) = {(img.shape[0], 3)}")
    _dtype_code(A)


def _recover_out(img: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    """J's buffer: ``out`` where given (the frames' shape and dtype,
    contiguous, on their device; it may be the frames themselves, each
    element read before it is written), else a new one."""
    if out is None:
        return torch.empty_like(img)
    if (out.shape != img.shape or out.dtype != img.dtype
            or out.device != img.device or not out.is_contiguous()):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on {out.device} "
                         f"is not a contiguous {tuple(img.shape)} {img.dtype} "
                         f"on {img.device}")
    return out


def cuda_recover(img: torch.Tensor, t: torch.Tensor, A: torch.Tensor,
                 t0: float = 0.1, gamma: float = 1.0,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check_recover(img, t, A)
    _check_cuda(img, t, A)
    n, h, w, _ = img.shape
    out = _recover_out(img, out)
    # ctypes rounds t0 and gamma to float32, as PyTorch rounds a scalar
    # operand of a float32 operation.
    _launch("recover", img.data_ptr(), t.data_ptr(), A.data_ptr(),
            out.data_ptr(), n, h, w, t0, gamma, _dtype_code(img),
            _dtype_code(t), _dtype_code(A))
    return out


def plain_recover(img: torch.Tensor, t: torch.Tensor, A: torch.Tensor,
                  t0: float = 0.1, gamma: float = 1.0,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 8 in float32, ``clip((I - A)/max(t, t0) + A, 0, 1) ** gamma``,
    cast once to the frames' dtype (into ``out`` where given)."""
    _check_recover(img, t, A)
    J_out = None if out is None else _recover_out(img, out)
    x = img.to(torch.float32)
    tt = torch.clamp_min(t.to(torch.float32), t0)[..., None]
    a = A.to(torch.float32)[:, None, None, :]
    out = torch.clamp((x - a) / tt + a, 0.0, 1.0)
    if gamma != 1.0:
        out = out ** gamma
    return out.to(img.dtype) if J_out is None else J_out.copy_(out)


def recover_op(img: torch.Tensor, t: torch.Tensor, A: torch.Tensor,
               t0: float = 0.1, gamma: float = 1.0,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, H, W, 3), (N, H, W), (N, 3) -> (N, H, W, 3) in the frames' dtype,
    into ``out`` where given (the frames themselves under buffer
    donation)."""
    kw = {} if out is None else {"out": out}
    return (cuda_recover if _on_kernel(img) else plain_recover)(
        img, t, A, t0, gamma, **kw)


# ---------------------------------------------------------------------------
# Masked min and box filters (dark_channel.py::masked_min_filter_2d_pallas,
# boxfilter.py::masked_box_filter_2d_pallas), the halo-extended planes of a
# spatial shard
# ---------------------------------------------------------------------------

def _check_masks(x: torch.Tensor, valid: torch.Tensor,
                 valid_w: Optional[torch.Tensor]) -> None:
    _check_plane(x)
    _dtype_code(x)
    if tuple(valid.shape) != (x.shape[1],):
        raise ValueError(f"row validity {tuple(valid.shape)} != (H,) = "
                         f"{(x.shape[1],)}")
    if valid_w is not None and tuple(valid_w.shape) != (x.shape[2],):
        raise ValueError(f"column validity {tuple(valid_w.shape)} != (W,) = "
                         f"{(x.shape[2],)}")


def validity_bytes(valid: Optional[torch.Tensor], n: int,
                   device) -> torch.Tensor:
    """A validity vector as the kernels' bytes (non-zero valid); None is
    all valid. A contiguous uint8 vector on ``device`` passes as it is, a
    contiguous bool one as a view of its bytes."""
    if valid is None:
        return torch.ones(n, dtype=torch.uint8, device=device)
    if tuple(valid.shape) != (n,):
        raise ValueError(f"validity {tuple(valid.shape)} != ({n},)")
    if valid.device == torch.device(device) and valid.is_contiguous():
        if valid.dtype == torch.uint8:
            return valid
        if valid.dtype == torch.bool:            # 0/1 bytes already
            return valid.view(torch.uint8)
    return (valid.to(device) != 0).to(torch.uint8).contiguous()


def _masked_window(name: str, x, valid, radius, valid_w,
                   wide: Optional[bool] = None):
    """Launch the masked window kernel ``name``: the strips, or the row
    window where ``wide`` (by default where :func:`strips_fit` does not
    hold)."""
    _check_masks(x, valid, valid_w)
    _check_cuda(x)
    dt = _dtype_code(x)
    n, h, w = x.shape
    _check_window(h, radius)
    vh = validity_bytes(valid, h, x.device)
    vw = validity_bytes(valid_w, w, x.device)
    out = torch.empty_like(x)
    if wide is None:
        wide = not strips_fit(name, radius, x.dtype)
    _launch(name, x.data_ptr(), vh.data_ptr(), vw.data_ptr(), out.data_ptr(),
            n, h, w, radius, dt, wide=wide)
    return out


def cuda_masked_min_filter(x: torch.Tensor, valid: torch.Tensor, radius: int,
                           valid_w: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    return _masked_window("masked_min_filter", x, valid, radius, valid_w)


def plain_masked_min_filter(x: torch.Tensor, valid: torch.Tensor,
                            radius: int,
                            valid_w: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """``core.spatial.masked_min_filter_2d``: invalid pixels +inf, in
    float32, cast back."""
    from repro_torch.core import spatial        # spatial imports this module
    _check_masks(x, valid, valid_w)
    return spatial.masked_min_filter_2d(x, valid, radius, valid_w)


def masked_min_filter_op(x: torch.Tensor, valid: torch.Tensor, radius: int,
                         valid_w: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(N, H, W), (H,) [, (W,)] validity -> (N, H, W) in the input dtype."""
    return (cuda_masked_min_filter if _on_kernel(x)
            else plain_masked_min_filter)(x, valid, radius, valid_w)


def cuda_masked_box_filter(x: torch.Tensor, valid: torch.Tensor, radius: int,
                           valid_w: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    return _masked_window("masked_box_filter", x, valid, radius, valid_w)


def _valid_counts(valid: Optional[torch.Tensor], n: int, r: int,
                  device) -> torch.Tensor:
    """(n,) float32 counts of the valid entries in each clipped window of
    radius r along one axis (None: all valid)."""
    v = (torch.ones(n, device=device) if valid is None
         else (valid.to(device) != 0).to(torch.float32))
    return window_sum(v, r, -1)


def plain_masked_box_filter(x: torch.Tensor, valid: torch.Tensor,
                            radius: int,
                            valid_w: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The windowed mean over the valid pixels in the kernel's order: the
    invalid pixels selected to +0 (``where``, not a multiply: they may hold
    +-inf or NaN), direct sums horizontal then vertical, each ascending
    from +0 (:func:`ascending_window_sum`), divided by max(rowcnt *
    colcnt, 1) of the valid rows and columns: the kernel's result bit for
    bit. ``core.spatial.masked_box_filter_2d`` (the ``"ref"`` route) is the
    same function summed in another order."""
    _check_masks(x, valid, valid_w)
    n, h, w = x.shape
    rows = _valid_counts(valid, h, radius, x.device)
    cols = _valid_counts(valid_w, w, radius, x.device)
    mask = (valid.to(x.device) != 0)[:, None]
    if valid_w is not None:
        mask = mask & (valid_w.to(x.device) != 0)[None, :]
    v = torch.where(mask, x.to(torch.float32),
                    torch.zeros((), device=x.device))
    s = ascending_window_sum(ascending_window_sum(v, radius, -1), radius, -2)
    cnt = torch.clamp_min(rows[:, None] * cols[None, :], 1.0)
    return (s / cnt).to(x.dtype)


def masked_box_filter_op(x: torch.Tensor, valid: torch.Tensor, radius: int,
                         valid_w: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(N, H, W), (H,) [, (W,)] validity -> (N, H, W) in the input dtype."""
    return (cuda_masked_box_filter if _on_kernel(x)
            else plain_masked_box_filter)(x, valid, radius, valid_w)


# ---------------------------------------------------------------------------
# Cross-shard top-k merge (atmolight.py::merge_topk_pallas)
# ---------------------------------------------------------------------------

def _check_merge(tk_t: torch.Tensor, tk_idx: torch.Tensor,
                 tk_rgb: torch.Tensor, k: int) -> None:
    if tk_t.dim() != 2:
        raise ValueError(f"expected (N, M) t lists, got {tuple(tk_t.shape)}")
    n, m = tk_t.shape
    if tuple(tk_idx.shape) != (n, m) or tuple(tk_rgb.shape) != (n, m, 3):
        raise ValueError(f"lists {tuple(tk_t.shape)}, {tuple(tk_idx.shape)}, "
                         f"{tuple(tk_rgb.shape)} are not (N, M), (N, M), "
                         "(N, M, 3)")
    if (tk_t.dtype, tk_idx.dtype, tk_rgb.dtype) != (
            torch.float32, torch.int32, torch.float32):
        raise ValueError("the merge takes float32 t, int32 indices and "
                         "float32 rgb")
    if not 1 <= k <= m or n < 1:
        raise ValueError(f"k={k} outside [1, M={m}], or N={n} < 1")


def cuda_merge_topk(tk_t: torch.Tensor, tk_idx: torch.Tensor,
                    tk_rgb: torch.Tensor, k: int) -> torch.Tensor:
    _check_merge(tk_t, tk_idx, tk_rgb, k)
    _check_cuda(tk_t, tk_idx, tk_rgb)
    n, m = tk_t.shape
    sel = torch.empty((n, k), dtype=torch.int32, device=tk_t.device)
    out = torch.empty((n, 3), dtype=torch.float32, device=tk_t.device)
    _launch("merge_topk", tk_t.data_ptr(), tk_idx.data_ptr(),
            tk_rgb.data_ptr(), sel.data_ptr(), out.data_ptr(), n, m, k)
    return out


def plain_merge_topk(tk_t: torch.Tensor, tk_idx: torch.Tensor,
                     tk_rgb: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest (t, index) rows by a stable two-key sort
    (``kernels.ref.topk_positions``), their rgb mean through
    :func:`topk_mean`."""
    from repro_torch.kernels import ref
    _check_merge(tk_t, tk_idx, tk_rgb, k)
    pick = ref.topk_positions(tk_t, tk_idx.to(torch.int64), k)
    return topk_mean(tk_rgb, pick)


def merge_topk_op(tk_t: torch.Tensor, tk_idx: torch.Tensor,
                  tk_rgb: torch.Tensor, k: int) -> torch.Tensor:
    """(N, M) float32 t, (N, M) int32 global index, (N, M, 3) float32 rgb
    -> (N, 3) float32."""
    return (cuda_merge_topk if _on_kernel(tk_t) else plain_merge_topk)(
        tk_t, tk_idx, tk_rgb, k)


# ---------------------------------------------------------------------------
# The §3.3 state sync: the candidate rows' merge and the EMA in one kernel
# (atmolight.py::merge_topk_pallas, core/normalize.py::ema_scan and
# ::ema_scan_associative)
# ---------------------------------------------------------------------------

#: The call shapes :func:`_check_merge_ema` has passed: each is checked
#: once, not on every step.
_merge_ema_shapes: set = set()


def _check_merge_ema(tk_t, tk_idx, tk_rgb, k, frame_ids, A, last_update,
                     initialized, period, out) -> None:
    key = (None if out is None else tuple((v.shape, v.dtype) for v in out),
           tk_rgb.shape, tk_rgb.dtype,
           None if tk_t is None else (tk_t.shape, tk_t.dtype),
           None if tk_idx is None else (tk_idx.shape, tk_idx.dtype),
           k, frame_ids.shape, frame_ids.dtype, A.shape, A.dtype,
           last_update.shape, last_update.dtype, initialized.shape,
           initialized.dtype, period)
    if key in _merge_ema_shapes:
        return
    if tk_rgb.dim() != 4 or tk_rgb.shape[-1] != 3 or \
            tk_rgb.dtype != torch.float32:
        raise ValueError(f"expected (L, B, M, 3) float32 rgb rows, got "
                         f"{tuple(tk_rgb.shape)} {tk_rgb.dtype}")
    l, b, m = tk_rgb.shape[:3]
    for name, v, dt in (("t", tk_t, torch.float32),
                        ("index", tk_idx, torch.int32)):
        if v is None and m == 1:
            continue
        if v is None or tuple(v.shape) != (l, b, m) or v.dtype != dt:
            raise ValueError(f"the {name} lists must be (L, B, M) = "
                             f"{(l, b, m)} {dt} (None only at M = 1)")
    if not 1 <= k <= min(m, MERGE_EMA_MAX_K):
        raise ValueError(f"k={k} outside [1, min(M={m}, {MERGE_EMA_MAX_K})]")
    if tuple(frame_ids.shape) != (l, b) or frame_ids.dtype != torch.int32:
        raise ValueError(f"frame ids {tuple(frame_ids.shape)} "
                         f"{frame_ids.dtype} are not (L, B) = {(l, b)} int32")
    for name, v, shape, dt in (("A", A, (l, 3), torch.float32),
                               ("last_update", last_update, (l,), torch.int32),
                               ("initialized", initialized, (l,), torch.bool)):
        if tuple(v.shape) != shape or v.dtype != dt:
            raise ValueError(f"state {name} {tuple(v.shape)} {v.dtype} is not "
                             f"{shape} {dt}")
    if out is not None and [(v.shape, v.dtype) for v in out] != [
            (v.shape, v.dtype) for v in (A, last_update, initialized)]:
        raise ValueError("out must hold the state's three tensors' shapes and "
                         "dtypes")
    if min(l, b) < 1 or period < 1:
        raise ValueError(f"L={l}, B={b} and period={period} must be >= 1")
    _merge_ema_shapes.add(key)


def _merge_ema_outputs(l: int, b: int, device, out):
    """a_seq (L, B, 3) float32 and the new state's rows (``out``'s where
    given). Four plain allocations: carving them from one buffer takes
    more view calls on the host than it saves."""
    a_seq = torch.empty((l, b, 3), dtype=torch.float32, device=device)
    if out is not None:
        return (a_seq, *out)
    return (a_seq, torch.empty((l, 3), dtype=torch.float32, device=device),
            torch.empty(l, dtype=torch.int32, device=device),
            torch.empty(l, dtype=torch.bool, device=device))


def cuda_merge_ema(tk_t, tk_idx, tk_rgb: torch.Tensor, k: int,
                   frame_ids: torch.Tensor, A: torch.Tensor,
                   last_update: torch.Tensor, initialized: torch.Tensor,
                   period: int, lam: float, associative: bool, out=None):
    _check_merge_ema(tk_t, tk_idx, tk_rgb, k, frame_ids, A, last_update,
                     initialized, period, out)
    lists = () if tk_t is None else (tk_t, tk_idx)
    _check_cuda(tk_rgb, frame_ids, A, last_update, initialized, *lists,
                *(out or ()))
    l, b, m = tk_rgb.shape[:3]
    res = _merge_ema_outputs(l, b, tk_rgb.device, out)
    t_ptr, idx_ptr = (None, None) if tk_t is None else (tk_t.data_ptr(),
                                                        tk_idx.data_ptr())
    _launch("merge_ema", t_ptr, idx_ptr, tk_rgb.data_ptr(),
            frame_ids.data_ptr(), A.data_ptr(), last_update.data_ptr(),
            initialized.data_ptr(), *(v.data_ptr() for v in res), l, b, m, k,
            period, lam, 1.0 - lam, int(associative))
    return res


def plain_merge_ema(tk_t, tk_idx, tk_rgb: torch.Tensor, k: int,
                    frame_ids: torch.Tensor, A: torch.Tensor,
                    last_update: torch.Tensor, initialized: torch.Tensor,
                    period: int, lam: float, associative: bool, out=None):
    """The composition the kernel replaces: each frame's candidate by
    :func:`plain_merge_topk` (the row itself at M = 1), then
    ``core.normalize.ema_scan_associative`` (``associative``) or
    ``ema_scan`` over each lane. The kernel equals it bit for bit where the
    compensated sum of the k picks is exact (rgb in [0, 1] within a factor
    2**21 of each other, as frames give them)."""
    from repro_torch.core import normalize
    _check_merge_ema(tk_t, tk_idx, tk_rgb, k, frame_ids, A, last_update,
                     initialized, period, out)
    l, b, m = tk_rgb.shape[:3]
    if m == 1:
        cand = tk_rgb[:, :, 0]
    else:
        cand = plain_merge_topk(tk_t.reshape(l * b, m),
                                tk_idx.reshape(l * b, m),
                                tk_rgb.reshape(l * b, m, 3), k).reshape(l, b, 3)
    scan = normalize.ema_scan_associative if associative else normalize.ema_scan
    a_seq, st = scan(cand, frame_ids,
                     normalize.AtmoState(A, last_update, initialized),
                     period, lam)
    new = (st.A, st.last_update, st.initialized)
    if out is None:
        return (a_seq, *new)
    for dst, src in zip(out, new):
        dst.copy_(src)
    return (a_seq, *out)


def merge_ema_op(tk_t, tk_idx, tk_rgb: torch.Tensor, k: int,
                 frame_ids: torch.Tensor, A: torch.Tensor,
                 last_update: torch.Tensor, initialized: torch.Tensor,
                 period: int, lam: float, associative: bool, out=None):
    """(L, B, M) float32 t and int32 global indices (None at M = 1), (L, B,
    M, 3) float32 rgb, (L, B) int32 ids (< 0 padding) and the lane-batched
    state (A (L, 3) float32, last_update (L,) int32, initialized (L,) bool)
    -> ``(a_seq (L, B, 3) float32, A, last_update, initialized)``, the new
    state in ``out``'s three tensors where given (they may be the state
    read)."""
    return (cuda_merge_ema if _on_kernel(tk_rgb) else plain_merge_ema)(
        tk_t, tk_idx, tk_rgb, k, frame_ids, A, last_update, initialized,
        period, lam, associative, out)


#: Kernel name -> (CUDA wrapper, plain version): what ``chip_smoke.py``
#: holds against each other.
PAIRS = {name: (globals()[f"cuda_{name}"], globals()[f"plain_{name}"])
         for name in KERNELS + SPATIAL_KERNELS + STATE_KERNELS}

__all__ = ["SOURCE", "KERNELS", "SPATIAL_KERNELS", "STATE_KERNELS",
           "MERGE_EMA_MAX_K", "launches",
           "wide_launches", "reset_launches", "PAIRS", "STRIP_KINDS",
           "strip_smem", "strips_fit", "strips_occupancy", "window_occupancy",
           "topk_occupancy", "WARP_TOPK_MAX", "warp_topk_fits", "window_sum",
           "TOP1_TILE", "TOP1_TILES", "check_tile_pixels",
           "ascending_window_sum", "window_counts",
           "validity_bytes", "KEY_LAST", "topk_keys_signed",
           "flip_key_order", "key_index", "key_t", "topk_select", "topk_mean",
           "cuda_dark_channel", "plain_dark_channel", "dark_channel_op",
           "cuda_min_filter", "plain_min_filter", "min_filter_op",
           "cuda_box_filter", "plain_box_filter", "box_filter_op",
           "cuda_atmolight", "plain_atmolight", "atmolight_op",
           "cuda_atmolight_topk", "plain_atmolight_topk", "atmolight_topk_op",
           "cuda_recover", "plain_recover", "recover_op",
           "cuda_masked_min_filter", "plain_masked_min_filter",
           "masked_min_filter_op", "cuda_masked_box_filter",
           "plain_masked_box_filter", "masked_box_filter_op",
           "cuda_merge_topk", "plain_merge_topk", "merge_topk_op",
           "cuda_merge_ema", "plain_merge_ema", "merge_ema_op"]
