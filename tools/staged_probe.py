"""What holds the staged window strips (B3a, B3b, B4, B8a, B8b) and the
warp top-k (B6b) back, on the card.

    python3 tools/staged_probe.py [variant ...]

Run from the root of a checkout on a machine with an sm_90a card and
``nvcc``. It builds variants (those named, else all) of
``src/repro_torch/kernels/csrc/staged.cu`` and its header, each a text
patch of a copy under ``build/staged_probe/``, all at once, and times the
box filter (B4, r = 20), the dark channel (B3a, r = 7), the min filter
(B3b, r = 7) and the top-k atmospheric light (B6b, k = 4) of each at the
serving shape (32 float32 planes or frames of 480x640), and the masked
min filter (B8a, r = 7) and masked box filter (B8b, r = 20) on a corner
tile of a 2 x 2 tiling of those planes extended by the spatial step's
47-pixel halo (32 x 334 x 414, the first 47 rows and columns invalid),
beside the same masked filters with every row and column valid
(``_valid``) and the unmasked box and min filters (``_tile``) on that
plane, each beside the route past its limits (``st_*_wide``: the
row-window kernel, the top-k's block rounds) of the same build: back to
back with CUDA events, and as 20 calls in a replayed CUDA graph
(``_graph``, the device's time a call without the host's launches):

- ``base``: the sources as they are;
- ``unroll4``: the middle loop of ``window_run`` unrolled by 4;
- ``run16``: vertical runs of 16 outputs a thread, not 8;
- ``no_vertical`` / ``no_horizontal``: each vertical (horizontal) run
  takes its first input for every output, its loads and adds gone;
  ``no_windows``: both;
- ``no_copy``: the float32 box and min filters copy no piece into shared
  memory (they then sum what the shared memory holds, which may send
  their divisions down their slow path);
- ``no_convert``: B3a stores no piece's pixels (their loads gone);
- ``no_div``: the mean's IEEE division a multiplication;
- ``no_store``: no output stored (a test on each keeps it live);
- ``band_half``, ``band_double``: bands of at most half or twice as many
  output rows (box and min filters 64 or 256, not 128; dark channel 32 or
  128, not 64): less or more shared memory a block, more or fewer rows
  recomputed;
- ``min_direct``: the min filters' runs by ``window_run`` (2r + 1 minima
  an output an axis), not ``min_run`` (van Herk / Gil-Werman);
- ``mask_off``: every masked block takes the closed-form counts and stages
  every column and row, as an all-valid block does: the mask's cost;
  ``no_flags``: the same without reading the validity bytes and the
  barrier that decides it;
- ``topk_insert64``: the warp top-k's lanes insert each pixel's key with
  64-bit compares (``KeyList::insert``), not the high word alone
  (``insert_after``, which the pixels' index order allows).

A patch that no longer matches the source as often as it says fails the
run. The variants but ``base``, ``unroll4``, ``run16``, the bands,
``min_direct`` and ``topk_insert64`` compute wrong results (``mask_off``
on the masked blocks): they are timed, never checked. The variants run in
two rounds, the second in reverse order, and each time is the mean of
both. It prints the opcode counts of the base float32 box filter kernel's
SASS (``cuobjdump``), one line a variant with its strips' blocks an SM
(box, dark, min, masked box, masked min), the card's name and power
limit, and last a JSON object
of every time (ms) and the blocks an SM.
"""
from __future__ import annotations

import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

N, H, W = 32, 480, 640
MIDDLE = "        for (int k = R - 1; k <= w; ++k) {       // every output\n"
INCLUDE = '#include "dehaze_common.cuh"\n'
FIRST_ONLY = INCLUDE + """
namespace dehaze {
template <int NP, int R, bool kSum, class Fetch>
__device__ __forceinline__ void first_only(const Fetch& fetch, int, float (&acc)[NP][R]) {
    float v[NP];
    fetch(0, v);
#pragma unroll
    for (int q = 0; q < NP; ++q)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[q][j] = v[q];
}
}  // namespace dehaze
"""
NO_VERTICAL = [("staged.cu", "window_run<1, kRunY, kSum>(", "first_only<1, kRunY, kSum>(", 1)]
NO_HORIZONTAL = [("staged.cu", "window_run<1, kRunX, kSum>(", "first_only<1, kRunX, kSum>(", 1)]
FIRST = [("staged.cu", INCLUDE, FIRST_ONLY, 1)]

MIN_RUN = "min_run<{R}>([&](int k) {{ return src[{at}]; }}, 2 * r, {acc});"
WINDOW_RUN = "window_run<1, {R}, false>([&](int k, float (&v)[1]) {{ v[0] = src[{at}]; }}, 2 * r, s);"
PIXEL = "i0 + 4u * (j * kTop1Threads) + c"
STORE = "store_px(out, frame + static_cast<long long>(y) * W + xo, kDt, v);"

# variant -> [(file, text, replacement, occurrences)]
VARIANTS = {
    "base": [],
    "unroll4": [("dehaze_common.cuh", MIDDLE, "#pragma unroll 4\n" + MIDDLE, 1)],
    "run16": [("staged.cu", "constexpr int kRunY = 8;", "constexpr int kRunY = 16;", 1)],
    "no_vertical": FIRST + NO_VERTICAL,
    "no_horizontal": FIRST + NO_HORIZONTAL,
    "no_windows": FIRST + NO_VERTICAL + NO_HORIZONTAL,
    "no_copy": [("staged.cu", "cp_async4(dst + j, in ? src + xf + j : src, in ? 4 : 0);",
                 "(void)in;", 1)],
    "no_convert": [("staged.cu", "dst[j] = in ? v : fill;", "(void)v;", 1)],
    "no_div": [("staged.cu", "? __fdiv_rn(v, fmaxf(", "? __fmul_rn(v, fmaxf(", 1),
               ("staged.cu", ": __fdiv_rn(v, __fmul_rn(cnt_y",
                ": __fmul_rn(v, __fmul_rn(cnt_y", 1)],
    "no_store": [("staged.cu", STORE, "if (v == 1234.5f) " + STORE, 1)],
    "band_half": [("staged.cu", "constexpr int kBandRows = 128;", "constexpr int kBandRows = 64;", 1),
                  ("staged.cu", "constexpr int kDarkBandRows = 64;", "constexpr int kDarkBandRows = 32;", 1),
                  ("staged.cu", "constexpr int kMinBandRows = 128;", "constexpr int kMinBandRows = 64;", 1)],
    "band_double": [("staged.cu", "constexpr int kBandRows = 128;", "constexpr int kBandRows = 256;", 1),
                    ("staged.cu", "constexpr int kDarkBandRows = 64;", "constexpr int kDarkBandRows = 128;", 1),
                    ("staged.cu", "constexpr int kMinBandRows = 128;", "constexpr int kMinBandRows = 256;", 1)],
    "min_direct": [("staged.cu", MIN_RUN.format(R="kRunX", at="k", acc="s[0]"),
                    WINDOW_RUN.format(R="kRunX", at="k"), 1),
                   ("staged.cu", MIN_RUN.format(R="kRunY", at="k * kSumStride", acc="s[0]"),
                    WINDOW_RUN.format(R="kRunY", at="k * kSumStride"), 1)],
    "mask_off": [("staged.cu", "any_invalid = !__syncthreads_and(all);",
                  "any_invalid = !__syncthreads_and(all) && false;", 1)],
    "no_flags": [("staged.cu", "    if constexpr (kMasked) {\n        bool all = true;",
                  "    if constexpr (false) {\n        bool all = true;", 1)],
    "topk_insert64": [("staged.cu", "mine.insert_after(key_hi(v[j][c]), " + PIXEL + ", 4 * j + c);",
                       "mine.insert(make_key(v[j][c], " + PIXEL + "));", 1)],
}
TOPK = 4
HALO = 47                                        # the spatial step's halo: r + 2 gf_r


def build_all(out_dir: Path) -> dict:
    from repro_torch.kernels import _build
    nvcc = _build.find_nvcc()
    procs = {}
    for name, patches in VARIANTS.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        texts = {p.name: p.read_text() for p in _build.CSRC.glob("*.cuh")}
        texts["staged.cu"] = (_build.CSRC / "staged.cu").read_text()
        for fname, old, new, count in patches:
            found = texts[fname].count(old)
            if found != count:
                raise SystemExit(f"{name}: patch {old[:40]!r} matches {found} "
                                 f"times in {fname}, expected {count}")
            texts[fname] = texts[fname].replace(old, new)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        lib = d / "staged.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(d / "staged.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{out}")
        libs[name] = lib
    return libs


def sass_opcodes(lib: Path) -> None:
    """Opcode counts of the float32 box filter strip kernel's SASS."""
    from repro_torch.kernels import _build
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    fn = re.search(r"Function : (\S*strip_window_kernelILi2ELi0E\S*)\n(.*?)"
                   r"(?:\n\s*Function :|\Z)", out, re.S)
    if not fn:
        print("sass: strip kernel not found", flush=True)
        return
    ops = collections.Counter(
        m.group(1).split(".")[0] for m in
        re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", fn.group(2)))
    print("sass box float32 strip kernel opcodes: "
          + json.dumps(dict(ops.most_common(25))), flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time a call: ``reps`` calls captured in one CUDA graph, the
    graph replayed between CUDA events (no host launch in the way)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, reps=5, warmup=1) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import staged as sk
    if len(sys.argv) > 1:                        # the variants named, in their order here
        for name in list(VARIANTS):
            if name not in sys.argv[1:]:
                del VARIANTS[name]
    libs = build_all(ROOT / "build" / "staged_probe")
    if "base" in libs:
        sass_opcodes(libs["base"])
    rng = np.random.default_rng(0)
    plane = torch.from_numpy(rng.standard_normal((N, H, W), dtype=np.float32)).cuda()
    frames = torch.from_numpy(rng.random((N, H, W, 3), dtype=np.float32)).cuda()
    t_map = torch.from_numpy(rng.permutation(N * H * W).astype(np.float32).reshape(N, H, W)
                             / (N * H * W)).cuda()
    out = torch.empty_like(plane)
    lists = torch.empty(N * -(-(H * W) // 2048) * TOPK, dtype=torch.int64, device="cuda")
    light = torch.empty((N, 3), device="cuda")
    # The corner tile: rows and columns -47 .. 286 and -47 .. 366 of the
    # plane, zero and invalid off it.
    th, tw = H // 2 + 2 * HALO, W // 2 + 2 * HALO
    tile = torch.nn.functional.pad(plane, (HALO, 0, HALO, 0))[:, :th, :tw].contiguous()
    t_out = torch.empty_like(tile)
    vh = (torch.arange(th, device="cuda") >= HALO).to(torch.uint8)
    vw = (torch.arange(tw, device="cuda") >= HALO).to(torch.uint8)
    ones_h = torch.ones(th, dtype=torch.uint8, device="cuda")
    ones_w = torch.ones(tw, dtype=torch.uint8, device="cuda")
    vp, i = ctypes.c_void_p, ctypes.c_int
    # case -> (entry, the arguments before the stream)
    cases = {name: (name, (x.data_ptr(), out.data_ptr(), N, H, W, r, 0)) for name, x, r in
             (("box_filter", plane, 20), ("dark_channel", frames, 7), ("min_filter", plane, 7))}
    cases["atmolight_topk"] = ("atmolight_topk", (
        frames.data_ptr(), t_map.data_ptr(), lists.data_ptr(), light.data_ptr(), N, H, W,
        TOPK, 0, 0))
    for name, r in (("masked_min_filter", 7), ("masked_box_filter", 20)):
        for suffix, (h_, w_) in (("", (vh, vw)), ("_valid", (ones_h, ones_w))):
            cases[name + suffix] = (name, (tile.data_ptr(), h_.data_ptr(), w_.data_ptr(),
                                           t_out.data_ptr(), N, th, tw, r, 0))
        unmasked = name.removeprefix("masked_")
        cases[unmasked + "_tile"] = (unmasked, (tile.data_ptr(), t_out.data_ptr(), N, th, tw,
                                                r, 0))
    argtypes = {"atmolight_topk": [vp] * 4 + [i] * 6, "masked_min_filter": [vp] * 4 + [i] * 5,
                "masked_box_filter": [vp] * 4 + [i] * 5}
    loaded = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for entry, _ in cases.values():
            for e in (f"st_{entry}", f"st_{entry}_wide"):
                top1 = [i] if e == "st_atmolight_topk" else []   # the warp top-k's tile
                getattr(lib, e).argtypes = argtypes.get(entry, [vp] * 2 + [i] * 5) + top1 + [vp]
        lib.st_strips_occupancy.argtypes = [i] * 4 + [ctypes.POINTER(i)]
        loaded[name] = lib
    keys = [f"{k}{s}{t}" for k in cases for s in ("", "_wide") for t in ("", "_graph")]
    times = {name: {k: 0.0 for k in keys} for name in loaded}
    order = list(loaded)
    for round_ in (order, order[::-1]):
        for name in round_:
            print(f"timing {name}", flush=True)
            for key in keys:
                case = key.removesuffix("_graph")
                wide = case.endswith("_wide")
                entry, a = cases[case.removesuffix("_wide")]
                fn = getattr(loaded[name], f"st_{entry}" + ("_wide" if wide else ""))
                top1 = (sk.TOP1_TILE,) if entry == "atmolight_topk" and not wide else ()

                def call():
                    rc = fn(*a, *top1, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise SystemExit(f"{name} {case}: cudaError_t {rc}")
                call()
                timer = graph_ms if key.endswith("_graph") else time_ms
                times[name][key] += timer(call) / 2
    blocks = {}
    for name, lib in loaded.items():
        got = []
        for kind, r, h in ((0, 20, H), (1, 7, H), (2, 7, H), (3, 20, th), (4, 7, th)):
            b = ctypes.c_int()
            lib.st_strips_occupancy(kind, r, 0, h, ctypes.byref(b))
            got.append(b.value)
        blocks[name] = got
    for name in order:
        print(f"{name:16s} blocks an SM (box, dark, min, masked box, masked min) "
              f"{blocks[name]}  " + "  ".join(f"{k} {times[name][k]:.4f}" for k in keys)
              + " ms", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(card[0] if card else torch.cuda.get_device_name(0))
    print(json.dumps({"ms": times, "blocks_an_sm": blocks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
