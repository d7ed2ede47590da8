"""Drive the PyTorch/CUDA port on one CUDA card, check it, and time it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (or any
sm_90a card) and ``nvcc``. It imports nothing of JAX or of the JAX
package. Phases, each failing the run (non-zero exit, no result line) on
any error:

1. the card's name and power limit, and the CUDA version;
2. build every kernel source (one ``nvcc`` per source, all at once), then
   hold every pass of the fused megakernel, and the whole, against its
   plain PyTorch version on the card at the serving shape (4 lanes x 8
   frames x 480x640) over {dcp, cap} x {topk 1, 4} x {f32, uint8, bf16}
   with refine, and two cells without refine (one with gamma != 1); every
   cell has an all-padding lane and chains a warm second batch on the
   first batch's carries;
3. serve 4 streams x 48 uint8 frames at 480x640 on 4 lanes through
   ``ElasticServer.serve_many`` with the fused config, then one stream
   through ``serve``, with the launch counters zeroed just before each path
   and read just after it; every pass must have launched once per tick on
   each path, and no staged kernel;
4. aggregate fps of that ``serve_many`` over a longer window (4 streams x
   192 frames) whose sink only records the order, so phase 3's per-frame
   checks stay out of its wall;
5. time every pass and the whole with CUDA events at the serving shape,
   beside its bound, its plain version and the matching PyTorch call;
6. the staged chain (the default ``kernel_mode="auto"``) at the serving
   shape, DCP, top-1, refine, over uint8, float32 and bfloat16 ingest and
   one uint8 cell with gamma != 1, each with an all-padding lane and two
   chained batches: every staged kernel call of the lane step held against
   its plain version on the same inputs; the whole step against the staged
   plain chain on the card; and, at float32 output, against the fused step
   (B1) on the same frames; neither step may make a synchronising CUDA
   call;
7. phases 3 and 4 again with the default config (staged): per tick one
   dark channel, six box filters, one atmospheric light and one recover,
   and no megakernel pass; the aggregate fps over 4 streams x 192 frames;
8. time the four staged kernels as phase 5 does, and the whole staged and
   fused lane steps back to back;
9. print ``{"kernels": [...]}``, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
L, B, H, W = 4, 8, 480, 640
SOURCE = "src/repro_torch/kernels/csrc/fused_dehaze.cu"
CFG_KW = dict(radius=7, omega=0.95, beta=1.0, gf_radius=20, gf_eps=1e-3,
              t0=0.1, gamma=1.0, period=8, lam=0.05)

STAGED_SOURCE = "src/repro_torch/kernels/csrc/staged.cu"

# The TPU kernel each staged kernel replaces (file:line), and its launches
# per tick of the staged lane step.
STAGED_REPLACES = {
    "dark_channel": "src/repro/kernels/dark_channel.py:45",
    "box_filter": "src/repro/kernels/boxfilter.py:133",
    "atmolight": "src/repro/kernels/atmolight.py:92",
    "recover": "src/repro/kernels/recover.py:32",
}
STAGED_PER_TICK = {"dark_channel": 1, "box_filter": 6, "atmolight": 1,
                   "recover": 1}

# The part of the TPU kernel each pass replaces (file:line).
REPLACES = {
    "fused_dehaze_lanes": "src/repro/kernels/fused.py:353",
    "premap": "src/repro/kernels/fused.py:163",
    "min_rows": "src/repro/kernels/fused.py:164",
    "min_cols_tmap": "src/repro/kernels/fused.py:165",
    "topk_block": "src/repro/kernels/fused.py:166",
    "topk_merge": "src/repro/kernels/fused.py:173",
    "ema": "src/repro/kernels/fused.py:180",
    "box_rows4": "src/repro/kernels/fused.py:126",
    "box_cols_ab": "src/repro/kernels/fused.py:140",
    "box_rows2": "src/repro/kernels/fused.py:144",
    "recover": "src/repro/kernels/fused.py:243",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ramps(seed: int, n: int) -> np.ndarray:
    """n frames, each its own permutation ramp over its H*W pixels (a ramp
    over all frames at once would space levels near the float32 ulp), with
    channel scales (1.0, 0.9, 0.8)."""
    r = np.random.default_rng(seed)
    g = np.stack([(r.permutation(H * W).reshape(H, W) + 1.0) / (H * W + 1.0)
                  for _ in range(n)])
    return np.stack([g, 0.9 * g, 0.8 * g], axis=-1).astype(np.float32)


def to_wire(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    from repro_torch.kernels import ref
    if dtype == torch.uint8:
        return ref.quantize_frames(x, "uint8")
    return torch.from_numpy(x).to(dtype)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# Phase 2: every pass and the whole against the plain version
# ---------------------------------------------------------------------------

PASS_TOL = {                      # pass -> (tolerance, relative to magnitude?)
    "premap": (0.0, False), "min_rows": (0.0, False),
    "min_cols_tmap": (0.0, False), "topk_block": (0.0, False),
    "topk_merge": (1e-6, False), "ema": (1e-6, False),
    "box_rows4": (1e-5, True), "box_cols_ab": (1e-3, False),
    "box_rows2": (1e-5, True), "recover": (1e-3, False),
}


def pass_error(name: str, got, want) -> float:
    """Max error of one pass's outputs (relative to max(1, |want|) for the
    window sums, whose magnitude grows with the window)."""
    if name == "topk_block":
        return 0.0 if torch.equal(got, want) else float("inf")
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g is None:
            continue
        d = (g.float() - w.float()).abs()
        if PASS_TOL[name][1]:
            d = d / w.float().abs().clamp_min(1.0)
        err = max(err, float(d.max()))
    return err


def run_checked(img, ids, cf, ci, s, errs):
    """The CUDA pass sequence with each pass held against its plain pass
    on the same inputs; returns the CUDA outputs."""
    from repro_torch.kernels import fused as fk

    def both(name, *args):
        got = fk.CUDA_PASSES[name](*args, s)
        want = fk.PLAIN_PASSES[name](*args, s)
        err = pass_error(name, got, want)
        tol = PASS_TOL[name][0]
        if name == "recover" and s.out_dtype == torch.bfloat16:
            tol = 2e-2                   # J/t stored in bfloat16
        check(err <= tol, f"pass {name} ({s.algorithm} k={s.topk} "
              f"{s.in_dtype} refine={s.refine}): error {err} > {tol}")
        errs[name] = max(errs.get(name, 0.0), err)
        return got

    pre, g = both("premap", img, cf)
    t_raw = both("min_cols_tmap", both("min_rows", pre))
    cand = both("topk_merge", both("topk_block", t_raw), img)
    a_seq, cf2, ci2 = both("ema", cand, ids, cf, ci)
    rows2 = None
    if s.refine:
        rows2 = both("box_rows2", both("box_cols_ab", both("box_rows4", g, t_raw)))
    J, t = both("recover", img, t_raw, g, rows2, a_seq)
    return J, t, a_seq, cf2, ci2


def phase_parity():
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import ref
    cells = [(alg, k, dt, True, 1.0)
             for alg in ("dcp", "cap") for k in (1, 4)
             for dt in (torch.float32, torch.uint8, torch.bfloat16)]
    # gamma != 1 without refine: the tone curve's slope near black turns a
    # refine-order difference of 1e-5 in J into 1e-2, while without refine
    # J is exact before the curve.
    cells += [("dcp", 1, torch.float32, False, 1.0),
              ("cap", 1, torch.uint8, False, 1.0 / 2.2)]
    frames = ramps(0, 2 * L * B).reshape(2, L, B, H, W, 3)
    pass_errs, whole_errs = {}, {"J_t": 0.0, "a_seq_carry": 0.0}
    for alg, k, dt, refine, gamma in cells:
        kw = dict(CFG_KW, algorithm=alg, topk=k, refine=refine, gamma=gamma)
        cf_k = cf_p = torch.ones(L, 3, device="cuda")
        ci_k = ci_p = torch.tensor([[-(2 ** 30), 0]] * L, dtype=torch.int32,
                                   device="cuda")
        for batch in range(2):
            img = to_wire(frames[batch].reshape(-1, 3), dt).reshape(
                L, B, H, W, 3).cuda()
            ids = (torch.arange(B, dtype=torch.int32) + B * batch).repeat(L, 1)
            ids[L - 1] = -1                                   # padding lane
            ids = ids.cuda()
            s = fk.make_static(img, **kw)
            got = run_checked(img, ids, cf_k, ci_k, s, pass_errs)
            whole = fk.fused_dehaze_lanes(img, ids, cf_k, ci_k, **kw)
            torch.cuda.synchronize()
            want = ref.fused_dehaze_lanes(img, ids, cf_p, ci_p, **kw)
            for g1, g2 in zip(got, whole):                    # same kernels
                check(torch.equal(g1, g2), "pass chain != wrapper")
            cell = f"{alg} k={k} {dt} refine={refine} gamma={gamma:.3f} b{batch}"
            e_jt = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
            e_a = max(max_err(got[2], want[2]), max_err(got[3], want[3]))
            tol = 2e-2 if dt == torch.bfloat16 else 1e-3
            check(e_jt <= tol, f"{cell}: J/t max error {e_jt} > {tol}")
            check(e_a <= 1e-5, f"{cell}: a_seq/carry max error {e_a} > 1e-5")
            check(torch.equal(got[4], want[4]),
                  f"{cell}: last_update/initialized differ")
            check(torch.equal(got[3][L - 1], cf_k[L - 1])
                  and torch.equal(got[4][L - 1], ci_k[L - 1]),
                  f"{cell}: the all-padding lane's carry changed")
            if not refine:
                check(torch.equal(got[1], want[1]),
                      f"{cell}: t differs without refine")
            whole_errs["J_t"] = max(whole_errs["J_t"], e_jt)
            whole_errs["a_seq_carry"] = max(whole_errs["a_seq_carry"], e_a)
            cf_k, ci_k, cf_p, ci_p = got[3], got[4], want[3], want[4]
        print(f"parity {alg} k={k} {str(dt):15s} refine={refine} "
              f"gamma={gamma:.3f}: ok", flush=True)
    print("parity max errors: passes " + json.dumps(pass_errs)
          + " whole " + json.dumps(whole_errs), flush=True)
    return pass_errs, whole_errs


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def reset_launches() -> None:
    from repro_torch.kernels import fused as fk, staged as sk
    fk.reset_launches()
    sk.reset_launches()


def path_launches(path: str, ticks: int, staged: bool = False) -> dict:
    """The launch counts since the last reset, read just after ``path``
    ran ``ticks`` steps. The fused path launches every megakernel pass
    once a step (the whole megakernel's runs are its first pass's,
    ``premap``) and no staged kernel; the staged path the staged kernels
    :data:`STAGED_PER_TICK` times a step and no megakernel pass."""
    from repro_torch.kernels import fused as fk, staged as sk
    counts = dict(fk.launches)
    counts["fused_dehaze_lanes"] = counts["premap"]
    want = {name: 0 if staged else ticks for name in counts}
    for name, n in sk.launches.items():
        counts[f"staged.{name}"] = n
        want[f"staged.{name}"] = STAGED_PER_TICK[name] * ticks if staged else 0
    for name, n in counts.items():
        check(want[name] == 0 or n > 0,
              f"kernel {name} never launched on the {path} path")
        check(n == want[name], f"kernel {name}: {n} launches on the {path} "
              f"path of {ticks} steps, expected {want[name]}")
    print(f"launches on {path} ({ticks} steps): " + json.dumps(counts),
          flush=True)
    return counts


def phase_serve(cfg, vids, staged: bool = False):
    from repro_torch.core import init_atmo_state
    from repro_torch.kernels import ref
    from repro_torch.stream import ElasticServer, StreamRequest
    n_frames = len(vids[0])
    lane0, order, bad = {}, {}, []

    def sink(sid, fid, frame):
        # Runs on monitor threads: record problems, the main thread fails.
        if tuple(frame.shape) != (H, W, 3) or frame.dtype != torch.float32:
            bad.append(f"{sid}:{fid} output {tuple(frame.shape)} {frame.dtype}")
        elif not (bool(torch.isfinite(frame).all())
                  and 0.0 <= float(frame.min()) and float(frame.max()) <= 1.0):
            bad.append(f"{sid}:{fid} output not finite in [0, 1]")
        order.setdefault(sid, []).append(fid)
        if sid == "cam0":
            lane0[fid] = frame

    label = "staged " if staged else ""
    srv = ElasticServer(cfg, batch=8, timeout_s=2.0)
    reset_launches()
    rep = srv.serve_many([StreamRequest(f"cam{i}", iter(v))
                          for i, v in enumerate(vids)], n_lanes=4, sink=sink)
    many = path_launches(label + "serve_many", rep.ticks, staged)
    check(not bad, "; ".join(bad[:5]))
    check(rep.skipped == 0, f"serve_many skipped {rep.skipped} frames")
    check(rep.frames == 4 * n_frames, f"serve_many served {rep.frames}")
    for i in range(4):
        check(order[f"cam{i}"] == list(range(n_frames)),
              f"cam{i}: frames not exactly once in order")

    single = {}
    solo = ElasticServer(cfg, batch=8, timeout_s=2.0)
    reset_launches()
    rep1 = solo.serve(iter(vids[0]), stream_id="cam0",
                      sink=lambda fid, f: single.setdefault(fid, f))
    one = path_launches(label + "serve", rep1.ticks, staged)
    check(rep1.skipped == 0 and sorted(single) == list(range(n_frames)),
          "serve: frames missing or skipped")
    e_single = max(max_err(single[f], lane0[f]) for f in range(n_frames))
    check(e_single <= 1e-5, f"serve vs serve_many lane: {e_single} > 1e-5")

    # The first batch of cam0 against the plain version from a fresh state.
    st = init_atmo_state("cuda")
    want = ref.fused_dehaze(
        torch.from_numpy(vids[0][:8]).cuda(), torch.arange(8, device="cuda",
                                                           dtype=torch.int32),
        st.A, st.last_update, st.initialized, algorithm=cfg.algorithm,
        radius=cfg.patch_radius, omega=cfg.omega, beta=cfg.beta,
        cap_w=(cfg.cap_w0, cfg.cap_w1, cfg.cap_w2), refine=cfg.refine,
        gf_radius=cfg.gf_radius, gf_eps=cfg.gf_eps, t0=cfg.t0,
        gamma=cfg.gamma, period=cfg.update_period, lam=cfg.lam,
        topk=cfg.topk)[0].cpu()
    e_ref = max(max_err(lane0[f], want[f]) for f in range(8))
    check(e_ref <= 1e-3, f"served frames vs plain version: {e_ref} > 1e-3")
    print(f"{label}serve_many (frames checked in the sink): {rep.frames} frames, "
          f"{rep.ticks} ticks, {rep.skipped} skipped, {rep.wall_s} s; "
          f"serve: {rep1.frames} frames, {rep1.wall_s} s; serve == lane "
          f"within {e_single}; vs plain {e_ref}", flush=True)
    return many, one, rep.ticks


# ---------------------------------------------------------------------------
# Phase 4: aggregate fps of the main path
# ---------------------------------------------------------------------------

def phase_throughput(cfg, vids, repeats: int = 4, staged: bool = False):
    """``serve_many`` of 4 fresh streams, each its video ``repeats`` times
    over, with a sink that only records the order. The step is the one
    phase 3 (or 7) built and ran (the step cache is shared)."""
    from repro_torch.stream import ElasticServer, StreamRequest
    order = {}

    def sink(sid, fid, frame):
        order.setdefault(sid, []).append(fid)

    srv = ElasticServer(cfg, batch=8, timeout_s=2.0)
    n = repeats * len(vids[0])
    label = "staged " if staged else ""
    reset_launches()
    rep = srv.serve_many(
        [StreamRequest(f"tput{i}", itertools.chain.from_iterable([v] * repeats))
         for i, v in enumerate(vids)], n_lanes=4, sink=sink)
    path_launches(label + "serve_many (throughput)", rep.ticks, staged)
    check(rep.skipped == 0 and rep.frames == 4 * n,
          f"throughput serve: {rep.frames} frames, {rep.skipped} skipped")
    for i in range(4):
        check(order[f"tput{i}"] == list(range(n)),
              f"tput{i}: frames not exactly once in order")
    print(f"{label}serve_many throughput: {rep.frames} frames, {rep.ticks} ticks, "
          f"{rep.wall_s} s, {rep.wall_s / rep.ticks * 1e3} ms per tick, "
          f"aggregate {rep.fps} fps, d2h {rep.d2h_bytes} bytes, "
          f"loop phases (s) " + json.dumps(rep.phases), flush=True)
    return rep


# ---------------------------------------------------------------------------
# Phase 5: times, bounds and yardsticks at the serving shape
# ---------------------------------------------------------------------------

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


def device_busy_ms(fn, reps: int = 5):
    """Device time of ``fn`` a call: the durations of the kernels and
    copies a ``torch.profiler`` trace of ``reps`` calls shows, summed; None
    where the trace shows no device activity or the profiler fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    except Exception as e:       # a measurement only: report, go on
        print(f"device time not measured: {e!r}", flush=True)
        return None
    return us / reps / 1e3 if us else None


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def phase_times():
    """Every pass of the serving config (DCP, top-1, refine, uint8 in,
    float32 out). The bound counts each input read once and each output
    written once, and the float32 operations of a sliding-window
    algorithm (O(1) per pixel per window pass)."""
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import ref
    kw = dict(CFG_KW, algorithm="dcp", topk=1, refine=True)
    img = to_wire(ramps(2, L * B).reshape(-1, 3), torch.uint8).reshape(
        L, B, H, W, 3).cuda()
    ids = torch.arange(B, dtype=torch.int32).repeat(L, 1).cuda()
    cf = torch.ones(L, 3, device="cuda")
    ci = torch.tensor([[-(2 ** 30), 0]] * L, dtype=torch.int32, device="cuda")
    s = fk.make_static(img, **kw)
    C, P = fk.CUDA_PASSES, fk.PLAIN_PASSES
    pre, g = C["premap"](img, cf, s)
    rows = C["min_rows"](pre, s)
    t_raw = C["min_cols_tmap"](rows, s)
    keys = C["topk_block"](t_raw, s)
    cand = C["topk_merge"](keys, img, s)
    a_seq, cf2, ci2 = C["ema"](cand, ids, cf, ci, s)
    rows4 = C["box_rows4"](g, t_raw, s)
    ab = C["box_cols_ab"](rows4, s)
    rows2 = C["box_rows2"](ab, s)
    J, t = C["recover"](img, t_raw, g, rows2, a_seq, s)
    npx = L * B * H * W
    k, kg = 2 * s.radius + 1, 2 * s.gf_radius + 1
    neg = (-pre)[:, None].contiguous()
    neg_rows = (-rows)[:, None].contiguous()
    planes4 = torch.stack([g, t_raw, g * t_raw, g * g], 1).contiguous()
    planes2 = ab.transpose(0, 1).contiguous()
    yard = {
        "min_rows": lambda: F.max_pool2d(neg, (k, 1), 1, (s.radius, 0)),
        "min_cols_tmap": lambda: F.max_pool2d(neg_rows, (1, k), 1, (0, s.radius)),
        "topk_block": lambda: torch.topk(t_raw.reshape(L * B, -1), 1,
                                         largest=False),
        "box_rows4": lambda: F.avg_pool2d(planes4, (kg, 1), 1, (s.gf_radius, 0),
                                          count_include_pad=False),
        "box_cols_ab": lambda: F.avg_pool2d(planes4, (1, kg), 1, (0, s.gf_radius),
                                            count_include_pad=False),
        "box_rows2": lambda: F.avg_pool2d(planes2, (kg, 1), 1, (s.gf_radius, 0),
                                          count_include_pad=False),
        "fused_dehaze_lanes": None,
    }
    # name -> (args, bytes moved, float32 operations)
    work = {
        "premap": ((img, cf), nbytes(img, pre, g), 10 * npx),
        "min_rows": ((pre,), nbytes(pre, rows), 3 * npx),
        "min_cols_tmap": ((rows,), nbytes(rows, t_raw), 5 * npx),
        "topk_block": ((t_raw,), nbytes(t_raw, keys), 4 * npx),
        "topk_merge": ((keys, img), nbytes(keys, cand) + 3 * L * B * s.topk,
                       keys.numel()),
        "ema": ((cand, ids, cf, ci), nbytes(cand, ids, cf, ci, a_seq, cf2, ci2),
                10 * 3 * L * B),
        "box_rows4": ((g, t_raw), nbytes(g, t_raw, rows4), 10 * npx),
        "box_cols_ab": ((rows4,), nbytes(rows4, ab), 20 * npx),
        "box_rows2": ((ab,), nbytes(ab, rows2), 4 * npx),
        "recover": ((img, t_raw, g, rows2, a_seq),
                    nbytes(img, g, rows2, a_seq, J, t), 24 * npx),
    }
    rows_out = {}
    for name, (args, nb, ops) in work.items():
        ms = time_ms(lambda: C[name](*args, s))
        plain_ms = time_ms(lambda: P[name](*args, s), reps=5, warmup=1)
        lib = yard.get(name)
        rows_out[name] = dict(ms=ms, plain_ms=plain_ms,
                              library_ms=time_ms(lib) if lib else None,
                              bytes=nb, ops=ops)
    whole_args = (img, ids, cf, ci)
    nb = nbytes(img, ids, cf, ci, J, t, a_seq, cf2, ci2)
    rows_out["fused_dehaze_lanes"] = dict(
        ms=time_ms(lambda: fk.fused_dehaze_lanes(*whole_args, **kw)),
        plain_ms=time_ms(lambda: ref.fused_dehaze_lanes(*whole_args, **kw),
                         reps=3, warmup=1),
        library_ms=None, bytes=nb,
        ops=sum(v[2] for v in work.values()))
    for r in rows_out.values():
        t_bytes = r["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = r["ops"] / PEAK_F32_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return rows_out


# ---------------------------------------------------------------------------
# Phase 6: the staged chain (kernel_mode "auto") against its plain versions
# and against the fused step
# ---------------------------------------------------------------------------

BF16_STEP = 2.0 ** -8             # one bfloat16 step for values in [0.5, 1)


def staged_tolerance(name: str, args) -> float:
    """Kernel against plain version: selections bit-equal; window means
    1e-5 relative to the mean's magnitude; recover 1e-6 in float32 at
    gamma 1 (1e-5 through powf), one bfloat16 step in bfloat16."""
    if name in ("dark_channel", "atmolight"):
        return 0.0
    if name == "box_filter":
        return 1e-5
    if args[0].dtype == torch.bfloat16:
        return BF16_STEP
    return 1e-6 if args[4] == 1.0 else 1e-5


def staged_error(name: str, got, want) -> float:
    d = (got.float() - want.float()).abs()
    if name == "box_filter":
        d = d / want.float().abs().clamp_min(1.0)
    return float(d.max()) if d.numel() else 0.0


def run_staged(step, frames, ids, state, ops: str, errs=None, cell=""):
    """One staged step with the staged ops routed to ``ops``: "plain"
    (the plain versions, on the card) or "checked" (each call runs the
    kernel and its plain version on the same inputs, holds them to
    :func:`staged_tolerance` and returns the kernel's result)."""
    from repro_torch.kernels import staged as sk
    saved = {name: getattr(sk, f"{name}_op") for name in sk.KERNELS}

    def checked(name):
        kernel, plain = sk.PAIRS[name]

        def op(*args):
            got = kernel(*args)
            want = plain(*args)
            err, tol = staged_error(name, got, want), staged_tolerance(name, args)
            check(err <= tol, f"staged {name} ({cell}): error {err} > {tol}")
            errs[name] = max(errs.get(name, 0.0), err)
            return got
        return op

    try:
        for name in sk.KERNELS:
            if ops == "plain":
                setattr(sk, f"{name}_op", sk.PAIRS[name][1])
            elif ops == "checked":
                setattr(sk, f"{name}_op", checked(name))
        return step(frames, ids, state)
    finally:
        for name, fn in saved.items():
            setattr(sk, f"{name}_op", fn)


def phase_staged_parity():
    """The staged lane step at the serving shape, DCP, top-1, refine, each
    cell two chained batches with an all-padding lane."""
    from repro_torch.core import (DehazeConfig, init_atmo_state_lanes,
                                  make_multi_stream_step)
    cells = [(torch.uint8, 1.0), (torch.float32, 1.0), (torch.bfloat16, 1.0),
             (torch.uint8, 1.0 / 2.2)]
    frames = ramps(3, 2 * L * B).reshape(2, L, B, H, W, 3)
    errs, whole = {}, {"vs_plain_J_t": 0.0, "vs_plain_a_seq": 0.0,
                       "vs_fused_J_t": 0.0, "vs_fused_a_seq": 0.0}
    for dt, gamma in cells:
        io = str(dt).replace("torch.", "")
        cfg = DehazeConfig(io_dtype=io, gamma=gamma)
        step = make_multi_stream_step(cfg, device="cuda")
        fused_step = make_multi_stream_step(
            DehazeConfig(io_dtype=io, gamma=gamma, kernel_mode="fused"),
            device="cuda")
        states = {k: init_atmo_state_lanes(L, "cuda")
                  for k in ("kernel", "plain", "fused")}
        for batch in range(2):
            cell = f"{io} gamma={gamma:.3f} b{batch}"
            img = to_wire(frames[batch].reshape(-1, 3), dt).reshape(
                L, B, H, W, 3).cuda()
            ids = (torch.arange(B, dtype=torch.int32) + B * batch).repeat(L, 1)
            ids[L - 1] = -1                                   # padding lane
            ids = ids.cuda()
            got = run_staged(step, img, ids, states["kernel"], "checked",
                             errs, cell)
            torch.cuda.synchronize()
            plain = run_staged(step, img, ids, states["plain"], "plain")
            fused = fused_step(img, ids, states["fused"])
            torch.cuda.synchronize()
            bf16 = got.frames.dtype == torch.bfloat16
            e_jt = max(max_err(got.frames, plain.frames),
                       max_err(got.transmission, plain.transmission))
            e_a = max(max_err(got.atmo_light, plain.atmo_light),
                      max_err(got.state.A, plain.state.A))
            tol = 2e-2 if bf16 else 1e-3
            check(e_jt <= tol, f"staged {cell}: J/t vs plain chain {e_jt} > {tol}")
            check(e_a <= (2e-2 if bf16 else 1e-5),
                  f"staged {cell}: a_seq/A vs plain chain {e_a}")
            check(torch.equal(got.state.last_update, plain.state.last_update)
                  and torch.equal(got.state.initialized,
                                  plain.state.initialized),
                  f"staged {cell}: last_update/initialized differ")
            check(torch.equal(got.state.A[L - 1], states["kernel"].A[L - 1])
                  and not bool(got.state.initialized[L - 1]),
                  f"staged {cell}: the all-padding lane's state changed")
            whole["vs_plain_J_t"] = max(whole["vs_plain_J_t"], e_jt)
            whole["vs_plain_a_seq"] = max(whole["vs_plain_a_seq"], e_a)
            if not bf16:                 # the fused step, at float32 output
                f_jt = max(max_err(got.frames, fused.frames),
                           max_err(got.transmission, fused.transmission))
                f_a = max(max_err(got.atmo_light, fused.atmo_light),
                          max_err(got.state.A, fused.state.A))
                check(f_jt <= 1e-3, f"staged {cell}: J/t vs fused {f_jt} > 1e-3")
                check(f_a <= 1e-5, f"staged {cell}: a_seq vs fused {f_a} > 1e-5")
                check(torch.equal(got.state.last_update,
                                  fused.state.last_update),
                      f"staged {cell}: last_update differs from fused")
                whole["vs_fused_J_t"] = max(whole["vs_fused_J_t"], f_jt)
                whole["vs_fused_a_seq"] = max(whole["vs_fused_a_seq"], f_a)
            states = {"kernel": got.state, "plain": plain.state,
                      "fused": fused.state}
        print(f"staged parity {io} gamma={gamma:.3f}: ok", flush=True)
        check_no_sync(step, img, ids, states["kernel"], f"staged {io}")
        check_no_sync(fused_step, img, ids, states["fused"], f"fused {io}")
    print("staged parity max errors: kernels " + json.dumps(errs)
          + " whole " + json.dumps(whole), flush=True)
    return errs, whole


def check_no_sync(step, frames, ids, state, label: str) -> None:
    """One step on device-resident inputs must make no synchronising CUDA
    call: a sync would also wait for the D2H copies of earlier ticks that
    the serve loop's completion threads have queued."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(frames, ids, state)
    except RuntimeError as e:
        fail(f"{label} step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------------------
# Phase 8: the staged kernels' times at the serving shape
# ---------------------------------------------------------------------------

def phase_staged_times():
    """Each staged kernel on the serving config's inputs (uint8 frames
    upcast to float32, 32 frames of 480x640). The bound counts each input
    read once and each output written once; of the atmospheric light's
    frames it counts the one pixel a frame that this data needs (its
    argmin t), not all of I."""
    from repro_torch.core import (DehazeConfig, init_atmo_state_lanes,
                                  make_multi_stream_step)
    from repro_torch.kernels import ref
    from repro_torch.kernels import staged as sk
    n = L * B
    npx = n * H * W
    x = ref.upcast_frames(to_wire(ramps(4, n).reshape(-1, 3), torch.uint8)
                          ).reshape(n, H, W, 3).cuda()
    dark = sk.cuda_dark_channel(x, 7)
    t_raw = 1.0 - 0.95 * dark
    mean = sk.cuda_box_filter(t_raw, 20)
    a = sk.cuda_atmolight(x, t_raw)
    J = sk.cuda_recover(x, t_raw, a, 0.1, 1.0)
    rows = torch.arange(n, device="cuda")
    # name -> (args, bytes moved, float32 operations, PyTorch call)
    work = {
        "dark_channel": ((x, 7), nbytes(x, dark), 4 * npx,
                         lambda: F.max_pool2d(-x.amin(-1)[:, None], 15, 1, 7)),
        "box_filter": ((t_raw, 20), nbytes(t_raw, mean), 5 * npx,
                       lambda: F.avg_pool2d(t_raw[:, None], 41, 1, 20,
                                            count_include_pad=False)),
        # t, then the picked pixel of I and a, each n x 3 floats
        "atmolight": ((x, t_raw), nbytes(t_raw, a, a), npx,
                      lambda: x.reshape(n, -1, 3)[
                          rows, t_raw.reshape(n, -1).argmin(-1)]),
        "recover": ((x, t_raw, a, 0.1, 1.0), nbytes(x, t_raw, a, J),
                    16 * npx, None),
    }
    out = {}
    # Whole lane steps on device-resident uint8 frames, back to back: the
    # CUDA-event time includes the gaps where the host launches slower than
    # the card runs.
    u8 = to_wire(ramps(4, n).reshape(-1, 3), torch.uint8).reshape(
        L, B, H, W, 3).cuda()
    ids = torch.arange(B, dtype=torch.int32).repeat(L, 1).cuda()
    for mode in ("auto", "fused"):
        step = make_multi_stream_step(
            DehazeConfig(io_dtype="uint8", kernel_mode=mode), device="cuda")
        state = init_atmo_state_lanes(L, "cuda")
        ms = time_ms(lambda: step(u8, ids, state))
        busy = device_busy_ms(lambda: step(u8, ids, state))
        print(f"lane step {mode} ({L} x {B} x {H}x{W} uint8) back to back: "
              f"{ms} ms a step, device busy "
              + ("not measured" if busy is None else
                 f"{busy} ms a step (idle share {1.0 - busy / ms})"),
              flush=True)
    for name, (args, nb, ops, lib) in work.items():
        kernel, plain = sk.PAIRS[name]
        t_bytes = nb / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
        out[name] = dict(
            ms=time_ms(lambda: kernel(*args)),
            plain_ms=time_ms(lambda: plain(*args), reps=5, warmup=1),
            library_ms=time_ms(lib) if lib else None,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    from repro_torch.core import DehazeConfig
    from repro_torch.kernels import _build, fused as fk, staged as sk
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    print(f"built {[p.name for p in built]} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(fk.TILE_PIXELS == fk._lib().fd_tile_pixels(), "tile size mismatch")
    sk._lib()                                # checks its tile constants

    pass_errs, whole_errs = phase_parity()
    cfg = DehazeConfig(kernel_mode="fused", io_dtype="uint8")
    rng = np.random.default_rng(1)
    vids = [rng.integers(0, 256, (48, H, W, 3), dtype=np.uint8)
            for _ in range(4)]
    launches, launches_serve, ticks = phase_serve(cfg, vids)
    rep = phase_throughput(cfg, vids)
    times = phase_times()

    staged_errs, staged_whole = phase_staged_parity()
    cfg_staged = DehazeConfig(io_dtype="uint8")            # kernel_mode "auto"
    s_launches, s_launches_serve, s_ticks = phase_serve(cfg_staged, vids,
                                                        staged=True)
    s_rep = phase_throughput(cfg_staged, vids, staged=True)
    s_times = phase_staged_times()

    kernels = []
    for name in ("fused_dehaze_lanes",) + fk.PASSES:
        r = times[name]
        err = (max(whole_errs.values()) if name == "fused_dehaze_lanes"
               else pass_errs[name])
        kernels.append({
            "name": name if name == "fused_dehaze_lanes"
            else f"fused_dehaze_lanes.{name}",
            "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name],
            "launches_serve": launches_serve[name],
            "launches_per_tick": launches[name] / ticks,
            "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
        print(f"{kernels[-1]['name']:36s} {r['ms']:9.4f} ms  bound "
              f"{r['bound_ms']:8.4f} ms ({r['bound_by']})  plain "
              f"{r['plain_ms']:9.3f} ms  library "
              f"{'-' if r['library_ms'] is None else '%.4f ms' % r['library_ms']}"
              f"  launches {launches[name]} on serve_many "
              f"({launches[name] / ticks:g}/tick), {launches_serve[name]} "
              f"on serve",
              flush=True)
    for name in sk.KERNELS:
        r = s_times[name]
        kernels.append({
            "name": f"staged.{name}", "route": "cuda",
            "source": STAGED_SOURCE, "replaces": STAGED_REPLACES[name],
            "launches": s_launches[f"staged.{name}"],
            "launches_serve": s_launches_serve[f"staged.{name}"],
            "launches_per_tick": s_launches[f"staged.{name}"] / s_ticks,
            "max_abs_err": staged_errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        print(f"{kernels[-1]['name']:36s} {r['ms']:9.4f} ms  bound "
              f"{r['bound_ms']:8.4f} ms ({r['bound_by']})  plain "
              f"{r['plain_ms']:9.3f} ms  library "
              f"{'-' if r['library_ms'] is None else '%.4f ms' % r['library_ms']}"
              f"  launches {kernels[-1]['launches']} on staged serve_many "
              f"({kernels[-1]['launches_per_tick']:g}/tick), "
              f"{kernels[-1]['launches_serve']} on staged serve",
              flush=True)
    print(f"serve_many aggregate fps: fused {rep.fps} ({rep.frames} frames, "
          f"{rep.wall_s} s), staged {s_rep.fps} ({s_rep.frames} frames, "
          f"{s_rep.wall_s} s); total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
