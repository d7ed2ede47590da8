"""Where a rung switch's serve-thread time goes, on the card.

    python3 tools/switch_probe.py

Run from the root of a checkout on a machine with an sm_90a card and
``nvcc``. It builds the kernels, then serves ``chip_smoke.py`` phase 16's
autoscaled ramp (7 uint8 480x640 streams, 5 of 48 frames and 2 of 192, a
(2, 4) ladder, ``dwell_up=1``, ``dwell_down=2``, a sink that takes each
frame's CRC-32) on the fused and the default (staged) path: twice on the
blocking tick path and once overlapped, each at the interpreter's default
thread switch interval (5 ms) and at 0.5 ms. For every switch it prints
the serve thread's seconds in each call ``repack_lanes`` makes (the new
state's fills, the index's ``pin_memory`` and ``to``, the gathers'
``index_select``), in ``repack_lanes`` and in the whole switch
(``_maybe_autoscale``), and the CUDA allocator's new segments
(``cudaMalloc``) during the repack; then each serve's ``switch_wall_s``.
"""
import concurrent.futures
import sys
import threading
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import DehazeConfig, normalize  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.stream import (ElasticServer, ScalePolicy,  # noqa: E402
                                StreamRequest)
from repro_torch.stream import scheduler as sch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("switch_probe: no CUDA device", file=sys.stderr)
        return 1
    srcs = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        list(pool.map(_build.build, srcs))
    print(cs.card_line(), flush=True)

    parts = []
    active = [False]
    serve_thread = threading.get_ident()

    def timed(name, fn):
        def call(*a, **k):
            if not active[0] or threading.get_ident() != serve_thread:
                return fn(*a, **k)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            parts.append((name, round(time.perf_counter() - t0, 6)))
            return out
        return call

    for name in ("pin_memory", "to", "index_select"):
        setattr(torch.Tensor, name, timed(name, getattr(torch.Tensor, name)))
    normalize.init_atmo_state_lanes = timed("fills",
                                            normalize.init_atmo_state_lanes)
    real_repack = normalize.repack_lanes
    real_switch = sch.MultiStreamScheduler._maybe_autoscale

    def segments() -> int:
        return torch.cuda.memory_stats().get("segment.all.allocated", 0)

    def timed_repack(packed, lanes, n):
        seg0 = segments()
        active[0] = True
        t0 = time.perf_counter()
        try:
            out = real_repack(packed, lanes, n)
        finally:
            active[0] = False
        parts.append(("repack_lanes", round(time.perf_counter() - t0, 6)))
        parts.append(("new_segments", segments() - seg0))
        return out

    def timed_switch(self, packed):
        n0 = self.n_lanes
        t0 = time.perf_counter()
        out = real_switch(self, packed)
        if self.n_lanes != n0:
            parts.append(("switch", round(time.perf_counter() - t0, 6)))
            print("switch", n0, "->", self.n_lanes, parts, flush=True)
        parts.clear()
        return out

    sch.repack_lanes = timed_repack
    sch.MultiStreamScheduler._maybe_autoscale = timed_switch

    rng = np.random.default_rng(1)
    vids = [rng.integers(0, 256, (48, cs.H, cs.W, 3), dtype=np.uint8)
            for _ in range(4)]
    ramp = [(f"r{i}", vids[i % 4]) for i in range(5)] + [
        (f"r{i}", np.concatenate([vids[i % 4]] * 4)) for i in (5, 6)]
    pol = ScalePolicy(rungs=(2, 4), dwell_up=1, dwell_down=2,
                      evict_tardy_after=None)
    for cfg in (DehazeConfig(kernel_mode="fused", io_dtype="uint8"),
                DehazeConfig(io_dtype="uint8")):
        for ov in (False, False, True):
            for interval in (0.005, 0.0005):
                sys.setswitchinterval(interval)
                print("cfg", cfg.kernel_mode, "overlap", ov,
                      "switchinterval", interval, flush=True)
                srv = ElasticServer(cfg, batch=8, timeout_s=2.0)
                rep = srv.serve_many(
                    [StreamRequest(s, iter(f)) for s, f in ramp], n_lanes=4,
                    autoscale=True, policy=pol, tick_overlap=ov,
                    sink=lambda s, f, x: zlib.crc32(x.numpy()))
                print("  switches", rep.ladder_switches, "switch_wall",
                      rep.switch_wall_s, flush=True)
    sys.setswitchinterval(0.005)
    return 0


if __name__ == "__main__":
    sys.exit(main())
