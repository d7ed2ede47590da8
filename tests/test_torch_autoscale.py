"""PyTorch port, elastic lane autoscaling and deadline-aware eviction
(``repro_torch.stream.autoscale``, the scheduler's ``_switch_lanes`` and
``_evict_tardy``), on the CPU, held to the JAX package on the same seeded
numpy inputs: ``ladder_rungs`` and ``LaneAutoscaler.observe`` equal to the
reference's; the hysteresis, warm-up and retry rules of
``tests/test_autoscale.py`` and ``tests/test_regressions.py``; the
autoscaled ramp bit-equal to the port's fixed-lane serve and within the
pipeline tolerance (J 2e-4, A 1e-5) of the JAX package's autoscaled
serve; the eviction cells against the JAX server's run. Frames are 12x16,
``gf_radius=2``, ``update_period=2``."""
import threading
import types

import numpy as np
import pytest
import torch

from repro.core import DehazeConfig as JaxConfig
from repro.stream import ElasticServer as JaxServer
from repro.stream import LaneAutoscaler as JaxAutoscaler
from repro.stream import ScalePolicy as JaxPolicy
from repro.stream import StreamRequest as JaxRequest
from repro.stream import ladder_rungs as jax_ladder_rungs
from repro_torch.core import DehazeConfig, init_atmo_state_lanes
from repro_torch.core.normalize import repack_lanes
from repro_torch.stream import (ElasticServer, LaneAutoscaler, ScalePolicy,
                                StreamRequest, ladder_rungs)
from repro_torch.stream.autoscale import WARM_MAX_ATTEMPTS
from repro_torch.stream.elastic import _cached_multi_step
from repro_torch.stream.scheduler import ServeReport

from _torch_common import as_np

torch.set_num_threads(1)

ATOL = 2e-4          # pipeline level, tests/test_fused.py
A_ATOL = 1e-5
KW = dict(gf_radius=2, update_period=2)
CPU = torch.device("cpu")


def _videos(lengths, seed, h=12, w=16):
    rng = np.random.default_rng(seed)
    return [[rng.random((h, w, 3)).astype(np.float32) for _ in range(k)]
            for k in lengths]


def _spin_until(cond, timeout=10.0):
    import time
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "condition not reached"
        time.sleep(0.005)


# --- the ladder ----------------------------------------------------------------

@pytest.mark.parametrize("rungs,cap", [((4, 8, 16, 32), 6), ((4, 8, 16, 32), 32),
                                       ((4, 8), 16), ((4, 8), 2),
                                       ((8, 4, 8), 8), ((2, 4), 4)])
def test_ladder_rungs_match_reference(rungs, cap):
    assert ladder_rungs(rungs, cap) == jax_ladder_rungs(rungs, cap)
    with pytest.raises(ValueError):
        ladder_rungs(rungs, 0)


# --- hysteresis (fake steps) ---------------------------------------------------

def _fake_factory(built=None):
    def factory(n):
        if built is not None:
            built.append(n)
        return lambda frames, ids, state: types.SimpleNamespace(state=state)
    return factory


def _fake_scaler(rungs=(2, 4, 8), **pol_kw):
    built = []
    sc = LaneAutoscaler(_fake_factory(built), rungs,
                        policy=ScalePolicy(rungs=rungs, **pol_kw),
                        state_factory=lambda n: np.zeros((n,), np.float32),
                        device="cpu")
    return sc, built


def _warm_all(sc, shape=(2, 4, 4, 3)):
    sc.ensure_warming(shape)
    assert sc.wait_warm(timeout=10.0)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dwell", [(1, 1), (1, 2), (2, 4)])
def test_observe_matches_reference(seed, dwell):
    """The same seeded trace of (pending, occupied) samples, every rung
    ready: the port's decisions (switches committed as they come) equal
    the JAX autoscaler's, tick for tick."""
    rungs = (2, 4, 8)
    kw = dict(rungs=rungs, dwell_up=dwell[0], dwell_down=dwell[1])
    ours = LaneAutoscaler(_fake_factory(), rungs, policy=ScalePolicy(**kw),
                          state_factory=lambda n: None, device="cpu")
    ref = JaxAutoscaler(_fake_factory(), rungs, policy=JaxPolicy(**kw),
                        state_factory=lambda n: np.zeros((n,), np.float32))
    for sc in (ours, ref):
        sc.acquire_initial()
        sc.ensure_warming((2, 4, 4, 3))
        assert sc.wait_warm(timeout=10.0)
        assert all(sc.is_ready(r) for r in rungs)
    rng = np.random.default_rng(seed)
    decisions = 0
    for _ in range(200):
        pending = int(rng.integers(0, 3)) * int(rng.integers(0, 2))
        occupied = int(rng.integers(0, ours.rung + 1))
        got = ours.observe(pending, occupied)
        assert got == ref.observe(pending, occupied)
        if got is not None:
            decisions += 1
            ours.commit(got)
            ref.commit(got)
        assert ours.rung == ref.rung
    assert decisions > 0
    assert [(s["from"], s["to"]) for s in ours.switches] == \
        [(s["from"], s["to"]) for s in ref.switches]


def test_grow_requires_dwell_and_resets_on_break():
    sc, _ = _fake_scaler(dwell_up=2, dwell_down=2)
    sc.acquire_initial()
    _warm_all(sc)
    assert sc.observe(pending=3, occupied=2) is None
    assert sc.observe(pending=0, occupied=1) is None      # break resets
    assert sc.observe(pending=3, occupied=2) is None
    assert sc.observe(pending=3, occupied=2) == 4
    sc.commit(4)
    assert sc.rung == 4 and sc.switches[0]["from"] == 2 \
        and sc.switches[0]["to"] == 4


def test_shrink_requires_empty_queue_and_fit():
    sc, _ = _fake_scaler(dwell_up=1, dwell_down=2)
    sc.acquire_initial()
    _warm_all(sc)
    sc.commit(8)
    assert sc.observe(pending=0, occupied=7) is None
    assert sc.observe(pending=1, occupied=2) is None
    assert sc.observe(pending=0, occupied=3) is None
    assert sc.observe(pending=0, occupied=4) == 4
    sc.commit(4)
    assert sc.switches[-1] == {"from": 8, "to": 4, "wall_s": 0.0}


def test_no_thrash_on_alternating_load():
    sc, _ = _fake_scaler(dwell_up=2, dwell_down=2)
    sc.acquire_initial()
    _warm_all(sc)
    sc.commit(4)
    for _ in range(10):
        assert sc.observe(pending=2, occupied=4) is None
        assert sc.observe(pending=0, occupied=1) is None
    assert sc.rung == 4 and len(sc.switches) == 1


def test_unwarm_rung_defers_switch():
    sc, built = _fake_scaler(dwell_up=2)
    sc.acquire_initial()
    assert sc.observe(pending=3, occupied=2) is None
    assert sc.observe(pending=3, occupied=2) is None      # dwell met, cold
    assert built == [2]
    _warm_all(sc)
    assert sc.observe(pending=3, occupied=2) == 4


def test_top_and_bottom_rungs_are_sticky():
    sc, _ = _fake_scaler(rungs=(2, 4), dwell_up=1, dwell_down=1)
    sc.acquire_initial()
    _warm_all(sc)
    for _ in range(3):
        assert sc.observe(pending=0, occupied=0) is None
    sc.commit(4)
    for _ in range(3):
        assert sc.observe(pending=9, occupied=4) is None
    assert sc.rung == 4


# --- warm-ups --------------------------------------------------------------------

def test_ladder_warms_off_the_serve_thread():
    """Every rung past the first is built and called by the warm thread
    (the call is what builds and launches the kernels on the card), at the
    wire dtype asked for, and a switch is then a lookup of that step."""
    cfg = DehazeConfig(kernel_mode="ref", gf_radius=3, update_period=3)
    rungs = ladder_rungs((2, 4), 4)
    calls = []

    def factory(n):
        step = _cached_multi_step(cfg, n, False, CPU)

        def call(frames, ids, state):
            calls.append((n, threading.get_ident(), frames.dtype,
                          tuple(frames.shape)))
            return step(frames, ids, state)
        call.built_by = threading.get_ident()
        return call

    sc = LaneAutoscaler(factory, rungs, device="cpu")
    main = threading.get_ident()
    assert sc.acquire_initial().built_by == main
    sc.ensure_warming((2, 12, 16, 3), torch.uint8)
    assert sc.wait_warm(timeout=60.0, raise_on_error=True)
    assert all(sc.is_ready(r) for r in rungs)
    assert calls == [(4, calls[0][1], torch.uint8, (4, 2, 12, 16, 3))]
    assert calls[0][1] != main and sc.step_for(4).built_by == calls[0][1]
    assert [e["rung"] for e in sc.warm_log] == [4]
    assert sc.warm_log[0]["thread"] == calls[0][1] \
        and sc.warm_log[0]["s"] > 0


class _FlakyRungFactory:
    """A step factory whose rung-8 build fails ``fail_times`` times."""

    def __init__(self, fail_times):
        self.fail_times = fail_times
        self.attempts = {}

    def __call__(self, rung):
        self.attempts[rung] = self.attempts.get(rung, 0) + 1
        if rung == 8 and self.attempts[rung] <= self.fail_times:
            raise RuntimeError(f"rung {rung} failed to build")
        return _fake_factory()(rung)


def _flaky_scaler(fail_times):
    factory = _FlakyRungFactory(fail_times)
    sc = LaneAutoscaler(factory, rungs=(4, 8),
                        policy=ScalePolicy(rungs=(4, 8), dwell_up=2),
                        state_factory=lambda n: None, device="cpu")
    sc.acquire_initial()
    sc.ensure_warming((1, 8, 8, 3))
    sc.wait_warm(timeout=5.0)
    return sc, factory


def test_warm_failure_surfaced_and_retried_once():
    sc, factory = _flaky_scaler(fail_times=1)
    assert 8 in sc.warm_errors and sc.warm_failures == 1
    assert sc.observe(pending=2, occupied=4) is None
    assert sc.observe(pending=2, occupied=4) is None      # kicks the retry
    _spin_until(lambda: sc.is_ready(8))
    assert sc.warm_errors == {} and sc.warm_failures == 0
    assert sc.observe(pending=2, occupied=4) == 8
    assert factory.attempts[8] == 2


def test_warm_failure_permanent_raises_on_request():
    sc, factory = _flaky_scaler(fail_times=10 ** 9)
    for _ in range(4):
        sc.observe(pending=2, occupied=4)
        sc.wait_warm(timeout=5.0)
    assert factory.attempts[8] == WARM_MAX_ATTEMPTS
    assert sc.warm_failures == 1 and not sc.is_ready(8)
    with pytest.raises(RuntimeError, match="rung"):
        sc.wait_warm(timeout=5.0, raise_on_error=True)


def test_warm_failure_rides_the_serve_report(monkeypatch):
    """A rung that never warms is counted on the report of the serve that
    wanted it, and the serve stays at its rung: no silent fallback."""
    from repro_torch.stream import autoscale
    real = autoscale.LaneAutoscaler._warm_call

    def broken(self, step, rung, shape):
        if rung == 4:
            raise RuntimeError("rung 4 failed to launch")
        return real(self, step, rung, shape)

    monkeypatch.setattr(autoscale.LaneAutoscaler, "_warm_call", broken)
    srv = ElasticServer(DehazeConfig(kernel_mode="ref", **KW), batch=2,
                        timeout_s=5.0, device="cpu")
    rep = srv.serve_many(
        [StreamRequest(f"s{i}", iter(v))
         for i, v in enumerate(_videos([6, 6, 6], seed=3))], n_lanes=4,
        autoscale=True, policy=ScalePolicy(rungs=(2, 4), dwell_up=1))
    assert rep.warm_failures == 1 and rep.ladder_switches == 0
    assert rep.n_lanes == 2 and rep.frames == 18 and rep.skipped == 0
    assert ServeReport(per_stream={}, frames=0, skipped=0, wall_s=0.0,
                       n_lanes=4, ticks=0, warm_failures=2).warm_failures == 2


# --- the repack ------------------------------------------------------------------

def test_repack_lanes_gathers_rows_bit_exactly():
    rng = np.random.default_rng(8)
    packed = init_atmo_state_lanes(4)
    packed.A.copy_(torch.from_numpy(rng.random((4, 3)).astype(np.float32)))
    packed.last_update.copy_(torch.tensor([3, -1, 7, 11], dtype=torch.int32))
    packed.initialized.copy_(torch.tensor([True, False, True, True]))
    before = packed.clone()
    out = repack_lanes(packed, [3, 0], 2)
    for f in ("A", "last_update", "initialized"):
        assert torch.equal(getattr(out, f), getattr(before, f)[[3, 0]])
        assert torch.equal(getattr(packed, f), getattr(before, f))
    grown = repack_lanes(packed, [2], 4)
    fresh = init_atmo_state_lanes(3)
    for f in ("A", "last_update", "initialized"):
        assert torch.equal(getattr(grown, f)[0], getattr(before, f)[2])
        assert torch.equal(getattr(grown, f)[1:], getattr(fresh, f))


# --- the autoscaled ramp -----------------------------------------------------------

LENGTHS = [8, 8, 8, 8, 8, 40, 40]
RAMP_POLICY = dict(rungs=(2, 4), grow_pending=1, dwell_up=1, dwell_down=1,
                   evict_tardy_after=None)


def _ramp(srv, request, **kw):
    outs, order = {}, {}

    def sink(sid, fid, f):
        outs[(sid, fid)] = as_np(f)
        order.setdefault(sid, []).append(fid)

    rep = srv.serve_many([request(f"s{i}", iter(v)) for i, v in
                          enumerate(_videos(LENGTHS, seed=41))], n_lanes=4,
                         sink=sink, **kw)
    finals = {f"s{i}": srv.store.get(f"s{i}") for i in range(len(LENGTHS))}
    return rep, outs, order, finals


@pytest.fixture(scope="module")
def jax_ramps():
    """The JAX package's autoscaled ramp, by kernel mode (run once)."""
    cache = {}

    def get(mode):
        if mode not in cache:
            srv = JaxServer(JaxConfig(kernel_mode=mode, **KW), batch=2,
                            timeout_s=5.0)
            cache[mode] = _ramp(srv, JaxRequest, autoscale=True,
                                policy=JaxPolicy(**RAMP_POLICY))
        return cache[mode]
    return get


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mode", ["ref", "fused"])
def test_autoscale_ramp_matches_fixed_lanes_and_reference(mode, overlap,
                                                          jax_ramps):
    """Five short streams and two long ones on a (2, 4) ladder: the
    backlog grows the ladder and the tail shrinks it; every frame once and
    in order, and J, the final states and the cursors bit-equal to a fixed
    4-lane serve, and within 2e-4 (A 1e-5) of the JAX autoscaled serve."""
    cfg = DehazeConfig(kernel_mode=mode, **KW)
    fixed = _ramp(ElasticServer(cfg, batch=2, timeout_s=5.0, device="cpu"),
                  StreamRequest, tick_overlap=overlap)
    srv = ElasticServer(cfg, batch=2, timeout_s=5.0, device="cpu")
    rep, outs, order, finals = _ramp(srv, StreamRequest, autoscale=True,
                                     policy=ScalePolicy(**RAMP_POLICY),
                                     tick_overlap=overlap)
    assert fixed[0].ladder_switches == 0 and fixed[0].n_lanes == 4
    assert rep.ladder_switches >= 2 and rep.n_lanes == 2
    assert rep.warm_failures == 0 and rep.evictions == 0
    assert rep.stragglers == 0
    assert rep.overlap_ticks == (rep.ticks if overlap else 0)
    assert rep.frames == sum(LENGTHS) and rep.skipped == 0
    for i, n in enumerate(LENGTHS):
        assert order[f"s{i}"] == list(range(n))
        assert srv.store.cursor(f"s{i}") == n
    _, f_outs, _, f_finals = fixed
    assert outs.keys() == f_outs.keys()
    for k in outs:
        np.testing.assert_array_equal(outs[k], f_outs[k])
    for sid, st in finals.items():
        for f in ("A", "last_update", "initialized"):
            assert torch.equal(getattr(st, f), getattr(f_finals[sid], f))

    jrep, jouts, jorder, jfinals = jax_ramps(mode)
    assert jrep.frames == rep.frames and jorder == order
    for k in jouts:
        np.testing.assert_allclose(outs[k], jouts[k], atol=ATOL, rtol=0)
    for sid in jfinals:
        np.testing.assert_allclose(as_np(finals[sid].A),
                                   as_np(jfinals[sid].A), atol=A_ATOL, rtol=0)


# --- deadline-aware eviction -------------------------------------------------------

def _evict_cell(server, request, policy, streams, clock, pulled=None,
                **kw):
    """Serve ``streams`` on one lane: ``(report, (stream, frame id) in the
    sink's order)``. Each stream's monitor thread calls the sink on its
    own, so that order holds within a stream only. ``pulled``, if given,
    gets ``(stream, frame index)`` in the order the server takes frames
    from the requests' iterators, which is the order of its ticks."""
    seq = []

    def frames(sid, v):
        for i, f in enumerate(v):
            if pulled is not None:
                pulled.append((sid, i))
            yield f
    rep = server.serve_many([request(sid, frames(sid, v), **req_kw)
                             for sid, v, req_kw in streams], n_lanes=1,
                            sink=lambda sid, fid, f: seq.append((sid, fid)),
                            policy=policy, clock=clock, **kw)
    return rep, seq


@pytest.mark.parametrize("overlap", [False, True])
def test_tardy_stream_checkpoints_requeues_and_resumes(overlap):
    """A past-deadline stream holding the only lane is preempted after 2
    ticks: the waiter serves (its frames taken before the tardy stream's
    last), the tardy stream resumes from its checkpoint
    (the same iterator: no frame twice), the same evictions, admissions
    and per-stream frames as the JAX server, its final A within 1e-5 of
    the reference's and bit-equal to an uninterrupted serve's."""
    cfg = DehazeConfig(kernel_mode="ref", **KW)
    tardy, waiter = _videos([12, 4], seed=53)
    streams = [("tardy", tardy, dict(deadline=0.0)), ("waiter", waiter, {})]
    srv = ElasticServer(cfg, batch=2, timeout_s=5.0, device="cpu")
    pulled = []
    rep, seq = _evict_cell(srv, StreamRequest,
                           ScalePolicy(evict_tardy_after=2), streams,
                           lambda: 100.0, pulled=pulled, tick_overlap=overlap)
    assert rep.overlap_ticks == (rep.ticks if overlap else 0)
    jsrv = JaxServer(JaxConfig(kernel_mode="ref", **KW), batch=2,
                     timeout_s=5.0)
    jrep, jseq = _evict_cell(jsrv, JaxRequest,
                             JaxPolicy(evict_tardy_after=2), streams,
                             lambda: 100.0)
    assert rep.evictions == jrep.evictions == 1
    assert rep.admissions == jrep.admissions == 3
    assert rep.ladder_switches == 0 and rep.frames == 16 and rep.skipped == 0
    for sid in ("tardy", "waiter"):
        assert rep.per_stream[sid].frames == jrep.per_stream[sid].frames
        got = [fid for s, fid in seq if s == sid]
        assert got == [fid for s, fid in jseq if s == sid]
        assert got == list(range(rep.per_stream[sid].frames))
    # The waiter is served before the tardy stream's last tick.
    assert pulled.index(("waiter", 3)) < pulled.index(("tardy", 11))
    assert srv.store.cursor("tardy") == 12
    np.testing.assert_allclose(as_np(srv.store.get("tardy").A),
                               as_np(jsrv.store.get("tardy").A),
                               atol=A_ATOL, rtol=0)
    solo = ElasticServer(cfg, batch=2, timeout_s=5.0, device="cpu")
    solo.serve_many([StreamRequest("tardy", iter(tardy))], n_lanes=1)
    for f in ("A", "last_update", "initialized"):
        assert torch.equal(getattr(srv.store.get("tardy"), f),
                           getattr(solo.store.get("tardy"), f))


def test_no_eviction_without_waiters_or_before_deadline():
    """Eviction needs a blown deadline, the dwell and a queue, as on the
    JAX server."""
    cfg = DehazeConfig(kernel_mode="ref", **KW)
    jcfg = JaxConfig(kernel_mode="ref", **KW)
    solo = _videos([8], seed=61)
    ok, queued = _videos([8, 4], seed=67)
    cells = [([("solo", solo[0], dict(deadline=0.0))], lambda: 100.0),
             ([("ok", ok, dict(deadline=1e9)), ("queued", queued, {})],
              lambda: 0.0)]
    for streams, clock in cells:
        rep, seq = _evict_cell(
            ElasticServer(cfg, batch=2, timeout_s=5.0, device="cpu"),
            StreamRequest, ScalePolicy(evict_tardy_after=1), streams, clock)
        jrep, jseq = _evict_cell(JaxServer(jcfg, batch=2, timeout_s=5.0),
                                 JaxRequest, JaxPolicy(evict_tardy_after=1),
                                 streams, clock)
        assert rep.evictions == jrep.evictions == 0
        assert rep.admissions == jrep.admissions == len(streams)
        assert rep.frames == jrep.frames and rep.skipped == 0
        assert sorted(seq) == sorted(jseq)
