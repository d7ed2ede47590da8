"""PyTorch port, the fleet tier (``repro_torch.stream.fleet``), on the CPU,
held to the JAX package on the same seeded numpy inputs: the fleet cells
of ``tests/test_parity_matrix.py`` and ``tests/test_fleet.py`` ({1, 2}
hosts x {ref, fused} x {blocking, overlapped}) bit-equal to the port's
one-host serve (J, emission order, final states, cursors) with no
migration and, at 2 hosts under first-fit, a spillover; as many
admissions as the JAX fleet on the same streams, its J within 2e-4 and A
within 1e-5 (which host spills depends on how the host threads
interleave, so spillovers are counted, not compared); the hash policy
the reference's and sticky; duplicate ids refused; per-host ladders; and
the property that spillover never migrates a stream. Frames are 12x16, ``gf_radius=2``, ``update_period=2``."""
import threading

import numpy as np
import pytest
import torch

from repro.core import DehazeConfig as JaxConfig
from repro.stream import ElasticServer as JaxServer
from repro.stream import StreamRequest as JaxRequest
from repro.stream.fleet import _resolve_policy as jax_resolve_policy
from repro_torch.core import DehazeConfig, PlacementSpec
from repro_torch.stream import ElasticServer, StreamRequest
from repro_torch.stream.fleet import _FleetQueue, _resolve_policy
from repro_torch.stream.scheduler import _Resume

from _torch_common import as_np

torch.set_num_threads(1)

ATOL = 2e-4          # pipeline level, tests/test_fused.py
A_ATOL = 1e-5
KW = dict(gf_radius=2, update_period=2)


def _videos(n, length, seed=5, h=12, w=16):
    rng = np.random.default_rng(seed)
    return [[rng.random((h, w, 3)).astype(np.float32) for _ in range(length)]
            for _ in range(n)]


def _serve(srv, request, vids, spill=False, **kw):
    """Serve ``vids`` as streams s0, s1, ...: ``(report, frames by stream,
    final states)``. ``spill`` forces a first-fit spill on 2 hosts x 2
    lanes: s0 and s1, which host 0 admits first, hold their second tick
    (frames from ``srv.batch``) until another stream's first frame has been
    taken, which only host 1 can do, and only once host 0's lanes are both
    claimed."""
    got, gate = {}, threading.Event()

    def frames(i, v):
        if not spill:
            return iter(v)
        return (_gated(v, gate, hold_from=srv.batch) if i < 2
                else _gated(v, gate, opens=True))
    rep = srv.serve_many(
        [request(f"s{i}", frames(i, v)) for i, v in enumerate(vids)],
        sink=lambda sid, fid, f: got.setdefault(sid, []).append(
            (fid, as_np(f))), **kw)
    assert gate.is_set() == spill
    finals = {f"s{i}": srv.store.get(f"s{i}") for i in range(len(vids))}
    return rep, got, finals


@pytest.fixture(scope="module")
def references():
    """By kernel mode: the port's one-host 2-lane serve of 6 streams of 8
    frames (the oracle of every cell) and the JAX 2-host fleet's."""
    cache = {}

    def get(mode):
        if mode not in cache:
            base = ElasticServer(DehazeConfig(kernel_mode=mode, **KW),
                                 batch=4, timeout_s=5.0, device="cpu")
            jsrv = JaxServer(JaxConfig(kernel_mode=mode, **KW), batch=4,
                             timeout_s=5.0)
            jax_run = _serve(jsrv, JaxRequest, _videos(6, 8), spill=True,
                             n_lanes=2, n_hosts=2)
            cache[mode] = (_serve(base, StreamRequest, _videos(6, 8),
                                  n_lanes=2), base, jax_run, jsrv)
        return cache[mode]
    return get


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mode", ["ref", "fused"])
@pytest.mark.parametrize("n_hosts", [1, 2])
def test_fleet_serve_matches_single_host(n_hosts, mode, overlap, references):
    """Per stream: the emitted frames (J carries the EMA trajectory), their
    order, the final state and the cursor bit-equal to the one-host serve;
    no migration; at 2 hosts first-fit spills (forced, in both packages:
    ``_serve``'s ``spill``), every admission lands on the stream's
    placement, and as many admissions as the JAX fleet, its J within 2e-4
    and A within 1e-5."""
    (rep_w, want, fin_w), base, (jrep, jgot, jfin), jsrv = references(mode)
    assert rep_w.frames == 48 and rep_w.skipped == 0
    srv = ElasticServer(DehazeConfig(kernel_mode=mode, **KW), batch=4,
                        timeout_s=5.0, device="cpu")
    rep, got, fin = _serve(srv, StreamRequest, _videos(6, 8),
                           spill=n_hosts > 1, n_lanes=2, n_hosts=n_hosts,
                           tick_overlap=overlap)
    assert rep.frames == 48 and rep.skipped == 0 and rep.stragglers == 0
    assert rep.n_hosts == n_hosts and rep.migrations == 0
    assert rep.overlap_ticks == (rep.ticks if overlap else 0)
    if n_hosts > 1:
        assert rep.n_lanes == 4 and rep.spillovers >= 1
        queue = srv.last_fleet.queue
        assert sorted(queue.placements) == [f"s{i}" for i in range(6)]
        for entry in queue.admission_log:
            assert entry["host"] == queue.placements[entry["stream_id"]]
        assert rep.admissions == jrep.admissions == 6
        assert jrep.migrations == 0 and jrep.spillovers >= 1
    for sid in want:
        fids = [f for f, _ in got[sid]]
        assert fids == [f for f, _ in want[sid]] == list(range(8))
        for (_, a), (_, b) in zip(got[sid], want[sid]):
            np.testing.assert_array_equal(a, b)
        for f in ("A", "last_update", "initialized"):
            assert torch.equal(getattr(fin[sid], f), getattr(fin_w[sid], f))
        assert srv.store.cursor(sid) == base.store.cursor(sid) == 8
        assert [f for f, _ in jgot[sid]] == fids
        for (_, a), (_, b) in zip(got[sid], jgot[sid]):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
        np.testing.assert_allclose(as_np(fin[sid].A), as_np(jfin[sid].A),
                                   atol=A_ATOL, rtol=0)


def test_fleet_duplicate_stream_ids_rejected():
    srv = ElasticServer(DehazeConfig(kernel_mode="ref", **KW), batch=4,
                        timeout_s=5.0, device="cpu")
    v = _videos(2, 3)
    with pytest.raises(ValueError, match="duplicate"):
        srv.serve_many([StreamRequest("dup", iter(v[0])),
                        StreamRequest("dup", iter(v[1]))],
                       n_lanes=1, n_hosts=2)


def test_fleet_hash_policy_spreads_and_stays_sticky():
    """The hash policy prefers the CRC32 host of each id, as the
    reference's does: both hosts serve, every admission on the stream's
    placement and, unless it spilled, on its preferred host; no
    migration, as on the JAX fleet."""
    srv = ElasticServer(DehazeConfig(kernel_mode="ref", **KW), batch=4,
                        timeout_s=5.0, device="cpu")
    rep, got, _ = _serve(srv, StreamRequest, _videos(8, 4), n_lanes=2,
                         n_hosts=2, placement_policy="hash")
    assert rep.frames == 32 and rep.migrations == 0
    queue = srv.last_fleet.queue
    assert {e["host"] for e in queue.admission_log} == {0, 1}
    for e in queue.admission_log:
        assert e["host"] == queue.placements[e["stream_id"]]
    assert all([f for f, _ in got[sid]] == list(range(4)) for sid in got)
    prefer = _resolve_policy("hash", 2)
    jprefer = jax_resolve_policy("hash", 2)
    assert [prefer(f"s{i}") for i in range(8)] == \
        [jprefer(f"s{i}") for i in range(8)]
    assert {prefer(f"s{i}") for i in range(8)} == {0, 1}
    for e in queue.admission_log:
        assert e["spillover"] or e["host"] == prefer(e["stream_id"])
    assert sum(e["spillover"] for e in queue.admission_log) == rep.spillovers
    jsrv = JaxServer(JaxConfig(kernel_mode="ref", **KW), batch=4,
                     timeout_s=5.0)
    jrep, _, _ = _serve(jsrv, JaxRequest, _videos(8, 4), n_lanes=2,
                        n_hosts=2, placement_policy="hash")
    assert jrep.frames == rep.frames and jrep.migrations == 0
    assert callable(_resolve_policy(lambda sid: 3, 2))
    assert _resolve_policy(lambda sid: 3, 2)("x") == 1
    with pytest.raises(ValueError, match="placement_policy"):
        _resolve_policy("round-robin", 2)


def _gated(frames, gate: threading.Event, hold_from: int = None,
           opens: bool = False):
    """``frames`` one by one: from ``hold_from`` on, each waits for
    ``gate`` (at most 30 s); ``opens`` sets it once the first frame is
    taken."""
    for i, f in enumerate(frames):
        if hold_from is not None and i >= hold_from:
            gate.wait(timeout=30.0)
        if opens:
            gate.set()
        yield f


def test_fleet_placement_and_default_lanes():
    """``n_hosts`` rides on the placement (validated, as the reference's
    ``lane_batched(n_hosts=2)`` is), and the default lanes per host are
    ceil(streams / hosts). The spill is forced: 5 streams of two 2-frame
    ticks on 2 hosts x 3 lanes, first-fit; the three streams host 0
    admits hold their second tick until a stream's first frame has been
    taken, which only host 1 can do, and only once host 0's three lanes
    are all claimed."""
    assert PlacementSpec.lane_batched(n_hosts=2).n_hosts == 2
    srv = ElasticServer(DehazeConfig(kernel_mode="ref", **KW), batch=2,
                        timeout_s=5.0, device="cpu")
    gate = threading.Event()
    reqs = [StreamRequest(f"s{i}", _gated(v, gate, hold_from=2) if i < 3
                          else _gated(v, gate, opens=True))
            for i, v in enumerate(_videos(5, 4))]
    rep = srv.serve_many(reqs, sink=lambda sid, fid, f: None,
                         placement=PlacementSpec.lane_batched(n_hosts=2))
    assert gate.is_set()
    assert rep.n_hosts == 2 and rep.n_lanes == 6 and rep.frames == 20
    assert rep.migrations == 0 and rep.spillovers >= 1     # 5 > 3 lanes
    queue = srv.last_fleet.queue
    assert {queue.placements[f"s{i}"] for i in range(3)} == {0}
    assert queue.placements["s3"] == 1


def test_fleet_autoscale_per_host_ladders():
    """Each host walks a ladder of its own (the rungs' steps shared), and
    the fleet stays bit-equal to the one-host fixed-lane serve."""
    cfg = DehazeConfig(kernel_mode="ref", **KW)
    from repro_torch.stream import ScalePolicy
    vids = _videos(6, 8, seed=9)
    base = ElasticServer(cfg, batch=2, timeout_s=5.0, device="cpu")
    _, want, fin_w = _serve(base, StreamRequest, vids, n_lanes=2)
    srv = ElasticServer(cfg, batch=2, timeout_s=5.0, device="cpu")
    rep, got, fin = _serve(srv, StreamRequest, vids, n_lanes=2, n_hosts=2,
                           autoscale=True,
                           policy=ScalePolicy(rungs=(1, 2), dwell_up=1,
                                              dwell_down=1,
                                              evict_tardy_after=None))
    assert rep.frames == 48 and rep.migrations == 0 and rep.warm_failures == 0
    for sid in want:
        assert [f for f, _ in got[sid]] == list(range(8))
        for (_, a), (_, b) in zip(got[sid], want[sid]):
            np.testing.assert_array_equal(a, b)
        assert torch.equal(fin[sid].A, fin_w[sid].A)


# --- the sticky/spillover no-migration property ------------------------------------

def _drive_queue(n_streams, n_hosts, lanes, prefs, choices,
                 max_preemptions=64):
    """Replay a schedule against the shared queue: hosts pop in turn,
    admitted streams finish or are preempted and requeued (pinned), until
    the queue drains. Preemptions stop after ``max_preemptions``, so a
    schedule that would preempt forever (a choice sequence of zeros, the
    first example hypothesis tries) still drains."""
    q = _FleetQueue(n_hosts, lanes, lambda sid: prefs[sid])
    for i in range(n_streams):
        q.seed(StreamRequest(f"s{i}", iter(())))
    live, occupied, step, preempted = [], [0] * n_hosts, 0, 0
    while True:
        acted = False
        for h in range(n_hosts):
            if occupied[h] < lanes:
                got = q.pop_for(h)
                if got is not None:
                    occupied[h] += 1
                    live.append((h, got[1]))
                    acted = True
        if live:
            step += 1
            h, req = live.pop(choices(step) % len(live))
            occupied[h] -= 1
            if choices(step + 1) % 3 == 0 and preempted < max_preemptions:
                preempted += 1
                resume = _Resume(None, 0, threading.Event())
                resume.barrier.set()
                q.push_requeue(req, resume, pin=h)
            else:
                q.note_freed(h)
            acted = True
        if not acted:
            break
    return q


def _check_sticky(q):
    assert q.migrations == 0 and not q._entries
    hosts = {}
    for e in q.admission_log:
        hosts.setdefault(e["stream_id"], set()).add(e["host"])
    assert all(len(h) == 1 for h in hosts.values()), hosts
    for e in q.admission_log:
        if e["resumed"]:
            assert not e["spillover"]


@pytest.mark.parametrize("seed", range(6))
def test_sticky_spillover_never_migrates(seed):
    rng = np.random.default_rng(seed)
    n_streams, n_hosts, lanes = 7, 3, 2
    prefs = {f"s{i}": int(rng.integers(n_hosts)) for i in range(n_streams)}
    seq = rng.integers(0, 1_000_000, size=4096)
    _check_sticky(_drive_queue(n_streams, n_hosts, lanes, prefs,
                               lambda step: int(seq[step % len(seq)])))


def test_sticky_spillover_never_migrates_property():
    pytest.importorskip("hypothesis",
                        reason="property tests need hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=60, deadline=None)
    @given(st.integers(1, 4), st.integers(1, 3), st.integers(1, 10),
           st.data())
    def prop(n_hosts, lanes, n_streams, data):
        prefs = {f"s{i}": data.draw(st.integers(0, n_hosts - 1))
                 for i in range(n_streams)}
        seq = data.draw(st.lists(st.integers(0, 10 ** 6), min_size=64,
                                 max_size=64))
        _check_sticky(_drive_queue(n_streams, n_hosts, lanes, prefs,
                                   lambda step: seq[step % len(seq)]))

    prop()
