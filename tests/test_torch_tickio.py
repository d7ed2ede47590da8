"""PyTorch port, zero-copy tick I/O: the donation contract of ``make_step``
(``donate="state"`` / ``True``), ``stream.iobuf``'s lane buffer adapter
and the overlapped serve paths, on the CPU (``device="cpu"``), held to the
JAX package on the same seeded numpy inputs: ``donation_spec`` and
``fetch_valid`` equal to the reference's, the overlapped serves bit-equal
to the port's blocking ones and within the pipeline tolerance of
``tests/test_fused.py`` (2e-4; final A 1e-5) of the JAX package's, with
the same ``d2h_bytes`` on each path. Shapes and configs follow
``tests/test_tickio.py``: 12x16 frames, ``gf_radius=2``,
``update_period=2``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import DehazeConfig as JaxConfig
from repro.core import PlacementSpec as JaxPlacement
from repro.core import init_atmo_state_lanes as jax_init_lanes
from repro.core import make_step as jax_make_step
from repro.core.pipeline import donation_spec as jax_donation_spec
from repro.stream import ElasticServer as JaxServer
from repro.stream import StreamRequest as JaxRequest
from repro.stream import fetch_valid as jax_fetch_valid
from repro_torch.core import (DehazeConfig, PlacementSpec,
                              init_atmo_state_lanes, make_step)
from repro_torch.core.pipeline import donation_spec
from repro_torch.stream import (ElasticServer, LaneTickStep, StreamRequest,
                                TickBufferPool, donation_supported,
                                fetch_valid)
from repro_torch.stream.elastic import _cached_multi_step

from _torch_common import as_np, wire

torch.set_num_threads(1)

ATOL = 2e-4          # pipeline level, tests/test_fused.py
A_ATOL = 1e-5
KW = dict(gf_radius=2, update_period=2)


def _frames(lanes, batch, h=12, w=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((lanes, batch, h, w, 3)).astype(np.float32)


def _ids(lanes, batch, base=0):
    return np.stack([np.arange(batch, dtype=np.int32) + base + 10 * i
                     for i in range(lanes)])


def _cfgs(mode="ref", **kw):
    """The port's config and the reference's; the port's staged kernels
    ("pallas") face the Pallas kernels in interpret mode."""
    kw = dict(KW, **kw)
    jmode = "interpret" if mode == "pallas" else mode
    return (DehazeConfig(kernel_mode=mode, **kw),
            JaxConfig(kernel_mode=jmode, **kw))


def _lane_step(cfg, lanes, donate=False):
    return _cached_multi_step(cfg, lanes, False, torch.device("cpu"),
                              donate=donate)


def _state_np(state):
    return [as_np(getattr(state, f)) for f in ("A", "last_update",
                                                "initialized")]


# --- donation_spec, fetch_valid ---------------------------------------------

@pytest.mark.parametrize("out_dtype", ["auto", "float32", "bfloat16"])
@pytest.mark.parametrize("io_dtype", ["float32", "bfloat16", "uint8"])
def test_donation_spec_matches_reference(io_dtype, out_dtype):
    cfg, jcfg = _cfgs(io_dtype=io_dtype, out_dtype=out_dtype)
    assert donation_spec(cfg) == jax_donation_spec(jcfg)
    assert donation_spec(cfg) in ((0, 2), (2,))
    assert donation_supported()


@pytest.mark.parametrize("lane", [None, 1])
def test_fetch_valid_matches_reference(lane):
    x = _frames(3, 4)
    got = fetch_valid(torch.from_numpy(x), 2, lane=lane)
    want = jax_fetch_valid(jnp.asarray(x), 2, lane=lane)
    np.testing.assert_array_equal(as_np(got), want)
    assert got.numel() * got.element_size() == want.nbytes


# --- the donation contract of make_step ----------------------------------------

@pytest.mark.parametrize("mode", ["ref", "fused", "pallas"])
def test_state_donation_reuses_the_state_and_consumes_it(mode):
    """donate="state": out.state is written into the input state's tensors
    (same data_ptr); the input object is consumed (reads raise) and the
    frames are untouched; values equal the non-donating step's and, within
    the pipeline tolerance, the JAX step's. A read taken before the next
    tick stays valid (the serve loop's eviction-snapshot rule)."""
    cfg, jcfg = _cfgs(mode)
    x = _frames(2, 4, seed=1)
    ids = _ids(2, 4)
    frames = torch.from_numpy(x.copy())
    plain = make_step(cfg, PlacementSpec.lane_batched(), device="cpu")
    want = plain(frames, torch.from_numpy(ids), init_atmo_state_lanes(2))
    step = make_step(cfg, PlacementSpec.lane_batched(), device="cpu",
                     donate="state")
    state = init_atmo_state_lanes(2)
    ptrs = [getattr(state, f).data_ptr() for f in ("A", "last_update",
                                                   "initialized")]
    out = step(frames, torch.from_numpy(ids), state)
    assert [getattr(out.state, f).data_ptr() for f in (
        "A", "last_update", "initialized")] == ptrs
    with pytest.raises(RuntimeError, match="donated"):
        state.A
    np.testing.assert_array_equal(as_np(frames), x)
    assert out.frames.data_ptr() != frames.data_ptr()
    assert torch.equal(out.frames, want.frames)
    for a, b in zip(_state_np(out.state), _state_np(want.state)):
        np.testing.assert_array_equal(a, b)
    jout = jax_make_step(jcfg, JaxPlacement.lane_batched())(
        jnp.asarray(x), jnp.asarray(ids), jax_init_lanes(2))
    np.testing.assert_allclose(as_np(out.frames), as_np(jout.frames),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(as_np(out.state.A), as_np(jout.state.A),
                               atol=A_ATOL, rtol=0)

    snapshot = out.state.A.clone()            # read before the next tick
    out2 = step(frames, torch.from_numpy(ids + 4), out.state)
    assert out2.state.A.data_ptr() == ptrs[0]
    with pytest.raises(RuntimeError):
        out.state.A
    assert torch.equal(snapshot, want.state.A)


@pytest.mark.parametrize("mode", ["ref", "fused", "pallas"])
@pytest.mark.parametrize("io_dtype", ["float32", "bfloat16", "uint8"])
def test_full_donation_writes_j_into_the_frames(mode, io_dtype):
    """donate=True: J goes into the frame buffer where donation_spec
    offers it (float32 and bfloat16 wire), equal to the non-donating
    step's J; a uint8 batch is left as it was."""
    cfg, jcfg = _cfgs(mode, io_dtype=io_dtype)
    x = _frames(2, 4, seed=2)
    _, frames = wire(x, io_dtype)
    ids = torch.from_numpy(_ids(2, 4))
    want = make_step(cfg, PlacementSpec.lane_batched(), device="cpu")(
        frames.clone(), ids, init_atmo_state_lanes(2))
    step = make_step(cfg, PlacementSpec.lane_batched(), device="cpu",
                     donate=True)
    before = frames.clone()
    out = step(frames, ids, init_atmo_state_lanes(2))
    assert torch.equal(out.frames, want.frames)
    if 0 in donation_spec(cfg):
        assert out.frames.data_ptr() == frames.data_ptr()
        assert torch.equal(frames, want.frames)
    else:
        assert out.frames.data_ptr() != frames.data_ptr()
        assert torch.equal(frames, before)
    jx, _ = wire(x, io_dtype)
    jout = jax_make_step(jcfg, JaxPlacement.lane_batched())(
        jx, jnp.asarray(_ids(2, 4)), jax_init_lanes(2))
    tol = ATOL if io_dtype != "bfloat16" else 2e-2   # one bfloat16 step
    np.testing.assert_allclose(as_np(out.frames), as_np(jout.frames),
                               atol=tol, rtol=0)


def test_donation_rejected_for_sharded_placements_and_bad_values():
    cfg, jcfg = _cfgs()
    for placement in (PlacementSpec.lane_sharded(),
                      PlacementSpec.frame_sharded()):
        with pytest.raises(ValueError, match="donat"):
            make_step(cfg, placement, donate="state")
    with pytest.raises(ValueError, match="donat"):
        jax_make_step(jcfg, JaxPlacement.lane_sharded(), donate="state")
    with pytest.raises(ValueError, match="donate"):
        make_step(cfg, PlacementSpec.lane_batched(), device="cpu",
                  donate="frames")


# --- LaneTickStep ---------------------------------------------------------------

def test_lane_tick_step_matches_the_blocking_step():
    """stage() a lane at a time + tick() equals the blocking call of the
    non-donating step bit for bit, and the JAX step within 2e-4."""
    cfg, jcfg = _cfgs()
    lanes, batch = 3, 4
    x = _frames(lanes, batch, seed=3)
    ids = _ids(lanes, batch)
    want = _lane_step(cfg, lanes)(torch.from_numpy(x), torch.from_numpy(ids),
                                  init_atmo_state_lanes(lanes))
    adapter = LaneTickStep(_lane_step(cfg, lanes, "state"), lanes,
                           device="cpu")
    for i in range(lanes):
        adapter.stage(i, torch.from_numpy(x[i]))
    out = adapter.tick(torch.from_numpy(ids), init_atmo_state_lanes(lanes))
    assert torch.equal(out.frames, want.frames)
    assert torch.equal(out.state.A, want.state.A)
    assert adapter.staged_lanes == lanes and adapter.staged_bytes == x.nbytes
    jout = jax_make_step(jcfg, JaxPlacement.lane_batched())(
        jnp.asarray(x), jnp.asarray(ids), jax_init_lanes(lanes))
    np.testing.assert_allclose(as_np(out.frames), as_np(jout.frames),
                               atol=ATOL, rtol=0)
    # The full-batch compatibility call ticks the same batch.
    again = adapter(torch.from_numpy(x), torch.from_numpy(ids),
                    init_atmo_state_lanes(lanes))
    assert torch.equal(again.frames, want.frames)


def test_stale_padding_rows_are_inert():
    """Restaging only lane 0 leaves lane 1's row stale: its ids of -1 keep
    lane 1's state bit-frozen, and lane 0's output equals a fresh
    full-batch run on what the buffer now holds."""
    cfg, _ = _cfgs()
    lanes, batch = 2, 4
    f0, f1 = _frames(lanes, batch, seed=4)
    adapter = LaneTickStep(_lane_step(cfg, lanes, "state"), lanes,
                           device="cpu")
    adapter.stage(0, torch.from_numpy(f0))
    adapter.stage(1, torch.from_numpy(f1))
    ids = np.stack([np.arange(batch, dtype=np.int32)] * lanes)
    out1 = adapter.tick(torch.from_numpy(ids), init_atmo_state_lanes(lanes))
    state1 = out1.state.clone()             # before the next tick donates it

    f0b = _frames(1, batch, seed=5)[0]
    adapter.stage(0, torch.from_numpy(f0b))
    ids2 = np.stack([np.arange(batch, dtype=np.int32) + batch,
                     np.full((batch,), -1, np.int32)])
    out2 = adapter.tick(torch.from_numpy(ids2), out1.state)
    want = _lane_step(cfg, lanes)(torch.from_numpy(np.stack([f0b, f1])),
                                  torch.from_numpy(ids2), state1.clone())
    assert torch.equal(out2.frames[0], want.frames[0])
    for f in ("A", "last_update", "initialized"):
        assert torch.equal(getattr(out2.state, f)[1], getattr(state1, f)[1])


def test_all_padding_tick_keeps_the_state_bit_unchanged():
    cfg, _ = _cfgs()
    lanes, batch = 2, 3
    adapter = LaneTickStep(_lane_step(cfg, lanes, "state"), lanes,
                           device="cpu")
    adapter.ensure_buf((batch, 12, 16, 3), torch.float32)
    packed = init_atmo_state_lanes(lanes)
    before = _state_np(packed.clone())
    out = adapter.tick(torch.full((lanes, batch), -1, dtype=torch.int32),
                       packed)
    for a, b in zip(before, _state_np(out.state)):
        np.testing.assert_array_equal(a, b)


def test_tick_buffer_pool_one_adapter_per_lane_count():
    cfg, _ = _cfgs()
    pool = TickBufferPool(lambda n: _lane_step(cfg, n, "state"), device="cpu")
    a2, a4 = pool.adapter(2), pool.adapter(4)
    assert a2 is pool.adapter(2) and a4 is pool.adapter(4)
    assert a2 is not a4 and a2.n_lanes == 2 and a4.n_lanes == 4


# --- the overlapped serves -------------------------------------------------------

def _videos(lengths, seed=42):
    rng = np.random.default_rng(seed)
    return [[rng.random((12, 16, 3)).astype(np.float32) for _ in range(k)]
            for k in lengths]


def _serve_many(srv, request, vids, lanes, overlap):
    outs = {}
    rep = srv.serve_many(
        [request(f"s{i}", iter(v)) for i, v in enumerate(vids)],
        n_lanes=lanes, tick_overlap=overlap,
        sink=lambda sid, fid, f: outs.setdefault((sid, fid), as_np(f)))
    finals = {f"s{i}": as_np(srv.store.get(f"s{i}").A)
              for i in range(len(vids))}
    return rep, outs, finals


@pytest.mark.parametrize("lane_native", [False, True])
@pytest.mark.parametrize("occupancy", ["full", "sparse"])
def test_overlap_serve_parity(monkeypatch, occupancy, lane_native):
    """The parity cell: the overlapped serve_many delivers the blocking
    one's frames and final states bit for bit, every tick overlapped;
    both within 2e-4 (A 1e-5) of the JAX package's serve_many, with its
    d2h_bytes on each path (whole batches blocking, valid-only
    overlapped)."""
    monkeypatch.setenv("REPRO_LANE_NATIVE", "1" if lane_native else "0")
    cfg, jcfg = _cfgs("fused")
    n_streams, lanes = (4, 4) if occupancy == "full" else (2, 4)
    vids = _videos([10, 7, 13, 5][:n_streams])
    reps = {}
    for overlap in (False, True):
        reps[overlap] = _serve_many(ElasticServer(cfg, batch=4, timeout_s=5.0,
                                                  device="cpu"),
                                    StreamRequest, vids, lanes, overlap)
        reps["jax", overlap] = _serve_many(JaxServer(jcfg, batch=4,
                                                     timeout_s=5.0),
                                           JaxRequest, vids, lanes, overlap)
    (rep_b, outs_b, fin_b), (rep_o, outs_o, fin_o) = reps[False], reps[True]
    assert rep_b.overlap_ticks == 0
    assert rep_o.overlap_ticks == rep_o.ticks == rep_b.ticks > 0
    assert rep_o.frames == rep_b.frames == sum(map(len, vids))
    assert rep_o.stragglers == rep_b.stragglers == 0
    assert outs_o.keys() == outs_b.keys()
    for k in outs_b:
        np.testing.assert_array_equal(outs_o[k], outs_b[k])
    for sid in fin_b:
        np.testing.assert_array_equal(fin_o[sid], fin_b[sid])
    for overlap in (False, True):
        rep, outs, fin = reps[overlap]
        jrep, jouts, jfin = reps["jax", overlap]
        assert jrep.overlap_ticks == rep.overlap_ticks
        assert rep.d2h_bytes == jrep.d2h_bytes
        assert outs.keys() == jouts.keys()
        for k in jouts:
            np.testing.assert_allclose(outs[k], jouts[k], atol=ATOL, rtol=0)
        for sid in jfin:
            np.testing.assert_allclose(fin[sid], jfin[sid], atol=A_ATOL,
                                       rtol=0)
    if occupancy == "sparse":
        assert rep_o.d2h_bytes < rep_b.d2h_bytes


@pytest.mark.parametrize("io_dtype", ["float32", "uint8"])
def test_overlap_serve_single_stream_parity(io_dtype):
    """serve() overlapped (float32: J written into each uploaded batch)
    equals the blocking serve bit for bit, every batch overlapped, and the
    stored state is the caller's to read afterwards."""
    cfg, _ = _cfgs("fused", io_dtype=io_dtype)
    frames = [wire(f, io_dtype)[1] for f in _videos([11], seed=9)[0]]
    got = {}
    for overlap in (False, True):
        srv = ElasticServer(cfg, batch=4, timeout_s=5.0, device="cpu")
        outs = {}
        rep = srv.serve(iter(frames), tick_overlap=overlap,
                        sink=lambda fid, f: outs.setdefault(fid, as_np(f)))
        assert rep.overlap_ticks == (rep.ticks if overlap else 0)
        assert rep.frames == len(frames) and rep.skipped == 0
        got[overlap] = outs, as_np(srv.store.get("default").A), rep.d2h_bytes
    assert got[True][0].keys() == got[False][0].keys()
    for k in got[False][0]:
        np.testing.assert_array_equal(got[True][0][k], got[False][0][k])
    np.testing.assert_array_equal(got[True][1], got[False][1])
    assert got[True][2] == got[False][2]            # valid-only both ways


def test_env_knob_forces_the_path(monkeypatch):
    cfg, _ = _cfgs()
    vids = _videos([6, 6], seed=7)
    srv = ElasticServer(cfg, batch=3, timeout_s=5.0, device="cpu")
    monkeypatch.setenv("REPRO_TICK_OVERLAP", "1")
    rep = srv.serve_many([StreamRequest(f"s{i}", iter(v))
                          for i, v in enumerate(vids)], n_lanes=2)
    assert rep.overlap_ticks == rep.ticks > 0
    rep1 = srv.serve(iter(vids[0]), stream_id="solo")
    assert rep1.overlap_ticks == rep1.ticks > 0
    # The explicit argument wins over the variable.
    rep_b = srv.serve_many([StreamRequest(f"u{i}", iter(v))
                            for i, v in enumerate(vids)], n_lanes=2,
                           tick_overlap=False)
    assert rep_b.overlap_ticks == 0
    monkeypatch.setenv("REPRO_TICK_OVERLAP", "0")
    rep2 = srv.serve_many([StreamRequest(f"t{i}", iter(v))
                           for i, v in enumerate(vids)], n_lanes=2)
    assert rep2.overlap_ticks == 0
    monkeypatch.setenv("REPRO_TICK_OVERLAP", "yes")
    with pytest.raises(ValueError, match="REPRO_TICK_OVERLAP"):
        srv.serve_many([StreamRequest("v", iter(vids[0]))], n_lanes=1)
