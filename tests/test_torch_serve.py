"""PyTorch port, serving end to end: ``repro_torch`` ``ElasticServer.serve``
and ``serve_many`` (``device="cpu"``, fused config: the megakernel's
plain version) against the JAX package's ``ElasticServer`` on the same
frames, at the pipeline-level tolerance of ``tests/test_fused.py``
(2e-4); plus the contracts of the port (same config, no JAX, no silent
CPU fallback, the parts not ported yet raise)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import DehazeConfig as JaxConfig
from repro.core import init_atmo_state_lanes as jax_init_lanes
from repro.core import make_multi_stream_step as jax_multi_step
from repro.stream import ElasticServer as JaxServer
from repro.stream import StreamRequest as JaxRequest
from repro_torch.core import (DehazeConfig, init_atmo_state,
                              init_atmo_state_lanes,
                              make_dehaze_step, make_multi_stream_step,
                              make_step)
from repro_torch.core.placement import PlacementSpec
from repro_torch.stream import ElasticServer, StreamRequest, StreamStateStore

from _torch_common import as_np

torch.set_num_threads(1)

ATOL = 2e-4
CFG = dict(kernel_mode="fused", patch_radius=3, gf_radius=4,
           update_period=2)


def _videos(lengths, io_dtype="float32", h=16, w=20, seed=0):
    rng = np.random.default_rng(seed)
    vids = [[rng.random((h, w, 3)).astype(np.float32) for _ in range(n)]
            for n in lengths]
    if io_dtype == "uint8":
        vids = [[np.clip(np.round(f * np.float32(255)), 0, 255)
                 .astype(np.uint8) for f in v] for v in vids]
    return vids


def _collect():
    outs, order = {}, {}

    def sink(sid, fid, frame):
        assert (sid, fid) not in outs, "frame delivered twice"
        outs[(sid, fid)] = as_np(frame)
        order.setdefault(sid, []).append(fid)
    return outs, order, sink


@pytest.mark.parametrize("io_dtype,n_lanes", [("float32", 2), ("uint8", 3)])
def test_serve_many_matches_jax_server(io_dtype, n_lanes):
    vids = _videos([7, 5, 9], io_dtype)
    jsrv = JaxServer(JaxConfig(io_dtype=io_dtype, **CFG), batch=4,
                     timeout_s=5.0)
    jouts, _, jsink = _collect()
    jsrv.serve_many([JaxRequest(f"s{i}", iter(v)) for i, v in enumerate(vids)],
                    n_lanes=n_lanes, sink=jsink)
    srv = ElasticServer(DehazeConfig(io_dtype=io_dtype, **CFG), batch=4,
                        timeout_s=5.0, device="cpu")
    outs, order, sink = _collect()
    rep = srv.serve_many([StreamRequest(f"s{i}", iter(v))
                          for i, v in enumerate(vids)],
                         n_lanes=n_lanes, sink=sink)
    assert rep.frames == sum(map(len, vids)) and rep.skipped == 0
    assert rep.admissions == len(vids) and rep.n_lanes == n_lanes
    assert set(outs) == set(jouts)
    for key, f in jouts.items():
        np.testing.assert_allclose(outs[key], f, atol=ATOL, rtol=0)
    for i, v in enumerate(vids):
        sid = f"s{i}"
        assert order[sid] == list(range(len(v)))          # once, in order
        assert srv.store.cursor(sid) == jsrv.store.cursor(sid) == len(v)
        np.testing.assert_allclose(as_np(srv.store.get(sid).A),
                                   np.asarray(jsrv.store.get(sid).A),
                                   atol=1e-5)
        assert int(srv.store.get(sid).last_update) \
            == int(jsrv.store.get(sid).last_update)


def test_serve_matches_jax_and_lane_batched_output():
    (vid,) = _videos([9], seed=1)
    jouts, js = {}, JaxServer(JaxConfig(**CFG), batch=4, timeout_s=5.0)
    js.serve(iter(vid), stream_id="cam", sink=lambda fid, f: jouts.setdefault(fid, f))
    outs = {}
    srv = ElasticServer(DehazeConfig(**CFG), batch=4, timeout_s=5.0,
                        device="cpu")
    rep = srv.serve(iter(vid), stream_id="cam",
                    sink=lambda fid, f: outs.setdefault(fid, as_np(f)))
    assert rep.frames == 9 and rep.skipped == 0 and sorted(outs) == list(range(9))
    for fid, f in jouts.items():
        np.testing.assert_allclose(outs[fid], np.asarray(f), atol=ATOL, rtol=0)
    # The single-stream step is the L=1 view of the lane step.
    many, _, sink = _collect()
    ElasticServer(DehazeConfig(**CFG), batch=4, timeout_s=5.0,
                  device="cpu").serve_many(
        [StreamRequest("cam", iter(vid)), StreamRequest("other", iter(vid[:3]))],
        n_lanes=2, sink=sink)
    for fid in range(9):
        np.testing.assert_allclose(many[("cam", fid)], outs[fid], atol=1e-5,
                                   rtol=0)


def test_state_carried_over_from_a_jax_store():
    """Serve the first half on the JAX server, hand its store over with
    ``from_jax_pytree`` and finish on the port: the second half and the
    final states match a JAX server finishing from the same store (the
    batch-entry A of §3.3 depends on where batches start, so the split is
    the same on both sides)."""
    vids = _videos([10, 7], seed=2)
    cfg_j = JaxConfig(**CFG)
    first = JaxServer(cfg_j, batch=4, timeout_s=5.0)
    first.serve_many([JaxRequest(f"s{i}", iter(v[:len(v) // 2]))
                      for i, v in enumerate(vids)])
    tree = first.store.to_pytree()
    rest = [(f"s{i}", v[len(v) // 2:]) for i, v in enumerate(vids)]

    jsrv = JaxServer(cfg_j, batch=4, timeout_s=5.0)
    jsrv.store = type(first.store).from_pytree(tree)
    jouts, _, jsink = _collect()
    jsrv.serve_many([JaxRequest(sid, iter(v)) for sid, v in rest], sink=jsink)

    srv = ElasticServer(DehazeConfig(**CFG), batch=4, timeout_s=5.0,
                        device="cpu")
    srv.store = StreamStateStore.from_jax_pytree(tree)
    outs, order, sink = _collect()
    srv.serve_many([StreamRequest(sid, iter(v)) for sid, v in rest],
                   sink=sink)
    assert set(outs) == set(jouts)
    for i, v in enumerate(vids):
        sid = f"s{i}"
        assert order[sid] == list(range(len(v) // 2, len(v)))
        for fid in order[sid]:
            np.testing.assert_allclose(outs[(sid, fid)], jouts[(sid, fid)],
                                       atol=ATOL, rtol=0)
        assert srv.store.cursor(sid) == jsrv.store.cursor(sid) == len(v)
        np.testing.assert_allclose(as_np(srv.store.get(sid).A),
                                   np.asarray(jsrv.store.get(sid).A),
                                   atol=1e-5)
    # ...and back: the port's pytree restores into a port store unchanged.
    back = StreamStateStore.from_jax_pytree(srv.store.to_numpy_pytree())
    for sid in ("s0", "s1"):
        assert back.cursor(sid) == srv.store.cursor(sid)
        assert torch.equal(back.get(sid).A, srv.store.get(sid).A)


@pytest.mark.parametrize("mode,algorithm,topk",
                         [("ref", "dcp", 1), ("ref", "cap", 4),
                          ("fused", "cap", 1), ("fused", "dcp", 4),
                          ("pallas", "dcp", 1)])
def test_multi_stream_step_matches_jax_step(mode, algorithm, topk):
    """The lane-batched step, staged over all lanes (``ref``, ``pallas``:
    the staged kernels' plain versions here) or lane-native (``fused``),
    against the reference's step, with an all-padding lane; each live lane
    equals the single-stream step on it."""
    kw = dict(CFG, kernel_mode=mode, algorithm=algorithm, topk=topk)
    x = np.random.default_rng(5).random((3, 4, 16, 20, 3)).astype(np.float32)
    ids = np.tile(np.arange(4, dtype=np.int32), (3, 1))
    ids[2] = -1
    # The JAX package cannot compile its Pallas kernels on the CPU; its
    # staged chain there is the plain one (``ref``).
    jkw = dict(kw, kernel_mode="ref" if mode == "pallas" else mode)
    want = jax_multi_step(JaxConfig(**jkw))(jnp.asarray(x), jnp.asarray(ids),
                                           jax_init_lanes(3))
    step = make_multi_stream_step(DehazeConfig(**kw), device="cpu")
    got = step(torch.from_numpy(x), torch.from_numpy(ids),
               init_atmo_state_lanes(3))
    for g, w in ((got.frames, want.frames), (got.transmission,
                                             want.transmission)):
        np.testing.assert_allclose(as_np(g), np.asarray(w), atol=ATOL)
    np.testing.assert_allclose(as_np(got.state.A), np.asarray(want.state.A),
                               atol=1e-5)
    np.testing.assert_array_equal(as_np(got.state.last_update),
                                  np.asarray(want.state.last_update))
    assert not bool(got.state.initialized[2])
    single = make_dehaze_step(DehazeConfig(**kw), device="cpu")
    for lane in range(2):
        one = single(torch.from_numpy(x[lane]), torch.from_numpy(ids[lane]),
                     init_atmo_state())
        np.testing.assert_allclose(as_np(one.frames), as_np(got.frames[lane]),
                                   atol=1e-6, rtol=0)


# --- contracts ------------------------------------------------------------------

def test_config_mirrors_the_reference():
    fields = {f.name: f.default for f in dataclasses.fields(DehazeConfig)}
    jfields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert fields == jfields
    assert list(fields) == list(jfields)
    with pytest.raises(AssertionError):
        DehazeConfig(io_dtype="float16").validate()


def test_import_pulls_in_no_jax():
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys, repro_torch, repro_torch.stream.elastic, "
            "repro_torch.kernels.fused, repro_torch.configs, "
            "repro_torch.models, repro_torch.checkpoint, "
            "repro_torch.data.synthetic; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ElasticServer(DehazeConfig(**CFG))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_step(DehazeConfig(**CFG), PlacementSpec.lane_batched())


def test_unported_options_raise():
    """Autoscaling and the fleet are ported (tests/test_torch_autoscale.py,
    tests/test_torch_fleet.py); a mesh-sharded placement is still refused:
    it is a step over a mesh, not a serving tier."""
    srv = ElasticServer(DehazeConfig(**CFG), device="cpu")
    reqs = [StreamRequest("a", iter(_videos([1])[0]))]
    with pytest.raises(ValueError, match="make_step"):
        srv.serve_many(reqs, placement=PlacementSpec.lane_sharded())
    assert PlacementSpec(lanes=True, n_hosts=2).validate().n_hosts == 2
    rep = srv.serve_many([StreamRequest("b", iter(_videos([3])[0]))],
                         autoscale=True, n_hosts=2)
    assert rep.frames == 3 and rep.n_hosts == 2 and rep.warm_failures == 0
