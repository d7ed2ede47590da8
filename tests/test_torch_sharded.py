"""PyTorch port, the data-parallel sharded step: ``make_step(cfg, placement,
mesh)`` with ``PlacementSpec.frame_sharded`` / ``lane_sharded`` over a
``torch.distributed`` device mesh, against the JAX package's shard_map
step on the same numpy inputs.

In-process tests use a one-rank gloo mesh (``make_host_mesh(1, 1,
device="cpu")``), made and destroyed by a fixture, against the JAX step on
a one-device ``("data", "model")`` mesh. The two-rank test runs two gloo
ranks in child processes (rendezvous through a file) and concatenates their
blocks, as ``tests/test_distributed.py`` runs the JAX step on 8 host
devices. The fused configs run the fused transmission stage (on the CPU,
its plain version; the JAX side the Pallas kernel in interpret mode), the
staged ones the masked filters through ``ops`` (on the CPU their plain
versions; ``core.spatial``'s under ``"ref"``). Tolerances: steps J/t
2e-4, A 1e-5, ``last_update`` exact (the reference's pipeline level); the
two-rank step against the single-device step frames/t 2e-5, A 1e-5 (as
``tests/test_distributed.py``); masked filters 1e-6.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.core import DehazeConfig as JaxConfig
from repro.core import PlacementSpec as JaxPlacement
from repro.core import compat
from repro.core import init_atmo_state as jax_init
from repro.core import init_atmo_state_lanes as jax_init_lanes
from repro.core import make_dehaze_step as jax_single_step
from repro.core import make_sharded_dehaze_step as jax_sharded_step
from repro.core import make_step as jax_make_step
from repro.core import spatial as jspatial
from repro_torch.core import (DehazeConfig, PlacementSpec, init_atmo_state,
                              init_atmo_state_lanes, make_dehaze_step,
                              make_multi_stream_step,
                              make_sharded_dehaze_step, make_step, spatial)
from repro_torch.kernels import fused, staged
from repro_torch.launch.mesh import make_host_mesh

from _torch_common import as_np, ramp_frames, wire
from _torch_common import launch_counters_restored  # noqa: F401 (autouse)

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
STEP_CFG = dict(patch_radius=2, gf_radius=3, update_period=2, lam=0.3)


@pytest.fixture
def mesh():
    """A one-rank gloo (data=1, model=1) mesh, destroyed after the test."""
    m = make_host_mesh(1, 1, device="cpu")
    yield m
    dist.destroy_process_group()


def _jax_mesh():
    return compat.make_mesh((1, 1), ("data", "model"))


def _compare_step(got, want, dtype):
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    for g, w in ((got.frames, want.frames),
                 (got.transmission, want.transmission)):
        np.testing.assert_allclose(as_np(g), as_np(w), atol=tol, rtol=0)
    np.testing.assert_allclose(as_np(got.atmo_light), as_np(want.atmo_light),
                               atol=2e-2 if dtype == "bfloat16" else 1e-5)
    np.testing.assert_allclose(as_np(got.state.A), as_np(want.state.A),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(as_np(got.state.last_update),
                                  as_np(want.state.last_update))
    np.testing.assert_array_equal(as_np(got.state.initialized),
                                  as_np(want.state.initialized))


# --- the frame-sharded step (B7a on the fused configs) ----------------------

@pytest.mark.parametrize("mode,algorithm,topk,dtype", [
    ("fused", "dcp", 1, "uint8"), ("fused", "cap", 4, "float32"),
    ("pallas", "dcp", 4, "float32"), ("pallas", "cap", 1, "uint8")])
def test_frame_sharded_step_matches_jax(mesh, mode, algorithm, topk, dtype,
                                        monkeypatch):
    """Two chained batches of one stream on one rank: the candidates are
    gathered over the data group, the EMA scans the whole batch."""
    monkeypatch.setenv("REPRO_KERNEL_MODE", "interpret")    # the JAX side
    kw = dict(STEP_CFG, algorithm=algorithm, topk=topk, io_dtype=dtype)
    jstep, _, _ = jax_sharded_step(
        JaxConfig(kernel_mode="fused" if mode == "fused" else "interpret",
                  **kw), _jax_mesh())
    jstep = jax.jit(jstep)
    step = make_sharded_dehaze_step(DehazeConfig(kernel_mode=mode, **kw), mesh)
    x = ramp_frames(30, 2, 4, h=16, w=20)
    jstate, state = jax_init(), init_atmo_state()
    for batch in range(2):
        jx, tx = wire(x[batch], dtype)
        ids = np.arange(4 * batch, 4 * batch + 4, dtype=np.int32)
        with _jax_mesh():
            want = jstep(jx, jnp.asarray(ids), jstate)
        got = step(tx, torch.from_numpy(ids), state)
        _compare_step(got, want, dtype)
        jstate, state = want.state, got.state


# --- the lane-sharded step (B7b with lane_native=False) ---------------------

@pytest.mark.parametrize("mode,lane_native", [("fused", False),
                                              ("fused", True),
                                              ("pallas", None)])
def test_lane_sharded_step_matches_jax(mesh, mode, lane_native, monkeypatch):
    """Lanes over the data axis, whole on their rank (3 lanes, the last all
    padding, two chained batches): the per-lane saved A feeds each lane's
    pre-map, the EMA scans each lane locally."""
    monkeypatch.setenv("REPRO_KERNEL_MODE", "interpret")    # the JAX side
    L, B = 3, 2
    kw = dict(STEP_CFG, topk=4)
    jstep = jax.jit(jax_make_step(
        JaxConfig(kernel_mode="fused" if mode == "fused" else "interpret",
                  **kw), JaxPlacement.lane_sharded(lane_axis="data"),
        _jax_mesh(), lane_native=lane_native))
    step = make_step(DehazeConfig(kernel_mode=mode, **kw),
                     PlacementSpec.lane_sharded(), mesh,
                     lane_native=lane_native)
    x = ramp_frames(31, 2, L, B, h=12, w=16)
    jstate, state = jax_init_lanes(L), init_atmo_state_lanes(L)
    for batch in range(2):
        ids = np.tile(np.arange(B * batch, B * batch + B, dtype=np.int32),
                      (L, 1))
        ids[L - 1] = -1
        with _jax_mesh():
            want = jstep(jnp.asarray(x[batch]), jnp.asarray(ids), jstate)
        got = step(torch.from_numpy(x[batch]), torch.from_numpy(ids), state)
        _compare_step(got, want, "float32")
        assert not bool(got.state.initialized[L - 1])
        jstate, state = want.state, got.state
    # Per lane, the single-device lane step.
    local = make_multi_stream_step(DehazeConfig(kernel_mode=mode, **kw),
                                   device="cpu", lane_native=lane_native)
    one = local(torch.from_numpy(x[0]), torch.from_numpy(ids - B),
                init_atmo_state_lanes(L))
    two = local(torch.from_numpy(x[1]), torch.from_numpy(ids), one.state)
    np.testing.assert_allclose(as_np(got.frames), as_np(two.frames),
                               atol=1e-6, rtol=0)


# --- two ranks ---------------------------------------------------------------

_RANK = textwrap.dedent("""
    import os
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import (DehazeConfig, PlacementSpec, init_atmo_state,
                                  make_sharded_dehaze_step, make_step)
    from repro_torch.launch.mesh import make_host_mesh

    rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                            world_size=2)
    data = np.load(inp)
    b_loc = data["frames"].shape[0] // 2
    mine = slice(rank * b_loc, (rank + 1) * b_loc)
    mesh = make_host_mesh(2, 1, device="cpu")
    res = {}
    for algo in ("dcp", "cap"):
        for mode in ("fused", "auto"):
            cfg = DehazeConfig(algorithm=algo, kernel_mode=mode, gf_radius=8)
            step = make_sharded_dehaze_step(cfg, mesh)
            o = step(torch.from_numpy(data["frames"][mine]),
                     torch.from_numpy(data["ids"][mine]), init_atmo_state())
            for key, v in (("frames", o.frames), ("t", o.transmission),
                           ("a", o.atmo_light), ("A", o.state.A),
                           ("k", o.state.last_update)):
                res[f"{algo}_{mode}_{key}"] = v.numpy()
    # A model axis of size 2 splits each frame into row halves.
    spatial = make_host_mesh(1, 2, device="cpu")
    h_loc = data["frames"].shape[1] // 2
    rows = slice(rank * h_loc, (rank + 1) * h_loc)
    for mode in ("fused", "auto"):
        cfg = DehazeConfig(kernel_mode=mode, gf_radius=8)
        o = make_step(cfg, PlacementSpec.frame_sharded(), spatial)(
            torch.from_numpy(np.ascontiguousarray(data["frames"][:, rows])),
            torch.from_numpy(data["ids"]), init_atmo_state())
        for key, v in (("frames", o.frames), ("t", o.transmission),
                       ("a", o.atmo_light)):
            res[f"spatial_{mode}_{key}"] = v.numpy()
    np.savez(out, **res)
    dist.destroy_process_group()
    # Leave without the interpreter's teardown: under load, torch's C++
    # teardown at exit can abort a rank (std::terminate) after its outputs
    # are saved.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
""")


def test_two_rank_frame_sharded_step_matches_single_device(tmp_path):
    """Two gloo ranks, two frames each: the concatenated blocks equal the
    JAX single-device step on all four frames; so do the row halves of a
    model axis of size 2 (halo 23 over 16-row shards: two hops)."""
    rng = np.random.default_rng(2)
    B, H, W = 4, 32, 24
    frames = rng.random((B, H, W, 3)).astype(np.float32) * 0.8 + 0.1
    ids = np.arange(B, dtype=np.int32)
    np.savez(tmp_path / "in.npz", frames=frames, ids=ids)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               GLOO_SOCKET_IFNAME="lo")
    env.pop("REPRO_KERNEL_MODE", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store"),
         str(tmp_path / "in.npz"), str(tmp_path / f"out{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"rank failed:\n{log}"
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for algo in ("dcp", "cap"):
        want = jax.jit(jax_single_step(JaxConfig(algorithm=algo, kernel_mode="ref",
                                                 gf_radius=8)))(
            jnp.asarray(frames), jnp.asarray(ids), jax_init())
        for mode in ("fused", "auto"):
            key = f"{algo}_{mode}"
            got = {k: np.concatenate([o[f"{key}_{k}"] for o in outs])
                   for k in ("frames", "t", "a")}
            np.testing.assert_allclose(got["frames"], as_np(want.frames),
                                       atol=2e-5)
            np.testing.assert_allclose(got["t"], as_np(want.transmission),
                                       atol=2e-5)
            np.testing.assert_allclose(got["a"], as_np(want.atmo_light),
                                       atol=1e-5)
            for o in outs:                     # the state is replicated
                np.testing.assert_allclose(o[f"{key}_A"], as_np(want.state.A),
                                           atol=1e-5)
                assert int(o[f"{key}_k"]) == int(want.state.last_update)
    want = jax.jit(jax_single_step(JaxConfig(kernel_mode="ref",
                                             gf_radius=8)))(
        jnp.asarray(frames), jnp.asarray(ids), jax_init())
    for mode in ("fused", "auto"):
        got = {k: np.concatenate([o[f"spatial_{mode}_{k}"] for o in outs],
                                 axis=0 if k == "a" else 1)[:B]
               for k in ("frames", "t", "a")}
        np.testing.assert_allclose(got["frames"], as_np(want.frames), atol=2e-5)
        np.testing.assert_allclose(got["t"], as_np(want.transmission),
                                   atol=2e-5)
        np.testing.assert_allclose(got["a"], as_np(want.atmo_light), atol=1e-5)


# --- contracts ---------------------------------------------------------------

class _Mesh:
    """A stand-in (data, model) mesh of the given sizes; building a step
    asks it for the data group and this rank's place, and communicates
    nothing."""
    mesh_dim_names = ("data", "model")
    device_type = "cpu"

    def __init__(self, data, model):
        self.shape = (data, model)

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


@pytest.mark.parametrize("placement", [
    PlacementSpec.frame_sharded(),
    PlacementSpec.frame_sharded(height_axis=None, width_axis="model"),
    PlacementSpec.lane_sharded(height_axis="model")])
def test_spatial_axis_of_size_two_raises(placement):
    """A spatial axis of size 2 once raised ``NotImplementedError``; the
    halo exchange is ported, so the same placements now build a step on a
    2-rank mesh (``tests/test_torch_spatial.py`` runs them)."""
    assert callable(make_step(DehazeConfig(), placement, _Mesh(1, 2)))


def test_placement_contracts(mesh):
    with pytest.raises(ValueError, match="needs the mesh"):
        make_step(DehazeConfig(), PlacementSpec.frame_sharded())
    with pytest.raises(ValueError, match="lanes=True"):
        PlacementSpec(lane_axis="data").validate()
    with pytest.raises(ValueError, match="frame axis"):
        PlacementSpec(lanes=True, batch_axes=("data",)).validate()
    with pytest.raises(ValueError, match="distinct"):
        PlacementSpec(batch_axes=("data",), height_axis="data").validate()
    # n_hosts sizes the fleet tier above the step, as on the reference.
    spec = PlacementSpec.lane_sharded(n_hosts=2)
    jspec = JaxPlacement.lane_sharded(n_hosts=2)
    assert (spec.n_hosts, spec.lane_axis, spec.lanes) == \
        (jspec.n_hosts, jspec.lane_axis, jspec.lanes)
    with pytest.raises(ValueError, match="no 'pod'"):
        make_step(DehazeConfig(), PlacementSpec.frame_sharded(("pod",)), mesh)
    with pytest.raises(ValueError, match="not the mesh's"):
        make_step(DehazeConfig(), PlacementSpec.frame_sharded(), mesh,
                  device="cuda")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_host_mesh(2, 1, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert dist.get_backend() == "gloo"
    for p in (PlacementSpec.frame_sharded(), PlacementSpec.lane_sharded()):
        assert p.sharded and not PlacementSpec.lane_batched().sharded


def test_sharded_step_matches_the_local_step(mesh):
    """On one rank the frame-sharded step is the single-device step, and
    the staged one runs the staged chain's math through the masked
    filters."""
    x = torch.from_numpy(ramp_frames(32, 4, h=16, w=20))
    ids = torch.arange(4, dtype=torch.int32)
    for mode in ("fused", "pallas"):
        cfg = DehazeConfig(kernel_mode=mode, algorithm="cap", topk=3,
                           **STEP_CFG)
        got = make_sharded_dehaze_step(cfg, mesh)(x, ids, init_atmo_state())
        want = make_dehaze_step(cfg, device="cpu")(x, ids, init_atmo_state())
        _compare_step(got, want, "float32")


def _count_masked_calls(monkeypatch):
    """Count the calls of the masked filters at each layer: ``ops`` (what
    the staged branch calls), the kernels' ops of ``kernels.staged`` (their
    plain versions here) and ``core.spatial``'s plain filters (the
    ``"ref"`` route)."""
    from repro_torch.kernels import ops, staged
    calls = {}

    def counted(module, name):
        fn = getattr(module, name)

        def wrapper(*args, **kw):
            key = f"{module.__name__.rsplit('.', 1)[-1]}.{name}"
            calls[key] = calls.get(key, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(module, name, wrapper)
    for module, name in ((ops, "masked_min_filter_2d"), (ops, "masked_box_filter_2d"),
                         (staged, "masked_min_filter_op"),
                         (staged, "masked_box_filter_op"),
                         (spatial, "masked_box_filter_2d"),
                         (spatial, "masked_guided_filter")):
        counted(module, name)
    return calls


# What one staged stage calls under each mode: one masked min filter and
# the guided filter's six masked means, through ops.
STAGED_CALLS = {
    "pallas": {"ops.masked_min_filter_2d": 1, "ops.masked_box_filter_2d": 6,
               "staged.masked_min_filter_op": 1, "staged.masked_box_filter_op": 6},
    "ref": {"ops.masked_min_filter_2d": 1, "spatial.masked_guided_filter": 1,
            "spatial.masked_box_filter_2d": 6}}


@pytest.mark.parametrize("mode", ["pallas", "ref"])
def test_staged_branch_takes_the_masked_filters_through_ops(mesh, mode,
                                                            monkeypatch):
    """The staged branch of the frame-sharded step and of one spatial
    shard's stage (a corner tile, rows and columns masked) calls ``ops``'
    masked min filter once and its masked means six times a stage: under
    ``"pallas"`` the kernels' ops (the plain versions on the CPU), under
    ``"ref"`` ``core.spatial``'s plain filters."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core.pipeline import spatial_shard_stage
    calls = _count_masked_calls(monkeypatch)
    cfg = DehazeConfig(kernel_mode=mode, **STEP_CFG)
    x = torch.from_numpy(ramp_frames(35, 4, h=16, w=20))
    make_sharded_dehaze_step(cfg, mesh)(x, torch.arange(4, dtype=torch.int32),
                                        init_atmo_state())
    assert calls == STAGED_CALLS[mode]
    calls.clear()
    # The top-left tile of a 2 x 2 tiling, extended by its halo (zero and
    # invalid above and left of the frame).
    halo = 2 + 2 * 3
    pre, guide = (torch.nn.functional.pad(p, (halo, 0, halo, 0))[
        :, :8 + 2 * halo, :10 + 2 * halo]
        for p in (alg.premap(x, torch.full((3,), 0.9), cfg), alg.luminance(x)))
    valid_h = torch.arange(-halo, 8 + halo) >= 0
    valid_w = torch.arange(-halo, 10 + halo) >= 0
    t, *_ = spatial_shard_stage(cfg, x[:, :8, :10], x[:, :8, :10], pre, guide,
                                valid_h, valid_w, 0, 0, 20, fused=False)
    assert calls == STAGED_CALLS[mode] and t.shape == (4, 8, 10)


@pytest.mark.parametrize("with_cols", [False, True])
def test_masked_filters_match_jax(with_cols):
    rng = np.random.default_rng(33)
    x = rng.random((2, 14, 18)).astype(np.float32)
    g = rng.random((2, 14, 18)).astype(np.float32)
    valid = rng.random(14) > 0.3
    valid_w = (rng.random(18) > 0.3) if with_cols else None
    tv = torch.from_numpy(valid)
    tw = None if valid_w is None else torch.from_numpy(valid_w)
    jv = jnp.asarray(valid)
    jw = None if valid_w is None else jnp.asarray(valid_w)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    np.testing.assert_array_equal(
        as_np(spatial.masked_min_filter_2d(tx, tv, 3, tw)),
        as_np(jspatial.masked_min_filter_2d(jnp.asarray(x), jv, 3, jw)))
    np.testing.assert_allclose(
        as_np(spatial.masked_box_filter_2d(tx, tv, 3, tw)),
        as_np(jspatial.masked_box_filter_2d(jnp.asarray(x), jv, 3, jw)),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        as_np(spatial.masked_guided_filter(tg, tx, tv, 3, 1e-3, tw)),
        as_np(jspatial.masked_guided_filter(jnp.asarray(g), jnp.asarray(x),
                                            jv, 3, 1e-3, jw)),
        atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_sharded_steps_on_the_card():
    """One NCCL rank: the frame- and lane-sharded fused steps (the
    transmission stage's tiled sequence, one a step) equal the
    single-device fused steps; the staged frame-sharded step (one masked
    min filter and six masked box filters a step, their strips) the
    single-device staged step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = DehazeConfig(kernel_mode="fused", **STEP_CFG)
    m = make_host_mesh(1, 1)
    try:
        assert dist.get_backend() == "nccl"
        x = torch.from_numpy(ramp_frames(34, 2, 4, h=48, w=64)).cuda()
        ids = torch.arange(8, dtype=torch.int32, device="cuda")
        fused.reset_launches()
        got = make_sharded_dehaze_step(cfg, m)(x.reshape(8, 48, 64, 3), ids,
                                               init_atmo_state("cuda"))
        assert fused.transmission_launches["tmap_tile"] == 1
        assert fused.transmission_launches["premap"] == 0
        want = make_dehaze_step(cfg)(x.reshape(8, 48, 64, 3), ids,
                                     init_atmo_state("cuda"))
        _compare_step(got, want, "float32")
        got = make_step(cfg, PlacementSpec.lane_sharded(), m, lane_native=False)(
            x, ids.reshape(2, 4), init_atmo_state_lanes(2, "cuda"))
        want = make_multi_stream_step(cfg)(x, ids.reshape(2, 4),
                                           init_atmo_state_lanes(2, "cuda"))
        _compare_step(got, want, "float32")
        cfg = DehazeConfig(kernel_mode="pallas", **STEP_CFG)
        staged.reset_launches()
        got = make_sharded_dehaze_step(cfg, m)(x.reshape(8, 48, 64, 3), ids,
                                               init_atmo_state("cuda"))
        assert staged.launches["masked_min_filter"] == 1
        assert staged.launches["masked_box_filter"] == 6
        assert not any(staged.wide_launches.values())
        want = make_dehaze_step(cfg)(x.reshape(8, 48, 64, 3), ids,
                                     init_atmo_state("cuda"))
        _compare_step(got, want, "float32")
    finally:
        dist.destroy_process_group()
