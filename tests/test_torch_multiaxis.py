"""PyTorch port, frames sharded over several batch axes (pod x data), and
the production meshes: ``launch.mesh.batch_axes_for`` and
``make_production_mesh`` against the JAX package's ``launch/mesh.py``,
and the frame-sharded step over a tuple of batch axes against the JAX
single-device step.

The reference gathers the state sync's rows over the tuple of axes
(``lax.all_gather(x, batch_axes, tiled=True)``): row-major over the axes
in the order given. Four gloo ranks in child processes (file rendezvous)
run every cell in one run: a (pod 2, data 2, model 1) mesh with
``("pod", "data")`` and ``("data", "pod")``, and a (pod 2, data 1, model 2)
mesh with ``("pod",)`` (and ``("pod", "data")``, its data axis of size 1)
and the height over ``model``; fused and ``"auto"``, DCP and CAP, 8 frames
of 32x24. Each rank's block is put in its place by the reference's order;
the whole equals the JAX single-device step within frames/t 2e-5 and A
1e-5, ``last_update`` exact (``tests/test_torch_sharded.py``), and the two
orders of the axes are equal bit for bit. The gather's order is also shown
in process, on a stand-in mesh whose ranks are not in row-major order.
"""
import json
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
from repro.core import init_atmo_state as jax_init
from repro.core import make_dehaze_step as jax_single_step
from repro.launch import mesh as jmesh
from repro_torch.core import pipeline
from repro_torch.launch import mesh as tmesh

from _torch_common import as_np

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CFG = dict(gf_radius=8, update_period=3, lam=0.3)
AXES3 = ("pod", "data", "model")


# --- the production meshes ---------------------------------------------------

class _PodMesh:
    """A stand-in (pod 2, data 3, model 4) mesh, the shape of the JAX
    package's ``test_batch_axes_for_pod_prefix``: the port reads
    ``mesh_dim_names`` and ``size(i)``, the reference ``axis_names`` and
    ``shape``."""
    mesh_dim_names = axis_names = AXES3
    shape = {"pod": 2, "data": 3, "model": 4}

    def size(self, i):
        return self.shape[AXES3[i]]


class _DataMesh:
    mesh_dim_names = axis_names = ("data", "model")
    shape = {"data": 4, "model": 2}

    def size(self, i):
        return self.shape[self.mesh_dim_names[i]]


@pytest.mark.parametrize("mesh,batch", [(_PodMesh(), b) for b in (6, 12, 4, 2, 9, 3)]
                         + [(_DataMesh(), b) for b in (8, 3)])
def test_batch_axes_for_matches_jax(mesh, batch):
    assert tmesh.batch_axes_for(mesh, batch) == jmesh.batch_axes_for(mesh, batch)


def test_production_mesh_spec_and_size_check(monkeypatch):
    """The shape and axis names the reference's ``make_production_mesh``
    hands ``compat.make_mesh``; the size check raises with the rank count
    it needs, on a one-rank gloo group and before making one where there
    is none."""
    monkeypatch.setattr(jmesh.compat, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    for multi_pod, n in ((False, 256), (True, 512)):
        want = jmesh.make_production_mesh(multi_pod=multi_pod)
        assert tmesh.production_mesh_spec(multi_pod) == want
        assert int(np.prod(want[0])) == n
        assert not dist.is_initialized()
        with pytest.raises(ValueError, match=f"needs {n} ranks.*has 1"):
            tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for multi_pod, n in ((False, 256), (True, 512)):
            with pytest.raises(ValueError, match=f"needs {n} ranks.*has 1"):
                tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


# --- the gather's order --------------------------------------------------------

class _RankMesh:
    """A stand-in mesh over a tensor of global ranks: ``get_local_rank``
    reads this rank's coordinates from it."""

    def __init__(self, ranks, names, me):
        self.mesh, self.mesh_dim_names, self.me = ranks, names, me
        self.shape = tuple(ranks.shape)

    def get_local_rank(self, axis):
        where = (self.mesh == self.me).nonzero()[0]
        return int(where[self.mesh_dim_names.index(axis)])

    def get_group(self, axis):
        raise AssertionError("several live axes make their own group")


@pytest.mark.parametrize("axes", [("pod", "data"), ("data", "pod")])
@pytest.mark.parametrize("layout", ["row-major", "shuffled"])
def test_gather_puts_blocks_in_the_reference_order(axes, layout, monkeypatch):
    """Every rank's gathered blocks come out row-major over ``axes`` in the
    order given, whatever order the group keeps its ranks in, and each
    rank's index is its place there; one group a model coordinate, made by
    every rank in the same order, once a mesh."""
    shape = (2, 2, 3)                                # pod, data, model
    ranks = torch.arange(12).reshape(shape)
    if layout == "shuffled":
        ranks = ranks.flatten()[torch.tensor(
            [7, 2, 11, 0, 5, 9, 1, 10, 3, 8, 6, 4])].reshape(shape)
    made = []

    class Group:
        def __init__(self, members):
            self.members = members[::-1]             # not the caller's order
    monkeypatch.setattr(dist, "new_group",
                        lambda ranks: made.append(Group(ranks)) or made[-1])
    monkeypatch.setattr(dist, "get_process_group_ranks", lambda g: g.members)
    monkeypatch.setattr(pipeline, "_all_gather", lambda x, g: torch.cat(
        [torch.full_like(x, r) for r in g.members]))
    for me in range(12):
        made.clear()
        monkeypatch.setattr(dist, "get_rank", lambda: me)
        mesh = _RankMesh(ranks, AXES3, me)
        gather, index = pipeline._batch_gather(mesh, axes)
        assert len(made) == 3                        # one a model coordinate
        pipeline._batch_gather(mesh, axes[::-1])     # the groups are kept
        assert len(made) == 3
        got = gather(torch.zeros(2, dtype=torch.int64)).reshape(4, 2)
        m = mesh.get_local_rank("model")
        coords = [(i, j) for i in range(2) for j in range(2)]   # row-major
        want = [int(ranks[(c[0], c[1], m) if axes[0] == "pod"
                          else (c[1], c[0], m)]) for c in coords]
        assert got[:, 0].tolist() == want and got[:, 1].tolist() == want
        assert want[index] == me


# --- four ranks ----------------------------------------------------------------

_RANK = textwrap.dedent("""
    import json
    import os
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import DehazeConfig, PlacementSpec, init_atmo_state, make_step
    from repro_torch.launch.mesh import batch_axes_for

    rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    cfg_kw = json.loads(sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                            world_size=4)
    data = np.load(inp)
    frames, ids = data["frames"], data["ids"]
    names = ("pod", "data", "model")
    res = {}
    for shape, cells in (((2, 2, 1), ((("pod", "data"), None),
                                      (("data", "pod"), None))),
                         ((2, 1, 2), ((("pod",), "model"),
                                      (("pod", "data"), "model")))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        coord = [mesh.get_local_rank(ax) for ax in names]
        res[f"{shape}_coord"] = np.asarray(coord)
        res[f"{shape}_axes_for"] = np.asarray(
            [str(batch_axes_for(mesh, b)) for b in (8, 2, 3)])
        for axes, height in cells:
            # This rank's block by the reference's order: row-major over
            # the axes as given.
            block, n = 0, 1
            for ax in axes:
                size = shape[names.index(ax)]
                block, n = block * size + coord[names.index(ax)], n * size
            b_loc = len(ids) // n
            mine = slice(block * b_loc, (block + 1) * b_loc)
            x = frames[mine]
            if height:
                h_loc = x.shape[1] // shape[2]
                x = x[:, coord[2] * h_loc:(coord[2] + 1) * h_loc]
            for algo in ("dcp", "cap"):
                for mode in ("fused", "auto"):
                    cfg = DehazeConfig(algorithm=algo, kernel_mode=mode, **cfg_kw)
                    step = make_step(cfg, PlacementSpec.frame_sharded(
                        axes, height, None), mesh)
                    o = step(torch.from_numpy(np.ascontiguousarray(x)),
                             torch.from_numpy(ids[mine]), init_atmo_state("cpu"))
                    key = f"{shape}_{'_'.join(axes)}_{algo}_{mode}"
                    for k, v in (("frames", o.frames), ("t", o.transmission),
                                 ("a", o.atmo_light), ("A", o.state.A),
                                 ("k", o.state.last_update)):
                        res[f"{key}_{k}"] = v.numpy()
    np.savez(out, **res)
    dist.destroy_process_group()
    # Leave without the interpreter's teardown: under load, torch's C++
    # teardown at exit can abort a rank (std::terminate) after its outputs
    # are saved.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
""")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Start the four ranks (each runs every cell), collect their outputs."""
    tmp = tmp_path_factory.mktemp("multiaxis")
    rng = np.random.default_rng(24)
    frames = rng.random((8, 32, 24, 3)).astype(np.float32) * 0.8 + 0.1
    ids = np.arange(8, dtype=np.int32)
    np.savez(tmp / "in.npz", frames=frames, ids=ids)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               GLOO_SOCKET_IFNAME="lo")
    env.pop("REPRO_KERNEL_MODE", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp / "store"),
         str(tmp / "in.npz"), str(tmp / f"out{r}.npz"), json.dumps(CFG)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"rank failed:\n{log}"
    return frames, ids, [dict(np.load(tmp / f"out{r}.npz")) for r in range(4)]


def _stitch(outs, shape, axes, height, key):
    """The whole batch from the ranks' blocks, each put in its place by the
    reference's order (and its rows by its model coordinate)."""
    names = list(AXES3)
    n = int(np.prod([shape[names.index(ax)] for ax in axes]))
    parts = {}
    for o in outs:
        coord = o[f"{shape}_coord"]
        block = 0
        for ax in axes:
            block = block * shape[names.index(ax)] + coord[names.index(ax)]
        parts[(block, coord[2] if height else 0)] = o[key]
    n_h = shape[2] if height else 1
    rows = [np.concatenate([parts[(b, m)] for m in range(n_h)], axis=1)
            if parts[(b, 0)].ndim > 2 else parts[(b, 0)] for b in range(n)]
    return np.concatenate(rows)


CELLS = [((2, 2, 1), ("pod", "data"), None), ((2, 2, 1), ("data", "pod"), None),
         ((2, 1, 2), ("pod",), "model"), ((2, 1, 2), ("pod", "data"), "model")]


@pytest.mark.parametrize("algo", ["dcp", "cap"])
def test_four_rank_multiaxis_steps_match_single_device(four_ranks, algo):
    frames, ids, outs = four_ranks
    want = jax.jit(jax_single_step(JaxConfig(algorithm=algo, kernel_mode="ref",
                                             **CFG)))(
        jnp.asarray(frames), jnp.asarray(ids), jax_init())
    for shape, axes, height in CELLS:
        for mode in ("fused", "auto"):
            key = f"{shape}_{'_'.join(axes)}_{algo}_{mode}"
            cell = f"{shape} {axes} {algo} {mode}"
            got = {k: _stitch(outs, shape, axes, height, f"{key}_{k}")
                   for k in ("frames", "t", "a")}
            for k, w, tol in (("frames", want.frames, 2e-5),
                              ("t", want.transmission, 2e-5),
                              ("a", want.atmo_light, 1e-5)):
                np.testing.assert_allclose(got[k], as_np(w), atol=tol, rtol=0,
                                           err_msg=f"{cell} {k}")
            for o in outs:                       # the state is replicated
                np.testing.assert_allclose(o[f"{key}_A"], as_np(want.state.A),
                                           atol=1e-5, rtol=0, err_msg=cell)
                assert int(o[f"{key}_k"]) == int(want.state.last_update), cell


@pytest.mark.parametrize("algo", ["dcp", "cap"])
@pytest.mark.parametrize("mode", ["fused", "auto"])
def test_axis_orders_agree_bit_for_bit(four_ranks, algo, mode):
    """``("pod", "data")`` and ``("data", "pod")`` hold different blocks on
    each rank; put in place, their outputs are the same bits."""
    _, _, outs = four_ranks
    shape = (2, 2, 1)
    for k in ("frames", "t", "a"):
        one, two = (_stitch(outs, shape, axes, None,
                            f"{shape}_{'_'.join(axes)}_{algo}_{mode}_{k}")
                    for axes in (("pod", "data"), ("data", "pod")))
        np.testing.assert_array_equal(one, two)


def test_batch_axes_for_on_device_meshes(four_ranks):
    """On the ranks' DeviceMeshes, for 8, 2 and 3 frames: the reference's
    answer on a stand-in mesh of the same shape."""
    _, _, outs = four_ranks

    class Mesh:
        axis_names = AXES3

    for shape in ((2, 2, 1), (2, 1, 2)):
        mesh = Mesh()
        mesh.shape = dict(zip(AXES3, shape))
        want = [str(jmesh.batch_axes_for(mesh, b)) for b in (8, 2, 3)]
        for o in outs:
            assert o[f"{shape}_axes_for"].tolist() == want, shape
