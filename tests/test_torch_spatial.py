"""PyTorch port, spatial (H/W halo) sharding: the halo exchange, the masked
filters (B8a, B8b), one shard's fused transmission stage (B9), the
cross-shard candidate merge (B10) and the spatially sharded step, against
the JAX package on the same numpy inputs.

On the CPU every kernel wrapper runs its plain version; the kernels are
held against those on the card (``chip_smoke.py`` phases 13-14 and the
``cuda``-marked tests below). The kernel cells compare the plain versions
(and B9's pass sequence through its plain passes, the wiring the card
runs) with the Pallas kernels in interpret mode: masked filters 1e-6
(the min exact); B9 t 1e-5, tk_t and tk_idx exact, tk_rgb 1e-6; B10 1e-6.

The distributed cells run four gloo ranks in child processes (file
rendezvous, ``GLOO_SOCKET_IFNAME=lo``) that loop over every mesh and cell,
and one JAX child with eight forced host devices for the reference's
``shard_map`` exchange and its packed-bfloat16 sharded step. The exchange
is compared exactly; the stitched steps with the JAX single-device step at
the reference's sharded-vs-single tolerances (``tests/test_parity_matrix.py``:
J/t 2e-5, A 1e-5, ``last_update`` exact; the plateau cell's A 1e-6), the
packed bfloat16 cell with the JAX sharded step of the same config (2e-5:
the bfloat16 wire rounds the halos on both sides alike).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import DehazeConfig as JaxConfig
from repro.core import init_atmo_state as jax_init
from repro.core import init_atmo_state_lanes as jax_init_lanes
from repro.core import make_dehaze_step as jax_single_step
from repro.core import make_multi_stream_step as jax_multi_step
from repro.kernels import ops as jops
from repro.kernels.atmolight import merge_topk_pallas
from repro.kernels.fused import fused_transmission_halo_pallas
from repro_torch.core import DehazeConfig, PlacementSpec, make_step
from repro_torch.kernels import fused, staged
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_common import as_np, ramp_frames, wire
from _torch_common import launch_counters_restored  # noqa: F401 (autouse)

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def tile_ext(plane: np.ndarray, halo_h: int, halo_w: int, n_h: int,
             n_w: int, i: int, j: int):
    """Tile (i, j) of an n_h x n_w tiling of (B, H, W, ...) frames, extended
    by the halos, zero and invalid past the frame: what the exchange
    delivers. Returns ``(ext, row validity, column validity)``."""
    b, H, W = plane.shape[:3]
    h, w = H // n_h, W // n_w
    rows = np.arange(i * h - halo_h, (i + 1) * h + halo_h)
    cols = np.arange(j * w - halo_w, (j + 1) * w + halo_w)
    vr, vc = (rows >= 0) & (rows < H), (cols >= 0) & (cols < W)
    ext = np.zeros((b, rows.size, cols.size) + plane.shape[3:], plane.dtype)
    ext[np.ix_(np.arange(b), np.flatnonzero(vr), np.flatnonzero(vc))] = \
        plane[np.ix_(np.arange(b), rows[vr], cols[vc])]
    return ext, vr, vc


# --- B8a / B8b: the masked filters -----------------------------------------

@pytest.mark.parametrize("case", ["rows", "rows_cols", "invalid_edge",
                                  "wide_window"])
def test_masked_filters_match_pallas(case):
    rng = np.random.default_rng(40)
    x = rng.random((2, 14, 18)).astype(np.float32)
    valid = rng.random(14) > 0.3
    valid_w = (rng.random(18) > 0.3) if case == "rows_cols" else None
    radius = 20 if case == "wide_window" else 3
    if case == "invalid_edge":               # a corner tile: both edges off
        valid, valid_w = np.arange(14) >= 5, np.arange(18) < 12
    tv = torch.from_numpy(valid)
    tw = None if valid_w is None else torch.from_numpy(valid_w)
    jw = None if valid_w is None else jnp.asarray(valid_w)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for mode in ("pallas", "ref"):
        np.testing.assert_array_equal(
            as_np(tops.masked_min_filter_2d(tx, tv, radius, tw, mode=mode)),
            as_np(jops.masked_min_filter_2d(jx, jnp.asarray(valid), radius,
                                            jw, mode="interpret")))
        np.testing.assert_allclose(
            as_np(tops.masked_box_filter_2d(tx, tv, radius, tw, mode=mode)),
            as_np(jops.masked_box_filter_2d(jx, jnp.asarray(valid), radius,
                                            jw, mode="interpret")),
            atol=1e-6, rtol=0)


# --- B9: one shard's fused transmission stage ------------------------------

HALO_KW = dict(radius=2, omega=0.95, beta=1.0, gf_radius=3, gf_eps=1e-3)
HALO = 2 + 2 * 3


def _halo_inputs(algorithm, tiling, tile, img_dtype, plane_dtype):
    """A tile of 2 frames of 24x30 in the wire dtype and its extended
    (pre-map, luma) planes, the maps taken over the whole frame first."""
    (n_h, n_w), (i, j) = tiling, tile
    x = ramp_frames(41, 2, h=24, w=30)
    _, tx = wire(x, img_dtype)
    xf = tref.upcast_frames(tx)
    a0 = torch.tensor([0.9, 0.85, 0.8])
    pre = tref.premap(xf, a0, algorithm).numpy()
    guide = tref.luminance(xf).numpy()
    hh, hw = (HALO if n_h > 1 else 0), (HALO if n_w > 1 else 0)
    pre_ext, vr, vc = tile_ext(pre, hh, hw, n_h, n_w, i, j)
    guide_ext, _, _ = tile_ext(guide, hh, hw, n_h, n_w, i, j)
    img, _, _ = tile_ext(tx.numpy(), 0, 0, n_h, n_w, i, j)
    valid_w = vc if n_w > 1 else None
    tdt = torch.bfloat16 if plane_dtype == "bfloat16" else torch.float32
    port = (torch.from_numpy(img), torch.from_numpy(pre_ext).to(tdt),
            torch.from_numpy(guide_ext).to(tdt), torch.from_numpy(vr),
            None if valid_w is None else torch.from_numpy(valid_w))
    jdt = jnp.bfloat16 if plane_dtype == "bfloat16" else jnp.float32
    jax_in = (jnp.asarray(img), jnp.asarray(pre_ext).astype(jdt),
              jnp.asarray(guide_ext).astype(jdt), jnp.asarray(vr),
              None if valid_w is None else jnp.asarray(valid_w))
    return port, jax_in


@pytest.mark.parametrize("algorithm,topk,tiling,tile,img_dtype,plane_dtype", [
    ("dcp", 1, (2, 2), (0, 0), "uint8", "float32"),     # corner
    ("cap", 4, (2, 2), (1, 1), "float32", "float32"),   # the other corner
    ("dcp", 4, (3, 3), (1, 1), "float32", "float32"),   # interior
    ("cap", 1, (2, 1), (1, 0), "float32", "float32"),   # edge, halo_w = 0
    ("dcp", 4, (1, 2), (0, 1), "uint8", "bfloat16"),    # edge, halo_h = 0
    ("cap", 4, (2, 2), (0, 1), "uint8", "bfloat16"),    # corner, bf16 planes
])
def test_halo_stage_matches_pallas(algorithm, topk, tiling, tile, img_dtype,
                                   plane_dtype):
    port, jax_in = _halo_inputs(algorithm, tiling, tile, img_dtype,
                                plane_dtype)
    kw = dict(HALO_KW, algorithm=algorithm, refine=True, topk=topk)
    want = fused_transmission_halo_pallas(*jax_in, interpret=True, **kw)
    s = fused.make_halo_static(*port[:3], **kw)
    vh = staged.validity_bytes(port[3], s.h_ext, "cpu")
    vw = staged.validity_bytes(port[4], s.w_ext, "cpu")
    ten = fused.run_halo_passes(*port[:3], vh, vw, s, fused.HALO_PLAIN_PASSES)
    # The masked tiled sequence (halo 8 > r 2: rows and columns whose t_raw
    # window holds no valid pixel) equals the ten masked passes.
    tiled = fused.run_tiled_halo_passes(*port[:3], vh, vw, s,
                                        fused.TILED_HALO_PLAIN_PASSES)
    for g, t in zip(tiled, ten):
        assert torch.equal(g, t)
        assert not torch.isnan(g.float()).any()
    for got in (tops.fused_transmission_halo(*port, mode="pallas", **kw), ten,
                tiled):
        t, tk_t, tk_rgb, tk_idx = got
        np.testing.assert_allclose(as_np(t), as_np(want[0]), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(as_np(tk_t), as_np(want[1]))
        np.testing.assert_allclose(as_np(tk_rgb), as_np(want[2]), atol=1e-6,
                                   rtol=0)
        np.testing.assert_array_equal(as_np(tk_idx), as_np(want[3]))


def test_halo_stage_without_refine_is_t_raw():
    """t is the core's t_raw. Within one float32 step of the Pallas kernel
    (XLA may contract ``1 - omega * dark`` into one multiply-add on the
    CPU, the port rounds the product); the picks are the same pixels."""
    port, jax_in = _halo_inputs("dcp", (2, 2), (1, 0), "float32", "float32")
    kw = dict(HALO_KW, algorithm="dcp", refine=False, topk=2)
    want = fused_transmission_halo_pallas(*jax_in, interpret=True, **kw)
    got = tops.fused_transmission_halo(*port, mode="ref", **kw)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(as_np(g), as_np(w), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(as_np(got[3]), as_np(want[3]))


# --- B10: the cross-shard merge --------------------------------------------

def _merge_inputs(case):
    rng = np.random.default_rng(42)
    n, m, k = 3, 16, 4
    if case == "k1":
        m, k = 12, 1
    if case == "ragged":
        m, k = 10, 3
    t = rng.random((n, m)).astype(np.float32)
    if case == "ties":            # plateaus spanning the k-row segments
        t = np.round(t * 2).astype(np.float32) / 4 + 0.25
    gidx = np.stack([rng.permutation(1000)[:m] for _ in range(n)]
                    ).astype(np.int32)
    rgb = rng.random((n, m, 3)).astype(np.float32)
    return t, gidx, rgb, k


@pytest.mark.parametrize("case", ["unsorted", "ties", "k1", "ragged"])
def test_merge_matches_pallas(case):
    t, gidx, rgb, k = _merge_inputs(case)
    want = merge_topk_pallas(jnp.asarray(t), jnp.asarray(gidx),
                             jnp.asarray(rgb), k, interpret=True)
    want_sort = jops.merge_topk_candidates(jnp.asarray(t), jnp.asarray(gidx),
                                           jnp.asarray(rgb), k, mode="ref")
    np.testing.assert_allclose(as_np(want), as_np(want_sort), atol=1e-6)
    args = (torch.from_numpy(t), torch.from_numpy(gidx), torch.from_numpy(rgb))
    for mode in ("pallas", "ref"):
        got = tops.merge_topk_candidates(*args, k, mode=mode)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-6, rtol=0)


def test_merge_keys_on_the_global_index_not_the_row():
    """Equal t in every row: the picks are the k smallest global indices,
    wherever they sit in the gathered list."""
    t = torch.full((1, 8), 0.5)
    gidx = torch.tensor([[70, 3, 50, 9, 1, 80, 2, 60]], dtype=torch.int32)
    rgb = torch.arange(24, dtype=torch.float32).reshape(1, 8, 3)
    got = staged.plain_merge_topk(t, gidx, rgb, 3)
    want = rgb[0, [4, 6, 1]].mean(0)
    np.testing.assert_allclose(as_np(got[0]), as_np(want), atol=1e-6)


# --- the halo exchange and the spatially sharded step (child processes) ----

STEP = dict(patch_radius=3, gf_radius=4, update_period=2, lam=0.3)
STEP_HALO = 3 + 2 * 4
B, H, W, L = 4, 32, 32, 4

# (mesh, placement, algorithm, topk, kernel_mode); meshes name their axes
# ("data", "model", "width") or, for the lane cells, ("data", "model").
CELLS = ([("122", "frame", a, k, m) for a in ("dcp", "cap") for k in (1, 4)
          for m in ("auto", "fused")]
         + [("221", "frame", "dcp", 1, "fused"), ("221", "frame", "cap", 4, "ref"),
            ("141", "frame", "dcp", 4, "fused"), ("141", "frame", "cap", 1, "ref"),
            ("22", "lanes", "dcp", 4, "fused"), ("22", "lanes", "cap", 1, "auto"),
            ("122", "plateau", "dcp", 4, "ref"),
            ("122", "plateau", "dcp", 4, "fused"),
            ("122", "packed", "dcp", 4, "fused"),
            ("122", "packed", "cap", 1, "auto")])
CELL_IDS = ["-".join(map(str, c)) for c in CELLS]

_RANK = textwrap.dedent("""
    import os
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import (DehazeConfig, PlacementSpec, init_atmo_state,
                                  init_atmo_state_lanes, make_step, spatial)

    rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                            world_size=4)
    d = np.load(inp)
    step_kw = dict(patch_radius=3, gf_radius=4, update_period=2, lam=0.3)
    halo = 3 + 2 * 4
    names = ("data", "model", "width")
    meshes = {m: init_device_mesh("cpu", tuple(int(c) for c in m),
                                  mesh_dim_names=names)
              for m in ("122", "221", "141")}
    meshes["22"] = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = {}

    def coords(mesh):
        return tuple(mesh.get_local_rank(a) for a in mesh.mesh_dim_names)

    def block(x, mesh, sp):
        # This rank's block: axis 0 (frames or lanes) over data, axes sp
        # and sp + 1 (rows, columns) over model and width.
        c = dict(zip(mesh.mesh_dim_names, coords(mesh)))
        n = dict(zip(mesh.mesh_dim_names, mesh.shape))
        b = x.shape[0] // n["data"]
        h, w = x.shape[sp] // n["model"], x.shape[sp + 1] // n.get("width", 1)
        cw = c.get("width", 0)
        idx = [slice(None)] * x.ndim
        idx[0] = slice(c["data"] * b, (c["data"] + 1) * b)
        idx[sp] = slice(c["model"] * h, (c["model"] + 1) * h)
        idx[sp + 1] = slice(cw * w, (cw + 1) * w)
        return torch.from_numpy(np.ascontiguousarray(x[tuple(idx)]))

    # The exchange: height then width on (1, 2, 2), height over 4 (two hops).
    for m in ("122", "141"):
        mesh = meshes[m]
        blk = block(d["x"], mesh, 1)
        e, vh = spatial.halo_exchange_height(blk, halo, mesh, "model")
        vw = torch.ones(e.shape[2], dtype=torch.bool)
        if mesh.shape[2] > 1:
            e, vw = spatial.halo_exchange_width(e, halo, mesh, "width")
        res[f"ex{m}_x"], res[f"ex{m}_vh"], res[f"ex{m}_vw"] = (
            e.numpy(), vh.numpy(), vw.numpy())

    cells = [c.split("-") for c in d["cells"]]
    for m, kind, algo, k, mode in cells:
        mesh = meshes[m]
        tag = "-".join((m, kind, algo, k, mode))
        kw = dict(step_kw, algorithm=algo, topk=int(k), kernel_mode=mode)
        if kind == "plateau":
            kw["update_period"] = 1
        if kind == "packed":
            kw.update(halo_packed=True, halo_dtype="bfloat16")
        cfg = DehazeConfig(**kw)
        if kind == "lanes":
            placement = PlacementSpec.lane_sharded(height_axis="model")
            frames, state = d["lanes"], init_atmo_state_lanes(2)
        else:
            placement = PlacementSpec.frame_sharded(("data",), "model", "width")
            frames = d["plateau"] if kind == "plateau" else d["frames"]
            state = init_atmo_state()
        step = make_step(cfg, placement, mesh)
        all_ids = d[f"ids_{kind == 'lanes'}"]
        n_d, d_rank = mesh.shape[0], coords(mesh)[0]
        for batch in range(2):
            x = block(frames[batch], mesh, 2 if kind == "lanes" else 1)
            ids = all_ids + batch * all_ids.shape[-1]
            b = ids.shape[0] // n_d
            ids = np.ascontiguousarray(ids[d_rank * b:(d_rank + 1) * b])
            o = step(x, torch.from_numpy(ids), state)
            state = o.state
            for key, v in (("frames", o.frames), ("t", o.transmission),
                           ("a", o.atmo_light), ("A", o.state.A),
                           ("k", o.state.last_update)):
                res[f"{tag}_{batch}_{key}"] = v.float().numpy() \\
                    if v.is_floating_point() else v.numpy()
        res[f"{tag}_coords"] = np.asarray(coords(mesh))
    np.savez(out, **res)
    dist.destroy_process_group()
    # Leave without the interpreter's teardown: under load, torch's C++
    # teardown at exit can abort a rank (std::terminate) after its outputs
    # are saved.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
""")

_JAX = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.core import compat, spatial
    from repro.core import (DehazeConfig, init_atmo_state,
                            make_sharded_dehaze_step)

    inp, out = sys.argv[1], sys.argv[2]
    d = np.load(inp)
    halo = 3 + 2 * 4
    res = {}
    for m, n_h, n_w in (("122", 2, 2), ("141", 4, 1)):
        mesh = compat.make_mesh((n_h, n_w), ("model", "width"))

        def body(blk, n_h=n_h, n_w=n_w):
            e, vh = spatial.halo_exchange_height(blk, halo, "model", n_h)
            vw = jnp.ones((e.shape[2],), bool)
            if n_w > 1:
                e, vw = spatial.halo_exchange_width(e, halo, "width", n_w)
            return e, vh[None], vw[None]

        f = compat.shard_map(body, mesh=mesh,
                             in_specs=P(None, "model", "width"),
                             out_specs=(P(None, "model", "width"),
                                        P("model", None), P("width", None)))
        e, vh, vw = jax.jit(f)(jnp.asarray(d["x"]))
        res[f"ex{m}_x"], res[f"ex{m}_vh"], res[f"ex{m}_vw"] = (
            np.asarray(e), np.asarray(vh), np.asarray(vw))
    # The packed bfloat16 halo cells' reference: the JAX sharded step of
    # the same config on a (1, 2, 2) mesh.
    mesh = compat.make_mesh((1, 2, 2), ("data", "model", "width"))
    for algo, k in (("dcp", 4), ("cap", 1)):
        cfg = DehazeConfig(algorithm=algo, topk=k, kernel_mode="ref",
                           patch_radius=3, gf_radius=4, update_period=2,
                           lam=0.3, halo_packed=True, halo_dtype="bfloat16")
        step, _, _ = make_sharded_dehaze_step(cfg, mesh, ("data",), "model",
                                              "width")
        state = init_atmo_state()
        for batch in range(2):
            ids = jnp.arange(4 * batch, 4 * batch + 4, dtype=jnp.int32)
            with mesh:
                o = jax.jit(step)(jnp.asarray(d["frames"][batch]), ids, state)
            state = o.state
            for key, v in (("frames", o.frames), ("t", o.transmission),
                           ("a", o.atmo_light), ("A", o.state.A),
                           ("k", o.state.last_update)):
                res[f"packed-{algo}-{k}_{batch}_{key}"] = np.asarray(v)
    np.savez(out, **res)
""")


def _plateau_frames():
    """Quantized frames: equal-t plateaus across the tile boundaries, with
    per-pixel rgb still varying inside them (``test_parity_matrix.py``)."""
    rng = np.random.default_rng(7)
    q = np.round(rng.random((2, B, H, W, 3)) * 4) / 4
    return (q * 0.8 + 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def spatial_runs(tmp_path_factory):
    """Run the four gloo ranks and the JAX child once for the module:
    ``(per-rank outputs, JAX child outputs, inputs)``."""
    tmp = tmp_path_factory.mktemp("spatial")
    inputs = dict(
        x=ramp_frames(43, B, h=H, w=W),
        frames=ramp_frames(44, 2, B, h=H, w=W),
        plateau=_plateau_frames(),
        lanes=ramp_frames(45, 2, L, 2, h=H, w=W),
        ids_False=np.arange(B, dtype=np.int32),
        ids_True=np.tile(np.arange(2, dtype=np.int32), (L, 1)),
        cells=np.asarray(CELL_IDS))
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               GLOO_SOCKET_IFNAME="lo")
    env.pop("REPRO_KERNEL_MODE", None)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp / "store"),
         str(tmp / "in.npz"), str(tmp / f"out{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp / "in.npz"), str(tmp / "jax.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"child failed:\n{log}"
    ranks = [dict(np.load(tmp / f"out{r}.npz")) for r in range(4)]
    return ranks, dict(np.load(tmp / "jax.npz")), inputs


@pytest.mark.parametrize("mesh", ["122", "141"])
def test_halo_exchange_matches_jax(spatial_runs, mesh):
    """Height over 2 then width over 2 (one hop, corners through the width
    exchange), and height over 4 with 8-row shards (halo 11: two hops)."""
    ranks, want, inputs = spatial_runs
    n_h, n_w = (2, 2) if mesh == "122" else (4, 1)
    for r in range(4):
        i, j = (r // 2, r % 2) if mesh == "122" else (r, 0)
        ext = ranks[r][f"ex{mesh}_x"]
        he, we = ext.shape[1], ext.shape[2]
        np.testing.assert_array_equal(
            ext, want[f"ex{mesh}_x"][:, i * he:(i + 1) * he, j * we:(j + 1) * we])
        np.testing.assert_array_equal(ranks[r][f"ex{mesh}_vh"],
                                      want[f"ex{mesh}_vh"][i])
        np.testing.assert_array_equal(ranks[r][f"ex{mesh}_vw"],
                                      want[f"ex{mesh}_vw"][j])
        # And what the exchange delivers is the frame's slice, zero past it.
        halo_w = STEP_HALO if n_w > 1 else 0
        sl, vr, vc = tile_ext(inputs["x"], STEP_HALO,
                              halo_w, n_h, n_w, i, j)
        np.testing.assert_array_equal(ext, sl)
        np.testing.assert_array_equal(ranks[r][f"ex{mesh}_vh"], vr)
        if n_w > 1:
            np.testing.assert_array_equal(ranks[r][f"ex{mesh}_vw"], vc)


def _stitch(ranks, tag, batch, key, lanes):
    """The ranks' blocks of one output put back together: frames over
    data (lanes over data for the lane cells), rows over model, columns
    over width; the state is replicated (each data rank's own lanes)."""
    lead = 1 if lanes else 0
    blocks = {}
    for r in ranks:
        c = tuple(r[f"{tag}_coords"]) + (0,)
        blocks[c[:3]] = r[f"{tag}_{batch}_{key}"]
    n = [max(c[i] for c in blocks) + 1 for i in range(3)]
    if key in ("A", "k") and not lanes:
        return blocks[(0, 0, 0)]
    if key in ("A", "k", "a"):
        return np.concatenate([blocks[(d, 0, 0)] for d in range(n[0])])
    return np.concatenate([np.concatenate(
        [np.concatenate([blocks[(d, m, w)] for w in range(n[2])],
                        axis=lead + 2) for m in range(n[1])], axis=lead + 1)
        for d in range(n[0])])


_JAX_WANT = {}


def _jax_want(kind, algorithm, topk, inputs):
    """The JAX single-device step (kernel_mode ``ref``) over the cell's two
    chained batches; lanes through the multi-stream step."""
    key = (kind, algorithm, topk)
    if key not in _JAX_WANT:
        kw = dict(STEP, algorithm=algorithm, topk=topk, kernel_mode="ref")
        if kind == "plateau":
            kw["update_period"] = 1
        cfg = JaxConfig(**kw)
        if kind == "lanes":
            step, state = jax.jit(jax_multi_step(cfg)), jax_init_lanes(L)
            frames, ids = inputs["lanes"], inputs["ids_True"]
        else:
            step, state = jax.jit(jax_single_step(cfg)), jax_init()
            frames = inputs["plateau" if kind == "plateau" else "frames"]
            ids = inputs["ids_False"]
        outs = []
        for batch in range(2):
            o = step(jnp.asarray(frames[batch]),
                     jnp.asarray(ids + batch * ids.shape[-1]), state)
            state = o.state
            outs.append(o)
        _JAX_WANT[key] = outs
    return _JAX_WANT[key]


@pytest.mark.parametrize("cell", CELL_IDS)
def test_spatial_step_matches_single_device(spatial_runs, cell):
    ranks, jax_out, inputs = spatial_runs
    mesh, kind, algorithm, topk, mode = cell.split("-")
    lanes = kind == "lanes"
    wants = None if kind == "packed" else \
        _jax_want(kind, algorithm, int(topk), inputs)
    a_tol = 1e-6 if kind == "plateau" else 1e-5
    for batch in range(2):
        got = {k: _stitch(ranks, cell, batch, k, lanes)
               for k in ("frames", "t", "a", "A", "k")}
        if kind == "packed":
            want = {k: jax_out[f"packed-{algorithm}-{topk}_{batch}_{k}"]
                    for k in got}
        else:
            o = wants[batch]
            want = dict(frames=as_np(o.frames), t=as_np(o.transmission),
                        a=as_np(o.atmo_light), A=as_np(o.state.A),
                        k=as_np(o.state.last_update))
        for k, tol in (("frames", 2e-5), ("t", 2e-5), ("a", a_tol),
                       ("A", a_tol)):
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                       err_msg=f"{cell} b{batch} {k}")
        np.testing.assert_array_equal(got["k"], want["k"])


# --- contracts and the card ------------------------------------------------

class _Mesh:
    """A stand-in ("data", "model", "width") mesh of the given sizes."""
    mesh_dim_names = ("data", "model", "width")
    device_type = "cpu"

    def __init__(self, *shape):
        self.shape = shape

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


def test_spatial_step_contracts():
    cfg = DehazeConfig()
    # Frames over several mesh axes (once NotImplementedError) build a step.
    assert callable(make_step(cfg, PlacementSpec.frame_sharded(
        ("data", "width"), "model", None), _Mesh(1, 2, 1)))
    with pytest.raises(ValueError, match="no 'pod'"):
        make_step(cfg, PlacementSpec.frame_sharded(("data",), "pod"),
                  _Mesh(1, 2, 1))
    with pytest.raises(ValueError, match="validity"):
        staged.cuda_masked_min_filter(torch.zeros(1, 4, 5), torch.ones(3), 1)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        staged.cuda_merge_topk(torch.zeros(1, 4), torch.zeros(1, 4, dtype=torch.int32),
                               torch.zeros(1, 4, 3), 2)
    with pytest.raises(ValueError, match="float32 t, int32"):
        staged.plain_merge_topk(torch.zeros(1, 4), torch.zeros(1, 4),
                                torch.zeros(1, 4, 3), 2)
    img = torch.zeros(1, 4, 5, 3)
    with pytest.raises(ValueError, match="evenly"):
        fused.make_halo_static(img, torch.zeros(1, 7, 5), torch.zeros(1, 7, 5),
                               radius=1, refine=True, gf_radius=1, gf_eps=1e-3)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fused.cuda_halo_min_rows(torch.zeros(1, 4, 5), torch.ones(4, dtype=torch.uint8),
                                 torch.ones(5, dtype=torch.uint8), None)


def test_cpu_halo_wrappers_launch_no_kernel():
    port, _ = _halo_inputs("dcp", (2, 2), (0, 1), "uint8", "float32")
    fused.reset_launches()
    staged.reset_launches()
    fused.fused_transmission_halo(*port, algorithm="dcp", refine=True,
                                  topk=2, **HALO_KW)
    staged.merge_topk_op(torch.zeros(1, 4), torch.arange(4, dtype=torch.int32)[None],
                         torch.zeros(1, 4, 3), 2)
    assert not any(fused.halo_launches.values())
    assert not any(staged.launches.values())


@pytest.mark.cuda
def test_spatial_kernels_match_plain_versions_on_the_card():
    """B8a, B8b (the masked strips, equal to the row window they replaced
    and to their plain versions with error 0), B9 (its masked tiled
    sequence, equal to the ten masked passes) and B10 against their plain
    versions on a corner tile (rows and columns masked at both edges)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for plane_dtype in ("float32", "bfloat16"):
        port, _ = _halo_inputs("cap", (2, 2), (0, 1), "uint8", plane_dtype)
        cuda = [None if v is None else v.cuda() for v in port]
        kw = dict(HALO_KW, algorithm="cap", refine=True, topk=4)
        fused.reset_launches()
        got = fused.fused_transmission_halo(*cuda, **kw)
        torch.cuda.synchronize()
        assert fused.halo_launches["tmap_tile"] == 1
        assert fused.halo_launches["min_rows"] == 0
        s = fused.make_halo_static(*cuda[:3], **kw)
        v = [staged.validity_bytes(c, n, "cuda")
             for c, n in ((cuda[3], s.h_ext), (cuda[4], s.w_ext))]
        for g, t in zip(got, fused.run_halo_passes(*cuda[:3], *v, s)):
            assert torch.equal(g, t)
        want = tref.fused_transmission_halo(*cuda, **kw)
        assert float((got[0] - want[0]).abs().max()) <= 1e-3
        assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
        assert float((got[2] - want[2]).abs().max()) <= 1e-5
        # B8a and B8b: the masked strips equal their plain versions and the
        # row window they replaced with error 0 (the mean bit for bit), at
        # r in {0, 2, 7, 20} and on both sides of the strips' limit (the
        # row window past it, by shape), the invalid pixels +-inf and NaN.
        pre, vh, vw = cuda[1], cuda[3], cuda[4]
        mask = vh.bool()[:, None] & vw.bool()[None, :]
        specials = torch.tensor([float("inf"), float("-inf"), float("nan")],
                                device="cuda").to(pre.dtype)
        bad = specials[torch.arange(mask.numel(), device="cuda") % 3].reshape(mask.shape)
        pre = torch.where(mask, pre, bad).contiguous()
        limit = max(r for r in range(400) if staged.strips_fit(
            "masked_box_filter", r, pre.dtype))
        for name in ("masked_min_filter", "masked_box_filter"):
            for r in (0, 2, 7, 20, limit, limit + 1):
                staged.reset_launches()
                g = staged.PAIRS[name][0](pre, vh, r, vw)
                torch.cuda.synchronize()
                assert staged.wide_launches[name] == int(r > limit), (name, r)
                old = staged._masked_window(name, pre, vh, r, vw, wide=True)
                w = staged.PAIRS[name][1](pre.cpu(), vh.cpu(), r, vw.cpu())
                assert torch.equal(g, old), (name, plane_dtype, r)
                assert not bool(torch.isnan(g).any()), (name, plane_dtype, r)
                assert torch.equal(g.cpu(), w), (name, plane_dtype, r)
    t, gidx, rgb, k = _merge_inputs("ties")
    args = [torch.from_numpy(a) for a in (t, gidx, rgb)]
    got = staged.cuda_merge_topk(*[a.cuda() for a in args], k)
    want = staged.plain_merge_topk(*args, k)
    assert float((got.cpu() - want).abs().max()) <= 1e-6
