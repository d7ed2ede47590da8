"""PyTorch port, the §3.3 state sync: ``kernels.ops.merge_ema`` (each
frame's candidate rows merged, then the lane's EMA; one CUDA kernel,
``staged.cuda_merge_ema``, on the card) against the JAX composition it
stands for on the same numpy inputs: ``repro.kernels.ops.
merge_topk_candidates`` on its ref substrate, then ``repro.core.normalize.
ema_scan`` or ``ema_scan_associative`` over each lane.

Cases: M candidate rows a frame in {1, 4, 16} (one row, a 2x2 tiling at
top-1, a 2x2 tiling at top-4), k in {1, 4}, t plateaus tied across the
shards' rows, padding ids, ids with gaps, warm and cold lanes and an
all-padding lane, period 1 and 8, both scan forms. Tolerances: a_seq and A
1e-5, last_update and initialized equal (the reference's pipeline level);
against the port's own composition (``staged.plain_merge_topk`` then
``core.normalize``'s scans) equality. A fake kernel library shows that the
staged lane step, a spatial step and the frame-sharded step each launch the
kernel once and the cross-shard merge never; on the CPU nothing launches.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import normalize as jn
from repro.kernels import ops as jops
from repro_torch.core import DehazeConfig, PlacementSpec
from repro_torch.core import normalize as tn
from repro_torch.core import pipeline, spatial
from repro_torch.kernels import ops as tops
from repro_torch.kernels import staged

from _torch_common import as_np
from _torch_common import launch_counters_restored  # noqa: F401 (autouse)

torch.set_num_threads(1)

L, B = 4, 8
LAM = 0.3
# Lane 0 warm with gaps, lane 1 cold behind padding frames, lane 2 all
# padding, lane 3 cold and consecutive.
IDS = np.asarray([[9, 10, 13, 14, 15, 16, 24, 25],
                  [-1, -1, 0, 1, 2, 3, -1, 5],
                  [-1] * B,
                  [40, 41, 42, 43, 44, 45, 46, 47]], np.int32)
# (M, k): one row a frame, a 2x2 tiling's lists at top-1 and at top-4,
# four rows all picked.
MK = [(1, 1), (4, 1), (4, 4), (16, 4)]


def _inputs(m: int, seed: int = 7):
    """(L, B, M) t with plateaus tied across the rows, distinct global
    indices, rgb in (0, 1), and a lane-batched state (lane 0 warm)."""
    rng = np.random.default_rng(seed + m)
    t = (np.round(rng.random((L, B, m)) * 3) / 4).astype(np.float32)
    gidx = np.stack([rng.permutation(10 * m)[:m] for _ in range(L * B)]
                    ).reshape(L, B, m).astype(np.int32)
    rgb = rng.uniform(0.05, 1.0, (L, B, m, 3)).astype(np.float32)
    A = np.ones((L, 3), np.float32)
    A[0] = [0.8, 0.85, 0.9]
    lu = np.full(L, -(2 ** 30), np.int32)
    lu[0] = 2
    inited = np.asarray([True, False, False, False])
    return t, gidx, rgb, (A, lu, inited)


def _torch_state(state):
    A, lu, inited = state
    return tn.AtmoState(A=torch.from_numpy(A.copy()),
                        last_update=torch.from_numpy(lu.copy()),
                        initialized=torch.from_numpy(inited.copy()))


def _jax(t, gidx, rgb, k, state, period, associative):
    """The JAX composition: the ref merge, then the scan of each lane."""
    m = t.shape[-1]
    if m == 1:
        cand = jnp.asarray(rgb[:, :, 0])
    else:
        cand = jops.merge_topk_candidates(
            jnp.asarray(t.reshape(L * B, m)), jnp.asarray(gidx.reshape(L * B, m)),
            jnp.asarray(rgb.reshape(L * B, m, 3)), k, mode="ref").reshape(L, B, 3)
    A, lu, inited = state
    js = jn.AtmoState(A=jnp.asarray(A), last_update=jnp.asarray(lu),
                      initialized=jnp.asarray(inited))
    return jn.ema_scan_lanes(cand, jnp.asarray(IDS), js, period, LAM,
                             associative=associative)


def _port(t, gidx, rgb, k, state, period, associative, mode):
    lists = (None, None) if t.shape[-1] == 1 else (torch.from_numpy(t),
                                                   torch.from_numpy(gidx))
    return tops.merge_ema(*lists, torch.from_numpy(rgb), k,
                          torch.from_numpy(IDS), _torch_state(state), period,
                          LAM, associative, mode=mode)


@pytest.mark.parametrize("associative", [True, False])
@pytest.mark.parametrize("period", [1, 8])
@pytest.mark.parametrize("m,k", MK)
def test_merge_ema_matches_jax(m, k, period, associative):
    t, gidx, rgb, state = _inputs(m)
    want_seq, want = _jax(t, gidx, rgb, k, state, period, associative)
    for mode in ("pallas", "ref"):
        got_seq, got = _port(t, gidx, rgb, k, state, period, associative, mode)
        assert got_seq.dtype == torch.float32 and got_seq.shape == (L, B, 3)
        np.testing.assert_allclose(as_np(got_seq), as_np(want_seq), atol=1e-5,
                                   rtol=0, err_msg=mode)
        np.testing.assert_allclose(as_np(got.A), as_np(want.A), atol=1e-5,
                                   rtol=0, err_msg=mode)
        np.testing.assert_array_equal(as_np(got.last_update),
                                      as_np(want.last_update))
        np.testing.assert_array_equal(as_np(got.initialized),
                                      as_np(want.initialized))
    # The all-padding lane keeps its state.
    assert torch.equal(got.A[2], torch.ones(3)) and not bool(got.initialized[2])


@pytest.mark.parametrize("associative", [True, False])
@pytest.mark.parametrize("m,k", MK)
def test_merge_ema_is_the_port_composition(m, k, associative):
    """The CPU route is the staged merge's plain version and the scan, bit
    for bit, and honours ``out_state`` (the donated state itself)."""
    t, gidx, rgb, state = _inputs(m, seed=11)
    period = 3
    tt, tg, tr = (torch.from_numpy(v) for v in (t, gidx, rgb))
    cand = tr[:, :, 0] if m == 1 else staged.plain_merge_topk(
        tt.reshape(-1, m), tg.reshape(-1, m), tr.reshape(-1, m, 3), k
    ).reshape(L, B, 3)
    scan = tn.ema_scan_associative if associative else tn.ema_scan
    want_seq, want = scan(cand, torch.from_numpy(IDS), _torch_state(state),
                          period, LAM)
    donated = _torch_state(state)
    ptrs = [v.data_ptr() for v in (donated.A, donated.last_update,
                                   donated.initialized)]
    got_seq, got = _port(t, gidx, rgb, k, state, period, associative, "pallas")
    seq2, got2 = tops.merge_ema(
        *((None, None) if m == 1 else (tt, tg)), tr, k, torch.from_numpy(IDS),
        donated, period, LAM, associative, mode="pallas", out_state=donated)
    for s, st in ((got_seq, got), (seq2, got2)):
        assert torch.equal(s, want_seq)
        for f in ("A", "last_update", "initialized"):
            assert torch.equal(getattr(st, f), getattr(want, f)), f
    assert [v.data_ptr() for v in (got2.A, got2.last_update,
                                   got2.initialized)] == ptrs


def test_merge_ema_contracts():
    t, gidx, rgb, (A, lu, inited) = _inputs(4)
    args = [torch.from_numpy(v) for v in (t, gidx, rgb)]
    state = [torch.from_numpy(v) for v in (A, lu, inited)]
    ids = torch.from_numpy(IDS)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        staged.cuda_merge_ema(*args, 2, ids, *state, 8, LAM, True)
    with pytest.raises(ValueError, match="None only at M = 1"):
        staged.plain_merge_ema(None, None, args[2], 1, ids, *state, 8, LAM, True)
    with pytest.raises(ValueError, match="k=5"):
        staged.plain_merge_ema(*args, 5, ids, *state, 8, LAM, True)
    with pytest.raises(ValueError, match="frame ids"):
        staged.plain_merge_ema(*args, 2, ids.long(), *state, 8, LAM, True)
    with pytest.raises(ValueError, match="period=0"):
        staged.plain_merge_ema(*args, 2, ids, *state, 0, LAM, True)
    # An empty batch passes the state through.
    st = tn.AtmoState(*state)
    a_seq, new = tops.merge_ema(None, None, torch.zeros(L, 0, 1, 3), 1,
                                ids[:, :0], st, 8, LAM, mode="pallas")
    assert a_seq.shape == (L, 0, 3)
    assert all(torch.equal(getattr(new, f), getattr(st, f))
               for f in ("A", "last_update", "initialized"))


# --- which kernels each step launches --------------------------------------

class _Mesh:
    """A stand-in ("data", "model", "width") mesh of the given sizes; the
    collectives are replaced by :func:`_fake_collectives`."""
    mesh_dim_names = ("data", "model", "width")
    device_type = "cpu"

    def __init__(self, *shape):
        self.shape = shape

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


def _fake_collectives(monkeypatch):
    """Every all-gather returns two copies of the rank's block (a two-rank
    axis); the height halo exchange pads the plane with zero rows, all
    valid."""
    monkeypatch.setattr(pipeline, "_all_gather",
                        lambda x, group: torch.cat([x.contiguous()] * 2))

    def exchange(p, halo, mesh, axis):
        shape = (p.shape[0], p.shape[1] + 2 * halo) + tuple(p.shape[2:])
        return (p.new_zeros(shape),
                torch.ones(shape[1], dtype=torch.bool, device=p.device))
    monkeypatch.setattr(spatial, "halo_exchange_height", exchange)


def _step_launches(device, monkeypatch):
    """The launch counts of a staged lane step, a staged spatial step (2
    height shards, top-2) and a staged frame-sharded step, each run once on
    ``device`` tensors."""
    _fake_collectives(monkeypatch)
    cfg = DehazeConfig(kernel_mode="pallas", patch_radius=1, gf_radius=2,
                       update_period=2, lam=LAM)
    h, w = 8, 12

    def frames(*lead):
        return torch.rand(lead + (h, w, 3)).to(device)

    def ids(*shape):
        return torch.arange(int(np.prod(shape)), dtype=torch.int32
                            ).reshape(shape).to(device)
    counts = {}
    lane_step = pipeline._make_local_step(cfg, PlacementSpec.lane_batched(),
                                          True, None)
    staged.reset_launches()
    lane_step(frames(3, 2), ids(3, 2), tn.init_atmo_state_lanes(3, device))
    counts["lanes"] = dict(staged.launches)
    for name, mesh, placement, k in (
            ("spatial", _Mesh(2, 2, 1),
             PlacementSpec.frame_sharded(("data",), "model", None), 2),
            ("frame_sharded", _Mesh(2, 1, 1),
             PlacementSpec.frame_sharded(("data",), None, None), 1)):
        step = pipeline._make_sharded_step(
            dataclasses.replace(cfg, topk=k), mesh, placement)
        staged.reset_launches()
        step(frames(4), ids(4), tn.init_atmo_state(device))
        counts[name] = dict(staged.launches)
    return counts


def test_each_step_launches_one_merge_ema_and_no_merge(monkeypatch):
    """Off the CPU (meta tensors, a fake kernel library) the staged lane
    step, a spatial step and the frame-sharded step each launch
    ``st_merge_ema`` once and ``st_merge_topk`` never, besides their
    filters."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append(name) or 0

    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(staged, "_lib", lambda: Lib())
    monkeypatch.setattr(staged, "_check_cuda", lambda *t: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    counts = _step_launches("meta", monkeypatch)
    filters = {"masked_min_filter": 1, "masked_box_filter": 6}
    want = {"lanes": {"dark_channel": 1, "box_filter": 6, "atmolight": 1,
                      "recover": 1},
            "spatial": filters, "frame_sharded": filters}
    for name, n in want.items():
        assert {k: v for k, v in counts[name].items() if v} == dict(
            n, merge_ema=1), name
    assert calls.count("st_merge_ema") == 3 and "st_merge_topk" not in calls


def test_cpu_steps_launch_nothing(monkeypatch):
    counts = _step_launches("cpu", monkeypatch)
    assert not any(n for c in counts.values() for n in c.values())


@pytest.mark.cuda
def test_merge_ema_kernel_matches_plain_version():
    """On the card the kernel equals its plain version bit for bit, both
    forms, M in {1, 4, 16}, the new state also written in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for m, k in MK:
        t, gidx, rgb, state = _inputs(m)
        lists = (None, None) if m == 1 else (torch.from_numpy(t).cuda(),
                                             torch.from_numpy(gidx).cuda())
        args = (*lists, torch.from_numpy(rgb).cuda(), k,
                torch.from_numpy(IDS).cuda(),
                *(torch.from_numpy(v.copy()).cuda() for v in state))
        for period in (1, 8):
            for associative in (True, False):
                got = staged.cuda_merge_ema(*args, period, LAM, associative)
                torch.cuda.synchronize()
                want = staged.plain_merge_ema(*args, period, LAM, associative)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (m, k, period, associative)
                out = tuple(v.clone() for v in args[-3:])
                got = staged.cuda_merge_ema(*args[:-3], *out, period, LAM,
                                            associative, out=out)
                torch.cuda.synchronize()
                for g, w in zip(got[1:], want[1:]):
                    assert torch.equal(g, w)
