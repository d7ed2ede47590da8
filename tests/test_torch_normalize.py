"""PyTorch port, §3.3 EMA normalization: ``repro_torch.core.normalize``
against ``repro.core.normalize`` on gaps, padding, empty batches and
consecutive ids, plus the lane-carry layout."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import normalize as jn
from repro_torch.core import normalize as tn

from _torch_common import as_np

torch.set_num_threads(1)

ID_CASES = {
    "consecutive": [10, 11, 12, 13, 14, 15, 16],
    "gaps": [3, 4, 9, 10, 30, 31, 32],
    "padding_tail": [5, 6, 7, -1, -1, -1, -1],
    "padding_head": [-1, -1, 0, 1, 2, 3, 4],
    "all_padding": [-1] * 7,
    "empty": [],
}


def _states(warm):
    if warm:
        A = np.asarray([0.8, 0.85, 0.9], np.float32)
        return (jn.AtmoState(A=jnp.asarray(A), last_update=jnp.asarray(2, jnp.int32),
                             initialized=jnp.asarray(True)),
                tn.AtmoState(A=torch.from_numpy(A),
                             last_update=torch.tensor(2, dtype=torch.int32),
                             initialized=torch.tensor(True)))
    return jn.init_atmo_state(), tn.init_atmo_state()


def _check(got, want):
    (ga, gs), (wa, ws) = got, want
    np.testing.assert_allclose(as_np(ga), as_np(wa), atol=1e-6, rtol=0)
    np.testing.assert_allclose(as_np(gs.A), as_np(ws.A), atol=1e-6, rtol=0)
    assert int(gs.last_update) == int(ws.last_update)
    assert bool(gs.initialized) == bool(ws.initialized)


@pytest.mark.parametrize("case", sorted(ID_CASES))
@pytest.mark.parametrize("warm", [False, True])
def test_ema_scan_matches(case, warm):
    ids = np.asarray(ID_CASES[case], np.int32)
    cand = np.random.default_rng(len(ids)).random((len(ids), 3)).astype(np.float32)
    js, ts = _states(warm)
    want = jn.ema_scan(jnp.asarray(cand), jnp.asarray(ids), js, 3, 0.3)
    got = tn.ema_scan(torch.from_numpy(cand), torch.from_numpy(ids), ts, 3, 0.3)
    _check(got, want)
    if case == "empty" or case == "all_padding":
        # The state passes through untouched (initialized included).
        assert bool(got[1].initialized) == warm
        np.testing.assert_array_equal(as_np(got[1].A), as_np(ts.A))


@pytest.mark.parametrize("case", ["consecutive", "padding_tail",
                                  "padding_head", "all_padding", "empty"])
@pytest.mark.parametrize("warm", [False, True])
def test_ema_scan_associative_matches(case, warm):
    ids = np.asarray(ID_CASES[case], np.int32)
    cand = np.random.default_rng(7).random((len(ids), 3)).astype(np.float32)
    js, ts = _states(warm)
    want = jn.ema_scan_associative(jnp.asarray(cand), jnp.asarray(ids), js,
                                   2, 0.05)
    got = tn.ema_scan_associative(torch.from_numpy(cand),
                                  torch.from_numpy(ids), ts, 2, 0.05)
    _check(got, want)
    # On consecutive ids the (c, d) form agrees with the sequential scan.
    _check(got, tn.ema_scan(torch.from_numpy(cand), torch.from_numpy(ids),
                            ts, 2, 0.05))


def test_bootstrap_sentinel_is_int32():
    s = tn.init_atmo_state()
    assert s.last_update.dtype == torch.int32
    assert int(s.last_update) == int(jn.init_atmo_state().last_update) \
        == -(2 ** 30)
    assert s.initialized.dtype == torch.bool and not bool(s.initialized)


def test_lane_carry_roundtrip_and_lanes():
    states = [tn.AtmoState(A=torch.tensor([0.1 * i, 0.2, 0.3]),
                           last_update=torch.tensor(i, dtype=torch.int32),
                           initialized=torch.tensor(i % 2 == 0))
              for i in range(3)]
    packed = tn.pack_atmo_states(states)
    cf, ci = tn.lane_carry(packed)
    assert cf.dtype == torch.float32 and ci.dtype == torch.int32
    assert tuple(cf.shape) == (3, 3) and tuple(ci.shape) == (3, 2)
    back = tn.unpack_atmo_states(tn.state_from_lane_carry(cf, ci))
    for s, b in zip(states, back):
        assert torch.equal(s.A, b.A)
        assert int(s.last_update) == int(b.last_update)
        assert bool(s.initialized) == bool(b.initialized)
    # The same layout as the reference's carry rows.
    jcf, jci = jn.lane_carry(jn.pack_atmo_states(
        [jn.AtmoState(A=jnp.asarray(as_np(s.A)),
                      last_update=jnp.asarray(int(s.last_update), jnp.int32),
                      initialized=jnp.asarray(bool(s.initialized)))
         for s in states]))
    np.testing.assert_array_equal(as_np(cf), as_np(jcf))
    np.testing.assert_array_equal(as_np(ci), as_np(jci))
    # set_lane_state replaces one lane and leaves its input alone.
    new = tn.set_lane_state(packed, 1, tn.init_atmo_state())
    assert not bool(new.initialized[1]) and int(packed.last_update[1]) == 1


def test_ema_scan_lanes_padding_lane_untouched():
    cand = np.random.default_rng(3).random((3, 4, 3)).astype(np.float32)
    ids = np.tile(np.arange(4, dtype=np.int32), (3, 1))
    ids[1] = -1
    want_seq, want = jn.ema_scan_lanes(jnp.asarray(cand), jnp.asarray(ids),
                                       jn.init_atmo_state_lanes(3), 2, 0.3)
    packed = tn.init_atmo_state_lanes(3)
    got_seq, got = tn.ema_scan_lanes(torch.from_numpy(cand),
                                     torch.from_numpy(ids), packed, 2, 0.3)
    np.testing.assert_allclose(as_np(got_seq), as_np(want_seq), atol=1e-6)
    np.testing.assert_allclose(as_np(got.A), as_np(want.A), atol=1e-6)
    np.testing.assert_array_equal(as_np(got.last_update),
                                  as_np(want.last_update))
    assert torch.equal(got.A[1], packed.A[1]) and not bool(got.initialized[1])


@pytest.mark.parametrize("associative", [True, False])
def test_ema_scan_lanes_is_each_lanes_own_scan(associative):
    """All lanes in one set of tensor operations equal each lane scanned
    alone, bit for bit, and the reference's vmapped scan: a cold lane, a
    warm lane, a lane with a padding head, an all-padding lane."""
    rng = np.random.default_rng(4)
    cand = rng.random((4, 5, 3)).astype(np.float32)
    ids = np.stack([np.arange(5), np.arange(7, 12), [-1, -1, 3, 4, 5],
                    [-1] * 5]).astype(np.int32)
    states = [tn.init_atmo_state(), _states(True)[1], _states(True)[1],
              tn.init_atmo_state()]
    packed = tn.pack_atmo_states(states)
    got_seq, got = tn.ema_scan_lanes(torch.from_numpy(cand),
                                     torch.from_numpy(ids), packed, 2, 0.3,
                                     associative=associative)
    scan = tn.ema_scan_associative if associative else tn.ema_scan
    for lane, st in enumerate(states):
        seq, one = scan(torch.from_numpy(cand[lane]),
                        torch.from_numpy(ids[lane]), st, 2, 0.3)
        assert torch.equal(got_seq[lane], seq)
        assert torch.equal(got.A[lane], one.A)
        assert int(got.last_update[lane]) == int(one.last_update)
        assert bool(got.initialized[lane]) == bool(one.initialized)
    jpacked = jn.pack_atmo_states([_states(False)[0], _states(True)[0],
                                   _states(True)[0], _states(False)[0]])
    want_seq, want = jn.ema_scan_lanes(jnp.asarray(cand), jnp.asarray(ids),
                                       jpacked, 2, 0.3,
                                       associative=associative)
    np.testing.assert_allclose(as_np(got_seq), as_np(want_seq), atol=1e-6)
    np.testing.assert_array_equal(as_np(got.last_update),
                                  as_np(want.last_update))
