"""PyTorch port, the kernel tuning registry: ``repro_torch.kernels.tuning``
against the JAX package's ``repro.kernels.tuning`` on the same inputs, and
the port's own knobs on the CPU.

The search (successive halving and the exhaustive sweep) runs on one
deterministic fake timer and fake builds in both packages: the same
winner, timed runs, exhaustive runs and rungs. The table layout
(``migrate_table``, ``validate_table``), the layered ``get_params``, the
bucket keys and the env helpers give the reference's answers on the same
tables and variables. The port's own additions: a winner that is not the
default persists only where it beats the default in turns by more than
their spread; a step resolves its knobs once a shape; a serve's cached
step follows the table's state; ``--tune`` fails on a variant that fits
but does not run. The knobs themselves (the megakernel's tile,
B6a/B6b's tile) leave the plain passes' outputs bit-equal to the
default's and within 2e-4 of the JAX fused step in interpret mode; a knob
or value an op does not take raises. Every table and env variable lives
in ``tmp_path`` and ``monkeypatch``: nothing here opens ``results/``.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import env as jenv
from repro.kernels import ops as jops
from repro.kernels import tuning as jtuning
from repro_torch.core import env as tenv
from repro_torch.kernels import fused, staged
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tuning
from repro_torch.launch import serve

from _torch_common import as_np, ramp_frames

torch.set_num_threads(1)

PACKAGES = {"torch": tuning, "jax": jtuning}


@pytest.fixture()
def tables(tmp_path, monkeypatch):
    """Both packages' table paths in ``tmp_path``, both device kinds
    ``kindA``; returns ``{"torch": path, "jax": path}``."""
    paths = {"torch": tmp_path / "torch.json", "jax": tmp_path / "jax.json"}
    monkeypatch.setenv("REPRO_TORCH_KERNEL_TUNING", str(paths["torch"]))
    monkeypatch.setenv("REPRO_KERNEL_TUNING", str(paths["jax"]))
    monkeypatch.setenv("REPRO_TUNE_DEVICE_KIND", "kindA")
    monkeypatch.delenv("REPRO_TUNE_REQUIRE_TABLE", raising=False)
    return paths


def _write_both(paths, table):
    for p in paths.values():
        p.write_text(json.dumps(table))


class FakeBench:
    """Deterministic virtual time: candidate ``x`` costs ``costs[x]`` a run
    and the timer reads the virtual clock (the reference's fake bench)."""

    def __init__(self, costs, fail=()):
        self.costs, self.fail, self.clock = costs, set(fail), 0.0

    def timer(self):
        return self.clock

    def build(self, params):
        x = params["x"]
        if x in self.fail:
            raise ValueError(f"candidate {x} cannot build")

        def run():
            self.clock += self.costs[x]
        return run


def _candidates(n):
    return [{"x": i} for i in range(n)]


def _search(pkg, method, costs, n, iters, fail=()):
    mod = PACKAGES[pkg]
    fb = FakeBench(costs, fail)
    stats = mod.TuneStats()
    fn = mod.measured_search if method == "search" else mod.autotune
    best = fn("fused_dcp", (2, 8, 8), _candidates(n), fb.build, iters=iters,
              persist=False, timer=fb.timer, stats=stats)
    return best, (stats.timed_runs, stats.exhaustive_runs, stats.rounds,
                  stats.builds, stats.considered)


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,iters", [(9, 3), (12, 3), (2, 3), (3, 2),
                                     (18, 2), (7, 5)])
def test_search_and_sweep_match_reference(tables, n, iters):
    costs = {i: 10.0 + ((i * 7) % n) for i in range(n)}      # distinct ranks
    for method in ("search", "exhaustive"):
        got = _search("torch", method, costs, n, iters)
        want = _search("jax", method, costs, n, iters)
        assert got == want, method
    se, ex = (_search("torch", m, costs, n, iters) for m in ("search", "exhaustive"))
    assert se[0] == ex[0]
    assert se[1][0] < ex[1][0] == n * iters == se[1][1]


def test_search_tie_break_and_bad_arguments(tables):
    costs = {0: 5.0, 1: 1.0, 2: 3.0, 3: 1.0}                  # 1 and 3 tie
    for pkg in PACKAGES:
        for method in ("search", "exhaustive"):
            assert _search(pkg, method, costs, 4, 3)[0] == {"x": 1}
        fb = FakeBench({0: 1.0})
        for bad in (dict(iters=0), dict(start_iters=0), dict(eta=1)):
            with pytest.raises(ValueError):
                PACKAGES[pkg].measured_search("fused_dcp", (2, 8, 8),
                                              _candidates(1), fb.build,
                                              timer=fb.timer, **bad)


@pytest.mark.parametrize("method", ["search", "exhaustive"])
def test_all_fail_raises_and_writes_nothing(tables, method):
    for pkg, mod in PACKAGES.items():
        fb = FakeBench({}, fail=(0, 1, 2))
        stats = mod.TuneStats()
        fn = mod.measured_search if method == "search" else mod.autotune
        with pytest.raises(mod.AutotuneError, match="all 3 candidates"):
            fn("fused_dcp", (2, 8, 8), _candidates(3), fb.build,
               timer=fb.timer, stats=stats)
        assert stats.skipped == {"ValueError": 3}
        assert not tables[pkg].exists()


def test_persisted_winner_and_provenance_match_reference(tables):
    """One skipped candidate; the entry under the device kind, its params
    and provenance (but the time of measurement) the reference's."""
    entries = {}
    for pkg, mod in PACKAGES.items():
        fb = FakeBench({0: 3.0, 1: 1.0, 2: 2.0}, fail=(2,))
        assert mod.measured_search("fused_dcp", (2, 8, 8), _candidates(3),
                                   fb.build, timer=fb.timer) == {"x": 1}
        raw = json.loads(tables[pkg].read_text())
        assert raw["schema"] == mod.SCHEMA_VERSION == 2
        entry = raw["device_kinds"]["kindA"]["fused_dcp"]["2x8x8"]
        del entry["provenance"]["measured_at"]
        entries[pkg] = entry
    assert entries["torch"] == entries["jax"]
    assert entries["torch"]["provenance"]["skipped"] == {"ValueError": 1}


class KnobBench:
    """Virtual time over the real fused candidates: a run of ``(tile,
    blocks_per_sm)`` costs ``costs[...]`` plus the next of ``jitter`` (a
    cycle), read by the fake timer."""

    def __init__(self, costs, jitter=(0.0,)):
        self.costs, self.jitter, self.clock, self.runs = costs, jitter, 0.0, 0

    def timer(self):
        return self.clock

    def build(self, params):
        cost = self.costs[params["tile"], params["blocks_per_sm"]]

        def run():
            self.clock += cost + self.jitter[self.runs % len(self.jitter)]
            self.runs += 1
        return run


_NOISE = (0.5, -0.4, 0.3, -0.5, 0.1, 0.4, -0.3)


@pytest.mark.parametrize("method", ["search", "exhaustive"])
@pytest.mark.parametrize("case", ["within_noise", "clear_gain", "quiet_gain"])
def test_winner_is_held_against_the_default_in_turns(tables, method, case):
    """With ``confirm`` rounds, a winner that is not the default persists
    only where it beats the default in turns by more than their spread;
    else the default does. Either way the turns go into the provenance and
    into ``confirm_runs``, apart from the search's own timed runs."""
    gain, jitter = {"within_noise": (0.2, _NOISE), "clear_gain": (5.0, _NOISE),
                    "quiet_gain": (0.1, (0.0,))}[case]
    costs = {(t, b): 10.0 - (gain if (t, b) == ("64x32", 3) else 0.0)
             for t in fused.TILES for b in fused.BLOCKS_PER_SM}
    costs["32x64", 2] = costs["64x32", 2] = 12.0
    fb = KnobBench(costs, jitter)
    stats = tuning.TuneStats()
    fn = tuning.measured_search if method == "search" else tuning.autotune
    best = fn("fused_dcp", (2, 8, 8), tuning.fused_candidates(), fb.build,
              iters=3, dtype=torch.uint8, timer=fb.timer, stats=stats,
              confirm=2, device="cpu")
    want = (tuning.DEFAULTS["fused_dcp"] if case == "within_noise"
            else {"tile": "64x32", "blocks_per_sm": 3})
    assert best == want
    entry = json.loads(tables["torch"].read_text())["device_kinds"]["kindA"][
        "fused_dcp"]["2x8x8xu8"]
    assert entry["params"] == want
    verdict = entry["provenance"]["against_default"]
    assert verdict["rounds"] == 2 and verdict["faster"] == (want != tuning.DEFAULTS["fused_dcp"])
    assert verdict["candidate"] == {"tile": "64x32", "blocks_per_sm": 3}
    assert stats.confirm_runs == 4 * 2 * 3
    assert tuning.validate_table() == []
    # The default winning outright needs no turns.
    costs["64x32", 3] = 11.0
    stats = tuning.TuneStats()
    assert fn("fused_dcp", (2, 8, 8), tuning.fused_candidates(), fb.build,
              iters=3, persist=False, timer=fb.timer, stats=stats,
              confirm=2) == tuning.DEFAULTS["fused_dcp"]
    assert stats.confirm_runs == 0


@pytest.mark.parametrize("shape,dtype,key", [
    ((8, 480, 640), torch.uint8, "8x480x640xu8"),
    ((4, 8, 480, 640), "bfloat16", "4x8x480x640xbf16"),
    ((32, 480, 640), None, "32x480x640"),
    ((2, 8, 8), torch.float32, "2x8x8")])
def test_bucket_keys_parse_back(shape, dtype, key):
    assert tuning.shape_bucket(shape, dtype) == key
    got_shape, io_dtype = tuning.parse_bucket(key)
    assert got_shape == shape
    assert tuning.shape_bucket(got_shape, io_dtype) == key


@pytest.mark.parametrize("op,bucket,params", [
    ("fused_dcp", "2x8x8xu8", {"tile": "64x32"}),
    ("fused_lanes", "2x2x8x8xu8", {"grid_order": "frame_major"}),
    ("atmolight_topk", "2x8x8", {"tile_pixels": 2048})])
def test_against_default_times_an_entry_in_turns(tables, op, bucket, params):
    v = tuning.against_default(op, bucket, params, device="cpu", rounds=2,
                               iters=1)
    assert v["rounds"] == 2 and v["spread_us"] >= 0
    assert set(v) >= {"default_us", "candidate_us", "faster", "slower"}
    with pytest.raises(ValueError, match="not a knob"):
        tuning.against_default(op, bucket, {"frames_per_block": 2},
                               device="cpu")


@pytest.mark.parametrize("kernel_mode,op", [("fused", "fused_dcp"),
                                            ("pallas", "atmolight")])
def test_a_step_resolves_its_knobs_once_a_shape(tables, monkeypatch,
                                                kernel_mode, op):
    """A step looks its knobs up at its first call at a shape and then
    reads them from its own memo; a serve's cached step is keyed by the
    tuning state, so a saved table gets a new step."""
    from repro_torch.core import DehazeConfig, init_atmo_state, make_dehaze_step
    from repro_torch.stream import elastic
    monkeypatch.setenv("REPRO_TUNE_DEVICE_KIND", "cpu")
    cfg = DehazeConfig(kernel_mode=kernel_mode, io_dtype="uint8")
    step = make_dehaze_step(cfg, device="cpu")
    frames = torch.from_numpy(
        (ramp_frames(3, 2, h=16, w=24) * 255).astype(np.uint8))
    ids = torch.arange(2, dtype=torch.int32)
    lookups = tuning.lookups
    state = init_atmo_state()
    for _ in range(3):
        state = step(frames, ids, state).state
    assert tuning.lookups - lookups == 1
    step(frames[:1], ids[:1], state)                    # a new shape
    assert tuning.lookups - lookups == 2
    token = tuning.state_token()
    first = elastic._cached_step(cfg, torch.device("cpu"))
    assert elastic._cached_step(cfg, torch.device("cpu")) is first
    tuning.save_table({"schema": 2, "device_kinds": {"cpu": {op: {
        "2x16x24" + ("xu8" if op == "fused_dcp" else ""): {
            "params": dict(tuning.DEFAULTS[op]), "provenance": _PROV}}}},
        "legacy": {}})
    assert tuning.state_token() != token
    assert elastic._cached_step(cfg, torch.device("cpu")) is not first
    monkeypatch.setenv(f"REPRO_TUNE_{op.upper()}", "{}")
    assert tuning.state_token() != token


# ---------------------------------------------------------------------------
# Table layout and lookup
# ---------------------------------------------------------------------------

_PROV = {"time_us": 1.0, "iters": 3, "considered": 4, "skipped": {},
         "method": "successive_halving"}
_TABLES = [
    {},
    {"fused_dcp": {"2x8x8": {"tile": "64x32"}}},                     # v1
    {"schema": 1, "fused_lanes": {"2x2x8x8": {"grid_order": "frame_major"}}},
    {"schema": 2, "device_kinds": {"kindA": {"fused_dcp": {
        "2x8x8": {"params": {"tile": "64x32"}, "provenance": _PROV}}}},
     "legacy": {}},
    {"schema": 2, "device_kinds": {"kindA": {
        "nope": {"2x8x8": {"params": {}, "provenance": _PROV}},
        "fused_dcp": {"2x8y8": {"params": {"tile": "64x32"},
                                "provenance": {"iters": 3}},
                      "4x8x8": {"params": 5},
                      "8x8x8": {"params": {}}}}},
     "legacy": {"bogus": {"1x1": 3}}},
    {"schema": 2, "device_kinds": {}},
    {"schema": 3, "device_kinds": {"kindA": {}}},
]


@pytest.mark.parametrize("i", range(len(_TABLES)))
def test_migrate_and_validate_match_reference(i):
    table = _TABLES[i]
    assert tuning.migrate_table(json.loads(json.dumps(table))) \
        == jtuning.migrate_table(json.loads(json.dumps(table)))
    # The same errors; a schema error names each package's own CLI.
    got = [e.replace("repro_torch.kernels", "repro.kernels")
           for e in tuning.validate_table(table)]
    assert got == jtuning.validate_table(table)


def test_validate_flags_knobs_the_kernels_do_not_take():
    table = {"schema": 2, "device_kinds": {"kindA": {"fused_dcp": {"2x8x8": {
        "params": {"frames_per_block": 4}, "provenance": _PROV}},
        "atmolight": {"2x8x8": {"params": {"tile_pixels": 1000},
                                "provenance": _PROV}}}}, "legacy": {}}
    assert jtuning.validate_table(table) == []        # the TPU's knob
    errors = tuning.validate_table(table)
    assert len(errors) == 2
    assert "'frames_per_block' is not a knob" in errors[0]
    assert "tile_pixels=1000" in errors[1]


def _layers(op, shape, t_dtype, j_dtype, keys):
    """Both packages' params at one lookup, equal on ``keys`` (those the
    table and the override set); returns the port's."""
    got = tuning.get_params(op, shape, t_dtype)
    want = jtuning.get_params(op, shape, j_dtype)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    return got


def test_get_params_layering_matches_reference(tables, monkeypatch):
    """Device kind over legacy, legacy filling unset keys, another kind
    falling back to legacy, the dtype-tagged bucket over the untagged one,
    the env override over every layer."""
    _write_both(tables, {
        "schema": 2,
        "device_kinds": {
            "kindA": {"fused_lanes": {
                "2x2x8x8": {"params": {"tile": "64x32"}, "provenance": {}},
                "2x2x8x8xu8": {"params": {"blocks_per_sm": 2},
                               "provenance": {}}}},
            "kindB": {"fused_lanes": {"2x2x8x8": {
                "params": {"tile": "32x64"}, "provenance": {}}}}},
        "legacy": {"fused_lanes": {"2x2x8x8": {"tile": "32x64",
                                               "grid_order": "frame_major"}}}})
    keys = ("tile", "grid_order")
    args = ("fused_lanes", (2, 2, 8, 8))
    p = _layers(*args, torch.float32, jnp.float32, keys)
    assert (p["tile"], p["grid_order"], p["blocks_per_sm"]) \
        == ("64x32", "frame_major", 3)
    p = _layers(*args, torch.uint8, jnp.uint8, keys + ("blocks_per_sm",))
    assert p["blocks_per_sm"] == 2
    monkeypatch.setenv("REPRO_TUNE_DEVICE_KIND", "kindC")
    assert _layers(*args, None, None, keys)["tile"] == "32x64"
    monkeypatch.setenv("REPRO_TUNE_FUSED_LANES", '{"tile": "64x32"}')
    assert _layers(*args, None, None, keys)["tile"] == "64x32"
    monkeypatch.setenv("REPRO_TUNE_FUSED_LANES", "{not json")   # ignored
    assert _layers(*args, None, None, keys)["tile"] == "32x64"


def test_require_table_matches_reference(tables, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_REQUIRE_TABLE", "1")
    for mod in PACKAGES.values():
        with pytest.raises(mod.AutotuneError, match="REPRO_TUNE_REQUIRE_TABLE"):
            mod.get_params("fused_dcp", (2, 8, 8))
    _write_both(tables, {"schema": 2, "device_kinds": {"kindA": {"fused_dcp": {
        "2x8x8xu8": {"params": {"tile": "64x32"}, "provenance": {}}}}},
        "legacy": {}})
    assert tuning.get_params("fused_dcp", (2, 8, 8), torch.uint8)["tile"] \
        == jtuning.get_params("fused_dcp", (2, 8, 8), jnp.uint8)["tile"]
    for mod in PACKAGES.values():                  # the f32 bucket: none
        with pytest.raises(mod.AutotuneError):
            mod.get_params("fused_dcp", (2, 8, 8))
    monkeypatch.setenv("REPRO_TUNE_FUSED_DCP", '{"blocks_per_sm": 2}')
    assert tuning.get_params("fused_dcp", (2, 8, 8))["blocks_per_sm"] \
        == jtuning.get_params("fused_dcp", (2, 8, 8))["blocks_per_sm"] == 2


@pytest.mark.parametrize("shape", [(2, 8, 8), (4, 2, 48, 64), (32, 480, 640)])
def test_shape_bucket_matches_reference(shape):
    pairs = [(None, None), (torch.float32, np.float32), (torch.uint8, np.uint8),
             (torch.bfloat16, jnp.bfloat16), (torch.int32, np.int32)]
    for t_dt, j_dt in pairs:
        assert tuning.shape_bucket(shape, t_dt) \
            == jtuning.shape_bucket(shape, j_dt)
    assert tuning.shape_bucket(shape, np.uint8) == tuning.shape_bucket(
        shape, "uint8") == "x".join(map(str, shape)) + "xu8"


def test_env_helpers_match_reference(monkeypatch, tmp_path):
    for value in (None, '{"tile": "64x32"}', "{bad", "[1, 2]", "3"):
        if value is None:
            monkeypatch.delenv("REPRO_TUNE_FUSED_DCP", raising=False)
        else:
            monkeypatch.setenv("REPRO_TUNE_FUSED_DCP", value)
        assert tenv.tune_override("fused_dcp") == jenv.tune_override("fused_dcp")
    for value in ("", "TPU v5e", "NVIDIA H100 80GB HBM3"):
        monkeypatch.setenv("REPRO_TUNE_DEVICE_KIND", value)
        assert tenv.tune_device_kind() == jenv.tune_device_kind()
    for value in ("", "0", "1"):
        monkeypatch.setenv("REPRO_TUNE_REQUIRE_TABLE", value)
        assert tenv.tune_require_table() == jenv.tune_require_table()
    monkeypatch.setenv("REPRO_TUNE_REQUIRE_TABLE", "yes")
    for env in (tenv, jenv):
        with pytest.raises(ValueError, match="REPRO_TUNE_REQUIRE_TABLE"):
            env.tune_require_table()
    for value in ("", "1"):
        monkeypatch.setenv("REPRO_BENCH_SMOKE", value)
        assert tenv.bench_smoke() == jenv.bench_smoke()
    # The port's table path is its own: the JAX package's variable does not
    # move it.
    monkeypatch.delenv("REPRO_TORCH_KERNEL_TUNING", raising=False)
    monkeypatch.setenv("REPRO_KERNEL_TUNING", str(tmp_path / "jax.json"))
    assert str(tenv.tuning_table_path()) == "results/kernel_tuning_torch.json"
    monkeypatch.setenv("REPRO_TORCH_KERNEL_TUNING", str(tmp_path / "t.json"))
    assert tenv.tuning_table_path() == tmp_path / "t.json"
    # snapshot / restore: both packages' semantics.
    monkeypatch.setenv("REPRO_TUNE_FUSED_CAP", "{}")
    snaps = (tenv.snapshot(), jenv.snapshot())
    assert snaps[0] == snaps[1]
    monkeypatch.setenv("REPRO_TUNE_ATMOLIGHT", "{}")
    monkeypatch.setenv("REPRO_TUNE_FUSED_CAP", "[]")
    tenv.restore(snaps[0])
    assert tenv.snapshot() == snaps[0] == jenv.snapshot()


# ---------------------------------------------------------------------------
# Resolution in the dispatch layer
# ---------------------------------------------------------------------------

def _cpu_fused_call(**knobs):
    x = torch.from_numpy(ramp_frames(3, 2, h=8, w=8))
    return tops.fused_dehaze(
        x, torch.arange(2, dtype=torch.int32), torch.ones(3),
        torch.tensor(-(2 ** 30), dtype=torch.int32), torch.tensor(False),
        mode="fused", radius=1, refine=True, gf_radius=1, gf_eps=1e-3, t0=0.1,
        gamma=1.0, period=2, lam=0.1, **knobs)


def test_bad_table_entries_and_overrides_raise(tables, monkeypatch):
    """A foreign knob in a table entry (the TPU's ``frames_per_block``), a
    value a kernel does not take and a bad override each raise
    ``ValueError`` naming it where the op resolves its knobs; nothing
    falls back to the defaults."""
    monkeypatch.setenv("REPRO_TUNE_DEVICE_KIND", "cpu")
    tuning.save_table({"schema": 2, "device_kinds": {"cpu": {
        "fused_dcp": {"2x8x8": {"params": {"frames_per_block": 4},
                                "provenance": _PROV}},
        "atmolight": {"2x8x8": {"params": {"tile_pixels": 1000},
                                "provenance": _PROV}}}}, "legacy": {}})
    with pytest.raises(ValueError, match="'frames_per_block' is not a knob"):
        _cpu_fused_call()
    with pytest.raises(ValueError, match="tile_pixels=1000"):
        tops.atmospheric_light(torch.rand(2, 8, 8, 3), torch.rand(2, 8, 8))
    tuning.save_table({"schema": 2, "device_kinds": {}, "legacy": {}})
    _cpu_fused_call()
    for value in ('{"tile": "16x16"}', '{"blocks_per_sm": "2"}',
                  '{"grid_order": "lane_major"}'):
        monkeypatch.setenv("REPRO_TUNE_FUSED_DCP", value)
        with pytest.raises(ValueError, match="REPRO_TUNE_FUSED_DCP"):
            _cpu_fused_call()
    monkeypatch.delenv("REPRO_TUNE_FUSED_DCP")
    with pytest.raises(ValueError, match="tile="):
        _cpu_fused_call(tile="48x48")


def test_resolution_reads_the_table_once_a_bucket(tables, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_DEVICE_KIND", "cpu")
    tuning.save_table({"schema": 2, "device_kinds": {"cpu": {"fused_dcp": {
        "2x8x8": {"params": {"tile": "64x32", "blocks_per_sm": 2},
                  "provenance": _PROV}}}}, "legacy": {}})
    tables["torch"].write_text(tables["torch"].read_text())   # a new mtime
    reads, lookups = tuning.table_reads, tuning.lookups
    for _ in range(3):
        p = tuning.resolve("fused_dcp", (2, 8, 8), torch.float32, "cpu")
        _cpu_fused_call()
    assert p == {"tile": "64x32", "blocks_per_sm": 2}
    assert tuning.lookups - lookups == 1
    assert tuning.table_reads - reads <= 1
    monkeypatch.setenv("REPRO_TUNE_FUSED_DCP", '{"tile": "32x64"}')
    assert tuning.resolve("fused_dcp", (2, 8, 8), torch.float32, "cpu")["tile"] \
        == "32x64"
    assert tuning.lookups - lookups == 2


# ---------------------------------------------------------------------------
# The knobs on the CPU
# ---------------------------------------------------------------------------

KW = dict(radius=2, omega=0.95, beta=1.0, gf_radius=3, gf_eps=1e-3, t0=0.1,
          gamma=1.0, period=2, lam=0.3)


def _lane_inputs():
    x = ramp_frames(21, 2, 2, h=40, w=70)       # 2 x 2 tiles of 32 x 64, 1 x 3 of 64 x 32
    ids = np.asarray([[0, 1], [-1, -1]], np.int32)
    cf = np.ones((2, 3), np.float32)
    ci = np.tile(np.asarray([-(2 ** 30), 0], np.int32), (2, 1))
    return x, ids, cf, ci


_JAX_STEP = {}


def _jax_interpret_step(algorithm):
    if algorithm not in _JAX_STEP:
        x, ids, cf, ci = _lane_inputs()
        _JAX_STEP[algorithm] = jops.fused_dehaze_lanes(
            jnp.asarray(x), jnp.asarray(ids), jnp.asarray(cf), jnp.asarray(ci),
            mode="interpret", algorithm=algorithm, topk=1, refine=True, **KW)
    return _JAX_STEP[algorithm]


@pytest.mark.parametrize("algorithm", ["dcp", "cap"])
@pytest.mark.parametrize("tile,lane_major", [("32x64", True), ("64x32", True),
                                             ("64x32", False)])
def test_tiled_passes_at_each_tile_match_default_and_reference(
        tables, algorithm, tile, lane_major):
    """The megakernel's tiled sequence through the plain passes at each
    tile (and grid order) is bit-equal to the default tile's, and within
    2e-4 of the JAX fused step in interpret mode; its top-1 tile keys are
    the 2-D tiles' minima, and their merge picks the default's pixel, also
    on a plateau whose t ties across tiles."""
    x, ids, cf, ci = _lane_inputs()
    kw = dict(KW, algorithm=algorithm, topk=1, refine=True)
    args = tuple(torch.from_numpy(a) for a in (x, ids, cf, ci))
    s = fused.make_static(args[0], tile=tile, lane_major=lane_major, **kw)
    s0 = fused.make_static(args[0], **kw)
    got = fused.run_tiled_passes(*args, s, fused.PLAIN_PASSES)
    want = fused.run_tiled_passes(*args, s0, fused.PLAIN_PASSES)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ref = _jax_interpret_step(algorithm)
    for g, w in zip(got, ref):
        np.testing.assert_allclose(as_np(g), as_np(w), atol=2e-4, rtol=0)
    th, tw = fused.TILES[tile]
    t_raw = torch.rand(2, 40, 70)
    plateau = torch.full((2, 40, 70), 0.5)
    plateau[0, 39, 69] = plateau[1, 0, 69] = 0.25     # far corner, top row
    plateau[1, 33, 0] = 0.25
    for t in (t_raw, plateau):
        keys = fused.tile2d_keys(t, tile)
        assert keys.shape == (2, fused.tile_count(40, 70, tile)) \
            == (2, -(-40 // th) * -(-70 // tw))
        flat = staged.flip_key_order(keys)
        for yi in range(-(-40 // th)):
            for xi in range(-(-70 // tw)):
                block = t[:, yi * th:(yi + 1) * th, xi * tw:(xi + 1) * tw]
                got_t = staged.key_t(flat[:, yi * -(-70 // tw) + xi])
                assert torch.equal(got_t, block.reshape(2, -1).amin(-1))
        pick = staged.key_index(flat.amin(-1))
        assert torch.equal(pick, staged.key_index(
            staged.flip_key_order(fused.tile2d_keys(t)).amin(-1)))
        assert torch.equal(pick, t.reshape(2, -1).argmin(-1))


def test_halo_tile_keys_follow_the_tile():
    img = torch.rand(2, 20, 30, 3)
    pre = torch.rand(2, 26, 36)
    picks = []
    for tile in fused.TILES:
        s = fused.make_halo_static(img, pre, pre, radius=1, refine=True,
                                   gf_radius=1, gf_eps=1e-3, tile=tile)
        t_core = torch.rand(2, 20, 30, generator=torch.Generator().manual_seed(0))
        keys = fused.halo_tile_keys(t_core, s)
        assert keys.shape == (2, fused.tile_count(*s.region_shape("tmap_tile"), tile))
        picks.append(staged.key_index(staged.flip_key_order(keys).amin(-1)))
    assert torch.equal(picks[0], picks[1])


def _tile_emulation(t: torch.Tensor, k: int, tile_pixels: int) -> torch.Tensor:
    """B6a/B6b's launches at a tile, emulated: each run of ``tile_pixels``
    contiguous pixels to its k smallest keys (all ones past its pixels),
    then each frame's k smallest of those; their flat indices."""
    n = t.shape[0]
    keys = staged.topk_keys_signed(t)
    tiles = -(-keys.shape[1] // tile_pixels)
    padded = torch.full((n, tiles * tile_pixels), staged.KEY_LAST,
                        dtype=torch.int64)
    padded[:, :keys.shape[1]] = keys
    lists = torch.sort(padded.reshape(n, tiles, tile_pixels), -1).values[..., :k]
    best = torch.sort(lists.reshape(n, -1), -1).values[:, :k]
    return staged.key_index(best)


@pytest.mark.parametrize("k", [1, 4, 16])
def test_atmolight_tiles_pick_the_same_pixels(tables, k):
    """Every ``tile_pixels`` of B6a (k = 1) and B6b (k > 1): the emulated
    tiles pick the plain version's pixels (on a ramp and on all ties across
    a tile's edge) and the plain versions are bit-equal."""
    h, w = 70, 130                      # 9100 px: tails at 2048, 4096, 8192
    x = torch.from_numpy(ramp_frames(5, 2, h=h, w=w))
    ties = torch.full((2, h, w), 0.375)
    for t in (1.0 - 0.95 * x.amin(-1), ties):
        outs = []
        for tile in staged.TOP1_TILES:
            pick = _tile_emulation(t, k, tile)
            assert torch.equal(pick, staged.key_index(staged.topk_select(t, k)))
            outs.append(staged.plain_atmolight(x, t, tile) if k == 1
                        else staged.plain_atmolight_topk(x, t, k, tile))
            assert torch.equal(outs[-1], outs[0])
            op = tops.atmospheric_light(x, t, k, mode="pallas", tile_pixels=tile)
            assert torch.equal(op, outs[0])
    with pytest.raises(ValueError, match="tile_pixels=1000"):
        staged.plain_atmolight(x, t, 1000)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def test_tuning_cli_smoke_on_cpu(tables, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TUNE_DEVICE_KIND", "cpu")
    assert tuning.main(["--smoke", "--no-persist", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    stats = out["stats"]
    assert stats["timed_runs"] < stats["exhaustive_runs"]
    assert out["device_kind"] == "cpu"
    assert set(out) >= {"fused_dcp", "fused_lanes", "fused_halo_2d",
                        "atmolight"}
    for op in ("fused_dcp", "fused_lanes", "fused_halo_2d", "atmolight"):
        for params in out[op].values():
            tuning.check_params(op, params)
    assert not tables["torch"].exists()
    assert tuning.main(["--validate"]) == 1            # no table


def test_serve_cli_tune_fails_on_a_variant_that_does_not_run(
        tables, monkeypatch, capsys):
    """A candidate that fits but fails to build or run makes ``--tune``
    exit 1; one that does not fit a block is no failure."""
    monkeypatch.setenv("REPRO_TUNE_DEVICE_KIND", "cpu")
    real = tuning._fused_build
    argv = ["--device", "cpu", "--tune", "--resolution", "120p", "--frames",
            "1", "--batch", "1", "--io-dtype", "uint8"]
    for exc, rc in ((RuntimeError, 1), (tuning.TileDoesNotFit, 0)):
        def failing_build(*a, exc=exc):
            build = real(*a)

            def maybe(params):
                if params != tuning.DEFAULTS["fused_dcp"]:
                    raise exc("variant")
                return build(params)
            return maybe
        monkeypatch.setattr(tuning, "_fused_build", failing_build)
        assert serve.main(argv) == rc
        err = capsys.readouterr().err
        assert ("FAIL: --tune skipped" in err) == (rc == 1)


def test_serve_cli_tune_writes_a_valid_table(tables, monkeypatch, capsys):
    monkeypatch.delenv("REPRO_TUNE_DEVICE_KIND")
    rc = serve.main(["--device", "cpu", "--tune", "--resolution", "120p",
                     "--streams", "2", "--lanes", "2", "--frames", "2",
                     "--batch", "1", "--io-dtype", "uint8",
                     "--fail-on-skipped"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "tune: device_kind=cpu" in out and "timed_runs=" in out
    table = tuning.load_table()
    assert tuning.validate_table(table) == []
    ops_ = table["device_kinds"]["cpu"]
    assert set(ops_["fused_dcp"]) == {"1x120x160xu8"}
    assert set(ops_["fused_lanes"]) == {"2x1x120x160xu8"}
    assert set(ops_["atmolight"]) == {"2x120x160"}
    assert tuning.main(["--validate", "--require-kind", "cpu"]) == 0
    assert tuning.main(["--validate", "--require-kind", "kindZ"]) == 1
