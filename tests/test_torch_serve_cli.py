"""PyTorch port, the serve CLI and what it serves: the port's synthetic hazy
video (``repro_torch.data``) equal to the JAX package's bit for bit, the
scattering model (``repro_torch.core.physics``) within 1e-6 of the
reference's, and ``repro_torch.launch.serve.main`` on the CPU: the
overlapped multi-stream serve passes its ``--expect-overlap`` gate, the
autoscaled ramp its ``--expect-switches`` gate, the 2-host fleet its
``--expect-spillover`` gate, and a serve that ``REPRO_TUNE_REQUIRE_TABLE``
finds without a measured table exits non-zero until ``--tune`` has
measured one."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import physics as jax_physics
from repro.data import HazeVideoSpec as JaxSpec
from repro.data import generate_haze_video as jax_generate
from repro_torch.core import physics
from repro_torch.data import HazeVideoSpec, generate_haze_video
from repro_torch.launch import serve

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 101])
def test_haze_video_matches_reference(seed):
    kw = dict(height=24, width=32, n_frames=5, seed=seed, a_noise=0.01)
    got, want = generate_haze_video(HazeVideoSpec(**kw)), jax_generate(JaxSpec(**kw))
    for name in ("hazy", "clear", "t", "A"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert np.array_equal(np.stack(list(got)), want.hazy)


def test_physics_matches_reference():
    rng = np.random.default_rng(3)
    clear = rng.random((2, 8, 10, 3)).astype(np.float32)
    depth = (3 * rng.random((2, 8, 10))).astype(np.float32)
    A = (0.6 + 0.4 * rng.random((2, 3))).astype(np.float32)
    t = physics.transmission_from_depth(torch.from_numpy(depth), 1.3)
    jt = jax_physics.transmission_from_depth(jnp.asarray(depth), 1.3)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-6, rtol=0)
    hazy = physics.synthesize_haze(torch.from_numpy(clear), t,
                                   torch.from_numpy(A))
    jhazy = jax_physics.synthesize_haze(jnp.asarray(clear), jt, jnp.asarray(A))
    np.testing.assert_allclose(hazy.numpy(), np.asarray(jhazy), atol=1e-6,
                               rtol=0)
    for t0 in (physics.DEFAULT_T0, 0.3):
        got = physics.recover(hazy, t, torch.from_numpy(A), t0)
        want = jax_physics.recover(jhazy, jt, jnp.asarray(A), t0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)
    # A shared (3,) light broadcasts over the frames.
    one = physics.synthesize_haze(torch.from_numpy(clear), t,
                                  torch.from_numpy(A[0]))
    jone = jax_physics.synthesize_haze(jnp.asarray(clear), jt,
                                       jnp.asarray(A[0]))
    np.testing.assert_allclose(one.numpy(), np.asarray(jone), atol=1e-6,
                               rtol=0)


def test_cli_serves_overlapped_and_gates(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TICK_OVERLAP", "1")
    rc = serve.main(["--device", "cpu", "--resolution", "120p",
                     "--streams", "2", "--lanes", "2", "--frames", "16",
                     "--io-dtype", "uint8", "--expect-overlap",
                     "--fail-on-skipped"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "tick_io: overlap_ticks=2/2 " in out
    assert "parity(cam0): frames=16 maxerr=0.00e+00" in out
    # The blocking path fails the gate.
    monkeypatch.setenv("REPRO_TICK_OVERLAP", "0")
    rc = serve.main(["--device", "cpu", "--resolution", "120p",
                     "--frames", "8", "--expect-overlap"])
    captured = capsys.readouterr()
    assert rc == 1 and "tick_io: overlap_ticks=0/1 " in captured.out
    assert "silent fallback" in captured.err


@pytest.mark.parametrize("flags", [["--tune"]])
def test_cli_unported_options_exit_nonzero(flags, tmp_path, monkeypatch,
                                           capsys):
    """``--tune``, once the one option not ported, runs now (its search is
    held to the reference in ``test_torch_tuning.py``). What exits non-zero
    is a serve whose knobs ``REPRO_TUNE_REQUIRE_TABLE=1`` finds without a
    measurement: without ``flags`` the table stays empty and the CLI exits
    1; with them the search fills it and the same serve runs."""
    table = tmp_path / "tuning.json"
    monkeypatch.setenv("REPRO_TORCH_KERNEL_TUNING", str(table))
    monkeypatch.setenv("REPRO_TUNE_REQUIRE_TABLE", "1")
    monkeypatch.delenv("REPRO_TUNE_DEVICE_KIND", raising=False)
    argv = ["--device", "cpu", "--resolution", "120p", "--frames", "2",
            "--batch", "2"]
    assert serve.main(argv) == 1
    assert "REPRO_TUNE_REQUIRE_TABLE" in capsys.readouterr().err
    assert not table.exists()
    assert serve.main(argv + flags) == 0
    captured = capsys.readouterr()
    assert "tune: device_kind=cpu" in captured.out
    assert "not ported" not in captured.err


@pytest.mark.parametrize("overlap", ["0", "1"])
def test_cli_autoscale_ramp_switches(overlap, monkeypatch, capsys):
    """``--autoscale --ladder 2,4 --ramp --expect-switches 2``: the rungs
    primed, the ramp grows and shrinks the ladder, and the reference's
    report lines are printed."""
    monkeypatch.setenv("REPRO_TICK_OVERLAP", overlap)
    # 96 frames: the burst keeps streams queued for 6 ticks at 2 lanes,
    # time for rung 4's warm-up (one tick's work on this CPU) to land.
    rc = serve.main(["--device", "cpu", "--resolution", "120p",
                     "--streams", "6", "--lanes", "4", "--frames", "96",
                     "--autoscale", "--ladder", "2,4", "--ramp",
                     "--expect-switches", "2", "--io-dtype", "uint8",
                     "--fail-on-skipped"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "streams=6 lanes=2 batch=8 hosts=1" in out
    line = next(s for s in out.splitlines() if s.startswith("ladder_switches="))
    assert int(line.split()[0].split("=")[1]) >= 2
    assert "evictions=0 final_lanes=2 warm_failures=0" in line
    assert "parity(cam0): frames=24 maxerr=0.00e+00" in out
    assert all(f"  cam{i}: frames={n} emitted={n} skipped=0" in out
               for i, n in enumerate([24, 24, 24, 24, 96, 96]))


def test_cli_autoscale_fails_on_missing_switches(capsys):
    """Fewer switches than expected fail the serve (no ramp: no backlog)."""
    rc = serve.main(["--device", "cpu", "--resolution", "120p",
                     "--streams", "2", "--lanes", "2", "--frames", "8",
                     "--autoscale", "--ladder", "2", "--expect-switches",
                     "1"])
    captured = capsys.readouterr()
    assert rc == 1 and "ladder_switches=0 " in captured.out
    assert "expected >= 1 ladder switches, got 0" in captured.err


def test_cli_fleet_spills_over(capsys):
    """``--hosts 2 --lanes 4 --expect-spillover 1``: 8 streams behind one
    front door, every frame once, no migration."""
    rc = serve.main(["--device", "cpu", "--resolution", "120p",
                     "--streams", "8", "--hosts", "2", "--lanes", "4",
                     "--frames", "16", "--expect-spillover", "1",
                     "--fail-on-skipped"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "streams=8 lanes=8 batch=8 hosts=2" in out
    line = next(s for s in out.splitlines() if s.startswith("spillovers="))
    assert int(line.split()[0].split("=")[1]) >= 1
    assert line.endswith("migrations=0")
    assert all(f"  cam{i}: frames=16 emitted=16 skipped=0" in out
               for i in range(8))
    rc = serve.main(["--device", "cpu", "--resolution", "120p",
                     "--streams", "2", "--hosts", "2", "--lanes", "1",
                     "--frames", "8", "--expect-spillover", "9"])
    assert rc == 1
    assert "expected >= 9 spillover admission(s)" in capsys.readouterr().err
