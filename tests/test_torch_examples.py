"""The examples' PyTorch twins (``examples/*_torch.py``) run as a user
runs them, each in a subprocess on the CPU (``--device cpu``;
``train_lm_torch.py`` at a small width and step count), under a time
limit: each must exit 0 and print its "OK" line, which it prints only
after its own assertions (the JAX script's) hold."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
TWINS = {
    "quickstart_torch.py": [],
    "video_dehaze_serve_torch.py": [],
    "dehaze_then_classify_torch.py": [],
    "train_lm_torch.py": ["--steps", "120", "--layers", "2", "--d-model", "128",
                          "--batch", "8", "--seq", "32"],
    "sample_dit_torch.py": [],
}


@pytest.mark.parametrize("script", list(TWINS))
def test_example_twin_runs_on_the_cpu(script):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *TWINS[script]], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert lines and lines[-1].endswith("OK"), proc.stdout[-2000:]


def test_twins_import_nothing_of_jax():
    for script in TWINS:
        text = (ROOT / "examples" / script).read_text()
        for bad in ("import jax", "from jax", "from repro ", "from repro.",
                    "import repro\n", "import repro."):
            assert bad not in text, (script, bad)
