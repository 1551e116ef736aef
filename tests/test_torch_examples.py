"""The port's examples (examples/torch/0*.py) are executable documentation:
each asserts its own results (exact recovery, sharding invariance,
checkpoint round-trips), so running it to completion with `--device cpu`
is the test. Each runs in a process of its own; on the card
`chip_smoke.py`'s [examples] phase runs them without the flag."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO / "examples" / "torch").glob("0*.py"))


def test_there_are_five_examples():
    assert [p.name[:2] for p in EXAMPLES] == ["01", "02", "03", "04", "05"]


@pytest.mark.parametrize("script", EXAMPLES, ids=lambda p: p.stem)
def test_example_runs_on_the_cpu(script):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, str(script), "--device", "cpu"], env=env,
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, (
        f"{script.name} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    assert proc.stdout.rstrip().splitlines()[-1] == "OK", script.name
