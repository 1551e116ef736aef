"""tools/fuzz_torch.py, the port's invariant fuzz, on the CPU.

Each of its thirteen checks runs one trial here (the trial number is the
check's place in `CHECKS` plus 13: the problem a round-robin campaign from
seed 0 gives it on its second turn, whose sub-cases, GOMP, FBR, FSBL and
sharded FISTA, the chip's campaign of 13 trials from 13 runs too; the first
turn's sharded BP takes 13 s on this CPU), with no violation; the kernel-against-
plain check says that it is skipped, since on the CPU both routes are the
plain twin.
A differential case feeds the same numpy problems to the cstpu calls of
benchmarks/fuzz.py's batch pairs and to the port's, and compares supports
and coefficients (in f64: rtol 1e-6, atol 1e-9; the two sum in other
orders).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fuzz as jfuzz

_PATH = Path(__file__).resolve().parent.parent / "tools" / "fuzz_torch.py"
_SPEC = importlib.util.spec_from_file_location("fuzz_torch", _PATH)
fuzz = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(fuzz)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs beside other
    workers on the same cores, and torch's default, a thread a core in
    every worker, makes these small solves wait on each other (a 1 s case
    took 267 s in a six-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_checks_are_cstpus_thirteen():
    assert len(fuzz.CHECKS) == len(jfuzz.CHECKS) == 13
    ported = {c.__name__ for c in fuzz.CHECKS}
    assert ported == ({c.__name__ for c in jfuzz.CHECKS}
                      - {"check_fused_vs_xla"} | {"check_kernel_vs_plain"})
    assert fuzz.SHAPES == jfuzz.SHAPES


@pytest.mark.parametrize("check", fuzz.CHECKS, ids=lambda c: c.__name__)
def test_each_check_holds_on_one_cpu_trial(check, capsys):
    fz = fuzz.Fuzz("cpu")
    fuzz.run_trial(fz, len(fuzz.CHECKS) + fuzz.CHECKS.index(check), check)
    assert fz.violations == []
    if check is fuzz.check_kernel_vs_plain:
        assert "skipped on the CPU" in capsys.readouterr().out


def test_a_raising_check_is_a_violation():
    fz = fuzz.Fuzz("cpu")

    def check_that_raises(fz, trial, rng, A, b, k):
        raise RuntimeError("boom")

    fuzz.run_trial(fz, 0, check_that_raises)
    assert len(fz.violations) == 1 and "RuntimeError: boom" in \
        fz.violations[0]


def test_command_line_rejects_a_bad_filter_and_device():
    assert fuzz.main(["1", "0", "no_such_check", "--device", "cpu"]) == 2
    assert fuzz.main(["1", "--device", "tpu"]) == 2


def _numpy_problem(seed, n=32, m=128, k=4):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m))
    A /= np.linalg.norm(A, axis=0)
    x = np.zeros(m)
    x[rng.choice(m, k, replace=False)] = rng.choice([-1.0, 1.0], k)
    return A, A @ x + 1e-3 * rng.standard_normal(n)


@pytest.mark.parametrize("pairs,name", [
    *(("batch", p[0]) for p in jfuzz.BATCH_PAIRS),
    *(("backward", p[0]) for p in jfuzz.BACKWARD_PAIRS)])
def test_cstpu_and_port_single_solvers_agree(pairs, name):
    # benchmarks/fuzz.py's cstpu call and fuzz_torch's port call of the
    # same pair, on the same numpy problem in f64
    k = 4
    if pairs == "batch":
        A, b = _numpy_problem(len(name))
        jpairs, tpairs = jfuzz.BATCH_PAIRS, fuzz.BATCH_PAIRS
    else:
        A, b = _numpy_problem(len(name), n=48, m=48 if name != "lace" else 32)
        jpairs, tpairs = jfuzz.BACKWARD_PAIRS, fuzz.BACKWARD_PAIRS
    jsingle = dict((p[0], p[1]) for p in jpairs)[name]
    tsingle = dict((p[0], p[1]) for p in tpairs)[name]
    want = jsingle(jnp.asarray(A), jnp.asarray(b), k)
    got = tsingle(torch.from_numpy(A), torch.from_numpy(b), k)
    np.testing.assert_array_equal(np.asarray(got.nzind),
                                  np.asarray(want.nzind))
    np.testing.assert_allclose(np.asarray(got.nzval), np.asarray(want.nzval),
                               rtol=1e-6, atol=1e-9)
