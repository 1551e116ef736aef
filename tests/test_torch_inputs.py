"""Array-likes in, as cstpu takes them.

cstpu's per-instance solvers and utilities take numpy arrays. The port
places every input by the one rule of cstpu_torch.ops.util.as_inputs: a
tensor keeps its device, anything else goes where a tensor argument lies,
else to the CUDA device, and with neither it raises that helper's error.
Three checks of that, on the CPU:

* every case of chip_smoke.py's [surface] table on numpy copies of its
  problems with no card: it raises the helper's "no CUDA device" error, or
  returns (the cases that take no array, and the sharded ones, whose mesh
  names the CPU); never a TypeError or an AttributeError;
* the solvers and utilities with A a CPU tensor and b a numpy array give
  the same result as with two tensors, bit for bit; the host-side helpers
  (support, samesupport, from_dense, droptol on a dense array) take numpy
  alone with no card, as cstpu's do;
* the supports of cstpu's 13 per-instance solvers on numpy inputs equal
  the port's on the same problem (f64, the oracle sizes of
  tests/conftest.py).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import cstpu
import cstpu_torch as ct
from cstpu.utils import sparse as cstpu_sparse
from cstpu_torch.models import backward, forward
from cstpu_torch.ops import active_set as aset
from cstpu_torch.ops.util import as_inputs
from cstpu_torch.utils import sparse
from cstpu_torch.utils.interop import solution_to_numpy

CASES = chip_smoke.surface_cases()
NO_CARD = "no CUDA device is available"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs beside other
    workers on the same cores (see tests/test_torch_surface.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_card(monkeypatch):
    """A machine without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def problems():
    return chip_smoke.surface_problems("cpu")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_surface_case_on_numpy_inputs(case, problems, no_card):
    P = chip_smoke.surface_numpy(problems)
    try:
        out = case.run(P)
    except RuntimeError as e:
        assert NO_CARD in str(e), e
        return
    # no array reached the CUDA default: the case takes none, or its mesh
    # or generator names the CPU; then it agrees with the tensor call
    if case.agree is not None:
        assert chip_smoke._agree(case, out, case.run(problems))


def test_as_inputs_places_by_the_first_tensor(no_card):
    a = np.ones((2, 3))
    t = torch.zeros(3, dtype=torch.float64)
    A, x = as_inputs(a, t)
    assert isinstance(A, torch.Tensor) and A.device == t.device
    assert x is t
    with pytest.raises(RuntimeError, match=NO_CARD):
        as_inputs(a, [1.0, 2.0])


# -- A a CPU tensor and b a numpy array against two tensors ----------------

def _numpy_problem(n, m, k, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m))
    A /= np.linalg.norm(A, axis=0)
    x = np.zeros(m)
    x[rng.choice(m, k, replace=False)] = rng.choice([-1.0, 1.0], k)
    b = A @ x
    return A, b + 1e-3 * rng.standard_normal(n)


def _state(A, b, m):
    """A per-instance state with three atoms fitted."""
    idx = torch.tensor([0, 3, 7], dtype=torch.int32)
    return aset.refit(aset.rebuild(A, b, idx, torch.ones(3, dtype=torch.bool)))


def _fwd(fn):
    """A forward helper on a fresh state: (A, b) -> its result."""
    def call(A, b):
        tA = torch.as_tensor(A)
        m = tA.shape[1]
        st = aset.refit(aset.empty(tA.shape[0], 6, m, tA.dtype))
        return fn(A, b, st, np.sum(np.asarray(tA) ** 2, axis=0), m)
    return call


def _bwd(fn):
    """A backward helper on a three-atom state: (A, b) -> its result."""
    def call(A, b):
        tA = torch.as_tensor(A)
        st = _state(tA, torch.as_tensor(b), tA.shape[1])
        return fn(A, b, st, tA.shape[1])
    return call


def _f32(b):
    """b in f32, in its own kind."""
    return b.astype(np.float32) if isinstance(b, np.ndarray) else b.float()


def _two_rows(b):
    """b and -b as a batch of two rows, in b's own kind."""
    return np.stack([b, -b]) if isinstance(b, np.ndarray) else torch.stack(
        [b, -b])


def _polish(A, b):
    x = ct.omp(torch.as_tensor(A), torch.as_tensor(b), 3).todense()
    return ct.polish(A, b, x)


WIDE = (32, 48, 3)   # n, m, k of the wide problems
TALL = (48, 32, 3)   # the backward family's
CALLS = {
    "mp": (WIDE, lambda A, b: ct.mp(A, b, 5)),
    "omp": (WIDE, lambda A, b: ct.omp(A, b, 3)),
    "gomp": (WIDE, lambda A, b: ct.gomp(A, b, 2, 4)),
    "oblivious": (WIDE, lambda A, b: ct.oblivious(A, b, 3)),
    **{name: (WIDE, lambda A, b, f=getattr(ct, name): f(A, b, sparsity=3))
       for name in ("fr", "ols", "oomp", "ormp", "stepwise_regression")},
    "fr_warm": (WIDE, lambda A, b: forward.fr_warm(A, b, [0, 5, 7])),
    "sp": (WIDE, lambda A, b: ct.sp(A, b, 3, 1e-2)),
    "ompr": (WIDE, lambda A, b: ct.ompr(A, b, 3, 1e-2)),
    "srr": (WIDE, lambda A, b: ct.srr(A, b, 3, 1e-2)),
    "rmp k": (WIDE, lambda A, b: ct.rmp(A, b, k=3)),
    "rmp delta": (WIDE, lambda A, b: ct.rmp(A, b, delta=1e-2)),
    "foba": (WIDE, lambda A, b: ct.foba(A, b, 1e-2)),
    "br": (TALL, lambda A, b: ct.br(A, b, sparsity=3)),
    "fbr": (TALL, lambda A, b: ct.fbr(A, b, sparsity=3)),
    "lace": (TALL, lambda A, b: ct.lace(A, b, sparsity=3)),
    "batch": (WIDE, lambda A, b: ct.batch(ct.omp, k=3)(A, _two_rows(b))),
    "correlate_argmax": ((32, 128, 3), lambda A, b: ct.correlate_argmax(
        A.float(), _f32(b))),
    "exhaustion_floor": (WIDE, forward.exhaustion_floor),
    "forward_deltas": (WIDE, _fwd(forward.forward_deltas)),
    "forward_step": (WIDE, _fwd(lambda A, b, st, c, m: forward.forward_step(
        A, b, st, 0.0, 0.0, c, m))),
    "backward_deltas": (TALL, _bwd(lambda A, b, st, m: backward.backward_deltas(
        b, st, m))),
    "backward_step": (TALL, _bwd(lambda A, b, st, m: backward.backward_step(
        A, b, st, np.inf, np.inf, m))),
    "lace_step": (TALL, _bwd(lambda A, b, st, m: backward.lace_step(
        A, b, st, np.inf, np.inf, m))),
    "polish": (WIDE, _polish),
    "svd_preconditioner": (WIDE, lambda A, b: ct.svd_preconditioner(A)(b)),
}


def _same(x, y):
    """Bit-for-bit equality of two results (solutions, tensors, tuples,
    states, numbers)."""
    if isinstance(x, ct.SparseSolution):
        return all(torch.equal(getattr(x, f), getattr(y, f))
                   for f in ("idx", "val", "mask")) and x.m == y.m
    if isinstance(x, torch.Tensor):
        return x.device == y.device and torch.equal(x, y)
    if isinstance(x, (tuple, list)):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    return x == y


@pytest.mark.parametrize("name", CALLS)
def test_numpy_b_beside_a_cpu_tensor_gives_the_tensor_result(name, no_card):
    shape, call = CALLS[name]
    A, b = _numpy_problem(*shape, seed=sorted(CALLS).index(name))
    tA = torch.as_tensor(A)
    got, want = call(tA, b), call(tA, torch.as_tensor(b))
    if name == "polish":
        # torch.linalg.lstsq on the CPU gives last-bit differences between
        # two calls on the same inputs (LAPACK's paths follow the buffers'
        # alignment): f64 to 1e-12
        assert got.device == want.device
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    else:
        assert _same(got, want)


# -- the host-side helpers: numpy alone, no card ---------------------------

HOST = {
    "support": lambda pkg, x, y: pkg.support(x, 0.1),
    "samesupport": lambda pkg, x, y: pkg.samesupport(x, y),
    "samesupport tol": lambda pkg, x, y: pkg.samesupport(x, y, 0.5),
    "from_dense": lambda pkg, x, y: pkg.from_dense(x, 12),
    "droptol": lambda pkg, x, y: pkg.droptol(y, 0.5),
}


@pytest.mark.parametrize("name", HOST)
def test_host_helpers_take_numpy_with_no_card(name, no_card):
    rng = np.random.default_rng(sorted(HOST).index(name))
    x = np.where(rng.random(24) < 0.4, rng.standard_normal(24), 0.0)
    y = 0.5 * x
    call = HOST[name]
    got = call(sparse, x, y)
    want = call(sparse, torch.as_tensor(x), torch.as_tensor(y))
    ref = call(cstpu_sparse, x, y)
    if isinstance(got, np.ndarray):
        assert np.array_equal(got, want) and np.array_equal(got, ref)
    elif isinstance(got, bool):
        assert got == want == bool(ref)
    elif isinstance(got, ct.SparseSolution):
        assert _same(got, want) and got.val.device.type == "cpu"
        assert np.array_equal(got.nzind, ref.nzind)
    else:
        assert _same(got, want) and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(ref))


# -- the supports of cstpu's solvers on numpy inputs -----------------------

SOLVERS = {
    "mp": (WIDE, lambda pkg, A, b: pkg.mp(A, b, 5)),
    "omp": (WIDE, lambda pkg, A, b: pkg.omp(A, b, 3)),
    "gomp": (WIDE, lambda pkg, A, b: pkg.gomp(A, b, 2, 4)),
    "oblivious": (WIDE, lambda pkg, A, b: pkg.oblivious(A, b, 3)),
    "fr": (WIDE, lambda pkg, A, b: pkg.fr(A, b, sparsity=3)),
    "sp": (WIDE, lambda pkg, A, b: pkg.sp(A, b, 3, 1e-2)),
    "ompr": (WIDE, lambda pkg, A, b: pkg.ompr(A, b, 3, 1e-2)),
    "srr": (WIDE, lambda pkg, A, b: pkg.srr(A, b, 3, 1e-2)),
    "rmp": (WIDE, lambda pkg, A, b: pkg.rmp(A, b, k=3)),
    "foba": (WIDE, lambda pkg, A, b: pkg.foba(A, b, 1e-2)),
    "br": (TALL, lambda pkg, A, b: pkg.br(A, b, sparsity=3)),
    "fbr": (TALL, lambda pkg, A, b: pkg.fbr(A, b, sparsity=3)),
    "lace": (TALL, lambda pkg, A, b: pkg.lace(A, b, sparsity=3)),
}


def _support(out):
    if isinstance(out, (torch.Tensor, np.ndarray)) or hasattr(out, "shape"):
        x = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        return np.flatnonzero(x).tolist()
    sol = solution_to_numpy(out)
    return sorted(sol["idx"][sol["mask"]].tolist())


@pytest.mark.parametrize("name", SOLVERS)
def test_cstpu_and_the_port_agree_on_numpy_inputs(name, no_card):
    from conftest import planted_problem

    (n, m, k), call = SOLVERS[name]
    A, _, _, y = planted_problem(40 + sorted(SOLVERS).index(name), n=n, m=m,
                                 k=k)
    A, y = np.asarray(A), np.asarray(y)
    want = _support(call(cstpu, A, y))
    got = _support(call(ct, torch.as_tensor(A), y))
    assert got == want and len(want) > 0, (got, want)
