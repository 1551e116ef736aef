"""The plain versions of the deletion kernels of
cstpu_torch.ops.fused_backward (the whole solves `fbr_fused_solve_ref` and
`lace_fused_solve_ref`) on the CPU against cstpu's Pallas kernel
(`fbr_fused_solve`, `lace_fused_solve`) in interpret mode, on the cases of
cstpu's tests/test_fused_backward.py and the same numpy arrays.

Tolerances: supports and `failed` equal; coefficients to 1e-4 absolute
(both end with an exact f32 refit on the surviving support)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstpu
from cstpu.ops import fused_backward as jfb
from cstpu_torch.ops import fused_backward as tfb
from cstpu_torch.utils.interop import solution_to_numpy, to_torch

ATOL = 1e-4
DELTA = 1e-2
SOLVES = {"fbr": (tfb.fbr_fused_solve_ref, jfb.fbr_fused_solve),
          "lace": (tfb.lace_fused_solve_ref, jfb.lace_fused_solve)}


def _problem(seed, n=32, m=None, k=3):
    from conftest import planted_problem

    return planted_problem(seed, n=n, m=n if m is None else m, k=k,
                           noise=DELTA / 2, dtype=jnp.float32)


def _compare(name, A, Bs, **kw):
    """The plain solve against cstpu's kernel in interpret mode; returns the
    port's (solution as numpy, failed, steps)."""
    tsolve, jsolve = SOLVES[name]
    jsol, jfail = jsolve(A, Bs, interpret=True, **kw)
    tsol, tfail, steps = tsolve(to_torch(A), to_torch(Bs), return_iters=True,
                                **kw)
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tfail.numpy(), np.asarray(jfail))
    return t, tfail, steps


def _supports(t):
    return [set(row[mask].tolist()) for row, mask in zip(t["idx"], t["mask"])]


def test_fbr_sparsity_matches_pallas_kernel():
    A, x, b, y = _problem(310)
    Bs = jnp.stack([b, y, 2.0 * b, b - 0.1 * y])
    t, failed, steps = _compare("fbr", A, Bs, sparsity=3)
    assert t["idx"].shape == (4, 32) and steps == 29 and not failed.any()
    planted = set(np.flatnonzero(np.asarray(x)).tolist())
    assert all(sup == planted for sup in _supports(t))
    # and the per-instance path's coefficients, after both exact refits
    for row, bb in enumerate(Bs):
        ref = np.asarray(cstpu.fbr(A, bb, sparsity=3).todense())
        dense = np.zeros(32, np.float32)
        dense[t["idx"][row][t["mask"][row]]] = t["val"][row][t["mask"][row]]
        np.testing.assert_allclose(dense, ref, atol=1e-3)


@pytest.mark.parametrize("crit", ["max_residual", "max_increase"])
def test_fbr_threshold_stopping_matches_pallas_kernel(crit):
    A, x, b, y = _problem(312)
    t, failed, steps = _compare("fbr", A, y[None, :], **{crit: DELTA})
    assert _supports(t) == [set(np.flatnonzero(np.asarray(x)).tolist())]
    assert steps <= 32 and not failed.any()


@pytest.mark.parametrize("kw", [{"sparsity": 3}, {"max_residual": DELTA}])
def test_lace_matches_pallas_kernel(kw):
    A, x, b, y = _problem(313 if "sparsity" in kw else 314, n=48, m=32)
    t, failed, _ = _compare("lace", A, jnp.stack([b, y]), **kw)
    planted = set(np.flatnonzero(np.asarray(x)).tolist())
    assert _supports(t)[1] == planted and not failed.any()


def test_fbr_sparsity_zero_deletes_all():
    A, x, b, y = _problem(315, n=16, m=16, k=2)
    t, failed, steps = _compare("fbr", A, b[None, :], sparsity=0)
    assert not t["mask"].any() and not failed.any() and steps == 16


@pytest.mark.parametrize("name", ["fbr", "lace"])
def test_heterogeneous_stops_do_not_interfere(name):
    # rows that stop at different deletion counts: a stopped row is skipped
    # by every later step while the others go on
    A, x, b, y = _problem(316)
    A2, x2, b2, y2 = _problem(317, k=5)
    t, failed, _ = _compare(name, A, jnp.stack([y, b2, 3.0 * y]),
                            max_increase=DELTA)
    sizes = [len(sup) for sup in _supports(t)]
    assert sizes[0] == 3 and sizes[1] != sizes[0] and not failed.any()


def test_nan_init_sets_failed():
    # a duplicated column makes the Gram singular and the shared Cholesky
    # init NaN: the flag latches instead of reporting success
    A0 = jax.random.normal(jax.random.PRNGKey(400), (48, 31), jnp.float32)
    A = jnp.concatenate([A0, A0[:, :1]], axis=1)
    A = A / jnp.linalg.norm(A, axis=0, keepdims=True)
    b = A[:, 0] + A[:, 5]
    for name in ("fbr", "lace"):
        tsolve, jsolve = SOLVES[name]
        _, jfail = jsolve(A, b[None, :], sparsity=3, interpret=True)
        tsol, tfail = tsolve(to_torch(A), to_torch(b[None, :]), sparsity=3)
        assert bool(tfail[0]) and bool(jfail[0])
        assert int(tsol.mask.sum()) == 32     # a failed row stops deleting


def test_fbr_refit_discards_downdate_drift_fuzz20099():
    # cstpu's fuzz trial 20099, drawn as its test draws it: after ~125 f32
    # Schur downdates two paths held the same support with coefficients
    # drifted apart; with the exact final refit the residuals agree
    trial = 20099
    rng = np.random.default_rng(trial)
    shapes = [(32, 128), (64, 128), (64, 256), (32, 48)]
    n0, m0 = shapes[rng.integers(len(shapes))]
    k = int(rng.integers(1, 7))
    correlated = bool(rng.integers(2))
    key = jax.random.PRNGKey(int(rng.integers(2**31)))
    gen = cstpu.correlated_data if correlated else cstpu.sparse_data
    kwargs = {"decay": 1.0} if correlated else {}
    _, _, b0 = gen(key, n=n0, m=m0, k=k, dtype=jnp.float32, **kwargs)
    rng.integers(2)
    jax.random.split(jax.random.PRNGKey(int(rng.integers(2**31))), 8)
    key2 = jax.random.PRNGKey(int(rng.integers(2**31)))
    A, _, b = cstpu.sparse_data(key2, n=128, m=128, k=k, dtype=jnp.float32)
    keys2 = jax.random.split(jax.random.PRNGKey(int(rng.integers(2**31))), 8)
    Y = jnp.stack([b] + [cstpu.perturb(kk, b, 1e-2) for kk in keys2[:7]])

    t, failed, steps = _compare("fbr", A, Y, sparsity=k)
    assert not failed.any() and steps == 128 - k
    tsol, _ = tfb.fbr_fused_solve_ref(to_torch(A), to_torch(Y), sparsity=k)
    ref = cstpu.fbr_batch(A, Y, sparsity=k)
    An, Yn = np.asarray(A), np.asarray(Y)
    rk = np.linalg.norm(tsol.todense().numpy() @ An.T - Yn, axis=1)
    rx = np.linalg.norm(np.asarray(jax.vmap(lambda s: s.todense())(ref))
                        @ An.T - Yn, axis=1)
    assert (rk <= rx * (1 + 1e-3) + 1e-4).all(), (rk, rx)
    assert (rx <= rk * (1 + 1e-3) + 1e-4).all(), (rk, rx)


def test_f64_input_solves_in_f32_and_keeps_tf32_setting():
    # the kernels' path is f32 whatever comes in, and pins true f32 only
    # for its own products: the caller's TF32 switch is as it was
    A, x, b, y = _problem(319)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sol, failed = tfb.fbr_fused_solve_ref(
            to_torch(A).double(), to_torch(y[None, :]).double(), sparsity=3)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert sol.val.dtype == torch.float32 and not failed.any()
    assert (set(sol.idx[0][sol.mask[0]].tolist())
            == set(np.flatnonzero(np.asarray(x)).tolist()))


def test_backward_gate_and_shape_errors():
    A = torch.zeros((1024, 1024))
    Bs = torch.zeros((8, 1024))
    assert tfb.supported_backward(A, Bs)
    assert tfb.supported_backward(A, Bs.repeat(8, 1))          # 256 MB
    assert not tfb.supported_backward(A, Bs.repeat(128, 1))    # 4 GB state
    assert not tfb.supported_backward(A.double(), Bs)
    assert not tfb.supported_backward(A[:512], Bs[:, :512])    # m > n
    assert not tfb.supported_backward(A[:, :1022], Bs)         # m % 4
    assert not tfb.supported_backward(A, Bs[:, :10])
    for solve in (tfb.fbr_fused_solve_ref, tfb.lace_fused_solve_ref):
        with pytest.raises(ValueError, match="m <= n"):
            solve(A[:16, :32], Bs[:, :16], sparsity=3)
