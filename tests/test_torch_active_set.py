"""cstpu_torch's active-set engine against cstpu's, in f64, on the same
numpy inputs (atol 1e-10: the same math in another operation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu.ops import active_set as jas
from cstpu_torch.ops import active_set as tas
from cstpu_torch.utils.interop import solution_to_numpy

ATOL = 1e-10


def _problem(seed, n=32, m=48):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m))
    A /= np.linalg.norm(A, axis=0)
    return A, rng.standard_normal(n)


def _same_state(ts, js):
    for name in ("idx", "mask", "k"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    for name in ("cols", "G", "Ginv", "Atb", "coef"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   atol=ATOL, err_msg=name)


def _both(A, b, atoms, kmax=6):
    """Gated appends of `atoms` with refits, on both engines."""
    n, m = A.shape
    ts = tas.empty(n, kmax, m, torch.float64)
    js = jas.empty(n, kmax, m, jnp.float64)
    tA, tb, jA, jb = torch.from_numpy(A), torch.from_numpy(b), A, b
    for i in atoms:
        present = bool(tas.contains(ts, i))
        assert present == bool(jas.contains(js, i))
        ok = not present
        ts = tas.refit(tas.append_gated(tA, tb, ts, i, ok))
        js = jas.refit(jas.append_gated(jA, jb, js, i, ok))
    return ts, js


def test_empty_matches():
    _same_state(tas.empty(8, 4, 20, torch.float64),
                jas.empty(8, 4, 20, jnp.float64))


def test_append_gated_refit_residual_match():
    A, b = _problem(0)
    ts, js = _both(A, b, [5, 17, 5, 40, 2])          # 5 twice: gated off
    _same_state(ts, js)
    assert int(ts.k) == 4
    np.testing.assert_allclose(tas.residual(ts, torch.from_numpy(b)).numpy(),
                               np.asarray(jas.residual(js, b)), atol=ATOL)
    np.testing.assert_allclose(tas.gamma(ts).numpy(),
                               np.asarray(jas.gamma(js)), atol=ATOL)
    cn2 = np.sum(A * A, axis=0)
    np.testing.assert_allclose(
        tas.ols_rescaling(torch.from_numpy(A), ts,
                          torch.from_numpy(cn2)).numpy(),
        np.asarray(jas.ols_rescaling(A, js, cn2)), atol=ATOL)
    np.testing.assert_array_equal(tas.active_marker(ts, 48).numpy(),
                                  np.asarray(jas.active_marker(js, 48)))


def test_append_ungated_matches():
    A, b = _problem(1)
    ts = tas.empty(32, 4, 48, torch.float64)
    js = jas.empty(32, 4, 48, jnp.float64)
    for i in (3, 9, 30):
        ts = tas.append(torch.from_numpy(A), torch.from_numpy(b), ts, i)
        js = jas.append(A, b, js, i)
    _same_state(tas.refit(ts), jas.refit(js))


def test_gate_rejects_in_span_column():
    A, b = _problem(2)
    ts, js = _both(A, b, [4, 11])
    # a combination of the two active columns is inside their span: both
    # engines must reject it through the degeneracy gate
    a = 0.6 * A[:, 4] - 0.8 * A[:, 11]
    ts2 = tas.append_col_gated(torch.from_numpy(a), torch.from_numpy(b), ts,
                               47, True)
    js2 = jas.append_col_gated(a, b, js, 47, True)
    assert int(ts2.k) == int(js2.k) == 2
    _same_state(ts2, js2)


def test_capacity_is_a_no_op():
    A, b = _problem(3)
    ts, js = _both(A, b, [1, 2], kmax=2)
    ts2 = tas.append_gated(torch.from_numpy(A), torch.from_numpy(b), ts, 9,
                           True)
    js2 = jas.append_gated(A, b, js, 9, True)
    _same_state(ts2, js2)
    assert int(ts2.k) == 2


@pytest.mark.parametrize("pos", [0, 2, 3])
def test_delete_matches(pos):
    A, b = _problem(4)
    ts, js = _both(A, b, [7, 1, 33, 20])
    _same_state(tas.refit(tas.delete(ts, pos, 48)),
                jas.refit(jas.delete(js, pos, 48)))


def test_rebuild_and_finalize_match():
    A, b = _problem(5)
    idx = np.array([12, 3, 40, 48, 48], np.int32)
    mask = idx < 48
    ts = tas.refit(tas.rebuild(torch.from_numpy(A), torch.from_numpy(b),
                               torch.from_numpy(idx), torch.from_numpy(mask)))
    js = jas.refit(jas.rebuild(A, b, jnp.asarray(idx), jnp.asarray(mask)))
    _same_state(ts, js)
    tsol, jsol = solution_to_numpy(tas.finalize(ts, 48)), solution_to_numpy(
        jas.finalize(js, 48))
    np.testing.assert_array_equal(tsol["idx"], jsol["idx"])
    np.testing.assert_array_equal(tsol["mask"], jsol["mask"])
    np.testing.assert_allclose(tsol["val"], jsol["val"], atol=ATOL)
    assert list(tsol["idx"][:3]) == [3, 12, 40]
