"""cstpu_torch.native (the C++ simplex and LASSO-path solvers, a copy of
cstpu.native built into cstpu_torch/build) against cstpu.native on the
same float64 inputs. They are the same C++ built with the same g++ flags,
so every result is held bit for bit (tolerance 0). The build itself: the
library's name carries a hash of the sources, and a failed build raises
with g++'s messages.
"""

import os
import shutil

import jax
import numpy as np
import pytest

import cstpu.native as jn
import cstpu_torch.native as tn
from cstpu import correlated_data, sparse_data


def _planted(seed, n=32, m=48, k=3, noise=5e-3):
    from conftest import planted_problem

    A, x, b, y = planted_problem(seed, n=n, m=m, k=k, noise=noise)
    return np.asarray(A), np.asarray(x), np.asarray(b), np.asarray(y)


def _equal(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_library_lives_in_the_build_directory():
    path = tn._build()
    assert os.path.dirname(path) == tn._BUILD
    assert os.path.basename(tn._BUILD) == "build"
    assert os.path.dirname(tn._BUILD) == os.path.dirname(tn._HERE)
    assert tn.CXX_FLAGS == ["-O3", "-fPIC", "-shared", "-std=c++17",
                            "-pthread"]
    assert path == tn._lib_path() and os.path.exists(path)


def test_sources_are_cstpus(tmp_path):
    # the same C++ as cstpu.native: the copies differ from cstpu's only
    # in comment lines
    for name in ("simplex.cpp", "lars.cpp"):
        mine = open(os.path.join(tn._HERE, name)).read().splitlines()
        theirs = open(os.path.join(os.path.dirname(jn.__file__),
                                   name)).read().splitlines()
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            if a != b:
                assert a.lstrip().startswith("//"), (name, a)


def test_failed_build_raises_with_compiler_message(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(tn, "_SRCS", [str(bad)])
    monkeypatch.setattr(tn, "_BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        tn._build()
    assert "broken.cpp" in str(err.value)
    # nothing half-written is left behind
    assert not any(p.name.endswith(".tmp")
                   for p in (tmp_path / "build").iterdir())


def test_library_name_follows_source_contents(tmp_path, monkeypatch):
    src = tmp_path / "a.cpp"
    src.write_text("// one\n")
    monkeypatch.setattr(tn, "_SRCS", [str(src)])
    first = tn._lib_path()
    src.write_text("// two\n")
    assert tn._lib_path() != first


CASES = {
    "known_lp": lambda: (np.array([[1.0, 2.0], [3.0, 2.0]]),
                         np.array([4.0, 8.0]), np.array([1.0, 1.0])),
    "negative_rhs": lambda: (np.array([[-1.0, 0.0]]), np.array([-3.0]),
                             np.array([1.0, 5.0])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_simplex_solve_bit_equal(case):
    A, b, c = CASES[case]()
    _equal(tn.simplex_solve(A, b, c), jn.simplex_solve(A, b, c))


def test_simplex_infeasible_raises_like_cstpu():
    A = np.array([[1.0, 1.0], [1.0, 1.0]])
    b = np.array([1.0, 2.0])
    c = np.array([1.0, 1.0])
    with pytest.raises(tn.SimplexError, match="infeasible"):
        tn.simplex_solve(A, b, c)
    with pytest.raises(jn.SimplexError, match="infeasible"):
        jn.simplex_solve(A, b, c)


@pytest.mark.parametrize("seed", [80, 81, 82])
@pytest.mark.parametrize("weighted", [False, True])
def test_bp_simplex_bit_equal(seed, weighted):
    A, x, b, _ = _planted(seed)
    w = np.linspace(0.5, 1.5, A.shape[1]) if weighted else None
    _equal(tn.bp_simplex(A, b, w), jn.bp_simplex(A, b, w))


def test_bp_simplex_correlated_bit_equal():
    A, x, b = correlated_data(jax.random.PRNGKey(192787767), n=64, m=128,
                              k=2, decay=1.0)
    A, b = np.asarray(A), np.asarray(b)
    _equal(tn.bp_simplex(A, b), jn.bp_simplex(A, b))


@pytest.mark.parametrize("seed", [83, 84])
@pytest.mark.parametrize("lam", [1e-3, 1e-2])
def test_lasso_homotopy_bit_equal(seed, lam):
    A, x, b, y = _planted(seed)
    _equal(tn.lasso_homotopy(A, y, lam), jn.lasso_homotopy(A, y, lam))
    w = np.linspace(0.5, 1.5, A.shape[1])
    _equal(tn.lasso_homotopy(A, y, lam, w), jn.lasso_homotopy(A, y, lam, w))


@pytest.mark.parametrize("seed", [85, 86])
@pytest.mark.parametrize("delta", [1e-2, 1e-1])
def test_bpd_homotopy_bit_equal(seed, delta):
    A, x, b, y = _planted(seed)
    _equal(tn.bpd_homotopy(A, y, delta), jn.bpd_homotopy(A, y, delta))


def test_homotopy_batches_bit_equal():
    A, x, b, y = _planted(87)
    Bs = np.stack([b, y, A @ np.linspace(0, 1, 48) * 1e-2])
    for t, j in ((tn.lasso_homotopy_batch, jn.lasso_homotopy_batch),
                 (tn.bpd_homotopy_batch, jn.bpd_homotopy_batch)):
        _equal(t(A, Bs, 1e-2, n_threads=2), j(A, Bs, 1e-2, n_threads=2))


def test_homotopy_infeasible_delta_raises_like_cstpu():
    A = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (24, 3)))
    b = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (24,)))
    for mod in (tn, jn):
        with pytest.raises(mod.HomotopyError):
            mod.bpd_homotopy(A, b, 1e-6)


def test_sparse_data_problem_bit_equal():
    A, x, b = sparse_data(jax.random.PRNGKey(89), n=16, m=64, k=2)
    A, b = np.asarray(A), np.asarray(b)
    _equal(tn.bp_simplex(A, b), jn.bp_simplex(A, b))
    _equal(tn.lasso_homotopy(A, b, 1e-4), jn.lasso_homotopy(A, b, 1e-4))
