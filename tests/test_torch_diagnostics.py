"""cstpu_torch's diagnostics (cstpu_torch.utils.diagnostics: omp_traced,
fr_traced) and dictionary utilities (cstpu_torch.utils.dictionary) against
cstpu's, in float64 on the CPU, on cstpu's seeded problems handed over
through numpy; the exports and signatures of the names the SBL slice and
the convex slice add (cstpu's, but for the sharded solvers' `atoms_axis`).

Tolerances: supports, selections, acceptance flags equal; values to 1e-10
absolute (the traces, the Babel function, the preconditioners: the same f64
products in another order).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstpu
import cstpu_torch
from cstpu.utils import diagnostics as jdiag
from cstpu.utils import dictionary as jdict
from cstpu_torch.utils import diagnostics as tdiag
from cstpu_torch.utils import dictionary as tdict
from cstpu_torch.utils.interop import solution_to_numpy, to_torch

ATOL = 1e-10


def _same_solution(got, want):
    g, w = solution_to_numpy(got), solution_to_numpy(want)
    np.testing.assert_array_equal(g["idx"], w["idx"])
    np.testing.assert_array_equal(g["mask"], w["mask"])
    np.testing.assert_allclose(g["val"], w["val"], rtol=0, atol=1e-8)


def _same_trace(got, want):
    assert type(got).__name__ == type(want).__name__
    for field in got._fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.shape == w.shape, field
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-8)


@pytest.mark.parametrize("seed,k", [(90, 3), (91, 10), (92, None)])
def test_omp_traced_matches_cstpu(seed, k):
    # (91, 10): more steps than the planted sparsity, a stall is recorded
    A, x, b = cstpu.sparse_data(jax.random.PRNGKey(seed), n=32, m=48, k=3)
    sol, tr = tdiag.omp_traced(to_torch(A), to_torch(b), k)
    jsol, jtr = jdiag.omp_traced(A, b, k)
    _same_solution(sol, jsol)
    _same_trace(tr, jtr)
    assert tr.selected.dtype == torch.int32


def test_omp_traced_max_residual_matches_cstpu():
    A, x, b = cstpu.sparse_data(jax.random.PRNGKey(90), n=32, m=48, k=3)
    y = cstpu.perturb(jax.random.PRNGKey(3), b, 1e-2)
    sol, tr = tdiag.omp_traced(to_torch(A), to_torch(y), 8, max_residual=0.5)
    jsol, jtr = jdiag.omp_traced(A, y, 8, max_residual=0.5)
    _same_solution(sol, jsol)
    _same_trace(tr, jtr)


@pytest.mark.parametrize("sparsity", [3, None])
@pytest.mark.parametrize("seed", [93, 94])
def test_fr_traced_matches_cstpu(seed, sparsity):
    A, x, b = cstpu.sparse_data(jax.random.PRNGKey(seed), n=32, m=48, k=3)
    sol, tr = tdiag.fr_traced(to_torch(A), to_torch(b), sparsity=sparsity)
    jsol, jtr = jdiag.fr_traced(A, b, sparsity=sparsity)
    _same_solution(sol, jsol)
    _same_trace(tr, jtr)


def test_fr_traced_stops_match_cstpu():
    A, x, b = cstpu.sparse_data(jax.random.PRNGKey(93), n=32, m=48, k=5)
    y = cstpu.perturb(jax.random.PRNGKey(4), b, 1e-2)
    for kw in (dict(max_residual=0.3), dict(min_decrease=0.2)):
        sol, tr = tdiag.fr_traced(to_torch(A), to_torch(y), sparsity=8, **kw)
        jsol, jtr = jdiag.fr_traced(A, y, sparsity=8, **kw)
        _same_solution(sol, jsol)
        _same_trace(tr, jtr)


def _dictionary(seed=7, n=24, m=40):
    A, _, _ = cstpu.correlated_data(jax.random.PRNGKey(seed), n=n, m=m, k=3)
    return A * jnp.linspace(0.5, 2.0, m)[None, :]   # unequal column norms


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["colnorms", "normalize_columns",
                                  "coherence", "precondition"])
def test_dictionary_unary_matches_cstpu(name):
    A = _dictionary()
    _close(getattr(tdict, name)(to_torch(A)), getattr(jdict, name)(A))


@pytest.mark.parametrize("k", [1, 4, 9])
def test_babel_matches_cstpu(k):
    A = jdict.normalize_columns(_dictionary())
    _close(tdict.cumbabel(to_torch(A), k), jdict.cumbabel(A, k))
    _close(tdict.babel(to_torch(A), k), jdict.babel(A, k))


@pytest.mark.parametrize("eps", [0.0, 0.25])
def test_mean_preconditioner_matches_cstpu(eps):
    A = _dictionary()
    b = A[:, 3] + 0.5
    tp, jp = tdict.mean_preconditioner(eps), jdict.mean_preconditioner(eps)
    _close(tp(to_torch(A)), jp(A))
    _close(tp(to_torch(b)), jp(b))


@pytest.mark.parametrize("min_sigma", [1e-6, 0.5])
def test_svd_preconditioner_matches_cstpu(min_sigma):
    A = _dictionary()
    Bs = A[:, :5] @ jnp.ones((5, 3))
    tp = tdict.svd_preconditioner(to_torch(A), min_sigma)
    jp = jdict.svd_preconditioner(A, min_sigma)
    _close(tp(to_torch(Bs)), jp(Bs))
    _close(tp(to_torch(Bs[:, 0])), jp(Bs[:, 0]))
    _close(tdict.precondition(to_torch(A), min_sigma),
           jdict.precondition(A, min_sigma))


# the names this slice adds to cstpu_torch, with cstpu's signatures
NEW_NAMES = ["colnorms", "normalize_columns", "coherence", "babel",
             "cumbabel", "mean_preconditioner", "svd_preconditioner",
             "precondition", "sbl", "fsbl", "fsbl_traced", "rmps",
             "rmps_traced", "rmps_estimate_noise", "rmps_batch",
             "fsbl_batch", "sbl_batch", "rmps_estimate_noise_batch",
             "omp_traced", "fr_traced", "SolveTrace", "SBLTrace",
             "RMPSTrace"]


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", NEW_NAMES)
def test_new_names_exported_with_cstpu_signatures(name):
    assert name in cstpu_torch.__all__
    got, want = getattr(cstpu_torch, name), getattr(cstpu, name)
    if isinstance(want, type):
        assert got._fields == want._fields
    else:
        assert _params(got) == _params(want)


# the names the convex slice adds: the convex family, the oracle and the
# config, checkpoint and profiling utilities, then the sharded convex
# solvers of cstpu.parallel
CONVEX_NAMES = ["bp", "basispursuit", "bp_candes", "bp_ard", "bpd",
                "basis_pursuit_denoising", "bpd_candes", "bpd_ard", "ista",
                "fista", "exhaustive", "SolverConfig", "solver_config",
                "save_state", "load_state", "solve_cost", "roofline_report"]
SHARDED_CONVEX_NAMES = ["bp_sharded", "bp_ard_sharded", "bpd_sharded",
                        "bpd_candes_sharded", "bpd_ard_sharded",
                        "bpd_secant_sharded", "ista_sharded",
                        "fista_sharded"]
# the one documented difference: the port's mesh names its axes, so the
# sharded solvers drop `atoms_axis`
DROPPED = {"atoms_axis"}


@pytest.mark.parametrize("name", CONVEX_NAMES + SHARDED_CONVEX_NAMES)
def test_convex_names_exported_with_cstpu_signatures(name):
    import cstpu.parallel
    import cstpu_torch.parallel

    sharded = name in SHARDED_CONVEX_NAMES
    pkg_t = cstpu_torch.parallel if sharded else cstpu_torch
    pkg_j = cstpu.parallel if sharded else cstpu
    assert name in pkg_t.__all__
    got, want = getattr(pkg_t, name), getattr(pkg_j, name)
    if isinstance(want, type):
        assert ([f.name for f in dataclasses.fields(got)]
                == [f.name for f in dataclasses.fields(want)])
        return
    expect = [p for p in _params(want) if not (sharded and p[0] in DROPPED)]
    assert _params(got) == expect


def test_exports_follow_cstpu_order():
    ours = [x for x in cstpu.__all__ if x in cstpu_torch.__all__]
    assert len(ours) == 81 == len(cstpu.__all__)
    for names in (NEW_NAMES, CONVEX_NAMES):
        mine = [x for x in cstpu_torch.__all__ if x in names]
        assert mine == [x for x in cstpu.__all__ if x in names]


def test_parallel_exports_cover_cstpu_parallel():
    import cstpu.parallel
    import cstpu_torch.parallel

    ours = [x for x in cstpu.parallel.__all__
            if x in cstpu_torch.parallel.__all__]
    assert len(ours) == 24 == len(cstpu.parallel.__all__)
    mine = [x for x in cstpu_torch.parallel.__all__
            if x in SHARDED_CONVEX_NAMES]
    assert mine == [x for x in cstpu.parallel.__all__
                    if x in SHARDED_CONVEX_NAMES]
