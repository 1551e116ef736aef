"""The batched bodies of cstpu_torch's greedy, two-stage, stepwise and
backward solvers (`_omp_rows`, `_fr_rows`, ... of cstpu_torch.models) on
the CPU: every `*_batch` fallback against cstpu's vmapped fallback of the
same entry point on the same numpy problems; row independence (a row's
result is what it gives alone, a NaN or all-zero row included); the latch
reads of `ops.util.LOOP_COUNTS`, which follow the slowest row's steps and
not the batch size; and `batch`'s mapping of the package's solvers to
their bodies.

Tolerances: in f64 supports are identical and values agree to 1e-10
relative; in f32 supports are identical and values agree to 1e-5 relative
(atol 1e-6). A row against itself alone is compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstpu
import cstpu_torch
from cstpu_torch.models import backward as tbackward
from cstpu_torch.models import batched as tbatched
from cstpu_torch.models import forward as tforward
from cstpu_torch.models import matching_pursuit as tmp
from cstpu_torch.models import stepwise as tstep
from cstpu_torch.models import twostage as ttwo
from cstpu_torch.ops import fused_solve as tfs
from cstpu_torch.ops import util as tutil
from cstpu_torch.utils.interop import solution_to_numpy, to_torch


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test: beside the other xdist workers torch's
    default thread count makes these small batched solves wait on each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tol(dtype):
    return ({"rtol": 1e-10, "atol": 1e-12} if dtype == jnp.float64
            else {"rtol": 1e-5, "atol": 1e-6})


def _greedy(seed, dtype=jnp.float64, n=32, m=48):
    """The oracle size of tests/conftest.py: four rows, the even ones
    noiseless."""
    from conftest import planted_problem

    A, x, b, y = planted_problem(seed, n=n, m=m, k=3, dtype=dtype)
    return A, jnp.stack([b, y, -b, b + 0.5 * y])


def _square(seed, dtype=jnp.float64):
    from conftest import planted_problem

    A, x, b, y = planted_problem(seed, n=24, m=16, k=3, noise=5e-3,
                                 dtype=dtype)
    return A, jnp.stack([y, 2.0 * y, b - 0.1 * y])


def _same(tsol, jsol, dtype):
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_array_equal(np.where(t["mask"], t["idx"], -1),
                                  np.where(j["mask"], j["idx"], -1))
    np.testing.assert_allclose(t["val"], j["val"], **_tol(dtype))


# every *_batch fallback that leaves the kernels, with its problem and call
GREEDY_CASES = {
    "omp_batch max_residual": lambda M, A, Bs: M.omp_batch(
        A, Bs, 5, max_residual=1e-2),
    "omp_batch highest": lambda M, A, Bs: M.omp_batch(
        A, Bs, 5, precision="highest"),
    # without sparsity a noisy row runs to full rank, where the last picks
    # are rounding noise: the noiseless rows alone, and the noisy ones under
    # a decrease floor above the noise
    "fr_batch exhaustion": lambda M, A, Bs: M.fr_batch(A, Bs[::2]),
    "fr_batch exhaustion min_decrease": lambda M, A, Bs: M.fr_batch(
        A, Bs, min_decrease=1e-2),
    "fr_batch min_decrease": lambda M, A, Bs: M.fr_batch(
        A, Bs, min_decrease=1e-2, sparsity=6),
    "srr_batch init 2": lambda M, A, Bs: M.srr_batch(
        A, Bs, 3, maxiter=6, initialization=2),
    "srr_batch l 2": lambda M, A, Bs: M.srr_batch(A, Bs, 3, maxiter=6, l=2),
    "sp_batch": lambda M, A, Bs: M.sp_batch(A, Bs, 3, maxiter=6),
    "ompr_batch": lambda M, A, Bs: M.ompr_batch(A, Bs, 3, 1e-12, maxiter=8),
    "rmp_batch delta": lambda M, A, Bs: M.rmp_batch(
        A, Bs, delta=1e-2, maxiter=2),
    "rmp_batch k": lambda M, A, Bs: M.rmp_batch(A, Bs, k=3),
    "foba_batch": lambda M, A, Bs: M.foba_batch(A, Bs, 1e-2),
    "gomp_batch": lambda M, A, Bs: M.gomp_batch(A, Bs, 2, 5),
}

BACKWARD_CASES = {
    "br_batch": lambda M, A, Bs: M.br_batch(A, Bs, sparsity=3),
    "br_batch naive": lambda M, A, Bs: M.br_batch(A, Bs, sparsity=3,
                                                  naive=True),
    "br_batch max_increase": lambda M, A, Bs: M.br_batch(
        A, Bs, max_increase=1e-2),
}


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("case", sorted(GREEDY_CASES))
def test_greedy_bodies_match_cstpus_vmap(case, dtype):
    A, Bs = _greedy(400, dtype)
    call = GREEDY_CASES[case]
    _same(call(cstpu_torch, to_torch(A), to_torch(Bs)), call(cstpu, A, Bs),
          dtype)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_mp_batch_body_matches_cstpu(dtype):
    A, Bs = _greedy(401, dtype)
    t = cstpu_torch.mp_batch(to_torch(A), to_torch(Bs), 7)
    np.testing.assert_allclose(t.numpy(), np.asarray(cstpu.mp_batch(A, Bs, 7)),
                               **_tol(dtype))


@pytest.mark.parametrize("case", sorted(BACKWARD_CASES))
def test_br_bodies_match_cstpus_vmap(case):
    A, Bs = _square(402)
    call = BACKWARD_CASES[case]
    _same(call(cstpu_torch, to_torch(A), to_torch(Bs)), call(cstpu, A, Bs),
          jnp.float64)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("name", ["fbr_batch", "lace_batch"])
def test_fbr_lace_bodies_return_failed_match_cstpu(name, dtype):
    A, Bs = _square(403, dtype)
    bad = np.asarray(Bs).copy()
    bad[1] = np.nan
    for rows in (Bs, jnp.asarray(bad)):
        tsol, tfailed = getattr(cstpu_torch, name)(
            to_torch(A), to_torch(rows), sparsity=3, return_failed=True)
        jsol, jfailed = getattr(cstpu, name)(A, rows, sparsity=3,
                                             return_failed=True)
        np.testing.assert_array_equal(tfailed.numpy(), np.asarray(jfailed))
        keep = ~np.asarray(jfailed)
        t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
        np.testing.assert_array_equal(t["idx"][keep], j["idx"][keep])
        np.testing.assert_allclose(t["val"][keep], j["val"][keep],
                                   **_tol(dtype))


def test_srr_random_init_draws_a_permutation_a_row_in_row_order():
    # initialization 3: row b's support is the b-th randperm of the
    # generator, as a loop of per-instance solves with the same generator
    A, Bs = _greedy(410)
    tA, tB = to_torch(A), to_torch(Bs)
    got = ttwo._srr_rows(tA, tB, 3, maxiter=4, initialization=3,
                         key=torch.Generator().manual_seed(5))
    key = torch.Generator().manual_seed(5)
    for b in range(tB.shape[0]):
        one = cstpu_torch.srr(tA, tB[b], 3, maxiter=4, initialization=3,
                              key=key)
        for x, y in zip(_row(got, b), _fields(one)):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


# --------------------------------------------------------------------------
# Row independence
# --------------------------------------------------------------------------

def _mixed(seed):
    """A noisy planted row, a row one atom spans (it stops at its first
    step), a row twice atom 0 (OMP's residual is then exactly zero and it
    stalls on atom 0), an all-zero row and a NaN row; f64 tensors."""
    A, Bs = _greedy(seed)
    A, Bs = to_torch(A), to_torch(Bs)
    nan = torch.full_like(Bs[0], float("nan"))
    return A, torch.stack([Bs[1], A[:, 7].clone(), 2.0 * A[:, 0],
                           torch.zeros_like(Bs[0]), nan, Bs[3]])


ROWS_CASES = {
    "omp max_residual": lambda A, Bs: tmp._omp_rows(A, Bs, 6, 1e-6),
    "omp": lambda A, Bs: tmp._omp_rows(A, Bs, 6),
    "mp": lambda A, Bs: tmp._mp_rows(A, Bs, 6),
    "gomp": lambda A, Bs: tmp._gomp_rows(A, Bs, 2, 5, 1e-6),
    "oblivious": lambda A, Bs: tmp._oblivious_rows(A, Bs, 4),
    "fr": lambda A, Bs: tforward._fr_rows(A, Bs),
    "sp": lambda A, Bs: ttwo._sp_rows(A, Bs, 4, maxiter=6),
    "ompr": lambda A, Bs: ttwo._ompr_rows(A, Bs, 3, 1e-12, maxiter=8),
    "srr": lambda A, Bs: ttwo._srr_rows(A, Bs, 3, maxiter=6, l=2),
    "srr init 2": lambda A, Bs: ttwo._srr_rows(A, Bs, 3, maxiter=6,
                                               initialization=2),
    "rmp delta": lambda A, Bs: tstep._rmp_rows(A, Bs, delta=1e-2,
                                               maxiter=3),
    "rmp k": lambda A, Bs: tstep._rmp_rows(A, Bs, k=3),
    "foba": lambda A, Bs: tstep._foba_rows(A, Bs, 1e-2),
    "br": lambda A, Bs: tbackward._br_rows(A[:, :24], Bs, sparsity=3),
    "fbr": lambda A, Bs: tbackward._fbr_rows(A[:, :24], Bs, sparsity=3),
    "lace": lambda A, Bs: tbackward._lace_rows(A[:, :24], Bs, sparsity=3),
}


def _fields(out):
    """The tensors of a body's result, row axis first."""
    if isinstance(out, tuple):
        return [x for part in out for x in _fields(part)]
    if isinstance(out, cstpu_torch.SparseSolution):
        return [out.idx, out.val, out.mask]
    return [out]


def _row(out, b):
    return [x[b] for x in _fields(out)]


@pytest.mark.parametrize("case", sorted(ROWS_CASES))
def test_a_row_gives_what_it_gives_alone(case):
    A, Bs = _mixed(404)
    body = ROWS_CASES[case]
    together = body(A, Bs)
    for b in range(Bs.shape[0]):
        alone = body(A, Bs[b:b + 1])
        for x, y in zip(_row(together, b), _row(alone, 0)):
            np.testing.assert_array_equal(x.numpy(), y.numpy(),
                                          err_msg=f"{case} row {b}")
    # the NaN row changes no other row: the batch without it agrees
    rest = [0, 1, 2, 3, 5]
    without = body(A, Bs[rest])
    for i, b in enumerate(rest):
        for x, y in zip(_row(together, b), _row(without, i)):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_the_mixed_rows_do_what_they_are_for():
    A, Bs = _mixed(404)
    sol = tmp._omp_rows(A, Bs, 6, 1e-6)
    k = sol.mask.sum(dim=1).tolist()
    assert k[1] == 1                 # one atom spans it: stops at step 1
    assert k[2] == 1 and k[3] == 1   # stall on atom 0 at step 2
    assert sol.idx[3, 0] == 0 and sol.val[3, 0] == 0
    assert torch.isnan(sol.val[4][sol.mask[4]]).all()
    assert torch.isfinite(sol.val[[0, 1, 2, 3, 5]]).all()


# --------------------------------------------------------------------------
# Latch reads
# --------------------------------------------------------------------------

LATCHED = ["omp max_residual", "fr", "sp", "ompr", "srr", "srr init 2",
           "rmp delta", "rmp k", "foba", "br", "fbr", "lace"]


def _counted(fn):
    for key in tutil.LOOP_COUNTS:
        tutil.LOOP_COUNTS[key] = 0
    fn()
    return dict(tutil.LOOP_COUNTS)


@pytest.mark.parametrize("case", LATCHED)
def test_latch_reads_follow_the_slowest_row(case):
    A, Bs = _mixed(405)
    body = ROWS_CASES[case]
    alone = [_counted(lambda b=b: body(A, Bs[b:b + 1]))
             for b in range(Bs.shape[0])]
    slowest = max(c["steps"] for c in alone)
    got = _counted(lambda: body(A, Bs))
    # one read a step: the loop runs as long as the slowest row, not B x
    assert got["steps"] <= slowest, (got, alone)
    assert got["latch_reads"] <= slowest + 1, (got, alone)
    assert got["latch_reads"] < sum(c["latch_reads"] for c in alone) or (
        slowest <= 1)
    # B copies of a row read the latch as often as the row alone
    copies = _counted(lambda: body(A, Bs[[0] * 8]))
    assert copies == alone[0]


@pytest.mark.parametrize("case", ["omp", "mp", "gomp fixed", "oblivious"])
def test_fixed_trip_counts_read_nothing(case):
    A, Bs = _mixed(406)
    body = {**ROWS_CASES,
            "gomp fixed": lambda A, Bs: tmp._gomp_rows(A, Bs, 2, 5)}[case]
    assert _counted(lambda: body(A, Bs))["latch_reads"] == 0


# --------------------------------------------------------------------------
# batch and the entry points
# --------------------------------------------------------------------------

def test_batch_maps_the_package_solvers_to_their_bodies(monkeypatch):
    A, Bs = _greedy(407)
    tA, tB = to_torch(A), to_torch(Bs)
    for name in ("omp", "mp", "gomp", "oblivious", "fr", "ols", "sp", "ompr",
                 "srr", "rmp", "foba", "br", "fbr", "lace", "sbl", "fsbl",
                 "rmps"):
        assert getattr(cstpu_torch, name) in tbatched._BODIES, name
    seen = []
    monkeypatch.setitem(tbatched._BODIES, tbatched.omp,
                        lambda A_, Bs_, **kw: seen.append(Bs_.shape[0])
                        or tmp._omp_rows(A_, Bs_, **kw))
    sol = tbatched.batch(tbatched.omp, k=3)(tA, tB)
    assert seen == [4] and sol.idx.shape == (4, 3)
    # any other callable runs once a row
    rows = []
    sol2 = tbatched.batch(lambda A_, b, k: rows.append(1)
                          or cstpu_torch.omp(A_, b, k), k=3)(tA, tB)
    assert rows == [1] * 4
    for x, y in zip(_fields(sol), _fields(sol2)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    # fbr's return_failed rides through batch
    A2, Bs2 = _square(408)
    sol3, failed = tbatched.batch(cstpu_torch.fbr, sparsity=3,
                                  return_failed=True)(to_torch(A2),
                                                      to_torch(Bs2))
    assert failed.shape == (3,) and sol3.idx.shape == (3, 16)


def test_fallbacks_launch_no_kernel_and_loop_no_row(monkeypatch):
    # every fallback with CUDA faked: one body call for all the rows
    A, Bs = _greedy(409, jnp.float32)
    tA, tB = to_torch(A), to_torch(Bs)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for key in tfs.LAUNCHES:
        tfs.LAUNCHES[key] = 0
    per_row = []
    for mod, name in ((tmp, "omp"), (tforward, "fr"), (ttwo, "srr")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, **kw:
                            per_row.append(1) or real(*a, **kw))
    tbatched.omp_batch(tA, tB, 3, max_residual=1e-3)
    tbatched.omp_batch(tA, tB, 3, precision="highest")
    tbatched.fr_batch(tA, tB)
    tbatched.srr_batch(tA, tB, 3, initialization=2, maxiter=3)
    assert per_row == [] and not any(tfs.LAUNCHES.values())


@pytest.mark.parametrize("rule", ["rmp_k", "rmp", "foba"])
def test_a_backward_stage_starts_from_an_exact_gram_inverse(rule,
                                                           monkeypatch):
    """Every backward step of `_stepwise_rows` sees the Gram inverse
    computed from the Gram (what `refresh_batched` gives), not the forward
    stage's bordered updates. Each row runs alone, so that a backward step
    is taken only while that row is in its backward stage."""
    from cstpu_torch.ops import active_set as tas

    A, Bs = _square(3)
    A, Bs = to_torch(A), to_torch(Bs)
    step, seen = tstep.backward_step_rows, []

    def spy(A_, Bs_, st, *a, **kw):
        seen.append(bool(torch.equal(st.Ginv,
                                     tas.refresh_batched(st).Ginv)))
        return step(A_, Bs_, st, *a, **kw)

    monkeypatch.setattr(tstep, "backward_step_rows", spy)
    for r in range(Bs.shape[0]):
        st = tstep._empty_state(A, 1)
        if rule == "rmp_k":
            tstep._stepwise_rows(A, Bs[r:r + 1], st, rule, min_k=3)
        else:
            tstep._stepwise_rows(A, Bs[r:r + 1], st, rule, 1e-3)
    assert seen and all(seen)


def test_the_backward_recompute_is_read_with_the_latch():
    """The stepwise body's recompute of Ginv adds no latch read: one a
    step, from the second on."""
    A, Bs = _square(4)
    A, Bs = to_torch(A), to_torch(Bs)
    for key in tutil.LOOP_COUNTS:
        tutil.LOOP_COUNTS[key] = 0
    tstep._rmp_rows(A, Bs, k=3)
    assert (tutil.LOOP_COUNTS["latch_reads"]
            == tutil.LOOP_COUNTS["steps"])


@pytest.mark.parametrize("slots", [5, 9, 16])
def test_naive_deltas_bounded_by_the_active_slots(slots):
    """The leave-one-out deltas over the first `slots` slots equal the full
    loop's on every row holding at most `slots` atoms."""
    from cstpu_torch.ops import active_set as tas

    A, Bs = _square(5)
    A, Bs = to_torch(A), to_torch(Bs)
    B, m = Bs.shape[0], A.shape[1]
    k = torch.tensor([5, 9, 16])[:B]
    idx = torch.arange(m, dtype=torch.int32).expand(B, m)
    mask = torch.arange(m)[None, :] < k[:, None]
    st = tas.refit_batched(tas.rebuild_batched(A, Bs, idx, mask))
    full = tbackward.backward_deltas_rows(Bs, st, m, naive=True)
    part = tbackward.backward_deltas_rows(Bs, st, m, naive=True,
                                          slots=slots)
    rows = k <= slots
    assert rows.any()
    assert torch.equal(part[rows], full[rows])


@pytest.mark.parametrize("kmax", [24, 520])
def test_refresh_inverts_the_gram_on_both_routes(kmax):
    """refresh_batched below and from TRIANGULAR_INVERSE_MIN slots (the
    cholesky_solve and the L^-T L^-1 routes): the inverse of every row's
    padded Gram, a row's result the same bits alone as in its batch."""
    from cstpu_torch.ops import active_set as tas

    gen = torch.Generator().manual_seed(kmax)
    B, n, m = 3, kmax + 8, kmax
    A = torch.randn((n, m), dtype=torch.float64, generator=gen)
    Bs = torch.randn((B, n), dtype=torch.float64, generator=gen)
    idx = torch.arange(m, dtype=torch.int32).expand(B, m)
    mask = torch.arange(m)[None, :] < torch.tensor([m, m - 5, 3])[:, None]
    st = tas.rebuild_batched(A, Bs, idx, mask)
    eye = torch.eye(kmax, dtype=torch.float64)
    Gpad = torch.where(mask[:, :, None] & mask[:, None, :], st.G, eye)
    np.testing.assert_allclose(st.Ginv.numpy(),
                               torch.linalg.inv(Gpad).numpy(),
                               rtol=1e-8, atol=1e-10)
    for b in range(B):
        one = tas.refresh_batched(tas.one_row(tas.row_of(st, b)))
        assert torch.equal(one.Ginv[0], st.Ginv[b])
