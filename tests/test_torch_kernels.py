"""The CUDA kernels of cstpu_torch (select_argmax, omp_append, mp_update,
select_topl, gomp_append, fr_select, fr_append, and the two-stage ones:
engine_init, ompr_swap, srr_append, engine_delete, sp_round) against their
plain PyTorch versions, on the card. Marked `gpu`: without a CUDA device
every test here skips.

On a GPU machine (no JAX needed, so the JAX suite's conftest is skipped):

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import pytest
import torch

from chip_smoke import planted
from cstpu_torch.ops import fused_solve as fs
from cstpu_torch.ops import fused_twostage as ft

pytestmark = pytest.mark.gpu

# f32 sums of n products in another order: scores agree to 1e-4 relative,
# indices wherever the top-two gap exceeds 1e-4 of the top score; one
# append step from identical state to 1e-4 absolute. FR's rescalings are
# differences of O(1) terms: 1e-4 absolute as well.
RTOL = 1e-4
ATOL = 1e-4
CDTS = [torch.bfloat16, torch.float32]
SIZES = [(5, 40, 300), (16, 130, 1000), (64, 1024, 8192)]  # ragged, bench


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _problem(dev, B, n, m, k, seed=0):
    return planted(torch.Generator(device=dev).manual_seed(seed), B, n, m, k)


_reduce = fs._reduce_partials


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_select_matches_plain(dev, B, n, m, cdt):
    A, Bs, _ = _problem(dev, B, n, m, 3)
    Ac = A.to(cdt)
    r = Bs + 0.01 * torch.randn(Bs.shape, device=dev,
                                generator=torch.Generator(dev).manual_seed(1))
    kv, ki = fs.select_argmax(r, Ac)
    pv, pi = fs._select_ref(r, Ac.float(), cdt)
    assert kv.shape == pv.shape == (B, -(-m // fs.TILE))
    torch.testing.assert_close(kv, pv, rtol=RTOL, atol=1e-6)
    scores = torch.abs(r.to(cdt).float() @ Ac.float())
    vals, idx = _reduce(kv, ki)
    top2 = scores.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > RTOL * top2[:, 0]
    assert bool(((idx == _reduce(pv, pi)[1]) | ~clear).all())


@pytest.mark.parametrize("cdt", CDTS)
def test_select_tie_nan_and_edge_tile(dev, cdt):
    B, n, m = 4, 64, 1000                  # last tile holds 104 atoms
    A, Bs, _ = _problem(dev, B, n, m, 3)
    Ac = A.to(cdt)
    Ac[:, 997] = Ac[:, 40]                 # tie across tiles
    Ac[:, 999] = Ac[:, 998]                # tie inside the edge tile
    r = Bs.clone()
    r[0] = Ac[:, 40].float()
    r[1, 7] = float("nan")
    r[2] = Ac[:, 998].float()
    pv, pi = fs.select_argmax(r, Ac)
    v, i = _reduce(pv, pi)
    assert i[:3].tolist() == [40, fs.INT_MAX, 998]
    assert torch.isnan(v[1]) and torch.isnan(pv[1]).all()
    rv, ri = fs._select_ref(r, Ac.float(), cdt)
    assert torch.equal(pi[[0, 2]], ri[[0, 2]])
    assert torch.equal(pi[1], ri[1])


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_append_matches_plain_every_step(dev, B, n, m, cdt):
    k = min(8, n)
    A, Bs, _ = _problem(dev, B, n, m, 4)
    Ac = A.to(cdt).contiguous()
    Ac32 = Ac.float()
    st, *out = fs._init_state(Bs, k, m)
    for t in range(k):
        parts = fs._select_ref(st.r, Ac32, cdt)
        stk = fs._OmpState(*(x.clone() for x in st))
        outk = [x.clone() for x in out]
        fs.omp_append(*parts, Ac, Bs, stk, t, *outk)
        fs._append_ref(*parts, Ac32, Bs, st, t, *out)
        torch.cuda.synchronize()
        assert torch.equal(stk.idx, st.idx), t
        for a, b in ((stk.Ginv, st.Ginv), (stk.coef, st.coef),
                     (stk.r, st.r), (stk.cols, st.cols)):
            torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
    assert torch.equal(outk[0], out[0])
    torch.testing.assert_close(outk[1], out[1], rtol=0, atol=ATOL)


def test_append_nan_row_masks_out(dev):
    A, Bs, _ = _problem(dev, 3, 64, 512, 3)
    Bs[0, 0] = float("nan")
    sol, _ = fs.omp_fused_solve(A, Bs, 3)
    ref, _ = fs.omp_fused_solve_ref(A, Bs, 3)
    assert not sol.mask[0].any() and torch.equal(sol.idx, ref.idx)
    assert torch.equal(sol.mask, ref.mask)


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_solve_matches_plain_and_recovers(dev, B, n, m, cdt):
    k = 3 if n < 100 else 8
    A, Bs, sup = _problem(dev, B, n, m, k)
    before = dict(fs.LAUNCHES)
    sol, r = fs.omp_fused_solve(A, Bs, k, corr_dtype=cdt)
    ref, rr = fs.omp_fused_solve_ref(A, Bs, k, corr_dtype=cdt)
    assert fs.LAUNCHES["select"] - before["select"] == k
    assert fs.LAUNCHES["append"] - before["append"] == k
    assert torch.equal(sol.idx, ref.idx) and torch.equal(sol.mask, ref.mask)
    torch.testing.assert_close(sol.val, ref.val, rtol=0, atol=1e-3)
    torch.testing.assert_close(r, rr, rtol=0, atol=1e-3)
    got = torch.where(sol.mask, sol.idx, m).sort(1).values
    assert torch.equal(got[:, :k].long(), sup.sort(1).values)


def test_wrappers_reject_bad_cuda_inputs(dev):
    A, Bs, _ = _problem(dev, 4, 32, 256, 2)
    with pytest.raises(ValueError):
        fs.select_argmax(Bs.double(), A.to(torch.bfloat16))
    with pytest.raises(ValueError):
        fs.select_argmax(Bs, A.to(torch.bfloat16).T)     # not contiguous
    with pytest.raises(ValueError):
        fs.select_argmax(Bs, A.cpu().to(torch.bfloat16))  # other device
    st, *out = fs._init_state(Bs, fs.KMAX + 1, 256)
    parts = fs.select_argmax(Bs, A.to(torch.bfloat16))
    with pytest.raises(ValueError):
        fs.omp_append(*parts, A.to(torch.bfloat16), Bs, st, 0, *out)


# --------------------------------------------------------------------------
# MP, GOMP and FR kernels
# --------------------------------------------------------------------------

def _clear(scores, rel=RTOL):
    """Rows (B,) whose top-two scores differ by more than rel * top."""
    top2 = scores.topk(2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) > rel * top2[:, 0].abs()


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_signed_select_and_mp_update_match_plain(dev, B, n, m, cdt):
    A, Bs, _ = _problem(dev, B, n, m, 3)
    Ac = A.to(cdt).contiguous()
    r = Bs.clone()
    r[0, 1] = float("nan")
    pv, pi, ps = fs.select_argmax(r, Ac, signed=True)
    pv0, pi0 = fs.select_argmax(r, Ac)
    torch.cuda.synchronize()
    # the signed variant leaves OMP's partials as they are, bit for bit
    assert torch.equal(pv.nan_to_num(-1.0), pv0.nan_to_num(-1.0))
    assert torch.equal(pi, pi0)
    rv, ri, rs = fs._select_ref(r, Ac.float(), cdt, signed=True)
    clear = _clear(torch.abs(r.to(cdt).float() @ Ac.float()))
    i, ri_ = _reduce(pv, pi)[1], _reduce(rv, ri)[1]
    assert int(i[0]) == fs.INT_MAX == int(ri_[0])
    assert bool(((i == ri_) | ~clear)[1:].all())
    same = (pi == ri) & ~torch.isnan(pv)
    assert torch.isnan(ps[0]).all() and torch.isnan(rs[0]).all()
    torch.testing.assert_close(ps[same], rs[same], rtol=RTOL, atol=1e-6)
    assert bool((ps.abs()[same] == pv[same]).all())
    x, xr = torch.zeros((B, m), device=dev), torch.zeros((B, m), device=dev)
    rk, rr = r.clone(), r.clone()
    fs.mp_update(pv, pi, ps, Ac, x, rk)
    fs._mp_update_ref(pv, pi, ps, Ac.float(), xr, rr)
    torch.cuda.synchronize()
    assert torch.equal(x, xr) and not x[0].any()
    torch.testing.assert_close(rk, rr, rtol=0, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
@pytest.mark.parametrize("l", [1, 4, fs.LMAX])
def test_select_topl_matches_plain(dev, B, n, m, cdt, l):
    A, Bs, _ = _problem(dev, B, n, m, 3)
    Ac = A.to(cdt).contiguous()
    r = Bs + 0.01 * torch.randn(Bs.shape, device=dev,
                                generator=torch.Generator(dev).manual_seed(2))
    kv, ki = fs.select_topl(r, Ac, l)
    pv, pi = fs._topl_ref(r, Ac.float(), cdt, l)
    torch.cuda.synchronize()
    assert kv.shape == pv.shape == (B, -(-m // fs.TILE), l)
    fin = torch.isfinite(pv)
    assert torch.equal(torch.isfinite(kv), fin)
    torch.testing.assert_close(kv[fin], pv[fin], rtol=RTOL, atol=1e-6)
    # indices wherever a pick's value is clear of its neighbours'
    gap = torch.full_like(pv, torch.inf)
    d = (pv[..., 1:] - pv[..., :-1]).abs()
    gap[..., 1:] = d
    gap[..., :-1] = torch.minimum(gap[..., :-1], d)
    clear = ~fin | (gap.nan_to_num(torch.inf) > RTOL * pv.abs())
    assert bool(((ki == pi) | ~clear).all())


@pytest.mark.parametrize("cdt", CDTS)
def test_select_topl_tie_nan_and_edge_tile(dev, cdt):
    B, n, m, l = 4, 64, 1000, 4            # last tile holds 104 atoms
    A, Bs, _ = _problem(dev, B, n, m, 3)
    Ac = A.to(cdt)
    Ac[:, 997] = Ac[:, 40]
    r = Bs.clone()
    r[0] = Ac[:, 40].float()
    r[1, 7] = float("nan")
    kv, ki = fs.select_topl(r, Ac, l)
    pv, pi = fs._topl_ref(r, Ac.float(), cdt, l)
    torch.cuda.synchronize()
    assert int(ki[0, 0, 0]) == 40 and int(ki[0, 7, 0]) == 997
    assert (ki[1] == fs.INT_MAX).all() and torch.isnan(kv[1]).all()
    assert torch.equal(ki[:2], pi[:2])
    picks = fs._merge_topl(kv, ki, l)
    assert picks[0, :2].tolist() == [40, 997]
    assert (picks[1] == fs.INT_MAX).all()
    # a tile with fewer than l live atoms pads with (-inf, INT_MAX)
    _, k1 = fs.select_topl(r[:1], Ac[:, :2].contiguous(), l)
    assert k1[0, 0, 2:].tolist() == [fs.INT_MAX] * (l - 2)


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_gomp_append_matches_plain_every_iteration(dev, B, n, m, cdt):
    l, k = 3, min(8, n)
    A, Bs, _ = _problem(dev, B, n, m, 4)
    Bs[0, 0] = float("nan")
    Ac = A.to(cdt).contiguous()
    Ac32 = Ac.float()
    st = fs._init_gomp(Bs, k, m)
    for cnt in [l] * (k // l) + [k % l]:
        parts = fs._topl_ref(st.r, Ac32, cdt, cnt)
        stk = fs._GompState(*(x.clone() for x in st))
        fs.gomp_append(*parts, Ac, Bs, stk, min(n, k), 0.0)
        fs._gomp_append_ref(*parts, Ac32, Bs, st, min(n, k), 0.0)
        torch.cuda.synchronize()
        for a, b in ((stk.idx, st.idx), (stk.kcnt, st.kcnt),
                     (stk.done, st.done)):
            assert torch.equal(a, b), cnt
        for a, b in ((stk.Ginv, st.Ginv), (stk.coef, st.coef),
                     (stk.r, st.r), (stk.cols, st.cols)):
            torch.testing.assert_close(a[1:], b[1:], rtol=0, atol=ATOL)
    assert not (fs._sorted_solution(stk.idx, stk.coef, m).mask[0]).any()


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_fr_kernels_match_plain_every_step(dev, B, n, m, cdt):
    # k = the planted count: every step's pick has a clear margin
    k = 4
    A, Bs, _ = _problem(dev, B, n, m, k)
    Bs[0, 0] = float("nan")
    Ac = A.to(cdt).contiguous()
    Ac32 = Ac.float()
    cn2 = torch.sum(A * A, dim=0)
    st = fs._init_fr(Bs, k, cn2)
    for t in range(k):
        stk = fs._FrState(*(x.clone() for x in st))
        kv, ki = fs.fr_select(Ac, cn2, stk)
        pv, pi = fs._fr_select_ref(Ac32, cn2, st, cdt)
        torch.cuda.synchronize()
        torch.testing.assert_close(stk.resc, st.resc, rtol=0, atol=ATOL)
        torch.testing.assert_close(kv[1:], pv[1:], rtol=RTOL, atol=1e-6)
        assert bool(torch.isnan(kv[0]).all()) and (ki[0] == fs.INT_MAX).all()
        assert torch.equal(_reduce(kv, ki)[1], _reduce(pv, pi)[1]), t
        # both appends from the kernel's partials
        fs.fr_append(kv, ki, Ac, Bs, stk, t, 0.0, 0.0)
        fs._fr_append_ref(kv, ki, Ac32, Bs, st, t, 0.0, 0.0)
        torch.cuda.synchronize()
        for a, b in ((stk.idx, st.idx), (stk.done, st.done),
                     (stk.amask, st.amask)):
            assert torch.equal(a, b), t
        for a, b in ((stk.Ginv, st.Ginv), (stk.coef, st.coef),
                     (stk.r, st.r), (stk.cols, st.cols),
                     (stk.aperp, st.aperp), (stk.dinv, st.dinv)):
            torch.testing.assert_close(a[1:], b[1:], rtol=0, atol=ATOL)
    assert float(st.done[0]) == 1.0 and not st.done[1:].any()


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_greedy_solves_match_plain_and_recover(dev, B, n, m, cdt):
    k = 3 if n < 100 else 8
    A, Bs, sup = _problem(dev, B, n, m, k)
    want = sup.sort(1).values

    def launches(fn):
        before = dict(fs.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        return out, {key: fs.LAUNCHES[key] - before[key] for key in before}

    (x, r), got = launches(lambda: fs.mp_fused_solve(A, Bs, k, cdt))
    assert got["select"] == got["mp_update"] == k
    xr, rr = fs.mp_fused_solve_ref(A, Bs, k, cdt)
    torch.testing.assert_close(x, xr, rtol=0, atol=1e-3)
    torch.testing.assert_close(r, rr, rtol=0, atol=1e-3)
    for solve, ref, key in (
            (lambda: fs.gomp_fused_solve(A, Bs, 2, k, corr_dtype=cdt),
             lambda: fs.gomp_fused_solve_ref(A, Bs, 2, k, corr_dtype=cdt),
             ("select_topl", "gomp_append", -(-k // 2))),
            (lambda: fs.fr_fused_solve(A, Bs, k, corr_dtype=cdt),
             lambda: fs.fr_fused_solve_ref(A, Bs, k, corr_dtype=cdt),
             ("fr_select", "fr_append", k))):
        (sol, _), got = launches(solve)
        assert got[key[0]] == got[key[1]] == key[2], got
        refsol, _ = ref()
        assert torch.equal(sol.idx, refsol.idx)
        assert torch.equal(sol.mask, refsol.mask)
        torch.testing.assert_close(sol.val, refsol.val, rtol=0, atol=1e-3)
        if n >= 1000:  # at the small sizes greedy picks may miss an atom
            have = torch.where(sol.mask, sol.idx, m).sort(1).values
            assert torch.equal(have[:, :k].long(), want)


def test_greedy_wrappers_reject_bad_cuda_inputs(dev):
    A, Bs, _ = _problem(dev, 4, 32, 256, 2)
    Ac = A.to(torch.bfloat16)
    with pytest.raises(ValueError):
        fs.select_topl(Bs, Ac, fs.LMAX + 1)
    with pytest.raises(ValueError):
        fs.select_topl(Bs.double(), Ac, 2)
    pv, pi = fs.select_topl(Bs, Ac, 2)
    st = fs._init_gomp(Bs, 4, 256)
    with pytest.raises(ValueError):
        fs.gomp_append(pv, pi, Ac, Bs.cpu(), st, 4, 0.0)
    cn2 = torch.sum(A * A, dim=0)
    st = fs._init_fr(Bs, 4, cn2)
    with pytest.raises(ValueError):
        fs.fr_select(Ac, cn2.double(), st)
    pv, pi, ps = fs.select_argmax(Bs, Ac, signed=True)
    with pytest.raises(ValueError):
        fs.mp_update(pv, pi, ps, Ac, torch.zeros((4, 255), device=dev), Bs)


# --------------------------------------------------------------------------
# Two-stage kernels: the masked select, the pending-term select, the slot
# engine (engine_init, ompr_swap, srr_append, engine_delete) and sp_round
# --------------------------------------------------------------------------

STATE_ATOL = 1e-4    # one engine step from identical state, as ATOL
# The latch `prev <= ||r||^2` compares two residual norms of one support
# when a swap re-adds and drops the same atom: a tie up to rounding, which
# the kernel and the plain version may break differently (so may cstpu's
# TPU and interpret runs). `done` is held equal where the norm moved by
# more than LATCH_RTOL.
LATCH_RTOL = 1e-5
EXACT = ("idx", "amask")
LATCHED = ("done", "fgate")    # SRR's forward gate is `not done`


def _clone(st):
    return type(st)(*(None if x is None else x.clone() for x in st))


def _same_state(stk, st, rows=None, prev0=None):
    """Exact fields equal, the rest within STATE_ATOL (on `rows`); `done`
    equal where the residual norm moved clearly from prev0 (everywhere
    without it)."""
    sel = slice(None) if rows is None else rows
    clear = torch.ones_like(st.done, dtype=torch.bool)
    if prev0 is not None:
        clear = (st.prev - prev0).abs() > LATCH_RTOL * prev0.abs()
    for name, a, b in zip(st._fields, stk, st):
        if a is None or name.startswith("pend"):
            continue
        if name in LATCHED:
            assert torch.equal(a[sel][clear[sel]], b[sel][clear[sel]]), name
            continue
        if name in EXACT:
            assert torch.equal(a[sel], b[sel]), name
        else:
            torch.testing.assert_close(a[sel], b[sel], rtol=0, atol=STATE_ATOL,
                                       equal_nan=True, msg=name)


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_masked_select_matches_plain(dev, B, n, m, cdt):
    A, Bs, _ = _problem(dev, B, n, m, 3)
    Ac = A.to(cdt).contiguous()
    gen = torch.Generator(dev).manual_seed(3)
    amask = (torch.rand((B, m), device=dev, generator=gen) < 0.3).to(torch.uint8)
    amask[0] = 1                                   # everything masked
    kv, ki = fs.select_argmax(Bs, Ac, amask=amask, eta=0.5)
    pv, pi = fs._select_ref(Bs, Ac.float(), cdt, False, amask, 0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(kv, pv, rtol=RTOL, atol=1e-6)
    assert float(_reduce(kv, ki)[0][0]) == -torch.inf
    assert int(_reduce(kv, ki)[1][0]) == 0         # the TPU argmax's index
    scores = torch.where(amask.bool(), -torch.inf,
                         torch.abs(0.5 * (Bs.to(cdt).float() @ Ac.float())))
    clear = _clear(scores[1:])
    assert bool(((_reduce(kv, ki)[1] == _reduce(pv, pi)[1])[1:] | ~clear).all())
    # nothing masked and eta = 1: OMP's partials, bit for bit
    zero = torch.zeros_like(amask)
    mv, mi = fs.select_argmax(Bs, Ac, amask=zero)
    ov, oi = fs.select_argmax(Bs, Ac)
    torch.cuda.synchronize()
    assert torch.equal(mv, ov) and torch.equal(mi, oi)


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_rescaled_select_pending_terms_match_plain(dev, B, n, m, cdt):
    A, Bs, _ = _problem(dev, B, n, m, 3)
    Ac = A.to(cdt).contiguous()
    cn2 = torch.sum(A * A, dim=0)
    gen = torch.Generator(dev).manual_seed(4)
    U = 0.1 * torch.randn((3, B, n), device=dev, generator=gen)
    W = torch.tensor([-0.5, 0.25, -0.125], device=dev)[:, None].repeat(1, B)
    amask = torch.zeros((B, m), dtype=torch.uint8, device=dev)
    amask[:, 7] = 1
    resc = cn2[None].repeat(B, 1)
    rk = resc.clone()
    kv, ki = fs.rescaled_select(Ac, cn2, Bs, U, W, 1.0, amask, rk)
    pv, pi = fs._rescaled_select_ref(Ac, cn2, Bs, U, W, 1.0, amask, resc, cdt)
    torch.cuda.synchronize()
    torch.testing.assert_close(rk, resc, rtol=0, atol=ATOL)
    torch.testing.assert_close(kv, pv, rtol=RTOL, atol=1e-6)
    assert bool((kv >= 0).all())                   # active atom 7 scores 0
    # FR's one-term form, and the same with a zero second term: bit for bit
    r1, r2 = cn2[None].repeat(B, 1), cn2[None].repeat(B, 1)
    one = fs.rescaled_select(Ac, cn2, Bs, U[:1], W[:1], -1.0, amask, r1)
    U2, W2 = U[:2].clone(), W[:2].clone()
    U2[1], W2[1] = 0.0, 0.0
    two = fs.rescaled_select(Ac, cn2, Bs, U2, W2, -1.0, amask, r2)
    torch.cuda.synchronize()
    assert torch.equal(r1, r2) and all(map(torch.equal, one, two))


def _noisy(dev, B, n, m, k):
    """A planted problem with noise of norm ~0.02 sqrt(n) on rows 1.. (so
    residual norms stay above rounding) and a NaN in row 0."""
    A, Bs, _ = _problem(dev, B, n, m, k)
    Bs[1:] += 0.02 * torch.randn(Bs[1:].shape, device=dev,
                                 generator=torch.Generator(dev).manual_seed(5))
    Bs[0, 0] = float("nan")
    return A, Bs


def _ompr_setup(dev, B, n, m, k, cdt):
    A, Bs = _noisy(dev, B, n, m, k)
    Ac = A.to(cdt).contiguous()
    return Ac, Ac.float(), Bs


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_ompr_kernels_match_plain_every_iteration(dev, B, n, m, cdt):
    k = 4
    Ac, Ac32, Bs = _ompr_setup(dev, B, n, m, k, cdt)
    st = ft._init_engine(Bs, k + 1, m)
    stk = _clone(st)
    parts = fs._topl_ref(Bs, Ac32, cdt, k)
    ft.engine_init(*parts, Ac, Bs, stk)
    ft._engine_init_ref(*parts, Ac32, Bs, st)
    torch.cuda.synchronize()
    _same_state(stk, st, slice(1, None))
    assert torch.equal(stk.idx[0], st.idx[0]) and not (stk.idx[0] < m).any()
    for t in range(4):
        parts = fs._select_ref(st.r, Ac32, cdt, False, st.amask, 1.0)
        stk, prev0 = _clone(st), st.prev.clone()
        ft.ompr_swap(*parts, Ac, Bs, stk, 1.0, 0.0)
        ft._ompr_swap_ref(*parts, Ac32, Bs, st, 1.0, 0.0)
        torch.cuda.synchronize()
        _same_state(stk, st, slice(1, None), prev0)
        assert float(stk.done[0]) == float(st.done[0]) == 1.0, t
    # a done row is left exactly as it was
    st.done[1] = 1.0
    before = _clone(st)
    ft.ompr_swap(*fs._select_ref(st.r, Ac32, cdt, False, st.amask, 1.0),
                 Ac, Bs, st, 1.0, 0.0)
    torch.cuda.synchronize()
    for a, b in zip(st, before):
        if a is not None:
            assert torch.equal(a[1].nan_to_num(), b[1].nan_to_num())


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
@pytest.mark.parametrize("l", [1, 2])
def test_srr_kernels_match_plain_every_step(dev, B, n, m, cdt, l):
    k = 3
    Ac, Ac32, Bs = _ompr_setup(dev, B, n, m, k, cdt)
    cn2 = torch.sum(Ac32 * Ac32, dim=0)
    st = ft._init_engine(Bs, k + l, m, cn2, npend=max(k, l + 1))
    stk = _clone(st)
    parts = fs._topl_ref(Bs, Ac32, cdt, k)
    ft.engine_init(*parts, Ac, Bs, stk)
    ft._engine_init_ref(*parts, Ac32, Bs, st)
    torch.cuda.synchronize()
    _same_state(stk, st, slice(1, None))
    torch.testing.assert_close(stk.pend_u[:, 1:], st.pend_u[:, 1:], rtol=0,
                               atol=STATE_ATOL)
    npend = k
    for it in range(3):
        for _ in range(l):
            stk = _clone(st)
            kv, ki = fs.rescaled_select(Ac, cn2, stk.r, stk.pend_u[:npend],
                                        stk.pend_w[:npend], 1.0, stk.amask,
                                        stk.resc)
            pv, pi = fs._rescaled_select_ref(Ac32, cn2, st.r, st.pend_u[:npend],
                                             st.pend_w[:npend], 1.0, st.amask,
                                             st.resc, cdt)
            torch.cuda.synchronize()
            torch.testing.assert_close(stk.resc[1:], st.resc[1:], rtol=0,
                                       atol=ATOL)
            assert torch.equal(_reduce(kv, ki)[1][1:], _reduce(pv, pi)[1][1:])
            ft.srr_append(kv, ki, Ac, Bs, stk)
            ft._srr_append_ref(kv, ki, Ac32, Bs, st)
            torch.cuda.synchronize()
            _same_state(stk, st, slice(1, None))
            npend = 1
        stk, prev0 = _clone(st), st.prev.clone()
        ft.engine_delete(Bs, stk, k, l, 0.0)
        ft._engine_delete_ref(Bs, st, k, l, 0.0)
        torch.cuda.synchronize()
        _same_state(stk, st, slice(1, None), prev0)
        torch.testing.assert_close(stk.pend_w[:l + 1, 1:], st.pend_w[:l + 1, 1:],
                                   rtol=0, atol=STATE_ATOL)
        npend = l + 1
        assert float(stk.done[0]) == 0.0, it  # a NaN row never latches (cstpu)


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_sp_round_matches_plain_every_round(dev, B, n, m, cdt):
    k = 4 if n < 100 else 8
    A, Bs = _noisy(dev, B, n, m, k)
    Ac = A.to(cdt).contiguous()
    Ac32 = Ac.float()
    st = ft._SpState(
        cols=torch.zeros((B, 2 * k, n), device=dev),
        Ginv=torch.eye(k, device=dev).repeat(B, 1, 1),
        coef=torch.zeros((B, 2 * k), device=dev),
        idx=torch.full((B, 2 * k), m, dtype=torch.int32, device=dev),
        Atb=torch.zeros((B, 2 * k), device=dev), r=Bs.clone(),
        done=torch.zeros((B,), device=dev), prev=torch.zeros((B,), device=dev))
    for t in range(4):
        parts = fs._topl_ref(st.r, Ac32, cdt, k)
        stk, prev0 = _clone(st), st.prev.clone()
        ft.sp_round(*parts, Ac, Bs, stk, 0.0, t == 0)
        ft._sp_round_ref(*parts, Ac32, Bs, st, 0.0, t == 0)
        torch.cuda.synchronize()
        _same_state(stk, st, slice(1, None), None if t == 0 else prev0)
        assert torch.equal(stk.idx[0], st.idx[0])
        assert float(stk.done[0]) == float(st.done[0])
    assert float(st.done[0]) == 1.0                # the NaN row latched


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_twostage_solves_match_plain_and_recover(dev, B, n, m, cdt):
    k = 3 if n < 100 else 8
    A, Bs, sup = _problem(dev, B, n, m, k)
    want = sup.sort(1).values

    def launches(fn):
        before = dict(fs.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        return out, {key: fs.LAUNCHES[key] - before[key] for key in before
                     if fs.LAUNCHES[key] != before[key]}

    (sol, _, it), got = launches(lambda: ft.sp_fused_solve(
        A, Bs, k, maxiter=8, corr_dtype=cdt, return_iters=True))
    assert got == {"select_topl": 1 + it, "sp_round": 1 + it}, got
    ref, _, it_ref = ft.sp_fused_solve_ref(A, Bs, k, maxiter=8, corr_dtype=cdt,
                                           return_iters=True)
    solves = [(sol, ref)]
    (sol, _, it), got = launches(lambda: ft.ompr_fused_solve(
        A, Bs, k, 1e-6, corr_dtype=cdt, return_iters=True))
    assert got == {"select_topl": 1, "engine_init": 1, "select": it,
                   "ompr_swap": it}, got
    solves.append((sol, ft.ompr_fused_solve_ref(A, Bs, k, 1e-6,
                                                corr_dtype=cdt)[0]))
    (sol, _, it), got = launches(lambda: ft.srr_fused_solve(
        A, Bs, k, maxiter=4, corr_dtype=cdt, return_iters=True))
    assert got == {"select_topl": 1, "engine_init": 1, "fr_select": it,
                   "srr_append": it, "engine_delete": it}, got
    solves.append((sol, ft.srr_fused_solve_ref(A, Bs, k, maxiter=4,
                                               corr_dtype=cdt)[0]))
    for sol, ref in solves:
        assert torch.equal(sol.idx, ref.idx) and torch.equal(sol.mask, ref.mask)
        torch.testing.assert_close(sol.val, ref.val, rtol=0, atol=1e-3)
        if n >= 1000:
            have = torch.where(sol.mask, sol.idx, m).sort(1).values
            assert torch.equal(have[:, :k].long(), want)


def test_twostage_wrappers_reject_bad_cuda_inputs(dev):
    A, Bs, _ = _problem(dev, 4, 32, 256, 2)
    Ac = A.to(torch.bfloat16)
    with pytest.raises(ValueError):
        fs.select_argmax(Bs, Ac, signed=True,
                         amask=torch.zeros((4, 256), dtype=torch.uint8,
                                           device=dev))
    with pytest.raises(ValueError):
        fs.select_argmax(Bs, Ac, amask=torch.zeros((4, 255), dtype=torch.uint8,
                                                   device=dev))
    st = ft._init_engine(Bs, 3, 256)
    pv, pi = fs.select_topl(Bs, Ac, 2)
    with pytest.raises(ValueError):
        ft.engine_init(pv, pi, Ac, Bs.cpu(), st)
    with pytest.raises(ValueError):
        ft.srr_append(*fs.select_argmax(Bs, Ac), Ac, Bs, st)  # no SRR state
    with pytest.raises(ValueError):
        ft.sp_round(pv, pi, Ac, Bs, ft._SpState(*(
            torch.zeros(1, device=dev) for _ in ft._SpState._fields)), 0.0,
            True)
