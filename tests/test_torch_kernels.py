"""The CUDA kernels of cstpu_torch (select_argmax, omp_append, mp_update,
select_topl, gomp_append, fr_select, fr_append) against their plain PyTorch
versions, on the card. Marked `gpu`: without a CUDA device every test here
skips.

On a GPU machine (no JAX needed, so the JAX suite's conftest is skipped):

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import pytest
import torch

from chip_smoke import planted
from cstpu_torch.ops import fused_solve as fs

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
