"""The CUDA kernels of cstpu_torch (select_argmax in its tensor-core and
CUDA-core variants, the CUDA-core loop of select_argmax, fr_select,
select_topl and fr_step_select over chip_smoke.SIMT_CASES, omp_append,
mp_update,
select_topl (tensor-core and CUDA-core variants), gomp_append, fr_select
(tensor-core and CUDA-core variants),
fr_append, the two-stage ones:
engine_init, ompr_swap, srr_append, engine_delete, sp_round, the stepwise
ones: rmp_append, engine_backward (both also in a grid of their own,
DELETE_CASES), the backward family's: bw_select,
bw_downdate, and the streaming selects of the sharded solvers:
stream_select.cu's top-1, masked top-1 and (n, B) argmax (each on the
tensor-core and the CUDA-core sweep), its top-l (both sweeps, the
CUDA-core one also over chip_smoke.SIMT_CASES, and the finish, past 128
slots too), and
fr_step_select.cu's rescaling update with its OLS select, in both
variants) against their
plain PyTorch versions, on the card. Marked `gpu`: without a CUDA
device every test here skips.

On a GPU machine (no JAX needed, so the JAX suite's conftest is skipped):

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import pytest
import torch

import chip_smoke
from chip_smoke import planted
from cstpu_torch.ops import corr_argmax as ca
from cstpu_torch.ops import fused_backward as fb
from cstpu_torch.ops import fused_solve as fs
from cstpu_torch.ops import fused_twostage as ft
from cstpu_torch.ops import stream_select as ss

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


def _share(cases, B, n, m):
    """The share of a grid of chip_smoke's (`cases`) that the SIZES entry
    (B, n, m) holds: the parametrisations of a test over SIZES hold the
    whole grid between them."""
    return cases[SIZES.index((B, n, m))::len(SIZES)]


def _key(name, A):
    """The launch-count key of the select `name` on the dictionary (view) A:
    the tensor-core variant's where the predicate takes A."""
    return name + "_mma" if fs._pick_mma(None, A) else name


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
    key = _key("select", A.to(cdt))
    assert key == ("select_mma" if cdt == torch.bfloat16 and m % 8 == 0
                   else "select")
    assert fs.LAUNCHES[key] - before[key] == k
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
    # bit for bit: the kernel rounds each product and difference as the twin
    torch.testing.assert_close(rk, rr, rtol=0, atol=0, equal_nan=True)
    # mp_update (B C blocks a row) over this entry's share of
    # chip_smoke.MP_CASES: chained steps of the signed select and the
    # update, a NaN row, a tie across tiles, x and r bit for bit
    for B2, n2 in _share(chip_smoke.MP_CASES, B, n, m):
        chip_smoke.hold_mp_update(dev, B2, n2, cdt)


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
    # gomp_append (a thread-block cluster per row) over this entry's share
    # of chip_smoke.GOMP_CASES: a NaN row, a duplicate pick, the rtol gate,
    # a done row, the eps latch, the remainder iteration
    for B2, n2, k2, cnt in _share(chip_smoke.GOMP_CASES, B, n, m):
        err, plan = chip_smoke.hold_gomp_append(dev, B2, n2, k2, cnt, cdt)
        assert err <= chip_smoke.APPEND_ATOL, (B2, n2, k2, cnt, plan, err)


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
    assert got[_key("select", A.to(cdt))] == got["mp_update"] == k
    xr, rr = fs.mp_fused_solve_ref(A, Bs, k, cdt)
    torch.testing.assert_close(x, xr, rtol=0, atol=1e-3)
    torch.testing.assert_close(r, rr, rtol=0, atol=1e-3)
    for solve, ref, key in (
            (lambda: fs.gomp_fused_solve(A, Bs, 2, k, corr_dtype=cdt),
             lambda: fs.gomp_fused_solve_ref(A, Bs, 2, k, corr_dtype=cdt),
             (_key("select_topl", A.to(cdt)), "gomp_append", -(-k // 2))),
            (lambda: fs.fr_fused_solve(A, Bs, k, corr_dtype=cdt),
             lambda: fs.fr_fused_solve_ref(A, Bs, k, corr_dtype=cdt),
             (_key("fr_select", A.to(cdt)), "fr_append", k))):
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


def _grid_share(B, n, m, parts=1, part=0):
    """The share of chip_smoke.ENGINE_CASES (the slot engine's cluster
    kernels' grid) that the SIZES entry (B, n, m) holds, split again into
    `parts`: the parametrisations of a test hold the whole grid between
    them."""
    return _share(chip_smoke.ENGINE_CASES, B, n, m)[part::parts]


def _hold_init_grid(dev, cases, cdt, srr):
    for B2, n2, K2 in cases:
        for cnt in chip_smoke.engine_cnts(K2):
            err, plan = chip_smoke.hold_engine_init(dev, B2, n2, K2, cnt,
                                                    cdt, srr)
            assert err <= chip_smoke.APPEND_ATOL, (B2, n2, K2, cnt, plan, err)


def _hold_rmp_grid(dev, cases, cdt, mode):
    for B2, n2, K2 in cases:
        err, plan, _ = chip_smoke.hold_rmp_append(dev, B2, n2, K2, cdt, mode)
        assert err <= chip_smoke.APPEND_ATOL, (B2, n2, K2, mode, plan, err)


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
    # engine_init (a thread-block cluster per row) over this entry's share
    # of the grid: a NaN row, a duplicate pick, the rtol gate
    _hold_init_grid(dev, _grid_share(B, n, m), cdt, False)
    # ompr_swap (a thread-block cluster per row) over this entry's share of
    # chip_smoke.SWAP_CASES: a NaN row, a duplicate pick, the rtol gate, a
    # done row, change false, an appended atom deleted at once
    for B2, n2, K2 in _share(chip_smoke.SWAP_CASES, B, n, m):
        err, plan = chip_smoke.hold_ompr_swap(dev, B2, n2, K2, cdt)
        assert err <= chip_smoke.APPEND_ATOL, (B2, n2, K2, plan, err)


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
    # engine_init with SRR's pending terms over this entry's share of the
    # grid, halved between l = 1 and 2
    _hold_init_grid(dev, _grid_share(B, n, m, 2, l - 1), cdt, True)
    # srr_append (a thread-block cluster per row) over this entry's share of
    # chip_smoke.SRR_CASES, halved the same way: a NaN row, a done row, a
    # shut forward gate, a duplicate pick, the rtol twin, a full state
    for B2, n2, K2, l2 in _share(chip_smoke.SRR_CASES, B, n, m)[l - 1::2]:
        err, plan = chip_smoke.hold_srr_append(dev, B2, n2, K2, l2, cdt)
        assert err <= chip_smoke.APPEND_ATOL, (B2, n2, K2, l2, plan, err)


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
    assert got == {_key("select_topl", A.to(cdt)): 1 + it,
                   "sp_round": 1 + it}, got
    ref, _, it_ref = ft.sp_fused_solve_ref(A, Bs, k, maxiter=8, corr_dtype=cdt,
                                           return_iters=True)
    solves = [(sol, ref)]
    (sol, _, it), got = launches(lambda: ft.ompr_fused_solve(
        A, Bs, k, 1e-6, corr_dtype=cdt, return_iters=True))
    assert got == {_key("select_topl", A.to(cdt)): 1, "engine_init": 1,
                   _key("select", A.to(cdt)): it,
                   "ompr_swap": it}, got
    solves.append((sol, ft.ompr_fused_solve_ref(A, Bs, k, 1e-6,
                                                corr_dtype=cdt)[0]))
    (sol, _, it), got = launches(lambda: ft.srr_fused_solve(
        A, Bs, k, maxiter=4, corr_dtype=cdt, return_iters=True))
    assert got == {_key("select_topl", A.to(cdt)): 1, "engine_init": 1,
                   _key("fr_select", A.to(cdt)): it,
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


# --------------------------------------------------------------------------
# Stepwise kernels (RMP, FoBa): rmp_append and engine_backward
# --------------------------------------------------------------------------

def _stepwise_setup(dev, B, n, m, k, K, cdt):
    """(Ac, Ac32, Bs, cn2, floor2, state): a noisy planted problem with a
    NaN row 0 and the empty K-slot RMP state."""
    Ac, Ac32, Bs = _ompr_setup(dev, B, n, m, k, cdt)
    cn2 = torch.sum(Ac32 * Ac32, dim=0)
    floor2 = 64.0 * n * (1.1920929e-07 ** 2) * torch.sum(Bs * Bs, dim=1)
    st = ft._init_engine(Bs, K, m, cn2, npend=K + 1, stepwise=True)
    return Ac, Ac32, Bs, cn2, floor2, st


def _select_both(Ac, Ac32, cn2, stk, st, npend, cdt):
    """The pending-term select on the kernel's and the plain state; the
    rescalings and the picks must agree on the clean rows."""
    kv, ki = fs.rescaled_select(Ac, cn2, stk.r, stk.pend_u[:npend],
                                stk.pend_w[:npend], 1.0, stk.amask, stk.resc)
    pv, pi = fs._rescaled_select_ref(Ac32, cn2, st.r, st.pend_u[:npend],
                                     st.pend_w[:npend], 1.0, st.amask,
                                     st.resc, cdt)
    torch.cuda.synchronize()
    torch.testing.assert_close(stk.resc[1:], st.resc[1:], rtol=0, atol=ATOL)
    assert torch.equal(_reduce(kv, ki)[1][1:], _reduce(pv, pi)[1][1:])
    return kv, ki


def _same_pending(stk, st, slots):
    torch.testing.assert_close(stk.pend_w[:slots, 1:], st.pend_w[:slots, 1:],
                               rtol=0, atol=STATE_ATOL)
    live = st.pend_w[:slots, 1:] != 0
    torch.testing.assert_close(stk.pend_u[:slots, 1:][live],
                               st.pend_u[:slots, 1:][live], rtol=0,
                               atol=STATE_ATOL)


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
@pytest.mark.parametrize("kfinal", [-1, 2])
def test_rmp_kernels_match_plain_every_step(dev, B, n, m, cdt, kfinal):
    # two outer passes, every launch from the plain version's state: the
    # delta variant's backward stage deletes nothing on the clean rows
    # (delta 0.15: above the noise's gains, below the unit coefficients'),
    # the k variant's cuts the 4 planted atoms to 2 and leaves two restore
    # terms
    k, K, delta2 = 4, 6, 0.15 ** 2
    Ac, Ac32, Bs, cn2, floor2, st = _stepwise_setup(dev, B, n, m, k, K, cdt)
    npend = 1
    for outer in range(2):
        steps = 0
        while steps < K + 1 and bool((st.fgate > 0.5).any()):
            stk = _clone(st)
            kv, ki = _select_both(Ac, Ac32, cn2, stk, st, npend, cdt)
            ft.rmp_append(kv, ki, Ac, Bs, stk, delta2, floor2, False)
            ft._rmp_append_ref(kv, ki, Ac32, Bs, st, delta2, floor2, False)
            torch.cuda.synchronize()
            _same_state(stk, st, slice(1, None))
            _same_pending(stk, st, 1)
            npend = 1
            steps += 1
        # the second pass adds again what the k variant's stage deleted
        assert steps == 1 + (k if outer == 0 else max(k - kfinal, 0)
                             if kfinal >= 0 else 0), steps
        assert float(st.fgate[0]) == float(stk.fgate[0]) == 0.0   # NaN row
        stk = _clone(st)
        ft.engine_backward(Bs, stk, delta2, kfinal)
        ft._engine_backward_ref(Bs, st, delta2, kfinal)
        torch.cuda.synchronize()
        _same_state(stk, st, slice(1, None))
        _same_pending(stk, st, K + 1)
        want = k - kfinal if kfinal >= 0 else 0
        assert (st.ndel[1:] == want).all(), st.ndel
        npend = 1 + int(st.ndel.max())
    assert not st.capped[1:].any() and not stk.capped[1:].any()
    # the second pass of the delta variant accepted nothing: every row done
    if kfinal < 0:
        assert (st.done[1:] == 1.0).all() and (stk.done[1:] == 1.0).all()
    # a done row is left exactly as it was; its pending weights and its
    # deletion count, which size the next select's passes, are zeroed
    st.done[1] = 1.0
    st.pend_w[:, 1] = 0.5
    before = _clone(st)
    parts = fs._rescaled_select_ref(Ac32, cn2, st.r, st.pend_u[:0],
                                    st.pend_w[:0], 1.0, st.amask,
                                    st.resc.clone(), cdt)
    ft.rmp_append(*parts, Ac, Bs, st, delta2, floor2, False)
    ft.engine_backward(Bs, st, delta2, kfinal)
    torch.cuda.synchronize()
    for name, a, b in zip(st._fields, st, before):
        if a is not None and not name.startswith("pend") and name != "ndel":
            assert torch.equal(a[1], b[1]), name
    assert not st.pend_w[:, 1].any() and float(st.ndel[1]) == 0.0
    # rmp_append (a thread-block cluster per row) at every step over this
    # entry's share of the grid: the delta variant's forward stage, or the
    # k variant's two stages around a plain backward one (free slots below
    # occupied ones); a NaN row, a duplicate pick, the rtol gate, a capped
    # row and a done row
    _hold_rmp_grid(dev, _grid_share(B, n, m), cdt,
                   "k" if kfinal >= 0 else "delta")


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_rmp_append_reports_the_cap(dev, B, n, m, cdt):
    # K = 2 slots against 4 planted atoms: the third forward step wants an
    # atom, finds no slot, and sets capped on every clean row
    Ac, Ac32, Bs, cn2, floor2, st = _stepwise_setup(dev, B, n, m, 4, 2, cdt)
    npend = 1
    for _ in range(3):
        stk = _clone(st)
        kv, ki = _select_both(Ac, Ac32, cn2, stk, st, npend, cdt)
        ft.rmp_append(kv, ki, Ac, Bs, stk, 1e-4, floor2, False)
        ft._rmp_append_ref(kv, ki, Ac32, Bs, st, 1e-4, floor2, False)
        torch.cuda.synchronize()
        _same_state(stk, st, slice(1, None))
    assert (stk.capped[1:] == 1.0).all() and (st.capped[1:] == 1.0).all()
    assert float(stk.capped[0]) == float(st.capped[0]) == 0.0


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_foba_kernel_matches_plain_every_iteration(dev, B, n, m, cdt):
    # on unit planted atoms FoBa's gain / 4 rule deletes nothing by itself,
    # so iterations 2 and 3 get their select scores multiplied by 100: the
    # rule's bound becomes 25 gains and the loop deletes several atoms,
    # which the later iterations add again
    k, K, delta2 = 4, 6, 0.15 ** 2
    Ac, Ac32, Bs, cn2, floor2, st = _stepwise_setup(dev, B, n, m, k, K, cdt)
    npend, t, ndel_seen = 1, 0, 0
    while t < 12 and bool((st.fgate > 0.5).any()):
        stk = _clone(st)
        kv, ki = _select_both(Ac, Ac32, cn2, stk, st, npend, cdt)
        if t in (2, 3):
            kv = kv * 100.0
        ft.rmp_append(kv, ki, Ac, Bs, stk, delta2, floor2, True)
        ft._rmp_append_ref(kv, ki, Ac32, Bs, st, delta2, floor2, True)
        torch.cuda.synchronize()
        _same_state(stk, st, slice(1, None))
        _same_pending(stk, st, K + 1)
        npend = 1 + int(st.ndel.max())
        ndel_seen = max(ndel_seen, int(st.ndel[1:].max()))
        t += 1
    assert k + 1 <= t < 12 and not st.fgate[1:].any()
    assert ndel_seen >= 2 and ((st.idx[1:] < m).sum(1) == k).all()
    # and over this entry's share of the grid, deleting rows included
    _hold_rmp_grid(dev, _grid_share(B, n, m), cdt, "foba")


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_stepwise_solves_match_plain_and_recover(dev, B, n, m, cdt):
    k = 3 if n < 100 else 8
    A, Bs, sup = _problem(dev, B, n, m, k)
    want = sup.sort(1).values

    def launches(fn):
        before = dict(fs.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        return out, {key: fs.LAUNCHES[key] - before[key] for key in before
                     if fs.LAUNCHES[key] != before[key]}

    solves = []
    for kw in ({"delta": 1e-2, "maxiter": 2}, {"k": k}):
        (sol, _, cap, (t, f)), got = launches(lambda: ft.rmp_fused_solve(
            A, Bs, kmax=12, corr_dtype=cdt, return_iters=True, **kw))
        assert got == {_key("fr_select", A.to(cdt)): f, "rmp_append": f,
                       "engine_backward": t}, got
        ref, _, cap_ref = ft.rmp_fused_solve_ref(A, Bs, kmax=12,
                                                 corr_dtype=cdt, **kw)
        assert torch.equal(cap, cap_ref)
        if "delta" in kw:
            assert not cap.any()
            solves.append((sol, ref))
    (sol, _, cap, t), got = launches(lambda: ft.foba_fused_solve(
        A, Bs, 1e-2, kmax=12, corr_dtype=cdt, return_iters=True))
    assert got == {_key("fr_select", A.to(cdt)): t, "rmp_append": t}, got
    assert not cap.any()
    solves.append((sol, ft.foba_fused_solve_ref(A, Bs, 1e-2, kmax=12,
                                                corr_dtype=cdt)[0]))
    for sol, ref in solves:
        assert torch.equal(sol.idx, ref.idx) and torch.equal(sol.mask, ref.mask)
        torch.testing.assert_close(sol.val, ref.val, rtol=0, atol=1e-3)
        if n >= 1000:
            have = torch.where(sol.mask, sol.idx, m).sort(1).values
            assert torch.equal(have[:, :k].long(), want)
    # kmax = 2 cannot hold the support: every row reports the cap
    _, _, cap = ft.rmp_fused_solve(A, Bs, delta=1e-2, kmax=2, corr_dtype=cdt)
    assert cap.all()


# --------------------------------------------------------------------------
# Backward kernels (FBR, LACE): bw_select and bw_downdate
# --------------------------------------------------------------------------

BW_SIZES = [(3, 48, 40), (8, 128, 128), (8, 1024, 1024)]   # B, n, m


def _bw_problem(dev, B, n, m, k=3):
    """Unit-norm Gaussian (n, m) dictionary, m <= n, and B rows of k planted
    ones plus noise of relative size ~1e-3."""
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((n, m), device=dev, generator=gen)
    A = A / A.norm(dim=0, keepdim=True)
    sup = torch.stack([torch.randperm(m, generator=gen, device=dev)[:k]
                       for _ in range(B)])
    Bs = A[:, sup].sum(-1).T.contiguous()
    Bs += 1e-3 * torch.randn(Bs.shape, device=dev, generator=gen)
    return A, Bs, sup


@pytest.mark.parametrize("B,n,m", BW_SIZES)
@pytest.mark.parametrize("select_abs", [False, True])
def test_bw_kernels_match_plain_every_step(dev, B, n, m, select_abs):
    # the kernels round every product and sum as the plain version's tensor
    # operations do, so the states agree bit for bit (the selection has no
    # sums); row 1 stops early at a threshold and is skipped from then on
    A, Bs, _ = _bw_problem(dev, B, n, m)
    st = fb._bw_init(A, Bs)
    st.nr2[1] = 1.0                    # its first step exceeds max_eps2
    for t in range(min(m - 3, 24)):
        stk = _clone(st)
        fb.bw_select(stk, 0.5, float("inf"), select_abs)
        fb._bw_select_ref(st, 0.5, float("inf"), select_abs)
        torch.cuda.synchronize()
        for name, a, b in zip(st._fields, stk, st):
            assert torch.equal(a, b), (t, name)
        fb.bw_downdate(stk)
        fb._bw_downdate_ref(st)
        torch.cuda.synchronize()
        assert torch.equal(stk.G, st.G), t
    assert float(st.run[1]) == 0.0 and st.run[[0, 2]].all()
    assert int(st.alive[1].sum()) == m and int(st.alive[0].sum()) == m - t - 1
    assert not st.failed.any()


def test_bw_select_latches_failed_on_nan(dev):
    A, Bs, _ = _bw_problem(dev, 4, 48, 40)
    st = fb._bw_init(A, Bs)
    st.coef[1] = float("nan")          # NaN scores: nothing is selected
    st.nr2[2] = -1e9                   # an indefinite state: d2 + nr2 < 0
    stk = _clone(st)
    fb.bw_select(stk, float("inf"), float("inf"), False)
    fb._bw_select_ref(st, float("inf"), float("inf"), False)
    torch.cuda.synchronize()
    assert stk.failed.tolist() == st.failed.tolist() == [0.0, 1.0, 1.0, 0.0]
    assert stk.run.tolist() == st.run.tolist() == [1.0, 0.0, 0.0, 1.0]
    assert torch.equal(stk.alive, st.alive) and int(stk.alive[2].sum()) == 40


@pytest.mark.parametrize("B,n,m", BW_SIZES)
def test_backward_solves_match_plain_and_recover(dev, B, n, m):
    A, Bs, sup = _bw_problem(dev, B, n, m)
    want = sup.sort(1).values
    for solve, ref in ((fb.fbr_fused_solve, fb.fbr_fused_solve_ref),
                       (fb.lace_fused_solve, fb.lace_fused_solve_ref)):
        before = dict(fs.LAUNCHES)
        sol, failed, t = solve(A, Bs, sparsity=3, return_iters=True)
        torch.cuda.synchronize()
        assert t == m - 3
        assert fs.LAUNCHES["bw_select"] - before["bw_select"] == t
        assert fs.LAUNCHES["bw_downdate"] - before["bw_downdate"] == t
        rsol, rfailed = ref(A, Bs, sparsity=3)
        assert torch.equal(sol.idx, rsol.idx) and torch.equal(failed, rfailed)
        assert not failed.any()
        torch.testing.assert_close(sol.val, rsol.val, rtol=0, atol=1e-4)
        have = torch.where(sol.mask, sol.idx, m).sort(1).values[:, :3]
        assert torch.equal(have.long(), want)
    # a threshold stop: far fewer steps than m, read at the latch interval
    sol, failed, t = fb.fbr_fused_solve(A, Bs, max_increase=0.1,
                                        return_iters=True)
    assert not failed.any() and t <= -(-(m - 2) // fb.CHECK_EVERY) * fb.CHECK_EVERY
    have = torch.where(sol.mask, sol.idx, m).sort(1).values[:, :3]
    assert torch.equal(have.long(), want)


def test_stepwise_and_backward_wrappers_reject_bad_cuda_inputs(dev):
    A, Bs, _ = _problem(dev, 4, 32, 256, 2)
    Ac = A.to(torch.bfloat16)
    cn2 = torch.sum(A * A, dim=0)
    floor2 = torch.zeros((4,), device=dev)
    st = ft._init_engine(Bs, 3, 256, cn2, npend=2)     # SRR's state
    with pytest.raises(ValueError):
        ft.rmp_append(*fs.select_argmax(Bs, Ac), Ac, Bs, st, 0.0, floor2,
                      False)
    with pytest.raises(ValueError):
        ft.engine_backward(Bs, st, 0.0, -1)
    A2, B2, _ = _bw_problem(dev, 2, 48, 40)
    bw = fb._bw_init(A2, B2)
    with pytest.raises(ValueError):
        fb.bw_select(bw._replace(coef=bw.coef.double()), 1.0, 1.0, False)
    with pytest.raises(ValueError):
        fb.bw_downdate(bw._replace(G=bw.G[:, :, :39]))


# --------------------------------------------------------------------------
# The streaming selects of the sharded solvers (csrc/stream_select.cu)
# --------------------------------------------------------------------------

# ragged batch and n; one tile; several tiles (4096 atoms in bf16, 2048 in
# f32 at n=1024)
STREAM_SIZES = [(5, 40, 384), (8, 64, 1152), (8, 1024, 8192)]


def _stream_inputs(dev, B, n, m, cdt, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((n, m), device=dev, generator=gen)
    A = (A / A.norm(dim=0)).to(cdt)
    R = torch.randn((B, n), device=dev, generator=gen)
    return A, R


def _clear_rows(scores, depth=1):
    top = scores.topk(depth + 1, dim=1).values
    return ((top[:, :-1] - top[:, 1:]) > RTOL * top[:, :1]).all(dim=1)


@pytest.mark.parametrize("B,n,m", STREAM_SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_stream_top1_and_masked_match_plain(dev, B, n, m, cdt):
    A, R = _stream_inputs(dev, B, n, m, cdt)
    before = dict(fs.LAUNCHES)
    kv, ki = ss.correlate_select_stream(A, R)
    pv, pi = ss.correlate_select_stream_ref(A, R)
    assert kv.dtype == torch.float32 and ki.dtype == torch.int32
    torch.testing.assert_close(kv, pv, rtol=RTOL, atol=1e-6)
    scores = torch.abs(R.to(cdt).float() @ A.float())
    clear = _clear_rows(scores)
    assert bool(((ki == pi) | ~clear).all()) and int(clear.sum()) >= B - 2
    M = torch.zeros((B, m), device=dev)
    M.scatter_(1, scores.topk(3, dim=1).indices, -torch.inf)
    M[B - 1] = -torch.inf                       # every atom excluded
    kv, ki = ss.correlate_select_masked_stream(A, R, M)
    pv, pi = ss.correlate_select_masked_stream_ref(A, R, M)
    torch.testing.assert_close(kv, pv, rtol=RTOL, atol=1e-6)
    clear = _clear_rows((scores + M).nan_to_num(neginf=-1.0))
    assert bool(((ki == pi) | ~clear).all())
    assert kv[B - 1] == -torch.inf and ki[B - 1] == 0
    assert bool((M[torch.arange(B - 1), ki[:B - 1].long()] == 0).all())
    k6, k9 = _key("select_stream", A), _key("select_masked_stream", A)
    assert k6.endswith("_mma") == (cdt == torch.bfloat16)
    assert fs.LAUNCHES[k6] - before[k6] == 1
    assert fs.LAUNCHES[k9] - before[k9] == 1


@pytest.mark.parametrize("B,n,m", STREAM_SIZES)
@pytest.mark.parametrize("l", [1, 4, 32])
@pytest.mark.parametrize("cdt", CDTS)
def test_stream_topl_matches_plain(dev, B, n, m, l, cdt):
    A, R = _stream_inputs(dev, B, n, m, cdt, seed=1)
    key = _key("select_topl_stream", A)
    before = dict(fs.LAUNCHES)
    kv, ki = ss.correlate_select_topl_stream(A, R, l)
    pv, pi = ss.correlate_select_topl_stream_ref(A, R, l)
    assert tuple(kv.shape) == tuple(ki.shape) == (B, l)
    scores = torch.abs(R.to(cdt).float() @ A.float())
    clear = _clear_rows(scores, depth=l)
    # slot for slot where nothing ties; values as sorted sets everywhere
    assert torch.equal(ki[clear], pi[clear]) and int(clear.sum()) >= 1
    torch.testing.assert_close(kv.sort(dim=1).values, pv.sort(dim=1).values,
                               rtol=RTOL, atol=1e-6)
    assert key.endswith("_mma") == (cdt == torch.bfloat16)
    assert fs.LAUNCHES[key] - before[key] == 1
    assert fs.LAUNCHES["stream_topl_finish"] - before["stream_topl_finish"] == 1


@pytest.mark.parametrize("cdt", CDTS)
def test_stream_ties_nan_row_and_poisoned_atom(dev, cdt):
    B, n, m = 8, 1024, 8192
    A, R = _stream_inputs(dev, B, n, m, cdt, seed=2)
    tm = ss._stream_tile(m, n, A.element_size(), ss.STREAM_TILE_BYTES)
    assert m // tm >= 2
    # one column three times: twice in the first tile, once in the last
    A[:, 1900] = A[:, 700]
    A[:, 7000] = A[:, 700]
    R[0] = A[:, 700].float()
    R[1, 5] = float("nan")
    kv, ki = ss.correlate_select_stream(A, R)
    assert ki[0] == 700 and kv[1] == -torch.inf and ki[1] == 0
    M = torch.zeros((B, m), device=dev)
    M[:, 700] = -torch.inf
    assert ss.correlate_select_masked_stream(A, R, M)[1][0] == 1900
    tv, ti = ss.correlate_select_topl_stream(A, R, 2)
    assert sorted(ti[0].tolist()) == [700, 1900]
    assert bool((tv[1] == -torch.inf).all()) and bool((ti[1] == 0).all())
    ci, cv = ca.correlate_argmax(A, R.T)
    assert ci[0] == 700 and torch.isnan(cv[1]) and not torch.isnan(cv[0])
    # a poisoned atom: its tile is skipped whole by K6, K7 and K9, and K10
    # reports NaN with the index it had before that tile
    best = int(torch.abs(R[2].to(cdt).float() @ A.float()).argmax())
    A[:, best] = float("nan")
    for kern, ref in (
            (ss.correlate_select_stream(A, R),
             ss.correlate_select_stream_ref(A, R)),
            (ss.correlate_select_masked_stream(A, R, M),
             ss.correlate_select_masked_stream_ref(A, R, M)),
            (ss.correlate_select_topl_stream(A, R, 4),
             ss.correlate_select_topl_stream_ref(A, R, 4))):
        assert torch.equal(kern[1], ref[1])
        torch.testing.assert_close(kern[0], ref[0], rtol=RTOL, atol=1e-6)
        lo = best // tm * tm
        assert not bool(((kern[1] >= lo) & (kern[1] < lo + tm))[2:].any())
    ci, cv = ca.correlate_argmax(A, R.T)
    pi, pv = ca.correlate_argmax_ref(A, R.T)
    assert bool(torch.isnan(cv).all()) and bool(torch.isnan(pv).all())
    assert torch.equal(ci, pi)


def test_stream_topl_evicts_the_lowest_slot_among_equal_minima(dev):
    n, m = 8256, 384                           # three tiles of 128 atoms
    assert ss._stream_tile(m, n, 4, ss.STREAM_TILE_BYTES) == 128
    gen = torch.Generator(device=dev).manual_seed(5)
    A = 0.01 * torch.randn((n, m), device=dev, generator=gen)
    a = torch.randn((n,), device=dev, generator=gen)
    a /= a.norm()
    A[:, 3] = A[:, 9] = 0.5 * a
    A[:, 300] = a
    R = a.repeat(8, 1)
    kv, ki = ss.correlate_select_topl_stream(A, R, 2)
    pv, pi = ss.correlate_select_topl_stream_ref(A, R, 2)
    assert ki.tolist() == pi.tolist() == [[300, 9]] * 8


@pytest.mark.parametrize("cdt", CDTS)
def test_stream_selects_read_a_column_slice_in_place(dev, cdt):
    B, n, m = 8, 64, 1024
    A, R = _stream_inputs(dev, B, n, 4 * m, cdt, seed=3)
    view = A[:, m:2 * m]
    assert not view.is_contiguous()
    for fn, extra in ((ss.correlate_select_stream, ()),
                      (ss.correlate_select_topl_stream, (4,)),
                      (ss.correlate_select_masked_stream,
                       (torch.zeros((B, m), device=dev),))):
        got, want = fn(view, R, *extra), fn(view.contiguous(), R, *extra)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ci, cv = ca.correlate_argmax(view, R.T)
    wi, wv = ca.correlate_argmax(view.contiguous(), R.T.contiguous())
    assert torch.equal(ci, wi) and torch.equal(cv, wv)


@pytest.mark.parametrize("cdt", CDTS)
def test_corr_argmax_matches_plain(dev, cdt):
    for B, n, m in ((8, 64, 1024), (5, 40, 640), (64, 1024, 8192)):
        A, R = _stream_inputs(dev, B, n, m, cdt, seed=4)
        key = _key("corr_argmax", A)
        before = fs.LAUNCHES[key]
        ki, kv = ca.correlate_argmax(A, R.T)          # (n, B), strided
        pi, pv = ca.correlate_argmax_ref(A, R.T)
        torch.testing.assert_close(kv, pv, rtol=RTOL, atol=1e-6)
        clear = _clear_rows(torch.abs(R.to(cdt).float() @ A.float()))
        assert bool(((ki == pi) | ~clear).all())
        i1, v1 = ca.correlate_argmax(A, R[0])         # one residual
        assert i1.ndim == 0 and v1.ndim == 0
        torch.testing.assert_close(v1, kv[0], rtol=RTOL, atol=1e-6)
        assert fs.LAUNCHES[key] - before == 2


def test_stream_wrappers_reject_bad_cuda_inputs(dev):
    A, R = _stream_inputs(dev, 8, 64, 1024, torch.float32)
    with pytest.raises(ValueError):
        ss.correlate_select_stream(A[:, :1000], R)
    with pytest.raises(ValueError):
        ss.correlate_select_stream(A.T.contiguous().T, R)   # column-major
    with pytest.raises(ValueError):
        ss.correlate_select_stream(A, R.cpu())
    with pytest.raises(ValueError):
        ss.correlate_select_topl_stream(A, R, 0)
    with pytest.raises(ValueError):
        ss.correlate_select_masked_stream(A, R, torch.zeros((8, 1024),
                                                            device=dev).bool())
    il = torch.full((8, 2), -1, dtype=torch.int32, device=dev)
    cn2 = torch.ones((1024,), device=dev)
    resc = torch.ones((8, 1024), device=dev)
    with pytest.raises(ValueError):              # resc must be f32
        ss.fr_step_select(A, R, R, il, cn2, resc.double(), 1e-4)
    with pytest.raises(ValueError):              # ... and contiguous
        ss.fr_step_select(A, R, R, il, cn2, resc.T.contiguous().T, 1e-4)
    with pytest.raises(ValueError):
        ss.fr_step_select(A, R, R[:, :32], il, cn2, resc, 1e-4)
    with pytest.raises(ValueError):
        ss.fr_step_select(A, R, R, il[:, :1], cn2, resc, 1e-4)
    with pytest.raises(ValueError):
        ca.correlate_argmax(A.double(), R.T)


@pytest.mark.parametrize("B,n,m", STREAM_SIZES)
@pytest.mark.parametrize("l", [33, 48, 128])
@pytest.mark.parametrize("cdt", CDTS)
def test_stream_topl_beyond_32_matches_plain(dev, B, n, m, l, cdt):
    # two and four slots per lane of the finishing warp; a repeated column
    # among the best, in the first block, a middle one and the last
    A, R = _stream_inputs(dev, B, n, m, cdt, seed=6)
    at = [5, m // 2 + 7, m - 100]
    A[:, at[1]] = A[:, at[0]]
    A[:, at[2]] = A[:, at[0]]
    R[0] = 0.2 * R[0] + 3 * A[:, at[0]].float()
    kv, ki = ss.correlate_select_topl_stream(A, R, l)
    pv, pi = ss.correlate_select_topl_stream_ref(A, R, l)
    assert tuple(kv.shape) == tuple(ki.shape) == (B, l)
    torch.testing.assert_close(kv.sort(dim=1).values, pv.sort(dim=1).values,
                               rtol=RTOL, atol=1e-6)
    scores = torch.abs(R.to(cdt).float() @ A.float())
    # the kept sets agree but for atoms that tie with the l-th score within
    # the summation noise; slot for slot where no two scores tie at all
    for b in range(B):
        odd = set(ki[b].tolist()) ^ set(pi[b].tolist())
        edge = pv[b].min()
        assert all(abs(float(scores[b, j] - edge)) <= RTOL * float(pv[b].max())
                   for j in odd), b
    scores[:, at[1:]] = -1.0                   # the copies count once
    clear = _clear_rows(scores, depth=l)
    assert torch.equal(ki[clear], pi[clear])
    assert set(at) <= set(ki[0].tolist()) and set(at) <= set(pi[0].tolist())


def test_stream_topl_48_evicts_the_lowest_slot_among_equal_minima(dev):
    n, m, l = 8256, 384, 48                    # three tiles of 128 atoms
    gen = torch.Generator(device=dev).manual_seed(6)
    A = 1e-3 * torch.randn((n, m), device=dev, generator=gen)
    a = torch.randn((n,), device=dev, generator=gen)
    a /= a.norm()
    strong = list(range(20, 66))
    for rank, j in enumerate(strong):
        A[:, j] = (0.9 - 0.005 * rank) * a
    A[:, 3] = A[:, 9] = 0.5 * a
    A[:, 300] = a
    R = a.repeat(8, 1)
    kv, ki = ss.correlate_select_topl_stream(A, R, l)
    pv, pi = ss.correlate_select_topl_stream_ref(A, R, l)
    assert torch.equal(ki, pi)
    assert sorted(ki[0].tolist()) == sorted(strong + [9, 300])


@pytest.mark.parametrize("n,m,l", [(1024, 8192, 129), (1024, 8192, 1024),
                                   (64, 1024, 1024),
                                   *chip_smoke.TOPL_WIDE_SCRATCH])
@pytest.mark.parametrize("cdt", CDTS)
def test_stream_topl_past_128_slots_matches_plain(dev, n, m, l, cdt):
    # the wide finish: a whole tile (64 x 1024) and slots in shared memory,
    # and both cases of chip_smoke whose keys lie in the finish's scratch
    errs = {}
    for poison in (False, True):
        chip_smoke.hold_topl_wide(dev, n, m, l, cdt, poison, errs)


# --------------------------------------------------------------------------
# fr_step_select (csrc/fr_step_select.cu)
# --------------------------------------------------------------------------

def _fr_step_inputs(dev, B, n, m, cdt, seed=0):
    """A shard, residuals, pending directions small enough that no
    rescaling comes near zero, and a fresh resc = cn2."""
    A, R = _stream_inputs(dev, B, n, m, cdt, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 50)
    W = 0.5 * torch.randn((B, n), device=dev, generator=gen) / n ** 0.5
    V = 0.5 * torch.randn((B, n), device=dev, generator=gen) / n ** 0.5
    cn2 = torch.sum(A.float() ** 2, dim=0)
    il = torch.full((B, 2), -1, dtype=torch.int32, device=dev)
    return A, R, W, V, il, cn2, cn2.repeat(B, 1)


def _fr_step_both(A, R, W, V, il, cn2, resc, deg):
    """Kernel and twin on clones of resc: ((val, idx, resc), the same)."""
    rk, rp = resc.clone(), resc.clone()
    key = _key("fr_step_select", A)
    before = fs.LAUNCHES[key]
    kern = ss.fr_step_select(A, R, W, il, cn2, rk, deg, V=V)
    plain = ss.fr_step_select_ref(A, R, W, il, cn2, rp, deg, V=V)
    torch.cuda.synchronize()
    assert fs.LAUNCHES[key] - before == 1
    assert kern[2] is rk and kern[0].dtype == torch.float32
    assert kern[1].dtype == torch.int32
    return kern, plain


def _same_fr_step(kern, plain, rows=None):
    """Values to RTOL, the -1 marks and NaNs of resc in the same places,
    resc to 1e-5 absolute (differences of O(1) terms), indices where the
    two best scores of the twin's row are clear of each other."""
    (kv, ki, kr), (pv, pi, pr) = kern, plain
    rows = slice(None) if rows is None else rows
    torch.testing.assert_close(kv[rows], pv[rows], rtol=RTOL, atol=1e-6)
    assert torch.equal(kr == -1.0, pr == -1.0)
    assert torch.equal(torch.isnan(kr), torch.isnan(pr))
    torch.testing.assert_close(kr[rows], pr[rows], rtol=0, atol=1e-5,
                               equal_nan=True)


@pytest.mark.parametrize("B,n,m", STREAM_SIZES + [(8, 1024, 32768),
                                                 (8, 1024, 131072)])
@pytest.mark.parametrize("use_v", [False, True])
@pytest.mark.parametrize("cdt", CDTS)
def test_fr_step_select_matches_plain(dev, B, n, m, use_v, cdt):
    A, R, W, V, il, cn2, resc = _fr_step_inputs(dev, B, n, m, cdt)
    deg = fs._degeneracy_rtol(n)
    resc[:, 40] = -1.0                           # an atom already active
    il[:3, 0] = 77                               # rows 0-2 mark atom 77
    il[2:5, 1] = 40                              # rows 2-4 restore atom 40
    kern, plain = _fr_step_both(A, R, W, V if use_v else None, il, cn2, resc,
                                deg)
    _same_fr_step(kern, plain)
    kr = kern[2]
    assert bool((kr[:3, 77] == -1.0).all()) and bool((kr[3:, 77] > 0).all())
    assert bool((kr[:2, 40] < 0).all())
    q = R.to(cdt).float() @ A.float()
    d2 = torch.where(plain[2] > deg * cn2, q * q / plain[2], -torch.inf)
    clear = _clear_rows(d2.nan_to_num(neginf=-1.0))
    assert bool(((kern[1] == plain[1]) | ~clear).all())
    assert int(clear.sum()) >= B - 2
    assert not bool((kern[1][:3] == 77).any())


@pytest.mark.parametrize("m", [32768, 131072])
@pytest.mark.parametrize("cdt", CDTS)
def test_fr_step_select_nan_tie_and_degenerate_cases(dev, m, cdt):
    B, n = 8, 1024
    A, R, W, V, il, cn2, resc = _fr_step_inputs(dev, B, n, m, cdt, seed=1)
    deg = fs._degeneracy_rtol(n)
    tm = ss._stream_tile(m, n, A.element_size(), ss.STREAM_TILE_BYTES)
    # one column three times, twice in one tile and once in the last: the
    # lowest copy wins, and marking it moves the pick on
    at = [700, 1900, m - 1000]
    A[:, at[1]] = A[:, at[0]]
    A[:, at[2]] = A[:, at[0]]
    cn2 = torch.sum(A.float() ** 2, dim=0)
    resc = cn2.repeat(B, 1)
    R[0] = A[:, at[0]].float() + 0.01 * R[0]
    R[1, 5] = float("nan")                       # a NaN row
    resc[3] = 0.0                                # an all-degenerate row
    W[3] = V[3] = 0.0
    for hide, pick in (((), at[0]), ((0,), at[1]), ((0, 1), at[2])):
        resc[0, [at[i] for i in hide]] = -1.0
        kern, plain = _fr_step_both(A, R, 0 * W, None, il, cn2, resc, deg)
        _same_fr_step(kern, plain, rows=[0, 2, 3, 4, 5, 6, 7])
        assert kern[1][0] == pick == plain[1][0]
        assert kern[0][1] == -torch.inf and kern[1][1] == 0
        assert kern[0][3] == -torch.inf and kern[1][3] == 0
    # a poisoned atom: z is NaN for every row, its resc is NaN from now on
    # and scores -inf; its tile is NOT skipped
    q = R.to(cdt).float() @ A.float()
    best = int((q[2] ** 2).argmax())
    A[:, best] = float("nan")
    kern, plain = _fr_step_both(A, R, W, V, il, cn2, resc, deg)
    live = [0, 2, 4, 5, 6, 7]
    _same_fr_step(kern, plain, rows=live)
    assert bool(torch.isnan(kern[2][:, best]).all())
    assert torch.equal(kern[1][live], plain[1][live])
    assert kern[1][2] != best
    # a NaN score with a valid rescaling: the tile IS skipped. Two infs in
    # a row of R meet entries of one sign in every atom (d2 = inf) but for
    # one atom of tile 0, where inf - inf = NaN: the answer is tile 1's
    # first atom
    A, R, W, V, il, cn2, resc = _fr_step_inputs(dev, B, n, m, cdt, seed=2)
    A[7:9] = (A[7:9].float().abs() + 1e-3).to(cdt)
    A[8, 100] = -A[8, 100]
    cn2 = torch.sum(A.float() ** 2, dim=0)
    resc = cn2.repeat(B, 1)
    R[2, 7] = R[2, 8] = float("inf")
    kern, plain = _fr_step_both(A, R, 0 * W, None, il, cn2, resc, deg)
    _same_fr_step(kern, plain)
    assert kern[0][2] == torch.inf and kern[1][2] == tm == plain[1][2]


@pytest.mark.parametrize("cdt", CDTS)
def test_fr_step_select_reads_a_column_slice_in_place(dev, cdt):
    B, n, m = 8, 64, 1024
    A, R, W, V, il, _, _ = _fr_step_inputs(dev, B, n, 4 * m, cdt, seed=3)
    view = A[:, m:2 * m]
    assert not view.is_contiguous()
    cn2 = torch.sum(view.float() ** 2, dim=0)
    resc = cn2.repeat(B, 1)
    deg = fs._degeneracy_rtol(n)
    ra, rb = resc.clone(), resc.clone()
    got = ss.fr_step_select(view, R, W, il, cn2, ra, deg, V=V)
    want = ss.fr_step_select(view.contiguous(), R, W, il, cn2, rb, deg, V=V)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_solvers_run_on_the_kernels(dev, shards):
    from cstpu_torch.parallel import make_mesh, sharded as sh

    B, n, m, k = 8, 256, 4096, 8
    A, Bs, sup = _problem(dev, B, n, m, k, seed=3)
    mesh = make_mesh((1, shards))
    want = sup.sort(1).values

    def counted(fn):
        before = dict(fs.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        return out, {key: v - before[key] for key, v in fs.LAUNCHES.items()
                     if v != before[key]}

    for fuse in (True, False):
        sol, cnt = counted(lambda: sh.omp_sharded_fused(
            A, Bs, k, mesh, fuse_collectives=fuse))
        assert cnt == {"select_stream_mma": shards * k}
        ref = sh.omp_sharded_fused_ref(A, Bs, k, mesh, fuse_collectives=fuse)
        assert torch.equal(sol.idx, ref.idx)
        assert torch.equal(sol.idx.long(), want)
        torch.testing.assert_close(sol.val, ref.val, rtol=0, atol=1e-4)
    x, cnt = counted(lambda: sh.mp_sharded_fused(A, Bs, k, mesh))
    assert cnt == {"select_stream_mma": shards * k}
    torch.testing.assert_close(x, sh.mp_sharded_fused_ref(A, Bs, k, mesh),
                               rtol=0, atol=1e-4)
    sol, cnt = counted(lambda: sh.gomp_sharded_fused(A, Bs, 3, k, mesh))
    assert cnt == {"select_topl_stream_mma": shards * 3,   # 2 steps + rest
                   "stream_topl_finish": shards * 3}
    assert torch.equal(sol.idx, sh.gomp_sharded_fused_ref(A, Bs, 3, k,
                                                          mesh).idx)
    sol, cnt = counted(lambda: sh.sp_sharded_fused(A, Bs, k, mesh, maxiter=4))
    assert cnt["select_topl_stream_mma"] % shards == 0 and len(cnt) == 2
    assert cnt["stream_topl_finish"] == cnt["select_topl_stream_mma"]
    assert torch.equal(sol.idx, sh.sp_sharded_fused_ref(A, Bs, k, mesh,
                                                        maxiter=4).idx)
    assert torch.equal(sol.idx[:, :k].long(), want)
    sol, cnt = counted(lambda: sh.ompr_sharded_fused(A, Bs, k, mesh))
    assert cnt["select_topl_stream_mma"] == cnt["stream_topl_finish"] == shards
    assert cnt["select_masked_stream_mma"] % shards == 0
    assert "select_masked_stream" not in cnt
    assert torch.equal(sol.idx, sh.ompr_sharded_fused_ref(A, Bs, k, mesh).idx)
    assert torch.equal(sol.idx[:, :k].long(), want)
    # the forward-regression family on fr_step_select: one launch per shard
    # and sweep
    for fuse in (True, False):
        (sol, steps), cnt = counted(lambda: sh.fr_sharded_fused(
            A, Bs, k, mesh, fuse_collectives=fuse, return_iters=True))
        assert cnt == {"fr_step_select_mma": shards * steps[0]}
        assert steps == [k]
        ref = sh.fr_sharded_fused_ref(A, Bs, k, mesh, fuse_collectives=fuse)
        assert torch.equal(sol.idx, ref.idx)
        assert torch.equal(sol.idx.long(), want)
        torch.testing.assert_close(sol.val, ref.val, rtol=0, atol=1e-4)
    (sol, iters), cnt = counted(lambda: sh.srr_sharded_fused(
        A, Bs, k, mesh, maxiter=4, return_iters=True))
    assert cnt == {"select_topl_stream_mma": shards,
                   "stream_topl_finish": shards,
                   "fr_step_select_mma": shards * iters[0]}
    assert torch.equal(sol.idx, sh.srr_sharded_fused_ref(A, Bs, k, mesh,
                                                         maxiter=4).idx)
    assert torch.equal(sol.idx[:, :k].long(), want)
    for fn, ref in ((sh.rmp_sharded_fused, sh.rmp_sharded_fused_ref),
                    (sh.foba_sharded_fused, sh.foba_sharded_fused_ref)):
        (sol, capped, counts), cnt = counted(lambda: fn(
            A, Bs, 1e-2, mesh, kmax=16, return_iters=True))
        assert cnt == {"fr_step_select_mma": shards * counts[0]["sweeps"]}
        rsol, rcapped = ref(A, Bs, 1e-2, mesh, kmax=16)
        assert torch.equal(sol.idx, rsol.idx) and not bool(capped.any())
        assert torch.equal(capped, rcapped)
        assert torch.equal(sol.idx[:, :k].long(), want)


# --------------------------------------------------------------------------
# The two variants of the top-1 selects: the tensor-core loop of
# csrc/mma_select.cuh (bf16) and the CUDA-core loop, forced one at a time
# --------------------------------------------------------------------------

# batches off the row-chunk widths (8, 16, 32, 64 and beyond), an n that is
# no multiple of the k-step or the stage, ragged m, the bench and a shard
MMA_SIZES = [(1, 64, 128), (9, 1000, 8232), (65, 1024, 8192),
             (200, 256, 1024), (8, 1000, 8192), (64, 1024, 8192),
             (8, 1024, 32768)]


def _tile_clear(scores):
    """(B, T): True where a tile's best score stands clear of its second."""
    B, m = scores.shape
    T = -(-m // fs.TILE)
    s = torch.nn.functional.pad(scores.nan_to_num(nan=-1.0, neginf=-1.0),
                                (0, T * fs.TILE - m), value=-1.0)
    top = s.view(B, T, fs.TILE).topk(2, dim=2).values
    return (top[..., 0] - top[..., 1]) > RTOL * top[..., 0]


@pytest.mark.parametrize("B,n,m", MMA_SIZES)
@pytest.mark.parametrize("mma", [True, False])
def test_select_variants_match_plain(dev, B, n, m, mma):
    A, R = _stream_inputs(dev, B, n, m, torch.bfloat16, seed=6)
    A32 = A.float()
    key = "select_mma" if mma else "select"
    before = fs.LAUNCHES[key]
    pv, pi, ps = fs.select_argmax(R, A, signed=True, mma=mma)
    qv, qi = fs.select_argmax(R, A, mma=mma)
    assert fs.LAUNCHES[key] - before == 2
    rv, ri, rs = fs._select_ref(R, A32, torch.bfloat16, signed=True)
    assert torch.equal(pv, qv) and torch.equal(pi, qi)
    torch.testing.assert_close(pv, rv, rtol=RTOL, atol=1e-6)
    clear = _tile_clear(torch.abs(R.to(torch.bfloat16).float() @ A32))
    assert torch.equal(pi[clear], ri[clear]) and int(clear.sum()) > 0
    same = pi == ri
    torch.testing.assert_close(ps[same], rs[same], rtol=RTOL, atol=1e-6)
    amask = (torch.rand((B, m), device=dev,
                        generator=torch.Generator(dev).manual_seed(7))
             < 0.3).to(torch.uint8)
    amask[B - 1] = 1                              # every atom active
    mv, mi = fs.select_argmax(R, A, amask=amask, eta=0.5, mma=mma)
    wv, wi = fs._select_ref(R, A32, torch.bfloat16, False, amask, 0.5)
    fin = torch.isfinite(wv)
    assert torch.equal(torch.isfinite(mv), fin)
    torch.testing.assert_close(mv[fin], wv[fin], rtol=RTOL, atol=1e-6)
    assert torch.equal(mi[B - 1], wi[B - 1])      # (-inf, first atom)


@pytest.mark.parametrize("mma", [True, False])
def test_select_variants_ties_nan_and_poisoned_atom(dev, mma):
    B, n, m = 8, 1000, 8232                       # ragged last tile
    A, R = _stream_inputs(dev, B, n, m, torch.bfloat16, seed=8)
    A[:, 30] = A[:, 9]                            # within a tile
    A[:, m - 2] = A[:, 9]                         # across tiles, ragged edge
    R[0] = A[:, 9].float()
    R[1, 3] = float("nan")
    pv, pi, ps = fs.select_argmax(R, A, signed=True, mma=mma)
    v, i = _reduce(pv, pi)
    assert i[0] == 9 and i[1] == fs.INT_MAX and torch.isnan(v[1])
    assert pv[0, 0] == pv[0, -1] and pi[0, -1] == m - 2
    assert bool(torch.isnan(pv[1]).all()) and bool(torch.isnan(ps[1]).all())
    amask = torch.zeros((B, m), dtype=torch.uint8, device=dev)
    amask[:, 9] = 1
    assert _reduce(*fs.select_argmax(R, A, amask=amask, mma=mma))[1][0] == 30
    A[:, 4100] = float("nan")                     # one atom of tile 32
    pv, pi = fs.select_argmax(R, A, mma=mma)
    rv, ri = fs._select_ref(R, A.float(), torch.bfloat16)
    assert bool(torch.isnan(pv[:, 32]).all())
    assert bool((pi[:, 32] == fs.INT_MAX).all())
    assert torch.equal(torch.isnan(pv), torch.isnan(rv))
    ok = ~torch.isnan(rv)
    torch.testing.assert_close(pv[ok], rv[ok], rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("B,n,m", [s for s in MMA_SIZES if s[2] % 128 == 0])
@pytest.mark.parametrize("mma", [True, False])
def test_stream_variants_match_plain(dev, B, n, m, mma):
    A, R = _stream_inputs(dev, B, n, m, torch.bfloat16, seed=9)
    sfx = "_mma" if mma else ""
    before = dict(fs.LAUNCHES)
    scores = torch.abs(R.to(torch.bfloat16).float() @ A.float())
    clear = _clear_rows(scores)
    kv, ki = ss.correlate_select_stream(A, R, mma=mma)
    tv, ti = ss.correlate_select_stream_ref(A, R)
    torch.testing.assert_close(kv, tv, rtol=RTOL, atol=1e-6)
    assert torch.equal(ki[clear], ti[clear])
    M = torch.zeros((B, m), device=dev)
    M.scatter_(1, scores.topk(3, dim=1).indices, -torch.inf)
    kv, ki = ss.correlate_select_masked_stream(A, R, M, mma=mma)
    pv, pi = ss.correlate_select_masked_stream_ref(A, R, M)
    torch.testing.assert_close(kv, pv, rtol=RTOL, atol=1e-6)
    cm = _clear_rows(scores + M)
    assert torch.equal(ki[cm], pi[cm])
    ci, cv = ca.correlate_argmax(A, R.T, mma=mma)      # (n, B), strided
    torch.testing.assert_close(cv, tv, rtol=RTOL, atol=1e-6)
    assert torch.equal(ci[clear], ti[clear])
    for name in ("select_stream", "select_masked_stream", "corr_argmax"):
        assert fs.LAUNCHES[name + sfx] - before[name + sfx] == 1
    # a column slice of a wider dictionary, read in place
    wide = torch.cat([A[:, :128], A, A[:, :128]], dim=1)
    view = wide[:, 128:128 + m]
    assert view.stride(0) == m + 256 and fs._pick_mma(None, view)
    got = ss.correlate_select_stream(view, R, mma=mma)
    want = ss.correlate_select_stream(A, R, mma=mma)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_scores_do_not_depend_on_tile_shard_or_batch(dev):
    # one column repeated in many tiles scores the same bits in each, in a
    # shard at any offset, and in a batch of any size: the tensor-core loop
    # sums every atom in the same order
    n, m = 1024, 8192
    A, R = _stream_inputs(dev, 64, n, m, torch.bfloat16, seed=10)
    for j in range(100, m, 1000):
        A[:, j] = A[:, 7]
    ref = None
    for B in (64, 32, 9, 8, 1):
        fv, fi = fs.select_argmax(R[:B], A, mma=True)
        for lo, hi in ((0, m), (2048, 4096), (4096, m)):
            val, idx = ss.correlate_select_stream(A[:, lo:hi], R[:B],
                                                  mma=True)
            # the shard's best is the best of its tiles in the whole sweep
            assert torch.equal(val, fv[:, lo // fs.TILE:hi // fs.TILE].amax(1))
            if lo == 0:
                v, i = _reduce(fv, fi)
                assert torch.equal(v, val) and torch.equal(i, idx)
                ref = val if ref is None else ref
                assert torch.equal(val, ref[:B])
    R[0] = A[:, 7].float()
    pv, pi = fs.select_argmax(R, A, mma=True)
    tiles = [j // fs.TILE for j in [7] + list(range(100, m, 1000))]
    assert len({float(pv[0, t]) for t in tiles}) == 1
    assert _reduce(pv, pi)[1][0] == 7


def test_forcing_the_tensor_core_loop_on_what_it_does_not_take_fails(dev):
    A, R = _stream_inputs(dev, 8, 64, 1032, torch.bfloat16, seed=11)
    thin = A[:, :1028].contiguous()               # pitch off 16 bytes
    odd = A[:, 4:1028]                            # base off 16 bytes
    assert not fs._pick_mma(None, thin) and not fs._pick_mma(None, odd)
    assert not fs._pick_mma(None, A.float()) and fs._pick_mma(None, A)
    with pytest.raises(RuntimeError):
        fs.select_argmax(R, thin, mma=True)
    with pytest.raises(RuntimeError):
        ss.correlate_select_stream(odd, R, mma=True)
    with pytest.raises(RuntimeError):
        fs.select_argmax(R, A.float(), mma=True)
    before = dict(fs.LAUNCHES)
    kv, ki = fs.select_argmax(R, thin)            # the CUDA-core variant
    pv, pi = fs._select_ref(R, thin.float(), torch.bfloat16)
    torch.testing.assert_close(kv, pv, rtol=RTOL, atol=1e-6)
    v, i = ss.correlate_select_stream(odd, R)
    w, j = ss.correlate_select_stream_ref(odd, R)
    torch.testing.assert_close(v, w, rtol=RTOL, atol=1e-6)
    assert fs.LAUNCHES["select"] - before["select"] == 1
    assert fs.LAUNCHES["select_stream"] - before["select_stream"] == 1
    assert fs.LAUNCHES["select_mma"] == before["select_mma"]


# --------------------------------------------------------------------------
# The two variants of the top-l selects: the tensor-core loop with the
# sorting epilogue of csrc/mma_topl.cuh (bf16) and the CUDA-core loop,
# forced one at a time; the streamed top-l's finish (merge and fold)
# --------------------------------------------------------------------------

# the paths' shapes (2a-3b, the 5c shard), batches 1 to 65 off the row-chunk
# widths, n = 1000 off the stage, a ragged m
TOPL_SIZES = [(64, 1024, 8192), (1, 1000, 8232), (7, 1000, 8232),
              (33, 1000, 8232), (65, 1000, 8232)]
STREAM_TOPL_SIZES = [(8, 1024, 32768), (1, 1000, 8192), (65, 1000, 12288),
                     (5, 40, 384)]


def _topl_problem(dev, B, n, m, seed):
    """bf16 dictionary and residuals with one column three times (twice in
    tile 0, once in the last tile), a NaN row and a poisoned atom."""
    A, R = _stream_inputs(dev, B, n, m, torch.bfloat16, seed=seed)
    A[:, 77] = A[:, 5]
    A[:, m - 3] = A[:, 5]
    R[0] = 0.2 * R[0] + 3 * A[:, 5].float()
    if B > 1:
        R[1, 7] = float("nan")
    if B > 2:
        A[:, m // 2 + 11] = float("nan")          # its tile, every row
    return A, R


def _tile_sets_clear(pv1, l):
    """(B, T): True where a tile's l-th score stands clear of its (l+1)-th
    (pv1 the plain partials at depth l + 1)."""
    top = pv1.nan_to_num(nan=-1.0, neginf=-1.0)
    return (top[..., l - 1] - top[..., l]) > RTOL * top[..., 0].abs()


@pytest.mark.parametrize("B,n,m", TOPL_SIZES)
@pytest.mark.parametrize("l", [1, 4, 16, 32])
@pytest.mark.parametrize("mma", [True, False])
def test_select_topl_variants_match_plain(dev, B, n, m, l, mma):
    A, R = _topl_problem(dev, B, n, m, seed=12)
    key = "select_topl_mma" if mma else "select_topl"
    before = dict(fs.LAUNCHES)
    kv, ki = fs.select_topl(R, A, l, mma=mma)
    assert fs.LAUNCHES[key] - before[key] == 1
    assert sum(fs.LAUNCHES.values()) - sum(before.values()) == 1
    pv, pi = fs._topl_ref(R, A.float(), torch.bfloat16, l)
    torch.cuda.synchronize()
    assert kv.shape == pv.shape == (B, -(-m // fs.TILE), l)
    nan = torch.isnan(pv)
    assert torch.equal(torch.isnan(kv), nan)
    assert bool((ki[nan] == fs.INT_MAX).all())
    assert torch.equal(torch.isinf(kv), torch.isinf(pv))
    fin = torch.isfinite(pv)
    # both lists are sorted by value: position for position to 1e-4
    torch.testing.assert_close(kv[fin], pv[fin], rtol=RTOL, atol=1e-6)
    # index sets where the l-th score stands clear of the (l+1)-th
    clear = _tile_sets_clear(fs._topl_ref(R, A.float(), torch.bfloat16,
                                          l + 1)[0], l)
    assert int(clear.sum()) > 0
    assert torch.equal(ki.sort(dim=2).values[clear],
                       pi.sort(dim=2).values[clear])
    # the repeated column: equal scores, the lower index first
    if l >= 2:
        assert ki[0, 0, :2].tolist() == [5, 77]
        assert int(ki[0, -1, 0]) == m - 3
        assert kv[0, 0, 0] == kv[0, 0, 1] == kv[0, -1, 0]


@pytest.mark.parametrize("B", [1, 8, 33, 64, 65])
def test_select_topl_first_entry_is_the_top1_partial(dev, B):
    # one loop, one instruction sequence: the sort's first key is the top-1
    # select's (max, lowest argmax) bit for bit, NaN tiles included
    A, R = _topl_problem(dev, B, 1000, 8232, seed=13)
    tv, ti = fs.select_argmax(R, A, mma=True)
    for l in (1, 4, 32):
        kv, ki = fs.select_topl(R, A, l, mma=True)
        assert torch.equal(kv[:, :, 0].view(torch.int32), tv.view(torch.int32))
        assert torch.equal(ki[:, :, 0], ti)


@pytest.mark.parametrize("B,n,m", STREAM_TOPL_SIZES)
@pytest.mark.parametrize("l", [1, 4, 32, 48, 128])
@pytest.mark.parametrize("mma", [True, False])
def test_stream_topl_variants_match_plain(dev, B, n, m, l, mma):
    A, R = _topl_problem(dev, B, n, m, seed=14)
    if m <= 384:                                  # one tile: no poisoned atom
        A[:, m // 2 + 11] = A[:, 9]
    key = "select_topl_stream_mma" if mma else "select_topl_stream"
    before = dict(fs.LAUNCHES)
    kv, ki = ss.correlate_select_topl_stream(A, R, l, mma=mma)
    assert fs.LAUNCHES[key] - before[key] == 1
    assert fs.LAUNCHES["stream_topl_finish"] - before["stream_topl_finish"] == 1
    pv, pi = ss.correlate_select_topl_stream_ref(A, R, l)
    assert tuple(kv.shape) == tuple(ki.shape) == (B, l)
    torch.testing.assert_close(kv.sort(dim=1).values, pv.sort(dim=1).values,
                               rtol=RTOL, atol=1e-6)
    scores = torch.abs(R.to(torch.bfloat16).float() @ A.float())
    tm = ss._stream_tile(m, n, 2, ss.STREAM_TILE_BYTES)
    bad = torch.isnan(scores.view(B, m // tm, tm)).any(dim=2)
    scores = torch.where(bad.repeat_interleave(tm, dim=1), -1.0,
                         scores.nan_to_num(nan=-1.0))
    if l < m:
        # slot for slot where the l + 1 best stand clear of each other; the
        # copies of column 5 tie, so row 0 is held by its set
        clear = _clear_rows(scores, depth=min(l, m - 1))
        clear[0] = False
        assert torch.equal(ki[clear], pi[clear])
    if l >= 3:
        assert {5, 77, m - 3} <= set(ki[0].tolist())
        assert set(ki[0].tolist()) == set(pi[0].tolist())
    if B > 1:
        assert bool((kv[1] == -torch.inf).all()) and bool((ki[1] == 0).all())
    # a column slice of a wider dictionary, pitch m + 384, read in place
    wide = torch.cat([A[:, :384], A], dim=1)
    view = wide[:, 384:]
    assert view.stride(0) == m + 384 and fs._pick_mma(None, view)
    got = ss.correlate_select_topl_stream(view, R, l, mma=mma)
    assert torch.equal(got[0], kv) and torch.equal(got[1], ki)


@pytest.mark.parametrize("B,n,m", STREAM_TOPL_SIZES)
def test_stream_topl_at_one_is_the_top1_stream(dev, B, n, m):
    A, R = _topl_problem(dev, B, n, m, seed=15)
    tv, ti = ss.correlate_select_stream(A, R, mma=True)
    kv, ki = ss.correlate_select_topl_stream(A, R, 1, mma=True)
    assert torch.equal(kv[:, 0].view(torch.int32), tv.view(torch.int32))
    assert torch.equal(ki[:, 0], ti)


@pytest.mark.parametrize("B,n,m", STREAM_TOPL_SIZES)
@pytest.mark.parametrize("l", [1, 4, 32, 128])
@pytest.mark.parametrize("mma", [True, False])
def test_stream_topl_finish_matches_plain(dev, B, n, m, l, mma):
    # the finish alone, on the sweep's own partials: the same rule on the
    # same values, so the slots agree bit for bit
    A, R = _topl_problem(dev, B, n, m, seed=16)
    A[:, 200] = A[:, 5]                           # ties across blocks
    tm = ss._stream_tile(m, n, 2, ss.STREAM_TILE_BYTES)
    pval, pidx = ss.stream_topl_sweep(A, R, l, mma=mma)
    want = ss.stream_topl_finish_ref(pval.clone(), pidx.clone(), tm // fs.TILE,
                                     l)
    before = fs.LAUNCHES["stream_topl_finish"]
    got = ss.stream_topl_finish(pval, pidx, tm // fs.TILE, l)
    assert fs.LAUNCHES["stream_topl_finish"] - before == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_forcing_the_tensor_core_topl_on_what_it_does_not_take_fails(dev):
    A, R = _stream_inputs(dev, 8, 64, 1032, torch.bfloat16, seed=17)
    thin = A[:, :1028].contiguous()               # pitch off 16 bytes
    odd = A[:, 4:1028]                            # base off 16 bytes
    with pytest.raises(RuntimeError):
        fs.select_topl(R, thin, 4, mma=True)
    with pytest.raises(RuntimeError):
        fs.select_topl(R, A.float(), 4, mma=True)
    with pytest.raises(RuntimeError):
        ss.correlate_select_topl_stream(odd, R, 4, mma=True)
    with pytest.raises(RuntimeError):
        ss.correlate_select_topl_stream(A[:, :1024].float(), R, 4, mma=True)
    before = dict(fs.LAUNCHES)
    kv, ki = fs.select_topl(R, thin, 4)           # the CUDA-core variant
    pv, pi = fs._topl_ref(R, thin.float(), torch.bfloat16, 4)
    torch.testing.assert_close(kv, pv, rtol=RTOL, atol=1e-6)
    v, i = ss.correlate_select_topl_stream(odd, R, 4)
    w, j = ss.correlate_select_topl_stream_ref(odd, R, 4)
    torch.testing.assert_close(v.sort(1).values, w.sort(1).values, rtol=RTOL,
                               atol=1e-6)
    assert fs.LAUNCHES["select_topl"] - before["select_topl"] == 1
    assert fs.LAUNCHES["select_topl_stream"] - before["select_topl_stream"] == 1
    assert fs.LAUNCHES["select_topl_mma"] == before["select_topl_mma"]
    assert (fs.LAUNCHES["select_topl_stream_mma"]
            == before["select_topl_stream_mma"])


# --------------------------------------------------------------------------
# The two variants of the rescaled selects, fr_select.cu and
# fr_step_select.cu: the tensor-core loop of csrc/mma_rescaled.cuh (bf16) and
# the CUDA-core loop, forced one at a time
# --------------------------------------------------------------------------

# batches off the row-group widths, an n that is no multiple of the k-step,
# ragged m, the paths' shapes (3a's B=64, 3d's B=8)
RESCALED_SIZES = [(1, 1024, 8192), (8, 1024, 8192), (9, 1000, 8232),
                  (64, 1024, 8192), (65, 1000, 8232)]


def _rescaled_inputs(dev, B, n, m, P, seed):
    """A bf16 dictionary, residuals, P pending terms small enough that no
    rescaling comes near zero, a fresh resc = cn2 in a buffer with a guard
    band behind it, and an active mask with one active atom per row."""
    A, R = _stream_inputs(dev, B, n, m, torch.bfloat16, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 60)
    U = 0.3 * torch.randn((P, B, n), device=dev, generator=gen) / n ** 0.5
    W = torch.rand((P, B), device=dev, generator=gen) - 0.5
    cn2 = torch.sum(A.float() ** 2, dim=0)
    buf = torch.full((B * m + 4096,), 7.0, device=dev)
    resc = buf[:B * m].view(B, m)
    resc.copy_(cn2.repeat(B, 1))
    amask = torch.zeros((B, m), dtype=torch.uint8, device=dev)
    amask[torch.arange(B), (13 * torch.arange(B, device=dev)) % m] = 1
    return A, R, U, W, cn2, resc, buf, amask


def _rescaled_both(A, cn2, R, U, W, wsign, amask, resc, mma):
    """Kernel (forced variant) on resc, twin on a clone: ((pval, pidx),
    (pval, pidx), twin's resc); one launch of the variant's key."""
    rp = resc.clone()
    key = "fr_select_mma" if mma else "fr_select"
    before = fs.LAUNCHES[key]
    kern = fs.rescaled_select(A, cn2, R, U, W, wsign, amask, resc, mma=mma)
    plain = fs._rescaled_select_ref(A.float(), cn2, R, U, W, wsign, amask, rp,
                                    torch.bfloat16)
    torch.cuda.synchronize()
    assert fs.LAUNCHES[key] - before == 1
    return kern, plain, rp


@pytest.mark.parametrize("B,n,m", RESCALED_SIZES)
@pytest.mark.parametrize("P", [0, 1, 2, 3, 4, 16])
@pytest.mark.parametrize("mma", [True, False])
def test_rescaled_select_variants_match_plain(dev, B, n, m, P, mma):
    A, R, U, W, cn2, resc, buf, amask = _rescaled_inputs(dev, B, n, m, P,
                                                         seed=12)
    (kv, ki), (pv, pi), rp = _rescaled_both(A, cn2, R, U, W, 1.0, amask, resc,
                                            mma)
    torch.testing.assert_close(resc, rp, rtol=0, atol=1e-5)
    assert bool((buf[B * m:] == 7.0).all())         # nothing past m or B
    torch.testing.assert_close(kv, pv, rtol=RTOL, atol=1e-6)
    q = R.to(torch.bfloat16).float() @ A.float()
    d2 = torch.where(amask.bool(), 0.0, q * q / rp)
    clear = _tile_clear(d2)
    assert torch.equal(ki[clear], pi[clear]) and int(clear.sum()) > 0


@pytest.mark.parametrize("mma", [True, False])
def test_rescaled_select_nan_degenerate_active_and_poisoned(dev, mma):
    B, n, m, P = 9, 1000, 8232, 1
    A, R, U, W, cn2, resc, buf, amask = _rescaled_inputs(dev, B, n, m, P,
                                                         seed=13)
    R[1, 5] = float("nan")                          # a NaN row
    resc[3] = 0.0                                   # an all-degenerate row
    W[:, 3] = 0.0
    amask[4] = 1                                    # an all-active row
    A[:, 4100] = float("nan")                       # a poisoned atom
    (kv, ki), (pv, pi), rp = _rescaled_both(A, cn2, R, U, W, -1.0, amask,
                                            resc, mma)
    assert torch.equal(torch.isnan(resc), torch.isnan(rp))
    assert bool(torch.isnan(resc[:, 4100]).all())   # z is NaN for every row
    torch.testing.assert_close(resc, rp, rtol=0, atol=1e-5, equal_nan=True)
    assert torch.equal(torch.isnan(kv), torch.isnan(pv))
    ok = ~torch.isnan(pv)
    torch.testing.assert_close(kv[ok], pv[ok], rtol=RTOL, atol=1e-6)
    v, i = _reduce(kv, ki)
    assert torch.isnan(v[1]) and i[1] == fs.INT_MAX  # active atoms score 0,
    assert bool(torch.isnan(kv[1][pv[1].isnan()]).all())   # the rest NaN
    assert bool((kv[3][~torch.isnan(kv[3])] <= 0).all())   # degenerate
    assert v[4] == 0 and i[4] == 0                  # all active: (0, first)
    assert int(ki[4, 5]) == 5 * fs.TILE
    assert not bool((ki == 4100).any())             # NaN resc scores -inf


def test_rescaled_repeated_column_scores_bit_equal(dev):
    # one column within a tile, across tiles and in the ragged last tile:
    # the same products, the same rescalings and the same scores, bit for
    # bit, whatever the batch; the lowest copy wins
    n, m = 1000, 8232
    A, R, U, W, cn2, resc, _, amask = _rescaled_inputs(dev, 64, n, m, 2,
                                                       seed=14)
    at = [9, 30, 4100, m - 2]
    for j in at[1:]:
        A[:, j] = A[:, at[0]]
    cn2 = torch.sum(A.float() ** 2, dim=0)
    R[0] = A[:, at[0]].float()
    amask.zero_()
    ref = None
    for B in (64, 9, 1):
        rk = cn2.repeat(B, 1)
        pv, pi = fs.rescaled_select(A, cn2, R[:B].contiguous(),
                                    U[:, :B].contiguous(),
                                    W[:, :B].contiguous(), 1.0, amask[:B], rk,
                                    mma=True)
        torch.cuda.synchronize()
        assert all(torch.equal(rk[:, at[0]], rk[:, j]) for j in at[1:])
        tiles = [j // fs.TILE for j in at]
        assert len({float(pv[0, t]) for t in tiles}) == 1
        assert [int(pi[0, t]) for t in tiles] == [9, 9, 4100, m - 2]
        assert _reduce(pv, pi)[1][0] == at[0]
        ref = (rk[0], pv[0]) if ref is None else ref
        assert torch.equal(rk[0], ref[0]) and torch.equal(pv[0], ref[1])


def test_rescaled_products_are_the_top1_loops_bits(dev):
    # with no pending term and resc = 1 the score is q * q, the square of
    # the top-1 select's |q|: the two loops sum every product in the same
    # k-steps, so the values agree bit for bit
    B, n, m = 64, 1024, 8192
    A, R, _, _, cn2, _, _, amask = _rescaled_inputs(dev, B, n, m, 0, seed=15)
    amask.zero_()
    resc = torch.ones((B, m), device=dev)
    empty = torch.zeros((0, B, n), device=dev)
    rv, ri = fs.rescaled_select(A, cn2 * 0, R, empty, empty[:, :, 0], 1.0,
                                amask, resc, mma=True)
    tv, ti = fs.select_argmax(R, A, mma=True)
    torch.cuda.synchronize()
    assert torch.equal(rv, tv * tv)
    assert float((ri == ti).float().mean()) > 0.99


# (B, rescaling products, tiles) -> (G, Pn, stacked rows): the paths' own
# shapes first (K8 at B=8 without and with V at m_local = 131072 and 32768;
# FR at 3a's and 3d's batch; SRR's init with 16 terms, then 2), then batches
# off the row-group widths
@pytest.mark.parametrize("B,nterms,ntiles,want", [
    (8, 1, 1024, (1, 2, 16)),
    (8, 2, 1024, (1, 4, 32)),
    (8, 1, 256, (1, 2, 16)),
    (64, 1, 64, (4, 2, 128)),
    (8, 1, 64, (1, 2, 16)),
    (64, 16, 64, (2, 4, 1280)),
    (64, 2, 64, (2, 4, 256)),
    (8, 16, 64, (1, 4, 160)),
    (1, 0, 64, (1, 2, 16)),
    (16, 1, 64, (1, 2, 32)),         # halved: twice the blocks still fit
    (65, 3, 65, (2, 4, 320)),
    (200, 1, 8, (2, 2, 416)),
])
def test_rescaled_plan(dev, B, nterms, ntiles, want):
    assert fs._rescaled_plan(B, nterms, ntiles) == want


def test_every_rescaled_plan_fits_an_instantiation(dev):
    built = {(1, 2), (2, 2), (4, 2), (1, 4), (2, 4)}   # mma_rescaled.cuh
    for B in (1, 7, 8, 9, 16, 31, 64, 65, 129, 200):
        for nterms in (0, 1, 2, 3, 4, 7, 16):
            for ntiles in (1, 8, 64, 65, 256, 1024):
                G, Pn, rows = fs._rescaled_plan(B, nterms, ntiles)
                assert (G, Pn) in built
                nchunks = -(-(-(-B // 8)) // G)
                npass = -(-(nterms + 1) // Pn)
                assert rows == npass * nchunks * 8 * G * Pn
                assert npass * Pn >= nterms + 1 and nchunks * 8 * G >= B


def _stack_rows(prods, G, Pn):
    """The stacked operand row by row: for each pass k, row chunk y, row
    group g of the chunk and product slot s, the 8 rows of product
    k Pn + s that the group holds, rounded to bf16, zeros past n and B."""
    B, n = prods[0].shape
    nchunks = -(-(-(-B // 8)) // G)
    zero = torch.zeros((8, -(-n // 8) * 8))
    out = []
    for k in range(-(-len(prods) // Pn)):
        for y in range(nchunks):
            for g in range(G):
                for s in range(Pn):
                    p, b0 = k * Pn + s, 8 * (y * G + g)
                    rows = zero.clone()
                    if p < len(prods):
                        got = prods[p][b0:b0 + 8].cpu()
                        rows[:got.shape[0], :n] = got
                    out.append(rows)
    return torch.cat(out).to(torch.bfloat16)


@pytest.mark.parametrize("B,n,m,P", [(8, 40, 1024, 1), (9, 1000, 8232, 0),
                                     (64, 1024, 8192, 1), (17, 16, 1024, 3),
                                     (65, 1000, 8232, 16)])
def test_rescaled_stacked_operand_is_the_products_interleaved(dev, B, n, m,
                                                              P):
    # the scratch the rounding launch wrote for the sweep: row chunk y of
    # pass k holds, in column group g Pn + s of wgmma's N, the rows
    # 8 (y G + g) .. + 7 of product k Pn + s (the terms, then r), so that
    # one thread holds every product of its (row, atom) entries
    from cstpu_torch.ops import _build

    A, R, U, W, cn2, resc, _, amask = _rescaled_inputs(dev, B, n, m, P,
                                                       seed=19)
    T = -(-m // fs.TILE)
    G, Pn, rows = fs._rescaled_plan(B, P, T)
    sb = torch.full((rows, -(-n // 8) * 8), 7.0, dtype=torch.bfloat16,
                    device=dev)
    pval = torch.empty((B, T), device=dev)
    pidx = torch.empty((B, T), dtype=torch.int32, device=dev)
    err = _build.load().cstpu_fr_select(
        R.data_ptr(), U.data_ptr(), W.data_ptr(), P, 1.0, A.data_ptr(), 1,
        cn2.data_ptr(), amask.data_ptr(), resc.data_ptr(), pval.data_ptr(),
        pidx.data_ptr(), B, n, m, fs._degeneracy_rtol(n), 1, sb.data_ptr(),
        rows, fs._stream())
    _build.check(err, "cstpu_fr_select")
    torch.cuda.synchronize()
    assert torch.equal(sb.cpu(), _stack_rows([*U, R], G, Pn))


FR_STEP_SIZES = [(1, 1024, 8192), (9, 1000, 8192), (65, 1024, 8192),
                 (64, 1024, 8192), (8, 1024, 32768), (8, 1024, 131072)]


@pytest.mark.parametrize("B,n,m", FR_STEP_SIZES)
@pytest.mark.parametrize("use_v", [False, True])
@pytest.mark.parametrize("mma", [True, False])
def test_fr_step_variants_match_plain(dev, B, n, m, use_v, mma):
    A, R, W, V, il, cn2, resc = _fr_step_inputs(dev, B, n, m,
                                                torch.bfloat16, seed=16)
    deg = fs._degeneracy_rtol(n)
    resc[:, 40] = -1.0
    il[:3, 0] = 77
    il[1:5, 1] = 40
    buf = torch.full((B * m + 4096,), 7.0, device=dev)
    rk = buf[:B * m].view(B, m)
    rk.copy_(resc)
    rp = resc.clone()
    key = "fr_step_select_mma" if mma else "fr_step_select"
    before = fs.LAUNCHES[key]
    V = V if use_v else None
    kern = ss.fr_step_select(A, R, W, il, cn2, rk, deg, V=V, mma=mma)
    plain = ss.fr_step_select_ref(A, R, W, il, cn2, rp, deg, V=V)
    torch.cuda.synchronize()
    assert fs.LAUNCHES[key] - before == 1
    assert bool((buf[B * m:] == 7.0).all())
    _same_fr_step(kern, plain)
    q = R.to(torch.bfloat16).float() @ A.float()
    d2 = torch.where(rp > deg * cn2, q * q / rp, -torch.inf)
    clear = _clear_rows(d2.nan_to_num(neginf=-1.0))
    assert bool(((kern[1] == plain[1]) | ~clear).all())
    assert bool((rk[:min(B, 3), 77] == -1.0).all())


@pytest.mark.parametrize("mma", [True, False])
def test_fr_step_variants_read_a_slice_and_repeat_bits_across_shards(dev,
                                                                     mma):
    # a shard slice with pitch m + 384 is read in place; one column repeated
    # in several tiles and in every shard of the dictionary updates and
    # scores the same bits everywhere
    B, n, m = 8, 1024, 32768
    A, R, W, V, il, cn2, resc = _fr_step_inputs(dev, B, n, m,
                                                torch.bfloat16, seed=17)
    cols = [7, 300, 4000, m // 4 + 7, m // 2 + 7, 3 * m // 4 + 7, m - 3]
    for j in cols[1:]:
        A[:, j] = A[:, cols[0]]
    cn2 = torch.sum(A.float() ** 2, dim=0)
    deg = fs._degeneracy_rtol(n)
    wide = torch.cat([A[:, :128], A, A[:, :256]], dim=1)
    view = wide[:, 128:128 + m]
    assert view.stride(0) == m + 384 and fs._pick_mma(None, view)
    got = ss.fr_step_select(view, R, W, il, cn2, cn2.repeat(B, 1), deg, V=V,
                            mma=mma)
    want = ss.fr_step_select(A, R, W, il, cn2, cn2.repeat(B, 1), deg, V=V,
                             mma=mma)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(torch.equal(want[2][:, cols[0]], want[2][:, j])
               for j in cols[1:])
    q = m // 4
    parts = [ss.fr_step_select(A[:, s * q:(s + 1) * q], R, W, il,
                               cn2[s * q:(s + 1) * q],
                               cn2[s * q:(s + 1) * q].repeat(B, 1), deg,
                               V=V, mma=mma)[2] for s in range(4)]
    assert torch.equal(torch.cat(parts, dim=1), want[2])


def test_forcing_the_tensor_core_rescaled_loop_on_f32_fails(dev):
    A, R, U, W, cn2, resc, _, amask = _rescaled_inputs(dev, 8, 64, 1024, 1,
                                                       seed=18)
    with pytest.raises(RuntimeError):
        fs.rescaled_select(A.float(), cn2, R, U, W, 1.0, amask, resc,
                           mma=True)
    il = torch.full((8, 2), -1, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError):
        ss.fr_step_select(A.float(), R, R, il, cn2, resc, 1e-6, mma=True)
    before = dict(fs.LAUNCHES)
    fs.rescaled_select(A[:, :1020].contiguous(), cn2[:1020], R, U, W, 1.0,
                       amask[:, :1020].contiguous(),
                       resc[:, :1020].contiguous())   # pitch off 16 bytes
    assert fs.LAUNCHES["fr_select"] - before["fr_select"] == 1
    assert fs.LAUNCHES["fr_select_mma"] == before["fr_select_mma"]


# --------------------------------------------------------------------------
# The one-block-per-row latency kernels as redesigned: bw_select on a
# thread-block cluster per row, sp_round on one tiled f32 Gram of its slot
# columns, and the warp-sorted merge of the top-l partials that sp_round,
# gomp_append and engine_init share (common.cuh::merge_topl_row)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,m", chip_smoke.BW_CLUSTER_CASES)
def test_bw_select_cluster_matches_plain_bit_for_bit(dev, B, m):
    # 40 FBR and 10 LACE steps: ties on both sides of a slice boundary (the
    # lower atom goes first), a NaN in the last slice only, a row rejected
    # at step 0 and a NaN init; every field bit for bit, every step
    st, fbr_tie, lace_tie = chip_smoke.bw_cluster_state(dev, B, m)
    steps = chip_smoke.hold_bw_select(st, fbr_tie, lace_tie)
    assert steps >= min(m - 3, 2)


def test_bw_select_launch_counts_one_per_step(dev):
    A, Bs, _ = _bw_problem(dev, 8, 1024, 1024)
    st = fb._bw_init(A, Bs)
    before = fs.LAUNCHES["bw_select"]
    for _ in range(3):
        fb.bw_select(st, float("inf"), float("inf"), False)
        fb.bw_downdate(st)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["bw_select"] - before == 3
    assert int(st.alive.sum()) == 8 * (1024 - 3)     # every step accepted


@pytest.mark.parametrize("B,n,m,k", chip_smoke.SP_ROUND_CASES)
def test_sp_round_tiled_gram_matches_plain_every_round(dev, B, n, m, k):
    # a NaN row, a poisoned partial and a done row; the state within
    # APPEND_ATOL of the plain round every round, idx equal
    err = chip_smoke.hold_sp_round(dev, B, n, m, k)
    assert err <= chip_smoke.APPEND_ATOL


def _crafted_partials(dev, B, m, l):
    """(B, T, l) top-l partials by hand: row 0 holds the value 2.0 in tiles
    0 and 3 and 1.0 in tiles 0 and 3, then (-inf, idx) entries in tiles 1
    and 0 (an atom a mask excluded), then pads; row 1 a NaN; row 2 only
    (-inf, idx) entries and pads. Rows 3.. are left to the caller."""
    T = -(-m // 128)
    pv = torch.full((B, T, l), -torch.inf, device=dev)
    pi = torch.full((B, T, l), fs.INT_MAX, dtype=torch.int32, device=dev)
    for row, tile, entries in (
            (0, 0, [(2.0, 5), (1.0, 7), (-torch.inf, 9)]),
            (0, 1, [(-torch.inf, 130)]),
            (0, 3, [(2.0, 400), (1.0, 390)]),
            (1, 2, [(3.0, 300), (float("nan"), 301)]),
            (2, 1, [(-torch.inf, 200), (-torch.inf, 131)]),
            (2, 0, [(-torch.inf, 60)])):
        for j, (v, i) in enumerate(entries):
            pv[row, tile, j] = v
            pi[row, tile, j] = i
    return pv, pi


def test_merge_orders_ties_across_tiles_and_inf_entries(dev):
    # gomp_append appends its picks whatever their value, in the merge's
    # order: equal values in index order across tiles, (-inf, idx) entries
    # after every finite one in index order, pads last, a NaN row no pick
    B, n, m, l, k = 4, 64, 1024, 6, 8
    A, Bs, _ = _problem(dev, B, n, m, 2)
    Ac = A.to(torch.bfloat16).contiguous()
    Ac32 = Ac.float()
    pv, pi = _crafted_partials(dev, B, m, l)
    real = fs._topl_ref(Bs, Ac32, torch.bfloat16, l)
    pv[3], pi[3] = real[0][3], real[1][3]
    st = fs._init_gomp(Bs, k, m)
    stk = fs._GompState(*(x.clone() for x in st))
    fs.gomp_append(pv, pi, Ac, Bs, stk, k, 0.0)
    fs._gomp_append_ref(pv, pi, Ac32, Bs, st, k, 0.0)
    torch.cuda.synchronize()
    assert torch.equal(stk.idx, st.idx) and torch.equal(stk.kcnt, st.kcnt)
    assert stk.idx[0, :6].tolist() == [5, 400, 7, 390, 9, 130]
    assert stk.idx[2, :3].tolist() == [60, 131, 200]
    for a, b in ((stk.Ginv, st.Ginv), (stk.coef, st.coef), (stk.r, st.r),
                 (stk.cols, st.cols)):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL, equal_nan=True)


def test_merge_feeds_engine_init_as_the_twin(dev):
    # engine_init appends only finite picks: row 0's four, in the merge's
    # order; the NaN row and the row of (-inf, idx) entries stay empty
    B, n, m, l = 4, 64, 1024, 6
    A, Bs, _ = _problem(dev, B, n, m, 2)
    Ac = A.to(torch.bfloat16).contiguous()
    Ac32 = Ac.float()
    pv, pi = _crafted_partials(dev, B, m, l)
    real = fs._topl_ref(Bs, Ac32, torch.bfloat16, l)
    pv[3], pi[3] = real[0][3], real[1][3]
    st = ft._init_engine(Bs, l + 1, m)
    stk = _clone(st)
    ft.engine_init(pv, pi, Ac, Bs, stk)
    ft._engine_init_ref(pv, pi, Ac32, Bs, st)
    torch.cuda.synchronize()
    _same_state(stk, st)
    assert stk.idx[0, :4].tolist() == [5, 400, 7, 390]
    assert not (stk.idx[1:3] < m).any()


# --------------------------------------------------------------------------
# omp_append and fr_append as a thread-block cluster per row over the
# staged slot columns (csrc/append_cluster.cuh)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,n,k", chip_smoke.APPEND_CASES)
@pytest.mark.parametrize("cdt", CDTS)
def test_append_cluster_matches_plain_every_step(dev, B, n, k, cdt):
    # both kernels on the plan's instantiation (the grid takes both); a NaN
    # row, a duplicate pick, a degenerate column and (FR) a latched row:
    # idx, done, amask equal, the state within APPEND_ATOL
    for fr in (False, True):
        err, plan = chip_smoke.hold_append(dev, B, n, k, cdt, fr)
        assert err <= chip_smoke.APPEND_ATOL, (fr, plan, err)


@pytest.mark.parametrize("B,C", [(1, 8), (8, 8), (16, 8), (20, 6), (64, 2),
                                 (65, 2), (132, 1), (300, 1)])
def test_append_plan_fills_the_card(dev, B, C):
    # C from B alone at these n: B C up to the 132 SMs, at most 8; slices
    # of a multiple of 4 entries, none empty; staged where (k - 1) slices fit
    # beside Ginv (at k = 128 from C = 6 on)
    for n in (1000, 1024, 1028):
        for k in (1, 16, 32, 128):
            plan = fs._append_plan(B, n, k)
            assert plan.C == C and plan.slice % 4 == 0, plan
            assert (plan.C - 1) * plan.slice < n <= plan.C * plan.slice
            assert plan.staged == (k < 128 or C > 2), (n, k, plan)
            assert plan.smem <= fs.SMEM_MAX
    # the grid's cases past the first 48: the staged variant's edge at
    # k = 32, C = 2, a larger n at small k, k = 128 at C = 8
    edge = [fs._append_plan(B2, n2, k2)
            for B2, n2, k2 in chip_smoke.APPEND_CASES[48:]]
    assert [(p.C, p.slice, p.staged) for p in edge] == [
        (2, 1664, True), (2, 1668, False), (2, 4096, False),
        (8, 512, False)], edge
    # small n: no block owns fewer than 64 entries (one at n <= 64)
    assert fs._append_plan(8, 40, 4).C == 1
    assert fs._append_plan(8, 130, 4).C == 3
    # at the wrappers' shared-memory limit one block cannot hold a row's
    # slices: the plan takes more blocks, streamed (four at k = 128)
    n = 41216
    assert fs._append_smem(n, 128) <= fs.SMEM_MAX
    plan = fs._append_plan(200, n, 128)
    assert plan.C == 4 and not plan.staged and plan.smem <= fs.SMEM_MAX


def test_append_wrappers_launch_at_the_budget_edge(dev):
    # the largest n the wrappers admit at k = 128 and at k = 1: one step
    # each launches (the cluster's streamed variant) and matches the plain
    # step
    for n, k in ((41216, 128), (58107, 1)):
        assert fs._append_smem(n, k) <= fs.SMEM_MAX
        A, Bs, _ = _problem(dev, 2, n, 256, 1)
        Ac = A.to(torch.bfloat16).contiguous()
        st, *out = fs._init_state(Bs, k, 256)
        parts = fs._select_ref(st.r, Ac.float(), torch.bfloat16)
        stk = fs._OmpState(*(x.clone() for x in st))
        outk = [x.clone() for x in out]
        fs.omp_append(*parts, Ac, Bs, stk, 0, *outk)
        fs._append_ref(*parts, Ac.float(), Bs, st, 0, *out)
        torch.cuda.synchronize()
        assert torch.equal(stk.idx, st.idx)
        for a, b in ((stk.Ginv, st.Ginv), (stk.coef, st.coef), (stk.r, st.r)):
            torch.testing.assert_close(a, b, rtol=0, atol=ATOL)


# --------------------------------------------------------------------------
# rmp_append and engine_init as a thread-block cluster per row
# (csrc/engine_cluster.cuh): the plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,C", [(1, 8), (8, 8), (16, 8), (20, 6), (64, 2),
                                 (65, 2), (132, 1), (300, 1)])
def test_engine_plan_fills_the_card(dev, B, C):
    # C from B alone at these n, as omp_append's plan; rmp_append stages all
    # K slot columns where they fit (not at K = 128 with C <= 2), engine_init
    # its cnt picked ones
    for n in (1000, 1024, 1028):
        for K in (16, 32, 128):
            for cnt in chip_smoke.engine_cnts(K) + (0,):
                plan = ft._engine_plan(B, n, K, cnt)
                assert plan.C == C and plan.slice % 4 == 0, plan
                assert (plan.C - 1) * plan.slice < n <= plan.C * plan.slice
                assert plan.staged == (cnt > 0 or K < 128 or C > 2), plan
                assert plan.smem <= fs.SMEM_MAX
    # the grid's edges: engine_init's picks staged up to n = 2520 at
    # K = cnt = 32, C = 2; rmp_append streamed at K = 128, C = 8, n = 4096
    assert ft._engine_plan(64, 2520, 32, 32).staged
    assert not ft._engine_plan(64, 2524, 32, 32).staged
    assert not ft._engine_plan(8, 4096, 128).staged
    # at the wrappers' shared-memory limit the plan takes more blocks
    for K, cnt in ((128, 0), (128, 32), (33, 32), (1, 0), (1, 1)):
        n = 1
        while ft._engine_smem(n + 1, K) <= fs.SMEM_MAX:
            n += 1
        plan = ft._engine_plan(200, n, K, cnt)
        assert plan.smem <= fs.SMEM_MAX and not plan.staged, (K, cnt, plan)


# --------------------------------------------------------------------------
# engine_delete and engine_backward as a thread-block cluster per row
# (csrc/engine_cluster.cuh's deletions, on the slot engine's plan)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
def test_engine_delete_matches_plain_every_launch(dev, B, n, m, cdt):
    # this entry's share of chip_smoke.DELETE_CASES: the plain init and
    # forward steps, then the stage from the plain state; a NaN row, a done
    # row, gated-off deletions, a full row, two slots tied
    for B2, n2, K2, l2 in _share(chip_smoke.DELETE_CASES, B, n, m):
        err, plan, _ = chip_smoke.hold_engine_delete(dev, B2, n2, K2, l2, cdt)
        assert err <= chip_smoke.APPEND_ATOL, (B2, n2, K2, l2, plan, err)


@pytest.mark.parametrize("B,n,m", SIZES)
@pytest.mark.parametrize("cdt", CDTS)
@pytest.mark.parametrize("rule", chip_smoke.DELETE_RULES)
def test_engine_backward_matches_plain_every_launch(dev, B, n, m, cdt, rule):
    # this entry's share of DELETE_CASES' (B, n, K): the plain forward stage,
    # then the stage under `rule` from the plain state; rows that reject at
    # once (NaN, empty, gains of ~100), a done row, a full row, a tie
    cases = list(dict.fromkeys(c[:3] for c in chip_smoke.DELETE_CASES))
    for B2, n2, K2 in _share(cases, B, n, m):
        err, plan, _ = chip_smoke.hold_engine_backward(dev, B2, n2, K2, cdt,
                                                       rule)
        assert err <= chip_smoke.APPEND_ATOL, (B2, n2, K2, rule, plan, err)


def test_engine_backward_deleting_stage_holds(dev):
    # 3d's state after its forward stage, k rule down to DELETE_KFINAL atoms
    # at both batch sizes: held against the plain version and timed
    A, _, _ = chip_smoke.planted(torch.Generator(device=dev).manual_seed(0), 1,
                                 1024, 8192, 1)
    gen = torch.Generator(device=dev).manual_seed(1)
    probs = {B: chip_smoke.planted_ones(gen, A, B, chip_smoke.STEP_CELL[3])[0]
             for B in chip_smoke.BATCHES}
    out = chip_smoke.deleting_times(A, probs)
    for B, v in out.items():
        assert v["ndel"] == chip_smoke.STEP_CELL[3] - chip_smoke.DELETE_KFINAL
        assert v["ms"] > 0.0 and v["bound"]["bound_ms"] > 0.0


def test_engine_wrappers_launch_at_the_budget_edge(dev):
    # the largest n the wrappers admit at K = 128 and 33: one rmp_append
    # step and one engine_init launch (the streamed variants) match the
    # plain versions
    for K, cnt in ((128, 32), (33, 32)):
        n = 1
        while ft._engine_smem(n + 1, K) <= fs.SMEM_MAX:
            n += 1
        m = 512
        A, Bs, _ = _problem(dev, 2, n, m, 4)
        Ac = A.to(torch.bfloat16).contiguous()
        Ac32 = Ac.float()
        cn2 = torch.sum(Ac32 * Ac32, dim=0)
        st = ft._init_engine(Bs, K, m, cn2, npend=max(cnt, K + 1),
                             stepwise=True)
        stk = _clone(st)
        parts = fs._topl_ref(Bs, Ac32, torch.bfloat16, cnt)
        ft.engine_init(*parts, Ac, Bs, stk)
        ft._engine_init_ref(*parts, Ac32, Bs, st)
        torch.cuda.synchronize()
        _same_state(stk, st, slice(0, None))
        st.fgate.fill_(1.0)
        floor2 = torch.zeros(2, device=dev)
        parts = fs._rescaled_select_ref(Ac32, cn2, st.r, st.pend_u[:1],
                                        st.pend_w[:1], 1.0, st.amask,
                                        st.resc, torch.bfloat16)
        stk = _clone(st)
        ft.rmp_append(*parts, Ac, Bs, stk, 0.0, floor2, True)
        ft._rmp_append_ref(*parts, Ac32, Bs, st, 0.0, floor2, True)
        torch.cuda.synchronize()
        _same_state(stk, st, slice(0, None))


# --------------------------------------------------------------------------
# the CUDA-core variants of select_argmax, fr_select, select_topl and
# fr_step_select on their staged, register-tiled loop (csrc/simt_select.cuh)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,n,m,off", chip_smoke.SIMT_CASES)
@pytest.mark.parametrize("cdt", CDTS)
def test_simt_selects_match_plain_on_every_row(dev, B, n, m, off, cdt):
    # select_argmax's three modes and fr_select with 0, 1, 2 and 16 pending
    # terms, forced onto the CUDA-core variant: every row's pick equal to
    # the plain twin's (a duplicated column -> its lower index, a NaN row
    # -> INT_MAX, an all-masked row), values within SELECT_RTOL, the
    # rescalings within RESC_ATOL; at an aligned base and m = 2048, and at
    # an unaligned base with a ragged, odd pitch
    sel_err, resc_err, _ = chip_smoke.hold_simt_select(dev, B, n, m, off,
                                                       cdt)
    assert sel_err <= chip_smoke.SELECT_RTOL
    assert resc_err <= chip_smoke.RESC_ATOL


@pytest.mark.parametrize("B,n,m,off", chip_smoke.SIMT_CASES)
@pytest.mark.parametrize("cdt", CDTS)
def test_simt_topl_and_fr_step_match_plain_on_every_row(dev, B, n, m, off,
                                                        cdt):
    # select_topl at l = 1, 4, 32 and fr_step_select with and without V, on
    # a contiguous shard and on a column view (lda = 4 m + off), forced onto
    # the CUDA-core variants on the same loop: each tile's first top-l entry
    # the top-1 select's partial bit for bit, the rest against the plain
    # twin (a duplicated column, a NaN row, a tile of 2 atoms' pads); the
    # step's picks on the clear rows, its mark, restore, NaN and
    # all-degenerate rows, and its written-back rescalings
    topl_err, _ = chip_smoke.hold_simt_topl(dev, B, n, m, off, cdt)
    assert topl_err <= chip_smoke.SELECT_RTOL
    _, resc_err, _ = chip_smoke.hold_simt_fr_step(dev, B, n, m, off, cdt)
    assert resc_err <= chip_smoke.RESC_ATOL


@pytest.mark.parametrize("B,n,m,off", chip_smoke.SIMT_CASES)
@pytest.mark.parametrize("cdt", CDTS)
def test_simt_stream_top1_matches_plain_on_every_row(dev, B, n, m, off, cdt):
    # stream_select.cu's CUDA-core top-1 sweep under K6, K9 and K10 (R as
    # (n, B), read through its strides), forced onto simt_select.cuh, on a
    # contiguous shard and on a column view (lda = 4 m + off): each tile's
    # partial select_argmax's CUDA-core partial bit for bit, the finished
    # picks against the plain twins (a duplicated column, a NaN row, an
    # all-excluded row, then a poisoned atom)
    err, _, _ = chip_smoke.hold_simt_stream(dev, B, n, m, off, cdt)
    assert err <= chip_smoke.SELECT_RTOL


@pytest.mark.parametrize("B,n,m,off", chip_smoke.SIMT_CASES)
@pytest.mark.parametrize("cdt", CDTS)
def test_simt_stream_topl_matches_plain_on_every_row(dev, B, n, m, off, cdt):
    # stream_select.cu's CUDA-core top-l sweep (K7) forced onto
    # simt_select.cuh, on a contiguous shard and on a column view (lda =
    # 4 m + off), at l = 1, 4, 32, 128 and 160 (the wide finish): the
    # partials select_topl's CUDA-core partials bit for bit up to l = 32 and
    # select_argmax's in each tile's first entry, every list against the
    # plain twin, the finish the plain finish's bit for bit, the select
    # against the plain select (a duplicated column, a NaN row, then a
    # poisoned atom); values within SELECT_RTOL of the best score
    err, _ = chip_smoke.hold_simt_stream_topl(dev, B, n, m, off, cdt)
    assert err <= chip_smoke.SELECT_RTOL
