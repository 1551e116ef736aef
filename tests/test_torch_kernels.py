"""The select and append CUDA kernels against their plain PyTorch versions,
on the card. Marked `gpu`: without a CUDA device every test here skips.

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
# append step from identical state to 1e-4 absolute.
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
