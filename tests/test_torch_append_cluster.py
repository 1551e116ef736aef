"""The OMP and FR append kernels (csrc/omp_append.cu, csrc/fr_append.cu: a
thread-block cluster per row over the staged slot columns,
csrc/append_cluster.cuh) as far as the CPU can see them.

The kernels run only on the card, where tests/test_torch_kernels.py holds
them to their plain twins at every step over the plan's grid. Here:

- the twins (`_append_ref`, `_fr_append_ref`) against cstpu's
  `_solve_kernel` and `_fr_kernel` in interpret mode, with a NaN row, a
  duplicate pick (a zero row: every score ties at 0, so atom 0 comes back
  and is turned away), a column twin (the rtol gate) and, for FR, a row
  that latches at once; n = 1000, which the card cuts into eight slices of
  128 entries, the last 104;
- the kernels' residual and aperp, summed over the live slots only (slots
  <= t, in slot order), equal the sums over all k slots bit for bit at
  every step of a finite solve: a dead slot's column is zero and its
  coefficient and u stay 0. A NaN row is NaN both ways;
- with a stand-in for the kernel library that records the C calls, the
  wrappers hand the C entries the arguments they always did, and refuse
  k > KMAX, t >= k and an n beyond the shared-memory budget without
  launching.

Tolerances: supports and masks equal; coefficients and residuals to 1e-4
absolute with f32 correlation (what cstpu holds its kernels to against its
XLA paths), 1e-3 with bf16 (both solve the bf16-rounded problem).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu.ops import fused_solve as jfs
from cstpu_torch.ops import fused_solve as tfs
from cstpu_torch.utils.interop import solution_to_numpy, to_torch

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
ATOL = {"f32": 1e-4, "bf16": 1e-3}
N, M = 1000, 256


def _rows(seed):
    """A (N, M) with atom 255 a copy of a planted atom j0, and rows: the
    noisy planted measurement (the picks past the planted ones follow the
    noise, clear of rounding), a NaN row, a zero row, the same with j0
    weighted up (its twin ties with it, and is turned away by the rtol gate
    once j0 is in)."""
    from conftest import planted_problem

    A, x, b, y = (np.asarray(v) for v in planted_problem(
        seed, n=N, m=M, k=3, noise=5e-3, dtype=jnp.float32))
    A = A.copy()
    j0 = int(np.flatnonzero(x)[0])
    A[:, 255] = A[:, j0]
    nan = y.copy()
    nan[7] = np.nan
    Bs = np.stack([y, nan, np.zeros_like(y), y + 2.0 * A[:, j0]])
    return A, Bs.astype(np.float32), j0


def _compare(t, j, atol):
    t, j = solution_to_numpy(t), solution_to_numpy(j)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=0, atol=atol)
    return t


def _kept(t, row):
    return set(t["idx"][row][t["mask"][row]].tolist())


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_omp_twin_nan_row_and_duplicate_pick_match_pallas(cdt):
    # cstpu's kernel read through its `_to_solution` sort
    # (sort_in_kernel=False), as tests/test_torch_fused_solve.py reads it
    # for a NaN row
    A, Bs, j0 = _rows(1101)
    jsol, jr = jfs.omp_fused_solve(A, Bs, 5, corr_dtype=JDT[cdt],
                                   interpret=True, sort_in_kernel=False)
    tsol, tr = tfs.omp_fused_solve_ref(to_torch(A), to_torch(Bs), 5,
                                       corr_dtype=TDT[cdt])
    t = _compare(tsol, jsol, ATOL[cdt])
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                               atol=ATOL[cdt])
    assert not t["mask"][1].any() and np.isnan(tr[1].numpy()).all()
    # the zero row keeps atom 0 alone: it comes back at every later step
    assert _kept(t, 2) == {0}
    assert j0 in _kept(t, 3) and 255 not in _kept(t, 3)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_fr_twin_nan_row_and_degenerate_twin_match_pallas(cdt):
    A, Bs, j0 = _rows(1102)
    jsol, jr = jfs.fr_fused_solve(A, Bs, 5, corr_dtype=JDT[cdt],
                                  interpret=True)
    tsol, tr = tfs.fr_fused_solve_ref(to_torch(A), to_torch(Bs), 5,
                                      corr_dtype=TDT[cdt])
    t = _compare(tsol, jsol, ATOL[cdt])
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                               atol=ATOL[cdt])
    assert not t["mask"][1].any() and np.isnan(tr[1].numpy()).all()
    # the zero row has ||r||^2 = 0: it latches before its first append
    assert not t["mask"][2].any()
    assert j0 in _kept(t, 3) and 255 not in _kept(t, 3)


def _slot_sum(cols, w, nslots):
    """sum_{s < nslots} cols[:, s] * w[:, s], added in slot order, as the
    kernels add it."""
    acc = torch.zeros_like(cols[:, 0])
    for s in range(nslots):
        acc = acc + cols[:, s] * w[:, s, None]
    return acc


def _same_or_both_nan(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("solver", ["omp", "fr"])
def test_live_slot_sums_equal_all_slot_sums_bit_for_bit(solver, cdt,
                                                        monkeypatch):
    A, Bs, _ = _rows(1103)
    A, Bs = to_torch(A), to_torch(Bs)
    k = 6
    Ac = A.to(TDT[cdt]).float()
    seen = []
    original = tfs._bordered_append_ref

    def spy(*args):
        out = original(*args)
        seen.append(out)
        return out

    monkeypatch.setattr(tfs, "_bordered_append_ref", spy)
    if solver == "omp":
        st, *out = tfs._init_state(Bs, k, M)
    else:
        cn2 = torch.sum(A * A, dim=0)
        st = tfs._init_fr(Bs, k, cn2)
    finite = torch.ones(Bs.shape[0], dtype=torch.bool)
    finite[1] = False
    for t in range(k):
        if solver == "omp":
            tfs._append_ref(*tfs._select_ref(st.r, Ac, TDT[cdt]), Ac, Bs, st,
                            t, *out)
        else:
            tfs._fr_append_ref(*tfs._fr_select_ref(Ac, cn2, st, TDT[cdt]),
                               Ac, Bs, st, t, 0.0, 0.0)
        live = Bs - _slot_sum(st.cols, st.coef, t + 1)
        every = Bs - _slot_sum(st.cols, st.coef, k)
        assert torch.equal(live[finite], every[finite]), t
        assert _same_or_both_nan(live, every), t
        assert bool(torch.isnan(live[1]).all()), t
        # the twin's residual is the same sum in torch.sum's order
        torch.testing.assert_close(live[finite], st.r[finite], rtol=0,
                                   atol=1e-5)
        if t < k - 1:  # the dead slots are zero columns with zero weights
            assert not st.cols[:, t + 1:].any()
            assert not st.coef[finite][:, t + 1:].any()
        if solver == "fr":
            _, acol, u, _ = seen[-1]
            live = acol - _slot_sum(st.cols, u, t + 1)
            every = acol - _slot_sum(st.cols, u, k)
            assert _same_or_both_nan(live, every), t
            torch.testing.assert_close(live, st.aperp, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# The wrappers' C calls
# --------------------------------------------------------------------------

class _Recorder:
    """Stands in for the kernel library: records each C call's arguments
    and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recorder(monkeypatch):
    """The wrappers' launch route on CPU tensors: tensors claim to be on
    CUDA, the library is the recorder, and no device or stream is asked."""
    from cstpu_torch.ops import _build

    rec = _Recorder()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_build, "load", lambda: rec)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(tfs, "_stream", lambda: None)
    return rec


def _parts(B, n, m, cdt=torch.bfloat16):
    T = -(-m // tfs.TILE)
    return (torch.zeros((B, T)), torch.zeros((B, T), dtype=torch.int32),
            torch.zeros((n, m), dtype=cdt), torch.zeros((B, n)))


@pytest.mark.parametrize("k,t,cdt", [(1, 0, torch.bfloat16),
                                     (32, 31, torch.float32),
                                     (128, 5, torch.bfloat16)])
def test_omp_append_wrapper_passes_the_same_arguments(recorder, k, t, cdt):
    B, n, m = 3, 1000, 8264
    pv, pi, Ac, Bs = _parts(B, n, m, cdt)
    st, oi, oc = tfs._init_state(Bs, k, m)
    before = tfs.LAUNCHES["append"]
    tfs.omp_append(pv, pi, Ac, Bs, st, t, oi, oc)
    (name, args), = recorder.calls
    assert name == "cstpu_omp_append"
    assert args[:6] == (pv.data_ptr(), pi.data_ptr(), 65, Ac.data_ptr(),
                        int(cdt == torch.bfloat16), Bs.data_ptr())
    assert args[6:13] == tuple(x.data_ptr() for x in (*st[:4], st.r, oi, oc))
    assert args[13:18] == (B, n, m, k, t)
    assert args[18] == pytest.approx(tfs._degeneracy_rtol(n))
    assert args[19:] == (None,)
    assert tfs.LAUNCHES["append"] - before == 1


@pytest.mark.parametrize("k,t,cdt", [(1, 0, torch.float32),
                                     (16, 15, torch.bfloat16),
                                     (128, 64, torch.float32)])
def test_fr_append_wrapper_passes_the_same_arguments(recorder, k, t, cdt):
    B, n, m = 3, 1028, 8192
    pv, pi, Ac, Bs = _parts(B, n, m, cdt)
    st = tfs._init_fr(Bs, k, torch.ones(m))
    before = tfs.LAUNCHES["fr_append"]
    tfs.fr_append(pv, pi, Ac, Bs, st, t, 0.25, 0.5)
    (name, args), = recorder.calls
    assert name == "cstpu_fr_append"
    assert args[:6] == (pv.data_ptr(), pi.data_ptr(), 64, Ac.data_ptr(),
                        int(cdt == torch.bfloat16), Bs.data_ptr())
    assert args[6:15] == tuple(x.data_ptr() for x in (
        st.cols, st.Ginv, st.coef, st.idx, st.r, st.aperp, st.dinv,
        st.amask, st.done))
    assert args[15:20] == (B, n, m, k, t)
    assert args[20] == pytest.approx(tfs._degeneracy_rtol(n))
    assert args[21:] == (0.25, 0.5, None)
    assert tfs.LAUNCHES["fr_append"] - before == 1


def _first_n_over_budget(k):
    n = 1
    while tfs._append_smem(n, k) <= tfs.SMEM_MAX:
        n += 1
    return n


# (k, t, n): k beyond KMAX, t beyond the slots, and the first n past the
# shared-memory budget at k = 128 (41217) and at k = 1 (58108)
REFUSED = [(tfs.KMAX + 1, 0, 64), (8, 8, 64),
           (128, 0, _first_n_over_budget(128)),
           (1, 0, _first_n_over_budget(1))]


@pytest.mark.parametrize("k,t,n", REFUSED)
def test_append_wrappers_refuse_what_the_kernels_do_not_take(recorder, k, t,
                                                            n):
    B, m = 1, 256
    pv, pi, Ac, Bs = _parts(B, n, m)
    st, oi, oc = tfs._init_state(Bs, k, m)
    with pytest.raises(ValueError, match="outside"):
        tfs.omp_append(pv, pi, Ac, Bs, st, t, oi, oc)
    with pytest.raises(ValueError, match="outside"):
        tfs.fr_append(pv, pi, Ac, Bs, tfs._init_fr(Bs, k, torch.ones(m)), t,
                      0.0, 0.0)
    assert recorder.calls == []
