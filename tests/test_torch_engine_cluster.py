"""The slot engine's cluster kernels (csrc/rmp_append.cu, csrc/engine_init.cu:
a thread-block cluster per row, csrc/engine_cluster.cuh) as far as the CPU
can see them.

The kernels run only on the card, where tests/test_torch_kernels.py holds
them to their plain twins at every launch over chip_smoke.py's
ENGINE_CASES. Here:

- the twins (`_rmp_append_ref`, `_engine_init_ref` and the rest of the RMP,
  FoBa, OMPR and SRR solves) against cstpu's `_rmp_kernel`, `_foba_kernel`,
  `_ompr_kernel` and `_srr_kernel` in interpret mode at n = 1000 (which the
  card cuts into eight slices of 128 entries, the last 104), with a NaN
  row, a zero row (every score ties at 0: the init takes atoms 0..k-1, RMP
  and FoBa none), a column twin (atom 255 a copy of a planted atom: the
  rtol gate) and a FoBa row that deletes (atom 254 a noisy sum of the
  planted atoms, taken first and deleted once they are in);
- a plain-torch model of the init's order on the card (the picks' Gram and
  betas first, the appends as sweeps of that Gram, then the residual and
  the pending terms) against `_engine_init_ref`: idx and amask equal, the
  state within 1e-5 in f32;
- the kernels' residual, aperp and restore terms, summed over the live
  slots only (the occupied ones and the append's, in slot order), equal
  the sums over all K slots bit for bit at every step of a finite solve
  (a free slot's column is zero and its weight finite); a NaN row is NaN
  both ways;
- with a stand-in for the kernel library that records the C calls, the
  wrappers hand the C entries the arguments they always did, and refuse
  K > KMAX, cnt outside 1..min(LMAX, K) and an n beyond the shared-memory
  budget without launching.

Tolerances: supports and masks equal; coefficients and residuals to 1e-4
absolute (what cstpu holds its kernels to against its XLA paths), in f32
and in bf16 (both solve the bf16-rounded problem).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu.ops import fused_twostage as jft
from cstpu_torch.ops import fused_solve as tfs
from cstpu_torch.ops import fused_twostage as tft
from cstpu_torch.utils.interop import solution_to_numpy, to_torch
# the stand-in for the kernel library that records the C calls
from test_torch_latency_kernels import recorder  # noqa: F401

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
ATOL = 1e-4
N, M = 1000, 256


def _rows(seed, combo=True):
    """A (N, M) with atom 255 a copy of the planted atom j0 and (combo) atom
    254 a noisy sum of the three planted ones, and rows: the noisy planted
    measurement, a NaN row, a zero row, the same with j0 weighted up (its
    twin ties with it in the init's picks)."""
    from conftest import planted_problem

    A, x, b, y = (np.asarray(v) for v in planted_problem(
        seed, n=N, m=M, k=3, noise=5e-3, dtype=jnp.float32))
    A = A.copy()
    sup = np.flatnonzero(x)
    j0 = int(sup[0])
    A[:, 255] = A[:, j0]
    rng = np.random.default_rng(seed)
    if combo:
        s = A[:, sup] @ x[sup] + 0.6 * rng.standard_normal(N) / np.sqrt(N)
        A[:, 254] = s / np.linalg.norm(s)
    nan = y.copy()
    nan[7] = np.nan
    Bs = np.stack([y, nan, np.zeros_like(y), y + 2.0 * A[:, j0]])
    return A.astype(np.float32), Bs.astype(np.float32), j0


def _compare(tout, jout, atol=ATOL):
    t, j = solution_to_numpy(tout[0]), solution_to_numpy(jout[0])
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=0, atol=atol)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=0,
                               atol=atol)
    return t


def _kept(t, row):
    return set(t["idx"][row][t["mask"][row]].tolist())


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("solver", ["ompr", "srr"])
def test_init_twin_edge_rows_match_pallas(solver, cdt):
    # the init takes the top-4 of |b . A|: on the planted rows the twin of
    # j0 ties with it and is turned away by the rtol gate; the zero row
    # takes atoms 0..3; the NaN row none
    A, Bs, j0 = _rows(1201)
    if solver == "ompr":
        jout = jft.ompr_fused_solve(A, Bs, 4, 1e-6, corr_dtype=JDT[cdt],
                                    interpret=True)
        tout = tft.ompr_fused_solve_ref(to_torch(A), to_torch(Bs), 4, 1e-6,
                                        corr_dtype=TDT[cdt])
    else:
        jout = jft.srr_fused_solve(A, Bs, 4, maxiter=4, corr_dtype=JDT[cdt],
                                   interpret=True)
        tout = tft.srr_fused_solve_ref(to_torch(A), to_torch(Bs), 4,
                                       maxiter=4, corr_dtype=TDT[cdt])
    t = _compare(tout, jout)
    assert not t["mask"][1].any() and np.isnan(tout[1][1].numpy()).all()
    assert _kept(t, 2) == {0, 1, 2, 3}
    for row in (0, 3):
        assert j0 in _kept(t, row) and 255 not in _kept(t, row)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_rmp_twin_edge_rows_match_pallas(cdt):
    A, Bs, j0 = _rows(1202)
    jout = jft.rmp_fused_solve(A, Bs, delta=1e-2, kmax=8,
                               corr_dtype=JDT[cdt], interpret=True)
    tout = tft.rmp_fused_solve_ref(to_torch(A), to_torch(Bs), delta=1e-2,
                                   kmax=8, corr_dtype=TDT[cdt])
    t = _compare(tout, jout)
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    assert not tout[2].any()
    # the NaN row and the zero row (||r||^2 = 0 at the floor) append nothing
    assert not t["mask"][1:3].any() and np.isnan(tout[1][1].numpy()).all()
    assert j0 in _kept(t, 3) and 255 not in _kept(t, 3)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_foba_twin_deleting_row_matches_pallas(cdt, monkeypatch):
    # atom 254 (a noisy sum of the planted atoms) comes in first and goes
    # once the planted atoms are in: one deletion, on the planted rows
    A, Bs, j0 = _rows(1204)
    deleted = []
    original = tft._backward_loop_ref

    def spy(*args):
        nd = original(*args)
        deleted.append(nd.clone())
        return nd

    monkeypatch.setattr(tft, "_backward_loop_ref", spy)
    jout = jft.foba_fused_solve(A, Bs, 1e-2, kmax=8, corr_dtype=JDT[cdt],
                                interpret=True)
    tout = tft.foba_fused_solve_ref(to_torch(A), to_torch(Bs), 1e-2, kmax=8,
                                    corr_dtype=TDT[cdt])
    t = _compare(tout, jout)
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    nd = torch.stack(deleted).sum(0)
    assert nd[0] >= 1 and nd[3] >= 1 and nd[1] == nd[2] == 0, nd
    assert 254 not in _kept(t, 0) and not t["mask"][1:3].any()


# --------------------------------------------------------------------------
# The init's order on the card
# --------------------------------------------------------------------------

def _init_gram_model(pval, pidx, Ac, Bs, st, rtol):
    """The init as csrc/engine_cluster.cuh::init_cluster_row orders it, row
    by row in f32: the picks' Gram and betas first; the cnt gated appends as
    sweeps of that Gram (append j's gate reads M[j][j], the Schur complement
    of pick j against the accepted picks; u_j = M[Q][j]); Ginv = -M[Q][Q] on
    the accepted slots, identity beyond; Atb in the appends' order; coef =
    Ginv Atb; then r, prev and (SRR) the pending terms over the live slots.
    Writes `st` like `_engine_init_ref`."""
    vals, picks = tfs._merge_topl_vals(pval, pidx, pval.shape[2])
    B, K, n = st.cols.shape
    m = Ac.shape[1]
    cnt = picks.shape[1]
    for b in range(B):
        pk = picks[b].long()
        G = Ac[:, pk.clamp(max=m - 1)].T.float()                  # (cnt, n)
        gram, beta = G @ G.T, G @ Bs[b]
        Mw = gram.clone()
        acc, U, dinv, slots = [], [], [], []
        for j in range(cnt):
            u = torch.zeros(K)
            if acc:
                u[:len(acc)] = Mw[acc, j]
            U.append(u)
            dup = any(int(pk[q]) == int(pk[j]) for q in acc)
            d = Mw[j, j]
            ok = bool(vals[b, j] > -torch.inf) and not dup and bool(
                d > rtol * gram[j, j])
            slots.append(len(acc))
            dinv.append(1.0 / d if ok else torch.tensor(0.0))
            if ok:
                rd = 1.0 / d
                col = Mw[:, j].clone()
                Mw = Mw - torch.outer(col, col) * rd
                Mw[j, :] = col * rd
                Mw[:, j] = col * rd
                Mw[j, j] = -rd
                acc.append(j)
        r_ = len(acc)
        Ginv = torch.eye(K)
        if acc:
            Ginv[:r_, :r_] = -Mw[acc][:, acc]
        atb = torch.zeros(K)
        for j in range(cnt):
            atb = atb + beta[j] * torch.tensor(
                [1.0 if (j in acc and s == slots[j]) else 0.0
                 for s in range(K)])
        coef = Ginv @ atb
        cols = torch.zeros((K, n))
        cols[:r_] = G[acc]
        live = max(r_, 1)   # slot 0's zero column when nothing went in
        r = Bs[b] - (cols[:live] * coef[:live, None]).sum(0)
        st.cols[b], st.Ginv[b], st.coef[b], st.Atb[b] = cols, Ginv, coef, atb
        st.idx[b] = torch.tensor([int(pk[j]) for j in acc] + [m] * (K - r_),
                                 dtype=torch.int32)
        st.r[b] = r
        st.prev[b] = torch.sum(r * r)
        for j in acc:
            if int(pk[j]) < m:
                st.amask[b, int(pk[j])] = 1
        if st.resc is not None:
            for j in range(cnt):
                sl = slots[j] + 1
                st.pend_u[j, b] = G[j] - (cols[:sl] * U[j][:sl, None]).sum(0)
                st.pend_w[j, b] = -dinv[j]
    st.done.zero_()
    if st.fgate is not None:
        st.fgate.fill_(1.0)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("srr", [False, True])
def test_init_gram_order_matches_the_twin(cdt, srr):
    # no combination atom: the picks' Gram is well conditioned, so the two
    # orders agree to f32 rounding in absolute terms
    A, Bs, j0 = _rows(1205, combo=False)
    A, Bs = to_torch(A), to_torch(Bs)
    Ac = A.to(TDT[cdt]).float()
    k, K = 6, 8
    cn2 = torch.sum(A * A, dim=0) if srr else None
    pv, pi = tfs._topl_ref(Bs, Ac, TDT[cdt], k)
    st = tft._init_engine(Bs, K, M, cn2, npend=k)
    model = tft._EngState(*(None if x is None else x.clone() for x in st))
    tft._engine_init_ref(pv, pi, Ac, Bs, st)
    _init_gram_model(pv, pi, Ac, Bs, model, tfs._degeneracy_rtol(N))
    assert torch.equal(model.idx, st.idx)
    assert torch.equal(model.amask, st.amask)
    fields = ["cols", "Ginv", "coef", "Atb", "r", "prev", "done"]
    fields += ["pend_u", "pend_w", "fgate"] if srr else []
    for name in fields:
        a, b = getattr(model, name), getattr(st, name)
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        torch.testing.assert_close(a.nan_to_num(), b.nan_to_num(), rtol=0,
                                   atol=1e-5, msg=name)
    # on row 3 the column of j0 went in, its copy did not; the NaN row took
    # nothing
    assert j0 in st.idx[3].tolist() and 255 not in st.idx[3].tolist()
    assert not (st.idx[1] < M).any() and bool(torch.isnan(st.r[1]).all())


# --------------------------------------------------------------------------
# Sums over the live slots
# --------------------------------------------------------------------------

def _slot_sum(cols, w, slots):
    """sum_{s in slots} cols[:, s] * w[:, s] (slots (B, K) bool), added in
    slot order, as the kernels add it."""
    acc = torch.zeros_like(cols[:, 0])
    for s in range(cols.shape[1]):
        keep = slots[:, s, None]
        acc = torch.where(keep, acc + cols[:, s] * w[:, s, None], acc)
    return acc


def _same_or_both_nan(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("foba", [False, True])
def test_live_slot_sums_equal_all_slot_sums_bit_for_bit(foba, cdt,
                                                        monkeypatch):
    A, Bs, _ = _rows(1204)
    A, Bs = to_torch(A), to_torch(Bs)
    K = 8
    Ac = A.to(TDT[cdt]).float()
    cn2 = torch.sum(Ac * Ac, dim=0)
    floor2 = tfs._f32(64.0 * N * (1.1920929e-07 ** 2)) * torch.sum(Bs * Bs,
                                                                    dim=1)
    st = tft._init_engine(Bs, K, M, cn2, npend=K + 1, stepwise=True)
    every = torch.ones((Bs.shape[0], K), dtype=torch.bool)
    finite = torch.ones(Bs.shape[0], dtype=torch.bool)
    finite[1] = False
    seen = {"append": [], "delete": 0}
    append, delete = tft._engine_append_ref, tft._delete_ep_ref

    def spy_append(Ac_, Bs_, st_, sel, gate):
        slot = tft._lowest(st_.idx >= M, K)
        out = append(Ac_, Bs_, st_, sel, gate)
        seen["append"].append((slot, out))
        return out

    def spy_delete(st_, p, hasf, m):
        # v = cols' q over the occupied slots (p among them) before the
        # delete, against the sum over all K slots
        ep = torch.arange(K)[None, :] == p[:, None]
        q = torch.sum(st_.Ginv * ep[:, None, :].float(), dim=2)
        occ = st_.idx < m
        v_live = _slot_sum(st_.cols, q, occ)
        v_all = _slot_sum(st_.cols, q, every)
        rows = hasf & finite
        assert torch.equal(v_live[rows], v_all[rows])
        seen["delete"] += int(hasf.sum())
        return delete(st_, p, hasf, m)

    monkeypatch.setattr(tft, "_engine_append_ref", spy_append)
    monkeypatch.setattr(tft, "_delete_ep_ref", spy_delete)
    npend = 1
    for step in range(12):
        if not bool((st.fgate > 0.5).any()):
            break
        pv, pi = tfs._rescaled_select_ref(Ac, cn2, st.r, st.pend_u[:npend],
                                          st.pend_w[:npend], 1.0, st.amask,
                                          st.resc, TDT[cdt])
        tft._rmp_append_ref(pv, pi, Ac, Bs, st, 1e-4, floor2, foba)
        slot, (ok, acol, u, dinv) = seen["append"][-1]
        # the live slots: the occupied ones and the append's
        live = (st.idx < M) | (torch.arange(K)[None, :] == slot[:, None])
        r_live = Bs - _slot_sum(st.cols, st.coef, live)
        r_all = Bs - _slot_sum(st.cols, st.coef, every)
        assert _same_or_both_nan(r_live, r_all), step
        torch.testing.assert_close(r_live[finite], st.r[finite], rtol=0,
                                   atol=1e-5)
        if step == 0:
            assert bool(torch.isnan(r_live[1]).all())
        a_live = acol - _slot_sum(st.cols, u, live)
        a_all = acol - _slot_sum(st.cols, u, every)
        assert _same_or_both_nan(a_live, a_all), step
        npend = 1 + int(st.ndel.max()) if foba else 1
    assert step >= 4
    assert seen["delete"] >= (2 if foba else 0)


# --------------------------------------------------------------------------
# The wrappers' C calls
# --------------------------------------------------------------------------

def _inputs(B, n, m, cdt=torch.bfloat16, l=0):
    T = -(-m // tfs.TILE)
    shape = (B, T, l) if l else (B, T)
    return (torch.zeros(shape), torch.zeros(shape, dtype=torch.int32),
            torch.zeros((n, m), dtype=cdt), torch.randn((B, n)))


@pytest.mark.parametrize("K,cdt,foba", [(1, torch.bfloat16, False),
                                        (32, torch.float32, True),
                                        (128, torch.bfloat16, True)])
def test_rmp_append_wrapper_passes_the_same_arguments(recorder, K, cdt, foba):
    B, n, m = 3, 1000, 8264
    pv, pi, Ac, Bs = _inputs(B, n, m, cdt)
    st = tft._init_engine(Bs, K, m, torch.ones(m), npend=K + 1,
                          stepwise=True)
    floor2 = torch.ones(B)
    before = tfs.LAUNCHES["rmp_append"]
    tft.rmp_append(pv, pi, Ac, Bs, st, 0.25, floor2, foba)
    (name, args), = recorder.calls
    assert name == "cstpu_rmp_append"
    assert args[:6] == (pv.data_ptr(), pi.data_ptr(), 65, Ac.data_ptr(),
                        int(cdt == torch.bfloat16), Bs.data_ptr())
    assert args[6:14] == tuple(x.data_ptr() for x in (
        st.cols, st.Ginv, st.coef, st.idx, st.Atb, st.r, st.amask, st.done))
    assert args[14:21] == tuple(x.data_ptr() for x in (
        st.pend_u, st.pend_w, st.fgate, st.acc, st.capped, st.ndel, floor2))
    assert args[21:25] == (B, n, m, K)
    assert args[25] == pytest.approx(tfs._degeneracy_rtol(n))
    assert args[26:] == (0.25, int(foba), None)
    assert tfs.LAUNCHES["rmp_append"] - before == 1


@pytest.mark.parametrize("cnt,K,srr", [(1, 2, False), (32, 33, False),
                                       (16, 17, True), (32, 128, True)])
def test_engine_init_wrapper_passes_the_same_arguments(recorder, cnt, K, srr):
    B, n, m = 3, 1028, 8192
    pv, pi, Ac, Bs = _inputs(B, n, m, torch.float32, l=cnt)
    st = tft._init_engine(Bs, K, m, torch.ones(m) if srr else None,
                          npend=cnt)
    before = tfs.LAUNCHES["engine_init"]
    tft.engine_init(pv, pi, Ac, Bs, st)
    (name, args), = recorder.calls
    assert name == "cstpu_engine_init"
    assert args[:7] == (pv.data_ptr(), pi.data_ptr(), 64, cnt,
                        Ac.data_ptr(), 0, Bs.data_ptr())
    assert args[7:16] == tuple(x.data_ptr() for x in (
        st.cols, st.Ginv, st.coef, st.idx, st.Atb, st.r, st.amask, st.done,
        st.prev))
    srr_ptrs = (st.pend_u.data_ptr(), st.pend_w.data_ptr(),
                st.fgate.data_ptr()) if srr else (None, None, None)
    assert args[16:19] == srr_ptrs
    assert args[19:23] == (B, n, m, K)
    assert args[23] == pytest.approx(tfs._degeneracy_rtol(n))
    assert args[24:] == (None,)
    assert tfs.LAUNCHES["engine_init"] - before == 1


def _first_n_over_budget(K):
    n = 1
    while tft._engine_smem(n, K) <= tfs.SMEM_MAX:
        n += 1
    return n


# (K, cnt, n): K beyond KMAX, cnt beyond K, beyond LMAX, and 0, and the
# first n past the shared-memory budget at K = 128 (40705) and at K = 33
@pytest.mark.parametrize("K,cnt,n", [(tfs.KMAX + 1, 1, 64), (4, 5, 64),
                                     (40, tfs.LMAX + 1, 64), (4, 0, 64),
                                     (128, 1, _first_n_over_budget(128)),
                                     (33, 32, _first_n_over_budget(33))])
def test_engine_wrappers_refuse_what_the_kernels_do_not_take(recorder, K,
                                                            cnt, n):
    B, m = 1, 256
    pv, pi, Ac, Bs = _inputs(B, n, m)
    floor2 = torch.ones(B)
    if K > tfs.KMAX or n > 64:
        with pytest.raises(ValueError, match="outside"):
            tft.rmp_append(pv, pi, Ac, Bs, tft._init_engine(
                Bs, K, m, torch.ones(m), npend=K + 1, stepwise=True), 0.25,
                floor2, False)
    pv3, pi3 = (torch.zeros((B, 2, max(cnt, 1))),
                torch.zeros((B, 2, max(cnt, 1)), dtype=torch.int32))
    if cnt == 0:
        pv3, pi3 = pv3[:, :, :0], pi3[:, :, :0]
    with pytest.raises(ValueError, match="outside"):
        tft.engine_init(pv3, pi3, Ac, Bs, tft._init_engine(Bs, K, m))
    assert recorder.calls == []
