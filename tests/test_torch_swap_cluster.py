"""GOMP's iteration and OMPR's replacement as thread-block clusters per row
(csrc/gomp_append.cu, csrc/ompr_swap.cu on csrc/gomp_ompr_cluster.cuh) as
far as the CPU can see them.

The kernels run only on the card, where tests/test_torch_kernels.py holds
them to their plain twins at every launch over chip_smoke.py's GOMP_CASES
and SWAP_CASES. Here:

- the twins (`_gomp_append_ref`, `_ompr_swap_ref` and the rest of the GOMP
  and OMPR solves) against cstpu's `_gomp_kernel` and `_ompr_kernel` in
  interpret mode at n = 1000 (which the card cuts into eight slices of 128
  entries, the last 104), with a NaN row, a zero row, a column twin (atom
  255 a copy of a planted atom: the rtol gate) and, for OMPR, rows whose
  appended atom is deleted at once;
- plain-torch models of the kernels' orders against the twins: GOMP's cross
  terms, the picks' Gram and the betas first (summed over C slices in rank
  order, in rounds of R picks), then the cnt gated appends on the K x K
  state, the writes last; OMPR's 2K + 3 products summed over C slices in
  rank order, then the append, the gradient step, the deletion and the
  refit on the K-sized state, r over the live slots. idx, kcnt, amask and
  done equal, the state within 1e-5 in f32;
- the residual summed over the live slots (GOMP: slots < kcnt; OMPR: idx <
  m after the deletion) equals the sum over all K slots bit for bit at
  every iteration of a finite solve, deletions included; a NaN row is NaN
  both ways;
- with a stand-in for the kernel library that records the C calls, the
  wrappers hand cstpu_gomp_append and cstpu_ompr_swap the arguments they
  always did, and refuse k or K beyond KMAX, cnt outside 1..LMAX and an n
  beyond the shared-memory budget without launching.

Tolerances: supports and masks equal; coefficients and residuals to 1e-4
absolute against cstpu (what cstpu holds its kernels to against its XLA
paths), in f32 and in bf16 (both solve the bf16-rounded problem); the
models to 1e-5 against the twins (f32, well-conditioned picks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu.ops import fused_solve as jfs
from cstpu.ops import fused_twostage as jft
from cstpu_torch.ops import fused_solve as tfs
from cstpu_torch.ops import fused_twostage as tft
from cstpu_torch.utils.interop import solution_to_numpy, to_torch
# the stand-in for the kernel library that records the C calls
from test_torch_latency_kernels import recorder  # noqa: F401

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
ATOL = 1e-4
MODEL_ATOL = 1e-5
N, M = 1000, 256


def _rows(seed, k=3):
    """A (N, M) with atom 255 a copy of the planted atom j0, and rows: the
    noisy planted measurement, a NaN row, a zero row, the same with j0
    weighted up (its twin ties with it in the picks)."""
    from conftest import planted_problem

    A, x, b, y = (np.asarray(v) for v in planted_problem(
        seed, n=N, m=M, k=k, noise=5e-3, dtype=jnp.float32))
    A = A.copy()
    j0 = int(np.flatnonzero(x)[0])
    A[:, 255] = A[:, j0]
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


def _slices(n, C):
    """The card's slices of n for a C-block cluster: (p0, p1) by rank."""
    S = ((n + C - 1) // C + 3) & ~3
    return [(min(n, r * S), min(n, (r + 1) * S)) for r in range(C)]


def _rank_sum(X, Y, C):
    """X @ Y' with the products of each of C slices of n formed apart and
    added in rank order, as a cluster adds its blocks' partials."""
    acc = None
    for p0, p1 in _slices(X.shape[1], C):
        part = X[:, p0:p1] @ Y[:, p0:p1].T
        acc = part if acc is None else acc + part
    return acc


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


def _close(a, b, name, atol=MODEL_ATOL):
    assert torch.equal(torch.isnan(a), torch.isnan(b)), name
    torch.testing.assert_close(a.nan_to_num(), b.nan_to_num(), rtol=0,
                               atol=atol, msg=name)


# --------------------------------------------------------------------------
# The twins against cstpu's kernels at n = 1000
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("l,k", [(2, 5), (4, 8)])
def test_gomp_twin_edge_rows_match_pallas(cdt, l, k):
    # the NaN row takes nothing; on the planted rows the twin of j0 ties
    # with it and is turned away by the rtol gate without using a slot
    A, Bs, j0 = _rows(1301)
    jout = jfs.gomp_fused_solve(A, Bs, l, k, corr_dtype=JDT[cdt],
                                interpret=True)
    tout = tfs.gomp_fused_solve_ref(to_torch(A), to_torch(Bs), l, k,
                                    corr_dtype=TDT[cdt])
    t = _compare(tout, jout)
    assert not t["mask"][1].any() and np.isnan(tout[1][1].numpy()).all()
    # the zero row's scores tie at 0 in every iteration: atoms 0..l-1
    # first, then the same ones again, duplicates
    assert _kept(t, 2) == set(range(l))
    for row in (0, 3):
        assert j0 in _kept(t, row) and 255 not in _kept(t, row)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_ompr_twin_edge_rows_match_pallas(cdt, monkeypatch):
    # on the planted rows the init takes the planted atoms (j0's twin
    # turned away) and the first swap's appended atom, the best passive one
    # at the noise level, has the least |gcoef|: it goes at once
    A, Bs, j0 = _rows(1302)
    appended, deleted = [], []
    append, delete = tft._engine_append_ref, tft._delete_ep_ref

    def spy_append(Ac_, Bs_, st_, sel, gate):
        appended.append(tft._lowest(st_.idx >= M, st_.idx.shape[1]))
        return append(Ac_, Bs_, st_, sel, gate)

    def spy_delete(st_, p, hasf, m):
        deleted.append(torch.where(hasf, p, -1))
        return delete(st_, p, hasf, m)

    monkeypatch.setattr(tft, "_engine_append_ref", spy_append)
    monkeypatch.setattr(tft, "_delete_ep_ref", spy_delete)
    jout = jft.ompr_fused_solve(A, Bs, 4, 1e-6, corr_dtype=JDT[cdt],
                                interpret=True)
    tout = tft.ompr_fused_solve_ref(to_torch(A), to_torch(Bs), 4, 1e-6,
                                    corr_dtype=TDT[cdt])
    t = _compare(tout, jout)
    assert not t["mask"][1].any() and np.isnan(tout[1][1].numpy()).all()
    assert _kept(t, 2) == {0, 1, 2, 3}
    for row in (0, 3):
        assert j0 in _kept(t, row) and 255 not in _kept(t, row)
    # the swaps' appends follow the init's 4; their slot deleted at once
    swap_slots = torch.stack(appended[4:])
    gone = torch.stack(deleted)
    assert bool((gone == swap_slots)[:, [0, 3]].any())


# --------------------------------------------------------------------------
# GOMP's order on the card
# --------------------------------------------------------------------------

def _gomp_cluster_model(pval, pidx, Ac, Bs, st, cap, eps2, C, R):
    """gomp_append as csrc/gomp_ompr_cluster.cuh::gomp_cluster_row orders
    it, row by row in f32: the picks merged; per round of R picks, the
    products of the old slot columns, the picks up to the round's last and
    b with the round's picks, over C slices added in rank order; the
    round's gated appends on Ginv and coef, g of pick j its cross terms
    with the old slots and its Gram entries with the picks put in before
    it; then the new columns, r = b - cols' coef over slots < kcnt in slot
    order, and the latch. Writes `st` like `_gomp_append_ref`."""
    B, k, n = st.cols.shape
    m = Ac.shape[1]
    cnt = pval.shape[2]
    picks = tfs._merge_topl(pval, pidx, cnt)
    rtol = tfs._f32(tfs._degeneracy_rtol(n))
    for b in range(B):
        kold = int(st.kcnt[b])
        latched = bool(st.done[b] > 0.5)
        pk = picks[b].long()
        G = Ac[:, pk.clamp(max=m - 1)].T.float()                   # (cnt, n)
        Ginv, coef = st.Ginv[b].clone(), st.coef[b].clone()
        idx = st.idx[b].clone()
        kc, pof = kold, {}
        for j0 in range(0, cnt, R):
            j1 = min(cnt, j0 + R)
            X = torch.cat([st.cols[b, :kold], G[:j1], Bs[b][None]])
            P = _rank_sum(X, G[j0:j1], C)              # (kold + j1 + 1, Rr)
            for c in range(j1 - j0):
                j = j0 + c
                g = torch.zeros(k)
                g[:kold] = P[:kold, c]
                for q in range(kold, kc):
                    g[q] = P[kold + pof[q], c]
                u = Ginv @ g
                dup = bool((idx == pk[j]).any())
                d = P[kold + j, c] - g @ u
                slot = kc
                ok = (slot < cap and not latched and not dup
                      and bool(d > rtol * P[kold + j, c]))
                dinv = (1.0 if ok else 0.0) / (d if d > 0 else 1.0)
                step = dinv * (P[kold + j1, c] - g @ coef)
                w = u.clone()
                e = torch.zeros(k)
                if slot < k:
                    w[slot] -= 1.0
                    e[slot] = 1.0 if ok else 0.0
                Ginv = Ginv + dinv * torch.outer(w, w) - torch.outer(e, e)
                coef = coef - step * w
                if ok:
                    idx[slot] = int(pk[j])
                    pof[slot] = j
                    kc += 1
        for s in range(kold, kc):
            st.cols[b, s] = G[pof[s]]
        live = torch.arange(k) < kc
        if kc == 0:
            live[0] = True   # slot 0's zero column: a NaN row stays NaN
        r = Bs[b] - _slot_sum(st.cols[b:b + 1], coef[None], live[None])[0]
        st.Ginv[b], st.coef[b], st.idx[b], st.r[b] = Ginv, coef, idx, r
        st.kcnt[b] = kc
        rr = sum(torch.sum(r[p0:p1] * r[p0:p1]) for p0, p1 in _slices(n, C))
        if bool(rr < tfs._f32(eps2)) or kc >= n:
            st.done[b] = 1.0


@pytest.mark.parametrize("C,R", [(1, 32), (8, 32), (8, 2), (2, 1)])
@pytest.mark.parametrize("l,k", [(3, 8), (4, 12)])
def test_gomp_cluster_order_matches_the_twin(C, R, l, k):
    # every iteration of a GOMP solve from identical state, the remainder
    # iteration included: one launch's partials at once (R = 32) and in
    # rounds of 2 and 1 picks; row 0 is latched by eps after its first
    # iteration, a row of the column twin turns it away
    A, Bs, j0 = _rows(1303)
    A, Bs = to_torch(A), to_torch(Bs)
    m = A.shape[1]
    st = tfs._init_gomp(Bs, k, m)
    eps2 = float(torch.sum((Bs[0] - Bs[0].mean()) ** 2)) * 1e-2
    counts = [l] * (k // l) + ([k % l] if k % l else [])
    for it, cnt in enumerate(counts):
        if it == len(counts) - 1 and k % l:
            st.done.zero_()
        pv, pi = tfs._topl_ref(st.r, A, torch.float32, cnt)
        model = tfs._GompState(*(x.clone() for x in st))
        tfs._gomp_append_ref(pv, pi, A, Bs, st, k, eps2)
        _gomp_cluster_model(pv, pi, A, Bs, model, k, eps2, C, R)
        for name in ("idx", "kcnt", "done"):
            assert torch.equal(getattr(model, name), getattr(st, name)), name
        for name in ("cols", "Ginv", "coef", "r"):
            _close(getattr(model, name), getattr(st, name), name)
    assert not (st.idx[1] < m).any() and bool(torch.isnan(st.r[1]).all())
    assert int(st.idx[3, 0]) == j0 and 255 not in st.idx[3].tolist()
    assert float(st.done[0]) == 1.0


# --------------------------------------------------------------------------
# OMPR's order on the card
# --------------------------------------------------------------------------

def _swap_cluster_model(pval, pidx, Ac, Bs, st, eta, delta2, C):
    """ompr_swap as csrc/gomp_ompr_cluster.cuh::swap_cluster_row orders it,
    row by row in f32 on the rows that are not done: the pick reduced; the
    products of the occupied slot columns, acol and b with acol and r (r
    before the append) over C slices added in rank order; the gated append
    into the first free slot (u = Ginv g), the gradient step's scores
    |coef_pre + eta gr| on the slots occupied after it, the deletion of the
    least (lowest slot on ties, none on a NaN minimum; where that is the
    appended atom, Ginv and Atb stay as they were), the refit; then the
    columns and r = b - cols' coef over the live slots in slot order, res,
    the latch and prev. Writes `st` like `_ompr_swap_ref`; returns the rows
    whose appended atom was the one deleted."""
    B, K, n = st.cols.shape
    m = Ac.shape[1]
    rtol = tfs._f32(tfs._degeneracy_rtol(n))
    eta = tfs._f32(eta)
    best, sel = tfs._reduce_partials(pval, pidx)
    own = []
    for b in range(B):
        if bool(st.done[b] > 0.5):
            continue
        idx = st.idx[b].clone()
        occ = idx < m
        lst = torch.nonzero(occ)[:, 0]
        nat = len(lst)
        free = torch.nonzero(~occ)[:, 0]
        slot = int(free[0]) if len(free) else K
        s = int(sel[b])
        acol = Ac[:, min(s, m - 1)].float()
        X = torch.cat([st.cols[b, lst], acol[None], Bs[b][None]])
        P = _rank_sum(X, torch.stack([acol, st.r[b]]), C)       # (nat + 2, 2)
        g = torch.zeros(K)
        g[lst] = P[:nat, 0]
        gr = torch.zeros(K)
        gr[lst] = P[:nat, 1]
        Ginv, atb, coef_pre = st.Ginv[b].clone(), st.Atb[b].clone(), st.coef[b]
        u = Ginv @ g
        ata, ar, beta = P[nat, 0], P[nat, 1], P[nat + 1, 0]
        change = bool(best[b] > 0)
        dup = bool((idx == s).any())
        d = ata - g @ u
        ok = change and slot < K and not dup and bool(d > rtol * ata)
        dinv = (1.0 if ok else 0.0) / (d if d > 0 else 1.0)
        score = torch.full((K,), torch.inf)
        if ok:
            act = occ.clone()
            act[slot] = True
            gr[slot] = ar
            gcoef = coef_pre * occ.float() + eta * gr
            score = torch.where(act, gcoef.abs(), torch.inf)
        dmin = score.amin()
        hits = torch.nonzero(score == dmin)[:, 0]
        p = int(hits[0]) if len(hits) else K
        hasf = ok and bool(dmin < torch.inf)
        if hasf and p == slot:
            own.append(b)
        w = u.clone()
        e = torch.zeros(K)
        if slot < K:
            w[slot] -= 1.0
            e[slot] = 1.0 if ok else 0.0
        cancel = hasf and p == slot   # the append and the deletion cancel
        if not cancel:
            Ginv = Ginv + dinv * torch.outer(w, w) - torch.outer(e, e)
            atb = atb + beta * e
        cols = st.cols[b].clone()
        if ok:
            idx[slot] = s
            cols[slot] = acol
            if s < m:
                st.amask[b, s] = 1
        if hasf and not cancel:
            q = Ginv[:, p].clone()
            inv = 1.0 / (q[p] if q[p] > 0 else 1.0)
            ep = torch.zeros(K)
            ep[p] = 1.0
            Ginv = Ginv - inv * torch.outer(q, q) + torch.outer(ep, ep)
            atb[p] = atb[p] * 0.0
        if hasf:
            if idx[p] < m:
                st.amask[b, int(idx[p])] = 0
            idx[p] = m
            cols[p] = cols[p] * 0.0
        coef = Ginv @ atb
        live = idx < m
        if not bool(live.any()):
            live[0] = True   # slot 0's zero column: a NaN row stays NaN
        r = Bs[b] - _slot_sum(cols[None], coef[None], live[None])[0]
        rr = sum(torch.sum(r[p0:p1] * r[p0:p1]) for p0, p1 in _slices(n, C))
        prev = st.prev[b].clone()
        res = rr if ok else prev
        if not change or bool(res <= tfs._f32(delta2)) or bool(prev <= res):
            st.done[b] = 1.0
        st.prev[b] = res
        st.cols[b], st.Ginv[b], st.coef[b], st.idx[b] = cols, Ginv, coef, idx
        st.Atb[b], st.r[b] = atb, r
    return own


def _ompr_states(seed, k):
    """A noisy OMPR problem on _rows' dictionary, after the twin's init:
    rows 0 and 3 planted, 1 a NaN row, 2 a zero row; row 4 planted with a
    noise level that keeps it swapping; the dictionary in f32."""
    A, Bs, j0 = _rows(seed)
    rng = np.random.default_rng(seed)
    extra = Bs[0] + 0.3 * rng.standard_normal(N).astype(np.float32) / np.sqrt(N)
    Bs = np.concatenate([Bs, extra[None]]).astype(np.float32)
    A, Bs = to_torch(A), to_torch(Bs)
    st = tft._init_engine(Bs, k + 1, M)
    tft._engine_init_ref(*tfs._topl_ref(Bs, A, torch.float32, k), A, Bs, st)
    return A, Bs, st, j0


@pytest.mark.parametrize("C", [1, 2, 8])
@pytest.mark.parametrize("k", [4, 8])
def test_swap_cluster_order_matches_the_twin(C, k):
    # every swap of an OMPR solve from identical state; a pick the row
    # already holds (a duplicate), the twin of j0 (the rtol gate) and a row
    # whose select found nothing (change false) by hand at swap 1, and at
    # swap 2 row 4's passive atom nearest to orthogonal to its residual,
    # whose |gcoef| is the least: the appended atom deleted at once. The latch is compared
    # where res moved clearly from prev (a swap that restores the support
    # ties the two to rounding: the known rounding-tie rule), and on the
    # rows where nothing went in
    A, Bs, st, j0 = _ompr_states(1304, k)
    own = []
    for step in range(4):
        pv, pi = tfs._select_ref(st.r, A, torch.float32, False, st.amask, 1.0)
        if step == 1:
            pv[0], pi[0] = 1.0, int(st.idx[0, 0])   # a duplicate
            pv[3], pi[3] = 1.0, 255                  # j0's twin
            pv[4] = -1.0                             # nothing passive
            st.done[[0, 3, 4]] = 0.0
        if step == 2:
            sc = torch.where(st.amask[4] > 0, torch.inf, (st.r[4] @ A).abs())
            pv[4], pi[4] = 1.0, int(sc[:255].argmin())   # not j0's twin
            st.done[4] = 0.0
        model = tft._EngState(*(None if x is None else x.clone() for x in st))
        prev0, idx0 = st.prev.clone(), st.idx.clone()
        tft._ompr_swap_ref(pv, pi, A, Bs, st, 1.0, 0.0)
        own += _swap_cluster_model(pv, pi, A, Bs, model, 1.0, 0.0, C)
        for name in ("idx", "amask"):
            assert torch.equal(getattr(model, name), getattr(st, name)), name
        clear = (st.prev - prev0).abs() > 1e-5 * prev0.abs()
        assert torch.equal(model.done[clear], st.done[clear])
        for name in ("cols", "Ginv", "coef", "Atb", "r", "prev"):
            _close(getattr(model, name), getattr(st, name), name)
        if step == 1:
            assert torch.equal(st.idx[[0, 3, 4]], idx0[[0, 3, 4]])
            assert st.done[[0, 3, 4]].tolist() == [1.0, 1.0, 1.0]
            assert model.done[[0, 3, 4]].tolist() == [1.0, 1.0, 1.0]
    assert 4 in own
    assert bool(torch.isnan(st.r[1]).all()) and float(st.done[1]) == 1.0


# --------------------------------------------------------------------------
# Sums over the live slots
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_gomp_live_slot_residual_equals_all_slots_bit_for_bit(cdt):
    A, Bs, _ = _rows(1305)
    A, Bs = to_torch(A), to_torch(Bs)
    k, l = 9, 4
    Ac = A.to(TDT[cdt]).float()
    st = tfs._init_gomp(Bs, k, M)
    every = torch.ones((Bs.shape[0], k), dtype=torch.bool)
    finite = torch.ones(Bs.shape[0], dtype=torch.bool)
    finite[1] = False
    for cnt in (l, l, k % l):
        tfs._gomp_append_ref(*tfs._topl_ref(st.r, Ac, TDT[cdt], cnt), Ac, Bs,
                             st, k, 0.0)
        live = torch.arange(k)[None, :] < st.kcnt[:, None]
        live[:, 0] |= st.kcnt == 0
        r_live = Bs - _slot_sum(st.cols, st.coef, live)
        r_all = Bs - _slot_sum(st.cols, st.coef, every)
        assert _same_or_both_nan(r_live, r_all)
        torch.testing.assert_close(r_live[finite], st.r[finite], rtol=0,
                                   atol=1e-5)
        assert bool(torch.isnan(r_live[1]).all())


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_ompr_live_slot_residual_equals_all_slots_bit_for_bit(cdt,
                                                              monkeypatch):
    A, Bs, st, _ = _ompr_states(1306, 4)
    K = st.idx.shape[1]
    Ac = A.to(TDT[cdt]).float()
    every = torch.ones((Bs.shape[0], K), dtype=torch.bool)
    finite = torch.ones(Bs.shape[0], dtype=torch.bool)
    finite[1] = False
    seen = {"deletes": 0}
    delete = tft._delete_ep_ref

    def spy_delete(st_, p, hasf, m):
        seen["deletes"] += int(hasf.sum())
        return delete(st_, p, hasf, m)

    monkeypatch.setattr(tft, "_delete_ep_ref", spy_delete)
    for _ in range(4):
        pv, pi = tfs._select_ref(st.r, Ac, TDT[cdt], False, st.amask, 1.0)
        st.done.zero_()   # every row swaps, the latched ones too
        tft._ompr_swap_ref(pv, pi, Ac, Bs, st, 1.0, 0.0)
        live = st.idx < M
        live[:, 0] |= ~live.any(1)
        r_live = Bs - _slot_sum(st.cols, st.coef, live)
        r_all = Bs - _slot_sum(st.cols, st.coef, every)
        assert _same_or_both_nan(r_live, r_all)
        torch.testing.assert_close(r_live[finite], st.r[finite], rtol=0,
                                   atol=1e-5)
        assert bool(torch.isnan(r_live[1]).all())
    assert seen["deletes"] >= 4


# --------------------------------------------------------------------------
# The wrappers' C calls
# --------------------------------------------------------------------------

def _parts(B, n, m, cdt=torch.bfloat16, l=0):
    T = -(-m // tfs.TILE)
    shape = (B, T, l) if l else (B, T)
    return (torch.zeros(shape), torch.zeros(shape, dtype=torch.int32),
            torch.zeros((n, m), dtype=cdt), torch.randn((B, n)))


@pytest.mark.parametrize("k,cnt,cdt", [(1, 1, torch.bfloat16),
                                       (32, 4, torch.float32),
                                       (8, 32, torch.bfloat16),
                                       (128, 32, torch.float32)])
def test_gomp_append_wrapper_passes_the_same_arguments(recorder, k, cnt,
                                                       cdt):
    B, n, m = 3, 1028, 8264
    pv, pi, Ac, Bs = _parts(B, n, m, cdt, l=cnt)
    st = tfs._init_gomp(Bs, k, m)
    before = tfs.LAUNCHES["gomp_append"]
    tfs.gomp_append(pv, pi, Ac, Bs, st, min(n, k), 0.25)
    (name, args), = recorder.calls
    assert name == "cstpu_gomp_append"
    assert args[:7] == (pv.data_ptr(), pi.data_ptr(), 65, cnt, Ac.data_ptr(),
                        int(cdt == torch.bfloat16), Bs.data_ptr())
    assert args[7:14] == tuple(x.data_ptr() for x in st)
    assert args[14:19] == (B, n, m, k, min(n, k))
    assert args[19] == pytest.approx(tfs._degeneracy_rtol(n))
    assert args[20:] == (0.25, None)
    assert tfs.LAUNCHES["gomp_append"] - before == 1


@pytest.mark.parametrize("K,cdt", [(2, torch.bfloat16), (33, torch.float32),
                                   (128, torch.bfloat16)])
def test_ompr_swap_wrapper_passes_the_same_arguments(recorder, K, cdt):
    B, n, m = 3, 1000, 8192
    pv, pi, Ac, Bs = _parts(B, n, m, cdt)
    st = tft._init_engine(Bs, K, m)
    before = tfs.LAUNCHES["ompr_swap"]
    tft.ompr_swap(pv, pi, Ac, Bs, st, 0.5, 1e-6)
    (name, args), = recorder.calls
    assert name == "cstpu_ompr_swap"
    assert args[:6] == (pv.data_ptr(), pi.data_ptr(), 64, Ac.data_ptr(),
                        int(cdt == torch.bfloat16), Bs.data_ptr())
    assert args[6:15] == tuple(x.data_ptr() for x in (
        st.cols, st.Ginv, st.coef, st.idx, st.Atb, st.r, st.amask, st.done,
        st.prev))
    assert args[15:19] == (B, n, m, K)
    assert args[19] == pytest.approx(tfs._degeneracy_rtol(n))
    assert args[20:] == (0.5, 1e-6, None)
    assert tfs.LAUNCHES["ompr_swap"] - before == 1


def _first_n_over(smem, k):
    n = 1
    while smem(n, k) <= tfs.SMEM_MAX:
        n += 1
    return n


# (k, cnt, n): k beyond KMAX, cnt beyond LMAX and 0, and the first n past
# the shared-memory budget at k = 128 (41217) and at k = 8
@pytest.mark.parametrize("k,cnt,n", [
    (tfs.KMAX + 1, 1, 64), (8, tfs.LMAX + 1, 64), (8, 0, 64),
    (128, 32, _first_n_over(tfs._append_smem, 128)),
    (8, 4, _first_n_over(tfs._append_smem, 8))])
def test_gomp_append_wrapper_refuses_what_the_kernel_does_not_take(
        recorder, k, cnt, n):
    B, m = 1, 256
    pv, pi, Ac, Bs = _parts(B, n, m, l=max(cnt, 1))
    if cnt == 0:
        pv, pi = pv[:, :, :0], pi[:, :, :0]
    with pytest.raises(ValueError, match="outside"):
        tfs.gomp_append(pv, pi, Ac, Bs, tfs._init_gomp(Bs, k, m), k, 0.0)
    assert recorder.calls == []


# (K, n): K beyond KMAX, and the first n past the shared-memory budget at
# K = 128 (40705) and at K = 33
@pytest.mark.parametrize("K,n", [(tfs.KMAX + 1, 64),
                                 (128, _first_n_over(tft._engine_smem, 128)),
                                 (33, _first_n_over(tft._engine_smem, 33))])
def test_ompr_swap_wrapper_refuses_what_the_kernel_does_not_take(recorder, K,
                                                                 n):
    B, m = 1, 256
    pv, pi, Ac, Bs = _parts(B, n, m)
    with pytest.raises(ValueError, match="outside"):
        tft.ompr_swap(pv, pi, Ac, Bs, tft._init_engine(Bs, K, m), 1.0, 0.0)
    assert recorder.calls == []
