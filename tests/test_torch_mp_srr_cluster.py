"""MP's update as a grid of several blocks per row (csrc/mp_update.cu) and
SRR's forward step on the slot engine's cluster (csrc/srr_append.cu on
csrc/engine_cluster.cuh's SRR mode) as far as the CPU can see them.

The kernels run only on the card, where tests/test_torch_kernels.py holds
them to their plain twins at every launch over chip_smoke.py's MP_CASES and
SRR_CASES. Here:

- a plain-torch model of the sliced mp_update (each of C slices of n
  reduces the row's partials itself, lane by lane then by a butterfly of
  xor shuffles, and updates its own slice; slice 0 updates x) against
  `_mp_update_ref`, bit for bit in f32, with a NaN row, partials tied
  across tiles and n not a multiple of the slices (1000, 1028);
- `mp_fused_solve_ref` against cstpu's `_mp_kernel` in interpret mode at
  n = 1000 with a NaN row;
- a plain-torch model of `rmp_cluster_row`'s order in the SRR mode (the
  products of the occupied slot columns, the column, b and r summed over C
  slices in rank order, the gate without a floor, the append, the refit
  and the pending term over the live slots) against `_srr_append_ref`:
  idx, amask and fgate equal, the state within 1e-5 in f32, on a NaN row,
  a zero row, closed rows (done, forward gate shut) and a full state;
- with a stand-in for the kernel library that records the C calls, the
  wrappers hand cstpu_mp_update and cstpu_srr_append the arguments they
  always did, and refuse an out-of-domain K or n without launching;
- chip_smoke.union_ms, the device busy time of `profile_path`: spans that
  overlap count once, spans one after another add up.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cstpu.ops import fused_solve as jfs
from cstpu_torch.ops import fused_solve as tfs
from cstpu_torch.ops import fused_twostage as tft
from cstpu_torch.utils.interop import to_torch
# the stand-in for the kernel library that records the C calls
from test_torch_latency_kernels import recorder  # noqa: F401

INT_MAX = tfs.INT_MAX
NAN = float("nan")
MODEL_ATOL = 1e-5
M = 512


def _slices(n, C):
    """The kernels' slices of n for C blocks a row: (p0, p1) by rank."""
    S = ((n + C - 1) // C + 3) & ~3
    return [(min(n, r * S), min(n, (r + 1) * S)) for r in range(C)]


# --------------------------------------------------------------------------
# mp_update
# --------------------------------------------------------------------------

def _combine(a, b):
    """common.cuh::argmax_combine with its payload on (value, index, signed
    score) triples of tensors: the larger value, the lower index on ties,
    (NaN, INT_MAX, NaN) where either value is NaN."""
    (v, i, s), (v2, i2, s2) = a, b
    nan = torch.isnan(v) | torch.isnan(v2)
    take = (v2 > v) | ((v2 == v) & (i2 < i))
    return (torch.where(nan, NAN, torch.where(take, v2, v)),
            torch.where(nan, INT_MAX, torch.where(take, i2, i)),
            torch.where(nan, NAN, torch.where(take, s2, s)))


def _warp_pick(pval, pidx, psig):
    """One warp's pick from a row's (B, T) partials as mp_update.cu takes
    it: lane l combines partials l, l + 32, ... in turn, then five rounds of
    xor shuffles. Every lane ends with the same triple; returns lane 0's."""
    B, T = pval.shape
    T32 = -(-T // 32) * 32
    pad = (0, T32 - T)
    pv = torch.nn.functional.pad(pval, pad, value=-torch.inf)
    pi = torch.nn.functional.pad(pidx, pad, value=INT_MAX)
    ps = torch.nn.functional.pad(psig, pad, value=0.0)
    acc = (torch.full((B, 32), -torch.inf), torch.full((B, 32), INT_MAX,
                                                       dtype=torch.int32),
           torch.zeros((B, 32)))
    for e0 in range(0, T32, 32):
        acc = _combine(acc, (pv[:, e0:e0 + 32], pi[:, e0:e0 + 32],
                             ps[:, e0:e0 + 32]))
    for off in (16, 8, 4, 2, 1):
        partner = torch.arange(32) ^ off
        acc = _combine(acc, tuple(x[:, partner] for x in acc))
    for x in acc:
        assert torch.equal(x.nan_to_num(), x[:, :1].nan_to_num().expand(-1, 32))
    return tuple(x[:, 0] for x in acc)


def _mp_sliced_model(pval, pidx, psig, Ac, x, r, C):
    """mp_update as its grid runs it: each of C slices of n reduces the
    partials itself and updates its entries of r, a product and a
    difference rounded one at a time; slice 0 adds v to x[i]. A NaN row
    (index INT_MAX) is left as it is."""
    m = Ac.shape[1]
    rows = torch.arange(r.shape[0])
    for c, (p0, p1) in enumerate(_slices(r.shape[1], C)):
        _, i, sg = _warp_pick(pval, pidx, psig)
        live = i < m
        ic = i.clamp(max=m - 1).long()
        a = Ac[p0:p1][:, ic].T.float()
        r[:, p0:p1] = torch.where(live[:, None], r[:, p0:p1] - sg[:, None] * a,
                                  r[:, p0:p1])
        if c == 0:
            x[rows[live], ic[live]] += sg[live]


def _mp_inputs(B, n, seed):
    """A unit-norm (n, M) dictionary with atom 400 a copy of atom 5 (tiles
    0 and 3), residuals and their signed select partials: row 0 is 2 a_5
    (the two tiles tie; 5 wins), row 1 a NaN row; row 2's partials tie in
    value across tiles 1 and 2 by hand (the lower index, 200, wins, with
    its own signed score)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, M)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    A[:, 400] = A[:, 5]
    r = rng.standard_normal((B, n)).astype(np.float32)
    r[0] = 2.0 * A[:, 5]
    if B > 1:
        r[1, 7] = np.nan
    A, r = to_torch(A), to_torch(r)
    pv, pi, ps = tfs._select_ref(r, A, torch.float32, signed=True)
    if B > 2:
        top = float(pv[2].max()) * 2.0
        pv[2, 1], pv[2, 2] = top, top
        pi[2, 1], pi[2, 2] = 200, 300
        ps[2, 1], ps[2, 2] = -top, top
    return A, r, (pv, pi, ps)


@pytest.mark.parametrize("C", [1, 3, 8])
@pytest.mark.parametrize("n", [1000, 1028])
@pytest.mark.parametrize("B", [1, 64, 65])
def test_sliced_mp_update_model_is_the_twin_bit_for_bit(B, n, C):
    A, r0, parts = _mp_inputs(B, n, 1400 + B + n + C)
    x0 = torch.zeros((B, M))
    x0[:, 9] = 0.5
    x, r = x0.clone(), r0.clone()
    xm, rm = x0.clone(), r0.clone()
    tfs._mp_update_ref(*parts, A, x, r)
    _mp_sliced_model(*parts, A, xm, rm, C)
    assert torch.equal(x, xm)
    assert torch.equal(r.isnan(), rm.isnan())
    assert torch.equal(r.nan_to_num(), rm.nan_to_num())
    assert float(x[0, 5]) == float(parts[2][0, 0]) and float(x[0, 400]) == 0
    if B > 1:
        assert torch.equal(x[1], x0[1])
        assert torch.equal(r[1].nan_to_num(), r0[1].nan_to_num())
    if B > 2:   # the tie across tiles 1 and 2: index 200, score -top
        assert float(x[2, 200]) == -float(parts[0][2, 1]) and x[2, 300] == 0


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_mp_twin_at_n_1000_matches_pallas(cdt):
    rng = np.random.default_rng(1401)
    n, m, B, k = 1000, 256, 8, 8
    A = rng.standard_normal((n, m)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((B, m), np.float32)
    for row in X:
        row[rng.choice(m, 3, replace=False)] = rng.choice([-1.0, 1.0], 3)
    Bs = (X @ A.T + 5e-3 * rng.standard_normal((B, n)) / np.sqrt(n)
          ).astype(np.float32)
    Bs[3, 5] = np.nan                              # a NaN row: no-op steps
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[cdt]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[cdt]
    jx, jr = jfs.mp_fused_solve(A, Bs, k, corr_dtype=jdt, interpret=True)
    tx, tr = tfs.mp_fused_solve_ref(to_torch(A), to_torch(Bs), k,
                                    corr_dtype=tdt)
    atol = 1e-5 if cdt == "f32" else 1e-4
    ok = np.arange(B) != 3
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=atol)
    np.testing.assert_allclose(tr.numpy()[ok], np.asarray(jr)[ok], atol=atol)
    assert not tx[3].any() and torch.isnan(tr[3]).any()


# --------------------------------------------------------------------------
# srr_append
# --------------------------------------------------------------------------

def _rank_dots(X, Y, C):
    """sum(X * Y, dim=1) with each of C slices of n summed apart and the
    slices added in rank order, as the cluster adds its blocks' partials."""
    acc = None
    for p0, p1 in _slices(X.shape[1], C):
        part = torch.sum(X[:, p0:p1] * Y[:, p0:p1], dim=1)
        acc = part if acc is None else acc + part
    return acc


def _slot_sum(cols, w, slots):
    """sum over the slots in slot order of cols[s] * w[s] (slots (K,)
    bool), as the kernel adds its live slots."""
    acc = torch.zeros_like(cols[0])
    for s in range(cols.shape[0]):
        if bool(slots[s]):
            acc = acc + cols[s] * w[s]
    return acc


def _srr_cluster_model(pval, pidx, Ac, Bs, st, C):
    """srr_append as engine_cluster.cuh::rmp_cluster_row orders it in its
    SRR mode, row by row in f32: a closed row (done, or its forward gate
    shut) leaves a zero pending term; else the pick reduced, the products
    g (occupied slots), ata, beta and ||r||^2 over C slices in rank order,
    u = Ginv g, the gate rr > 0 && vmax > 0 && nactive < min(n, m), the
    append into the first free slot unless full, a duplicate or d <= rtol
    ata, the Ginv and Atb update, coef = Ginv Atb, then aperp and r over
    the live slots (the occupied ones and the append's) in slot order."""
    B, K, n = st.cols.shape
    m = Ac.shape[1]
    rtol = tfs._f32(tfs._degeneracy_rtol(n))
    vmax, sel = tfs._reduce_partials(pval, pidx)
    for b in range(B):
        if bool(st.done[b] > 0.5) or bool(st.fgate[b] < 0.5):
            st.pend_u[0, b] = 0.0
            st.pend_w[0, b] = 0.0
            continue
        idx = st.idx[b].clone()
        occ = idx < m
        lst = torch.nonzero(occ)[:, 0]
        nat = len(lst)
        free = torch.nonzero(~occ)[:, 0]
        slot = int(free[0]) if len(free) else K
        s = int(sel[b])
        acol = Ac[:, min(s, m - 1)].float()
        X = torch.cat([st.cols[b, lst], acol[None], acol[None], st.r[b][None]])
        Y = torch.cat([acol[None].expand(nat + 1, -1), Bs[b][None],
                       st.r[b][None]])
        P = _rank_dots(X, Y, C)
        g = torch.zeros(K)
        g[lst] = P[:nat]
        ata, beta, rr = P[nat], P[nat + 1], P[nat + 2]
        Ginv, atb = st.Ginv[b].clone(), st.Atb[b].clone()
        u = Ginv @ g
        wanted = bool(rr > 0) and bool(vmax[b] > 0) and nat < min(n, m)
        dup = bool((idx == s).any())
        d = ata - g @ u
        ok = wanted and nat < K and not dup and bool(d > rtol * ata)
        okf = 1.0 if ok else 0.0
        dinv = okf / (d if d > 0 else 1.0)
        w, e = u.clone(), torch.zeros(K)
        if slot < K:
            w[slot] -= 1.0
            e[slot] = okf
        Ginv = Ginv + dinv * torch.outer(w, w) - torch.outer(e, e)
        atb = atb + beta * (e if ok else torch.zeros(K))
        cols = st.cols[b].clone()
        if ok:
            idx[slot] = s
            if s < m:
                st.amask[b, s] = 1
        if slot < K:
            cols[slot] = acol * okf
        live = (idx < m) | (torch.arange(K) == slot)
        coef = Ginv @ atb
        st.pend_u[0, b] = acol - _slot_sum(cols, u, live)
        st.pend_w[0, b] = -dinv
        st.r[b] = Bs[b] - _slot_sum(cols, coef, live)
        st.cols[b], st.Ginv[b], st.coef[b], st.idx[b] = cols, Ginv, coef, idx
        st.Atb[b] = atb
        if not ok:
            st.fgate[b] = 0.0


def _close(a, b, name):
    assert torch.equal(torch.isnan(a), torch.isnan(b)), name
    torch.testing.assert_close(a.nan_to_num(), b.nan_to_num(), rtol=0,
                               atol=MODEL_ATOL, msg=name)


def _srr_state(seed, k, K):
    """SRR's state after the twin's init (k picks, K slots) on a unit-norm
    (1000, M) dictionary, atom M-1 a copy of atom 7, and rows: three noisy
    planted rows (row 0 holds atom 7, whose twin meets the rtol gate), a
    NaN row, a zero row, a done row, a row whose forward gate is shut and a
    row that holds K atoms (full)."""
    rng = np.random.default_rng(seed)
    n = 1000
    A = rng.standard_normal((n, M)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    A[:, M - 1] = A[:, 7]
    X = np.zeros((8, M), np.float32)
    for row in X:
        row[rng.choice(M - 1, 6, replace=False)] = rng.choice([-1.0, 1.0], 6)
    X[0, 7] = 3.0
    Bs = X @ A.T + 0.02 * rng.standard_normal((8, n)).astype(np.float32)
    Bs[3, 11] = np.nan
    Bs[4] = 0.0
    A, Bs = to_torch(A), to_torch(Bs.astype(np.float32))
    cn2 = torch.sum(A * A, dim=0)
    st = tft._init_engine(Bs, K, M, cn2, npend=max(k, 2))
    tft._engine_init_ref(*tfs._topl_ref(Bs, A, torch.float32, k), A, Bs, st)
    st.done[5] = 1.0
    st.fgate[6] = 0.0
    atoms = torch.tensor(rng.choice(M - 1, K, replace=False))
    cols = A[:, atoms].T.contiguous()
    st.cols[7], st.idx[7] = cols, atoms.int()
    st.Ginv[7] = torch.linalg.inv(cols.double() @ cols.double().T).float()
    st.Atb[7] = cols @ Bs[7]
    st.coef[7] = st.Ginv[7] @ st.Atb[7]
    st.amask[7, atoms] = 1
    st.r[7] = Bs[7] - st.coef[7] @ cols
    return A, Bs, cn2, st


@pytest.mark.parametrize("C", [1, 2, 8])
@pytest.mark.parametrize("k,K", [(3, 4), (4, 9)])
def test_srr_cluster_order_matches_the_twin(C, k, K):
    # forward steps from identical state; at step 1 row 1's pick is its
    # slot-0 atom again (a duplicate) and row 0's the twin of atom 7 (the
    # rtol gate)
    A, Bs, cn2, st = _srr_state(1402 + k, k, K)
    npend = k
    for step in range(3):
        pv, pi = tfs._rescaled_select_ref(A, cn2, st.r, st.pend_u[:npend],
                                          st.pend_w[:npend], 1.0, st.amask,
                                          st.resc, torch.float32)
        if step == 1:
            pv[1], pi[1] = 1.0, int(st.idx[1, 0])
            pv[0], pi[0] = 1.0, M - 1
        model = tft._EngState(*(None if x is None else x.clone() for x in st))
        tft._srr_append_ref(pv, pi, A, Bs, st)
        _srr_cluster_model(pv, pi, A, Bs, model, C)
        for name in ("idx", "amask", "fgate", "done"):
            assert torch.equal(getattr(model, name), getattr(st, name)), name
        for name in ("cols", "Ginv", "coef", "Atb", "r"):
            _close(getattr(model, name), getattr(st, name), name)
        _close(model.pend_u[0], st.pend_u[0], "pend_u")
        _close(model.pend_w[0], st.pend_w[0], "pend_w")
        npend = 1
    assert bool(torch.isnan(st.r[3]).all()) and float(st.fgate[3]) == 0.0
    assert float(st.fgate[4]) == 0.0 and not st.pend_u[0, 4].any()  # zero row
    assert float(st.fgate[7]) == 0.0                                # full
    assert not bool((st.idx[0] == M - 1).any())                     # rtol twin
    assert int((st.idx[1] == st.idx[1, 0]).sum()) == 1             # duplicate
    for row in (5, 6):                                            # closed
        assert float(st.pend_w[0, row]) == 0.0 and not st.pend_u[0, row].any()


# --------------------------------------------------------------------------
# The wrappers' C calls
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32])
def test_mp_update_wrapper_passes_the_same_arguments(recorder, cdt):
    B, n, m = 3, 1000, 8264
    T = -(-m // tfs.TILE)
    pv, pi, ps = torch.zeros((B, T)), torch.zeros((B, T), dtype=torch.int32), \
        torch.zeros((B, T))
    Ac = torch.zeros((n, m), dtype=cdt)
    x, r = torch.zeros((B, m)), torch.zeros((B, n))
    before = tfs.LAUNCHES["mp_update"]
    tfs.mp_update(pv, pi, ps, Ac, x, r)
    (name, args), = recorder.calls
    assert name == "cstpu_mp_update"
    assert args == (pv.data_ptr(), pi.data_ptr(), ps.data_ptr(), T,
                    Ac.data_ptr(), int(cdt == torch.bfloat16), x.data_ptr(),
                    r.data_ptr(), B, n, m, None)
    assert tfs.LAUNCHES["mp_update"] - before == 1


@pytest.mark.parametrize("bad", ["n", "m"])
def test_mp_update_wrapper_refuses_mismatched_shapes(recorder, bad):
    B, n, m = 2, 64, 256
    T = -(-m // tfs.TILE)
    parts = (torch.zeros((B, T)), torch.zeros((B, T), dtype=torch.int32),
             torch.zeros((B, T)))
    Ac = torch.zeros((n + (bad == "n"), m), dtype=torch.bfloat16)
    x, r = torch.zeros((B, m + (bad == "m"))), torch.zeros((B, n))
    with pytest.raises(ValueError):
        tfs.mp_update(*parts, Ac, x, r)
    assert recorder.calls == []


@pytest.mark.parametrize("K,cdt", [(2, torch.bfloat16), (17, torch.float32),
                                   (128, torch.bfloat16)])
def test_srr_append_wrapper_passes_the_same_arguments(recorder, K, cdt):
    B, n, m = 3, 1028, 8192
    T = -(-m // tfs.TILE)
    pv, pi = torch.zeros((B, T)), torch.zeros((B, T), dtype=torch.int32)
    Ac, Bs = torch.zeros((n, m), dtype=cdt), torch.randn((B, n))
    st = tft._init_engine(Bs, K, m, torch.ones(m), npend=2)
    before = tfs.LAUNCHES["srr_append"]
    tft.srr_append(pv, pi, Ac, Bs, st)
    (name, args), = recorder.calls
    assert name == "cstpu_srr_append"
    assert args[:6] == (pv.data_ptr(), pi.data_ptr(), T, Ac.data_ptr(),
                        int(cdt == torch.bfloat16), Bs.data_ptr())
    assert args[6:17] == tuple(x.data_ptr() for x in (
        st.cols, st.Ginv, st.coef, st.idx, st.Atb, st.r, st.amask, st.done,
        st.pend_u, st.pend_w, st.fgate))
    assert args[17:21] == (B, n, m, K)
    assert args[21] == pytest.approx(tfs._degeneracy_rtol(n))
    assert args[22:] == (None,)
    assert tfs.LAUNCHES["srr_append"] - before == 1


def _first_n_over(K):
    n = 1
    while tft._engine_smem(n, K) <= tfs.SMEM_MAX:
        n += 1
    return n


# (K, n): K beyond KMAX, and the first n past the shared-memory budget at
# K = 128 and at K = 17
@pytest.mark.parametrize("K,n", [(tfs.KMAX + 1, 64), (128, _first_n_over(128)),
                                 (17, _first_n_over(17))])
def test_srr_append_wrapper_refuses_what_the_kernel_does_not_take(recorder,
                                                                  K, n):
    B, m = 1, 256
    T = -(-m // tfs.TILE)
    pv, pi = torch.zeros((B, T)), torch.zeros((B, T), dtype=torch.int32)
    Ac, Bs = torch.zeros((n, m), dtype=torch.bfloat16), torch.randn((B, n))
    st = tft._init_engine(Bs, K, m, torch.ones(m), npend=2)
    with pytest.raises(ValueError, match="outside"):
        tft.srr_append(pv, pi, Ac, Bs, st)
    assert recorder.calls == []


# --------------------------------------------------------------------------
# The profile's busy time
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spans,busy", [
    ([], 0.0),
    ([(0.0, 2.0), (2.0, 3.5)], 3.5),                # one after another
    ([(5.0, 6.0), (0.0, 1.0)], 2.0),                # in any order
    ([(0.0, 4.0), (1.0, 2.0)], 4.0),                # one inside another
    ([(0.0, 2.0), (1.5, 3.0), (10.0, 11.0)], 4.0),  # an overlap, then a gap
])
def test_union_ms_counts_overlapping_spans_once(spans, busy):
    assert chip_smoke.union_ms(spans) == busy
