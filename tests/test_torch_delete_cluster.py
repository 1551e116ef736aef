"""SRR's deletions and RMP's backward stage as a thread-block cluster per
row (csrc/engine_delete.cu and csrc/engine_backward.cu on
csrc/engine_cluster.cuh's deletions) as far as the CPU can see them.

The kernels run only on the card, where tests/test_torch_kernels.py holds
them to their plain twins at every launch over chip_smoke.py's
DELETE_CASES. Here:

- a plain-torch model of the cluster's order (C slices of n; the score over
  the occupied slots, the lowest slot on ties, a NaN minimum rejecting; the
  restore term v and r summed over the live slots in slot order, slot 0
  standing in where none is occupied; ||r||^2 per slice, the slices added in
  rank order; a row whose backward rule rejects at once leaves its state
  and r as they were) against `_engine_delete_ref` for l in {1, 2, 4} and
  against `_engine_backward_ref` under both rules: idx, amask and ndel
  equal, the state within 1e-5 in f32, on a NaN row, a zero row (its
  scores tie at 0), a done row, a row that rejects at once, gated-off
  deletions, a full row, two slots tied by construction and occupied slots
  that are not contiguous;
- the twin of RMP's backward stage takes a row that deletes all K atoms
  (the k rule down to 0), as cstpu's `_rmp_kernel` does in interpret mode;
- with a stand-in for the kernel library that records the C calls, the
  wrappers hand cstpu_engine_delete and cstpu_engine_backward the arguments
  they always did, and refuse an out-of-domain K, n or l without launching.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cstpu.ops import fused_twostage as jft
from cstpu_torch.ops import fused_solve as tfs
from cstpu_torch.ops import fused_twostage as tft
from cstpu_torch.utils.interop import solution_to_numpy, to_torch
# the stand-in for the kernel library that records the C calls
from test_torch_latency_kernels import recorder  # noqa: F401

MODEL_ATOL = 1e-5
N, M = 1000, 512
ROWS = 10
K_SLOTS = 6


def _slices(n, C):
    """The kernels' slices of n for C blocks a row: (p0, p1) by rank."""
    S = ((n + C - 1) // C + 3) & ~3
    return [(min(n, r * S), min(n, (r + 1) * S)) for r in range(C)]


def _slot_sum(cols, w, slots):
    """sum over the slots in slot order of cols[s] * w[s] (slots (K,)
    bool), as the kernels add their live slots."""
    acc = torch.zeros_like(cols[0])
    for s in range(cols.shape[0]):
        if bool(slots[s]):
            acc = acc + cols[s] * w[s]
    return acc


def _residual(st, b, Bs):
    """Row b's r over its occupied slots in slot order, slot 0 where none
    is (its column is zero, so a NaN row stays NaN)."""
    m = st.amask.shape[1]
    live = st.idx[b] < m
    if not bool(live.any()):
        live = torch.arange(live.shape[0]) == 0
    return Bs[b] - _slot_sum(st.cols[b], st.coef[b], live)


def _deletions(st, b, jmax, accept):
    """engine_cluster.cuh::cluster_deletions on row b: while accept(dmin,
    nat) holds, at most jmax times, delete the slot of least coef^2 /
    max(Ginv_pp, 1e-30) (the lowest on ties; NaN rejects), its restore term
    (v over the occupied slots in slot order, 1/q_pp) into pending slot
    1 + j, the downdate with the pad put back, the clears, coef = Ginv Atb.
    Returns the number of deletions."""
    K = st.idx.shape[1]
    m = st.amask.shape[1]
    nd = 0
    for _ in range(jmax):
        occ = st.idx[b] < m
        diag = torch.diagonal(st.Ginv[b])
        d2 = torch.where(occ, st.coef[b] * st.coef[b]
                         / torch.clamp(diag, min=1e-30), torch.inf)
        dmin = d2.min()
        if not accept(dmin, int(occ.sum())):
            break
        p = int(torch.nonzero(d2 == dmin)[0, 0])
        q = st.Ginv[b, :, p].clone()
        inv = 1.0 / (q[p] if q[p] > 0 else torch.tensor(1.0))
        st.pend_u[1 + nd, b] = _slot_sum(st.cols[b], q, occ)
        st.pend_w[1 + nd, b] = inv
        atom = int(st.idx[b, p])
        if atom < m:
            st.amask[b, atom] = 0
        e = torch.zeros(K)
        e[p] = 1.0
        st.Ginv[b] = st.Ginv[b] - (inv * q)[:, None] * q[None, :] \
            + e[:, None] * e[None, :]
        st.cols[b, p] *= 0.0
        st.idx[b, p] = m
        st.Atb[b, p] *= 0.0
        st.coef[b] = st.Ginv[b] @ st.Atb[b]
        nd += 1
    return nd


def _delete_model(Bs, st, k, l, delta2, C):
    """engine_delete as srr_delete_row orders it, row by row in f32."""
    n = Bs.shape[1]
    for b in range(Bs.shape[0]):
        if bool(st.done[b] > 0.5):
            st.pend_u[1:l + 1, b] = 0.0
            st.pend_w[1:l + 1, b] = 0.0
            continue
        nd = _deletions(st, b, l, lambda dmin, nat: nat > k
                        and bool(dmin < torch.inf))
        st.pend_u[1 + nd:l + 1, b] = 0.0
        st.pend_w[1 + nd:l + 1, b] = 0.0
        if nd == 0:
            st.coef[b] = st.Ginv[b] @ st.Atb[b]
        st.r[b] = _residual(st, b, Bs)
        res = None
        for p0, p1 in _slices(n, C):
            part = torch.sum(st.r[b, p0:p1] * st.r[b, p0:p1])
            res = part if res is None else res + part
        latch = bool(res <= tfs._f32(delta2)) or bool(st.prev[b] <= res)
        if latch:
            st.done[b] = 1.0
        st.prev[b] = res
        st.fgate[b] = 0.0 if latch else 1.0


def _backward_model(Bs, st, delta2, kfinal):
    """engine_backward as rmp_backward_row orders it, row by row in f32: a
    row whose rule rejects at once writes its latches and zero weights
    only."""
    K = st.idx.shape[1]
    thr = tfs._f32(delta2)

    def accept(dmin, nat):
        if kfinal >= 0:
            return nat > kfinal and bool(dmin < torch.inf)
        return bool(dmin < thr)

    for b in range(Bs.shape[0]):
        if bool(st.done[b] > 0.5):
            st.pend_w[1:K + 1, b] = 0.0
            st.ndel[b] = 0.0
            continue
        nd = _deletions(st, b, K + 1, accept)
        st.pend_w[1 + nd:K + 1, b] = 0.0
        if nd > 0:
            st.r[b] = _residual(st, b, Bs)
        progressed = bool(st.acc[b] > 0.5) or nd > 0
        if not progressed:
            st.done[b] = 1.0
        st.fgate[b] = 1.0 if progressed else 0.0
        st.acc[b] = 0.0
        st.ndel[b] = float(nd)


def _problem(seed):
    """A unit-norm (N, M) dictionary and ROWS noisy measurements of 4
    planted +-1 atoms: row 3 a NaN row, row 4 a zero row, row 6 the clean
    10 (a_5 + a_6)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, M)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((ROWS, M), np.float32)
    for row in X:
        row[rng.choice(M, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
    Bs = X @ A.T + 0.02 * rng.standard_normal((ROWS, N)).astype(np.float32)
    Bs[3, 11] = np.nan
    Bs[4] = 0.0
    Bs[6] = 10.0 * (A[:, 5] + A[:, 6])
    return to_torch(A), to_torch(Bs.astype(np.float32)), rng


def _full(st, row, A, Bs, atoms):
    """Row `row` holds exactly `atoms` (K of them)."""
    chip_smoke._full_row(st, row, A, Bs, torch.as_tensor(atoms))


def _hole(st, row, Bs):
    """Slot 1 of row `row` deleted by the twin, so that the occupied slots
    are not contiguous."""
    m = st.amask.shape[1]
    K = st.idx.shape[1]
    hasf = torch.arange(st.idx.shape[0]) == row
    saved = st.pend_u[1].clone(), st.pend_w[1].clone()
    tft._delete_ep_ref(st, torch.full((st.idx.shape[0],), 1), hasf, m)
    st.coef[row] = st.Ginv[row] @ st.Atb[row]
    st.r[row] = Bs[row] - st.coef[row] @ st.cols[row]
    st.pend_u[1], st.pend_w[1] = saved
    assert int(st.idx[row, 1]) == m and int((st.idx[row] < m).sum()) == K - 1


def _close(a, b, name):
    assert torch.equal(torch.isnan(a), torch.isnan(b)), name
    torch.testing.assert_close(a.nan_to_num(), b.nan_to_num(), rtol=0,
                               atol=MODEL_ATOL, msg=name)


def _srr_state(l, seed):
    """SRR's state before its backward stage, K = 6 slots, k = 6 - l: the
    twin's init (k picks), l twin forward steps; row 5 done, row 7's
    forward gate shut (its deletions gated off), row 8 full, row 9 full
    with slot 1 deleted (not contiguous), row 2 the tie (chip_smoke's
    _tie_row: slots 0 and 1 score 0.25 bit for bit). Row 6 is -2 times
    row 0: SRR's forward steps would fit the rounding noise of a clean
    row, whose scores then tie up to rounding."""
    K = K_SLOTS
    k = K - l
    A, Bs, rng = _problem(seed)
    Bs[6] = -2.0 * Bs[0]
    cn2 = torch.sum(A * A, dim=0)
    st = tft._init_engine(Bs, K, M, cn2, npend=max(k, l + 1))
    tft._engine_init_ref(*tfs._topl_ref(Bs, A, torch.float32, k), A, Bs, st)
    st.done[5] = 1.0
    st.fgate[7] = 0.0
    npend = k
    for _ in range(l):
        tft._srr_append_ref(*tfs._rescaled_select_ref(
            A, cn2, st.r, st.pend_u[:npend], st.pend_w[:npend], 1.0,
            st.amask, st.resc, torch.float32), A, Bs, st)
        npend = 1
    _full(st, 8, A, Bs, rng.choice(M, K, replace=False))
    _full(st, 9, A, Bs, rng.choice(M, K, replace=False))
    _hole(st, 9, Bs)
    chip_smoke._tie_row(st, 2, Bs)
    return Bs, st, k


@pytest.mark.parametrize("C", [1, 2, 8])
@pytest.mark.parametrize("l", [1, 2, 4])
def test_delete_cluster_order_matches_the_twin(C, l):
    Bs, st, k = _srr_state(l, 1500 + l)
    m = st.amask.shape[1]
    nat0 = (st.idx < m).sum(1)
    prev0 = st.prev.clone()
    model = tft._EngState(*(None if x is None else x.clone() for x in st))
    tft._engine_delete_ref(Bs, st, k, l, 1e-4)
    _delete_model(Bs, model, k, l, 1e-4, C)
    for name in ("idx", "amask"):
        assert torch.equal(getattr(model, name), getattr(st, name)), name
    for name in ("cols", "Ginv", "coef", "Atb", "r", "prev"):
        _close(getattr(model, name), getattr(st, name), name)
    clear = (st.prev - prev0).abs() > chip_smoke.LATCH_RTOL * prev0.abs()
    for name in ("done", "fgate"):
        assert torch.equal(getattr(model, name)[clear],
                           getattr(st, name)[clear]), name
    _close(model.pend_u[1:l + 1], st.pend_u[1:l + 1], "pend_u")
    _close(model.pend_w[1:l + 1], st.pend_w[1:l + 1], "pend_w")
    nd = nat0 - (st.idx < m).sum(1)
    # the NaN row and the gated-off row delete nothing and leave zero terms
    for row in (3, 7):
        assert int(nd[row]) == 0 and not st.pend_w[1:l + 1, row].any()
        assert not st.pend_u[1:l + 1, row].any()
    assert bool(torch.isnan(st.r[3]).all()) and float(st.done[3]) == 0.0
    # the done row: zero terms, nothing else moved
    assert not st.pend_u[1:l + 1, 5].any() and not st.pend_w[1:l + 1, 5].any()
    # the full rows back to k atoms, at most l a launch; the tie to slot 0
    assert int(nd[8]) == l and int(nd[9]) == min(l, K_SLOTS - 1 - k)
    assert int(st.idx[2, 0]) == m and float(st.pend_w[1, 2]) == 1.0
    if l > 1:
        assert int(st.idx[2, 1]) == m


def _rmp_state(seed):
    """RMP's state after the twin's forward stage to rejection at delta
    0.15, K = 6 slots: row 4 (zero) takes nothing, row 5 done with its
    pending weights at 0.5, row 6 (10 (a_5 + a_6)) two atoms of gain ~100,
    row 8 full, row 9 full with slot 1 deleted (not contiguous), row 2 the
    tie (_tie_row), rows 2, 8, 9 with a forward step accepted."""
    K = K_SLOTS
    A, Bs, rng = _problem(seed)
    cn2 = torch.sum(A * A, dim=0)
    floor2 = 64.0 * N * (1.1920929e-07 ** 2) * torch.sum(Bs * Bs, dim=1)
    st = tft._init_engine(Bs, K, M, cn2, npend=K + 1, stepwise=True)
    for _ in range(K + 1):
        tft._rmp_append_ref(*tfs._rescaled_select_ref(
            A, cn2, st.r, st.pend_u[:1], st.pend_w[:1], 1.0, st.amask,
            st.resc, torch.float32), A, Bs, st, 0.15 ** 2, floor2, False)
    st.done[5] = 1.0
    st.pend_w[:, 5] = 0.5
    _full(st, 8, A, Bs, rng.choice(M, K, replace=False))
    _full(st, 9, A, Bs, rng.choice(M, K, replace=False))
    _hole(st, 9, Bs)
    chip_smoke._tie_row(st, 2, Bs)
    st.acc[[2, 8, 9]] = 1.0
    return Bs, st


@pytest.mark.parametrize("rule", ["delta", "k", "k0"])
def test_backward_cluster_order_matches_the_twin(rule):
    # delta: while the increase < 1; k: down to one atom; k0: down to none
    # (a full row deletes all K atoms)
    delta2, kfinal = {"delta": (1.0, -1), "k": (0.0, 1), "k0": (0.0, 0)}[rule]
    Bs, st = _rmp_state(1510 + len(rule))
    K, m = K_SLOTS, st.amask.shape[1]
    model = tft._EngState(*(None if x is None else x.clone() for x in st))
    pre = tft._EngState(*(None if x is None else x.clone() for x in st))
    tft._engine_backward_ref(Bs, st, delta2, kfinal)
    _backward_model(Bs, model, delta2, kfinal)
    for name in ("idx", "amask", "ndel", "done", "fgate", "acc"):
        assert torch.equal(getattr(model, name), getattr(st, name)), name
    for name in ("cols", "Ginv", "coef", "Atb", "r"):
        _close(getattr(model, name), getattr(st, name), name)
    _close(model.pend_w[1:K + 1], st.pend_w[1:K + 1], "pend_w")
    live = st.pend_w[1:K + 1] != 0
    _close(model.pend_u[1:K + 1][live], st.pend_u[1:K + 1][live], "pend_u")
    # the NaN row and the empty zero row reject at once and latch; the model
    # (as the kernel) leaves their state and r as they were
    for row in (3, 4):
        assert float(st.ndel[row]) == 0.0 and float(st.done[row]) == 1.0
        assert all(torch.equal(getattr(model, f)[row].nan_to_num(),
                               getattr(pre, f)[row].nan_to_num())
                   for f in ("cols", "Ginv", "coef", "idx", "Atb", "r"))
    # the done row: its weights zeroed, nothing else moved
    assert float(st.ndel[5]) == 0.0 and not st.pend_w[1:K + 1, 5].any()
    if rule == "delta":   # row 6's gains are ~100: rejects at once, goes on
        assert float(st.ndel[6]) == 0.0 and float(st.fgate[6]) == 1.0
        assert int(st.ndel[2]) == 2          # the two tied slots, then stop
    else:   # down to kfinal atoms; the tie goes to slot 0, then slot 1
        assert bool(((st.idx < m).sum(1) <= kfinal)[st.done < 0.5].all())
        assert int(st.ndel[8]) == K - kfinal and int(st.ndel[9]) == K - 1 - kfinal
    assert int(st.idx[2, 0]) == m and int(st.idx[2, 1]) == m
    assert float(st.pend_w[1, 2]) == 1.0


def test_rmp_k0_deletes_every_slot_as_pallas():
    # kmax = 4 slots against 8 planted atoms: the forward stage fills all
    # four and reports the cap; k = 0 then deletes all of them, the stage's
    # K-th deletion included (the twin once stepped past its pending slots
    # there)
    rng = np.random.default_rng(1520)
    n, m, B = 64, 128, 3
    A = rng.standard_normal((n, m)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((B, m), np.float32)
    for row in X:
        row[rng.choice(m, 8, replace=False)] = rng.choice([-1.0, 1.0], 8)
    Bs = (X @ A.T).astype(np.float32)
    jsol, jr, jcap = jft.rmp_fused_solve(A, Bs, k=0, kmax=4,
                                         corr_dtype=jnp.float32,
                                         interpret=True)
    tsol, tr, tcap = tft.rmp_fused_solve_ref(to_torch(A), to_torch(Bs), k=0,
                                             kmax=4, corr_dtype=torch.float32)
    jt = solution_to_numpy(jsol)
    tt = solution_to_numpy(tsol)
    np.testing.assert_array_equal(tt["mask"], jt["mask"])
    assert not tt["mask"].any()
    np.testing.assert_array_equal(tcap.numpy(), np.asarray(jcap))
    assert tcap.all()
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


# --------------------------------------------------------------------------
# The wrappers' C calls
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K,l", [(2, 1), (17, 4), (128, 2)])
def test_engine_delete_wrapper_passes_the_same_arguments(recorder, K, l):
    B, n, m = 3, 1028, 8192
    Bs = torch.randn((B, n))
    st = tft._init_engine(Bs, K, m, torch.ones(m), npend=l + 1)
    before = tfs.LAUNCHES["engine_delete"]
    tft.engine_delete(Bs, st, K - 1, l, 0.25)
    (name, args), = recorder.calls
    assert name == "cstpu_engine_delete"
    assert args[:13] == tuple(x.data_ptr() for x in (
        Bs, st.cols, st.Ginv, st.coef, st.idx, st.Atb, st.r, st.amask,
        st.done, st.prev, st.pend_u, st.pend_w, st.fgate))
    assert args[13:19] == (B, n, m, K, K - 1, l)
    assert args[19] == pytest.approx(0.25) and args[20:] == (None,)
    assert tfs.LAUNCHES["engine_delete"] - before == 1


@pytest.mark.parametrize("K,kfinal", [(2, -1), (32, 8), (128, 0)])
def test_engine_backward_wrapper_passes_the_same_arguments(recorder, K,
                                                           kfinal):
    B, n, m = 3, 1000, 8192
    Bs = torch.randn((B, n))
    st = tft._init_engine(Bs, K, m, torch.ones(m), npend=K + 1,
                          stepwise=True)
    before = tfs.LAUNCHES["engine_backward"]
    tft.engine_backward(Bs, st, 0.5, kfinal)
    (name, args), = recorder.calls
    assert name == "cstpu_engine_backward"
    assert args[:14] == tuple(x.data_ptr() for x in (
        Bs, st.cols, st.Ginv, st.coef, st.idx, st.Atb, st.r, st.amask,
        st.done, st.pend_u, st.pend_w, st.fgate, st.acc, st.ndel))
    assert args[14:18] == (B, n, m, K)
    assert args[18] == pytest.approx(0.5) and args[19:] == (kfinal, None)
    assert tfs.LAUNCHES["engine_backward"] - before == 1


def _first_n_over(K):
    n = 1
    while tft._engine_smem(n, K) <= tfs.SMEM_MAX:
        n += 1
    return n


# (K, n): K beyond KMAX, and the first n past the shared-memory budget at
# K = 128 and at K = 17
@pytest.mark.parametrize("K,n", [(tfs.KMAX + 1, 64), (128, _first_n_over(128)),
                                 (17, _first_n_over(17))])
def test_deletion_wrappers_refuse_what_the_kernels_do_not_take(recorder, K,
                                                               n):
    B, m = 1, 256
    Bs = torch.randn((B, n))
    st = tft._init_engine(Bs, K, m, torch.ones(m), npend=K + 1,
                          stepwise=True)
    with pytest.raises(ValueError, match="outside"):
        tft.engine_delete(Bs, st, 1, 1, 0.0)
    with pytest.raises(ValueError, match="outside"):
        tft.engine_backward(Bs, st, 0.0, 1)
    assert recorder.calls == []


@pytest.mark.parametrize("l", [0, 3])
def test_engine_delete_refuses_l_outside_the_pending_slots(recorder, l):
    # l deletions need l + 1 pending slots (slot 0 is the append's)
    B, n, m, K = 2, 256, 512, 4
    Bs = torch.randn((B, n))
    st = tft._init_engine(Bs, K, m, torch.ones(m), npend=3)
    with pytest.raises(ValueError, match="pending slots"):
        tft.engine_delete(Bs, st, 1, l, 0.0)
    assert recorder.calls == []
