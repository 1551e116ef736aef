"""The streamed top-l (K7) past 128 slots, on the CPU.

cstpu's K7 (cstpu/ops/stream_select.py::_select_topl_kernel) takes any l;
so does the port's: a sweep block offers its min(l, 128) best, and past
128 slots the finish takes its wide route (csrc/stream_select.cu: a merge
of each tile's whole block lists into its top l, then a fold that keeps the
slots sorted and restores their order after each tile with the last merge
of a bitonic network, or the whole network where written candidates tie).
The kernels run only on the card (tests/test_torch_kernels.py holds them
there); here:

  * a numpy model of the wide finish, step for step as the kernels take
    them (the merge's ranks by binary search, the fold's places, its tie
    test and the bitonic network itself, which must leave the slots sorted
    after every tile), against the plain twin bit for bit, on partials
    with ties within and across tiles, an all-zero row, a NaN tile and a
    NaN row, and tiles of 1 to 16 blocks;
  * the plain twin's fold (a tile at once) against the rule's own form,
    candidate by candidate, bit for bit;
  * the twin through the wrapper against cstpu's K7 in interpret mode at
    l in (129, 200, 512) over two tiles;
  * which C calls the wrapper makes past 128 slots (a stand-in library);
  * `gomp_sharded_fused` and `sp_sharded_fused` at l = k = 129 on a
    two-shard CPU mesh against cstpu's `gomp_batch` and `sp_batch`.

Tolerances: streamed values to 1e-5 relative (f32 sums of the same
products in another order), indices slot for slot where no two of the
l + 1 best scores lie within 1e-4 of the best and as sets everywhere;
sharded supports equal and coefficients to rtol 1e-4 (atol 1e-5: a
129-atom fit in f32).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu.models import batched as jbatched
from cstpu.ops import stream_select as jss
from cstpu_torch.ops import fused_solve as tfs
from cstpu_torch.ops import stream_select as tss
from cstpu_torch.parallel import make_mesh
from cstpu_torch.parallel import sharded as tsh
from cstpu_torch.utils.interop import (
    solution_from_cstpu, solution_to_numpy, to_torch)

BF, F32 = torch.bfloat16, torch.float32
INT_MAX = np.iinfo(np.int32).max
RTOL = 1e-5
GAP = 1e-4
TILE = 128


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs beside other
    workers on the same cores, and torch's default, a thread a core in
    every worker, makes these small solves wait on each other (a 1 s case
    took 267 s in a six-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# A numpy model of the wide finish
# --------------------------------------------------------------------------

def _pow2(x):
    p = 1
    while p < x:
        p <<= 1
    return p


def _keys(v, j):
    """mma_topl.cuh::topl_key: the value's bits high, ~index low; -inf 0."""
    v = np.asarray(v, np.float32)
    hi = v.view(np.uint32).astype(np.uint64) << np.uint64(32)
    lo = (~np.asarray(j, np.int64).astype(np.uint32)).astype(np.uint64)
    return np.where(v == -np.inf, np.uint64(0), hi | lo)


def _unkey(k):
    v = (k >> np.uint64(32)).astype(np.uint32).view(np.float32)
    i = (~(k & np.uint64(0xFFFFFFFF)).astype(np.uint32)).view(np.int32)
    return np.where(k == 0, -np.inf, v), np.where(k == 0, INT_MAX, i)


def _order(v):
    """stream_select.cu::float_order."""
    b = np.asarray(v, np.float32).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _unorder(o):
    o = np.asarray(o, np.uint32)
    return np.where(o & 0x80000000, o & 0x7FFFFFFF,
                    ~o).astype(np.uint32).view(np.float32)


def _merge_model(lists, Lm):
    """stream_topl_merge_wide_kernel on one tile's key lists (nl, 128):
    pairs merged by rank (a left key counts the right keys above it, a
    right key the left keys at or above it), each level kept to Lm."""
    n = lists.shape[1]
    while lists.shape[0] > 1:
        out_n = min(2 * n, Lm)
        out = np.zeros((lists.shape[0] // 2, out_n), np.uint64)
        for p in range(lists.shape[0] // 2):
            a, b = lists[2 * p], lists[2 * p + 1]
            for keys, cnt in (((a, (b[None, :] > a[:, None]).sum(1))),
                              (b, (a[None, :] >= b[:, None]).sum(1))):
                pos = np.arange(n) + cnt
                out[p, pos[pos < out_n]] = keys[pos < out_n]
        lists, n = out, out_n
    return lists[0]


def _bitonic(K, k0):
    """stream_select.cu::sort_slots: the network from merge width k0."""
    L = K.size
    k = k0
    while k <= L:
        j = k // 2
        while j:
            p = np.arange(L // 2)
            a = (p & ~(j - 1)) * 2 + (p & (j - 1))
            b = a + j
            x, y = K[a].copy(), K[b].copy()
            swap = (x > y) == ((a & k) == 0)
            K[a], K[b] = np.where(swap, y, x), np.where(swap, x, y)
            j //= 2
        k *= 2
    return K


def _wide_finish_model(pval, pidx, bpt, l, stats):
    """Both launches of the wide finish on the partials (B, nblocks, 128);
    `stats` counts the tiles that took the last merge alone and the whole
    network."""
    B, nblocks, lc = pval.shape
    assert lc == TILE and l > TILE
    T = nblocks // bpt
    lo, Lm, nl, Lf = min(l, bpt * TILE), _pow2(min(l, bpt * TILE)), \
        _pow2(bpt), _pow2(l)
    val = np.empty((B, l), np.float32)
    idx = np.empty((B, l), np.int32)
    for row in range(B):
        K = np.full(Lf, np.uint64(2 ** 64 - 1))
        K[:l] = ((np.uint64(_order(-np.inf)) << np.uint64(32))
                 | np.arange(l, dtype=np.uint64))
        sidx = np.zeros(l, np.int32)
        for t in range(T):
            pv = pval[row, t * bpt:(t + 1) * bpt]
            pi = pidx[row, t * bpt:(t + 1) * bpt]
            if bpt > 1:
                lists = np.zeros((nl, TILE), np.uint64)
                lists[:bpt] = _keys(pv, pi)
                cv, ci = _unkey(_merge_model(lists, Lm)[:lo])
                if np.isnan(pv).any():
                    cv, ci = np.full(lo, np.nan, np.float32), \
                        np.full(lo, INT_MAX)
            else:
                cv, ci = pv[0], pi[0]
            cv = np.asarray(cv, np.float32)
            take = cv > _unorder((K[:lo] >> np.uint64(32)).astype(np.uint32))
            s = (K[:lo] & np.uint64(0xFFFFFFFF)).astype(np.int64)
            K[:lo] = np.where(take, (_order(cv).astype(np.uint64)
                                     << np.uint64(32)) | s.astype(np.uint64),
                              K[:lo])
            sidx[s[take]] = np.asarray(ci)[take]
            tie = bool((take[:-1] & (cv[1:] == cv[:-1])).any())
            if take.any():
                K = _bitonic(K, 2 if tie else Lf)
                stats["whole" if tie else "merge"] += 1
            assert (K[:-1] <= K[1:]).all(), "slots out of order"
        s = (K[:l] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        val[row, s] = _unorder((K[:l] >> np.uint64(32)).astype(np.uint32))
        idx[row, s] = sidx[s]
    return val, idx


def _partials(seed, B=6, n=32, m=4096):
    """The sweep's partials (B, m / 128, 128) of a dictionary with ties:
    one column five times (within a block, across blocks and tiles), a
    block of four distinct columns, an all-zero row, a NaN atom (its tile
    skipped on every row), a NaN row, and scores of a few distinct values
    on row 4."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    for j in (5, 40, 700, 3000):
        A[:, j] = A[:, 9]
    A[:, 1024:1152] = A[:, 1024:1028].repeat(32, axis=1)
    R = rng.standard_normal((B, n)).astype(np.float32)
    R[0] = 0.2 * R[0] + A[:, 9]
    R[1] = 0.0
    A[-1, 300] = np.nan
    R[2, 7] = np.nan
    R[4] = 0.0
    R[4, 0] = 1.0
    A[0] = np.round(A[0] * 4) / 4
    return tfs._topl_ref(torch.from_numpy(R), torch.from_numpy(A).to(BF),
                         BF, TILE)


@pytest.mark.parametrize("l", [129, 200, 512, 1024])
@pytest.mark.parametrize("bpt", [1, 2, 16])
def test_wide_finish_model_is_the_twin_bit_for_bit(l, bpt):
    pval, pidx = _partials(10 + l)
    stats = {"merge": 0, "whole": 0}
    got = _wide_finish_model(pval.numpy(), pidx.numpy(), bpt, l, stats)
    want = tss.stream_topl_finish_ref(pval, pidx, bpt, l)
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].numpy().view(np.int32))
    np.testing.assert_array_equal(got[1], want[1].numpy())
    # both orders of the fold ran; the NaN tile is skipped on every row,
    # the NaN row left empty, the all-zero row filled with zeros
    assert stats["merge"] > 0 and stats["whole"] > 0
    tile = bpt * TILE
    lo = 300 // tile * tile
    assert not ((want[1] >= lo) & (want[1] < lo + tile)
                & (want[0] > -np.inf)).any()
    assert bool((want[0][2] == -np.inf).all())
    assert int((want[0][1] == 0).sum()) == min(l, 4096 - tile)


def _fold_one_by_one(cv, ci, skip, l):
    """The rule itself: each candidate over the lowest slot that holds the
    running minimum, only if strictly larger."""
    B, T, c = cv.shape
    val = torch.full((B, l), -torch.inf)
    idx = torch.zeros((B, l), dtype=torch.int32)
    slot = torch.arange(l).view(1, l)
    for t in range(T):
        for k in range(min(l, c)):
            rmin = torch.amin(val, dim=1, keepdim=True)
            p = torch.amin(torch.where(val == rmin, slot, INT_MAX), dim=1,
                           keepdim=True)
            cand = cv[:, t, k:k + 1]
            take = (slot == p) & (cand > rmin) & ~skip[:, t:t + 1]
            val = torch.where(take, cand, val)
            idx = torch.where(take, ci[:, t, k:k + 1].to(torch.int32), idx)
    return val, idx


@pytest.mark.parametrize("l,c", [(4, 8), (40, 40), (150, 128), (300, 64)])
def test_twin_fold_is_the_rule_one_by_one(l, c):
    gen = torch.Generator().manual_seed(l)
    B, T = 5, 6
    raw = torch.randint(0, 6, (B, T, c), generator=gen).float()  # ties
    raw[1] = torch.rand((T, c), generator=gen)
    cv, order = torch.sort(raw, dim=2, descending=True, stable=True)
    ci = order + c * torch.arange(T).view(1, T, 1)
    cv[:, :, -3:] = -torch.inf                                  # pads
    skip = torch.zeros((B, T), dtype=torch.bool)
    skip[2, 1] = skip[0, 4] = True
    got = tss._fold_topl(cv, ci, skip, l)
    want = _fold_one_by_one(cv, ci, skip, l)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --------------------------------------------------------------------------
# The twin through the wrapper against cstpu's K7
# --------------------------------------------------------------------------

def _clear_rows(scores, depth):
    top = -np.sort(-np.nan_to_num(scores, nan=-1.0), axis=1)[:, :depth + 1]
    return ((top[:, :-1] - top[:, 1:]) > GAP * top[:, :1]).all(axis=1)


@pytest.mark.parametrize("l,n,m,dtype", [(129, 2048, 4096, BF),
                                         (200, 4096, 1024, F32),
                                         (512, 4096, 1024, F32)])
def test_twin_past_128_slots_matches_pallas(l, n, m, dtype):
    rng = np.random.default_rng(l + n)
    A = rng.standard_normal((n, m)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    A[:, 700] = A[:, 3]                        # a tie across the tiles
    R = rng.standard_normal((8, n)).astype(np.float32)
    R[0] = 0.3 * R[0] + 2.0 * A[:, 3]
    R[5, 7] = np.nan
    tA = torch.from_numpy(A).to(dtype)
    assert m // tss._tile_of(tA, "test") == 2
    tv, ti = tss.correlate_select_topl_stream(tA, torch.from_numpy(R), l)
    jA = jnp.asarray(A, jnp.float32 if dtype == F32 else jnp.bfloat16)
    jv, ji = jss.correlate_select_topl_stream(jA, jnp.asarray(R), l,
                                              interpret=True)
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    assert tv.shape == jv.shape == (8, l)
    np.testing.assert_allclose(np.sort(tv, axis=1), np.sort(jv, axis=1),
                               rtol=RTOL)
    assert (tv[5] == -np.inf).all() and (ti[5] == 0).all()
    assert {3, 700} <= set(ti[0].tolist())
    s = np.abs(torch.from_numpy(R).to(dtype).float().numpy()
               @ tA.float().numpy())
    clear = _clear_rows(s, l)
    clear[0] = False                           # the copies tie
    np.testing.assert_array_equal(ti[clear], ji[clear])
    for b in range(8):
        assert set(ti[b].tolist()) == set(ji[b].tolist()), b


# --------------------------------------------------------------------------
# The wrapper's C calls past 128 slots
# --------------------------------------------------------------------------

class _Recorder:
    """Stands in for the kernel library: records each C call's arguments,
    writes `work` bytes into cstpu_stream_topl_work's out, returns 0."""

    def __init__(self, work):
        self.calls, self.work = [], work

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            if name == "cstpu_stream_topl_work":
                args[-1][0] = self.work
            return 0
        return call


@pytest.mark.parametrize("work", [0, 4096])
def test_wrapper_past_128_slots_launches_the_wide_finish(monkeypatch, work):
    from cstpu_torch.ops import _build

    rec = _Recorder(work)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_build, "load", lambda: rec)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(tss, "_stream", lambda: None)
    tss._finish_work.cache_clear()
    B, n, m, l = 8, 1024, 8192, 160
    A = torch.zeros((n, m), dtype=BF)
    R = torch.zeros((B, n))
    before = dict(tfs.LAUNCHES)
    val, idx = tss.correlate_select_topl_stream(A, R, l)
    tss._finish_work.cache_clear()
    assert tuple(val.shape) == tuple(idx.shape) == (B, l)
    got = {k: v - before[k] for k, v in tfs.LAUNCHES.items() if v != before[k]}
    assert got == {"select_topl_stream_mma": 1, "stream_topl_finish": 1}
    names = [c[0] for c in rec.calls]
    assert names == ["cstpu_stream_topl", "cstpu_stream_topl_work",
                     "cstpu_stream_topl_finish"]
    sweep, query, fin = (c[1] for c in rec.calls)
    assert sweep[6:10] == (B, n, m, TILE)      # a block's whole list
    bpt = tss._tile_of(A, "test") // TILE
    assert query[:4] == (B, m, l, bpt)
    assert fin[4:8] == (B, m, l, bpt)
    assert (fin[8] is None) == (work == 0)


# --------------------------------------------------------------------------
# The sharded solvers past 128 picks against cstpu's
# --------------------------------------------------------------------------

WIDE_K = 129


def _problem():
    """n = 272 (SP needs 2k <= n), m = 1024 and eight random measurements:
    the top-129 of every row is spread out."""
    rng = np.random.default_rng(129)
    A = rng.standard_normal((272, 1024)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    return A, rng.standard_normal((8, 272)).astype(np.float32)


def _by_atom(sol):
    """Per row the active atoms, ascending, and their coefficients."""
    s = solution_to_numpy(sol)
    out = []
    for idx, mask, val in zip(s["idx"], s["mask"], s["val"]):
        order = np.argsort(idx[mask])
        out.append((idx[mask][order], val[mask][order]))
    return out


@pytest.mark.parametrize("name", ["gomp", "sp"])
def test_sharded_past_128_picks_matches_cstpu(name):
    # cstpu's sharded bodies take 25-125 s to compile at k = 129 on this
    # CPU, its batched solvers (the same selections, unsharded) 2-3 s: they
    # are the reference. Coefficients of a 129-atom least-squares fit in
    # f32 (the engine's factorization against cstpu's) to atol 1e-5.
    A, Bs = _problem()
    mesh = make_mesh((1, 2), devices=["cpu"])
    tA, tB = to_torch(A), to_torch(Bs)
    jA, jB = jnp.asarray(A), jnp.asarray(Bs)
    if name == "gomp":
        got = tsh.gomp_sharded_fused(tA, tB, WIDE_K, WIDE_K, mesh,
                                     corr_dtype=F32)
        want = jbatched.gomp_batch(jA, jB, WIDE_K, WIDE_K)
    else:
        got = tsh.sp_sharded_fused(tA, tB, WIDE_K, mesh, maxiter=2,
                                   corr_dtype=F32)
        want = jbatched.sp_batch(jA, jB, WIDE_K, maxiter=2)
    for (gi, gv), (wi, wv) in zip(_by_atom(got),
                                  _by_atom(solution_from_cstpu(want))):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-5)
        assert gi.size == WIDE_K
