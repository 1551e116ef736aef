"""The plain twins of the streaming select kernels
(cstpu_torch.ops.stream_select, cstpu_torch.ops.corr_argmax) on the CPU
against cstpu's Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances: values to 1e-5 relative (f32 sums of the same products in
another order; in bf16 both sides round R and multiply exactly); indices
equal wherever the gap between a row's best scores is clear of that noise.
Exact ties are built by repeating a column, NaN cases by poisoning a row of
R or one atom. The top-l results are compared as sets of (index, value)
per row after sorting: the slot order is the running set's own on both
sides, and is compared too where no two scores tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu.ops import pallas_kernels as jpk
from cstpu.ops import stream_select as jss
from cstpu_torch.ops import corr_argmax as tca
from cstpu_torch.ops import stream_select as tss

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
RTOL = 1e-5
# (n, m): cstpu's test size, a ragged atom count (one 1152-atom tile), and a
# size whose 8 MB tile splits the shard (two tiles in bf16, four in f32)
SIZES = [(64, 1024), (64, 1152), (1024, 8192)]


def _inputs(seed, n, m, B=8):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    R = rng.standard_normal((B, n)).astype(np.float32)
    return A, R


def _pair(A, cdt):
    """The dictionary in the correlation dtype, for both packages."""
    tA = torch.from_numpy(A).to(TDT[cdt])
    jA = jnp.asarray(tA.float().numpy()).astype(JDT[cdt])
    return tA, jA


def _clear(scores, depth=1):
    """Rows whose `depth` best scores are clear of each other and of the
    next one by more than the summation noise."""
    top = -np.sort(-scores, axis=1)[:, :depth + 1]
    with np.errstate(invalid="ignore"):      # -inf - -inf on excluded rows
        return np.all(top[:, :-1] - top[:, 1:] > 1e-4 * top[:, :1], axis=1)


def _scores(tA, R):
    return np.abs(torch.from_numpy(R).to(tA.dtype).float().numpy()
                  @ tA.float().numpy())


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("n,m", SIZES)
def test_select_stream_matches_pallas(n, m, cdt):
    A, R = _inputs(1, n, m)
    tA, jA = _pair(A, cdt)
    tv, ti = tss.correlate_select_stream(tA, torch.from_numpy(R))
    jv, ji = jss.correlate_select_stream(jA, jnp.asarray(R), interpret=True)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    clear = _clear(_scores(tA, R))
    assert clear.sum() >= 6
    np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ji)[clear])


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("l", [1, 4, 32])
@pytest.mark.parametrize("n,m", SIZES)
def test_select_topl_stream_matches_pallas(n, m, l, cdt):
    A, R = _inputs(2, n, m)
    tA, jA = _pair(A, cdt)
    tv, ti = tss.correlate_select_topl_stream(tA, torch.from_numpy(R), l)
    jv, ji = jss.correlate_select_topl_stream(jA, jnp.asarray(R), l,
                                              interpret=True)
    assert tuple(tv.shape) == tuple(ti.shape) == (8, l)
    clear = _clear(_scores(tA, R), depth=l)
    assert clear.sum() >= 4
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    for b in np.flatnonzero(clear):
        # slot for slot where nothing ties, and as sorted sets
        np.testing.assert_array_equal(ti[b], ji[b])
        np.testing.assert_allclose(tv[b], jv[b], rtol=RTOL)
    for b in range(8):
        np.testing.assert_allclose(np.sort(tv[b]), np.sort(jv[b]), rtol=RTOL)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("n,m", SIZES)
def test_select_masked_stream_matches_pallas(n, m, cdt):
    A, R = _inputs(3, n, m)
    tA, jA = _pair(A, cdt)
    sc = _scores(tA, R)
    M = np.zeros((8, m), np.float32)
    # exclude each row's four best atoms, and every atom of the last row
    M[np.arange(8)[:, None], np.argsort(-sc, axis=1)[:, :4]] = -np.inf
    M[7] = -np.inf
    tv, ti = tss.correlate_select_masked_stream(
        tA, torch.from_numpy(R), torch.from_numpy(M))
    jv, ji = jss.correlate_select_masked_stream(
        jA, jnp.asarray(R), jnp.asarray(M), interpret=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    clear = _clear(sc + M)
    clear[7] = True
    np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ji)[clear])
    # the excluded row: the running pair's start
    assert tv[7] == -torch.inf and ti[7] == 0
    # no excluded atom was picked
    assert np.all(M[np.arange(7), ti.numpy()[:7]] == 0)


def _tied(n, m, at):
    """A dictionary whose atoms `at` are one repeated column, and residuals
    that all score it highest."""
    A, R = _inputs(4, n, m)
    A[:, at] = A[:, [at[0]]]
    R[:] = 0.05 * R + A[:, at[0]]
    return A, R


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_ties_go_to_the_lowest_index_within_and_across_tiles(cdt):
    # n=1024, m=8192: tiles of 4096 (bf16) or 2048 (f32) atoms; the repeated
    # column sits twice in one tile and once in a later one
    at = [700, 1900, 7000]
    A, R = _tied(1024, 8192, at)
    tA, jA = _pair(A, cdt)
    tR, jR = torch.from_numpy(R), jnp.asarray(R)
    tv, ti = tss.correlate_select_stream(tA, tR)
    jv, ji = jss.correlate_select_stream(jA, jR, interpret=True)
    assert np.all(ti.numpy() == 700) and np.all(np.asarray(ji) == 700)
    # K10 on the same columns, R as (n, B)
    ki, kv = tca.correlate_argmax(tA, tR.T)
    gi, gv = jpk.correlate_argmax(jA, jR.T, interpret=True)
    assert np.all(ki.numpy() == 700) and np.all(np.asarray(gi) == 700)
    # masking the first copy moves the pick to the second, then the third
    M = np.zeros((8, 8192), np.float32)
    for hide, want in (([700], 1900), ([700, 1900], 7000)):
        M[:, hide] = -np.inf
        _, ti = tss.correlate_select_masked_stream(tA, tR,
                                                   torch.from_numpy(M))
        _, ji = jss.correlate_select_masked_stream(jA, jR, jnp.asarray(M),
                                                   interpret=True)
        assert np.all(ti.numpy() == want) and np.all(np.asarray(ji) == want)
    # top-2 holds the two lowest copies: the later tile's equal value does
    # not displace an earlier entry
    tv, ti = tss.correlate_select_topl_stream(tA, tR, 2)
    jv, ji = jss.correlate_select_topl_stream(jA, jR, 2, interpret=True)
    for got in (ti.numpy(), np.asarray(ji)):
        assert all(sorted(row.tolist()) == [700, 1900] for row in got)


def test_topl_evicts_the_lowest_slot_among_equal_minima():
    # n = 8256 makes the 8 MB tile 128 atoms wide, so m = 384 is three
    # tiles: the running set holds the repeated column twice (slots 0 and
    # 1), then a larger score arrives from the last tile and takes the
    # FIRST slot that holds the minimum, so atom 9 stays and atom 3 goes
    rng = np.random.default_rng(5)
    n, m = 8256, 384
    assert tss._stream_tile(m, n, 4, tss.STREAM_TILE_BYTES) == 128
    A = 0.01 * rng.standard_normal((n, m)).astype(np.float32)
    a = rng.standard_normal(n).astype(np.float32)
    a /= np.linalg.norm(a)
    A[:, 3] = A[:, 9] = 0.5 * a
    A[:, 300] = a
    R = np.tile(a, (8, 1))
    tv, ti = tss.correlate_select_topl_stream(
        torch.from_numpy(A), torch.from_numpy(R), 2)
    jv, ji = jss.correlate_select_topl_stream(
        jnp.asarray(A), jnp.asarray(R), 2, interpret=True)
    assert ti.tolist() == [[300, 9]] * 8
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_nan_row_and_poisoned_atom(cdt):
    n, m = 1024, 8192
    A, R = _inputs(6, n, m)
    R[1, 5] = np.nan                         # a NaN row of R
    tA, jA = _pair(A, cdt)
    sc = _scores(tA, R)
    best = int(np.argmax(sc[2]))             # row 2's best atom ...
    tA[:, best] = float("nan")               # ... poisoned in the dictionary
    jA = jA.at[:, best].set(jnp.nan)
    tR, jR = torch.from_numpy(R), jnp.asarray(R)
    tm = tss._stream_tile(m, n, tA.element_size(), tss.STREAM_TILE_BYTES)
    assert m // tm >= 2
    lo = best // tm * tm                     # its tile is skipped whole
    sc[:, lo:lo + tm] = -np.inf
    M = np.zeros((8, m), np.float32)

    for tv, ti, jv, ji in (
            (*tss.correlate_select_stream(tA, tR),
             *jss.correlate_select_stream(jA, jR, interpret=True)),
            (*tss.correlate_select_masked_stream(tA, tR,
                                                 torch.from_numpy(M)),
             *jss.correlate_select_masked_stream(jA, jR, jnp.asarray(M),
                                                 interpret=True))):
        tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
        # the NaN row keeps the running pair's start on both sides
        assert tv[1] == jv[1] == -np.inf and ti[1] == ji[1] == 0
        live = [b for b in range(8) if b != 1]
        np.testing.assert_allclose(tv[live], jv[live], rtol=RTOL)
        np.testing.assert_array_equal(ti[live], ji[live])
        # every other row picked outside the poisoned tile
        np.testing.assert_array_equal(ti[live], np.argmax(sc, axis=1)[live])

    l = 4
    tv, ti = tss.correlate_select_topl_stream(tA, tR, l)
    jv, ji = jss.correlate_select_topl_stream(jA, jR, l, interpret=True)
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    assert np.all(tv[1] == -np.inf) and np.all(ti[1] == 0)      # l empty slots
    assert np.all(jv[1] == -np.inf) and np.all(ji[1] == 0)
    for b in (0, 2, 3, 4, 5, 6, 7):
        np.testing.assert_array_equal(np.sort(ti[b]), np.sort(ji[b]))
        np.testing.assert_array_equal(
            np.sort(ti[b]), np.sort(np.argsort(-sc[b])[:l]))

    # K10 makes the NaN visible: every row's value is NaN (the poisoned atom
    # scores NaN against all of them) and the index is what it was before
    # the poisoned tile of `_pick_tile(m)` atoms
    ki, kv = tca.correlate_argmax(tA, tR.T)
    gi, gv = jpk.correlate_argmax(jA, jR.T, interpret=True)
    assert np.all(np.isnan(kv.numpy())) and np.all(np.isnan(np.asarray(gv)))
    np.testing.assert_array_equal(ki.numpy(), np.asarray(gi))


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("n,m", [(64, 1024), (64, 1152), (96, 640)])
def test_correlate_argmax_matches_pallas(n, m, cdt):
    A, R = _inputs(7, n, m)
    tA, jA = _pair(A, cdt)
    assert tca._pick_tile(m) == jpk._pick_tile(m)
    ki, kv = tca.correlate_argmax(tA, torch.from_numpy(R).T)
    gi, gv = jpk.correlate_argmax(jA, jnp.asarray(R).T, interpret=True)
    assert ki.dtype == torch.int32 and kv.dtype == torch.float32
    np.testing.assert_allclose(kv.numpy(), np.asarray(gv), rtol=RTOL)
    clear = _clear(_scores(tA, R))
    np.testing.assert_array_equal(ki.numpy()[clear], np.asarray(gi)[clear])
    # one residual (n,): scalars
    i1, v1 = tca.correlate_argmax(tA, torch.from_numpy(R[0]))
    j1, w1 = jpk.correlate_argmax(jA, jnp.asarray(R[0]), interpret=True)
    assert i1.ndim == 0 and v1.ndim == 0
    np.testing.assert_allclose(float(v1), float(w1), rtol=RTOL)
    if clear[0]:
        assert int(i1) == int(j1)


def test_correlate_argmax_nan_row_only_poisons_that_row():
    A, R = _inputs(8, 64, 1024)
    R[3, 0] = np.nan
    tA, jA = _pair(A, "f32")
    ki, kv = tca.correlate_argmax(tA, torch.from_numpy(R).T)
    gi, gv = jpk.correlate_argmax(jA, jnp.asarray(R).T, interpret=True)
    np.testing.assert_array_equal(np.isnan(kv.numpy()),
                                  np.isnan(np.asarray(gv)))
    assert np.isnan(kv.numpy()).tolist() == [b == 3 for b in range(8)]
    np.testing.assert_array_equal(ki.numpy(), np.asarray(gi))


def test_gates_and_tiles_match_cstpu():
    for m, n, itemsize in ((1024, 64, 4), (1152, 64, 2), (131072, 1024, 2),
                           (131072, 1024, 4), (1000, 64, 4), (128, 70000, 4)):
        assert (tss._stream_tile(m, n, itemsize, 8 << 20)
                == jss._stream_tile(m, n, itemsize, 8 << 20))
    for n, m, B in ((64, 1024, 8), (60, 1024, 8), (64, 1000, 8),
                    (64, 1024, 6)):
        tA, jA = torch.empty((n, m)), jnp.zeros((n, m), jnp.float32)
        for cdt in ("f32", "bf16"):
            assert (tss.supported_select(tA, B, TDT[cdt])
                    == jss.supported_select(jA, B, JDT[cdt]))
    for m in (1024, 640, 1000, 128):
        assert (tca.supported(torch.empty((8, m)), torch.empty((8,)))
                == bool(jpk.supported(jnp.zeros((8, m), jnp.float32),
                                      jnp.zeros((8,), jnp.float32))))


def test_shape_errors():
    A = torch.zeros((64, 1000))
    R = torch.zeros((8, 64))
    with pytest.raises(ValueError, match="no streamable tile"):
        tss.correlate_select_stream(A, R)
    with pytest.raises(ValueError, match="128-multiple"):
        tca.correlate_argmax(A, R.T)
    A = torch.zeros((64, 1024))
    # l = 33 is served now; l < 1 is not
    assert tss.correlate_select_topl_stream(A, R, 33)[0].shape == (8, 33)
    with pytest.raises(ValueError, match="l=0 < 1"):
        tss.correlate_select_topl_stream(A, R, 0)
    with pytest.raises(ValueError, match="resc must be a contiguous"):
        tss.fr_step_select(A, R, R, torch.full((8, 2), -1), torch.ones(1024),
                           torch.ones((8, 1024), dtype=torch.float64), 1e-4)
    with pytest.raises(ValueError, match=r"il must be \(8, 2\)"):
        tss.fr_step_select(A, R, R, torch.full((8,), -1), torch.ones(1024),
                           torch.ones((8, 1024)), 1e-4)
    with pytest.raises(ValueError, match="float32"):
        tss.correlate_select_masked_stream(
            A, R, torch.zeros((8, 1024), dtype=torch.uint8))
    with pytest.raises(ValueError, match="bfloat16 or"):
        tss.correlate_select_stream(A.double(), R)
    with pytest.raises(ValueError, match=r"need A \(n, m\)"):
        tss.correlate_select_stream(A, torch.zeros((8, 32)))


# --------------------------------------------------------------------------
# The top-l select beyond 32 slots
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("n,m", SIZES)
def test_select_topl_stream_48_matches_pallas(n, m, cdt):
    # l = 48 with a repeated column among the best: cstpu's kept set, ties
    # included. The repeated column sits at three places (at n=1024 in two
    # tiles); value for value the sorted sets agree, and index for index
    A, R = _inputs(12, n, m)
    at = [5, 700, m - 100]
    A[:, at] = A[:, [at[0]]]
    R[:4] = 0.3 * R[:4] + 3 * A[:, at[0]]        # rows 0-3 rank it high
    tA, jA = _pair(A, cdt)
    l = 48
    tv, ti = tss.correlate_select_topl_stream(tA, torch.from_numpy(R), l)
    jv, ji = jss.correlate_select_topl_stream(jA, jnp.asarray(R), l,
                                              interpret=True)
    assert tuple(tv.shape) == tuple(ti.shape) == (8, l)
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    sc = _scores(tA, R)
    for b in range(8):
        np.testing.assert_allclose(np.sort(tv[b]), np.sort(jv[b]), rtol=RTOL)
        # the repeated column counts once in the clearance of the scores
        uniq = np.delete(sc[b], at[1:])
        if _clear(uniq[None], depth=l)[0]:
            np.testing.assert_array_equal(np.sort(ti[b]), np.sort(ji[b]))
    for b in range(4):                            # all three copies are kept
        assert set(at) <= set(ti[b].tolist()) and set(at) <= set(ji[b].tolist())


def test_topl_48_evicts_the_lowest_slot_among_equal_minima():
    # the case of test_topl_evicts_the_lowest_slot_among_equal_minima in a
    # 48-slot set: 128-atom tiles; tile 0 fills the set with its 48 best,
    # the two weakest of them one repeated column (atoms 3 and 9); tile 2
    # then offers ONE larger score, which takes the first slot holding the
    # minimum, so atom 9 stays and atom 3 goes
    rng = np.random.default_rng(6)
    n, m, l = 8256, 384, 48
    A = 1e-3 * rng.standard_normal((n, m)).astype(np.float32)
    a = rng.standard_normal(n).astype(np.float32)
    a /= np.linalg.norm(a)
    strong = list(range(20, 66))                  # 46 atoms of tile 0
    for rank, j in enumerate(strong):
        A[:, j] = (0.9 - 0.005 * rank) * a
    A[:, 3] = A[:, 9] = 0.5 * a
    A[:, 300] = a
    R = np.tile(a, (8, 1))
    tv, ti = tss.correlate_select_topl_stream(
        torch.from_numpy(A), torch.from_numpy(R), l)
    jv, ji = jss.correlate_select_topl_stream(
        jnp.asarray(A), jnp.asarray(R), l, interpret=True)
    want = sorted(strong + [9, 300])
    assert all(sorted(row) == want for row in ti.tolist())
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)


# --------------------------------------------------------------------------
# fr_step_select: the rescaling update and the OLS select in one sweep
# --------------------------------------------------------------------------

DEG = 8.0 * 64 * 1.1920929e-07


def _fr_inputs(seed, n, m, B=8):
    """A dictionary, residuals, and pending directions small enough that no
    rescaling comes near zero (resc - z^2 stays above 0.5)."""
    rng = np.random.default_rng(seed)
    A, R = _inputs(seed, n, m, B)
    W = (0.5 * rng.standard_normal((B, n)) / np.sqrt(n)).astype(np.float32)
    V = (0.5 * rng.standard_normal((B, n)) / np.sqrt(n)).astype(np.float32)
    cn2 = np.sum(A * A, axis=0, dtype=np.float32)
    resc = np.broadcast_to(cn2, (B, m)).copy()
    il = np.full((B, 2), -1, np.int32)
    return A, R, W, V, il, cn2, resc


def _fr_both(tA, jA, R, W, V, il, cn2, resc, deg=DEG):
    """(port (val, idx, resc), cstpu (val, idx, resc)) as numpy; the port's
    resc must be the tensor it was given."""
    t = lambda x: None if x is None else torch.from_numpy(x)
    j = lambda x: None if x is None else jnp.asarray(x)
    tresc = torch.from_numpy(resc.copy())
    tv, ti, tr = tss.fr_step_select(tA, t(R), t(W), t(il), t(cn2), tresc, deg,
                                    V=t(V))
    assert tr is tresc and tv.dtype == torch.float32
    assert ti.dtype == torch.int32
    jv, ji, jr = jss.fr_step_select(jA, j(R), j(W), j(il), j(cn2)[None],
                                    j(resc), deg, V=j(V), interpret=True)
    return ((tv.numpy(), ti.numpy(), tr.numpy()),
            (np.asarray(jv), np.asarray(ji), np.asarray(jr)))


def _same_step(got, want, rows=slice(None)):
    (tv, ti, tr), (jv, ji, jr) = got, want
    np.testing.assert_allclose(tv[rows], jv[rows], rtol=RTOL)
    np.testing.assert_array_equal(ti[rows], ji[rows])
    np.testing.assert_array_equal(tr == -1.0, jr == -1.0)
    np.testing.assert_allclose(tr[rows], jr[rows], rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("use_v", [False, True])
@pytest.mark.parametrize("n,m", SIZES)
def test_fr_step_select_matches_pallas(n, m, use_v, cdt):
    A, R, W, V, il, cn2, resc = _fr_inputs(21, n, m)
    resc[:, 40] = -1.0                            # an atom already active
    il[:4, 0] = 77                                # rows 0-3 mark atom 77
    il[2:6, 1] = 40                               # rows 2-5 restore atom 40
    tA, jA = _pair(A, cdt)
    got, want = _fr_both(tA, jA, R, W, V if use_v else None, il, cn2, resc)
    _same_step(got, want)
    tr = got[2]
    assert np.all(tr[:4, 77] == -1.0) and np.all(tr[4:, 77] > 0)
    # an active atom that is not restored stays negative (it drifts by the
    # updates, which never reach the threshold)
    assert np.all(tr[[0, 1, 6, 7], 40] <= -1.0 + (1.0 if use_v else 0.0))
    assert np.all(tr[[0, 1, 6, 7], 40] < 0)
    # a restored atom holds exactly the V update on a zero base, less z^2
    zv = (torch.from_numpy(V).to(tA.dtype).float() @ tA.float()).numpy()
    zw = (torch.from_numpy(W).to(tA.dtype).float() @ tA.float()).numpy()
    expect = (zv[2:6, 40] ** 2 if use_v else 0) - zw[2:6, 40] ** 2
    np.testing.assert_allclose(tr[2:6, 40], expect, rtol=1e-4, atol=1e-7)
    # the marked and the active atoms are never selected
    assert not np.any(got[1][:4] == 77)


@pytest.mark.parametrize("n,m", SIZES)
def test_fr_step_select_on_a_column_slice_with_v_matches_pallas(n, m):
    # an f32 shard read in place as a column view of a dictionary four
    # shards wide (rows 4 m entries apart), with V, a mark and a restore:
    # the same update of resc and the same pick as cstpu's kernel on the
    # shard alone, and the rest of the wide dictionary untouched
    A, R, W, V, il, cn2, resc = _fr_inputs(25, n, m)
    resc[:, 40] = -1.0                            # an atom already active
    il[:3, 0] = 77                                # rows 0-2 mark atom 77
    il[3:5, 1] = 40                               # rows 3-4 restore atom 40
    rng = np.random.default_rng(26)
    wide = rng.standard_normal((n, 4 * m)).astype(np.float32)
    wide[:, m:2 * m] = A
    tw = torch.from_numpy(wide)
    tA = tw[:, m:2 * m]
    assert tA.stride() == (4 * m, 1) and not tA.is_contiguous()
    got, want = _fr_both(tA, jnp.asarray(A), R, W, V, il, cn2, resc)
    _same_step(got, want)
    assert np.all(got[2][:3, 77] == -1.0)
    assert np.all(got[2][3:5, 40] > -1.0)
    np.testing.assert_array_equal(tw.numpy(), wide)


def _quarter_view(A, seed):
    """A (n, m) as the second shard of an f32 dictionary four shards wide
    (rows 4 m entries apart): (the wide array, its tensor, the view)."""
    n, m = A.shape
    wide = np.random.default_rng(seed).standard_normal(
        (n, 4 * m)).astype(np.float32)
    wide[:, m:2 * m] = A
    tw = torch.from_numpy(wide)
    tA = tw[:, m:2 * m]
    assert tA.stride() == (4 * m, 1) and not tA.is_contiguous()
    return wide.copy(), tw, tA


@pytest.mark.parametrize("n,m", SIZES)
def test_select_stream_on_a_column_slice_matches_pallas(n, m):
    # an f32 shard read in place as a column view of a dictionary four
    # shards wide: the same pick as cstpu's kernel on the shard alone, and
    # the wide dictionary untouched
    A, R = _inputs(31, n, m)
    wide, tw, tA = _quarter_view(A, 32)
    tv, ti = tss.correlate_select_stream(tA, torch.from_numpy(R))
    jv, ji = jss.correlate_select_stream(jnp.asarray(A), jnp.asarray(R),
                                         interpret=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    clear = _clear(np.abs(R @ A))
    assert clear.sum() >= 6
    np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ji)[clear])
    np.testing.assert_array_equal(tw.numpy(), wide)


@pytest.mark.parametrize("n,m", SIZES)
def test_select_masked_stream_on_a_column_slice_matches_pallas(n, m):
    # the masked select on the same kind of view: each row's four best
    # atoms excluded, and every atom of the last row ((-inf, 0) on both)
    A, R = _inputs(33, n, m)
    wide, tw, tA = _quarter_view(A, 34)
    sc = np.abs(R @ A)
    M = np.zeros((8, m), np.float32)
    M[np.arange(8)[:, None], np.argsort(-sc, axis=1)[:, :4]] = -np.inf
    M[7] = -np.inf
    tv, ti = tss.correlate_select_masked_stream(
        tA, torch.from_numpy(R), torch.from_numpy(M))
    jv, ji = jss.correlate_select_masked_stream(
        jnp.asarray(A), jnp.asarray(R), jnp.asarray(M), interpret=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    clear = _clear(sc + M)
    clear[7] = True
    np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ji)[clear])
    assert tv[7] == -torch.inf and ti[7] == 0
    assert np.all(M[np.arange(7), ti.numpy()[:7]] == 0)
    np.testing.assert_array_equal(tw.numpy(), wide)


@pytest.mark.parametrize("l", [1, 4, 32, 48])
@pytest.mark.parametrize("n,m", SIZES)
def test_select_topl_stream_on_a_column_slice_matches_pallas(n, m, l):
    # the top-l select on the same kind of view: the same slots as cstpu's
    # kernel on the shard alone where nothing ties, the same values as
    # sorted sets on every row, and the wide dictionary untouched
    A, R = _inputs(41, n, m)
    wide, tw, tA = _quarter_view(A, 42)
    tv, ti = tss.correlate_select_topl_stream(tA, torch.from_numpy(R), l)
    jv, ji = jss.correlate_select_topl_stream(jnp.asarray(A), jnp.asarray(R),
                                              l, interpret=True)
    assert tuple(tv.shape) == tuple(ti.shape) == (8, l)
    # at l = 48 over 8192 atoms few rows have all 49 best scores apart
    clear = _clear(np.abs(R @ A), depth=l)
    assert clear.sum() >= 2
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    for b in np.flatnonzero(clear):
        np.testing.assert_array_equal(ti[b], ji[b])
        np.testing.assert_allclose(tv[b], jv[b], rtol=RTOL)
    for b in range(8):
        np.testing.assert_allclose(np.sort(tv[b]), np.sort(jv[b]), rtol=RTOL)
    np.testing.assert_array_equal(tw.numpy(), wide)


@pytest.mark.parametrize("n,m", SIZES)
def test_correlate_argmax_on_a_column_slice_matches_pallas(n, m):
    # correlate_argmax on the same kind of view, R given as (n, B) (a
    # contiguous tensor, read through its strides on the card)
    A, R = _inputs(35, n, m)
    wide, tw, tA = _quarter_view(A, 36)
    RT = torch.from_numpy(np.ascontiguousarray(R.T))
    assert RT.stride() == (8, 1)
    assert tca._pick_tile(m) == jpk._pick_tile(m)
    ki, kv = tca.correlate_argmax(tA, RT)
    gi, gv = jpk.correlate_argmax(jnp.asarray(A), jnp.asarray(R.T),
                                  interpret=True)
    np.testing.assert_allclose(kv.numpy(), np.asarray(gv), rtol=RTOL)
    clear = _clear(np.abs(R @ A))
    assert clear.sum() >= 6
    np.testing.assert_array_equal(ki.numpy()[clear], np.asarray(gi)[clear])
    np.testing.assert_array_equal(tw.numpy(), wide)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_fr_step_select_nan_row_poisoned_atom_degenerate_row(cdt):
    n, m = 1024, 8192
    deg = 8.0 * n * 1.1920929e-07
    A, R, W, V, il, cn2, resc = _fr_inputs(22, n, m)
    tA, jA = _pair(A, cdt)
    tm = tss._stream_tile(m, n, tA.element_size(), tss.STREAM_TILE_BYTES)
    assert m // tm >= 2
    R[1, 5] = np.nan      # a NaN row: q is NaN everywhere, every tile skipped
    resc[3] = 0.0         # an all-degenerate row: nothing passes the
    W[3] = V[3] = 0.0     # threshold, every score is -inf
    # row 2's best atom is poisoned in the dictionary: z = w . a is NaN for
    # every row (0 * NaN included), so its resc is NaN from now on, fails
    # the threshold test and scores -inf: its tile is NOT skipped
    q = (torch.from_numpy(R).to(tA.dtype).float() @ tA.float()).numpy()
    best = int(np.nanargmax(q[2] ** 2))
    tA[:, best] = float("nan")
    jA = jA.at[:, best].set(jnp.nan)
    got, want = _fr_both(tA, jA, R, W, V, il, cn2, resc, deg=deg)
    live = [0, 2, 4, 5, 6, 7]
    _same_step(got, want, rows=live)
    lo = best // tm * tm
    for val, idx, out in (got, want):
        assert val[1] == -np.inf and idx[1] == 0
        assert val[3] == -np.inf and idx[3] == 0
        assert np.all(np.isnan(out[:, best]))
        assert not np.any(idx[live] == best)
        # rows still pick inside the poisoned atom's tile
        assert np.any((idx[live] >= lo) & (idx[live] < lo + tm))


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_fr_step_select_skips_a_tile_whose_score_is_nan(cdt):
    # a NaN in q with a valid rescaling makes d2 NaN, and the tile that
    # holds it is skipped whole. Row 2 of R carries two infs that meet
    # entries of one sign in every atom (q = inf, d2 = inf) but for atom
    # 100, where the signs differ: inf - inf = NaN. Tile 0 is skipped and
    # the row's answer is the first atom of tile 1, at d2 = inf
    n, m = 1024, 8192
    A, R, W, V, il, cn2, resc = _fr_inputs(23, n, m)
    W[:] = 0.0
    A[7:9] = np.abs(A[7:9]) + 1e-3
    A[8, 100] = -A[8, 100]
    cn2 = np.sum(A * A, axis=0, dtype=np.float32)
    resc = np.broadcast_to(cn2, resc.shape).copy()
    R[2, 7] = R[2, 8] = np.inf
    tA, jA = _pair(A, cdt)
    tm = tss._stream_tile(m, n, tA.element_size(), tss.STREAM_TILE_BYTES)
    got, want = _fr_both(tA, jA, R, W, None, il, cn2, resc,
                         deg=8.0 * n * 1.1920929e-07)
    _same_step(got, want)
    for val, idx, _ in (got, want):
        assert val[2] == np.inf and idx[2] == tm


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_fr_step_select_ties_go_to_the_lowest_index_across_tiles(cdt):
    # n=1024, m=8192: the repeated column sits twice in one tile and once in
    # a later one, with equal rescalings: the lowest copy wins; marking it
    # moves the pick to the second, then to the third
    at = [700, 1900, 7000]
    A, R = _tied(1024, 8192, at)
    _, _, W, V, il, cn2, resc = _fr_inputs(24, 1024, 8192)
    cn2 = np.sum(A * A, axis=0, dtype=np.float32)
    resc = np.broadcast_to(cn2, resc.shape).copy()
    W[:] = 0.0
    tA, jA = _pair(A, cdt)
    for hide, pick in (([], 700), ([700], 1900), ([700, 1900], 7000)):
        resc[:, hide] = -1.0
        got, want = _fr_both(tA, jA, R, W, None, il, cn2, resc,
                             deg=8.0 * 1024 * 1.2e-7)
        _same_step(got, want)
        assert np.all(got[1] == pick) and np.all(want[1] == pick)
