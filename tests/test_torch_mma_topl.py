"""The top-l selects' variants (csrc/select_topl.cu for batched GOMP, SP and
the top-k init of OMPR and SRR; the top-l sweep of csrc/stream_select.cu,
K7, for the sharded solvers) and the streamed top-l's finish, as far as the
CPU can see them.

Both selects have a tensor-core variant (the top-1 selects' wgmma loop with
the sorting epilogue of csrc/mma_topl.cuh) for a bf16 dictionary whose base
and row pitch the loop's bulk loads can address, and a CUDA-core variant
for everything else; the kernels exist only on the card, where
tests/test_torch_kernels.py holds both to the plain twins. What decides the
variant is Python, and is tested here: the predicate shared with the top-1
selects (`fused_solve.mma_select_takes`) over dtypes, addresses, pitches
and the shard views of a one-shard and a four-shard mesh; that each wrapper
hands the C entry point the variant it picked, with the rounding scratch
only for the tensor-core loop, and counts the launch under that variant's
own key (a stand-in for the kernel library records the calls); and that on
CPU tensors a wrapper runs its plain twin whatever `mma` asks for, and
launches nothing.

The plain twins, through the wrappers, are held against cstpu's Pallas
kernels in interpret mode: the GOMP, SP, OMPR and SRR solves at the oracle
size (tests/conftest.py's planted problem, n=32, at m=128, the Pallas
kernels' atom multiple, and eight measurements of it), the sharded GOMP,
SP and OMPR solves at m=512 on a one-shard and a four-shard mesh, and the
streamed top-l at l = 128 (the narrow finish's most) with a NaN tile and
ties across tiles. Tolerances: supports equal; coefficients and residuals to 1e-4
absolute (what cstpu holds its kernels to against its XLA paths); streamed
values to 1e-5 relative (f32 sums of the same bf16 products in another
order), slot for slot where no two of the l + 1 best scores lie within
1e-4 of the best (closer scores may trade places between the two sums),
and as sets everywhere else.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu.ops import fused_solve as jfs
from cstpu.ops import fused_twostage as jft
from cstpu.ops import stream_select as jss
from cstpu.parallel import mesh as jmesh
from cstpu.parallel import sharded as jsh
from cstpu_torch.ops import fused_solve as tfs
from cstpu_torch.ops import fused_twostage as tft
from cstpu_torch.ops import stream_select as tss
from cstpu_torch.parallel import make_mesh, shard_dictionary
from cstpu_torch.parallel import sharded as tsh
from cstpu_torch.utils.interop import solution_to_numpy, to_torch

BF, F32 = torch.bfloat16, torch.float32
RTOL = 1e-5
GAP = 1e-4
ATOL = 1e-4


# --------------------------------------------------------------------------
# The variant each top-l wrapper takes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,ptr,lda,m,want", [
    (BF, 0, 8192, 8192, True),             # 2a, 2b, 2c, 3b
    (BF, 0, 8232, 8232, True),             # a ragged width, pitch 16 bytes
    (BF, 2 * 32768, 131072, 32768, True),  # 5c: the second of four shards
    (BF, 2 * 3 * 32768, 131072, 32768, True),
    (BF, 0, 131072, 131072, True),         # 5c on one shard
    (F32, 0, 8192, 8192, False),           # 2a with precision="f32"
    (F32, 4 * 32768, 131072, 32768, False),  # 5c with corr_dtype=f32
    (BF, 0, 1001, 1001, False),            # a contiguous odd width
    (BF, 2 * 100, 131072, 32768, False),   # a shard 100 atoms in
    (BF, 0, 32768 + 4, 32768, False),      # pitch off 16 bytes
])
def test_predicate_over_dtypes_addresses_and_pitches(dtype, ptr, lda, m,
                                                     want):
    assert tfs.mma_select_takes(dtype, ptr, lda, m) is want


def _dictionary(n, m, dtype=BF, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    return torch.from_numpy(A).to(dtype)


@pytest.mark.parametrize("shards", [1, 4])
def test_every_shard_of_the_topl_solvers_takes_the_tensor_core_loop(shards):
    A = _dictionary(16, 2048, F32)
    mesh = make_mesh((1, shards), devices=["cpu"])
    Ash = shard_dictionary(A, mesh)
    for shard in Ash.corr(BF)[0]:
        assert tuple(shard.shape) == (16, 2048 // shards)
        assert tfs._pick_mma(None, shard)
    for shard in Ash.corr(F32)[0]:                 # views of A: CUDA cores
        assert not tfs._pick_mma(None, shard)


def test_each_variant_has_its_own_launch_count():
    for name in ("select_topl", "select_topl_stream"):
        assert name in tfs.LAUNCHES and name + "_mma" in tfs.LAUNCHES
    assert "stream_topl_finish" in tfs.LAUNCHES


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
    import contextlib

    from cstpu_torch.ops import _build

    rec = _Recorder()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_build, "load", lambda: rec)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(tfs, "_stream", lambda: None)
    monkeypatch.setattr(tss, "_stream", lambda: None)
    return rec


@pytest.mark.parametrize("dtype,cut,mma,want", [
    (BF, 0, None, True), (BF, 0, False, False), (BF, 0, True, True),
    (F32, 0, None, False), (F32, 0, True, True),
    (BF, 4, None, False),                      # a slice 8 bytes in
])
def test_wrappers_pass_and_count_the_variant(recorder, dtype, cut, mma,
                                             want):
    B, n, m, l = 8, 32, 1024, 4
    A = _dictionary(n, m + 128, dtype, seed=1)[:, cut:cut + m]
    R = torch.zeros((B, n))
    before = dict(tfs.LAUNCHES)
    tss.correlate_select_topl_stream(A, R, l, mma=mma)
    if cut == 0:
        tfs.select_topl(R, A.contiguous(), l, mma=mma)
    got = {k: v - before[k] for k, v in tfs.LAUNCHES.items() if v != before[k]}
    sfx = "_mma" if want else ""
    assert got == {"select_topl_stream" + sfx: 1, "stream_topl_finish": 1,
                   **({"select_topl" + sfx: 1} if cut == 0 else {})}
    names = [c[0] for c in recorder.calls]
    assert names[:2] == ["cstpu_stream_topl", "cstpu_stream_topl_finish"]
    sweep = recorder.calls[0][1]
    assert sweep[10] == int(want) and (sweep[11] is not None) == want
    assert sweep[2] == m + 128                  # the pitch, read in place
    fin = recorder.calls[1][1]
    assert fin[4:8] == (B, m, l, tss._tile_of(A, "test") // tfs.TILE)
    if cut == 0:
        name, args = recorder.calls[2]
        assert name == "cstpu_select_topl"
        assert args[9] == int(want) and (args[10] is not None) == want


def test_wrappers_reject_what_no_variant_takes(recorder):
    A = _dictionary(32, 1024, seed=2)
    R = torch.zeros((8, 32))
    with pytest.raises(ValueError):
        tfs.select_topl(R, A, tfs.LMAX + 1)
    with pytest.raises(ValueError):
        tss.correlate_select_topl_stream(A, R, 0)
    with pytest.raises(ValueError):
        tss.stream_topl_finish(torch.zeros((8, 8, 4)),
                               torch.zeros((8, 8, 4), dtype=torch.int64), 1, 4)
    assert recorder.calls == []


# --------------------------------------------------------------------------
# The CPU route: the twins, whatever the variant
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mma", [None, True, False])
def test_cpu_wrappers_run_the_twin_whatever_the_variant(mma):
    n, m, B, l = 64, 1152, 8, 5
    A = _dictionary(n, m, seed=3)
    R = torch.from_numpy(
        np.random.default_rng(4).standard_normal((B, n)).astype(np.float32))
    before = dict(tfs.LAUNCHES)
    got = tfs.select_topl(R, A, l, mma=mma)
    want = tfs._topl_ref(R, A, BF, l)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = tss.correlate_select_topl_stream(A, R, l, mma=mma)
    want = tss.correlate_select_topl_stream_ref(A, R, l)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    pval, pidx = tss.stream_topl_sweep(A, R, l, mma=mma)
    assert torch.equal(pval, tfs._topl_ref(R, A, BF, l)[0])
    got = tss.stream_topl_finish(pval, pidx, 1152 // tfs.TILE, l)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dict(tfs.LAUNCHES) == before            # no kernel on the CPU


def _scores(A, R):
    return np.abs(R.to(BF).float().numpy() @ A.float().numpy())


@pytest.mark.parametrize("l", [1, 4, 48, 128])
def test_finish_twin_is_the_stream_twin_on_block_partials(l):
    # the finish's rule on 128-atom block lists (sorted, merged per tile)
    # gives the running slots of the tile-by-tile twin, bit for bit
    n, m, B = 1024, 8192, 6                      # two tiles of 4096 in bf16
    A = _dictionary(n, m, seed=5)
    A[:, 4000] = A[:, 9]                         # a tie within tile 0
    A[:, 6000] = A[:, 9]                         # and across tiles
    R = torch.from_numpy(
        np.random.default_rng(6).standard_normal((B, n)).astype(np.float32))
    R[0] = 0.3 * R[0] + 2.0 * A[:, 9].float()
    R[2, 3] = float("nan")
    tm = tss._tile_of(A, "test")
    assert m // tm == 2
    want = tss.correlate_select_topl_stream_ref(A, R, l)
    got = tss.stream_topl_finish_ref(*tfs._topl_ref(R, A, BF, l),
                                     tm // tfs.TILE, l)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[0][2] == -torch.inf).all())
    if l >= 3:
        assert {9, 4000, 6000} <= set(got[1][0].tolist())


def _clear_rows(scores, depth):
    top = -np.sort(-np.nan_to_num(scores, nan=-1.0), axis=1)[:, :depth + 1]
    return ((top[:, :-1] - top[:, 1:]) > GAP * top[:, :1]).all(axis=1)


def test_stream_twin_at_the_most_slots_matches_pallas():
    # l = 128, the narrow finish's most, over four tiles of 128 atoms
    # (n = 8256 in f32), one column three times (twice in tile 0, once in tile 2), a NaN tile
    # (a poisoned atom in tile 1, every row) and a NaN row
    n, m, B, l = 8256, 512, 8, 128
    A = _dictionary(n, m, F32, seed=7)
    A[:, 70] = A[:, 3]
    A[:, 300] = A[:, 3]
    A[:, 200] = float("nan")
    R = np.random.default_rng(8).standard_normal((B, n)).astype(np.float32)
    R[0] = 0.3 * R[0] + 2.0 * A[:, 3].numpy()
    R[1, 5] = np.nan
    assert tss._tile_of(A, "test") == 128
    tv, ti = tss.correlate_select_topl_stream(A, torch.from_numpy(R), l)
    jv, ji = jss.correlate_select_topl_stream(jnp.asarray(A.numpy()),
                                              jnp.asarray(R), l,
                                              interpret=True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert tv.shape == (B, l) and jv.shape == (B, l)
    np.testing.assert_allclose(np.sort(tv.numpy(), axis=1),
                               np.sort(jv, axis=1), rtol=RTOL)
    # tile 1 is skipped whole: nothing of it in any row, NaN row all empty
    assert not ((ti.numpy() >= 128) & (ti.numpy() < 256)).any()
    assert (tv.numpy()[1] == -np.inf).all() and (ti.numpy()[1] == 0).all()
    assert {3, 70, 300} <= set(ti.numpy()[0].tolist())
    s = _scores(A, torch.from_numpy(R))
    s[:, 128:256] = -1.0
    clear = _clear_rows(s, l)
    clear[0] = False                           # the copies tie
    np.testing.assert_array_equal(ti.numpy()[clear], ji[clear])
    for b in range(B):                         # sets everywhere else
        assert set(ti.numpy()[b].tolist()) == set(ji[b].tolist()), b


# --------------------------------------------------------------------------
# Solves through the wrappers against cstpu's Pallas kernels
# --------------------------------------------------------------------------

def _planted(seed, n=32, m=128, k=3):
    """conftest's planted problem and eight measurements of it: (A, Bs
    (8, n)), numpy."""
    from conftest import planted_problem

    A, _, b, y = planted_problem(seed, n=n, m=m, k=k, noise=5e-3,
                                 dtype=jnp.float32)
    b, y = np.asarray(b), np.asarray(y)
    Bs = np.stack([y, b, -y, 2.0 * b, b + 0.5 * y, -b, 0.5 * y, y - 0.25 * b])
    return np.asarray(A), Bs.astype(np.float32)


def _same_solution(t, j):
    t, j = solution_to_numpy(t), solution_to_numpy(j)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=0, atol=ATOL)


def _topl(mma):
    return lambda r, Ac, l: tfs.select_topl(r, Ac, l, mma=mma)


@pytest.mark.parametrize("mma", [None, True])
def test_cpu_gomp_and_sp_through_the_wrapper_match_pallas(mma):
    A, Bs = _planted(800)
    tA, tB = to_torch(A), to_torch(Bs)
    before = dict(tfs.LAUNCHES)
    js, jr = jfs.gomp_fused_solve(A, Bs, 2, 3, corr_dtype=jnp.bfloat16,
                                  interpret=True)
    ts, tr = tfs._gomp(tA, tB, 2, 3, 0.0, BF, _topl(mma), tfs.gomp_append,
                       False)
    _same_solution(ts, js)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=ATOL)
    js, jr = jft.sp_fused_solve(A, Bs, 3, maxiter=8, interpret=True)
    ts, tr, _ = tft._sp(tA, tB, 3, 1e-12, 8, BF, _topl(mma), tft.sp_round,
                     False)
    _same_solution(ts, js)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=ATOL)
    assert dict(tfs.LAUNCHES) == before


@pytest.mark.parametrize("mma", [None, True])
def test_cpu_ompr_and_srr_through_the_wrapper_match_pallas(mma):
    # the top-k init of both on the top-l select
    A, Bs = _planted(801)
    tA, tB = to_torch(A), to_torch(Bs)
    before = dict(tfs.LAUNCHES)
    js, jr = jft.ompr_fused_solve(A, Bs, 3, 1e-12, interpret=True)
    ts, tr, _ = tft._ompr(tA, tB, 3, 1e-12, 1.0, None, BF,
                       (_topl(mma), tft.engine_init, tft.select_argmax,
                        tft.ompr_swap), False)
    _same_solution(ts, js)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=ATOL)
    js, jr = jft.srr_fused_solve(A, Bs, 3, l=2, maxiter=4, interpret=True)
    ts, tr, _ = tft._srr(tA, tB, 3, 1e-12, 4, 2, BF,
                      (_topl(mma), tft.engine_init, tft.rescaled_select,
                       tft.srr_append, tft.engine_delete), False)
    _same_solution(ts, js)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=ATOL)
    assert dict(tfs.LAUNCHES) == before


SHARDED = {
    "gomp": (lambda A, Bs, mesh, **kw: tsh.gomp_sharded_fused(
                 A, Bs, 2, 5, mesh, **kw),       # l=2, k=5: remainder step
             lambda A, Bs, mesh, **kw: jsh.gomp_sharded_fused(
                 A, Bs, 2, 5, mesh, **kw)),
    "sp": (lambda A, Bs, mesh, **kw: tsh.sp_sharded_fused(
               A, Bs, 3, mesh, maxiter=8, **kw),
           lambda A, Bs, mesh, **kw: jsh.sp_sharded_fused(
               A, Bs, 3, mesh, maxiter=8, **kw)),
    "ompr": (lambda A, Bs, mesh, **kw: tsh.ompr_sharded_fused(
                 A, Bs, 3, mesh, delta=1e-12, **kw),
             lambda A, Bs, mesh, **kw: jsh.ompr_sharded_fused(
                 A, Bs, 3, mesh, delta=1e-12, **kw)),
}


@pytest.mark.parametrize("name", list(SHARDED))
def test_cpu_sharded_topl_solvers_match_pallas_on_one_and_four_shards(name):
    # bf16 correlation: the top-l sweep's tensor-core variant on the card
    A, Bs = _planted(802, m=512)
    port, ref = SHARDED[name]
    want = ref(A, Bs, jmesh.make_mesh((1, 4), devices=jax.devices()[:4]),
               corr_dtype=jnp.bfloat16, interpret=True)
    before = dict(tfs.LAUNCHES)
    for shards in (1, 4):
        got = port(to_torch(A), to_torch(Bs),
                   make_mesh((1, shards), devices=["cpu"]), corr_dtype=BF)
        _same_solution(got, want)
    assert dict(tfs.LAUNCHES) == before
