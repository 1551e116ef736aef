"""The variant choice of the top-1 selects (cstpu_torch.ops.fused_solve.
mma_select_takes and the `mma` argument of select_argmax,
correlate_select_stream, correlate_select_masked_stream and
correlate_argmax), on the CPU.

The selects have two hand-written CUDA variants: a tensor-core loop for a
bf16 dictionary whose base and row pitch the loop's bulk loads can address,
and a CUDA-core loop for everything else. Which one runs is decided in
Python by a pure predicate, tested here over dtypes, addresses, pitches and
widths and on real views (column slices, the shards of a mesh). On CPU
tensors a wrapper runs its plain twin whatever variant is asked for, so the
same calls are held against cstpu's Pallas kernels in interpret mode
(values to 1e-5 relative: f32 sums of the same products in another order;
indices where the best score stands clear of the next by 1e-4 of it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu.ops import pallas_kernels as jpk
from cstpu.ops import stream_select as jss
from cstpu_torch.ops import corr_argmax as tca
from cstpu_torch.ops import fused_solve as tfs
from cstpu_torch.ops import stream_select as tss
from cstpu_torch.parallel import make_mesh, shard_dictionary

BF, F32 = torch.bfloat16, torch.float32
RTOL = 1e-5


@pytest.mark.parametrize("dtype,ptr,lda,m,want", [
    (BF, 0, 8192, 8192, True),            # the bench dictionary
    (BF, 256, 131072, 32768, True),       # a shard read in place
    (BF, 4096 * 2, 8192, 2048, True),     # a slice 4096 atoms in
    (BF, 16, 8, 1, True),                 # one atom, the narrowest pitch
    (BF, 0, 8232, 8232, True),            # a ragged width on a fine pitch
    (BF, 0, 1000, 1000, True),
    (F32, 0, 8192, 8192, False),          # f32 stays true f32
    (torch.float16, 0, 8192, 8192, False),
    (BF, 8, 8192, 8192, False),           # base off 16 bytes
    (BF, 2, 8192, 8184, False),           # a slice one atom in
    (BF, 0, 300, 300, False),             # pitch off 16 bytes
    (BF, 0, 1028, 1024, False),
    (BF, 0, 8184, 8192, False),           # rows would overlap
    (BF, 0, 8192, 0, False),              # nothing to select
])
def test_predicate_over_dtypes_addresses_and_pitches(dtype, ptr, lda, m, want):
    assert tfs.mma_select_takes(dtype, ptr, lda, m) is want


def _dictionary(n, m, dtype=BF, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    return torch.from_numpy(A).to(dtype)


def test_predicate_on_views():
    A = _dictionary(16, 1032)
    assert A.data_ptr() % 16 == 0
    assert tfs._pick_mma(None, A)
    assert tfs._pick_mma(None, A[:, 8:1032])       # 16 bytes in, pitch 1032
    assert tfs._pick_mma(None, A[:, 512:640])
    assert not tfs._pick_mma(None, A[:, 4:1028])   # 8 bytes in
    assert not tfs._pick_mma(None, A[:, 1:129])
    assert not tfs._pick_mma(None, A[:, :1028].contiguous())   # pitch 1028
    assert not tfs._pick_mma(None, A.float())
    # a forced variant is the caller's, whatever the predicate says
    assert tfs._pick_mma(True, A.float()) is True
    assert tfs._pick_mma(False, A) is False


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_every_shard_of_a_mesh_takes_the_tensor_core_loop(shards):
    A = _dictionary(16, 2048, F32)
    mesh = make_mesh((1, shards), devices=["cpu"])
    Ash = shard_dictionary(A, mesh)
    for shard in Ash.corr(BF)[0]:
        assert tuple(shard.shape) == (16, 2048 // shards)
        assert tfs._pick_mma(None, shard)
    for shard in Ash.corr(F32)[0]:                 # views of A: CUDA cores
        assert not tfs._pick_mma(None, shard)


@pytest.mark.parametrize("B,n,n8", [(1, 1, 8), (8, 1000, 1000), (9, 1001, 1008),
                                    (64, 1024, 1024)])
def test_rounded_scratch_pads_n_to_a_16_byte_pitch(B, n, n8):
    rb = tfs._rounded_scratch(B, n, torch.device("cpu"))
    assert tuple(rb.shape) == (B, n8) and rb.dtype == BF
    assert rb.stride(0) * rb.element_size() % 16 == 0


def test_rounding_of_the_residuals_is_to_nearest_even():
    # what the kernels' rounding pass and the twins' `.to(bfloat16)` both
    # do: halfway cases go to the even mantissa, NaN and Inf pass through
    bits = np.array([0x3F808000, 0x3F818000, 0x3F808001, 0x3F807FFF,
                     0x7F800000, 0xFF800000, 0x7FC00000], dtype=np.uint32)
    x = torch.from_numpy(bits.view(np.float32).copy())
    got = x.to(BF).float().numpy()
    want = np.array([0x3F800000, 0x3F820000, 0x3F810000, 0x3F800000,
                     0x7F800000, 0xFF800000], dtype=np.uint32)
    np.testing.assert_array_equal(got[:6].view(np.uint32), want)
    assert np.isnan(got[6])


def test_each_variant_has_its_own_launch_count():
    for name in ("select", "select_stream", "select_masked_stream",
                 "corr_argmax"):
        assert name in tfs.LAUNCHES and name + "_mma" in tfs.LAUNCHES


def _clear(scores):
    top = -np.sort(-scores, axis=1)[:, :2]
    return top[:, 0] - top[:, 1] > 1e-4 * top[:, 0]


@pytest.mark.parametrize("mma", [None, True, False])
def test_cpu_wrappers_run_the_twin_whatever_the_variant(mma):
    n, m, B = 64, 1024, 8
    A = _dictionary(n, m, seed=1)
    R = torch.from_numpy(
        np.random.default_rng(2).standard_normal((B, n)).astype(np.float32))
    before = dict(tfs.LAUNCHES)
    got = tfs.select_argmax(R, A, signed=True, mma=mma)
    want = tfs._select_ref(R, A, BF, signed=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    amask = torch.zeros((B, m), dtype=torch.uint8)
    amask[:, ::3] = 1
    got = tfs.select_argmax(R, A, amask=amask, eta=0.5, mma=mma)
    want = tfs._select_ref(R, A, BF, False, amask, 0.5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dict(tfs.LAUNCHES) == before            # no kernel on the CPU


@pytest.mark.parametrize("mma", [None, True, False])
def test_stream_wrappers_match_pallas_whatever_the_variant(mma):
    n, m, B = 64, 1152, 8
    tA = _dictionary(n, m, seed=3)
    jA = jnp.asarray(tA.float().numpy()).astype(jnp.bfloat16)
    R = np.random.default_rng(4).standard_normal((B, n)).astype(np.float32)
    scores = np.abs(torch.from_numpy(R).to(BF).float().numpy()
                    @ tA.float().numpy())
    clear = _clear(scores)
    assert clear.sum() >= 6
    before = dict(tfs.LAUNCHES)
    tv, ti = tss.correlate_select_stream(tA, torch.from_numpy(R), mma=mma)
    jv, ji = jss.correlate_select_stream(jA, jnp.asarray(R), interpret=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ji)[clear])
    M = np.zeros((B, m), np.float32)
    M[np.arange(B), np.argmax(scores, axis=1)] = -np.inf
    tv, ti = tss.correlate_select_masked_stream(
        tA, torch.from_numpy(R), torch.from_numpy(M), mma=mma)
    jv, ji = jss.correlate_select_masked_stream(
        jA, jnp.asarray(R), jnp.asarray(M), interpret=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    cm = _clear(scores + M)
    np.testing.assert_array_equal(ti.numpy()[cm], np.asarray(ji)[cm])
    ti, tv = tca.correlate_argmax(tA, torch.from_numpy(R.T.copy()), mma=mma)
    ji, jv = jpk.correlate_argmax(jA, jnp.asarray(R.T), interpret=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ji)[clear])
    assert dict(tfs.LAUNCHES) == before
