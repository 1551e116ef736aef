"""The tensor-core variants of the rescaled selects (csrc/fr_select.cu for
batched FR, SRR, RMP and FoBa; csrc/fr_step_select.cu, K8, for the sharded
solvers) as far as the CPU can see them.

The kernels, their launch plan and their stacked operand exist only on the
card, where tests/test_torch_kernels.py holds both variants to the plain
twins. What decides the variant is Python, and is tested here: the
predicate (`fused_solve.mma_select_takes`, shared with the top-1 selects)
over dtypes, addresses, pitches and real shard views, and each variant's
own launch key.

On CPU tensors a wrapper runs its plain twin whatever variant `mma` asks
for, and launches nothing. The twin of the rescaled select with P in
{0, 1, 2, 16} pending terms is held against a float64 numpy reference, and
the whole FR and SRR solves through the wrappers against cstpu's Pallas
kernels in interpret mode at the oracle problem size (tests/conftest.py's
planted problem, n=32, at m=128, the Pallas kernels' atom multiple), where
the select sees P = 1 pending term (FR) and P = k, then l + 1 (SRR).
Tolerances: values 1e-5 relative (f32 sums of the same products in another
order); indices where the top score stands clear of the next by 1e-4 of it;
solves: supports equal, coefficients and residuals to 1e-4 absolute (what
cstpu holds its kernels to against its XLA paths).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu.ops import fused_solve as jfs
from cstpu.ops import fused_twostage as jft
from cstpu_torch.ops import fused_solve as tfs
from cstpu_torch.ops import fused_twostage as tft
from cstpu_torch.ops import stream_select as tss
from cstpu_torch.parallel import make_mesh, shard_dictionary
from cstpu_torch.utils.interop import solution_to_numpy, to_torch

BF, F32 = torch.bfloat16, torch.float32
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": F32, "bf16": BF}
RTOL = 1e-5
GAP = 1e-4
ATOL = 1e-4


# --------------------------------------------------------------------------
# The variant predicate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,ptr,lda,m,want", [
    (BF, 0, 8192, 8192, True),             # 3a, 3b, 3d: the batched selects
    (BF, 0, 8232, 8232, True),             # a ragged width, pitch 16 bytes
    (BF, 2 * 32768, 131072, 32768, True),  # K8: the second of four shards
    (BF, 2 * 3 * 32768, 131072, 32768, True),
    (BF, 0, 131072, 131072, True),         # K8 on one shard
    (F32, 0, 8192, 8192, False),           # f32 correlation stays true f32
    (F32, 4 * 32768, 131072, 32768, False),
    (BF, 0, 1001, 1001, False),            # a contiguous odd width
    (BF, 2 * 100, 131072, 32768, False),   # a shard 100 atoms in
    (BF, 0, 32768 + 4, 32768, False),      # pitch off 16 bytes
])
def test_predicate_over_dtypes_addresses_and_pitches(dtype, ptr, lda, m,
                                                     want):
    assert tfs.mma_select_takes(dtype, ptr, lda, m) is want


def _dictionary(n, m, dtype=F32, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    return torch.from_numpy(A).to(dtype)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_every_shard_of_the_fr_solvers_takes_the_tensor_core_loop(shards):
    # the shards K8 sweeps: the cdt copy, cast shard by shard, and column
    # views of a bf16 dictionary read in place
    A = _dictionary(16, 4096)
    mesh = make_mesh((1, shards), devices=["cpu"])
    for shard in shard_dictionary(A, mesh).corr(BF)[0]:
        assert tuple(shard.shape) == (16, 4096 // shards)
        assert tfs._pick_mma(None, shard)
    for shard in shard_dictionary(A.to(BF), mesh).corr(BF)[0]:
        assert shard.stride(0) == 4096 and tfs._pick_mma(None, shard)
    for shard in shard_dictionary(A, mesh).corr(F32)[0]:
        assert not tfs._pick_mma(None, shard)
    # the batched selects' contiguous copy, and the variant a caller forces
    Ac = A.to(BF).contiguous()
    assert tfs._pick_mma(None, Ac) and not tfs._pick_mma(None, Ac[:, 3:])
    assert tfs._pick_mma(False, Ac) is False
    assert tfs._pick_mma(True, Ac.float()) is True


def test_each_variant_has_its_own_launch_count():
    for name in ("fr_select", "fr_step_select"):
        assert name in tfs.LAUNCHES and name + "_mma" in tfs.LAUNCHES


# --------------------------------------------------------------------------
# The CPU route: the twins, whatever the variant, against cstpu
# --------------------------------------------------------------------------

def _rescaled_inputs(P, seed, B=8, n=32, m=300):
    """A bf16 dictionary with a ragged last tile, its column norms,
    residuals, P pending terms, one active atom per row and resc = cn2."""
    rng = np.random.default_rng(seed)
    Ac = _dictionary(n, m, seed=P).to(BF)
    cn2 = torch.sum(Ac.float() ** 2, dim=0)
    r = torch.from_numpy(rng.standard_normal((B, n)).astype(np.float32))
    U = torch.from_numpy((0.3 * rng.standard_normal((P, B, n))
                          / np.sqrt(n)).astype(np.float32))
    W = torch.from_numpy((rng.random((P, B)) - 0.5).astype(np.float32))
    amask = torch.zeros((B, m), dtype=torch.uint8)
    amask[np.arange(B), 11 * np.arange(B)] = 1
    return Ac, cn2, r, U, W, amask, cn2.repeat(B, 1)


def test_cpu_wrappers_run_the_twin_when_the_tensor_core_loop_is_asked():
    # mma=True picks a variant of the kernel; CPU tensors have none, so the
    # wrappers run their twins, bit for bit, and launch nothing
    Ac, cn2, r, U, W, amask, resc = _rescaled_inputs(2, 39)
    before = dict(tfs.LAUNCHES)
    rk, rp = resc.clone(), resc.clone()
    got = tfs.rescaled_select(Ac, cn2, r, U, W, 1.0, amask, rk, mma=True)
    want = tfs._rescaled_select_ref(Ac, cn2, r, U, W, 1.0, amask, rp, BF)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(rk, rp)
    A = torch.cat([Ac, Ac[:, :84]], dim=1)            # 384 atoms, 3 tiles
    il = torch.full((8, 2), -1, dtype=torch.int32)
    il[:2, 0], il[2:4, 1] = 5, 11
    c2 = torch.sum(A.float() ** 2, dim=0)
    rk, rp = c2.repeat(8, 1), c2.repeat(8, 1)
    got = tss.fr_step_select(A, r, U[0], il, c2, rk, 1e-6, V=U[1], mma=True)
    want = tss.fr_step_select_ref(A, r, U[0], il, c2, rp, 1e-6, V=U[1])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dict(tfs.LAUNCHES) == before


def _select_f64(Ac, cn2, r, U, W, wsign, amask, resc, rtol):
    """The rescaled select in float64 from the bf16-rounded operands:
    (per-tile max d2, its lowest index, the updated resc)."""
    A = Ac.double().numpy()
    rd = lambda x: x.to(BF).double().numpy()
    x = resc.double().numpy().copy()
    for p in range(U.shape[0]):
        z = rd(U[p]) @ A
        x += wsign * W[p].double().numpy()[:, None] * z * z
    q = rd(r) @ A
    d2 = np.where(x > rtol * cn2.double().numpy(), q * q / x, -np.inf)
    d2 = np.where(amask.numpy().astype(bool), 0.0, d2)
    B, m = d2.shape
    T = -(-m // tfs.TILE)
    s = np.pad(d2, ((0, 0), (0, T * tfs.TILE - m)),
               constant_values=-np.inf).reshape(B, T, tfs.TILE)
    return s.max(axis=2), s.argmax(axis=2) + tfs.TILE * np.arange(T), x, d2


@pytest.mark.parametrize("P", [0, 1, 2, 16])
def test_cpu_rescaled_select_matches_float64(P):
    Ac, cn2, r, U, W, amask, resc = _rescaled_inputs(P, 40 + P)
    B, m = resc.shape
    rtol = tfs._degeneracy_rtol(Ac.shape[0])
    wv, wi, wx, d2 = _select_f64(Ac, cn2, r, U, W, 1.0, amask, resc, rtol)
    before = dict(tfs.LAUNCHES)
    pv, pi = tfs.rescaled_select(Ac, cn2, r, U, W, 1.0, amask, resc)
    assert dict(tfs.LAUNCHES) == before           # no kernel on the CPU
    np.testing.assert_allclose(resc.numpy(), wx, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(pv.numpy(), wv, rtol=RTOL)
    top = -np.sort(-np.pad(d2, ((0, 0), (0, 84)), constant_values=-np.inf)
                   .reshape(B, 3, tfs.TILE), axis=2)
    clear = top[..., 0] - top[..., 1] > GAP * top[..., 0]
    np.testing.assert_array_equal(pi.numpy()[clear], wi[clear])
    assert clear.sum() >= 18


def _planted(seed, n=32, m=128, k=3):
    """conftest's planted problem at the Pallas kernels' atom multiple and
    eight measurements of it: (A, Bs (8, n)), numpy."""
    from conftest import planted_problem

    A, _, b, y = planted_problem(seed, n=n, m=m, k=k, noise=5e-3,
                                 dtype=jnp.float32)
    b, y = np.asarray(b), np.asarray(y)
    Bs = np.stack([y, b, -y, 2.0 * b, b + 0.5 * y, -b, 0.5 * y, y - 0.25 * b])
    return np.asarray(A), Bs.astype(np.float32)


def _same_solution(tout, jout):
    t, j = solution_to_numpy(tout[0]), solution_to_numpy(jout[0])
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_cpu_fr_solve_through_the_wrapper_matches_pallas(cdt):
    A, Bs = _planted(610)
    k = 3                                         # every pick stands clear
    jout = jfs.fr_fused_solve(A, Bs, k, corr_dtype=JDT[cdt], interpret=True)
    before = dict(tfs.LAUNCHES)
    tout = tfs._fr(to_torch(A), to_torch(Bs), k, 0.0, 0.0, TDT[cdt],
                   tfs.fr_select, tfs.fr_append, False)
    assert dict(tfs.LAUNCHES) == before
    _same_solution(tout, jout)


def test_cpu_srr_solve_through_the_wrapper_matches_pallas():
    # the first select takes the k init terms, the later ones l + 1
    A, Bs = _planted(700)
    k, l = 3, 2
    jout = jft.srr_fused_solve(A, Bs, k, l=l, maxiter=4, interpret=True)
    before = dict(tfs.LAUNCHES)
    tout = tft._srr(to_torch(A), to_torch(Bs), k, 1e-12, 4, l, BF,
                    (tft.select_topl, tft.engine_init,
                     tft.rescaled_select, tft.srr_append,
                     tft.engine_delete), False)
    assert dict(tfs.LAUNCHES) == before
    _same_solution(tout, jout)
