"""cstpu_torch's column-sharded solvers (cstpu_torch.parallel) on the CPU
against cstpu's, on `sparse_data(n=64, m=1024)` as cstpu's own sharded
tests use it, converted through numpy. cstpu runs on its eight-device CPU
mesh with its Pallas selects in interpret mode; the port runs an eight-shard
mesh on the CPU, where its selects are their plain twins. corr_dtype is f32
on both sides.

Tolerances: supports equal; values to rtol 1e-4 (atol 1e-6), the tolerance
cstpu holds its sharded solvers to against its single-device ones. OMPR's
and SP's iteration counts are not visible in a solution and not compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu import perturb, sparse_data
from cstpu.parallel import mesh as jmesh
from cstpu.parallel import sharded as jsh
from cstpu_torch.parallel import (
    make_mesh, shard_batch, shard_dictionary, sharded as tsh)
from cstpu_torch.utils.interop import (
    solution_from_cstpu, solution_to_numpy, to_torch)

DELTA = 1e-2
F32 = torch.float32
KW = dict(corr_dtype=F32)
JKW = dict(corr_dtype=jnp.float32, interpret=True)


def _mesh(s=8, b=1):
    return make_mesh((b, s), devices=["cpu"])


@pytest.fixture(scope="module")
def jax_mesh():
    assert jax.device_count() >= 8
    return jmesh.make_mesh((1, 8))


def _problem(seed, k=5, dtype=jnp.float32, rows=4):
    """(A, Bs) as cstpu arrays: b and a perturbed copy, `rows` times."""
    kd, kn = jax.random.split(jax.random.PRNGKey(seed))
    A, x, b = sparse_data(kd, n=64, m=1024, k=k, dtype=dtype)
    return A, jnp.stack([b, perturb(kn, b, DELTA / 2)] * rows)


def _torch(*arrays):
    return tuple(to_torch(a) for a in arrays)


def _same_solution(got, want, rtol=1e-4, atol=1e-6):
    """Supports equal, values close; `want` may be cstpu's solution."""
    if not isinstance(want.idx, torch.Tensor):
        want = solution_from_cstpu(want)
    g, w = solution_to_numpy(got), solution_to_numpy(want)
    np.testing.assert_array_equal(g["idx"], w["idx"])
    np.testing.assert_array_equal(g["mask"], w["mask"])
    np.testing.assert_allclose(g["val"], w["val"], rtol=rtol, atol=atol)
    assert g["m"] == w["m"]


# the five fused bodies: name -> (port call, cstpu call) on (A, Bs, mesh)
FUSED = {
    "omp": (lambda A, Bs, mesh, **kw: tsh.omp_sharded_fused(
                A, Bs, 5, mesh, **kw),
            lambda A, Bs, mesh, **kw: jsh.omp_sharded_fused(
                A, Bs, 5, mesh, **kw)),
    "gomp": (lambda A, Bs, mesh, **kw: tsh.gomp_sharded_fused(
                 A, Bs, 2, 7, mesh, **kw),       # l=2, k=7: remainder step
             lambda A, Bs, mesh, **kw: jsh.gomp_sharded_fused(
                 A, Bs, 2, 7, mesh, **kw)),
    "sp": (lambda A, Bs, mesh, **kw: tsh.sp_sharded_fused(
               A, Bs, 5, mesh, **kw),
           lambda A, Bs, mesh, **kw: jsh.sp_sharded_fused(
               A, Bs, 5, mesh, **kw)),
    "ompr": (lambda A, Bs, mesh, **kw: tsh.ompr_sharded_fused(
                 A, Bs, 5, mesh, delta=1e-12, **kw),
             lambda A, Bs, mesh, **kw: jsh.ompr_sharded_fused(
                 A, Bs, 5, mesh, delta=1e-12, **kw)),
}
SEEDS = {"omp": 73, "gomp": 74, "sp": 75, "ompr": 78, "mp": 77}


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_matches_cstpu_on_eight_shards(name, jax_mesh):
    port, ref = FUSED[name]
    A, Bs = _problem(SEEDS[name], k=6 if name == "gomp" else 5)
    want = ref(A, Bs, jax_mesh, **JKW)
    got = port(*_torch(A, Bs), _mesh(8), **KW)
    _same_solution(got, want)
    assert got.val.dtype == F32 and got.idx.dtype == torch.int32


def test_mp_matches_cstpu_on_eight_shards(jax_mesh):
    A, Bs = _problem(SEEDS["mp"])
    want = jsh.mp_sharded_fused(A, Bs, 40, jax_mesh, **JKW)
    got = tsh.mp_sharded_fused(*_torch(A, Bs), 40, _mesh(8), **KW)
    assert tuple(got.shape) == (8, 1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


def test_omp_sharded_matches_cstpu(jax_mesh):
    # the plain reference, in f64: one measurement, a batch, a (2, 4) mesh
    A, Bs = _problem(70, dtype=jnp.float64)
    tA, tB = _torch(A, Bs)
    _same_solution(tsh.omp_sharded(tA, tB, 5, _mesh(8)),
                   jsh.omp_sharded(A, Bs, 5, jax_mesh), rtol=1e-10)
    one = tsh.omp_sharded(tA, tB[1], 5, _mesh(8))
    assert one.idx.shape == (5,)
    _same_solution(one, jsh.omp_sharded(A, Bs[1], 5, jax_mesh), rtol=1e-10)
    _same_solution(tsh.omp_sharded(tA, tB, 5, _mesh(4, 2)),
                   jsh.omp_sharded(A, Bs, 5, jmesh.make_mesh((2, 4))),
                   rtol=1e-10)
    # the fused solver agrees with it
    _same_solution(tsh.omp_sharded_fused(tA, tB, 5, _mesh(8), **KW),
                   tsh.omp_sharded(tA, tB, 5, _mesh(8)), rtol=1e-5)


@pytest.mark.parametrize("name", list(FUSED) + ["mp"])
def test_selection_is_invariant_under_the_shard_count(name):
    A, Bs = _torch(*_problem(SEEDS[name] + 100))
    if name == "mp":
        outs = [tsh.mp_sharded_fused(A, Bs, 40, _mesh(s), **KW)
                for s in (1, 2, 4, 8)]
        for x in outs[1:]:
            assert torch.equal(x != 0, outs[0] != 0)
            np.testing.assert_allclose(x.numpy(), outs[0].numpy(), rtol=1e-5,
                                       atol=1e-7)
        return
    outs = [FUSED[name][0](A, Bs, _mesh(s), **KW) for s in (1, 2, 4, 8)]
    for sol in outs[1:]:
        _same_solution(sol, outs[0], rtol=1e-5)


def test_cross_shard_ties_go_to_the_lowest_global_index():
    # the planted atom is repeated in three shards: every shard count picks
    # the lowest copy, in both collective forms
    A, Bs = _torch(*_problem(140, k=1))
    first = int(torch.argmax(torch.abs(Bs[0] @ A)))
    lo = first % 128
    for at in (lo, lo + 384, lo + 896):
        A[:, at] = A[:, first]
    for s in (1, 2, 4, 8):
        for fuse in (True, False):
            sol = tsh.omp_sharded_fused(A, Bs, 1, _mesh(s),
                                        fuse_collectives=fuse, **KW)
            assert sol.idx[:, 0].tolist() == [lo] * 8, (s, fuse)
            x = tsh.mp_sharded_fused(A, Bs, 1, _mesh(s),
                                     fuse_collectives=fuse, **KW)
            assert torch.nonzero(x)[:, 1].tolist() == [lo] * 8, (s, fuse)
            # top-2 of three equal scores: the two lowest copies, of which
            # the second is rejected as degenerate
            sol = tsh.gomp_sharded_fused(A, Bs, 2, 2, _mesh(s),
                                         fuse_collectives=fuse, **KW)
            assert sol.idx.tolist() == [[lo, 1024]] * 8, (s, fuse)


def test_dp_tp_mesh_and_presharded_inputs(jax_mesh):
    # (2, 4) mesh with B=16, from tensors and from shard_dictionary /
    # shard_batch results (no shard is cut twice)
    A, Bs = _problem(75, rows=8)
    tA, tB = _torch(A, Bs)
    mesh2 = _mesh(4, 2)
    want = jsh.omp_sharded_fused(A, Bs, 5, jmesh.make_mesh((2, 4)), **JKW)
    got = tsh.omp_sharded_fused(tA, tB, 5, mesh2, **KW)
    _same_solution(got, want, rtol=1e-5)
    assert got.idx.shape == (16, 5)
    Ash = shard_dictionary(tA, mesh2)
    assert Ash.shards[0][1].data_ptr() == tA[:, 256:].data_ptr()   # a view
    assert Ash.shards[1][1] is Ash.shards[0][1]       # shared across rows
    again = tsh.omp_sharded_fused(Ash, shard_batch(tB, mesh2), 5, mesh2, **KW)
    _same_solution(again, got, rtol=0, atol=0)
    assert Ash.corr(F32)[0][0] is Ash.shards[0][0]    # same dtype: no copy
    assert Ash.corr(torch.bfloat16) is Ash.corr(torch.bfloat16)   # kept
    with pytest.raises(ValueError, match="another mesh"):
        tsh.omp_sharded_fused(Ash, tB, 5, _mesh(8), **KW)


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_fused_collectives_identity_all_bodies(dtype_name):
    # both collective forms make the same selections in every body; in f64
    # the shipped column keeps the dictionary's precision, so the values
    # agree to f64 resolution
    A, Bs = _torch(*_problem(93, dtype=jnp.dtype(dtype_name)))
    assert A.dtype == getattr(torch, dtype_name)
    rtol = 1e-6 if dtype_name == "float32" else 1e-13
    mesh = _mesh(8)
    for name, (port, _) in FUSED.items():
        fused = port(A, Bs, mesh, fuse_collectives=True, **KW)
        triple = port(A, Bs, mesh, fuse_collectives=False, **KW)
        assert fused.val.dtype == A.dtype
        assert torch.equal(fused.idx, triple.idx), name
        assert torch.equal(fused.mask, triple.mask), name
        np.testing.assert_allclose(fused.val.numpy(), triple.val.numpy(),
                                   rtol=rtol, atol=1e-30, err_msg=name)
    xf = tsh.mp_sharded_fused(A, Bs, 10, mesh, fuse_collectives=True, **KW)
    xt = tsh.mp_sharded_fused(A, Bs, 10, mesh, fuse_collectives=False, **KW)
    np.testing.assert_allclose(xf.numpy(), xt.numpy(), rtol=rtol, atol=1e-30)


def test_fused_collectives_gate():
    # m >= 2^24 cannot carry the index exactly in an f32 payload: the
    # explicit opt-in is rejected on (shape, dtype) alone; a meta tensor
    # stands for the 512 MB dictionary
    A = torch.empty((8, 1 << 24), dtype=F32, device="meta")
    Bs = torch.zeros((8, 8))
    for entry in (tsh.omp_sharded_fused, tsh.mp_sharded_fused,
                  tsh.sp_sharded_fused, tsh.ompr_sharded_fused):
        with pytest.raises(ValueError, match="fuse_collectives needs m < 2"):
            entry(A, Bs, 2, _mesh(8), fuse_collectives=True)
    with pytest.raises(ValueError, match=r"2\^24 for float32 payloads"):
        tsh.gomp_sharded_fused(A, Bs, 2, 4, _mesh(8), fuse_collectives=True)
    assert tsh._resolve_fuse(None, 1 << 24, torch.float64, "t") is True
    assert tsh._resolve_fuse(None, 1 << 24, F32, "t") is False
    assert tsh._resolve_fuse(None, (1 << 24) - 1, F32, "t") is True
    assert tsh._resolve_fuse(False, 1 << 24, F32, "t") is False
    for dtype, jdt in ((F32, jnp.float32), (torch.float64, jnp.float64),
                       (torch.bfloat16, jnp.bfloat16)):
        assert (tsh._payload_exact_limit(dtype)
                == jsh._payload_exact_limit(jdt))


def test_gomp_converged_rows_stop_acquiring(jax_mesh):
    # the batch loop runs until ALL rows are done; a row that converged
    # early must not go on acquiring (cstpu's discriminator: a noisy
    # 2-sparse row beside 6-sparse ones)
    kd, kn = jax.random.split(jax.random.PRNGKey(40))
    A, x, b = sparse_data(kd, n=64, m=1024, k=2, dtype=jnp.float32)
    y0 = perturb(kn, b, 5e-3)
    k2 = jax.random.permutation(jax.random.PRNGKey(41), 1024)[:6]
    b2 = A @ jnp.zeros((1024,), jnp.float32).at[k2].set(1.0)
    y1 = perturb(jax.random.PRNGKey(42), b2, 5e-3)
    Bs = jnp.stack([y0] * 4 + [y1] * 4)
    want = jsh.gomp_sharded_fused(A, Bs, 2, 8, jax_mesh, max_residual=1e-2,
                                  **JKW)
    got = tsh.gomp_sharded_fused(*_torch(A, Bs), 2, 8, _mesh(8),
                                 max_residual=1e-2, **KW)
    _same_solution(got, want)
    assert got.mask.sum(dim=1).tolist() == [2] * 4 + [6] * 4


def test_ompr_mask_tracks_swaps_on_the_owning_shard():
    # the masked select is handed the shards' exclusion masks: at every
    # iteration each row excludes exactly its k active atoms (an appended
    # atom goes to -inf and the deleted one back to 0, on the owning shard
    # only), the masks move when atoms are swapped, and a row that stopped
    # early excludes its final support to the end
    from cstpu import ompr

    # eight atoms with amplitudes in [0.5, 2]: the oblivious start misses
    # some of them and OMPR swaps them in over several iterations
    rng = np.random.default_rng(0)
    k = 8
    A = rng.standard_normal((64, 1024)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    tA = torch.from_numpy(A)
    sup = [np.sort(rng.permutation(1024)[:k]) for _ in range(8)]
    tB = torch.stack([
        (tA[:, s_] * torch.from_numpy(
            rng.uniform(0.5, 2, k).astype(np.float32))).sum(1) for s_ in sup])
    seen = []

    def masked(Ac, R, M):
        seen.append(M.clone())
        return tsh._PLAIN.masked(Ac, R, M)

    s = 4
    got, iters = tsh.ompr_sharded_fused(
        tA, tB, k, _mesh(s), delta=1e-12, return_iters=True,
        _select=tsh._PLAIN._replace(masked=masked), **KW)
    assert iters[0] >= 4 and len(seen) == s * iters[0]
    calls = [torch.cat(seen[t * s:(t + 1) * s], dim=1)       # (B, m) per call
             for t in range(iters[0])]
    for M in calls:
        assert set(M.unique().tolist()) == {0.0, -np.inf}
        assert (M == -np.inf).sum(dim=1).tolist() == [k] * 8
    changed = [not torch.equal(calls[t], calls[t + 1])
               for t in range(len(calls) - 1)]
    assert sum(changed) >= 3                                  # swaps ran
    sol = solution_to_numpy(got)
    for i in range(8):
        idx = sol["idx"][i][sol["mask"][i]]
        assert idx.tolist() == sup[i].tolist()
        if torch.equal(calls[-1][i], calls[-2][i]):      # stopped before
            assert (np.flatnonzero(calls[-1][i].numpy() == -np.inf).tolist()
                    == idx.tolist())
    for i in range(2):
        ref = ompr(jnp.asarray(A), jnp.asarray(tB[i].numpy()), k, 1e-12)
        assert sup[i].tolist() == list(np.asarray(ref.nzind))


def test_sp_rows_past_done_keep_their_state():
    # rows that stop at different iterations: each row's solution in the
    # mixed batch is what it is in a batch of its own copies (where every
    # row stops together). Random measurements keep SP moving between
    # supports, so a stopped row that went on would change
    A, _ = _torch(*_problem(175))
    rng = np.random.default_rng(0)
    mixed = torch.from_numpy(rng.standard_normal((8, 64))).float()
    sol, iters = tsh.sp_sharded_fused(A, mixed, 5, _mesh(4), maxiter=12,
                                      return_iters=True, **KW)
    stops = []
    for i in range(8):
        alone, it = tsh.sp_sharded_fused(A, mixed[i].repeat(8, 1), 5,
                                         _mesh(4), maxiter=12,
                                         return_iters=True, **KW)
        stops.append(it[0])
        assert torch.equal(sol.idx[i], alone.idx[0]), i
        np.testing.assert_allclose(sol.val[i].numpy(), alone.val[0].numpy(),
                                   rtol=1e-5, atol=1e-7)
    assert iters[0] == max(stops) and min(stops) < max(stops)


def test_prune_rebuilds_from_the_cached_columns():
    from cstpu_torch.ops import active_set as tas

    rng = np.random.default_rng(1)
    n, m, k, B = 24, 40, 3, 4
    A = torch.from_numpy(rng.standard_normal((n, m)))
    A /= A.norm(dim=0)
    Bs = torch.from_numpy(rng.standard_normal((B, n)))
    st = tas.empty_batched(B, n, 2 * k, m, torch.float64)
    picks = np.stack([rng.permutation(m)[:5] for _ in range(B)], axis=1)
    for atoms in picks:                     # five of the six slots in use
        atoms = torch.from_numpy(atoms).to(torch.int32)
        st = tas.append_col_gated_batched(A[:, atoms.long()].T, Bs, st, atoms,
                                          torch.ones(B, dtype=torch.bool))
    st = tas.refit_batched(st)
    out = tsh._prune_to_k(st, Bs, k, m)
    for b in range(B):
        coef = st.coef[b].abs()
        keep = sorted(torch.argsort(coef, descending=True)[:k].tolist())
        want_idx = sorted(st.idx[b][keep].tolist())
        assert sorted(out.idx[b][out.mask[b]].tolist()) == want_idx
        assert int(out.k[b]) == k and not out.mask[b, k:].any()
        # the refit on the kept atoms is the least-squares solution
        cols = A[:, out.idx[b][:k].long()]
        ls = torch.linalg.lstsq(cols, Bs[b][:, None]).solution[:, 0]
        np.testing.assert_allclose(out.coef[b, :k].numpy(), ls.numpy(),
                                   atol=1e-10)


def test_winning_column_comes_from_the_full_precision_shard():
    # with a bf16 correlation copy the appended column, and so the
    # coefficients, are those of the f32 dictionary: they reproduce the
    # planted values far below bf16's resolution
    A, Bs = _torch(*_problem(173))
    A, Bs = A.double(), Bs.double()
    Bs[:] = (A[:, [3, 500, 900]] * torch.tensor([1.0, -2.0, 0.5])).sum(1)
    for fuse in (True, False):
        sol = tsh.omp_sharded_fused(A, Bs, 3, _mesh(4),
                                    corr_dtype=torch.bfloat16,
                                    fuse_collectives=fuse)
        assert sol.idx[0].tolist() == [3, 500, 900]
        np.testing.assert_allclose(sol.val[0].numpy(), [1.0, -2.0, 0.5],
                                   atol=1e-12)


def test_shape_errors():
    A, Bs = _torch(*_problem(73))
    with pytest.raises(ValueError, match="m = 1024 not divisible by atom "
                                         "shards 3"):
        tsh.omp_sharded_fused(A, Bs, 5, _mesh(3), **KW)
    with pytest.raises(ValueError, match="not divisible by atom shards"):
        tsh.omp_sharded(A, Bs, 5, _mesh(3))
    # per-shard width 64 is no multiple of 128: cstpu's wording
    with pytest.raises(ValueError, match=r"mp_sharded_fused: unsupported "
                       r"shard shape \(n=64, per-shard atom width 64, B=8 "
                       r"over 1 batch shards, float32\)"):
        tsh.mp_sharded_fused(A, Bs, 5, _mesh(16), **KW)
    with pytest.raises(ValueError, match="B=8 over 3 batch shards"):
        tsh.gomp_sharded_fused(A, Bs, 2, 4, _mesh(2, 3), **KW)
    with pytest.raises(ValueError, match="2k = 80 > 64"):
        tsh.sp_sharded_fused(A, Bs, 40, _mesh(8), **KW)
    with pytest.raises(ValueError, match="must be batched"):
        tsh.omp_sharded_fused(A, Bs[0], 5, _mesh(8), **KW)
    with pytest.raises(ValueError, match="corr_dtype must be"):
        tsh.omp_sharded_fused(A, Bs, 5, _mesh(8), corr_dtype=torch.float64)
    # the top-k init is no longer capped at 32 picks: k = 33 solves, with
    # k + 1 slots
    assert tsh.ompr_sharded_fused(A, Bs, 33, _mesh(8), maxiter=1,
                                  **KW).idx.shape == (8, 34)
    with pytest.raises(ValueError, match="n = 64 not divisible by shards 3"):
        tsh.omp_sharded_rows(A, Bs[0], 5, _mesh(3))
    with pytest.raises(ValueError, match="rmp/foba_sharded_fused: "
                                         "unsupported shard shape"):
        tsh.rmp_sharded_fused(A, Bs, DELTA, _mesh(16), **KW)
    # what the TPU's tiling needed and the port does not: B and n that are
    # no multiples of 8
    sol = tsh.omp_sharded_fused(A[:60], Bs[:3, :60], 2, _mesh(8), **KW)
    assert sol.idx.shape == (3, 2)


def test_mesh_helpers():
    mesh = _mesh(4, 2)
    assert mesh.shape == {"batch": 2, "atoms": 4}
    assert mesh.home(1) == torch.device("cpu")
    xs = [torch.tensor([1.0, 5.0]), torch.tensor([3.0, 2.0])]
    home = torch.device("cpu")
    assert mesh.pmax(xs, home).tolist() == [3.0, 5.0]
    assert mesh.pmin(xs, home).tolist() == [1.0, 2.0]
    assert mesh.psum(xs, home).tolist() == [4.0, 7.0]
    assert mesh.all_gather(xs, home).shape == (2, 2)
    with pytest.raises(ValueError, match="must be positive"):
        make_mesh((0, 2), devices=["cpu"])
    with pytest.raises(ValueError, match="not divisible by batch shards"):
        shard_batch(torch.zeros((5, 4)), mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((1, 2))
    # numpy inputs go where the mesh lies
    A, Bs = _problem(73)
    sol = tsh.omp_sharded_fused(np.array(A), np.array(Bs), 5, _mesh(8),
                                **KW)
    assert sol.idx.device.type == "cpu"


def test_package_exports():
    import cstpu_torch

    for name in ("make_mesh", "shard_dictionary", "shard_batch",
                 "omp_sharded", "omp_sharded_fused", "mp_sharded_fused",
                 "gomp_sharded_fused", "ompr_sharded_fused",
                 "sp_sharded_fused", "correlate_argmax", "fr_sharded_fused",
                 "srr_sharded_fused", "rmp_sharded_fused",
                 "foba_sharded_fused", "omp_sharded_rows"):
        assert name in cstpu_torch.__all__ and hasattr(cstpu_torch, name)
    from cstpu_torch import parallel
    import cstpu.parallel as jparallel

    ported = [n for n in jparallel.__all__ if "sharded" in n
              and not n.startswith(("bp", "ista", "fista", "fsbl", "rmps"))]
    assert set(ported) <= set(parallel.__all__)


# --------------------------------------------------------------------------
# The forward-regression family on fr_step_select: FR, SRR, RMP, FoBa
# --------------------------------------------------------------------------

# name -> (port call, cstpu call) on (A, Bs, mesh); RMP and FoBa return
# (solution, capped)
FRFAM = {
    "fr": (lambda A, Bs, mesh, **kw: tsh.fr_sharded_fused(
               A, Bs, 5, mesh, **kw),
           lambda A, Bs, mesh, **kw: jsh.fr_sharded_fused(
               A, Bs, 5, mesh, **kw)),
    "srr": (lambda A, Bs, mesh, **kw: tsh.srr_sharded_fused(
                A, Bs, 5, mesh, **kw),
            lambda A, Bs, mesh, **kw: jsh.srr_sharded_fused(
                A, Bs, 5, mesh, **kw)),
    "rmp": (lambda A, Bs, mesh, **kw: tsh.rmp_sharded_fused(
                A, Bs, DELTA, mesh, kmax=16, **kw),
            lambda A, Bs, mesh, **kw: jsh.rmp_sharded_fused(
                A, Bs, DELTA, mesh, kmax=16, **kw)),
    "foba": (lambda A, Bs, mesh, **kw: tsh.foba_sharded_fused(
                 A, Bs, DELTA, mesh, kmax=16, **kw),
             lambda A, Bs, mesh, **kw: jsh.foba_sharded_fused(
                 A, Bs, DELTA, mesh, kmax=16, **kw)),
}
FRSEEDS = {"fr": 76, "srr": 79, "rmp": 83, "foba": 83}


def _sol_capped(out):
    """(solution, capped or None) of a family member's result."""
    return out if isinstance(out, tuple) else (out, None)


def _same_family(got, want, rtol=1e-4):
    (gs, gc), (ws, wc) = _sol_capped(got), _sol_capped(want)
    _same_solution(gs, ws, rtol=rtol)
    if gc is not None:
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def _correlated(seed, k=6, decay=0.5, noise=DELTA):
    """cstpu's correlated dictionary at n=64, m=1024, eight noisy rows:
    coherent atoms make the forward stages take wrong atoms first, which
    the backward stages then delete."""
    from cstpu import correlated_data

    keys = jax.random.split(jax.random.PRNGKey(seed), 9)
    A, x, b = correlated_data(keys[0], n=64, m=1024, k=k, dtype=jnp.float32,
                              decay=decay)
    return A, jnp.stack([perturb(kk, b, noise) for kk in keys[1:]])


@pytest.mark.parametrize("name", list(FRFAM))
def test_fr_family_matches_cstpu_on_eight_shards(name, jax_mesh):
    port, ref = FRFAM[name]
    A, Bs = _problem(FRSEEDS[name])
    got = port(*_torch(A, Bs), _mesh(8), **KW)
    _same_family(got, ref(A, Bs, jax_mesh, **JKW))
    sol, capped = _sol_capped(got)
    assert sol.val.dtype == F32 and sol.idx.dtype == torch.int32
    assert capped is None or (capped.dtype == torch.bool
                              and not capped.any())


@pytest.mark.parametrize("name,seed", [("srr", 304), ("rmp", 304),
                                       ("foba", 304), ("rmp", 306),
                                       ("foba", 306)])
def test_fr_family_deletions_match_cstpu(name, seed, jax_mesh, monkeypatch):
    # a correlated dictionary: the forward stages take wrong atoms first
    # and the backward stages delete them (seed 304: every row recovers its
    # six atoms after 48 deletions in the batch; seed 306: some rows run
    # into the kmax cap). SRR ends every row by deleting the atom it
    # has just appended, the case that clears all four pending channels
    port, ref = FRFAM[name]
    A, Bs = _correlated(seed)
    deleted, same = [], []
    candidate, delete = tsh._delete_candidate, tsh._delete_refit
    select = tsh._Rescaling.select

    def spy_select(self, *a, **kw):
        out = select(self, *a, **kw)
        same.append(out[1])
        return out

    def spy_candidate(st):
        out = candidate(st)
        same.append((st.k > 5) & (out[2] == same.pop()))
        return out

    def spy_delete(st, pos, m, gate):
        deleted.append(int(gate.sum()))
        return delete(st, pos, m, gate)

    monkeypatch.setattr(tsh, "_delete_refit", spy_delete)
    if name == "srr":
        monkeypatch.setattr(tsh._Rescaling, "select", spy_select)
        monkeypatch.setattr(tsh, "_delete_candidate", spy_candidate)
    got = port(*_torch(A, Bs), _mesh(8), **KW)
    _same_family(got, ref(A, Bs, jax_mesh, **JKW))
    assert sum(deleted) >= 8
    if name == "srr":
        assert sum(int(x.sum()) for x in same) >= 8
    else:
        assert bool(got[1].any()) == (seed == 306)


@pytest.mark.parametrize("name", list(FRFAM))
def test_fr_family_is_invariant_under_shards_and_forms(name):
    # 1, 2, 4 and 8 shards, both collective forms, a (2, 4) mesh: the same
    # supports, on a problem with deletions
    port, _ = FRFAM[name]
    A, Bs = _torch(*_correlated(304))
    base = port(A, Bs, _mesh(1), fuse_collectives=False, **KW)
    for s in (1, 2, 4, 8):
        for fuse in (True, False):
            _same_family(port(A, Bs, _mesh(s), fuse_collectives=fuse, **KW),
                         base, rtol=1e-5)
    _same_family(port(A, Bs, _mesh(4, 2), **KW), base, rtol=1e-5)
    # the twin on the plain select is the same function on the CPU
    ref = getattr(tsh, f"{name}_sharded_fused_ref")
    args = (5,) if name in ("fr", "srr") else (DELTA,)
    kw = {} if name in ("fr", "srr") else {"kmax": 16}
    _same_family(ref(A, Bs, *args, _mesh(4), **kw, **KW), base, rtol=1e-5)


@pytest.mark.parametrize("name", list(FRFAM))
def test_fr_family_matches_the_batched_entry_points(name):
    # the sharded solver and the `*_batch` entry point (per-instance solvers
    # on the CPU) recover the same supports
    import cstpu_torch

    A, Bs = _torch(*_problem(FRSEEDS[name]))
    sol, _ = _sol_capped(FRFAM[name][0](A, Bs, _mesh(4), **KW))
    want = {"fr": lambda: cstpu_torch.fr_batch(A, Bs, sparsity=5),
            "srr": lambda: cstpu_torch.srr_batch(A, Bs, 5),
            "rmp": lambda: cstpu_torch.rmp_batch(A, Bs, delta=DELTA),
            "foba": lambda: cstpu_torch.foba_batch(A, Bs, DELTA)}[name]()
    g, w = solution_to_numpy(sol), solution_to_numpy(want)
    for i in range(8):
        gi, wi = g["idx"][i][g["mask"][i]], w["idx"][i][w["mask"][i]]
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(g["val"][i][g["mask"][i]],
                                   w["val"][i][w["mask"][i]], rtol=1e-4,
                                   atol=1e-6)


def test_fr_family_counts_and_iteration_reports():
    A, Bs = _torch(*_problem(76))
    sol, steps = tsh.fr_sharded_fused(A, Bs, 5, _mesh(4), return_iters=True,
                                      **KW)
    assert steps == [5] and sol.idx.shape == (8, 5)
    # a stopping rule that ends the loop early: the exact rows stop at once
    sol, steps = tsh.fr_sharded_fused(A, Bs[::2], 9, _mesh(4),
                                      max_residual=1e-3, return_iters=True,
                                      **KW)
    assert steps == [6] and sol.mask.sum(dim=1).tolist() == [5] * 4
    _, iters = tsh.srr_sharded_fused(A, Bs, 5, _mesh(4), return_iters=True,
                                     **KW)
    assert 1 <= iters[0] <= 20
    for fn in (tsh.rmp_sharded_fused, tsh.foba_sharded_fused):
        sol, capped, counts = fn(A, Bs, DELTA, _mesh(4, 2), kmax=16,
                                 return_iters=True, **KW)
        assert len(counts) == 2 and capped.shape == (8,)
        for c in counts:
            assert c["sweeps"] >= 6 and c["flag_reads"] >= c["sweeps"]


def test_rmp_cap_reports_capped_rows(jax_mesh):
    # kmax below the support: every row is refused an atom and says so
    A, Bs = _problem(83)
    got = tsh.rmp_sharded_fused(*_torch(A, Bs), DELTA, _mesh(8), kmax=3,
                                **KW)
    want = jsh.rmp_sharded_fused(A, Bs, DELTA, jax_mesh, kmax=3, **JKW)
    _same_family(got, want)
    assert got[1].all() and got[0].idx.shape == (8, 3)


def _wide_problem(seed):
    """n=128, m=1024 and eight random (not sparse) measurements: the scores
    of a top-48 are spread out, and a 48-atom fit leaves a real residual."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((128, 1024)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    return jnp.asarray(A), jnp.asarray(
        rng.standard_normal((8, 128)).astype(np.float32))


WIDE = {
    "sp": (lambda A, Bs, mesh, **kw: tsh.sp_sharded_fused(
               A, Bs, 48, mesh, maxiter=2, **kw),
           lambda A, Bs, mesh, **kw: jsh.sp_sharded_fused(
               A, Bs, 48, mesh, maxiter=2, **kw)),
    "srr": (lambda A, Bs, mesh, **kw: tsh.srr_sharded_fused(
                A, Bs, 48, mesh, maxiter=4, **kw),
            lambda A, Bs, mesh, **kw: jsh.srr_sharded_fused(
                A, Bs, 48, mesh, maxiter=4, **kw)),
    "ompr": (lambda A, Bs, mesh, **kw: tsh.ompr_sharded_fused(
                 A, Bs, 48, mesh, maxiter=3, **kw),
             lambda A, Bs, mesh, **kw: jsh.ompr_sharded_fused(
                 A, Bs, 48, mesh, maxiter=3, **kw)),
    "gomp": (lambda A, Bs, mesh, **kw: tsh.gomp_sharded_fused(
                 A, Bs, 48, 48, mesh, **kw),
             lambda A, Bs, mesh, **kw: jsh.gomp_sharded_fused(
                 A, Bs, 48, 48, mesh, **kw)),
}


@pytest.mark.parametrize("name", list(WIDE))
def test_topk_beyond_32_matches_cstpu(name, jax_mesh):
    # k = 48 (GOMP: l = 48) is beyond the 32 picks the top-l select used to
    # serve; every shard is 128 atoms wide, so a shard offers 48 of its 128
    port, ref = WIDE[name]
    A, Bs = _wide_problem(48)
    got = port(*_torch(A, Bs), _mesh(8), **KW)
    _same_solution(got, ref(A, Bs, jax_mesh, **JKW))
    assert got.mask.sum(dim=1).min() >= 48
    _same_solution(port(*_torch(A, Bs), _mesh(2), fuse_collectives=False,
                        **KW), got, rtol=1e-5)


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_omp_sharded_rows_matches_cstpu(s):
    # f64, a tall shape (n > m would leave cstpu's generator no room: the
    # rows are what is cut, so n = 64 over s shards serves)
    A, Bs = _problem(70, dtype=jnp.float64)
    tA, tB = _torch(A, Bs)
    rows_mesh = jmesh.make_mesh((1, s), devices=jax.devices()[:s])
    for i in (0, 1):
        want = jsh.omp_sharded_rows(A, Bs[i], 5, rows_mesh)
        got = tsh.omp_sharded_rows(tA, tB[i], 5, _mesh(s))
        assert got.idx.shape == (5,) and got.val.dtype == torch.float64
        _same_solution(got, want, rtol=1e-10, atol=1e-12)
    # the epsilon stop, and agreement with the column-sharded reference
    want = jsh.omp_sharded_rows(A, Bs[1], 5, rows_mesh, max_residual=1.5)
    got = tsh.omp_sharded_rows(tA, tB[1], 5, _mesh(s), max_residual=1.5)
    _same_solution(got, want, rtol=1e-10, atol=1e-12)
    assert int(got.mask.sum()) < 5
    _same_solution(tsh.omp_sharded_rows(tA, tB[1], 5, _mesh(s)),
                   tsh.omp_sharded(tA, tB[1], 5, _mesh(8)), rtol=1e-10)
