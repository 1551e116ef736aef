"""cstpu_torch's batched entry points (omp_batch, mp_batch, gomp_batch,
fr_batch, sp_batch, ompr_batch, srr_batch, rmp_batch, foba_batch, br_batch,
fbr_batch, lace_batch) against cstpu's on the CPU,
their dispatch, and the port's guards: no jax import, no CPU run of
chip_smoke.py, a clear error when nvcc is missing.

Tolerances: in f64 supports are identical and values agree to 1e-10
relative; in f32 to 1e-5 relative (atol 1e-6) on the per-instance paths,
and 1e-4 absolute where the kernels' plain versions stand in for the
kernels (cstpu's kernel-against-XLA tolerance)."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstpu
import cstpu_torch
from cstpu_torch.models import batched as tbatched
from cstpu_torch.ops import _build
from cstpu_torch.ops import fused_solve as tfs
from cstpu_torch.ops import fused_twostage as tft
from cstpu_torch.utils.interop import solution_to_numpy, to_torch

ROOT = Path(__file__).resolve().parent.parent


def _batch(seed, dtype=jnp.float32):
    from conftest import planted_problem

    A, x, b, y = planted_problem(seed, n=32, m=128, k=3, dtype=dtype)
    return A, x, jnp.stack([b, y, -b, b + 0.5 * y])


@pytest.mark.parametrize("dtype,k", [(jnp.float32, 3), (jnp.float64, 3),
                                     (jnp.float64, 6), (jnp.float64, None)])
def test_omp_batch_matches_cstpu(dtype, k):
    A, x, Bs = _batch(300, dtype)
    t = solution_to_numpy(cstpu_torch.omp_batch(to_torch(A), to_torch(Bs), k))
    j = solution_to_numpy(cstpu.omp_batch(A, Bs, k))
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    rtol = 1e-10 if dtype == jnp.float64 else 1e-5
    np.testing.assert_allclose(t["val"], j["val"], rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("kw", [{"max_residual": 1e-2},
                                {"precision": "highest"},
                                {"precision": "f32"}, {}])
def test_options_match_cstpu_and_launch_nothing_on_cpu(kw):
    A, x, Bs = _batch(301)
    for key in tfs.LAUNCHES:
        tfs.LAUNCHES[key] = 0
    t = solution_to_numpy(cstpu_torch.omp_batch(to_torch(A), to_torch(Bs),
                                                5, **kw))
    j = solution_to_numpy(cstpu.omp_batch(A, Bs, 5, **kw))
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=1e-5, atol=1e-6)
    assert not any(tfs.LAUNCHES.values())


def test_fused_solve_on_cpu_launches_nothing():
    A, x, Bs = _batch(302)
    for key in tfs.LAUNCHES:
        tfs.LAUNCHES[key] = 0
    tfs.omp_fused_solve(to_torch(A), to_torch(Bs), 3)
    tfs.mp_fused_solve(to_torch(A), to_torch(Bs), 3)
    tfs.gomp_fused_solve(to_torch(A), to_torch(Bs), 2, 4)
    tfs.fr_fused_solve(to_torch(A), to_torch(Bs), 3)
    assert not any(tfs.LAUNCHES.values())


def test_options_that_leave_the_kernels(monkeypatch):
    # max_residual > 0 and precision="highest" take omp's batched body even
    # for CUDA tensors: decided by the options, not by an exception; one
    # call of the body for all the rows, and no kernel
    A, x, Bs = _batch(303)
    calls = []
    monkeypatch.setattr(tbatched.fused_solve, "omp_fused_solve",
                        lambda *a, **k: (calls.append("fused"), None))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    rows = tbatched._omp_rows
    monkeypatch.setattr(tbatched, "_omp_rows",
                        lambda A_, Bs_, k=None, max_residual=0.0:
                        calls.append(("rows", Bs_.shape[0]))
                        or rows(A_, Bs_, k, max_residual))
    tA, tB = to_torch(A), to_torch(Bs)
    tbatched.omp_batch(tA, tB, 3, max_residual=1e-3)
    tbatched.omp_batch(tA, tB, 3, precision="highest")
    assert calls == [("rows", 4)] * 2
    tbatched.omp_batch(tA, tB, 3)
    assert calls[-1] == "fused"


def test_batch_stacks_solutions_and_tensors():
    A, x, Bs = _batch(304, jnp.float64)
    tA, tB = to_torch(A), to_torch(Bs)
    sol = cstpu_torch.batch(cstpu_torch.omp, k=3)(tA, tB)
    assert sol.idx.shape == (4, 3) and sol.m == 128
    dense = cstpu_torch.batch(cstpu_torch.mp)(tA, tB, k=4)
    assert dense.shape == (4, 128)
    np.testing.assert_array_equal(
        sol.todense()[1].numpy(), cstpu_torch.omp(tA, tB[1], 3).todense().numpy())


def test_import_leaves_jax_out():
    code = ("import sys, cstpu_torch, cstpu_torch.ops.fused_solve, "
            "cstpu_torch.utils.interop; "
            "sys.exit(1 if 'jax' in sys.modules else 0)")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode != 0
    assert '"ok": true' not in done.stdout


def test_build_raises_clearly_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "NVCC_CANDIDATES", [])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_sources_are_the_package_csrc():
    names = sorted(p.name for p in _build.sources())
    assert names == ["bw_downdate.cu", "bw_select.cu", "engine_backward.cu",
                     "engine_delete.cu", "engine_init.cu", "fr_append.cu",
                     "fr_select.cu", "fr_step_select.cu", "gomp_append.cu",
                     "mp_update.cu",
                     "omp_append.cu", "ompr_swap.cu", "rmp_append.cu",
                     "select_argmax.cu", "select_topl.cu", "sp_round.cu",
                     "srr_append.cu", "stream_select.cu"]
    # every C entry point the wrappers call has its ctypes signature: one
    # per source, stream_select.cu's second, third and fourth ones for the
    # top-l sweep, its finish and the finish's scratch query past 128
    # slots, fr_select.cu's query of the tensor-core rescaled selects'
    # plan, omp_append.cu's query of the cluster append's plan,
    # rmp_append.cu's of the slot engine's, gomp_append.cu's and
    # ompr_swap.cu's of theirs, and mp_update.cu's of its grid's
    assert set(_build._SIGNATURES) == {
        "cstpu_" + name[:-3] for name in names} | {
            "cstpu_stream_topl", "cstpu_stream_topl_finish",
            "cstpu_stream_topl_work",
            "cstpu_rescaled_plan", "cstpu_append_plan", "cstpu_engine_plan",
            "cstpu_gomp_plan", "cstpu_ompr_plan", "cstpu_mp_plan"}
    assert all(p.parent == ROOT / "cstpu_torch" / "csrc"
               for p in _build.sources())


# --------------------------------------------------------------------------
# mp_batch, gomp_batch, fr_batch
# --------------------------------------------------------------------------

def _tol(dtype):
    return ({"rtol": 1e-10, "atol": 1e-12} if dtype == jnp.float64
            else {"rtol": 1e-5, "atol": 1e-6})


def _same(tsol, jsol, dtype):
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], **_tol(dtype))
    return t


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_mp_batch_matches_cstpu(dtype):
    A, x, Bs = _batch(305, dtype)
    t = cstpu_torch.mp_batch(to_torch(A), to_torch(Bs), 10)
    j = cstpu.mp_batch(A, Bs, 10)
    assert t.shape == (4, 128)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **_tol(dtype))


@pytest.mark.parametrize("dtype,l,k", [(jnp.float64, 2, 5),
                                       (jnp.float64, 3, 7),
                                       (jnp.float32, 1, 3)])
def test_gomp_batch_matches_cstpu(dtype, l, k):
    # past the planted count the noiseless rows (0, 2) pick atoms by
    # rounding noise after their exact fit: only the noisy rows compare
    A, x, Bs = _batch(306, dtype)
    Bs = Bs if k <= 3 else Bs[1::2]
    t = _same(cstpu_torch.gomp_batch(to_torch(A), to_torch(Bs), l, k),
              cstpu.gomp_batch(A, Bs, l, k), dtype)
    assert t["idx"].shape == (Bs.shape[0], k)
    # k=None takes k = m: the slot width is m on both
    t = cstpu_torch.gomp_batch(to_torch(A), to_torch(Bs[:1]), 16)
    j = cstpu.gomp_batch(A, Bs[:1], 16, None)
    assert t.idx.shape == j.idx.shape == (1, 128)


@pytest.mark.parametrize("dtype,kw", [(jnp.float64, {"sparsity": 3}),
                                      (jnp.float64, {}),
                                      (jnp.float64, {"max_residual": 1e-2}),
                                      (jnp.float32, {"sparsity": 3})])
def test_fr_batch_matches_cstpu(dtype, kw):
    # without sparsity the noiseless rows stop at their exact fit, the
    # noisy ones at the floor of min_decrease
    A, x, Bs = _batch(307, dtype)
    if "sparsity" not in kw:
        kw = {**kw, "min_decrease": 1e-2}
    _same(cstpu_torch.fr_batch(to_torch(A), to_torch(Bs), **kw),
          cstpu.fr_batch(A, Bs, **kw), dtype)


def _fake_cuda(monkeypatch):
    """Make every tensor claim to be on CUDA and route the kernel solves
    to their plain versions, so that the kernel branches of the batched
    entry points run on the CPU. Returns the list of branches taken."""
    calls = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for mod, names in ((tbatched.fused_solve, ("mp", "gomp", "fr")),
                       (tbatched.fused_twostage, ("sp", "ompr", "srr", "rmp",
                                                  "foba")),
                       (tbatched.fused_backward, ("fbr", "lace"))):
        for name in names:
            ref = getattr(mod, f"{name}_fused_solve_ref")
            monkeypatch.setattr(
                mod, f"{name}_fused_solve",
                lambda *a, _ref=ref, _name=name, **kw:
                calls.append(_name) or _ref(*a, **kw))
    return calls


def test_kernel_branches_match_cstpu(monkeypatch):
    # the kernel path of each entry point, with the kernels' plain versions
    # standing in, against cstpu's per-instance paths in f32
    A, x, Bs = _batch(308)
    calls = _fake_cuda(monkeypatch)
    tA, tB = to_torch(A), to_torch(Bs)
    xs = tbatched.mp_batch(tA, tB, 6, precision="f32")
    np.testing.assert_allclose(xs.numpy(), np.asarray(cstpu.mp_batch(A, Bs, 6)),
                               atol=1e-4)
    t = solution_to_numpy(tbatched.fr_batch(tA, tB, sparsity=3,
                                            precision="f32"))
    j = solution_to_numpy(cstpu.fr_batch(A, Bs, sparsity=3))
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_allclose(t["val"], j["val"], atol=1e-4)
    # k > n: the kernel path's slot width min(k, n) = 32 is padded back to
    # the per-instance width min(k, m) = 40 (idx m, val 0, mask False)
    t = solution_to_numpy(tbatched.gomp_batch(tA, tB, 2, 40,
                                              precision="f32"))
    j = solution_to_numpy(cstpu.gomp_batch(A, Bs, 2, 40))
    assert t["idx"].shape == j["idx"].shape == (4, 40)
    assert (t["idx"][:, 32:] == 128).all() and not t["mask"][:, 32:].any()
    assert (t["val"][:, 32:] == 0).all()
    planted = set(np.flatnonzero(np.asarray(x)).tolist())
    assert planted <= set(t["idx"][0][t["mask"][0]].tolist())
    assert calls == ["mp", "fr", "gomp"]


def test_greedy_options_that_leave_the_kernels(monkeypatch):
    # decided by the options, dtypes and gates, not by an exception: no
    # sparsity (fr), precision="highest", a float64 dictionary
    A, x, Bs = _batch(309)
    calls = _fake_cuda(monkeypatch)
    tA, tB = to_torch(A), to_torch(Bs)
    tbatched.fr_batch(tA, tB, min_decrease=1e-2)
    tbatched.fr_batch(tA, tB, sparsity=3, precision="highest")
    tbatched.mp_batch(tA, tB, 3, precision="highest")
    tbatched.gomp_batch(tA, tB, 2, 4, precision="highest")
    tbatched.gomp_batch(tA.double(), tB.double(), 2, 4)
    assert calls == []
    tbatched.gomp_batch(tA, tB, 2, 4)
    assert calls == ["gomp"]


# --------------------------------------------------------------------------
# sp_batch, ompr_batch, srr_batch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_twostage_batch_matches_cstpu(dtype):
    # noisy rows only: past an exact fit the extra slots of SP and SRR pick
    # atoms by rounding noise
    A, x, Bs = _batch(310, dtype)
    Bs = Bs[1::2]
    tA, tB = to_torch(A), to_torch(Bs)
    t = _same(cstpu_torch.sp_batch(tA, tB, 3, maxiter=8),
              cstpu.sp_batch(A, Bs, 3, maxiter=8), dtype)
    assert t["idx"].shape == (2, 6)
    t = _same(cstpu_torch.ompr_batch(tA, tB, 3, 1e-10, maxiter=16),
              cstpu.ompr_batch(A, Bs, 3, 1e-10, maxiter=16), dtype)
    assert t["idx"].shape == (2, 4)
    for init in (1, 2):
        t = _same(cstpu_torch.srr_batch(tA, tB, 3, l=2, initialization=init),
                  cstpu.srr_batch(A, Bs, 3, l=2, initialization=init), dtype)
        assert t["idx"].shape == (2, 5)
    planted = set(np.flatnonzero(np.asarray(x)).tolist())
    assert planted <= set(t["idx"][0][t["mask"][0]].tolist())


def test_twostage_kernel_branches_match_cstpu(monkeypatch):
    # the kernel path of each two-stage entry point, with the kernels'
    # plain versions standing in, against cstpu's per-instance paths in f32
    A, x, Bs = _batch(311)
    calls = _fake_cuda(monkeypatch)
    tA, tB = to_torch(A), to_torch(Bs)
    for got, want in (
            (tbatched.sp_batch(tA, tB, 3, maxiter=8, precision="f32"),
             cstpu.sp_batch(A, Bs, 3, maxiter=8)),
            (tbatched.ompr_batch(tA, tB, 3, 1e-10, maxiter=16,
                                 precision="f32"),
             cstpu.ompr_batch(A, Bs, 3, 1e-10, maxiter=16)),
            (tbatched.srr_batch(tA, tB, 3, l=2, precision="f32"),
             cstpu.srr_batch(A, Bs, 3, l=2))):
        t, j = solution_to_numpy(got), solution_to_numpy(want)
        np.testing.assert_array_equal(t["idx"], j["idx"])
        np.testing.assert_allclose(t["val"], j["val"], atol=1e-4)
    assert calls == ["sp", "ompr", "srr"]


def test_twostage_options_that_leave_the_kernels(monkeypatch):
    # decided by the options and dtypes, not by an exception:
    # initialization 2, precision="highest", a float64 dictionary
    A, x, Bs = _batch(312)
    calls = _fake_cuda(monkeypatch)
    tA, tB = to_torch(A), to_torch(Bs)
    tbatched.srr_batch(tA, tB, 3, initialization=2)
    tbatched.sp_batch(tA, tB, 3, precision="highest")
    tbatched.ompr_batch(tA.double(), tB.double(), 3, 1e-10, maxiter=4)
    assert calls == []
    tbatched.srr_batch(tA, tB, 3, maxiter=2)
    assert calls == ["srr"]


def test_twostage_fused_solves_on_cpu_launch_nothing():
    A, x, Bs = _batch(313)
    for key in tfs.LAUNCHES:
        tfs.LAUNCHES[key] = 0
    tA, tB = to_torch(A), to_torch(Bs)
    _, _, it = tft.sp_fused_solve(tA, tB, 3, return_iters=True)
    assert it >= 1
    tft.ompr_fused_solve(tA, tB, 3, 1e-10)
    tft.srr_fused_solve(tA, tB, 3)
    assert not any(tfs.LAUNCHES.values())


# --------------------------------------------------------------------------
# Inputs that are not tensors
# --------------------------------------------------------------------------

def test_non_tensor_inputs_raise_without_a_cuda_device():
    # numpy inputs would go to the card; without one every entry point
    # raises instead of solving on the CPU unasked
    A, x, Bs = _batch(320)
    nA, nB = np.asarray(A), np.asarray(Bs)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: numpy inputs are taken")
    calls = {"omp_batch": (3,), "mp_batch": (3,), "gomp_batch": (2, 4),
             "fr_batch": (), "sp_batch": (3,), "ompr_batch": (3, 1e-10),
             "srr_batch": (3,), "foba_batch": (1e-2,), "br_batch": (),
             "fbr_batch": (), "lace_batch": ()}
    for name, args in calls.items():
        with pytest.raises(RuntimeError, match="CPU tensors"):
            getattr(cstpu_torch, name)(nA, nB, *args)
    with pytest.raises(RuntimeError, match="CPU tensors"):
        cstpu_torch.rmp_batch(nA.tolist(), nB.tolist(), delta=1e-2)


def test_tensor_inputs_keep_their_device():
    # CPU tensors ask for the CPU; an input that is not a tensor follows the
    # one that is
    A, x, Bs = _batch(321)
    tA, tB = tbatched._inputs(to_torch(A), np.array(Bs))
    assert tA.device == tB.device == torch.device("cpu")
    assert isinstance(tB, torch.Tensor)
    np.testing.assert_array_equal(tB.numpy(), np.asarray(Bs))
    same = tbatched._inputs(tA, tB)
    assert same[0] is tA and same[1] is tB
    sol = cstpu_torch.omp_batch(np.array(A), tB, 3)
    assert sol.idx.device == torch.device("cpu")
    np.testing.assert_array_equal(
        sol.idx.numpy(), np.asarray(cstpu.omp_batch(A, Bs, 3).idx))


# --------------------------------------------------------------------------
# rmp_batch, foba_batch, br_batch, fbr_batch, lace_batch
# --------------------------------------------------------------------------

def _dense(sol):
    t = solution_to_numpy(sol)
    out = np.zeros((t["idx"].shape[0], t["m"] + 1), t["val"].dtype)
    np.put_along_axis(out, np.where(t["mask"], t["idx"], t["m"]),
                      np.where(t["mask"], t["val"], 0), axis=1)
    return out[:, :-1]


def _jdense(sol):
    import jax

    return np.asarray(jax.vmap(lambda s: s.todense())(sol))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_stepwise_batch_matches_cstpu(dtype):
    A, x, Bs = _batch(322, dtype)
    tA, tB = to_torch(A), to_torch(Bs)
    _same(cstpu_torch.rmp_batch(tA, tB, delta=1e-2),
          cstpu.rmp_batch(A, Bs, delta=1e-2), dtype)
    _same(cstpu_torch.rmp_batch(tA, tB, delta=1e-2, maxiter=3),
          cstpu.rmp_batch(A, Bs, delta=1e-2, maxiter=3), dtype)
    t = _same(cstpu_torch.foba_batch(tA, tB, 1e-2),
              cstpu.foba_batch(A, Bs, 1e-2), dtype)
    assert t["idx"].shape == (4, 32)             # min(n, m) slots
    if dtype == jnp.float64:   # the k variant: exhaustion is f64's here
        _same(cstpu_torch.rmp_batch(tA, tB[:1], k=3),
              cstpu.rmp_batch(A, Bs[:1], k=3), dtype)
    for kw in ({}, {"k": 3, "delta": 1e-2}):
        with pytest.raises(ValueError, match="exactly one"):
            cstpu_torch.rmp_batch(tA, tB, **kw)


def _square(seed, dtype=jnp.float32):
    from conftest import planted_problem

    A, x, b, y = planted_problem(seed, n=32, m=32, k=3, noise=5e-3,
                                 dtype=dtype)
    return A, x, jnp.stack([y, 2.0 * y, b - 0.1 * y])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_backward_batch_matches_cstpu(dtype):
    A, x, Bs = _square(323, dtype)
    tA, tB = to_torch(A), to_torch(Bs)
    planted = set(np.flatnonzero(np.asarray(x)).tolist())
    atol = 1e-8 if dtype == jnp.float64 else 1e-3
    for name, kws in (("br_batch", ({"sparsity": 3}, {"max_increase": 1e-2},
                                    {"sparsity": 3, "naive": True})),
                      ("fbr_batch", ({"sparsity": 3}, {"max_residual": 3e-2})),
                      ("lace_batch", ({"sparsity": 3}, {"max_increase": 1e-2}))):
        for kw in kws:
            tsol = getattr(cstpu_torch, name)(tA, tB, **kw)
            jsol = getattr(cstpu, name)(A, Bs, **kw)
            t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
            np.testing.assert_array_equal(t["idx"], j["idx"])
            np.testing.assert_allclose(t["val"], j["val"], rtol=0, atol=atol)
            assert set(t["idx"][0][t["mask"][0]].tolist()) == planted


def test_backward_batch_return_failed():
    A, x, Bs = _square(324, jnp.float64)
    tA, tB = to_torch(A), to_torch(Bs)
    sol, failed = cstpu_torch.fbr_batch(tA, tB, sparsity=3,
                                        return_failed=True)
    assert failed.shape == (3,) and failed.dtype == torch.bool
    assert not failed.any() and sol.idx.shape == (3, 32)
    # LACE's per-instance path: a non-finite active coefficient is the flag
    bad = tB.clone()
    bad[1] = float("nan")
    sol, failed = cstpu_torch.lace_batch(tA, bad, sparsity=3,
                                         return_failed=True)
    _, jfailed = cstpu.lace_batch(A, jnp.asarray(bad.numpy()), sparsity=3,
                                  return_failed=True)
    assert failed.tolist() == np.asarray(jfailed).tolist() == [False, True,
                                                               False]
    assert isinstance(cstpu_torch.lace_batch(tA, tB, sparsity=3),
                      cstpu_torch.SparseSolution)


def test_stepwise_and_backward_kernel_branches_match_cstpu(monkeypatch):
    # the kernel path of each new entry point, with the kernels' plain
    # versions standing in, against cstpu's per-instance paths in f32
    A, x, Bs = _batch(325)
    calls = _fake_cuda(monkeypatch)
    tA, tB = to_torch(A), to_torch(Bs)
    for got, want in (
            (tbatched.rmp_batch(tA, tB, delta=1e-2, kmax=8, precision="f32"),
             cstpu.rmp_batch(A, Bs, delta=1e-2)),
            (tbatched.rmp_batch(tA, tB, delta=1e-2, maxiter=2, kmax=8),
             cstpu.rmp_batch(A, Bs, delta=1e-2, maxiter=2)),
            (tbatched.foba_batch(tA, tB, 1e-2, kmax=8, precision="f32"),
             cstpu.foba_batch(A, Bs, 1e-2))):
        assert got.idx.shape == (4, 8)
        np.testing.assert_allclose(_dense(got), _jdense(want), atol=2e-3)
    A2, x2, Bs2 = _square(326)
    tA2, tB2 = to_torch(A2), to_torch(Bs2)
    for name in ("fbr_batch", "lace_batch"):
        got, failed = getattr(tbatched, name)(tA2, tB2, sparsity=3,
                                              return_failed=True)
        want = getattr(cstpu, name)(A2, Bs2, sparsity=3)
        assert not failed.any()
        np.testing.assert_allclose(_dense(got), _jdense(want), atol=1e-3)
    tbatched.br_batch(tA2, tB2, sparsity=3)            # no kernel path
    assert calls == ["rmp", "rmp", "foba", "fbr", "lace"]


def test_capped_rows_are_resolved_uncapped(monkeypatch):
    # kmax = 2 cannot hold the 3 planted atoms: the kernels report every row
    # capped and the batched body re-solves them all in one call, so the
    # result is the uncapped one, at the wider slot width
    A, x, Bs = _batch(327)
    calls = _fake_cuda(monkeypatch)
    tA, tB = to_torch(A), to_torch(Bs)
    redone = []
    real_rmp, real_foba = tbatched._rmp_rows, tbatched._foba_rows
    monkeypatch.setattr(tbatched, "_rmp_rows", lambda A_, Bs_, *a, **kw:
                        redone.append(("rmp", Bs_.shape[0]))
                        or real_rmp(A_, Bs_, *a, **kw))
    monkeypatch.setattr(tbatched, "_foba_rows", lambda A_, Bs_, *a, **kw:
                        redone.append(("foba", Bs_.shape[0]))
                        or real_foba(A_, Bs_, *a, **kw))
    got = tbatched.rmp_batch(tA, tB, delta=1e-2, kmax=2)
    assert got.idx.shape == (4, 32) and redone == [("rmp", 4)]
    np.testing.assert_allclose(
        _dense(got), _jdense(cstpu.rmp_batch(A, Bs, delta=1e-2)), atol=1e-4)
    got = tbatched.foba_batch(tA, tB, 1e-2, kmax=2)
    assert redone[1:] == [("foba", 4)]
    np.testing.assert_allclose(
        _dense(got), _jdense(cstpu.foba_batch(A, Bs, 1e-2)), atol=1e-4)
    assert calls == ["rmp", "foba"]
    # k > kmax never reaches the kernels
    tbatched.rmp_batch(tA, tB[:1], k=3, kmax=2)
    assert calls == ["rmp", "foba"]


def test_merge_solution_rows_pads_and_overwrites():
    S = cstpu_torch.SparseSolution
    sol = S(idx=torch.tensor([[1, 9], [2, 9], [3, 4]], dtype=torch.int32),
            val=torch.tensor([[1.0, 0.0], [2.0, 0.0], [3.0, 4.0]]),
            mask=torch.tensor([[True, False], [True, False], [True, True]]),
            m=9)
    redo = S(idx=torch.tensor([[5, 6, 7]], dtype=torch.int32),
             val=torch.tensor([[5.0, 6.0, 7.0]]),
             mask=torch.tensor([[True, True, True]]), m=9)
    out = tbatched._merge_solution_rows(sol, redo, torch.tensor([1]), 9)
    assert out.idx.tolist() == [[1, 9, 9], [5, 6, 7], [3, 4, 9]]
    assert out.val.tolist() == [[1.0, 0.0, 0.0], [5.0, 6.0, 7.0],
                                [3.0, 4.0, 0.0]]
    assert out.mask.tolist() == [[True, False, False], [True, True, True],
                                 [True, True, False]]
    assert sol.idx.shape == (3, 2)                 # the input is not written


def test_stepwise_and_backward_options_that_leave_the_kernels(monkeypatch):
    # decided by the options, dtypes and gates, not by an exception
    A, x, Bs = _batch(328)
    calls = _fake_cuda(monkeypatch)
    tA, tB = to_torch(A), to_torch(Bs)
    tbatched.rmp_batch(tA, tB, delta=1e-2, precision="highest")
    tbatched.foba_batch(tA.double(), tB.double(), 1e-2)
    tbatched.rmp_batch(tA, tB, delta=1e-2, kmax=200)       # beyond KMAX
    A2, x2, Bs2 = _square(329, jnp.float64)
    tbatched.fbr_batch(to_torch(A2), to_torch(Bs2), sparsity=3)   # f64
    tbatched.lace_batch(to_torch(A2)[:, :30].float(),
                        to_torch(Bs2).float(), sparsity=3)        # m % 4
    assert calls == []


def test_stepwise_and_backward_fused_solves_on_cpu_launch_nothing():
    A, x, Bs = _batch(330)
    A2, x2, Bs2 = _square(331)
    for key in tfs.LAUNCHES:
        tfs.LAUNCHES[key] = 0
    tA, tB = to_torch(A), to_torch(Bs)
    *_, (t, f) = tft.rmp_fused_solve(tA, tB, delta=1e-2, kmax=8,
                                     return_iters=True)
    assert t == 1 and f >= 4
    tft.foba_fused_solve(tA, tB, 1e-2, kmax=8)
    tbatched.fused_backward.fbr_fused_solve(to_torch(A2), to_torch(Bs2),
                                            sparsity=3)
    tbatched.fused_backward.lace_fused_solve(to_torch(A2), to_torch(Bs2),
                                             sparsity=3)
    assert not any(tfs.LAUNCHES.values())
    assert {"rmp_append", "engine_backward", "bw_select",
            "bw_downdate"} <= set(tfs.LAUNCHES)


# --------------------------------------------------------------------------
# The middle route: a shape beyond a solver's kernel gate that the streaming
# gate takes goes to the sharded solver on a one-shard mesh
# --------------------------------------------------------------------------

def _fake_cuda_middle(monkeypatch):
    """`_fake_cuda`, and the sharded solvers routed to their twins on the
    plain selects. Returns (kernel branches taken, sharded branches taken)."""
    calls = _fake_cuda(monkeypatch)
    routed = []
    for name in ("fr", "mp", "sp", "gomp", "srr", "ompr"):
        ref = getattr(tbatched.sharded, f"{name}_sharded_fused_ref")
        monkeypatch.setattr(
            tbatched.sharded, f"{name}_sharded_fused",
            lambda *a, _ref=ref, _name=name, **kw:
            routed.append(_name) or _ref(*a, **kw))
    return calls, routed


def test_middle_route_reaches_the_sharded_solvers(monkeypatch):
    # n=160, m=256, B=8: k = 130 is beyond the append kernels' 128 slots
    # (fr, gomp), a top-k of 40 beyond select_topl's 32 picks (sp, srr,
    # ompr). Each result has the supports of the loop over rows on the CPU
    rng = np.random.default_rng(11)
    A = rng.standard_normal((160, 256)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Bs = rng.standard_normal((8, 160)).astype(np.float32)
    tA, tB = torch.from_numpy(A), torch.from_numpy(Bs)
    want = {
        "fr": cstpu_torch.fr_batch(tA, tB, sparsity=130),
        "gomp": cstpu_torch.gomp_batch(tA, tB, 2, 130),
        "sp": cstpu_torch.sp_batch(tA, tB, 40, maxiter=2),
        "srr": cstpu_torch.srr_batch(tA, tB, 40, maxiter=3),
        "ompr": cstpu_torch.ompr_batch(tA, tB, 40, 1e-12, maxiter=3),
    }
    calls, routed = _fake_cuda_middle(monkeypatch)
    got = {
        "fr": tbatched.fr_batch(tA, tB, sparsity=130, precision="f32"),
        "gomp": tbatched.gomp_batch(tA, tB, 2, 130, precision="f32"),
        "sp": tbatched.sp_batch(tA, tB, 40, maxiter=2, precision="f32"),
        "srr": tbatched.srr_batch(tA, tB, 40, maxiter=3, precision="f32"),
        "ompr": tbatched.ompr_batch(tA, tB, 40, 1e-12, maxiter=3,
                                    precision="f32"),
    }
    assert routed == ["fr", "gomp", "sp", "srr", "ompr"] and calls == []
    for name, sol in got.items():
        g, w = solution_to_numpy(sol), solution_to_numpy(want[name])
        for i in range(8):
            gi, wi = g["idx"][i][g["mask"][i]], w["idx"][i][w["mask"][i]]
            np.testing.assert_array_equal(gi, wi, err_msg=name)
    # what stays off the middle route: options the kernels do not serve, a
    # batch the streaming gate refuses (B % 8), SRR's other initializations
    tbatched.fr_batch(tA, tB, sparsity=130, precision="highest")
    tbatched.sp_batch(tA[:, :128], tB[:4], 40, maxiter=1)
    tbatched.srr_batch(tA, tB, 40, maxiter=1, l=2)
    assert len(routed) == 5
    # mp: its kernel takes any shape with m >= 1, so the route is reached
    # only when that gate is closed
    monkeypatch.setattr(tbatched.fused_solve, "supported_mp",
                        lambda A_, Bs_: False)
    x = tbatched.mp_batch(tA, tB, 6, precision="f32")
    assert routed[-1] == "mp"
    np.testing.assert_allclose(
        x.numpy(), cstpu_torch.batch(cstpu_torch.mp, k=6)(tA, tB).numpy(),
        atol=1e-5)


def test_one_shard_mesh_is_cached_per_device():
    mesh = tbatched._one_shard_mesh(torch.device("cpu"))
    assert mesh is tbatched._one_shard_mesh(torch.device("cpu"))
    assert mesh.shape == {"batch": 1, "atoms": 1}


def test_gaussian_data_is_sparse_data():
    assert cstpu_torch.gaussian_data is cstpu_torch.sparse_data
    assert cstpu.gaussian_data is cstpu.sparse_data
    assert "gaussian_data" in cstpu_torch.__all__
    gen = torch.Generator().manual_seed(5)
    A, x, b = cstpu_torch.gaussian_data(gen, n=16, m=32, k=3)
    assert A.shape == (16, 32) and int((x != 0).sum()) == 3
    np.testing.assert_allclose((A @ x).numpy(), b.numpy(), atol=1e-6)
