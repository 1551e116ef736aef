"""cstpu_torch's batched entry points (omp_batch, mp_batch, gomp_batch,
fr_batch, sp_batch, ompr_batch, srr_batch) against cstpu's on the CPU,
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
    # max_residual > 0 and precision="highest" take the per-instance omp
    # even for CUDA tensors: decided by the options, not by an exception
    A, x, Bs = _batch(303)
    calls = []
    monkeypatch.setattr(tbatched.fused_solve, "omp_fused_solve",
                        lambda *a, **k: (calls.append("fused"), None))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(tbatched, "omp",
                        lambda A_, b, k=None, max_residual=0.0:
                        calls.append("omp") or cstpu_torch.omp(A_, b, k))
    tA, tB = to_torch(A), to_torch(Bs)
    tbatched.omp_batch(tA, tB, 3, max_residual=1e-3)
    tbatched.omp_batch(tA, tB, 3, precision="highest")
    assert calls == ["omp"] * 8
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
    assert names == ["engine_delete.cu", "engine_init.cu", "fr_append.cu",
                     "fr_select.cu", "gomp_append.cu", "mp_update.cu",
                     "omp_append.cu", "ompr_swap.cu", "select_argmax.cu",
                     "select_topl.cu", "sp_round.cu", "srr_append.cu"]
    # every C entry point the wrappers call has its ctypes signature
    assert set(_build._SIGNATURES) == {
        "cstpu_" + name[:-3] for name in names}
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
                       (tbatched.fused_twostage, ("sp", "ompr", "srr"))):
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
