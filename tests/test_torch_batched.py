"""cstpu_torch.omp_batch against cstpu.omp_batch on the CPU, its dispatch,
and the port's guards: no jax import, no CPU run of chip_smoke.py, a clear
error when nvcc is missing."""

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
    assert tfs.LAUNCHES == {"select": 0, "append": 0}


def test_fused_solve_on_cpu_launches_nothing():
    A, x, Bs = _batch(302)
    for key in tfs.LAUNCHES:
        tfs.LAUNCHES[key] = 0
    tfs.omp_fused_solve(to_torch(A), to_torch(Bs), 3)
    assert tfs.LAUNCHES == {"select": 0, "append": 0}


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
    assert names == ["omp_append.cu", "select_argmax.cu"]
    assert all(p.parent == ROOT / "cstpu_torch" / "csrc"
               for p in _build.sources())
