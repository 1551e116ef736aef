"""cstpu_torch's atom-sharded SBL solvers (cstpu_torch.parallel.sharded_sbl)
on CPU meshes of (1, 1), (1, 4) and (2, 2) shards against cstpu's on its
eight-device CPU mesh, on cstpu's own problems (tests/test_sharded.py:
n=32, m=128, k=3, float32), converted through numpy.

Tolerances: x to 1e-4 absolute (cstpu's own, sharded against single
device) and the supports {|x| > sigma} equal. The C rebuild is held against
numpy's float64 Sigma + A diag(gamma) A' to 1e-10 relative to its largest
entry.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu import correlated_data, perturb, sparse_data
from cstpu.parallel import mesh as jmesh
from cstpu.parallel import sharded_sbl as jss
from cstpu_torch.parallel import (fsbl_sharded, make_mesh, rmps_sharded,
                                  sharded_sbl as tss)
from cstpu_torch.utils.interop import to_torch

SIGMA = 1e-2
ATOL = 1e-4
MESHES = [(1, 1), (1, 4), (2, 2)]


@pytest.fixture(scope="module")
def jax_mesh():
    assert jax.device_count() >= 8
    return jmesh.make_mesh((1, 8))


def _mesh(shape):
    return make_mesh(shape, devices=["cpu"])


def _problem(seed, corr=False):
    kd, kn = jax.random.split(jax.random.PRNGKey(seed))
    gen = correlated_data if corr else sparse_data
    A, x, b = gen(kd, n=32, m=128, k=3, dtype=jnp.float32)
    y = perturb(kn, b, SIGMA)
    return A, x, b, y


def _cov(seed=83):
    W = jax.random.normal(jax.random.PRNGKey(seed), (32, 32),
                          jnp.float32) / jnp.sqrt(32.0)
    return SIGMA ** 2 * (0.5 * jnp.eye(32) + W @ W.T)


def _close(got, want):
    assert got.device.type == "cpu"
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(np.abs(got) > SIGMA, np.abs(want) > SIGMA)


SOLVERS = {"fsbl": (fsbl_sharded, jss.fsbl_sharded),
           "rmps": (rmps_sharded, jss.rmps_sharded)}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ["fsbl", "rmps"])
@pytest.mark.parametrize("cov", [False, True])
def test_sharded_sbl_matches_cstpu(name, shape, cov, jax_mesh):
    A, x, b, y = _problem(81 if name == "fsbl" else 82)
    Bs = jnp.stack([b, y] * 4)
    sig = _cov() if cov else SIGMA ** 2
    tfn, jfn = SOLVERS[name]
    got = tfn(to_torch(A), to_torch(Bs), to_torch(sig), _mesh(shape))
    _close(got, jfn(A, Bs, sig, jax_mesh))
    planted = np.flatnonzero(np.asarray(x))
    np.testing.assert_array_equal(
        np.flatnonzero(np.abs(got[1].numpy()) > SIGMA), planted)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_rmps_sharded_mid_stage_refresh_matches_cstpu(shape, jax_mesh):
    # a budget of 2 actions re-anchors S/Q/C^-1 inside the stage loops
    A, x, b, y = _problem(82)
    Bs = jnp.stack([b, y] * 4)
    got = rmps_sharded(to_torch(A), to_torch(Bs), SIGMA ** 2, _mesh(shape),
                       refresh_actions=2)
    _close(got, jss.rmps_sharded(A, Bs, SIGMA ** 2, jax_mesh,
                                 refresh_actions=2))


def test_rmps_sharded_capped_acquisition_not_starved(jax_mesh):
    # cstpu's discriminator (tests/test_sharded.py:551-569): without the
    # starved guard this stops after one outer iteration on one atom
    A, x, b, y = _problem(8, corr=True)
    Bs = jnp.stack([y] * 8)
    got = rmps_sharded(to_torch(A), to_torch(Bs), 1e-4, _mesh((1, 4)),
                       maxiter_acquisition=1)
    _close(got, jss.rmps_sharded(A, Bs, 1e-4, jax_mesh,
                                 maxiter_acquisition=1))
    planted = set(np.flatnonzero(np.asarray(x)).tolist())
    assert planted <= set(np.flatnonzero(np.abs(got[0].numpy()) > SIGMA))


@pytest.mark.parametrize("name", ["fsbl", "rmps"])
def test_sharded_sbl_rejects_bad_shapes(name):
    A, x, b, y = _problem(81)
    Bs = to_torch(jnp.stack([b, y] * 4))
    tfn = SOLVERS[name][0]
    with pytest.raises(ValueError, match="sigma"):
        tfn(to_torch(A), Bs, torch.eye(16), _mesh((1, 4)))
    with pytest.raises(ValueError, match="atom shards"):
        tfn(to_torch(A), Bs, SIGMA ** 2, _mesh((1, 3)))
    with pytest.raises(ValueError, match="batch shards"):
        tfn(to_torch(A), Bs[:3], SIGMA ** 2, _mesh((2, 2)))


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
@pytest.mark.parametrize("actives", [40, 200])
def test_rebuild_C_both_forms_match_numpy(shape, actives, monkeypatch):
    # up to kcap = 64 actives a shard in every row the gathered form runs,
    # beyond it the dense one; both must give Sigma + A diag(gamma) A'
    rng = np.random.default_rng(5)
    n, m, B = 24, 1024, 3
    A = rng.standard_normal((n, m))
    gamma = np.zeros((B, m))
    for r in range(B):
        on = rng.choice(m, size=actives - r, replace=False)
        gamma[r, on] = rng.uniform(0.1, 2.0, size=on.size)
    W = rng.standard_normal((n, n))
    Sig = 1e-2 * (np.eye(n) + W @ W.T / n)
    want = Sig + np.einsum("km,bm,jm->bkj", A, gamma, A)

    forms = []
    for form in ("_dense_part", "_gathered_part"):
        real = getattr(tss, form)
        monkeypatch.setattr(tss, form, lambda *a, _f=real, _n=form:
                            (forms.append(_n), _f(*a))[1])
    mesh = _mesh(shape)
    rows, _, _, _, _ = tss._setup(torch.as_tensor(A), torch.zeros((B, n),
                                  dtype=torch.float64), 0.0, mesh, "test")
    ml = m // shape[1]
    g = torch.as_tensor(gamma)
    got = tss._rebuild_C(rows[0], [g[:, j * ml:(j + 1) * ml]
                                   for j in range(shape[1])],
                         torch.as_tensor(Sig))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    per_shard = max(np.count_nonzero(gamma[:, j * ml:(j + 1) * ml], axis=1)
                    .max() for j in range(shape[1]))
    assert ("_dense_part" in forms) == (per_shard > tss.KCAP)
    assert ("_gathered_part" in forms) == (
        min(np.count_nonzero(gamma[:, j * ml:(j + 1) * ml], axis=1).max()
            for j in range(shape[1])) <= tss.KCAP)


@pytest.mark.parametrize("name", ["fsbl", "rmps"])
def test_sharded_signatures_are_cstpu_without_axis_names(name):
    tfn, jfn = SOLVERS[name]
    want = [(p.name, p.kind, p.default)
            for p in inspect.signature(jfn).parameters.values()
            if p.name not in ("atoms_axis", "batch_axis")]
    got = [(p.name, p.kind, p.default)
           for p in inspect.signature(tfn).parameters.values()]
    assert got == want
