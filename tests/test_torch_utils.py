"""cstpu_torch's solver configs, checkpoints and profiling
(cstpu_torch.utils.config, .checkpoint, .profiling) against cstpu's, on
the CPU.

Tolerances: configs, their JSON and the signature defaults are equal
exactly; a checkpoint round trip gives every leaf back bit for bit with
its dtype, on the template's device; the cost model and roofline numbers
equal cstpu's to 1e-12 relative (the same float arithmetic).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import cstpu
import cstpu_torch
from cstpu.utils import config as jcfg
from cstpu.utils import profiling as jprof
from cstpu_torch.ops import active_set
from cstpu_torch.utils import config as tcfg
from cstpu_torch.utils import profiling as tprof
from cstpu_torch.utils.checkpoint import load_state, save_state
from cstpu_torch.utils.interop import to_torch


def test_unknown_solver_rejected():
    with pytest.raises(KeyError):
        tcfg.solver_config("nope")


def test_unknown_parameter_rejected():
    with pytest.raises(TypeError, match="sparsityy"):
        tcfg.solver_config("fr", sparsityy=3)
    with pytest.raises(TypeError, match="epsilon"):
        tcfg.solver_config("bp_ard", epsilon=1e-2)


@pytest.mark.parametrize("solver,params", [
    ("omp", {"k": 8}), ("sp", {"k": 4, "delta": 1e-6}),
    ("bpd", {"delta": 1e-2, "method": "admm"}), ("exhaustive", {"k": 3}),
    ("omp", {"k": np.int64(8)}), ("ista", {"lam": np.float32(0.5)})])
def test_config_json_equals_cstpus(solver, params):
    got = tcfg.solver_config(solver, **params)
    want = jcfg.solver_config(solver, **params)
    assert got.to_json() == want.to_json()
    assert got.params == want.params
    back = tcfg.SolverConfig.from_json(got.to_json())
    assert back == got and hash(back) == hash(got)


def test_available_solvers_equal_cstpus():
    assert tcfg.available_solvers() == jcfg.available_solvers()


@pytest.mark.parametrize("solver",
                         jcfg.available_solvers()["single"])
def test_defaults_equal_cstpus(solver):
    assert tcfg.defaults(solver) == jcfg.defaults(solver)


def test_zero_d_tensor_params_serialize():
    cfg = tcfg.solver_config("omp", k=torch.tensor(8))
    assert cfg.to_json() == jcfg.solver_config("omp", k=8).to_json()


def test_run_and_run_batch_match_direct_calls():
    from cstpu import sparse_data

    A, x, b = sparse_data(jax.random.PRNGKey(7), n=32, m=64, k=3)
    At, bt = to_torch(A), to_torch(b)
    sol = tcfg.solver_config("omp", k=3).run(At, bt)
    ref = cstpu_torch.omp(At, bt, 3)
    assert torch.equal(sol.idx, ref.idx) and torch.equal(sol.val, ref.val)
    xb = tcfg.solver_config("bp").run(At, bt)
    assert torch.equal(xb, cstpu_torch.bp(At, bt))
    Bs = torch.stack([bt, 2.0 * bt])
    sols = tcfg.solver_config("omp", k=3).run_batch(At, Bs)
    assert sols.idx.shape[0] == 2
    with pytest.raises(KeyError, match="batched"):
        tcfg.solver_config("bp").run_batch(At, Bs)


def _states():
    n, k, m = 6, 4, 9
    g = torch.Generator().manual_seed(3)
    aset = active_set.empty(n, k, m, torch.float64)._replace(
        cols=torch.randn((n, k), generator=g, dtype=torch.float64),
        k=torch.tensor(2, dtype=torch.int32))
    sol = cstpu_torch.SparseSolution(
        idx=torch.tensor([1, 5, 9], dtype=torch.int32),
        val=torch.tensor([0.5, -1.25, 0.0], dtype=torch.float32),
        mask=torch.tensor([True, True, False]), m=9)
    tr = cstpu_torch.SolveTrace(
        residual_norm=torch.rand(4, generator=g, dtype=torch.float64),
        selected=torch.tensor([3, 1, -1, -1], dtype=torch.int32),
        accepted=torch.tensor([True, True, False, False]),
        score=torch.rand(4, generator=g))
    sbl = cstpu_torch.SBLTrace(
        likelihood_delta=torch.rand(5, generator=g),
        selected=torch.arange(5, dtype=torch.int32),
        action=torch.tensor([0, 0, 2, 1, -1], dtype=torch.int32),
        n_active=torch.tensor([1, 2, 2, 1, 1], dtype=torch.int32))
    return {"ActiveSet": aset, "SparseSolution": sol, "SolveTrace": tr,
            "SBLTrace": sbl}


def _leaves_equal(got, want):
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(got, want)
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _leaves_equal(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for key in want:
            _leaves_equal(got[key], want[key])
    elif isinstance(want, cstpu_torch.SparseSolution):
        assert type(got) is type(want) and got.m == want.m
        for f in ("idx", "val", "mask"):
            _leaves_equal(getattr(got, f), getattr(want, f))
    else:
        assert got == want


@pytest.mark.parametrize("name", ["ActiveSet", "SparseSolution",
                                  "SolveTrace", "SBLTrace"])
def test_checkpoint_round_trip(name, tmp_path):
    state = _states()[name]
    path = str(tmp_path / "state.pt")
    save_state(path, state)
    # the template's values do not matter, only its structure and devices
    like = type(state)(*[torch.zeros_like(x) for x in state]) \
        if isinstance(state, tuple) else state
    _leaves_equal(load_state(path, like), state)


def test_checkpoint_nested_tree(tmp_path):
    st = _states()
    tree = {"trace": st["SolveTrace"], "sol": st["SparseSolution"],
            "rest": (torch.ones(2, dtype=torch.float64), 3.5, [7])}
    path = str(tmp_path / "tree.pt")
    save_state(path, tree)
    _leaves_equal(load_state(path, tree), tree)
    with pytest.raises(ValueError, match="leaves"):
        load_state(path, {"trace": st["SolveTrace"]})


@pytest.mark.parametrize("args", [(64, 1024, 8192, 32), (8, 128, 512, 6, 2),
                                  (1, 32, 48, 3, 4, 3)])
def test_solve_cost_and_roofline_equal_cstpus(args):
    got, want = tprof.solve_cost(*args), jprof.solve_cost(*args)
    for f in ("flops", "hbm_bytes_fused", "hbm_bytes_loop", "steps",
              "batch"):
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=1e-12)
    for peaks in ((None, None), (989.0, 3350.0)):
        g = cstpu_torch.roofline_report(1.5e-3, got, *peaks)
        w = cstpu.roofline_report(1.5e-3, want, *peaks)
        assert g.keys() == w.keys()
        for key in g:
            assert g[key] == pytest.approx(w[key], rel=1e-12)
        assert tprof.format_report(g) == jprof.format_report(w)


def test_measured_stream_rate_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tprof.measured_stream_gbps(1 << 20)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as d:
        torch.ones(8).sum()
    with open(os.path.join(d, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
