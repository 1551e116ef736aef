"""The convex loops' CUDA graphs (cstpu_torch.models.basis_pursuit._latched):
a block of CHECK_EVERY iterations is captured and replayed only where every
tensor of the loop lies on one card, and on that card.

The gate is a pure function of the loop's devices and is tested here on
the CPU. The `gpu` tests skip without a CUDA device; those that need two
cards (a solve on a card other than the current one, a mesh over several
cards) skip on a host with one. On a GPU machine (no JAX needed):

    python -m pytest tests/test_torch_graphs.py --noconftest -q

Tolerances: a graph replays the eager loop's kernels on the same buffers,
so graphs against eager is exact (0). One shard against several is f32
sums in another order: atol 1e-4, supports equal.
"""

import functools

import pytest
import torch

from cstpu_torch.models import basis_pursuit as cbp
from cstpu_torch.parallel import convex as pcv

ATOL_SHARDS = 1e-4
SUP = 1e-3


@pytest.mark.parametrize("devices, want", [
    (["cuda:0"], "cuda:0"),
    (["cuda:1", "cuda:1", "cuda:1"], "cuda:1"),
    (["cuda:0", "cuda:1"], None),          # a mesh over two cards
    (["cuda:1", "cuda:0", "cuda:0"], None),
    (["cpu"], None),
    (["cpu", "cuda:0"], None),
    (["cuda"], None),                      # no index: not known to be one card
    ([], None),
])
def test_graph_gate_takes_one_card_only(devices, want):
    got = cbp._graph_device([torch.device(d) for d in devices])
    assert got == (None if want is None else torch.device(want))


def test_cpu_loops_replay_no_graph():
    g = torch.Generator().manual_seed(0)
    A = torch.randn((16, 64), generator=g, dtype=torch.float64)
    x = torch.zeros(64, dtype=torch.float64)
    x[[3, 17, 40]] = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    cbp.LOOP_COUNTS.update(iterations=0, latch_reads=0, replays=0)
    got = cbp.bp(A, A @ x, maxiter=200)
    assert cbp.LOOP_COUNTS["iterations"] > cbp.CHECK_EVERY
    assert cbp.LOOP_COUNTS["replays"] == 0
    assert torch.isfinite(got).all()


# --- on the card -----------------------------------------------------------

def _cards(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs run only on the card")
    if torch.cuda.device_count() < k:
        pytest.skip(f"needs {k} CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False


def _problem(dev, n=128, m=1024, k=6, seed=0):
    import chip_smoke
    gen = torch.Generator(device=dev).manual_seed(seed)
    A, Bs, sup = chip_smoke.planted(gen, 1, n, m, k)
    return A, Bs[0], sup[0]


def _eager(fn):
    """fn() with every convex loop launched one kernel at a time."""
    saved = cbp._latched, pcv._latched
    cbp._latched = functools.partial(saved[0], graphs=False)
    pcv._latched = functools.partial(saved[1], graphs=False)
    try:
        return fn()
    finally:
        cbp._latched, pcv._latched = saved


def _replays(fn):
    cbp.LOOP_COUNTS.update(iterations=0, latch_reads=0, replays=0)
    out = fn()
    return out, cbp.LOOP_COUNTS["replays"]


def _solves(A, b):
    import cstpu_torch
    return {
        "bp": lambda: cstpu_torch.bp(A, b),
        "bpd admm": lambda: cstpu_torch.bpd(A, b, 1e-2, method="admm",
                                            on_infeasible="raw"),
        "bpd secant": lambda: cstpu_torch.bpd(A, b, 1e-2),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("key", ["bp", "bpd admm", "bpd secant"])
@pytest.mark.parametrize("card", [0, 1])
def test_graphs_equal_eager_on_each_card(key, card):
    """On the current card and on another one: the graph path replays and
    gives the eager loop's x exactly (a capture on the wrong card records
    nothing, and its replays would leave the state where it stood)."""
    _cards(card + 1)
    dev = torch.device("cuda", card)
    A, b, sup = _problem(dev)
    fn = _solves(A, b)[key]
    with torch.cuda.device(0):
        got, replays = _replays(fn)
        want = _eager(fn)
    assert replays > 0
    assert got.device == dev
    assert torch.equal(got, want), float((got - want).abs().max())
    assert set(sup.tolist()) <= set(
        torch.nonzero(got.abs() > SUP)[:, 0].tolist())


@pytest.mark.gpu
@pytest.mark.parametrize("key", ["bp_sharded", "bpd_sharded",
                                 "bpd_secant_sharded"])
def test_mesh_over_cards_runs_eagerly_and_agrees(key):
    """A sharded solve on a mesh over every card (up to four) runs no graph
    and gives, to ATOL_SHARDS, the x of the same shards on one card (the
    graph path), with the planted support."""
    _cards(2)
    from cstpu_torch import parallel
    s = min(torch.cuda.device_count(), 4)
    one = torch.device("cuda", 0)
    A, b, sup = _problem(one, m=4096)
    solve = getattr(parallel, key)
    kw = {} if key == "bp_sharded" else {"delta": 1e-2}

    def run(devices):
        out = solve(A, b, mesh=parallel.make_mesh((1, s), devices), **kw)
        return out[0] if isinstance(out, tuple) else out

    x1, r1 = _replays(lambda: run([one]))
    xs, rs = _replays(lambda: run([torch.device("cuda", j)
                                   for j in range(s)]))
    assert r1 > 0 and rs == 0, (r1, rs)
    assert xs.device == one
    assert float((xs - x1).abs().max()) <= ATOL_SHARDS
    assert set(sup.tolist()) <= set(
        torch.nonzero(xs.abs() > SUP)[:, 0].tolist())
