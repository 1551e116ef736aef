"""The port's multi-process layer (cstpu_torch.parallel.distributed) over
meshes that span processes, against cstpu and against the one-process mesh.

The multi-process test spawns 2 processes (this file run as a script, the
worker below; it imports torch, numpy and cstpu_torch only), each with 2
CPU shard devices, joined over gloo on localhost: the counterpart of
tests/test_distributed.py. The parent draws cstpu's seeded problem
(sparse_data, perturb, PRNGKey 7; n=32, m=48, k=3, sigma=1e-2) and solves
it with cstpu's single-process omp, rmps and bp; the workers check the
port's sharded solvers over the process-spanning (1, 4) mesh against those
values with cstpu's tolerances (1e-9 on the OMP values in f64, 1e-6 on
RMPS and BP), and bit for bit against the same solver over the one-process
(1, 4) mesh, every sharded solver of cstpu_torch.parallel; the (2, 2) mesh,
whose batch rows each lie in one process, likewise. Each named check is
one test here.

The `gpu` test runs the same worker with one process per card over NCCL
on a host with two or more cards and skips with fewer. On a GPU machine
(no JAX needed; it compares with the one-process mesh only):

    python -m pytest tests/test_torch_distributed.py --noconftest -q -m gpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2
TIMEOUT_S = 300          # per worker; a worker takes ~15 s on an idle CPU
SIGMA = 1e-2
DELTA = 1e-2

# what cstpu's runner checks (tests/distributed_runner.py), then the port's
CSTPU_CHECKS = ("omp_selection_identity", "omp_planted_support",
                "omp_coefficients", "rmps_values", "rmps_support",
                "bp_support", "bp_values")
SOLVERS = ("omp_sharded", "omp_sharded_batched", "omp_sharded_rows",
           "omp_sharded_fused", "omp_sharded_fused_three",
           "mp_sharded_fused", "gomp_sharded_fused", "sp_sharded_fused",
           "ompr_sharded_fused", "fr_sharded_fused", "srr_sharded_fused",
           "rmp_sharded_fused", "foba_sharded_fused", "fsbl_sharded",
           "rmps_sharded", "bp_sharded", "bp_ard_sharded", "bpd_sharded",
           "bpd_candes_sharded", "bpd_ard_sharded", "bpd_secant_sharded",
           "ista_sharded", "fista_sharded")
# the checks of the GPU test, one process per card: a (1, 2) mesh
CARD_CHECKS = (("process_count", "idempotent_initialize",
                "mesh_spans_processes", "shard_global_callback",
                "convex_loop_eager", "greedy_launches_local")
               + tuple(f"same_as_one_process[{x}]" for x in SOLVERS))
PORT_CHECKS = CARD_CHECKS + tuple(
    f"same_as_one_process_2x2[{x}]" for x in
    ("omp_sharded_fused", "gomp_sharded_fused", "fr_sharded_fused",
     "rmps_sharded", "bp_sharded"))


# ---------------------------------------------------------------------------
# The worker: one process of the mesh
# ---------------------------------------------------------------------------

def _wide_problem(dtype):
    """A problem for the streaming solvers (a per-shard width that is a
    multiple of 128 at four shards): n=32, m=512, B=4, 3 planted ones a
    row, from numpy's seeded generator."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((32, 512))
    A /= np.linalg.norm(A, axis=0)
    sup = np.stack([rng.choice(512, 3, replace=False) for _ in range(4)])
    Bs = A[:, sup].sum(-1).T
    return torch.as_tensor(A, dtype=dtype), torch.as_tensor(Bs, dtype=dtype)


def _solves(A, b, Bs, A2, B2, mesh, sh):
    """Every sharded solver of cstpu_torch.parallel once over `mesh`; `sh`
    turns a whole tensor into its placed form for the mesh."""
    import cstpu_torch.parallel as par

    f32 = dict(corr_dtype=torch.float32)
    Ash, A2sh = sh(A, (None, "atoms")), sh(A2, (None, "atoms"))
    B2sh = sh(B2, ("batch", None))
    yield "omp_sharded", lambda: par.omp_sharded(Ash, b, 3, mesh)
    yield "omp_sharded_batched", lambda: par.omp_sharded(Ash, Bs, 3, mesh)
    yield "omp_sharded_rows", lambda: par.omp_sharded_rows(
        A[:, :12].repeat(4, 1), b.repeat(4), 3, mesh)
    yield "omp_sharded_fused", lambda: par.omp_sharded_fused(
        A2sh, B2sh, 3, mesh, return_iters=True, **f32)
    yield "omp_sharded_fused_three", lambda: par.omp_sharded_fused(
        A2sh, B2, 3, mesh, fuse_collectives=False, return_iters=True, **f32)
    yield "mp_sharded_fused", lambda: par.mp_sharded_fused(
        A2sh, B2, 6, mesh, **f32)
    yield "gomp_sharded_fused", lambda: par.gomp_sharded_fused(
        A2sh, B2, 2, 4, mesh, return_iters=True, **f32)
    yield "sp_sharded_fused", lambda: par.sp_sharded_fused(
        A2sh, B2, 3, mesh, maxiter=4, return_iters=True, **f32)
    yield "ompr_sharded_fused", lambda: par.ompr_sharded_fused(
        A2sh, B2, 3, mesh, return_iters=True, **f32)
    yield "fr_sharded_fused", lambda: par.fr_sharded_fused(
        A2sh, B2, 3, mesh, return_iters=True, **f32)
    yield "srr_sharded_fused", lambda: par.srr_sharded_fused(
        A2sh, B2, 3, mesh, maxiter=4, return_iters=True, **f32)
    yield "rmp_sharded_fused", lambda: par.rmp_sharded_fused(
        A2sh, B2, 1e-3, mesh, kmax=8, return_iters=True, **f32)
    yield "foba_sharded_fused", lambda: par.foba_sharded_fused(
        A2sh, B2, 1e-3, mesh, kmax=8, return_iters=True, **f32)
    yield "fsbl_sharded", lambda: par.fsbl_sharded(Ash, Bs, SIGMA ** 2, mesh)
    yield "rmps_sharded", lambda: par.rmps_sharded(Ash, Bs, SIGMA ** 2, mesh)
    yield "bp_sharded", lambda: par.bp_sharded(Ash, b, mesh=mesh)
    yield "bp_ard_sharded", lambda: par.bp_ard_sharded(
        Ash, b, mesh, maxiter=3, maxiter_admm=2000)
    y = Bs[1]
    yield "bpd_sharded", lambda: par.bpd_sharded(Ash, y, DELTA, mesh=mesh,
                                                 maxiter=500)
    yield "bpd_candes_sharded", lambda: par.bpd_candes_sharded(
        Ash, y, DELTA, mesh, maxiter=2, tol=1e-4)
    yield "bpd_ard_sharded", lambda: par.bpd_ard_sharded(
        Ash, y, DELTA, mesh, maxiter=2, tol=1e-4)
    yield "bpd_secant_sharded", lambda: par.bpd_secant_sharded(
        Ash, y, DELTA, mesh=mesh, return_info=True)
    yield "ista_sharded", lambda: par.ista_sharded(Ash, b, 1e-3, mesh,
                                                   maxiter=256)
    yield "fista_sharded", lambda: par.fista_sharded(Ash, b, 1e-3, mesh,
                                                     maxiter=256,
                                                     stepsize=None)


def _leaves(x):
    """The tensors and numbers of a result, in order, as CPU tensors."""
    if isinstance(x, torch.Tensor):
        return [x.detach().cpu()]
    if dataclasses.is_dataclass(x):
        return [y for f in dataclasses.fields(x)
                for y in _leaves(getattr(x, f.name))]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _leaves(v)]
    if isinstance(x, dict):
        return [y for key in sorted(x) for y in _leaves(x[key])]
    return [torch.as_tensor(float(x))] if isinstance(x, (int, float)) else []


def _bit_equal(a, b) -> bool:
    """Every tensor of two results of the same dtype and shape, entry by
    entry the same (a NaN where the other has a NaN)."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and (torch.equal(x, y) or (x.is_floating_point()
                                   and torch.equal(x.isnan(), y.isnan())
                                   and torch.equal(x.nan_to_num(),
                                                   y.nan_to_num())))
        for x, y in zip(la, lb))


def _worker(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--problem", default=None)   # cstpu's values (npz)
    ap.add_argument("--cards", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    import cstpu_torch.parallel as par
    from cstpu_torch.models import basis_pursuit as cbp
    from cstpu_torch.ops.fused_solve import LAUNCHES
    from cstpu_torch.parallel import distributed as dist
    from cstpu_torch.parallel.mesh import make_mesh

    checks = {}
    dist.initialize(f"localhost:{args.port}", args.world, args.rank)
    checks["process_count"] = (torch.distributed.get_world_size()
                               == args.world)
    dist.initialize()
    dist.initialize(f"localhost:{args.port}", args.world, args.rank)
    checks["idempotent_initialize"] = (torch.distributed.is_initialized()
                                       and torch.distributed.get_rank()
                                       == args.rank)

    if args.cards:      # one process per card, NCCL
        devices = None
        all_devices = [torch.device("cuda", i) for i in range(args.world)]
    else:               # two CPU shard devices a process, gloo
        devices = ["cpu", "cpu"]
        all_devices = ["cpu"]
    mesh = dist.global_mesh(devices=devices)
    s = mesh.shape["atoms"]
    checks["mesh_spans_processes"] = (
        {p for row in mesh.ranks for p in row} == set(range(args.world))
        and mesh.row_spans(0))
    home = mesh.home(0)
    dt = torch.float64

    if args.problem:
        prob = np.load(args.problem)
        A_np, b_np, y_np = prob["A"], prob["b"], prob["y"]
        planted = prob["planted"]
    else:
        rng = np.random.default_rng(7)
        A_np = rng.standard_normal((32, 48))
        A_np /= np.linalg.norm(A_np, axis=0)
        planted = np.sort(rng.choice(48, 3, replace=False))
        b_np = A_np[:, planted].sum(1)
        e = rng.standard_normal(32)
        y_np = b_np + e * (SIGMA / np.linalg.norm(e))
    A = torch.as_tensor(A_np, dtype=dt, device=home)
    b = torch.as_tensor(b_np, dtype=dt, device=home)
    Bs = torch.as_tensor(np.stack([b_np, y_np] * 2), dtype=dt, device=home)
    A2, B2 = (x.to(home) for x in _wide_problem(torch.float32))

    # the callback form: this process makes its own columns only
    asked = []

    def columns(index):
        asked.append(index)
        return A_np[index]

    A_sh = dist.shard_global(columns, mesh, (None, "atoms"),
                             global_shape=A_np.shape)
    ml = A_np.shape[1] // s
    mine = mesh.local(0)
    checks["shard_global_callback"] = (
        A_sh.shape == A_np.shape
        and sorted(ix[1].start // ml for ix in asked) == list(mine)
        and all((A_sh.shards[0][j] is None) == (j not in mine)
                for j in range(s))
        and all(np.array_equal(A_sh.shards[0][j].cpu().numpy(),
                               A_np[:, j * ml:(j + 1) * ml]) for j in mine))

    def placed(x, spec):
        return dist.shard_global(x, mesh, spec)

    # every sharded solver: the spanning mesh against the one-process one;
    # the streaming select launched once per shard of this process and step
    one = make_mesh((1, s), devices=all_devices)
    got = {}
    for (name, fn), (_, ref) in zip(
            _solves(A, b, Bs, A2, B2, mesh, placed),
            _solves(A, b, Bs, A2, B2, one, lambda x, spec: x)):
        LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
        got[name] = fn()
        if name == "omp_sharded_fused":
            steps = got[name][1][0]
            launched = {key: v for key, v in LAUNCHES.items() if v}
            # CPU tensors take the plain twins, which launch nothing
            checks["greedy_launches_local"] = launched == (
                {"select_stream": len(mine) * steps} if args.cards else {})
        checks[f"same_as_one_process[{name}]"] = _bit_equal(got[name], ref())

    if not args.cards:  # the (2, 2) mesh: each batch row in one process
        mesh22 = dist.global_mesh(batch_shards=2, devices=devices)
        one22 = make_mesh((2, 2), devices=all_devices)
        for (name, fn), (_, ref) in zip(
                _solves(A, b, Bs, A2, B2, mesh22,
                        lambda x, spec: dist.shard_global(x, mesh22, spec)),
                _solves(A, b, Bs, A2, B2, one22, lambda x, spec: x)):
            key = f"same_as_one_process_2x2[{name}]"
            if key in PORT_CHECKS:
                checks[key] = (not mesh22.row_spans(0)
                               and _bit_equal(fn(), ref()))

    # a loop over the spanning mesh never takes the CUDA-graph path: with
    # the graph gate forced open, the one-process mesh tries a graph, which
    # raises on the CPU, and the spanning mesh runs eagerly
    gate = cbp._graph_device
    cbp._graph_device = lambda devices: torch.device("cuda", 0)
    try:
        live = args.cards
        if not args.cards:
            try:
                par.bp_sharded(A, b, mesh=one, maxiter=200)
            except (RuntimeError, AssertionError):
                live = True
        cbp.LOOP_COUNTS.update(iterations=0, latch_reads=0, replays=0)
        z = par.bp_sharded(A_sh, b_np, mesh=mesh, maxiter=200)[0]
        checks["convex_loop_eager"] = (
            live and cbp.LOOP_COUNTS["iterations"] > cbp.CHECK_EVERY
            and cbp.LOOP_COUNTS["replays"] == 0
            and bool(torch.isfinite(z).all()))
    finally:
        cbp._graph_device = gate

    if args.problem:    # cstpu's own checks, with its tolerances
        sol = got["omp_sharded"]
        idx = np.sort(sol.idx[sol.mask].cpu().numpy())
        ref_idx = np.sort(prob["omp_idx"][prob["omp_mask"]])
        checks["omp_selection_identity"] = bool(np.array_equal(idx, ref_idx))
        checks["omp_planted_support"] = bool(np.array_equal(idx, planted))
        checks["omp_coefficients"] = bool(np.allclose(
            np.sort(sol.val.cpu().numpy()), np.sort(prob["omp_val"]),
            atol=1e-9))
        xs = got["rmps_sharded"].cpu().numpy()
        checks["rmps_values"] = bool(np.allclose(xs, prob["rmps"], atol=1e-6))
        checks["rmps_support"] = bool(np.array_equal(
            np.sort(np.flatnonzero(np.abs(xs[1]) > SIGMA)), planted))
        z = got["bp_sharded"][0].cpu().numpy()
        checks["bp_support"] = bool(np.array_equal(
            np.flatnonzero(np.abs(z) > 1e-5),
            np.flatnonzero(np.abs(prob["bp"]) > 1e-5)))
        checks["bp_values"] = bool(np.allclose(z, prob["bp"], atol=1e-6))

    with open(args.out, "w") as f:
        json.dump({"ok": all(checks.values()), "checks": checks}, f)
    torch.distributed.destroy_process_group()
    return 0 if all(checks.values()) else 1


# ---------------------------------------------------------------------------
# The parent: spawn the workers, read their checks
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(tmp, extra=()) -> list:
    """Run NPROC workers; their check payloads, or fail with their logs."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs, outs = [], []
    for rank in range(NPROC):
        out = tmp / f"rank{rank}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(rank),
             "--world", str(NPROC), "--port", str(port), "--out", str(out),
             *extra],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:     # the PIDs started here, nothing else
            p.kill()
        logs = [p.communicate()[0] for p in procs]
        pytest.fail("distributed workers timed out\n"
                    + "\n--- worker log ---\n".join(logs))
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode in (0, 1) and outs[rank].exists(), (
            f"worker {rank} exited {p.returncode}\n{log[-4000:]}")
    return [json.loads(out.read_text())["checks"] for out in outs]


@pytest.fixture(scope="module")
def cpu_checks(tmp_path_factory):
    """cstpu's values on its seeded problem, then the two CPU workers'
    checks."""
    import jax
    from cstpu import bp, omp, perturb, rmps, sparse_data

    tmp = tmp_path_factory.mktemp("dist")
    kd, kn = jax.random.split(jax.random.PRNGKey(7))
    A, x, b = sparse_data(kd, n=32, m=48, k=3)
    y = perturb(kn, b, SIGMA)
    A_np, b_np, y_np = (np.asarray(v, np.float64) for v in (A, b, y))
    sol = omp(A_np, b_np, 3)
    np.savez(tmp / "problem.npz", A=A_np, b=b_np, y=y_np,
             planted=np.sort(np.flatnonzero(np.abs(np.asarray(x)))),
             omp_idx=np.asarray(sol.idx), omp_mask=np.asarray(sol.mask),
             omp_val=np.asarray(sol.val),
             rmps=np.stack([np.asarray(rmps(A_np, bb, SIGMA ** 2))
                            for bb in np.stack([b_np, y_np] * 2)]),
             bp=np.asarray(bp(A_np, b_np)))
    return _spawn(tmp, ("--problem", str(tmp / "problem.npz")))


@pytest.mark.parametrize("check", CSTPU_CHECKS + PORT_CHECKS)
def test_two_processes_two_cpu_shards_each(cpu_checks, check):
    for rank, checks in enumerate(cpu_checks):
        assert checks.get(check) is True, (rank, check, checks)


def test_every_check_ran(cpu_checks):
    for checks in cpu_checks:
        assert set(checks) == set(CSTPU_CHECKS + PORT_CHECKS)


@pytest.mark.gpu
def test_one_process_per_card_over_nccl(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < NPROC:
        pytest.skip(f"needs {NPROC} CUDA devices: one process per card")
    checks = _spawn(tmp_path, ("--cards",))
    for rank, got in enumerate(checks):
        assert set(got) == set(CARD_CHECKS), got
        assert all(got.values()), (rank, got)


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------

def test_initialize_is_a_noop_in_one_process(monkeypatch):
    from cstpu_torch.parallel import distributed as dist

    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    dist.initialize()
    assert not torch.distributed.is_initialized()
    mesh = dist.initialize_and_mesh(devices=["cpu"] * 4, batch_shards=2)
    assert mesh.ranks is None and mesh.shape == {"batch": 2, "atoms": 2}
    assert mesh.rows() == (0, 1) and mesh.local(1) == (0, 1)


def test_initialize_reads_a_launchers_environment():
    # what torchrun sets, for a group of one; in a process of its own, so
    # that this one stays uninitialized
    code = ("import torch\n"
            "from cstpu_torch.parallel import distributed as dist\n"
            "dist.initialize()\n"
            "dist.initialize()\n"
            "assert torch.distributed.get_world_size() == 1\n"
            "mesh = dist.global_mesh(devices=['cpu'] * 2)\n"
            "assert mesh.ranks is None and mesh.shape['atoms'] == 2\n"
            "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="1", RANK="0")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.stdout.strip() == "OK", proc.stdout + proc.stderr


@pytest.mark.parametrize("args, match", [
    (("localhost:notaport", 2, 0), "Port"),
    (("localhost:70000", 2, 0), "[Pp]ort"),
    (("localhost:29400", 2, 2), "process_id 2"),
    (("localhost:29400", 2, None), "together"),
])
def test_a_failed_launch_raises(args, match):
    from cstpu_torch.parallel import distributed as dist

    with pytest.raises(ValueError, match=match):
        dist.initialize(*args)
    assert not torch.distributed.is_initialized()


def test_global_mesh_in_one_process():
    from cstpu_torch.parallel import distributed as dist

    assert dist.global_mesh(devices=["cpu"] * 4).shape == {"batch": 1,
                                                           "atoms": 4}
    assert dist.global_mesh(atoms_shards=2, devices=["cpu"] * 4).shape == {
        "batch": 2, "atoms": 2}
    with pytest.raises(ValueError, match="3 x 1 != 4 devices"):
        dist.global_mesh(3, 1, devices=["cpu"] * 4)


def test_shard_global_in_one_process():
    from cstpu_torch.parallel import distributed as dist

    mesh = dist.global_mesh(2, 2, devices=["cpu"] * 4)
    A = np.arange(24.0).reshape(3, 8)
    for make in (A, lambda index: A[index]):
        Ash = dist.shard_global(make, mesh, (None, "atoms"),
                                global_shape=A.shape)
        assert Ash.shape == (3, 8)
        assert Ash.shards[1][1].tolist() == A[:, 4:].tolist()
    for make in (A.T, lambda index: A.T[index]):
        rows = dist.shard_global(make, mesh, ("batch", None),
                                 global_shape=(8, 3))
        assert len(rows) == 2 and rows[1].tolist() == A.T[4:].tolist()
    v = dist.shard_global(np.ones(5), mesh, (None,))
    assert v.shape == (5,)
    with pytest.raises(ValueError, match="spec"):
        dist.shard_global(A, mesh, ("atoms", None))
    with pytest.raises(ValueError, match="global_shape"):
        dist.shard_global(lambda index: A[index], mesh, (None, "atoms"))


if __name__ == "__main__":
    try:
        sys.exit(_worker(sys.argv[1:]))
    except Exception:
        traceback.print_exc()
        sys.exit(2)
