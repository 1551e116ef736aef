"""Multi-process initialization and mesh construction (PyTorch counterpart
of cstpu.parallel.distributed).

One process per card (or per host), a global mesh over all processes'
devices, and the same `cstpu_torch.parallel` entry points: a batch row of
the mesh whose shards lie in several processes exchanges its shards'
tensors over `torch.distributed` at each collective and reduces them as
the one-process mesh does, so the result is the same bits in every
process (see cstpu_torch.parallel.mesh).

Typical launch (the same program in every process):

    torchrun --nproc-per-node 4 solve.py

    from cstpu_torch.parallel import distributed as dist
    mesh = dist.initialize_and_mesh(batch_shards=dp, atoms_shards=tp)
    A = dist.shard_global(make_columns, mesh, (None, "atoms"),
                          global_shape=(n, m))
    sol = omp_sharded_fused(A, Bs, k, mesh)

Without a launcher, pass coordinator_address/num_processes/process_id to
`initialize`. One process without either skips initialization and builds
the one-process mesh, so code written against this module runs unchanged
from one card to many.

Backends. The process group `initialize` starts is gloo: it carries the
mesh's bookkeeping and the gathering of whole results. The collectives of
the mesh's batch rows run on NCCL where every shard device is a card of
its own and every process holds one (NCCL refuses two processes on one
card), else on gloo, which stages CUDA tensors through the host.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from cstpu_torch.parallel.mesh import Mesh, make_mesh, place_batch, \
    place_columns

_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Start torch.distributed for a multi-process run: a no-op when it is
    already started or when one process runs without a launcher.

    With no arguments it reads a launcher's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, as `torchrun` sets them) and is a no-op
    without one. With arguments it joins the group at
    `tcp://coordinator_address` ("host:port") as `process_id` of
    `num_processes`. Unlike cstpu's, which falls back to independent
    one-process runs when the launch fails, a launch that was asked for
    and fails raises."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        if not all(k in os.environ for k in _LAUNCHER_ENV):
            return  # one process: the local mesh suffices
        dist.init_process_group("gloo", init_method="env://")
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize: pass coordinator_address, "
                         "num_processes and process_id together")
    num_processes, process_id = int(num_processes), int(process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"initialize: process_id {process_id} is not in "
                         f"[0, {num_processes})")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _own_card(rank: int) -> torch.device:
    """This process's card: LOCAL_RANK where a launcher set it, else the
    rank modulo the cards this host has; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "cstpu_torch: global_mesh found no CUDA device; pass "
            "devices=['cpu'] to build a mesh on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _factor(batch_shards, atoms_shards, ndev: int) -> tuple:
    """cstpu's defaults: every device an atom shard; one axis given, the
    other fills the devices."""
    if batch_shards is None and atoms_shards is None:
        batch_shards, atoms_shards = 1, ndev
    elif batch_shards is None:
        batch_shards = ndev // atoms_shards
    elif atoms_shards is None:
        atoms_shards = ndev // batch_shards
    if batch_shards * atoms_shards != ndev:
        raise ValueError(f"{batch_shards} x {atoms_shards} != {ndev} devices")
    return batch_shards, atoms_shards


def global_mesh(batch_shards: int | None = None,
                atoms_shards: int | None = None, devices=None) -> Mesh:
    """Mesh over ALL processes' devices, in rank order. Defaults: no batch
    sharding, every device an atom shard (the column-sharded dictionary of
    suite config 5).

    `devices` is this process's list of devices; it defaults to the
    process's own card (see `_own_card`) in a multi-process run and to
    every card in one process, and raises without a card (pass
    `devices=["cpu"]` for the CPU). Every process must call this, in the
    same order as its other collective calls: the mesh's process groups
    are made here."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        local = make_mesh(None, devices).devices[0]
        b, s = _factor(batch_shards, atoms_shards, len(local))
        return make_mesh((b, s), local)
    rank, world = dist.get_rank(), dist.get_world_size()
    local = [torch.device(d) for d in (devices or [_own_card(rank)])]
    coord = dist.new_group(backend="gloo")
    declared = [None] * world
    dist.all_gather_object(declared, (socket.gethostname(),
                                      [str(d) for d in local]), group=coord)
    flat = [(p, host, torch.device(d)) for p, (host, devs) in
            enumerate(declared) for d in devs]
    b, s = _factor(batch_shards, atoms_shards, len(flat))
    grid = [flat[i * s:(i + 1) * s] for i in range(b)]
    cards = [(host, d.index) for _, host, d in flat]
    nccl = (dist.is_nccl_available()
            and all(len(devs) == 1 for _, devs in declared)
            and all(d.type == "cuda" for _, _, d in flat)
            and len(set(cards)) == len(cards))
    if nccl:
        torch.cuda.set_device(local[0])
    groups = []
    for row in grid:
        members = sorted({p for p, _, _ in row})
        groups.append(dist.new_group(members, backend="nccl" if nccl
                                     else "gloo")
                      if len(members) > 1 else None)
    return Mesh(tuple(tuple(d for _, _, d in row) for row in grid),
                tuple(tuple(p for p, _, _ in row) for row in grid),
                rank, tuple(groups), coord, stage=not nccl)


def initialize_and_mesh(**kw) -> Mesh:
    initialize()
    return global_mesh(**kw)


def shard_global(make_local, mesh: Mesh, spec, global_shape=None):
    """Place a global array over the mesh without making it whole anywhere.

    `make_local` is either the whole array (a tensor or numpy array: each
    process cuts and places its own parts) or a callback `(index: tuple of
    slices) -> that part` (pass `global_shape`) that each process calls for
    its own shards only: every process makes just its own atom columns,
    the 1M-atom dictionary pattern of suite config 5. `spec` stands for
    cstpu's PartitionSpec:

      (None, "atoms")   a dictionary (n, m) -> a ShardedDictionary
      ("batch", None)   measurements (B, n) -> `shard_batch`'s row slices
      (None,)           a vector, replicated -> a tensor on the home device
                        of this process's first batch row
    """
    if callable(make_local):
        if global_shape is None:
            raise ValueError("shard_global: the callback form needs "
                             "global_shape")
        shape = tuple(int(x) for x in global_shape)
    else:
        whole = torch.as_tensor(make_local)
        shape = tuple(whole.shape)

        def make_local(index):
            return whole[index]
    spec = tuple(spec)
    if spec == (None, "atoms") and len(shape) == 2:
        return place_columns(make_local, shape, mesh)
    if spec == ("batch", None) and len(shape) == 2:
        return place_batch(make_local, shape, mesh)
    if spec == (None,) and len(shape) == 1:
        return torch.as_tensor(make_local((slice(None),))).to(
            mesh.home(mesh.rows()[0]))
    raise ValueError(f"shard_global: spec {spec} for shape {shape}; valid: "
                     "(None, 'atoms') and ('batch', None) for 2-D, (None,) "
                     "for 1-D")
