"""Shard-mesh helpers (PyTorch counterpart of cstpu.parallel.mesh).

Two axes, as in cstpu:

  * 'batch' - data parallelism over problem instances (independent rows)
  * 'atoms' - the dictionary A is column-sharded, each shard correlates its
    own atoms with the residual

cstpu runs its shards as the devices of one or more processes under
`shard_map`. The port's mesh is a `b x s` grid of shards, each with an
explicit `torch.device`; several shards may share a device, and on a
machine with one card all of them do. A shard of a dictionary that already
lies on its device is a column slice of it, not a copy.

A mesh from `make_mesh` is held by one process. A mesh from
`cstpu_torch.parallel.distributed.global_mesh` spans processes: `ranks`
says which process holds each shard, and each process holds and computes
only its own shards (`local`), the batch rows with a shard here (`rows`).

The mesh carries the collectives the sharded solvers need over the 'atoms'
axis (`all_gather`, `pmax`, `pmin`, `psum`) as methods over a list of this
process's shards' tensors of one batch row. State that cstpu replicates on
every shard (active sets, residuals) is computed once per batch row and
process, on the row's first device in the process, its home; a collective
brings its result there. Where a row spans processes, a collective first
exchanges the shards' tensors over `torch.distributed` and then stacks and
reduces them exactly as within one process, in shard order on the home
device: every process of the row gets the same bits, the same as the
one-process mesh with the same shard count gets on the same device type,
so that every process takes the same branch at every latch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A (batch, atoms) grid of shard devices, in one process or several.

    `ranks` (b tuples of s process ranks) is None for a mesh held by one
    process; `groups` holds, per batch row, the process group of the row's
    ranks (None for a row within one process) and `world` the group over
    every rank (gloo), both made once when the mesh is built. `stage`: the
    row groups are gloo, so CUDA tensors go through the host."""
    devices: tuple          # b tuples of s torch.device
    ranks: tuple | None = None
    rank: int = 0
    groups: tuple = ()
    world: object = None
    stage: bool = False

    @property
    def shape(self) -> dict:
        return {"batch": len(self.devices), "atoms": len(self.devices[0])}

    def local(self, row: int) -> tuple:
        """The atom-shard indices of batch row `row` held by this process,
        ascending."""
        if self.ranks is None:
            return tuple(range(len(self.devices[row])))
        return tuple(j for j, p in enumerate(self.ranks[row])
                     if p == self.rank)

    def rows(self) -> tuple:
        """The batch rows with a shard in this process."""
        return tuple(i for i in range(len(self.devices)) if self.local(i))

    def row_spans(self, row: int) -> bool:
        """Whether batch row `row`'s shards lie in more than one process."""
        return bool(self.groups) and self.groups[row] is not None

    def home(self, row: int) -> torch.device:
        """The device that holds batch row `row`'s replicated state in this
        process."""
        return self.devices[row][self.local(row)[0]]

    # collectives over the atoms axis: `xs` holds one tensor per shard of
    # batch row `row` in this process (in `local(row)` order), each on its
    # shard's device; the result lies on `home`

    def all_gather(self, xs, home, row: int = 0) -> torch.Tensor:
        """The row's shards' tensors stacked along a new leading axis in
        shard order, (s, ...)."""
        if self.row_spans(row):
            return self._exchange(xs, home, row)
        return torch.stack([x.to(home) for x in xs])

    def pmax(self, xs, home, row: int = 0) -> torch.Tensor:
        return torch.amax(self.all_gather(xs, home, row), dim=0)

    def pmin(self, xs, home, row: int = 0) -> torch.Tensor:
        return torch.amin(self.all_gather(xs, home, row), dim=0)

    def psum(self, xs, home, row: int = 0) -> torch.Tensor:
        return torch.sum(self.all_gather(xs, home, row), dim=0)

    def cat(self, xs, home, row: int = 0, dim: int = 0) -> torch.Tensor:
        """The row's shards' pieces concatenated along `dim` in shard order
        (a vector or matrix sharded with the atoms, whole)."""
        if self.row_spans(row):
            return torch.cat(self._exchange(xs, home, row).unbind(0), dim=dim)
        return torch.cat([x.to(home) for x in xs], dim=dim)

    def _exchange(self, xs, home, row: int) -> torch.Tensor:
        """`all_gather` across the row's processes: each sends its shards'
        tensors stacked (padded to the most shards a process holds), the
        result is every shard's tensor in shard order on `home`."""
        ranks = self.ranks[row]
        members = sorted(set(ranks))
        held = {p: [j for j, q in enumerate(ranks) if q == p]
                for p in members}
        most = max(len(js) for js in held.values())
        part = torch.stack([x.to(home) for x in xs])
        if len(xs) < most:
            part = torch.cat([part, part.new_zeros(
                (most - len(xs), *part.shape[1:]))])
        wire = part.cpu() if self.stage else part
        got = [torch.empty_like(wire) for _ in members]
        dist.all_gather(got, wire, group=self.groups[row])
        out = [None] * len(ranks)
        for p, g in zip(members, got):
            for c, j in enumerate(held[p]):
                out[j] = g[c]
        return torch.stack(out).to(home)

    # results of whole batch rows, gathered over the processes

    def _rows_everywhere(self) -> bool:
        """Whether every process holds a shard of every batch row (then each
        has every row's result already)."""
        if self.ranks is None:
            return True
        everyone = set(p for row in self.ranks for p in row)
        return all(set(row) == everyone for row in self.ranks)

    def cat_rows(self, parts: dict, home) -> torch.Tensor:
        """The batch rows' results concatenated along dim 0 in row order, on
        `home`. `parts` maps each row this process solved to its result, all
        of one shape; a row solved elsewhere comes from the process of its
        first shard."""
        if self._rows_everywhere():
            xs = [parts[i] for i in sorted(parts)]
            return xs[0] if len(xs) == 1 else torch.cat(
                [x.to(home) for x in xs])
        b = len(self.devices)
        like = next(iter(parts.values()))
        mine = like.new_zeros((b, *like.shape), device="cpu")
        for i, x in parts.items():
            if self.ranks[i][0] == self.rank:
                mine[i] = x.cpu()
        got = [torch.empty_like(mine)
               for _ in range(dist.get_world_size(self.world))]
        dist.all_gather(got, mine, group=self.world)
        return torch.cat([got[self._world_rank(self.ranks[i][0])][i]
                          for i in range(b)]).to(home)

    def objects_rows(self, parts: dict) -> list:
        """`cat_rows` for Python objects (iteration counts): one per batch
        row, in row order."""
        if self._rows_everywhere():
            return [parts[i] for i in sorted(parts)]
        got = [None] * dist.get_world_size(self.world)
        dist.all_gather_object(got, parts, group=self.world)
        return [got[self._world_rank(self.ranks[i][0])][i]
                for i in range(len(self.devices))]

    def _world_rank(self, rank: int) -> int:
        return dist.get_group_rank(self.world, rank)


def make_mesh(shape=None, devices=None) -> Mesh:
    """A mesh of `shape` = (batch shards, atom shards) over `devices`.

    `devices` defaults to every CUDA device; without one this raises, so
    that nothing runs on the CPU unasked (pass `devices=["cpu"]` for that).
    Default shape: all devices on the 'atoms' axis, batch = 1. When the
    shape asks for more shards than there are devices, the devices are
    handed out in turns, so several shards share one."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cstpu_torch: make_mesh found no CUDA device; pass "
                "devices=['cpu'] to build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (1, len(devices))
    b, s = (int(x) for x in shape)
    if b < 1 or s < 1:
        raise ValueError(f"make_mesh: shape {shape} must be positive")
    grid = tuple(tuple(devices[(i * s + j) % len(devices)] for j in range(s))
                 for i in range(b))
    return Mesh(grid)


@dataclass
class ShardedDictionary:
    """A dictionary cut into column shards over a mesh's 'atoms' axis:
    `shards[i][j]` (n, m / s) lies on `mesh.devices[i][j]`, and is None
    where another process holds it. Copies in a correlation dtype are made
    once per dtype and kept (`corr`)."""
    shards: tuple
    shape: tuple
    dtype: torch.dtype
    mesh: Mesh
    _corr: dict = field(default_factory=dict, repr=False)

    def corr(self, dtype) -> tuple:
        """The shards in `dtype`, cast shard by shard (no second full-size
        temporary); the shards themselves where the dtype is theirs."""
        if dtype not in self._corr:
            seen = {}   # batch rows that share a shard share its copy

            def cast(x):
                if x is None:
                    return None
                if id(x) not in seen:
                    seen[id(x)] = x.to(dtype)
                return seen[id(x)]

            self._corr[dtype] = tuple(tuple(cast(x) for x in row)
                                      for row in self.shards)
        return self._corr[dtype]


def place_columns(make_local, shape, mesh: Mesh) -> ShardedDictionary:
    """A dictionary of `shape` (n, m) cut into column shards over the
    'atoms' axis, each shard of this process made by `make_local(index)`
    (index: a tuple of slices into the whole) and moved to its device.
    Batch rows that share a device share the shard; the rest is never
    made."""
    n, m = shape
    s = mesh.shape["atoms"]
    if m % s:
        raise ValueError(f"m = {m} not divisible by atom shards {s}")
    ml = m // s
    placed = {}

    def place(j, dev):
        if (j, dev) not in placed:
            placed[(j, dev)] = torch.as_tensor(
                make_local((slice(None), slice(j * ml, (j + 1) * ml)))
            ).to(dev)
        return placed[(j, dev)]

    shards = tuple(
        tuple(place(j, dev) if j in mesh.local(i) else None
              for j, dev in enumerate(row))
        for i, row in enumerate(mesh.devices))
    dtype = next(iter(placed.values())).dtype
    return ShardedDictionary(shards, (n, m), dtype, mesh)


def shard_dictionary(A, mesh: Mesh) -> ShardedDictionary:
    """Cut A (n, m) into column shards over the 'atoms' axis, one per shard
    device of this process (replicated over the batch axis). A shard on A's
    own device is a view of A; batch rows that share a device share the
    shard."""
    return place_columns(lambda index: A[index], tuple(A.shape), mesh)


def shard_rows(x, mesh: Mesh) -> tuple:
    """Cut x, a dictionary (n, m) or a measurement (n,), into row slices
    over the 'atoms' axis, slice j on shard j of this process's first batch
    row (the cut of the row-sharded OMP); None where another process holds
    the shard. A slice on x's own device is a view of x."""
    s = mesh.shape["atoms"]
    n = x.shape[0]
    if n % s:
        raise ValueError(f"n = {n} not divisible by shards {s}")
    nl = n // s
    row = mesh.rows()[0]
    return tuple(x[j * nl:(j + 1) * nl].to(dev) if j in mesh.local(row)
                 else None for j, dev in enumerate(mesh.devices[row]))


def shard_batch(b, mesh: Mesh) -> tuple:
    """Cut measurements b (B, n) into row slices over the 'batch' axis,
    slice i on batch row i's home device (None for a row without a shard
    in this process); a single measurement (n,) is replicated."""
    return place_batch(lambda index: b[index], tuple(b.shape), mesh)


def place_batch(make_local, shape, mesh: Mesh) -> tuple:
    """`shard_batch` with each slice of this process made by
    `make_local(index)` (index: a tuple of slices into the whole)."""
    rows = mesh.shape["batch"]
    whole = tuple(slice(None) for _ in shape)
    if len(shape) != 2:
        return tuple(torch.as_tensor(make_local(whole)).to(mesh.home(i))
                     if mesh.local(i) else None for i in range(rows))
    if shape[0] % rows:
        raise ValueError(f"B = {shape[0]} not divisible by batch shards "
                         f"{rows}")
    per = shape[0] // rows
    return tuple(
        torch.as_tensor(make_local((slice(i * per, (i + 1) * per),
                                    slice(None)))).to(mesh.home(i))
        if mesh.local(i) else None for i in range(rows))
