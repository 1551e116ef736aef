"""Shard-mesh helpers (PyTorch counterpart of cstpu.parallel.mesh).

Two axes, as in cstpu:

  * 'batch' - data parallelism over problem instances (independent rows)
  * 'atoms' - the dictionary A is column-sharded, each shard correlates its
    own atoms with the residual

cstpu runs its shards as the devices of one process under `shard_map`. The
port's mesh is a `b x s` grid of shards held by one process, each with an
explicit `torch.device`; several shards may share a device, and on a
machine with one card all of them do. A shard of a dictionary that already
lies on its device is a column slice of it, not a copy.

The mesh carries the collectives the sharded solvers need over the 'atoms'
axis (`all_gather`, `pmax`, `pmin`, `psum`) as methods over a list of
per-shard tensors. State that cstpu replicates on every shard (active sets,
residuals) is computed once per batch row, on the row's first device, its
home; a collective brings its result there.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

@dataclass(frozen=True)
class Mesh:
    """A (batch, atoms) grid of shard devices."""
    devices: tuple          # b tuples of s torch.device

    @property
    def shape(self) -> dict:
        return {"batch": len(self.devices), "atoms": len(self.devices[0])}

    def home(self, row: int) -> torch.device:
        """The device that holds batch row `row`'s replicated state."""
        return self.devices[row][0]

    # collectives over the atoms axis: `xs` holds one tensor per shard of a
    # batch row, each on its shard's device; the result lies on `home`

    def all_gather(self, xs, home) -> torch.Tensor:
        """The shards' tensors stacked along a new leading axis, (s, ...)."""
        return torch.stack([x.to(home) for x in xs])

    def pmax(self, xs, home) -> torch.Tensor:
        return torch.amax(self.all_gather(xs, home), dim=0)

    def pmin(self, xs, home) -> torch.Tensor:
        return torch.amin(self.all_gather(xs, home), dim=0)

    def psum(self, xs, home) -> torch.Tensor:
        return torch.sum(self.all_gather(xs, home), dim=0)


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
    `shards[i][j]` (n, m / s) lies on `mesh.devices[i][j]`. Copies in a
    correlation dtype are made once per dtype and kept (`corr`)."""
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
                if id(x) not in seen:
                    seen[id(x)] = x.to(dtype)
                return seen[id(x)]

            self._corr[dtype] = tuple(tuple(cast(x) for x in row)
                                      for row in self.shards)
        return self._corr[dtype]


def shard_dictionary(A, mesh: Mesh) -> ShardedDictionary:
    """Cut A (n, m) into column shards over the 'atoms' axis, one per shard
    device (replicated over the batch axis). A shard on A's own device is a
    view of A; batch rows that share a device share the shard."""
    n, m = A.shape
    s = mesh.shape["atoms"]
    if m % s:
        raise ValueError(f"m = {m} not divisible by atom shards {s}")
    ml = m // s
    placed = {}

    def place(j, dev):
        if (j, dev) not in placed:
            placed[(j, dev)] = A[:, j * ml:(j + 1) * ml].to(dev)
        return placed[(j, dev)]

    shards = tuple(tuple(place(j, dev) for j, dev in enumerate(row))
                   for row in mesh.devices)
    return ShardedDictionary(shards, (n, m), A.dtype, mesh)


def shard_rows(x, mesh: Mesh) -> tuple:
    """Cut x, a dictionary (n, m) or a measurement (n,), into row slices
    over the 'atoms' axis, slice j on the first batch row's shard j (the cut
    of the row-sharded OMP). A slice on x's own device is a view of x."""
    s = mesh.shape["atoms"]
    n = x.shape[0]
    if n % s:
        raise ValueError(f"n = {n} not divisible by shards {s}")
    nl = n // s
    return tuple(x[j * nl:(j + 1) * nl].to(dev)
                 for j, dev in enumerate(mesh.devices[0]))


def shard_batch(b, mesh: Mesh) -> tuple:
    """Cut measurements b (B, n) into row slices over the 'batch' axis,
    slice i on batch row i's home device; a single measurement (n,) is
    replicated."""
    rows = mesh.shape["batch"]
    if b.ndim != 2:
        return tuple(b.to(mesh.home(i)) for i in range(rows))
    if b.shape[0] % rows:
        raise ValueError(f"B = {b.shape[0]} not divisible by batch shards "
                         f"{rows}")
    per = b.shape[0] // rows
    return tuple(b[i * per:(i + 1) * per].to(mesh.home(i))
                 for i in range(rows))
