"""Column-sharded greedy pursuit over a mesh of shards (PyTorch counterpart
of cstpu.parallel.sharded): OMP, MP, GOMP, OMPR and SP on the streaming
select kernels, forward regression (FR), SRR, RMP and FoBa on the combined
rescaling-and-select kernel (`stream_select.fr_step_select`), the plain
`omp_sharded` they are verified against, and the row-sharded
`omp_sharded_rows` for a long measurement axis.

The dictionary A is column-sharded over the mesh's 'atoms' axis. Per step
every shard sweeps its own atoms with one streaming select
(cstpu_torch.ops.stream_select: the dictionary read, all the traffic, rides
the kernel) and the global selection is resolved from the shards' own
scores, the largest value first and the lowest global index on ties, so
the support does not depend on the shard count. Two forms of that merge,
as in cstpu:

  three collectives   gmax = pmax of the local bests, gidx = pmin of the
                      global indices where local == gmax, then the owning
                      shard reads the winning column from its
                      FULL-PRECISION shard and a masked psum broadcasts it;
  one all-gather      (`fuse_collectives`) every shard ships its local
                      best column with its (score, global index) in one
                      (n + 2)-lane payload, and the winner is resolved on
                      the gathered table. The index rides in a lane of
                      promote(A.dtype, f32): exact below 2^24 (f32) or 2^53
                      (f64); the default is on below that limit and an
                      explicit True beyond it raises.

The active-set append and the k x k refit run on the batched engine
(cstpu_torch.ops.active_set, `*_batched`), once per batch row on the row's
home device, where cstpu computes them replicated on every shard. The
'batch' axis splits the measurements into row slices that are solved
independently, one after the other. cstpu's `lax.while_loop` is a Python
loop here that reads `all(done)` once per step.

The forward-regression family keeps, per shard and on the shard's device,
the OLS rescaling of its own atoms, resc (B, m_local) f32, which
`fr_step_select` updates in place. What an append or a deletion does to it
is deferred to the next sweep: the previous append's scaled orthogonal
direction W with the atom to mark as active, a deletion's freed direction V
with the atom to restore (SRR), or is applied at once by one product over
the full-precision shard (RMP's and FoBa's deletions, which are rare). RMP
and FoBa nest loops that end on the data; each `lax.while_loop` of cstpu is
a Python loop that reads one flag per iteration, and with `return_iters`
the solvers report their sweeps and those reads.

`A` may be a tensor or the result of `shard_dictionary` (then no shard is
cut or cast twice); `Bs` a tensor or the result of `shard_batch`. Results
are gathered on the home device of this process's first batch row. Over a
mesh that spans processes each process sweeps its own shards (their global
indices place their atoms) and solves the batch rows it has a shard of,
and every process returns the whole result.

Shape limits. What remains of cstpu's: m divisible by the atom shards, B
by the batch shards, a per-shard atom width that is a multiple of 128 with
a streamable tile (`stream_select._stream_tile`, which defines the NaN
rule). GOMP's l and the k of SP's, OMPR's and SRR's top-k may be any
size, on the card too (past 128 the top-l select's finish takes its wide
route). Dropped, because only the TPU's tiling needed them: n % 8 == 0 and
a per-shard batch that is a multiple of 8.

With `return_iters` the solvers whose loops end on the data (OMP, GOMP,
SP, OMPR, FR, SRR) also return the steps or outer iterations each batch row
ran; RMP and FoBa return `{"sweeps": ..., "flag_reads": ...}` per batch row.

Every `*_sharded_fused` has a twin `*_sharded_fused_ref` that runs the same
body on the selects' plain versions; on CPU tensors both are the same.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from cstpu_torch.ops import active_set as aset
from cstpu_torch.ops import stream_select as ss
from cstpu_torch.ops.fused_solve import _degeneracy_rtol
from cstpu_torch.ops.util import cholesky_nan, true_f32
from cstpu_torch.parallel.mesh import Mesh, ShardedDictionary, shard_batch, \
    shard_dictionary, shard_rows
from cstpu_torch.utils.sparse import SparseSolution

INT_MAX = torch.iinfo(torch.int32).max

# Exact integer range of the fused payload's index lane.
_F32_EXACT_INT = 1 << 24
_F64_EXACT_INT = 1 << 53


class _Selects(NamedTuple):
    """The four streaming selects a body calls."""
    top1: object
    topl: object
    masked: object
    fr_step: object


_KERNELS = _Selects(ss.correlate_select_stream,
                    ss.correlate_select_topl_stream,
                    ss.correlate_select_masked_stream,
                    ss.fr_step_select)
_PLAIN = _Selects(ss.correlate_select_stream_ref,
                  ss.correlate_select_topl_stream_ref,
                  ss.correlate_select_masked_stream_ref,
                  ss.fr_step_select_ref)


class _Row(NamedTuple):
    """One batch row's shards in this process: their global shard indices,
    devices, full-precision and correlation-dtype dictionary shards, and
    what resolves a selection across the row's shards."""
    mesh: Mesh
    i: int              # the batch row
    js: tuple           # this process's shards of the row, ascending
    home: torch.device
    devs: tuple
    A: tuple            # the shards (n, m_local) in the dictionary's dtype
    Ac: tuple           # the same in the correlation dtype
    m_local: int
    sel: _Selects
    fuse: bool

    def all_gather(self, xs):
        return self.mesh.all_gather(xs, self.home, self.i)

    def pmax(self, xs):
        return self.mesh.pmax(xs, self.home, self.i)

    def pmin(self, xs):
        return self.mesh.pmin(xs, self.home, self.i)

    def psum(self, xs):
        return self.mesh.psum(xs, self.home, self.i)


def _rows(mesh: Mesh, Ash: ShardedDictionary, Acs, sel: _Selects,
          fuse: bool, which=None) -> tuple:
    """A `_Row` for each batch row in `which` (default: every row with a
    shard in this process)."""
    ml = Ash.shape[1] // mesh.shape["atoms"]
    rows = []
    for i in (mesh.rows() if which is None else which):
        js = mesh.local(i)
        rows.append(_Row(mesh, i, js, mesh.home(i),
                         tuple(mesh.devices[i][j] for j in js),
                         tuple(Ash.shards[i][j] for j in js),
                         tuple(Acs[i][j] for j in js), ml, sel, fuse))
    return tuple(rows)


def _payload_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def _payload_exact_limit(dtype) -> int:
    """Largest atom count whose global index rides exactly in a payload
    lane of promote(dtype, f32)."""
    return (_F32_EXACT_INT if _payload_dtype(dtype) == torch.float32
            else _F64_EXACT_INT)


def _resolve_fuse(fuse, m: int, dtype, entry: str) -> bool:
    """Shared fuse_collectives gate: default ON where the index rides
    exactly in the payload dtype; explicit True beyond that is an error."""
    limit = _payload_exact_limit(dtype)
    if fuse is None:
        return m < limit
    if fuse and m >= limit:
        raise ValueError(
            f"{entry}: fuse_collectives needs m < 2^"
            f"{limit.bit_length() - 1} for "
            f"{str(dtype).replace('torch.', '')} payloads, got m = {m}")
    return bool(fuse)


def _require_stream_ok(n: int, m_local: int, B: int, b_shards: int,
                       corr_dtype, entry: str) -> None:
    """Fail up front with the real constraint: a batch the batch shards
    divide, and a 128-multiple per-shard atom width with one tile inside
    the 8 MB budget of `_stream_tile`."""
    name = str(corr_dtype).replace("torch.", "")
    if corr_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{entry}: corr_dtype must be torch.bfloat16 or "
                         f"torch.float32, got {corr_dtype}")
    itemsize = torch.empty((), dtype=corr_dtype).element_size()
    if (B % b_shards or m_local % 128
            or ss._stream_tile(m_local, n, itemsize,
                               ss.STREAM_TILE_BYTES) == 0):
        raise ValueError(
            f"{entry}: unsupported shard shape (n={n}, per-shard atom "
            f"width {m_local}, B={B} over {b_shards} batch shards, "
            f"{name}) — needs a batch that the batch shards divide and a "
            "per-shard atom width that is a multiple of 128 with one tile "
            "inside the 8 MB tile budget")


def _setup(A, Bs, mesh: Mesh, corr_dtype, fuse, sel: _Selects, entry: str):
    """Checks shared by the fused entry points, then one `_Row` and one
    measurement slice per batch row. Returns (rows, slices, n, m)."""
    if not isinstance(A, (torch.Tensor, ShardedDictionary)):
        A = torch.as_tensor(A)
    n, m = A.shape
    s, b = mesh.shape["atoms"], mesh.shape["batch"]
    if m % s:
        raise ValueError(f"m = {m} not divisible by atom shards {s}")
    # the gate comes before the shape checks, so that the payload error
    # fires on (shape, dtype) alone
    fuse = _resolve_fuse(fuse, m, A.dtype, entry)
    if isinstance(Bs, (tuple, list)):
        slices = tuple(Bs)
        held = [x.shape[0] for x in slices if x is not None]
        B = sum(held) * b // max(len(held), 1)
        if len(slices) != b:
            raise ValueError(f"{entry}: {len(slices)} measurement slices "
                             f"for {b} batch shards")
    else:
        Bs = torch.as_tensor(Bs)
        if Bs.ndim != 2:
            raise ValueError(f"{entry}: Bs must be batched (B, n), got "
                             f"shape {tuple(Bs.shape)}")
        B, slices = Bs.shape[0], None
    _require_stream_ok(n, m // s, B, b, corr_dtype, entry)
    if isinstance(A, ShardedDictionary):
        if A.mesh.devices != mesh.devices:
            raise ValueError(f"{entry}: the dictionary was sharded over "
                             "another mesh")
        Ash = A
    else:
        Ash = shard_dictionary(A, mesh)
    if slices is None:
        slices = shard_batch(Bs, mesh)
    rows = _rows(mesh, Ash, Ash.corr(corr_dtype), sel, fuse)
    slices = tuple(slices[row.i].to(row.home, Ash.dtype) for row in rows)
    return rows, slices, n, m


def _cat_rows(rows, xs):
    """Per-row tensors of the rows this process solved as every batch
    row's, concatenated on the first row's home device."""
    return rows[0].mesh.cat_rows({row.i: x for row, x in zip(rows, xs)},
                                 rows[0].home)


def _cat_solutions(rows, out, return_iters: bool = False):
    """The batch rows' (solution, iterations) as one solution, on the first
    row's home device; with `return_iters` also the rows' iteration
    counts."""
    sols = [sol for sol, _ in out]
    sol = SparseSolution(
        idx=_cat_rows(rows, [x.idx for x in sols]),
        val=_cat_rows(rows, [x.val for x in sols]),
        mask=_cat_rows(rows, [x.mask for x in sols]), m=sols[0].m)
    if not return_iters:
        return sol
    return sol, rows[0].mesh.objects_rows(
        {row.i: it for row, (_, it) in zip(rows, out)})


# --------------------------------------------------------------------------
# Merging the shards' selections
# --------------------------------------------------------------------------

def _sweep(row: _Row, select, r, *extra):
    """`select` on every shard of the row in this process: lists of local
    (val, idx), one a shard."""
    out = [select(Ac, r.to(dev), *(x[j] for x in extra))
           for j, (Ac, dev) in enumerate(zip(row.Ac, row.devs))]
    return [v for v, _ in out], [i for _, i in out]


def _global_idx(row: _Row, lidxs):
    """Local atom indices -> global ones, shard * m_local + lidx, i32."""
    return [j * row.m_local + li.to(torch.int32)
            for j, li in zip(row.js, lidxs)]


def _bcast_cols(row: _Row, gsel):
    """Owner-gathers-then-psum broadcast of the selected columns: the
    owning shard reads its full-precision columns (an indexed read),
    everyone psums. Returns (cols (B, n) at home, owners: a (B,) mask for
    each shard of this process)."""
    parts, owners = [], []
    for j, A_local, dev in zip(row.js, row.A, row.devs):
        g = gsel.to(dev)
        owner = (g // row.m_local) == j
        lcol = A_local[:, (g % row.m_local).long()].T
        parts.append(torch.where(owner[:, None], lcol, 0))
        owners.append(owner)
    return row.psum(parts), owners


def _select_bcast_fused(row: _Row, lvals, lidxs):
    """One collective per step instead of three: every shard ships its
    local-best COLUMN with its (score, global index) in a single
    all-gather of (B, n + 2) payloads; the winner (max value, lowest
    global index) is resolved on the gathered table. The payload rides in
    promote(A.dtype, f32), so the shipped column keeps the dictionary's
    full precision. Returns (cols (B, n), gsel (B,) i32, vmax (B,))."""
    n = row.A[0].shape[0]
    pdt = _payload_dtype(row.A[0].dtype)
    payloads = []
    for A_local, lval, lidx, gidx in zip(row.A, lvals, lidxs,
                                         _global_idx(row, lidxs)):
        lcol = A_local[:, lidx.long()].T.to(pdt)               # (B, n)
        payloads.append(torch.cat(
            [lcol, lval.to(pdt)[:, None], gidx.to(pdt)[:, None]], dim=1))
    allp = row.all_gather(payloads)                             # (s, B, n+2)
    vals, idxs = allp[:, :, n], allp[:, :, n + 1]
    vmax = torch.amax(vals, dim=0)
    # the sentinel exceeds every valid index in either payload dtype
    isel = torch.amin(torch.where(vals == vmax, idxs, float(INT_MAX)), dim=0)
    win = ((vals == vmax) & (idxs == isel)).to(pdt)
    cols = torch.einsum("sb,sbn->bn", win, allp[:, :, :n])
    return cols.to(row.A[0].dtype), isel.to(torch.int32), vmax


def _select_top1(row: _Row, lvals, lidxs):
    """Resolve the shards' top-1 candidates: (col (B, n), gsel (B,) i32,
    gmax (B,), owners or None), by the row's collective form."""
    if row.fuse:
        return (*_select_bcast_fused(row, lvals, lidxs), None)
    gmax = row.pmax(lvals)
    cands = [torch.where(lv == gmax.to(lv.device), gi, INT_MAX)
             for lv, gi in zip(lvals, _global_idx(row, lidxs))]
    gsel = row.pmin(cands)
    col, owners = _bcast_cols(row, gsel)
    return col, gsel, gmax, owners


def _merge_topl(row: _Row, lvals, gidxs, ll: int):
    """All-gather the per-shard top-l candidates (B, l) and select the
    global top-`ll`, value-descending with lowest-global-index ties.
    Returns ll (B,) index tensors, best first."""
    B = lvals[0].shape[0]
    av = row.all_gather(lvals).movedim(0, 1).reshape(B, -1)
    ai = row.all_gather(gidxs).movedim(0, 1).reshape(B, -1)
    sels = []
    for _ in range(ll):
        gmax = torch.amax(av, dim=1, keepdim=True)
        sel = torch.amin(torch.where(av == gmax, ai, INT_MAX), dim=1,
                         keepdim=True)
        av = torch.where(ai == sel, -torch.inf, av)
        sels.append(sel[:, 0])
    return sels


def _merge_topl_bcast_fused(row: _Row, lvals, lidxs, ll: int):
    """Fused top-l selection + column broadcast in ONE all-gather of
    (B, ll, n + 2) payloads; the global top-`ll` is resolved on the
    gathered table in `_merge_topl`'s order. Returns (gsels: ll (B,) i32,
    cols: ll (B, n)), best first."""
    n = row.A[0].shape[0]
    B = lvals[0].shape[0]
    dtype = row.A[0].dtype
    pdt = _payload_dtype(dtype)
    payloads = []
    for A_local, lval, lidx, gidx in zip(row.A, lvals, lidxs,
                                         _global_idx(row, lidxs)):
        lcols = A_local[:, lidx.long()].movedim(0, 2).to(pdt)   # (B, ll, n)
        payloads.append(torch.cat(
            [lcols, lval.to(pdt)[:, :, None], gidx.to(pdt)[:, :, None]],
            dim=2))
    allp = row.all_gather(payloads)                         # (s, B, ll, n+2)
    allp = allp.movedim(0, 1).reshape(B, -1, n + 2)         # (B, s*ll, n+2)
    av, ai = allp[:, :, n], allp[:, :, n + 1]
    gsels, cols = [], []
    for _ in range(ll):
        gmax = torch.amax(av, dim=1, keepdim=True)
        sel = torch.amin(torch.where(av == gmax, ai, float(INT_MAX)), dim=1,
                         keepdim=True)
        win = (ai == sel).to(pdt)                           # (B, s*ll)
        cols.append(torch.einsum("bs,bsn->bn", win,
                                 allp[:, :, :n]).to(dtype))
        gsels.append(sel[:, 0].to(torch.int32))
        av = torch.where(ai == sel, -torch.inf, av)
    return gsels, cols


def _select_topl(row: _Row, r, ll: int):
    """One top-l sweep per shard and the merge: (gsels, cols), ll each."""
    lvals, lidxs = _sweep(row, partial(row.sel.topl, l=ll), r)
    if row.fuse:
        return _merge_topl_bcast_fused(row, lvals, lidxs, ll)
    gsels = _merge_topl(row, lvals, _global_idx(row, lidxs), ll)
    return gsels, [_bcast_cols(row, gsel)[0] for gsel in gsels]


# --------------------------------------------------------------------------
# OMP
# --------------------------------------------------------------------------

def _omp_steps(row: _Row, Bs, k: int, eps: float, m: int, select_col):
    """The batched OMP loop over one batch row; `select_col(r)` returns the
    step's (col (B, n), gsel (B,)). Returns (solution, steps run)."""
    B, n = Bs.shape
    cap = min(n, k)
    st = aset.empty_batched(B, n, k, m, Bs.dtype, row.home)
    done = torch.zeros((B,), dtype=torch.bool, device=row.home)
    steps = 0
    for t in range(k):
        if t and bool(done.all()):
            break
        steps += 1
        col, gsel = select_col(aset.residual_batched(st, Bs))
        present = aset.contains_batched(st, gsel)
        full = st.k >= cap
        ok = ~present & ~full & ~done
        st = aset.refit_batched(
            aset.append_col_gated_batched(col, Bs, st, gsel, ok))
        r2 = aset.residual_batched(st, Bs)
        done = done | present | full | (torch.linalg.norm(r2, dim=1) < eps)
    return aset.finalize_batched(st, m), steps


def _omp_fused_row(row: _Row, Bs, k: int, eps: float, m: int):
    """Batched OMP over a batch row's shards: per step one streaming select
    per shard, the merge, the exact column from the owning shard, then the
    gated append and the refit on the batched engine."""
    def select_col(r):
        col, gsel, _, _ = _select_top1(row, *_sweep(row, row.sel.top1, r))
        return col, gsel
    return _omp_steps(row, Bs, k, eps, m, select_col)


def omp_sharded_fused(A, Bs, k: int, mesh: Mesh, max_residual: float = 0.0,
                      corr_dtype=torch.bfloat16,
                      fuse_collectives: bool | None = None,
                      return_iters: bool = False, *,
                      _select: _Selects = _KERNELS):
    """Column-sharded batched OMP on the per-shard streaming select kernel,
    the path for dictionaries beyond one kernel's reach. `Bs` is batched
    (B, n). Deterministic selection with lowest-global-index ties;
    identical to `omp` whenever selection margins exceed the corr_dtype's
    noise floor. Returns a batched SparseSolution of width k."""
    rows, slices, n, m = _setup(A, Bs, mesh, corr_dtype, fuse_collectives,
                                _select, "omp_sharded_fused")
    k = int(min(k if k is not None else n, n, m))
    return _cat_solutions(rows, [
        _omp_fused_row(row, b, k, float(max_residual), m)
        for row, b in zip(rows, slices)], return_iters)


def omp_sharded(A, b, k: int, mesh: Mesh, max_residual: float = 0.0):
    """OMP with the dictionary column-sharded over the 'atoms' axis, on
    plain tensor operations in the dictionary's own precision: the
    reference the fused solvers are verified against. `b` may be one
    measurement (n,) or a batch (B, n); batches are split over the 'batch'
    axis. Semantics of `omp` (deterministic collective argmax)."""
    if not isinstance(A, (torch.Tensor, ShardedDictionary)):
        A = torch.as_tensor(A)
    n, m = A.shape
    k = int(min(k if k is not None else n, n, m))
    s = mesh.shape["atoms"]
    if m % s:
        raise ValueError(f"m = {m} not divisible by atom shards {s}")
    Ash = shard_dictionary(A, mesh) if isinstance(A, torch.Tensor) else A
    b = torch.as_tensor(b)
    batched = b.ndim == 2
    if batched:
        rows = _rows(mesh, Ash, Ash.shards, _PLAIN, False)
        slices = shard_batch(b, mesh)
        slices = [slices[row.i] for row in rows]
    else:
        # one instance: each process solves it on its first batch row (the
        # batch axis replicates it)
        rows = _rows(mesh, Ash, Ash.shards, _PLAIN, False, mesh.rows()[:1])
        slices = [b[None]]

    def solve(row, bb):
        def select_col(r):
            lvals, lidxs = [], []
            for A_local, dev in zip(row.A, row.devs):
                lv, li = torch.max(torch.abs(r.to(dev) @ A_local), dim=1)
                lvals.append(lv)
                lidxs.append(li)
            col, gsel, _, _ = _select_top1(row, lvals, lidxs)
            return col, gsel

        return _omp_steps(row, bb.to(row.home, Ash.dtype), k,
                          float(max_residual), m, select_col)

    out = [solve(row, bb) for row, bb in zip(rows, slices)]
    if batched:
        return _cat_solutions(rows, out)
    sol = out[0][0]
    return SparseSolution(sol.idx[0], sol.val[0], sol.mask[0], sol.m)


# --------------------------------------------------------------------------
# MP
# --------------------------------------------------------------------------

def _mp_fused_row(row: _Row, Bs, k: int):
    """Batched matching pursuit over a batch row's shards: the coefficient
    vector stays SHARDED with the atoms (each shard owns x for its columns,
    updated in place). Shards are merged on the kernel's own scores, so the
    selection does not depend on the shard count; the accepted coefficient
    is computed in full precision from the broadcast column."""
    B = Bs.shape[0]
    ml = row.m_local
    xs = [torch.zeros((B, ml), dtype=Bs.dtype, device=dev)
          for dev in row.devs]
    r = Bs.clone()
    for _ in range(k):
        col, gsel, _, owners = _select_top1(
            row, *_sweep(row, row.sel.top1, r))
        p = torch.sum(r * col, dim=1)                            # signed
        for c, (j, x, dev) in enumerate(zip(row.js, xs, row.devs)):
            g = gsel.to(dev)
            owner = owners[c] if owners is not None else (g // ml) == j
            # a shard that does not own the atom adds 0 somewhere
            x.scatter_add_(1, (g % ml).long()[:, None],
                           torch.where(owner, p.to(dev), 0)[:, None])
        r = r - p[:, None] * col
    return row.mesh.cat(xs, row.home, row.i, dim=1)


def mp_sharded_fused(A, Bs, k: int, mesh: Mesh, corr_dtype=torch.bfloat16,
                     fuse_collectives: bool | None = None, *,
                     _select: _Selects = _KERNELS):
    """Column-sharded batched matching pursuit on the streaming select
    kernel. During the solve the coefficients are sharded as the atoms
    are; the dense (B, m) result is their concatenation on the first batch
    row's home device. Semantics of `mp` (k fixed updates)."""
    rows, slices, n, m = _setup(A, Bs, mesh, corr_dtype, fuse_collectives,
                                _select, "mp_sharded_fused")
    return _cat_rows(rows, [_mp_fused_row(row, b, int(k))
                            for row, b in zip(rows, slices)])


# --------------------------------------------------------------------------
# GOMP
# --------------------------------------------------------------------------

def _gomp_fused_row(row: _Row, Bs, l: int, k: int, eps: float, m: int):
    """Batched GOMP over a batch row's shards: per outer step one top-l
    sweep per shard, the merge of the s * l candidates, l gated appends and
    one refit. Parity: cstpu.models.matching_pursuit._gomp."""
    B, n = Bs.shape
    cap = min(n, k)
    st = aset.empty_batched(B, n, k, m, Bs.dtype, row.home)

    def group_step(st, ll, gate):
        gsels, cols = _select_topl(row, aset.residual_batched(st, Bs), ll)
        notfull = st.k < n
        for gsel, col in zip(gsels, cols):
            present = aset.contains_batched(st, gsel)
            # `gate` carries the per-row done latch: converged rows stop
            # acquiring while the batch loop runs until ALL rows are done
            ok = gate & ~present & (st.k < cap) & notfull
            st = aset.append_col_gated_batched(col, Bs, st, gsel, ok)
        return aset.refit_batched(st), notfull

    done = torch.zeros((B,), dtype=torch.bool, device=row.home)
    steps = 0
    for t in range(k // l):
        if t and bool(done.all()):
            break
        steps += 1
        st, notfull = group_step(st, l, ~done)
        r2 = aset.residual_batched(st, Bs)
        done = done | ~notfull | (torch.linalg.norm(r2, dim=1) < eps)
    if k % l:  # unconditional remainder step, as in the reference
        steps += 1
        st, _ = group_step(st, k % l, torch.ones_like(done))
    return aset.finalize_batched(st, m), steps


def gomp_sharded_fused(A, Bs, l: int, k: int, mesh: Mesh,
                       max_residual: float = 0.0, corr_dtype=torch.bfloat16,
                       fuse_collectives: bool | None = None,
                       return_iters: bool = False, *,
                       _select: _Selects = _KERNELS):
    """Column-sharded batched GOMP on the per-shard streaming top-l kernel
    (any l). Semantics of `gomp`."""
    rows, slices, n, m = _setup(A, Bs, mesh, corr_dtype, fuse_collectives,
                                _select, "gomp_sharded_fused")
    k = int(min(k if k is not None else m, m))
    return _cat_solutions(rows, [
        _gomp_fused_row(row, b, int(l), k, float(max_residual), m)
        for row, b in zip(rows, slices)], return_iters)


# --------------------------------------------------------------------------
# SP
# --------------------------------------------------------------------------

def _prune_to_k(st: aset.ActiveSet, b, k: int, m: int) -> aset.ActiveSet:
    """Keep every row's k largest-|coefficient| slots, rebuilding the state
    from the CACHED columns (no dictionary access: a shard does not hold
    the other shards' atoms). Equal scores keep the lower slot."""
    B, n, kmax = st.cols.shape
    dev, dtype = st.cols.device, st.cols.dtype
    scores = torch.where(st.mask, torch.abs(st.coef), -torch.inf)
    keep = torch.sort(scores, dim=1, descending=True,
                      stable=True).indices[:, :k]
    pad = kmax - k
    mask = torch.cat([st.mask.gather(1, keep),
                      torch.zeros((B, pad), dtype=torch.bool, device=dev)],
                     dim=1)
    idx = torch.cat([st.idx.gather(1, keep),
                     torch.full((B, pad), m, dtype=torch.int32, device=dev)],
                    dim=1)
    cols = torch.cat([st.cols.gather(2, keep[:, None, :].expand(B, n, k)),
                      torch.zeros((B, n, pad), dtype=dtype, device=dev)],
                     dim=2)
    cols = cols * mask[:, None, :].to(dtype)
    eye = torch.eye(kmax, dtype=dtype, device=dev)
    G = torch.where(mask[:, :, None] & mask[:, None, :],
                    cols.transpose(1, 2) @ cols, eye)
    st2 = aset.ActiveSet(
        idx=torch.where(mask, idx, m).to(torch.int32),
        mask=mask,
        k=mask.sum(dim=1).to(torch.int32),
        cols=cols, G=G, Ginv=eye.expand(B, kmax, kmax),
        Atb=torch.einsum("bnk,bn->bk", cols, b),
        coef=torch.zeros((B, kmax), dtype=dtype, device=dev),
    )
    return aset.refit_batched(aset.refresh_batched(st2))


def _sp_fused_row(row: _Row, Bs, k: int, maxiter: int, delta: float, m: int):
    """Batched SP over a batch row's shards: oblivious top-k init, then per
    iteration a top-k sweep per shard and the merge expand the support to
    <= 2k, and the prune to the k largest |coefficients| rebuilds from the
    cached columns. Parity: cstpu.models.twostage._sp."""
    B, n = Bs.shape
    kmax = 2 * k

    def acquire(st, r, gate):
        gsels, cols = _select_topl(row, r, k)
        for gsel, col in zip(gsels, cols):
            present = aset.contains_batched(st, gsel)
            ok = ~present & (st.k < kmax) & gate
            st = aset.append_col_gated_batched(col, Bs, st, gsel, ok)
        return aset.refit_batched(st)

    def resnorm(st):
        return torch.linalg.norm(aset.residual_batched(st, Bs), dim=1)

    done = torch.zeros((B,), dtype=torch.bool, device=row.home)
    # oblivious init: top-k of |A'b|
    st = acquire(aset.empty_batched(B, n, kmax, m, Bs.dtype, row.home), Bs,
                 ~done)
    res = resnorm(st)
    iters = 0
    for t in range(maxiter):
        if t and bool(done.all()):
            break
        iters += 1
        gate = ~done
        st2 = acquire(st, aset.residual_batched(st, Bs), gate)
        st2 = _prune_to_k(st2, Bs, k, m)
        st = aset.where_rows(gate, st2, st)     # rows past done keep theirs
        new_res = torch.where(gate, resnorm(st), res)
        done = done | (new_res <= delta) | (res <= new_res)
        res = new_res
    return aset.finalize_batched(st, m), iters


def sp_sharded_fused(A, Bs, k: int, mesh: Mesh, delta: float = 1e-12,
                     maxiter: int | None = None, corr_dtype=torch.bfloat16,
                     fuse_collectives: bool | None = None,
                     return_iters: bool = False, *,
                     _select: _Selects = _KERNELS):
    """Column-sharded batched Subspace Pursuit on the per-shard streaming
    top-k kernel (any k). Semantics of `sp`; the solution has
    2k slots."""
    rows, slices, n, m = _setup(A, Bs, mesh, corr_dtype, fuse_collectives,
                                _select, "sp_sharded_fused")
    k = int(k)
    if 2 * k > n:
        raise ValueError(f"2k = {2 * k} > {n} = len(b) is invalid for SP")
    maxiter = int(maxiter if maxiter is not None else 16 * k)
    return _cat_solutions(rows, [
        _sp_fused_row(row, b, k, maxiter, float(delta), m)
        for row, b in zip(rows, slices)], return_iters)


# --------------------------------------------------------------------------
# OMPR
# --------------------------------------------------------------------------

def _ompr_fused_row(row: _Row, Bs, k: int, maxiter: int, delta: float,
                    eta: float, m: int):
    """Batched OMPR over a batch row's shards: the passive-atom gradient
    selection is a MASKED top-1 sweep (off the support the dense
    coefficient is zero, so the score is eta |<a, r>|), the active gradient
    step needs only the cached columns, and the swap's delete and refit run
    on the batched engine. Each shard keeps the -inf exclusion mask of its
    own atoms (B, m_local), updated in place.
    Parity: cstpu.models.twostage._ompr."""
    B, n = Bs.shape
    ml = row.m_local
    kmax = k + 1

    def mask_set(Ms, gsel, on, value: float):
        for j, M, dev in zip(row.js, Ms, row.devs):
            g = gsel.to(dev)
            hit = ((g // ml) == j) & on.to(dev)       # the owning shard only
            loc = (g % ml).long()[:, None]
            M.scatter_(1, loc, torch.where(hit[:, None], value,
                                           M.gather(1, loc)))

    # oblivious top-k init
    Ms = [torch.zeros((B, ml), dtype=torch.float32, device=dev)
          for dev in row.devs]
    st = aset.empty_batched(B, n, kmax, m, Bs.dtype, row.home)
    gsels, cols = _select_topl(row, Bs, k)
    for gsel, col in zip(gsels, cols):
        ok = ~aset.contains_batched(st, gsel)
        st = aset.append_col_gated_batched(col, Bs, st, gsel, ok)
        mask_set(Ms, gsel, ok, -torch.inf)
    st = aset.refit_batched(st)
    res = torch.linalg.norm(aset.residual_batched(st, Bs), dim=1)

    done = torch.zeros((B,), dtype=torch.bool, device=row.home)
    iters = 0
    for t in range(maxiter):
        if t and bool(done.all()):
            break
        iters += 1
        r = aset.residual_batched(st, Bs)
        col, gsel, gmax, _ = _select_top1(
            row, *_sweep(row, row.sel.masked, r, Ms))
        nochange = ~(gmax > 0)              # the reference's i == 0 bail-out
        act = ~done & ~nochange
        st2 = aset.append_col_gated_batched(col, Bs, st, gsel, act)
        # gradient coefficient step over the (new) active set
        grad = torch.where(
            st2.mask,
            st2.coef + eta * torch.einsum("bnk,bn->bk", st2.cols, r), 0)
        st2 = st2._replace(coef=grad)
        # delete the min-|coefficient| active slot
        pos = torch.argmin(torch.where(st2.mask, torch.abs(grad), torch.inf),
                           dim=1)
        didx = st2.idx.gather(1, pos[:, None])[:, 0]
        st3 = aset.refit_batched(aset.delete_batched(st2, pos, m))
        st = aset.where_rows(act, st3, st)
        mask_set(Ms, gsel, act, -torch.inf)
        mask_set(Ms, didx, act, 0.0)
        new_res = torch.where(
            act, torch.linalg.norm(aset.residual_batched(st, Bs), dim=1), res)
        done = done | nochange | (new_res <= delta) | (res <= new_res)
        res = new_res
    return aset.finalize_batched(st, m), iters


def ompr_sharded_fused(A, Bs, k: int, mesh: Mesh, delta: float = 1e-12,
                       eta: float = 1.0, maxiter: int | None = None,
                       corr_dtype=torch.bfloat16,
                       fuse_collectives: bool | None = None,
                       return_iters: bool = False, *,
                       _select: _Selects = _KERNELS):
    """Column-sharded batched OMP with replacement on the masked streaming
    select kernel (the top-k init on the streaming top-l kernel, any k).
    Semantics of `ompr`; the solution has k + 1 slots."""
    rows, slices, n, m = _setup(A, Bs, mesh, corr_dtype, fuse_collectives,
                                _select, "ompr_sharded_fused")
    maxiter = int(maxiter if maxiter is not None else n)
    return _cat_solutions(rows, [
        _ompr_fused_row(row, b, int(k), maxiter, float(delta), float(eta), m)
        for row, b in zip(rows, slices)], return_iters)


# --------------------------------------------------------------------------
# The forward-regression family: FR, SRR, RMP, FoBa
# --------------------------------------------------------------------------

def _colnorm2(A_local):
    """Squared column norms of a shard in f32, (m_local,), block by block so
    that no second shard-sized temporary is made."""
    ml = A_local.shape[1]
    out = torch.empty((ml,), dtype=torch.float32, device=A_local.device)
    step = 16384
    for c0 in range(0, ml, step):
        x = A_local[:, c0:c0 + step].float()
        out[c0:c0 + step] = torch.sum(x * x, dim=0)
    return out


def _local_idx(gidx, j: int, ml: int):
    """The global atom indices gidx (B,; -1 for none) as local ones on shard
    j: -1 where there is none or another shard owns the atom."""
    owned = (gidx >= 0) & (torch.div(gidx, ml, rounding_mode="floor") == j)
    return torch.where(owned, gidx % ml, -1).to(torch.int32)


class _Rescaling:
    """The per-shard OLS rescaling of one batch row's atoms and the sweep
    that maintains it: cn2[j] (m_local,) and resc[j] (B, m_local) f32 on
    shard j's device, resc starting at cn2 for every row."""

    def __init__(self, row: _Row, B: int, n: int):
        self.row = row
        self.deg = _degeneracy_rtol(n)
        self.cn2 = [_colnorm2(A_local) for A_local in row.A]
        self.resc = [c[None, :].repeat(B, 1) for c in self.cn2]
        self.none = torch.full((B,), -1, dtype=torch.int32, device=row.home)
        self.sweeps = 0

    def select(self, r, W, mark, V=None, restore=None):
        """One `fr_step_select` per shard and the merge of the shards' best
        atoms: (col (B, n), gsel (B,) i32, dmax (B,)). W (and V) are the
        pending directions (B, n) f32, `mark` and `restore` GLOBAL atom
        indices (B,; -1 for none); each shard is told of its own atoms
        only."""
        row = self.row
        restore = self.none if restore is None else restore
        lvals, lidxs = [], []
        for c, (j, Ac, dev) in enumerate(zip(row.js, row.Ac, row.devs)):
            il = torch.stack([_local_idx(mark, j, row.m_local),
                              _local_idx(restore, j, row.m_local)],
                             dim=1).to(dev)
            lv, li, _ = row.sel.fr_step(
                Ac, r.to(dev), W.to(dev), il, self.cn2[c], self.resc[c],
                self.deg, V=None if V is None else V.to(dev))
            lvals.append(lv)
            lidxs.append(li)
        self.sweeps += 1
        col, gsel, dmax, _ = _select_top1(row, lvals, lidxs)
        return col, gsel, dmax

    def init_from(self, st: aset.ActiveSet, active):
        """The rescaling of a non-empty starting support, computed directly
        per shard in true f32: resc_j = cn2_j - a_j' C Ginv C' a_j, and -1
        on the atoms of `active`, a list of (gsel (B,), on (B,)) pairs."""
        row = self.row
        B, n, kmax = st.cols.shape
        for c, (j, A_local, dev) in enumerate(zip(row.js, row.A, row.devs)):
            cols = st.cols.to(dev).float()
            Ginv = st.Ginv.to(dev)
            with true_f32():
                Z = (cols.transpose(1, 2).reshape(B * kmax, n)
                     @ A_local.float()).view(B, kmax, -1).to(Ginv.dtype)
                GZ = Ginv @ Z
            resc = (self.cn2[c][None, :] - torch.sum(Z * GZ, dim=1)).float()
            for gsel, on in active:
                loc = _local_idx(torch.where(on, gsel, -1), j,
                                 row.m_local).to(dev).long()
                hit = loc >= 0
                loc = loc.clamp(min=0)[:, None]
                resc.scatter_(1, loc, torch.where(hit[:, None], -1.0,
                                                  resc.gather(1, loc)))
            self.resc[c] = resc.contiguous()

    def apply_delete(self, v, didx, eager):
        """A deletion's rescaling update, applied at once: resc_j += (v'a_j)^2
        over the full-precision shard in true f32 for the rows of `eager`,
        and the deleted atom didx (B,; global) restored on a zero base, its
        own (v'a)^2 being its exact rescaling after the deletion."""
        row = self.row
        ve = v * eager[:, None].to(v.dtype)
        for c, (j, A_local, dev) in enumerate(zip(row.js, row.A, row.devs)):
            with true_f32():
                z = ve.to(dev) @ A_local.float()               # (B, m_local)
            zz = z * z
            self.resc[c] += zz
            loc = _local_idx(torch.where(eager, didx, -1), j,
                             row.m_local).to(dev).long()
            hit = loc >= 0
            loc = loc.clamp(min=0)[:, None]
            self.resc[c].scatter_(1, loc, torch.where(
                hit[:, None], zz.gather(1, loc), self.resc[c].gather(1, loc)))


def _append_refit(st: aset.ActiveSet, col, Bs, gsel, accept):
    return aset.refit_batched(
        aset.append_col_gated_batched(col, Bs, st, gsel, accept))


def _delete_candidate(st: aset.ActiveSet):
    """Every row's deletion candidate, the slot of least coef^2 / gamma
    (lowest slot on ties), and its freed span direction from the state
    BEFORE the delete: (pos (B,), dmin (B,), didx (B,) i32, v (B, n) f32)."""
    gam = aset.gamma_batched(st)
    d2 = torch.where(st.mask,
                     st.coef * st.coef / torch.clamp(gam, min=1e-30),
                     torch.inf)
    pos = torch.argmin(d2, dim=1)
    at = pos[:, None]
    dmin = d2.gather(1, at)[:, 0]
    didx = st.idx.gather(1, at)[:, 0]
    qv = st.Ginv.gather(2, at[:, None, :].expand(-1, st.Ginv.shape[1], 1))
    qv = qv[:, :, 0]                                           # Ginv e_pos
    qpp = qv.gather(1, at)[:, 0]
    v = (torch.einsum("bnk,bk->bn", st.cols, qv)
         * torch.sqrt(1.0 / torch.clamp(qpp, min=1e-30))[:, None])
    return pos, dmin, didx, v.to(torch.float32)


def _delete_refit(st: aset.ActiveSet, pos, m: int, gate):
    st2 = aset.refit_batched(aset.delete_batched(st, pos, m))
    return aset.where_rows(gate, st2, st)


def _fr_fused_row(row: _Row, Bs, k: int, max_eps2: float, min_d2: float,
                  m: int):
    """Batched forward regression over a batch row's shards. Each shard
    keeps the OLS rescaling of ITS atoms; `fr_step_select` folds the
    previous append's rank-one downdate and this step's scoring into one
    pass over the shard. The scaled orthogonal direction w of each accepted
    append comes from the cached active columns and rides into the next
    sweep. Parity: cstpu.parallel.sharded._fr_fused_shard_body."""
    B, n = Bs.shape
    kcap = min(n, k)
    st = aset.empty_batched(B, n, k, m, Bs.dtype, row.home)
    resc = _Rescaling(row, B, n)
    W = torch.zeros((B, n), dtype=torch.float32, device=row.home)
    mark = resc.none
    done = torch.zeros((B,), dtype=torch.bool, device=row.home)
    for t in range(k):
        if t and bool(done.all()):
            break
        r = aset.residual_batched(st, Bs)
        col, gsel, dmax = resc.select(r, W, mark)
        rnorm2 = torch.sum(r * r, dim=1)
        accept = (~done & (rnorm2 > max_eps2) & (dmax > min_d2)
                  & (st.k < kcap))
        # w for the NEXT sweep's downdate, from the state before the append
        W = aset.w_of_batched(st, col) * accept[:, None]
        mark = torch.where(accept, gsel, -1)
        st = _append_refit(st, col, Bs, gsel, accept)
        done = done | ~accept
    return aset.finalize_batched(st, m), resc.sweeps


def fr_sharded_fused(A, Bs, sparsity: int, mesh: Mesh,
                     max_residual: float = 0.0, min_decrease: float = 0.0,
                     corr_dtype=torch.bfloat16,
                     fuse_collectives: bool | None = None,
                     return_iters: bool = False, *,
                     _select: _Selects = _KERNELS):
    """Column-sharded batched forward regression (OLS rule) on the combined
    rescaling-and-select streaming kernel: one pass over the dictionary per
    step. Semantics of `fr` with a sparsity cap."""
    rows, slices, n, m = _setup(A, Bs, mesh, corr_dtype, fuse_collectives,
                                _select, "fr_sharded_fused")
    k = int(min(sparsity, n, m))
    return _cat_solutions(rows, [
        _fr_fused_row(row, b, k, float(max_residual) ** 2,
                      float(min_decrease) ** 2, m)
        for row, b in zip(rows, slices)], return_iters)


def _srr_fused_row(row: _Row, Bs, k: int, maxiter: int, delta: float, m: int):
    """Batched SRR (l = 1, oblivious init) over a batch row's shards. The
    top-k of |A'b| starts the support and its rescaling is computed
    directly. Then every iteration is ONE sweep that carries both deferred
    identities, the previous append's downdate (W, mark) and the previous
    deletion's update (V, restore), followed by the append and, while the
    support exceeds k, the delete of the least coef^2 / gamma slot.
    Parity: cstpu.parallel.sharded._srr_fused_shard_body."""
    B, n = Bs.shape
    kmax = min(k + 1, m)
    st = aset.empty_batched(B, n, kmax, m, Bs.dtype, row.home)
    resc = _Rescaling(row, B, n)

    # oblivious top-k init
    gsels, cols = _select_topl(row, Bs, k)
    active = []
    for gsel, col in zip(gsels, cols):
        ok = ~aset.contains_batched(st, gsel)
        st = aset.append_col_gated_batched(col, Bs, st, gsel, ok)
        active.append((gsel, ok))
    st = aset.refit_batched(st)
    resc.init_from(st, active)

    def resnorm(st):
        return torch.linalg.norm(aset.residual_batched(st, Bs), dim=1)

    res = resnorm(st)
    W = torch.zeros((B, n), dtype=torch.float32, device=row.home)
    V = torch.zeros_like(W)
    mark = restore = resc.none
    done = torch.zeros((B,), dtype=torch.bool, device=row.home)
    iters = 0
    for t in range(maxiter):
        if t and bool(done.all()):
            break
        iters += 1
        gate = ~done
        r = aset.residual_batched(st, Bs)
        col, gsel, dmax = resc.select(r, W, mark, V, restore)
        rnorm2 = torch.sum(r * r, dim=1)
        accept = gate & (rnorm2 > 0) & (dmax > 0) & (st.k < kmax)
        W = aset.w_of_batched(st, col) * accept[:, None]
        mark = torch.where(accept, gsel, -1)
        st2 = _append_refit(st, col, Bs, gsel, accept)

        # backward: delete the least coef^2 / gamma slot while count > k
        dodel = gate & (st2.k > k)
        pos, _, didx, v = _delete_candidate(st2)
        V = v * dodel[:, None]
        restore = torch.where(dodel, didx, -1)
        st = _delete_refit(st2, pos, m, dodel)
        # deleting the atom just appended: its pending -w^2 and the
        # delete's +v^2 cancel (w == v), the atom is neither marked nor
        # restored and its rescaling still holds the value from before the
        # append, so all four pending channels are cleared
        same = dodel & accept & (didx == gsel)
        W = W * ~same[:, None]
        V = V * ~same[:, None]
        mark = torch.where(same, -1, mark)
        restore = torch.where(same, -1, restore)

        new_res = torch.where(gate, resnorm(st), res)
        done = done | (new_res <= delta) | (res <= new_res)
        res = new_res
    return aset.finalize_batched(st, m), iters


def srr_sharded_fused(A, Bs, k: int, mesh: Mesh, delta: float = 1e-12,
                      maxiter: int | None = None, corr_dtype=torch.bfloat16,
                      fuse_collectives: bool | None = None,
                      return_iters: bool = False, *,
                      _select: _Selects = _KERNELS):
    """Column-sharded batched SRR (l = 1, oblivious init): one streamed pass
    over the dictionary per replacement iteration. Semantics of `srr`; the
    solution has min(k + 1, m) slots."""
    rows, slices, n, m = _setup(A, Bs, mesh, corr_dtype, fuse_collectives,
                                _select, "srr_sharded_fused")
    k = int(k)
    maxiter = int(maxiter if maxiter is not None else 4 * k)
    return _cat_solutions(rows, [
        _srr_fused_row(row, b, k, maxiter, float(delta), m)
        for row, b in zip(rows, slices)], return_iters)


def _rmp_foba_row(row: _Row, Bs, kmax: int, maxiter: int, delta2: float,
                  m: int, foba: bool):
    """Batched RMP (delta variant) or FoBa over a batch row's shards.
    Forward steps are one sweep each, the previous append's downdate folded
    in; a backward deletion's rescaling identity is applied at once by one
    product over the local full-precision shard (deletions are rare, sweeps
    are not). The kmax slot cap with its per-row `capped` flag is the
    contract of the batched kernels: rows the cap refused are solved again
    by the caller. Returns (solution, capped (B,), counts).
    Parity: cstpu.parallel.sharded._rmp_fused_shard_body."""
    B, n = Bs.shape
    home = row.home
    st = aset.empty_batched(B, n, kmax, m, Bs.dtype, home)
    resc = _Rescaling(row, B, n)
    limit = min(n, m)
    reads = 0

    def flag(x) -> bool:
        """One value read back to the host: what cstpu's `lax.while_loop`
        conditions are here."""
        nonlocal reads
        reads += 1
        return bool(x)

    def forward_step(st, W, mark, gate, capped):
        r = aset.residual_batched(st, Bs)
        col, gsel, dmax = resc.select(r, W, mark)
        rnorm2 = torch.sum(r * r, dim=1)
        wanted = gate & (rnorm2 > 0) & (dmax > delta2) & (st.k < limit)
        full = st.k >= kmax
        accept = wanted & ~full
        W = aset.w_of_batched(st, col) * accept[:, None]
        pend = torch.where(accept, gsel, -1)
        st = _append_refit(st, col, Bs, gsel, accept)
        return st, W, pend, accept, capped | (wanted & full), dmax

    def bwd_once(st, W, mark, pend, g, floor):
        """One gated delete of the rows of g whose least coef^2 / gamma lies
        below `floor`; where the deleted atom IS the pending one, the
        pending forward channels are cancelled instead of applying the
        update (the -w^2 and the +v^2 cancel). Returns also whether any row
        deleted (one flag read)."""
        pos, dmin, didx, v = _delete_candidate(st)
        acc = g & (dmin < floor)
        if not flag(acc.any()):
            return st, W, mark, pend, acc, False
        same = acc & (pend >= 0) & (didx == pend)
        resc.apply_delete(v, didx, acc & ~same)
        st = _delete_refit(st, pos, m, acc)
        W = W * ~same[:, None]
        mark = torch.where(same, -1, mark)
        pend = torch.where(same, -1, pend)
        return st, W, mark, pend, acc, True

    W = torch.zeros((B, n), dtype=torch.float32, device=home)
    mark = pend = resc.none
    capped = torch.zeros((B,), dtype=torch.bool, device=home)
    if not foba:
        done = torch.zeros((B,), dtype=torch.bool, device=home)
        for t in range(maxiter):
            if t and flag(done.all()):
                break
            alive = ~done
            # forward stage: until no live row accepts
            g = alive
            facc = torch.zeros_like(done)
            while True:
                st, W, mark2, acc, capped, _ = forward_step(
                    st, W, mark, g, capped)
                pend = torch.where(g, mark2, pend)
                mark = mark2
                g = g & acc
                facc = facc | acc
                if not flag(g.any()):
                    break
            # backward stage: until no live row deletes
            g = alive
            bacc = torch.zeros_like(done)
            while True:
                st, W, mark, pend, acc, went = bwd_once(
                    st, W, mark, pend, g, delta2)
                g = g & acc
                bacc = bacc | acc
                if not went:
                    break
            done = done | ~(facc | bacc)
    else:
        alive = torch.ones((B,), dtype=torch.bool, device=home)
        for t in range(maxiter):
            if t and not flag(alive.any()):
                break
            st, W, mark2, acc, capped, dmax = forward_step(
                st, W, mark, alive, capped)
            pend = torch.where(alive, mark2, pend)
            mark = mark2
            floor = torch.clamp(dmax, min=0.0) * 0.25
            g = alive & acc
            while True:
                st, W, mark, pend, bacc, went = bwd_once(
                    st, W, mark, pend, g, floor)
                g = g & bacc
                if not went:
                    break
            alive = alive & acc
    counts = {"sweeps": resc.sweeps, "flag_reads": reads}
    return aset.finalize_batched(st, m), capped, counts


def _rmp_foba_sharded(A, Bs, mesh: Mesh, kmax: int, maxiter: int,
                      delta: float, corr_dtype, fuse_collectives,
                      return_iters: bool, foba: bool, select: _Selects):
    rows, slices, n, m = _setup(A, Bs, mesh, corr_dtype, fuse_collectives,
                                select, "rmp/foba_sharded_fused")
    out = [_rmp_foba_row(row, b, int(kmax), int(maxiter), float(delta) ** 2,
                         m, foba) for row, b in zip(rows, slices)]
    sol, counts = _cat_solutions(rows, [(x, it) for x, _, it in out], True)
    capped = _cat_rows(rows, [c for _, c, _ in out])
    if return_iters:
        return sol, capped, counts
    return sol, capped


def rmp_sharded_fused(A, Bs, delta: float, mesh: Mesh, kmax: int = 32,
                      maxiter: int = 1, corr_dtype=torch.bfloat16,
                      fuse_collectives: bool | None = None,
                      return_iters: bool = False, *,
                      _select: _Selects = _KERNELS):
    """Column-sharded batched RMP (delta variant) with the kmax cap and the
    `capped` contract. Returns (SparseSolution, capped (B,) bool)."""
    return _rmp_foba_sharded(A, Bs, mesh, kmax, maxiter, delta, corr_dtype,
                             fuse_collectives, return_iters, False, _select)


def foba_sharded_fused(A, Bs, delta: float, mesh: Mesh, kmax: int = 32,
                       corr_dtype=torch.bfloat16,
                       fuse_collectives: bool | None = None,
                       return_iters: bool = False, *,
                       _select: _Selects = _KERNELS):
    """Column-sharded batched FoBa (a deletion must cost less than a quarter
    of the last forward gain). Returns (SparseSolution, capped (B,) bool)."""
    return _rmp_foba_sharded(A, Bs, mesh, kmax, int(A.shape[0]), delta,
                             corr_dtype, fuse_collectives, return_iters,
                             True, _select)


# --------------------------------------------------------------------------
# Row-sharded OMP: the strategy for a long measurement axis
# --------------------------------------------------------------------------

def omp_sharded_rows(A, b, k: int, mesh: Mesh, max_residual: float = 0.0):
    """OMP with the dictionary ROW-sharded over the 'atoms' axis of the
    mesh, and b likewise: the strategy for n >> m. Per step every shard
    correlates its own measurement rows and one m-length psum gives the
    global correlation; the selection and the k x k Cholesky refit are
    computed once, at home, and the Gram and A'b updates are psums of the
    shards' partial products. Plain tensor operations in the dictionary's
    own precision, one instance b (n,), on the first batch row of the mesh
    in this process. Semantics of `omp`."""
    A, b = torch.as_tensor(A), torch.as_tensor(b)
    n, m = A.shape
    k = int(min(k if k is not None else n, n, m))
    row = mesh.rows()[0]
    js = mesh.local(row)
    A_loc = [shard_rows(A, mesh)[j] for j in js]
    b_loc = [shard_rows(b.to(A.dtype), mesh)[j] for j in js]
    devs, home = [mesh.devices[row][j] for j in js], mesh.home(row)
    dtype = A.dtype
    psum = partial(mesh.psum, home=home, row=row)

    idx = torch.full((k,), m, dtype=torch.int32, device=home)
    mask = torch.zeros((k,), dtype=torch.bool, device=home)
    G = torch.eye(k, dtype=dtype, device=home)
    Atb = torch.zeros((k,), dtype=dtype, device=home)
    coef = torch.zeros((k,), dtype=dtype, device=home)
    cols = [torch.zeros((x.shape[0], k), dtype=dtype, device=dev)
            for x, dev in zip(A_loc, devs)]

    def residual_local(coef):
        return [bl - c @ coef.to(dev)
                for bl, c, dev in zip(b_loc, cols, devs)]

    count = 0
    for _ in range(k):
        r_loc = residual_local(coef)
        scores = torch.abs(psum([r @ Al for r, Al in zip(r_loc, A_loc)]))
        i = int(torch.argmax(scores))
        if bool(torch.any(mask & (idx == i))) or count >= k:
            break                       # stalled: present or full
        a_loc = [Al[:, i] for Al in A_loc]
        for c, a in zip(cols, a_loc):
            c[:, count] = a
        g = psum([c.T @ a for c, a in zip(cols, a_loc)])
        G[count, :] = g
        G[:, count] = g
        idx[count] = i
        mask[count] = True
        Atb[count] = psum([a @ bl for a, bl in zip(a_loc, b_loc)])
        count += 1
        L = cholesky_nan(G)
        coef = torch.cholesky_solve(
            torch.where(mask, Atb, 0)[:, None], L)[:, 0]
        coef = torch.where(mask, coef, 0)
        rn2 = psum([torch.sum(r * r).to(home) for r in residual_local(coef)])
        if bool(torch.sqrt(rn2) < max_residual):
            break

    order = torch.argsort(torch.where(mask, idx, INT_MAX), stable=True)
    mask = mask[order]
    return SparseSolution(
        idx=torch.where(mask, idx[order], m).to(torch.int32),
        val=torch.where(mask, coef[order], 0), mask=mask, m=int(m))


omp_sharded_fused_ref = partial(omp_sharded_fused, _select=_PLAIN)
mp_sharded_fused_ref = partial(mp_sharded_fused, _select=_PLAIN)
gomp_sharded_fused_ref = partial(gomp_sharded_fused, _select=_PLAIN)
sp_sharded_fused_ref = partial(sp_sharded_fused, _select=_PLAIN)
ompr_sharded_fused_ref = partial(ompr_sharded_fused, _select=_PLAIN)
fr_sharded_fused_ref = partial(fr_sharded_fused, _select=_PLAIN)
srr_sharded_fused_ref = partial(srr_sharded_fused, _select=_PLAIN)
rmp_sharded_fused_ref = partial(rmp_sharded_fused, _select=_PLAIN)
foba_sharded_fused_ref = partial(foba_sharded_fused, _select=_PLAIN)
