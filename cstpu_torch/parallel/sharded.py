"""Column-sharded greedy pursuit over a mesh of shards (PyTorch counterpart
of cstpu.parallel.sharded): OMP, MP, GOMP, OMPR and SP on the streaming
select kernels, and the plain `omp_sharded` they are verified against.

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

`A` may be a tensor or the result of `shard_dictionary` (then no shard is
cut or cast twice); `Bs` a tensor or the result of `shard_batch`. Results
are gathered on the first batch row's home device.

Shape limits. What remains of cstpu's: m divisible by the atom shards, B
by the batch shards, a per-shard atom width that is a multiple of 128 with
a streamable tile (`stream_select._stream_tile`, which defines the NaN
rule), l <= 32 for the top-l select (so k <= 32 for SP and OMPR). Dropped,
because only the TPU's tiling needed them: n % 8 == 0 and a per-shard
batch that is a multiple of 8.

With `return_iters` the solvers whose loops end on the data (OMP, GOMP,
SP, OMPR) also return the steps or outer iterations each batch row ran.

Every `*_sharded_fused` has a twin `*_sharded_fused_ref` that runs the same
body on the selects' plain versions; on CPU tensors both are the same.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from cstpu_torch.ops import active_set as aset
from cstpu_torch.ops import stream_select as ss
from cstpu_torch.parallel.mesh import Mesh, ShardedDictionary, shard_batch, \
    shard_dictionary
from cstpu_torch.utils.sparse import SparseSolution

INT_MAX = torch.iinfo(torch.int32).max

# Exact integer range of the fused payload's index lane.
_F32_EXACT_INT = 1 << 24
_F64_EXACT_INT = 1 << 53


class _Selects(NamedTuple):
    """The three streaming selects a body calls."""
    top1: object
    topl: object
    masked: object


_KERNELS = _Selects(ss.correlate_select_stream,
                    ss.correlate_select_topl_stream,
                    ss.correlate_select_masked_stream)
_PLAIN = _Selects(ss.correlate_select_stream_ref,
                  ss.correlate_select_topl_stream_ref,
                  ss.correlate_select_masked_stream_ref)


class _Row(NamedTuple):
    """One batch row's shards: devices, full-precision and correlation-dtype
    dictionary shards, and what resolves a selection across them."""
    mesh: Mesh
    home: torch.device
    devs: tuple
    A: tuple            # s shards (n, m_local) in the dictionary's dtype
    Ac: tuple           # the same in the correlation dtype
    m_local: int
    sel: _Selects
    fuse: bool


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
        B = sum(x.shape[0] for x in slices)
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
    Acs = Ash.corr(corr_dtype)
    rows = tuple(_Row(mesh, mesh.home(i), mesh.devices[i], Ash.shards[i],
                      Acs[i], m // s, sel, fuse) for i in range(b))
    slices = tuple(x.to(row.home, Ash.dtype)
                   for x, row in zip(slices, rows))
    return rows, slices, n, m


def _cat_solutions(out, return_iters: bool = False):
    """The batch rows' (solution, iterations) as one solution, on the first
    row's device; with `return_iters` also the rows' iteration counts."""
    sols = [sol for sol, _ in out]
    dev = sols[0].idx.device
    sol = sols[0] if len(sols) == 1 else SparseSolution(
        idx=torch.cat([x.idx.to(dev) for x in sols]),
        val=torch.cat([x.val.to(dev) for x in sols]),
        mask=torch.cat([x.mask.to(dev) for x in sols]),
        m=sols[0].m)
    return (sol, [it for _, it in out]) if return_iters else sol


# --------------------------------------------------------------------------
# Merging the shards' selections
# --------------------------------------------------------------------------

def _sweep(row: _Row, select, r, *extra):
    """`select` on every shard of the row: lists of s local (val, idx)."""
    out = [select(Ac, r.to(dev), *(x[j] for x in extra))
           for j, (Ac, dev) in enumerate(zip(row.Ac, row.devs))]
    return [v for v, _ in out], [i for _, i in out]


def _global_idx(row: _Row, lidxs):
    """Local atom indices -> global ones, shard * m_local + lidx, i32."""
    return [j * row.m_local + li.to(torch.int32)
            for j, li in enumerate(lidxs)]


def _bcast_cols(row: _Row, gsel):
    """Owner-gathers-then-psum broadcast of the selected columns: the
    owning shard reads its full-precision columns (an indexed read),
    everyone psums. Returns (cols (B, n) at home, owners: s (B,) masks)."""
    parts, owners = [], []
    for j, (A_local, dev) in enumerate(zip(row.A, row.devs)):
        g = gsel.to(dev)
        owner = (g // row.m_local) == j
        lcol = A_local[:, (g % row.m_local).long()].T
        parts.append(torch.where(owner[:, None], lcol, 0))
        owners.append(owner)
    return row.mesh.psum(parts, row.home), owners


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
    allp = row.mesh.all_gather(payloads, row.home)              # (s, B, n+2)
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
    gmax = row.mesh.pmax(lvals, row.home)
    cands = [torch.where(lv == gmax.to(lv.device), gi, INT_MAX)
             for lv, gi in zip(lvals, _global_idx(row, lidxs))]
    gsel = row.mesh.pmin(cands, row.home)
    col, owners = _bcast_cols(row, gsel)
    return col, gsel, gmax, owners


def _merge_topl(row: _Row, lvals, gidxs, ll: int):
    """All-gather the per-shard top-l candidates (B, l) and select the
    global top-`ll`, value-descending with lowest-global-index ties.
    Returns ll (B,) index tensors, best first."""
    B = lvals[0].shape[0]
    av = row.mesh.all_gather(lvals, row.home).movedim(0, 1).reshape(B, -1)
    ai = row.mesh.all_gather(gidxs, row.home).movedim(0, 1).reshape(B, -1)
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
    allp = row.mesh.all_gather(payloads, row.home)          # (s, B, ll, n+2)
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
    return _cat_solutions([
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
        slices = shard_batch(b, mesh)
    else:
        slices = (b[None],)

    def solve(i, bb):
        row = _Row(mesh, mesh.home(i), mesh.devices[i], Ash.shards[i],
                   Ash.shards[i], m // s, _PLAIN, False)

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

    sol = _cat_solutions([solve(i, bb) for i, bb in enumerate(slices)])
    if batched:
        return sol
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
        for j, (x, dev) in enumerate(zip(xs, row.devs)):
            g = gsel.to(dev)
            owner = owners[j] if owners is not None else (g // ml) == j
            # a shard that does not own the atom adds 0 somewhere
            x.scatter_add_(1, (g % ml).long()[:, None],
                           torch.where(owner, p.to(dev), 0)[:, None])
        r = r - p[:, None] * col
    return torch.cat([x.to(row.home) for x in xs], dim=1)


def mp_sharded_fused(A, Bs, k: int, mesh: Mesh, corr_dtype=torch.bfloat16,
                     fuse_collectives: bool | None = None, *,
                     _select: _Selects = _KERNELS):
    """Column-sharded batched matching pursuit on the streaming select
    kernel. During the solve the coefficients are sharded as the atoms
    are; the dense (B, m) result is their concatenation on the first batch
    row's home device. Semantics of `mp` (k fixed updates)."""
    rows, slices, n, m = _setup(A, Bs, mesh, corr_dtype, fuse_collectives,
                                _select, "mp_sharded_fused")
    out = [_mp_fused_row(row, b, int(k)) for row, b in zip(rows, slices)]
    return torch.cat([x.to(out[0].device) for x in out], dim=0)


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
    (l <= 32). Semantics of `gomp`."""
    rows, slices, n, m = _setup(A, Bs, mesh, corr_dtype, fuse_collectives,
                                _select, "gomp_sharded_fused")
    k = int(min(k if k is not None else m, m))
    return _cat_solutions([
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
    top-k kernel (k <= 32). Semantics of `sp`; the solution has 2k slots."""
    rows, slices, n, m = _setup(A, Bs, mesh, corr_dtype, fuse_collectives,
                                _select, "sp_sharded_fused")
    k = int(k)
    if 2 * k > n:
        raise ValueError(f"2k = {2 * k} > {n} = len(b) is invalid for SP")
    maxiter = int(maxiter if maxiter is not None else 16 * k)
    return _cat_solutions([
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
        for j, (M, dev) in enumerate(zip(Ms, row.devs)):
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
    select kernel (k <= 32 for the top-k init). Semantics of `ompr`; the
    solution has k + 1 slots."""
    rows, slices, n, m = _setup(A, Bs, mesh, corr_dtype, fuse_collectives,
                                _select, "ompr_sharded_fused")
    maxiter = int(maxiter if maxiter is not None else n)
    return _cat_solutions([
        _ompr_fused_row(row, b, int(k), maxiter, float(delta), float(eta), m)
        for row, b in zip(rows, slices)], return_iters)


omp_sharded_fused_ref = partial(omp_sharded_fused, _select=_PLAIN)
mp_sharded_fused_ref = partial(mp_sharded_fused, _select=_PLAIN)
gomp_sharded_fused_ref = partial(gomp_sharded_fused, _select=_PLAIN)
sp_sharded_fused_ref = partial(sp_sharded_fused, _select=_PLAIN)
ompr_sharded_fused_ref = partial(ompr_sharded_fused, _select=_PLAIN)
