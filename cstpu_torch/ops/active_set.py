"""Fixed-shape masked active-set engine (PyTorch counterpart of
cstpu.ops.active_set).

State of one instance:

  * `idx`/`mask`   — padded support (insertion order; sorted at extraction)
  * `cols`         — cached active columns of A (zeros where inactive)
  * `G`            — exact Gram matrix of the active columns, identity-padded
  * `Ginv`         — its inverse, identity-padded
  * `Atb`, `coef`  — A_i' b and the current LS coefficients

Appends update Ginv with the rank-one bordered block-inverse formula;
deletions and bulk rebuilds recompute it exactly from G by a Cholesky
solve (`refresh`). The engine is dtype-generic: f64 on the CPU for the
conformance tests, f32 on the card. Functions return new states and never
write into their arguments.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INT32_MAX = torch.iinfo(torch.int32).max


class ActiveSet(NamedTuple):
    idx: torch.Tensor    # int32[kmax] support indices (insertion order), pad m
    mask: torch.Tensor   # bool[kmax]
    k: torch.Tensor      # int32[] number of active slots
    cols: torch.Tensor   # f[n, kmax] active columns of A, zero where inactive
    G: torch.Tensor      # f[kmax, kmax] Gram, identity on inactive slots
    Ginv: torch.Tensor   # f[kmax, kmax] inverse Gram, identity on inactive
    Atb: torch.Tensor    # f[kmax]
    coef: torch.Tensor   # f[kmax] current LS coefficients


def empty(n: int, kmax: int, m: int, dtype, device=None) -> ActiveSet:
    """Empty active set with capacity kmax over an n x m dictionary."""
    eye = torch.eye(kmax, dtype=dtype, device=device)
    return ActiveSet(
        idx=torch.full((kmax,), m, dtype=torch.int32, device=device),
        mask=torch.zeros((kmax,), dtype=torch.bool, device=device),
        k=torch.zeros((), dtype=torch.int32, device=device),
        cols=torch.zeros((n, kmax), dtype=dtype, device=device),
        G=eye,
        Ginv=eye.clone(),
        Atb=torch.zeros((kmax,), dtype=dtype, device=device),
        coef=torch.zeros((kmax,), dtype=dtype, device=device),
    )


def contains(st: ActiveSet, i) -> torch.Tensor:
    """True if atom index i is in the active set."""
    return torch.any(st.mask & (st.idx == i))


def _bordered_ginv(Ginv, u, dinv, p):
    """[[Ginv + u u'/d, -u/d], [-u'/d, 1/d]] with the border at slot p."""
    out = Ginv + dinv * torch.outer(u, u)
    out[p, :] = -dinv * u
    out[:, p] = -dinv * u
    out[p, p] = dinv
    return out


def _probe(a, st: ActiveSet):
    """(u, d, a'a) of column `a` against the OLD active set: u = Ginv g
    with g the cross terms, d = a'a - g'u its out-of-span energy."""
    g = torch.where(st.mask, st.cols.T @ a, 0)
    ata = a @ a
    u = st.Ginv @ g
    return u, ata - g @ u, ata


def _border(a, b, st: ActiveSet, i, u, d, ata) -> ActiveSet:
    """Write column `a` as atom i into the first free slot; d is clamped
    at 1e-12 * a'a before the bordered Ginv update."""
    p = int(st.k)
    cols = st.cols.clone()
    cols[:, p] = a
    gfull = cols.T @ a                   # zeros at inactive slots, a'a at p
    G = st.G.clone()
    G[p, :] = gfull
    G[:, p] = gfull
    d = torch.maximum(d, 1e-12 * torch.clamp(ata, min=1e-30))
    Ginv = _bordered_ginv(st.Ginv, u, 1.0 / d, p)
    idx = st.idx.clone()
    idx[p] = int(i)
    mask = st.mask.clone()
    mask[p] = True
    Atb = st.Atb.clone()
    Atb[p] = a @ b
    return ActiveSet(idx=idx, mask=mask, k=st.k + 1, cols=cols, G=G,
                     Ginv=Ginv, Atb=Atb, coef=st.coef)


def append_col(a, b, st: ActiveSet, i) -> ActiveSet:
    """Add the explicit column `a` as atom index i (no refit).

    Callers guard capacity and duplicates. The orthogonal energy d is
    clamped at 1e-12 * a'a (the degeneracy guard of this ungated form).
    """
    return _border(a, b, st, i, *_probe(a, st))


def append(A, b, st: ActiveSet, i) -> ActiveSet:
    """Add atom i at the first free slot (no refit). Caller must `refit`."""
    return append_col(A[:, int(i)], b, st, i)


def append_col_gated(a, b, st: ActiveSet, i, ok) -> ActiveSet:
    """`append_col` that returns the state unchanged when `ok` is False.

    Two rejections are enforced here for any caller-supplied gate:
      * capacity — at st.k == kmax nothing is written;
      * degeneracy — a column numerically inside the active span is
        rejected (d <= 8 n eps(dtype) ||a||^2): accepting it makes the
        exact Gram singular and the next `refresh` Cholesky fails.
    """
    if not (bool(ok) and int(st.k) < st.idx.shape[0]):
        return st
    u, d, ata = _probe(a, st)
    rtol = 8.0 * a.shape[0] * torch.finfo(a.dtype).eps
    if not bool(d > rtol * ata):
        return st
    return _border(a, b, st, i, u, d, ata)


def append_gated(A, b, st: ActiveSet, i, ok) -> ActiveSet:
    """Gated append by atom index (see append_col_gated)."""
    return append_col_gated(A[:, int(i)], b, st, i, ok)


def refresh(st: ActiveSet) -> ActiveSet:
    """Recompute Ginv exactly from the exact padded Gram (Cholesky solve)."""
    kmax = st.G.shape[0]
    eye = torch.eye(kmax, dtype=st.G.dtype, device=st.G.device)
    Gpad = torch.where(st.mask[:, None] & st.mask[None, :], st.G, eye)
    L = torch.linalg.cholesky(Gpad)
    return st._replace(Ginv=torch.cholesky_solve(eye, L))


def delete(st: ActiveSet, pos, m: int) -> ActiveSet:
    """Remove the active slot at `pos`, compacting left; Ginv is recomputed
    exactly. No refit."""
    kmax = st.idx.shape[0]
    dev = st.idx.device
    ar = torch.arange(kmax, device=dev)
    src = torch.clamp(torch.where(ar >= pos, ar + 1, ar), max=kmax - 1)
    newmask = ar < (st.k - 1)
    eye = torch.eye(kmax, dtype=st.G.dtype, device=dev)
    both = newmask[:, None] & newmask[None, :]
    st2 = ActiveSet(
        idx=torch.where(newmask, st.idx[src], m).to(torch.int32),
        mask=newmask,
        k=st.k - 1,
        cols=torch.where(newmask[None, :], st.cols[:, src], 0),
        G=torch.where(both, st.G[src][:, src], eye),
        Ginv=eye,
        Atb=torch.where(newmask, st.Atb[src], 0),
        coef=torch.where(newmask, st.coef[src], 0),
    )
    return refresh(st2)


def rebuild(A, b, idx, mask) -> ActiveSet:
    """Construct the state for a given padded support in one shot."""
    kmax = idx.shape[0]
    eye = torch.eye(kmax, dtype=A.dtype, device=A.device)
    safe = torch.where(mask, idx, 0).long()
    cols = A[:, safe] * mask[None, :].to(A.dtype)
    G = torch.where(mask[:, None] & mask[None, :], cols.T @ cols, eye)
    st = ActiveSet(
        idx=torch.where(mask, idx, A.shape[1]).to(torch.int32),
        mask=mask,
        k=mask.sum().to(torch.int32),
        cols=cols,
        G=G,
        Ginv=eye,
        Atb=cols.T @ b,
        coef=torch.zeros((kmax,), dtype=A.dtype, device=A.device),
    )
    return refresh(st)


def refit(st: ActiveSet) -> ActiveSet:
    """Solve the active LS problem: coef = Ginv @ Atb."""
    coef = st.Ginv @ torch.where(st.mask, st.Atb, 0)
    return st._replace(coef=torch.where(st.mask, coef, 0))


def residual(st: ActiveSet, b) -> torch.Tensor:
    """r = b - A_active @ coef, using the cached active columns."""
    return b - st.cols @ st.coef


def gamma(st: ActiveSet) -> torch.Tensor:
    """diag((A_i'A_i)^-1) over active slots (junk elsewhere; callers mask)."""
    return torch.diagonal(st.Ginv)


def ols_rescaling(A, st: ActiveSet, colnorm2) -> torch.Tensor:
    """Squared energetic norms ||a_j||^2 - ||proj_active a_j||^2 for all j."""
    W = st.cols.T @ A
    return colnorm2 - torch.sum(W * (st.Ginv @ W), dim=0)


def active_marker(st: ActiveSet, m: int) -> torch.Tensor:
    """Dense boolean (m,) marking active atom indices."""
    z = torch.zeros((m + 1,), dtype=torch.bool, device=st.idx.device)
    z[torch.where(st.mask, st.idx, m).long()] = st.mask
    return z[:m]


def finalize(st: ActiveSet, m: int):
    """Sort the active set by atom index and return a SparseSolution."""
    from cstpu_torch.utils.sparse import SparseSolution

    key = torch.where(st.mask, st.idx, INT32_MAX)
    order = torch.argsort(key, stable=True)
    mask = st.mask[order]
    return SparseSolution(
        idx=torch.where(mask, st.idx[order], m).to(torch.int32),
        val=torch.where(mask, st.coef[order], 0),
        mask=mask,
        m=int(m),
    )


# --------------------------------------------------------------------------
# Batched forms: the same state with a leading batch axis B on every field
# (idx, mask, Atb, coef (B, kmax); k (B,); cols (B, n, kmax); G, Ginv (B,
# kmax, kmax)), what cstpu gets by vmapping the functions above. Gates are
# boolean masks and nothing here reads a value back to the host, so a step
# of a batched solver is a fixed chain of tensor operations. Dtype-generic.
# --------------------------------------------------------------------------

def vm_rows(v, M) -> torch.Tensor:
    """v[b] @ M[b] for every row: (B, r), (B, r, c) -> (B, c), a batch of
    (1, r) x (r, c) products: on the CPU a row's rounding then does not
    depend on the batch's size, where a batched matrix-vector product
    M[b] @ v[b] picks its kernel by it."""
    return torch.einsum("brc,br->bc", M, v)


def mv_rows(M, v) -> torch.Tensor:
    """M[b] @ v[b] for every row: (B, r, c), (B, c) -> (B, r), as the
    products v[b] @ M[b]' (see vm_rows)."""
    return torch.bmm(v[:, None, :], M.transpose(1, 2))[:, 0]


def empty_batched(B: int, n: int, kmax: int, m: int, dtype,
                  device=None) -> ActiveSet:
    """B empty active sets with capacity kmax over an n x m dictionary."""
    eye = torch.eye(kmax, dtype=dtype, device=device).expand(B, kmax, kmax)
    return ActiveSet(
        idx=torch.full((B, kmax), m, dtype=torch.int32, device=device),
        mask=torch.zeros((B, kmax), dtype=torch.bool, device=device),
        k=torch.zeros((B,), dtype=torch.int32, device=device),
        cols=torch.zeros((B, n, kmax), dtype=dtype, device=device),
        G=eye.clone(),
        Ginv=eye.clone(),
        Atb=torch.zeros((B, kmax), dtype=dtype, device=device),
        coef=torch.zeros((B, kmax), dtype=dtype, device=device),
    )


def contains_batched(st: ActiveSet, i) -> torch.Tensor:
    """(B,) bool: atom index i[b] is in row b's active set."""
    return torch.any(st.mask & (st.idx == i[:, None]), dim=1)


def where_rows(gate, new: ActiveSet, old: ActiveSet) -> ActiveSet:
    """Row b of `new` where gate[b], else of `old` (cstpu's vmapped
    `tree_where`)."""
    def pick(x, y):
        return torch.where(gate.view((-1,) + (1,) * (x.ndim - 1)), x, y)
    return type(new)(*(pick(x, y) for x, y in zip(new, old)))


def _probe_batched(a, st: ActiveSet):
    """`_probe` for every row: (u, d, a'a) of the column a[b] (B, n)
    against row b's active set. `a` must be contiguous: the sums over a
    strided layout round otherwise than over a row's own, and a row's
    result would depend on the batch."""
    g = torch.where(st.mask, vm_rows(a, st.cols), 0)
    ata = torch.sum(a * a, dim=1)
    u = mv_rows(st.Ginv, g)
    return u, ata - torch.sum(g * u, dim=1), ata


def append_col_batched(a, b, st: ActiveSet, i, ok=None) -> ActiveSet:
    """`append_col` for every row where ok[b] (default: every row): the
    column a[b] goes in as atom i[b] with no degeneracy gate, d clamped at
    1e-12 a'a. Callers guard duplicates; a row at capacity keeps its
    state. No refit."""
    ok = torch.ones_like(st.k, dtype=torch.bool) if ok is None else ok
    u, d, ata = _probe_batched(a, st)
    return _border_batched(a, b, st, i, ok & (st.k < st.idx.shape[1]),
                           u, d, ata)


def append_col_gated_batched(a, b, st: ActiveSet, i, ok) -> ActiveSet:
    """`append_col_gated` for every row: the column a[b] (B, n) goes in as
    atom i[b] at row b's first free slot where ok[b]; rows at capacity
    (k == kmax) or whose column is degenerate against the active span
    (d <= 8 n eps(dtype) ||a||^2) keep their state. No refit."""
    kmax = st.idx.shape[1]
    u, d, ata = _probe_batched(a, st)
    rtol = 8.0 * a.shape[1] * torch.finfo(a.dtype).eps
    ok = ok & (st.k < kmax) & (d > rtol * ata)
    return _border_batched(a, b, st, i, ok, u, d, ata)


def append_gated_batched(A, b, st: ActiveSet, i, ok) -> ActiveSet:
    """Gated append of atom i[b] of the dictionary A into row b (see
    append_col_gated_batched)."""
    return append_col_gated_batched(A[:, i.long()].T.contiguous(), b, st, i,
                                    ok)


def _border_batched(a, b, st: ActiveSet, i, ok, u, d, ata) -> ActiveSet:
    """`_border` on the rows where ok[b]: column a[b] written into row b's
    first free slot with the bordered Ginv update; the other rows keep
    their state."""
    kmax = st.idx.shape[1]
    slot = torch.arange(kmax, device=a.device)
    at_p = (slot == st.k[:, None]) & ok[:, None]              # (B, kmax)
    row_p, col_p = at_p[:, :, None], at_p[:, None, :]
    cols = torch.where(col_p, a[:, :, None], st.cols)
    gfull = vm_rows(a, cols)  # 0 on free slots, a'a at p
    G = torch.where(row_p, gfull[:, None, :], st.G)
    G = torch.where(col_p, gfull[:, :, None], G)
    dinv = 1.0 / torch.maximum(d, 1e-12 * torch.clamp(ata, min=1e-30))
    border = -dinv[:, None] * u
    Ginv = st.Ginv + dinv[:, None, None] * (u[:, :, None] * u[:, None, :])
    Ginv = torch.where(row_p, border[:, None, :], Ginv)
    Ginv = torch.where(col_p, border[:, :, None], Ginv)
    Ginv = torch.where(row_p & col_p, dinv[:, None, None], Ginv)
    Ginv = torch.where(ok[:, None, None], Ginv, st.Ginv)
    return ActiveSet(
        idx=torch.where(at_p, i[:, None].to(torch.int32), st.idx),
        mask=st.mask | at_p,
        k=st.k + ok.to(torch.int32),
        cols=cols, G=G, Ginv=Ginv,
        Atb=torch.where(at_p, torch.sum(a * b, dim=1)[:, None], st.Atb),
        coef=st.coef,
    )


def rebuild_batched(A, b, idx, mask) -> ActiveSet:
    """`rebuild` for every row: row b's state for the padded support
    (idx[b], mask[b]) (B, kmax) and measurement b[b], in one shot."""
    B, kmax = idx.shape
    safe = torch.where(mask, idx, 0).long()
    cols = (A[:, safe].permute(1, 0, 2) * mask[:, None, :].to(A.dtype)
            ).contiguous()
    eye = torch.eye(kmax, dtype=A.dtype, device=A.device)
    G = torch.where(mask[:, :, None] & mask[:, None, :],
                    cols.transpose(1, 2) @ cols, eye)
    st = ActiveSet(
        idx=torch.where(mask, idx, A.shape[1]).to(torch.int32),
        mask=mask,
        k=mask.sum(dim=1).to(torch.int32),
        cols=cols,
        G=G,
        Ginv=eye.expand(B, kmax, kmax),
        Atb=vm_rows(b, cols),
        coef=torch.zeros((B, kmax), dtype=A.dtype, device=A.device),
    )
    return refresh_batched(st)


# from this many slots on, refresh_batched inverts as L^-T L^-1: at 1024
# slots a batched cholesky_solve against I takes 11.2-13.6 ms for eight rows
# on an NVIDIA H100, a batched triangular solve and product 3.4; at 321 slots
# (5c-wide's sharded SP) the triangular route took 127-129 ms of the solve's
# device time against 76-79 and its fused and plain solves parted in support
TRIANGULAR_INVERSE_MIN = 512


def refresh_batched(st: ActiveSet) -> ActiveSet:
    """Recompute every row's Ginv exactly from its padded Gram; a row whose
    Gram is not positive definite gets a NaN inverse (no exception). Below
    TRIANGULAR_INVERSE_MIN slots by `cholesky_solve` against the identity,
    from it on as L^-T L^-1 (one batched triangular solve and product)."""
    from cstpu_torch.ops.util import cholesky_nan

    kmax = st.G.shape[1]
    eye = torch.eye(kmax, dtype=st.G.dtype, device=st.G.device)
    Gpad = torch.where(st.mask[:, :, None] & st.mask[:, None, :], st.G, eye)
    L = cholesky_nan(Gpad)
    if kmax < TRIANGULAR_INVERSE_MIN:
        return st._replace(Ginv=torch.cholesky_solve(eye.expand_as(L), L))
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return st._replace(Ginv=Linv.transpose(1, 2) @ Linv)


def delete_batched(st: ActiveSet, pos, m: int) -> ActiveSet:
    """Remove row b's active slot pos[b], compacting left; Ginv is
    recomputed exactly. No refit."""
    B, n, kmax = st.cols.shape
    ar = torch.arange(kmax, device=st.idx.device).expand(B, kmax)
    src = torch.clamp(torch.where(ar >= pos[:, None], ar + 1, ar),
                      max=kmax - 1)
    newmask = ar < (st.k - 1)[:, None]
    eye = torch.eye(kmax, dtype=st.G.dtype, device=st.G.device)
    both = newmask[:, :, None] & newmask[:, None, :]
    G = st.G.gather(1, src[:, :, None].expand(B, kmax, kmax))
    G = G.gather(2, src[:, None, :].expand(B, kmax, kmax))
    st2 = ActiveSet(
        idx=torch.where(newmask, st.idx.gather(1, src), m).to(torch.int32),
        mask=newmask,
        k=st.k - 1,
        cols=torch.where(newmask[:, None, :],
                         st.cols.gather(2, src[:, None, :].expand(B, n, kmax)),
                         0),
        G=torch.where(both, G, eye),
        Ginv=eye.expand(B, kmax, kmax),
        Atb=torch.where(newmask, st.Atb.gather(1, src), 0),
        coef=torch.where(newmask, st.coef.gather(1, src), 0),
    )
    return refresh_batched(st2)


def refit_batched(st: ActiveSet) -> ActiveSet:
    """coef = Ginv @ Atb for every row."""
    coef = mv_rows(st.Ginv, torch.where(st.mask, st.Atb, 0))
    return st._replace(coef=torch.where(st.mask, coef, 0))


def residual_batched(st: ActiveSet, b) -> torch.Tensor:
    """r (B, n) = b - cols @ coef, from the cached active columns."""
    return b - mv_rows(st.cols, st.coef)


def gamma_batched(st: ActiveSet) -> torch.Tensor:
    """(B, kmax): every row's diag((A_i'A_i)^-1) over its active slots (junk
    elsewhere; callers mask)."""
    return torch.diagonal(st.Ginv, dim1=1, dim2=2)


def ols_rescaling_batched(A, st: ActiveSet, colnorm2) -> torch.Tensor:
    """(B, m): every row's squared energetic norms ||a_j||^2 -
    ||proj_active a_j||^2."""
    W = st.cols.transpose(1, 2) @ A
    return colnorm2 - torch.sum(W * (st.Ginv @ W), dim=1)


def active_marker_batched(st: ActiveSet, m: int) -> torch.Tensor:
    """(B, m) bool marking every row's active atom indices."""
    z = torch.zeros((st.idx.shape[0], m + 1), dtype=torch.bool,
                    device=st.idx.device)
    z.scatter_(1, torch.where(st.mask, st.idx, m).long(), st.mask)
    return z[:, :m]


def one_row(st):
    """A per-instance state (any NamedTuple of tensors) as a batch of one
    row."""
    return type(st)(*(x[None] for x in st))


def row_of(st, b: int = 0):
    """Row b of a batched state as a per-instance state."""
    return type(st)(*(x[b] for x in st))


def w_of(st: ActiveSet, a) -> torch.Tensor:
    """Orthonormalized direction of column `a` (n,) against one instance's
    active set: w = a_perp / sqrt(d), d = a'a - g'u clamped at 1e-12 * a'a.
    It carries an append's rescaling downdate (resc_j -= (w'a_j)^2) into the
    next streamed sweep of the sharded FR/SRR/RMP/FoBa solvers. Always
    f32, whatever the dictionary's dtype: it feeds the f32 rescaling."""
    g = torch.where(st.mask, st.cols.T @ a, 0)
    u = st.Ginv @ g
    aperp = a - st.cols @ u
    ata = a @ a
    d = torch.maximum(ata - g @ u, 1e-12 * torch.clamp(ata, min=1e-30))
    return (aperp * torch.sqrt(1.0 / d)).to(torch.float32)


def w_of_batched(st: ActiveSet, a) -> torch.Tensor:
    """`w_of` for every row: a (B, n) against row b's active set, (B, n)
    f32."""
    g = torch.where(st.mask, torch.einsum("bnk,bn->bk", st.cols, a), 0)
    u = torch.einsum("bkj,bj->bk", st.Ginv, g)
    aperp = a - torch.einsum("bnk,bk->bn", st.cols, u)
    ata = torch.sum(a * a, dim=1)
    d = torch.maximum(ata - torch.sum(g * u, dim=1),
                      1e-12 * torch.clamp(ata, min=1e-30))
    return (aperp * torch.sqrt(1.0 / d)[:, None]).to(torch.float32)


def finalize_batched(st: ActiveSet, m: int):
    """Sort every row's active set by atom index; a batched
    SparseSolution."""
    from cstpu_torch.utils.sparse import SparseSolution

    key = torch.where(st.mask, st.idx, INT32_MAX)
    order = torch.argsort(key, dim=1, stable=True)
    mask = st.mask.gather(1, order)
    return SparseSolution(
        idx=torch.where(mask, st.idx.gather(1, order), m).to(torch.int32),
        val=torch.where(mask, st.coef.gather(1, order), 0),
        mask=mask,
        m=int(m),
    )
