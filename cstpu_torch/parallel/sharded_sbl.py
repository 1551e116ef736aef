"""Column-sharded Sparse Bayesian Learning over a mesh of shards (PyTorch
counterpart of cstpu.parallel.sharded_sbl): `fsbl_sharded` and
`rmps_sharded`. Signatures are cstpu's without `atoms_axis` and
`batch_axis`: the port's mesh has its two axes by name (as in the port's
other sharded solvers).

The per-action cost at large m is the S/Q sweep Av = A'v, an m-length pass
over the dictionary. The per-atom state (alpha, S, Q) lies with the atom
columns, per shard on the shard's device, so that sweep, the action scoring
and the init products run on the local shards; C^-1 (B, n, n), the noise
and the owner's scalars lie on the batch row's home device, where cstpu
replicates them:

  per action: local action deltas -> pmax of the local bests, pmin of the
  global indices that match (INT_MAX for no candidate) -> one packed psum
  of the owner's six scalars and a masked psum of the owner's column ->
  rank-one C^-1 downdate at home -> LOCAL Av sweep and S/Q/alpha updates.

The posterior mean uses mu = Gamma A' C^-1 b, one local product per shard,
with C rebuilt exactly from the final alpha (`_rebuild_C`). The noise is a
scalar variance or a full (n, n) covariance. Over a mesh that spans
processes each process keeps the state of its own shards and solves the
batch rows it has a shard of; every process returns the whole result.

Each `lax.while_loop` of cstpu is a Python loop that reads its latch from
the device once an action (RMPS's drift-budget refresh, `refresh_actions`,
is decided on the host from the count of actions its stage loops ran).
`sbl.LOOP_COUNTS` counts the actions and the latch reads. Everything runs
in true f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cstpu_torch.models.sbl import (LOOP_COUNTS, _delta_add,
                                    _delta_delete, _delta_update, _get_sq,
                                    _optimal_alpha, _sigma_matrix, _stopped)
from cstpu_torch.ops.util import cholesky_nan, solve_nan, true_f32
from cstpu_torch.parallel.mesh import (Mesh, ShardedDictionary, shard_batch,
                                       shard_dictionary)

INT_MAX = torch.iinfo(torch.int32).max
KCAP = 64                 # slots of the gathered C rebuild
TEMP_BYTES = 1 << 30      # most bytes of one column-chunked temporary


class _Row(NamedTuple):
    """One batch row of the mesh: its shards in this process (with their
    global shard indices) and where its state lies."""
    mesh: Mesh
    i: int                # the batch row
    js: tuple             # this process's shards of the row, ascending
    home: torch.device
    devs: tuple
    A: tuple              # the shards (n, m_local)
    ml: int

    def pmax(self, xs):
        return self.mesh.pmax(xs, self.home, self.i)

    def pmin(self, xs):
        return self.mesh.pmin(xs, self.home, self.i)

    def psum(self, xs):
        return self.mesh.psum(xs, self.home, self.i)

    def cat(self, xs, dim: int = 0):
        """The row's shards' pieces, whole, at home."""
        return self.mesh.cat(xs, self.home, self.i, dim)

    @property
    def m(self) -> int:
        return self.ml * self.mesh.shape["atoms"]


def _row(mesh: Mesh, Ash: ShardedDictionary, i: int) -> _Row:
    """Batch row i's `_Row` in this process."""
    js = mesh.local(i)
    return _Row(mesh, i, js, mesh.home(i),
                tuple(mesh.devices[i][j] for j in js),
                tuple(Ash.shards[i][j] for j in js),
                Ash.shape[1] // mesh.shape["atoms"])


def _check_sigma(sigma, n: int, entry: str) -> None:
    shape = tuple(torch.as_tensor(sigma).shape)
    if len(shape) == 0:
        return
    if shape != (n, n):
        raise ValueError(
            f"{entry}: sigma must be a scalar variance or an (n, n) "
            f"covariance with n = {n}, got shape {shape}")


def _chunk(ml: int, col_bytes: int) -> int:
    """Columns per chunk so that a temporary of col_bytes per column stays
    within TEMP_BYTES."""
    return max(1, min(ml, TEMP_BYTES // max(col_bytes, 1)))


def _dense_part(A_l, g):
    """sum_k gamma_k a_k a_k' over the whole shard, row by row, in column
    chunks: never a (B, n, m_local) temporary."""
    n, ml = A_l.shape
    B = g.shape[0]
    out = torch.zeros((B, n, n), dtype=A_l.dtype, device=A_l.device)
    c = _chunk(ml, n * A_l.element_size())
    for r in range(B):
        for c0 in range(0, ml, c):
            Ac = A_l[:, c0:c0 + c]
            out[r] += (Ac * g[r, c0:c0 + c]) @ Ac.T
    return out


def _gathered_part(A_l, g, kcap: int):
    """The same Gram partial from each row's top-kcap |gamma| columns:
    exact while no row has more than kcap actives (a zero-gamma pad adds a
    zero column)."""
    n = A_l.shape[0]
    B = g.shape[0]
    gi = torch.topk(torch.abs(g), kcap, dim=1).indices       # (B, kcap)
    gsel = g.gather(1, gi)
    cols = A_l[:, gi.reshape(-1)].reshape(n, B, kcap).permute(1, 0, 2)
    return (cols * gsel[:, None, :]) @ cols.transpose(1, 2)


def _rebuild_C(row: _Row, gammas, sigma):
    """C = Sigma + A diag(gamma) A' (B, n, n) at home, rebuilt exactly from
    per-shard Gram partials (one psum). gamma is nonzero on the active atoms
    only, so a shard gathers each row's top-kcap |gamma| columns, kcap =
    min(m_local, 64), and pays O(n^2 kcap); a shard where some row has more
    than kcap actives runs the dense rebuild instead (the same result,
    slower)."""
    kcap = min(row.ml, KCAP)
    parts = []
    for A_l, g in zip(row.A, gammas):
        if kcap < row.ml and int((g != 0).sum(1).max()) <= kcap:
            parts.append(_gathered_part(A_l, g, kcap))
        else:
            parts.append(_dense_part(A_l, g))
    return row.psum(parts) + _sigma_matrix(sigma, row.A[0].shape[0])


def _gammas(alphas):
    return [torch.where(torch.isfinite(a), 1.0 / a, 0.0) for a in alphas]


def _posterior_mean_local(row: _Row, Bs, alphas, sigma):
    """mu = Gamma A' C^-1 b with C rebuilt exactly from the final alpha
    (which discards the downdate chain's drift): (B, m) at home."""
    gammas = _gammas(alphas)
    Cb = solve_nan(_rebuild_C(row, gammas, sigma), Bs)
    return row.cat([g * (Cb.to(dev) @ A_l)
                    for A_l, g, dev in zip(row.A, gammas, row.devs)], dim=1)


def _init_sq_empty(row: _Row, Bs, sigma):
    """Closed-form (S, Q, C^-1) at the EMPTY active set (C = Sigma): scalar
    noise is elementwise, a covariance two Cholesky solves."""
    B, n = Bs.shape
    eye = torch.eye(n, dtype=Bs.dtype, device=row.home)
    S, Q = [], []
    if sigma.ndim == 2:
        L = cholesky_nan(sigma)
        Cinv = torch.cholesky_solve(eye, L).expand(B, n, n).clone()
        for A_l, dev in zip(row.A, row.devs):
            SiA = torch.cholesky_solve(A_l, L.to(dev))           # (n, ml)
            S.append(torch.sum(SiA * A_l, dim=0).expand(B, -1).clone())
            Q.append(Bs.to(dev) @ SiA)
    else:
        Cinv = (eye / sigma).expand(B, n, n).clone()
        for A_l, dev in zip(row.A, row.devs):
            s2 = sigma.to(dev)
            S.append((torch.sum(A_l * A_l, dim=0) / s2).expand(B, -1).clone())
            Q.append((Bs.to(dev) @ A_l) / s2)
    return S, Q, Cinv


def _sq_refresh(row: _Row, Bs, alphas, sigma):
    """Rebuild (S, Q, C^-1) exactly from alpha: C from one psum of the
    shards' Gram partials, the sweeps local. The S sweep runs in column
    chunks whose (B, n, chunk) temporary stays within TEMP_BYTES."""
    B, n = Bs.shape
    eye = torch.eye(n, dtype=Bs.dtype, device=row.home)
    Cinv = solve_nan(_rebuild_C(row, _gammas(alphas), sigma),
                     eye.expand(B, n, n))
    CB = torch.einsum("bij,bi->bj", Cinv, Bs)
    S, Q = [], []
    for A_l, dev in zip(row.A, row.devs):
        Cd = Cinv.to(dev)
        S_l = torch.empty((B, row.ml), dtype=Bs.dtype, device=dev)
        c = _chunk(row.ml, B * n * A_l.element_size())
        for c0 in range(0, row.ml, c):
            Ac = A_l[:, c0:c0 + c]
            S_l[:, c0:c0 + c] = torch.sum((Cd @ Ac) * Ac, dim=1)
        S.append(S_l)
        Q.append(CB.to(dev) @ A_l)
    return S, Q, Cinv


def _iota(row: _Row, dev):
    return torch.arange(row.ml, device=dev)[None, :]


def _gmaxmin(row: _Row, vals, mode_max: bool):
    """Collective arg-extreme with lowest-global-index ties: (the extreme
    (B,), its global index (B,) int64, INT_MAX where no shard matches)."""
    red = torch.amax if mode_max else torch.amin
    lext = [red(v, dim=1) for v in vals]
    gext = (row.pmax if mode_max else row.pmin)(lext)
    cands = []
    for j, v, le, dev in zip(row.js, vals, lext, row.devs):
        ge = gext.to(dev)
        lloc = torch.amin(torch.where(v == ge[:, None], _iota(row, dev),
                                      INT_MAX), dim=1)
        cands.append(torch.where(le == ge, j * row.ml + lloc, INT_MAX))
    return gext, row.pmin(cands)


def _owner(row: _Row, j: int, gsel, dev):
    """(owner mask, local index or 0) of shard j for the selection."""
    g = gsel.to(dev)
    owner = (g // row.ml) == j
    return owner, torch.where(owner, g % row.ml, 0)


def _owner_scalars(row: _Row, xs, gsel):
    """The owner's values of several per-atom arrays (`xs`: one list of
    per-shard (B, ml) tensors each) in ONE packed psum."""
    parts = []
    for c, (j, dev) in enumerate(zip(row.js, row.devs)):
        owner, sel = _owner(row, j, gsel, dev)
        parts.append(torch.stack([x[c].gather(1, sel[:, None])[:, 0]
                                  for x in xs], dim=1)
                     * owner.to(xs[0][c].dtype)[:, None])
    packed = row.psum(parts)
    return [packed[:, i] for i in range(len(xs))]


def _apply_action(row: _Row, alpha, S, Q, Cinv, gsel, gamma_change,
                  new_alpha_i, S_i, Q_i, gate):
    """The rank-one action: C^-1 downdate at home, LOCAL Av sweep and
    S/Q/alpha updates. gamma_change must be 0 where gate is False; S_i,
    Q_i are the owner's scalars."""
    parts, owners = [], []
    for j, A_l, dev in zip(row.js, row.A, row.devs):
        owner, sel = _owner(row, j, gsel, dev)
        parts.append(A_l[:, sel].T * owner.to(A_l.dtype)[:, None])
        owners.append(owner)
    acol = row.psum(parts)                                      # (B, n)
    v = torch.einsum("bij,bj->bi", Cinv, acol)
    nz = gamma_change != 0
    denom = 1.0 / torch.where(nz, gamma_change, 1.0) + S_i
    dinv = torch.where(nz, gate.to(v.dtype) / denom, 0.0)       # (B,)
    Cinv = Cinv - dinv[:, None, None] * v[:, :, None] * v[:, None, :]
    alpha2, S2, Q2 = [], [], []
    for j, (A_l, dev) in enumerate(zip(row.A, row.devs)):
        dv, Qd = dinv.to(dev)[:, None], Q_i.to(dev)[:, None]
        Av = v.to(dev) @ A_l
        S2.append(S[j] - dv * Av * Av)
        Q2.append(Q[j] - dv * Av * Qd)
        mark = torch.where(owners[j] & gate.to(dev), gsel.to(dev) % row.ml,
                           -1)
        alpha2.append(torch.where(_iota(row, dev) == mark[:, None],
                                  new_alpha_i.to(dev)[:, None], alpha[j]))
    return alpha2, S2, Q2, Cinv


def _nan0(x):
    return torch.where(torch.isnan(x), 0.0, x)


def _fsbl_row(row: _Row, Bs, sigma, maxiter: int, min_increase):
    """Batched FSBL with atom-sharded (alpha, S, Q) over one batch row of
    the mesh. Parity: cstpu.models.sbl._fsbl (greedy best-action
    ascent)."""
    B = Bs.shape[0]
    S, Q, Cinv = _init_sq_empty(row, Bs, sigma)
    alpha = [torch.full((B, row.ml), torch.inf, dtype=Bs.dtype, device=dev)
             for dev in row.devs]
    done = torch.zeros((B,), dtype=torch.bool, device=row.home)
    for _ in range(maxiter):
        if _stopped(done):
            break
        LOOP_COUNTS["steps"] += 1
        ds, fields = [], ([], [], [], [], S, Q)
        for a, S_l, Q_l in zip(alpha, S, Q):
            s, q = _get_sq(S_l, Q_l, a)
            active = torch.isfinite(a)
            relevant = s < q * q
            alphan = _optimal_alpha(s, q)
            d = torch.where(~active & relevant, _delta_add(S_l, Q_l),
                torch.where(active & ~relevant, _delta_delete(S_l, Q_l, a),
                torch.where(active & relevant,
                            _delta_update(S_l, Q_l, a, alphan), 0.0)))
            ds.append(_nan0(d))
            for x, y in zip(fields, (active.to(a.dtype),
                                     relevant.to(a.dtype),
                                     torch.where(active, a, 0.0),
                                     torch.where(relevant, alphan, 0.0))):
                x.append(y)
        gmax, gsel = _gmaxmin(row, ds, True)
        act, rel, a_i, an_i, S_i, Q_i = _owner_scalars(row, fields, gsel)
        act_i, rel_i = act > 0.5, rel > 0.5
        a_i = torch.where(act_i, a_i, torch.inf)
        gamma_change = torch.where(~act_i & rel_i, 1.0 / an_i,
                       torch.where(act_i & ~rel_i, -1.0 / a_i,
                       torch.where(act_i & rel_i, 1.0 / an_i - 1.0 / a_i,
                                   0.0)))
        ok = ~done & (gmax > 0)
        gamma_change = torch.where(ok, gamma_change, 0.0)
        new_alpha_i = torch.where(rel_i, an_i, torch.inf)
        alpha, S, Q, Cinv = _apply_action(row, alpha, S, Q, Cinv, gsel,
                                          gamma_change, new_alpha_i, S_i,
                                          Q_i, ok)
        # negated >=: a NaN gain stops the row
        done = done | ~(gmax >= min_increase)
    return _posterior_mean_local(row, Bs, alpha, sigma)


def _rmps_row(row: _Row, Bs, sigma, maxiter: int, maxiter_acq: int,
              maxiter_del: int, min_increase, refresh_actions: int):
    """Batched RMPS with atom-sharded (alpha, S, Q) over one batch row of
    the mesh. Parity: cstpu.models.sbl._rmps_optimize, with the exact
    S/Q/C^-1 refresh on a drift budget (every `refresh_actions` rank-one
    actions, mid-stage where needed) instead of every outer iteration."""
    B = Bs.shape[0]

    def sq(a, S_l, Q_l):
        s, q = _get_sq(S_l, Q_l, a)
        return s, q, torch.isfinite(a), s < q * q

    def acquisition(alpha, S, Q, Cinv, stop):
        vals, fields = [], ([], S, Q)
        for a, S_l, Q_l in zip(alpha, S, Q):
            s, q, active, relevant = sq(a, S_l, Q_l)
            add = ~active & relevant
            vals.append(_nan0(torch.where(add, _delta_add(S_l, Q_l), 0.0)))
            fields[0].append(torch.where(add, _optimal_alpha(s, q), 0.0))
        gmax, gsel = _gmaxmin(row, vals, True)
        do = ~stop & (gmax > 0)
        an, S_i, Q_i = _owner_scalars(row, fields, gsel)
        gc = torch.where(do, 1.0 / an, 0.0)
        alpha, S, Q, Cinv = _apply_action(row, alpha, S, Q, Cinv, gsel, gc,
                                          an, S_i, Q_i, do)
        return alpha, S, Q, Cinv, stop | ~do

    def deletion_update(alpha, S, Q, Cinv, stop):
        dvs, uvs, fields = [], [], ([], [], S, Q)
        for a, S_l, Q_l in zip(alpha, S, Q):
            s, q, active, relevant = sq(a, S_l, Q_l)
            dvs.append(torch.where(active & ~relevant, q * q / s, torch.inf))
            alphan = _optimal_alpha(s, q)
            uvs.append(_nan0(torch.where(active & relevant,
                                         _delta_update(S_l, Q_l, a, alphan),
                                         0.0)))
            fields[0].append(torch.where(active, a, 0.0))
            fields[1].append(torch.where(relevant, alphan, 0.0))
        dmin, kd = _gmaxmin(row, dvs, False)
        do_del = dmin < 1
        umax, ku = _gmaxmin(row, uvs, True)
        do_upd = ~do_del & (umax > 0)
        upd_gain = torch.where(do_upd, umax, 0.0)
        gsel = torch.where(do_del, kd, ku)
        a_sel, an_sel, S_i, Q_i = _owner_scalars(row, fields, gsel)
        do = ~stop & (do_del | do_upd)
        gc = torch.where(do_del, -1.0 / a_sel,
                         torch.where(do_upd, 1.0 / an_sel - 1.0 / a_sel, 0.0))
        gc = torch.where(do, gc, 0.0)
        new_a = torch.where(do_del, torch.inf, an_sel)
        alpha, S, Q, Cinv = _apply_action(row, alpha, S, Q, Cinv, gsel, gc,
                                          new_a, S_i, Q_i, do)
        return alpha, S, Q, Cinv, stop | (~do_del & (upd_gain < min_increase))

    def run_stage(body, maxiter_s, alpha, S, Q, Cinv, enabled, acts):
        """One coordinate-ascent stage with the drift-budget refresh INSIDE
        the loop: once `acts` rank-one actions ran since the last exact
        rebuild, the state is re-anchored before the next action, mid-stage
        where needed (drifted S/Q otherwise keep finding phantom adds)."""
        stop = ~enabled
        j = 0
        while j < maxiter_s and not _stopped(stop):
            if acts >= refresh_actions:
                S, Q, Cinv = _sq_refresh(row, Bs, alpha, sigma)
                acts = 0
            LOOP_COUNTS["steps"] += 1
            alpha, S, Q, Cinv, stop = body(alpha, S, Q, Cinv, stop)
            j += 1
            acts += 1
        return alpha, S, Q, Cinv, acts

    def alpha_eq(a, b):
        eq = [torch.all((x == y) | (torch.isinf(x) & torch.isinf(y)), dim=1)
              .to(torch.int32) for x, y in zip(a, b)]
        return row.pmin(eq) > 0

    def has_beneficial_add(alpha, S, Q):
        best = []
        for a, S_l, Q_l in zip(alpha, S, Q):
            s, q, active, relevant = sq(a, S_l, Q_l)
            best.append(torch.amax(_nan0(torch.where(
                ~active & relevant, _delta_add(S_l, Q_l), 0.0)), dim=1))
        return row.pmax(best) > 0

    alpha = [torch.full((B, row.ml), torch.inf, dtype=Bs.dtype, device=dev)
             for dev in row.devs]
    old = alpha
    acts = 0
    done = torch.zeros((B,), dtype=torch.bool, device=row.home)
    for t in range(maxiter):
        if t and _stopped(done):
            break
        if t == 0:
            # alpha = Inf: the closed-form empty-set state
            S, Q, Cinv = _init_sq_empty(row, Bs, sigma)
            acts = 0
        alpha, S, Q, Cinv, acts = run_stage(acquisition, maxiter_acq, alpha,
                                            S, Q, Cinv, ~done, acts)
        done1 = done | alpha_eq(alpha, old)
        old1 = alpha
        alpha, S, Q, Cinv, acts = run_stage(deletion_update, maxiter_del,
                                            alpha, S, Q, Cinv, ~done1, acts)
        # a capped acquisition stage with beneficial adds still pending has
        # not converged even if the deletion stage changed nothing
        done = done1 | (alpha_eq(alpha, old1)
                        & ~has_beneficial_add(alpha, S, Q))
        old = alpha
    return _posterior_mean_local(row, Bs, alpha, sigma)


def _setup(A, Bs, sigma, mesh: Mesh, entry: str):
    """Checks shared by both solvers, then (rows, measurement slices on
    their homes, the noise on each home)."""
    if not isinstance(A, (torch.Tensor, ShardedDictionary)):
        A = torch.as_tensor(A)
    n, m = A.shape
    _check_sigma(sigma, n, entry)
    s, b = mesh.shape["atoms"], mesh.shape["batch"]
    if m % s:
        raise ValueError(f"m = {m} not divisible by atom shards {s}")
    if isinstance(Bs, (tuple, list)):       # shard_batch's slices
        slices = tuple(Bs)
        if len(slices) != b:
            raise ValueError(f"{entry}: {len(slices)} measurement slices "
                             f"for {b} batch shards")
    else:
        Bs = torch.as_tensor(Bs)
        if Bs.shape[0] % b:
            raise ValueError(f"B = {Bs.shape[0]} not divisible by batch "
                             f"shards {b}")
        slices = shard_batch(Bs, mesh)
    Ash = A if isinstance(A, ShardedDictionary) else shard_dictionary(A, mesh)
    rows = tuple(_row(mesh, Ash, i) for i in mesh.rows())
    slices = tuple(slices[row.i].to(row.home, Ash.dtype) for row in rows)
    sigmas = tuple(torch.as_tensor(sigma, dtype=Ash.dtype, device=row.home)
                   for row in rows)
    return rows, slices, sigmas, n, m


def _gather(rows, out):
    """The rows' posterior means as every batch row's, (B, m)."""
    return rows[0].mesh.cat_rows({row.i: x for row, x in zip(rows, out)},
                                 rows[0].home)


def fsbl_sharded(A, Bs, sigma, mesh: Mesh, maxiter: int | None = None,
                 min_increase: float = 1e-6):
    """Batched FSBL with the dictionary and the per-atom state
    column-sharded.

    Returns the dense posterior-mean weights (B, m) on the home device of
    this process's first batch row. Semantics of cstpu_torch.fsbl over
    the rows; `sigma` is a scalar noise variance or a full (n, n)
    covariance. `A` may be a tensor or the result of `shard_dictionary`,
    `Bs` a tensor or the result of `shard_batch`.
    """
    rows, slices, sigmas, n, m = _setup(A, Bs, sigma, mesh, "fsbl_sharded")
    maxiter = int(maxiter if maxiter is not None else 2 * m)
    with true_f32():
        return _gather(rows, [
            _fsbl_row(row, b, s2, maxiter,
                      torch.as_tensor(min_increase, dtype=b.dtype,
                                      device=row.home))
            for row, b, s2 in zip(rows, slices, sigmas)])


def rmps_sharded(A, Bs, sigma, mesh: Mesh, maxiter: int | None = None,
                 maxiter_acquisition: int | None = None,
                 maxiter_deletion: int | None = None,
                 min_increase: float = 1e-6, refresh_actions: int = 128):
    """Batched RMPS with the dictionary and the per-atom state
    column-sharded.

    Returns the dense posterior-mean weights (B, m) on the home device of
    this process's first batch row. Semantics of cstpu_torch.rmps over
    the rows; `sigma` as in fsbl_sharded.

    `refresh_actions`: the exact-refresh drift budget. S/Q/C^-1 are rebuilt
    from alpha once the unrefreshed rank-one chain reaches this many
    actions (an exact-arithmetic no-op that bounds f32 drift). The final
    posterior mean is always rebuilt exactly from alpha.
    """
    rows, slices, sigmas, n, m = _setup(A, Bs, sigma, mesh, "rmps_sharded")
    its = tuple(int(x if x is not None else n)
                for x in (maxiter, maxiter_acquisition, maxiter_deletion))
    with true_f32():
        return _gather(rows, [
            _rmps_row(row, b, s2, *its,
                      torch.as_tensor(min_increase, dtype=b.dtype,
                                      device=row.home),
                      int(refresh_actions))
            for row, b, s2 in zip(rows, slices, sigmas)])
