"""Batched greedy solvers on hand-written CUDA kernels (PyTorch counterpart
of cstpu.ops.fused_solve): OMP, MP, GOMP and forward regression (FR).

cstpu runs each whole k-step solve in one Pallas launch with the dictionary
pinned in TPU VMEM (`_solve_kernel`, `_mp_kernel`, `_gomp_kernel`,
`_fr_kernel`), or, for OMP, streamed tile by tile when it is too large for
VMEM (`_stream_kernel`). On Hopper a block has at most 227 KB of shared
memory, while the bench dictionary (16 MB in bf16) fits the 50 MB L2. So
the port runs a Python loop over the steps, and each step launches a select
kernel, which sweeps the dictionary and writes per-tile partials, and an
update kernel, one block per row, or for omp_append, fr_append and
gomp_append a thread-block cluster per row, for mp_update a grid of
several blocks per row (cstpu_torch/csrc):

  OMP   select_argmax  |round_cdt(r) . A_cdt| -> (max, lowest argmax) (B, T)
        omp_append     reduce, gated bordered append, residual; at the
                       last step the rank sort by atom index
  MP    select_argmax  the same, with the winner's signed score
        mp_update      x[i] += v, r -= v a_i
  GOMP  select_topl    per-tile top-l of the same scores, (B, T, l)
        gomp_append    merge to the row's top-l; l gated appends into the
                       per-row slot count; residual and epsilon latch
  FR    fr_select      resc -= dinv (aperp . a_j)^2 for step t-1, then the
                       OLS score q^2 / resc with the active and degenerate
                       masks -> (max, lowest argmax) (B, T)
        fr_append      stopping rules, gated append, aperp and dinv for the
                       next select, residual, stop latch

The selects stream the dictionary tile by tile at every m, which is the
design `_stream_kernel` exists for, so `omp_stream_solve` runs on the same
kernels; the gates differ only in whether the cdt dictionary fits the L2
cache. GOMP and FR return their slots in insertion order, and
`_sorted_solution` sorts them by atom index in torch, as cstpu sorts them
in XLA after its kernels (`_to_solution`).

Precision is cstpu's: the dictionary and the vector that meets it enter
each product in `corr_dtype` (bf16 by default, f32 on request, never
TF32); the products and every sum, Ginv, the coefficients, the rescalings
and the residual are f32. The solve is exact for the cdt-rounded
dictionary.

Every kernel has its plain PyTorch version beside it (`_select_ref`,
`_append_ref`, `_mp_update_ref`, `_topl_ref`, `_gomp_append_ref`,
`_fr_select_ref`, `_fr_append_ref`); each `*_fused_solve_ref` is the whole
solve on them. A wrapper runs the plain version only for tensors on the
CPU; on CUDA tensors it launches its kernel or raises. Solver state is
updated in place, one set of buffers for all steps.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache, partial
from typing import NamedTuple

import torch

from cstpu_torch.ops import _build
from cstpu_torch.utils.sparse import SparseSolution

INT_MAX = torch.iinfo(torch.int32).max
TILE = 128             # atoms per select block and per partial (kTile)
KMAX = 128             # most steps the append kernels' shared Ginv holds
LMAX = 32              # most GOMP picks per iteration (kTopLMax)
SMEM_MAX = 232448      # bytes of shared memory one sm_90 block may use
L2_BYTES = 40 << 20    # cdt dictionary size kept resident in the 50 MB L2

# Kernel launches made by the wrappers below, by kernel. The selects have
# two hand-written variants with a key each: "select_mma", "select_topl_mma"
# and "fr_select_mma" count the tensor-core loop, "select", "select_topl"
# and "fr_select" the CUDA-core one (see `mma_select_takes`).
LAUNCHES = {"select": 0, "select_mma": 0, "append": 0, "mp_update": 0,
            "select_topl": 0, "select_topl_mma": 0, "gomp_append": 0,
            "fr_select": 0, "fr_select_mma": 0, "fr_append": 0}


def _degeneracy_rtol(n: int) -> float:
    """Relative threshold below which an atom's orthogonal component is
    numerical noise in f32-accumulated Gram arithmetic (~8n f32 ulps).
    Appends with d <= rtol * ||a||^2 are rejected, and FR scores atoms with
    rescaling <= rtol * ||a||^2 as degenerate. It uses f32's eps whatever
    the correlation dtype (the active-set engine's gated append uses the
    eps of its own dtype instead)."""
    return 8.0 * n * 1.1920929e-07


def _f32(x: float) -> float:
    """x rounded to f32, as the kernels receive a threshold."""
    return float(torch.tensor(float(x), dtype=torch.float32))


class _OmpState(NamedTuple):
    cols: torch.Tensor   # (B, k, n) f32, slot t = column appended at step t
    Ginv: torch.Tensor   # (B, k, k) f32, identity on unused slots
    coef: torch.Tensor   # (B, k) f32
    idx: torch.Tensor    # (B, k) i32, m on unused slots
    r: torch.Tensor      # (B, n) f32 residual


class _GompState(NamedTuple):
    cols: torch.Tensor   # (B, k, n) f32, slots in insertion order
    Ginv: torch.Tensor   # (B, k, k) f32
    coef: torch.Tensor   # (B, k) f32
    idx: torch.Tensor    # (B, k) i32
    r: torch.Tensor      # (B, n) f32
    kcnt: torch.Tensor   # (B,) i32 slots in use
    done: torch.Tensor   # (B,) f32 epsilon/full latch (1 = stopped)


class _FrState(NamedTuple):
    cols: torch.Tensor   # (B, k, n) f32, slot t = column appended at step t
    Ginv: torch.Tensor   # (B, k, k) f32
    coef: torch.Tensor   # (B, k) f32
    idx: torch.Tensor    # (B, k) i32
    r: torch.Tensor      # (B, n) f32
    resc: torch.Tensor   # (B, m) f32 rescalings ||a_j||^2 - ||proj a_j||^2
    amask: torch.Tensor  # (B, m) u8, 1 on active atoms
    aperp: torch.Tensor  # (B, n) f32 last appended column minus its projection
    dinv: torch.Tensor   # (B,) f32 1/d of the last append, 0 if rejected
    done: torch.Tensor   # (B,) f32 stop latch (1 = stopped)


_CDTS = (torch.bfloat16, torch.float32)
_F32 = (torch.float32,)
_I32 = (torch.int32,)
_U8 = (torch.uint8,)


def _check_cdt(corr_dtype):
    if corr_dtype not in _CDTS:
        raise ValueError(f"corr_dtype must be torch.bfloat16 or "
                         f"torch.float32, got {corr_dtype}")
    return corr_dtype


def _append_smem(n: int, k: int) -> int:
    """Dynamic shared memory, bytes, that a one-block-per-row append of
    the first port took (the acquired column, Ginv, g, u, coef and idx).
    Every append wrapper admits n and k only where it fits SMEM_MAX: the
    domain of the OMP/FR path, whose cluster kernels (`_append_plan`) take
    any n it admits."""
    return (n + k * k + 3 * k) * 4 + k * 4


def _expect(name: str, dev, *specs) -> None:
    """Raise ValueError unless every (tensor, dtypes, shape) of `specs` is
    contiguous, on `dev`, of one of `dtypes` and of `shape`."""
    for x, dtypes, shape in specs:
        if (x.device != dev or not x.is_contiguous() or x.dtype not in dtypes
                or tuple(x.shape) != tuple(shape)):
            raise ValueError(
                f"{name}: need a contiguous {tuple(shape)} tensor of "
                f"{dtypes} on {dev}, got {tuple(x.shape)} {x.dtype} "
                f"{x.device} (contiguous={x.is_contiguous()})")


def _on_cpu(*tensors) -> bool:
    """True when no tensor of `tensors` (None entries skipped) is on CUDA."""
    return not any(x is not None and x.is_cuda for x in tensors)


def _stream():
    return torch.cuda.current_stream().cuda_stream


# --------------------------------------------------------------------------
# Selects
# --------------------------------------------------------------------------

def _tile_argmax(scores):
    """Per-tile (max, lowest argmax) of scores (B, m), (B, T) each, with
    T = ceil(m / TILE); a NaN anywhere in a tile makes it (NaN, INT_MAX)."""
    B, m = scores.shape
    T = -(-m // TILE)
    s = torch.nn.functional.pad(scores, (0, T * TILE - m),
                                value=-torch.inf).view(B, T, TILE)
    tmax = torch.amax(s, dim=2)
    col = torch.arange(T * TILE, device=scores.device).view(1, T, TILE)
    tidx = torch.amin(torch.where(s == tmax[..., None], col, INT_MAX), dim=2)
    return tmax, tidx.to(torch.int32)


def _select_ref(r, Ac, cdt, signed: bool = False, amask=None,
                eta: float = 1.0):
    """Plain select: per-tile (max |score|, lowest argmax), (B, T) each,
    and with `signed` the winner's signed score as a third (B, T). With an
    active-atom mask amask (B, m) the score is where(active, -inf,
    |eta * score|), OMPR's passive select.

    `Ac` holds cdt-rounded values in any float dtype. A NaN anywhere in a
    tile makes its partial (NaN, INT_MAX[, NaN])."""
    m = Ac.shape[1]
    scores = torch.matmul(r.to(cdt).float(), Ac.float())
    if amask is None:
        tmax, tidx = _tile_argmax(torch.abs(scores))
    else:
        tmax, tidx = _tile_argmax(torch.where(
            amask.bool(), -torch.inf, torch.abs(_f32(eta) * scores)))
    if not signed:
        return tmax, tidx
    sig = scores.gather(1, tidx.clamp(max=m - 1).long())
    return tmax, tidx, torch.where(torch.isnan(tmax), torch.nan, sig)


def mma_select_takes(dtype, data_ptr: int, lda: int, m: int) -> bool:
    """The variant predicate of the top-1 selects: True when the tensor-core
    loop (csrc/mma_select.cuh) takes a dictionary of `dtype` at address
    `data_ptr` with m atoms and rows `lda` entries apart. It takes bf16
    correlation only (f32 stays true f32 on CUDA cores), and its loads need
    a base aligned to 16 bytes and a row pitch that is a multiple of 16
    bytes (8 entries). Any n, any B and a ragged m are fine: the loads
    zero-fill the edges. What it does not take goes to the CUDA-core
    kernel, never to the plain twin."""
    return (dtype == torch.bfloat16 and data_ptr % 16 == 0 and lda % 8 == 0
            and lda >= m >= 1)


def _pick_mma(mma, Ac) -> bool:
    """The variant a top-1 select runs on the dictionary (view) Ac: the
    predicate's answer, or the caller's `mma` (True or False) when it
    forces one; forcing the tensor-core loop on what it does not take
    makes the C entry point return an error."""
    if mma is None:
        return mma_select_takes(Ac.dtype, Ac.data_ptr(), Ac.stride(0),
                                Ac.shape[1])
    return bool(mma)


def _rounded_scratch(B: int, n: int, dev):
    """The tensor-core loop's scratch for the bf16-rounded residuals,
    (B, roundup(n, 8)); the kernel fills it."""
    return torch.empty((B, -(-n // 8) * 8), dtype=torch.bfloat16, device=dev)


@lru_cache(maxsize=None)
def _rescaled_plan(B: int, nterms: int, ntiles: int):
    """(G, Pn, rows) of the tensor-core rescaled select for B rows, `nterms`
    rescaling products before the residuals' and `ntiles` tiles, as
    csrc/mma_rescaled.cuh::rescaled_plan decides it: G row groups of 8 and
    Pn product slots a block, and the rows the stacked operand's scratch
    must hold."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.load().cstpu_rescaled_plan(B, nterms, ntiles, out),
                 "cstpu_rescaled_plan")
    return tuple(out)


def select_argmax(r, Ac, signed: bool = False, amask=None, eta: float = 1.0,
                  mma=None):
    """Per-tile select partials for residuals r (B, n) f32 against the
    dictionary Ac (n, m) in its correlation dtype: (pval (B, T) f32,
    pidx (B, T) i32), T = ceil(m / TILE), and with `signed` the winners'
    signed scores psig (B, T) f32. With amask (B, m) u8 the active atoms
    score -inf and the others |eta * score| (OMPR). On CUDA tensors this
    launches csrc/select_argmax.cu: its tensor-core variant where
    `mma_select_takes` says so (counted under "select_mma"), else its
    CUDA-core variant ("select"); `mma` = True or False forces one."""
    if _on_cpu(r, Ac, amask):
        return _select_ref(r, Ac, Ac.dtype, signed, amask, eta)
    B, n = r.shape
    m = Ac.shape[1] if Ac.ndim == 2 else 0
    _expect("select_argmax", r.device, (r, _F32, (B, n)),
            (Ac, _CDTS, (n, m)))
    if amask is not None:
        if signed:
            raise ValueError("select_argmax: a mask and a signed output "
                             "are not served together")
        _expect("select_argmax", r.device, (amask, _U8, (B, m)))
    T = -(-m // TILE)
    pval = torch.empty((B, T), dtype=torch.float32, device=r.device)
    pidx = torch.empty((B, T), dtype=torch.int32, device=r.device)
    psig = torch.empty_like(pval) if signed else None
    use_mma = _pick_mma(mma, Ac)
    rb = _rounded_scratch(B, n, r.device) if use_mma else None
    lib = _build.load()
    with torch.cuda.device(r.device):
        err = lib.cstpu_select_argmax(
            r.data_ptr(), Ac.data_ptr(), int(Ac.dtype == torch.bfloat16),
            pval.data_ptr(), pidx.data_ptr(),
            psig.data_ptr() if signed else None,
            None if amask is None else amask.data_ptr(), float(eta), B, n,
            m, int(use_mma), None if rb is None else rb.data_ptr(),
            _stream())
    _build.check(err, "cstpu_select_argmax")
    LAUNCHES["select_mma" if use_mma else "select"] += 1
    return (pval, pidx, psig) if signed else (pval, pidx)


def _topl_ref(r, Ac, cdt, l: int):
    """Plain top-l select: per tile the l largest |score|, value descending
    then index ascending, (B, T, l) each; a tile holding a NaN gives l
    (NaN, INT_MAX); the ragged edge pads with (-inf, INT_MAX)."""
    B = r.shape[0]
    m = Ac.shape[1]
    T = -(-m // TILE)
    scores = torch.abs(torch.matmul(r.to(cdt).float(), Ac.float()))
    s = torch.nn.functional.pad(scores, (0, T * TILE - m),
                                value=-torch.inf).view(B, T, TILE)
    col = torch.arange(T * TILE, device=r.device).view(1, T, TILE)
    col = torch.where(col < m, col, INT_MAX).expand(B, T, TILE)
    vals, order = torch.sort(s, dim=2, descending=True, stable=True)
    pval, pidx = vals[..., :l], col.gather(2, order[..., :l])
    nan = torch.isnan(s).any(dim=2, keepdim=True)
    return (torch.where(nan, torch.nan, pval),
            torch.where(nan, INT_MAX, pidx).to(torch.int32))


def select_topl(r, Ac, l: int, mma=None):
    """Per-tile top-l partials for residuals r (B, n) f32 against Ac (n, m)
    in its correlation dtype: (pval, pidx), (B, T, l) each, 1 <= l <= LMAX.
    On CUDA tensors this launches csrc/select_topl.cu: its tensor-core
    variant (csrc/mma_topl.cuh) where `mma_select_takes` says so (counted
    under "select_topl_mma"), else its CUDA-core variant ("select_topl");
    `mma` = True or False forces one."""
    l = int(l)
    if _on_cpu(r, Ac):
        return _topl_ref(r, Ac, Ac.dtype, l)
    B, n = r.shape
    m = Ac.shape[1] if Ac.ndim == 2 else 0
    if not 1 <= l <= LMAX:
        raise ValueError(f"select_topl: l={l} outside 1..{LMAX}")
    _expect("select_topl", r.device, (r, _F32, (B, n)), (Ac, _CDTS, (n, m)))
    T = -(-m // TILE)
    pval = torch.empty((B, T, l), dtype=torch.float32, device=r.device)
    pidx = torch.empty((B, T, l), dtype=torch.int32, device=r.device)
    use_mma = _pick_mma(mma, Ac)
    rb = _rounded_scratch(B, n, r.device) if use_mma else None
    lib = _build.load()
    with torch.cuda.device(r.device):
        err = lib.cstpu_select_topl(
            r.data_ptr(), Ac.data_ptr(), int(Ac.dtype == torch.bfloat16),
            pval.data_ptr(), pidx.data_ptr(), B, n, m, l, int(use_mma),
            None if rb is None else rb.data_ptr(), _stream())
    _build.check(err, "cstpu_select_topl")
    LAUNCHES["select_topl_mma" if use_mma else "select_topl"] += 1
    return pval, pidx


def _rescaled_select_ref(Ac, cn2, r, U, W, wsign: float, amask, resc, cdt):
    """Plain rescaled select: applies the P pending rank-one terms to resc
    in place, resc += (wsign * W[p]) (U[p] . a_j)^2 for p = 0..P-1 in
    order (U (P, B, n) rounded to cdt, W (P, B)), then per-tile (max,
    lowest argmax) of the OLS score q^2 / resc, with active atoms at 0 and
    degenerate ones at -inf."""
    n = Ac.shape[0]
    Af = Ac.float()
    for p in range(U.shape[0]):
        z = torch.matmul(U[p].to(cdt).float(), Af)
        resc.add_((wsign * W[p])[:, None] * z * z)
    q = torch.matmul(r.to(cdt).float(), Af)
    rmin = _f32(_degeneracy_rtol(n)) * cn2[None, :]
    d2 = torch.where(resc > rmin, q * q / resc, -torch.inf)
    return _tile_argmax(torch.where(amask.bool(), 0.0, d2))


def _fr_select_ref(Ac, cn2, st: _FrState, cdt):
    """Plain FR select: downdates st.resc in place with the last append's
    (aperp, dinv), resc -= dinv (aperp . a_j)^2, then scores as
    `_rescaled_select_ref`."""
    return _rescaled_select_ref(Ac, cn2, st.r, st.aperp[None],
                                st.dinv[None], -1.0, st.amask, st.resc, cdt)


def rescaled_select(Ac, cn2, r, U, W, wsign: float, amask, resc, mma=None):
    """Rescaled select partials (pval, pidx), (B, T) each: the P pending
    terms of U (P, B, n) f32 and W (P, B) f32 go into resc (B, m) f32 in
    place, then the OLS score with the active mask amask (B, m) u8, against
    Ac (n, m) in its correlation dtype and the f32 squared column norms cn2
    (m,). On CUDA tensors this launches csrc/fr_select.cu: its tensor-core
    variant where `mma_select_takes` says so (counted under
    "fr_select_mma"), else its CUDA-core variant ("fr_select"); `mma` =
    True or False forces one."""
    if _on_cpu(Ac, cn2, r, U, W, amask, resc):
        return _rescaled_select_ref(Ac, cn2, r, U, W, wsign, amask, resc,
                                    Ac.dtype)
    B, n = r.shape
    m = Ac.shape[1] if Ac.ndim == 2 else 0
    P = U.shape[0] if U.ndim == 3 else -1
    _expect("fr_select", Ac.device, (Ac, _CDTS, (n, m)), (cn2, _F32, (m,)),
            (r, _F32, (B, n)), (U, _F32, (P, B, n)), (W, _F32, (P, B)),
            (amask, _U8, (B, m)), (resc, _F32, (B, m)))
    T = -(-m // TILE)
    pval = torch.empty((B, T), dtype=torch.float32, device=Ac.device)
    pidx = torch.empty((B, T), dtype=torch.int32, device=Ac.device)
    use_mma = _pick_mma(mma, Ac)
    rows = _rescaled_plan(B, P, T)[2] if use_mma else 0
    sb = _rounded_scratch(rows, n, Ac.device) if use_mma else None
    lib = _build.load()
    with torch.cuda.device(Ac.device):
        err = lib.cstpu_fr_select(
            r.data_ptr(), U.data_ptr(), W.data_ptr(), P, float(wsign),
            Ac.data_ptr(), int(Ac.dtype == torch.bfloat16), cn2.data_ptr(),
            amask.data_ptr(), resc.data_ptr(), pval.data_ptr(),
            pidx.data_ptr(), B, n, m, _degeneracy_rtol(n), int(use_mma),
            None if sb is None else sb.data_ptr(), rows, _stream())
    _build.check(err, "cstpu_fr_select")
    LAUNCHES["fr_select_mma" if use_mma else "fr_select"] += 1
    return pval, pidx


def fr_select(Ac, cn2, st: _FrState, mma=None):
    """FR select partials (pval, pidx), (B, T) each, for the state `st`
    against Ac (n, m) in its correlation dtype and the f32 squared column
    norms cn2 (m,); downdates st.resc in place with the last append's
    (aperp, dinv), one pending term. On CUDA tensors this launches
    csrc/fr_select.cu (`mma` as `rescaled_select`'s)."""
    return rescaled_select(Ac, cn2, st.r, st.aperp[None], st.dinv[None],
                           -1.0, st.amask, st.resc, mma)


# --------------------------------------------------------------------------
# Updates: the shared bordered append, then one update per solver
# --------------------------------------------------------------------------

def _reduce_partials(pval, pidx):
    """Per-row (max, lowest argmax) over the select partials (B, T);
    (NaN, INT_MAX) for a row whose maximum is NaN."""
    vmax = torch.amax(pval, dim=1, keepdim=True)
    idx = torch.amin(torch.where(pval == vmax, pidx, INT_MAX), dim=1)
    return vmax[:, 0], idx


def _rank_sort(idx, coef):
    """(idx, coef) (B, k) sorted by idx; ties (pads) keep slot order."""
    k = idx.shape[1]
    ki, kj = idx[:, :, None], idx[:, None, :]
    pos = torch.arange(k, device=idx.device)
    less = (kj < ki) | ((kj == ki) & (pos[None, None, :] < pos[None, :, None]))
    rank = less.sum(dim=2)
    return (torch.empty_like(idx).scatter_(1, rank, idx),
            torch.empty_like(coef).scatter_(1, rank, coef))


def _bordered_append_ref(Ac, Bs, st, sel, slot, pre):
    """Plain gated bordered append, the math of cstpu's (fused_solve.py
    :165-201, :587-611, :757-784) batched over rows: atom sel (B,) into slot (B,) (== k: write nothing)
    where pre (B,) allows, updating st.Ginv/coef/idx/cols in place.
    Returns (ok (B,), acol (B, n), u (B, k), dinv (B,))."""
    n, m = Ac.shape
    k = st.idx.shape[1]
    acol = Ac[:, sel.clamp(max=m - 1).long()].T.float()           # (B, n)
    ata = torch.sum(acol * acol, dim=1, keepdim=True)
    beta = torch.sum(acol * Bs, dim=1, keepdim=True)
    g = torch.sum(st.cols * acol[:, None, :], dim=2)              # (B, k)
    hit = torch.arange(k, device=Bs.device)[None, :] == slot[:, None]
    et = hit.float()
    u = torch.sum(st.Ginv * g[:, None, :], dim=2)
    d = ata - torch.sum(g * u, dim=1, keepdim=True)
    dup = torch.any(st.idx == sel[:, None], dim=1, keepdim=True)
    ok = pre[:, None] & ~dup & (d > _degeneracy_rtol(n) * ata)
    okf = ok.float()
    dinv = okf / torch.where(d > 0, d, 1.0)
    s = dinv * (beta - torch.sum(g * st.coef, dim=1, keepdim=True))

    w = u - et
    st.Ginv.copy_(st.Ginv + dinv[:, :, None] * w[:, :, None] * w[:, None, :]
                  - okf[:, :, None] * et[:, None, :] * et[:, :, None])
    st.coef.sub_(s * w)
    st.idx.copy_(torch.where(hit & ok, sel[:, None], st.idx))
    st.cols.copy_(torch.where(hit[:, :, None], (acol * okf)[:, None, :],
                              st.cols))
    return ok[:, 0], acol, u, dinv[:, 0]


def _residual(Bs, st):
    """r = b - cols' coef, (B, n)."""
    return Bs - torch.sum(st.cols * st.coef[:, :, None], dim=1)


def _append_ref(pval, pidx, Ac, Bs, st: _OmpState, t: int, out_idx,
                out_coef):
    """Plain append step t: the same math as csrc/omp_append.cu, batched
    over rows, updating `st` in place."""
    B = Bs.shape[0]
    k = st.idx.shape[1]
    i = _reduce_partials(pval, pidx)[1]
    _bordered_append_ref(Ac, Bs, st, i,
                         torch.full((B,), t, device=Bs.device),
                         torch.ones((B,), dtype=torch.bool, device=Bs.device))
    st.r.copy_(_residual(Bs, st))
    if t == k - 1:
        sidx, scoef = _rank_sort(st.idx, st.coef)
        out_idx.copy_(sidx)
        out_coef.copy_(scoef)


def omp_append(pval, pidx, Ac, Bs, st: _OmpState, t: int, out_idx,
               out_coef):
    """OMP step t from the select partials: updates `st` in place and, at
    t = k-1, writes the index-sorted support into out_idx/out_coef. On
    CUDA tensors this launches csrc/omp_append.cu, a thread-block cluster
    per row (`_append_plan`)."""
    if _on_cpu(pval, pidx, Ac, Bs, *st, out_idx, out_coef):
        return _append_ref(pval, pidx, Ac, Bs, st, t, out_idx, out_coef)
    B, k, n = st.cols.shape
    m = Ac.shape[1] if Ac.ndim == 2 else 0
    if not 0 <= t < k <= KMAX or _append_smem(n, k) > SMEM_MAX:
        raise ValueError(f"omp_append: k={k}, t={t}, n={n} outside the "
                         f"kernel's limits (k <= {KMAX}, shared memory)")
    T = -(-m // TILE)
    _expect("omp_append", Bs.device, (pval, _F32, (B, T)),
            (pidx, _I32, (B, T)), (Ac, _CDTS, (n, m)), (Bs, _F32, (B, n)),
            (st.cols, _F32, (B, k, n)), (st.Ginv, _F32, (B, k, k)),
            (st.coef, _F32, (B, k)), (st.idx, _I32, (B, k)),
            (st.r, _F32, (B, n)), (out_idx, _I32, (B, k)),
            (out_coef, _F32, (B, k)))
    lib = _build.load()
    with torch.cuda.device(Bs.device):
        err = lib.cstpu_omp_append(
            pval.data_ptr(), pidx.data_ptr(), T, Ac.data_ptr(),
            int(Ac.dtype == torch.bfloat16), Bs.data_ptr(),
            st.cols.data_ptr(), st.Ginv.data_ptr(), st.coef.data_ptr(),
            st.idx.data_ptr(), st.r.data_ptr(), out_idx.data_ptr(),
            out_coef.data_ptr(), B, n, m, k, t, _degeneracy_rtol(n),
            _stream())
    _build.check(err, "cstpu_omp_append")
    LAUNCHES["append"] += 1


class _AppendPlan(NamedTuple):
    C: int        # blocks of a row's thread-block cluster
    slice: int    # entries of n a block owns (the last block: the rest)
    staged: bool  # the live slot columns staged in shared memory
    smem: int     # dynamic shared memory of a block, bytes


def _append_plan(B: int, n: int, k: int) -> _AppendPlan:
    """The launch plan of omp_append and fr_append for B rows, n and k
    slots, as csrc/omp_append.cu::append_plan decides it."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.load().cstpu_append_plan(B, n, k, out),
                 "cstpu_append_plan")
    C, slice_, staged, smem = out
    return _AppendPlan(C, slice_, bool(staged), smem)


class _GompPlan(NamedTuple):
    C: int        # blocks of a row's thread-block cluster
    slice: int    # entries of n a block owns (the last block: the rest)
    staged: bool  # the old slot columns and b staged in shared memory
    smem: int     # dynamic shared memory of a block, bytes
    R: int        # picks a round: one exchange of partials a round
    W: int        # entries of a pick's slice gathered at once


def _gomp_plan(B: int, n: int, k: int, cnt: int) -> _GompPlan:
    """The launch plan of gomp_append for B rows, n, k slots and cnt picks,
    as csrc/gomp_ompr_cluster.cuh::gomp_plan decides it."""
    out = (ctypes.c_int * 6)()
    _build.check(_build.load().cstpu_gomp_plan(B, n, k, cnt, out),
                 "cstpu_gomp_plan")
    C, slice_, staged, smem, R, W = out
    return _GompPlan(C, slice_, bool(staged), smem, R, W)


def _mp_update_ref(pval, pidx, psig, Ac, x, r):
    """Plain MP step: x[i] += v, r -= v a_i per row with the winner's
    signed score v; a NaN row (index INT_MAX) is left as it is."""
    m = Ac.shape[1]
    i = _reduce_partials(pval, pidx)[1]
    live = i < m
    ic = i.clamp(max=m - 1).long()
    v = torch.where(live, psig.gather(1, (ic // TILE)[:, None])[:, 0], 0.0)
    x.scatter_add_(1, ic[:, None], v[:, None])
    acol = Ac[:, ic].T.float()
    r.copy_(torch.where(live[:, None], r - v[:, None] * acol, r))


class _MpPlan(NamedTuple):
    C: int        # blocks a row (a grid of B C blocks, no cluster)
    slice: int    # entries of n a block owns (the last block: the rest)
    threads: int  # threads a block


def _mp_plan(B: int, n: int) -> _MpPlan:
    """The launch plan of mp_update for B rows of length n, as
    csrc/mp_update.cu::mp_plan decides it."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.load().cstpu_mp_plan(B, n, out), "cstpu_mp_plan")
    return _MpPlan(*out)


def mp_update(pval, pidx, psig, Ac, x, r):
    """MP step from the signed select partials: updates x (B, m) and r
    (B, n) f32 in place. On CUDA tensors this launches csrc/mp_update.cu,
    B C blocks (`_mp_plan`)."""
    if _on_cpu(pval, pidx, psig, Ac, x, r):
        return _mp_update_ref(pval, pidx, psig, Ac, x, r)
    B, n = r.shape
    m = Ac.shape[1] if Ac.ndim == 2 else 0
    T = -(-m // TILE)
    _expect("mp_update", r.device, (pval, _F32, (B, T)),
            (pidx, _I32, (B, T)), (psig, _F32, (B, T)),
            (Ac, _CDTS, (n, m)), (x, _F32, (B, m)), (r, _F32, (B, n)))
    lib = _build.load()
    with torch.cuda.device(r.device):
        err = lib.cstpu_mp_update(
            pval.data_ptr(), pidx.data_ptr(), psig.data_ptr(), T,
            Ac.data_ptr(), int(Ac.dtype == torch.bfloat16), x.data_ptr(),
            r.data_ptr(), B, n, m, _stream())
    _build.check(err, "cstpu_mp_update")
    LAUNCHES["mp_update"] += 1


def _merge_topl_vals(pval, pidx, cnt: int):
    """Each row's top-cnt of its (B, T, l) partials, value descending then
    index ascending: (values, indices), (B, cnt) each; a row holding a NaN
    gets (-inf, INT_MAX) throughout."""
    B = pval.shape[0]
    v, i = pval.reshape(B, -1), pidx.reshape(B, -1)
    by_idx = torch.argsort(i, dim=1, stable=True)
    v, i = v.gather(1, by_idx), i.gather(1, by_idx)
    by_val = torch.argsort(v, dim=1, descending=True, stable=True)
    vals = v.gather(1, by_val)[:, :cnt]
    picks = i.gather(1, by_val)[:, :cnt]
    nan = torch.isnan(pval.reshape(B, -1)).any(1, keepdim=True)
    return (torch.where(nan, -torch.inf, vals),
            torch.where(nan, INT_MAX, picks))


def _merge_topl(pval, pidx, cnt: int):
    """Each row's top-cnt picks of its (B, T, l) partials, value
    descending then index ascending, (B, cnt); all INT_MAX for a row
    holding a NaN."""
    return _merge_topl_vals(pval, pidx, cnt)[1]


def _gomp_append_ref(pval, pidx, Ac, Bs, st: _GompState, cap: int,
                     eps2: float):
    """Plain GOMP iteration: the same math as csrc/gomp_append.cu, batched
    over rows, updating `st` in place."""
    n = Ac.shape[0]
    picks = _merge_topl(pval, pidx, pval.shape[2])
    for p in range(picks.shape[1]):
        pre = (st.kcnt < cap) & (st.done < 0.5)
        ok = _bordered_append_ref(Ac, Bs, st, picks[:, p], st.kcnt.long(),
                                  pre)[0]
        st.kcnt.add_(ok.to(torch.int32))
    st.r.copy_(_residual(Bs, st))
    rr = torch.sum(st.r * st.r, dim=1)
    st.done.copy_(torch.where((rr < _f32(eps2)) | (st.kcnt >= n), 1.0,
                              st.done))


def gomp_append(pval, pidx, Ac, Bs, st: _GompState, cap: int, eps2: float):
    """One GOMP iteration from the top-l partials (B, T, cnt): cnt gated
    appends into each row's slot count, the residual and the epsilon
    latch, updating `st` in place. On CUDA tensors this launches
    csrc/gomp_append.cu, a thread-block cluster per row (`_gomp_plan`)."""
    if _on_cpu(pval, pidx, Ac, Bs, *st):
        return _gomp_append_ref(pval, pidx, Ac, Bs, st, cap, eps2)
    B, k, n = st.cols.shape
    m = Ac.shape[1] if Ac.ndim == 2 else 0
    T = -(-m // TILE)
    cnt = pval.shape[2] if pval.ndim == 3 else 0
    if (not 1 <= cnt <= LMAX or not 1 <= k <= KMAX
            or _append_smem(n, k) > SMEM_MAX):
        raise ValueError(f"gomp_append: cnt={cnt}, k={k}, n={n} outside the "
                         f"kernel's limits (cnt <= {LMAX}, k <= {KMAX}, "
                         "shared memory)")
    _expect("gomp_append", Bs.device, (pval, _F32, (B, T, cnt)),
            (pidx, _I32, (B, T, cnt)), (Ac, _CDTS, (n, m)),
            (Bs, _F32, (B, n)), (st.cols, _F32, (B, k, n)),
            (st.Ginv, _F32, (B, k, k)), (st.coef, _F32, (B, k)),
            (st.idx, _I32, (B, k)), (st.r, _F32, (B, n)),
            (st.kcnt, _I32, (B,)), (st.done, _F32, (B,)))
    lib = _build.load()
    with torch.cuda.device(Bs.device):
        err = lib.cstpu_gomp_append(
            pval.data_ptr(), pidx.data_ptr(), T, cnt, Ac.data_ptr(),
            int(Ac.dtype == torch.bfloat16), Bs.data_ptr(),
            st.cols.data_ptr(), st.Ginv.data_ptr(), st.coef.data_ptr(),
            st.idx.data_ptr(), st.r.data_ptr(), st.kcnt.data_ptr(),
            st.done.data_ptr(), B, n, m, k, int(cap), _degeneracy_rtol(n),
            float(eps2), _stream())
    _build.check(err, "cstpu_gomp_append")
    LAUNCHES["gomp_append"] += 1


def _fr_append_ref(pval, pidx, Ac, Bs, st: _FrState, t: int,
                   max_eps2: float, min_d2: float):
    """Plain FR step t: the same math as csrc/fr_append.cu, batched over
    rows, updating `st` in place."""
    B = Bs.shape[0]
    m = Ac.shape[1]
    dmax, i = _reduce_partials(pval, pidx)
    rr = torch.sum(st.r * st.r, dim=1)
    accept = (rr > _f32(max_eps2)) & (dmax > _f32(min_d2))
    ok, acol, u, dinv = _bordered_append_ref(
        Ac, Bs, st, i, torch.full((B,), t, device=Bs.device),
        accept & (st.done < 0.5))
    st.aperp.copy_(acol - torch.sum(st.cols * u[:, :, None], dim=1))
    st.dinv.copy_(dinv)
    rows = torch.nonzero(ok & (i < m))[:, 0]
    st.amask[rows, i[rows].long()] = 1
    st.r.copy_(_residual(Bs, st))
    st.done.copy_(torch.where(ok, st.done, 1.0))


def fr_append(pval, pidx, Ac, Bs, st: _FrState, t: int, max_eps2: float,
              min_d2: float):
    """FR step t from the fr_select partials: the stopping rules, the gated
    append, aperp/dinv for the next select, the residual and the latch,
    updating `st` in place. On CUDA tensors this launches
    csrc/fr_append.cu, a thread-block cluster per row on omp_append's
    plan."""
    if _on_cpu(pval, pidx, Ac, Bs, *st):
        return _fr_append_ref(pval, pidx, Ac, Bs, st, t, max_eps2, min_d2)
    B, k, n = st.cols.shape
    m = Ac.shape[1] if Ac.ndim == 2 else 0
    if not 0 <= t < k <= KMAX or _append_smem(n, k) > SMEM_MAX:
        raise ValueError(f"fr_append: k={k}, t={t}, n={n} outside the "
                         f"kernel's limits (k <= {KMAX}, shared memory)")
    T = -(-m // TILE)
    _expect("fr_append", Bs.device, (pval, _F32, (B, T)),
            (pidx, _I32, (B, T)), (Ac, _CDTS, (n, m)), (Bs, _F32, (B, n)),
            (st.cols, _F32, (B, k, n)), (st.Ginv, _F32, (B, k, k)),
            (st.coef, _F32, (B, k)), (st.idx, _I32, (B, k)),
            (st.r, _F32, (B, n)), (st.aperp, _F32, (B, n)),
            (st.dinv, _F32, (B,)), (st.amask, _U8, (B, m)),
            (st.done, _F32, (B,)))
    lib = _build.load()
    with torch.cuda.device(Bs.device):
        err = lib.cstpu_fr_append(
            pval.data_ptr(), pidx.data_ptr(), T, Ac.data_ptr(),
            int(Ac.dtype == torch.bfloat16), Bs.data_ptr(),
            st.cols.data_ptr(), st.Ginv.data_ptr(), st.coef.data_ptr(),
            st.idx.data_ptr(), st.r.data_ptr(), st.aperp.data_ptr(),
            st.dinv.data_ptr(), st.amask.data_ptr(), st.done.data_ptr(), B,
            n, m, k, t, _degeneracy_rtol(n), float(max_eps2), float(min_d2),
            _stream())
    _build.check(err, "cstpu_fr_append")
    LAUNCHES["fr_append"] += 1


# --------------------------------------------------------------------------
# The solves
# --------------------------------------------------------------------------

def _slot_state(Bs, k: int, m: int) -> dict:
    """Empty append state for measurements Bs (B, n) f32 with k slots."""
    B, n = Bs.shape
    dev = Bs.device
    f32 = torch.float32
    return dict(cols=torch.zeros((B, k, n), dtype=f32, device=dev),
                Ginv=torch.eye(k, dtype=f32, device=dev).repeat(B, 1, 1),
                coef=torch.zeros((B, k), dtype=f32, device=dev),
                idx=torch.full((B, k), m, dtype=torch.int32, device=dev),
                r=Bs.clone())


def _init_state(Bs, k: int, m: int):
    """Empty OMP state for measurements Bs (B, n) f32, and the (B, k)
    outputs the last append step writes."""
    B = Bs.shape[0]
    dev = Bs.device
    return (_OmpState(**_slot_state(Bs, k, m)),
            torch.empty((B, k), dtype=torch.int32, device=dev),
            torch.empty((B, k), dtype=torch.float32, device=dev))


def _init_gomp(Bs, k: int, m: int) -> _GompState:
    B = Bs.shape[0]
    return _GompState(
        **_slot_state(Bs, k, m),
        kcnt=torch.zeros((B,), dtype=torch.int32, device=Bs.device),
        done=torch.zeros((B,), dtype=torch.float32, device=Bs.device))


def _init_fr(Bs, k: int, cn2) -> _FrState:
    B, n = Bs.shape
    m = cn2.shape[0]
    dev = Bs.device
    return _FrState(
        **_slot_state(Bs, k, m),
        resc=cn2[None, :].repeat(B, 1),
        amask=torch.zeros((B, m), dtype=torch.uint8, device=dev),
        aperp=torch.zeros((B, n), dtype=torch.float32, device=dev),
        dinv=torch.zeros((B,), dtype=torch.float32, device=dev),
        done=torch.zeros((B,), dtype=torch.float32, device=dev))


def _omp_steps(Ac, Bs, k: int, select, append):
    """k OMP steps over the batch: one select and one append each."""
    st, out_idx, out_coef = _init_state(Bs, k, Ac.shape[1])
    for t in range(k):
        pval, pidx = select(st.r, Ac)
        append(pval, pidx, Ac, Bs, st, t, out_idx, out_coef)
    return out_idx, out_coef, st.r


def _to_solution(idx, coef, m: int) -> SparseSolution:
    """Batched (B, k) support and coefficients, already sorted by atom index
    (the OMP append kernel sorts at the last step; GOMP and FR come through
    `_sorted_solution`) -> SparseSolution. Slots holding no atom (index m,
    or INT_MAX from a NaN row) are masked."""
    mask = idx < m
    return SparseSolution(idx=torch.where(mask, idx, m),
                          val=torch.where(mask, coef, 0.0),
                          mask=mask, m=int(m))


def _sorted_solution(idx, coef, m: int) -> SparseSolution:
    """Batched (B, k) slots in insertion order -> SparseSolution sorted by
    atom index, as cstpu's `_to_solution` sorts (masked slots last)."""
    return _to_solution(*_rank_sort(idx, coef), m)


def _prepare(A, Bs, corr_dtype, upcast: bool):
    """(cdt dictionary, f32 measurements), both contiguous. The plain
    versions multiply in f32 on the cdt-rounded values (`upcast`)."""
    Ac = A.to(_check_cdt(corr_dtype))
    if upcast:
        Ac = Ac.float()
    return Ac.contiguous(), Bs.to(torch.float32).contiguous()


def _solve(A, Bs, k: int, corr_dtype, select, append, upcast: bool):
    n, m = A.shape
    k = int(min(k, n, m))
    Ac, Bs = _prepare(A, Bs, corr_dtype, upcast)
    idx, coef, r = _omp_steps(Ac, Bs, k, select, append)
    return _to_solution(idx, coef, m), r


def omp_fused_solve(A, Bs, k: int, corr_dtype=torch.bfloat16):
    """Batched OMP on the select and append kernels.

    A: (n, m) dictionary; Bs: (B, n) measurements; k fixed steps (a
    stalled instance's steps are no-ops). Returns a batched SparseSolution
    sorted by atom index, and the final residuals (B, n) f32.
    """
    return _solve(A, Bs, k, corr_dtype, select_argmax, omp_append, False)


def omp_fused_solve_ref(A, Bs, k: int, corr_dtype=torch.bfloat16):
    """omp_fused_solve on the plain versions of both kernels, on any
    device: the reference the kernels are held against."""
    cdt = _check_cdt(corr_dtype)
    return _solve(A, Bs, k, cdt, partial(_select_ref, cdt=cdt), _append_ref,
                  True)


def omp_stream_solve(A, Bs, k: int, corr_dtype=torch.bfloat16):
    """Batched OMP for dictionaries beyond the L2 cache. The select kernel
    streams the dictionary from device memory tile by tile every step,
    so this is the same solve as omp_fused_solve, with the same result."""
    return omp_fused_solve(A, Bs, k, corr_dtype)


def _mp(A, Bs, k: int, corr_dtype, select, update, upcast: bool):
    Ac, Bs = _prepare(A, Bs, corr_dtype, upcast)
    x = torch.zeros((Bs.shape[0], Ac.shape[1]), dtype=torch.float32,
                    device=Bs.device)
    r = Bs.clone()
    for _ in range(int(k)):
        update(*select(r, Ac), Ac, x, r)
    return x, r


def mp_fused_solve(A, Bs, k: int, corr_dtype=torch.bfloat16):
    """Batched matching pursuit, k steps x[i] += v, r -= v a_i on the
    signed select and the mp_update kernel. Unit-norm columns assumed, as
    cstpu's MP. Returns the dense x (B, m) f32 and r (B, n) f32."""
    return _mp(A, Bs, k, corr_dtype, partial(select_argmax, signed=True),
               mp_update, False)


def mp_fused_solve_ref(A, Bs, k: int, corr_dtype=torch.bfloat16):
    """mp_fused_solve on the plain versions of both kernels."""
    cdt = _check_cdt(corr_dtype)
    return _mp(A, Bs, k, cdt, partial(_select_ref, cdt=cdt, signed=True),
               _mp_update_ref, True)


def _gomp(A, Bs, l: int, k: int, max_residual, corr_dtype, select, append,
          upcast: bool):
    n, m = A.shape
    k = int(min(k, n, m))   # as cstpu: appends beyond n are impossible
    l = int(l)
    if not 1 <= l or min(l, k) > LMAX:
        raise ValueError(f"gomp_fused_solve: need 1 <= l and at most "
                         f"{LMAX} picks per iteration, got l={l}, k={k}")
    Ac, Bs = _prepare(A, Bs, corr_dtype, upcast)
    cap = min(n, k)
    eps2 = float(max_residual) ** 2
    st = _init_gomp(Bs, k, m)
    for _ in range(k // l):
        append(*select(st.r, Ac, l), Ac, Bs, st, cap, eps2)
    if k % l:   # the unconditional remainder iteration, latch reset
        st.done.zero_()
        append(*select(st.r, Ac, k % l), Ac, Bs, st, cap, eps2)
    return _sorted_solution(st.idx, st.coef, m), st.r


def gomp_fused_solve(A, Bs, l: int, k: int, max_residual: float = 0.0,
                     corr_dtype=torch.bfloat16):
    """Batched generalized OMP on the select_topl and gomp_append kernels:
    k // l iterations of l picks with epsilon stopping between them, then
    one unconditional remainder iteration of k % l picks. k is clamped to
    min(k, n, m). Returns a SparseSolution (B, k) sorted by atom index and
    the residuals (B, n) f32."""
    return _gomp(A, Bs, l, k, max_residual, corr_dtype, select_topl,
                 gomp_append, False)


def gomp_fused_solve_ref(A, Bs, l: int, k: int, max_residual: float = 0.0,
                         corr_dtype=torch.bfloat16):
    """gomp_fused_solve on the plain versions of both kernels."""
    cdt = _check_cdt(corr_dtype)
    return _gomp(A, Bs, l, k, max_residual, cdt,
                 lambda r, Ac, l_: _topl_ref(r, Ac, cdt, l_),
                 _gomp_append_ref, True)


def _fr(A, Bs, k: int, max_residual, min_decrease, corr_dtype, select,
        append, upcast: bool):
    n, m = A.shape
    k = int(min(k, n, m))
    cn2 = torch.sum(A.float() * A.float(), dim=0)  # the f32 dictionary's
    Ac, Bs = _prepare(A, Bs, corr_dtype, upcast)
    max_eps2 = float(max_residual) ** 2
    min_d2 = float(min_decrease) ** 2
    st = _init_fr(Bs, k, cn2)
    for t in range(k):
        append(*select(Ac, cn2, st), Ac, Bs, st, t, max_eps2, min_d2)
    return _sorted_solution(st.idx, st.coef, m), st.r


def fr_fused_solve(A, Bs, k: int, max_residual: float = 0.0,
                   min_decrease: float = 0.0, corr_dtype=torch.bfloat16):
    """Batched forward regression with the OLS rule on the fr_select and
    fr_append kernels: k steps, each instance latched off at its first
    rejected step (residual norm <= max_residual, best decrease <=
    min_decrease, or a degenerate/duplicate pick). Returns a SparseSolution
    (B, k) sorted by atom index and the residuals (B, n) f32."""
    return _fr(A, Bs, k, max_residual, min_decrease, corr_dtype, fr_select,
               fr_append, False)


def fr_fused_solve_ref(A, Bs, k: int, max_residual: float = 0.0,
                       min_decrease: float = 0.0, corr_dtype=torch.bfloat16):
    """fr_fused_solve on the plain versions of both kernels."""
    cdt = _check_cdt(corr_dtype)
    return _fr(A, Bs, k, max_residual, min_decrease, cdt,
               partial(_fr_select_ref, cdt=cdt), _fr_append_ref, True)


# --------------------------------------------------------------------------
# Shape gates
# --------------------------------------------------------------------------

def _kernel_ok(A, Bs, k: int) -> bool:
    n, m = A.shape
    k = int(min(k, n, m))
    return (Bs.ndim == 2 and Bs.shape[1] == n and Bs.shape[0] >= 1
            and 1 <= k <= KMAX and _append_smem(n, k) <= SMEM_MAX)


def supported(A, Bs, k: int, corr_dtype=torch.bfloat16) -> bool:
    """Shape gate of omp_fused_solve: k and n within the append kernel's
    shared memory, and the cdt dictionary small enough to stay in L2."""
    itemsize = torch.empty((), dtype=corr_dtype).element_size()
    return (_kernel_ok(A, Bs, k)
            and A.shape[0] * A.shape[1] * itemsize <= L2_BYTES)


def supported_stream(A, Bs, k: int, corr_dtype=torch.bfloat16) -> bool:
    """Shape gate of omp_stream_solve: the solver state must fit the append
    kernel; the dictionary need not fit L2."""
    return _kernel_ok(A, Bs, k)


def supported_mp(A, Bs) -> bool:
    """Shape gate of mp_fused_solve: MP keeps no solver state in shared
    memory, so any (n, m) with B >= 1 rows of length n."""
    return (Bs.ndim == 2 and Bs.shape[1] == A.shape[0] and Bs.shape[0] >= 1
            and A.shape[1] >= 1)


def supported_gomp(A, Bs, l: int, k: int) -> bool:
    """Shape gate of gomp_fused_solve: the append state as for OMP, and at
    most LMAX picks per iteration."""
    kk = int(min(k, *A.shape))
    return _kernel_ok(A, Bs, kk) and 1 <= int(l) and min(int(l), kk) <= LMAX


def supported_fr(A, Bs, k: int, corr_dtype=torch.bfloat16) -> bool:
    """Shape gate of fr_fused_solve: the append state as for OMP (aperp
    goes to device memory, not to shared memory)."""
    return _kernel_ok(A, Bs, k)
