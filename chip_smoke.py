"""Smoke run of cstpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel from cstpu_torch/csrc with nvcc (one process per
source), holds each against its plain PyTorch version on the card, and
drives the main paths, each once with the launch counts zeroed just before
it and read just after:

  omp_batch            batched OMP at the bench size (B=64, n=1024,
                       m=8192, k=32) and at suite config 5b (m=131072)
  mp_batch             batched MP at the bench size, unit-norm dictionary
  gomp_batch(., 4, 32) suite config 2a (B=64, n=1024, m=8192)
  fr_batch(sparsity=16) suite config 3a, correlated dictionary (decay 0.25)
  sp_batch(., 32, maxiter=8)   suite config 2b, on 2a's problem
  ompr_batch(., 32, 1e-12)     config 2c, on 2a's problem
  srr_batch(., 16, 1e-12, maxiter=4)  suite config 3b, on 3a's problem
  rmp_batch(., delta=1e-2, kmax=32), foba_batch(., 1e-2, kmax=32)
                       suite config 3d (n=1024, m=8192, 16 planted ones),
                       at the suite's B=8 and at B=64
  fbr_batch(., sparsity=32), lace_batch(., sparsity=32)
                       suite config 3e (square n=m=1024, 32 planted ones:
                       992 deletions per row), at B=8 and at B=64

It checks planted-support recovery, launch counts (for the two-stage,
stepwise and backward paths against the formulas for the iterations they
ran) and agreement with the plain solves, and times kernels and solves with
CUDA events; the later kernels' device time per launch and the paths' idle
share come from torch.profiler. Every kernel's time stands beside its bound
on an H100 (the bytes it must move over 3.35 TB/s, or its operations over
the peak rate of their type) and, where one PyTorch call computes the same
function, that call's time.

The second-to-last line of standard output is a JSON record of the
kernels; the last line is {"ok": true, "device": {...}}. Any failure
raises, so the exit code is not 0. Without a CUDA device it exits at
once with an error.
"""

import json
import statistics
import subprocess
import sys
import time
from functools import partial

import torch

# bench.py's headline problem, then suite config 5b (benchmarks/suite.py)
CELLS = [("bench", 64, 1024, 8192, 32), ("5b", 64, 1024, 131072, 32)]
SEED = 0
# select: idx must agree where the top-two gap exceeds GAP_RTOL * top score
# (f32 sums over n=1024 products in another order differ by ~1e-6
# relative); values agree to SELECT_RTOL relative.
GAP_RTOL = 1e-4
SELECT_RTOL = 1e-4
# one append step from identical state: Ginv, coef, r, cols to APPEND_ATOL
APPEND_ATOL = 1e-4
# kernel solve against plain solve: identical supports, coefficients to
COEF_ATOL = 1e-3
# MP's dense x and r against the plain solve: 32 steps of f32 updates whose
# scores are sums of n=1024 products in another order (~1e-6 relative each)
MP_ATOL = 1e-3
# FR's written-back rescalings after steps from identical state: absolute,
# they are differences of O(1) terms
RESC_ATOL = 1e-4
TIMED_SOLVES = 7
TIMED_LAUNCHES = 20
# the greedy paths: (name, B, n, m, k, l or decay), after suite configs
MP_CELL = ("mp", 64, 1024, 8192, 32)
GOMP_CELL = ("2a", 64, 1024, 8192, 32, 4)
FR_CELL = ("3a", 64, 1024, 8192, 16, 0.25)
# the two-stage paths: (name, k, keyword arguments), on 2a's and 3a's
# problems (benchmarks/suite.py:178-183, :213-220; gomp_ompr_ab.py:31-59)
SP_CELL = ("2b", 32, {"maxiter": 8})
OMPR_CELL = ("2c", 32, {"delta": 1e-12})
SRR_CELL = ("3b", 16, {"delta": 1e-12, "maxiter": 4})
# one step of a two-stage kernel from identical state: as APPEND_ATOL; the
# latch `prev <= ||r||^2` is compared where ||r||^2 moved by more than
# LATCH_RTOL (a swap that re-adds and drops one atom leaves a rounding tie)
LATCH_RTOL = 1e-5
# the stepwise paths, suite config 3d (benchmarks/suite.py:239-265): n, m,
# planted k, delta, kmax; and the backward ones, config 3e (:268-294): n, m,
# sparsity. Each at the suite's batch and at the other paths'.
STEP_CELL = ("3d", 1024, 8192, 16, 1e-2, 32)
BW_CELL = ("3e", 1024, 1024, 32)
BATCHES = (8, 64)
TIMED_SLOW = 3   # timed calls of the solves that take tenths of a second
# published peaks of one H100 SXM: device memory bytes/s, dense FLOP/s by
# operand type (bf16 on the tensor cores, f32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def planted(gen, B, n, m, k):
    """Unit-norm Gaussian dictionary and B measurements of k-sparse +-1
    signals, all on the generator's device."""
    from cstpu_torch.utils.data import sparse_data, sparse_vector

    A, _, _ = sparse_data(gen, n, m, 1)
    X = torch.stack([sparse_vector(gen, m, k) for _ in range(B)])
    sup = torch.nonzero(X)[:, 1].view(B, k)
    Bs = (A[:, sup] * X.gather(1, sup)[None]).sum(-1).T.contiguous()
    return A, Bs, sup


def planted_ones(gen, A, B, k):
    """B measurements of k-sparse signals with value 1 on a uniformly
    random support each, as the suite plants them (benchmarks/suite.py
    `_planted`)."""
    m = A.shape[1]
    sup = torch.stack([torch.randperm(m, generator=gen, device=A.device)[:k]
                       for _ in range(B)])
    return A[:, sup].sum(-1).T.contiguous(), sup


def recovery(sol, sup):
    """Share of rows whose planted support is inside the returned one."""
    got = torch.where(sol.mask, sol.idx, sol.m).cpu().numpy().tolist()
    return sum(set(s) <= set(g) for s, g in
               zip(sup.cpu().numpy().tolist(), got)) / len(got)


def expect_launches(**counts):
    """The launch counts of one main path: `counts`, and 0 elsewhere."""
    from cstpu_torch.ops import fused_solve as fs

    return {key: counts.get(key, 0) for key in fs.LAUNCHES}


def run_counted(fn):
    """fn() with every launch count set to 0 just before and read just
    after (synchronised); returns (result, counts)."""
    from cstpu_torch.ops import fused_solve as fs

    for key in fs.LAUNCHES:
        fs.LAUNCHES[key] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, dict(fs.LAUNCHES)


def bound(nbytes, flops, kind):
    """The least ms an H100 could take: the bytes (each input read once,
    each output written once) over the memory rate, or the operations over
    the peak rate of their operand type `kind`, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def select_bound(B, n, m, cdt_bytes=2, terms=0, outs=1):
    """A select launch: A (n, m) in cdt, r and `terms` pending vectors
    (B, n) f32, with terms also the rescalings (B, m) f32 both ways, the
    active mask and the column norms; `outs` (value, index) partials per
    tile and row. 2 B n m multiply-adds per product with A."""
    tiles = -(-m // 128)
    nbytes = (n * m * cdt_bytes + (1 + terms) * B * n * 4
              + B * tiles * outs * 8)
    if terms:
        nbytes += 2 * B * m * 4 + B * m + m * 4
    return bound(nbytes, 2 * (1 + terms) * B * n * m,
                 "bf16" if cdt_bytes == 2 else "f32")


def engine_bound(B, K, n, appends=0, deletes=0, refits=1, cdt_bytes=2):
    """A per-row update launch on a K-slot state: the columns (B, K, n),
    Ginv (B, K, K), r and b read, Ginv and r written, one column in per
    append, one vector out per append or delete (the new column, the
    pending term, the cleared slot); all f32 arithmetic."""
    nbytes = 4 * B * (K * n + 2 * K * K + 3 * n + 6 * K)
    nbytes += appends * B * n * (cdt_bytes + 8) + deletes * B * n * 8
    flops = B * (appends * (4 * K * n + 5 * K * K)
                 + deletes * (2 * K * n + 3 * K * K)
                 + refits * (2 * K * n + 2 * K * K))
    return bound(nbytes, flops, "f32")


def cuda_ms(fn, reps):
    """Median ms of `reps` timed calls of fn (after two warm-up calls); each
    call is bracketed by CUDA events and synced by fetching a value."""
    for _ in range(2):
        float(fn())
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fn()
        t1.record()
        float(out)
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def check_select(A, Bs):
    """select_argmax against _select_ref on the card, with a duplicated
    column (lowest index wins) and a NaN row (index INT_MAX)."""
    from cstpu_torch.ops import fused_solve as fs

    m = A.shape[1]
    Ac = A.to(torch.bfloat16)
    Ac[:, m - 5] = Ac[:, 123]
    r = Bs.clone()
    r[0] = Ac[:, 123].float()
    r[1, 5] = float("nan")
    kv, ki = fs._reduce_partials(*fs.select_argmax(r, Ac))
    pv, pi = fs._reduce_partials(*fs._select_ref(r, Ac.float(),
                                                 torch.bfloat16))
    torch.cuda.synchronize()
    assert ki[0].item() == pi[0].item() == 123, (ki[0], pi[0])
    assert ki[1].item() == pi[1].item() == fs.INT_MAX, (ki[1], pi[1])
    assert torch.isnan(kv[1]) and torch.isnan(pv[1])
    scores = torch.abs(r.to(torch.bfloat16).float() @ Ac.float())
    top2 = scores[2:].topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > GAP_RTOL * top2[:, 0]
    agree = (ki[2:] == pi[2:]) | ~clear
    assert bool(agree.all()), "select idx disagree beyond the noise gap"
    err = (kv[2:] - pv[2:]).abs()
    assert bool((err <= SELECT_RTOL * pv[2:].abs()).all()), float(err.max())
    print(f"[select] idx agree on {int(clear.sum())}/{len(clear)} clear rows, "
          f"tie->123, NaN row->INT_MAX; max |val err| {float(err.max()):.3e} "
          f"(rtol {SELECT_RTOL})")
    return float(err.max()), r, Ac


def check_append(A, Bs, k):
    """One append step (the last, with the sort) from identical state."""
    from cstpu_torch.ops import fused_solve as fs

    Ac = A.to(torch.bfloat16).contiguous()
    Ac32 = Ac.float()
    st, *out = fs._init_state(Bs, k, A.shape[1])
    for t in range(k - 1):
        fs._append_ref(*fs._select_ref(st.r, Ac32, torch.bfloat16), Ac32, Bs,
                       st, t, *out)
    parts = fs._select_ref(st.r, Ac32, torch.bfloat16)
    stk = fs._OmpState(*(x.clone() for x in st))
    outk = [x.clone() for x in out]
    fs.omp_append(*parts, Ac, Bs, stk, k - 1, *outk)
    fs._append_ref(*parts, Ac32, Bs, st, k - 1, *out)
    torch.cuda.synchronize()
    assert torch.equal(stk.idx, st.idx) and torch.equal(outk[0], out[0])
    err = max(float((a - b).abs().max()) for a, b in
              ((stk.Ginv, st.Ginv), (stk.coef, st.coef), (stk.r, st.r),
               (stk.cols, st.cols), (outk[1], out[1])))
    assert err <= APPEND_ATOL, err
    print(f"[append] step t={k - 1} from identical state: idx and sorted "
          f"support equal; max |err| Ginv/coef/r/cols {err:.3e} "
          f"(atol {APPEND_ATOL})")
    return err, stk, parts, Ac


def main_path(A, Bs, sup, k):
    """omp_batch once with zeroed launch counts; recovery and the plain
    solve's agreement."""
    import cstpu_torch
    from cstpu_torch.ops import fused_solve as fs

    sol, launches = run_counted(lambda: cstpu_torch.omp_batch(A, Bs, k))
    assert launches == expect_launches(select=k, append=k), launches
    rec = recovery(sol, sup)
    assert rec == 1.0, f"planted-support recovery {rec} != 1.0"
    ref, _ = fs.omp_fused_solve_ref(A, Bs, k)
    assert torch.equal(sol.idx, ref.idx) and torch.equal(sol.mask, ref.mask)
    cerr = float((sol.val - ref.val).abs().max())
    assert cerr <= COEF_ATOL, cerr
    print(f"[main] omp_batch recovery={rec:.3f} launches={launches} "
          f"supports == plain solve, max |coef err| {cerr:.3e} "
          f"(atol {COEF_ATOL})")
    return launches


def per_launch_ms(x, fn):
    """Median ms per call of fn, over 5 timed runs of TIMED_LAUNCHES calls;
    each run ends by fetching an element of x."""
    def run():
        for _ in range(TIMED_LAUNCHES):
            fn()
        return x.flatten()[0]
    return cuda_ms(run, 5) / TIMED_LAUNCHES


def times(A, Bs, k, r, Ac_sel, st, parts, Ac, gpu):
    import cstpu_torch
    from cstpu_torch.ops import fused_solve as fs

    B = Bs.shape[0]
    solve = cuda_ms(lambda: cstpu_torch.omp_batch(A, Bs, k).val.sum(),
                    TIMED_SOLVES)
    plain = cuda_ms(lambda: fs.omp_fused_solve_ref(A, Bs, k)[0].val.sum(),
                    TIMED_SOLVES)
    Ac_sel32 = Ac_sel.float()

    launches = partial(per_launch_ms, Bs)
    sel = launches(lambda: fs.select_argmax(r, Ac_sel))
    sel_p = launches(lambda: fs._select_ref(r, Ac_sel32, torch.bfloat16))
    t = k // 2
    _, *out = fs._init_state(Bs, k, A.shape[1])
    Ac32 = Ac.float()
    app = launches(lambda: fs.omp_append(*parts, Ac, Bs, st, t, *out))
    app_p = launches(lambda: fs._append_ref(*parts, Ac32, Bs, st, t, *out))
    print(f"[time] solve {solve:.4f} ms (plain {plain:.4f} ms), "
          f"{B * k / (solve / 1e3):.1f} atoms/s (plain "
          f"{B * k / (plain / 1e3):.1f}); select {sel:.4f} ms (plain "
          f"{sel_p:.4f}); append {app:.4f} ms (plain {app_p:.4f}) | {gpu}")
    return {"solve": solve, "plain_solve": plain, "select": sel,
            "plain_select": sel_p, "append": app, "plain_append": app_p}


def check_greedy_kernels(A, Bs, Ar, Br, l, k_fr):
    """Each kernel of the MP, GOMP and FR paths against its plain version
    on the card, at the main paths' shapes: the signed select (with a tie
    and a NaN row), mp_update, select_topl (tie, NaN), gomp_append,
    fr_select and fr_append. Returns each kernel's max |err|."""
    from cstpu_torch.ops import fused_solve as fs

    bf = torch.bfloat16
    m = A.shape[1]
    err = {}
    # --- signed select and mp_update (bench dictionary) ------------------
    Ac = A.to(bf).contiguous()
    Ac[:, m - 3] = Ac[:, 77]
    Ac32 = Ac.float()
    r = Bs.clone()
    r[0] = 2.0 * Ac[:, 77].float()
    r[1, 9] = float("nan")
    pv, pi, ps = fs.select_argmax(r, Ac, signed=True)
    pv0, pi0 = fs.select_argmax(r, Ac)
    rv, ri, rs = fs._select_ref(r, Ac32, bf, signed=True)
    torch.cuda.synchronize()
    assert torch.equal(pi, pi0) and torch.equal(pv.nan_to_num(-1.0),
                                                pv0.nan_to_num(-1.0))
    i, ir = fs._reduce_partials(pv, pi)[1], fs._reduce_partials(rv, ri)[1]
    assert int(i[0]) == int(ir[0]) == 77 and int(i[1]) == fs.INT_MAX
    same = (pi == ri) & ~torch.isnan(pv)
    err["select_signed"] = float((ps[same] - rs[same]).abs().max())
    assert bool(((ps[same] - rs[same]).abs()
                 <= SELECT_RTOL * rs[same].abs() + 1e-6).all())
    x = torch.zeros((Bs.shape[0], m), device=A.device)
    xr, rk, rr = x.clone(), r.clone(), r.clone()
    fs.mp_update(pv, pi, ps, Ac, x, rk)
    fs._mp_update_ref(pv, pi, ps, Ac32, xr, rr)
    torch.cuda.synchronize()
    assert torch.equal(x, xr) and not x[1].any()
    assert float(x[0, 77]) == float(ps[0, 0]) and float(x[0, m - 3]) == 0
    ok = ~torch.isnan(rr).any(1)
    err["mp_update"] = float((rk[ok] - rr[ok]).abs().max())
    assert err["mp_update"] <= APPEND_ATOL, err["mp_update"]
    assert torch.isnan(rk[1]).any() and torch.equal(rk[1].isnan(),
                                                    rr[1].isnan())
    print(f"[mp kernels] signed select: partials equal to OMP's, tie->77, "
          f"NaN row->INT_MAX, max |signed err| {err['select_signed']:.3e}; "
          f"mp_update x equal, max |r err| {err['mp_update']:.3e} "
          f"(atol {APPEND_ATOL})")

    # --- select_topl and gomp_append (config 2a dictionary) --------------
    kv, ki = fs.select_topl(r, Ac, l)
    tv, ti = fs._topl_ref(r, Ac32, bf, l)
    torch.cuda.synchronize()
    fin = torch.isfinite(tv)
    assert torch.equal(torch.isfinite(kv), fin)
    err["select_topl"] = float((kv[fin] - tv[fin]).abs().max())
    assert bool(((kv[fin] - tv[fin]).abs()
                 <= SELECT_RTOL * tv[fin].abs() + 1e-6).all())
    picks, pref = fs._merge_topl(kv, ki, l), fs._merge_topl(tv, ti, l)
    assert picks[0, :2].tolist() == [77, m - 3], picks[0]
    assert (picks[1] == fs.INT_MAX).all() and (pref[1] == fs.INT_MAX).all()
    scores = torch.abs(r.to(bf).float() @ Ac32)[2:]
    srt = scores.sort(1, descending=True).values[:, :l + 1]
    clear = ((srt[:, :-1] - srt[:, 1:]) > GAP_RTOL * srt[:, :1]).all(1)
    agree = (picks[2:] == pref[2:]).all(1) | ~clear
    assert bool(agree.all()), "top-l picks disagree beyond the noise gap"
    k = GOMP_CELL[4]
    st = fs._init_gomp(Bs, k, m)
    for _ in range(k // l // 2):
        fs._gomp_append_ref(*fs._topl_ref(st.r, Ac32, bf, l), Ac32, Bs, st,
                            k, 0.0)
    parts = fs._topl_ref(st.r, Ac32, bf, l)
    stk = fs._GompState(*(x.clone() for x in st))
    fs.gomp_append(*parts, Ac, Bs, stk, k, 0.0)
    fs._gomp_append_ref(*parts, Ac32, Bs, st, k, 0.0)
    torch.cuda.synchronize()
    for a, b in ((stk.idx, st.idx), (stk.kcnt, st.kcnt), (stk.done, st.done)):
        assert torch.equal(a, b)
    err["gomp_append"] = max(float((a - b).abs().max()) for a, b in
                             ((stk.Ginv, st.Ginv), (stk.coef, st.coef),
                              (stk.r, st.r), (stk.cols, st.cols)))
    assert err["gomp_append"] <= APPEND_ATOL, err["gomp_append"]
    print(f"[gomp kernels] select_topl l={l}: tie->(77, {m - 3}), NaN row "
          f"all INT_MAX, picks agree on {int(clear.sum())}/{len(clear)} "
          f"clear rows, max |val err| {err['select_topl']:.3e}; "
          f"gomp_append (iteration {k // l // 2}) idx/kcnt/done equal, max "
          f"|err| {err['gomp_append']:.3e} (atol {APPEND_ATOL})")

    # --- fr_select and fr_append (config 3a correlated dictionary) -------
    Arc = Ar.to(bf).contiguous()
    Arc32 = Arc.float()
    cn2 = torch.sum(Ar * Ar, dim=0)
    Brn = Br.clone()
    Brn[3, 0] = float("nan")
    st = fs._init_fr(Brn, k_fr, cn2)
    t = k_fr // 2
    for s in range(t):
        fs._fr_append_ref(*fs._fr_select_ref(Arc32, cn2, st, bf), Arc32, Brn,
                          st, s, 0.0, 0.0)
    stk = fs._FrState(*(x.clone() for x in st))
    kv, ki = fs.fr_select(Arc, cn2, stk)
    pv, pi = fs._fr_select_ref(Arc32, cn2, st, bf)
    torch.cuda.synchronize()
    resc_err = float((stk.resc - st.resc).abs().max())
    assert resc_err <= RESC_ATOL, resc_err
    live = ~torch.isnan(pv)
    assert torch.equal(live, ~torch.isnan(kv))
    assert (ki[3] == fs.INT_MAX).all()
    fin = live & torch.isfinite(pv)
    d2_err = float(((kv[fin] - pv[fin]).abs() / pv[fin].abs().clamp(
        min=1e-30)).max())
    assert d2_err <= SELECT_RTOL, d2_err
    i, ir = fs._reduce_partials(kv, ki)[1], fs._reduce_partials(pv, pi)[1]
    rows = torch.arange(Br.shape[0], device=A.device) != 3
    assert bool((i == ir)[rows].all()), "fr_select picks disagree"
    err["fr_select"] = max(resc_err, float((kv[fin] - pv[fin]).abs().max()))
    fs.fr_append(kv, ki, Arc, Brn, stk, t, 0.0, 0.0)
    fs._fr_append_ref(kv, ki, Arc32, Brn, st, t, 0.0, 0.0)
    torch.cuda.synchronize()
    for a, b in ((stk.idx, st.idx), (stk.done, st.done),
                 (stk.amask, st.amask)):
        assert torch.equal(a, b)
    assert float(stk.done[3]) == 1.0 and not stk.done[rows].any()
    err["fr_append"] = max(float((a[rows] - b[rows]).abs().max())
                           for a, b in ((stk.Ginv, st.Ginv),
                                        (stk.coef, st.coef), (stk.r, st.r),
                                        (stk.cols, st.cols),
                                        (stk.aperp, st.aperp),
                                        (stk.dinv, st.dinv)))
    assert err["fr_append"] <= APPEND_ATOL, err["fr_append"]
    print(f"[fr kernels] fr_select (step {t}) resc max |err| {resc_err:.3e} "
          f"(atol {RESC_ATOL}), d2 max rel err {d2_err:.3e} (rtol "
          f"{SELECT_RTOL}), picks equal, NaN row INT_MAX; fr_append "
          f"idx/done/amask equal, NaN row latched, max |err| "
          f"{err['fr_append']:.3e} (atol {APPEND_ATOL})")
    return err, {"mp": (pv0, pi0, ps, Ac), "fr": (stk, Arc, cn2, kv, ki)}


def greedy_paths(A, Bs, Bg, sup_g, Ar, Br, sup_f):
    """mp_batch, gomp_batch and fr_batch once each with zeroed launch
    counts; recovery and agreement with the plain solves."""
    import cstpu_torch
    from cstpu_torch.ops import fused_solve as fs

    _, B, n, m, k = MP_CELL
    x, launches_mp = run_counted(lambda: cstpu_torch.mp_batch(A, Bs, k))
    assert launches_mp == expect_launches(select=k, mp_update=k), launches_mp
    xr, rr = fs.mp_fused_solve_ref(A, Bs, k)
    Ac32 = A.to(torch.bfloat16).float()
    r = Bs - x @ Ac32.T
    x_err = float((x - xr).abs().max())
    r_err = float((r - rr).abs().max())
    assert x_err <= MP_ATOL and r_err <= MP_ATOL, (x_err, r_err)
    fall = r.norm(dim=1) / Bs.norm(dim=1)
    assert bool((fall < 1).all()), "MP residual did not fall"
    print(f"[main mp] mp_batch k={k} launches={launches_mp}; x, r vs plain "
          f"max |err| {x_err:.3e}, {r_err:.3e} (atol {MP_ATOL}); ||r||/||b|| "
          f"max {float(fall.max()):.4f}")

    _, B, n, m, k, l = GOMP_CELL
    sol, launches_g = run_counted(
        lambda: cstpu_torch.gomp_batch(A, Bg, l, k))
    it = -(-k // l)
    assert launches_g == expect_launches(select_topl=it, gomp_append=it), \
        launches_g
    rec_g = recovery(sol, sup_g)
    assert rec_g == 1.0, f"gomp_batch recovery {rec_g} != 1.0"
    ref, _ = fs.gomp_fused_solve_ref(A, Bg, l, k)
    assert torch.equal(sol.idx, ref.idx) and torch.equal(sol.mask, ref.mask)
    g_err = float((sol.val - ref.val).abs().max())
    assert g_err <= COEF_ATOL, g_err
    print(f"[main 2a] gomp_batch l={l} k={k} recovery={rec_g:.3f} "
          f"launches={launches_g}; supports == plain solve, max |coef err| "
          f"{g_err:.3e} (atol {COEF_ATOL})")

    _, B, n, m, k, decay = FR_CELL
    sol, launches_f = run_counted(
        lambda: cstpu_torch.fr_batch(Ar, Br, sparsity=k))
    assert launches_f == expect_launches(fr_select=k, fr_append=k), \
        launches_f
    rec_f = recovery(sol, sup_f)
    assert rec_f == 1.0, f"fr_batch recovery {rec_f} != 1.0"
    ref, _ = fs.fr_fused_solve_ref(Ar, Br, k)
    assert torch.equal(sol.idx, ref.idx) and torch.equal(sol.mask, ref.mask)
    f_err = float((sol.val - ref.val).abs().max())
    assert f_err <= COEF_ATOL, f_err
    print(f"[main 3a] fr_batch sparsity={k} (correlated, decay {decay}) "
          f"recovery={rec_f:.3f} launches={launches_f}; supports == plain "
          f"solve, max |coef err| {f_err:.3e} (atol {COEF_ATOL})")
    return {"mp": launches_mp, "gomp": launches_g, "fr": launches_f,
            "recovery": {"2a": rec_g, "3a": rec_f},
            "err": {"mp_x": x_err, "gomp_coef": g_err, "fr_coef": f_err}}


def greedy_times(A, Bs, Bg, Ar, Br, parts, gpu):
    """Solve and per-launch times of the three greedy paths against their
    plain versions (CUDA events)."""
    import cstpu_torch
    from cstpu_torch.ops import fused_solve as fs

    bf = torch.bfloat16
    tm = {}
    k = MP_CELL[4]
    _, _, _, _, kg, l = GOMP_CELL
    kf = FR_CELL[4]
    B = Bs.shape[0]
    for name, fn, ref, atoms in (
            ("mp", lambda: cstpu_torch.mp_batch(A, Bs, k).sum(),
             lambda: fs.mp_fused_solve_ref(A, Bs, k)[0].sum(), B * k),
            ("gomp", lambda: cstpu_torch.gomp_batch(A, Bg, l, kg).val.sum(),
             lambda: fs.gomp_fused_solve_ref(A, Bg, l, kg)[0].val.sum(),
             B * kg),
            ("fr", lambda: cstpu_torch.fr_batch(Ar, Br, sparsity=kf).val.sum(),
             lambda: fs.fr_fused_solve_ref(Ar, Br, kf)[0].val.sum(), B * kf)):
        tm[name] = cuda_ms(fn, TIMED_SOLVES)
        tm["plain_" + name] = cuda_ms(ref, TIMED_SOLVES)
        tm[name + "_atoms_per_s"] = atoms / (tm[name] / 1e3)
        tm["plain_" + name + "_atoms_per_s"] = atoms / (tm["plain_" + name]
                                                       / 1e3)

    launches = partial(per_launch_ms, Bs)
    pv, pi, ps, Ac = parts["mp"]
    Ac32 = Ac.float()
    r = Bs.clone()
    tm["select_signed"] = launches(lambda: fs.select_argmax(r, Ac, True))
    tm["plain_select_signed"] = launches(
        lambda: fs._select_ref(r, Ac32, bf, True))
    x = torch.zeros((B, A.shape[1]), device=A.device)
    tm["mp_update"] = launches(lambda: fs.mp_update(pv, pi, ps, Ac, x, r))
    tm["plain_mp_update"] = launches(
        lambda: fs._mp_update_ref(pv, pi, ps, Ac32, x, r))
    r = Bg.clone()
    tm["select_topl"] = launches(lambda: fs.select_topl(r, Ac, l))
    tm["plain_select_topl"] = launches(lambda: fs._topl_ref(r, Ac32, bf, l))
    st = fs._init_gomp(Bg, kg, A.shape[1])
    gparts = fs._topl_ref(st.r, Ac32, bf, l)
    tm["gomp_append"] = launches(
        lambda: fs.gomp_append(*gparts, Ac, Bg, st, kg, 0.0))
    st = fs._init_gomp(Bg, kg, A.shape[1])
    tm["plain_gomp_append"] = launches(
        lambda: fs._gomp_append_ref(*gparts, Ac32, Bg, st, kg, 0.0))
    stf, Arc, cn2, kv, ki = parts["fr"]
    Arc32 = Arc.float()
    t = kf // 2
    for key, fn in (
            ("fr_select", lambda s: fs.fr_select(Arc, cn2, s)),
            ("plain_fr_select", lambda s: fs._fr_select_ref(Arc32, cn2, s, bf)),
            ("fr_append",
             lambda s: fs.fr_append(kv, ki, Arc, Br, s, t, 0.0, 0.0)),
            ("plain_fr_append",
             lambda s: fs._fr_append_ref(kv, ki, Arc32, Br, s, t, 0.0, 0.0))):
        s = fs._FrState(*(x.clone() for x in stf))
        tm[key] = launches(lambda: fn(s))
    print("[time greedy] " + ", ".join(
        f"{name} {tm[name]:.4f} ms (plain {tm['plain_' + name]:.4f})"
        for name in ("mp", "gomp", "fr", "select_signed", "mp_update",
                     "select_topl", "gomp_append", "fr_select", "fr_append"))
        + f"; atoms/s mp {tm['mp_atoms_per_s']:.1f} (plain "
        f"{tm['plain_mp_atoms_per_s']:.1f}), gomp {tm['gomp_atoms_per_s']:.1f}"
        f" (plain {tm['plain_gomp_atoms_per_s']:.1f}), fr "
        f"{tm['fr_atoms_per_s']:.1f} (plain {tm['plain_fr_atoms_per_s']:.1f})"
        f" | {gpu}")
    return tm


def _clone(st):
    return type(st)(*(None if x is None else x.clone() for x in st))


def _state_err(stk, st, rows, prev0=None):
    """Max |err| over the float fields of two engine or SP states on
    `rows`; idx and amask must be equal there, done and fgate where the
    residual norm moved clearly from prev0."""
    clear = torch.ones_like(st.done, dtype=torch.bool)
    if prev0 is not None:
        clear = (st.prev - prev0).abs() > LATCH_RTOL * prev0.abs()
    clear = clear & rows
    err = 0.0
    for name, a, b in zip(st._fields, stk, st):
        if a is None or name.startswith("pend"):
            continue
        if name in ("idx", "amask"):
            assert torch.equal(a[rows], b[rows]), name
        elif name in ("done", "fgate"):
            assert torch.equal(a[clear], b[clear]), name
        else:
            err = max(err, float((a[rows] - b[rows]).abs().max()))
    assert err <= APPEND_ATOL, err
    return err


def check_twostage_kernels(A, Bg, Ar, Br):
    """Each two-stage kernel against its plain version on the card from
    identical state, at the main paths' shapes (2b/2c on 2a's problem, 3b
    on 3a's), with a NaN row (row 3: masks out, the clean rows solve) and a
    done row (row 5: left exactly as it was): the masked select, the
    pending-term select, engine_init, ompr_swap, srr_append,
    engine_delete and sp_round. Returns each kernel's max |err|."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import fused_twostage as ft

    bf = torch.bfloat16
    m = A.shape[1]
    B = Bg.shape[0]
    rows = torch.arange(B, device=A.device) != 3
    err = {}
    Ac = A.to(bf).contiguous()
    Ac32 = Ac.float()
    Bn = Bg.clone()
    Bn[3] = float("nan")

    # --- OMPR (2c): engine_init, the masked select, ompr_swap -------------
    k = OMPR_CELL[1]
    st = ft._init_engine(Bn, k + 1, m)
    stk = _clone(st)
    parts = fs._topl_ref(Bn, Ac32, bf, k)
    ft.engine_init(*parts, Ac, Bn, stk)
    ft._engine_init_ref(*parts, Ac32, Bn, st)
    torch.cuda.synchronize()
    err["engine_init"] = _state_err(stk, st, rows)
    assert not (stk.idx[3] < m).any()
    kv, ki = fs.select_argmax(st.r, Ac, amask=st.amask)
    pv, pi = fs._select_ref(st.r, Ac32, bf, False, st.amask, 1.0)
    zv, zi = fs.select_argmax(st.r, Ac, amask=torch.zeros_like(st.amask))
    ov, oi = fs.select_argmax(st.r, Ac)
    torch.cuda.synchronize()
    assert torch.equal(zv.nan_to_num(-1.0), ov.nan_to_num(-1.0))
    assert torch.equal(zi, oi)
    live = ~torch.isnan(pv)
    err["select_masked"] = float((kv[live] - pv[live]).abs().max())
    assert bool(((kv[live] - pv[live]).abs()
                 <= SELECT_RTOL * pv[live].abs() + 1e-6).all())
    i, ir = fs._reduce_partials(kv, ki)[1], fs._reduce_partials(pv, pi)[1]
    assert torch.equal(i, ir) and int(i[3]) == fs.INT_MAX
    st.done[5] = 1.0
    stk, prev0 = _clone(st), st.prev.clone()
    ft.ompr_swap(kv, ki, Ac, Bn, stk, 1.0, 1e-24)
    ft._ompr_swap_ref(kv, ki, Ac32, Bn, st, 1.0, 1e-24)
    torch.cuda.synchronize()
    err["ompr_swap"] = _state_err(stk, st, rows, prev0)
    assert float(stk.done[3]) == 1.0
    assert all(torch.equal(a[5].nan_to_num(), b[5].nan_to_num())
               for a, b in zip(stk, st) if a is not None)
    print(f"[2c kernels] engine_init (k={k}) max |err| "
          f"{err['engine_init']:.3e}; masked select: zero mask == OMP's "
          f"partials bit for bit, picks equal, max |val err| "
          f"{err['select_masked']:.3e}; ompr_swap idx/amask equal, NaN row "
          f"latched, done row untouched, max |err| {err['ompr_swap']:.3e} "
          f"(atol {APPEND_ATOL})")

    # --- SRR (3b): engine_init with pending terms, fr_select, srr_append,
    # engine_delete -------------------------------------------------------
    k = SRR_CELL[1]
    Arc = Ar.to(bf).contiguous()
    Arc32 = Arc.float()
    cn2 = torch.sum(Ar * Ar, dim=0)
    Brn = Br.clone()
    Brn[3] = float("nan")
    st = ft._init_engine(Brn, k + 1, m, cn2, npend=k)
    stk = _clone(st)
    parts = fs._topl_ref(Brn, Arc32, bf, k)
    ft.engine_init(*parts, Arc, Brn, stk)
    ft._engine_init_ref(*parts, Arc32, Brn, st)
    torch.cuda.synchronize()
    err["engine_init"] = max(err["engine_init"], _state_err(stk, st, rows))
    npend = k
    resc_err = d2_err = 0.0
    err["srr_append"] = err["engine_delete"] = 0.0
    for it in range(2):
        if it == 1:
            st.done[5] = 1.0
        row5 = {name: x[5].clone() for name, x in zip(st._fields, st)
                if x is not None and name not in ("resc", "pend_u",
                                                  "pend_w")}
        stk = _clone(st)
        kv, ki = fs.rescaled_select(Arc, cn2, stk.r, stk.pend_u[:npend],
                                    stk.pend_w[:npend], 1.0, stk.amask,
                                    stk.resc)
        pv, pi = fs._rescaled_select_ref(Arc32, cn2, st.r, st.pend_u[:npend],
                                         st.pend_w[:npend], 1.0, st.amask,
                                         st.resc, bf)
        torch.cuda.synchronize()
        resc_err = max(resc_err, float((stk.resc[rows]
                                        - st.resc[rows]).abs().max()))
        assert resc_err <= RESC_ATOL, resc_err
        fin = ~torch.isnan(pv) & torch.isfinite(pv)
        d2_err = max(d2_err, float(((kv[fin] - pv[fin]).abs()
                                    / pv[fin].abs().clamp(min=1e-30)).max()))
        assert d2_err <= SELECT_RTOL, d2_err
        i, ir = fs._reduce_partials(kv, ki)[1], fs._reduce_partials(pv, pi)[1]
        assert bool((i == ir)[rows].all()) and int(i[3]) == fs.INT_MAX
        ft.srr_append(kv, ki, Arc, Brn, stk)
        ft._srr_append_ref(kv, ki, Arc32, Brn, st)
        torch.cuda.synchronize()
        err["srr_append"] = max(err["srr_append"], _state_err(stk, st, rows))
        stk, prev0 = _clone(st), st.prev.clone()
        ft.engine_delete(Brn, stk, k, 1, 1e-24)
        ft._engine_delete_ref(Brn, st, k, 1, 1e-24)
        torch.cuda.synchronize()
        err["engine_delete"] = max(err["engine_delete"],
                                   _state_err(stk, st, rows, prev0))
        if it == 1:   # the done row: state as it was, zero pending terms
            assert all(torch.equal(getattr(stk, name)[5], b)
                       for name, b in row5.items())
            assert not stk.pend_u[:2, 5].any() and not stk.pend_w[:2, 5].any()
        npend = 2
    err["fr_select_pending"] = max(resc_err, d2_err)
    print(f"[3b kernels] engine_init (k={k}, {k} pending terms); two SRR "
          f"iterations from identical state (row 5 done in the second): "
          f"fr_select with pending terms "
          f"resc max |err| {resc_err:.3e} (atol {RESC_ATOL}), d2 max rel err "
          f"{d2_err:.3e}, picks equal, NaN row INT_MAX; srr_append max |err| "
          f"{err['srr_append']:.3e}, engine_delete {err['engine_delete']:.3e} "
          f"(atol {APPEND_ATOL})")

    # --- SP (2b): sp_round, the init round and two more -------------------
    k = SP_CELL[1]
    B, n = Bn.shape
    st = ft._SpState(
        cols=torch.zeros((B, 2 * k, n), device=A.device),
        Ginv=torch.eye(k, device=A.device).repeat(B, 1, 1),
        coef=torch.zeros((B, 2 * k), device=A.device),
        idx=torch.full((B, 2 * k), m, dtype=torch.int32, device=A.device),
        Atb=torch.zeros((B, 2 * k), device=A.device), r=Bn.clone(),
        done=torch.zeros((B,), device=A.device),
        prev=torch.zeros((B,), device=A.device))
    err["sp_round"] = 0.0
    for t in range(3):
        if t == 2:
            st.done[5] = 1.0
        parts = fs._topl_ref(st.r, Ac32, bf, k)
        stk, prev0 = _clone(st), st.prev.clone()
        ft.sp_round(*parts, Ac, Bn, stk, 0.0, t == 0)
        ft._sp_round_ref(*parts, Ac32, Bn, st, 0.0, t == 0)
        torch.cuda.synchronize()
        err["sp_round"] = max(err["sp_round"], _state_err(
            stk, st, rows, None if t == 0 else prev0))
    assert float(stk.done[3]) == 1.0 and not (stk.idx[3] < m).any()
    assert all(torch.equal(a[5], b[5]) for a, b in zip(stk, st))
    print(f"[2b kernels] sp_round (k={k}): init round and two rounds from "
          f"identical state, idx equal, NaN row latched empty, done row "
          f"untouched, max |err| {err['sp_round']:.3e} (atol {APPEND_ATOL})")
    return err


def twostage_paths(A, Bg, sup_g, Ar, Br, sup_f):
    """sp_batch, ompr_batch and srr_batch once each with zeroed launch
    counts; the counts against the formulas for the outer iterations, read
    from the same solve with return_iters (the kernels are deterministic:
    its solution must equal the main path's bit for bit); recovery and
    agreement with the plain solves."""
    import cstpu_torch
    from cstpu_torch.ops import fused_twostage as ft

    out = {"launches": {}, "recovery": {}, "err": {}, "iters": {}}
    for (cell, k, kw), entry, solve, ref, A_, B_, sup in (
            (SP_CELL, cstpu_torch.sp_batch, ft.sp_fused_solve,
             ft.sp_fused_solve_ref, A, Bg, sup_g),
            (OMPR_CELL, cstpu_torch.ompr_batch, ft.ompr_fused_solve,
             ft.ompr_fused_solve_ref, A, Bg, sup_g),
            (SRR_CELL, cstpu_torch.srr_batch, ft.srr_fused_solve,
             ft.srr_fused_solve_ref, Ar, Br, sup_f)):
        sol, launches = run_counted(lambda: entry(A_, B_, k, **kw))
        sol2, _, it = solve(A_, B_, k, return_iters=True, **kw)
        assert torch.equal(sol.idx, sol2.idx) and torch.equal(sol.val,
                                                              sol2.val)
        want = {"2b": dict(select_topl=1 + it, sp_round=1 + it),
                "2c": dict(select_topl=1, engine_init=1, select=it,
                           ompr_swap=it),
                "3b": dict(select_topl=1, engine_init=1, fr_select=it,
                           srr_append=it, engine_delete=it)}[cell]
        assert launches == expect_launches(**want), (cell, launches)
        rec = recovery(sol, sup)
        assert rec == 1.0, f"{cell} recovery {rec} != 1.0"
        rsol, _, it_plain = ref(A_, B_, k, return_iters=True, **kw)
        assert torch.equal(sol.idx, rsol.idx) and torch.equal(sol.mask,
                                                              rsol.mask)
        cerr = float((sol.val - rsol.val).abs().max())
        assert cerr <= COEF_ATOL, cerr
        out["launches"][cell] = launches
        out["recovery"][cell] = rec
        out["err"][cell] = cerr
        out["iters"][cell] = (it, it_plain)
        print(f"[main {cell}] {entry.__name__} k={k} {kw} recovery={rec:.3f} "
              f"iters={it} (plain {it_plain}) launches="
              f"{ {key: v for key, v in launches.items() if v} }; supports "
              f"== plain solve, max |coef err| {cerr:.3e} (atol {COEF_ATOL})")
    return out


KERNEL_NAMES = ("select_argmax", "select_topl", "fr_select", "engine_init",
                "ompr_swap", "srr_append", "engine_delete", "sp_round",
                "rmp_append", "engine_backward", "bw_select", "bw_downdate")


def profile_path(fn):
    """One call of fn under torch.profiler after a warm-up: (device ms by
    kernel, {name: (launches, device ms)}, other device ms)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per, busy = {}, 0.0
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", 0.0)
        if dev <= 0:
            continue
        busy += dev / 1e3
        name = next((kn for kn in KERNEL_NAMES if kn + "_kernel" in ev.key),
                    "other")
        cnt, ms = per.get(name, (0, 0.0))
        per[name] = (cnt + (ev.count if name != "other" else 0),
                     ms + dev / 1e3)
    return busy, per


def twostage_times(A, Bg, Ar, Br, gpu):
    """Solve times of 2b, 2c and 3b against their plain versions (CUDA
    events); per-launch device time of every kernel on each path and the
    path's device busy time and idle share (torch.profiler); plain
    per-step times of the new kernels' plain versions (CUDA events)."""
    import cstpu_torch
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import fused_twostage as ft

    bf = torch.bfloat16
    tm, split = {}, {}
    for (cell, k, kw), entry, ref, A_, B_ in (
            (SP_CELL, cstpu_torch.sp_batch, ft.sp_fused_solve_ref, A, Bg),
            (OMPR_CELL, cstpu_torch.ompr_batch, ft.ompr_fused_solve_ref, A,
             Bg),
            (SRR_CELL, cstpu_torch.srr_batch, ft.srr_fused_solve_ref, Ar,
             Br)):
        tm[cell] = cuda_ms(lambda: entry(A_, B_, k, **kw).val.sum(),
                           TIMED_SOLVES)
        tm["plain_" + cell] = cuda_ms(
            lambda: ref(A_, B_, k, **kw)[0].val.sum(), TIMED_SOLVES)
        busy, per = profile_path(lambda: entry(A_, B_, k, **kw))
        split[cell] = {"wall_ms": tm[cell], "device_busy_ms": busy,
                       "idle_share": 1.0 - busy / tm[cell],
                       "kernels": {name: {"launches": c, "ms": ms}
                                   for name, (c, ms) in per.items()}}

    def per_launch(cell, name):
        got = split[cell]["kernels"].get(name)
        return got["ms"] / got["launches"] if got else float("nan")

    launches = partial(per_launch_ms, Bg)
    m = A.shape[1]
    Ac32 = A.to(bf).float()
    Arc32 = Ar.to(bf).float()
    cn2 = torch.sum(Ar * Ar, dim=0)
    k = OMPR_CELL[1]
    st = ft._init_engine(Bg, k + 1, m)
    parts = fs._topl_ref(Bg, Ac32, bf, k)
    pl = {"engine_init": launches(
        lambda: ft._engine_init_ref(*parts, Ac32, Bg, _clone(st)))}
    ft._engine_init_ref(*parts, Ac32, Bg, st)
    sparts = fs._select_ref(st.r, Ac32, bf, False, st.amask, 1.0)
    pl["select_masked"] = launches(
        lambda: fs._select_ref(st.r, Ac32, bf, False, st.amask, 1.0))
    pl["ompr_swap"] = launches(
        lambda: ft._ompr_swap_ref(*sparts, Ac32, Bg, _clone(st), 1.0, 0.0))
    k = SRR_CELL[1]
    st = ft._init_engine(Br, k + 1, m, cn2, npend=k)
    ft._engine_init_ref(*fs._topl_ref(Br, Arc32, bf, k), Arc32, Br, st)
    for P, key in ((k, "fr_select_init"), (2, "fr_select_pending2")):
        pl[key] = launches(lambda: fs._rescaled_select_ref(
            Arc32, cn2, st.r, st.pend_u[:P], st.pend_w[:P], 1.0, st.amask,
            st.resc.clone(), bf))
    rparts = fs._rescaled_select_ref(Arc32, cn2, st.r, st.pend_u[:k],
                                     st.pend_w[:k], 1.0, st.amask,
                                     st.resc.clone(), bf)
    pl["srr_append"] = launches(
        lambda: ft._srr_append_ref(*rparts, Arc32, Br, _clone(st)))
    ft._srr_append_ref(*rparts, Arc32, Br, st)
    pl["engine_delete"] = launches(
        lambda: ft._engine_delete_ref(Br, _clone(st), k, 1, 0.0))
    k = SP_CELL[1]
    pl["select_topl32"] = launches(lambda: fs._topl_ref(Bg, Ac32, bf, k))
    sp = ft._SpState(
        cols=torch.zeros((Bg.shape[0], 2 * k, Bg.shape[1]), device=A.device),
        Ginv=torch.eye(k, device=A.device).repeat(Bg.shape[0], 1, 1),
        coef=torch.zeros((Bg.shape[0], 2 * k), device=A.device),
        idx=torch.full((Bg.shape[0], 2 * k), m, dtype=torch.int32,
                       device=A.device),
        Atb=torch.zeros((Bg.shape[0], 2 * k), device=A.device), r=Bg.clone(),
        done=torch.zeros((Bg.shape[0],), device=A.device),
        prev=torch.zeros((Bg.shape[0],), device=A.device))
    tparts = fs._topl_ref(Bg, Ac32, bf, k)
    pl["sp_round"] = launches(
        lambda: ft._sp_round_ref(*tparts, Ac32, Bg, _clone(sp), 0.0, True))
    kern = {"sp_round": per_launch("2b", "sp_round"),
            "select_topl32": per_launch("2b", "select_topl"),
            "engine_init": per_launch("2c", "engine_init"),
            "select_masked": per_launch("2c", "select_argmax"),
            "ompr_swap": per_launch("2c", "ompr_swap"),
            "fr_select_3b": per_launch("3b", "fr_select"),
            "srr_append": per_launch("3b", "srr_append"),
            "engine_delete": per_launch("3b", "engine_delete")}
    print("[time two-stage] " + ", ".join(
        f"{cell} {tm[cell]:.4f} ms (plain {tm['plain_' + cell]:.4f})"
        for cell in ("2b", "2c", "3b")) + " | " + gpu)
    print("[time two-stage kernels, device ms per launch on the paths] "
          + ", ".join(f"{key} {v:.4f}" for key, v in kern.items())
          + " | plain ms per call (events): "
          + ", ".join(f"{key} {v:.4f}" for key, v in pl.items()))
    for cell in ("2b", "2c", "3b"):
        sp_ = split[cell]
        print(f"[split {cell}] wall {sp_['wall_ms']:.4f} ms, device busy "
              f"{sp_['device_busy_ms']:.4f} ms, idle share "
              f"{sp_['idle_share']:.4f}; "
              + ", ".join(f"{name} {v['launches']}x {v['ms']:.4f} ms"
                          for name, v in sp_["kernels"].items()))
    return tm, kern, pl, split



def _pend_err(stk, st, rows):
    """Max |err| of the pending terms on `rows`: the weights everywhere, the
    vectors where the weight is not 0."""
    w_err = float((stk.pend_w[:, rows] - st.pend_w[:, rows]).abs().max())
    live = st.pend_w[:, rows] != 0
    u_err = float((stk.pend_u[:, rows][live]
                   - st.pend_u[:, rows][live]).abs().max()) if live.any() \
        else 0.0
    assert max(w_err, u_err) <= APPEND_ATOL, (w_err, u_err)
    return max(w_err, u_err)


def check_stepwise_kernels(A, gen):
    """rmp_append and engine_backward against their plain versions on the
    card from identical state, at 3d's shapes (B=64, K=kmax=32), every
    launch of a forward stage, a backward stage of each rule and six FoBa
    iterations: row 3 is NaN (its gate closes at once), row 7 carries 40
    planted atoms (it fills the 32 slots and reports the cap), row 5 is
    done in the second pass (left exactly as it was). Returns each kernel's
    max |err|."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import fused_twostage as ft

    bf = torch.bfloat16
    _, n, m, k, delta, K = STEP_CELL
    B = 64
    delta2 = delta * delta
    Bs, _ = planted_ones(gen, A, B, k)
    Bs[7] = planted_ones(gen, A, 1, 40)[0][0]
    Bs[3] = float("nan")
    rows = torch.arange(B, device=A.device) != 3
    Ac = A.to(bf).contiguous()
    Ac32 = Ac.float()
    cn2 = torch.sum(A * A, dim=0)
    floor2 = 64.0 * n * (1.1920929e-07 ** 2) * torch.sum(Bs * Bs, dim=1)
    err = {"rmp_append": 0.0, "rmp_append_foba": 0.0, "engine_backward": 0.0}

    def select_both(stk, st, npend):
        kv, ki = fs.rescaled_select(Ac, cn2, stk.r, stk.pend_u[:npend],
                                    stk.pend_w[:npend], 1.0, stk.amask,
                                    stk.resc)
        pv, pi = fs._rescaled_select_ref(Ac32, cn2, st.r, st.pend_u[:npend],
                                         st.pend_w[:npend], 1.0, st.amask,
                                         st.resc, bf)
        torch.cuda.synchronize()
        resc_err = float((stk.resc[rows] - st.resc[rows]).abs().max())
        assert resc_err <= RESC_ATOL, resc_err
        i, ir = fs._reduce_partials(kv, ki)[1], fs._reduce_partials(pv, pi)[1]
        assert bool((i == ir)[rows].all()), "fr_select picks disagree"
        return kv, ki, resc_err

    def append_both(stk, st, kv, ki, foba):
        ft.rmp_append(kv, ki, Ac, Bs, stk, delta2, floor2, foba)
        ft._rmp_append_ref(kv, ki, Ac32, Bs, st, delta2, floor2, foba)
        torch.cuda.synchronize()
        key = "rmp_append_foba" if foba else "rmp_append"
        err[key] = max(err[key], _state_err(stk, st, rows),
                       _pend_err(stk, st, rows))

    def backward_both(st, kfinal):
        stk = _clone(st)
        ft.engine_backward(Bs, stk, delta2, kfinal)
        ft._engine_backward_ref(Bs, st, delta2, kfinal)
        torch.cuda.synchronize()
        err["engine_backward"] = max(err["engine_backward"],
                                     _state_err(stk, st, rows),
                                     _pend_err(stk, st, rows))
        return stk

    # --- RMP: a forward stage, then both backward rules from its end ------
    st = ft._init_engine(Bs, K, m, cn2, npend=K + 1, stepwise=True)
    npend, steps, resc_err = 1, 0, 0.0
    while steps < K + 1 and bool((st.fgate > 0.5).any()):
        stk = _clone(st)
        kv, ki, e = select_both(stk, st, npend)
        append_both(stk, st, kv, ki, False)
        resc_err = max(resc_err, e)
        npend = 1
        steps += 1
    assert steps == K + 1, steps           # row 7 runs into the cap
    capped = st.capped > 0.5
    assert capped.tolist() == [b == 7 for b in range(B)], capped
    assert torch.equal(stk.capped, st.capped)
    nact = (st.idx < m).sum(1)
    assert int(nact[3]) == 0 and int(nact[7]) == K
    assert bool((nact[rows & ~capped] == k).all()), nact
    fwd = _clone(st)
    stk = backward_both(st, -1)            # delta rule: nothing to delete
    assert not st.ndel[rows].any() and not stk.ndel.any()
    assert float(stk.done[3]) == float(st.done[3]) == 1.0   # NaN row: no step
    st = _clone(fwd)
    kfin = k // 2
    stk = backward_both(st, kfin)          # k rule: down to k / 2 atoms
    assert st.ndel[rows].tolist() == stk.ndel[rows].tolist() \
        == [(K if b == 7 else k) - kfin for b in range(B) if b != 3]
    # the second pass: the next select applies the deletions' pending terms
    # (K - k / 2 + 1 of them); row 5 is done and must stay exactly as it is
    st.done[5] = 1.0
    st.fgate[5] = 0.0
    row5 = {name: x[5].clone() for name, x in zip(st._fields, st)
            if x is not None and name not in ("resc", "pend_u", "pend_w",
                                              "ndel")}
    npend = 1 + int(st.ndel.max())
    for _ in range(3):
        stk = _clone(st)
        kv, ki, e = select_both(stk, st, npend)
        append_both(stk, st, kv, ki, False)
        resc_err = max(resc_err, e)
        npend = 1
    stk = backward_both(st, kfin)
    assert all(torch.equal(getattr(stk, name)[5], b)
               for name, b in row5.items())
    assert not stk.pend_w[:, 5].any() and float(stk.ndel[5]) == 0.0
    print(f"[3d kernels] rmp_append: a forward stage of {steps} launches from "
          f"identical state (NaN row closed, row 7 capped at {K} slots, "
          f"fr_select resc max |err| {resc_err:.3e}) and 3 launches of a "
          f"second pass after {K - kfin + 1} pending terms"
          f", max |err| {err['rmp_append']:.3e}; engine_backward: delta rule "
          f"(no deletion), k rule ({k - kfin} and {K - kfin} deletions), done "
          f"row untouched, "
          f"max |err| {err['engine_backward']:.3e} (atol {APPEND_ATOL})")

    # --- FoBa: six iterations; in the fourth and fifth the select's scores
    # are multiplied by 100, so that the gain / 4 rule deletes atoms ---------
    st = ft._init_engine(Bs, K, m, cn2, npend=K + 1, stepwise=True)
    npend, most = 1, 0
    for t in range(6):
        stk = _clone(st)
        kv, ki, e = select_both(stk, st, npend)
        if t in (3, 4):
            kv = kv * 100.0
        append_both(stk, st, kv, ki, True)
        assert torch.equal(stk.ndel[rows], st.ndel[rows])
        npend = 1 + int(st.ndel.max())
        most = max(most, npend - 1)
    assert most >= 2, most
    print(f"[3d kernels] rmp_append with foba: six iterations from identical "
          f"state, up to {most} deletions in one launch, max |err| "
          f"{err['rmp_append_foba']:.3e} (atol {APPEND_ATOL})")
    return err


def check_backward_kernels(A2, Bs2):
    """bw_select and bw_downdate against their plain versions on the card
    from identical state at 3e's shapes (B=8, m=1024), 40 FBR steps and 10
    LACE steps: row 1 is rejected at its first step (its ||r||^2 set above
    the threshold) and skipped from then on, row 2 has a NaN init (it
    latches `failed` and stops). The kernels round as the plain versions
    do, so every field must be equal bit for bit."""
    from cstpu_torch.ops import fused_backward as fb

    st = fb._bw_init(A2, Bs2)
    st.nr2[1] = 1.0
    st.G[2] = float("nan")
    st.coef[2] = float("nan")
    st.diag[2] = float("nan")
    err = {"bw_select": 0.0, "bw_downdate": 0.0}
    clean = torch.arange(Bs2.shape[0], device=A2.device) != 2
    for t in range(50):
        select_abs = t >= 40
        stk = _clone(st)
        fb.bw_select(stk, 0.5, float("inf"), select_abs)
        fb._bw_select_ref(st, 0.5, float("inf"), select_abs)
        torch.cuda.synchronize()
        for name, a, b in zip(st._fields, stk, st):
            if name != "G":
                err["bw_select"] = max(err["bw_select"], float(
                    (a[clean] - b[clean]).abs().max()))
                assert torch.equal(a.isnan(), b.isnan()), (t, name)
        fb.bw_downdate(stk)
        fb._bw_downdate_ref(st)
        torch.cuda.synchronize()
        err["bw_downdate"] = max(err["bw_downdate"], float(
            (stk.G[clean] - st.G[clean]).abs().max()))
        assert err["bw_select"] == 0.0 and err["bw_downdate"] == 0.0, (t, err)
        if t == 0:
            assert stk.run.tolist() == st.run.tolist() \
                == [1.0, 0.0, 0.0] + [1.0] * (Bs2.shape[0] - 3)
            assert stk.failed.tolist() == st.failed.tolist() \
                == [0.0, 0.0, 1.0] + [0.0] * (Bs2.shape[0] - 3)
    m = A2.shape[1]
    assert int(stk.alive[1].sum()) == m and int(stk.alive[0].sum()) == m - 50
    assert stk.run[clean].tolist() == [1.0, 0.0] + [1.0] * (Bs2.shape[0] - 3)
    print(f"[3e kernels] bw_select and bw_downdate: 40 FBR and 10 LACE steps "
          f"from identical state at B={Bs2.shape[0]}, m={m}: every field equal "
          f"bit for bit (max |err| {err['bw_select']:.1e}, "
          f"{err['bw_downdate']:.1e}); rejected row skipped, NaN init latched "
          f"failed and stopped")
    return err


def stepwise_paths(A, gen):
    """rmp_batch (delta) and foba_batch of config 3d once each per batch
    size with zeroed launch counts: the counts against the formulas for the
    steps the same solve reports, recovery, no capped row, and agreement
    with the plain solves. Returns the record and the problems."""
    import cstpu_torch
    from cstpu_torch.ops import fused_twostage as ft

    cell, n, m, k, delta, kmax = STEP_CELL
    out, problems = {}, {}
    for B in BATCHES:
        Bs, sup = planted_ones(gen, A, B, k)
        problems[B] = Bs
        for name, entry, solve, ref in (
                ("rmp", lambda: cstpu_torch.rmp_batch(A, Bs, delta=delta,
                                                      kmax=kmax),
                 lambda **kw: ft.rmp_fused_solve(A, Bs, delta=delta,
                                                 kmax=kmax, **kw),
                 lambda: ft.rmp_fused_solve_ref(A, Bs, delta=delta,
                                                kmax=kmax)),
                ("foba", lambda: cstpu_torch.foba_batch(A, Bs, delta,
                                                        kmax=kmax),
                 lambda **kw: ft.foba_fused_solve(A, Bs, delta, kmax=kmax,
                                                  **kw),
                 lambda: ft.foba_fused_solve_ref(A, Bs, delta, kmax=kmax))):
            sol, launches = run_counted(entry)
            sol2, _, capped, it = solve(return_iters=True)
            assert torch.equal(sol.idx, sol2.idx) and torch.equal(sol.val,
                                                                  sol2.val)
            assert not capped.any(), capped
            if name == "rmp":
                passes, steps = it
                want = dict(fr_select=steps, rmp_append=steps,
                            engine_backward=passes)
                assert passes == 1 and steps == k + 1, it
            else:
                want = dict(fr_select=it, rmp_append=it)
                assert it == k + 1, it
            assert launches == expect_launches(**want), (name, B, launches)
            rec = recovery(sol, sup)
            assert rec == 1.0, f"{cell} {name} B={B} recovery {rec} != 1.0"
            assert int(sol.mask.sum()) == B * k   # the planted atoms only
            rsol, _, rcapped = ref()
            assert torch.equal(sol.idx, rsol.idx) and not rcapped.any()
            cerr = float((sol.val - rsol.val).abs().max())
            assert cerr <= COEF_ATOL, cerr
            out[(name, B)] = {"launches": launches, "recovery": rec,
                              "err": cerr, "iters": it}
            print(f"[main {cell}] {name}_batch B={B} delta={delta} kmax={kmax} "
                  f"recovery={rec:.3f} iters={it} launches="
                  f"{ {key: v for key, v in launches.items() if v} }; no row "
                  f"capped, supports == plain solve, max |coef err| "
                  f"{cerr:.3e} (atol {COEF_ATOL})")
    return out, problems


def backward_paths(A2, gen):
    """fbr_batch and lace_batch of config 3e once each per batch size with
    zeroed launch counts: 992 deletion steps, two launches each; recovery,
    no failed row, supports equal to the plain solves."""
    import cstpu_torch
    from cstpu_torch.ops import fused_backward as fb

    cell, n, m, k = BW_CELL
    out, problems = {}, {}
    for B in BATCHES:
        Bs, sup = planted_ones(gen, A2, B, k)
        problems[B] = Bs
        for name, entry, solve, ref in (
                ("fbr", cstpu_torch.fbr_batch, fb.fbr_fused_solve,
                 fb.fbr_fused_solve_ref),
                ("lace", cstpu_torch.lace_batch, fb.lace_fused_solve,
                 fb.lace_fused_solve_ref)):
            (sol, failed), launches = run_counted(
                lambda: entry(A2, Bs, sparsity=k, return_failed=True))
            sol2, _, steps = solve(A2, Bs, sparsity=k, return_iters=True)
            assert torch.equal(sol.idx, sol2.idx) and torch.equal(sol.val,
                                                                  sol2.val)
            assert steps == m - k, steps
            assert launches == expect_launches(bw_select=steps,
                                               bw_downdate=steps), launches
            assert not failed.any(), failed
            rec = recovery(sol, sup)
            assert rec == 1.0, f"{cell} {name} B={B} recovery {rec} != 1.0"
            assert int(sol.mask.sum()) == B * k
            rsol, rfailed = ref(A2, Bs, sparsity=k)
            assert torch.equal(sol.idx, rsol.idx) and not rfailed.any()
            cerr = float((sol.val - rsol.val).abs().max())
            assert cerr <= COEF_ATOL, cerr
            out[(name, B)] = {"launches": launches, "recovery": rec,
                              "err": cerr, "iters": steps}
            print(f"[main {cell}] {name}_batch B={B} sparsity={k} "
                  f"recovery={rec:.3f} deletion steps={steps} launches="
                  f"{ {key: v for key, v in launches.items() if v} }; no row "
                  f"failed, supports == plain solve, max |coef err| "
                  f"{cerr:.3e} (atol {COEF_ATOL})")
    return out, problems


def _split(wall, fn):
    """The profiler's time split of one call of fn beside its wall ms."""
    busy, per = profile_path(fn)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall,
            "kernels": {name: {"launches": c, "ms": ms}
                        for name, (c, ms) in per.items()}}


def _print_splits(tm, split, keys, gpu):
    for key in keys:
        sp_ = split[key]
        print(f"[time {key}] {tm[key]:.4f} ms (plain {tm['plain_' + key]:.4f})"
              f" | {gpu}")
        print(f"[split {key}] wall {sp_['wall_ms']:.4f} ms, device busy "
              f"{sp_['device_busy_ms']:.4f} ms, idle share "
              f"{sp_['idle_share']:.4f}; "
              + ", ".join(f"{name} {v['launches']}x {v['ms']:.4f} ms"
                          for name, v in sp_["kernels"].items()))


def stepwise_times(A, problems, gpu):
    """Solve times of 3d's two paths per batch size against their plain
    versions (CUDA events), the profiler's split, and per-call times of the
    new kernels' plain versions at B=8."""
    import cstpu_torch
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import fused_twostage as ft

    cell, n, m, k, delta, kmax = STEP_CELL
    tm, split = {}, {}
    for B, Bs in problems.items():
        for name, entry, ref in (
                ("rmp", lambda: cstpu_torch.rmp_batch(A, Bs, delta=delta,
                                                      kmax=kmax),
                 lambda: ft.rmp_fused_solve_ref(A, Bs, delta=delta,
                                                kmax=kmax)[0]),
                ("foba", lambda: cstpu_torch.foba_batch(A, Bs, delta,
                                                        kmax=kmax),
                 lambda: ft.foba_fused_solve_ref(A, Bs, delta,
                                                 kmax=kmax)[0])):
            key = f"{cell} {name} B={B}"
            tm[key] = cuda_ms(lambda: entry().val.sum(), TIMED_SOLVES)
            tm["plain_" + key] = cuda_ms(lambda: ref().val.sum(), TIMED_SLOW)
            split[key] = _split(tm[key], entry)
    _print_splits(tm, split, [key for key in tm if not key.startswith("plain")],
                  gpu)
    # plain per-call times at B=8, mid-solve: 8 atoms in
    bf = torch.bfloat16
    Bs = problems[BATCHES[0]]
    Ac32 = A.to(bf).float()
    cn2 = torch.sum(A * A, dim=0)
    floor2 = 64.0 * n * (1.1920929e-07 ** 2) * torch.sum(Bs * Bs, dim=1)
    st = ft._init_engine(Bs, kmax, m, cn2, npend=kmax + 1, stepwise=True)
    for _ in range(8):
        ft._rmp_append_ref(*fs._rescaled_select_ref(
            Ac32, cn2, st.r, st.pend_u[:1], st.pend_w[:1], 1.0, st.amask,
            st.resc, bf), Ac32, Bs, st, delta * delta, floor2, False)
    launches = partial(per_launch_ms, Bs)
    parts = fs._rescaled_select_ref(Ac32, cn2, st.r, st.pend_u[:1],
                                    st.pend_w[:1], 1.0, st.amask,
                                    st.resc.clone(), bf)
    pl = {"fr_select_b8": launches(lambda: fs._rescaled_select_ref(
        Ac32, cn2, st.r, st.pend_u[:1], st.pend_w[:1], 1.0, st.amask,
        st.resc.clone(), bf)),
        "rmp_append": launches(lambda: ft._rmp_append_ref(
            *parts, Ac32, Bs, _clone(st), delta * delta, floor2, False)),
        "rmp_append_foba": launches(lambda: ft._rmp_append_ref(
            *parts, Ac32, Bs, _clone(st), delta * delta, floor2, True)),
        "engine_backward": launches(lambda: ft._engine_backward_ref(
            Bs, _clone(st), delta * delta, -1))}
    print("[time 3d plain ms per call at B=8 (events, a state copy "
          "included)] " + ", ".join(f"{key} {v:.4f}" for key, v in pl.items()))
    return tm, split, pl


def backward_times(A2, problems, gpu):
    """Solve times of 3e's two paths per batch size against their plain
    versions (CUDA events), the profiler's split, and per-call times of the
    kernels, their plain versions and the one PyTorch call that makes
    bw_downdate's update (torch.baddbmm) at both batch sizes."""
    import cstpu_torch
    from cstpu_torch.ops import fused_backward as fb

    cell, n, m, k = BW_CELL
    tm, split, per_call = {}, {}, {}
    for B, Bs in problems.items():
        for name, entry, ref in (
                ("fbr", cstpu_torch.fbr_batch, fb.fbr_fused_solve_ref),
                ("lace", cstpu_torch.lace_batch, fb.lace_fused_solve_ref)):
            key = f"{cell} {name} B={B}"
            tm[key] = cuda_ms(lambda: entry(A2, Bs, sparsity=k).val.sum(),
                              TIMED_SLOW)
            tm["plain_" + key] = cuda_ms(
                lambda: ref(A2, Bs, sparsity=k)[0].val.sum(), TIMED_SLOW)
            split[key] = _split(tm[key], lambda: entry(A2, Bs, sparsity=k))
        st = fb._bw_init(A2, Bs)
        for _ in range(8):
            fb._bw_select_ref(st, float("inf"), float("inf"), False)
            fb._bw_downdate_ref(st)
        launches = partial(per_launch_ms, Bs)
        inf = float("inf")
        sel_state, down_state = _clone(st), _clone(st)
        sel_state.alive.fill_(1.0)   # so that 100 timed selects all step
        per_call[B] = {
            "bw_select": launches(lambda: (
                sel_state.run.fill_(1.0),
                fb.bw_select(sel_state, inf, inf, False))),
            "plain_bw_select": launches(lambda: (
                sel_state.run.fill_(1.0),
                fb._bw_select_ref(sel_state, inf, inf, False))),
            "bw_downdate": launches(lambda: fb.bw_downdate(down_state)),
            "plain_bw_downdate": launches(
                lambda: fb._bw_downdate_ref(down_state)),
            "baddbmm": launches(lambda: down_state.G.baddbmm_(
                down_state.gcol[:, :, None],
                (down_state.g * down_state.sc[:, :1])[:, None, :],
                alpha=-1.0))}
        del st, sel_state, down_state
        torch.cuda.empty_cache()
    _print_splits(tm, split, [key for key in tm if not key.startswith("plain")],
                  gpu)
    for B, pc in per_call.items():
        print(f"[time 3e ms per call at B={B} (events, the wrapper included)] "
              + ", ".join(f"{key} {v:.4f}" for key, v in pc.items()))
    return tm, split, per_call


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    from cstpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(gpu)
    print(f"[device] {torch.cuda.get_device_name(0)} torch "
          f"{torch.__version__} cuda {torch.version.cuda} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    secs, log = _build.build()
    print(f"[build] nvcc {len(_build.sources())} sources -> {_build.LIB.name} "
          f"in {secs:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    dev = torch.device("cuda", 0)
    record = {}
    for name, B, n, m, k in CELLS:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        A, Bs, sup = planted(gen, B, n, m, k)
        print(f"[{name}] B={B} n={n} m={m} k={k}")
        sel_err, r, Ac_sel = check_select(A, Bs)
        app_err, st, parts, Ac = check_append(A, Bs, k)
        launches = main_path(A, Bs, sup, k)
        tm = times(A, Bs, k, r, Ac_sel, st, parts, Ac, gpu)
        record[name] = (sel_err, app_err, launches, tm)
        print(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
        del A, Bs, r, Ac_sel, st, parts, Ac
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    from cstpu_torch.utils.data import correlated_data

    gen = torch.Generator(device=dev).manual_seed(SEED)
    _, B, n, m, k = MP_CELL
    A, Bs, _ = planted(gen, B, n, m, k)
    _, B, n, m, kg, l = GOMP_CELL
    Bg, sup_g = planted_ones(gen, A, B, kg)
    _, B, n, m, kf, decay = FR_CELL
    Ar = correlated_data(gen, n, m, kf, decay=decay)[0].contiguous()
    Br, sup_f = planted_ones(gen, Ar, B, kf)
    print(f"[greedy] B={B} n={n} m={m}: mp k={k}, gomp l={l} k={kg}, fr "
          f"k={kf} on correlated_data(decay={decay})")
    gerr, parts = check_greedy_kernels(A, Bs, Ar, Br, l, kf)
    paths = greedy_paths(A, Bs, Bg, sup_g, Ar, Br, sup_f)
    gtm = greedy_times(A, Bs, Bg, Ar, Br, parts, gpu)
    print(f"[greedy] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print(f"[two-stage] 2b sp_batch k={SP_CELL[1]} and 2c ompr_batch "
          f"k={OMPR_CELL[1]} on 2a's problem; 3b srr_batch k={SRR_CELL[1]} "
          f"on 3a's")
    terr = check_twostage_kernels(A, Bg, Ar, Br)
    tpaths = twostage_paths(A, Bg, sup_g, Ar, Br, sup_f)
    ttm, tkern, tplain, _ = twostage_times(A, Bg, Ar, Br, gpu)
    print(f"[two-stage] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cell, n, m, k, delta, kmax = STEP_CELL
    print(f"[stepwise] {cell} rmp_batch(delta={delta}, kmax={kmax}) and "
          f"foba_batch({delta}, kmax={kmax}) on the unit-norm Gaussian "
          f"dictionary n={n} m={m}, {k} planted ones, B in {BATCHES}")
    serr = check_stepwise_kernels(A, gen)
    spaths, sprob = stepwise_paths(A, gen)
    stm, ssplit, splain = stepwise_times(A, sprob, gpu)
    print(f"[stepwise] done in {time.perf_counter() - t0:.1f} s")
    del Ar, Br, Bg, sprob
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    from cstpu_torch.utils.data import sparse_data

    cell, n, m, k = BW_CELL
    print(f"[backward] {cell} fbr_batch and lace_batch(sparsity={k}) on a "
          f"square unit-norm Gaussian dictionary n=m={m}, {k} planted ones, "
          f"B in {BATCHES}: {m - k} deletions per row")
    A2 = sparse_data(gen, n, m, 1)[0].contiguous()
    berr = check_backward_kernels(A2, planted_ones(gen, A2, BATCHES[0], k)[0])
    bpaths, bprob = backward_paths(A2, gen)
    btm, bsplit, bcall = backward_times(A2, bprob, gpu)
    print(f"[backward] done in {time.perf_counter() - t0:.1f} s")

    sel_err, app_err, launches, tm = record["bench"]
    fs_line = "cstpu/ops/fused_solve.py"
    ts_line = "cstpu/ops/fused_twostage.py"
    csrc = "cstpu_torch/csrc"
    tl = tpaths["launches"]

    def entry(name, replaces, launches, err, ms, plain_ms, bound_,
              library_ms=None, **extra):
        return {"name": name, "route": "cuda", "source": f"{csrc}/{name}.cu",
                "replaces": replaces if ":" in str(replaces)
                else f"{fs_line}:{replaces}", "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound_,
                "library_ms": library_ms, **extra}

    # the shapes the bounds are computed from: the cells' own
    _, B, n, m, k = CELLS[0]
    T = -(-m // 128)
    kg, l = GOMP_CELL[4], GOMP_CELL[5]
    kf, ks, ko, kr = FR_CELL[4], SP_CELL[1], OMPR_CELL[1], SRR_CELL[1]
    _, n3, m3, k3, _, K3 = STEP_CELL
    _, n4, m4, k4 = BW_CELL
    B0 = BATCHES[0]
    sl = {key: v["launches"] for key, v in spaths.items()}
    bl = {key: v["launches"] for key, v in bpaths.items()}

    def on_path(split, key, name):
        """Profiler device ms per launch of kernel `name` on path `key`."""
        got = split[key]["kernels"][name]
        return got["ms"] / got["launches"]

    d_rmp, d_foba = f"3d rmp B={B0}", f"3d foba B={B0}"
    d_fbr, d_lace = f"3e fbr B={B0}", f"3e lace B={B0}"
    big = BATCHES[1]

    kernels = [
        entry("select_argmax", 127, launches["select"]
              + paths["mp"]["select"] + tl["2c"]["select"],
              max(sel_err, gerr["select_signed"], terr["select_masked"]),
              tm["select"], tm["plain_select"], select_bound(B, n, m),
              also_replaces=[f"{fs_line}:332", f"{fs_line}:874",
                             f"{ts_line}:1052"],
              paths={"omp_batch": launches["select"],
                     "mp_batch": paths["mp"]["select"],
                     "ompr_batch": tl["2c"]["select"]},
              signed_ms=gtm["select_signed"],
              plain_signed_ms=gtm["plain_select_signed"],
              masked_ms=tkern["select_masked"],
              plain_masked_ms=tplain["select_masked"]),
        entry("omp_append", 127, launches["append"], app_err, tm["append"],
              tm["plain_append"], engine_bound(B, k, n, appends=1),
              also_replaces=[f"{fs_line}:332"]),
        entry("mp_update", 874, paths["mp"]["mp_update"], gerr["mp_update"],
              gtm["mp_update"], gtm["plain_mp_update"],
              bound(B * (T * 12 + n * 2 + 2 * n * 4 + 8), 2 * B * n, "f32")),
        entry("select_topl", 714, paths["gomp"]["select_topl"]
              + sum(tl[c]["select_topl"] for c in ("2b", "2c", "3b")),
              gerr["select_topl"], gtm["select_topl"],
              gtm["plain_select_topl"], select_bound(B, n, m, outs=l),
              also_replaces=[f"{ts_line}:897", f"{ts_line}:1052",
                             f"{ts_line}:1191"],
              paths={"gomp_batch": paths["gomp"]["select_topl"],
                     **{name: tl[c]["select_topl"] for name, c in (
                         ("sp_batch", "2b"), ("ompr_batch", "2c"),
                         ("srr_batch", "3b"))}},
              l32_ms=tkern["select_topl32"],
              plain_l32_ms=tplain["select_topl32"]),
        entry("gomp_append", 714, paths["gomp"]["gomp_append"],
              gerr["gomp_append"], gtm["gomp_append"],
              gtm["plain_gomp_append"], engine_bound(B, kg, n, appends=l)),
        entry("fr_select", 532, paths["fr"]["fr_select"]
              + tl["3b"]["fr_select"]
              + sum(v["fr_select"] for v in sl.values()),
              max(gerr["fr_select"], terr["fr_select_pending"]),
              gtm["fr_select"], gtm["plain_fr_select"],
              select_bound(B, n, m, terms=1),
              also_replaces=[f"{ts_line}:1191", f"{ts_line}:1368",
                             f"{ts_line}:1499"],
              paths={"fr_batch": paths["fr"]["fr_select"],
                     "srr_batch": tl["3b"]["fr_select"],
                     **{f"{name}_batch B={b}": v["fr_select"]
                        for (name, b), v in sl.items()}},
              rmp_b8_ms=on_path(ssplit, d_rmp, "fr_select"),
              rmp_b64_ms=on_path(ssplit, f"3d rmp B={big}", "fr_select"),
              plain_rmp_b8_ms=splain["fr_select_b8"],
              srr_ms=tkern["fr_select_3b"],
              plain_srr_init_ms=tplain["fr_select_init"],
              plain_srr_pending2_ms=tplain["fr_select_pending2"]),
        entry("fr_append", 532, paths["fr"]["fr_append"], gerr["fr_append"],
              gtm["fr_append"], gtm["plain_fr_append"],
              engine_bound(B, kf, n, appends=1)),
        entry("sp_round", f"{ts_line}:897", tl["2b"]["sp_round"],
              terr["sp_round"], tkern["sp_round"], tplain["sp_round"],
              # 2k slots, k acquired columns in, the compaction's k out; the
              # blocks G12, G22 and the rebuilt Gram, then O(k^3) solves
              bound(4 * B * (4 * ks * n + 2 * ks * ks + 3 * n)
                    + B * ks * n * 2,
                    B * (6 * ks * ks * n + 8 * ks ** 3), "f32")),
        entry("engine_init", f"{ts_line}:1052", tl["2c"]["engine_init"]
              + tl["3b"]["engine_init"], terr["engine_init"],
              tkern["engine_init"], tplain["engine_init"],
              engine_bound(B, ko + 1, n, appends=ko),
              also_replaces=[f"{ts_line}:1191"],
              paths={"ompr_batch": tl["2c"]["engine_init"],
                     "srr_batch": tl["3b"]["engine_init"]}),
        entry("ompr_swap", f"{ts_line}:1052", tl["2c"]["ompr_swap"],
              terr["ompr_swap"], tkern["ompr_swap"], tplain["ompr_swap"],
              engine_bound(B, ko + 1, n, appends=1, deletes=1)),
        entry("srr_append", f"{ts_line}:1191", tl["3b"]["srr_append"],
              terr["srr_append"], tkern["srr_append"], tplain["srr_append"],
              engine_bound(B, kr + 1, n, appends=1)),
        entry("engine_delete", f"{ts_line}:1191", tl["3b"]["engine_delete"],
              terr["engine_delete"], tkern["engine_delete"],
              tplain["engine_delete"],
              engine_bound(B, kr + 1, n, deletes=1)),
        # the stepwise and backward kernels: ms is the profiler's device
        # time per launch on the B=8 path, the bound that launch's
        entry("rmp_append", f"{ts_line}:1368",
              sum(v["rmp_append"] for v in sl.values()),
              max(serr["rmp_append"], serr["rmp_append_foba"]),
              on_path(ssplit, d_rmp, "rmp_append"), splain["rmp_append"],
              engine_bound(B0, K3, n3, appends=1),
              also_replaces=[f"{ts_line}:1499"],
              paths={f"{name}_batch B={b}": v["rmp_append"]
                     for (name, b), v in sl.items()},
              foba_ms=on_path(ssplit, d_foba, "rmp_append"),
              plain_foba_ms=splain["rmp_append_foba"],
              b64_ms=on_path(ssplit, f"3d rmp B={big}", "rmp_append")),
        entry("engine_backward", f"{ts_line}:1368",
              sum(v["engine_backward"] for v in sl.values()),
              serr["engine_backward"],
              on_path(ssplit, d_rmp, "engine_backward"),
              splain["engine_backward"],
              # this run's stage deletes nothing: the scores and the latch
              engine_bound(B0, K3, n3, refits=0),
              paths={f"{name}_batch B={b}": v["engine_backward"]
                     for (name, b), v in sl.items() if name == "rmp"}),
        entry("bw_select", "cstpu/ops/fused_backward.py:184",
              sum(v["bw_select"] for v in bl.values()), berr["bw_select"],
              on_path(bsplit, d_fbr, "bw_select"),
              bcall[B0]["plain_bw_select"],
              # coef, diag, alive both ways, a row and a column of G in, g
              # and gcol out; ~10 operations an atom
              bound(10 * B0 * m4 * 4, 10 * B0 * m4, "f32"),
              paths={f"{name}_batch B={b}": v["bw_select"]
                     for (name, b), v in bl.items()},
              event_ms=bcall[B0]["bw_select"],
              lace_ms=on_path(bsplit, d_lace, "bw_select"),
              b64_ms=on_path(bsplit, f"3e fbr B={big}", "bw_select")),
        entry("bw_downdate", "cstpu/ops/fused_backward.py:184",
              sum(v["bw_downdate"] for v in bl.values()), berr["bw_downdate"],
              on_path(bsplit, d_fbr, "bw_downdate"),
              bcall[B0]["plain_bw_downdate"],
              bound(2 * B0 * m4 * m4 * 4 + 2 * B0 * m4 * 4,
                    3 * B0 * m4 * m4, "f32"),
              library_ms=bcall[B0]["baddbmm"],
              paths={f"{name}_batch B={b}": v["bw_downdate"]
                     for (name, b), v in bl.items()},
              event_ms=bcall[B0]["bw_downdate"],
              b64_ms=on_path(bsplit, f"3e fbr B={big}", "bw_downdate"),
              b64_event_ms=bcall[big]["bw_downdate"],
              b64_plain_ms=bcall[big]["plain_bw_downdate"],
              b64_library_ms=bcall[big]["baddbmm"],
              b64_bound_ms=bound(2 * big * m4 * m4 * 4, 3 * big * m4 * m4,
                                 "f32")["bound_ms"]),
    ]
    assert all({"bound_ms", "bound_by", "library_ms"} <= set(kn)
               for kn in kernels)
    print(json.dumps({"kernels": kernels, "two_stage": {
        "iters": tpaths["iters"], "recovery": tpaths["recovery"],
        "solve_ms": {c: ttm[c] for c in ("2b", "2c", "3b")},
        "plain_solve_ms": {c: ttm["plain_" + c] for c in ("2b", "2c", "3b")},
        "device": gpu}, "stepwise_backward": {
        "solve_ms": {**stm, **btm},
        "paths": {f"{cell_} {name} B={b}": {"recovery": v["recovery"],
                                            "iters": v["iters"],
                                            "coef_err": v["err"]}
                  for cell_, rec in (("3d", spaths), ("3e", bpaths))
                  for (name, b), v in rec.items()},
        "idle_share": {key: v["idle_share"]
                       for key, v in {**ssplit, **bsplit}.items()},
        "device": gpu}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
