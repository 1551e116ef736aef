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

It checks planted-support recovery, launch counts and agreement with the
plain solves, and times kernels and solves with CUDA events.

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

    sel_err, app_err, launches, tm = record["bench"]
    fs_line = "cstpu/ops/fused_solve.py"
    csrc = "cstpu_torch/csrc"

    def entry(name, replaces, launches, err, ms, plain_ms, **extra):
        return {"name": name, "route": "cuda", "source": f"{csrc}/{name}.cu",
                "replaces": f"{fs_line}:{replaces}", "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **extra}

    kernels = [
        entry("select_argmax", 127, launches["select"]
              + paths["mp"]["select"], max(sel_err, gerr["select_signed"]),
              tm["select"], tm["plain_select"],
              also_replaces=[f"{fs_line}:332", f"{fs_line}:874"],
              paths={"omp_batch": launches["select"],
                     "mp_batch": paths["mp"]["select"]},
              signed_ms=gtm["select_signed"],
              plain_signed_ms=gtm["plain_select_signed"]),
        entry("omp_append", 127, launches["append"], app_err, tm["append"],
              tm["plain_append"], also_replaces=[f"{fs_line}:332"]),
        entry("mp_update", 874, paths["mp"]["mp_update"], gerr["mp_update"],
              gtm["mp_update"], gtm["plain_mp_update"]),
        entry("select_topl", 714, paths["gomp"]["select_topl"],
              gerr["select_topl"], gtm["select_topl"],
              gtm["plain_select_topl"]),
        entry("gomp_append", 714, paths["gomp"]["gomp_append"],
              gerr["gomp_append"], gtm["gomp_append"],
              gtm["plain_gomp_append"]),
        entry("fr_select", 532, paths["fr"]["fr_select"], gerr["fr_select"],
              gtm["fr_select"], gtm["plain_fr_select"]),
        entry("fr_append", 532, paths["fr"]["fr_append"], gerr["fr_append"],
              gtm["fr_append"], gtm["plain_fr_append"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
