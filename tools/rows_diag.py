"""Diagnostics of the batched active-set engine under the rows bodies, for
one checkout of the repo.

    python3 tools/rows_diag.py ROOT TAG [cuda|cpu] [SEEDS]

ROOT is a checkout (this one, or another unpacked with `git archive` into a
directory that .gitignore lists); its cstpu_torch and chip_smoke.py are
imported. TAG labels the output lines. On the device named (the card by
default):

  * `rmp(A, y, k=3)` in f32 on `[surface]`'s noisy (64, 96) problem
    (chip_smoke.surface_problems): its support, the forward stage's end
    (atoms, residual norm, max |G Ginv - I|) and the first deletions;
  * the same call over SEEDS (default 40) other seeds of that problem
    (SURFACE_SEED 1000, 1001, ...): how many recover the planted atoms;
  * on the card only: eight 1024² inverses from their Cholesky factors
    (3e's size, B = 8) by a batched `cholesky_solve` against I, by a loop
    of single ones, by `cholesky_inverse`, and by `solve_triangular` and
    L^-T L^-1 (CUDA events, mean of five); then 24 BR deletions at 3e,
    B = 8 (chip_smoke.rows_problems), timed and profiled (torch.profiler's
    top operations by device time).
"""

import os
import sys
import time


def main():
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    devn = sys.argv[3] if len(sys.argv) > 3 else "cuda"
    seeds = int(sys.argv[4]) if len(sys.argv) > 4 else 40
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import cstpu_torch as ct
    from cstpu_torch.models import backward as bk
    from cstpu_torch.models import forward as fw
    from cstpu_torch.ops import active_set as aset

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(devn)
    P = cs.surface_problems(devn)
    A, y = P["A"], P["y"]
    n, m = A.shape
    s = ct.rmp(A, y, k=3)
    print(f"[{tag} {devn}] rmp k f32 -> {sorted(s.idx[s.mask].tolist())} "
          f"planted {P['sup']}", flush=True)
    # the forward stage to exhaustion, then the first deletions, on a
    # batch of one row (a checkout before the rows bodies: one instance)
    cn = torch.sum(A * A, 0)
    rows = hasattr(fw, "forward_step_rows")
    if rows:
        st = aset.refit_batched(aset.empty_batched(1, n, min(n, m), m,
                                                   A.dtype, dev))
        floor = fw.exhaustion_floor(A, y[None])
    else:
        st = aset.refit(aset.empty(n, min(n, m), m, A.dtype, dev))
        floor = fw.exhaustion_floor(A, y)
    for _ in range(n):
        if rows:
            st, acc, _ = fw.forward_step_rows(A, y[None], st, floor, 0.0,
                                              cn, m)
            acc = bool(acc[0])
        else:
            st, acc, _ = fw.forward_step(A, y, st, floor, 0.0, cn, m)
            acc = bool(acc)
        if not acc:
            break

    def one(st):
        return aset.row_of(st) if rows else st

    r1 = one(st)
    k = int(r1.k)
    G, Gi = r1.G[:k, :k].double(), r1.Ginv[:k, :k].double()
    eye = torch.eye(k, dtype=torch.float64, device=dev)
    print(f"[{tag} {devn}] forward k={k} |r|="
          f"{float(aset.residual(r1, y).norm()):.6g} |G Ginv - I|max="
          f"{float((G @ Gi - eye).abs().max()):.4g} last atoms "
          f"{r1.idx[50:k].tolist()}", flush=True)
    dels = []
    for _ in range(8):
        before = set(one(st).idx[one(st).mask].tolist())
        if rows:
            d2 = bk.backward_deltas_rows(y[None], st, m)[0]
            st, _ = bk.backward_step_rows(A, y[None], st, torch.inf,
                                          torch.inf, m)
        else:
            d2 = bk.backward_deltas(y, st, m)
            st, _ = bk.backward_step(A, y, st, torch.inf, torch.inf, m)
        gone = sorted(before - set(one(st).idx[one(st).mask].tolist()))
        dels.append((gone, int(torch.isnan(d2).sum()),
                     f"{float(torch.nan_to_num(d2, nan=-1).min()):.3g}"))
    print(f"[{tag} {devn}] first deletions (atom, NaN deltas, min delta): "
          f"{dels}", flush=True)
    hits, miss = 0, []
    for sd in range(seeds):
        cs.SURFACE_SEED = 1000 + sd
        Q = cs.surface_problems(devn)
        s = ct.rmp(Q["A"], Q["y"], k=3)
        ok = sorted(s.idx[s.mask].tolist()) == Q["sup"]
        hits += ok
        if not ok:
            miss.append(sd)
    print(f"[{tag} {devn}] seed sweep rmp k f32: {hits}/{seeds} recover, "
          f"misses {miss}", flush=True)
    if devn == "cpu":
        return

    def ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn(8, 1024, 1200, device=dev, generator=g) / 1200 ** 0.5
    Gb = X @ X.transpose(1, 2)
    I = torch.eye(1024, device=dev)
    L = torch.linalg.cholesky_ex(Gb)[0]

    def tri():
        Li = torch.linalg.solve_triangular(L, I.expand_as(L), upper=False)
        return Li.transpose(1, 2) @ Li

    for name, fn in (
            ("cholesky_ex batched 8",
             lambda: torch.linalg.cholesky_ex(Gb)),
            ("cholesky_ex loop 8",
             lambda: [torch.linalg.cholesky_ex(Gb[i]) for i in range(8)]),
            ("cholesky_solve(eye) batched 8",
             lambda: torch.cholesky_solve(I.expand_as(L), L)),
            ("cholesky_solve(eye) loop 8",
             lambda: [torch.cholesky_solve(I, L[i]) for i in range(8)]),
            ("cholesky_inverse batched 8", lambda: torch.cholesky_inverse(L)),
            ("solve_triangular + L^-T L^-1 batched 8", tri)):
        print(f"[{tag} fact] {name}: {ms(fn):.3f} ms", flush=True)
    A2, Bs2, _ = cs.rows_problems(dev)["3e"]
    m2 = A2.shape[1]

    def run():
        if hasattr(bk, "_br_rows"):
            return bk._br_rows(A2, Bs2, sparsity=m2 - 24)
        return [ct.br(A2, b, sparsity=m2 - 24) for b in Bs2]

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    print(f"[{tag}] br 24 deletions B=8 wall "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms", flush=True)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=18,
                                    max_name_column_width=60))


if __name__ == "__main__":
    main()
