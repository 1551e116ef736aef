"""Smoke run of cstpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the select and append kernels from cstpu_torch/csrc with nvcc,
holds each against its plain PyTorch version on the card, drives the main
path (`cstpu_torch.omp_batch`, batched OMP over one shared dictionary) at
the bench size (B=64, n=1024, m=8192, k=32) and at suite config 5b
(m=131072), checks planted-support recovery, launch counts and agreement
with the plain solve, and times kernels and solves with CUDA events.

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
TIMED_SOLVES = 7
TIMED_LAUNCHES = 20


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

    for key in fs.LAUNCHES:
        fs.LAUNCHES[key] = 0
    sol = cstpu_torch.omp_batch(A, Bs, k)
    torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    assert launches == {"select": k, "append": k}, launches
    m = A.shape[1]
    got = torch.where(sol.mask, sol.idx, m).cpu().numpy()
    rec = sum(set(s) <= set(g) for s, g in
              zip(sup.cpu().numpy().tolist(), got.tolist())) / len(got)
    assert rec == 1.0, f"planted-support recovery {rec} != 1.0"
    ref, _ = fs.omp_fused_solve_ref(A, Bs, k)
    assert torch.equal(sol.idx, ref.idx) and torch.equal(sol.mask, ref.mask)
    cerr = float((sol.val - ref.val).abs().max())
    assert cerr <= COEF_ATOL, cerr
    print(f"[main] omp_batch recovery={rec:.3f} launches={launches} "
          f"supports == plain solve, max |coef err| {cerr:.3e} "
          f"(atol {COEF_ATOL})")
    return launches


def times(A, Bs, k, r, Ac_sel, st, parts, Ac, gpu):
    import cstpu_torch
    from cstpu_torch.ops import fused_solve as fs

    B = Bs.shape[0]
    solve = cuda_ms(lambda: cstpu_torch.omp_batch(A, Bs, k).val.sum(),
                    TIMED_SOLVES)
    plain = cuda_ms(lambda: fs.omp_fused_solve_ref(A, Bs, k)[0].val.sum(),
                    TIMED_SOLVES)
    Ac_sel32 = Ac_sel.float()

    def launches(fn):
        def run():
            for _ in range(TIMED_LAUNCHES):
                fn()
            return Bs[0, 0]
        return cuda_ms(run, 5) / TIMED_LAUNCHES

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

    sel_err, app_err, launches, tm = record["bench"]
    kernels = [
        {"name": "select_argmax", "route": "cuda",
         "source": "cstpu_torch/csrc/select_argmax.cu",
         "replaces": "cstpu/ops/fused_solve.py:127",
         "also_replaces": "cstpu/ops/fused_solve.py:332",
         "launches": launches["select"], "max_abs_err": sel_err,
         "ms": tm["select"], "plain_ms": tm["plain_select"]},
        {"name": "omp_append", "route": "cuda",
         "source": "cstpu_torch/csrc/omp_append.cu",
         "replaces": "cstpu/ops/fused_solve.py:127",
         "also_replaces": "cstpu/ops/fused_solve.py:332",
         "launches": launches["append"], "max_abs_err": app_err,
         "ms": tm["append"], "plain_ms": tm["plain_append"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
