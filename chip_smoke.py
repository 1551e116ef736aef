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
  omp_sharded_fused(., 32, mesh)  suite config 5c (B=8, n=1024, m=131072)
                       on a mesh of one shard and of four shards on the one
                       card, both collective forms; and config 5m
                       (m=1,048,576, a 4 GB dictionary) on one shard
  mp/gomp/ompr/sp_sharded_fused   on 5c's dictionary with planted ones, four
                       shards; correlate_argmax on 5c's dictionary
  sp/ompr/srr_sharded_fused(., 160), gomp_sharded_fused(., 160, 160)
                       5c's problem past 128 picks (5c-wide), four shards:
                       the streamed top-l's wide route on the main path
  fr_sharded_fused(., 16, mesh)   config 3a widened to 5c's width (B=8,
                       n=1024, m=131072, correlated dictionary, decay 0.25),
                       one shard and four, both collective forms
  srr_sharded_fused(., 16, 1e-12, maxiter=16)  config 3b on the same
                       dictionary, four shards
  rmp/foba_sharded_fused(., 1e-2, kmax=32)  config 3d at m=131072 (5c's
                       dictionary, 16 planted ones), four shards
  omp_sharded_rows     a tall dictionary (n=65536, m=512) on four row shards
  sbl_batch, fsbl_batch, rmps_batch, rmps_estimate_noise_batch
                       suite config 4 (B=8, n=128, m=512, k=6, sigma 1e-2 and
                       3e-2), fsbl_traced and rmps_traced on one row of it;
                       fsbl_batch(maxiter=4k) and rmps_batch at config 4e
                       (B=8, n=1024, k=16, sigma 1e-2, m=131072 and 2^20),
                       fsbl_sharded and rmps_sharded on four shards at
                       m=131072 (the [sbl] phase: the SBL family has no TPU
                       kernel; it holds the solves, their agreement across
                       routes and shard counts, times, idle shares and loop
                       counts)
  bp_ard_sharded(., eps=1e-2, maxiter=2), bp_sharded
                       suite config 5 (n=128, k=6) at m=1024 on one shard
                       and m=4096 on four; bp, bp_candes, bp_ard, ista,
                       fista, bp(method="simplex"), bpd and bpd(method=
                       "homotopy") on the one-shard dictionary; bpd,
                       bpd_ard, bpd_sharded, bpd_secant_sharded and the
                       secant-screened bpd_ard at config 5bpd (n=1024,
                       m=131072, k=32, delta=1e-2); bp_ard_sharded at
                       config 5ard (m=2^20, a 4 GB dictionary, one shard);
                       exhaustive at n=32, m=48, k=3 against the CPU (the
                       [convex] phase: no TPU kernel either; it holds
                       recovery, one shard against four, the certified
                       bodies inside the delta-ball, times, idle shares
                       and loop counts)
  [distributed]        omp_sharded_fused (both collective forms),
                       gomp/ompr_sharded_fused at config 5c, fr_sharded_
                       fused at 3a-wide, rmps_sharded at 4e (m=131072) and
                       bp_sharded at config 5 (m=4096) over a (1, 4) mesh
                       that spans two worker processes of this script on
                       the one card (cstpu_torch.parallel.distributed,
                       gloo over localhost; each worker makes its own two
                       shards), bit for bit against the one-process (1, 4)
                       mesh, launches = a worker's shards x steps
  [examples]           examples/torch/0*.py on the card, each in its own
                       process: exit code 0 and a last line OK
  [surface]            every public name of cstpu_torch and
                       cstpu_torch.parallel on the card at small sizes
                       (benchmarks/tpu_smoke.py's tables, extended), each
                       result held against its oracle and against the same
                       call on CPU tensors; one PASS/FAIL line a case
  [fuzz]               tools/fuzz_torch.py's invariant checks on the card,
                       FUZZ_TRIALS trials, no violation

It checks planted-support recovery, launch counts (for the two-stage,
stepwise, backward and sharded paths against the formulas for the
iterations they ran: a streaming select per shard and step) and agreement
with the plain solves (for the sharded paths also across shard counts,
collective forms and with the unsharded batch solvers), and times kernels and solves with
CUDA events. K7 past 128 slots (its finish's wide route) is held against
its plain twin in the [topl wide] phase at l in TOPL_WIDE_LS and timed at
TOPL_WIDE_TIMED. The top-1 selects, the top-l selects (select_topl, K7's sweep)
and the rescaled selects (fr_select, fr_step_select) have two hand-written
variants, a tensor-core one for bf16 correlation and a CUDA-core one: both
are held against the plain twins, the bf16 paths must have taken the first
and the f32 paths (omp_batch, gomp_batch, fr_batch,
omp/ompr/fr_sharded_fused and correlate_argmax with f32 correlation, at a
smaller depth) the second, by their own launch counts; K7's finish, one
for both sweeps, is held alone against its plain fold; bw_select (a
thread-block cluster per row) is held bit for bit at BW_CLUSTER_CASES and
sp_round (a two-block cluster per row) at SP_ROUND_CASES, and a
[latency kernels] line sets their device times beside those before them;
omp_append and fr_append (a thread-block cluster per row over the staged
slot columns) are held at every step at APPEND_CASES, which take both of
the plan's instantiations, and an [append kernels] line sets their device
times, plans and registers beside the times before; mp_update (B C blocks,
no cluster) is held bit for bit at every step of chained MP steps at
MP_CASES and srr_append (a cluster per row on the slot engine's core) at
every launch at SRR_CASES, and an [mp srr kernels] line sets their device
times, bounds, plans and registers beside the times before; engine_delete
and engine_backward (a cluster per row on the slot engine's deletions) are
held at every launch at DELETE_CASES (engine_backward under both of its
rules), engine_backward is timed in a deleting stage of its own (3d's
state after its forward stage, down to DELETE_KFINAL atoms a row), and a
[delete kernels] line sets their device times, bounds from the data,
plans and registers beside the times before;
the later kernels' device time per launch and the paths' idle share come
from torch.profiler. Every kernel's time stands beside its bound
on an H100 (the bytes it must move over 3.35 TB/s, or its operations over
the peak rate of their type) and, where one PyTorch call computes the same
function, that call's time.

The second-to-last line of standard output is a JSON record of the
kernels; the last line is {"ok": true, "device": {...}}. Any failure
raises, so the exit code is not 0. Without a CUDA device it exits at
once with an error.
"""

import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from functools import partial
from typing import NamedTuple

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
# scores are sums of n=1024 products in another order (~1e-6 relative each);
# on the rows whose picks all stand clear of their runners-up (GAP_RTOL)
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
# cuda_ms's cap on the script's time: a call slower than WARM_ONCE_S is
# warmed up once, and the timed calls stop at about TIMED_BUDGET_S (a
# 1.7 s plain backward solve is timed once, not three times)
WARM_ONCE_S = 0.5
TIMED_BUDGET_S = 1.0
# device ms a launch of the CUDA-core selects on the f32 paths before their
# redesign on simt_select.cuh (each the parent commit's, by `tools/
# ab_paths.py ROOT TAG --f32`; for K4 and K8, a call is the sweep and the
# finish, and the time the mean of the A/B's two parent runs; PERF.md,
# NVIDIA H100 80GB HBM3, 700.00 W)
F32_BEFORE_MS = {"select bench": 0.1558, "select 5b": 0.9759,
                 "fr_select 3a": 0.3248, "select_topl 2a": 0.1795,
                 "select_topl 2b": 0.2608, "fr_step_select 131072": 0.7066,
                 "fr_step_select V 131072": 1.4320,
                 "fr_step_select 32768": 0.3163,
                 "fr_step_select V 32768": 0.4702}
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


def select_bound(B, n, m, cdt_bytes=2, terms=0, outs=1, masked=False):
    """A select launch: A (n, m) in cdt, r and `terms` pending vectors
    (B, n) f32, with terms also the rescalings (B, m) f32 both ways, the
    active mask and the column norms, with `masked` the active mask alone;
    `outs` (value, index) partials per tile and row (1.5 with the signed
    score). 2 B n m multiply-adds per product with A."""
    tiles = -(-m // 128)
    nbytes = (n * m * cdt_bytes + (1 + terms) * B * n * 4
              + B * tiles * outs * 8)
    if masked:
        nbytes += B * m
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
    """Median ms of up to `reps` timed calls of fn; each call is bracketed
    by CUDA events and synced by fetching a value. Two warm-up calls, one
    where the first took WARM_ONCE_S or more; then as many timed calls as
    TIMED_BUDGET_S holds at the last warm-up's time, at least one."""
    for _ in range(2):
        t0 = time.perf_counter()
        float(fn())
        took = time.perf_counter() - t0
        if took >= WARM_ONCE_S:
            break
    reps = max(1, min(reps, int(TIMED_BUDGET_S / max(took, 1e-6))))
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
    """select_argmax, its tensor-core variant (the one a bf16 dictionary
    takes) and its CUDA-core variant, against _select_ref on the card, with
    a duplicated column (lowest index wins) and a NaN row (index INT_MAX).
    Returns (max |val err| by variant, r, Ac)."""
    from cstpu_torch.ops import fused_solve as fs

    m = A.shape[1]
    Ac = A.to(torch.bfloat16)
    Ac[:, m - 5] = Ac[:, 123]
    r = Bs.clone()
    r[0] = Ac[:, 123].float()
    r[1, 5] = float("nan")
    pv, pi = fs._reduce_partials(*fs._select_ref(r, Ac.float(),
                                                 torch.bfloat16))
    scores = torch.abs(r.to(torch.bfloat16).float() @ Ac.float())
    top2 = scores[2:].topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > GAP_RTOL * top2[:, 0]
    errs = {}
    for key, mma in (("select_mma", None), ("select", False)):
        _, counts = run_counted(lambda: fs.select_argmax(r, Ac, mma=mma))
        assert counts == expect_launches(**{key: 1}), (key, counts)
        kv, ki = fs._reduce_partials(*fs.select_argmax(r, Ac, mma=mma))
        torch.cuda.synchronize()
        assert ki[0].item() == pi[0].item() == 123, (ki[0], pi[0])
        assert ki[1].item() == pi[1].item() == fs.INT_MAX, (ki[1], pi[1])
        assert torch.isnan(kv[1]) and torch.isnan(pv[1])
        agree = (ki[2:] == pi[2:]) | ~clear
        assert bool(agree.all()), "select idx disagree beyond the noise gap"
        err = (kv[2:] - pv[2:]).abs()
        assert bool((err <= SELECT_RTOL * pv[2:].abs()).all()), float(
            err.max())
        errs[key] = float(err.max())
    print(f"[select] tensor-core and CUDA-core variants: idx agree on "
          f"{int(clear.sum())}/{len(clear)} clear rows, tie->123, NaN "
          f"row->INT_MAX; max |val err| {errs['select_mma']:.3e} and "
          f"{errs['select']:.3e} (rtol {SELECT_RTOL})")
    return errs, r, Ac


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
    # a bf16 dictionary must have taken the tensor-core select
    assert launches == expect_launches(select_mma=k, append=k), launches
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


def f32_main_path(A, Bs, sup, k):
    """omp_batch with f32 correlation once with zeroed launch counts: true
    f32 stays on the CUDA-core select; recovery and the plain f32 solve's
    agreement."""
    import cstpu_torch
    from cstpu_torch.ops import fused_solve as fs

    sol, launches = run_counted(
        lambda: cstpu_torch.omp_batch(A, Bs, k, precision="f32"))
    assert launches == expect_launches(select=k, append=k), launches
    rec = recovery(sol, sup)
    assert rec == 1.0, f"planted-support recovery {rec} != 1.0"
    ref, _ = fs.omp_fused_solve_ref(A, Bs, k, torch.float32)
    assert torch.equal(sol.idx, ref.idx) and torch.equal(sol.mask, ref.mask)
    cerr = float((sol.val - ref.val).abs().max())
    assert cerr <= COEF_ATOL, cerr

    def solve():
        return cstpu_torch.omp_batch(A, Bs, k, precision="f32")

    wall = cuda_ms(lambda: solve().val.sum(), TIMED_SOLVES)
    busy, per = profile_path(solve)
    print(f"[main f32] omp_batch(precision='f32') k={k} recovery={rec:.3f} "
          f"launches={launches}: the CUDA-core select; supports == plain "
          f"solve, max |coef err| {cerr:.3e} (atol {COEF_ATOL}); wall "
          f"{wall:.4f} ms, device busy {busy:.4f} ms ("
          + ", ".join(f"{name} {c}x {ms:.4f}" for name, (c, ms) in
                      per.items()) + ")")
    return launches


def per_launch_ms(x, fn):
    """Median ms per call of fn, over 5 timed runs of TIMED_LAUNCHES calls;
    each run ends by fetching an element of x."""
    def run():
        for _ in range(TIMED_LAUNCHES):
            fn()
        return x.flatten()[0]
    return cuda_ms(run, 5) / TIMED_LAUNCHES


def device_ms_per_call(fn, reps=TIMED_LAUNCHES):
    """Device ms per call of fn under torch.profiler: the sum of the device
    records' spans over `reps` calls (after a warm-up), whatever the host
    takes between them; each kernel once, so a library call (torch's
    operations) is read as our kernels are (a sum over key_averages counts
    a torch operation's kernels twice). The profiler can lose records: the
    calls are profiled until the highest count of records comes twice (up
    to PROFILE_TRIES + 1 profiles), else the device time is not measured
    (None; host time between the calls is never read as device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [ev.duration_ns()
                 for ev in prof.profiler.kineto_results.events()
                 if ev.device_type() == DeviceType.CUDA
                 and not getattr(ev, "is_user_annotation", lambda: False)()]
        # a lost record only lowers a profile's count of records: the
        # highest count, seen twice, is a whole profile
        if spans and len(spans) in counts and len(spans) >= max(counts):
            return sum(spans) / 1e6 / reps
        counts.append(len(spans))
    print(f"[profile] device records of {reps} calls by profile: {counts}; "
          "device time not measured")
    return None


def ms4(v):
    """A time for a print line: four decimals, or "not measured" (None)."""
    return "not measured" if v is None else f"{v:.4f}"


def f32_line(ms, before, bnd, lib, lib_name="torch.matmul f32"):
    """A [time f32] line's numbers: device ms beside the parent's, the bound
    and the f32 library call's device ms (either may be not measured)."""
    parts = [(f"{ms:.4f} ms device" if ms else "device ms not measured")
             + f" (before {before:.4f}"
             + (f", {before / ms:.2f}x" if ms else ""),
             f"bound {bnd['bound_ms']:.4f} by {bnd['bound_by']}"
             + (f", {bnd['bound_ms'] / ms:.1%} of it" if ms else ""),
             f"{lib_name} {ms4(lib)}"
             + (f", {ms / lib:.2f}x of it" if ms and lib else "")]
    return "; ".join(parts) + ")"


def times(A, Bs, k, r, Ac_sel, st, parts, Ac, gpu, cell="bench"):
    import cstpu_torch
    from cstpu_torch.ops import fused_solve as fs

    B = Bs.shape[0]
    solve = cuda_ms(lambda: cstpu_torch.omp_batch(A, Bs, k).val.sum(),
                    TIMED_SOLVES)
    plain = cuda_ms(lambda: fs.omp_fused_solve_ref(A, Bs, k)[0].val.sum(),
                    TIMED_SOLVES)
    Ac_sel32 = Ac_sel.float()

    launches = partial(per_launch_ms, Bs)
    # the tensor-core variant, the CUDA-core one (the earlier time), the
    # CUDA-core one in f32, and the first one's device time (its wrapper
    # may take longer than its kernels)
    sel = launches(lambda: fs.select_argmax(r, Ac_sel))
    sel_simt = launches(lambda: fs.select_argmax(r, Ac_sel, mma=False))
    sel_f32 = launches(lambda: fs.select_argmax(r, Ac_sel32))
    sel_dev = device_ms_per_call(lambda: fs.select_argmax(r, Ac_sel))
    # the CUDA-core loop on the f32 path, on the device, beside the parent's
    # time, its bound and the f32 library call's
    sel_f32_dev = device_ms_per_call(lambda: fs.select_argmax(r, Ac_sel32))
    # ... and by batch rows: a block re-reads its rows of r for every tile,
    # so the time over the dictionary's bytes grows with the rows
    by_rows = {rows: device_ms_per_call(
        lambda: fs.select_argmax(r[:rows].contiguous(), Ac_sel))
        for rows in (8, 16, 32) if rows < B}
    sel_p = launches(lambda: fs._select_ref(r, Ac_sel32, torch.bfloat16))
    # the yardstick: one torch.matmul (cuBLAS, f32) gives the select's
    # scores, without its abs and argmax; beside it the same product on the
    # tensor cores (bf16 operands, f32 sums, bf16 out); the port's kernel
    # path calls neither
    r32 = r.to(torch.bfloat16).float()
    gemm = launches(lambda: torch.matmul(r32, Ac_sel32))
    gemm_dev = device_ms_per_call(lambda: torch.matmul(r32, Ac_sel32))
    m = A.shape[1]
    print(f"[time f32 {cell}] select_argmax, CUDA cores, B={B} n="
          f"{A.shape[0]} m={m}: " + f32_line(
              sel_f32_dev, F32_BEFORE_MS[f"select {cell}"],
              select_bound(B, A.shape[0], m, cdt_bytes=4), gemm_dev)
          + f" | {gpu}")
    rb = r.to(torch.bfloat16)
    gemm_bf16 = launches(lambda: torch.matmul(rb, Ac_sel))
    t = k // 2
    _, *out = fs._init_state(Bs, k, A.shape[1])
    Ac32 = Ac.float()
    app = launches(lambda: fs.omp_append(*parts, Ac, Bs, st, t, *out))
    app_p = launches(lambda: fs._append_ref(*parts, Ac32, Bs, st, t, *out))
    print(f"[time] solve {solve:.4f} ms (plain {plain:.4f} ms), "
          f"{B * k / (solve / 1e3):.1f} atoms/s (plain "
          f"{B * k / (plain / 1e3):.1f}); select, tensor cores {sel:.4f} ms "
          f"per call, {ms4(sel_dev)} on the device ("
          + ", ".join(f"{ms4(v)} at B={rows}" for rows, v in by_rows.items())
          + f"; CUDA cores {sel_simt:.4f}, "
          f"in f32 {sel_f32:.4f}; plain {sel_p:.4f}; torch.matmul of the "
          f"scores alone {gemm:.4f}, in bf16 {gemm_bf16:.4f}); append "
          f"{app:.4f} ms (plain "
          f"{app_p:.4f}) | {gpu}")
    busy, per = profile_path(lambda: cstpu_torch.omp_batch(A, Bs, k))
    print(f"[split omp_batch B={B} m={A.shape[1]}] wall {solve:.4f} ms, "
          f"device busy {busy:.4f} ms, idle share {1.0 - busy / solve:.4f}; "
          + ", ".join(f"{name} {c}x {ms:.4f} ms"
                      for name, (c, ms) in per.items()))
    return {"solve": solve, "plain_solve": plain, "select": sel,
            "split": per,
            "select_simt": sel_simt, "select_f32": sel_f32,
            "select_f32_device": sel_f32_dev, "select_gemm_device": gemm_dev,
            "select_device": sel_dev, "select_device_by_rows": by_rows,
            "device_busy": busy,
            "plain_select": sel_p, "select_gemm": gemm,
            "select_gemm_bf16": gemm_bf16, "append": app,
            "plain_append": app_p}


def _hold_rescaled(kern, plain, rk, rp, rows, A32, cn2, r, amask, mma):
    """A rescaled select's partials (kern) against its plain twin's from
    identical state, with rk and rp the rescalings each wrote: resc on
    `rows` to RESC_ATOL, NaN partials in the same places, finite ones to
    SELECT_RTOL relative, and the picks equal on every row of `rows` for the
    CUDA-core variant; the tensor-core variant (mma) sums in another order,
    so its picks are compared on the rows of `rows` whose best score stands
    clear of the next by GAP_RTOL, and at least three quarters of them must
    stand clear. Returns (resc err, d2 rel err, rows compared)."""
    from cstpu_torch.ops import fused_solve as fs

    (kv, ki), (pv, pi) = kern, plain
    resc_err = float((rk[rows] - rp[rows]).abs().max())
    assert resc_err <= RESC_ATOL, resc_err
    assert torch.equal(torch.isnan(kv), torch.isnan(pv))
    fin = ~torch.isnan(pv) & torch.isfinite(pv)
    d2_err = float(((kv[fin] - pv[fin]).abs()
                    / pv[fin].abs().clamp(min=1e-30)).max())
    assert d2_err <= SELECT_RTOL, d2_err
    compared = rows
    if mma:
        q = r.to(torch.bfloat16).float() @ A32
        rmin = fs._f32(fs._degeneracy_rtol(A32.shape[0])) * cn2
        d2 = torch.where(amask.bool(), 0.0,
                         torch.where(rp > rmin, q * q / rp, -torch.inf))
        compared = _clear_rows(d2) & rows
        assert 4 * int(compared.sum()) >= 3 * int(rows.sum()), \
            (int(compared.sum()), int(rows.sum()))
    i, ir = fs._reduce_partials(kv, ki)[1], fs._reduce_partials(pv, pi)[1]
    assert bool((i == ir)[compared].all()), "rescaled select picks disagree"
    return resc_err, d2_err, compared


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
    rv, ri, rs = fs._select_ref(r, Ac32, bf, signed=True)
    # the CUDA-core variant first, then the one the path takes
    for key, mma in (("select_signed_simt", False), ("select_signed", None)):
        pv, pi, ps = fs.select_argmax(r, Ac, signed=True, mma=mma)
        pv0, pi0 = fs.select_argmax(r, Ac, mma=mma)
        torch.cuda.synchronize()
        assert torch.equal(pi, pi0) and torch.equal(pv.nan_to_num(-1.0),
                                                    pv0.nan_to_num(-1.0))
        i, ir = fs._reduce_partials(pv, pi)[1], fs._reduce_partials(rv, ri)[1]
        assert int(i[0]) == int(ir[0]) == 77 and int(i[1]) == fs.INT_MAX
        same = (pi == ri) & ~torch.isnan(pv)
        err[key] = float((ps[same] - rs[same]).abs().max())
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
    # r bit for bit: the products and differences rounded as the twin's
    assert torch.equal(rk.nan_to_num(), rr.nan_to_num()), err["mp_update"]
    assert torch.isnan(rk[1]).any() and torch.equal(rk[1].isnan(),
                                                    rr[1].isnan())
    print(f"[mp kernels] signed select: partials equal to OMP's, tie->77, "
          f"NaN row->INT_MAX, max |signed err| {err['select_signed']:.3e}; "
          f"mp_update x and r equal bit for bit")

    # --- select_topl and gomp_append (config 2a dictionary) --------------
    tv, ti = fs._topl_ref(r, Ac32, bf, l)
    pref = fs._merge_topl(tv, ti, l)
    scores = torch.abs(r.to(bf).float() @ Ac32)[2:]
    srt = scores.sort(1, descending=True).values[:, :l + 1]
    clear = ((srt[:, :-1] - srt[:, 1:]) > GAP_RTOL * srt[:, :1]).all(1)
    # the CUDA-core variant, then the tensor-core one (the path's)
    for key, mma in (("select_topl", False), ("select_topl_mma", None)):
        (kv, ki), counts = run_counted(lambda: fs.select_topl(r, Ac, l,
                                                              mma=mma))
        assert counts == expect_launches(**{key: 1}), (key, counts)
        fin = torch.isfinite(tv)
        assert torch.equal(torch.isfinite(kv), fin)
        err[key] = float((kv[fin] - tv[fin]).abs().max())
        assert bool(((kv[fin] - tv[fin]).abs()
                     <= SELECT_RTOL * tv[fin].abs() + 1e-6).all())
        picks = fs._merge_topl(kv, ki, l)
        assert picks[0, :2].tolist() == [77, m - 3], picks[0]
        assert (picks[1] == fs.INT_MAX).all() and (pref[1] == fs.INT_MAX).all()
        agree = (picks[2:] == pref[2:]).all(1) | ~clear
        assert bool(agree.all()), "top-l picks disagree beyond the noise gap"
    # one loop: the first of a tile's l is the top-1 select's partial, bits
    # and index
    tv1, ti1 = fs.select_argmax(r, Ac, mma=True)
    assert torch.equal(kv[:, :, 0].view(torch.int32), tv1.view(torch.int32))
    assert torch.equal(ki[:, :, 0], ti1)
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
    print(f"[gomp kernels] select_topl l={l}, tensor-core and CUDA-core "
          f"variants: tie->(77, {m - 3}), NaN row all INT_MAX, picks agree "
          f"on {int(clear.sum())}/{len(clear)} clear rows, max |val err| "
          f"{err['select_topl_mma']:.3e} and {err['select_topl']:.3e}; the "
          f"tensor-core one's first entry per tile == the top-1 select's "
          f"partial bit for bit; "
          f"gomp_append (iteration {k // l // 2}) idx/kcnt/done equal, max "
          f"|err| {err['gomp_append']:.3e} (atol {APPEND_ATOL})")

    # --- fr_select and fr_append (config 3a correlated dictionary) -------
    Arc = Ar.to(bf).contiguous()
    Arc32 = Arc.float()
    cn2 = torch.sum(Ar * Ar, dim=0)
    Brn = Br.clone()
    Brn[3, 0] = float("nan")
    st0 = fs._init_fr(Brn, k_fr, cn2)
    t = k_fr // 2
    for s in range(t):
        fs._fr_append_ref(*fs._fr_select_ref(Arc32, cn2, st0, bf), Arc32, Brn,
                          st0, s, 0.0, 0.0)
    rows = torch.arange(Br.shape[0], device=A.device) != 3
    # the CUDA-core variant, then the one the path takes, each from a copy
    # of the same state; the path's goes on to the append
    for key, mma in (("fr_select", False), ("fr_select_mma", None)):
        st = fs._FrState(*(x.clone() for x in st0))
        stk = fs._FrState(*(x.clone() for x in st0))
        (kv, ki), counts = run_counted(
            lambda: fs.fr_select(Arc, cn2, stk, mma=mma))
        assert counts == expect_launches(**{key: 1}), (key, counts)
        pv, pi = fs._fr_select_ref(Arc32, cn2, st, bf)
        torch.cuda.synchronize()
        assert (ki[3] == fs.INT_MAX).all()
        resc_err, d2_err, same = _hold_rescaled(
            (kv, ki), (pv, pi), stk.resc, st.resc, rows, Arc32, cn2, st.r,
            st.amask, mma is None)
        fin = ~torch.isnan(pv) & torch.isfinite(pv)
        err[key] = max(resc_err, float((kv[fin] - pv[fin]).abs().max()))
        print(f"[fr kernels] {key} (step {t}) resc max |err| {resc_err:.3e} "
              f"(atol {RESC_ATOL}), d2 max rel err {d2_err:.3e} (rtol "
              f"{SELECT_RTOL}), picks equal on {int(same.sum())}/"
              f"{int(rows.sum())} rows ("
              f"{'the clear ones' if mma is None else 'all'}), NaN row "
              f"INT_MAX")
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
    print(f"[fr kernels] fr_append idx/done/amask equal, NaN row latched, "
          f"max |err| {err['fr_append']:.3e} (atol {APPEND_ATOL})")
    return err, {"mp": (pv0, pi0, ps, Ac), "fr": (stk, Arc, cn2, kv, ki)}


def mp_clear_rows(A, Bs, k):
    """Rows of the plain bf16 MP solve whose every pick stood clear of its
    runner-up by more than GAP_RTOL of the top score. MP compares dense x
    and r after k picks, and two picks within the sums' noise may come in
    either order (the order moves x by their atoms' inner product), so, as
    for the select itself, a solve is compared on its clear rows."""
    from cstpu_torch.ops import fused_solve as fs

    bf = torch.bfloat16
    Ac32 = A.to(bf).float()
    r = Bs.clone()
    x = torch.zeros((Bs.shape[0], A.shape[1]), device=A.device)
    clear = torch.ones((Bs.shape[0],), dtype=torch.bool, device=A.device)
    for _ in range(k):
        top2 = torch.abs(r.to(bf).float() @ Ac32).topk(2, dim=1).values
        clear &= (top2[:, 0] - top2[:, 1]) > GAP_RTOL * top2[:, 0]
        fs._mp_update_ref(*fs._select_ref(r, Ac32, bf, signed=True), Ac32, x,
                          r)
    return clear


def greedy_paths(A, Bs, Bg, sup_g, Ar, Br, sup_f):
    """mp_batch, gomp_batch and fr_batch once each with zeroed launch
    counts; recovery and agreement with the plain solves."""
    import cstpu_torch
    from cstpu_torch.ops import fused_solve as fs

    _, B, n, m, k = MP_CELL
    x, launches_mp = run_counted(lambda: cstpu_torch.mp_batch(A, Bs, k))
    assert launches_mp == expect_launches(select_mma=k, mp_update=k), \
        launches_mp
    xr, rr = fs.mp_fused_solve_ref(A, Bs, k)
    Ac32 = A.to(torch.bfloat16).float()
    r = Bs - x @ Ac32.T
    clear = mp_clear_rows(A, Bs, k)
    assert int(clear.sum()) >= 3 * B // 4, int(clear.sum())
    x_err = float((x - xr)[clear].abs().max())
    r_err = float((r - rr)[clear].abs().max())
    assert x_err <= MP_ATOL and r_err <= MP_ATOL, (x_err, r_err)
    fall = r.norm(dim=1) / Bs.norm(dim=1)
    assert bool((fall < 1).all()), "MP residual did not fall"
    print(f"[main mp] mp_batch k={k} launches={launches_mp}; x, r vs plain "
          f"on the {int(clear.sum())}/{B} rows whose picks all stand clear "
          f"(gap {GAP_RTOL}): max |err| {x_err:.3e}, {r_err:.3e} (atol "
          f"{MP_ATOL}; all rows {float((x - xr).abs().max()):.3e}); "
          f"||r||/||b|| max {float(fall.max()):.4f}")

    _, B, n, m, k, l = GOMP_CELL
    sol, launches_g = run_counted(
        lambda: cstpu_torch.gomp_batch(A, Bg, l, k))
    it = -(-k // l)
    # a bf16 dictionary must have taken the tensor-core top-l select
    assert launches_g == expect_launches(select_topl_mma=it,
                                         gomp_append=it), launches_g
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
    # a bf16 dictionary must have taken the tensor-core select
    assert launches_f == expect_launches(fr_select_mma=k, fr_append=k), \
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


def fr_f32_path(Ar, Br, sup):
    """fr_batch with f32 correlation at 3a's size once with zeroed launch
    counts: true f32 stays on the CUDA-core rescaled select; recovery and
    the plain f32 solve's agreement."""
    import cstpu_torch
    from cstpu_torch.ops import fused_solve as fs

    k = FR_CELL[4]
    sol, launches = run_counted(
        lambda: cstpu_torch.fr_batch(Ar, Br, sparsity=k, precision="f32"))
    assert launches == expect_launches(fr_select=k, fr_append=k), launches
    rec = recovery(sol, sup)
    assert rec == 1.0, f"fr_batch f32 recovery {rec} != 1.0"
    ref, _ = fs.fr_fused_solve_ref(Ar, Br, k, corr_dtype=torch.float32)
    assert torch.equal(sol.idx, ref.idx) and torch.equal(sol.mask, ref.mask)
    cerr = float((sol.val - ref.val).abs().max())
    assert cerr <= COEF_ATOL, cerr

    def solve():
        return cstpu_torch.fr_batch(Ar, Br, sparsity=k, precision="f32")

    wall = cuda_ms(lambda: solve().val.sum(), TIMED_SOLVES)
    busy, per = profile_path(solve)
    print(f"[main 3a f32] fr_batch(precision='f32') k={k} recovery={rec:.3f} "
          f"launches={launches['fr_select']}: the CUDA-core rescaled select; "
          f"supports == plain solve, max |coef err| {cerr:.3e} (atol "
          f"{COEF_ATOL}); wall {wall:.4f} ms, device busy {busy:.4f} ms ("
          + ", ".join(f"{name} {c}x {ms:.4f}" for name, (c, ms) in
                      per.items()) + ")")
    return launches


def gomp_f32_path(A, Bg, sup):
    """gomp_batch with f32 correlation at 2a's size once with zeroed launch
    counts: true f32 stays on the CUDA-core top-l select; recovery and the
    plain f32 solve's agreement."""
    import cstpu_torch
    from cstpu_torch.ops import fused_solve as fs

    _, B, n, m, k, l = GOMP_CELL
    sol, launches = run_counted(
        lambda: cstpu_torch.gomp_batch(A, Bg, l, k, precision="f32"))
    it = -(-k // l)
    assert launches == expect_launches(select_topl=it, gomp_append=it), \
        launches
    rec = recovery(sol, sup)
    assert rec == 1.0, f"gomp_batch f32 recovery {rec} != 1.0"
    ref, _ = fs.gomp_fused_solve_ref(A, Bg, l, k, corr_dtype=torch.float32)
    assert torch.equal(sol.idx, ref.idx) and torch.equal(sol.mask, ref.mask)
    cerr = float((sol.val - ref.val).abs().max())
    assert cerr <= COEF_ATOL, cerr
    print(f"[main 2a f32] gomp_batch(precision='f32') l={l} k={k} "
          f"recovery={rec:.3f} launches={launches['select_topl']}: the "
          f"CUDA-core top-l select; supports == plain solve, max |coef err| "
          f"{cerr:.3e} (atol {COEF_ATOL})")
    return launches


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

    busy, per = profile_path(lambda: cstpu_torch.mp_batch(A, Bs, k))
    tm["mp_device_busy"] = busy
    tm["mp_split"] = per
    print(f"[split mp] wall {tm['mp']:.4f} ms, device busy {busy:.4f} ms, "
          f"idle share {1.0 - busy / tm['mp']:.4f}; "
          + ", ".join(f"{name} {c}x {ms:.4f} ms"
                      for name, (c, ms) in per.items()))
    # the profiler's split of 2a and 3a
    tm["splits"] = {
        "2a": _split(tm["gomp"], lambda: cstpu_torch.gomp_batch(A, Bg, l, kg)),
        "3a": _split(tm["fr"], lambda: cstpu_torch.fr_batch(Ar, Br,
                                                            sparsity=kf))}
    for key, sp_ in tm["splits"].items():
        print(f"[split {key}] wall {sp_['wall_ms']:.4f} ms, device busy "
              f"{sp_['device_busy_ms']:.4f} ms, idle share "
              f"{sp_['idle_share']:.4f}; "
              + ", ".join(f"{nm} {v['launches']}x {v['ms']:.4f} ms"
                          for nm, v in sp_["kernels"].items()))
    launches = partial(per_launch_ms, Bs)
    pv, pi, ps, Ac = parts["mp"]
    Ac32 = Ac.float()
    r = Bs.clone()
    tm["select_signed"] = launches(lambda: fs.select_argmax(r, Ac, True))
    tm["select_signed_simt"] = launches(
        lambda: fs.select_argmax(r, Ac, True, mma=False))
    tm["select_signed_device"] = device_ms_per_call(
        lambda: fs.select_argmax(r, Ac, True))
    tm["plain_select_signed"] = launches(
        lambda: fs._select_ref(r, Ac32, bf, True))
    x = torch.zeros((B, A.shape[1]), device=A.device)
    tm["mp_update"] = launches(lambda: fs.mp_update(pv, pi, ps, Ac, x, r))
    tm["plain_mp_update"] = launches(
        lambda: fs._mp_update_ref(pv, pi, ps, Ac32, x, r))
    r = Bg.clone()
    # the yardstick: one f32 torch.matmul of the products the kernel
    # computes in its body, here the scores r . A, and the same product in
    # bf16 on the tensor cores; and that bf16 GEMM followed by torch.topk
    # over each tile of 128 (never called by the port)
    r32, rb = r.to(bf).float(), r.to(bf)
    T = -(-A.shape[1] // fs.TILE)
    tm["select_topl_gemm"] = launches(lambda: torch.matmul(r32, Ac32))
    tm["select_topl_gemm_bf16"] = launches(lambda: torch.matmul(rb, Ac))
    # at 2a's l and at 2b's: the tensor-core variant (the paths') per call
    # and on the device, the CUDA-core one on the same bf16 inputs, the
    # plain twin, the composite yardstick
    for lv, sfx in ((l, ""), (SP_CELL[1], "32")):
        call = partial(fs.select_topl, r, Ac, lv)
        tm["select_topl" + sfx] = launches(call)
        tm["select_topl" + sfx + "_device"] = device_ms_per_call(call)
        tm["select_topl" + sfx + "_simt"] = launches(
            lambda: call(mma=False))
        tm["select_topl" + sfx + "_simt_device"] = device_ms_per_call(
            lambda: call(mma=False))
        tm["plain_select_topl" + sfx] = launches(
            lambda: fs._topl_ref(r, Ac32, bf, lv))
        tm["select_topl" + sfx + "_gemm_topk"] = launches(
            lambda: torch.matmul(rb, Ac).view(B, T, fs.TILE).abs().topk(
                lv, dim=2))
    # the f32 path's dictionary, and half the rows (16 a block, not 32)
    tm["select_topl_f32"] = launches(lambda: fs.select_topl(r, Ac32, l))
    # the CUDA-core variant on the f32 path's f32 dictionary at 2a's l and
    # 2b's, on the device, beside the parent's time, its f32 bound and one
    # f32 torch.matmul followed by torch.topk a tile (the matmul alone too)
    n, m = A.shape
    tm["select_topl_f32_gemm_device"] = device_ms_per_call(
        lambda: torch.matmul(r, A))
    for lv, sfx, cell in ((l, "", "2a"), (SP_CELL[1], "32", "2b")):
        tm["select_topl" + sfx + "_f32_device"] = device_ms_per_call(
            lambda: fs.select_topl(r, A, lv))
        tm["select_topl" + sfx + "_f32_topk_device"] = device_ms_per_call(
            lambda: torch.matmul(r, A).view(B, T, fs.TILE).abs().topk(
                lv, dim=2))
        print(f"[time f32 {cell}] select_topl l={lv}, CUDA cores, B={B} n={n}"
              f" m={m}: " + f32_line(
                  tm["select_topl" + sfx + "_f32_device"],
                  F32_BEFORE_MS[f"select_topl {cell}"],
                  select_bound(B, n, m, cdt_bytes=4, outs=lv),
                  tm["select_topl" + sfx + "_f32_topk_device"],
                  "torch.matmul f32 + torch.topk")
              + f"; the matmul alone {ms4(tm['select_topl_f32_gemm_device'])}"
              f" | {gpu}")
    r_half = r[:B // 2].contiguous()
    tm["select_topl_device_half"] = device_ms_per_call(
        lambda: fs.select_topl(r_half, Ac, l))
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
    # the rescaled select: its tensor-core variant (the path's), its device
    # time, the CUDA-core variant on the same inputs and on the f32
    # dictionary, and one f32 torch.matmul of its products [r; aperp] . A
    s = fs._FrState(*(x.clone() for x in stf))
    tm["fr_select_device"] = device_ms_per_call(
        lambda: fs.fr_select(Arc, cn2, s))
    tm["fr_select_simt"] = launches(lambda: fs.fr_select(Arc, cn2, s,
                                                          mma=False))
    tm["fr_select_f32"] = launches(lambda: fs.fr_select(Arc32, cn2, s))
    tm["fr_select_f32_device"] = device_ms_per_call(
        lambda: fs.fr_select(Arc32, cn2, s))
    ru = torch.cat([stf.r, stf.aperp]).to(bf).float()
    tm["fr_select_gemm"] = launches(lambda: torch.matmul(ru, Arc32))
    tm["fr_select_gemm_device"] = device_ms_per_call(lambda: torch.matmul(ru, Arc32))
    Bf, nf, mf = stf.r.shape[0], Arc.shape[0], Arc.shape[1]
    print(f"[time f32 3a] fr_select, CUDA cores, one pending term, B={Bf} "
          f"n={nf} m={mf}: " + f32_line(
              tm["fr_select_f32_device"], F32_BEFORE_MS["fr_select 3a"],
              select_bound(Bf, nf, mf, cdt_bytes=4, terms=1),
              tm["fr_select_gemm_device"]) + f" | {gpu}")
    rub = ru.to(bf)
    tm["fr_select_gemm_bf16"] = launches(lambda: torch.matmul(rub, Arc))
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
        + f"; select_signed on CUDA cores {tm['select_signed_simt']:.4f}, "
        f"on the device {tm['select_signed_device']:.4f}"
        + f"; fr_select on the device {tm['fr_select_device']:.4f}, on CUDA "
        f"cores {tm['fr_select_simt']:.4f} (f32 {tm['fr_select_f32']:.4f}), "
        f"torch.matmul of its products {tm['fr_select_gemm']:.4f} (bf16 "
        f"{tm['fr_select_gemm_bf16']:.4f}); select_topl's scores by "
        f"torch.matmul {tm['select_topl_gemm']:.4f} (bf16 "
        f"{tm['select_topl_gemm_bf16']:.4f})"
        + "; select_topl " + ", ".join(
            f"l={lv}: tensor cores {tm['select_topl' + sfx]:.4f} per call, "
            f"{tm['select_topl' + sfx + '_device']:.4f} on the device, CUDA "
            f"cores {tm['select_topl' + sfx + '_simt']:.4f} "
            f"({tm['select_topl' + sfx + '_simt_device']:.4f} device), "
            f"plain {tm['plain_select_topl' + sfx]:.4f}, bf16 GEMM + topk "
            f"{tm['select_topl' + sfx + '_gemm_topk']:.4f}"
            for lv, sfx in ((l, ""), (SP_CELL[1], "32")))
        + f"; f32 dictionary {tm['select_topl_f32']:.4f}, tensor cores at "
        f"B={B // 2} {tm['select_topl_device_half']:.4f} device"
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
    pv, pi = fs._select_ref(st.r, Ac32, bf, False, st.amask, 1.0)
    live = ~torch.isnan(pv)
    # the CUDA-core variant first, then the one the path takes
    for key, mma in (("select_masked_simt", False), ("select_masked", None)):
        kv, ki = fs.select_argmax(st.r, Ac, amask=st.amask, mma=mma)
        zv, zi = fs.select_argmax(st.r, Ac, mma=mma,
                                  amask=torch.zeros_like(st.amask))
        ov, oi = fs.select_argmax(st.r, Ac, mma=mma)
        torch.cuda.synchronize()
        assert torch.equal(zv.nan_to_num(-1.0), ov.nan_to_num(-1.0))
        assert torch.equal(zi, oi)
        err[key] = float((kv[live] - pv[live]).abs().max())
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
    err["fr_select_pending_simt"] = 0.0
    nclear = int(rows.sum())
    for it in range(2):
        if it == 1:
            st.done[5] = 1.0
        row5 = {name: x[5].clone() for name, x in zip(st._fields, st)
                if x is not None and name not in ("resc", "pend_u",
                                                  "pend_w")}
        # the CUDA-core variant on a copy, then the one the path takes
        stk, simt = _clone(st), _clone(st)
        sparts = fs.rescaled_select(Arc, cn2, simt.r, simt.pend_u[:npend],
                                    simt.pend_w[:npend], 1.0, simt.amask,
                                    simt.resc, mma=False)
        kv, ki = fs.rescaled_select(Arc, cn2, stk.r, stk.pend_u[:npend],
                                    stk.pend_w[:npend], 1.0, stk.amask,
                                    stk.resc)
        pv, pi = fs._rescaled_select_ref(Arc32, cn2, st.r, st.pend_u[:npend],
                                         st.pend_w[:npend], 1.0, st.amask,
                                         st.resc, bf)
        torch.cuda.synchronize()
        held = _hold_rescaled(sparts, (pv, pi), simt.resc, st.resc, rows,
                              Arc32, cn2, st.r, st.amask, False)
        err["fr_select_pending_simt"] = max(err["fr_select_pending_simt"],
                                            *held[:2])
        e_resc, e_d2, same = _hold_rescaled((kv, ki), (pv, pi), stk.resc,
                                            st.resc, rows, Arc32, cn2, st.r,
                                            st.amask, True)
        resc_err, d2_err = max(resc_err, e_resc), max(d2_err, e_d2)
        nclear = min(nclear, int(same.sum()))
        assert int(fs._reduce_partials(kv, ki)[1][3]) == fs.INT_MAX
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
          f"fr_select with pending terms, tensor cores: "
          f"resc max |err| {resc_err:.3e} (atol {RESC_ATOL}), d2 max rel err "
          f"{d2_err:.3e}; CUDA cores: max err "
          f"{err['fr_select_pending_simt']:.3e}; picks equal on all "
          f"{int(rows.sum())} rows (CUDA cores) and on at least {nclear} "
          f"clear rows (tensor cores), NaN row INT_MAX; srr_append max |err| "
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
    for case in SP_ROUND_CASES:
        e = hold_sp_round(A.device, *case)
        err["sp_round"] = max(err["sp_round"], e)
        print(f"[2b kernels] sp_round case (B, n, m, k) = {case}: "
              f"{SP_ROUNDS} rounds from identical state, idx equal, NaN row "
              f"empty, poisoned partials no pick, done row untouched, max "
              f"|err| {e:.3e} (atol {APPEND_ATOL})")
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
        want = {"2b": dict(select_topl_mma=1 + it, sp_round=1 + it),
                "2c": dict(select_topl_mma=1, engine_init=1, select_mma=it,
                           ompr_swap=it),
                "3b": dict(select_topl_mma=1, engine_init=1,
                           fr_select_mma=it, srr_append=it,
                           engine_delete=it)}[cell]
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


# the kernels by name (a profiler key holds "<name>_kernel"); gomp_append
# comes before omp_append, fr_select_simt before select_simt (the CUDA-core
# selects; select_argmax and fr_select in checkouts before them), whose
# names are inside their own; select_topl_simt and fr_step_simt are the
# CUDA-core top-l select and K8 sweep (select_topl and fr_step_sweep in
# checkouts before them), stream_top1_simt the CUDA-core top-1 sweep of K6,
# K9 and K10 (stream_sweep before it), stream_topl_simt K7's CUDA-core
# sweep (stream_topl_sweep before it)
KERNEL_NAMES = ("fr_select_simt", "select_simt", "select_topl_simt",
                "fr_step_simt", "stream_top1_simt", "stream_topl_simt",
                "select_argmax",
                "top1_mma", "topl_mma", "round_rows", "gomp_append",
                "omp_append", "fr_append", "mp_update", "select_topl", "fr_select", "engine_init",
                "ompr_swap", "srr_append", "engine_delete", "sp_round",
                "rmp_append", "engine_backward", "bw_select", "bw_downdate",
                "stream_sweep", "stream_finish", "stream_topl_sweep",
                "stream_topl_merge", "stream_topl_fold",
                "stream_topl_merge_wide", "stream_topl_fold_wide",
                "fr_step_sweep", "rescaled_mma")


# the wrappers whose one count is one launch of one kernel: their LAUNCHES
# key and that kernel's name in the profile
PROFILED_KEYS = {"append": "omp_append", **{
    kn: kn for kn in ("gomp_append", "fr_append", "mp_update", "engine_init",
                      "ompr_swap", "srr_append", "engine_delete", "sp_round",
                      "rmp_append", "engine_backward", "bw_select",
                      "bw_downdate")}}
PROFILE_TRIES = 4


def union_ms(spans):
    """The length of the union of the (start, end) spans: time in which at
    least one of them ran, so that two overlapping launches count once."""
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total


def profile_path(fn, reps=1, totals=False):
    """`reps` calls of fn under torch.profiler after a warm-up: (device busy
    ms, {name: (launches, device ms)}), "other" for the device work not in
    KERNEL_NAMES (torch's kernels, copies, sets). Both come from the
    profile's device events: the busy time is the union of their spans, so
    that work that overlaps is counted once, and a kernel's ms the sum of
    its spans. With `totals`, (busy, totals, per) with totals = {"union":
    busy, "sum": the spans' sum, "key_averages": the sum of
    self_device_time_total over prof.key_averages()}: on one stream the
    union and the sum agree; the key_averages sum counts a torch
    operation's kernels twice, under the operation and under the kernel.
    The profiler can lose kernel records: a profile whose count of a
    PROFILED_KEYS kernel differs from the wrapper's LAUNCHES count over the
    same calls is taken again, up to PROFILE_TRIES times, and then
    fails. Without `totals` the profile records device activity only and
    its raw records are read (no host events, no event tree: a sharded
    solve's host operations made that the most of the profile's cost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cstpu_torch.ops.fused_solve import LAUNCHES

    activities = [ProfilerActivity.CUDA]
    if totals:
        activities.insert(0, ProfilerActivity.CPU)
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        before = dict(LAUNCHES)
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launched = {PROFILED_KEYS[key]: v - before.get(key, 0)
                    for key, v in LAUNCHES.items()
                    if key in PROFILED_KEYS and v > before.get(key, 0)}
        per, spans = {}, []
        if totals:
            records = [(ev.device_type, ev.name, ev.time_range.start * 1000,
                        ev.time_range.end * 1000,
                        getattr(ev, "is_user_annotation", False))
                       for ev in prof.events()]
        else:
            records = [(ev.device_type(), ev.name(), ev.start_ns(),
                        ev.start_ns() + ev.duration_ns(),
                        getattr(ev, "is_user_annotation", lambda: False)())
                       for ev in prof.profiler.kineto_results.events()]
        for dtype, ev_name, t0, t1, annotation in records:
            if dtype != DeviceType.CUDA or annotation:
                continue
            spans.append((t0, t1))
            name = next((kn for kn in KERNEL_NAMES
                         if kn + "_kernel" in ev_name), "other")
            cnt, ms = per.get(name, (0, 0.0))
            per[name] = (cnt + (name != "other"), ms + (t1 - t0) / 1e6)
        busy = union_ms(spans) / 1e6
        lost = {name: (per.get(name, (0, 0.0))[0], c)
                for name, c in launched.items()
                if per.get(name, (0, 0.0))[0] != c}
        if not lost:
            if not totals:
                return busy, per
            keyavg = sum(max(getattr(ev, "self_device_time_total", 0.0), 0.0)
                         for ev in prof.key_averages()) / 1e3
            return busy, {"union": busy, "sum": sum(ms for _, ms in
                                                    per.values()),
                          "key_averages": keyavg}, per
        print(f"[profile] try {attempt}: the profile's launches differ from "
              f"the wrappers' counts (profiled, launched): {lost}")
    raise AssertionError(f"the profiler lost kernel records in "
                         f"{PROFILE_TRIES} tries: {lost}")


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
    Ac = A.to(bf).contiguous()
    # the masked select per call (events): tensor cores, then CUDA cores
    pl["select_masked_call"] = launches(
        lambda: fs.select_argmax(st.r, Ac, amask=st.amask))
    pl["select_masked_simt"] = launches(
        lambda: fs.select_argmax(st.r, Ac, amask=st.amask, mma=False))
    del Ac
    pl["ompr_swap"] = launches(
        lambda: ft._ompr_swap_ref(*sparts, Ac32, Bg, _clone(st), 1.0, 0.0))
    k = SRR_CELL[1]
    st = ft._init_engine(Br, k + 1, m, cn2, npend=k)
    ft._engine_init_ref(*fs._topl_ref(Br, Arc32, bf, k), Arc32, Br, st)
    Arc = Ar.to(bf).contiguous()
    for P, key in ((k, "fr_select_init"), (2, "fr_select_pending2")):
        pl[key] = launches(lambda: fs._rescaled_select_ref(
            Arc32, cn2, st.r, st.pend_u[:P], st.pend_w[:P], 1.0, st.amask,
            st.resc.clone(), bf))
        # the kernel's variants per call on the same inputs, the tensor-core
        # one's device time, and one f32 torch.matmul of the select's
        # products [r; U] . A
        resc = st.resc.clone()
        call = partial(fs.rescaled_select, Arc, cn2, st.r, st.pend_u[:P],
                       st.pend_w[:P], 1.0, st.amask, resc)
        pl[key + "_call"] = launches(call)
        pl[key + "_device"] = device_ms_per_call(call)
        pl[key + "_simt"] = launches(lambda: call(mma=False))
        ru = torch.cat([st.r[None], st.pend_u[:P]]).flatten(0, 1)
        rub = ru.to(bf)
        ru = rub.float()
        pl[key + "_gemm"] = launches(lambda: torch.matmul(ru, Arc32))
        pl[key + "_gemm_bf16"] = launches(lambda: torch.matmul(rub, Arc))
    del Arc
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
    # a tensor-core select is its sweep and a rounding launch; the paths'
    # top-l and top-1 or rescaled selects share the rounding's name, so it
    # counts at its mean per launch
    kern = {"sp_round": per_launch("2b", "sp_round"),
            "select_topl32": per_launch("2b", "topl_mma")
            + per_launch("2b", "round_rows"),
            "select_topl32_2c": per_launch("2c", "topl_mma")
            + per_launch("2c", "round_rows"),
            "select_topl16_3b": per_launch("3b", "topl_mma")
            + per_launch("3b", "round_rows"),
            "engine_init": per_launch("2c", "engine_init"),
            "select_masked": per_launch("2c", "top1_mma")
            + per_launch("2c", "round_rows"),
            "ompr_swap": per_launch("2c", "ompr_swap"),
            "fr_select_3b": per_launch("3b", "rescaled_mma")
            + per_launch("3b", "round_rows"),
            "srr_append": per_launch("3b", "srr_append"),
            "engine_delete": per_launch("3b", "engine_delete")}
    print("[time two-stage] " + ", ".join(
        f"{cell} {tm[cell]:.4f} ms (plain {tm['plain_' + cell]:.4f})"
        for cell in ("2b", "2c", "3b")) + " | " + gpu)
    print("[time two-stage kernels, device ms per launch on the paths] "
          + ", ".join(f"{key} {v:.4f}" for key, v in kern.items())
          + " | plain (and the masked select's own) ms per call (events): "
          + ", ".join(f"{key} {ms4(v)}" for key, v in pl.items()))
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
    err = {"rmp_append": 0.0, "rmp_append_foba": 0.0, "engine_backward": 0.0,
           "fr_select_simt": 0.0}

    def select_both(stk, st, npend):
        # the CUDA-core variant on a copy, then the one the path takes
        simt = _clone(stk)
        sparts = fs.rescaled_select(Ac, cn2, simt.r, simt.pend_u[:npend],
                                    simt.pend_w[:npend], 1.0, simt.amask,
                                    simt.resc, mma=False)
        kv, ki = fs.rescaled_select(Ac, cn2, stk.r, stk.pend_u[:npend],
                                    stk.pend_w[:npend], 1.0, stk.amask,
                                    stk.resc)
        pv, pi = fs._rescaled_select_ref(Ac32, cn2, st.r, st.pend_u[:npend],
                                         st.pend_w[:npend], 1.0, st.amask,
                                         st.resc, bf)
        torch.cuda.synchronize()
        held = _hold_rescaled(sparts, (pv, pi), simt.resc, st.resc, rows,
                              Ac32, cn2, st.r, st.amask, False)
        err["fr_select_simt"] = max(err["fr_select_simt"], held[0])
        resc_err = _hold_rescaled((kv, ki), (pv, pi), stk.resc, st.resc,
                                  rows, Ac32, cn2, st.r, st.amask, True)[0]
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
          f"fr_select resc max |err| {resc_err:.3e}, CUDA-core variant "
          f"{err['fr_select_simt']:.3e}) and 3 launches of a "
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
    del st, stk
    for B, m_ in BW_CLUSTER_CASES:
        st, fbr_tie, lace_tie = bw_cluster_state(A2.device, B, m_)
        steps = hold_bw_select(st, fbr_tie, lace_tie)
        print(f"[3e kernels] bw_select cluster case B={B} m={m_} (clusters of "
              f"{min(8, -(-m_ // 128))}): {BW_LACE_FROM} FBR and "
              f"{BW_STEPS - BW_LACE_FROM} LACE steps bit for bit, row 0 "
              f"deleted {steps}; ties {fbr_tie} and {lace_tie} across slice "
              f"boundaries went to the lower atom; rejected row, NaN init and "
              f"NaN in the last slice stopped at step 0")
        del st
        torch.cuda.empty_cache()
    return err


# bw_select's cluster cases (B, m): clusters of 1 block (m = 4, 124) and of
# 8 (m = 1024, 1028, 4096); one atom a thread held in registers up to
# m = 1024, slices walked and read again beyond: a ragged last slice at
# m = 1028 (8 slices of 129, the last 125 atoms), 512 atoms a slice at 4096
BW_CLUSTER_CASES = [(1, 4), (8, 124), (65, 124), (8, 1024), (64, 1024),
                    (65, 1028), (1, 1028), (8, 4096)]
BW_STEPS, BW_LACE_FROM = 50, 40   # 40 FBR steps, then 10 LACE steps
# device ms per launch and per solve of the kernels redesigned for their
# latency (bw_select, sp_round, and the merge in engine_init and
# gomp_append) before the redesign, on the paths chip_smoke.py drives
# (PERF.md's kernel table and section 5, NVIDIA H100 80GB HBM3, 700.00 W)
BEFORE_MS = {"bw_select 3e fbr B=8": (0.0080, 7.9159),
             "bw_select 3e fbr B=64": (0.0129, 12.7777),
             "bw_select 3e lace B=8": (0.0084, 8.2834),
             "sp_round 2b": (0.5100, 1.5299),
             "engine_init 2c": (1.0237, 1.0237),
             "gomp_append 2a": (0.0440, 0.3520)}


def bw_slice_bounds(m):
    """The first atoms of slices 1.. of bw_select's cluster: C = min(8,
    ceil(m / 128)) blocks of ceil(m / C) atoms (csrc/bw_select.cu)."""
    C = min(8, -(-m // 128))
    return list(range(-(-m // C), m, -(-m // C)))


def bw_cluster_state(dev, B, m):
    """The backward state of B rows on a unit-norm Gaussian (2m, m)
    dictionary (3 planted ones, 1 at m = 4, noise 1e-3), then: row 0 has
    two atoms of score 0 on both sides of the first slice boundary (the
    middle atom when there is one slice), row 1 is rejected at its first
    step (||r||^2 above max_eps2 = 0.5), row 2 has a NaN init, row 3 a NaN
    coefficient in the last slice only. Returns the state and the pairs of
    atoms (FBR's tie, LACE's tie at the last boundary)."""
    from cstpu_torch.ops import fused_backward as fb

    gen = torch.Generator(device=dev).manual_seed(1000 * B + m)
    A = torch.randn((2 * m, m), device=dev, generator=gen)
    A = A / A.norm(dim=0, keepdim=True)
    k = min(3, m - 3)
    sup = torch.stack([torch.randperm(m, generator=gen, device=dev)[:k]
                       for _ in range(B)])
    Bs = A[:, sup].sum(-1).T.contiguous()
    Bs += 1e-3 * torch.randn(Bs.shape, device=dev, generator=gen)
    st = fb._bw_init(A, Bs)
    bounds = bw_slice_bounds(m) or [m // 2]
    fbr_tie, lace_tie = (bounds[0] - 1, bounds[0]), (bounds[-1] - 1,
                                                      bounds[-1])
    st.coef[0, list(fbr_tie)] = 0.0
    st.diag[0, fbr_tie[1]] = st.diag[0, fbr_tie[0]]
    if B > 1:
        st.nr2[1] = 1.0
    if B > 2:
        st.G[2] = float("nan")
        st.coef[2] = float("nan")
        st.diag[2] = float("nan")
    if B > 3:
        st.coef[3, m - 1] = float("nan")
    return st, fbr_tie, lace_tie


def hold_bw_select(st, fbr_tie, lace_tie):
    """BW_STEPS deletion steps (FBR, then LACE from BW_LACE_FROM, where row
    0 gets a second tie: 0 and -0 on both sides of the last boundary) of
    bw_select and bw_downdate against their plain versions from identical
    state; every field equal bit for bit at every step (NaN where the plain
    version has NaN). The lower atom of each tie is deleted first; rows 1-3
    stop at step 0 (row 1 rejected, rows 2-3 failed). Returns the number of
    steps row 0 took."""
    from cstpu_torch.ops import fused_backward as fb

    B, m = st.coef.shape
    inf = float("inf")
    for t in range(BW_STEPS):
        select_abs = t >= BW_LACE_FROM
        if t == BW_LACE_FROM:
            st.coef[0, lace_tie[0]] = 0.0
            st.coef[0, lace_tie[1]] = -0.0
        tie = fbr_tie if t == 0 else lace_tie
        watch = (t in (0, BW_LACE_FROM) and bool(st.run[0] > 0.5)
                 and bool((st.alive[0, list(tie)] > 0.5).all()))
        stk = _clone(st)
        fb.bw_select(stk, 0.5, inf, select_abs)
        fb._bw_select_ref(st, 0.5, inf, select_abs)
        torch.cuda.synchronize()
        for name, a, b in zip(st._fields, stk, st):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                       msg=lambda msg: f"{t} {name}: {msg}")
        fb.bw_downdate(stk)
        fb._bw_downdate_ref(st)
        torch.cuda.synchronize()
        torch.testing.assert_close(stk.G, st.G, rtol=0, atol=0,
                                   equal_nan=True)
        if watch:
            assert float(st.alive[0, tie[0]]) == 0.0, (t, tie)
            assert float(st.alive[0, tie[1]]) == 1.0, (t, tie)
        if t == 0:
            want = [1.0, 0.0, 0.0, 0.0][:B]
            assert st.run[:4].tolist() == want, st.run[:4]
            assert st.failed[:4].tolist() == [0.0, 0.0, 1.0, 1.0][:B]
    return m - int(st.alive[0].sum())


# sp_round's cases (B, n, m, k): k from 1 to 32, n a multiple of the Gram's
# panel chunk (32) and not, m with a ragged last tile (8264 = 64.5 tiles)
SP_ROUND_CASES = [(64, 1024, 8192, 32), (65, 1000, 8264, 31),
                  (1, 1024, 8264, 32), (64, 1000, 8192, 8),
                  (65, 1024, 8264, 1), (1, 1000, 8192, 31)]
SP_ROUNDS = 4


def sp_empty_state(Bs, k, m):
    """The empty SP state of k slots (2k slot columns) for rows Bs."""
    from cstpu_torch.ops import fused_twostage as ft

    B, n = Bs.shape
    dev = Bs.device
    return ft._SpState(
        cols=torch.zeros((B, 2 * k, n), device=dev),
        Ginv=torch.eye(k, device=dev).repeat(B, 1, 1),
        coef=torch.zeros((B, 2 * k), device=dev),
        idx=torch.full((B, 2 * k), m, dtype=torch.int32, device=dev),
        Atb=torch.zeros((B, 2 * k), device=dev), r=Bs.clone(),
        done=torch.zeros((B,), device=dev), prev=torch.zeros((B,), device=dev))


def hold_sp_round(dev, B, n, m, k):
    """SP_ROUNDS rounds of sp_round against its plain version from
    identical state on a planted problem (min(k, 8) +-1 atoms, noise of
    norm ~0.02 sqrt(n), bf16 dictionary), the init round first: row 3 is a
    NaN row (it latches empty), row 4's partials hold a NaN every round (no
    pick is made: it stays empty), row 5 is done from round 2 (left exactly as
    it was). idx equal, the rest within APPEND_ATOL every round. Returns
    the max |err|."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import fused_twostage as ft

    gen = torch.Generator(device=dev).manual_seed(B + n + m + k)
    A, Bs, _ = planted(gen, B, n, m, min(k, 8))
    Bs += 0.02 * torch.randn(Bs.shape, device=dev, generator=gen)
    if B > 3:
        Bs[3, 0] = float("nan")
    bf = torch.bfloat16
    Ac = A.to(bf).contiguous()
    Ac32 = Ac.float()
    st = sp_empty_state(Bs, k, m)
    rows = torch.arange(B, device=dev) != 3
    err = 0.0
    for t in range(SP_ROUNDS):
        if t == 2 and B > 5:
            st.done[5] = 1.0
        pv, pi = fs._topl_ref(st.r, Ac32, bf, k)
        if B > 4:
            pv[4, pv.shape[1] // 2, k // 2] = float("nan")
        stk, prev0 = _clone(st), st.prev.clone()
        row5 = [x[5].clone() for x in st] if t >= 2 and B > 5 else None
        ft.sp_round(pv, pi, Ac, Bs, stk, 0.0, t == 0)
        ft._sp_round_ref(pv, pi, Ac32, Bs, st, 0.0, t == 0)
        torch.cuda.synchronize()
        err = max(err, _state_err(stk, st, rows, None if t == 0 else prev0))
        assert torch.equal(stk.idx, st.idx), t
        if B > 3:
            assert not (stk.idx[3] < m).any()
            assert t == 0 or float(stk.done[3]) == 1.0
        if B > 4:   # no pick, every round: the row stays empty
            assert not (stk.idx[4] < m).any()
        if row5 is not None:
            assert all(torch.equal(a[5], b) for a, b in zip(stk, row5))
    return err


# omp_append's and fr_append's grid (csrc/append_cluster.cuh): B = 1, 8
# (the plan's C = 8) and 64, 65 (C = 2); n a multiple of the slices and not
# (1000: eight slices of 128 entries, the last 104; 1028: of 132, the last
# 104); k from 1 to KMAX; m with a ragged last tile. The plan stages the
# slot columns where they fit (all but k = 128 at C = 2); it streams them
# there and in the last four cases but the first of them: at the edge of
# the staged variant's shared memory (k = 32, C = 2: slices of 1664
# entries fit, of 1668 not), at a larger n at small k, and at k = 128
# with C = 8
APPEND_CASES = [(B, n, k) for B in (1, 8, 64, 65) for n in (1000, 1024, 1028)
                for k in (1, 16, 32, 128)] + [
    (64, 3328, 32), (64, 3336, 32), (65, 8192, 16), (8, 4096, 128)]
APPEND_M = 2000
# the smoke holds the kernel grids below on half of their (B, n) cross
# product: every B and every n once or more, both plan families (C = 8 at
# B <= 8, C = 2 at B >= 64), and every case off the cross product (the
# plans' edges: streamed, rounds, chunks). tests/test_torch_kernels.py holds
# the whole grids on the card.
SMOKE_BN = ((1, 1028), (8, 1000), (8, 1024), (64, 1024), (64, 1028),
            (65, 1000))


def smoke_grid(cases):
    """The cases of a kernel grid that the smoke holds (SMOKE_BN)."""
    return [c for c in cases if tuple(c[:2]) in SMOKE_BN
            or c[0] not in (1, 8, 64, 65) or c[1] not in (1000, 1024, 1028)]


# device ms per launch of the two kernels before the cluster redesign, on
# the paths chip_smoke.py drives (PERF.md section 5, NVIDIA H100 80GB HBM3,
# 700.00 W)
APPEND_BEFORE_MS = {"omp_append bench": 0.0188, "omp_append 5b": 0.0306,
                    "fr_append 3a": 0.0249}


def _nan_err(a, b):
    """max |a - b| where both are numbers; the NaNs must lie alike."""
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b)), "NaNs differ"
    return float((a - b).abs().masked_fill(nan, 0.0).max()) if a.numel() else 0.0


def hold_append(dev, B, n, k, cdt, fr):
    """k steps of omp_append (fr: fr_append) against its plain version, each
    from identical state, on a planted problem (min(k, 8) +-1 atoms a row,
    noise of norm ~0.02 sqrt(n), atom m-1 a copy of m-2). Row 1 is a NaN
    row; at step 1 row 2's pick is its slot-0 atom again (a duplicate) and
    row 3's (b = 4 a_{m-2} + ..., so slot 0 holds m-2) the copy m-1 (the
    rtol gate); FR's row 4 is latched from step 1. idx, done, amask and the
    sorted support equal; cols, Ginv, coef, r, aperp, dinv within
    APPEND_ATOL, NaN where the plain version has NaN. Returns (max |err|,
    the plan the launches took)."""
    from cstpu_torch.ops import fused_solve as fs

    m = APPEND_M
    gen = torch.Generator(device=dev).manual_seed(7 * B + n + 3 * k + fr)
    A, Bs, _ = planted(gen, B, n, m, min(k, 8))
    A[:, m - 1] = A[:, m - 2]
    Bs += 0.02 * torch.randn(Bs.shape, device=dev, generator=gen)
    if B > 1:
        Bs[1, 3] = float("nan")
    if B > 3:
        Bs[3] += 4.0 * A[:, m - 2]
    Ac = A.to(cdt).contiguous()
    Ac32 = Ac.float()
    cn2 = torch.sum(A * A, dim=0)
    if fr:
        st, out = fs._init_fr(Bs, k, cn2), []
    else:
        st, *out = fs._init_state(Bs, k, m)
    err = 0.0
    plan = fs._append_plan(B, n, k)
    for t in range(k):
        if fr and t == 1 and B > 4:
            st.done[4] = 1.0
        if fr:
            pv, pi = fs._fr_select_ref(Ac32, cn2, st, cdt)
        else:
            pv, pi = fs._select_ref(st.r, Ac32, cdt)
        if t == 1:
            for row, atom in ((2, int(st.idx[2, 0]) if B > 2 else 0),
                              (3, m - 1)):
                if row < B:
                    pv[row], pi[row] = 1.0, atom
        stk = type(st)(*(x.clone() for x in st))
        outk = [x.clone() for x in out]
        if fr:
            fs.fr_append(pv, pi, Ac, Bs, stk, t, 0.0, 0.0)
            fs._fr_append_ref(pv, pi, Ac32, Bs, st, t, 0.0, 0.0)
        else:
            fs.omp_append(pv, pi, Ac, Bs, stk, t, *outk)
            fs._append_ref(pv, pi, Ac32, Bs, st, t, *out)
        torch.cuda.synchronize()
        assert torch.equal(stk.idx, st.idx), (t, "idx")
        fields = ["cols", "Ginv", "coef", "r"]
        if fr:
            assert torch.equal(stk.done, st.done), (t, "done")
            assert torch.equal(stk.amask, st.amask), (t, "amask")
            fields += ["aperp", "dinv"]
        for name in fields:
            e = _nan_err(getattr(stk, name), getattr(st, name))
            assert e <= APPEND_ATOL, (t, name, e)
            err = max(err, e)
        if not fr and t == k - 1:
            assert torch.equal(outk[0], out[0]), "sorted support"
            err = max(err, _nan_err(outk[1], out[1]))
            assert err <= APPEND_ATOL, err
    if B > 1:
        assert bool(torch.isnan(st.r[1]).all())
    if k > 1 and B > 3:
        # the duplicate and the degenerate pick were turned away
        assert int(st.idx[3, 0]) == m - 2, st.idx[3]
        assert not bool((st.idx[2:4, 1:] == st.idx[2:4, :1]).any())
        assert not bool((st.idx[3] == m - 1).any())
        if fr:
            assert st.done[2:4].tolist() == [1.0, 1.0], st.done
    if fr and k > 1 and B > 4:
        assert not bool((st.idx[4, 1:] < m).any()), st.idx[4]
    return err, plan


# the slot engine's cluster kernels (rmp_append, engine_init): the grid of
# (B, n, K), each K with cnt in {1, K} where K <= LMAX, and at the plan's
# edges: engine_init's picked columns staged up to n = 2520 at K = cnt = 32,
# C = 2 and streamed from 2524; rmp_append's slot columns streamed at
# K = 128 with C = 2 (in the grid) and with C = 8 (n = 4096)
ENGINE_CASES = [(B, n, K) for B in (1, 8, 64, 65) for n in (1000, 1024, 1028)
                for K in (16, 32, 128)] + [
    (64, 2520, 32), (64, 2524, 32), (8, 4096, 128)]
ENGINE_M = 2000
ENGINE_MODES = ("delta", "k", "foba")
# device ms per launch of the two kernels before the cluster redesign, on
# the paths chip_smoke.py drives (PERF.md section 5, NVIDIA H100 80GB HBM3,
# 700.00 W)
ENGINE_BEFORE_MS = {"rmp_append 3d rmp B=8": 0.0201,
                    "rmp_append 3d rmp B=64": 0.0232,
                    "rmp_append 3d foba B=8": 0.0221,
                    "rmp_append 3d foba B=64": 0.0248,
                    "engine_init 2c": 0.2198, "engine_init 3b": 0.1016}


def engine_cnts(K):
    """The init's pick counts held at K slots: 1, and K where K <= LMAX."""
    from cstpu_torch.ops import fused_solve as fs

    return (1, K) if K <= fs.LMAX else (1,)


def _engine_problem(dev, B, n, K, seed):
    """A unit-norm Gaussian dictionary (m = ENGINE_M, atom m-1 a copy of
    m-2) and B noisy measurements of min(4, K) +-1 atoms; row 1 a NaN row,
    row 3 with 4 a_{m-2} added (its twin m-1 meets the rtol gate)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = ENGINE_M
    A, Bs, _ = planted(gen, B, n, m, min(4, K))
    A[:, m - 1] = A[:, m - 2]
    Bs += 0.02 * torch.randn(Bs.shape, device=dev, generator=gen)
    if B > 1:
        Bs[1, 3] = float("nan")
    if B > 3:
        Bs[3] += 4.0 * A[:, m - 2]
    return A, Bs, gen


def _engine_err(stk, st, fields, exact):
    """Max |err| of the float fields, the exact ones equal; NaNs alike."""
    err = 0.0
    for name in exact:
        a, b = getattr(stk, name), getattr(st, name)
        assert torch.equal(a.nan_to_num(), b.nan_to_num()), name
    for name in fields:
        e = _nan_err(getattr(stk, name), getattr(st, name))
        assert e <= APPEND_ATOL, (name, e)
        err = max(err, e)
    return err


def hold_engine_init(dev, B, n, K, cnt, cdt, srr):
    """engine_init against its plain version from the empty state (K slots,
    cnt picks; srr: with SRR's pending terms and fgate) on _engine_problem,
    the partials the plain top-cnt select's, with row 2 holding its first
    pick twice (a duplicate) and row 3's picks led by m-2 and its twin m-1
    (the rtol gate) where cnt > 1. idx, amask, done and fgate equal; cols,
    Ginv, coef, Atb, r, prev and the pending terms within APPEND_ATOL, NaN
    where the plain version has NaN. Returns (max |err|, the plan)."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import fused_twostage as ft

    A, Bs, _ = _engine_problem(dev, B, n, K, 11 * B + n + 5 * K + 3 * cnt + srr)
    m = ENGINE_M
    Ac = A.to(cdt).contiguous()
    Ac32 = Ac.float()
    pv, pi = fs._topl_ref(Bs, Ac32, cdt, cnt)
    dup = None
    if B > 2 and pv.shape[1] > 1:
        # row 2's best candidate a second time, in a tile that does not
        # hold it
        v, j = fs._merge_topl_vals(pv[2:3], pi[2:3], 1)
        dup = int(j[0, 0])
        tile = 1 if dup // fs.TILE == 0 else 0
        pv[2, tile, 0], pi[2, tile, 0] = v[0, 0], j[0, 0]
    cn2 = torch.sum(A * A, dim=0) if srr else None
    st = ft._init_engine(Bs, K, m, cn2, npend=cnt)
    stk = _clone(st)
    plan = ft._engine_plan(B, n, K, cnt)
    ft.engine_init(pv, pi, Ac, Bs, stk)
    ft._engine_init_ref(pv, pi, Ac32, Bs, st)
    torch.cuda.synchronize()
    fields = ["cols", "Ginv", "coef", "Atb", "r", "prev"]
    exact = ["idx", "amask", "done"]
    if srr:
        fields += ["pend_u", "pend_w"]
        exact += ["fgate"]
    err = _engine_err(stk, st, fields, exact)
    if B > 1:
        assert not bool((st.idx[1] < m).any()) and bool(torch.isnan(st.r[1]).all())
    if cnt > 1 and dup is not None:   # the second copy was refused
        assert int((st.idx[2] == dup).sum()) == 1, st.idx[2]
        assert int((st.idx[2] < m).sum()) <= cnt - 1, st.idx[2]
    if cnt > 1 and B > 3:
        assert int(st.idx[3, 0]) == m - 2 and not bool((st.idx[3] == m - 1).any())
    return err, plan


def _full_row(st, row, Ac32, Bs, atoms):
    """Row `row` of the engine state set to a full support `atoms` (K of
    them): its columns, the inverse of their Gram (f64, then f32), Atb,
    coef = Ginv Atb, idx, amask and r = b - cols' coef."""
    K = st.idx.shape[1]
    cols = Ac32[:, atoms].T.contiguous()
    G = (cols.double() @ cols.double().T)
    Ginv = torch.linalg.inv(G).float()
    st.cols[row] = cols
    st.Ginv[row] = Ginv
    st.Atb[row] = cols @ Bs[row]
    st.coef[row] = Ginv @ st.Atb[row]
    st.idx[row] = atoms.int()
    st.amask[row, atoms] = 1
    st.r[row] = Bs[row] - st.coef[row] @ cols
    assert K == len(atoms)


def hold_rmp_append(dev, B, n, K, cdt, mode):
    """rmp_append against its plain version at every launch, each from
    identical state (the plain one's), on _engine_problem with K slots;
    mode "delta": RMP's forward stage to rejection; "k": that stage, the
    plain backward stage down to 2 atoms (free slots below occupied ones),
    and a second forward stage; "foba": FoBa iterations, the select scores
    multiplied by 100 at iterations 2 and 3 so that the gain / 4 rule
    deletes. Row 1 is a NaN row; at step 1 row 2's pick is its slot-0 atom
    again (a duplicate) and row 3's the twin m-1 (the rtol gate); row 4
    starts full (K atoms) and is capped; row 5 is done. idx, amask, fgate,
    acc, capped, ndel, done equal; cols, Ginv, coef, Atb, r, resc and the
    pending terms (where their weight is not 0) within APPEND_ATOL.
    Returns (max |err|, the plan, deletions seen)."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import fused_twostage as ft

    A, Bs, gen = _engine_problem(dev, B, n, K, 13 * B + n + 7 * K
                                 + ENGINE_MODES.index(mode))
    m = ENGINE_M
    Ac = A.to(cdt).contiguous()
    Ac32 = Ac.float()
    cn2 = torch.sum(Ac32 * Ac32, dim=0)
    floor2 = 64.0 * n * (1.1920929e-07 ** 2) * torch.sum(Bs * Bs, dim=1)
    st = ft._init_engine(Bs, K, m, cn2, npend=K + 1, stepwise=True)
    if B > 4:
        _full_row(st, 4, Ac32, Bs, torch.randperm(m - 2, generator=gen,
                                                  device=dev)[:K])
    if B > 5:
        st.done[5] = 1.0
    delta2, foba = 0.15 ** 2, mode == "foba"
    plan = ft._engine_plan(B, n, K)
    err, ndel, npend, step, stages = 0.0, 0, 1, 0, 0
    while True:
        if not bool(((st.fgate > 0.5) & (st.done < 0.5)).any()):
            if mode != "k" or stages == 1:
                break
            ft._engine_backward_ref(Bs, st, delta2, 2)
            npend = 1 + int(st.ndel.max())
            stages = 1
            continue
        assert step < 2 * K + 8, step
        pv, pi = fs._rescaled_select_ref(Ac32, cn2, st.r, st.pend_u[:npend],
                                         st.pend_w[:npend], 1.0, st.amask,
                                         st.resc, cdt)
        if step == 1:
            for row, atom in ((2, int(st.idx[2, 0]) if B > 2 else 0),
                              (3, m - 1)):
                if row < B:
                    pv[row], pi[row] = 1.0, atom
        if foba and step in (2, 3):
            pv = pv * 100.0
        stk = _clone(st)
        ft.rmp_append(pv, pi, Ac, Bs, stk, delta2, floor2, foba)
        ft._rmp_append_ref(pv, pi, Ac32, Bs, st, delta2, floor2, foba)
        torch.cuda.synchronize()
        err = max(err, _engine_err(
            stk, st, ["cols", "Ginv", "coef", "Atb", "r", "resc"],
            ["idx", "amask", "fgate", "acc", "capped", "ndel", "done"]))
        slots = K + 1 if foba else 1
        e = _nan_err(stk.pend_w[:slots], st.pend_w[:slots])
        live = (st.pend_w[:slots] != 0)[:, :, None].expand(-1, -1, n)
        e = max(e, _nan_err(stk.pend_u[:slots][live], st.pend_u[:slots][live]))
        assert e <= APPEND_ATOL, ("pending", step, e)
        err = max(err, e)
        ndel = max(ndel, int(st.ndel.max()))
        npend = 1 + int(st.ndel.max()) if foba else 1
        step += 1
    if B > 3:
        assert bool(torch.isnan(st.r[1]).all())
        assert int(st.idx[3, 0]) == m - 2 and not bool((st.idx[3] == m - 1).any())
        assert int((st.idx[2] == st.idx[2, 0]).sum()) == 1
    if B > 4:
        assert float(st.capped[4]) == 1.0 and float(st.capped[0]) == 0.0
    if mode == "foba":
        assert ndel >= 2, ndel
    return err, plan, ndel


# gomp_append's and ompr_swap's grid (csrc/gomp_ompr_cluster.cuh): B = 1, 8
# (the plans' C = 8) and 64, 65 (C = 2); n a multiple of the slices and
# not; GOMP's k in {8, 32, 128} with cnt in {1, 4, 32} (cnt <= k), OMPR's
# K in {5, 17, 33}. GOMP's plan stages the old slot columns but at k = 128,
# where it streams them, at B <= 8 with cnt = 32 in rounds of 24 picks; at
# the edges: staged up to n = 2992 at k = 32, cnt = 4, C = 2 and streamed
# from 2996, and the largest n the wrapper admits at k = 8 (58016: the
# picks gathered a chunk of 1024 entries at a time) and at k = 128
# (41216, cnt = 32: rounds of 4 picks, chunks). OMPR's plan stages all
# but n >= 3140 at K = 33, C = 2, and the largest n the wrapper admits at
# K = 33 (56759: C = 8 at B = 1, C = 4 at B = 65)
GOMP_CASES = [(B, n, k, cnt) for B in (1, 8, 64, 65)
              for n in (1000, 1024, 1028)
              for k, cnt in ((8, 1), (8, 4), (32, 1), (32, 4), (32, 32),
                             (128, 1), (128, 4), (128, 32))] + [
    (64, 2992, 32, 4), (64, 2996, 32, 4), (1, 58016, 8, 4),
    (64, 58016, 8, 4), (8, 41216, 128, 32)]
SWAP_CASES = [(B, n, K) for B in (1, 8, 64, 65) for n in (1000, 1024, 1028)
              for K in (5, 17, 33)] + [
    (64, 3136, 33), (64, 3140, 33), (1, 56759, 33), (65, 56759, 33)]
SWAPS = 4
# device ms per launch of the two kernels before the cluster redesign, on
# the paths chip_smoke.py drives (PERF.md section 5, NVIDIA H100 80GB HBM3,
# 700.00 W)
SWAP_BEFORE_MS = {"gomp_append 2a": 0.0293, "ompr_swap 2c": 0.0369}


def _inject(pv, pi, row, atom, value=1e3):
    """Row `row`'s partials made to lead with `atom` at `value`: for top-1
    partials (B, T) every tile; for top-l ones (B, T, l) the head of a tile
    that does not hold the atom."""
    if pv.ndim == 2:
        pv[row], pi[row] = value, atom
        return
    tile = 1 if atom // 128 == 0 and pv.shape[1] > 1 else 0
    pv[row, tile, 0], pi[row, tile, 0] = value, atom


def hold_gomp_append(dev, B, n, k, cnt, cdt):
    """gomp_append against its plain version at every launch, each from
    identical state (the plain one's), as gomp_fused_solve runs them: k //
    cnt iterations of cnt picks, then a remainder iteration (k % cnt picks,
    or cnt // 2 + 1 where cnt divides k) with the latch reset; on
    _engine_problem with k slots, the eps latch at 0.001 n (a row whose
    planted atoms are all in stops; one missing keeps it going). Row 1 is a
    NaN row; row 3's first picks are m-2 and its twin m-1 (the rtol gate),
    and at iteration 1 row 2's partials lead with its slot-0 atom (a
    duplicate) and row 3's with m-1 again; row 4 is latched from iteration
    1 (done). idx, kcnt, done equal; cols, Ginv, coef, r within
    APPEND_ATOL, NaN where the plain version has NaN. Returns (max |err|,
    the plan)."""
    from cstpu_torch.ops import fused_solve as fs

    A, Bs, _ = _engine_problem(dev, B, n, k, 17 * B + n + 3 * k + cnt)
    m = ENGINE_M
    Ac = A.to(cdt).contiguous()
    Ac32 = Ac.float()
    cap, eps2 = min(n, k), 0.001 * n
    st = fs._init_gomp(Bs, k, m)
    plan = fs._gomp_plan(B, n, k, cnt)
    counts = [cnt] * (k // cnt) + [k % cnt or cnt // 2 + 1]
    err = 0.0
    for it, c in enumerate(counts):
        if it == len(counts) - 1:
            st.done.zero_()   # the remainder iteration
        if it == 1 and B > 4:
            st.done[4] = 1.0
        pv, pi = fs._topl_ref(st.r, Ac32, cdt, c)
        if it == 1:
            if B > 2:
                _inject(pv, pi, 2, int(st.idx[2, 0]))
            if B > 3:
                _inject(pv, pi, 3, m - 1)
        stk = _clone(st)
        fs.gomp_append(pv, pi, Ac, Bs, stk, cap, eps2)
        fs._gomp_append_ref(pv, pi, Ac32, Bs, st, cap, eps2)
        torch.cuda.synchronize()
        err = max(err, _engine_err(stk, st, ["cols", "Ginv", "coef", "r"],
                                   ["idx", "kcnt", "done"]))
    if B > 1:
        assert not bool((st.idx[1] < m).any()) and bool(torch.isnan(st.r[1]).all())
    if B > 3:
        assert int(st.idx[3, 0]) == m - 2 and not bool((st.idx[3] == m - 1).any())
        assert int((st.idx[2] == st.idx[2, 0]).sum()) == 1
    return err, plan


def hold_ompr_swap(dev, B, n, K, cdt):
    """ompr_swap against its plain version at every launch, each from
    identical state (the plain one's): the plain init (K - 1 picks), then
    SWAPS swaps from the plain masked select's partials, on _engine_problem
    with K slots. Row 1 is a NaN row; row 4 is done throughout (its state
    must stay as it was, bit for bit); at swap 1 row 2's pick is an atom it
    holds (a duplicate), row 3's the twin m-1 of its m-2 (the rtol gate),
    row 5's partials all -1 (change false), and row 6's pick its passive
    atom nearest to orthogonal to its residual (its |gcoef| the least: the
    appended atom deleted at once), those rows' latches reset. idx and
    amask equal, done where res moved clearly from prev and on rows 2, 3,
    5; cols, Ginv, coef, Atb, r, prev within APPEND_ATOL, NaN where the
    plain version has NaN. Returns (max |err|, the plan)."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import fused_twostage as ft

    A, Bs, _ = _engine_problem(dev, B, n, K, 19 * B + n + 7 * K)
    m = ENGINE_M
    Ac = A.to(cdt).contiguous()
    Ac32 = Ac.float()
    st = ft._init_engine(Bs, K, m)
    ft._engine_init_ref(*fs._topl_ref(Bs, Ac32, cdt, min(K - 1, fs.LMAX)),
                        Ac32, Bs, st)
    if B > 4:
        st.done[4] = 1.0
    plan = ft._ompr_plan(B, n, K)
    err = 0.0
    for step in range(SWAPS):
        pv, pi = fs._select_ref(st.r, Ac32, cdt, False, st.amask, 1.0)
        hand = [row for row in (2, 3, 5, 6) if row < B and step == 1]
        if hand:
            st.done[hand] = 0.0
            if B > 2:
                _inject(pv, pi, 2, int(st.idx[2][st.idx[2] < m][0]), 1.0)
            if B > 3:
                _inject(pv, pi, 3, m - 1, 1.0)
            if B > 5:
                pv[5] = -1.0
            if B > 6:
                sc = torch.where(st.amask[6] > 0, torch.inf,
                                 (st.r[6] @ Ac32).abs())
                _inject(pv, pi, 6, int(sc[:m - 2].argmin()), 1.0)
        stk, prev0, idx0 = _clone(st), st.prev.clone(), st.idx.clone()
        ft.ompr_swap(pv, pi, Ac, Bs, stk, 1.0, 0.0)
        ft._ompr_swap_ref(pv, pi, Ac32, Bs, st, 1.0, 0.0)
        torch.cuda.synchronize()
        err = max(err, _engine_err(
            stk, st, ["cols", "Ginv", "coef", "Atb", "r", "prev"],
            ["idx", "amask"]))
        clear = (st.prev - prev0).abs() > LATCH_RTOL * prev0.abs()
        clear[[row for row in (2, 3, 5) if row < B and step == 1]] = True
        assert torch.equal(stk.done[clear], st.done[clear]), step
        if B > 4:   # the done row as it was, bit for bit
            assert all(torch.equal(x[4].nan_to_num(), y[4].nan_to_num())
                       for x, y in zip(stk, st) if x is not None)
        if hand:
            assert st.done[[row for row in (2, 3, 5) if row < B]].eq(1.0).all()
            if B > 6:   # the appended atom went at once
                assert torch.equal(st.idx[6], idx0[6]), (st.idx[6], idx0[6])
    if B > 1:
        assert bool(torch.isnan(st.r[1]).all()) and float(st.done[1]) == 1.0
    return err, plan


# the CUDA-core selects' grid (csrc/simt_select.cuh under select_argmax.cu,
# fr_select.cu, select_topl.cu and fr_step_select.cu): B in {1, 8, 64, 65}
# by n in {1000, 1024, 1028} by two layouts: m = 2048 at an aligned base
# (an f32 dictionary and the rows by TMA), and a ragged, odd m = 2001 with
# the dictionary and the rows one entry into their storage (an unaligned
# base and an odd pitch: cp.async for both); then an odd n (the rows by
# cp.async beside a TMA dictionary), a narrow dictionary, m = 8192 at B =
# 32 and 65 (4 and 8 warps a block), and m = 36864 and 40960 at B = 3 and
# 8 (fr_step_select's few-row plan for grids past two blocks an SM; the
# smaller grids above take its other one); each in f32 and in bf16 (the
# catch-all's staged words)
SIMT_CASES = [(B, n, m, off) for B in (1, 8, 64, 65)
              for n in (1000, 1024, 1028)
              for m, off in ((2048, 0), (2001, 1))] + [
    (5, 1001, 2048, 0), (3, 130, 384, 0), (32, 1024, 8192, 0),
    (65, 1028, 8192, 1), (3, 1024, 36864, 0), (8, 1024, 40960, 1)]
SIMT_TERMS = (0, 1, 2, 16)   # fr_select's pending terms
SIMT_MODES = ("abs", "signed", "masked")
SIMT_TIE = 5                 # the duplicated column's first index


def _simt_staged(x, off, dtype):
    """A contiguous copy of x in `dtype` whose base lies `off` entries into
    its storage."""
    store = torch.empty(x.numel() + off, dtype=dtype, device=x.device)
    store[off:] = x.flatten().to(dtype)
    return store[off:].view(x.shape)


def _picks_equal(kern, plain, what):
    """Every row's pick (the partials' reduction) equal, NaN partials in
    the same places, finite ones within SELECT_RTOL."""
    from cstpu_torch.ops import fused_solve as fs

    (kv, ki), (pv, pi) = kern[:2], plain[:2]
    i, ir = fs._reduce_partials(kv, ki)[1], fs._reduce_partials(pv, pi)[1]
    assert torch.equal(i, ir), (what, torch.nonzero(i != ir).flatten())
    assert torch.equal(torch.isnan(kv), torch.isnan(pv)), what
    fin = torch.isfinite(pv)
    assert torch.equal(torch.isfinite(kv), fin), what
    err = float(((kv[fin] - pv[fin]).abs()
                 / pv[fin].abs().clamp(min=1e-30)).max()) if fin.any() else 0
    assert err <= SELECT_RTOL, (what, err)
    return i, err


def hold_simt_select(dev, B, n, m, off, cdt):
    """The CUDA-core variants of select_argmax (SIMT_MODES) and fr_select
    (SIMT_TERMS pending terms) against their plain twins on one problem of
    SIMT_CASES: a dictionary with column m - 1 a copy of SIMT_TIE and a
    row of that atom (row 0: the lowest index wins), a NaN row (1: INT_MAX),
    a row whose atoms are all masked (2: -inf and the lowest index in the
    masked select, all 0 and index 0 in fr_select); every row's pick equal
    to the twin's, the values within SELECT_RTOL, fr_select's rescalings
    within RESC_ATOL. Returns (max rel value err, max resc err, the staging
    that ran: (f32 dictionary by TMA, rows by TMA))."""
    from cstpu_torch.ops import fused_solve as fs

    gen = torch.Generator(device=dev).manual_seed(B * 131 + n * 7 + m + off)
    A = torch.randn(n, m, generator=gen, device=dev)
    A = A / torch.linalg.norm(A, dim=0)
    A[:, m - 1] = A[:, SIMT_TIE]
    Ac = _simt_staged(A, off, cdt)
    Ac32 = Ac.float()
    r = torch.randn(B, n, generator=gen, device=dev)
    r[0] = Ac32[:, SIMT_TIE]
    if B > 1:
        r[1, n // 2] = float("nan")
    r = _simt_staged(r, off, torch.float32)
    amask = (torch.rand(B, m, generator=gen, device=dev) < 0.05).to(
        torch.uint8)
    amask[0, SIMT_TIE] = 0
    if B > 2:
        amask[2] = 1
    staging = (cdt == torch.float32 and Ac.data_ptr() % 16 == 0
               and m % 4 == 0, r.data_ptr() % 16 == 0 and n % 4 == 0)
    sel_err = 0.0
    for mode in SIMT_MODES:
        kw = ({"signed": True} if mode == "signed" else
              {"amask": amask, "eta": 0.5} if mode == "masked" else {})
        kern, counts = run_counted(lambda: fs.select_argmax(r, Ac, mma=False,
                                                            **kw))
        assert counts == expect_launches(select=1), counts
        plain = fs._select_ref(r, Ac32, cdt, **kw)
        i, err = _picks_equal(kern, plain, (mode, B, n, m, off, cdt))
        sel_err = max(sel_err, err)
        if mode != "masked":
            assert int(i[0]) == SIMT_TIE, (mode, i[0])
        if B > 1:
            assert int(i[1]) == fs.INT_MAX, (mode, i[1])
        if mode == "masked" and B > 2:
            assert int(i[2]) == 0 and bool(torch.isinf(kern[0][2]).all())
        if mode == "signed":
            same = (kern[1] == plain[1]) & torch.isfinite(plain[0])
            assert bool(((kern[2] - plain[2]).abs()[same]
                         <= SELECT_RTOL * plain[2].abs()[same] + 1e-6).all())
    cn2 = torch.sum(Ac32 * Ac32, dim=0)
    resc_err = 0.0
    for P in SIMT_TERMS:
        U = _simt_staged(0.1 * torch.randn(P, B, n, generator=gen,
                                           device=dev), off, torch.float32)
        W = torch.rand(P, B, generator=gen, device=dev)
        resc = cn2[None].repeat(B, 1) + 0.5
        rk, rp = resc.clone(), resc.clone()
        kern, counts = run_counted(lambda: fs.rescaled_select(
            Ac, cn2, r, U, W, -1.0, amask, rk, mma=False))
        assert counts == expect_launches(fr_select=1), counts
        plain = fs._rescaled_select_ref(Ac32, cn2, r, U, W, -1.0, amask, rp,
                                        cdt)
        i, err = _picks_equal(kern, plain, ("fr", P, B, n, m, off, cdt))
        sel_err = max(sel_err, err)
        assert int(i[0]) == SIMT_TIE, (P, i[0])
        if B > 1:
            assert int(i[1]) == fs.INT_MAX, (P, i[1])
        if B > 2:
            assert int(i[2]) == 0 and float(kern[0][2].max()) == 0.0
        resc_err = max(resc_err, float((rk - rp).abs().max()))
        assert resc_err <= RESC_ATOL, (P, resc_err)
    return sel_err, resc_err, staging


# the top-l select's CUDA-core variant over the grid: each l of SIMT_TOPL_LS
SIMT_TOPL_LS = (1, 4, 32)


def _bits(x):
    """A tensor's bits: floats as int32, so that NaNs compare equal."""
    return x.view(torch.int32) if x.is_floating_point() else x


def hold_simt_topl(dev, B, n, m, off, cdt):
    """select_topl's CUDA-core variant (csrc/select_topl.cu on
    simt_select.cuh) against its plain twin at each l of SIMT_TOPL_LS on
    one problem of SIMT_CASES, built as hold_simt_select builds it (column
    m - 1 a copy of SIMT_TIE and row 0 that atom, row 1 a NaN row): values
    to SELECT_RTOL, the same entries infinite or NaN, indices wherever a
    pick's value stands clear of its neighbours'; each tile's first entry
    the top-1 select's CUDA-core partial bit for bit (the same sums); row 0
    picks SIMT_TIE then m - 1, row 1 l (NaN, INT_MAX) a tile; a tile of 2
    atoms pads with (-inf, INT_MAX). Returns (max rel value err, the staging
    that ran: (f32 dictionary by TMA, rows by TMA))."""
    from cstpu_torch.ops import fused_solve as fs

    gen = torch.Generator(device=dev).manual_seed(B * 131 + n * 7 + m + off)
    A = torch.randn(n, m, generator=gen, device=dev)
    A = A / torch.linalg.norm(A, dim=0)
    A[:, m - 1] = A[:, SIMT_TIE]
    Ac = _simt_staged(A, off, cdt)
    Ac32 = Ac.float()
    r = torch.randn(B, n, generator=gen, device=dev)
    r[0] = Ac32[:, SIMT_TIE]
    if B > 1:
        r[1, n // 2] = float("nan")
    r = _simt_staged(r, off, torch.float32)
    staging = (cdt == torch.float32 and Ac.data_ptr() % 16 == 0
               and m % 4 == 0, r.data_ptr() % 16 == 0 and n % 4 == 0)
    top1 = fs.select_argmax(r, Ac, mma=False)
    err = 0.0
    for l in SIMT_TOPL_LS:
        (kv, ki), counts = run_counted(lambda: fs.select_topl(r, Ac, l,
                                                              mma=False))
        assert counts == expect_launches(select_topl=1), counts
        pv, pi = fs._topl_ref(r, Ac32, cdt, l)
        what = ("topl", l, B, n, m, off, cdt)
        assert kv.shape == pv.shape == (B, -(-m // fs.TILE), l), what
        assert torch.equal(_bits(kv[..., 0]), _bits(top1[0])), what
        assert torch.equal(ki[..., 0], top1[1]), what
        fin = torch.isfinite(pv)
        assert torch.equal(torch.isfinite(kv), fin), what
        assert torch.equal(torch.isnan(kv), torch.isnan(pv)), what
        rel = ((kv[fin] - pv[fin]).abs()
               / pv[fin].abs().clamp(min=1e-30)).max() if fin.any() else 0
        err = max(err, float(rel))
        assert err <= SELECT_RTOL, (what, err)
        # a pick is clear where its value stands apart from its neighbours',
        # the (l + 1)-th candidate's included
        nxt = fs._topl_ref(r, Ac32, cdt, l + 1)[0]
        d = (nxt[..., 1:] - nxt[..., :-1]).abs()
        gap = d[..., :l].clone()
        gap[..., 1:] = torch.minimum(gap[..., 1:], d[..., :l - 1])
        clear = ~fin | (gap.nan_to_num(torch.inf) > GAP_RTOL * pv.abs())
        assert bool(((ki == pi) | ~clear).all()), what
        picks = fs._merge_topl(kv, ki, l)
        assert int(picks[0, 0]) == SIMT_TIE, (what, picks[0])
        if l > 1:
            assert int(picks[0, 1]) == m - 1, (what, picks[0])
        if B > 1:
            assert bool((ki[1] == fs.INT_MAX).all()), what
            assert bool(torch.isnan(kv[1]).all()), what
    if off == 0:
        l = SIMT_TOPL_LS[-1]
        kv, ki = fs.select_topl(r[:1], Ac[:, :2].contiguous(), l, mma=False)
        assert ki[0, 0, 2:].tolist() == [fs.INT_MAX] * (l - 2)
        assert bool(torch.isneginf(kv[0, 0, 2:]).all())
    return err, staging


def hold_simt_fr_step(dev, B, n, m, off, cdt):
    """fr_step_select's CUDA-core sweep (csrc/fr_step_select.cu on
    simt_select.cuh) against its plain twin on one problem of SIMT_CASES,
    its width cut to m8 = a multiple of 128 (the stream tiling), with and
    without V, on a contiguous shard and on a column view of a 4 m8 + off
    wide dictionary (lda = 4 m8 + off), the shard and the rows `off`
    entries into their storage: column m8 - 1 a copy of SIMT_TIE and row 0
    that atom (it picks SIMT_TIE), row 1 a NaN row and row 2 an
    all-degenerate one ((-inf, 0) each), row 3 marks atom 77 (-1 written),
    row 4 restores atom 40 (active elsewhere: -1). Picks on the clear rows
    and values to SELECT_RTOL, the written-back resc to RESC_ATOL with its
    -1 marks and NaNs in the same places. Returns (max abs d2 err, max resc
    err, the stagings that ran)."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import stream_select as ss

    m8 = m // fs.TILE * fs.TILE
    gen = torch.Generator(device=dev).manual_seed(B * 17 + n * 3 + m + off)
    A = torch.randn(n, m8, generator=gen, device=dev)
    A = A / torch.linalg.norm(A, dim=0)
    A[:, m8 - 1] = A[:, SIMT_TIE]
    R = torch.randn(B, n, generator=gen, device=dev)
    R[0] = A[:, SIMT_TIE] + 0.01 * R[0]
    if B > 1:
        R[1, n // 2] = float("nan")
    W = 0.5 * torch.randn(B, n, generator=gen, device=dev) / n ** 0.5
    V = 0.5 * torch.randn(B, n, generator=gen, device=dev) / n ** 0.5
    W[0] = V[0] = 0.0            # the tied row keeps equal rescalings
    W[2:3] = V[2:3] = 0.0        # the all-degenerate row stays at 0
    R, W, V = (_simt_staged(x, off, torch.float32) for x in (R, W, V))
    il = torch.full((B, 2), -1, dtype=torch.int32, device=dev)
    if B > 3:
        il[3, 0] = 77
    if B > 4:
        il[4, 1] = 40
    wide = torch.zeros(n, 4 * m8 + off, device=dev, dtype=cdt)
    wide[:, off + m8:off + 2 * m8] = A.to(cdt)
    shards = {"contiguous": _simt_staged(A, off, cdt),
              "view": wide[:, off + m8:off + 2 * m8]}
    deg = fs._degeneracy_rtol(n)
    errs, rerr, stagings = {}, 0.0, set()
    for (layout, Ac), use_v in itertools.product(shards.items(),
                                                 (False, True)):
        Af = Ac.float()
        cn2 = torch.sum(Af * Af, dim=0)
        resc0 = cn2.repeat(B, 1)
        resc0[:, 40] = -1.0                # an atom already active
        if B > 2:
            resc0[2] = 0.0                 # an all-degenerate row
        rk, rp = resc0.clone(), resc0.clone()
        Vv = V if use_v else None
        (kv, ki, _), counts = run_counted(lambda: ss.fr_step_select(
            Ac, R, W, il, cn2, rk, deg, V=Vv, mma=False))
        assert counts == expect_launches(fr_step_select=1), counts
        pv, pi, _ = ss.fr_step_select_ref(Ac, R, W, il, cn2, rp, deg, V=Vv)
        what = ("fr_step", layout, use_v, B, n, m8, off, cdt)
        q = R.to(cdt).float() @ Af
        d2 = torch.where(rp > deg * cn2, q * q / rp, -torch.inf)
        tm = ss._stream_tile(m8, n, Ac.element_size(), ss.STREAM_TILE_BYTES)
        nan_tile = torch.isnan(d2.view(B, m8 // tm, tm)).any(dim=2)
        live = torch.where(nan_tile[:, :, None], -torch.inf,
                           d2.view(B, m8 // tm, tm)).view(B, m8)
        _hold(str(what), (kv, ki), (pv, pi), _clear_rows(live), errs)
        assert torch.equal(rk == -1.0, rp == -1.0), what
        assert torch.equal(torch.isnan(rk), torch.isnan(rp)), what
        rerr = max(rerr, float((rk - rp).nan_to_num(nan=0.0).abs().max()))
        assert rerr <= RESC_ATOL, (what, rerr)
        assert int(ki[0]) == SIMT_TIE, (what, int(ki[0]))
        if B > 1:
            assert float(kv[1]) == float("-inf") and int(ki[1]) == 0, what
        if B > 2:
            assert float(kv[2]) == float("-inf") and int(ki[2]) == 0, what
        if B > 3:
            assert float(rk[3, 77]) == -1.0, what
        if B > 4:
            assert float(rk[4, 40]) > -1.0, what
        lda = Ac.stride(0)
        stagings.add((cdt == torch.float32 and Ac.data_ptr() % 16 == 0
                      and lda % 4 == 0,
                      R.data_ptr() % 16 == 0 and n % 4 == 0))
    return max(errs.values()), rerr, stagings


def hold_simt_stream(dev, B, n, m, off, cdt):
    """stream_select.cu's CUDA-core top-1 sweep (stream_top1_simt_kernel on
    simt_select.cuh) under K6 (correlate_select_stream), K9
    (correlate_select_masked_stream) and K10 (correlate_argmax, R given as
    (n, B) and read through its strides), forced onto it with mma=False, on
    one problem of SIMT_CASES, its width cut to m8 = a multiple of 128 (the
    stream tiling), on a contiguous shard and on a column view of a 4 m8 +
    off wide dictionary (lda = 4 m8 + off), the shard and the rows `off`
    entries into their storage; column m8 - 1 a copy of SIMT_TIE and row 0
    that atom (a tie: SIMT_TIE wins), row 1 a NaN row, row 2 every atom
    excluded (K9: (-inf, 0)), M otherwise 0 or -inf on 5% of the atoms;
    then again with atom m8 // 3 poisoned (NaN; then excluded nowhere).
    Each tile's partial equals select_argmax's CUDA-core partial of the
    same rows on the shard's contiguous copy bit for bit (K6 and K10 its |s|
    mode, K9 its masked mode with the excluded atoms as amask and eta = 1:
    the same function for M in {0, -inf} where no excluded atom is NaN);
    the finished picks against the plain twins (indices on the clear rows,
    values to SELECT_RTOL, the same entries infinite or NaN), row 1 (-inf,
    0) under K6 and K9 and NaN under K10. Returns (max rel value err, the
    stagings that ran: (f32 dictionary by TMA, rows by TMA) of K6, and
    whether K10's R, stored as columns (B > 1), came by TMA)."""
    from cstpu_torch.ops import corr_argmax as ca
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import stream_select as ss

    m8 = m // fs.TILE * fs.TILE
    gen = torch.Generator(device=dev).manual_seed(B * 23 + n * 5 + m + off)
    A = torch.randn(n, m8, generator=gen, device=dev)
    A = A / torch.linalg.norm(A, dim=0)
    A[:, m8 - 1] = A[:, SIMT_TIE]
    r = torch.randn(B, n, generator=gen, device=dev)
    r[0] = A[:, SIMT_TIE].to(cdt).float()
    if B > 1:
        r[1, n // 2] = float("nan")
    poison = m8 // 3
    M = torch.where(torch.rand(B, m8, generator=gen, device=dev) < 0.05,
                    -torch.inf, 0.0)
    M[0, SIMT_TIE] = M[0, m8 - 1] = 0.0
    if B > 2:
        M[2] = -torch.inf
    R = _simt_staged(r, off, torch.float32)
    RT = _simt_staged(r.T, off, torch.float32)     # (n, B): ldr 1, ldp B
    tm = ss._stream_tile(m8, n, torch.empty((), dtype=cdt).element_size(),
                         ss.STREAM_TILE_BYTES)
    t10 = ca._pick_tile(m8)
    errs, stagings, col_stagings = {}, set(), set()
    for poisoned in (False, True):
        Ap = A.clone()
        if poisoned:
            # the poisoned atom excluded nowhere (row 2 keeps it alone, in a
            # tile the NaN rule skips)
            Ap[:, poison] = float("nan")
            M[:, poison] = 0.0
        amask = torch.isinf(M).to(torch.uint8)
        wide = torch.zeros(n, 4 * m8 + off, device=dev, dtype=cdt)
        wide[:, off + m8:off + 2 * m8] = Ap.to(cdt)
        contiguous = _simt_staged(Ap, off, cdt)
        k1 = fs.select_argmax(R, contiguous, mma=False)
        k1m = fs.select_argmax(R, contiguous, amask=amask, eta=1.0,
                               mma=False)
        sc = ss._abs_scores(contiguous, R)
        for layout, Ac in (("contiguous", contiguous),
                           ("view", wide[:, off + m8:off + 2 * m8])):
            what = (layout, poisoned, B, n, m8, off, cdt)
            got = {}
            for name, count, call, part in (
                    ("K6", "select_stream", lambda: ss._launch_top1(
                        Ac, R, n, 1, B, None, tm // fs.TILE, False,
                        "select_stream", False, partials=True), k1),
                    ("K9", "select_masked_stream", lambda: ss._launch_top1(
                        Ac, R, n, 1, B, M, tm // fs.TILE, False,
                        "select_masked_stream", False, partials=True), k1m),
                    ("K10", "corr_argmax", lambda: ss._launch_top1(
                        Ac, RT, RT.stride(1), RT.stride(0), B, None,
                        t10 // fs.TILE, True, "corr_argmax", False,
                        partials=True), k1)):
                (kv, ki, pv, pi), counts = run_counted(call)
                assert counts == expect_launches(**{count: 1}), counts
                assert torch.equal(_bits(pv), _bits(part[0])), (name, what)
                assert torch.equal(pi, part[1]), (name, what)
                got[name] = (kv, ki)
            # the public entry points on the same inputs: the same picks
            for name, kern in (
                    ("K6", ss.correlate_select_stream(Ac, R, mma=False)),
                    ("K9", ss.correlate_select_masked_stream(Ac, R, M,
                                                             mma=False)),
                    ("K10", ca.correlate_argmax(Ac, RT, mma=False)[::-1])):
                assert all(torch.equal(_bits(a), _bits(b))
                           for a, b in zip(kern, got[name])), (name, what)
            stagings.add((cdt == torch.float32 and Ac.data_ptr() % 16 == 0
                          and Ac.stride(0) % 4 == 0,
                          R.data_ptr() % 16 == 0 and n % 4 == 0))
            if B > 1:
                col_stagings.add(RT.data_ptr() % 16 == 0 and B % 4 == 0)
            nan_tile = torch.isnan(sc.view(B, m8 // tm, tm)).any(dim=2)
            live = torch.where(nan_tile[:, :, None], -torch.inf,
                               sc.view(B, m8 // tm, tm)).view(B, m8)
            _hold(str(("K6",) + what), got["K6"],
                  ss.correlate_select_stream_ref(Ac, R), _clear_rows(live),
                  errs)
            _hold(str(("K9",) + what), got["K9"],
                  ss.correlate_select_masked_stream_ref(Ac, R, M),
                  _clear_rows(live + M), errs)
            first = torch.isnan(sc.view(B, m8 // t10, t10)).any(
                dim=2).int().argmax(dim=1) * t10
            seen = torch.where(
                (torch.arange(m8, device=dev)[None, :] < first[:, None])
                | ~torch.isnan(sc).any(dim=1, keepdim=True), sc, -torch.inf)
            wi, wv = ca.correlate_argmax_ref(Ac, RT)
            _hold(str(("K10",) + what), got["K10"], (wv, wi),
                  _clear_rows(seen), errs)
            (v6, i6), (v9, i9), (v10, i10) = (got[k] for k in ("K6", "K9",
                                                                "K10"))
            if not poisoned:
                assert int(i6[0]) == int(i10[0]) == SIMT_TIE, what
                assert int(i9[0]) == SIMT_TIE, what
            if B > 1:
                for v, i in ((v6, i6), (v9, i9)):
                    assert float(v[1]) == float("-inf") and int(i[1]) == 0
                assert bool(torch.isnan(v10[1])), what
            if B > 2:
                assert float(v9[2]) == float("-inf") and int(i9[2]) == 0
    return max(errs.values()), stagings, col_stagings


# K7's CUDA-core sweep over the grid: each l of SIMT_STREAM_TOPL_LS, the
# last past 128 slots (a block's whole list, the wide finish)
SIMT_STREAM_TOPL_LS = (1, 4, 32, 128, 160)


def hold_simt_stream_topl(dev, B, n, m, off, cdt):
    """stream_select.cu's CUDA-core top-l sweep (stream_topl_simt_kernel on
    simt_select.cuh, K7), forced onto it with mma=False, on one problem of
    SIMT_CASES, its width cut to m8 = a multiple of 128 (the stream tiling),
    on a contiguous shard and on a column view of a 4 m8 + off wide
    dictionary (lda = 4 m8 + off), the shard and the rows `off` entries
    into their storage; column m8 - 1 a copy of SIMT_TIE and row 0 that
    atom, row 1 a NaN row; then again with atom m8 // 3 poisoned (NaN). At
    each l of SIMT_STREAM_TOPL_LS: the sweep's partials for l <= LMAX equal
    select_topl's CUDA-core partials of the same rows on the shard's
    contiguous copy bit for bit, and each tile's first entry select_argmax's
    CUDA-core partial; every list (up to 128 entries) against the plain twin
    (`_topl_ref`: the same entries NaN, values within SELECT_RTOL of the
    tile's best, indices wherever an entry stands clear of its
    neighbours); the finish on those partials equal to its plain twin's bit
    for bit and the public entry point's select to both; the select against
    the plain select (`correlate_select_topl_stream_ref`: sorted values
    within SELECT_RTOL of the row's best, index sets where the l-th best
    stands clear of the next, slot for slot on fully clear rows), row 0
    holding SIMT_TIE (l = 1) or both copies, row 1 all (-inf, 0), no slot
    in the poisoned atom's tile. Returns (max |value err| of the lists and
    the selects, the stagings that ran: (f32 dictionary by TMA, rows by
    TMA))."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import stream_select as ss

    m8 = m // fs.TILE * fs.TILE
    gen = torch.Generator(device=dev).manual_seed(B * 29 + n * 11 + m + off)
    A = torch.randn(n, m8, generator=gen, device=dev)
    A = A / torch.linalg.norm(A, dim=0)
    A[:, m8 - 1] = A[:, SIMT_TIE]
    r = torch.randn(B, n, generator=gen, device=dev)
    r[0] = A[:, SIMT_TIE].to(cdt).float()
    if B > 1:
        r[1, n // 2] = float("nan")
    R = _simt_staged(r, off, torch.float32)
    poison = m8 // 3
    tm = ss._stream_tile(m8, n, torch.empty((), dtype=cdt).element_size(),
                         ss.STREAM_TILE_BYTES)
    bpt, err, stagings = tm // fs.TILE, 0.0, set()
    for poisoned in (False, True):
        Ap = A.clone()
        if poisoned:
            Ap[:, poison] = float("nan")
        wide = torch.zeros(n, 4 * m8 + off, device=dev, dtype=cdt)
        wide[:, off + m8:off + 2 * m8] = Ap.to(cdt)
        contiguous = _simt_staged(Ap, off, cdt)
        top1 = fs.select_argmax(R, contiguous, mma=False)
        k4 = {l: fs.select_topl(R, contiguous, l, mma=False)
              for l in SIMT_STREAM_TOPL_LS if l <= fs.LMAX}
        # the plain lists: each tile whole, sorted; an entry is clear where
        # it stands apart from both neighbours
        full_v, full_i = fs._topl_ref(R, contiguous.float(), cdt, fs.TILE)
        d = torch.nn.functional.pad((full_v[..., 1:] - full_v[..., :-1]).abs(),
                                    (1, 1), value=torch.inf)
        gap = torch.minimum(d[..., :-1], d[..., 1:]).nan_to_num(torch.inf)
        sc = ss._abs_scores(contiguous, R).view(B, m8 // tm, tm)
        live = torch.where(torch.isnan(sc).any(dim=2, keepdim=True),
                           -torch.inf, sc).view(B, m8)
        for layout, Ac in (("contiguous", contiguous),
                           ("view", wide[:, off + m8:off + 2 * m8])):
            for l in SIMT_STREAM_TOPL_LS:
                what = ("K7", layout, poisoned, l, B, n, m8, off, cdt)
                lc = min(l, fs.TILE)
                (kv, ki), counts = run_counted(
                    lambda: ss.stream_topl_sweep(Ac, R, l, mma=False))
                assert counts == expect_launches(select_topl_stream=1), counts
                assert kv.shape == (B, m8 // fs.TILE, lc), what
                assert torch.equal(_bits(kv[..., 0]), _bits(top1[0])), what
                assert torch.equal(ki[..., 0], top1[1]), what
                if l in k4:
                    assert torch.equal(_bits(kv), _bits(k4[l][0])), what
                    assert torch.equal(ki, k4[l][1]), what
                pv, pi = full_v[..., :lc], full_i[..., :lc]
                assert torch.equal(torch.isnan(kv), torch.isnan(pv)), what
                fin = ~torch.isnan(pv)
                e = (kv - pv).abs()[fin]
                scale = full_v[..., :1].expand_as(pv)[fin]
                assert bool((e <= SELECT_RTOL * scale + 1e-7).all()), (
                    what, float(e.max()))
                err = max(err, float(e.max()) if e.numel() else 0.0)
                clear = ~fin | (gap[..., :lc] > GAP_RTOL * full_v[..., :1])
                assert bool(((ki == pi) | ~clear).all()), what
                # the finish on these partials, and the public entry point
                want = ss.stream_topl_finish_ref(kv.clone(), ki.clone(), bpt,
                                                 l)
                got, counts = run_counted(
                    lambda: ss.stream_topl_finish(kv, ki, bpt, l))
                assert counts == expect_launches(stream_topl_finish=1), counts
                assert all(torch.equal(_bits(a), _bits(b))
                           for a, b in zip(got, want)), what
                pub = ss.correlate_select_topl_stream(Ac, R, l, mma=False)
                assert all(torch.equal(_bits(a), _bits(b))
                           for a, b in zip(pub, got)), what
                err = max(err, _hold_topl(
                    what, got, ss.correlate_select_topl_stream_ref(Ac, R, l),
                    live, l)[0])
                gv, gi = got
                if B > 1:
                    assert bool((gv[1] == -torch.inf).all()), what
                    assert bool((gi[1] == 0).all()), what
                if poisoned:
                    lo = poison // tm * tm
                    assert not bool(((gi >= lo) & (gi < lo + tm)
                                     & (gv > -torch.inf)).any()), what
                elif l == 1:
                    assert int(gi[0, 0]) == SIMT_TIE, what
                else:
                    assert {SIMT_TIE, m8 - 1} <= set(gi[0].tolist()), what
            stagings.add((cdt == torch.float32 and Ac.data_ptr() % 16 == 0
                          and Ac.stride(0) % 4 == 0,
                          R.data_ptr() % 16 == 0 and n % 4 == 0))
    return err, stagings


# mp_update's grid (csrc/mp_update.cu: B C blocks, no cluster): B = 1 and 8
# (C = 8), 64 and 65 (C = 3); n a multiple of 4 (16-byte pieces of r) and
# not (1001, 1003: entry by entry); n = 8192 at B = 64 (C = 4: the slices
# capped at what a block's registers hold) and n = 4100 at B = 8 (C = 17)
MP_CASES = [(B, n) for B in (1, 8, 64, 65) for n in (1000, 1024, 1028)] + [
    (65, 1001), (1, 1003), (64, 8192), (8, 4100)]
MP_M = 2000
MP_STEPS = 4
# srr_append's grid (csrc/srr_append.cu on engine_cluster.cuh's SRR mode):
# K slots, l forward steps an iteration (k = max(1, K - l) kept by the
# plain backward stage), rmp_append's plan: staged throughout the grid,
# streamed at K = 33 from n = 3136 with C = 2 and at K = 128 with C = 8
SRR_CASES = [(B, n, K, l) for B in (1, 8, 64, 65) for n in (1000, 1024, 1028)
             for K in (2, 17, 33) for l in (1, 2, 4)] + [
    (64, 4096, 33, 1), (65, 4100, 33, 2), (8, 4096, 128, 2)]
SRR_ITERS = 2
# device ms per launch of the two kernels before the redesign, on the
# paths chip_smoke.py drives (PERF.md section 5, NVIDIA H100 80GB HBM3,
# 700.00 W)
MP_SRR_BEFORE_MS = {"mp_update mp": 0.0038, "srr_append 3b": 0.0236}


def hold_mp_update(dev, B, n, cdt):
    """MP_STEPS chained MP steps on a planted problem (m = MP_M): at each
    step the signed select on the card (bf16: the tensor-core loop and the
    CUDA-core one in turn), then mp_update, against _mp_update_ref on the
    same partials from the same state: x and r equal bit for bit (NaN where the twin has NaN). Row 1 is
    a NaN row (x and r untouched); row 2 is 3 a_100, whose twin a_1500 lies
    in another tile (the tie goes to 100). Returns the plan."""
    from cstpu_torch.ops import fused_solve as fs

    gen = torch.Generator(device=dev).manual_seed(19 * B + n)
    m = MP_M
    A, Bs, _ = planted(gen, B, n, m, 4)
    A[:, 1500] = A[:, 100]
    if B > 1:
        Bs[1, 3] = float("nan")
    if B > 2:
        Bs[2] = 3.0 * A[:, 100]
    Ac = A.to(cdt).contiguous()
    Ac32 = Ac.float()
    x = torch.zeros((B, m), device=dev)
    r = Bs.clone()
    for t in range(MP_STEPS):
        xr, rr = x.clone(), r.clone()
        mma = cdt == torch.bfloat16 and t % 2 == 0
        parts = fs.select_argmax(r, Ac, signed=True, mma=mma)
        fs.mp_update(*parts, Ac, x, r)
        fs._mp_update_ref(*parts, Ac32, xr, rr)
        torch.cuda.synchronize()
        assert torch.equal(x, xr), (B, n, t, float((x - xr).abs().max()))
        assert torch.equal(r.isnan(), rr.isnan()) and torch.equal(
            r.nan_to_num(), rr.nan_to_num()), (B, n, t)
        if t == 0 and B > 2:
            assert int(fs._reduce_partials(*parts[:2])[1][2]) == 100
    if B > 1:
        assert not x[1].any() and torch.equal(r[1].nan_to_num(),
                                              Bs[1].nan_to_num())
    if B > 2:
        assert float(x[2, 1500]) == 0.0 and float(x[2, 100]) != 0.0
    return fs._mp_plan(B, n)


def hold_srr_append(dev, B, n, K, l, cdt):
    """srr_append against its plain version at every launch, each from
    identical state (the plain one's), on _engine_problem with K slots:
    the plain init (k = max(1, K - l) picks), then SRR_ITERS iterations of
    l forward steps on the plain pending-term select and the plain
    backward stage back to k. Row 1 is a NaN row; at the first step row 2's
    pick is its slot-0 atom again (a duplicate) and row 3's the twin m-1 of
    its atom m-2 (the rtol gate); row 4's forward gate is shut and row 5
    is done from the start; row 6 starts full (K atoms). idx, amask,
    fgate, done equal; cols, Ginv, coef, Atb, r, resc and pending slot 0
    within APPEND_ATOL. Returns (max |err|, the plan)."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import fused_twostage as ft

    A, Bs, gen = _engine_problem(dev, B, n, K, 17 * B + n + 3 * K + l)
    m = ENGINE_M
    Ac = A.to(cdt).contiguous()
    Ac32 = Ac.float()
    cn2 = torch.sum(Ac32 * Ac32, dim=0)
    k = max(1, K - l)
    cnt = min(k, fs.LMAX)
    st = ft._init_engine(Bs, K, m, cn2, npend=max(cnt, l + 1))
    ft._engine_init_ref(*fs._topl_ref(Bs, Ac32, cdt, cnt), Ac32, Bs, st)
    if B > 4:
        st.fgate[4] = 0.0
    if B > 5:
        st.done[5] = 1.0
    if B > 6:
        _full_row(st, 6, Ac32, Bs, torch.randperm(m - 2, generator=gen,
                                                  device=dev)[:K])
    plan = ft._engine_plan(B, n, K)
    err, npend, step = 0.0, cnt, 0
    for _ in range(SRR_ITERS):
        for _ in range(l):
            pv, pi = fs._rescaled_select_ref(
                Ac32, cn2, st.r, st.pend_u[:npend], st.pend_w[:npend], 1.0,
                st.amask, st.resc, cdt)
            if step == 0:
                for row, atom in ((2, int(st.idx[2, 0]) if B > 2 else 0),
                                  (3, m - 1)):
                    if row < B:
                        pv[row], pi[row] = 1.0, atom
            pre = _clone(st)
            stk = _clone(st)
            ft.srr_append(pv, pi, Ac, Bs, stk)
            ft._srr_append_ref(pv, pi, Ac32, Bs, st)
            torch.cuda.synchronize()
            err = max(err, _engine_err(
                stk, st, ["cols", "Ginv", "coef", "Atb", "r", "resc"],
                ["idx", "amask", "fgate", "done"]))
            e = max(_nan_err(stk.pend_w[:1], st.pend_w[:1]),
                    _nan_err(stk.pend_u[:1], st.pend_u[:1]))
            assert e <= APPEND_ATOL, ("pending", step, e)
            err = max(err, e)
            if step == 0 and B > 5:
                # the closed rows as they were, their pending slot 0 zero
                for row in (4, 5):
                    assert all(torch.equal(x[row].nan_to_num(),
                                           y[row].nan_to_num())
                               for name, x, y in zip(st._fields, stk, pre)
                               if x is not None and name not in (
                                   "pend_u", "pend_w"))
                    assert not stk.pend_u[0, row].any()
                    assert float(stk.pend_w[0, row]) == 0.0
                if B > 6:   # the full row refused, its gate shut
                    assert float(stk.fgate[6]) == 0.0
            npend = 1
            step += 1
        ft._engine_delete_ref(Bs, st, k, l, 0.0)
        npend = l + 1
    if B > 3:
        assert bool(torch.isnan(st.r[1]).all())
        assert int(st.idx[3, 0]) == m - 2 and not bool((st.idx[3] == m - 1).any())
        assert int((st.idx[2] == st.idx[2, 0]).sum()) == 1
    return err, plan


# engine_delete's and engine_backward's grid (csrc/engine_cluster.cuh's
# deletions on engine_plan(B, n, K, 0), the plan of srr_append and
# rmp_append): B = 1, 8 (C = 8) and 64, 65 (C = 2); n a multiple of the
# slices and not; K slots with l deletions an SRR iteration (k = max(1,
# min(K - l, LMAX)) atoms kept); staged throughout the grid, streamed at
# K = 33 with C = 2 (n = 4096) and at K = 128 with C = 8 (n = 4096).
# engine_backward runs at each (B, n, K) once per rule.
DELETE_CASES = [(B, n, K, l) for B in (1, 8, 64, 65)
                for n in (1000, 1024, 1028) for K in (2, 17, 33)
                for l in (1, 2, 4)] + [(64, 4096, 33, 1), (8, 4096, 128, 2)]
DELETE_RULES = ("delta", "k")
# the timed deleting stage: 3d's 16 atoms a row down to this many
DELETE_KFINAL = 8
# device ms per launch of the two kernels before the cluster redesign, on
# the paths chip_smoke.py drives (PERF.md sections 5 and 6, NVIDIA H100
# 80GB HBM3, 700.00 W)
DELETE_BEFORE_MS = {"engine_delete 3b": 0.0174,
                    "engine_backward 3d rmp B=8": 0.0059,
                    "engine_backward 3d rmp B=64": 0.0060}


def _tie_row(st, row, Bs):
    """Row `row` of the engine state (and of Bs) set to K orthonormal slot
    columns, the unit vectors e_0 .. e_{K-1} (atoms 0 .. K-1): Ginv = I and
    coef = Atb = b[:K], with b[0] = b[1] = 0.5 and b[q] = 1 + q beyond, so
    that slots 0 and 1 tie for the least score (0.25, bit for bit), slot 0
    going first, and every other slot scores 4 or more."""
    K, n = st.cols.shape[1:]
    dev = Bs.device
    Bs[row, :K] = 1.0 + torch.arange(K, dtype=torch.float32, device=dev)
    Bs[row, :2] = 0.5
    st.cols[row] = torch.eye(K, n, device=dev)
    st.Ginv[row] = torch.eye(K, device=dev)
    st.Atb[row] = Bs[row, :K]
    st.coef[row] = Bs[row, :K]
    st.idx[row] = torch.arange(K, dtype=torch.int32, device=dev)
    st.amask[row] = 0
    st.amask[row, :K] = 1
    st.r[row] = Bs[row] - st.coef[row] @ st.cols[row]


def hold_engine_delete(dev, B, n, K, l, cdt):
    """engine_delete against its plain version at every launch, each from
    identical state (the plain one's), on _engine_problem with K slots: the
    plain init (k picks), then SRR_ITERS iterations of l plain forward
    steps and the backward stage (l deletions back to k). Row 1 is a NaN
    row; row 4's forward gate is shut, so its deletions are gated off (zero
    terms); row 5 is done; row 6 starts full (K atoms) and row 7 holds K
    orthonormal columns whose slots 0 and 1 tie (_tie_row). idx and amask
    equal, done and fgate where ||r||^2 moved clearly; cols, Ginv, coef,
    Atb, r, prev and pending slots 1..l within APPEND_ATOL, NaN where the
    plain version has NaN. Returns (max |err|, the plan, the most
    deletions of a row in one launch)."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import fused_twostage as ft

    A, Bs, gen = _engine_problem(dev, B, n, K, 29 * B + n + 7 * K + l)
    m = ENGINE_M
    Ac = A.to(cdt).contiguous()
    Ac32 = Ac.float()
    cn2 = torch.sum(Ac32 * Ac32, dim=0)
    k = max(1, min(K - l, fs.LMAX))
    st = ft._init_engine(Bs, K, m, cn2, npend=max(k, l + 1))
    ft._engine_init_ref(*fs._topl_ref(Bs, Ac32, cdt, k), Ac32, Bs, st)
    if B > 5:
        st.done[5] = 1.0
    if B > 6:
        _full_row(st, 6, Ac32, Bs, torch.randperm(m - 2, generator=gen,
                                                  device=dev)[:K])
    if B > 7:
        _tie_row(st, 7, Bs)
    delta2 = 1e-4
    plan = ft._engine_plan(B, n, K)
    err, most = 0.0, 0
    for it in range(SRR_ITERS):
        if B > 4:
            st.fgate[4] = 0.0
        npend = k if it == 0 else l + 1
        for _ in range(l):
            ft._srr_append_ref(*fs._rescaled_select_ref(
                Ac32, cn2, st.r, st.pend_u[:npend], st.pend_w[:npend], 1.0,
                st.amask, st.resc, cdt), Ac32, Bs, st)
            npend = 1
        pre, prev0 = _clone(st), st.prev.clone()
        stk = _clone(st)
        ft.engine_delete(Bs, stk, k, l, delta2)
        ft._engine_delete_ref(Bs, st, k, l, delta2)
        torch.cuda.synchronize()
        err = max(err, _engine_err(stk, st, ["cols", "Ginv", "coef", "Atb",
                                             "r", "prev"], ["idx", "amask"]))
        clear = (st.prev - prev0).abs() > LATCH_RTOL * prev0.abs()
        for name in ("done", "fgate"):
            assert torch.equal(getattr(stk, name)[clear],
                               getattr(st, name)[clear]), (name, it)
        e = max(_nan_err(stk.pend_w[1:l + 1], st.pend_w[1:l + 1]),
                _nan_err(stk.pend_u[1:l + 1], st.pend_u[1:l + 1]))
        assert e <= APPEND_ATOL, ("pending", it, e)
        err = max(err, e)
        nd = (pre.idx < m).sum(1) - (st.idx < m).sum(1)
        most = max(most, int(nd.max()))
        if B > 5:   # the done row as it was, its pending slots zero
            assert all(torch.equal(x[5].nan_to_num(), y[5].nan_to_num())
                       for name, x, y in zip(st._fields, stk, pre)
                       if x is not None and not name.startswith("pend"))
            assert not stk.pend_u[1:l + 1, 5].any()
            assert not stk.pend_w[1:l + 1, 5].any()
        if B > 4:   # the gated-off deletions' terms are zero
            assert int(nd[4]) == 0 and not stk.pend_w[1:l + 1, 4].any()
            assert not stk.pend_u[1:l + 1, 4].any()
        if it == 0 and B > 6:   # the full row back to k atoms, at most l
            assert int(nd[6]) == min(l, K - k), nd[6]
        if it == 0 and B > 7:   # the tie goes to slot 0, then slot 1
            assert int(stk.idx[7, 0]) == m and float(stk.pend_w[1, 7]) == 1.0
            if l > 1 and K - 1 > k:
                assert int(stk.idx[7, 1]) == m
    if B > 1:   # a NaN row deletes nothing and never latches
        assert bool(torch.isnan(st.r[1]).all()) and float(st.done[1]) == 0.0
    return err, plan, most


def hold_engine_backward(dev, B, n, K, cdt, rule):
    """engine_backward against its plain version from identical state (the
    plain one's after the plain RMP forward stage to rejection at delta
    0.15 on _engine_problem with K slots): rule "delta" deletes while the
    increase < 1 (about half the unit planted atoms), rule "k" down to
    kfinal = 1 atom. Row 3 is 10 (a_5 + a_6), whose two gains are ~100: it
    rejects at once under the delta rule, with a forward step accepted. Row 1
    is a NaN row and row 2 is empty (its forward gate shut from the start):
    both reject at once and latch done; row 5 is done (its pending weights
    set to 0.5, which the stage must zero); row 6 starts full (K atoms) and
    row 7 holds K orthonormal columns whose slots 0 and 1 tie (_tie_row).
    idx, amask, ndel, done, fgate, acc equal; cols, Ginv, coef, Atb, r
    within APPEND_ATOL, the pending weights 1..K everywhere and their
    vectors where the weight is not 0; a row that rejects at once keeps its
    state and r bit for bit. Returns (max |err|, the plan, the most
    deletions of a row)."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import fused_twostage as ft

    A, Bs, gen = _engine_problem(dev, B, n, K, 31 * B + n + 3 * K
                                 + DELETE_RULES.index(rule))
    m = ENGINE_M
    if B > 3:
        Bs[3] = 10.0 * (A[:, 5] + A[:, 6])
    Ac = A.to(cdt).contiguous()
    Ac32 = Ac.float()
    cn2 = torch.sum(Ac32 * Ac32, dim=0)
    floor2 = 64.0 * n * (1.1920929e-07 ** 2) * torch.sum(Bs * Bs, dim=1)
    st = ft._init_engine(Bs, K, m, cn2, npend=K + 1, stepwise=True)
    if B > 2:
        st.fgate[2] = 0.0
    steps = 0
    while bool(((st.fgate > 0.5) & (st.done < 0.5)).any()):
        assert steps < K + 2, steps
        ft._rmp_append_ref(*fs._rescaled_select_ref(
            Ac32, cn2, st.r, st.pend_u[:1], st.pend_w[:1], 1.0, st.amask,
            st.resc, cdt), Ac32, Bs, st, 0.15 ** 2, floor2, False)
        steps += 1
    if B > 5:
        st.done[5] = 1.0
        st.pend_w[:, 5] = 0.5
    if B > 6:
        _full_row(st, 6, Ac32, Bs, torch.randperm(m - 2, generator=gen,
                                                  device=dev)[:K])
        st.acc[6] = 1.0
    if B > 7:
        _tie_row(st, 7, Bs)
        st.acc[7] = 1.0
    delta2, kfinal = (1.0, -1) if rule == "delta" else (0.0, 1)
    plan = ft._engine_plan(B, n, K)
    pre, stk = _clone(st), _clone(st)
    ft.engine_backward(Bs, stk, delta2, kfinal)
    ft._engine_backward_ref(Bs, st, delta2, kfinal)
    torch.cuda.synchronize()
    err = _engine_err(stk, st, ["cols", "Ginv", "coef", "Atb", "r"],
                      ["idx", "amask", "ndel", "done", "fgate", "acc"])
    e = _nan_err(stk.pend_w[1:K + 1], st.pend_w[1:K + 1])
    live = (st.pend_w[1:K + 1] != 0)[:, :, None].expand(-1, -1, n)
    e = max(e, _nan_err(stk.pend_u[1:K + 1][live], st.pend_u[1:K + 1][live]))
    assert e <= APPEND_ATOL, ("pending", e)
    err = max(err, e)
    # the rows that reject at once: latched, their state and r untouched
    for row in (1, 2) + ((3,) if rule == "delta" else ()):
        if row < B:
            assert float(stk.ndel[row]) == 0.0, row
            assert all(torch.equal(getattr(stk, name)[row].nan_to_num(),
                                   getattr(pre, name)[row].nan_to_num())
                       for name in ("cols", "Ginv", "coef", "idx", "Atb",
                                    "r", "amask")), row
    if B > 2:
        assert float(stk.done[1]) == float(stk.done[2]) == 1.0
    if B > 3 and rule == "delta":
        assert float(stk.done[3]) == 0.0 and float(stk.fgate[3]) == 1.0
    if B > 5:
        assert float(stk.ndel[5]) == 0.0 and not stk.pend_w[1:K + 1, 5].any()
        assert all(torch.equal(getattr(stk, name)[5], getattr(pre, name)[5])
                   for name in ("cols", "Ginv", "coef", "idx", "Atb", "r"))
    if B > 7:   # the tie goes to slot 0, then slot 1
        assert int(stk.idx[7, 0]) == m and float(stk.pend_w[1, 7]) == 1.0
        want = 2 if rule == "delta" else K - 1
        assert int(stk.ndel[7]) == want, stk.idx[7]
        assert want < 2 or int(stk.idx[7, 1]) == m, stk.idx[7]
    if rule == "k":   # every row down to at most one atom
        assert bool(((stk.idx < m).sum(1) <= 1)[stk.done < 0.5].all())
    return err, plan, int(st.ndel.max())


def delete_bound(B, K, n, nd, nat, srr=False):
    """engine_delete or engine_backward on a K-slot state, from this run's
    data: every row reads coef, idx and Ginv's diagonal and its latches and
    writes its latches and K pending weights; a row that deletes (nd[b] >
    0; with `srr` every row, which writes r and its latch) also reads
    Ginv, Atb, b and its nat[b] occupied slot columns and writes Ginv,
    coef, idx, Atb, r and, a deletion, a restore term and a cleared column.
    Operations: a deletion v over the live slots (2 nat n), the downdate
    and the refit (5 K^2), and r once (2 nat n); all f32."""
    nbytes, flops = B * 4 * (4 * K + 5), 0
    for d, a in zip(nd, nat):
        if d > 0 or srr:
            nbytes += 4 * (2 * K * K + 4 * K + 2 * n + a * n) + d * 8 * n
            flops += d * (2 * a * n + 5 * K * K) + 2 * a * n
    return bound(nbytes, flops, "f32")


def deleting_state(A, Bs, kmax, delta):
    """3d's state after its forward stage, on the card: rescaled_select and
    rmp_append to rejection from the empty kmax-slot state, as
    rmp_batch(delta=delta, kmax=kmax) runs them."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import fused_twostage as ft

    n, m = A.shape
    Ac = A.to(torch.bfloat16).contiguous()
    cn2 = torch.sum(A * A, dim=0)
    floor2 = 64.0 * n * (1.1920929e-07 ** 2) * torch.sum(Bs * Bs, dim=1)
    st = ft._init_engine(Bs, kmax, m, cn2, npend=kmax + 1, stepwise=True)
    for _ in range(kmax + 1):
        ft.rmp_append(*fs.rescaled_select(Ac, cn2, st.r, st.pend_u[:1],
                                          st.pend_w[:1], 1.0, st.amask,
                                          st.resc),
                      Ac, Bs, st, delta * delta, floor2, False)
        if not bool((st.fgate > 0.5).any()):
            break
    return st


def deleting_times(A, problems):
    """engine_backward's deleting stage, which no timed path runs: from 3d's
    state after its forward stage (deleting_state: its k planted atoms a
    row) at each batch size, the k rule down to DELETE_KFINAL atoms, k -
    DELETE_KFINAL deletions a row. Held once against its plain version
    (idx, ndel equal, the rest within APPEND_ATOL); then TIMED_LAUNCHES
    launches, each on a fresh copy of the state, under torch.profiler.
    Returns {B: {"ms": device ms per launch, "bound": delete_bound's, "ndel":
    deletions a row, "plan": the launch's plan}}."""
    from cstpu_torch.ops import fused_twostage as ft

    _, n, m, k, delta, kmax = STEP_CELL
    out = {}
    for B, Bs in problems.items():
        st = deleting_state(A, Bs, kmax, delta)
        nat = (st.idx < m).sum(1)
        assert bool((nat == k).all()), nat
        stk, ref = _clone(st), _clone(st)
        ft.engine_backward(Bs, stk, 0.0, DELETE_KFINAL)
        ft._engine_backward_ref(Bs, ref, 0.0, DELETE_KFINAL)
        torch.cuda.synchronize()
        _engine_err(stk, ref, ["cols", "Ginv", "coef", "Atb", "r"],
                    ["idx", "amask", "ndel", "done", "fgate"])
        nd = k - DELETE_KFINAL
        assert bool((stk.ndel == nd).all()), stk.ndel
        _, per = profile_path(
            lambda: ft.engine_backward(Bs, _clone(st), 0.0, DELETE_KFINAL),
            TIMED_LAUNCHES)
        cnt, ms = per["engine_backward"]
        assert cnt == TIMED_LAUNCHES, cnt
        out[B] = {"ms": ms / cnt, "ndel": nd,
                  "bound": delete_bound(B, kmax, n, [nd] * B, [k] * B),
                  "plan": ft._engine_plan(B, n, kmax)}
    return out


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
                want = dict(fr_select_mma=steps, rmp_append=steps,
                            engine_backward=passes)
                assert passes == 1 and steps == k + 1, it
            else:
                want = dict(fr_select_mma=it, rmp_append=it)
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
    # the rescaled select at both batch sizes, mid-solve: its tensor-core
    # variant per call and on the device, the CUDA-core one on the same
    # inputs, and one f32 torch.matmul of its products [r; u] . A
    Ac = A.to(bf).contiguous()
    sel = {}
    for B, Bs in problems.items():
        st = ft._init_engine(Bs, kmax, m, cn2, npend=kmax + 1, stepwise=True)
        fl2 = 64.0 * n * (1.1920929e-07 ** 2) * torch.sum(Bs * Bs, dim=1)
        for _ in range(8):
            ft._rmp_append_ref(*fs._rescaled_select_ref(
                Ac32, cn2, st.r, st.pend_u[:1], st.pend_w[:1], 1.0, st.amask,
                st.resc, bf), Ac32, Bs, st, delta * delta, fl2, False)
        call = partial(fs.rescaled_select, Ac, cn2, st.r, st.pend_u[:1],
                       st.pend_w[:1], 1.0, st.amask, st.resc.clone())
        ru = torch.cat([st.r, st.pend_u[0]]).to(bf).float()
        launches = partial(per_launch_ms, Bs)
        sel[f"fr_select_b{B}_call"] = launches(call)
        sel[f"fr_select_b{B}_device"] = device_ms_per_call(call)
        sel[f"fr_select_b{B}_simt"] = launches(lambda: call(mma=False))
        sel[f"fr_select_b{B}_gemm"] = launches(
            lambda: torch.matmul(ru, Ac32))
        rub = ru.to(bf)
        sel[f"fr_select_b{B}_gemm_bf16"] = launches(
            lambda: torch.matmul(rub, Ac))
    print(f"[time 3d fr_select ms per call | {gpu}] "
          + ", ".join(f"{key} {ms4(v)}" for key, v in sel.items()))
    pl.update(sel)
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


# the sharded paths, suite configs 5c and 5m (benchmarks/suite.py:447-511):
# (name, B, n, m, k); the other four sharded solvers run on 5c's dictionary
# with planted ones (2a's construction) on SHARDS shards
SHARD_CELLS = {"5c": (8, 1024, 131072, 32), "5m": (8, 1024, 1 << 20, 32)}
SHARDS = 4
# shapes the stream kernels are held against their plain twins at: a whole
# 5c dictionary as one shard, and one of its four shards
STREAM_WIDTHS = (131072, 32768)
TPU_SELECT = "cstpu/ops/stream_select.py"
TPU_ARGMAX = "cstpu/ops/pallas_kernels.py"


def stream_bound(B, n, m, cdt_bytes=2, l=1, masked=False):
    """A streaming select: the shard (n, m) in cdt and R (B, n) f32 read
    once, with `masked` also M (B, m) f32; l (value, index) pairs per row
    written. 2 B n m operations."""
    nbytes = n * m * cdt_bytes + B * n * 4 + B * l * 8
    if masked:
        nbytes += B * m * 4
    return bound(nbytes, 2 * B * n * m, "bf16" if cdt_bytes == 2 else "f32")


def _clear_rows(scores, depth=1):
    """Rows whose `depth` best scores stand clear of each other and of the
    next by more than GAP_RTOL of the best."""
    top = scores.nan_to_num(nan=-1.0, neginf=-1.0).topk(depth + 1,
                                                        dim=1).values
    return ((top[:, :-1] - top[:, 1:]) > GAP_RTOL * top[:, :1]).all(dim=1)


def _hold(name, kern, plain, clear, errs):
    """A select's (val, idx) against its plain twin's: indices equal on the
    clear rows, finite values to SELECT_RTOL relative, the same entries
    infinite or NaN. Records the largest absolute value error."""
    (kv, ki), (pv, pi) = kern, plain
    assert torch.equal(ki[clear], pi[clear]), f"{name}: idx disagree"
    fin = torch.isfinite(pv)
    assert torch.equal(torch.isfinite(kv), fin), f"{name}: finite pattern"
    assert torch.equal(torch.isnan(kv), torch.isnan(pv)), f"{name}: NaN"
    err = (kv[fin] - pv[fin]).abs()
    assert bool((err <= SELECT_RTOL * pv[fin].abs() + 1e-7).all()), (
        name, float(err.max()))
    errs[name] = max(errs.get(name, 0.0), float(err.max()) if fin.any()
                     else 0.0)


def check_stream_kernels(dev):
    """select_stream, select_masked_stream, select_topl_stream (l=4 and 32)
    and corr_argmax against their plain twins on the card, at the sharded
    paths' shapes (B=8, n=1024, bf16 and f32), with a column repeated
    within and across tiles, a NaN row of R, a row with every atom
    excluded, and then one poisoned atom."""
    from cstpu_torch.ops import corr_argmax as ca
    from cstpu_torch.ops import stream_select as ss

    B, n = SHARD_CELLS["5c"][:2]
    errs = {}
    for m in STREAM_WIDTHS:
        for cdt in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(SEED)
            A = torch.randn((n, m), device=dev, generator=gen)
            A = (A / A.norm(dim=0)).to(cdt)
            R = torch.randn((B, n), device=dev, generator=gen)
            tm = ss._stream_tile(m, n, A.element_size(),
                                 ss.STREAM_TILE_BYTES)
            a0, a1, a2 = 70, min(tm, m // 2) - 3, m - 5    # one column, thrice
            A[:, a1] = A[:, a0]
            A[:, a2] = A[:, a0]
            R[0] = A[:, a0].float()
            R[1, 5] = float("nan")
            M = torch.zeros((B, m), device=dev)
            M[:, a0] = -torch.inf
            M[3] = -torch.inf
            for poisoned in (False, True):
                if poisoned:
                    best = int(ss._abs_scores(A, R[2:3]).argmax())
                    A[:, best] = float("nan")
                sc = ss._abs_scores(A, R)
                # what the tile rule leaves of the scores: tiles that hold
                # a NaN take no part
                nan_tile = torch.isnan(sc.view(B, m // tm, tm)).any(dim=2)
                live = torch.where(nan_tile[:, :, None], -torch.inf,
                                   sc.view(B, m // tm, tm)).view(B, m)
                p6 = ss.correlate_select_stream_ref(A, R)
                p9 = ss.correlate_select_masked_stream_ref(A, R, M)
                # bf16 takes the tensor-core sweep; hold the CUDA-core one
                # on it too (f32 always takes the CUDA-core one)
                bf16 = cdt == torch.bfloat16
                forced = (False, None) if bf16 else (None,)
                for mma in forced:
                    sfx = "_mma" if bf16 and mma is None else ""
                    k6 = ss.correlate_select_stream(A, R, mma=mma)
                    _hold("select_stream" + sfx, k6, p6, _clear_rows(live),
                          errs)
                    k9 = ss.correlate_select_masked_stream(A, R, M, mma=mma)
                    _hold("select_masked_stream" + sfx, k9, p9,
                          _clear_rows(live + M), errs)
                for l, mma in itertools.product((4, 32), forced):
                    sfx = "_mma" if bf16 and mma is None else ""
                    k7 = ss.correlate_select_topl_stream(A, R, l, mma=mma)
                    p7 = ss.correlate_select_topl_stream_ref(A, R, l)
                    _hold("select_topl_stream" + sfx, k7, p7,
                          _clear_rows(live, depth=l), errs)
                    # as sets on every row (the tied one too): the sorted
                    # values agree, and row 0 holds the same atoms
                    ks, ps = k7[0].sort(dim=1).values, p7[0].sort(dim=1).values
                    fin = torch.isfinite(ps)
                    assert bool(((ks - ps)[fin].abs()
                                 <= SELECT_RTOL * ps[fin].abs() + 1e-7).all())
                    assert (sorted(k7[1][0].tolist())
                            == sorted(p7[1][0].tolist()))
                    assert bool((k7[0][1] == -torch.inf).all())
                    assert bool((k7[1][1] == 0).all())
                    # the finish alone on this sweep's partials: the plain
                    # fold of the same values, bit for bit
                    pval, pidx = ss.stream_topl_sweep(A, R, l, mma=mma)
                    want = ss.stream_topl_finish_ref(pval.clone(),
                                                     pidx.clone(),
                                                     tm // 128, l)
                    got = ss.stream_topl_finish(pval, pidx, tm // 128, l)
                    assert torch.equal(got[0], want[0])
                    assert torch.equal(got[1], want[1])
                    errs["stream_topl_finish"] = 0.0
                if bf16:
                    # at l = 1 the tensor-core top-l is the top-1 select
                    v1, i1 = ss.correlate_select_topl_stream(A, R, 1,
                                                             mma=True)
                    w1, j1 = ss.correlate_select_stream(A, R, mma=True)
                    assert torch.equal(v1[:, 0].view(torch.int32),
                                       w1.view(torch.int32))
                    assert torch.equal(i1[:, 0], j1)
                tile10 = ca._pick_tile(m)
                first = torch.isnan(sc.view(B, m // tile10, tile10)).any(
                    dim=2).int().argmax(dim=1) * tile10
                seen = torch.where(
                    (torch.arange(m, device=dev)[None, :] < first[:, None])
                    | ~torch.isnan(sc).any(dim=1, keepdim=True), sc,
                    -torch.inf)
                pi, pv = ca.correlate_argmax_ref(A, R.T)
                for mma in forced:
                    sfx = "_mma" if bf16 and mma is None else ""
                    ki, kv = ca.correlate_argmax(A, R.T, mma=mma)
                    _hold("corr_argmax" + sfx, (kv, ki), (pv, pi),
                          _clear_rows(seen), errs)
                torch.cuda.synchronize()
                # the built cases: the tied row against the plain twin, the
                # NaN row, the row with every atom excluded
                for kern, plain in ((k6, p6), (k9, p9), ((kv, ki), (pv, pi))):
                    assert int(kern[1][0]) == int(plain[1][0])
                assert float(k6[0][1]) == float("-inf") and int(k6[1][1]) == 0
                assert float(k9[0][3]) == float("-inf") and int(k9[1][3]) == 0
                assert bool(torch.isnan(kv[1]))
                if poisoned:
                    lo = best // tm * tm
                    for val, got in (k6, k9, k7):  # no pick from its tile
                        assert not bool(((got >= lo) & (got < lo + tm)
                                         & (val > -torch.inf)).any())
                    assert bool(torch.isnan(kv).all())
                else:
                    assert int(k6[1][0]) == a0 and int(k9[1][0]) == a1
                    assert {a0, a1, a2} <= set(k7[1][0].tolist())
                    assert int(ki[0]) == a0 and not bool(torch.isnan(kv[0]))
            del A, R, M, sc, live, seen
            torch.cuda.empty_cache()
    print("[stream kernels] K6, K9, K7 (l=4, 32; its finish alone bit for "
          "bit; at l=1 == K6's tensor-core sweep), K10 == plain twins at "
          f"m_local in {STREAM_WIDTHS}, bf16 (tensor-core and CUDA-core "
          "sweeps) and f32: ties -> lowest index "
          "within and across tiles, NaN row -> (-inf, 0) / NaN (K10), "
          "all-excluded row -> (-inf, 0), poisoned atom -> its tile skipped "
          "/ NaN visible (K10); max |val err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (rtol {SELECT_RTOL})")
    return errs


# the top-1 selects at awkward shapes (B, n, m): batches off the row-chunk
# widths of the tensor-core loop, an n that is no multiple of its k-step or
# its stage, a ragged m; the last three can stream (m a multiple of 128)
MMA_SHAPES = ((1, 64, 128), (9, 1000, 8232), (65, 1024, 8192),
              (200, 256, 1024), (8, 1000, 8192))


def _tile_clear(scores):
    """Per row and tile of 128 atoms, True where the tile's best score
    stands clear of its second by more than GAP_RTOL of it."""
    B, m = scores.shape
    T = -(-m // 128)
    s = torch.nn.functional.pad(scores.nan_to_num(nan=-1.0, neginf=-1.0),
                                (0, T * 128 - m), value=-1.0).view(B, T, 128)
    top = s.topk(2, dim=2).values
    return (top[..., 0] - top[..., 1]) > GAP_RTOL * top[..., 0]


def check_mma_selects(dev):
    """Both hand-written variants of every top-1 select against the plain
    twins at MMA_SHAPES, bf16: the per-tile partials of select_argmax
    (plain, signed, masked with an all-masked row), and where the shape
    streams K6, K9 (+M), K10 (R as (n, B), read through its strides) and a
    column slice of a wider dictionary (row pitch > m) read in place; with a
    column repeated within and across tiles, a NaN row and then a poisoned
    atom. Forcing the tensor-core loop on a misaligned or f32 dictionary
    must fail, and the predicate must send those to the CUDA cores."""
    from cstpu_torch.ops import corr_argmax as ca
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import stream_select as ss

    bf = torch.bfloat16
    errs = {}
    for B, n, m in MMA_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        A = torch.randn((n, m), device=dev, generator=gen)
        Ac = (A / A.norm(dim=0)).to(bf)
        r = torch.randn((B, n), device=dev, generator=gen)
        a0, a1, a2 = 5, 14, m - 3              # one column, thrice
        Ac[:, a1] = Ac[:, a0]
        Ac[:, a2] = Ac[:, a0]
        r[0] = Ac[:, a0].float()
        if B > 2:
            r[1, 3] = float("nan")
        amask = (torch.rand((B, m), device=dev, generator=gen) < 0.3).to(
            torch.uint8)
        amask[:, a0] = 1
        amask[:, a1] = 0
        full = B - 1 if B > 3 else None        # a row with every atom active
        if full:
            amask[full] = 1
        streams = m % 128 == 0
        tm = ss._stream_tile(m, n, 2, ss.STREAM_TILE_BYTES) if streams else m
        M = torch.where(amask.bool(), -torch.inf, 0.0)
        for poisoned in (False, True):
            if poisoned:
                Ac[:, m // 2 + 1] = float("nan")
            Ac32 = Ac.float()
            sc = torch.abs(r.to(bf).float() @ Ac32)
            want = fs._select_ref(r, Ac32, bf, signed=True)
            want_m = fs._select_ref(r, Ac32, bf, False, amask, 0.5)
            clear = _tile_clear(sc)
            clear_m = _tile_clear(torch.where(amask.bool(), -torch.inf,
                                              0.5 * sc))
            for mma in (True, False):
                sfx = "_mma" if mma else ""
                pv, pi, ps = fs.select_argmax(r, Ac, signed=True, mma=mma)
                qv, qi = fs.select_argmax(r, Ac, mma=mma)
                mv, mi = fs.select_argmax(r, Ac, amask=amask, eta=0.5,
                                          mma=mma)
                torch.cuda.synchronize()
                assert torch.equal(pi, qi) and torch.equal(
                    pv.nan_to_num(-1.0), qv.nan_to_num(-1.0))
                _hold("select" + sfx, (pv, pi), want[:2], clear, errs)
                same = (pi == want[1]) & torch.isfinite(want[0])
                assert bool(((ps[same] - want[2][same]).abs() <= SELECT_RTOL
                             * want[2][same].abs() + 1e-6).all())
                _hold("select_masked" + sfx, (mv, mi), want_m, clear_m, errs)
                # a fully masked row keeps (-inf, the tile's first atom)
                if full:
                    assert torch.equal(mi[full], want_m[1][full])
                if not poisoned:
                    last = a2 if a2 >= 128 else a0
                    assert int(pi[0, 0]) == a0 and int(pi[0, -1]) == last
                    assert float(pv[0, 0]) == float(pv[0, -1])
                    assert int(mi[0, 0]) == a1
                if B > 2:
                    assert bool(torch.isnan(pv[1]).all())
                    assert bool((pi[1] == fs.INT_MAX).all())
                if not streams:
                    continue
                # tiles of the NaN rule that hold a NaN take no part
                tiles = sc.view(B, m // tm, tm)
                live = torch.where(torch.isnan(tiles).any(dim=2, keepdim=True),
                                   -torch.inf, tiles).view(B, m)
                _hold("select_stream" + sfx,
                      ss.correlate_select_stream(Ac, r, mma=mma),
                      ss.correlate_select_stream_ref(Ac, r),
                      _clear_rows(live), errs)
                _hold("select_masked_stream" + sfx,
                      ss.correlate_select_masked_stream(Ac, r, M, mma=mma),
                      ss.correlate_select_masked_stream_ref(Ac, r, M),
                      _clear_rows(live + M), errs)
                if not poisoned:
                    rt = r.T                   # (n, B) as a strided view
                    ki, kv = ca.correlate_argmax(Ac, rt, mma=mma)
                    wi, wv = ca.correlate_argmax_ref(Ac, rt)
                    _hold("corr_argmax" + sfx, (kv, ki), (wv, wi),
                          _clear_rows(sc), errs)
                    pad = torch.ones((n, 128), dtype=bf, device=dev)
                    wide = torch.cat([pad, pad, Ac, pad], dim=1)
                    part = wide[:, 256:256 + m]
                    assert part.stride(0) == m + 384
                    got = ss.correlate_select_stream(part, r, mma=mma)
                    torch.cuda.synchronize()
                    copy = ss.correlate_select_stream(Ac, r, mma=mma)
                    assert torch.equal(got[0].nan_to_num(-1.0),
                                       copy[0].nan_to_num(-1.0))
                    assert torch.equal(got[1], copy[1])
        del A, Ac, Ac32, sc
    # what the tensor-core loop does not take: f32, a base off 16 bytes, a
    # pitch off 8 entries; the predicate sends them to the CUDA cores
    gen = torch.Generator(device=dev).manual_seed(SEED)
    A = torch.randn((64, 1032), device=dev, generator=gen).to(bf)
    r = torch.randn((8, 64), device=dev, generator=gen)
    odd = A[:, 4:1028]                         # base off by 8 bytes
    thin = torch.randn((64, 1028), device=dev, generator=gen).to(bf)
    for bad, fn in (
            ("f32", lambda **kw: fs.select_argmax(r, A.float(), **kw)),
            ("misaligned base",
             lambda **kw: ss.correlate_select_stream(odd, r, **kw)),
            ("pitch off 16 bytes",
             lambda **kw: fs.select_argmax(r, thin, **kw))):
        try:
            fn(mma=True)
        except RuntimeError:
            pass
        else:
            raise AssertionError(f"tensor-core select took {bad}")
        _, counts = run_counted(fn)
        assert not any(v for key, v in counts.items() if key.endswith("_mma"))
        assert sum(counts.values()) == 1, counts
    torch.cuda.synchronize()
    print(f"[mma selects] tensor-core and CUDA-core variants == plain twins "
          f"at (B, n, m) in {MMA_SHAPES}: plain, signed, masked, +M, R as "
          f"(n, B), a column slice read in place; ties, NaN row, all-masked "
          f"row, poisoned atom; f32, a misaligned base and an odd pitch "
          f"refused by the tensor-core loop and sent to the CUDA cores; max "
          f"|val err| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (rtol {SELECT_RTOL})")
    return errs


def check_mma_topl(dev):
    """Both hand-written variants of the top-l selects against the plain
    twins at MMA_SHAPES, bf16, with a column repeated within and across
    tiles, a NaN row and a poisoned atom: select_topl's partials at l in
    (1, 4, 16, 32), values to SELECT_RTOL and index sets on the tiles whose
    l-th score stands clear of the (l+1)-th, its first entry per tile the
    top-1 select's partial bit for bit; where the shape streams, K7 at l in
    (1, 4, 32, 48, 128) (sorted values; slot for slot on the clear rows),
    its finish alone against the plain fold bit for bit, a column slice
    (pitch m + 384) read in place, and at l = 1 the top-1 stream select.
    Forcing the tensor-core loop on f32 or a misaligned base must fail."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import stream_select as ss

    bf = torch.bfloat16
    errs = {}
    for B, n, m in MMA_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        A = torch.randn((n, m), device=dev, generator=gen)
        Ac = (A / A.norm(dim=0)).to(bf)
        r = torch.randn((B, n), device=dev, generator=gen)
        a0, a1, a2 = 5, 14, m - 3              # one column, thrice
        Ac[:, a1] = Ac[:, a0]
        Ac[:, a2] = Ac[:, a0]
        r[0] = 0.3 * r[0] + 3.0 * Ac[:, a0].float()
        if B > 2:
            r[1, 3] = float("nan")
        if m >= 1024:
            Ac[:, m // 2 + 1] = float("nan")    # its tile, every row
        Ac32 = Ac.float()
        tv1, ti1 = fs.select_argmax(r, Ac, mma=True)
        for l, mma in itertools.product((1, 4, 16, 32), (True, False)):
            key = "select_topl_mma" if mma else "select_topl"
            kv, ki = fs.select_topl(r, Ac, l, mma=mma)
            pv, pi = fs._topl_ref(r, Ac32, bf, l)
            torch.cuda.synchronize()
            assert torch.equal(torch.isnan(kv), torch.isnan(pv))
            fin = torch.isfinite(pv)
            assert torch.equal(torch.isfinite(kv), fin)
            e = (kv[fin] - pv[fin]).abs()
            assert bool((e <= SELECT_RTOL * pv[fin].abs() + 1e-6).all()), (
                key, l, float(e.max()))
            errs[key] = max(errs.get(key, 0.0),
                            float(e.max()) if e.numel() else 0.0)
            deeper = fs._topl_ref(r, Ac32, bf, l + 1)[0].nan_to_num(-1.0)
            clear = (deeper[..., l - 1] - deeper[..., l]
                     > GAP_RTOL * deeper[..., 0].abs())
            assert torch.equal(ki.sort(dim=2).values[clear],
                               pi.sort(dim=2).values[clear]), (key, l)
            if mma:
                assert torch.equal(kv[:, :, 0].view(torch.int32),
                                   tv1.view(torch.int32))
                assert torch.equal(ki[:, :, 0], ti1)
        if m % 128:
            continue
        tm = ss._stream_tile(m, n, 2, ss.STREAM_TILE_BYTES)
        sc = torch.abs(r.to(bf).float() @ Ac32)
        tiles = sc.view(B, m // tm, tm)
        live = torch.where(torch.isnan(tiles).any(dim=2, keepdim=True),
                           -1.0, tiles).view(B, m)
        pad = torch.ones((n, 128), dtype=bf, device=dev)
        part = torch.cat([pad, pad, Ac, pad], dim=1)[:, 256:256 + m]
        assert part.stride(0) == m + 384
        for l, mma in itertools.product((1, 4, 32, 48, 128), (True, False)):
            key = "select_topl_stream_mma" if mma else "select_topl_stream"
            kv, ki = ss.correlate_select_topl_stream(Ac, r, l, mma=mma)
            pv, pi = ss.correlate_select_topl_stream_ref(Ac, r, l)
            ks, ps = kv.sort(dim=1).values, pv.sort(dim=1).values
            fin = torch.isfinite(ps)
            assert torch.equal(torch.isfinite(ks), fin)
            e = (ks[fin] - ps[fin]).abs()
            assert bool((e <= SELECT_RTOL * ps[fin].abs() + 1e-6).all()), (
                key, l, float(e.max()))
            errs[key] = max(errs.get(key, 0.0),
                            float(e.max()) if e.numel() else 0.0)
            clear = _clear_rows(live, depth=min(l, m - 1))
            clear[0] = False                   # the copies of a0 tie
            assert torch.equal(ki[clear], pi[clear]), (key, l)
            if l >= 3 and bool((live[0, [a0, a1, a2]] >= 0).all()):
                assert {a0, a1, a2} <= set(ki[0].tolist())
            got = ss.correlate_select_topl_stream(part, r, l, mma=mma)
            assert torch.equal(got[0], kv) and torch.equal(got[1], ki)
            pval, pidx = ss.stream_topl_sweep(Ac, r, l, mma=mma)
            want = ss.stream_topl_finish_ref(pval.clone(), pidx.clone(),
                                             tm // 128, l)
            got = ss.stream_topl_finish(pval, pidx, tm // 128, l)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1])
        v1, i1 = ss.correlate_select_topl_stream(Ac, r, 1, mma=True)
        w1, j1 = ss.correlate_select_stream(Ac, r, mma=True)
        assert torch.equal(v1[:, 0].view(torch.int32), w1.view(torch.int32))
        assert torch.equal(i1[:, 0], j1)
        del A, Ac, Ac32, sc
    gen = torch.Generator(device=dev).manual_seed(SEED)
    A = torch.randn((64, 1032), device=dev, generator=gen).to(bf)
    r = torch.randn((8, 64), device=dev, generator=gen)
    odd = A[:, 4:1028]                         # base off by 8 bytes
    for bad, fn in (
            ("f32", lambda **kw: fs.select_topl(r, A.float(), 4, **kw)),
            ("misaligned base",
             lambda **kw: ss.correlate_select_topl_stream(odd, r, 4, **kw))):
        try:
            fn(mma=True)
        except RuntimeError:
            pass
        else:
            raise AssertionError(f"tensor-core top-l took {bad}")
        _, counts = run_counted(fn)
        assert not any(v for key, v in counts.items() if key.endswith("_mma"))
    torch.cuda.synchronize()
    print(f"[mma top-l] tensor-core and CUDA-core variants == plain twins "
          f"at (B, n, m) in {MMA_SHAPES}: select_topl at l in (1, 4, 16, "
          f"32), its first entry == the top-1 partial bit for bit; K7 at l "
          f"in (1, 4, 32, 48, 128), a column slice read in place, the "
          f"finish alone bit for bit, l=1 == the top-1 stream; ties, NaN "
          f"row, poisoned atom; f32 and a misaligned base refused; max "
          f"|val err| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (rtol {SELECT_RTOL})")
    return errs


# K7 past 128 slots: the widths held at both shard widths of 5c, the
# widths timed, and the cases whose keys pass the wide finish's shared
# memory (kWideSmem), as (n, m, l): the fold's slots at l = 16384, and the
# merge of a 16384-atom tile (n = 256 in bf16: 128 blocks a tile)
TOPL_WIDE_LS = (129, 256, 1024)
TOPL_WIDE_TIMED = (160, 1024)
TOPL_WIDE_SCRATCH = ((1024, 32768, 16384), (256, 32768, 129))
# 5c's problem past 128 picks: k of sp/ompr/srr_sharded_fused, l and k of
# gomp_sharded_fused
WIDE_K = 160


def _hold_topl(what, kern, plain, live, l):
    """A finished top-l select (val, idx) against its plain twin's, on the
    scores `live` (B, m; -inf where the NaN rule skips a tile): values as
    sorted rows within SELECT_RTOL of the row's best score, index sets
    equal where the l-th best score stands clear of the (l+1)-th, slot for
    slot where all l + 1 best stand clear (`_clear_rows`). Returns (the
    largest |value err|, rows held slot for slot, rows held as sets)."""
    (kv, ki), (pv, pi) = kern, plain
    B, m = live.shape
    ks, ps = kv.sort(dim=1).values, pv.sort(dim=1).values
    fin = torch.isfinite(ps)
    assert torch.equal(torch.isfinite(ks), fin), what
    # past 128 slots the smallest kept scores are cancellations of products
    # of the row's scale: the tolerance is relative to the row's best
    scale = torch.where(fin, ps, 0.0).amax(dim=1, keepdim=True).expand_as(ps)
    err = (ks - ps)[fin].abs()
    assert bool((err <= SELECT_RTOL * scale[fin] + 1e-7).all()), (
        what, float(err.max()))
    depth = min(l, m - 1)
    top = live.nan_to_num(nan=-1.0, neginf=-1.0).topk(depth + 1,
                                                      dim=1).values
    edge = ((top[:, depth - 1] - top[:, depth]) > GAP_RTOL * top[:, 0]
            if l < m else torch.ones((B,), dtype=torch.bool,
                                     device=live.device))
    for b in torch.nonzero(edge).flatten().tolist():
        assert set(ki[b].tolist()) == set(pi[b].tolist()), (what, b)
    clear = _clear_rows(live, depth=depth)
    assert torch.equal(ki[clear], pi[clear]), what
    return (float(err.max()) if err.numel() else 0.0, int(clear.sum()),
            int(edge.sum()))


def hold_topl_wide(dev, n, m, l, cdt, poison, errs):
    """K7 at l > 128 against its plain twin on the card, B=8: one column
    twice (within and across tiles), a NaN row, and with `poison` a NaN
    atom (its tile skipped on every row). The select's launches by the
    counts (the sweep the predicate picks, one finish); values as sorted
    rows to SELECT_RTOL of the row's best score; index sets equal where the l-th best score stands
    clear of the (l+1)-th, slot for slot where all l + 1 best stand clear
    (`_clear_rows`); the finish alone on the sweep's partials bit for bit.
    Returns (rows held slot for slot, rows held as sets)."""
    from cstpu_torch.ops import stream_select as ss

    B = 8
    gen = torch.Generator(device=dev).manual_seed(SEED + l)
    A = torch.randn((n, m), device=dev, generator=gen)
    A = (A / A.norm(dim=0)).to(cdt)
    R = torch.randn((B, n), device=dev, generator=gen)
    tm = ss._tile_of(A, "hold_topl_wide")
    a0, a1 = 70, min(tm, m // 2) + 3           # one column, within and
    A[:, a1] = A[:, a0]                        # across tiles
    R[0] = A[:, a0].float()
    R[1, 5] = float("nan")
    if poison:
        best = int(ss._abs_scores(A, R[2:3]).argmax())
        A[:, best] = float("nan")
    sc = ss._abs_scores(A, R).view(B, m // tm, tm)
    live = torch.where(torch.isnan(sc).any(dim=2, keepdim=True), -torch.inf,
                       sc).view(B, m)
    key = ("select_topl_stream_mma" if cdt == torch.bfloat16
           else "select_topl_stream")
    (kv, ki), counts = run_counted(
        lambda: ss.correlate_select_topl_stream(A, R, l))
    assert counts == expect_launches(**{key: 1, "stream_topl_finish": 1}), \
        counts
    name = key + " wide"
    err, clear, edge = _hold_topl(
        (name, l), (kv, ki), ss.correlate_select_topl_stream_ref(A, R, l),
        live, l)
    errs[name] = max(errs.get(name, 0.0), err)
    assert bool((kv[1] == -torch.inf).all()) and bool((ki[1] == 0).all())
    if poison:
        lo = best // tm * tm
        assert not bool(((ki >= lo) & (ki < lo + tm)
                         & (kv > -torch.inf)).any()), (name, l)
    else:
        assert {a0, a1} <= set(ki[0].tolist()), (name, l)
    pval, pidx = ss.stream_topl_sweep(A, R, l)
    want = ss.stream_topl_finish_ref(pval.clone(), pidx.clone(), tm // 128, l)
    got = ss.stream_topl_finish(pval, pidx, tm // 128, l)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (
        name, l, "finish")
    errs["stream_topl_finish wide"] = 0.0
    return clear, edge


def check_topl_wide(dev, gpu):
    """The [topl wide] phase: K7 past 128 slots (`hold_topl_wide`) at l in
    TOPL_WIDE_LS and m_local in STREAM_WIDTHS, bf16 (the tensor-core sweep)
    and f32 (the CUDA-core one), with and without a poisoned atom, and at
    TOPL_WIDE_SCRATCH, where the finish's keys lie in its scratch; then
    its times at l in TOPL_WIDE_TIMED: device ms per call (profiler; the
    sweep, merge and fold apart), ms per call (events), the plain twin's,
    the bound (`stream_bound`) and the library's: the bf16 GEMM and
    torch.topk(l) over the shard's scores."""
    from cstpu_torch.ops import stream_select as ss

    t0 = time.perf_counter()
    B, n = SHARD_CELLS["5c"][:2]
    errs, rows = {}, []
    for m, cdt, l, poison in itertools.product(
            STREAM_WIDTHS, (torch.bfloat16, torch.float32), TOPL_WIDE_LS,
            (False, True)):
        rows.append(hold_topl_wide(dev, n, m, l, cdt, poison, errs))
    for n_, m, l in TOPL_WIDE_SCRATCH:
        bpt = ss._stream_tile(m, n_, 2, ss.STREAM_TILE_BYTES) // 128
        assert ss._finish_work(B, m, l, bpt) > 0, (n_, m, l)
        rows.append(hold_topl_wide(dev, n_, m, l, torch.bfloat16, False,
                                   errs))
    held = time.perf_counter() - t0

    bf = torch.bfloat16
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    R = torch.randn((B, n), device=dev, generator=gen)
    for ml in STREAM_WIDTHS:
        A = torch.randn((n, ml), device=dev, generator=gen)
        Ac = (A / A.norm(dim=0)).to(bf)
        del A
        Rb = R.to(bf)
        for l in TOPL_WIDE_TIMED:
            fn = lambda: ss.correlate_select_topl_stream(Ac, R, l)
            busy, got = profile_path(fn, TIMED_LAUNCHES)
            ms = {nm: v[1] / TIMED_LAUNCHES for nm, v in got.items()}
            rec = {
                "device_ms": busy / TIMED_LAUNCHES,
                "sweep_device_ms": ms.get("topl_mma", 0.0)
                + ms.get("round_rows", 0.0),
                "merge_device_ms": ms.get("stream_topl_merge_wide", 0.0),
                "fold_device_ms": ms.get("stream_topl_fold_wide", 0.0),
                "ms": per_launch_ms(R, fn),
                "plain_ms": cuda_ms(lambda: ss.correlate_select_topl_stream_ref(
                    Ac, R, l)[0].flatten()[0], TIMED_SLOW),
                **stream_bound(B, n, ml, l=l),
                "library_ms": per_launch_ms(R, lambda: torch.matmul(
                    Rb, Ac).abs().topk(l, dim=1))}
            if l == TOPL_WIDE_TIMED[0]:
                busy, got = profile_path(
                    lambda: ss.correlate_select_topl_stream(Ac.float(), R, l),
                    TIMED_LAUNCHES)
                rec["f32_device_ms"] = busy / TIMED_LAUNCHES
            out[(ml, l)] = rec
        del Ac
        torch.cuda.empty_cache()
    print(f"[topl wide] K7 at l > 128 == plain twin: l in {TOPL_WIDE_LS} at "
          f"m_local in {STREAM_WIDTHS} (B={B}, n={n}), bf16 (tensor-core "
          f"sweep) and f32 (CUDA-core sweep), with and without a poisoned "
          f"tile, and (n, m, l) in {TOPL_WIDE_SCRATCH} (keys in the "
          f"finish's scratch): sorted values within rtol {SELECT_RTOL}, "
          f"index sets on {sum(e for _, e in rows)} rows whose l-th best "
          f"stands clear, slot for slot on {sum(c for c, _ in rows)} fully "
          f"clear rows, the finish alone bit for bit, NaN row and poisoned "
          f"tile skipped; max |val err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; held in {held:.1f} s")
    print("[topl wide] ms per call at B=8, n=1024, bf16 (device: profiler; "
          "ms: events, wrapper and launches; library: bf16 GEMM + "
          "torch.topk(l)): "
          + "; ".join(f"m_local={ml} l={l} " + ", ".join(
              f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
              for k, v in rec.items()) for (ml, l), rec in out.items())
          + f" | {gpu}; {time.perf_counter() - t0:.1f} s")
    return errs, out


def sharded_wide_paths(A, Bs, sup):
    """5c's problem (B=8, n=1024, m=131072, 32 planted +-1 atoms a row) past
    128 picks on SHARDS shards: sp, ompr and srr_sharded_fused at k =
    WIDE_K, gomp_sharded_fused at l = k = WIDE_K, each once with the launch
    counts zeroed just before: launches against the iterations run,
    supports equal to the plain solve's, the planted atoms inside every
    support (GOMP, one step of k picks: inside it or below the row's k-th
    best score); then each solve's time (events) and profiler split."""
    import cstpu_torch
    from cstpu_torch.parallel import sharded as sh

    k, s = WIDE_K, SHARDS
    mesh = cstpu_torch.make_mesh((1, s))
    Ash = cstpu_torch.shard_dictionary(A, mesh)
    out = {}
    cases = (
        ("gomp", lambda f, **kw: f(Ash, Bs, k, k, mesh, **kw),
         cstpu_torch.gomp_sharded_fused, sh.gomp_sharded_fused_ref,
         lambda it: {"select_topl_stream_mma": s * it,
                     "stream_topl_finish": s * it}),
        ("sp", lambda f, **kw: f(Ash, Bs, k, mesh, **kw),
         cstpu_torch.sp_sharded_fused, sh.sp_sharded_fused_ref,
         lambda it: {"select_topl_stream_mma": s * (1 + it),
                     "stream_topl_finish": s * (1 + it)}),
        ("ompr", lambda f, **kw: f(Ash, Bs, k, mesh, delta=1e-12, **kw),
         cstpu_torch.ompr_sharded_fused, sh.ompr_sharded_fused_ref,
         lambda it: {"select_topl_stream_mma": s, "stream_topl_finish": s,
                     "select_masked_stream_mma": s * it}),
        ("srr", lambda f, **kw: f(Ash, Bs, k, mesh, delta=1e-12, **kw),
         cstpu_torch.srr_sharded_fused, sh.srr_sharded_fused_ref,
         lambda it: {"select_topl_stream_mma": s, "stream_topl_finish": s,
                     "fr_step_select_mma": s * it}),
    )
    for name, call, entry, ref, want in cases:
        t0 = time.perf_counter()
        (sol, iters), launches = run_counted(
            lambda: call(entry, return_iters=True))
        wall = time.perf_counter() - t0
        assert launches == expect_launches(**want(iters[0])), (name, launches)
        rec = recovery(sol, sup)
        plain, it_plain = call(ref, return_iters=True)
        assert _supports(plain) == _supports(sol), f"{name}: plain solve"
        if name == "gomp":
            # one step of k picks and no correction: a planted atom whose
            # |score| on b lies below the row's k-th best is left out by
            # GOMP's own rule, on every route
            sc = (Bs @ A).abs()
            kth = sc.topk(k, dim=1).values[:, -1]
            for b_, (got, want) in enumerate(zip(_supports(sol),
                                                 sup.tolist())):
                for j in set(want) - set(got):
                    assert float(sc[b_, j]) <= float(kth[b_]) * (1 + 1e-3), \
                        (name, b_, j)
        else:
            assert rec == 1.0, f"{name}: recovery {rec}"
        cerr = float((sol.val - plain.val).abs().max())
        assert cerr <= COEF_ATOL, (name, cerr)
        ms = cuda_ms(lambda: call(entry).val.sum(), TIMED_SLOW)
        sp_ = _split(ms, lambda: call(entry))
        out[name] = {"launches": launches, "iters": iters[0],
                     "plain_iters": it_plain[0], "recovery": rec,
                     "err": cerr, "first_call_s": wall, "solve_ms": ms,
                     "device_busy_ms": sp_["device_busy_ms"],
                     "idle_share": sp_["idle_share"],
                     "kernels": sp_["kernels"]}
        print(f"[main 5c-wide {name}] {entry.__name__} k={k} shards={s} "
              f"recovery={rec:.3f} iters={iters[0]} (plain {it_plain[0]}) "
              f"launches={ {key: v for key, v in launches.items() if v} }; "
              f"supports == plain solve, max |coef err| {cerr:.3e} (atol "
              f"{COEF_ATOL}); first call {wall:.2f} s")
        print(f"[split 5c-wide {name}] wall {ms:.4f} ms, device busy "
              f"{sp_['device_busy_ms']:.4f} ms, idle share "
              f"{sp_['idle_share']:.4f}; "
              + ", ".join(f"{nm} {v['launches']}x {v['ms']:.4f} ms"
                          for nm, v in sp_["kernels"].items()))
    return out


def _supports(sol):
    """Per row the sorted tuple of active atom indices."""
    idx = torch.where(sol.mask, sol.idx, sol.m).cpu().numpy()
    return [tuple(sorted(int(i) for i in row if i < sol.m)) for row in idx]


def unit_dictionary(gen, n, m):
    """Unit-norm Gaussian dictionary, normalised in place (no second copy of
    a dictionary that takes gigabytes)."""
    A = torch.randn((n, m), generator=gen, device=gen.device)
    A /= torch.linalg.vector_norm(A, dim=0, keepdim=True)
    return A


def planted_pm1(gen, A, B, k):
    """B measurements of k-sparse +-1 signals on random supports."""
    m = A.shape[1]
    sup = torch.stack([torch.randperm(m, generator=gen, device=A.device)[:k]
                       for _ in range(B)])
    sign = torch.randint(0, 2, (B, k), generator=gen,
                         device=A.device).float() * 2 - 1
    return (A[:, sup] * sign[None]).sum(-1).T.contiguous(), sup


def sharded_omp_path(cell, A, Bs, sup, shard_counts, plain: bool):
    """omp_sharded_fused on the cell's problem, once per shard count and
    collective form with the launch counts zeroed just before: recovery
    1.000, launches = shards x steps, all of the tensor-core sweep, supports
    equal across shard counts, forms, the plain solve (when `plain`) and
    omp_batch."""
    import cstpu_torch
    from cstpu_torch.parallel import sharded as sh

    k = SHARD_CELLS[cell][3]
    out, first = {}, None
    for s in shard_counts:
        mesh = cstpu_torch.make_mesh((1, s))
        Ash = cstpu_torch.shard_dictionary(A, mesh)
        for fuse in (True, False):
            (sol, iters), launches = run_counted(
                lambda: cstpu_torch.omp_sharded_fused(
                    Ash, Bs, k, mesh, fuse_collectives=fuse,
                    return_iters=True))
            assert iters == [k], iters
            assert launches == expect_launches(select_stream_mma=s * k), \
                launches
            rec = recovery(sol, sup)
            assert rec == 1.0, f"{cell} s={s} fuse={fuse}: recovery {rec}"
            if first is None:
                first = sol
            assert torch.equal(sol.idx, first.idx), (cell, s, fuse)
            bitwise = torch.equal(sol.val, first.val)
            cerr = float((sol.val - first.val).abs().max())
            assert cerr <= COEF_ATOL, cerr
            out[(s, fuse)] = {"launches": launches["select_stream_mma"],
                              "recovery": rec, "bitwise_val": bitwise}
            print(f"[main {cell}] omp_sharded_fused shards={s} "
                  f"fuse_collectives={fuse} recovery={rec:.3f} steps={iters} "
                  f"select_stream_mma launches="
                  f"{launches['select_stream_mma']}; "
                  f"supports == first run, coefficients "
                  f"{'bit-equal' if bitwise else f'within {cerr:.3e}'}")
        if plain:
            ref = sh.omp_sharded_fused_ref(Ash, Bs, k, mesh)
            assert _supports(ref) == _supports(first), (cell, s, "plain")
            cerr = float((ref.val - first.val).abs().max())
            assert cerr <= COEF_ATOL, cerr
            print(f"[main {cell}] shards={s}: supports == plain solve, max "
                  f"|coef err| {cerr:.3e} (atol {COEF_ATOL})")
        del Ash
    ub = cstpu_torch.omp_batch(A, Bs, k)
    assert _supports(ub) == _supports(first), (cell, "omp_batch")
    print(f"[main {cell}] supports == omp_batch's on the same rows")
    return out


def sharded_other_paths(A, gen):
    """mp/gomp/ompr/sp_sharded_fused on 5c's dictionary with planted ones,
    B=8, SHARDS shards: launch counts against the iterations run, recovery
    (all but MP), supports equal to the plain solve's and to the unsharded
    *_batch's; MP's x and r against the plain solve."""
    import cstpu_torch
    from cstpu_torch.parallel import sharded as sh

    B, n, m, k = SHARD_CELLS["5c"]
    s = SHARDS
    Bs, sup = planted_ones(gen, A, B, k)
    mesh = cstpu_torch.make_mesh((1, s))
    Ash = cstpu_torch.shard_dictionary(A, mesh)
    out = {}

    x, launches = run_counted(
        lambda: cstpu_torch.mp_sharded_fused(Ash, Bs, k, mesh))
    assert launches == expect_launches(select_stream_mma=s * k), launches
    xp = sh.mp_sharded_fused_ref(Ash, Bs, k, mesh)
    clear = mp_clear_rows(A, Bs, k)
    assert int(clear.sum()) >= 3 * B // 4, int(clear.sum())
    xerr = float((x - xp)[clear].abs().max())
    r, rp = Bs - x @ A.T, Bs - xp @ A.T
    rerr = float((r - rp)[clear].abs().max())
    assert xerr <= MP_ATOL and rerr <= MP_ATOL, (xerr, rerr)
    fall = float((r.norm(dim=1) / Bs.norm(dim=1)).max())
    assert fall < 1.0, fall
    out["mp"] = {"launches": launches, "err": max(xerr, rerr)}
    print(f"[main 5c mp] mp_sharded_fused shards={s} launches="
          f"{launches['select_stream_mma']}; max |x err| {xerr:.3e}, |r err| "
          f"{rerr:.3e} against the plain solve on the {int(clear.sum())}/{B} "
          f"clear rows (atol {MP_ATOL}); ||r||/||b|| "
          f"<= {fall:.3f}")

    cases = (
        ("gomp", lambda f, **kw: f(Ash, Bs, 4, k, mesh, **kw),
         cstpu_torch.gomp_sharded_fused, sh.gomp_sharded_fused_ref,
         lambda: cstpu_torch.gomp_batch(A, Bs, 4, k),
         lambda it: {"select_topl_stream_mma": s * it,
                     "stream_topl_finish": s * it}),
        ("ompr", lambda f, **kw: f(Ash, Bs, k, mesh, delta=1e-12, **kw),
         cstpu_torch.ompr_sharded_fused, sh.ompr_sharded_fused_ref,
         lambda: cstpu_torch.ompr_batch(A, Bs, k, 1e-12),
         lambda it: {"select_topl_stream_mma": s, "stream_topl_finish": s,
                     "select_masked_stream_mma": s * it}),
        ("sp", lambda f, **kw: f(Ash, Bs, k, mesh, maxiter=8, **kw),
         cstpu_torch.sp_sharded_fused, sh.sp_sharded_fused_ref,
         lambda: cstpu_torch.sp_batch(A, Bs, k, maxiter=8),
         lambda it: {"select_topl_stream_mma": s * (1 + it),
                     "stream_topl_finish": s * (1 + it)}),
    )
    for name, call, entry, ref, unsharded, want in cases:
        (sol, iters), launches = run_counted(
            lambda: call(entry, return_iters=True))
        assert launches == expect_launches(**want(iters[0])), (name, launches)
        rec = recovery(sol, sup)
        assert rec == 1.0, f"{name}: recovery {rec}"
        plain, it_plain = call(ref, return_iters=True)
        assert _supports(plain) == _supports(sol), f"{name}: plain solve"
        assert _supports(unsharded()) == _supports(sol), f"{name}: unsharded"
        cerr = float((sol.val - plain.val).abs().max())
        assert cerr <= COEF_ATOL, (name, cerr)
        out[name] = {"launches": launches, "iters": iters[0],
                     "plain_iters": it_plain[0], "recovery": rec,
                     "err": cerr}
        print(f"[main 5c {name}] {entry.__name__} shards={s} recovery="
              f"{rec:.3f} iters={iters[0]} (plain {it_plain[0]}) launches="
              f"{ {key: v for key, v in launches.items() if v} }; supports "
              f"== plain solve == unsharded batch solve, max |coef err| "
              f"{cerr:.3e} (atol {COEF_ATOL})")
    return out, Bs, sup


def corr_argmax_path(A, Bs):
    """The package's correlate_argmax on 5c's dictionary with R as (n, B),
    launch count zeroed just before: every row's pick is the first pick of
    the streaming select on the same inputs."""
    import cstpu_torch
    from cstpu_torch.ops import stream_select as ss

    Ac = A.to(torch.bfloat16)
    R = Bs.T.contiguous()                       # (n, B)
    (idx, val), launches = run_counted(
        lambda: cstpu_torch.correlate_argmax(Ac, R))
    assert launches == expect_launches(corr_argmax_mma=1), launches
    sval, sidx = ss.correlate_select_stream(Ac, Bs)
    torch.cuda.synchronize()
    assert torch.equal(idx, sidx) and torch.equal(val, sval)
    assert not bool(torch.isnan(val).any())
    print(f"[main 5c corr_argmax] correlate_argmax(A, R (n, B)) launches="
          f"{launches['corr_argmax_mma']}; idx and val == select_stream's on "
          f"the same inputs")
    return launches["corr_argmax_mma"]


F32_STEPS = 8   # depth of the f32-correlation sharded paths


def sharded_f32_paths(A, Bs, sup, Bones, sup_ones, gpu):
    """The sharded paths with f32 correlation, at a smaller depth: they must
    run on the CUDA-core sweeps (true f32). omp_sharded_fused (F32_STEPS
    steps of 5c's problem: every pick a planted atom), ompr_sharded_fused,
    gomp_sharded_fused (l = 4) and sp_sharded_fused on the planted ones
    (recovery 1.000, supports equal to the plain solve's; GOMP and SP on
    K7's CUDA-core sweep alone, with the device busy time and idle share of
    a solve) and correlate_argmax on the f32 dictionary, each with the
    launch counts zeroed just before."""
    import cstpu_torch
    from cstpu_torch.ops import stream_select as ss
    from cstpu_torch.parallel import sharded as sh

    B, n, m, k = SHARD_CELLS["5c"]
    s, f32 = SHARDS, torch.float32
    mesh = cstpu_torch.make_mesh((1, s))
    Ash = cstpu_torch.shard_dictionary(A, mesh)
    sol, launches = run_counted(lambda: cstpu_torch.omp_sharded_fused(
        Ash, Bs, F32_STEPS, mesh, corr_dtype=f32))
    assert launches == expect_launches(select_stream=s * F32_STEPS), launches
    got, planted_ = _supports(sol), [set(row) for row in sup.tolist()]
    assert all(len(g) == F32_STEPS and set(g) <= p
               for g, p in zip(got, planted_)), "f32 picks off the support"
    ref = sh.omp_sharded_fused_ref(Ash, Bs, F32_STEPS, mesh, corr_dtype=f32)
    assert _supports(ref) == got
    out = {"omp": launches["select_stream"]}
    (sol, iters), launches = run_counted(lambda: cstpu_torch.ompr_sharded_fused(
        Ash, Bones, k, mesh, delta=1e-12, corr_dtype=f32, return_iters=True))
    assert launches == expect_launches(
        select_topl_stream=s, stream_topl_finish=s,
        select_masked_stream=s * iters[0]), launches
    rec = recovery(sol, sup_ones)
    assert rec == 1.0, f"ompr f32: recovery {rec}"
    ref = sh.ompr_sharded_fused_ref(Ash, Bones, k, mesh, delta=1e-12,
                                    corr_dtype=f32)
    assert _supports(ref) == _supports(sol)
    out["ompr"] = launches["select_masked_stream"]
    out["ompr_topl"] = launches["select_topl_stream"]
    out["ompr_finish"] = launches["stream_topl_finish"]
    topl = {}
    for name, call, ref, sweeps in (
            ("gomp", lambda f, **kw: f(Ash, Bones, 4, k, mesh, **kw),
             sh.gomp_sharded_fused_ref, lambda it: s * it),
            ("sp", lambda f, **kw: f(Ash, Bones, k, mesh, **kw),
             sh.sp_sharded_fused_ref, lambda it: s * (1 + it))):
        entry = getattr(cstpu_torch, f"{name}_sharded_fused")
        (sol, iters), launches = run_counted(lambda: call(
            entry, corr_dtype=f32, return_iters=True))
        want = sweeps(iters[0])
        assert launches == expect_launches(
            select_topl_stream=want, stream_topl_finish=want), (name, launches)
        rec = recovery(sol, sup_ones)
        assert rec == 1.0, f"{name} f32: recovery {rec}"
        assert _supports(call(ref, corr_dtype=f32)) == _supports(sol), name
        wall = cuda_ms(lambda: call(entry, corr_dtype=f32).val.sum(),
                       TIMED_SOLVES)
        split = _split(wall, lambda: call(entry, corr_dtype=f32))
        out[name] = want
        topl[name] = (iters[0], rec, split)
        print(f"[time f32 5c {name}] {name}_sharded_fused corr_dtype=f32 "
              f"shards={s}: wall {wall:.4f} ms, device busy "
              f"{split['device_busy_ms']:.4f} ms, idle share "
              f"{split['idle_share']:.4f}; "
              + ", ".join(f"{nm} {v['launches']}x {v['ms']:.4f} ms"
                          for nm, v in split["kernels"].items())
              + f" | {gpu}")
    R = Bs.T.contiguous()
    (idx, val), launches = run_counted(
        lambda: cstpu_torch.correlate_argmax(A, R))
    assert launches == expect_launches(corr_argmax=1), launches
    sval, sidx = ss.correlate_select_stream(A, Bs)
    torch.cuda.synchronize()
    assert torch.equal(idx, sidx) and torch.equal(val, sval)
    out["corr_argmax"] = launches["corr_argmax"]
    print(f"[main 5c f32] f32 correlation runs the CUDA-core sweeps: "
          f"omp_sharded_fused k={F32_STEPS} shards={s} select_stream "
          f"launches={out['omp']}, every pick planted, supports == plain "
          f"solve; ompr_sharded_fused recovery={rec:.3f} iters={iters[0]} "
          f"select_masked_stream launches={out['ompr']}, supports == plain "
          f"solve; "
          + "; ".join(f"{name}_sharded_fused recovery={rec:.3f} iters={it} "
                      f"select_topl_stream launches={out[name]}, supports == "
                      f"plain solve" for name, (it, rec, _) in topl.items())
          + f"; correlate_argmax launches={out['corr_argmax']}, == "
          f"select_stream's")
    return out


def sharded_times(A5c, Bs5c, Bones, gpu):
    """Solve times (CUDA events) and the profiler's split of the 5c paths;
    per-call times of the four stream kernels and their plain twins at
    5c's shapes (the wrapper and both launches included)."""
    import cstpu_torch
    from cstpu_torch.ops import corr_argmax as ca
    from cstpu_torch.ops import stream_select as ss
    from cstpu_torch.parallel import sharded as sh

    B, n, m, k = SHARD_CELLS["5c"]
    tm, split = {}, {}
    for s in (1, SHARDS):
        mesh = cstpu_torch.make_mesh((1, s))
        Ash = cstpu_torch.shard_dictionary(A5c, mesh)
        for fuse in (True, False):
            key = f"5c omp s={s} fuse={int(fuse)}"
            fn = lambda: cstpu_torch.omp_sharded_fused(
                Ash, Bs5c, k, mesh, fuse_collectives=fuse)
            tm[key] = cuda_ms(lambda: fn().val.sum(), TIMED_SOLVES)
            if fuse:
                split[key] = _split(tm[key], fn)
        if s == 1:
            tm["plain_5c omp s=1 fuse=1"] = cuda_ms(
                lambda: sh.omp_sharded_fused_ref(Ash, Bs5c, k,
                                                 mesh).val.sum(), TIMED_SLOW)
    tm["5b-rows omp_batch B=8"] = cuda_ms(
        lambda: cstpu_torch.omp_batch(A5c, Bs5c, k).val.sum(), TIMED_SOLVES)
    others = (
        ("mp", lambda f: f(Ash, Bones, k, mesh),
         cstpu_torch.mp_sharded_fused, sh.mp_sharded_fused_ref),
        ("gomp", lambda f: f(Ash, Bones, 4, k, mesh).val,
         cstpu_torch.gomp_sharded_fused, sh.gomp_sharded_fused_ref),
        ("ompr", lambda f: f(Ash, Bones, k, mesh, delta=1e-12).val,
         cstpu_torch.ompr_sharded_fused, sh.ompr_sharded_fused_ref),
        ("sp", lambda f: f(Ash, Bones, k, mesh, maxiter=8).val,
         cstpu_torch.sp_sharded_fused, sh.sp_sharded_fused_ref))
    for name, call, entry, ref in others:       # mesh, Ash: SHARDS shards
        key = f"5c {name} s={SHARDS}"
        tm[key] = cuda_ms(lambda: call(entry).sum(), TIMED_SLOW)
        tm["plain_" + key] = cuda_ms(lambda: call(ref).sum(), TIMED_SLOW)
        split[key] = _split(tm[key], lambda: call(entry))
    for key in split:
        sp_ = split[key]
        plain = tm.get("plain_" + key)
        print(f"[time {key}] {tm[key]:.4f} ms"
              + (f" (plain {plain:.4f})" if plain else "") + f" | {gpu}")
        print(f"[split {key}] wall {sp_['wall_ms']:.4f} ms, device busy "
              f"{sp_['device_busy_ms']:.4f} ms, idle share "
              f"{sp_['idle_share']:.4f}; "
              + ", ".join(f"{nm} {v['launches']}x {v['ms']:.4f} ms"
                          for nm, v in sp_["kernels"].items()))
    print("[time 5c] " + ", ".join(
        f"{key} {v:.4f} ms" for key, v in tm.items() if key not in split)
        + f" | {gpu}")

    # per-call times at the shapes of the paths
    bf = torch.bfloat16
    per = {}
    launches = partial(per_launch_ms, Bs5c)
    once = lambda fn: cuda_ms(lambda: fn()[0].flatten()[0], TIMED_SLOW)
    for ml in STREAM_WIDTHS:
        Ac = A5c[:, :ml].to(bf)
        M = torch.zeros((B, ml), device=A5c.device)
        M[:, :k] = -torch.inf
        RT = Bs5c.T.contiguous()
        for name, kern, plain in (
                ("select_stream", lambda: ss.correlate_select_stream(Ac, Bs5c),
                 lambda: ss.correlate_select_stream_ref(Ac, Bs5c)),
                ("select_masked_stream",
                 lambda: ss.correlate_select_masked_stream(Ac, Bs5c, M),
                 lambda: ss.correlate_select_masked_stream_ref(Ac, Bs5c, M)),
                ("select_topl_stream l=4",
                 lambda: ss.correlate_select_topl_stream(Ac, Bs5c, 4),
                 lambda: ss.correlate_select_topl_stream_ref(Ac, Bs5c, 4)),
                ("select_topl_stream l=32",
                 lambda: ss.correlate_select_topl_stream(Ac, Bs5c, 32),
                 lambda: ss.correlate_select_topl_stream_ref(Ac, Bs5c, 32)),
                ("corr_argmax", lambda: ca.correlate_argmax(Ac, RT),
                 lambda: ca.correlate_argmax_ref(Ac, RT))):
            per[(name, ml)] = launches(kern)
            per[("plain_" + name, ml)] = once(plain)
        # the top-1 selects above took the tensor-core sweep: its device
        # time (the wrapper may take longer than its three kernels), and
        # the CUDA-core sweep on the same inputs, the earlier time
        for name, call in (
                ("select_stream",
                 lambda **kw: ss.correlate_select_stream(Ac, Bs5c, **kw)),
                ("select_masked_stream",
                 lambda **kw: ss.correlate_select_masked_stream(Ac, Bs5c, M,
                                                                **kw)),
                ("corr_argmax", lambda **kw: ca.correlate_argmax(Ac, RT,
                                                                 **kw))):
            per[(name + " device", ml)] = device_ms_per_call(call)
            per[(name + " simt", ml)] = launches(lambda: call(mma=False))
        # the sweeps' yardstick: one f32 torch.matmul of the scores they
        # compute in their bodies, R . A_shard, the same product in bf16,
        # and for the top-l that bf16 GEMM followed by torch.topk over each
        # tile of 128
        Af, R32, Rb = Ac.float(), Bs5c.to(bf).float(), Bs5c.to(bf)
        per[("select_topl_stream gemm", ml)] = launches(
            lambda: torch.matmul(R32, Af))
        per[("select_topl_stream gemm bf16", ml)] = launches(
            lambda: torch.matmul(Rb, Ac))
        # the top-l: each variant on the device, its sweep and its finish
        # apart; the finish alone per call, and its plain twin
        bpt = ss._tile_of(Ac, "sharded_times") // 128
        for l in (4, 32):
            pre = f"select_topl_stream l={l}"
            per[(pre + " gemm topk", ml)] = launches(
                lambda: torch.matmul(Rb, Ac).view(B, ml // 128, 128).abs()
                .topk(l, dim=2))
            per[(pre + " simt", ml)] = launches(
                lambda: ss.correlate_select_topl_stream(Ac, Bs5c, l,
                                                        mma=False))
            for sfx, mma, sweep in ((" ", None, ("topl_mma", "round_rows")),
                                    (" simt ", False, ("stream_topl_simt",))):
                busy, got = profile_path(
                    lambda: ss.correlate_select_topl_stream(Ac, Bs5c, l,
                                                            mma=mma),
                    TIMED_LAUNCHES)
                ms = {nm: v[1] / TIMED_LAUNCHES for nm, v in got.items()}
                per[(pre + sfx + "device", ml)] = busy / TIMED_LAUNCHES
                per[(pre + sfx + "sweep device", ml)] = sum(
                    ms.get(nm, 0.0) for nm in sweep)
                per[(pre + sfx + "finish device", ml)] = ms.get(
                    "stream_topl_merge", 0.0) + ms.get("stream_topl_fold",
                                                        0.0)
            pv, pi = ss.stream_topl_sweep(Ac, Bs5c, l)
            per[(f"stream_topl_finish l={l}", ml)] = launches(
                lambda: ss.stream_topl_finish(pv, pi, bpt, l))
            per[(f"plain_stream_topl_finish l={l}", ml)] = once(
                lambda: ss.stream_topl_finish_ref(pv, pi, bpt, l))
        del Ac, M, Af
    # the CUDA-core sweeps of stream_select.cu (K6, K9, K10, K7, all on
    # simt_select.cuh) on the f32 dictionary (a column view of it at 32768,
    # lda = 131072), as the f32 paths run them: device ms a call (sweep and
    # finish) beside the f32 bound and one f32 torch.matmul R . A_shard; for
    # K7 also that matmul followed by torch.topk(l) a tile of 128
    simt = "simt_select.cuh"
    for ml in STREAM_WIDTHS:
        Af = A5c[:, :ml]
        M = torch.zeros((B, ml), device=A5c.device)
        M[:, :k] = -torch.inf
        RT = Bs5c.T.contiguous()
        lib = device_ms_per_call(lambda: torch.matmul(Bs5c, Af))
        per[("f32 gemm", ml)] = lib
        for l in (4, 32):
            per[(f"f32 gemm topk l={l}", ml)] = device_ms_per_call(
                lambda: torch.matmul(Bs5c, Af).view(B, ml // 128, 128).abs()
                .topk(l, dim=2))
        line = []
        for name, loop, call, bnd in (
                ("select_stream", simt, lambda: ss.correlate_select_stream(
                    Af, Bs5c), stream_bound(B, n, ml, 4)),
                ("select_masked_stream", simt,
                 lambda: ss.correlate_select_masked_stream(Af, Bs5c, M),
                 stream_bound(B, n, ml, 4, masked=True)),
                ("select_topl_stream l=4", simt,
                 lambda: ss.correlate_select_topl_stream(Af, Bs5c, 4),
                 stream_bound(B, n, ml, 4, l=4)),
                ("select_topl_stream l=32", simt,
                 lambda: ss.correlate_select_topl_stream(Af, Bs5c, 32),
                 stream_bound(B, n, ml, 4, l=32)),
                ("corr_argmax", simt, lambda: ca.correlate_argmax(Af, RT),
                 stream_bound(B, n, ml, 4))):
            ms = device_ms_per_call(call)
            per[(name + " f32 device", ml)] = ms
            per[(name + " f32 bound", ml)] = bnd["bound_ms"]
            topk = per.get((f"f32 gemm topk {name.split()[-1]}", ml))
            line.append(f"{name} on {loop} {ms4(ms)} (bound "
                        f"{bnd['bound_ms']:.4f} by {bnd['bound_by']}"
                        + (f", {ms / lib:.2f}x the matmul" if ms and lib
                           else "")
                        + (f", torch.matmul + torch.topk a tile "
                           f"{ms4(topk)}" + (f", {ms / topk:.2f}x it"
                                             if ms and topk else "")
                           if "topl" in name else "") + ")")
        print(f"[time f32 5c] CUDA-core sweeps of stream_select.cu, B={B} "
              f"n={n} m_local={ml} (lda {Af.stride(0)}), device ms a call: "
              + ", ".join(line) + f"; torch.matmul f32 {ms4(lib)} | {gpu}")
        del M
    for ml in STREAM_WIDTHS:
        print(f"[time stream kernels, ms per call at B={B}, n={n}, "
              f"m_local={ml}, bf16 (events, wrapper and both launches)] "
              + ", ".join(f"{name} {ms4(v)}" for (name, w), v in per.items()
                          if w == ml) + f" | {gpu}")
    return tm, split, per


def sharded_5m(dev, gpu):
    """Suite config 5m: omp_sharded_fused at m = 2^20 on one shard (the f32
    master copy sharded as a view, the bf16 copy cast once): recovery,
    launches, supports equal with both collective forms and to omp_batch's;
    solve time, the profiler's split and the sweep's time per call."""
    import cstpu_torch
    from cstpu_torch.ops import stream_select as ss

    B, n, m, k = SHARD_CELLS["5m"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    A = unit_dictionary(gen, n, m)
    Bs, sup = planted_pm1(gen, A, B, k)
    print(f"[5m] B={B} n={n} m={m} k={k}: f32 dictionary "
          f"{A.numel() * 4 / 2**30:.1f} GiB")
    paths = sharded_omp_path("5m", A, Bs, sup, (1,), plain=False)
    mesh = cstpu_torch.make_mesh((1, 1))
    Ash = cstpu_torch.shard_dictionary(A, mesh)
    fn = lambda: cstpu_torch.omp_sharded_fused(Ash, Bs, k, mesh)
    tm = {"5m omp s=1 fuse=1": cuda_ms(lambda: fn().val.sum(), TIMED_SLOW)}
    split = {"5m omp s=1 fuse=1": _split(tm["5m omp s=1 fuse=1"], fn)}
    tm["5m omp_batch B=8"] = cuda_ms(
        lambda: cstpu_torch.omp_batch(A, Bs, k).val.sum(), TIMED_SLOW)
    Ac = Ash.corr(torch.bfloat16)[0][0]
    sweep = per_launch_ms(Bs, lambda: ss.correlate_select_stream(Ac, Bs))
    sweep_simt = per_launch_ms(
        Bs, lambda: ss.correlate_select_stream(Ac, Bs, mma=False))
    peak = torch.cuda.max_memory_allocated() / 2**30
    # both sweeps against the plain twin at this width (the twin holds a
    # second f32 copy of the dictionary: after the peak is read)
    errs = {}
    want = ss.correlate_select_stream_ref(Ac, Bs)
    for name, mma in (("select_stream_mma", None), ("select_stream", False)):
        _hold(name, ss.correlate_select_stream(Ac, Bs, mma=mma), want,
              _clear_rows(ss._abs_scores(Ac, Bs)), errs)
    del want
    sp_ = split["5m omp s=1 fuse=1"]
    print(f"[time 5m] omp_sharded_fused {tm['5m omp s=1 fuse=1']:.4f} ms, "
          f"omp_batch on the same rows {tm['5m omp_batch B=8']:.4f} ms; "
          f"select_stream {sweep:.4f} ms per call (CUDA-core sweep "
          f"{sweep_simt:.4f}), both == plain twin, max |val err| "
          f"{errs['select_stream_mma']:.3e} and {errs['select_stream']:.3e}; "
          f"peak device memory {peak:.2f} GiB | {gpu}")
    print(f"[split 5m] wall {sp_['wall_ms']:.4f} ms, device busy "
          f"{sp_['device_busy_ms']:.4f} ms, idle share "
          f"{sp_['idle_share']:.4f}; "
          + ", ".join(f"{nm} {v['launches']}x {v['ms']:.4f} ms"
                      for nm, v in sp_["kernels"].items()))
    del A, Ash, Ac
    torch.cuda.empty_cache()
    return paths, tm, split, (sweep, sweep_simt), peak


# the forward-regression family on the sharded path: suite configs 3a, 3b
# (benchmarks/suite.py:186-220) and 3d (:239-265) at 5c's width; FR's and
# SRR's k, SRR's keyword arguments, then delta, kmax and planted k of RMP
# and FoBa; the row-sharded OMP's tall shape (n, m, k)
# SRR: 3b's maxiter=4 leaves two of the eight rows short of their planted
# support at this width (a replacement per iteration; srr_batch and the
# sharded solver alike), so the wide cell allows 16 and the rows take 7
FR5_K, FR5_DECAY = 16, 0.25
SRR5_KW = {"delta": 1e-12, "maxiter": 16}
STEP5 = (1e-2, 32, 16)
ROWS_CELL = (65536, 512, 16)


def fr_step_bound(B, n, m, cdt_bytes=2, use_v=False):
    """One fr_step_select: the shard (n, m) in cdt read once, resc (B, m)
    f32 read and written, R, W (and V) (B, n) f32, the column norms, the
    two index columns in and a (value, index) pair per row out; two
    products with the shard, three with V."""
    terms = 3 if use_v else 2
    nbytes = (n * m * cdt_bytes + 2 * B * m * 4 + terms * B * n * 4 + m * 4
              + B * 8 + B * 8)
    return bound(nbytes, 2 * terms * B * n * m,
                 "bf16" if cdt_bytes == 2 else "f32")


def check_fr_step_kernel(dev):
    """fr_step_select against its plain twin on the card at the sharded
    paths' shapes (B=8, n=1024, bf16 and f32, with and without V): a marked
    and a restored atom, a column repeated within and across tiles, a NaN
    row, an all-degenerate row, then one poisoned atom. Values to
    SELECT_RTOL, indices on the clear rows, the written-back resc to
    RESC_ATOL with its -1 marks and NaNs in the same places."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import stream_select as ss

    B, n = SHARD_CELLS["5c"][:2]
    deg = fs._degeneracy_rtol(n)
    errs = {"fr_step_select": 0.0, "fr_step_select_mma": 0.0, "resc": 0.0}
    for m in STREAM_WIDTHS:
        for cdt in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(SEED)
            A = torch.randn((n, m), device=dev, generator=gen)
            A = (A / A.norm(dim=0)).to(cdt)
            R = torch.randn((B, n), device=dev, generator=gen)
            W = 0.5 * torch.randn((B, n), device=dev, generator=gen) / n ** 0.5
            V = 0.5 * torch.randn((B, n), device=dev, generator=gen) / n ** 0.5
            tm = ss._stream_tile(m, n, A.element_size(),
                                 ss.STREAM_TILE_BYTES)
            a0, a1, a2 = 70, min(tm, m // 2) - 3, m - 5    # one column, thrice
            A[:, a1] = A[:, a0]
            A[:, a2] = A[:, a0]
            R[0] = A[:, a0].float() + 0.01 * R[0]
            R[1, 5] = float("nan")
            W[0] = V[0] = 0.0            # the tied row keeps equal rescalings
            W[3] = V[3] = 0.0
            il = torch.full((B, 2), -1, dtype=torch.int32, device=dev)
            il[4:6, 0] = 77                       # rows 4, 5 mark atom 77
            il[5:7, 1] = 40                       # rows 5, 6 restore atom 40
            for poisoned in (False, True):
                if poisoned:
                    best = int((ss._abs_scores(A, R[2:3])).argmax())
                    A[:, best] = float("nan")
                cn2 = torch.sum(A.float() ** 2, dim=0).nan_to_num(nan=1.0)
                resc0 = cn2.repeat(B, 1)
                resc0[:, 40] = -1.0               # an atom already active
                resc0[3] = 0.0                    # an all-degenerate row
                # bf16: the tensor-core variant (the paths') and the
                # CUDA-core one; f32: the CUDA-core one
                variants = ((("fr_step_select_mma", None),
                             ("fr_step_select", False))
                            if cdt == torch.bfloat16
                            else (("fr_step_select", None),))
                for (key, mma), use_v in itertools.product(variants,
                                                           (False, True)):
                    rk, rp = resc0.clone(), resc0.clone()
                    Vv = V if use_v else None
                    (kv, ki, _), counts = run_counted(
                        lambda: ss.fr_step_select(A, R, W, il, cn2, rk, deg,
                                                  V=Vv, mma=mma))
                    assert counts == expect_launches(**{key: 1}), counts
                    pv, pi, _ = ss.fr_step_select_ref(A, R, W, il, cn2, rp,
                                                      deg, V=Vv)
                    torch.cuda.synchronize()
                    q = R.to(cdt).float() @ A.float()
                    d2 = torch.where(rp > deg * cn2, q * q / rp, -torch.inf)
                    nan_tile = torch.isnan(d2.view(B, m // tm, tm)).any(dim=2)
                    live = torch.where(nan_tile[:, :, None], -torch.inf,
                                       d2.view(B, m // tm, tm)).view(B, m)
                    _hold(key, (kv, ki), (pv, pi), _clear_rows(live), errs)
                    assert torch.equal(rk == -1.0, rp == -1.0)
                    assert torch.equal(torch.isnan(rk), torch.isnan(rp))
                    rerr = float((rk - rp).nan_to_num(nan=0.0).abs().max())
                    assert rerr <= RESC_ATOL, rerr
                    errs["resc"] = max(errs["resc"], rerr)
                    # the built cases
                    assert int(ki[0]) == int(pi[0]) == a0
                    assert float(kv[1]) == float("-inf") and int(ki[1]) == 0
                    assert float(kv[3]) == float("-inf") and int(ki[3]) == 0
                    assert bool((rk[4:6, 77] == -1.0).all())
                    assert bool((rk[[0, 1, 2, 3, 6, 7], 77] != -1.0).all())
                    assert bool((rk[[0, 2, 4, 7], 40] < 0).all())
                    assert bool((rk[5:7, 40] > -1.0).all())
                    if poisoned:
                        assert bool(torch.isnan(rk[:, best]).all())
                        assert not bool((ki == best).any())
                # marking the lowest copy moves the tied row's pick on
                for _, mma in variants:
                    rk = resc0.clone()
                    rk[0, a0] = -1.0
                    _, ki, _ = ss.fr_step_select(A, R, W, il, cn2, rk, deg,
                                                 mma=mma)
                    assert int(ki[0]) == a1, int(ki[0])
            del A, R, W, V, resc0, rk, rp, q, d2, live
            torch.cuda.empty_cache()
    print("[fr_step kernel] K8 == plain twin at m_local in "
          f"{STREAM_WIDTHS}, bf16 (tensor-core and CUDA-core variants) and "
          "f32, with and without V: mark -> -1, "
          "restore on a zero base, ties -> lowest index within and across "
          "tiles, NaN row and all-degenerate row -> (-inf, 0), poisoned atom "
          "-> NaN resc, scored -inf; max |d2 err| "
          f"{errs['fr_step_select_mma']:.3e} (tensor cores), "
          f"{errs['fr_step_select']:.3e} (CUDA cores; rtol {SELECT_RTOL}), "
          f"max |resc err| {errs['resc']:.3e} (atol {RESC_ATOL})")
    return errs


def sharded_fr_paths(Ar, Br, sup):
    """fr_sharded_fused on the correlated dictionary at 5c's width, once per
    shard count and collective form with the launch counts zeroed just
    before: recovery 1.000, launches = shards x steps, supports equal across
    shard counts and forms, to the plain solve's and to fr_batch's."""
    import cstpu_torch
    from cstpu_torch.parallel import sharded as sh

    k = FR5_K
    out, first = {}, None
    for s in (1, SHARDS):
        mesh = cstpu_torch.make_mesh((1, s))
        Ash = cstpu_torch.shard_dictionary(Ar, mesh)
        for fuse in (True, False):
            (sol, steps), launches = run_counted(
                lambda: cstpu_torch.fr_sharded_fused(
                    Ash, Br, k, mesh, fuse_collectives=fuse,
                    return_iters=True))
            assert steps == [k], steps
            assert launches == expect_launches(fr_step_select_mma=s * k), \
                launches
            rec = recovery(sol, sup)
            assert rec == 1.0, f"fr s={s} fuse={fuse}: recovery {rec}"
            if first is None:
                first = sol
            assert torch.equal(sol.idx, first.idx), ("fr", s, fuse)
            cerr = float((sol.val - first.val).abs().max())
            assert cerr <= COEF_ATOL, cerr
            out[(s, fuse)] = {"launches": launches["fr_step_select_mma"],
                              "recovery": rec, "steps": steps[0]}
            print(f"[main 3a-wide] fr_sharded_fused shards={s} "
                  f"fuse_collectives={fuse} recovery={rec:.3f} steps={steps} "
                  f"fr_step_select_mma launches="
                  f"{launches['fr_step_select_mma']}; "
                  f"supports == first run, coefficients within {cerr:.3e}")
        ref = sh.fr_sharded_fused_ref(Ash, Br, k, mesh)
        assert _supports(ref) == _supports(first), ("fr", s, "plain")
        cerr = float((ref.val - first.val).abs().max())
        assert cerr <= COEF_ATOL, cerr
        print(f"[main 3a-wide] shards={s}: supports == plain solve, max "
              f"|coef err| {cerr:.3e} (atol {COEF_ATOL})")
        del Ash
    ub = cstpu_torch.fr_batch(Ar, Br, sparsity=k)
    assert _supports(ub) == _supports(first), "fr_batch"
    print("[main 3a-wide] supports == fr_batch's on the same rows")
    return out


def sharded_srr_rmp_foba_paths(Ar, Br, sup_r, A, Bo, sup_o):
    """srr_sharded_fused on the correlated dictionary and rmp/foba_sharded_
    fused on the unit-norm Gaussian one, m=131072, B=8, SHARDS shards, each
    once with the launch counts zeroed just before: launches against the
    sweeps run, recovery 1.000, no row capped, supports equal to the plain
    solve's and to srr/rmp/foba_batch's."""
    import cstpu_torch
    from cstpu_torch.parallel import sharded as sh

    s = SHARDS
    delta, kmax, _ = STEP5
    mesh = cstpu_torch.make_mesh((1, s))
    out = {}
    Ash = cstpu_torch.shard_dictionary(Ar, mesh)
    (sol, iters), launches = run_counted(
        lambda: cstpu_torch.srr_sharded_fused(Ash, Br, FR5_K, mesh, **SRR5_KW,
                                              return_iters=True))
    assert launches == expect_launches(
        select_topl_stream_mma=s, stream_topl_finish=s,
        fr_step_select_mma=s * iters[0]), launches
    rec = recovery(sol, sup_r)
    assert rec == 1.0, f"srr: recovery {rec}"
    plain, it_plain = sh.srr_sharded_fused_ref(Ash, Br, FR5_K, mesh,
                                               **SRR5_KW, return_iters=True)
    assert _supports(plain) == _supports(sol), "srr: plain solve"
    ub = cstpu_torch.srr_batch(Ar, Br, FR5_K, **SRR5_KW)
    assert _supports(ub) == _supports(sol), "srr: srr_batch"
    cerr = float((sol.val - plain.val).abs().max())
    assert cerr <= COEF_ATOL, ("srr", cerr)
    out["srr"] = {"launches": launches, "iters": iters[0],
                  "plain_iters": it_plain[0], "recovery": rec, "err": cerr}
    print(f"[main 3b-wide] srr_sharded_fused shards={s} recovery={rec:.3f} "
          f"iters={iters[0]} (plain {it_plain[0]}) launches="
          f"{ {key: v for key, v in launches.items() if v} }; supports == "
          f"plain solve == srr_batch, max |coef err| {cerr:.3e} "
          f"(atol {COEF_ATOL})")
    del Ash

    Ash = cstpu_torch.shard_dictionary(A, mesh)
    for name, entry, ref, unsharded in (
            ("rmp", cstpu_torch.rmp_sharded_fused, sh.rmp_sharded_fused_ref,
             lambda: cstpu_torch.rmp_batch(A, Bo, delta=delta, kmax=kmax)),
            ("foba", cstpu_torch.foba_sharded_fused,
             sh.foba_sharded_fused_ref,
             lambda: cstpu_torch.foba_batch(A, Bo, delta, kmax=kmax))):
        (sol, capped, counts), launches = run_counted(
            lambda: entry(Ash, Bo, delta, mesh, kmax=kmax, return_iters=True))
        sweeps, reads = counts[0]["sweeps"], counts[0]["flag_reads"]
        assert launches == expect_launches(fr_step_select_mma=s * sweeps), \
            launches
        rec = recovery(sol, sup_o)
        assert rec == 1.0, f"{name}: recovery {rec}"
        assert not bool(capped.any()), f"{name}: a row was capped"
        plain, pcapped = ref(Ash, Bo, delta, mesh, kmax=kmax)
        assert _supports(plain) == _supports(sol), f"{name}: plain solve"
        assert torch.equal(pcapped, capped)
        assert _supports(unsharded()) == _supports(sol), f"{name}: unsharded"
        cerr = float((sol.val - plain.val).abs().max())
        assert cerr <= COEF_ATOL, (name, cerr)
        out[name] = {"launches": launches, "sweeps": sweeps,
                     "flag_reads": reads, "recovery": rec, "err": cerr}
        print(f"[main 3d-wide {name}] {name}_sharded_fused shards={s} "
              f"recovery={rec:.3f} capped=0 sweeps={sweeps} host flag reads="
              f"{reads} fr_step_select_mma launches="
              f"{launches['fr_step_select_mma']}; supports == plain solve == "
              f"{name}_batch, max |coef err| {cerr:.3e} (atol {COEF_ATOL})")
    return out


def sharded_fr_f32_path(Ar, Br, sup):
    """fr_sharded_fused with f32 correlation on one shard and on SHARDS
    (column views of the dictionary) at 5c's width, and srr_sharded_fused
    on SHARDS (3b-wide's problem), each once with zeroed launch counts: true
    f32 stays on K8's CUDA-core sweep (with V in SRR); recovery, launches by
    the formulas, the plain f32 solve's supports. Returns {path:
    fr_step_select launches}."""
    import cstpu_torch
    from cstpu_torch.parallel import sharded as sh

    k, f32 = FR5_K, torch.float32
    out = {}
    for s in (1, SHARDS):
        mesh = cstpu_torch.make_mesh((1, s))
        Ash = cstpu_torch.shard_dictionary(Ar, mesh)
        sol, launches = run_counted(lambda: cstpu_torch.fr_sharded_fused(
            Ash, Br, k, mesh, corr_dtype=f32))
        assert launches == expect_launches(fr_step_select=s * k), launches
        rec = recovery(sol, sup)
        assert rec == 1.0, f"fr f32 s={s}: recovery {rec}"
        ref = sh.fr_sharded_fused_ref(Ash, Br, k, mesh, corr_dtype=f32)
        assert _supports(ref) == _supports(sol), ("fr f32: plain solve", s)
        out[f"fr_sharded_fused s={s} corr_dtype=f32"] = launches[
            "fr_step_select"]
        print(f"[main 3a-wide f32] fr_sharded_fused(corr_dtype=f32) shards="
              f"{s} recovery={rec:.3f} fr_step_select launches="
              f"{launches['fr_step_select']}: the CUDA-core sweep; supports "
              f"== plain solve")
    (sol, iters), launches = run_counted(
        lambda: cstpu_torch.srr_sharded_fused(Ash, Br, k, mesh, **SRR5_KW,
                                              corr_dtype=f32,
                                              return_iters=True))
    assert launches == expect_launches(
        select_topl_stream=SHARDS, stream_topl_finish=SHARDS,
        fr_step_select=SHARDS * iters[0]), launches
    rec = recovery(sol, sup)
    assert rec == 1.0, f"srr f32: recovery {rec}"
    ref = sh.srr_sharded_fused_ref(Ash, Br, k, mesh, **SRR5_KW,
                                   corr_dtype=f32)
    assert _supports(ref) == _supports(sol), "srr f32: plain solve"
    out[f"srr_sharded_fused s={SHARDS} corr_dtype=f32"] = launches[
        "fr_step_select"]
    print(f"[main 3b-wide f32] srr_sharded_fused(corr_dtype=f32) shards="
          f"{SHARDS} recovery={rec:.3f} iters={iters[0]} launches="
          f"{ {key: v for key, v in launches.items() if v} }: the CUDA-core "
          f"sweep with V; supports == plain solve")
    return out


def sharded_rows_path(dev):
    """omp_sharded_rows once at a tall shape on SHARDS row shards: the
    planted support recovered, the solution equal to omp_sharded's (the
    column-sharded plain solver) on the same problem. It runs no kernel."""
    import cstpu_torch

    n, m, k = ROWS_CELL
    gen = torch.Generator(device=dev).manual_seed(SEED)
    A = unit_dictionary(gen, n, m)
    b, sup = planted_pm1(gen, A, 1, k)
    mesh = cstpu_torch.make_mesh((1, SHARDS))
    sol, launches = run_counted(
        lambda: cstpu_torch.omp_sharded_rows(A, b[0], k, mesh))
    assert not any(launches.values()), launches
    ref = cstpu_torch.omp_sharded(A, b[0], k, mesh)
    assert torch.equal(sol.idx, ref.idx) and torch.equal(sol.mask, ref.mask)
    assert sorted(sol.idx.tolist()) == sorted(sup[0].tolist())
    cerr = float((sol.val - ref.val).abs().max())
    assert cerr <= COEF_ATOL, cerr
    ms = cuda_ms(lambda: cstpu_torch.omp_sharded_rows(A, b[0], k,
                                                      mesh).val.sum(),
                 TIMED_SLOW)
    print(f"[main rows] omp_sharded_rows n={n} m={m} k={k} on {SHARDS} row "
          f"shards: support == planted == omp_sharded's, max |coef err| "
          f"{cerr:.3e} (atol {COEF_ATOL}); {ms:.4f} ms per solve")
    return {"ms": ms, "err": cerr}


def sharded_fr_times(Ar, Br, A, Bo, gpu):
    """Solve times (CUDA events) and the profiler's split of the sharded
    forward-regression paths; per-call times of fr_step_select and its
    plain twin, with and without V, at the two shard widths (the wrapper and
    both launches included)."""
    import cstpu_torch
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import stream_select as ss
    from cstpu_torch.parallel import sharded as sh

    B, n = Br.shape
    k = FR5_K
    delta, kmax, _ = STEP5
    tm, split = {}, {}
    for s in (1, SHARDS):
        mesh = cstpu_torch.make_mesh((1, s))
        Ash = cstpu_torch.shard_dictionary(Ar, mesh)
        for fuse in (True, False):
            key = f"3a-wide fr s={s} fuse={int(fuse)}"
            fn = lambda: cstpu_torch.fr_sharded_fused(
                Ash, Br, k, mesh, fuse_collectives=fuse)
            tm[key] = cuda_ms(lambda: fn().val.sum(), TIMED_SOLVES)
            if fuse:
                split[key] = _split(tm[key], fn)
        if s == 1:
            tm["plain_3a-wide fr s=1 fuse=1"] = cuda_ms(
                lambda: sh.fr_sharded_fused_ref(Ash, Br, k, mesh).val.sum(),
                TIMED_SLOW)
    tm["3a-wide fr_batch B=8"] = cuda_ms(
        lambda: cstpu_torch.fr_batch(Ar, Br, sparsity=k).val.sum(),
        TIMED_SOLVES)
    key = f"3b-wide srr s={SHARDS}"          # mesh, Ash: SHARDS shards of Ar
    fn = lambda: cstpu_torch.srr_sharded_fused(Ash, Br, k, mesh, **SRR5_KW)
    tm[key] = cuda_ms(lambda: fn().val.sum(), TIMED_SLOW)
    tm["plain_" + key] = cuda_ms(
        lambda: sh.srr_sharded_fused_ref(Ash, Br, k, mesh,
                                         **SRR5_KW).val.sum(), TIMED_SLOW)
    split[key] = _split(tm[key], fn)
    tm["3b-wide srr_batch B=8"] = cuda_ms(
        lambda: cstpu_torch.srr_batch(Ar, Br, k, **SRR5_KW).val.sum(),
        TIMED_SLOW)
    del Ash
    Ash = cstpu_torch.shard_dictionary(A, mesh)
    for name, entry, ref, unsharded in (
            ("rmp", cstpu_torch.rmp_sharded_fused, sh.rmp_sharded_fused_ref,
             lambda: cstpu_torch.rmp_batch(A, Bo, delta=delta, kmax=kmax)),
            ("foba", cstpu_torch.foba_sharded_fused,
             sh.foba_sharded_fused_ref,
             lambda: cstpu_torch.foba_batch(A, Bo, delta, kmax=kmax))):
        key = f"3d-wide {name} s={SHARDS}"
        fn = lambda: entry(Ash, Bo, delta, mesh, kmax=kmax)
        tm[key] = cuda_ms(lambda: fn()[0].val.sum(), TIMED_SLOW)
        tm["plain_" + key] = cuda_ms(
            lambda: ref(Ash, Bo, delta, mesh, kmax=kmax)[0].val.sum(),
            TIMED_SLOW)
        split[key] = _split(tm[key], fn)
        tm[f"3d-wide {name}_batch B=8"] = cuda_ms(
            lambda: unsharded().val.sum(), TIMED_SLOW)
    for key in split:
        sp_ = split[key]
        plain = tm.get("plain_" + key)
        print(f"[time {key}] {tm[key]:.4f} ms"
              + (f" (plain {plain:.4f})" if plain else "") + f" | {gpu}")
        print(f"[split {key}] wall {sp_['wall_ms']:.4f} ms, device busy "
              f"{sp_['device_busy_ms']:.4f} ms, idle share "
              f"{sp_['idle_share']:.4f}; "
              + ", ".join(f"{nm} {v['launches']}x {v['ms']:.4f} ms"
                          for nm, v in sp_["kernels"].items()))
    print("[time fr family] " + ", ".join(
        f"{key} {v:.4f} ms" for key, v in tm.items() if key not in split)
        + f" | {gpu}")

    # per-call times at the shapes of the paths
    bf = torch.bfloat16
    per = {}
    deg = fs._degeneracy_rtol(n)
    il = torch.full((B, 2), -1, dtype=torch.int32, device=Ar.device)
    W = Br / n ** 0.5
    launches = partial(per_launch_ms, Br)
    once = lambda fn: cuda_ms(lambda: fn()[0].flatten()[0], TIMED_SLOW)
    for ml in STREAM_WIDTHS:
        Ac = Ar[:, :ml].to(bf)
        Af = Ac.float()
        cn2 = torch.sum(Ar[:, :ml] ** 2, dim=0)
        resc = cn2.repeat(B, 1)
        for name, V in (("fr_step_select", None), ("fr_step_select V", W)):
            # resc is reset by no one between the calls: it only drifts
            # down by z^2 each call, far from the threshold in 100 calls
            call = partial(ss.fr_step_select, Ac, Br, 1e-2 * W, il, cn2, resc,
                           deg, V=V)
            per[(name, ml)] = launches(call)
            per[("plain_" + name, ml)] = once(
                lambda: ss.fr_step_select_ref(Ac, Br, 1e-2 * W, il, cn2, resc,
                                              deg, V=V))
            # the tensor-core sweep's device time, the CUDA-core sweep on
            # the same inputs, and one f32 torch.matmul of the products the
            # sweep computes, [R; W (; V)] . A_shard
            per[(name + " device", ml)] = device_ms_per_call(call)
            per[(name + " simt", ml)] = launches(lambda: call(mma=False))
            RWb = torch.cat([Br, 1e-2 * W]
                            + ([V] if V is not None else [])).to(bf)
            RW = RWb.float()
            per[(name + " gemm", ml)] = launches(lambda: torch.matmul(RW, Af))
            per[(name + " gemm bf16", ml)] = launches(
                lambda: torch.matmul(RWb, Ac))
        del Ac, Af, resc
    # the CUDA-core sweep on the f32 path's shard (the whole dictionary at
    # 131072, a column view of it at 32768, lda = 131072) on the device,
    # beside the parent's time, its f32 bound and one f32 torch.matmul of
    # its products
    for ml in STREAM_WIDTHS:
        Af = Ar[:, :ml]
        cn2 = torch.sum(Af * Af, dim=0)
        resc = cn2.repeat(B, 1)
        for name, V in (("fr_step_select", None), ("fr_step_select V", W)):
            call = partial(ss.fr_step_select, Af, Br, 1e-2 * W, il, cn2, resc,
                           deg, V=V)
            prods = torch.cat([Br, 1e-2 * W] + ([V] if V is not None else []))
            per[(name + " f32 device", ml)] = device_ms_per_call(call)
            per[(name + " f32 gemm", ml)] = device_ms_per_call(
                lambda: torch.matmul(prods, Af))
            print(f"[time f32 3a-wide] {name}, CUDA cores, B={B} n={n} "
                  f"m_local={ml} (lda {Af.stride(0)}): " + f32_line(
                      per[(name + " f32 device", ml)],
                      F32_BEFORE_MS[f"{name} {ml}"],
                      fr_step_bound(B, n, ml, cdt_bytes=4,
                                    use_v=V is not None),
                      per[(name + " f32 gemm", ml)]) + f" | {gpu}")
        del resc
    for ml in STREAM_WIDTHS:
        print(f"[time fr_step kernel, ms per call at B={B}, n={n}, "
              f"m_local={ml}, bf16 (events, wrapper and both launches)] "
              + ", ".join(f"{name} {ms4(v)}" for (name, w), v in per.items()
                          if w == ml) + f" | {gpu}")
    return tm, split, per


# the SBL family, suite configs 4 (benchmarks/suite.py:297-331: B, n, m, k,
# the sigmas) and 4e (:334-392: B, n, k, sigma, the widths). cstpu has no
# TPU kernel for it: the port runs tensor operations and cuSOLVER's
# factorizations, and this phase holds its results, not a kernel's.
SBL4_CELL = (8, 128, 512, 6, (1e-2, 3e-2))
SBL4E_CELL = (8, 1024, 16, 1e-2, (131072, 1 << 20))
# the sharded route against the single-device body, and four shards
# against one: cstpu's own tolerance (tests/test_sharded.py:468,484)
SBL_ATOL = 1e-4


def top_device_ops(fn, top=4):
    """One call of fn under torch.profiler (the caller has warmed it up),
    device activity only: (device busy ms, the union of the device spans;
    the `top` device operations by summed ms as (name, count, ms), all of
    them where top is None). The raw
    kineto records are read, not `prof.events()`: a noise-learning solve
    leaves some 10^6 of them, whose event tree takes minutes to build."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, per = [], {}
    for ev in prof.profiler.kineto_results.events():
        if (ev.device_type() != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", lambda: False)()):
            continue
        t0, t1 = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        spans.append((t0, t1))
        cnt, ns = per.get(ev.name(), (0, 0))
        per[ev.name()] = (cnt + 1, ns + t1 - t0)
    ops = sorted(per.items(), key=lambda kv: -kv[1][1])
    if top is not None:
        ops = ops[:top]
    return union_ms(spans) / 1e6, [(name[:60], c, ns / 1e6)
                                   for name, (c, ns) in ops]


def sbl_recovery(X, sup, sigma):
    """Share of rows whose planted support lies inside {|x| > sigma}."""
    return float((X.abs() > sigma).gather(1, sup).all(1).float().mean())


def _timed(fn):
    """(fn(), ms): one call bracketed by CUDA events, synced by a value
    fetch."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    res = fn()
    t1.record()
    float((res[0] if isinstance(res, tuple) else res).abs().sum())
    return res, t0.elapsed_time(t1)


def sbl_solve(key, fn, sigma, sup, reps, out, profile=True):
    """fn() once with the loop counts set to 0 just before and read just
    after: recovery 1.000, finite, on the card. Its time is the median of
    `reps` more calls (with reps=0, of that one; the solves compile
    nothing, and earlier solves warmed the libraries up), each bracketed by
    CUDA events and synced by a value fetch; then, with `profile`, one
    profiled call's device busy time, idle share and top operations. fn
    returns x (B, m) or a tuple that starts with it; returns the first
    call's result."""
    from cstpu_torch.models import sbl as sb

    t_start = time.perf_counter()
    for c in sb.LOOP_COUNTS:
        sb.LOOP_COUNTS[c] = 0
    res, first_ms = _timed(fn)
    counts = dict(sb.LOOP_COUNTS)
    X = res[0] if isinstance(res, tuple) else res
    rec = sbl_recovery(X, sup, sigma)
    assert X.is_cuda, (key, X.device)
    assert not bool(torch.isnan(X).any()), f"{key}: NaN in x"
    assert rec == 1.0, f"{key}: recovery {rec} < 1.0"
    times = [_timed(fn)[1] for _ in range(reps)] or [first_ms]
    ms = statistics.median(times)
    busy, ops = top_device_ops(fn) if profile else (None, [])
    assert busy is None or busy > 0, f"{key}: no device time in the profile"
    idle = None if busy is None else 1.0 - busy / ms
    out[key] = {"recovery": rec, "ms": ms, "calls_timed": len(times),
                "device_busy_ms": busy, "idle_share": idle,
                **counts, "top_ops": [[n, c, t] for n, c, t in ops]}
    split = ("device busy not profiled" if busy is None else
             f"device busy {busy:.4f} ms, idle share {idle:.4f}")
    print(f"[sbl {key}] recovery {rec:.3f}, x on {X.device}, no NaN; "
          f"{ms:.4f} ms (median of {len(times)}, events), {split}; steps "
          f"{counts['steps']}, latch reads {counts['latch_reads']}; top: "
          + ", ".join(f"{n} {c}x {t:.4f} ms" for n, c, t in ops)
          + f"; {time.perf_counter() - t_start:.1f} s")
    return res


def sbl_paths(dev, gpu):
    """The [sbl] phase: config 4's four batched entry points at both sigmas
    (fsbl_batch's and rmps_batch's sharded route held against the
    single-device body on the same card tensors), the traced solvers on
    one row, and config 4e's fsbl_batch and rmps_batch at both widths
    (at 131072 also fsbl_sharded and rmps_sharded on four shards, held
    against one)."""
    import cstpu_torch
    from cstpu_torch.models import sbl as sb
    from cstpu_torch.utils.data import perturb

    out = {}
    t0 = time.perf_counter()
    B, n, m, k, sigmas = SBL4_CELL
    gen = torch.Generator(device=dev).manual_seed(SEED)
    A = unit_dictionary(gen, n, m)
    Bs, sup = planted_ones(gen, A, B, k)
    print(f"[sbl] config 4: B={B} n={n} m={m} k={k}, sigma in {sigmas}; "
          f"config 4e: B={SBL4E_CELL[0]} n={SBL4E_CELL[1]} "
          f"k={SBL4E_CELL[2]} sigma={SBL4E_CELL[3]} at m in "
          f"{SBL4E_CELL[4]}; no kernel: tensor operations and cuSOLVER")
    agree = {}
    for sigma in sigmas:
        Y = perturb(gen, Bs, sigma)
        s2 = sigma ** 2
        tag = f"4 sigma={sigma:g}"
        xf = sbl_solve(f"{tag} fsbl_batch",
                       lambda: cstpu_torch.fsbl_batch(A, Y, s2), sigma, sup,
                       TIMED_SOLVES, out)
        xr = sbl_solve(f"{tag} rmps_batch",
                       lambda: cstpu_torch.rmps_batch(A, Y, s2), sigma, sup,
                       TIMED_SOLVES, out)
        sbl_solve(f"{tag} sbl_batch",
                  lambda: cstpu_torch.sbl_batch(A, Y, s2), sigma, sup,
                  TIMED_SLOW, out)
        # noise learning under the reference's Inverse-Gamma(1, sigma^2)
        # prior (its test/sbl.jl:29-40): under the flat default prior the
        # EM drives sigma^2 to 0, and in f32 through it on some rows, in
        # cstpu as here (ROADMAP.md Queue 3). Profiled at the first sigma
        # only: a solve leaves ~10^6 device records, whose profile takes
        # three times the solve
        _, s2_est = sbl_solve(
            f"{tag} rmps_estimate_noise_batch",
            lambda: cstpu_torch.rmps_estimate_noise_batch(
                A, Y, s2, a_sigma2=1.0, b_sigma2=s2),
            sigma, sup, 0, out, profile=sigma == sigmas[0])
        assert bool((s2_est > 0).all()), (tag, s2_est)
        out[f"{tag} noise sigma2"] = s2_est.tolist()
        print(f"[sbl {tag} noise] sigma^2 estimates (prior a=1, b=sigma^2) "
              + ", ".join(f"{v:.3e}" for v in s2_est.tolist()))
        # the sharded route against the batched single-device body
        for name, got, want in (
                ("fsbl", xf, sb._fsbl_rows(A, Y, s2)[0]),
                ("rmps", xr, sb._rmps_rows(A, Y, s2))):
            err = float((got - want).abs().max())
            assert err <= SBL_ATOL, (tag, name, err)
            agree[f"{tag} {name}"] = err
        sbl_solve(f"{tag} fsbl_traced row 0",
                  lambda: cstpu_torch.fsbl_traced(A, Y[0], s2)[0][None],
                  sigma, sup[:1], TIMED_SLOW, out)
        sbl_solve(f"{tag} rmps_traced row 0",
                  lambda: cstpu_torch.rmps_traced(A, Y[0], s2)[0][None],
                  sigma, sup[:1], TIMED_SLOW, out)
        _, tr = cstpu_torch.fsbl_traced(A, Y[0], s2)
        _, rtr = cstpu_torch.rmps_traced(A, Y[0], s2)
        acted = tr.action >= 0
        ran = rtr.n_active > 0
        print(f"[sbl {tag} traces] fsbl_traced: {int(acted.sum())} actions "
              f"(adds {int((tr.action == 0).sum())}, deletes "
              f"{int((tr.action == 1).sum())}, re-estimates "
              f"{int((tr.action == 2).sum())}), last n_active "
              f"{int(tr.n_active[acted][-1])}; rmps_traced: "
              f"{int(ran.sum())} outer iterations, added "
              f"{rtr.n_added[ran].tolist()}, deleted "
              f"{rtr.n_deleted[ran].tolist()}, updated "
              f"{rtr.n_updated[ran].tolist()}")
    print(f"[sbl 4] fsbl_batch and rmps_batch (the atom-sharded route on a "
          f"one-shard mesh) == the batched single-device body on the same "
          f"card tensors, max |err| "
          + ", ".join(f"{key} {v:.3e}" for key, v in agree.items())
          + f" (atol {SBL_ATOL}); {time.perf_counter() - t0:.1f} s | {gpu}")
    del A, Bs, Y
    torch.cuda.empty_cache()

    B, n, k, sigma, widths = SBL4E_CELL
    s2 = sigma ** 2
    shards = {}
    for m in widths:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        A = unit_dictionary(gen, n, m)
        Bs, sup = planted_ones(gen, A, B, k)
        Y = perturb(gen, Bs, sigma)
        tag = f"4e m={m}"
        xf = sbl_solve(f"{tag} fsbl_batch",
                       lambda: cstpu_torch.fsbl_batch(A, Y, s2,
                                                      maxiter=4 * k),
                       sigma, sup, TIMED_SLOW, out)
        xr = sbl_solve(f"{tag} rmps_batch",
                       lambda: cstpu_torch.rmps_batch(A, Y, s2), sigma, sup,
                       TIMED_SLOW, out)
        if m == widths[0]:
            mesh = cstpu_torch.make_mesh((1, SHARDS))
            Ash = cstpu_torch.shard_dictionary(A, mesh)
            for name, one, fn in (
                    ("fsbl", xf, lambda: cstpu_torch.parallel.fsbl_sharded(
                        Ash, Y, s2, mesh, maxiter=4 * k)),
                    ("rmps", xr, lambda: cstpu_torch.parallel.rmps_sharded(
                        Ash, Y, s2, mesh))):
                got = sbl_solve(f"{tag} {name}_sharded s={SHARDS}", fn,
                                sigma, sup, TIMED_SLOW, out)
                err = float((got - one).abs().max())
                same = bool(((got.abs() > sigma) == (one.abs() > sigma))
                            .all())
                assert same and err <= SBL_ATOL, (tag, name, same, err)
                shards[f"{tag} {name}"] = err
            del Ash
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[f"{tag} peak_gib"] = peak
        print(f"[sbl {tag}] done in {time.perf_counter() - t0:.1f} s, peak "
              f"device memory {peak:.2f} GiB | {gpu}")
        del A, Bs, Y, xf, xr
        torch.cuda.empty_cache()
    print(f"[sbl 4e] fsbl_sharded and rmps_sharded on {SHARDS} shards == "
          f"one shard (fsbl_batch, rmps_batch): supports {{|x| > sigma}} "
          f"equal on every row, max |err| "
          + ", ".join(f"{key} {v:.3e}" for key, v in shards.items())
          + f" (atol {SBL_ATOL})")
    out["agree_single_device"] = agree
    out["agree_shards"] = shards
    return out



# [convex]: benchmarks/suite.py configs 5 (:395-422: bp_ard_sharded, n=128,
# k=6, m=1024 a shard), 5bpd (:514-566: the BPD family, n=1024, m=131072,
# k=32, delta=1e-2, y = b + noise of norm delta/2) and 5ard (:569-634: ARD
# BP at m=2^20, a 4 GB f32 dictionary, one shard), and the oracle at
# tests/conftest.py's sizes. cstpu's convex family has no TPU kernel: the
# port runs tensor operations (cuBLAS GEMVs, cuSOLVER factorizations) in
# host loops, and this phase holds its results, not a kernel's.
CONVEX5_CELL = (128, 6, 1024)          # n, k, m a shard
BPD5_CELL = (1024, 131072, 32, 1e-2)   # n, m, k, delta
ARD5_CELL = (1024, 1 << 20, 32)        # n, m, k
# the ARD solvers' reweightings: the suite runs 4 (benchmarks/suite.py:411,
# :543); here the depth is cut to 2, which halves the phase's longest solves
ARD_REWEIGHTS = 2
# 5bpd's ADMM solves (bpd_sharded, bpd_ard's reweightings): the suite caps
# them at 12000 iterations (:542-546), which bpd_sharded and bpd_ard's first
# reweighting reach; here at 3000 (the planted atoms stand at |x| >= 0.98,
# delta 1e-2; the profile of a 12000-iteration solve took ~36 s)
BPD_ADMM_ITERS = 3000
ORACLE_CELL = (32, 48, 3)              # n, m, k: C(48, 3) = 17296
CONVEX_ATOL = 1e-4     # one shard against four (cstpu: tests/test_sharded.py)
CONVEX_SUP = 1e-3      # recovery {|x| > 1e-3} (suite configs 5 and 5ard)
BALL_RTOL = 1e-5       # the certified bodies: ||Ax - y|| <= delta (1 + 1e-5)
OBJ_RTOL = 0.05        # bpd's l1 objective within 5% of the exact path's
STREAM_RTOL = 0.02     # measured_stream_gbps against a 4 GB GEMV's rate


def convex_solve(key, fn, reps, out, host=False, device_op=None):
    """fn() once with the loop counts set to 0 just before and read just
    after (its result is returned and checked by the caller), then `reps`
    calls each bracketed by CUDA events and synced by a value fetch (their
    median is the wall; where the first call took over a second, it is
    the one timed call: the solves compile nothing, and earlier solves
    warmed the libraries up), then one profiled call: its
    device busy time (the union of the device spans), idle share and top
    device operations. fn returns x or a tuple that starts with it. A
    `host` solve (the native C++ solvers) may leave no device time. Where
    `device_op` is given, a device operation whose name holds it must show
    in the profile (profiled again, up to 4 tries, where the profiler lost
    the records: a `[profile] try N` line)."""
    from cstpu_torch.models import basis_pursuit as cbp

    t_start = time.perf_counter()
    for c in cbp.LOOP_COUNTS:
        cbp.LOOP_COUNTS[c] = 0
    res, first_ms = _timed(fn)
    counts = dict(cbp.LOOP_COUNTS)
    x = res[0] if isinstance(res, tuple) else res
    assert x.is_cuda, (key, x.device)
    times = ([first_ms] if first_ms > 1e3 else
             [_timed(fn)[1] for _ in range(reps)])
    ms = statistics.median(times)
    for attempt in range(4):
        busy, ops = top_device_ops(fn, top=None)
        if device_op is None or any(device_op in n for n, _, _ in ops):
            break
        print(f"[profile] try {attempt + 2}: no {device_op!r} device "
              f"operation in {key}'s profile ({len(ops)} names)")
    else:
        raise AssertionError(f"{key}: no {device_op!r} device operation in "
                             "4 profiles")
    ops = ops[:4]
    assert busy > 0 or host, f"{key}: no device time in the profile"
    out[key] = {"ms": ms, "calls_timed": len(times), "device_busy_ms": busy,
                "idle_share": 1.0 - busy / ms, **counts,
                "top_ops": [[n, c, t] for n, c, t in ops]}
    print(f"[convex {key}] {ms:.3f} ms (median of {len(times)}, events), "
          f"device busy {busy:.3f} ms, idle share {1.0 - busy / ms:.4f}; "
          f"iterations {counts['iterations']}, latch reads "
          f"{counts['latch_reads']}, graph replays {counts['replays']}; top: "
          + ", ".join(f"{n} {c}x {t:.3f} ms" for n, c, t in ops)
          + f"; {time.perf_counter() - t_start:.1f} s")
    return res


def _recovered(x, sup, thr):
    """Every planted atom lies in {|x| > thr}; x finite."""
    assert bool(torch.isfinite(x).all()), "x not finite"
    got = set(torch.nonzero(x.abs() > thr)[:, 0].tolist())
    return set(sup.tolist()) <= got, len(got)


def _residual64(A, x, y):
    """||A x - y|| in float64 over x's nonzeros (exact for a sparse x; no
    float64 copy of the dictionary)."""
    nz = torch.nonzero(x)[:, 0]
    fit = A[:, nz].double() @ x[nz].double()
    return float(torch.linalg.vector_norm(fit - y.double()))


def convex_paths(dev, gpu):
    """The [convex] phase: suite config 5 on one shard and four, the
    single-device convex family on config 5's one-shard dictionary, config
    5bpd's five BPD solves, config 5ard on one shard, and the oracle on
    the card against the CPU."""
    import cstpu_torch
    import cstpu_torch.utils.profiling
    from cstpu_torch import native
    from cstpu_torch.models import basis_pursuit as cbp
    from cstpu_torch.parallel import convex as pcv
    from cstpu_torch.utils.data import perturb

    out, agree = {}, {}
    t0 = time.perf_counter()
    tb = time.perf_counter()
    lib = native._build()
    print(f"[convex] native library (g++ {' '.join(native.CXX_FLAGS)}) "
          f"{lib.rsplit('/', 1)[-1]} in {time.perf_counter() - tb:.1f} s; "
          "no kernel: host loops over cuBLAS GEMVs and cuSOLVER "
          f"factorizations | {gpu}")

    # --- config 5: n=128, k=6, one planted b ---------------------------
    n, k, m1 = CONVEX5_CELL
    gen = torch.Generator(device=dev).manual_seed(SEED)
    A4, Bs, sup = planted(gen, 1, n, SHARDS * m1, k)
    b4, sup4 = Bs[0], sup[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    A1, Bs, sup = planted(gen, 1, n, m1, k)
    b1, sup1 = Bs[0], sup[0]
    mesh1 = cstpu_torch.make_mesh((1, 1))
    mesh4 = cstpu_torch.make_mesh((1, SHARDS))
    print(f"[convex] config 5: n={n} k={k}, m={m1} on one shard and "
          f"m={SHARDS * m1} on {SHARDS}")
    checks = {}
    xs = {}
    for key, fn, sup_ in (
            (f"5 bp_ard_sharded m={m1} s=1",
             lambda: cstpu_torch.parallel.bp_ard_sharded(
                 A1, b1, mesh1, eps=1e-2, maxiter=ARD_REWEIGHTS), sup1),
            (f"5 bp_ard_sharded m={SHARDS * m1} s={SHARDS}",
             lambda: cstpu_torch.parallel.bp_ard_sharded(
                 A4, b4, mesh4, eps=1e-2, maxiter=ARD_REWEIGHTS),
             sup4),
            (f"5 bp_sharded m={SHARDS * m1} s=1",
             lambda: cstpu_torch.parallel.bp_sharded(A4, b4, mesh=mesh1)[0],
             sup4),
            (f"5 bp_sharded m={SHARDS * m1} s={SHARDS}",
             lambda: cstpu_torch.parallel.bp_sharded(A4, b4, mesh=mesh4)[0],
             sup4)):
        x = convex_solve(key, fn, TIMED_SLOW, out)
        ok, nnz = _recovered(x, sup_, CONVEX_SUP)
        assert ok, f"{key}: planted atoms not recovered"
        checks[key] = nnz
        xs[key] = x
    one = xs[f"5 bp_sharded m={SHARDS * m1} s=1"]
    four = xs[f"5 bp_sharded m={SHARDS * m1} s={SHARDS}"]
    err = float((one - four).abs().max())
    same = bool(((one.abs() > CONVEX_SUP) == (four.abs() > CONVEX_SUP)).all())
    assert same and err <= CONVEX_ATOL, ("5 bp_sharded 1 vs 4", same, err)
    agree["5 bp_sharded s=1 vs s=4"] = err

    # the single-device family on the one-shard dictionary
    delta = 1e-2
    y1 = perturb(gen, b1, delta / 2)
    xbp = convex_solve(f"5 bp m={m1}", lambda: cstpu_torch.bp(A1, b1),
                       TIMED_SLOW, out)
    sup_bp = torch.nonzero(xbp.abs() > CONVEX_SUP)[:, 0]
    assert _recovered(xbp, sup1, CONVEX_SUP)[0], "5 bp: not recovered"
    for key, fn in (
            ("bp_candes", lambda: cstpu_torch.bp_candes(A1, b1)),
            ("bp_ard", lambda: cstpu_torch.bp_ard(A1, b1)),
            ("bp simplex", lambda: cstpu_torch.bp(A1, b1, method="simplex")),
            ("ista", lambda: cstpu_torch.ista(A1, b1, 1e-3, stepsize=None)),
            ("fista", lambda: cstpu_torch.fista(A1, b1, 1e-3,
                                                stepsize=None))):
        x = convex_solve(f"5 {key} m={m1}", fn, TIMED_SLOW, out,
                         host=key == "bp simplex")
        ok, nnz = _recovered(x, sup1, CONVEX_SUP)
        assert ok, f"5 {key}: planted atoms not recovered"
        if key.startswith(("ista", "fista")):
            # the LASSO's largest entries are bp's support
            top = torch.topk(x.abs(), len(sup_bp)).indices
            same = set(top.tolist()) == set(sup_bp.tolist())
        else:
            same = torch.equal(torch.nonzero(x.abs() > CONVEX_SUP)[:, 0],
                               sup_bp)
        assert same, f"5 {key}: support differs from bp's"
        checks[f"5 {key}"] = nnz
    xsec, info = convex_solve(
        f"5 bpd m={m1}",
        lambda: cstpu_torch.bpd(A1, y1, delta, return_info=True),
        TIMED_SLOW, out)
    xhom, hinfo = convex_solve(
        f"5 bpd homotopy m={m1}",
        lambda: cstpu_torch.bpd(A1, y1, delta, method="homotopy",
                                return_info=True), TIMED_SLOW, out,
        host=True)
    # the homotopy's exact boundary point, cast to f32, may round a few
    # ulps outside (its own flag then reads False); both are held to the
    # ball below
    assert info["feasible"], info
    obj, hobj = float(xsec.abs().sum()), float(xhom.abs().sum())
    assert obj <= hobj * (1.0 + OBJ_RTOL) + 1e-3, ("5 bpd objective", obj,
                                                   hobj)
    for key, x in (("bpd", xsec), ("bpd homotopy", xhom)):
        r = _residual64(A1, x, y1) / delta
        assert r <= 1.0 + BALL_RTOL, (key, r)
        assert _recovered(x, sup1, delta)[0], f"5 {key}: not recovered"
        out[f"5 {key} m={m1}"]["feas_over_delta"] = r
    # the loops' CUDA graphs against the same loops launched one kernel at
    # a time, on the ADMM bodies of bp and bpd (Woodbury form)
    graphs = {}
    for key, fn in (("bp", lambda: cstpu_torch.bp(A1, b1)),
                    ("bpd admm", lambda: cstpu_torch.bpd(
                        A1, y1, delta, method="admm",
                        on_infeasible="raw"))):
        latched = cbp._latched
        cbp._latched = partial(latched, graphs=False)
        try:
            eager = fn()
        finally:
            cbp._latched = latched
        gerr = float((fn() - eager).abs().max())
        assert gerr <= CONVEX_ATOL, (f"5 {key} graphs vs eager", gerr)
        graphs[key] = gerr
    agree.update({f"5 {key} graphs vs eager": v for key, v in graphs.items()})
    print(f"[convex 5] recovery {{|x| > {CONVEX_SUP}}} includes the planted "
          f"atoms on every solve (nnz "
          + ", ".join(f"{key} {v}" for key, v in checks.items())
          + f"); bp_sharded on {SHARDS} shards == one shard, max |err| "
          f"{err:.3e} (atol {CONVEX_ATOL}); the bp family's supports == "
          f"bp's; bpd l1 {obj:.6f} against the exact path's {hobj:.6f} "
          f"(within {OBJ_RTOL:g}), ||Ax - y|| / delta "
          f"{out[f'5 bpd m={m1}']['feas_over_delta']:.6f} and "
          f"{out[f'5 bpd homotopy m={m1}']['feas_over_delta']:.6f} "
          f"(homotopy's flag {hinfo['feasible']}); the loops replayed as "
          "CUDA graphs == launched one kernel at a time, max |err| "
          + ", ".join(f"{key} {v:.3e}" for key, v in graphs.items())
          + f"; "
          f"{time.perf_counter() - t0:.1f} s | {gpu}")
    del A1, A4

    # --- config 5bpd: n=1024, m=131072, k=32 ---------------------------
    t1 = time.perf_counter()
    n, m, k, delta = BPD5_CELL
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    A, Bs, sup = planted(gen, 1, n, m, k)
    b, sup = Bs[0], sup[0]
    y = perturb(gen, b, delta / 2)
    print(f"[convex] config 5bpd: n={n} m={m} k={k} delta={delta:g}")
    feas = {}
    for key, fn, certified in (
            ("bpd", lambda: cstpu_torch.bpd(A, y, delta, maxiter=12000),
             True),
            ("bpd_ard", lambda: cstpu_torch.bpd_ard(
                A, y, delta, maxiter=ARD_REWEIGHTS,
                maxiter_admm=BPD_ADMM_ITERS), False),
            ("bpd_sharded", lambda: cstpu_torch.parallel.bpd_sharded(
                A, y, delta, mesh=mesh1, maxiter=BPD_ADMM_ITERS)[0], False),
            ("bpd_secant_sharded",
             lambda: cstpu_torch.parallel.bpd_secant_sharded(
                 A, y, delta, mesh=mesh1), True),
            ("bpd_ard secant screened", lambda: cstpu_torch.bpd_ard(
                A, y, delta, maxiter=ARD_REWEIGHTS, method="secant",
                screen=True),
             False)):
        x = convex_solve(f"5bpd {key}", fn, 1, out)
        ok, nnz = _recovered(x, sup, delta)
        assert ok, f"5bpd {key}: planted atoms not recovered"
        r = _residual64(A, x, y) / delta
        if certified:
            assert r <= 1.0 + BALL_RTOL, (f"5bpd {key}", r)
        feas[key] = r
        out[f"5bpd {key}"].update(feas_over_delta=r, nnz_gt_delta=nnz)
    print(f"[convex 5bpd] recovery {{|x| > delta}} includes the planted "
          "atoms on all five; ||Ax - y|| / delta: "
          + ", ".join(f"{key} {v:.6f}" for key, v in feas.items())
          + f" (asserted <= 1 + {BALL_RTOL:g} on the certified bpd and "
          f"bpd_secant_sharded; the rest reported: cstpu's raw ADMM "
          f"iterate and 1.05 delta fallback); "
          f"{time.perf_counter() - t1:.1f} s | {gpu}")
    del A, Bs
    torch.cuda.empty_cache()

    # --- config 5ard: n=1024, m=2^20 (4 GB f32), one shard --------------
    t2 = time.perf_counter()
    n, m, k = ARD5_CELL
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    A = unit_dictionary(gen, n, m)
    Bs, sup = planted_ones(gen, A, 1, k)
    b, sup = Bs[0], sup[0]
    gbps = cstpu_torch.utils.profiling.measured_stream_gbps()
    # the calibration must read at least what one of the solve's own 4 GB
    # GEMV passes (r'A, the ARD loop's) streams, within the spread of one
    # call, before any roofline fraction divides by it
    r = torch.randn((n,), device=dev, generator=gen)
    gemv_ms = min(_timed(lambda: r @ A)[1] for _ in range(5))
    gemv_gbps = A.numel() * 4 / gemv_ms / 1e6
    out["stream_gbps"], out["gemv_gbps"] = gbps, gemv_gbps
    assert gbps >= gemv_gbps * (1.0 - STREAM_RTOL), ("stream rate", gbps,
                                                     gemv_gbps)
    del r
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()   # the solve's peak, A included
    print(f"[convex] config 5ard: n={n} m={m} k={k}, one shard "
          f"({A.numel() * 4 / 2**30:.1f} GiB f32); the card streams "
          f"{gbps:.1f} GB/s (utils.profiling.measured_stream_gbps; "
          f"{HBM_BYTES_PER_S / 1e9:.0f} by the data sheet), one r'A GEMV "
          f"pass {gemv_ms:.4f} ms = {gemv_gbps:.1f} GB/s")
    kw = dict(eps=1e-2, maxiter=ARD_REWEIGHTS, maxiter_admm=2000, tol=3e-6,
              admm_chunk=2000)
    x = convex_solve("5ard bp_ard_sharded",
                     lambda: cstpu_torch.parallel.bp_ard_sharded(
                         A, b, mesh1, **kw), 1, out)
    ok, nnz = _recovered(x, sup, CONVEX_SUP)
    assert ok, "5ard: planted atoms not recovered"
    nb = float(torch.linalg.vector_norm(b.double()))
    raw = _residual64(A, x, b) / nb
    xp = cstpu_torch.polish(A, b, x, tol=CONVEX_SUP)
    pol = _residual64(A, xp, b) / nb
    peak = torch.cuda.max_memory_allocated() / 2**30
    out["5ard bp_ard_sharded"].update(
        feasibility_admm=raw, feasibility_polished=pol, nnz_1e3=nnz,
        peak_gib=peak, whiten_lean=m * n * 4 > pcv._WHITEN_BYTES_MAX)
    print(f"[convex 5ard] recovery {{|x| > {CONVEX_SUP}}} includes the "
          f"{k} planted atoms (nnz {nnz}); ||Ax - b|| / ||b|| raw "
          f"{raw:.3e}, after polish {pol:.3e}; peak device memory "
          f"{peak:.2f} GiB; {time.perf_counter() - t2:.1f} s | {gpu}")
    del A, Bs, x, xp
    torch.cuda.empty_cache()

    # --- the oracle: exhaustive at n=32, m=48, k=3 -----------------------
    n, m, k = ORACLE_CELL
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    A, Bs, sup = planted(gen, 1, n, m, k)
    yo = perturb(gen, Bs[0], 1e-2)
    got = convex_solve(
        f"oracle exhaustive n={n} m={m} k={k}",
        lambda: torch.as_tensor(cstpu_torch.exhaustive(A, yo, k),
                                device=dev), TIMED_SLOW, out,
        device_op="svd")
    cpu = cstpu_torch.exhaustive(A.cpu(), yo.cpu(), k)
    assert got.tolist() == cpu.tolist(), (got, cpu)
    assert got.tolist() == sorted(sup[0].tolist()), (got, sup)
    print(f"[convex oracle] exhaustive on the card == on the CPU == the "
          f"planted support {got.tolist()} ({math.comb(m, k)} candidates; "
          "their batched SVD ran on the card: cuSOLVER's batched Jacobi "
          "kernels in the profile)")
    out["agree_shards"] = agree
    print(f"[convex] done in {time.perf_counter() - t0:.1f} s | {gpu}")
    return out


# --------------------------------------------------------------------------
# [distributed] and [examples]
# --------------------------------------------------------------------------

# The sharded solvers over a (1, SHARDS) mesh that spans DIST_PROCS
# processes on the one card (gloo over localhost; NCCL refuses two
# processes on one card), each process holding SHARDS / DIST_PROCS shards
# that it makes itself (shard_global's callback form): suite config 5c
# (benchmarks/suite.py:447-465: B=8, n=1024, m=131072, k=32, bf16
# correlation) for omp (both collective forms), gomp and ompr, config 3a
# widened to 5c's width for fr, config 4e's rmps at m=131072 (k=16, sigma
# 1e-2) on 5c's dictionary, and config 5's bp at m=4096 (n=128, k=6). Each
# is held bit for bit against the same solve over the one-process (1,
# SHARDS) mesh on the same card. The dictionaries are made shard by shard
# from a seed of their own (the kinds of the earlier phases: unit-norm
# Gaussian, correlated_data's spectrum), so that no process holds another's.
DIST_PROCS = 2
DIST_SEED = SEED + 1000
# bp's ADMM iterations on the spanning mesh (it converges in ~3200, ~8 ms
# an iteration with the exchanges): the depth is cut to this many
DIST_BP_MAXITER = 1024
DIST_TIMEOUT_S = 300    # a worker's own limit (the phase takes ~1 min)
BP5_CELL = (128, 4096, 6)               # n, m, k: suite config 5 at 4 shards
EXAMPLE_TIMEOUT_S = 300


def dist_shard(seed, n, ml, j, dev, decay=None):
    """Shard j (n, ml) of a [distributed] dictionary from its own seed:
    unit-norm Gaussian columns, or with `decay` correlated_data's (U
    diag(1/i^decay)) V with U (n, n) shared by every shard."""
    gen = torch.Generator(device=dev).manual_seed(seed + 1 + j)
    A = torch.randn((n, ml), generator=gen, device=dev)
    if decay is not None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        U = torch.randn((n, n), generator=gen, device=dev)
        A = (U / torch.arange(1, n + 1, device=dev) ** decay) @ A
    A /= torch.linalg.vector_norm(A, dim=0, keepdim=True)
    return A


def dist_kinds():
    """(seed, n, m, decay) of the phase's three dictionaries: 5c's
    unit-norm Gaussian, 3a-wide's correlated one, config 5's."""
    _, n, m, _ = SHARD_CELLS["5c"]
    return ((DIST_SEED, n, m, None), (DIST_SEED + 100, n, m, FR5_DECAY),
            (DIST_SEED + 200, BP5_CELL[0], BP5_CELL[1], None))


def dist_dictionaries(mesh, dev):
    """The phase's three dictionaries over `mesh`, each process making its
    own shards only: (A5, Ar5, Abp) as ShardedDictionary."""
    from cstpu_torch.parallel import distributed as dist

    def place(seed, n, m, decay):
        ml = m // SHARDS
        return dist.shard_global(
            lambda index: dist_shard(seed, n, ml, index[1].start // ml, dev,
                                     decay),
            mesh, (None, "atoms"), global_shape=(n, m))

    return tuple(place(*kind) for kind in dist_kinds())


def dist_problem(dev):
    """The measurements of the phase, planted on the whole dictionaries
    (made here once from the same shards, then freed)."""
    from cstpu_torch.utils.data import perturb

    gen = torch.Generator(device=dev).manual_seed(DIST_SEED)
    B, _, _, k = SHARD_CELLS["5c"]
    A5, Ar5, Abp = (torch.cat([dist_shard(seed, n, m // SHARDS, j, dev, decay)
                               for j in range(SHARDS)], dim=1)
                    for seed, n, m, decay in dist_kinds())
    prob = {}
    prob["Bs5"], prob["sup5"] = planted_pm1(gen, A5, B, k)
    prob["Bones"], prob["sup_ones"] = planted_ones(gen, A5, B, k)
    prob["Br"], prob["supr"] = planted_ones(gen, Ar5, B, FR5_K)
    b4e, prob["sup4e"] = planted_ones(gen, A5, B, SBL4E_CELL[2])
    prob["Y4e"] = perturb(gen, b4e, SBL4E_CELL[3])
    bbp, supbp = planted_pm1(gen, Abp, 1, BP5_CELL[2])
    prob["bbp"], prob["supbp"] = bbp[0], supbp[0]
    return prob


def _first_tensor(res):
    """The first tensor of a solver's result (a value to fetch)."""
    if isinstance(res, torch.Tensor):
        return res
    if isinstance(res, (tuple, list)):
        return _first_tensor(res[0])
    return res.val


def dist_solves(mesh, prob, dev):
    """The phase's solves over `mesh`, each once with the launch and loop
    counts set to 0 just before and read just after (its result is the
    one returned), then once bracketed by CUDA events and synced by a value
    fetch (for bp, whose solve takes seconds, that first call is the timed
    one: every process of the mesh makes the same calls), then once under
    torch.profiler for its device busy time. Over a mesh that spans
    processes the time in the mesh's exchanges during the timed call (gloo
    and the host copies around it; the device is synced before each, so
    that its queued work is not counted) is summed too. Returns ({key:
    result}, {key: stats})."""
    import cstpu_torch
    from cstpu_torch.models import basis_pursuit as cbp
    from cstpu_torch.models import sbl as sb
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.parallel.mesh import Mesh

    A5, Ar5, Abp = dist_dictionaries(mesh, dev)
    k = SHARD_CELLS["5c"][3]
    s2 = SBL4E_CELL[3] ** 2
    par = cstpu_torch.parallel
    solves = (
        ("5c omp fuse=1", lambda: par.omp_sharded_fused(
            A5, prob["Bs5"], k, mesh, fuse_collectives=True,
            return_iters=True)),
        ("5c omp fuse=0", lambda: par.omp_sharded_fused(
            A5, prob["Bs5"], k, mesh, fuse_collectives=False,
            return_iters=True)),
        ("5c gomp", lambda: par.gomp_sharded_fused(
            A5, prob["Bones"], 4, k, mesh, return_iters=True)),
        ("5c ompr", lambda: par.ompr_sharded_fused(
            A5, prob["Bones"], k, mesh, delta=1e-12, return_iters=True)),
        ("3a-wide fr", lambda: par.fr_sharded_fused(
            Ar5, prob["Br"], FR5_K, mesh, return_iters=True)),
        ("4e rmps", lambda: par.rmps_sharded(A5, prob["Y4e"], s2, mesh)),
        ("5 bp", lambda: par.bp_sharded(Abp, prob["bbp"], mesh=mesh,
                                        maxiter=DIST_BP_MAXITER)[0]),
    )
    spent = [0.0]
    exchange = Mesh._exchange

    def timed_exchange(self, xs, home, row):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return exchange(self, xs, home, row)
        finally:
            spent[0] += time.perf_counter() - t0

    results, stats = {}, {}
    Mesh._exchange = timed_exchange
    try:
        for key, fn in solves:
            for counts in (fs.LAUNCHES, cbp.LOOP_COUNTS, sb.LOOP_COUNTS):
                for c in counts:
                    counts[c] = 0

            def counted(res):
                torch.cuda.synchronize()
                return res, {
                    "launches": {c: v for c, v in fs.LAUNCHES.items() if v},
                    "loop": dict(cbp.LOOP_COUNTS) if key == "5 bp" else
                    dict(sb.LOOP_COUNTS) if key == "4e rmps" else {}}

            slow = key == "5 bp"
            if not slow:
                res, st = counted(fn())
            spent[0] = 0.0
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn()
            t1.record()
            float(_first_tensor(out).float().sum())
            ms, ex_ms = t0.elapsed_time(t1), spent[0] * 1e3
            if slow:
                res, st = counted(out)
            st.update(ms=ms, exchange_ms=ex_ms)
            busy, _ = top_device_ops(fn)
            st.update(device_busy_ms=busy, idle_share=1.0 - busy / ms,
                      exchange_share=ex_ms / ms)
            results[key], stats[key] = res, st
    finally:
        Mesh._exchange = exchange
    return results, stats


def _to_cpu(res):
    if isinstance(res, torch.Tensor):
        return res.cpu()
    if isinstance(res, (tuple, list)):
        return type(res)(_to_cpu(x) for x in res)
    if hasattr(res, "idx"):
        return {"idx": res.idx.cpu(), "val": res.val.cpu(),
                "mask": res.mask.cpu()}
    return res


def dist_worker(argv):
    """One process of the [distributed] phase:

        python3 chip_smoke.py --dist-worker RANK PORT DIR

    joins the group at localhost:PORT, builds the process-spanning mesh
    over its SHARDS / DIST_PROCS shards on cuda:0, reads the measurements
    from DIR/problem.pt and writes its results (rankR.pt) and counts and
    times (rankR.json) there."""
    import os

    from cstpu_torch.parallel import distributed as dist

    rank, port, out = int(argv[0]), int(argv[1]), argv[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.initialize(f"localhost:{port}", DIST_PROCS, rank)
    mesh = dist.global_mesh(devices=[dev] * (SHARDS // DIST_PROCS))
    assert mesh.row_spans(0) and mesh.stage, mesh
    prob = torch.load(os.path.join(out, "problem.pt"), map_location=dev)
    results, stats = dist_solves(mesh, prob, dev)
    torch.save({key: _to_cpu(v) for key, v in results.items()},
               os.path.join(out, f"rank{rank}.pt"))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"local_shards": list(mesh.local(0)), "stats": stats}, f)
    torch.distributed.destroy_process_group()
    return 0


def _same_bits(a, b):
    """Every tensor of two results equal entry by entry (NaN where NaN)."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and (
            torch.equal(a, b) or (a.is_floating_point()
                                  and torch.equal(a.isnan(), b.isnan())
                                  and torch.equal(a.nan_to_num(),
                                                  b.nan_to_num())))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[x], b[x])
                                            for x in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_same_bits, a, b))
    return a == b


def distributed_paths(dev, gpu):
    """The [distributed] phase: the one-process (1, SHARDS) mesh's solves
    here, then the same solves in DIST_PROCS worker processes over a mesh
    that spans them, held bit for bit against these; recovery; each
    worker's launches = its shards x steps; times."""
    import os
    import socket
    import tempfile

    import cstpu_torch

    t_start = time.perf_counter()
    prob = dist_problem(dev)
    one = cstpu_torch.make_mesh((1, SHARDS))
    ref, ref_stats = dist_solves(one, prob, dev)
    ref = {key: _to_cpu(v) for key, v in ref.items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_start

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(prob, os.path.join(tmp, "problem.pt"))
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=here)
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(DIST_PROCS)]
        procs = []
        for r in range(DIST_PROCS):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--dist-worker", str(r), str(port), tmp],
                    cwd=here, env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DIST_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:     # the workers started here, nothing else
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for path in logs:
            with open(path) as f:
                texts.append(f.read())
        for r, p in enumerate(procs):
            assert p.returncode == 0, (
                f"[distributed] worker {r} exited {p.returncode} (a "
                f"negative code: killed past its {DIST_TIMEOUT_S} s)\n"
                + texts[r][-6000:])
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
               for r in range(DIST_PROCS)]
        meta = []
        for r in range(DIST_PROCS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                meta.append(json.load(f))
    t_workers = time.perf_counter() - t_start - t_ref

    _, _, m, k = SHARD_CELLS["5c"]
    local = SHARDS // DIST_PROCS
    out = {"ref": ref_stats, "workers": [x["stats"] for x in meta]}
    for key in ref:
        for r in range(DIST_PROCS):
            assert _same_bits(got[r][key], ref[key]), (
                f"[distributed] {key}: worker {r} differs from the "
                f"one-process mesh")
        res = ref[key]
        if key == "4e rmps":
            rec = sbl_recovery(res.to(dev), prob["sup4e"], SBL4E_CELL[3])
            assert rec == 1.0, (key, rec)
        elif key == "5 bp":
            ok, _ = _recovered(res.to(dev), prob["supbp"], CONVEX_SUP)
            assert ok, key
        else:
            sol, iters = res
            sup = {"5c omp fuse=1": "sup5", "5c omp fuse=0": "sup5",
                   "3a-wide fr": "supr"}.get(key, "sup_ones")
            sol = cstpu_torch.SparseSolution(sol["idx"], sol["val"],
                                             sol["mask"], m)
            rec = recovery(sol, prob[sup])
            assert rec == 1.0, (key, rec)
            it = iters[0]
            want = {"5c omp fuse=1": {"select_stream_mma": it},
                    "5c omp fuse=0": {"select_stream_mma": it},
                    "5c gomp": {"select_topl_stream_mma": it,
                                "stream_topl_finish": it},
                    "5c ompr": {"select_topl_stream_mma": 1,
                                "stream_topl_finish": 1,
                                "select_masked_stream_mma": it},
                    "3a-wide fr": {"fr_step_select_mma": it}}[key]
            for shards, stats in ((SHARDS, ref_stats),
                                  *((local, x["stats"]) for x in meta)):
                assert stats[key]["launches"] == {
                    c: shards * v for c, v in want.items()}, (
                    key, shards, stats[key]["launches"])
        for x in meta:
            loop = x["stats"][key]["loop"]
            assert loop == ref_stats[key]["loop"] or (
                key == "5 bp" and loop["replays"] == 0
                and {c: v for c, v in loop.items() if c != "replays"}
                == {c: v for c, v in ref_stats[key]["loop"].items()
                    if c != "replays"}), (key, loop, ref_stats[key]["loop"])
        w = [x["stats"][key] for x in meta]
        print(f"[distributed {key}] bit-equal to the one-process (1, "
              f"{SHARDS}) mesh on both workers ("
              + ", ".join(f"{c} {v}" for c, v in (
                  ref_stats[key]["launches"] or ref_stats[key]["loop"])
                  .items())
              + " one-process); one-process "
              f"{ref_stats[key]['ms']:.3f} ms (busy "
              f"{ref_stats[key]['device_busy_ms']:.3f}); workers "
              + "; ".join(
                  f"{r}: {x['ms']:.3f} ms (events, value fetch), busy "
                  f"{x['device_busy_ms']:.3f} ms, idle share "
                  f"{x['idle_share']:.4f}, exchanges {x['exchange_ms']:.3f} "
                  f"ms = {x['exchange_share']:.4f} of the wall"
                  for r, x in enumerate(w)) + f" | {gpu}")
    print(f"[distributed] {DIST_PROCS} processes x {local} shards on the "
          f"one card (gloo over localhost), local shards "
          f"{[x['local_shards'] for x in meta]}: every solve bit-equal, "
          f"recovery 1.000, launches = shards x steps; one-process solves "
          f"{t_ref:.1f} s, workers {t_workers:.1f} s | {gpu}")
    out["seconds"] = {"one_process": t_ref, "workers": t_workers}
    return out


def examples_paths(gpu):
    """The [examples] phase: examples/torch/0*.py on the card, each in a
    process of its own: exit code 0 and a last line OK."""
    import glob
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    scripts = sorted(glob.glob(os.path.join(here, "examples", "torch",
                                            "0*.py")))
    assert len(scripts) == 5, scripts
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, script], cwd=here, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for script in scripts]
    out, texts = {}, []
    try:
        for p in procs:     # all five at once, each in its own process
            texts.append(p.communicate(timeout=max(
                EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0), 1.0)))
            out[os.path.basename(p.args[1])] = time.perf_counter() - t0
    finally:
        for p in procs:     # the processes started here, nothing else
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (stdout, stderr) in zip(procs, texts):
        name = os.path.basename(p.args[1])
        assert p.returncode == 0, (
            f"[examples] {name} exited {p.returncode}\n{stdout[-3000:]}\n"
            f"{stderr[-3000:]}")
        last = stdout.rstrip().splitlines()[-1]
        assert last == "OK", (name, last)
        print(f"[examples] {name} on the card: rc 0, last line OK, done "
              f"{out[name]:.1f} s after the five started | {gpu}")
    return out


# --------------------------------------------------------------------------
# [surface]: every public name of cstpu_torch and cstpu_torch.parallel on
# the card (benchmarks/tpu_smoke.py's tables, extended)
# --------------------------------------------------------------------------

SURFACE_DELTA = 1e-2
SURFACE_SEED = 123


def _same_support(card, cpu):
    """agree: the card's and the CPU's supports, row for row."""
    return _rows_of(card) == _rows_of(cpu)


class SurfaceCase(NamedTuple):
    """One case of the [surface] phase: `run(P)` calls the public names in
    `covers` on the problems P of one device (`surface_problems`);
    `check(P, out)` is its oracle, (ok, detail); `agree(card, cpu)` holds
    the card's result against the CPU's: supports (`_same_support`), which
    may part at a near-tie where the oracle holds on both, or numbers,
    which must agree; None: the oracle on both (the generators draw other
    numbers on each). `keys`: launch counts the call must take on the card
    (a key or its "_mma" variant)."""
    name: str
    covers: tuple
    run: object
    check: object
    agree: object = _same_support
    keys: tuple = ()


def surface_problems(dev):
    """tpu_smoke's problems, made with numpy from SURFACE_SEED and put on
    `dev` in f32: a 3-sparse +-1 signal on a unit-norm (64, 96) dictionary
    with b and y = b + noise of norm delta/2; the same on a square (64, 64)
    one (the backward family); eight rows of 3 planted ones on (64, 128)
    and on (128, 128) (the batched kernels' small corner); eight 3-sparse
    +-1 rows on (64, 256) (the sharded solvers, two shards of 128); 16
    atoms of the first with 3 planted (exhaustive)."""
    import numpy as np

    rng = np.random.default_rng(SURFACE_SEED)
    d = SURFACE_DELTA

    def unit(n, m):
        A = rng.standard_normal((n, m))
        return A / np.linalg.norm(A, axis=0)

    def planted(m, k, ones=False):
        sup = np.sort(rng.choice(m, k, replace=False))
        x = np.zeros(m)
        x[sup] = 1.0 if ones else rng.choice([-1.0, 1.0], k)
        return x, sup

    def noisy(b):
        e = rng.standard_normal(b.shape)
        return b + e * (d / 2) / np.linalg.norm(e)

    A, As, A2, A3, Ash = (unit(64, 96), unit(64, 64), unit(64, 128),
                          unit(128, 128), unit(64, 256))
    x, sup = planted(96, 3)
    xs, sups = planted(64, 3)
    X2, sup2 = zip(*(planted(128, 3, ones=True) for _ in range(8)))
    Xsh, supsh = zip(*(planted(256, 3) for _ in range(8)))
    x16 = np.zeros(16)
    x16[[2, 5, 9]] = 1.0
    X2, Xsh = np.stack(X2), np.stack(Xsh)
    b, bs = A @ x, As @ xs
    P = {"A": A, "b": b, "y": noisy(b), "As": As, "bs": bs, "ys": noisy(bs),
         "A2": A2, "Bs2": X2 @ A2.T, "A3": A3, "Bs3": X2 @ A3.T, "Ash": Ash,
         "Bsh": Xsh @ Ash.T, "A16": A[:, :16], "b16": A[:, :16] @ x16}
    P = {key: torch.tensor(v, dtype=torch.float32, device=dev)
         for key, v in P.items()}
    P.update(dev=torch.device(dev), sup=sup.tolist(), sups=sups.tolist(),
             sup2=[s.tolist() for s in sup2],
             supsh=[s.tolist() for s in supsh], sup16=[2, 5, 9])
    return P


def _f64(x):
    """x in f64: a tensor, or (a problem's numpy copy) an array."""
    return x.double() if isinstance(x, torch.Tensor) else x.astype("float64")


def _minus(x, y):
    """x - y with y (a tensor, or a problem's numpy copy) where x lies."""
    return x - torch.as_tensor(y, device=x.device)


def _columns(X):
    """X transposed, contiguous: (B, n) rows as the (n, B) columns."""
    import numpy as np

    return (X.T.contiguous() if isinstance(X, torch.Tensor)
            else np.ascontiguousarray(X.T))


def surface_numpy(P):
    """The problems P as numpy copies (what a cstpu user passes): the
    arrays on the host, the device and the supports as they are."""
    return {key: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for key, v in P.items()}


def _gen(P, seed=7):
    return torch.Generator(device=P["dev"]).manual_seed(seed)


def _mesh2(P):
    import cstpu_torch

    return cstpu_torch.make_mesh((1, 2), devices=[P["dev"]])


def _sol(out):
    """The solution of a call's result: a tuple's first entry."""
    return out[0] if isinstance(out, tuple) else out


def _rows_of(out):
    """Per row the sorted active atoms of a (batched) SparseSolution, or of
    a dense x above 10 delta; a 1-D result is one row."""
    out = _sol(out)
    if hasattr(out, "mask"):
        idx = torch.where(out.mask, out.idx, -1).reshape(
            -1, out.idx.shape[-1]).cpu().tolist()
        return [sorted(i for i in row if i >= 0) for row in idx]
    x = torch.as_tensor(out).detach().float().cpu().reshape(
        -1, out.shape[-1])
    return [sorted(torch.nonzero(row.abs() > 10 * SURFACE_DELTA).flatten()
                   .tolist()) for row in x]


def _dense_rows(out):
    out = _sol(out)
    x = out.todense() if hasattr(out, "todense") else torch.as_tensor(out)
    return x.reshape(-1, x.shape[-1]).float()


def _planted_check(key, held, what):
    """The oracle: `held(planted, got)` on every row; the detail shows a
    single row's support, or how many rows hold."""
    def check(P, out):
        want = P[key] if isinstance(P[key][0], list) else [P[key]]
        got = _rows_of(out)
        rows = sum(held(w, g) for w, g in zip(want, got))
        ok = rows == len(want) == len(got)
        return ok, (f"support={got[0]}" if len(want) == 1
                    else f"{rows}/{len(want)} rows {what}")
    return check


def _exact(key):
    """Every row's support equals the planted one."""
    return _planted_check(key, lambda w, g: w == g, "recovered exactly")


def _superset(key):
    """Every row's support holds the planted one."""
    return _planted_check(key, lambda w, g: set(w) <= set(g),
                          "hold the planted atoms")


def _fit(akey, ykey):
    """The oracle: finite, and ||A x - y|| < 3 delta on every row."""
    def check(P, out):
        x = _dense_rows(out)
        Y = P[ykey].reshape(-1, P[akey].shape[0])
        r = torch.linalg.norm(x @ P[akey].T - Y, dim=1)
        ok = bool(torch.isfinite(x).all()) and bool(
            (r < 3 * SURFACE_DELTA).all())
        return ok, f"resid={float(r.max()):.2e}"
    return check


def _both(*checks):
    def check(P, out):
        res = [c(P, out) for c in checks]
        return all(ok for ok, _ in res), "; ".join(d for _, d in res)
    return check


def _close(rtol=1e-4, atol=1e-5):
    """agree: the results' tensors close (numbers, tuples of them)."""
    def agree(card, cpu):
        a = card if isinstance(card, (tuple, list)) else (card,)
        b = cpu if isinstance(cpu, (tuple, list)) else (cpu,)
        return all(torch.allclose(torch.as_tensor(x).double().cpu(),
                                  torch.as_tensor(y).double().cpu(),
                                  rtol=rtol, atol=atol)
                   for x, y in zip(a, b))
    return agree


def _is(kind, what="result"):
    return lambda P, out: (isinstance(out, kind), f"{what} "
                           f"{type(out).__name__}")


def surface_cases():
    """The [surface] table: every name of cstpu_torch.__all__ and
    cstpu_torch.parallel.__all__ in at least one case's `covers`."""
    import cstpu_torch as ct
    import cstpu_torch.parallel as cp

    d = SURFACE_DELTA
    s2 = d ** 2
    C = SurfaceCase
    ex, sup_s, sup_2, sup_h = (_exact("sup"), _exact("sups"),
                               _superset("sup2"), _superset("supsh"))
    fit, fit_h = _fit("A", "y"), _fit("Ash", "Bsh")

    def traced(fn, trace):
        return lambda P, out: (
            isinstance(out[1], trace) and fn(P, out[0])[0],
            f"{fn(P, out[0])[1]}, {type(out[1]).__name__}")

    cases = [
        # per-instance solvers at n=64, m=96 (square 64 x 64 backward)
        C("mp", ("mp",), lambda P: ct.mp(P["A"], P["y"], 30), fit),
        C("omp", ("omp", "SparseSolution"),
          lambda P: ct.omp(P["A"], P["y"], 3),
          _both(ex, _is(ct.SparseSolution))),
        C("gomp", ("gomp",), lambda P: ct.gomp(P["A"], P["y"], 2, 4),
          _superset("sup")),
        C("oblivious", ("oblivious",),
          lambda P: ct.oblivious(P["A"], P["y"], 3), ex),
        *(C(name, (name,), lambda P, f=getattr(ct, name): f(
            P["A"], P["y"], sparsity=3), ex)
          for name in ("fr", "ols", "oomp", "ormp", "stepwise_regression")),
        C("br", ("br",), lambda P: ct.br(P["As"], P["ys"], sparsity=3),
          sup_s),
        C("br naive", ("br",),
          lambda P: ct.br(P["As"], P["ys"], sparsity=3, naive=True), sup_s),
        C("fbr", ("fbr",), lambda P: ct.fbr(P["As"], P["ys"], sparsity=3),
          sup_s),
        C("lace", ("lace",), lambda P: ct.lace(P["As"], P["ys"], sparsity=3),
          sup_s),
        C("sp", ("sp",), lambda P: ct.sp(P["A"], P["y"], 3, d), ex),
        C("ompr", ("ompr",), lambda P: ct.ompr(P["A"], P["y"], 3, d), ex),
        *(C(f"srr init={i}", ("srr",), lambda P, i=i: ct.srr(
            P["A"], P["y"], 3, d, initialization=i,
            key=_gen(P) if i == 3 else None), ex) for i in (1, 2, 3)),
        C("rmp k", ("rmp",), lambda P: ct.rmp(P["A"], P["y"], k=3), ex),
        C("rmp k f64", ("rmp",), lambda P: ct.rmp(_f64(P["A"]),
                                                  _f64(P["y"]), k=3), ex),
        C("rmp delta", ("rmp",), lambda P: ct.rmp(P["A"], P["y"], delta=d),
          ex),
        C("foba", ("foba",), lambda P: ct.foba(P["A"], P["y"], d), ex),
        C("sbl", ("sbl",), lambda P: ct.sbl(P["A"], P["y"], s2), ex),
        C("fsbl", ("fsbl",), lambda P: ct.fsbl(P["A"], P["y"], s2), ex),
        C("rmps", ("rmps",), lambda P: ct.rmps(P["A"], P["y"], s2), ex),
        C("rmps_estimate_noise", ("rmps_estimate_noise",),
          lambda P: ct.rmps_estimate_noise(P["A"], P["y"], s2, 1.0, s2), ex),
        C("rmps_estimate_noise_batch", ("rmps_estimate_noise_batch",),
          lambda P: ct.rmps_estimate_noise_batch(
              P["A"], P["y"][None], s2, 1.0, s2)[0], ex),
        C("fsbl_traced", ("fsbl_traced", "SBLTrace"),
          lambda P: ct.fsbl_traced(P["A"], P["y"], s2),
          traced(ex, ct.SBLTrace)),
        C("rmps_traced", ("rmps_traced", "RMPSTrace"),
          lambda P: ct.rmps_traced(P["A"], P["y"], s2),
          traced(ex, ct.RMPSTrace)),
        C("omp_traced", ("omp_traced", "SolveTrace"),
          lambda P: ct.omp_traced(P["A"], P["y"], 3),
          traced(ex, ct.SolveTrace)),
        C("fr_traced", ("fr_traced",),
          lambda P: ct.fr_traced(P["A"], P["y"], sparsity=3),
          traced(ex, ct.SolveTrace)),
        *(C(name, (name,), lambda P, f=getattr(ct, name): f(P["A"], P["b"]),
            ex) for name in ("bp", "basispursuit", "bp_candes", "bp_ard")),
        *(C(name, (name,), lambda P, f=getattr(ct, name): f(
            P["A"], P["y"], d), fit)
          for name in ("bpd", "basis_pursuit_denoising", "bpd_candes",
                       "bpd_ard")),
        *(C(name, (name,), lambda P, f=getattr(ct, name): f(
            P["A"], P["y"], d / 10, maxiter=2048, stepsize=None), fit)
          for name in ("ista", "fista")),
        C("exhaustive", ("exhaustive",),
          lambda P: ct.exhaustive(P["A16"], P["b16"], 3),
          lambda P, out: (sorted(int(i) for i in out) == P["sup16"],
                          f"support={sorted(int(i) for i in out)}"),
          _close()),
        # the batched entry points at the kernels' small corner (n=64,
        # m=128, B=8, k=3): the kernel route by the launch counts
        C("omp_batch", ("omp_batch",),
          lambda P: ct.omp_batch(P["A2"], P["Bs2"], 3), sup_2,
          keys=("select", "append")),
        C("fr_batch", ("fr_batch",),
          lambda P: ct.fr_batch(P["A2"], P["Bs2"], sparsity=3), sup_2,
          keys=("fr_select", "fr_append")),
        C("gomp_batch", ("gomp_batch",),
          lambda P: ct.gomp_batch(P["A2"], P["Bs2"], 2, 4), sup_2,
          keys=("select_topl", "gomp_append")),
        C("sp_batch", ("sp_batch",),
          lambda P: ct.sp_batch(P["A2"], P["Bs2"], 3, d), sup_2,
          keys=("select_topl", "sp_round")),
        C("ompr_batch", ("ompr_batch",),
          lambda P: ct.ompr_batch(P["A2"], P["Bs2"], 3, d), sup_2,
          keys=("engine_init", "ompr_swap")),
        C("srr_batch", ("srr_batch",),
          lambda P: ct.srr_batch(P["A2"], P["Bs2"], 3, d), sup_2,
          keys=("engine_init", "srr_append")),
        C("rmp_batch delta", ("rmp_batch",),
          lambda P: ct.rmp_batch(P["A2"], P["Bs2"], delta=d, kmax=8), sup_2,
          keys=("fr_select", "rmp_append")),
        # k at kmax = n runs the forward stage to full rank and prunes the
        # whole basis: on bf16-rounded scores its late picks are noise and
        # one flip reshuffles it (docs/DESIGN.md, exhaustion mode; the
        # plain twin in bf16 misses a planted atom here too), so true f32
        C("rmp_batch k", ("rmp_batch",),
          lambda P: ct.rmp_batch(P["A2"], P["Bs2"], k=3, kmax=64,
                                 precision="f32"), sup_2,
          keys=("fr_select", "rmp_append", "engine_backward")),
        C("foba_batch", ("foba_batch",),
          lambda P: ct.foba_batch(P["A2"], P["Bs2"], d, kmax=8), sup_2,
          keys=("fr_select", "rmp_append")),
        C("fbr_batch", ("fbr_batch",),
          lambda P: ct.fbr_batch(P["A3"], P["Bs3"], sparsity=3), sup_2,
          keys=("bw_select", "bw_downdate")),
        C("lace_batch", ("lace_batch",),
          lambda P: ct.lace_batch(P["A3"], P["Bs3"], sparsity=3), sup_2,
          keys=("bw_select", "bw_downdate")),
        C("mp_batch", ("mp_batch",),
          lambda P: ct.mp_batch(P["A2"], P["Bs2"], 60), _fit("A2", "Bs2"),
          keys=("select", "mp_update")),
        C("br_batch", ("br_batch",),
          lambda P: ct.br_batch(P["A3"], P["Bs3"], sparsity=3), sup_2),
        C("batch", ("batch",),
          lambda P: ct.batch(ct.omp, k=3)(P["A2"], P["Bs2"]), sup_2),
        *(C(name, (name,), lambda P, f=getattr(ct, name): f(
            P["A2"], P["Bs2"], s2), sup_2)
          for name in ("rmps_batch", "fsbl_batch", "sbl_batch")),
        # the sharded solvers on a (1, 2) mesh at m=256
        C("make_mesh", ("make_mesh", "Mesh", "shard_dictionary",
                        "ShardedDictionary", "shard_batch"),
          lambda P: (_mesh2(P), ct.shard_dictionary(P["Ash"], _mesh2(P)),
                     ct.shard_batch(P["Bsh"], _mesh2(P))),
          lambda P, out: (
              isinstance(out[0], cp.Mesh)
              and isinstance(out[1], cp.ShardedDictionary)
              and [tuple(x.shape) for x in out[1].shards[0]]
              == [(64, 128)] * 2 and tuple(out[2][0].shape) == (8, 64),
              f"{type(out[0]).__name__} shards "
              f"{[tuple(x.shape) for x in out[1].shards[0]]}"), None),
        C("omp_sharded", ("omp_sharded",),
          lambda P: ct.omp_sharded(P["Ash"], P["Bsh"][0], 3, _mesh2(P)),
          lambda P, out: (_rows_of(out) == [P["supsh"][0]],
                          f"support={_rows_of(out)}")),
        C("omp_sharded_rows", ("omp_sharded_rows",),
          lambda P: ct.omp_sharded_rows(P["Ash"], P["Bsh"][0], 3, _mesh2(P)),
          lambda P, out: (_rows_of(out) == [P["supsh"][0]],
                          f"support={_rows_of(out)}")),
        C("omp_sharded_fused", ("omp_sharded_fused",),
          lambda P: ct.omp_sharded_fused(P["Ash"], P["Bsh"], 3, _mesh2(P)),
          sup_h, keys=("select_stream",)),
        C("mp_sharded_fused", ("mp_sharded_fused",),
          lambda P: ct.mp_sharded_fused(P["Ash"], P["Bsh"], 60, _mesh2(P)),
          fit_h, keys=("select_stream",)),
        C("gomp_sharded_fused", ("gomp_sharded_fused",),
          lambda P: ct.gomp_sharded_fused(P["Ash"], P["Bsh"], 2, 4,
                                          _mesh2(P)),
          sup_h, keys=("select_topl_stream", "stream_topl_finish")),
        C("ompr_sharded_fused", ("ompr_sharded_fused",),
          lambda P: ct.ompr_sharded_fused(P["Ash"], P["Bsh"], 3, _mesh2(P),
                                          delta=d),
          sup_h, keys=("select_topl_stream", "select_masked_stream")),
        C("sp_sharded_fused", ("sp_sharded_fused",),
          lambda P: ct.sp_sharded_fused(P["Ash"], P["Bsh"], 3, _mesh2(P)),
          sup_h, keys=("select_topl_stream",)),
        C("fr_sharded_fused", ("fr_sharded_fused",),
          lambda P: ct.fr_sharded_fused(P["Ash"], P["Bsh"], 3, _mesh2(P)),
          sup_h, keys=("fr_step_select",)),
        C("srr_sharded_fused", ("srr_sharded_fused",),
          lambda P: ct.srr_sharded_fused(P["Ash"], P["Bsh"], 3, _mesh2(P)),
          sup_h, keys=("select_topl_stream", "fr_step_select")),
        C("rmp_sharded_fused", ("rmp_sharded_fused",),
          lambda P: ct.rmp_sharded_fused(P["Ash"], P["Bsh"], d, _mesh2(P),
                                         kmax=8),
          sup_h, keys=("fr_step_select",)),
        C("foba_sharded_fused", ("foba_sharded_fused",),
          lambda P: ct.foba_sharded_fused(P["Ash"], P["Bsh"], d, _mesh2(P),
                                          kmax=8),
          sup_h, keys=("fr_step_select",)),
        C("correlate_argmax", ("correlate_argmax",),
          lambda P: ct.correlate_argmax(P["Ash"], _columns(P["Bsh"])),
          lambda P, out: (
              out[0].tolist() == (P["Bsh"] @ P["Ash"]).abs().argmax(
                  dim=1).tolist(), f"idx={out[0].tolist()}"),
          lambda a, b: a[0].tolist() == b[0].tolist(),
          keys=("corr_argmax",)),
        *(C(name, (name,), lambda P, f=getattr(cp, name): f(
            P["Ash"], P["Bsh"], s2, _mesh2(P)), sup_h)
          for name in ("fsbl_sharded", "rmps_sharded")),
        C("bp_sharded", ("bp_sharded",),
          lambda P: cp.bp_sharded(P["A"], P["b"], mesh=_mesh2(P))[0], ex),
        C("bp_ard_sharded", ("bp_ard_sharded",),
          lambda P: cp.bp_ard_sharded(P["A"], P["b"], _mesh2(P)), ex),
        C("bpd_sharded", ("bpd_sharded",),
          lambda P: cp.bpd_sharded(P["A"], P["y"], d, mesh=_mesh2(P))[0],
          fit),
        *(C(name, (name,), lambda P, f=getattr(cp, name): f(
            P["A"], P["y"], d, _mesh2(P)), fit)
          for name in ("bpd_candes_sharded", "bpd_ard_sharded")),
        C("bpd_secant_sharded", ("bpd_secant_sharded",),
          lambda P: cp.bpd_secant_sharded(P["A"], P["y"], d,
                                          mesh=_mesh2(P)), fit),
        *(C(name, (name,), lambda P, f=getattr(cp, name): f(
            P["A"], P["y"], d / 10, _mesh2(P), maxiter=2048,
            stepsize=None), fit)
          for name in ("ista_sharded", "fista_sharded")),
        # the utilities
        C("sparse_vector", ("sparse_vector",),
          lambda P: ct.sparse_vector(_gen(P), 96, 3),
          lambda P, out: (int((out != 0).sum()) == 3
                          and bool((out.abs()[out != 0] == 1).all()),
                          f"nnz={int((out != 0).sum())}"), None),
        *(C(name, (name,), lambda P, f=getattr(ct, name): f(
            _gen(P), 64, 96, 3),
            lambda P, out: (
                torch.allclose(out[0].norm(dim=0), torch.ones_like(
                    out[0][0]), atol=1e-5)
                and torch.allclose(out[0] @ out[1], out[2], atol=1e-5)
                and int((out[1] != 0).sum()) == 3,
                f"A {tuple(out[0].shape)}"), None)
          for name in ("sparse_data", "gaussian_data", "correlated_data",
                       "coherent_data")),
        C("perturb", ("perturb",),
          lambda P: _minus(ct.perturb(_gen(P), P["b"], d), P["b"]),
          lambda P, out: (abs(float(out.norm()) - d) < 1e-6,
                          f"||e||={float(out.norm()):.6f}"), None),
        C("colnorms", ("colnorms", "normalize_columns"),
          lambda P: (ct.colnorms(P["A"]),
                     ct.colnorms(ct.normalize_columns(3.0 * P["A"]))),
          lambda P, out: (torch.allclose(out[1], torch.ones_like(out[1]),
                                         atol=1e-5), "unit columns"),
          _close()),
        C("babel", ("coherence", "babel", "cumbabel"),
          lambda P: (ct.coherence(P["A"]), ct.babel(P["A"], 3),
                     ct.cumbabel(P["A"], 3)),
          lambda P, out: (
              abs(float(out[2][0]) - float(out[0])) < 1e-6
              and abs(float(out[2][2]) - float(out[1])) < 1e-6
              and bool((out[2][1:] >= out[2][:-1]).all()),
              f"coherence={float(out[0]):.4f}"), _close()),
        C("preconditioners", ("mean_preconditioner", "svd_preconditioner",
                              "precondition"),
          lambda P: (ct.mean_preconditioner(1e-3)(P["A"]),
                     ct.svd_preconditioner(P["A"])(P["A"]),
                     ct.precondition(P["A"])),
          lambda P, out: (torch.allclose(out[1], out[2], atol=1e-5)
                          and tuple(out[0].shape) == (64, 96),
                          "precondition == svd_preconditioner(A)(A)"),
          _close(atol=1e-4)),
        C("support", ("support", "samesupport", "droptol", "polish"),
          lambda P: _support_utilities(P),
          lambda P, out: (out[0] == P["sup"] and out[1] and out[2] == 3
                          and out[3] < 3 * SURFACE_DELTA,
                          f"support={out[0]} polished resid={out[3]:.2e}"),
          lambda a, b: a[:3] == b[:3]),
        C("solver_config", ("solver_config", "SolverConfig"),
          lambda P: _config_roundtrip(P),
          lambda P, out: (isinstance(out[0], ct.SolverConfig)
                          and out[0] == out[1] and _exact("sup")(P, out[2])[0]
                          and _superset("sup2")(P, out[3])[0],
                          f"{out[0].to_json()}"),
          lambda a, b: _rows_of(a[2]) == _rows_of(b[2])),
        C("save_state", ("save_state", "load_state"),
          lambda P: _state_roundtrip(P),
          lambda P, out: (out, "the omp solution saved and loaded "
                               "unchanged"), None),
        C("solve_cost", ("solve_cost", "roofline_report"),
          lambda P: ct.roofline_report(1e-3, ct.solve_cost(8, 64, 128, 3)),
          lambda P, out: (out["tflops"] > 0 and out["seconds"] == 1e-3,
                          f"tflops={out['tflops']:.3e}"),
          lambda a, b: a == b),
    ]
    return cases


def _support_utilities(P):
    import cstpu_torch as ct

    x = ct.omp(P["A"], P["y"], 3).todense()
    exact = torch.zeros_like(x)
    exact[P["sup"]] = 1.0
    kept = ct.droptol(x, 0.5)
    pol = ct.polish(P["A"], P["y"], x)
    A, y = (torch.as_tensor(P[key], device=pol.device) for key in ("A", "y"))
    return ([int(i) for i in ct.support(x)], bool(ct.samesupport(x, exact)),
            int((kept != 0).sum()), float(torch.linalg.norm(A @ pol - y)))


def _config_roundtrip(P):
    import cstpu_torch as ct

    cfg = ct.solver_config("omp", k=3)
    back = ct.SolverConfig.from_json(cfg.to_json())
    return (cfg, back, cfg.run(P["A"], P["y"]),
            cfg.run_batch(P["A2"], P["Bs2"]))


def _state_roundtrip(P):
    import os
    import tempfile

    import cstpu_torch as ct

    sol = ct.omp(P["A"], P["y"], 3)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.pt")
        ct.save_state(path, sol)
        back = ct.load_state(path, sol)
    return (back.idx.device == sol.idx.device
            and torch.equal(back.idx, sol.idx)
            and torch.equal(back.val, sol.val)
            and torch.equal(back.mask, sol.mask) and back.m == sol.m)


def surface_names():
    """Every public name the [surface] phase must call: both __all__s."""
    import cstpu_torch
    import cstpu_torch.parallel

    return set(cstpu_torch.__all__) | set(cstpu_torch.parallel.__all__)


def _agree(case, card, cpu):
    """True or False by the case's `agree`; None where it has none."""
    return None if case.agree is None else bool(case.agree(card, cpu))


def surface_paths(dev, gpu):
    """The [surface] phase: every case of `surface_cases` on the card with
    the launch counts zeroed just before it (its oracle; on the card the
    kernel route by its `keys`), then the same call on CPU tensors, held
    against the card's (supports equal, or the oracle on both where they
    part at a near-tie), then on numpy copies of the card's problems
    (`surface_numpy`), which must hold the oracle and agree with the
    tensor call by the case's `agree`. One PASS or FAIL line a case; it
    raises after the whole table has run if any case failed, or if a
    public name has no case."""
    t0 = time.perf_counter()
    cases = surface_cases()
    covered = set().union(*(c.covers for c in cases))
    assert covered == surface_names(), sorted(surface_names() ^ covered)
    P = {"card": surface_problems(dev), "cpu": surface_problems("cpu")}
    P["numpy"] = surface_numpy(P["card"])
    fails = []
    for case in cases:
        t1 = time.perf_counter()
        try:
            out, counts = run_counted(lambda: case.run(P["card"]))
            ok, detail = case.check(P["card"], out)
            missing = [key for key in case.keys
                       if not counts.get(key, 0) + counts.get(key + "_mma",
                                                              0)]
            launched = {key: v for key, v in counts.items() if v}
            out_cpu = case.run(P["cpu"])
            ok_cpu, detail_cpu = case.check(P["cpu"], out_cpu)
            same = _agree(case, out, out_cpu)
            held = ("cpu agrees" if same else
                    "cpu parts, oracle on both" if same is False
                    else "oracle on both")
            # numpy copies of the card's problems, as a cstpu user passes
            # them: as_inputs puts them on the card; the same result
            out_np = case.run(P["numpy"])
            ok_np, detail_np = case.check(P["card"], out_np)
            same_np = _agree(case, out_np, out)
            ok = bool(ok and ok_cpu and ok_np and same_np is not False
                      and not missing
                      and (same is not False
                           or case.agree is _same_support))
            detail = (f"{detail} | {held} | numpy "
                      + ("agrees" if same_np else "parts" if same_np is False
                         else "holds its oracle")
                      + (f" (numpy: {detail_np})" if not ok_np else "")
                      + (f" (cpu: {detail_cpu})" if not ok_cpu else "")
                      + (f" | launches {launched}" if case.keys else "")
                      + (f" | kernel route missing {missing}"
                         if missing else ""))
        except Exception as e:  # noqa: BLE001 - a FAIL line, then go on
            ok, detail = False, f"raised {type(e).__name__}: {e}"
        if not ok:
            fails.append(case.name)
        print(f"{'PASS' if ok else 'FAIL'} [surface] {case.name:26s} "
              f"{detail} ({time.perf_counter() - t1:.2f} s)", flush=True)
    print(f"[surface] {len(cases) - len(fails)}/{len(cases)} cases passed, "
          f"{len(covered)} public names called on the card (tensors and "
          f"numpy arrays) and on the CPU; "
          f"{time.perf_counter() - t0:.1f} s | {gpu}")
    if fails:
        raise AssertionError(f"[surface] failed: {fails}")
    return {"cases": len(cases), "names": len(covered),
            "seconds": time.perf_counter() - t0}


# the [fuzz] phase: tools/fuzz_torch.py's checks on the card, one trial a
# check (the trial number seeds its problem): the campaign's second turn,
# the problems tests/test_torch_fuzz.py runs on the CPU (the first turn's
# sharded BP takes 50 s on the card)
FUZZ_TRIALS = 13
FUZZ_SEED = 13


# the [rows] phase: the batched bodies of the greedy, two-stage, stepwise
# and backward solvers (what the *_batch entry points run where the kernels
# do not), on suite problems; rows solved alone against the batch to ATOL
ROWS_BR_B = 8
ROWS_SMALL_B = 8  # the greedy and two-stage bodies' batch on the bench
ROWS_RMP_KMAX = 8
ROWS_ATOL = 1e-5
ROWS_ALONE = (0, -1)


def rows_problems(dev):
    """The [rows] calls' problems, each from a generator of its own seeded
    with SEED: the bench's planted rows (MP_CELL; its first ROWS_SMALL_B
    rows too), 3a's correlated dictionary with its planted ones (FR_CELL,
    also 3b's), 3e's square dictionary at B = ROWS_BR_B (in f32, and in f64
    for the backward bodies, which f32 sends to the kernels) and 3d's at B
    = BATCHES[0]. {cell: (A, Bs, planted support)}."""
    from cstpu_torch.utils.data import correlated_data, sparse_data

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED)

    _, B, n, m, k = MP_CELL
    out = {"bench": planted(gen(), B, n, m, k)}
    A, Bs, sup = out["bench"]
    out[f"bench B={ROWS_SMALL_B}"] = (A, Bs[:ROWS_SMALL_B].contiguous(),
                                     sup[:ROWS_SMALL_B])
    _, B, n, m, kf, decay = FR_CELL
    g = gen()
    Ar = correlated_data(g, n, m, kf, decay=decay)[0].contiguous()
    out["3a"] = (Ar, *planted_ones(g, Ar, B, kf))
    _, n2, m2, k2 = BW_CELL
    g = gen()
    A2 = sparse_data(g, n2, m2, 1)[0].contiguous()
    out["3e"] = (A2, *planted_ones(g, A2, ROWS_BR_B, k2))
    out["3e f64"] = (A2.double(), out["3e"][1].double(), out["3e"][2])
    _, n3, m3, k3, _, _ = STEP_CELL
    g = gen()
    A3 = planted(g, 1, n3, m3, 1)[0]
    out["3d"] = (A3, *planted_ones(g, A3, BATCHES[0], k3))
    return out


def rows_calls(probs):
    """The [rows] calls: (name, cell, entry(A, Bs)) through the public entry
    points, each taking the batched body (or, for rmp_batch at kmax =
    ROWS_RMP_KMAX, the kernels and then the body for the capped rows)."""
    import cstpu_torch as ct

    k, kf, ks, kb = MP_CELL[4], FR_CELL[4], SRR_CELL[1], BW_CELL[3]
    kg, l, kp, ko = GOMP_CELL[4], GOMP_CELL[5], SP_CELL[1], OMPR_CELL[1]
    delta, kmax = STEP_CELL[4], STEP_CELL[5]
    small = f"bench B={ROWS_SMALL_B}"
    return [
        ("omp_batch max_residual=1e-4", "bench",
         lambda A, Bs: ct.omp_batch(A, Bs, k, max_residual=1e-4)),
        ("omp_batch precision=highest", "bench",
         lambda A, Bs: ct.omp_batch(A, Bs, k, precision="highest")),
        ("fr_batch no sparsity", "3a", lambda A, Bs: ct.fr_batch(A, Bs)),
        (f"srr_batch({ks}, initialization=2)", "3a",
         lambda A, Bs: ct.srr_batch(A, Bs, ks, initialization=2,
                                    **SRR_CELL[2])),
        (f"br_batch(sparsity={kb})", "3e",
         lambda A, Bs: ct.br_batch(A, Bs, sparsity=kb)),
        (f"rmp_batch(delta={delta}, kmax={ROWS_RMP_KMAX})", "3d",
         lambda A, Bs: ct.rmp_batch(A, Bs, delta=delta, kmax=ROWS_RMP_KMAX)),
        # the bodies that ran on the card only at B = 1 ([surface]'s
        # per-instance calls): precision="highest" takes the body; fbr_batch
        # and lace_batch have no precision option (cstpu's neither), so an
        # f64 dictionary, which their kernels do not take, does
        (f"gomp_batch({l}, {kg}) precision=highest", small,
         lambda A, Bs: ct.gomp_batch(A, Bs, l, kg, precision="highest")),
        (f"sp_batch({kp}, maxiter=8) precision=highest", small,
         lambda A, Bs: ct.sp_batch(A, Bs, kp, precision="highest",
                                   **SP_CELL[2])),
        (f"ompr_batch({ko}, 1e-12) precision=highest", small,
         lambda A, Bs: ct.ompr_batch(A, Bs, ko, precision="highest",
                                     **OMPR_CELL[2])),
        (f"foba_batch({delta}, kmax={kmax}) precision=highest", "3d",
         lambda A, Bs: ct.foba_batch(A, Bs, delta, kmax=kmax,
                                     precision="highest")),
        (f"fbr_batch(sparsity={kb})", "3e f64",
         lambda A, Bs: ct.fbr_batch(A, Bs, sparsity=kb)),
        (f"lace_batch(sparsity={kb})", "3e f64",
         lambda A, Bs: ct.lace_batch(A, Bs, sparsity=kb)),
    ]


def _rows_body_launches():
    """Wrap models.batched._rmp_rows (the capped rows' body) so that the
    kernel launches made inside it are recorded: ([launches per call],
    restore)."""
    from cstpu_torch.models import batched as tb
    from cstpu_torch.ops import fused_solve as fs

    body = tb._rmp_rows
    seen = []

    def counted(*a, **kw):
        before = sum(fs.LAUNCHES.values())
        out = body(*a, **kw)
        torch.cuda.synchronize()
        seen.append(sum(fs.LAUNCHES.values()) - before)
        return out

    tb._rmp_rows = counted
    return seen, lambda: setattr(tb, "_rmp_rows", body)


def rows_call(name, A, Bs, sup, entry):
    """One [rows] call: ROWS_ALONE's rows solved alone, then the entry point
    once with the launch and loop counts zeroed (wall ms by CUDA events),
    then profiled once (device busy ms: the union of the device spans,
    top_device_ops, which reads the raw records: a loop over 992 deletions
    leaves ~10^5), and the alone rows against the same rows of the batch.
    Returns its record."""
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops.util import LOOP_COUNTS

    seen, restore = _rows_body_launches()
    try:
        alone = [entry(A, Bs[[r]]) for r in ROWS_ALONE]
        for counts in (fs.LAUNCHES, LOOP_COUNTS):
            for key in counts:
                counts[key] = 0
        seen.clear()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        sol = entry(A, Bs)
        t1.record()
        torch.cuda.synchronize()
        wall = t0.elapsed_time(t1)
        launches = sum(fs.LAUNCHES.values())
        loops = dict(LOOP_COUNTS)
        body_launches = list(seen)
        busy, _ = top_device_ops(lambda: entry(A, Bs), top=None)
    finally:
        restore()
    err, same = 0.0, True
    for r, one in zip(ROWS_ALONE, alone):
        same &= bool(torch.equal(sol.mask[r], one.mask[0])
                     and torch.equal(sol.idx[r][sol.mask[r]],
                                     one.idx[0][one.mask[0]]))
        err = max(err, float((sol.val[r] - one.val[0]).abs().max()))
    return {"name": name, "B": Bs.shape[0], "recovery": recovery(sol, sup),
            "wall_ms": wall, "busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall), "launches": launches,
            "body_launches": body_launches, "loops": loops,
            "alone_same_support": same, "alone_max_abs_err": err}


def rows_paths(dev, gpu):
    """The [rows] phase: every call of rows_calls on rows_problems through
    rows_call, then the checks: recovery 1.000; ROWS_ALONE's rows alone
    with the same supports as in the batch and coefficients within
    ROWS_ATOL; no kernel launched by a body (the calls that go straight to
    the body launch nothing at all; rmp_batch's capped rows are re-solved by
    one body call that launches nothing); one latch read a step."""
    t0 = time.perf_counter()
    probs = rows_problems(dev)
    out = {}
    for name, cell, entry in rows_calls(probs):
        A, Bs, sup = probs[cell]
        t1 = time.perf_counter()
        r = rows_call(name, A, Bs, sup, entry)
        r["seconds"] = time.perf_counter() - t1
        loops = r["loops"]
        print(f"[rows] {cell} {name} B={r['B']}: recovery {r['recovery']:.3f}"
              f", wall {r['wall_ms']:.3f} ms (events), device busy "
              f"{r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}; "
              f"steps {loops['steps']}, latch reads {loops['latch_reads']};"
              f" kernel launches {r['launches']} (in the body "
              f"{r['body_launches']}); rows {list(ROWS_ALONE)} alone: "
              f"supports equal {r['alone_same_support']}, max |dval| "
              f"{r['alone_max_abs_err']:.2e}; {r['seconds']:.1f} s | {gpu}",
              flush=True)
        assert r["recovery"] == 1.0, r
        assert r["alone_same_support"], r
        assert r["alone_max_abs_err"] <= ROWS_ATOL, r
        assert loops["latch_reads"] <= loops["steps"] + 1, r
        if name.startswith("rmp_batch"):
            # every row capped at kmax: one body call re-solves them all
            assert r["body_launches"] == [0], r
        else:
            assert r["launches"] == 0 and r["body_launches"] == [], r
        out[f"{cell} {name}"] = r
    print(f"[rows] done in {time.perf_counter() - t0:.1f} s")
    return out


def fuzz_paths(gpu):
    """The [fuzz] phase: FUZZ_TRIALS trials of tools/fuzz_torch.py from
    FUZZ_SEED on the card, the checks in turn; raises on any violation."""
    import importlib.util
    from pathlib import Path

    t0 = time.perf_counter()
    path = Path(__file__).resolve().parent / "tools" / "fuzz_torch.py"
    spec = importlib.util.spec_from_file_location("fuzz_torch", path)
    fuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz)
    fz = fuzz.run(FUZZ_TRIALS, FUZZ_SEED, None, "cuda")
    secs = time.perf_counter() - t0
    print(f"[fuzz] {FUZZ_TRIALS} trials from seed {FUZZ_SEED} over "
          f"{len(fuzz.CHECKS)} checks on the card: {len(fz.violations)} "
          f"violations; {secs:.1f} s | {gpu}")
    assert not fz.violations, fz.violations
    return {"trials": FUZZ_TRIALS, "checks": len(fuzz.CHECKS),
            "violations": 0, "seconds": secs}


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
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"[g++] {gxx.stdout.splitlines()[0]} (builds cstpu_torch.native)")

    secs, log = _build.build()
    print(f"[build] nvcc {len(_build.sources())} sources -> {_build.LIB.name} "
          f"in {secs:.1f} s")
    lines = log.splitlines()
    for line in lines:
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    app_regs = {}  # registers of omp_append's and fr_append's kernels
    eng_regs = {}  # ... and of rmp_append's and engine_init's
    swap_regs = {}  # ... and of gomp_append's and ompr_swap's
    mps_regs = {}  # ... and of mp_update's and srr_append's
    del_regs = {}  # ... and of engine_delete's and engine_backward's
    # the tensor-core selects by name: rows per block (NB), epilogue mode
    # (0 |s|, 1 signed, 2 masked, 3 +M), then registers, spills, static smem;
    # the rescaled ones by row groups G, product slots Pn (wgmma's N is
    # 8 G Pn) and kernel (K8's step or fr_select's)
    for i, line in enumerate(lines):
        props = " ".join(x.replace("ptxas info    :", "").strip()
                         for x in lines[i + 1:i + 3])
        got = re.search(r"Function properties for .*top1_mma_kernelILi(\d+)"
                        r"ELi(\d+)E", line)
        if got:
            print(f"[build mma] NB={got[1]} mode={got[2]}: {props}")
        # the CUDA-core selects' loop (simt_select.cuh) by kernel, dictionary
        # dtype, (select_argmax) epilogue mode, (fr_step_select) V or
        # (stream_top1_simt) the mask and the rows stored as columns, and
        # plan (entries a stage x stages x warps; the stream sweeps and K8)
        got = re.search(r"Function properties for _ZN5cstpu\d+((?:fr_)?select"
                        r"_simt|select_topl_simt|fr_step_simt|stream_top1_simt"
                        r"|stream_topl_simt)"
                        r"_kernelI(13__nv_bfloat16|f)(?:Li(\d)E)?(?:Lb([01])E)?"
                        r"(?:Lb([01])E)?(?:NS_4simt4PlanILi(\d+)ELi(\d+)ELi"
                        r"(\d+)E)?", line)
        if got:
            cdt = "bf16" if got[2].startswith("13") else "f32"
            mode = f" mode={got[3]}" if got[3] else ""
            if got[6]:
                flags = ("" if got[4] is None else
                         f"M={got[4]} cols={got[5]} "
                         if got[1].startswith("stream") else f"V={got[4]} ")
                mode = f" {flags}plan={got[6]}x{got[7]}x{got[8]}"
            print(f"[build simt] {got[1]} {cdt}{mode}: {props}")
        got = re.search(r"Function properties for .*topl_mma_kernelILi(\d+)E",
                        line)
        if got:
            print(f"[build mma] top-l NB={got[1]}: {props}")
        got = re.search(r"Function properties for .*stream_topl_(merge|fold)",
                        line)
        if got:
            print(f"[build mma] top-l finish, {got[1]}: {props}")
        got = re.search(r"Function properties for .*?(bw_select_kernelILb[01]E"
                        r"|sp_round_kernelI(?:13__nv_bfloat16|f)E"
                        r"|(?:omp|fr|rmp|gomp)_append_kernelI"
                        r"(?:13__nv_bfloat16|f)Lb[01]E"
                        r"|ompr_swap_kernelI(?:13__nv_bfloat16|f)Lb[01]E"
                        r"|engine_init_kernelI(?:13__nv_bfloat16|f)Lb[01]E"
                        r"|srr_append_kernelI(?:13__nv_bfloat16|f)Lb[01]E"
                        r"|engine_(?:delete|backward)_kernelILb[01]E"
                        r"|mp_update_kernelI(?:13__nv_bfloat16|f)E)",
                        line)
        if got:
            name = (got[1].replace("bw_select_kernelILb1E", "bw_select held")
                    .replace("bw_select_kernelILb0E", "bw_select walked")
                    .replace("_kernelILb1E", " staged")
                    .replace("_kernelILb0E", " streamed")
                    .replace("Lb1E", " staged")
                    .replace("Lb0E", " streamed").replace("I13__nv_", " ")
                    .replace("If", " f32").rstrip("E").replace("_kernel", ""))
            print(f"[build latency] {name}: {props}")
            regs = re.search(r"Used (\d+) registers", props)[1]
            if name.startswith(("mp_update", "srr_append")):
                mps_regs[name] = regs
            elif name.startswith(("engine_delete", "engine_backward")):
                spill = re.search(r"(\d+) bytes spill stores", props)[1]
                del_regs[name] = f"{regs} (spill stores {spill} B)"
            elif name.startswith(("rmp", "engine_init")):
                eng_regs[name] = regs
            elif name.startswith(("gomp", "ompr")):
                swap_regs[name] = regs
            elif "_append" in name:
                app_regs[name] = regs
        got = re.search(r"Function properties for .*rescaled_mma_kernelILi"
                        r"(\d+)ELi(\d+)ELb(\d)E", line)
        if got:
            print(f"[build mma] rescaled G={got[1]} Pn={got[2]} "
                  f"{'fr_step_select' if got[3] == '1' else 'fr_select'}: "
                  f"{props}")
    # the plans the two cluster kernels above take on their main paths
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import fused_twostage as ft

    _, Bg, ng, _, kg, lg = GOMP_CELL
    print(f"[build latency] plans: gomp_append at {GOMP_CELL[0]} "
          f"{fs._gomp_plan(Bg, ng, kg, lg)._asdict()}, ompr_swap at "
          f"{OMPR_CELL[0]} {ft._ompr_plan(Bg, ng, OMPR_CELL[1] + 1)._asdict()}"
          f", mp_update at {MP_CELL[0]} "
          f"{fs._mp_plan(MP_CELL[1], MP_CELL[2])._asdict()}, srr_append at "
          f"{SRR_CELL[0]} {ft._engine_plan(Bg, ng, SRR_CELL[1] + 1)._asdict()}")

    dev = torch.device("cuda", 0)
    grid_append_cases = smoke_grid(APPEND_CASES)
    grid_engine_cases = smoke_grid(ENGINE_CASES)
    grid_gomp_cases = smoke_grid(GOMP_CASES)
    grid_swap_cases = smoke_grid(SWAP_CASES)
    grid_mp_cases = smoke_grid(MP_CASES)
    grid_srr_cases = smoke_grid(SRR_CASES)
    grid_delete_cases = smoke_grid(DELETE_CASES)
    t0 = time.perf_counter()
    grid_err, plans = {}, {}
    for (B, n, k), cdt, fr in itertools.product(
            grid_append_cases, (torch.bfloat16, torch.float32), (False, True)):
        err, plan = hold_append(dev, B, n, k, cdt, fr)
        key = ("fr_append" if fr else "omp_append",
               "staged" if plan.staged else "streamed")
        grid_err[key] = max(grid_err.get(key, 0.0), err)
        plans[(B, n, k)] = plan
    # both kernels held on both of the plan's instantiations
    assert len(grid_err) == 4, sorted(grid_err)
    print(f"[append grid] omp_append and fr_append against their plain "
          f"versions at every step, (B, n, k) in {grid_append_cases}, bf16 and "
          f"f32: idx, done, amask equal; max |err| "
          + ", ".join(f"{kn} {v} {e:.3e}" for (kn, v), e in grid_err.items())
          + f" (atol {APPEND_ATOL}); plans (C, slice, staged): "
          + ", ".join(f"B={B} n={n} k={k} {p.C}/{p.slice}/{int(p.staged)}"
                      for (B, n, k), p in plans.items() if n != 1028)
          + f"; {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    eng_err, eng_plans, eng_ndel = {}, {}, 0
    for (B, n, K), cdt in itertools.product(
            grid_engine_cases, (torch.bfloat16, torch.float32)):
        for cnt, srr in itertools.product(engine_cnts(K), (False, True)):
            err, plan = hold_engine_init(dev, B, n, K, cnt, cdt, srr)
            key = ("engine_init", "staged" if plan.staged else "streamed")
            eng_err[key] = max(eng_err.get(key, 0.0), err)
            eng_plans[("engine_init", B, n, K, cnt)] = plan
        for mode in ENGINE_MODES:
            err, plan, nd = hold_rmp_append(dev, B, n, K, cdt, mode)
            key = ("rmp_append", "staged" if plan.staged else "streamed")
            eng_err[key] = max(eng_err.get(key, 0.0), err)
            eng_plans[("rmp_append", B, n, K, 0)] = plan
            eng_ndel = max(eng_ndel, nd)
    # both kernels held on both of the plan's instantiations
    assert len(eng_err) == 4, sorted(eng_err)
    print(f"[engine grid] rmp_append (modes {ENGINE_MODES}: a NaN row, a "
          f"duplicate pick, the rtol gate, a capped row, a done row; FoBa "
          f"deleting up to {eng_ndel} atoms a launch) and engine_init (cnt in "
          f"{{1, K}}, OMPR and SRR; a duplicate pick, the rtol gate, a NaN "
          f"row) against their plain versions at every launch, (B, n, K) in "
          f"{grid_engine_cases}, bf16 and f32: flags, idx, amask equal; max |err| "
          + ", ".join(f"{kn} {v} {e:.3e}" for (kn, v), e in eng_err.items())
          + f" (atol {APPEND_ATOL}); plans (C, slice, staged): "
          + ", ".join(f"{kn} B={B} n={n} K={K}"
                      + (f" cnt={c}" if c else "")
                      + f" {p.C}/{p.slice}/{int(p.staged)}"
                      for (kn, B, n, K, c), p in eng_plans.items()
                      if n in (1024, 2520, 2524, 4096) and B in (8, 64))
          + f"; {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    swap_err, swap_plans = {}, {}
    for (B, n, k, cnt), cdt in itertools.product(
            grid_gomp_cases, (torch.bfloat16, torch.float32)):
        err, plan = hold_gomp_append(dev, B, n, k, cnt, cdt)
        key = ("gomp_append", "staged" if plan.staged else "streamed")
        swap_err[key] = max(swap_err.get(key, 0.0), err)
        swap_plans[("gomp_append", B, n, k, cnt)] = plan
    for (B, n, K), cdt in itertools.product(
            grid_swap_cases, (torch.bfloat16, torch.float32)):
        err, plan = hold_ompr_swap(dev, B, n, K, cdt)
        key = ("ompr_swap", "staged" if plan.staged else "streamed")
        swap_err[key] = max(swap_err.get(key, 0.0), err)
        swap_plans[("ompr_swap", B, n, K, 0)] = plan
    # both kernels held on both of the plans' instantiations, GOMP's
    # exchange in rounds and its picks gathered in chunks among them
    assert len(swap_err) == 4, sorted(swap_err)
    gplans = [(c, p) for (kn, *c), p in swap_plans.items()
              if kn == "gomp_append"]
    assert any(p.R < c[3] for c, p in gplans), "no GOMP plan in rounds"
    assert any(p.W < p.slice for _, p in gplans), "no GOMP plan in chunks"
    print(f"[swap grid] gomp_append (k // cnt iterations and the remainder: "
          f"a NaN row, a duplicate pick, the rtol gate, a done row, the eps "
          f"latch) over (B, n, k, cnt) in {grid_gomp_cases} and ompr_swap (the "
          f"plain init, then {SWAPS} swaps: a NaN row, a duplicate pick, the "
          f"rtol gate, a done row, change false, an appended atom deleted at "
          f"once) over (B, n, K) in {grid_swap_cases}, bf16 and f32, against "
          f"their plain versions at every launch: idx, kcnt, amask equal, "
          f"done equal (OMPR: where res moved clearly, the rounding-tie "
          f"rule); max |err| "
          + ", ".join(f"{kn} {v} {e:.3e}" for (kn, v), e in swap_err.items())
          + f" (atol {APPEND_ATOL}); plans (C, slice, staged[, R, W]): "
          + ", ".join(f"{kn} B={B} n={n} k={k}" + (f" cnt={c}" if c else "")
                      + f" {p.C}/{p.slice}/{int(p.staged)}"
                      + (f"/{p.R}/{p.W}" if c else "")
                      for (kn, B, n, k, c), p in swap_plans.items()
                      if B in (8, 64) and (n == 1024 or n > 2000))
          + f"; {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    mp_plans, srr_err, srr_plans = {}, {}, {}
    for (B, n), cdt in itertools.product(grid_mp_cases,
                                         (torch.bfloat16, torch.float32)):
        mp_plans[(B, n)] = hold_mp_update(dev, B, n, cdt)
    for (B, n, K, l), cdt in itertools.product(
            grid_srr_cases, (torch.bfloat16, torch.float32)):
        err, plan = hold_srr_append(dev, B, n, K, l, cdt)
        key = "staged" if plan.staged else "streamed"
        srr_err[key] = max(srr_err.get(key, 0.0), err)
        srr_plans[(B, n, K)] = plan
    # srr_append held on both of the plan's instantiations; mp_update with r
    # in 16-byte pieces and entry by entry, and with slices capped by the
    # registers (C above ceil(132 / B))
    assert len(srr_err) == 2, sorted(srr_err)
    assert {n % 4 == 0 for _, n in grid_mp_cases} == {True, False}
    assert any(p.C > -(-132 // B) for (B, _), p in mp_plans.items())
    print(f"[mp srr grid] mp_update ({MP_STEPS} chained steps of the signed "
          f"select, both loops, then mp_update: a NaN row, a tie across "
          f"tiles) over (B, n) in {grid_mp_cases}, m={MP_M}, bf16 and f32: x and "
          f"r equal to the plain version's bit for bit; plans (C, slice): "
          + ", ".join(f"B={B} n={n} {p.C}/{p.slice}"
                      for (B, n), p in mp_plans.items())
          + f". srr_append (the plain init, {SRR_ITERS} iterations of l "
          f"forward steps and the plain backward stage: a NaN row, a done "
          f"row, a shut forward gate, a duplicate pick, the rtol twin, a full "
          f"state) over (B, n, K, l) in {grid_srr_cases}, bf16 and f32, against "
          f"its plain version at every launch: idx, amask, fgate, done "
          f"equal; max |err| "
          + ", ".join(f"{v} {e:.3e}" for v, e in srr_err.items())
          + f" (atol {APPEND_ATOL}); plans (C, slice, staged): "
          + ", ".join(f"B={B} n={n} K={K} {p.C}/{p.slice}/{int(p.staged)}"
                      for (B, n, K), p in srr_plans.items()
                      if B in (8, 64) and (n == 1024 or n > 2000))
          + f"; {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    del_err, del_plans, del_most = {}, {}, {}
    for (B, n, K, l), cdt in itertools.product(
            grid_delete_cases, (torch.bfloat16, torch.float32)):
        err, plan, most = hold_engine_delete(dev, B, n, K, l, cdt)
        key = ("engine_delete", "staged" if plan.staged else "streamed")
        del_err[key] = max(del_err.get(key, 0.0), err)
        del_most["engine_delete"] = max(del_most.get("engine_delete", 0), most)
        del_plans[(B, n, K)] = plan
    for (B, n, K), cdt, rule in itertools.product(
            dict.fromkeys(c[:3] for c in grid_delete_cases),
            (torch.bfloat16, torch.float32), DELETE_RULES):
        err, plan, most = hold_engine_backward(dev, B, n, K, cdt, rule)
        key = ("engine_backward", "staged" if plan.staged else "streamed")
        del_err[key] = max(del_err.get(key, 0.0), err)
        del_most["engine_backward"] = max(del_most.get("engine_backward", 0),
                                          most)
    # both kernels held on both of the plan's instantiations
    assert len(del_err) == 4, sorted(del_err)
    print(f"[delete grid] engine_delete (the plain init, {SRR_ITERS} "
          f"iterations of l plain forward steps and the stage: a NaN row, a "
          f"done row, gated-off deletions, a full row, two slots tied; up to "
          f"{del_most['engine_delete']} deletions a launch) over (B, n, K, l) "
          f"in {grid_delete_cases} and engine_backward (the plain forward stage, "
          f"then rules {DELETE_RULES}: increase < 1, and down to one atom; a "
          f"NaN row, an empty row and a row with gains of ~100 that reject "
          f"at once, a done row, a full row, two slots tied; up to "
          f"{del_most['engine_backward']} deletions a row) over its (B, n, "
          f"K), bf16 and f32, against their plain versions at every launch: "
          f"idx, amask, ndel, acc equal, done and fgate equal (SRR: where "
          f"||r||^2 moved clearly); max |err| "
          + ", ".join(f"{kn} {v} {e:.3e}" for (kn, v), e in del_err.items())
          + f" (atol {APPEND_ATOL}); plans (C, slice, staged): "
          + ", ".join(f"B={B} n={n} K={K} {p.C}/{p.slice}/{int(p.staged)}"
                      for (B, n, K), p in del_plans.items()
                      if B in (8, 64) and (n == 1024 or n > 2000))
          + f"; {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    simt_err, simt_resc, staging = 0.0, 0.0, set()
    topl_err, step_err, step_resc, stream_err = 0.0, 0.0, 0.0, 0.0
    topl_staging, step_staging, stream_staging = set(), set(), set()
    col_staging, stream_topl_staging, stream_topl_err = set(), set(), 0.0
    grid_simt_cases = smoke_grid(SIMT_CASES)
    for (B, n, m, off), cdt in itertools.product(
            grid_simt_cases, (torch.float32, torch.bfloat16)):
        err, rerr, how = hold_simt_select(dev, B, n, m, off, cdt)
        simt_err, simt_resc = max(simt_err, err), max(simt_resc, rerr)
        staging.add(how)
        err, how = hold_simt_topl(dev, B, n, m, off, cdt)
        topl_err = max(topl_err, err)
        topl_staging.add(how)
        err, rerr, how = hold_simt_fr_step(dev, B, n, m, off, cdt)
        step_err, step_resc = max(step_err, err), max(step_resc, rerr)
        step_staging |= how
        err, how, col = hold_simt_stream(dev, B, n, m, off, cdt)
        stream_err = max(stream_err, err)
        stream_staging |= how
        col_staging |= col
        err, how = hold_simt_stream_topl(dev, B, n, m, off, cdt)
        stream_topl_err = max(stream_topl_err, err)
        stream_topl_staging |= how
    # the loop held on every staging: the dictionary (f32) and the rows each
    # by TMA and by cp.async, under each kernel; K10's rows stored as
    # columns by both
    every = {(a, r) for a in (True, False) for r in (True, False)}
    assert (staging == topl_staging == step_staging == stream_staging
            == stream_topl_staging == every), (
        staging, topl_staging, step_staging, stream_staging,
        stream_topl_staging)
    assert col_staging == {True, False}, col_staging
    print(f"[simt grid] select_argmax ({', '.join(SIMT_MODES)}), "
          f"fr_select ({', '.join(map(str, SIMT_TERMS))} pending terms), "
          f"select_topl (l in {SIMT_TOPL_LS}), fr_step_select (with and "
          f"without V), the stream top-1 sweep (K6, K9, K10; R as (n, B) "
          f"for K10) and the stream top-l sweep (K7, l in "
          f"{SIMT_STREAM_TOPL_LS}; the last three each on a contiguous shard "
          f"and a column view, lda = 4 m + offset), CUDA-core variants "
          f"(csrc/simt_select.cuh), against their plain versions over (B, "
          f"n, m, offset) in {grid_simt_cases}, f32 and bf16, every staging "
          f"(dictionary by TMA, rows by TMA) under each: {sorted(staging)}: "
          f"picks equal on every row (a duplicated column -> {SIMT_TIE}, a "
          f"NaN row -> INT_MAX, an all-masked row; the step's mark, restore, "
          f"NaN and all-degenerate rows; the stream sweep's NaN row, "
          f"all-excluded row and poisoned atom), each tile's first top-l "
          f"entry and each stream sweep partial the top-1 partial bit for "
          f"bit, the stream top-l partials select_topl's at l <= 32 bit for "
          f"bit and its finish the plain finish's, max rel value err "
          f"{simt_err:.3e}, top-l {topl_err:.3e} "
          f"(rtol {SELECT_RTOL}), fr_step_select max |d2 err| "
          f"{step_err:.3e}, the stream top-1 max |val err| {stream_err:.3e}, "
          f"the stream top-l {stream_topl_err:.3e}, "
          f"resc max |err| {simt_resc:.3e}, the step's {step_resc:.3e} (atol "
          f"{RESC_ATOL}); {time.perf_counter() - t0:.1f} s")

    record = {}
    for name, B, n, m, k in CELLS:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        A, Bs, sup = planted(gen, B, n, m, k)
        print(f"[{name}] B={B} n={n} m={m} k={k}")
        sel_err, r, Ac_sel = check_select(A, Bs)
        app_err, st, parts, Ac = check_append(A, Bs, k)
        launches = main_path(A, Bs, sup, k)
        if name == "bench":
            f32_launches = f32_main_path(A, Bs, sup, k)
        tm = times(A, Bs, k, r, Ac_sel, st, parts, Ac, gpu, name)
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
    f32fr = fr_f32_path(Ar, Br, sup_f)
    f32g = gomp_f32_path(A, Bg, sup_g)
    gtm = greedy_times(A, Bs, Bg, Ar, Br, parts, gpu)
    print(f"[greedy] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print(f"[two-stage] 2b sp_batch k={SP_CELL[1]} and 2c ompr_batch "
          f"k={OMPR_CELL[1]} on 2a's problem; 3b srr_batch k={SRR_CELL[1]} "
          f"on 3a's")
    terr = check_twostage_kernels(A, Bg, Ar, Br)
    tpaths = twostage_paths(A, Bg, sup_g, Ar, Br, sup_f)
    ttm, tkern, tplain, tsplit = twostage_times(A, Bg, Ar, Br, gpu)
    print(f"[two-stage] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cell, n, m, k, delta, kmax = STEP_CELL
    print(f"[stepwise] {cell} rmp_batch(delta={delta}, kmax={kmax}) and "
          f"foba_batch({delta}, kmax={kmax}) on the unit-norm Gaussian "
          f"dictionary n={n} m={m}, {k} planted ones, B in {BATCHES}")
    serr = check_stepwise_kernels(A, gen)
    spaths, sprob = stepwise_paths(A, gen)
    stm, ssplit, splain = stepwise_times(A, sprob, gpu)
    dtm = deleting_times(A, sprob)
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
    del A2, bprob
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    B5, n5, m5, k5 = SHARD_CELLS["5c"]
    print(f"[sharded] 5c omp_sharded_fused on 1 and {SHARDS} shards, then "
          f"mp/gomp/ompr/sp_sharded_fused on {SHARDS} shards: B={B5} n={n5} "
          f"m={m5} k={k5}; 5m at m={SHARD_CELLS['5m'][2]} on one shard")
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        """Seconds since the last lap, under `name`."""
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    xerr = check_stream_kernels(dev)
    lap("stream kernels")
    merr = check_mma_selects(dev)
    lap("mma selects")
    lerr = check_mma_topl(dev)
    lap("mma top-l")
    werr, wtm = check_topl_wide(dev, gpu)
    lap("topl wide")
    gen5 = torch.Generator(device=dev).manual_seed(SEED)
    A5 = unit_dictionary(gen5, n5, m5)
    Bs5, sup5 = planted_pm1(gen5, A5, B5, k5)
    p5c = sharded_omp_path("5c", A5, Bs5, sup5, (1, SHARDS), plain=True)
    lap("5c omp")
    pother, Bones, sup_ones = sharded_other_paths(A5, gen5)
    lap("5c others")
    pwide = sharded_wide_paths(A5, Bs5, sup5)
    lap("5c-wide")
    k10_launches = corr_argmax_path(A5, Bs5)
    pf32 = sharded_f32_paths(A5, Bs5, sup5, Bones, sup_ones, gpu)
    lap("corr_argmax and f32")
    xtm, xsplit, xper = sharded_times(A5, Bs5, Bones, gpu)
    lap("times")
    print(f"[sharded] greedy solvers done in {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{key} {v:.1f}" for key, v in laps.items()) + ")")

    t1 = time.perf_counter()
    print(f"[sharded fr] fr_sharded_fused(k={FR5_K}) on 1 and {SHARDS} "
          f"shards and srr_sharded_fused on correlated_data(decay="
          f"{FR5_DECAY}), rmp/foba_sharded_fused(delta={STEP5[0]}, kmax="
          f"{STEP5[1]}) on 5c's dictionary with {STEP5[2]} planted ones: "
          f"B={B5} n={n5} m={m5}")
    frerr = check_fr_step_kernel(dev)
    Ar5 = correlated_data(gen5, n5, m5, FR5_K,
                          decay=FR5_DECAY)[0].contiguous()
    Br5, supr5 = planted_ones(gen5, Ar5, B5, FR5_K)
    Bo5, supo5 = planted_ones(gen5, A5, B5, STEP5[2])
    pfr = sharded_fr_paths(Ar5, Br5, supr5)
    pfr32 = sharded_fr_f32_path(Ar5, Br5, supr5)
    pfam = sharded_srr_rmp_foba_paths(Ar5, Br5, supr5, A5, Bo5, supo5)
    ftm, fsplit, fper = sharded_fr_times(Ar5, Br5, A5, Bo5, gpu)
    del A5, Ar5
    torch.cuda.empty_cache()
    prow = sharded_rows_path(dev)
    print(f"[sharded fr] done in {time.perf_counter() - t1:.1f} s")
    p5m, tm5m, split5m, (sweep5m, sweep5m_simt), peak5m = sharded_5m(dev,
                                                                     gpu)
    print(f"[sharded] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sbl_out = sbl_paths(dev, gpu)
    print(f"[sbl] done in {time.perf_counter() - t0:.1f} s")
    convex_out = convex_paths(dev, gpu)
    t0 = time.perf_counter()
    dist_out = distributed_paths(dev, gpu)
    print(f"[distributed] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    examples_out = examples_paths(gpu)
    print(f"[examples] done in {time.perf_counter() - t0:.1f} s")
    surface_out = surface_paths(dev, gpu)
    fuzz_out = fuzz_paths(gpu)
    rows_out = rows_paths(dev, gpu)

    sel_err, app_err, launches, tm = record["bench"]
    tm5b = record["5b"][3]
    fs_line = "cstpu/ops/fused_solve.py"
    ts_line = "cstpu/ops/fused_twostage.py"
    csrc = "cstpu_torch/csrc"
    tl = tpaths["launches"]

    def entry(name, replaces, launches, err, ms, plain_ms, bound_,
              library_ms=None, source=None, **extra):
        return {"name": name, "route": "cuda",
                "source": source or f"{csrc}/{name}.cu",
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

    def rescaled_on_path(split, key):
        """Profiler device ms per tensor-core rescaled select on path `key`:
        its sweep and its stacking launch."""
        got = split[key]["kernels"]
        return ((got["rescaled_mma"]["ms"] + got["round_rows"]["ms"])
                / got["rescaled_mma"]["launches"])

    rescaled_loop = f"{csrc}/mma_rescaled.cuh"
    fr_replaces = [f"{ts_line}:1191", f"{ts_line}:1368", f"{ts_line}:1499"]

    d_rmp, d_foba = f"3d rmp B={B0}", f"3d foba B={B0}"
    d_fbr, d_lace = f"3e fbr B={B0}", f"3e lace B={B0}"
    big = BATCHES[1]

    # the one-block-per-row kernels of this slice's redesign: device ms per
    # launch and per solve on their paths, beside the times before it
    latency = {
        "bw_select 3e fbr B=8": (bsplit, d_fbr, "bw_select"),
        "bw_select 3e fbr B=64": (bsplit, f"3e fbr B={big}", "bw_select"),
        "bw_select 3e lace B=8": (bsplit, d_lace, "bw_select"),
        "sp_round 2b": (tsplit, "2b", "sp_round"),
        "engine_init 2c": (tsplit, "2c", "engine_init"),
        "gomp_append 2a": (gtm["splits"], "2a", "gomp_append")}
    print("[latency kernels] device ms per launch (per solve) on the paths, "
          "before this slice's redesign in brackets (PERF.md, " + gpu + "): "
          + ", ".join(
              f"{key} {on_path(sp_, path, name):.4f} "
              f"({sp_[path]['kernels'][name]['ms']:.4f}) "
              f"[{BEFORE_MS[key][0]:.4f} ({BEFORE_MS[key][1]:.4f})]"
              for key, (sp_, path, name) in latency.items()))
    # omp_append and fr_append (a thread-block cluster per row): device ms
    # per launch on their paths beside the times before the redesign, the
    # plans and the registers
    from cstpu_torch.ops import fused_solve as fs

    app_plan = {"omp_append": fs._append_plan(B, n, k),
                "fr_append": fs._append_plan(B, n, kf)}
    app_dev = {"omp_append bench": tm["split"]["omp_append"][1]
               / tm["split"]["omp_append"][0],
               "omp_append 5b": tm5b["split"]["omp_append"][1]
               / tm5b["split"]["omp_append"][0],
               "fr_append 3a": on_path(gtm["splits"], "3a", "fr_append")}
    print("[append kernels] device ms per launch on the paths, before the "
          "cluster redesign in brackets (PERF.md, " + gpu + "): "
          + ", ".join(f"{key} {v:.4f} [{APPEND_BEFORE_MS[key]:.4f}]"
                      for key, v in app_dev.items())
          + "; plans at B=64, n=1024: "
          + ", ".join(f"{kn} k={kk} C={p.C} slice={p.slice} staged="
                      f"{int(p.staged)} smem={p.smem} B"
                      for (kn, p), kk in zip(app_plan.items(), (k, kf)))
          + "; registers: " + ", ".join(f"{kn} {r}"
                                        for kn, r in app_regs.items()))
    # rmp_append and engine_init (a thread-block cluster per row): device
    # ms per launch on their paths beside the times before the redesign and
    # the bound at that path's shape, the plans and the registers
    from cstpu_torch.ops import fused_twostage as ft

    eng_path = {"rmp_append 3d rmp B=8": (ssplit, d_rmp, "rmp_append"),
                "rmp_append 3d rmp B=64": (ssplit, f"3d rmp B={big}",
                                           "rmp_append"),
                "rmp_append 3d foba B=8": (ssplit, d_foba, "rmp_append"),
                "rmp_append 3d foba B=64": (ssplit, f"3d foba B={big}",
                                            "rmp_append"),
                "engine_init 2c": (tsplit, "2c", "engine_init"),
                "engine_init 3b": (tsplit, "3b", "engine_init")}
    eng_dev = {key: on_path(*v) for key, v in eng_path.items()}
    eng_bound = {"rmp_append B=8": engine_bound(B0, K3, n3, appends=1),
                 "rmp_append B=64": engine_bound(big, K3, n3, appends=1),
                 "engine_init 2c": engine_bound(B, ko + 1, n, appends=ko),
                 "engine_init 3b": engine_bound(B, kr + 1, n, appends=kr)}
    eng_plan = {"rmp_append B=8": ft._engine_plan(B0, n3, K3),
                "rmp_append B=64": ft._engine_plan(big, n3, K3),
                "engine_init 2c": ft._engine_plan(B, n, ko + 1, ko),
                "engine_init 3b": ft._engine_plan(B, n, kr + 1, kr)}
    print("[engine kernels] device ms per launch on the paths, before the "
          "cluster redesign in brackets (PERF.md, " + gpu + "): "
          + ", ".join(f"{key} {v:.4f} [{ENGINE_BEFORE_MS[key]:.4f}]"
                      for key, v in eng_dev.items())
          + "; bounds: " + ", ".join(f"{key} {v['bound_ms']:.4f}"
                                    for key, v in eng_bound.items())
          + "; plans: " + ", ".join(
              f"{key} C={p.C} slice={p.slice} staged={int(p.staged)} "
              f"smem={p.smem} B" for key, p in eng_plan.items())
          + "; registers: " + ", ".join(f"{kn} {r}"
                                        for kn, r in eng_regs.items()))
    # gomp_append and ompr_swap (a thread-block cluster per row): device ms
    # per launch on their paths beside the times before the redesign and
    # the bound at that path's shape, the plans and the registers
    swap_dev = {"gomp_append 2a": on_path(gtm["splits"], "2a",
                                          "gomp_append"),
                "ompr_swap 2c": on_path(tsplit, "2c", "ompr_swap")}
    swap_bound = {"gomp_append 2a": engine_bound(B, kg, n, appends=l),
                  "ompr_swap 2c": engine_bound(B, ko + 1, n, appends=1,
                                               deletes=1)}
    swap_plan = {"gomp_append 2a": fs._gomp_plan(B, n, kg, l),
                 "ompr_swap 2c": ft._ompr_plan(B, n, ko + 1)}
    print("[swap kernels] device ms per launch on the paths, before the "
          "cluster redesign in brackets (PERF.md, " + gpu + "): "
          + ", ".join(f"{key} {v:.4f} [{SWAP_BEFORE_MS[key]:.4f}]"
                      for key, v in swap_dev.items())
          + "; bounds: " + ", ".join(f"{key} {v['bound_ms']:.4f}"
                                    for key, v in swap_bound.items())
          + "; plans: " + ", ".join(
              f"{key} " + " ".join(f"{f}={int(v)}"
                                   for f, v in p._asdict().items())
              for key, p in swap_plan.items())
          + "; registers: " + ", ".join(f"{kn} {r}"
                                        for kn, r in swap_regs.items()))
    # mp_update (B C blocks) and srr_append (a thread-block cluster per row
    # on engine_cluster.cuh's SRR mode): device ms per launch on their
    # paths beside the times before the redesign and the bounds, the plans
    # and the registers
    mp_cnt, mp_ms = gtm["mp_split"]["mp_update"]
    mps_dev = {"mp_update mp": mp_ms / mp_cnt,
               "srr_append 3b": on_path(tsplit, "3b", "srr_append")}
    mp_bound = bound(B * (T * 12 + n * 2 + 2 * n * 4 + 8), 2 * B * n, "f32")
    mps_bound = {"mp_update mp": mp_bound,
                 "srr_append 3b": engine_bound(B, kr + 1, n, appends=1)}
    mps_plan = {"mp_update mp": fs._mp_plan(B, n),
                "srr_append 3b": ft._engine_plan(B, n, kr + 1)}
    print("[mp srr kernels] device ms per launch on the paths, before the "
          "redesign in brackets (PERF.md, " + gpu + "): "
          + ", ".join(f"{key} {v:.4f} [{MP_SRR_BEFORE_MS[key]:.4f}]"
                      for key, v in mps_dev.items())
          + "; bounds: " + ", ".join(f"{key} {v['bound_ms']:.4f}"
                                    for key, v in mps_bound.items())
          + "; plans: " + ", ".join(
              f"{key} " + " ".join(f"{f}={int(v)}"
                                   for f, v in p._asdict().items())
              for key, p in mps_plan.items())
          + "; mp_update launched without a dependent launch (taken out: "
          "the mp solve's device busy did not drop with it, PERF.md "
          "section 6)"
          + "; registers: " + ", ".join(f"{kn} {r}"
                                        for kn, r in mps_regs.items()))
    # engine_delete and engine_backward (a thread-block cluster per row on
    # engine_cluster.cuh's deletions): device ms per launch on their paths
    # (3d's backward stage deletes nothing) and in the timed deleting stage,
    # beside the times before the redesign, the bounds from the data, the
    # plans and the registers
    d_big = f"3d rmp B={big}"
    del_dev = {"engine_delete 3b": on_path(tsplit, "3b", "engine_delete"),
               "engine_backward 3d rmp B=8": on_path(ssplit, d_rmp,
                                                     "engine_backward"),
               "engine_backward 3d rmp B=64": on_path(ssplit, d_big,
                                                      "engine_backward"),
               **{f"engine_backward deleting B={b}": v["ms"]
                  for b, v in dtm.items()}}
    del_bound = {"engine_delete 3b": engine_bound(B, kr + 1, n, deletes=1),
                 "engine_backward 3d rmp B=8": delete_bound(
                     B0, K3, n3, [0] * B0, [k3] * B0),
                 "engine_backward 3d rmp B=64": delete_bound(
                     big, K3, n3, [0] * big, [k3] * big),
                 **{f"engine_backward deleting B={b}": v["bound"]
                    for b, v in dtm.items()}}
    del_plan = {"engine_delete 3b": ft._engine_plan(B, n, kr + 1),
                "engine_backward B=8": ft._engine_plan(B0, n3, K3),
                "engine_backward B=64": ft._engine_plan(big, n3, K3)}
    print("[delete kernels] device ms per launch on the paths and in the "
          f"deleting stage ({k3} atoms a row down to {DELETE_KFINAL}), before "
          "the cluster redesign in brackets (PERF.md, " + gpu + "): "
          + ", ".join(f"{key} {v:.4f}" + (f" [{DELETE_BEFORE_MS[key]:.4f}]"
                                          if key in DELETE_BEFORE_MS else "")
                      for key, v in del_dev.items())
          + "; bounds from the data: " + ", ".join(
              f"{key} {v['bound_ms']:.6f} ({v['bound_by']})"
              for key, v in del_bound.items())
          + "; plans: " + ", ".join(
              f"{key} " + " ".join(f"{f}={int(v)}"
                                   for f, v in p._asdict().items())
              for key, p in del_plan.items())
          + "; registers: " + ", ".join(f"{kn} {r}"
                                        for kn, r in del_regs.items()))
    kernels = [
        # the top-1 select's tensor-core variant: ms is the event time per
        # call through the wrapper (one rounding launch and the sweep),
        # device_ms the profiler's time of its kernels, earlier_ms the
        # CUDA-core variant on the same bf16 inputs
        entry("select_argmax_mma", 127, launches["select_mma"]
              + paths["mp"]["select_mma"] + tl["2c"]["select_mma"],
              max(sel_err["select_mma"], gerr["select_signed"],
                  terr["select_masked"], merr["select_mma"],
                  merr["select_masked_mma"]),
              tm["select"], tm["plain_select"], select_bound(B, n, m),
              source=f"{csrc}/select_argmax.cu",
              also_replaces=[f"{fs_line}:332", f"{fs_line}:874",
                             f"{ts_line}:1052"],
              main_loop=f"{csrc}/mma_select.cuh",
              paths={"omp_batch": launches["select_mma"],
                     "omp_batch 5b": record["5b"][2]["select_mma"],
                     "mp_batch": paths["mp"]["select_mma"],
                     "ompr_batch": tl["2c"]["select_mma"]},
              # the yardstick beside it: torch.matmul of the scores alone,
              # in f32 and (library_bf16_ms) in bf16 on the tensor cores
              library_ms=tm["select_gemm"],
              library_bf16_ms=tm["select_gemm_bf16"],
              device_ms=tm["select_device"],
              earlier_ms=tm["select_simt"],
              signed_ms=gtm["select_signed"],
              signed_device_ms=gtm["select_signed_device"],
              signed_earlier_ms=gtm["select_signed_simt"],
              plain_signed_ms=gtm["plain_select_signed"],
              signed_bound_ms=select_bound(B, n, m, outs=1.5)["bound_ms"],
              signed_library_ms=tm["select_gemm"],
              signed_library_bf16_ms=tm["select_gemm_bf16"],
              masked_library_ms=tm["select_gemm"],
              masked_library_bf16_ms=tm["select_gemm_bf16"],
              masked_ms=tplain["select_masked_call"],
              masked_device_ms=tkern["select_masked"],
              masked_earlier_ms=tplain["select_masked_simt"],
              plain_masked_ms=tplain["select_masked"],
              masked_bound_ms=select_bound(B, n, m,
                                           masked=True)["bound_ms"],
              m131072_ms=tm5b["select"],
              m131072_device_ms=tm5b["select_device"],
              m131072_device_ms_by_rows=tm5b["select_device_by_rows"],
              device_ms_by_rows=tm["select_device_by_rows"],
              m131072_earlier_ms=tm5b["select_simt"],
              m131072_plain_ms=tm5b["plain_select"],
              m131072_library_ms=tm5b["select_gemm"],
              m131072_library_bf16_ms=tm5b["select_gemm_bf16"],
              m131072_bound_ms=select_bound(B, n, CELLS[1][3])["bound_ms"]),
        # its CUDA-core variant: the f32-correlation path runs it; ms is its
        # time on the bench's bf16 inputs, f32_ms on the f32 dictionary
        entry("select_argmax", 127, f32_launches["select"],
              max(sel_err["select"], gerr["select_signed_simt"],
                  terr["select_masked_simt"], merr["select"],
                  merr["select_masked"]),
              tm["select_simt"], tm["plain_select"], select_bound(B, n, m),
              also_replaces=[f"{fs_line}:332", f"{fs_line}:874",
                             f"{ts_line}:1052"],
              paths={"omp_batch precision=f32": f32_launches["select"]},
              library_ms=tm["select_gemm"],
              library_bf16_ms=tm["select_gemm_bf16"],
              f32_ms=tm["select_f32"],
              f32_bound_ms=select_bound(B, n, m, cdt_bytes=4)["bound_ms"],
              # the f32 path's launch on the device (simt_select.cuh),
              # beside the f32 torch.matmul's device ms
              grid_max_rel_err=simt_err,
              f32_device_ms=tm["select_f32_device"],
              f32_library_device_ms=tm["select_gemm_device"],
              main_loop=f"{csrc}/simt_select.cuh",
              m131072_f32_device_ms=tm5b["select_f32_device"],
              m131072_f32_library_device_ms=tm5b["select_gemm_device"],
              signed_ms=gtm["select_signed_simt"],
              masked_ms=tplain["select_masked_simt"],
              m131072_ms=tm5b["select_simt"],
              m131072_f32_ms=tm5b["select_f32"],
              m131072_bound_ms=select_bound(B, n, CELLS[1][3])["bound_ms"]),
        # ms is the event time per call through the wrapper; device_ms the
        # profiler's on the path, m131072_ at 5b; plan the launch's cluster
        entry("omp_append", 127, launches["append"],
              max(app_err, record["5b"][1], grid_err[("omp_append", "staged")],
                  grid_err[("omp_append", "streamed")]), tm["append"],
              tm["plain_append"], engine_bound(B, k, n, appends=1),
              also_replaces=[f"{fs_line}:332"],
              paths={"omp_batch": launches["append"],
                     "omp_batch 5b": record["5b"][2]["append"]},
              device_ms=app_dev["omp_append bench"],
              m131072_ms=tm5b["append"],
              m131072_device_ms=app_dev["omp_append 5b"],
              plan=app_plan["omp_append"]._asdict(),
              registers=app_regs),
        # ms is the event time per call through the wrapper; device_ms the
        # profiler's on the path; plan the launch's grid (B C blocks)
        entry("mp_update", 874, paths["mp"]["mp_update"], gerr["mp_update"],
              gtm["mp_update"], gtm["plain_mp_update"], mp_bound,
              device_ms=mps_dev["mp_update mp"],
              plan=mps_plan["mp_update mp"]._asdict(),
              registers={kn: r for kn, r in mps_regs.items()
                         if kn.startswith("mp_update")}),
        # the top-l select's tensor-core variant at 2a (l=4) and at 2b's
        # l=32: ms per call by events (the rounding launch and the sweep),
        # device_ms the profiler's, earlier_ms the CUDA-core variant on the
        # same bf16 inputs; library_topk_ms the bf16 GEMM and torch.topk
        entry("select_topl_mma", 714, paths["gomp"]["select_topl_mma"]
              + sum(tl[c]["select_topl_mma"] for c in ("2b", "2c", "3b")),
              max(gerr["select_topl_mma"], lerr["select_topl_mma"]),
              gtm["select_topl"], gtm["plain_select_topl"],
              select_bound(B, n, m, outs=l), source=f"{csrc}/select_topl.cu",
              main_loop=f"{csrc}/mma_topl.cuh",
              also_replaces=[f"{ts_line}:897", f"{ts_line}:1052",
                             f"{ts_line}:1191"],
              library_ms=gtm["select_topl_gemm"],
              library_bf16_ms=gtm["select_topl_gemm_bf16"],
              library_topk_ms=gtm["select_topl_gemm_topk"],
              device_ms=gtm["select_topl_device"],
              earlier_ms=gtm["select_topl_simt"],
              earlier_device_ms=gtm["select_topl_simt_device"],
              half_rows_device_ms=gtm["select_topl_device_half"],
              paths={"gomp_batch": paths["gomp"]["select_topl_mma"],
                     **{name: tl[c]["select_topl_mma"] for name, c in (
                         ("sp_batch", "2b"), ("ompr_batch", "2c"),
                         ("srr_batch", "3b"))}},
              path_device_ms=on_path(gtm["splits"], "2a", "topl_mma")
              + on_path(gtm["splits"], "2a", "round_rows"),
              l32_ms=gtm["select_topl32"],
              l32_device_ms=gtm["select_topl32_device"],
              l32_path_device_ms=tkern["select_topl32"],
              l32_earlier_ms=gtm["select_topl32_simt"],
              l32_earlier_device_ms=gtm["select_topl32_simt_device"],
              plain_l32_ms=gtm["plain_select_topl32"],
              l32_library_ms=gtm["select_topl_gemm"],
              l32_library_bf16_ms=gtm["select_topl_gemm_bf16"],
              l32_library_topk_ms=gtm["select_topl32_gemm_topk"],
              l32_bound_ms=select_bound(B, n, m, outs=ks)["bound_ms"],
              ompr_init_path_device_ms=tkern["select_topl32_2c"],
              srr_init_path_device_ms=tkern["select_topl16_3b"]),
        # its CUDA-core variant: the f32-correlation path runs it; ms is its
        # time on 2a's bf16 inputs, f32_ms on the f32 dictionary
        entry("select_topl", 714, f32g["select_topl"],
              max(gerr["select_topl"], lerr["select_topl"]),
              gtm["select_topl_simt"], gtm["plain_select_topl"],
              select_bound(B, n, m, outs=l),
              also_replaces=[f"{ts_line}:897", f"{ts_line}:1052",
                             f"{ts_line}:1191"],
              paths={"gomp_batch precision=f32": f32g["select_topl"]},
              library_ms=gtm["select_topl_gemm"],
              library_bf16_ms=gtm["select_topl_gemm_bf16"],
              device_ms=gtm["select_topl_simt_device"],
              f32_ms=gtm["select_topl_f32"],
              f32_device_ms=gtm["select_topl_f32_device"],
              f32_bound_ms=select_bound(B, n, m, cdt_bytes=4,
                                        outs=l)["bound_ms"],
              f32_library_ms=gtm["select_topl_f32_gemm_device"],
              f32_library_topk_ms=gtm["select_topl_f32_topk_device"],
              l32_ms=gtm["select_topl32_simt"],
              l32_device_ms=gtm["select_topl32_simt_device"],
              l32_f32_device_ms=gtm["select_topl32_f32_device"],
              l32_f32_bound_ms=select_bound(B, n, m, cdt_bytes=4,
                                            outs=ks)["bound_ms"],
              l32_f32_library_topk_ms=gtm["select_topl32_f32_topk_device"]),
        entry("gomp_append", 714, paths["gomp"]["gomp_append"],
              gerr["gomp_append"], gtm["gomp_append"],
              gtm["plain_gomp_append"], swap_bound["gomp_append 2a"],
              device_ms=swap_dev["gomp_append 2a"],
              plan=swap_plan["gomp_append 2a"]._asdict()),
        # the rescaled select's tensor-core variant: ms is the event time
        # per call at 3a (the stacking launch and the sweep), device_ms the
        # profiler's time of its two kernels, earlier_ms the CUDA-core
        # variant on the same inputs; the same at 3d (B=8 and 64) and at
        # 3b's two calls (16 pending terms, then 2)
        entry("fr_select_mma", 532, paths["fr"]["fr_select_mma"]
              + tl["3b"]["fr_select_mma"]
              + sum(v["fr_select_mma"] for v in sl.values()),
              max(gerr["fr_select_mma"], terr["fr_select_pending"]),
              gtm["fr_select"], gtm["plain_fr_select"],
              select_bound(B, n, m, terms=1),
              source=f"{csrc}/fr_select.cu", main_loop=rescaled_loop,
              also_replaces=fr_replaces,
              paths={"fr_batch": paths["fr"]["fr_select_mma"],
                     "srr_batch": tl["3b"]["fr_select_mma"],
                     **{f"{name}_batch B={b}": v["fr_select_mma"]
                        for (name, b), v in sl.items()}},
              # the yardstick: one f32 torch.matmul of the select's
              # products, and the same product in bf16 on the tensor cores
              library_ms=gtm["fr_select_gemm"],
              library_bf16_ms=gtm["fr_select_gemm_bf16"],
              device_ms=gtm["fr_select_device"],
              path_device_ms=rescaled_on_path(gtm["splits"], "3a"),
              earlier_ms=gtm["fr_select_simt"],
              **{f"rmp_b{b}_{key}": splain[f"fr_select_b{b}_{src}"]
                 for b in (B0, big) for key, src in (
                     ("ms", "call"), ("device_ms", "device"),
                     ("earlier_ms", "simt"), ("library_ms", "gemm"),
                     ("library_bf16_ms", "gemm_bf16"))},
              rmp_b8_path_device_ms=rescaled_on_path(ssplit, d_rmp),
              rmp_b64_path_device_ms=rescaled_on_path(
                  ssplit, f"3d rmp B={big}"),
              plain_rmp_b8_ms=splain["fr_select_b8"],
              rmp_b8_bound_ms=select_bound(B0, n3, m3, terms=1)["bound_ms"],
              rmp_b64_bound_ms=select_bound(big, n3, m3,
                                            terms=1)["bound_ms"],
              srr_path_device_ms=tkern["fr_select_3b"],
              **{f"srr_{P}_{key}": tplain[f"fr_select_{src}_{suf}"]
                 for P, src in ((kr, "init"), (2, "pending2"))
                 for key, suf in (("ms", "call"), ("device_ms", "device"),
                                  ("earlier_ms", "simt"),
                                  ("library_ms", "gemm"),
                                  ("library_bf16_ms", "gemm_bf16"))},
              plain_srr_init_ms=tplain["fr_select_init"],
              plain_srr_pending2_ms=tplain["fr_select_pending2"],
              **{f"srr_{P}_bound_ms": select_bound(B, n, m,
                                                   terms=P)["bound_ms"]
                 for P in (kr, 2)},
              # SRR's first select applies the init's k pending terms, the
              # later ones an append's and a deletion's: the mean launch
              srr_bound_ms=(
                  select_bound(B, n, m, terms=kr)["bound_ms"]
                  + (tl["3b"]["fr_select_mma"] - 1)
                  * select_bound(B, n, m, terms=2)["bound_ms"])
              / tl["3b"]["fr_select_mma"]),
        # its CUDA-core variant: the f32-correlation path runs it; ms is its
        # time on 3a's bf16 inputs, f32_ms on the f32 dictionary
        entry("fr_select", 532, f32fr["fr_select"],
              max(gerr["fr_select"], terr["fr_select_pending_simt"],
                  serr["fr_select_simt"]),
              gtm["fr_select_simt"], gtm["plain_fr_select"],
              select_bound(B, n, m, terms=1), also_replaces=fr_replaces,
              paths={"fr_batch precision=f32": f32fr["fr_select"]},
              library_ms=gtm["fr_select_gemm"],
              library_bf16_ms=gtm["fr_select_gemm_bf16"],
              f32_ms=gtm["fr_select_f32"],
              f32_bound_ms=select_bound(B, n, m, cdt_bytes=4,
                                        terms=1)["bound_ms"],
              grid_max_rel_err=simt_err, grid_resc_err=simt_resc,
              f32_device_ms=gtm["fr_select_f32_device"],
              f32_library_device_ms=gtm["fr_select_gemm_device"],
              main_loop=f"{csrc}/simt_select.cuh",
              rmp_b8_ms=splain["fr_select_b8_simt"],
              srr_16_ms=tplain["fr_select_init_simt"]),
        entry("fr_append", 532, paths["fr"]["fr_append"],
              max(gerr["fr_append"], grid_err[("fr_append", "staged")],
                  grid_err[("fr_append", "streamed")]),
              gtm["fr_append"], gtm["plain_fr_append"],
              engine_bound(B, kf, n, appends=1),
              device_ms=app_dev["fr_append 3a"],
              plan=app_plan["fr_append"]._asdict()),
        entry("sp_round", f"{ts_line}:897", tl["2b"]["sp_round"],
              terr["sp_round"], tkern["sp_round"], tplain["sp_round"],
              # 2k slots, k acquired columns in, the compaction's k out; the
              # blocks G12, G22 and the rebuilt Gram, then O(k^3) solves
              bound(4 * B * (4 * ks * n + 2 * ks * ks + 3 * n)
                    + B * ks * n * 2,
                    B * (6 * ks * ks * n + 8 * ks ** 3), "f32")),
        entry("engine_init", f"{ts_line}:1052", tl["2c"]["engine_init"]
              + tl["3b"]["engine_init"],
              max(terr["engine_init"], eng_err[("engine_init", "staged")],
                  eng_err[("engine_init", "streamed")]),
              tkern["engine_init"], tplain["engine_init"],
              eng_bound["engine_init 2c"],
              also_replaces=[f"{ts_line}:1191"],
              paths={"ompr_batch": tl["2c"]["engine_init"],
                     "srr_batch": tl["3b"]["engine_init"]},
              device_ms=eng_dev["engine_init 2c"],
              device_3b_ms=eng_dev["engine_init 3b"],
              bound_3b_ms=eng_bound["engine_init 3b"]["bound_ms"],
              plan=eng_plan["engine_init 2c"]._asdict(),
              plan_3b=eng_plan["engine_init 3b"]._asdict()),
        entry("ompr_swap", f"{ts_line}:1052", tl["2c"]["ompr_swap"],
              terr["ompr_swap"], tkern["ompr_swap"], tplain["ompr_swap"],
              swap_bound["ompr_swap 2c"], device_ms=swap_dev["ompr_swap 2c"],
              plan=swap_plan["ompr_swap 2c"]._asdict()),
        # ms is the profiler's device time per launch on the path; plan the
        # launch's cluster (rmp_append's plan)
        entry("srr_append", f"{ts_line}:1191", tl["3b"]["srr_append"],
              max(terr["srr_append"], srr_err["staged"],
                  srr_err["streamed"]), tkern["srr_append"],
              tplain["srr_append"], mps_bound["srr_append 3b"],
              plan=mps_plan["srr_append 3b"]._asdict(),
              registers={kn: r for kn, r in mps_regs.items()
                         if kn.startswith("srr_append")}),
        # ms is the profiler's device time per launch on the path; plan the
        # launch's cluster (rmp_append's plan)
        entry("engine_delete", f"{ts_line}:1191", tl["3b"]["engine_delete"],
              max(terr["engine_delete"], del_err[("engine_delete", "staged")],
                  del_err[("engine_delete", "streamed")]),
              del_dev["engine_delete 3b"], tplain["engine_delete"],
              del_bound["engine_delete 3b"],
              plan=del_plan["engine_delete 3b"]._asdict(),
              registers={kn: r for kn, r in del_regs.items()
                         if kn.startswith("engine_delete")}),
        # the stepwise and backward kernels: ms is the profiler's device
        # time per launch on the B=8 path, the bound that launch's
        entry("rmp_append", f"{ts_line}:1368",
              sum(v["rmp_append"] for v in sl.values()),
              max(serr["rmp_append"], serr["rmp_append_foba"],
                  eng_err[("rmp_append", "staged")],
                  eng_err[("rmp_append", "streamed")]),
              eng_dev["rmp_append 3d rmp B=8"], splain["rmp_append"],
              eng_bound["rmp_append B=8"],
              also_replaces=[f"{ts_line}:1499"],
              paths={f"{name}_batch B={b}": v["rmp_append"]
                     for (name, b), v in sl.items()},
              foba_ms=eng_dev["rmp_append 3d foba B=8"],
              plain_foba_ms=splain["rmp_append_foba"],
              b64_ms=eng_dev["rmp_append 3d rmp B=64"],
              b64_foba_ms=eng_dev["rmp_append 3d foba B=64"],
              b64_bound_ms=eng_bound["rmp_append B=64"]["bound_ms"],
              plan=eng_plan["rmp_append B=8"]._asdict(),
              plan_b64=eng_plan["rmp_append B=64"]._asdict()),
        entry("engine_backward", f"{ts_line}:1368",
              sum(v["engine_backward"] for v in sl.values()),
              max(serr["engine_backward"],
                  del_err[("engine_backward", "staged")],
                  del_err[("engine_backward", "streamed")]),
              del_dev["engine_backward 3d rmp B=8"],
              splain["engine_backward"],
              # this run's stage deletes nothing: the first scores and the
              # latch
              del_bound["engine_backward 3d rmp B=8"],
              paths={f"{name}_batch B={b}": v["engine_backward"]
                     for (name, b), v in sl.items() if name == "rmp"},
              b64_ms=del_dev["engine_backward 3d rmp B=64"],
              **{f"deleting_b{b}_{key}": val for b, v in dtm.items()
                 for key, val in (("ms", v["ms"]), ("ndel", v["ndel"]),
                                  ("bound_ms", v["bound"]["bound_ms"]))},
              plan=del_plan["engine_backward B=8"]._asdict(),
              registers={kn: r for kn, r in del_regs.items()
                         if kn.startswith("engine_backward")}),
        entry("bw_select", "cstpu/ops/fused_backward.py:184",
              sum(v["bw_select"] for v in bl.values()), berr["bw_select"],
              on_path(bsplit, d_fbr, "bw_select"),
              bcall[B0]["plain_bw_select"],
              # coef, diag, alive both ways, row p of G in, g and gcol out
              # at 4 bytes an atom; column p of G in at one 32-byte sector
              # an atom (a strided read); ~10 operations an atom. Its real
              # floor is latency: a launch and two cluster barriers
              bound(9 * B0 * m4 * 4 + B0 * m4 * 32, 10 * B0 * m4, "f32"),
              paths={f"{name}_batch B={b}": v["bw_select"]
                     for (name, b), v in bl.items()},
              event_ms=bcall[B0]["bw_select"],
              lace_ms=on_path(bsplit, d_lace, "bw_select"),
              b64_ms=on_path(bsplit, f"3e fbr B={big}", "bw_select"),
              b64_bound_ms=bound(9 * big * m4 * 4 + big * m4 * 32,
                                 10 * big * m4, "f32")["bound_ms"]),
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
    # the streaming selects of the sharded solvers: ms is the event time per
    # call (the wrapper, the sweep and the finishing stage) at 5c's shard
    # shapes, B=8, bf16; the bound is that call's
    stream_src = f"{csrc}/stream_select.cu"
    # the CUDA-core top-1 sweep of K6, K9, K10: its loop, its name in the
    # profile and its largest value error over [simt grid]
    top1_simt = {"main_loop": f"{csrc}/simt_select.cuh",
                 "profile_name": "stream_top1_simt",
                 "grid_max_abs_err": stream_err}
    whole, part = STREAM_WIDTHS
    m5m = SHARD_CELLS["5m"][2]
    omp5c = {f"omp_sharded_fused 5c s={s_} fuse={int(f_)}": v["launches"]
             for (s_, f_), v in p5c.items()}
    omp5m = {f"omp_sharded_fused 5m s={s_} fuse={int(f_)}": v["launches"]
             for (s_, f_), v in p5m.items()}
    ol = {name: v["launches"] for name, v in pother.items()}

    def device_ms(split, key, *names):
        """Profiler device ms per select on path `key`: its kernels' time
        over the launches of the first."""
        got = split[key]["kernels"]
        return sum(got[nm]["ms"] for nm in names) / got[names[0]]["launches"]

    top1_paths = {**omp5c, **omp5m,
                  "mp_sharded_fused 5c": ol["mp"]["select_stream_mma"]}
    mma_loop = f"{csrc}/mma_select.cuh"
    sweep_kernels = ("top1_mma", "round_rows", "stream_finish")
    topl_paths = {f"{name}_sharded_fused 5c":
                  ol[name]["select_topl_stream_mma"]
                  for name in ("gomp", "ompr", "sp")}
    topl_paths[f"srr_sharded_fused s={SHARDS}"] = \
        pfam["srr"]["launches"]["select_topl_stream_mma"]
    wide_paths = {f"{name}_sharded_fused 5c-wide k={WIDE_K}":
                  v["launches"]["stream_topl_finish"]
                  for name, v in pwide.items()}
    topl_paths.update({key: pwide[key.split("_")[0]]["launches"][
        "select_topl_stream_mma"] for key in wide_paths})
    finish_paths = {
        **wide_paths,
        **{f"{name}_sharded_fused 5c": ol[name]["stream_topl_finish"]
           for name in ("gomp", "ompr", "sp")},
        f"srr_sharded_fused s={SHARDS}":
        pfam["srr"]["launches"]["stream_topl_finish"],
        "ompr_sharded_fused 5c corr_dtype=f32": pf32["ompr_finish"]}
    # the f32-correlation paths on K7's CUDA-core sweep (a sweep and a
    # finish a select)
    topl32_paths = {"ompr_sharded_fused 5c corr_dtype=f32": pf32["ompr_topl"],
                    **{f"{name}_sharded_fused 5c corr_dtype=f32": pf32[name]
                       for name in ("gomp", "sp")}}
    finish_paths.update({f"{name}_sharded_fused 5c corr_dtype=f32": pf32[name]
                         for name in ("gomp", "sp")})
    finish_launches = sum(finish_paths.values())

    def stream_library(width, other, prefix="shard_"):
        """The yardsticks of a sweep at `width` (library_ms, the f32
        torch.matmul of R . A_shard, and its bf16 GEMM) and at `other`."""
        return {"library_ms": xper[("select_topl_stream gemm", width)],
                "library_bf16_ms": xper[("select_topl_stream gemm bf16",
                                         width)],
                prefix + "library_ms": xper[("select_topl_stream gemm",
                                             other)],
                prefix + "library_bf16_ms": xper[(
                    "select_topl_stream gemm bf16", other)]}

    def topl_times(width, prefix, variant):
        """K7's times at `width` for the sweep `variant` (" " tensor
        cores, " simt " CUDA cores): l=32 and l=4, the device time of a
        select and of its sweep and finish apart."""
        out = {}
        for l, lp in ((32, ""), (4, "l4_")):
            pre = f"select_topl_stream l={l}{variant}"
            out[f"{prefix}{lp}device_ms"] = xper[(pre + "device", width)]
            out[f"{prefix}{lp}sweep_device_ms"] = xper[(pre + "sweep device",
                                                         width)]
            out[f"{prefix}{lp}finish_device_ms"] = xper[(
                pre + "finish device", width)]
            if prefix or lp:
                key = f"select_topl_stream l={l}" + (
                    " simt" if "simt" in variant else "")
                out[f"{prefix}{lp}ms"] = xper[(key, width)]
                out[f"{prefix}{lp}plain_ms"] = xper[(
                    f"plain_select_topl_stream l={l}", width)]
                out[f"{prefix}{lp}bound_ms"] = stream_bound(
                    B5, n5, width, l=l)["bound_ms"]
                out[f"{prefix}{lp}library_topk_ms"] = xper[(
                    f"select_topl_stream l={l} gemm topk", width)]
        return out

    def f32_sweep(name, tag=""):
        """A CUDA-core sweep's device ms a call on the f32 dictionary
        (f32_ at the whole width, f32_shard_ at the shard's, a column
        view), its f32 bound and one f32 torch.matmul R . A_shard (for the
        top-l, also that matmul + torch.topk(l) a tile)."""
        out = {}
        for prefix, width in ((f"f32_{tag}", whole),
                              (f"f32_shard_{tag}", part)):
            out[prefix + "device_ms"] = xper[(name + " f32 device", width)]
            out[prefix + "bound_ms"] = xper[(name + " f32 bound", width)]
            out[prefix + "library_ms"] = xper[("f32 gemm", width)]
            if "topl" in name:
                out[prefix + "library_topk_ms"] = xper[(
                    f"f32 gemm topk {name.split()[-1]}", width)]
        return out

    def finish_bound(width, l):
        """The finish reads the sweep's partials (B, width / 128, l) pairs
        once and writes l pairs a row; a few operations a candidate."""
        nbytes = B5 * (width // 128) * l * 8 + B5 * l * 8
        return bound(nbytes, 8 * B5 * (width // 128) * l, "f32")
    kernels += [
        # the tensor-core sweeps: ms per call by events, device_ms the
        # profiler's time of a select's three kernels, earlier_ms the
        # CUDA-core sweep on the same inputs
        entry("select_stream_mma", f"{TPU_SELECT}:88",
              sum(top1_paths.values()),
              max(xerr["select_stream_mma"], merr["select_stream_mma"]),
              xper[("select_stream", whole)],
              xper[("plain_select_stream", whole)],
              stream_bound(B5, n5, whole), source=stream_src,
              main_loop=mma_loop, paths=top1_paths,
              device_ms=xper[("select_stream device", whole)],
              path_device_ms=device_ms(xsplit, "5c omp s=1 fuse=1",
                                       *sweep_kernels),
              earlier_ms=xper[("select_stream simt", whole)],
              shard_ms=xper[("select_stream", part)],
              shard_device_ms=xper[("select_stream device", part)],
              shard_earlier_ms=xper[("select_stream simt", part)],
              shard_plain_ms=xper[("plain_select_stream", part)],
              shard_bound_ms=stream_bound(B5, n5, part)["bound_ms"],
              **stream_library(whole, part),
              m5_ms=sweep5m,
              m5_earlier_ms=sweep5m_simt,
              m5_device_ms=device_ms(split5m, "5m omp s=1 fuse=1",
                                     *sweep_kernels),
              m5_bound_ms=stream_bound(B5, n5, m5m)["bound_ms"]),
        entry("select_stream", f"{TPU_SELECT}:88", pf32["omp"],
              max(xerr["select_stream"], merr["select_stream"]),
              xper[("select_stream simt", whole)],
              xper[("plain_select_stream", whole)],
              stream_bound(B5, n5, whole), source=stream_src,
              paths={"omp_sharded_fused 5c corr_dtype=f32": pf32["omp"]},
              shard_ms=xper[("select_stream simt", part)],
              shard_bound_ms=stream_bound(B5, n5, part)["bound_ms"],
              m5_ms=sweep5m_simt,
              m5_bound_ms=stream_bound(B5, n5, m5m)["bound_ms"],
              **top1_simt,
              **f32_sweep("select_stream")),
        # the top-l select (K7) at the shard's width, l=32 (sp, ompr): its
        # tensor-core sweep and the finish, per call by events; device_ms
        # the profiler's, sweep and finish apart; l4_ at gomp's l, whole_
        # at 5c's whole width on one shard
        entry("select_topl_stream_mma", f"{TPU_SELECT}:187",
              sum(topl_paths.values()),
              max(xerr["select_topl_stream_mma"],
                  lerr["select_topl_stream_mma"]),
              xper[("select_topl_stream l=32", part)],
              xper[("plain_select_topl_stream l=32", part)],
              stream_bound(B5, n5, part, l=32), source=stream_src,
              main_loop=f"{csrc}/mma_topl.cuh", paths=topl_paths,
              **stream_library(part, whole, "whole_"),
              library_topk_ms=xper[("select_topl_stream l=32 gemm topk",
                                    part)],
              **topl_times(part, "", " "),
              path_device_ms=device_ms(xsplit, f"5c sp s={SHARDS}",
                                       "topl_mma", "round_rows",
                                       "stream_topl_merge",
                                       "stream_topl_fold"),
              l4_path_device_ms=device_ms(xsplit, f"5c gomp s={SHARDS}",
                                          "topl_mma", "round_rows",
                                          "stream_topl_merge",
                                          "stream_topl_fold"),
              **topl_times(whole, "whole_", " ")),
        # its CUDA-core sweep (simt_select.cuh): the f32-correlation paths
        # run it; ms is its time on the bf16 inputs above (the catch-all),
        # with the same finish
        entry("select_topl_stream", f"{TPU_SELECT}:187",
              sum(topl32_paths.values()),
              max(xerr["select_topl_stream"], lerr["select_topl_stream"],
                  stream_topl_err),
              xper[("select_topl_stream l=32 simt", part)],
              xper[("plain_select_topl_stream l=32", part)],
              stream_bound(B5, n5, part, l=32), source=stream_src,
              main_loop=f"{csrc}/simt_select.cuh",
              profile_name="stream_topl_simt",
              grid_max_abs_err=stream_topl_err,
              paths=topl32_paths,
              **stream_library(part, whole, "whole_"),
              **topl_times(part, "", " simt "),
              **topl_times(whole, "whole_", " simt "),
              **f32_sweep("select_topl_stream l=32"),
              **f32_sweep("select_topl_stream l=4", "l4_")),
        # the finish of both sweeps: merge and fold, per call by events on
        # the sweep's partials at the shard's width; device_ms the
        # profiler's within a select
        entry("stream_topl_finish", f"{TPU_SELECT}:187", finish_launches,
              xerr["stream_topl_finish"],
              xper[("stream_topl_finish l=32", part)],
              xper[("plain_stream_topl_finish l=32", part)],
              finish_bound(part, 32), source=stream_src,
              paths=finish_paths,
              device_ms=xper[("select_topl_stream l=32 finish device", part)],
              l4_ms=xper[("stream_topl_finish l=4", part)],
              l4_plain_ms=xper[("plain_stream_topl_finish l=4", part)],
              l4_device_ms=xper[("select_topl_stream l=4 finish device",
                                 part)],
              l4_bound_ms=finish_bound(part, 4)["bound_ms"],
              whole_ms=xper[("stream_topl_finish l=32", whole)],
              whole_plain_ms=xper[("plain_stream_topl_finish l=32", whole)],
              whole_device_ms=xper[("select_topl_stream l=32 finish device",
                                    whole)],
              whole_bound_ms=finish_bound(whole, 32)["bound_ms"],
              # past 128 slots (the wide route): the whole select at
              # m_local and l, its sweep, merge and fold apart, the f32
              # sweep's select at l=160, bound and bf16 GEMM + topk
              wide_max_abs_err=max(v for k_, v in werr.items()
                                   if "select" in k_),
              wide={f"m_local={ml} l={l_}": rec
                    for (ml, l_), rec in wtm.items()}),
        entry("select_masked_stream_mma", f"{TPU_SELECT}:385",
              ol["ompr"]["select_masked_stream_mma"],
              max(xerr["select_masked_stream_mma"],
                  merr["select_masked_stream_mma"]),
              xper[("select_masked_stream", part)],
              xper[("plain_select_masked_stream", part)],
              stream_bound(B5, n5, part, masked=True), source=stream_src,
              main_loop=mma_loop,
              paths={"ompr_sharded_fused 5c":
                     ol["ompr"]["select_masked_stream_mma"]},
              device_ms=xper[("select_masked_stream device", part)],
              earlier_ms=xper[("select_masked_stream simt", part)],
              whole_ms=xper[("select_masked_stream", whole)],
              whole_device_ms=xper[("select_masked_stream device", whole)],
              whole_earlier_ms=xper[("select_masked_stream simt", whole)],
              whole_plain_ms=xper[("plain_select_masked_stream", whole)],
              whole_bound_ms=stream_bound(B5, n5, whole,
                                          masked=True)["bound_ms"],
              **stream_library(part, whole, "whole_")),
        entry("select_masked_stream", f"{TPU_SELECT}:385", pf32["ompr"],
              max(xerr["select_masked_stream"],
                  merr["select_masked_stream"]),
              xper[("select_masked_stream simt", part)],
              xper[("plain_select_masked_stream", part)],
              stream_bound(B5, n5, part, masked=True), source=stream_src,
              paths={"ompr_sharded_fused 5c corr_dtype=f32": pf32["ompr"]},
              whole_ms=xper[("select_masked_stream simt", whole)],
              whole_bound_ms=stream_bound(B5, n5, whole,
                                          masked=True)["bound_ms"],
              **top1_simt,
              **f32_sweep("select_masked_stream")),
        entry("corr_argmax_mma", f"{TPU_ARGMAX}:86", k10_launches,
              max(xerr["corr_argmax_mma"], merr["corr_argmax_mma"]),
              xper[("corr_argmax", whole)],
              xper[("plain_corr_argmax", whole)],
              stream_bound(B5, n5, whole), source=stream_src,
              main_loop=mma_loop,
              paths={"correlate_argmax 5c": k10_launches},
              device_ms=xper[("corr_argmax device", whole)],
              earlier_ms=xper[("corr_argmax simt", whole)],
              shard_ms=xper[("corr_argmax", part)],
              shard_device_ms=xper[("corr_argmax device", part)],
              shard_earlier_ms=xper[("corr_argmax simt", part)],
              shard_plain_ms=xper[("plain_corr_argmax", part)],
              **stream_library(whole, part)),
        entry("corr_argmax", f"{TPU_ARGMAX}:86", pf32["corr_argmax"],
              max(xerr["corr_argmax"], merr["corr_argmax"]),
              xper[("corr_argmax simt", whole)],
              xper[("plain_corr_argmax", whole)],
              stream_bound(B5, n5, whole), source=stream_src,
              paths={"correlate_argmax 5c f32": pf32["corr_argmax"]},
              shard_ms=xper[("corr_argmax simt", part)],
              **top1_simt,
              **f32_sweep("corr_argmax")),
    ]
    # fr_step_select: as the streaming selects, at B=8, bf16, the whole 5c
    # width without V; the shard's width and the V variant beside it. Its
    # tensor-core variant: ms per call by events (the stacking launch, the
    # sweep and the finishing stage), device_ms the profiler's, earlier_ms
    # the CUDA-core sweep on the same inputs
    fr_paths = {f"fr_sharded_fused s={s_} fuse={int(f_)}": v["launches"]
                for (s_, f_), v in pfr.items()}
    fam_paths = {f"{name}_sharded_fused s={SHARDS}":
                 pfam[name]["launches"]["fr_step_select_mma"]
                 for name in ("srr", "rmp", "foba")}
    k8_kernels = ("rescaled_mma", "round_rows", "stream_finish")

    def k8(prefix, name, width):
        """The K8 numbers of one shape: per call, device, CUDA-core, plain,
        library, bound."""
        v = " V" in name
        return {f"{prefix}ms": fper[(name, width)],
                f"{prefix}device_ms": fper[(name + " device", width)],
                f"{prefix}earlier_ms": fper[(name + " simt", width)],
                f"{prefix}plain_ms": fper[("plain_" + name, width)],
                f"{prefix}library_ms": fper[(name + " gemm", width)],
                f"{prefix}library_bf16_ms": fper[(name + " gemm bf16",
                                                   width)],
                f"{prefix}bound_ms": fr_step_bound(B5, n5, width,
                                                   use_v=v)["bound_ms"]}

    kernels.append(entry(
        "fr_step_select_mma", f"{TPU_SELECT}:322",
        sum(fr_paths.values()) + sum(fam_paths.values()),
        frerr["fr_step_select_mma"], fper[("fr_step_select", whole)],
        fper[("plain_fr_step_select", whole)], fr_step_bound(B5, n5, whole),
        source=f"{csrc}/fr_step_select.cu", main_loop=rescaled_loop,
        paths={**fr_paths, **fam_paths}, resc_max_abs_err=frerr["resc"],
        library_ms=fper[("fr_step_select gemm", whole)],
        library_bf16_ms=fper[("fr_step_select gemm bf16", whole)],
        device_ms=fper[("fr_step_select device", whole)],
        earlier_ms=fper[("fr_step_select simt", whole)],
        path_device_ms=device_ms(fsplit, "3a-wide fr s=1 fuse=1",
                                 *k8_kernels),
        **k8("v_", "fr_step_select V", whole),
        **k8("shard_", "fr_step_select", part),
        **k8("shard_v_", "fr_step_select V", part),
        shard_path_device_ms=device_ms(fsplit, f"3a-wide fr s={SHARDS} "
                                       "fuse=1", *k8_kernels),
        srr_path_device_ms=device_ms(fsplit, f"3b-wide srr s={SHARDS}",
                                     *k8_kernels)))
    # its CUDA-core variant: the f32-correlation paths run it; ms is its
    # time on the bf16 inputs above, f32_* its device times on the f32
    # shard (at `part`, a column view) beside the f32 bound and library call
    def k8_f32(prefix, name, width):
        return {f"{prefix}device_ms": fper[(name + " f32 device", width)],
                f"{prefix}library_ms": fper[(name + " f32 gemm", width)],
                f"{prefix}bound_ms": fr_step_bound(
                    B5, n5, width, cdt_bytes=4,
                    use_v=" V" in name)["bound_ms"]}

    kernels.append(entry(
        "fr_step_select", f"{TPU_SELECT}:322", sum(pfr32.values()),
        frerr["fr_step_select"], fper[("fr_step_select simt", whole)],
        fper[("plain_fr_step_select", whole)], fr_step_bound(B5, n5, whole),
        paths=pfr32, main_loop=f"{csrc}/simt_select.cuh",
        library_ms=fper[("fr_step_select gemm", whole)],
        library_bf16_ms=fper[("fr_step_select gemm bf16", whole)],
        v_ms=fper[("fr_step_select V simt", whole)],
        shard_ms=fper[("fr_step_select simt", part)],
        shard_v_ms=fper[("fr_step_select V simt", part)],
        **k8_f32("f32_", "fr_step_select", whole),
        **k8_f32("f32_v_", "fr_step_select V", whole),
        **k8_f32("f32_shard_", "fr_step_select", part),
        **k8_f32("f32_shard_v_", "fr_step_select V", part)))
    assert all(kn["launches"] > 0 for kn in kernels)
    assert all({"bound_ms", "bound_by", "library_ms"} <= set(kn)
               for kn in kernels)
    print(json.dumps({"sharded": {
        "solve_ms": {**xtm, **tm5m},
        "idle_share": {key: v["idle_share"]
                       for key, v in {**xsplit, **split5m}.items()},
        "device_busy_ms": {key: v["device_busy_ms"]
                           for key, v in {**xsplit, **split5m}.items()},
        "paths": {**{key: p5c[(s_, f_)] for key, (s_, f_) in zip(
            omp5c, p5c)}, **{key: p5m[(s_, f_)] for key, (s_, f_) in zip(
                omp5m, p5m)},
            **{name: {key: v for key, v in rec.items() if key != "launches"}
               for name, rec in pother.items()},
            **{f"{name} 5c-wide k={WIDE_K}": {
                key: v for key, v in rec.items() if key != "launches"}
               for name, rec in pwide.items()}},
        "peak_gib_5m": peak5m, "device": gpu}}))
    print(json.dumps({"sharded_fr": {
        "solve_ms": ftm,
        "idle_share": {key: v["idle_share"] for key, v in fsplit.items()},
        "device_busy_ms": {key: v["device_busy_ms"]
                           for key, v in fsplit.items()},
        "paths": {**{key: pfr[(s_, f_)] for key, (s_, f_) in zip(
            fr_paths, pfr)},
            **{name: {key: v for key, v in rec.items() if key != "launches"}
               for name, rec in pfam.items()}},
        "omp_sharded_rows": prow, "device": gpu}}))
    print(json.dumps({"greedy": {
        "solve_ms": {key: gtm[key] for key in ("mp", "gomp", "fr")},
        "idle_share": {key: v["idle_share"]
                       for key, v in gtm["splits"].items()},
        "device_busy_ms": {key: v["device_busy_ms"]
                           for key, v in gtm["splits"].items()},
        "device": gpu}}))
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
    print(json.dumps({"sbl": {**sbl_out, "device": gpu}}))
    print(json.dumps({"convex": {**convex_out, "device": gpu}}))
    print(json.dumps({"distributed": {**dist_out, "device": gpu},
                      "examples_s": examples_out}))
    print(json.dumps({"surface": surface_out, "fuzz": fuzz_out,
                      "topl_wide": {f"m_local={ml} l={l_}": rec
                                    for (ml, l_), rec in wtm.items()},
                      "device": gpu}))
    print(json.dumps({"rows": rows_out, "device": gpu}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(dist_worker(sys.argv[2:]) if sys.argv[1:2] == ["--dist-worker"]
             else main())
