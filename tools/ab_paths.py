"""Device time per launch of every kernel on the batched update paths of one
checkout, for A/B runs of two checkouts on the same card.

    python3 tools/ab_paths.py ROOT TAG

ROOT is a checkout of the repo (this one, or another unpacked with `git
archive` into a directory that .gitignore lists); its cstpu_torch is
built from its own sources and imported. The problems and the profiling
are this script's own checkout's chip_smoke.py (loaded from its file), so
two checkouts are measured alike. TAG labels the output lines. The
paths are chip_smoke.py's, on its problems (seed 0, NVIDIA H100 shapes):
the bench OMP solve, suite configs 2a (gomp_batch), 2b (sp_batch), 2c
(ompr_batch), 3a (fr_batch), 3b (srr_batch), each profiled over three
solves, 3e (fbr_batch at B = 8 and 64) over one, 5b (omp_batch at
m = 131072), 3d (rmp_batch and foba_batch at B = 8 and 64) and mp
(mp_batch at the bench size, chip_smoke.MP_CELL) over three; then
engine_backward's deleting stage (chip_smoke.deleting_times: 3d's state
after its forward stage, the k rule down to chip_smoke.DELETE_KFINAL
atoms, at B = 8 and 64), which no path times.

    python3 tools/ab_paths.py ROOT TAG --rows

times only the calls of chip_smoke.py's [rows] phase (chip_smoke.rows_calls
on chip_smoke.rows_problems: the entry points' paths that leave the
kernels, which a checkout before the batched bodies runs as a loop over
rows): per call, after a warm-up on one row, the wall ms (CUDA events) and
the device busy ms (one profiled call), and the steps and latch reads
where the checkout counts them.

    python3 tools/ab_paths.py ROOT TAG --rows --sharded

adds (or, alone, times only) 5c-wide's SP (sp_sharded_fused at k =
chip_smoke.WIDE_K on chip_smoke.SHARDS shards of 5c's problem, the
sharded body whose torch operations on the batched active-set engine at
2k slots take most of its device time): wall ms (CUDA events,
chip_smoke.cuda_ms: the median of up to chip_smoke.TIMED_SLOW solves) and device busy ms (one profiled solve).
Each line gives the update kernels' registers (the deletion kernels'
spill stores beside theirs), the device busy ms per
solve (torch.profiler: the union of the device spans; beside it their
sum, and the sum over key_averages that chip_smoke.py reported before,
which counts torch's kernels twice), the wall ms per solve (host clock,
the same solves again unprofiled) and, per kernel, its launches per solve
and its device ms per launch (torch.profiler). Run two checkouts
alternately in one call (A, B, B, A): a card's speed varies between
calls.
"""

import importlib.util
import os
import re
import sys
import time
from pathlib import Path


def own_chip_smoke():
    """This checkout's chip_smoke.py, whatever ROOT is."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("ab_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def update_registers(log):
    """(kernel, registers) of the update kernels' instantiations in an
    nvcc -Xptxas -v log, by their mangled names' stems; for engine_delete
    and engine_backward (templated on the staging alone, or, in checkouts
    before their cluster redesign, not templated) the registers and the
    spill stores."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        props = " ".join(lines[i + 1:i + 3])
        regs = re.search(r"Used (\d+) registers", props)
        got = re.search(r"Function properties for _ZN5cstpu\d+(\w+?_kernel)"
                        r"I(13__nv_bfloat16|f)(Lb[01]E)?", line)
        if got and regs and not got[1].startswith(
                ("select", "fr_select", "fr_step", "stream")):
            cdt = "bf16" if got[2].startswith("13") else "f32"
            inst = {"Lb1E": " staged", "Lb0E": " streamed"}.get(got[3], "")
            out.append((f"{got[1][:-7]} {cdt}{inst}", int(regs[1])))
        got = re.search(r"Function properties for _ZN5cstpu\d+"
                        r"(engine_delete|engine_backward)_kernel(ILb[01]E|E)",
                        line)
        if got and regs:
            inst = {"ILb1E": " staged", "ILb0E": " streamed"}.get(got[2],
                                                                 " one block")
            spill = re.search(r"(\d+) bytes spill stores", props)[1]
            out.append((f"{got[1]}{inst}",
                        f"{regs[1]} (spill stores {spill} B)"))
    return out


def rows(cs, tag):
    """The [rows] calls, timed as chip_smoke.rows_call times them: after a
    warm-up on one row, the wall ms of one call (CUDA events, launch and
    loop counts zeroed just before) and the device busy ms of one profiled
    call. A checkout before the batched bodies counts no steps or latch
    reads (it has no ops.util.LOOP_COUNTS)."""
    import torch
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import util

    loop_counts = getattr(util, "LOOP_COUNTS", None)
    probs = cs.rows_problems(torch.device("cuda", 0))
    for name, cell, entry in cs.rows_calls(probs):
        A, Bs, sup = probs[cell]
        entry(A, Bs[:1])
        for counts in (fs.LAUNCHES, loop_counts or {}):
            for key in counts:
                counts[key] = 0
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        sol = entry(A, Bs)
        t1.record()
        torch.cuda.synchronize()
        wall = t0.elapsed_time(t1)
        launches = sum(fs.LAUNCHES.values())
        loops = (dict(loop_counts) if loop_counts is not None else
                 {"steps": "not counted", "latch_reads": "not counted"})
        busy, _ = cs.top_device_ops(lambda: entry(A, Bs), top=None)
        print(f"[ab {tag}] rows {cell} {name} B={Bs.shape[0]}: wall "
              f"{wall:.3f} ms, busy {busy:.3f} ms, idle share "
              f"{max(0.0, 1.0 - busy / wall):.3f}, recovery "
              f"{cs.recovery(sol, sup):.3f}, steps {loops['steps']}, latch "
              f"reads {loops['latch_reads']}, launches {launches}",
              flush=True)


def sharded_sp(cs, tag):
    """5c-wide's SP, timed as chip_smoke.sharded_wide_paths times it."""
    import torch

    import cstpu_torch

    dev = torch.device("cuda", 0)
    B, n, m, k = cs.SHARD_CELLS["5c"]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    A = cs.unit_dictionary(gen, n, m)
    Bs, sup = cs.planted_pm1(gen, A, B, k)
    mesh = cstpu_torch.make_mesh((1, cs.SHARDS))
    Ash = cstpu_torch.shard_dictionary(A, mesh)

    def call():
        return cstpu_torch.sp_sharded_fused(Ash, Bs, cs.WIDE_K, mesh)

    rec = cs.recovery(call(), sup)
    ms = cs.cuda_ms(lambda: call().val.sum(), cs.TIMED_SLOW)
    sp_ = cs._split(ms, call)
    print(f"[ab {tag}] 5c-wide sp_sharded_fused k={cs.WIDE_K} shards="
          f"{cs.SHARDS} B={B}: wall {ms:.3f} ms, busy "
          f"{sp_['device_busy_ms']:.3f} ms, idle share "
          f"{sp_['idle_share']:.3f}, recovery {rec:.3f}", flush=True)


def main():
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_paths: needs an NVIDIA GPU")
    cs = own_chip_smoke()
    import cstpu_torch
    from cstpu_torch.ops import _build
    from cstpu_torch.utils.data import correlated_data, sparse_data

    assert _build.PKG.parent == Path(root), _build.PKG
    torch.backends.cuda.matmul.allow_tf32 = False
    _, log = _build.build()
    print(f"[ab {tag}] {cs.gpu_line()}")
    if {"--rows", "--sharded"} & set(sys.argv[3:]):
        if "--rows" in sys.argv[3:]:
            rows(cs, tag)
        if "--sharded" in sys.argv[3:]:
            sharded_sp(cs, tag)
        return None
    print(f"[ab {tag}] registers: " + ", ".join(
        f"{kn} {regs}" for kn, regs in update_registers(log)))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    _, B, n, m, k = cs.MP_CELL
    A, Bs, _ = cs.planted(gen, B, n, m, k)
    Bg, _ = cs.planted_ones(gen, A, B, cs.GOMP_CELL[4])

    def show(name, fn, reps=3):
        busy, tot, per = cs.profile_path(fn, reps, totals=True)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        print(f"[ab {tag}] {name} busy/solve {busy / reps:.4f} ms (sum "
              f"{tot['sum'] / reps:.4f}, key_averages "
              f"{tot['key_averages'] / reps:.4f}), wall/solve {wall:.4f} ms: "
              + ", ".join(
            f"{kn} {c // reps}x {ms / c if c else ms / reps:.4f}"
            for kn, (c, ms) in sorted(per.items())), flush=True)

    show("bench omp", lambda: cstpu_torch.omp_batch(A, Bs, k))
    show("2a", lambda: cstpu_torch.gomp_batch(A, Bg, cs.GOMP_CELL[5],
                                             cs.GOMP_CELL[4]))
    show("2b", lambda: cstpu_torch.sp_batch(A, Bg, cs.SP_CELL[1],
                                           **cs.SP_CELL[2]))
    show("2c", lambda: cstpu_torch.ompr_batch(A, Bg, cs.OMPR_CELL[1],
                                             **cs.OMPR_CELL[2]))
    _, _, _, _, kf, decay = cs.FR_CELL
    Ar = correlated_data(gen, n, m, kf, decay=decay)[0].contiguous()
    Br, _ = cs.planted_ones(gen, Ar, B, kf)
    show("3a fr", lambda: cstpu_torch.fr_batch(Ar, Br, sparsity=kf))
    show("3b srr", lambda: cstpu_torch.srr_batch(Ar, Br, cs.SRR_CELL[1],
                                                 **cs.SRR_CELL[2]))
    _, n2, m2, k2 = cs.BW_CELL
    A2 = sparse_data(gen, n2, m2, 1)[0].contiguous()
    for B3 in cs.BATCHES:
        Bs3, _ = cs.planted_ones(gen, A2, B3, k2)
        show(f"3e fbr B={B3}",
             lambda: cstpu_torch.fbr_batch(A2, Bs3, sparsity=k2), 1)
    del A, Bs, Bg, Ar, Br, A2
    torch.cuda.empty_cache()
    # 5b on a generator of its own, so that the problems above stay the
    # ones of checkouts whose ab_paths.py had no 5b
    _, B5, n5, m5, k5 = cs.CELLS[1]
    gen5 = torch.Generator(device=dev).manual_seed(cs.SEED)
    A5, Bs5, _ = cs.planted(gen5, B5, n5, m5, k5)
    show("5b omp", lambda: cstpu_torch.omp_batch(A5, Bs5, k5))
    del A5, Bs5
    torch.cuda.empty_cache()
    # 3d on a generator of its own too: rmp_batch and foba_batch on the
    # bench's unit-norm dictionary, 16 planted ones a row, B = 8 and 64
    _, n3, m3, k3, delta, kmax = cs.STEP_CELL
    gen3 = torch.Generator(device=dev).manual_seed(cs.SEED)
    A3, _, _ = cs.planted(gen3, 1, n3, m3, 1)
    probs3 = {}
    for B3 in cs.BATCHES:
        Bs3, _ = cs.planted_ones(gen3, A3, B3, k3)
        probs3[B3] = Bs3
        show(f"3d rmp B={B3}", lambda: cstpu_torch.rmp_batch(
            A3, Bs3, delta=delta, kmax=kmax))
        show(f"3d foba B={B3}", lambda: cstpu_torch.foba_batch(
            A3, Bs3, delta, kmax=kmax))
    # engine_backward deleting: 3d's forward stage, then the k rule down to
    # DELETE_KFINAL atoms, TIMED_LAUNCHES launches on fresh copies
    for B3, v in cs.deleting_times(A3, probs3).items():
        print(f"[ab {tag}] 3d deleting B={B3}: engine_backward "
              f"{v['ndel']} deletions a row, {v['ms']:.4f} ms a launch "
              f"(bound {v['bound']['bound_ms']:.6f}, {v['bound']['bound_by']};"
              f" plan {v['plan']._asdict()})", flush=True)
    del A3, Bs3, probs3
    # mp on a generator of its own too: mp_batch on chip_smoke's MP problem
    # (the bench's planted rows, unit-norm dictionary)
    _, Bm, nm, mm, km = cs.MP_CELL
    genm = torch.Generator(device=dev).manual_seed(cs.SEED)
    Am, Bsm, _ = cs.planted(genm, Bm, nm, mm, km)
    show("mp", lambda: cstpu_torch.mp_batch(Am, Bsm, km))


if __name__ == "__main__":
    main()
