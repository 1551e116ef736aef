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
    python3 tools/ab_paths.py ROOT TAG --f32 [OUT]

times only the true-f32 selects (the CUDA-core variants of select_argmax,
fr_select, select_topl, fr_step_select and the streaming top-1 and top-l
selects): device ms per launch
(chip_smoke.device_ms_per_call) of the top-1 select at the bench shape
(B = 64, n = 1024, m = 8192; |s|, signed and masked) and at 5b's (m =
131072), of fr_select at 3a's (one pending term) and with SRR's first
call's 16 terms, beside the f32 torch.matmul of the same products; of
select_topl at 2a (l = 4) and 2b (l = 32), beside the f32 torch.matmul
and torch.topk a tile and the matmul alone; of fr_step_select (sweep and
finish) with and without V on 3a-wide's problem at m_local = 131072 and
on a four-shard column view at 32768, beside the f32 matmul of its
products and its bound; of the top-1 sweep under K6, K9 and K10 (K10 also
on a contiguous copy of R) at the 32768 view and at 131072 on one shard,
B = 8, and at the view at B = 64, and of K7's CUDA-core sweep and finish
at l = 4, 32 and 160 (B = 8, both widths) and at l = 32 at B = 64 (the
view) beside the f32 matmul and torch.topk(l) a tile (past 128, a row),
on 5c's f32 dictionary (a generator of its own); of the same top-1 and
top-l sweeps and of fr_step_select on a bf16 copy forced onto CUDA cores
(the catch-all; B = 8, both widths; beside the bf16 matmul); and the f32
solves omp_batch, fr_batch and gomp_batch (precision="f32", at the bench,
3a and 2a), fr_sharded_fused (one shard and four) and srr_sharded_fused
(four) with corr_dtype=f32 on 3a-wide's problem, and omp_sharded_fused,
ompr_sharded_fused, mp_sharded_fused, gomp_sharded_fused (l = 4) and
sp_sharded_fused (one shard and four) with corr_dtype=f32 on 5c's (wall
ms by events, device busy ms, per kernel
launches and device ms). It saves every output (partials,
rescalings, solutions) to OUT/ab_f32_TAG.pt (OUT: this checkout's
build/ab_f32 by default) and holds them bit for bit against every other
TAG's file there: run the parent and the change in turn on one machine.

    python3 tools/ab_paths.py ROOT TAG --fr-step-plans C,S [C,S ...]

times fr_step_select's sweep, the top-1 sweep (K6, K9, K10) and the top-l
sweep (K7 at l = 4, 32, 160) at B = 8, in f32 and on a bf16 copy (the
catch-all), as --f32 does, under each
few-row plan of C entries of n a stage
in a ring of S stages: a process a plan, each building ROOT's library with
-DCSTPU_FEW_CHUNK=C -DCSTPU_FEW_STAGES=S into cstpu_torch/build/plan_CxS
(simt_select.cuh); the outputs go to build/ab_plans and are held bit for
bit across the plans.
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


def wide_problem(cs, dev):
    """3a-wide's problem (chip_smoke.FR5_K on correlated_data(decay=
    chip_smoke.FR5_DECAY) at 5c's shape, B = 8, n = 1024, m = 131072) on a
    generator of its own: (A, Br, sup)."""
    import torch

    from cstpu_torch.utils.data import correlated_data

    B, n, m, _ = cs.SHARD_CELLS["5c"]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    A = correlated_data(gen, n, m, cs.FR5_K, decay=cs.FR5_DECAY)[0]
    A = A.contiguous()
    Br, sup = cs.planted_ones(gen, A, B, cs.FR5_K)
    return A, Br, sup


def fr_steps(cs, tag, dev, cdt=None):
    """K8's CUDA-core sweep in f32 (or, with cdt = torch.bfloat16, on a bf16
    copy: the catch-all, forced with mma=False) on 3a-wide's problem, with
    and without V: on the whole dictionary as one shard (m_local = 131072,
    contiguous) and on its first quarter as a column view (m_local = 32768,
    lda = 4 m_local, one of four shards); device ms a call (the sweep and
    the finish) beside one torch.matmul of its products [R; W (; V)] . A in
    the dictionary's dtype. Returns the outputs of one call from a fresh
    rescaling each."""
    import torch

    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import stream_select as ss

    A, Br, _ = wide_problem(cs, dev)
    bf16 = cdt == torch.bfloat16
    if bf16:
        A = A.to(cdt)
    B, n = Br.shape
    deg = fs._degeneracy_rtol(n)
    il = torch.full((B, 2), -1, dtype=torch.int32, device=dev)
    il[1, 0], il[2, 1] = 77, 40          # a mark and a restore
    W = 1e-2 * Br / n ** 0.5
    V = 0.5 * W.flip(0)
    outputs = {}
    what = "bf16 catch-all" if bf16 else "f32"
    for width in cs.STREAM_WIDTHS:
        As = A[:, :width]
        cn2 = torch.sum(As.float() ** 2, dim=0)
        resc0 = cn2.repeat(B, 1)
        resc0[:, 40] = -1.0
        for name, Vv in (("fr_step_select", None), ("fr_step_select V", V)):
            resc = resc0.clone()

            def call(resc=resc, Vv=Vv):
                return ss.fr_step_select(As, Br, W, il, cn2, resc, deg, V=Vv,
                                         mma=False)

            prods = torch.cat([Br, W] + ([Vv] if Vv is not None else []))
            ms = cs.device_ms_per_call(call)
            lib = cs.device_ms_per_call(
                lambda: torch.matmul(prods.to(As.dtype), As))
            key = f"{name} {width}" + (" bf16" if bf16 else "")
            got = ss.fr_step_select(As, Br, W, il, cn2, resc0.clone(), deg,
                                    V=Vv, mma=False)
            outputs[key] = [x.cpu() for x in got]
            bnd = cs.fr_step_bound(B, n, width, cdt_bytes=As.element_size(),
                                   use_v=Vv is not None)
            print(f"[ab {tag}] {what} {key} (lda {As.stride(0)}): "
                  f"{cs.ms4(ms)} ms a call on the device (sweep and finish), "
                  f"torch.matmul {what[:4]} of its products {cs.ms4(lib)}; "
                  f"bound {bnd['bound_ms']:.4f} by {bnd['bound_by']}",
                  flush=True)
    return outputs


def sharded_f32_solves(cs, dev):
    """fr_sharded_fused on one shard and on four and srr_sharded_fused on
    four, corr_dtype=f32, on 3a-wide's problem: (name, solve) pairs."""
    import torch

    import cstpu_torch

    A, Br, _ = wide_problem(cs, dev)
    f32 = torch.float32
    out = []
    for s in (1, cs.SHARDS):
        mesh = cstpu_torch.make_mesh((1, s))
        Ash = cstpu_torch.shard_dictionary(A, mesh)
        out.append((f"fr_sharded_fused f32 shards={s}",
                    lambda Ash=Ash, mesh=mesh: cstpu_torch.fr_sharded_fused(
                        Ash, Br, cs.FR5_K, mesh, corr_dtype=f32)))
    out.append((f"srr_sharded_fused f32 shards={cs.SHARDS}",
                lambda: cstpu_torch.srr_sharded_fused(
                    Ash, Br, cs.FR5_K, mesh, **cs.SRR5_KW, corr_dtype=f32)))
    return out


# K7's l at B = 8 (GOMP's, SP's at 5c, and 5c-wide's past 128 slots), and
# at B = 64
STREAM_TOPL_LS = (4, 32, 160)
STREAM_TOPL_L64 = 32


def stream_sweeps(cs, tag, dev, widths=((32768, 8), (131072, 8),
                                        (32768, 64)), cdt=None):
    """K6, K9, K10 and K7 forced onto the CUDA cores (mma=False) in f32 on
    5c's f32 dictionary (chip_smoke.unit_dictionary, on a generator of its
    own; with cdt = torch.bfloat16 on its bf16 copy, the catch-all, alone):
    at each (m_local, B) of `widths`, m_local = 32768 as its first quarter
    (a column view, lda = 131072: one of four shards) and 131072 as one
    shard; device ms a call (the sweep and the finish) beside the bound and
    one torch.matmul R . A_shard in the dictionary's dtype. At B = 8 in f32
    also K10 with R made a contiguous (B, n) copy first (the wrapper's other
    choice to the sweep's strided read of R (n, B); the copy is timed with
    the call). K7 (its CUDA-core sweep and the finish) at each l of
    STREAM_TOPL_LS at B = 8 and at STREAM_TOPL_L64 at B = 64, beside that
    matmul and torch.topk(l) a tile of 128 (past 128, of the row).
    Returns the outputs of one call each."""
    import torch

    from cstpu_torch.ops import corr_argmax as ca
    from cstpu_torch.ops import stream_select as ss

    _, n, m, k = cs.SHARD_CELLS["5c"]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    A = cs.unit_dictionary(gen, n, m)
    Rall = torch.randn(max(b for _, b in widths), n, generator=gen,
                       device=dev)
    bf16 = cdt == torch.bfloat16
    if bf16:
        A = A.to(cdt)
    what = "bf16 catch-all" if bf16 else "f32"
    outputs = {}
    for width, B in widths:
        Af = A[:, :width]
        R = Rall[:B].contiguous()
        RT = R.T.contiguous()
        M = torch.zeros((B, width), device=dev)
        M[:, :k] = -torch.inf
        M[B - 1] = -torch.inf                 # a row with every atom excluded
        bpt10 = ca._pick_tile(width) // 128
        nb = Af.element_size()
        calls = {
            "K6": (lambda: ss.correlate_select_stream(Af, R, mma=False),
                   cs.stream_bound(B, n, width, nb)),
            "K9": (lambda: ss.correlate_select_masked_stream(Af, R, M,
                                                              mma=False),
                   cs.stream_bound(B, n, width, nb, masked=True)),
            "K10": (lambda: ca.correlate_argmax(Af, RT, mma=False),
                    cs.stream_bound(B, n, width, nb))}
        if B == 8 and not bf16:
            calls["K10 copied"] = (
                lambda: ss._launch_top1(Af, RT.T.contiguous(), n, 1, B, None,
                                        bpt10, True, "corr_argmax", False),
                cs.stream_bound(B, n, width, 4))
        topk = {}
        for l in STREAM_TOPL_LS if B == 8 else (STREAM_TOPL_L64,):
            calls[f"K7 l={l}"] = (
                lambda l=l: ss.correlate_select_topl_stream(Af, R, l,
                                                            mma=False),
                cs.stream_bound(B, n, width, nb, l=l))
            topk[f"K7 l={l}"] = cs.device_ms_per_call(
                lambda l=l: (torch.matmul(R.to(A.dtype), Af).view(
                    B, width // 128, 128) if l <= 128 else torch.matmul(
                    R.to(A.dtype), Af)[:, None]).abs().topk(l, dim=2))
        lib = cs.device_ms_per_call(lambda: torch.matmul(R.to(A.dtype), Af))
        for name, (call, bnd) in calls.items():
            ms = cs.device_ms_per_call(call)
            key = f"{name} {what[:4]} {width} B={B}"
            outputs[key] = [x.cpu() for x in call()]
            extra = (f", torch.matmul {what[:4]} + torch.topk "
                     + ("a tile " if int(name[5:]) <= 128 else "a row ")
                     + cs.ms4(topk[name]) if name in topk else "")
            print(f"[ab {tag}] {what} {key} (lda {Af.stride(0)}), CUDA cores: "
                  f"{cs.ms4(ms)} ms a call on the device (sweep and finish), "
                  f"torch.matmul {what[:4]} {cs.ms4(lib)}{extra}; bound "
                  f"{bnd['bound_ms']:.4f} by {bnd['bound_by']}", flush=True)
    return outputs


def sharded_stream_solves(cs, dev):
    """The f32 sharded solves on the stream sweeps, on one shard and on
    four: omp_sharded_fused (5c's +-1 rows, k = 32), ompr_sharded_fused,
    mp_sharded_fused, gomp_sharded_fused (l = 4) and sp_sharded_fused (5c's
    planted ones) with corr_dtype=f32, on 5c's dictionary from a generator
    of its own: (name, solve) pairs."""
    import torch

    import cstpu_torch

    B, n, m, k = cs.SHARD_CELLS["5c"]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    A = cs.unit_dictionary(gen, n, m)
    Bs, _ = cs.planted_pm1(gen, A, B, k)
    Bones, _ = cs.planted_ones(gen, A, B, k)
    f32 = torch.float32
    out = []
    for s in (1, cs.SHARDS):
        mesh = cstpu_torch.make_mesh((1, s))
        Ash = cstpu_torch.shard_dictionary(A, mesh)
        out += [
            (f"omp_sharded_fused f32 shards={s}",
             lambda Ash=Ash, mesh=mesh: cstpu_torch.omp_sharded_fused(
                 Ash, Bs, k, mesh, corr_dtype=f32)),
            (f"ompr_sharded_fused f32 shards={s}",
             lambda Ash=Ash, mesh=mesh: cstpu_torch.ompr_sharded_fused(
                 Ash, Bones, k, mesh, delta=1e-12, corr_dtype=f32)),
            (f"mp_sharded_fused f32 shards={s}",
             lambda Ash=Ash, mesh=mesh: cstpu_torch.mp_sharded_fused(
                 Ash, Bones, k, mesh, corr_dtype=f32)),
            (f"gomp_sharded_fused f32 shards={s}",
             lambda Ash=Ash, mesh=mesh: cstpu_torch.gomp_sharded_fused(
                 Ash, Bones, 4, k, mesh, corr_dtype=f32)),
            (f"sp_sharded_fused f32 shards={s}",
             lambda Ash=Ash, mesh=mesh: cstpu_torch.sp_sharded_fused(
                 Ash, Bones, k, mesh, corr_dtype=f32))]
    return out


def fr_step_plans(cs, tag, plans):
    """The --fr-step-plans mode: K8's sweep, the top-1 sweep (K6, K9, K10)
    and the top-l sweep (K7) at B = 8, f32 and the bf16 catch-all, under
    each (entries a stage, stages) plan of few
    rows, each built into a library of its own (simt_select.cuh's
    CSTPU_FEW_CHUNK and CSTPU_FEW_STAGES) and timed in a process of its own
    by fr_steps and stream_sweeps; the outputs are held bit for bit across
    the plans."""
    import subprocess

    for chunk, stages in plans:
        sub = subprocess.run(
            [sys.executable, __file__, os.getcwd(), f"{tag}-{chunk}x{stages}",
             "--fr-step-plan", f"{chunk},{stages}"], check=False)
        if sub.returncode != 0:
            print(f"[ab {tag}] plan {chunk}x{stages} failed: rc "
                  f"{sub.returncode}", flush=True)


def f32_selects(cs, tag, out_dir):
    """The --f32 mode (see the module's note)."""
    import torch

    import cstpu_torch
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.utils.data import correlated_data

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    _, B, n, m, k = cs.CELLS[0]
    A, Bs, _ = cs.planted(gen, B, n, m, k)
    amask = (torch.rand(B, m, generator=gen, device=dev) < 0.01).to(
        torch.uint8)
    _, _, _, _, kf, decay = cs.FR_CELL
    Ar = correlated_data(gen, n, m, kf, decay=decay)[0].contiguous()
    Br, _ = cs.planted_ones(gen, Ar, B, kf)
    cn2 = torch.sum(Ar * Ar, dim=0)
    st = fs._init_fr(Br, kf, cn2)
    for t in range(kf // 2):   # 3a's state half way, by the plain twins
        fs._fr_append_ref(*fs._fr_select_ref(Ar, cn2, st, torch.float32),
                          Ar, Br, st, t, 0.0, 0.0)
    P = 16   # SRR's first call: 16 pending terms
    U = 0.1 * torch.randn(P, B, n, generator=gen, device=dev)
    W = torch.rand(P, B, generator=gen, device=dev)

    def fr_call(s, pend=None):
        if pend is None:
            return [*fs.fr_select(Ar, cn2, s, mma=False), s.resc]
        return [*fs.rescaled_select(Ar, cn2, s.r, *pend, -1.0, s.amask,
                                    s.resc, mma=False), s.resc]

    def fresh():
        return fs._FrState(*(x.clone() for x in st))

    timed = fresh()   # the rescalings the timed calls downdate
    calls = {   # name: (the launch, on a given state for fr, the library call)
        "select bench": (lambda: fs.select_argmax(Bs, A, mma=False),
                         lambda: torch.matmul(Bs, A)),
        "select signed bench": (
            lambda: fs.select_argmax(Bs, A, signed=True, mma=False),
            lambda: torch.matmul(Bs, A)),
        "select masked bench": (
            lambda: fs.select_argmax(Bs, A, amask=amask, eta=0.5, mma=False),
            lambda: torch.matmul(Bs, A)),
        "fr_select 3a": (lambda s=None: fr_call(s or timed),
                         lambda: torch.matmul(torch.cat([st.r, st.aperp]),
                                              Ar)),
        "fr_select 3a 16 terms": (
            lambda s=None: fr_call(s or timed, (U, W)),
            lambda: torch.matmul(torch.cat([st.r, *U]), Ar)),
    }
    # 5b's dictionary (m = 131072) on a generator of its own
    _, B5, n5, m5, k5 = cs.CELLS[1]
    A5, Bs5, _ = cs.planted(torch.Generator(device=dev).manual_seed(cs.SEED),
                            B5, n5, m5, k5)
    calls["select 5b"] = (lambda: fs.select_argmax(Bs5, A5, mma=False),
                          lambda: torch.matmul(Bs5, A5))
    # the top-l select at 2a (l = 4) and 2b (l = 32): suite config 2a's
    # planted ones on the bench's dictionary, on a generator of its own;
    # its library call is the f32 torch.matmul and torch.topk a tile (the
    # bare matmul beside it)
    gen2 = torch.Generator(device=dev).manual_seed(cs.SEED)
    Bg, supg = cs.planted_ones(gen2, A, B, cs.GOMP_CELL[4])
    T = -(-m // fs.TILE)
    for cell, lv in (("2a", cs.GOMP_CELL[5]), ("2b", cs.SP_CELL[1])):
        calls[f"select_topl {cell}"] = (
            lambda lv=lv: fs.select_topl(Bg, A, lv, mma=False),
            lambda lv=lv: torch.matmul(Bg, A).view(B, T, fs.TILE).abs().topk(
                lv, dim=2),
            lambda: torch.matmul(Bg, A))
    outputs = {}
    for name, (kern, lib, *bare) in calls.items():
        ms, lib_ms = cs.device_ms_per_call(kern), cs.device_ms_per_call(lib)
        got = kern(fresh()) if name.startswith("fr") else kern()
        outputs[name] = [x.cpu() for x in got]
        what = "and torch.topk a tile " if bare else ""
        print(f"[ab {tag}] f32 {name}: {cs.ms4(ms)} ms a launch on the "
              f"device, torch.matmul f32 of its products {what}"
              f"{cs.ms4(lib_ms)}" + (f", the matmul alone "
                                     f"{cs.ms4(cs.device_ms_per_call(bare[0]))}"
                                     if bare else ""), flush=True)
    outputs.update(fr_steps(cs, tag, dev))
    solves = [
        ("omp_batch f32 bench", lambda: cstpu_torch.omp_batch(
            A, Bs, k, precision="f32")),
        ("fr_batch f32 3a", lambda: cstpu_torch.fr_batch(
            Ar, Br, sparsity=kf, precision="f32")),
        ("gomp_batch f32 2a", lambda: cstpu_torch.gomp_batch(
            A, Bg, cs.GOMP_CELL[5], cs.GOMP_CELL[4], precision="f32"))]
    solves += sharded_f32_solves(cs, dev)
    outputs.update(stream_sweeps(cs, tag, dev))
    torch.cuda.empty_cache()
    # the same sweeps' bf16 catch-all (a bf16 shard forced onto CUDA cores)
    outputs.update(stream_sweeps(cs, tag, dev, ((32768, 8), (131072, 8)),
                                 cdt=torch.bfloat16))
    outputs.update(fr_steps(cs, tag, dev, torch.bfloat16))
    torch.cuda.empty_cache()
    solves += sharded_stream_solves(cs, dev)
    for name, solve in solves:
        sol = solve()
        # MP returns its coefficients (B, m); the others a solution
        outputs[name] = ([sol.cpu()] if torch.is_tensor(sol) else
                         [sol.idx.cpu(), sol.val.cpu(), sol.mask.cpu()])
        wall = cs.cuda_ms(lambda: (lambda x: x if torch.is_tensor(x) else
                                   x.val)(solve()).sum(), cs.TIMED_SOLVES)
        busy, per = cs.profile_path(solve)
        print(f"[ab {tag}] {name}: wall {wall:.4f} ms, device busy "
              f"{busy:.4f} ms (" + ", ".join(
                  f"{kn} {c}x {ms:.4f}" for kn, (c, ms) in per.items())
              + ")", flush=True)
    compare(outputs, tag, out_dir)


def compare(outputs, tag, out_dir):
    """Save the outputs to OUT/ab_f32_TAG.pt and hold them bit for bit
    against every other TAG's file there."""
    import torch

    def bits(x):
        """A tensor's bits: floats as int32 (NaNs compare equal)."""
        return x.view(torch.int32) if x.is_floating_point() else x

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(outputs, out_dir / f"ab_f32_{tag}.pt")
    for other in sorted(out_dir.glob("ab_f32_*.pt")):
        if other.name == f"ab_f32_{tag}.pt":
            continue
        theirs = torch.load(other)
        same = {name: all(torch.equal(bits(a), bits(b))
                          for a, b in zip(mine, theirs[name]))
                for name, mine in outputs.items() if name in theirs}
        print(f"[ab {tag}] f32 outputs bit for bit equal to "
              f"{other.stem[len('ab_f32_'):]}'s: {all(same.values())} "
              f"({same})", flush=True)


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
    args = sys.argv[3:]
    own_build = Path(__file__).resolve().parent.parent / "build"
    if "--fr-step-plans" in args:
        # a process a plan, each building its own library
        plans = [tuple(map(int, a.split(","))) for a in
                 args[args.index("--fr-step-plans") + 1:]]
        fr_step_plans(cs, tag, plans)
        return None
    if "--fr-step-plan" in args:
        chunk, stages = args[args.index("--fr-step-plan") + 1].split(",")
        _build.NVCC_FLAGS = [*_build.NVCC_FLAGS,
                             f"-DCSTPU_FEW_CHUNK={int(chunk)}",
                             f"-DCSTPU_FEW_STAGES={int(stages)}"]
        _build.BUILD = _build.BUILD / f"plan_{int(chunk)}x{int(stages)}"
        _build.LIB = _build.BUILD / _build.LIB.name
    _, log = _build.build()
    print(f"[ab {tag}] {cs.gpu_line()}")
    if "--fr-step-plan" in args:
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if (("fr_step_simt" in line or "stream_top1_simt" in line
                 or "stream_topl_simt" in line)
                    and "Function properties" in line):
                print(f"[ab {tag}] {line.strip()[:160]}: "
                      + " ".join(x.strip() for x in lines[i + 1:i + 3]))
        dev = torch.device("cuda", 0)
        outputs = fr_steps(cs, tag, dev)
        outputs.update(stream_sweeps(cs, tag, dev,
                                     ((32768, 8), (131072, 8))))
        # the bf16 catch-all takes the plans too
        outputs.update(fr_steps(cs, tag, dev, torch.bfloat16))
        outputs.update(stream_sweeps(cs, tag, dev, ((32768, 8), (131072, 8)),
                                     cdt=torch.bfloat16))
        compare(outputs, tag, own_build / "ab_plans")
        return None
    if "--f32" in args:
        rest = [a for a in args if a != "--f32"]
        f32_selects(cs, tag, rest[0] if rest else own_build / "ab_f32")
        return None
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
