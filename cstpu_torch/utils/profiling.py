"""Profiling and roofline accounting for solver workloads (PyTorch
counterpart of cstpu.utils.profiling).

  * `trace(dir)` — a context manager over torch.profiler that writes a
    Chrome trace of the enclosed block (open it in chrome://tracing or
    Perfetto).
  * `solve_cost(...)` — the bytes/FLOPs model of one batched greedy solve,
    used to turn a measured wall time into roofline fractions.
  * `roofline_report(...)` — combines a measured time with the cost model
    and measured peak rates into per-solve counters (GEMM TFLOP/s, HBM
    GB/s, fraction of each roof).
  * `measured_stream_gbps()` — the device's streaming read rate, measured.

The cost model is deliberately simple and documented rather than
instrumented: every greedy step is one (B,n)x(n,m) correlation GEMM plus
O(B·k·n) state work; a whole-solve kernel reads the dictionary once per
SOLVE, a loop of per-step launches once per STEP.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass

import torch


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a torch.profiler trace (host and CUDA activity) of the
    enclosed block; on exit it is written to `log_dir/trace.json` (default:
    cstpu-trace under the temporary directory). Yields log_dir."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "cstpu-trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class SolveCost:
    """FLOPs/bytes of one batched k-step greedy solve."""
    flops: float            # total floating point operations
    hbm_bytes_fused: float  # HBM traffic if the dictionary is read once
    hbm_bytes_loop: float   # HBM traffic reading A once per step
    steps: int
    batch: int


def solve_cost(B: int, n: int, m: int, k: int, itemsize: int = 4,
               gemms_per_step: int = 2) -> SolveCost:
    """Cost model for OMP-family solves (selection + column-extraction
    GEMMs per step; FR passes gemms_per_step=3 for the rescaling GEMM)."""
    gemm_flops = 2.0 * B * n * m * gemms_per_step * k
    state_flops = 2.0 * B * k * n * k          # cols reductions per step
    return SolveCost(
        flops=gemm_flops + state_flops,
        hbm_bytes_fused=n * m * itemsize + 2.0 * B * n * 4,
        hbm_bytes_loop=k * n * m * itemsize + 2.0 * B * n * 4,
        steps=k,
        batch=B,
    )


def roofline_report(seconds: float, cost: SolveCost,
                    peak_tflops: float | None = None,
                    peak_gbps: float | None = None) -> dict:
    """Turn a measured solve time into roofline counters.

    `peak_tflops` / `peak_gbps` should be *measured* rates (e.g.
    `measured_stream_gbps()`); pass None to omit fractions.
    """
    rep = {
        "seconds": seconds,
        "tflops": cost.flops / seconds / 1e12,
        "atom_selections_per_sec": cost.batch * cost.steps / seconds,
        "hbm_gbps_if_fused": cost.hbm_bytes_fused / seconds / 1e9,
        "hbm_gbps_if_loop": cost.hbm_bytes_loop / seconds / 1e9,
    }
    if peak_tflops:
        rep["frac_of_peak_flops"] = rep["tflops"] / peak_tflops
    if peak_gbps:
        rep["frac_of_stream_roof_loop"] = rep["hbm_gbps_if_loop"] / peak_gbps
    return rep


def measured_stream_gbps(nbytes: int = 2 << 30) -> float:
    """Calibrate the card's streaming read rate: reductions over one f32
    buffer of `nbytes` (2 GiB by default, 40 times the H100's 50 MB L2, so
    that every pass reads HBM), timed as a chain of 1 and of 17 reductions
    and differenced (launch and sync overheads cancel), each chain
    bracketed by CUDA events and synced by fetching its value; the best of
    five. Without a CUDA device this raises: a CPU rate is not the
    card's."""
    if not torch.cuda.is_available():
        raise RuntimeError("measured_stream_gbps: no CUDA device")
    x = torch.ones((nbytes // 4,), dtype=torch.float32, device="cuda")

    def chain(reps: int):
        acc = torch.zeros((), dtype=torch.float32, device="cuda")
        for _ in range(reps):
            acc = acc + torch.sum(x)
        return acc

    def timed(reps: int) -> float:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        acc = chain(reps)
        e1.record()
        float(acc)
        return e0.elapsed_time(e1) / 1e3

    chain(1)
    chain(17)
    t1 = min(timed(1) for _ in range(5))
    t2 = min(timed(17) for _ in range(5))
    return x.numel() * 4 / ((t2 - t1) / 16) / 1e9


def format_report(rep: dict) -> str:
    return json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in rep.items()})
