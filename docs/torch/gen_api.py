"""Generate docs/torch/API.md from the live cstpu_torch docstrings.

Run from the repo root:  PYTHONPATH=. python docs/torch/gen_api.py
The script asserts that every name of `cstpu_torch.__all__` and of
`cstpu_torch.parallel.__all__` is filed exactly once, so a public name
added without a place here fails loudly. It imports cstpu_torch only.
"""

from __future__ import annotations

import inspect
import os

import cstpu_torch
import cstpu_torch.parallel

TOP = {
    "Greedy pursuit": ["mp", "omp", "gomp", "oblivious"],
    "Stepwise regression (forward / backward)": [
        "fr", "ols", "oomp", "ormp", "stepwise_regression", "br", "fbr",
        "lace"],
    "Two-stage / replacement": ["sp", "ompr", "srr"],
    "Stepwise compositions": ["rmp", "foba"],
    "Sparse Bayesian learning": ["sbl", "fsbl", "rmps",
                                 "rmps_estimate_noise"],
    "Convex (basis pursuit family)": [
        "bp", "basispursuit", "bp_candes", "bp_ard", "bpd",
        "basis_pursuit_denoising", "bpd_candes", "bpd_ard", "ista",
        "fista"],
    "Exhaustive oracle": ["exhaustive"],
    "Batched entry points (the hand-written CUDA kernels)": sorted(
        n for n in cstpu_torch.__all__
        if n.endswith("_batch") and n != "shard_batch"),
    "Observability": sorted(
        n for n in cstpu_torch.__all__ if n.endswith("_traced")) + [
        "SolveTrace", "SBLTrace", "RMPSTrace", "solve_cost",
        "roofline_report"],
    "Solver configs": ["SolverConfig", "solver_config"],
    "Checkpoint / resume": ["save_state", "load_state"],
    "Data generation & dictionary analysis": [
        "sparse_vector", "sparse_data", "gaussian_data",
        "correlated_data", "coherent_data", "perturb",
        "normalize_columns", "colnorms", "coherence", "babel",
        "cumbabel", "samesupport", "support", "droptol", "polish",
        "mean_preconditioner", "svd_preconditioner", "precondition"],
    "Solution containers & batching": ["SparseSolution", "batch"],
    "Meshes and the column-sharded greedy solvers": [
        "make_mesh", "shard_dictionary", "shard_batch", "omp_sharded",
        "omp_sharded_rows", "omp_sharded_fused", "mp_sharded_fused",
        "gomp_sharded_fused", "ompr_sharded_fused", "sp_sharded_fused",
        "fr_sharded_fused", "srr_sharded_fused", "rmp_sharded_fused",
        "foba_sharded_fused", "correlate_argmax"],
}
PARALLEL = {
    "Mesh types": ["Mesh", "ShardedDictionary"],
    "Atom-sharded SBL": ["fsbl_sharded", "rmps_sharded"],
    "Column-sharded convex": [
        "bp_sharded", "bp_ard_sharded", "bpd_sharded", "bpd_candes_sharded",
        "bpd_ard_sharded", "bpd_secant_sharded", "ista_sharded",
        "fista_sharded"],
}
# the names both lists hold: filed once, under TOP, and reached from either
SHARED = sorted(set(cstpu_torch.__all__) & set(cstpu_torch.parallel.__all__))

DIFFERENCES = [
    "The generators (`sparse_vector`, `sparse_data`, `gaussian_data`, "
    "`correlated_data`, `coherent_data`, `perturb`) and `srr`'s `key` take "
    "a `torch.Generator` where cstpu takes a JAX PRNG key; the two draw "
    "other numbers from the same seed.",
    "The sharded solvers drop `atoms_axis`, `batch_axis` and `interpret`, "
    "and all but `mp_sharded_fused`, `fsbl_sharded`, `rmps_sharded` and "
    "the eight convex ones add `return_iters`; `omp_sharded_rows` drops "
    "`meas_axis`, `make_mesh` drops `axis_names`, and `shard_dictionary` "
    "and `shard_batch` drop `axis`.",
    "Tensors are solved on the device they lie on; inputs that are not "
    "tensors go to the card (a CPU run passes CPU tensors). The kernels run "
    "only for CUDA tensors; on the CPU each wrapper runs its plain twin.",
]


def _check(groups, names, what):
    listed = [n for ns in groups.values() for n in ns]
    extra = sorted(set(names) - set(listed))
    assert not extra, f"{what}: unfiled public names: {extra}"
    unknown = sorted(set(listed) - set(names))
    assert not unknown, f"{what}: filed but not public: {unknown}"
    dupes = sorted({n for n in listed if listed.count(n) > 1})
    assert not dupes, f"{what}: filed twice: {dupes}"
    return listed


def _entry(mod, n):
    obj = getattr(mod, n)
    doc = (obj.__doc__ or "").strip().splitlines()[0].strip()
    sig = ""
    if callable(obj) and not inspect.isclass(obj):
        try:
            sig = str(inspect.signature(obj))
        except (TypeError, ValueError):
            sig = "(...)"
    return f"* **`{n}{sig}`** — {doc}"


def main() -> None:
    top = _check(TOP, cstpu_torch.__all__, "cstpu_torch")
    par = _check({**PARALLEL, "shared": SHARED},
                 cstpu_torch.parallel.__all__, "cstpu_torch.parallel")
    lines = [
        "# cstpu_torch public API",
        "",
        "Every public name of `import cstpu_torch` and of",
        "`cstpu_torch.parallel`, grouped by subsystem, with its signature",
        "and summary line, generated from the live docstrings",
        "(`PYTHONPATH=. python docs/torch/gen_api.py`). The names mirror",
        "cstpu's ([../API.md](../API.md)); the differences are on purpose:",
        "",
        *(f"- {d}" for d in DIFFERENCES),
        "",
        "Names of `cstpu_torch.parallel.__all__` that `cstpu_torch` also",
        "exports are filed once, under `cstpu_torch`: "
        + ", ".join(f"`{n}`" for n in SHARED) + ".",
        "",
    ]
    for title, names in TOP.items():
        lines += [f"## {title}", ""]
        lines += [_entry(cstpu_torch, n) for n in names]
        lines.append("")
    for title, names in PARALLEL.items():
        lines += [f"## cstpu_torch.parallel: {title}", ""]
        lines += [_entry(cstpu_torch.parallel, n) for n in names]
        lines.append("")
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "API.md")
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out}: {len(lines)} lines, {len(top)} + "
          f"{len(par) - len(SHARED)} names")


if __name__ == "__main__":
    main()
