"""Declarative solver configuration (PyTorch counterpart of
cstpu.utils.config).

The reference has no config system — every knob is a positional/keyword
argument with a literal default baked into the solver (SURVEY §5: e.g.
`maxiter=128m, min_change=1e-6` the reference's src/sbl.jl:39, `maxiter=16k`
src/twostage.jl:87, `eps=1e-2` src/basispursuit.jl:42). cstpu keeps those
literals in the solver SIGNATURES as the single source of truth (the
conformance contract), and layers a declarative config on top:

  * `SolverConfig` — a frozen, hashable record naming a solver plus
    parameter overrides, validated against the real signature (a typo'd
    knob fails at construction, not deep inside a jit trace).
  * `solver_config("omp", k=8)` / `cfg.run(A, b)` / `cfg.run_batch(A, Bs)`
    — dispatch to the single-problem and batched-first entry points.
  * `defaults("omp")` — the signature defaults, for sweep tooling.
  * JSON round-trip (`to_json` / `from_json`) so experiment grids and
    checkpoint metadata can persist exactly which solver ran.
"""

from __future__ import annotations

import inspect
import json
from dataclasses import dataclass, field


def _registries():
    # imported lazily: this module must not import the whole package at
    # import time
    import cstpu_torch
    from cstpu_torch.models import batched

    single = {
        name: getattr(cstpu_torch, name)
        for name in ("mp", "omp", "gomp", "oblivious", "fr", "br", "fbr",
                     "lace", "sp", "ompr", "srr", "rmp", "foba", "sbl",
                     "fsbl", "rmps", "bp", "bpd", "bp_candes", "bp_ard",
                     "bpd_candes", "bpd_ard", "ista", "fista", "exhaustive")
    }
    batch = {
        name: getattr(batched, f"{name}_batch")
        for name in ("mp", "omp", "gomp", "fr", "br", "fbr", "lace", "sp",
                     "ompr", "srr", "rmp", "foba", "sbl", "fsbl", "rmps")
    }
    return single, batch


def _validate(fn, name: str, params: dict, batched: bool):
    sig = inspect.signature(fn)
    if any(p.kind is inspect.Parameter.VAR_KEYWORD
           for p in sig.parameters.values()):
        return  # forwards **kw (e.g. rmps_batch) — accepts anything
    data_args = {"A", "b", "Bs", "key"}
    known = {p for p in sig.parameters if p not in data_args}
    unknown = set(params) - known
    if unknown:
        kind = "batched " if batched else ""
        raise TypeError(
            f"unknown parameter(s) {sorted(unknown)} for {kind}solver "
            f"{name!r}; valid: {sorted(known)}")


@dataclass(frozen=True)
class SolverConfig:
    """Frozen, hashable (solver, overrides) record. Construct through
    `solver_config(...)` which validates parameter names."""
    solver: str
    params: tuple = field(default_factory=tuple)  # ((name, value), ...)

    def kwargs(self) -> dict:
        return dict(self.params)

    def run(self, A, b, **data_kw):
        """Solve one (A, b) with the configured solver."""
        single, _ = _registries()
        return single[self.solver](A, b, **self.kwargs(), **data_kw)

    def run_batch(self, A, Bs, **data_kw):
        """Solve a batch of measurements with the `*_batch` entry point
        (the hand-written kernels or the sharded route where available)."""
        _, batch = _registries()
        if self.solver not in batch:
            raise KeyError(f"solver {self.solver!r} has no batched entry "
                           f"point; available: {sorted(batch)}")
        fn = batch[self.solver]
        params = self.kwargs()
        _validate(fn, self.solver, params, batched=True)
        return fn(A, Bs, **params, **data_kw)

    def to_json(self) -> str:
        return json.dumps({"solver": self.solver, "params": self.kwargs()})

    @classmethod
    def from_json(cls, s: str) -> "SolverConfig":
        d = json.loads(s)
        return solver_config(d["solver"], **d["params"])


def _plain(v):
    """Coerce numpy scalars and 0-d tensors to Python scalars so the config
    stays hashable and JSON-serializable (sweeping values out of an array
    is the natural way to build a grid — np.float32 would break to_json
    and 0-d arrays would break hash())."""
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    return v


def solver_config(solver: str, **params) -> SolverConfig:
    """Build a validated SolverConfig: `solver_config("omp", k=8)`."""
    single, _ = _registries()
    if solver not in single:
        raise KeyError(f"unknown solver {solver!r}; "
                       f"available: {sorted(single)}")
    params = {k: _plain(v) for k, v in params.items()}
    _validate(single[solver], solver, params, batched=False)
    return SolverConfig(solver, tuple(sorted(params.items())))


def defaults(solver: str) -> dict:
    """Signature defaults of a solver — the reference's literal defaults
    are preserved here as the conformance contract (SURVEY §5)."""
    single, _ = _registries()
    if solver not in single:
        raise KeyError(f"unknown solver {solver!r}")
    return {
        name: p.default
        for name, p in inspect.signature(single[solver]).parameters.items()
        if p.default is not inspect.Parameter.empty
    }


def available_solvers() -> dict:
    """{'single': [...], 'batched': [...]} solver names."""
    single, batch = _registries()
    return {"single": sorted(single), "batched": sorted(batch)}
