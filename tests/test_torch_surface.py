"""chip_smoke.py's [surface] phase, as far as the CPU can see it.

The phase calls every public name of cstpu_torch and cstpu_torch.parallel
on the card and holds each result against its oracle and against the same
call on CPU tensors. Its case table imports without a card: a public name
that no case calls fails here, and so does a case whose oracle does not
hold on the CPU (each case runs once, on CPU tensors, as the phase's CPU
half runs it). docs/torch/gen_api.py files every public name exactly once.
"""

import pytest
import torch

import chip_smoke
import cstpu_torch
import cstpu_torch.parallel

CASES = chip_smoke.surface_cases()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs beside other
    workers on the same cores, and torch's default, a thread a core in
    every worker, makes these small solves wait on each other (a 1 s case
    took 267 s in a six-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_table_calls_every_public_name():
    covered = set().union(*(c.covers for c in CASES))
    names = set(cstpu_torch.__all__) | set(cstpu_torch.parallel.__all__)
    assert covered == names == chip_smoke.surface_names(), sorted(
        covered ^ names)
    assert len({c.name for c in CASES}) == len(CASES)


@pytest.fixture(scope="module")
def problems():
    return chip_smoke.surface_problems("cpu")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_each_case_holds_its_oracle_on_the_cpu(case, problems):
    out = case.run(problems)
    ok, detail = case.check(problems, out)
    assert ok, detail
    if case.agree not in (None, chip_smoke._same_support):
        assert chip_smoke._agree(case, out, case.run(problems))


def test_the_problems_are_made_from_the_seed():
    a, b = chip_smoke.surface_problems("cpu"), chip_smoke.surface_problems(
        "cpu")
    assert all(torch.equal(a[key], b[key]) for key in a
               if isinstance(a[key], torch.Tensor))
    assert a["sup"] == b["sup"] and a["supsh"] == b["supsh"]


def test_the_api_page_files_every_public_name_once():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "docs" / "torch" / \
        "gen_api.py"
    spec = importlib.util.spec_from_file_location("gen_api", path)
    gen_api = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen_api)
    top = gen_api._check(gen_api.TOP, cstpu_torch.__all__, "cstpu_torch")
    par = gen_api._check({**gen_api.PARALLEL, "shared": gen_api.SHARED},
                         cstpu_torch.parallel.__all__, "parallel")
    assert len(top) + len(par) - len(gen_api.SHARED) == len(
        chip_smoke.surface_names())
