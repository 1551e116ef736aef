"""The one-block-per-row latency kernels of cstpu_torch as far as the CPU can
see them: bw_select (csrc/bw_select.cu, a thread-block cluster per row),
sp_round (csrc/sp_round.cu, the tiled slot Gram) and the merge of the
top-l partials that sp_round, gomp_append and engine_init share
(csrc/common.cuh::merge_topl_row, warp sorts and a tree of merges).

The kernels run only on the card, where tests/test_torch_kernels.py holds
them to their plain twins at the edge shapes of the redesign. Here the
twins are held against cstpu's Pallas kernels in interpret mode at those
edges: FBR and LACE with equal scores on both sides of what is a cluster's
slice boundary on the card (m = 1028: eight slices of 129 atoms), SP with
equal picks in two tiles; the merge twin against the sequential rule the
kernels' merge replaced, on partials with ties across tiles, (-inf, idx)
entries, pads and a NaN; and, with a stand-in for the kernel library that
records the C calls, that the wrappers hand the C entries the arguments
they did and refuse what the kernels do not take (m % 4 != 0 for the
deletion kernels, k > LMAX for sp_round), launching nothing.

Tolerances: supports, masks and `failed` equal; coefficients and residuals
to 1e-4 absolute (what cstpu holds its kernels to against its XLA paths).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu.ops import fused_backward as jfb
from cstpu.ops import fused_twostage as jft
from cstpu_torch.ops import fused_backward as tfb
from cstpu_torch.ops import fused_solve as tfs
from cstpu_torch.ops import fused_twostage as tft
from cstpu_torch.utils.interop import solution_to_numpy, to_torch

ATOL = 1e-4
INT_MAX = tfs.INT_MAX


def _same_solution(t, j):
    t, j = solution_to_numpy(t), solution_to_numpy(j)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=0, atol=ATOL)
    return t


# --------------------------------------------------------------------------
# FBR and LACE: ties across a slice boundary at m = 1028
# --------------------------------------------------------------------------

def _signed_permutation(m, seed):
    """A square (m, m) signed permutation: A'A = I exactly in f32, so the
    init is exact and a score is the square (FBR) or the absolute value
    (LACE) of a measurement entry, and ties are exact."""
    rng = np.random.default_rng(seed)
    A = np.zeros((m, m), np.float32)
    A[rng.permutation(m), np.arange(m)] = rng.choice([-1.0, 1.0], size=m)
    return A


@pytest.mark.parametrize("name", ["fbr", "lace"])
def test_ties_across_a_slice_boundary_match_pallas(name):
    # m = 1028: the card runs 8 slices of 129 atoms, the first boundary
    # between atoms 128 and 129, the last between 902 and 903. Row 0 ties
    # 128 and 129 at the smallest score, row 1 ties 902 and 903; the
    # residual bound admits exactly one deletion: the lower atom goes
    m = 1028
    A = _signed_permutation(m, 11)
    rng = np.random.default_rng(12)
    x = rng.choice([-1.0, 1.0], size=(2, m)) * rng.uniform(1.0, 2.0, (2, m))
    x[0, [128, 129]] = [0.01, -0.01]
    x[1, [902, 903]] = [-0.01, 0.01]
    Bs = (x.astype(np.float32) @ A.T).astype(np.float32)
    kw = {"max_residual": float(np.sqrt(1.5e-4))}
    tsolve, jsolve = {"fbr": (tfb.fbr_fused_solve_ref, jfb.fbr_fused_solve),
                      "lace": (tfb.lace_fused_solve_ref,
                               jfb.lace_fused_solve)}[name]
    jsol, jfail = jsolve(A, Bs, interpret=True, **kw)
    tsol, tfail, steps = tsolve(to_torch(A), to_torch(Bs), return_iters=True,
                                **kw)
    t = _same_solution(tsol, jsol)
    np.testing.assert_array_equal(tfail.numpy(), np.asarray(jfail))
    assert not tfail.any()
    for row, (lo, hi) in enumerate([(128, 129), (902, 903)]):
        kept = set(t["idx"][row][t["mask"][row]].tolist())
        assert lo not in kept and hi in kept and len(kept) == m - 1


@pytest.mark.parametrize("select_abs", [False, True])
def test_plain_select_takes_the_lowest_of_equal_scores(select_abs):
    # the twin itself, one step on a state built by hand: equal scores at
    # 128 and 129 (FBR: coef^2 / diag; LACE: |coef|), a NaN row, a row
    # whose atoms are all deleted (every score inf: the lowest index, an
    # infinite increase, rejected)
    B, m = 3, 1028
    G = torch.eye(m).repeat(B, 1, 1)
    coef = torch.ones((B, m))
    coef[0, 128], coef[0, 129] = 0.5, -0.5
    coef[1, 600] = float("nan")
    st = tfb._BwState(
        G=G, coef=coef, diag=torch.ones((B, m)), alive=torch.ones((B, m)),
        nr2=torch.zeros(B), run=torch.ones(B), failed=torch.zeros(B),
        g=torch.zeros((B, m)), gcol=torch.zeros((B, m)), sc=torch.zeros(B, 2))
    st.alive[2] = 0.0
    tfb.bw_select(st, float("inf"), float("inf"), select_abs)
    assert st.alive[0, 128] == 0.0 and st.alive[0, 129] == 1.0
    assert st.run.tolist() == [1.0, 0.0, 0.0]
    assert st.failed.tolist() == [0.0, 1.0, 0.0]
    assert torch.equal(st.g[2], G[2, 0]) and st.sc[2].tolist() == [0.0, 1.0]


# --------------------------------------------------------------------------
# SP: equal picks in two tiles
# --------------------------------------------------------------------------

def _planted(seed, n=32, m=256, k=3):
    from conftest import planted_problem

    A, x, b, y = planted_problem(seed, n=n, m=m, k=k, noise=5e-3,
                                 dtype=jnp.float32)
    A, x, b, y = (np.asarray(v) for v in (A, x, b, y))
    return A, x, b, y


def test_sp_with_a_column_in_two_tiles_matches_pallas():
    # atom 200 (tile 1) is atom 3 (tile 0) again: the two score alike in
    # every round and are picked together, 3 first; the Schur pre-gate
    # turns the copy away, as in cstpu's kernel. Rows 2 and 3 are three
    # atoms each, atom 3 (or its copy) among them: 3 is kept, 200 never
    A, x, b, y = _planted(820)
    A = A.copy()
    sup = np.flatnonzero(x)
    A[:, 200] = A[:, 3]
    Bs = np.stack([y, b, A[:, 3] + A[:, sup[0]] + A[:, sup[1]],
                   1.5 * A[:, 200] - A[:, sup[2]] + 0.5 * A[:, sup[0]],
                   -b, A[:, 200] - 0.2 * b, 2.0 * y, y - 0.3 * A[:, 3]])
    Bs = Bs.astype(np.float32)
    js, jr = jft.sp_fused_solve(A, Bs, 3, maxiter=8, interpret=True)
    ts, tr, _ = tft._sp(to_torch(A), to_torch(Bs), 3, 1e-12, 8,
                        torch.bfloat16, tfs.select_topl, tft.sp_round, False)
    t = _same_solution(ts, js)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=ATOL)
    for row in (2, 3):
        kept = set(t["idx"][row][t["mask"][row]].tolist())
        assert 3 in kept and 200 not in kept


# --------------------------------------------------------------------------
# The merge of the top-l partials
# --------------------------------------------------------------------------

def _sequential_merge(pv, pi, cnt):
    """The rule of the merge the kernels had: cnt passes, each taking the
    best candidate after the previous pick (value descending, then index
    ascending); a NaN among a row's partials makes every pick
    (-inf, INT_MAX)."""
    vals, picks = [], []
    for v_row, i_row in zip(pv.reshape(pv.shape[0], -1).tolist(),
                            pi.reshape(pi.shape[0], -1).tolist()):
        if any(np.isnan(v_row)):
            vals.append([-np.inf] * cnt)
            picks.append([INT_MAX] * cnt)
            continue
        vp, ip, vr, pr = np.inf, -1, [], []
        for _ in range(cnt):
            v, i = -np.inf, INT_MAX
            for ve, ie in zip(v_row, i_row):
                after = ve < vp or (ve == vp and ie > ip)
                if after and (ve > v or (ve == v and ie < i)):
                    v, i = ve, ie
            vr.append(v)
            pr.append(i)
            vp, ip = v, i
        vals.append(vr)
        picks.append(pr)
    return np.array(vals, np.float32), np.array(picks, np.int64)


@pytest.mark.parametrize("cnt", [1, 5, 8, 32])
def test_merge_twin_is_the_sequential_rule(cnt):
    # per tile, l = 8 entries sorted as a select writes them: values with
    # ties inside and across tiles, (-inf, idx) entries (atoms a mask
    # excluded), pads (-inf, INT_MAX), -0 beside 0; row 3 holds a NaN
    rng = np.random.default_rng(cnt)
    B, T, l = 5, 9, 8
    pv = np.full((B, T, l), -np.inf, np.float32)
    pi = np.full((B, T, l), INT_MAX, np.int64)
    for b in range(B):
        for t in range(T):
            n_real = int(rng.integers(0, l + 1))
            idx = np.sort(rng.choice(128, size=n_real, replace=False)) + 128 * t
            v = rng.choice([0.0, -0.0, 0.5, 1.0, 1.0, 2.0, -np.inf, np.inf],
                           size=n_real).astype(np.float32)
            order = sorted(range(n_real), key=lambda e: (-v[e], idx[e]))
            pv[b, t, :n_real] = v[order]
            pi[b, t, :n_real] = idx[order]
    pv[3, 4, 0] = np.nan
    want_v, want_i = _sequential_merge(pv, pi, cnt)
    got_v, got_i = tfs._merge_topl_vals(torch.from_numpy(pv),
                                        torch.from_numpy(pi), cnt)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert (got_i[3] == INT_MAX).all() and (got_v[3] == -np.inf).all()


# --------------------------------------------------------------------------
# The C calls of the wrappers
# --------------------------------------------------------------------------

class _Recorder:
    """Stands in for the kernel library: records each C call's arguments
    and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recorder(monkeypatch):
    """The wrappers' launch route on CPU tensors: tensors claim to be on
    CUDA, the library is the recorder, and no device or stream is asked."""
    import contextlib

    from cstpu_torch.ops import _build

    rec = _Recorder()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_build, "load", lambda: rec)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for mod in (tfs, tft, tfb):
        monkeypatch.setattr(mod, "_stream", lambda: None)
    return rec


def _bw_state(B, m):
    z = lambda *shape: torch.zeros(shape)  # noqa: E731
    return tfb._BwState(G=z(B, m, m), coef=z(B, m), diag=z(B, m),
                        alive=z(B, m), nr2=z(B), run=z(B), failed=z(B),
                        g=z(B, m), gcol=z(B, m), sc=z(B, 2))


@pytest.mark.parametrize("select_abs", [False, True])
def test_bw_wrappers_pass_the_same_arguments(recorder, select_abs):
    B, m = 3, 1028
    st = _bw_state(B, m)
    before = dict(tfs.LAUNCHES)
    tfb.bw_select(st, 0.25, 4.0, select_abs)
    tfb.bw_downdate(st)
    assert [c[0] for c in recorder.calls] == ["cstpu_bw_select",
                                              "cstpu_bw_downdate"]
    args = recorder.calls[0][1]
    assert args[:10] == tuple(x.data_ptr() for x in st)
    assert args[10:] == (B, m, 0.25, 4.0, int(select_abs), None)
    assert recorder.calls[1][1] == (st.G.data_ptr(), st.g.data_ptr(),
                                    st.gcol.data_ptr(), st.sc.data_ptr(), B,
                                    m, None)
    assert tfs.LAUNCHES["bw_select"] - before["bw_select"] == 1
    assert tfs.LAUNCHES["bw_downdate"] - before["bw_downdate"] == 1


@pytest.mark.parametrize("m", [1026, 1030, 2])
def test_bw_wrappers_refuse_m_not_a_multiple_of_4(recorder, m):
    st = _bw_state(2, m)
    with pytest.raises(ValueError, match="multiple of 4"):
        tfb.bw_select(st, 1.0, 1.0, False)
    with pytest.raises(ValueError, match="multiple of 4"):
        tfb.bw_downdate(st)
    assert recorder.calls == []


def _sp_parts(B, n, m, k):
    T = -(-m // tfs.TILE)
    pv = torch.zeros((B, T, k))
    pi = torch.zeros((B, T, k), dtype=torch.int32)
    Ac = torch.zeros((n, m), dtype=torch.bfloat16)
    Bs = torch.zeros((B, n))
    st = tft._SpState(
        cols=torch.zeros((B, 2 * k, n)), Ginv=torch.zeros((B, k, k)),
        coef=torch.zeros((B, 2 * k)),
        idx=torch.zeros((B, 2 * k), dtype=torch.int32),
        Atb=torch.zeros((B, 2 * k)), r=torch.zeros((B, n)),
        done=torch.zeros(B), prev=torch.zeros(B))
    return pv, pi, Ac, Bs, st


@pytest.mark.parametrize("k,init", [(1, True), (31, False), (32, False)])
def test_sp_round_wrapper_passes_the_same_arguments(recorder, k, init):
    B, n, m = 3, 1000, 8264
    pv, pi, Ac, Bs, st = _sp_parts(B, n, m, k)
    before = tfs.LAUNCHES["sp_round"]
    tft.sp_round(pv, pi, Ac, Bs, st, 0.5, init)
    (name, args), = recorder.calls
    assert name == "cstpu_sp_round"
    assert args[:6] == (pv.data_ptr(), pi.data_ptr(), 65, Ac.data_ptr(), 1,
                        Bs.data_ptr())
    assert args[6:14] == tuple(x.data_ptr() for x in st)
    assert args[14:18] == (B, n, m, k)
    assert args[18] == pytest.approx(tft._degeneracy_rtol(n))
    assert args[19:] == (0.5, int(init), None)
    assert tfs.LAUNCHES["sp_round"] - before == 1


@pytest.mark.parametrize("k", [tfs.LMAX + 1, 128, 129])
def test_sp_round_wrapper_refuses_k_beyond_the_kernel(recorder, k):
    with pytest.raises(ValueError, match="outside"):
        tft.sp_round(*_sp_parts(2, 300, 1024, k), 0.0, False)
    assert recorder.calls == []
