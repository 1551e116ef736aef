"""Backward elimination steps (PyTorch counterpart of the part of
cstpu.models.backward that SRR needs).

A backward step deletes the active atom whose removal increases the squared
residual norm least, delta_i^2 = coef_i^2 / gamma_i with gamma =
diag((A_i'A_i)^-1), or, with `naive`, by re-solving each leave-one-out
problem. BR, FBR and LACE themselves wait for the backward slice of the
port (ROADMAP.md).
"""

from __future__ import annotations

import torch

from cstpu_torch.ops import active_set as aset
from cstpu_torch.ops.util import masked_argmin, norm2


def backward_deltas(b, st, m: int, naive: bool = False):
    """Squared residual-norm increase for deleting each active slot (inf
    on the inactive ones), from the cached state alone."""
    if not naive:
        return torch.where(st.mask, st.coef * st.coef / aset.gamma(st),
                           torch.inf)
    base = norm2(aset.residual(st, b))
    d2 = torch.full_like(st.coef, torch.inf)
    for p in torch.nonzero(st.mask)[:, 0].tolist():
        cand = aset.refit(aset.delete(st, p, m))
        d2[p] = norm2(aset.residual(cand, b)) - base
    return d2


def backward_step(A, b, st, max_eps, max_delta, m: int, naive: bool = False):
    """One backward step; returns (state, accepted).

    Deletes the least-increase atom iff an atom is active, the residual
    norm after the deletion stays below `max_eps`, and the increase is
    below `max_delta^2`; otherwise returns the state unchanged. The same
    routine serves BR and the backward stages of SRR, RMP and FoBa.
    """
    normr2 = norm2(aset.residual(st, b))
    pos, mind2 = masked_argmin(backward_deltas(b, st, m, naive), st.mask)
    new_norm = torch.sqrt(torch.clamp(mind2 + normr2, min=0))
    accept = bool((st.k > 0) & (new_norm < max_eps)
                  & (mind2 < max_delta * max_delta))
    if not accept:
        return st, False
    return aset.refit(aset.delete(st, int(pos), m)), True
