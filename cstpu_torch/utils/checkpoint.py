"""Checkpoint / resume for solver state (PyTorch counterpart of
cstpu.utils.checkpoint).

Every solver state is a tree of tensors (ActiveSet, SQState, SolveTrace,
SBLTrace: named tuples; SparseSolution: a dataclass), so durable
checkpoint/resume is a thin wrapper over `torch.save`: long multi-stage
solves (the RMPS sigma^2 outer loop, reweighted BP) can persist and resume
across processes. The tree is flattened by this module's own walk (named
tuples, tuples, lists, dicts and dataclasses; tensors and Python scalars
are leaves), saved as a list of leaves, loaded with `weights_only=True`
and rebuilt through the structure of a template.
"""

from __future__ import annotations

import dataclasses
import os

import torch


def _children(node):
    """(the node's children, a function that rebuilds it from them), or
    None for a leaf."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(node), lambda xs: type(node)(*xs)
    if isinstance(node, (tuple, list)):
        return list(node), lambda xs: type(node)(xs)
    if isinstance(node, dict):
        keys = sorted(node)
        return ([node[k] for k in keys],
                lambda xs: type(node)(zip(keys, xs)))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = [f.name for f in dataclasses.fields(node)]
        return ([getattr(node, k) for k in names],
                lambda xs: dataclasses.replace(node, **dict(zip(names, xs))))
    return None


def _leaves(node):
    kids = _children(node)
    if kids is None:
        return [node]
    return [leaf for child in kids[0] for leaf in _leaves(child)]


def _rebuild(like, leaves):
    """`like` with its leaves taken in order from the iterator `leaves`: a
    tensor leaf keeps the saved dtype and goes to the device of its
    counterpart in `like`."""
    kids = _children(like)
    if kids is None:
        leaf = next(leaves)
        if isinstance(like, torch.Tensor):
            return torch.as_tensor(leaf).to(like.device)
        return leaf
    children, build = kids
    return build([_rebuild(child, leaves) for child in children])


def save_state(path: str, state) -> None:
    """Persist a solver-state tree (its tensors and Python scalars) to
    `path` with torch.save."""
    leaves = [x.detach().cpu() if isinstance(x, torch.Tensor) else x
              for x in _leaves(state)]
    torch.save({"leaves": leaves}, os.path.abspath(path))


def load_state(path: str, like):
    """Restore a solver-state tree saved by `save_state`.

    `like` is a template tree with the target structure; each restored
    tensor keeps its saved dtype and goes to the device of its counterpart
    in `like`."""
    data = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
    leaves = data["leaves"]
    want = len(_leaves(like))
    if len(leaves) != want:
        raise ValueError(f"checkpoint {path!r} holds {len(leaves)} leaves, "
                         f"the template {want}")
    return _rebuild(like, iter(leaves))
