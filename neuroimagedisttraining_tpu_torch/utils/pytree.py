"""The small algebra of model states that the engines, the health stats
and the rollback share (the reference package's ``utils/pytree.py``).

A state is a ``dict[str, Tensor]`` keyed by the model's parameter or buffer
names (``"f0.conv.weight"``); a client-stacked state holds a leading client
axis on every leaf; a list of states is one state a client. Reductions
(``tree_dot``, ``tree_norm``) accumulate in float32 on the leaves' device
and return a 0-d tensor: no host read.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

State = dict[str, torch.Tensor]


def tree_map(fn: Callable, *trees: Mapping[str, torch.Tensor]) -> State:
    """``fn`` leaf by leaf over states with the same keys (the first's
    order)."""
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def tree_sub(a: Mapping, b: Mapping) -> State:
    return tree_map(torch.sub, a, b)


def tree_clone(tree: Mapping) -> State:
    """A copy that owns its tensors (a pin no later step can change)."""
    return {k: v.detach().clone() for k, v in tree.items()}


def tree_dot(a: Mapping, b: Mapping) -> torch.Tensor:
    """``sum_leaves <a, b>`` in float32, a 0-d tensor."""
    parts = [torch.vdot(a[k].reshape(-1).to(torch.float32),
                        b[k].reshape(-1).to(torch.float32)) for k in a]
    if not parts:
        return torch.zeros(())
    return torch.sum(torch.stack(parts))


def tree_norm(tree: Mapping) -> torch.Tensor:
    """The global L2 norm over every leaf (``clip_grad_norm_``'s)."""
    return torch.sqrt(torch.clamp(tree_dot(tree, tree), min=0.0))


def tree_stack(states: list[Mapping]) -> State:
    """One state a client -> the client-stacked state ``[C, ...]``."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def tree_stack_index(stacked: Mapping, idx) -> State:
    """Rows ``idx`` of a client-stacked state: ``tree[idx]`` per leaf."""
    return {k: v[idx] for k, v in stacked.items()}


def tree_weighted_mean(stacked: Mapping, weights: torch.Tensor) -> State:
    """The weighted mean over the leading client axis (FedAvg): weights
    normalized first, then ``sum_c x_c * w_c`` per leaf in float32."""
    w = weights.to(torch.float32)
    w = w / torch.clamp(torch.sum(w), min=1e-12)

    def leaf(x):
        wb = w.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.sum(x.to(torch.float32) * wb, dim=0).to(x.dtype)

    return {k: leaf(v) for k, v in stacked.items()}


def tree_by_name(tree: Mapping, name: str):
    """A leaf by its ``/``-joined key path in a nested tree (the flax
    trees of a checkpoint), or by its flat key in a state."""
    if name in tree:
        return tree[name]
    node = tree
    for part in name.split("/"):
        node = node[part] if isinstance(node, Mapping) else node[int(part)]
    return node
