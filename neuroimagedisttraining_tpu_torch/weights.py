"""Carry weights and masks between the reference package's flax trees and
the port's state dicts.

flax ``params`` / ``batch_stats`` are nested dicts of numpy arrays (e.g.
``params["f0"]["conv"]["kernel"]``); the port's state is flat dicts keyed
``"f0.conv.weight"``. Per leaf:

- conv ``kernel`` DHWIO -> ``weight`` OIDHW (``permute(4, 3, 0, 1, 2)``),
  HWIO -> OIHW (``permute(3, 2, 0, 1)``);
- dense ``kernel`` ``[in, out]`` -> ``weight`` ``[out, in]``;
- a kernel that is a top-level parameter with no module of its own
  (``meta.py``'s ``meta_conv1_kernel``) -> ``meta_conv1_weight``, laid
  out as above;
- BatchNorm and GroupNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``
  (nested as the modules are: ``bn1/norm/scale`` for the 2D ResNet's
  BatchNorm, ``bn1/scale`` for its ``ipbn``; none for a BatchNorm without
  scale or bias);
- ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
- the DARTS search net's top-level ``alphas_normal`` / ``alphas_reduce``
  keep their names and layout.

Every model of the zoo carries over leaf by leaf, both ways: the port's
module names are flax's (ResNet3D's nested ``layer2_0/ds_conv``), a
bias-free conv has no ``bias`` leaf on either side, and the GroupNorm
model's empty ``batch_stats`` is an empty dict. A mask tree is congruent
with ``params`` and converts the same way. The port flattens channels-last
before a dense layer, so the dense kernels need no row permutation.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
#: top-level leaves that carry over under their own name
_AS_IS = ("alphas_normal", "alphas_reduce")


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


#: a flax kernel's axes as the port lays them out, by rank, and back
_TO_TORCH = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 2: (1, 0)}
_TO_FLAX = {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0), 2: (1, 0)}


def _to_torch_layout(leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf.endswith("kernel") and a.ndim in _TO_TORCH:
        return np.transpose(a, _TO_TORCH[a.ndim])
    return a


def _to_flax_layout(leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf.endswith("kernel") and a.ndim in _TO_FLAX:
        return np.transpose(a, _TO_FLAX[a.ndim])
    return a


def _port_name(mods, leaf: str, names: dict[str, str]) -> str:
    """The port's name of the flax leaf ``mods/leaf``."""
    if not mods and leaf in _AS_IS:
        return leaf
    if leaf not in names and leaf.endswith("_kernel"):  # a top-level kernel
        return ".".join((*mods, leaf.removesuffix("kernel") + "weight"))
    return ".".join((*mods, names[leaf]))


def _convert(tree: Mapping, names: dict[str, str]) -> dict[str, torch.Tensor]:
    out = {}
    for path, a in _flatten(tree).items():
        *mods, leaf = path
        a = np.ascontiguousarray(_to_torch_layout(leaf, np.asarray(a)))
        out[_port_name(mods, leaf, names)] = torch.from_numpy(
            a.astype(np.float32))
    return out


def params_from_flax(params: Mapping, batch_stats: Mapping
                     ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """flax ``(params, batch_stats)`` -> the port's ``(params, bstats)``
    (CPU float32 tensors)."""
    return _convert(params, _PARAM_NAMES), _convert(batch_stats, _STAT_NAMES)


def masks_from_flax(masks: Mapping) -> dict[str, torch.Tensor]:
    """A flax mask tree (congruent with ``params``) -> the port's masks."""
    return _convert(masks, _PARAM_NAMES)


def params_to_flax(params: Mapping[str, torch.Tensor],
                   bstats: Mapping[str, torch.Tensor],
                   like_params: Mapping, like_stats: Mapping
                   ) -> tuple[dict, dict]:
    """The port's state -> nested numpy trees with the structure of
    ``like_params`` / ``like_stats`` (a flax tree of the same model)."""
    def back(tree, names, state):
        def walk(t, prefix):
            out = {}
            for k, v in t.items():
                if isinstance(v, Mapping):
                    out[k] = walk(v, prefix + (k,))
                else:
                    a = state[_port_name(prefix, k, names)]
                    out[k] = np.ascontiguousarray(_to_flax_layout(
                        k, a.detach().cpu().numpy()))
            return out
        return walk(tree, ())

    return (back(like_params, _PARAM_NAMES, params),
            back(like_stats, _STAT_NAMES, bstats))


def _flax_path(name: str, ndim: int, stats: bool) -> tuple[str, ...]:
    """The flax path (within ``params`` / ``batch_stats``) of the port's
    leaf ``name`` of rank ``ndim``: the inverse of ``_port_name``."""
    if name in _AS_IS:
        return (name,)
    *mods, leaf = name.split(".")
    if stats:
        back = {v: k for k, v in _STAT_NAMES.items()}
        return (*mods, back[leaf])
    if not mods and leaf.endswith("_weight"):  # a top-level kernel
        return (leaf.removesuffix("weight") + "kernel",)
    if leaf == "bias":
        return (*mods, "bias")
    if leaf == "weight":
        if ndim in _TO_FLAX:
            return (*mods, "kernel")
        if ndim == 1:
            return (*mods, "scale")
    raise ValueError(f"no flax name for the port's leaf {name!r} "
                     f"(rank {ndim})")


def flax_named_leaves(params: Mapping[str, torch.Tensor],
                      bstats: Mapping[str, torch.Tensor]
                      ) -> dict[str, np.ndarray]:
    """The upload ``{"params": params, "batch_stats": bstats}`` as the
    reference's wire names it: float32 numpy leaves in flax's layout,
    keyed by their flax paths (``"params/f0/conv/kernel"``), in flax's
    leaf order (keys sorted at every level)."""
    out = {}
    for top, state, stats in (("batch_stats", bstats, True),
                              ("params", params, False)):
        for name, v in state.items():
            a = v.detach().cpu().numpy()
            path = _flax_path(name, a.ndim, stats)
            out[(top, *path)] = np.ascontiguousarray(
                _to_flax_layout(path[-1], a))
    return {"/".join(p): out[p] for p in sorted(out)}


def _nest(flat: dict[tuple, Any]) -> dict:
    out: dict = {}
    for path in sorted(flat):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = flat[path]
    return out


def state_to_flax(state, stats: bool) -> dict:
    """A state (``params`` or, with ``stats``, ``batch_stats``; a mask is
    params-like) or a list of one a client as the reference's nested
    tree of numpy leaves in flax's layout; a list becomes the
    client-stacked tree (a leading client axis on every leaf), as the
    reference's per-client stacks are."""
    stacked = isinstance(state, list)
    names = list(state[0]) if stacked else list(state)
    flat = {}
    for name in names:
        if stacked:
            a = np.stack([s[name].detach().cpu().numpy() for s in state])
            lead, rank = (0,), a.ndim - 1
        else:
            a = state[name].detach().cpu().numpy()
            lead, rank = (), a.ndim
        path = _flax_path(name, rank, stats)
        if path[-1].endswith("kernel") and rank in _TO_FLAX:
            a = np.transpose(a, lead + tuple(len(lead) + i
                                             for i in _TO_FLAX[rank]))
        flat[path] = np.ascontiguousarray(a)
    return _nest(flat)


def state_from_flax(tree: Mapping, shapes: Mapping[str, tuple],
                    device=None):
    """:func:`state_to_flax`'s inverse: a nested flax tree -> a state, or
    a list of one a client where its leaves carry a leading client axis
    over the port's ``shapes`` (name -> shape, the model's leaves, in
    the model's order, which the state's keys keep). ``batch_stats``
    trees (``mean`` / ``var`` leaves) map to the buffers. Tensors go to
    ``device``."""
    flat = _flatten(tree)
    if not flat:
        return {}
    stats = all(p[-1] in _STAT_NAMES for p in flat)
    names = _STAT_NAMES if stats else _PARAM_NAMES
    out, stacked = {}, None
    for path, a in flat.items():
        *mods, leaf = path
        name = _port_name(mods, leaf, names)
        a = np.asarray(a)
        rank = len(shapes[name])
        lead = a.ndim - rank
        if stacked is None:
            stacked = lead == 1
        if lead != int(stacked):
            raise ValueError(f"checkpoint leaf {'/'.join(path)} of shape "
                             f"{a.shape} against the model's {name} "
                             f"{tuple(shapes[name])}")
        if leaf.endswith("kernel") and rank in _TO_TORCH:
            a = np.transpose(a, tuple(range(lead)) + tuple(
                lead + i for i in _TO_TORCH[rank]))
        # a copy in the allocator's memory: a reduction over numpy's
        # buffer (another alignment) may round differently
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(
            device, copy=True)
    # the model's leaf order (a sum over leaves runs in dict order)
    out = {k: out[k] for k in shapes if k in out}
    if not stacked:
        return out
    n = next(iter(out.values())).shape[0]
    return [{k: v[c].clone() for k, v in out.items()} for c in range(n)]
