"""Checkpoint -> deployment bundle (the reference package's
``serve/bundle.py``, whose files this writes byte for byte).

A bundle is a directory holding ``manifest.json`` and ``weights.msgpack``.
``build_bundle`` reads a training checkpoint (``utils/checkpoint.py``:
either package's, both hold the reference's keys and flax trees), strips
the training state (optimizer state, generator, history, FedFomo's
weights), casts the float32 masters to bfloat16 inference weights (float32
behind ``precision="fp32"``), multiplies SalientGrads' masks into the
served weights (their nonzero count is pinned in the manifest), and
unstacks the per-site personalized models (Ditto / FedFomo ``per_params``
``[C, ...]`` stacks) into entries of their own, so that the front end can
route a site to its model.

The weights stay flax trees (``{"params", "batch_stats"}`` in flax's
layout and names) on disk; the engine turns them into the port's state at
load (``weights.params_from_flax``). A bfloat16 leaf is a CPU
``torch.bfloat16`` tensor here (``codec/wire.py``'s convention: numpy has
no bfloat16 without ``ml_dtypes``), cast from float32 by round to nearest
even with ``ml_dtypes``' NaN (``0x7FC0`` with the sign kept), so that the
payload is the reference's to the byte. FedFomo keeps no global model, so
its global entry is the uniform mean of the personal stack, taken by numpy
in float32 as the reference takes it.

The manifest has no timestamp and is written with sorted keys, so that
save -> load -> save is bitwise-stable; it carries a sha256 over the
weights payload and a digest of every model, and ``load_bundle``
recomputes both and refuses any drift with the reference's messages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Callable

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.codec.wire import (
    msgpack_dumps, msgpack_loads,
)
from neuroimagedisttraining_tpu_torch.utils.checkpoint import load_checkpoint

#: bump when the manifest schema or weights layout changes; load_bundle
#: refuses any other version
BUNDLE_VERSION = 1

MANIFEST_NAME = "manifest.json"
WEIGHTS_NAME = "weights.msgpack"

#: manifest keys that must be present (the schema floor)
_REQUIRED_KEYS = (
    "bundle_version", "model", "num_classes", "input_shape", "precision",
    "source_round", "flavor", "sites", "sparse_nnz", "total_params",
    "weights_sha256", "models",
)

GLOBAL_KEY = "global"


class BundleError(ValueError):
    """Raised on any bundle build/load contract violation; the message
    names the file and the drift."""


def _site_key(site: str) -> str:
    return f"site:{site}"


def _sha256(raw: bytes) -> str:
    return hashlib.sha256(raw).hexdigest()


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (and of congruent ``rest``
    trees); a dict out in sorted key order, as jax rebuilds one."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                other = (sorted(r) if isinstance(r, dict)
                         else type(r).__name__)
                raise ValueError(f"tree structures differ: keys "
                                 f"{sorted(tree)} vs {other}")
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def _leaves(tree: Any) -> list:
    """The leaves of nested dicts in sorted key order (jax's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def bf16_round(x: np.ndarray) -> torch.Tensor:
    """float -> bfloat16, round to nearest even, as ``ml_dtypes`` casts
    (NaN -> ``0x7FC0`` with its sign): a CPU ``torch.bfloat16`` tensor
    (``torch``'s own cast spells NaN ``0xFFFF``)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
               ) >> np.uint32(16)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    bits = np.where(nan, np.uint32(0x7FC0) | ((u >> np.uint32(16))
                                             & np.uint32(0x8000)), rounded)
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(
        torch.bfloat16)


def _cast_floats(tree: Any, precision: str) -> Any:
    def cast(x):
        x = np.asarray(x)
        if not np.issubdtype(x.dtype, np.floating):
            return x
        return x.astype(np.float32) if precision == "fp32" else bf16_round(x)

    return _tree_map(cast, tree)


def _count_params(tree: Any) -> int:
    return int(sum(int(np.prod(tuple(x.shape))) for x in _leaves(tree)))


def _count_nnz(tree: Any) -> int:
    return int(sum(int(np.count_nonzero(np.asarray(x)))
                   for x in _leaves(tree)))


def _model_digest(entry: dict) -> str:
    """sha256 over the model's own serialized subtree: what ``/predict``
    replies echo, so that two sites can show they were served different
    personalized weights."""
    return _sha256(msgpack_dumps(entry))


def _apply_mask(params: Any, masks: Any) -> Any:
    """Multiply SalientGrads' masks into the served params (the engine
    sees only the zeroed weights)."""
    try:
        return _tree_map(lambda p, m: np.asarray(p) * np.asarray(m),
                         params, masks)
    except ValueError as e:
        raise BundleError(
            f"salientgrads mask tree does not match params tree: {e}"
        ) from e


def _unstack(tree: Any, idx: int) -> Any:
    """Row ``idx`` of a [C, ...] stacked per-site tree."""
    return _tree_map(lambda x: np.asarray(x)[idx], tree)


def _stack_dim(tree: Any) -> int:
    leaves = _leaves(tree)
    if not leaves:
        return 0
    return int(np.asarray(leaves[0]).shape[0])


def _infer_flavor(state: dict) -> str:
    """The checkpoint's flavor from its state keys (each engine's
    checkpoint slots)."""
    if "masks" in state:
        return "salientgrads"
    if "p_choose" in state or "weights" in state:
        return "fedfomo"
    if "per_params" in state:
        return "ditto"
    if "params" in state:
        return "fedavg"
    raise BundleError(
        f"unrecognized checkpoint state (keys={sorted(state)}): no "
        "params/per_params — not a federation checkpoint?")


def _mean_tree(tree: Any) -> Any:
    """Uniform mean over the leading [C, ...] axis in float32 (numpy's
    summation order, the reference's): FedFomo's global fallback."""
    return _tree_map(
        lambda x: np.mean(np.asarray(x, np.float32), axis=0), tree)


def build_bundle(checkpoint_dir: str, out_dir: str, *, model: str,
                 num_classes: int, input_shape: tuple[int, ...] | list[int],
                 precision: str = "bf16", round_idx: int | None = None,
                 ) -> dict:
    """Convert a training checkpoint into a bundle directory; returns the
    manifest. ``precision`` is ``"bf16"`` (the default) or ``"fp32"``."""
    if precision not in ("bf16", "fp32"):
        raise BundleError(
            f"precision must be bf16|fp32, got {precision!r}")
    found = load_checkpoint(checkpoint_dir, round_idx)
    if found is None:
        raise BundleError(f"no checkpoints in {checkpoint_dir!r}")
    source_round, state = found
    flavor = _infer_flavor(state)

    g_params = state.get("params")
    g_bstats = state.get("batch_stats", {})
    per_params = state.get("per_params")
    per_bstats = state.get("per_bstats", {})
    masks = state.get("masks")
    sparse_nnz = None
    if masks is not None and g_params is not None:
        g_params = _apply_mask(g_params, masks)
        sparse_nnz = _count_nnz(g_params)
    if g_params is None:
        # FedFomo keeps no global model: the uniform mean of the personal
        # stack serves unknown sites
        if per_params is None:
            raise BundleError(
                f"checkpoint flavor {flavor!r} has neither params nor "
                "per_params")
        g_params = _mean_tree(per_params)
        g_bstats = _mean_tree(per_bstats) if _leaves(per_bstats) else {}

    models: dict[str, dict] = {
        GLOBAL_KEY: {
            "params": _cast_floats(g_params, precision),
            "batch_stats": _cast_floats(g_bstats, precision),
        }
    }
    sites: list[str] = []
    if per_params is not None:
        n_sites = _stack_dim(per_params)
        has_bstats = bool(_leaves(per_bstats))
        for i in range(n_sites):
            site = str(i)
            sites.append(site)
            p_i = _unstack(per_params, i)
            if masks is not None:
                p_i = _apply_mask(p_i, masks)
            models[_site_key(site)] = {
                "params": _cast_floats(p_i, precision),
                "batch_stats": _cast_floats(
                    _unstack(per_bstats, i) if has_bstats else {},
                    precision),
            }

    payload = msgpack_dumps({k: models[k] for k in sorted(models)})
    manifest = {
        "bundle_version": BUNDLE_VERSION,
        "model": model,
        "num_classes": int(num_classes),
        "input_shape": [int(d) for d in input_shape],
        "precision": precision,
        "source_round": int(source_round),
        "flavor": flavor,
        "sites": sites,
        "sparse_nnz": sparse_nnz,
        "total_params": _count_params(models[GLOBAL_KEY]["params"]),
        "weights_sha256": _sha256(payload),
        "models": {k: {"digest": _model_digest(models[k])}
                   for k in sorted(models)},
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, WEIGHTS_NAME), "wb") as f:
        f.write(payload)
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


@dataclasses.dataclass(frozen=True)
class ServeBundle:
    """A validated, loaded bundle: the manifest and the weight trees keyed
    ``"global"`` / ``"site:<id>"``."""

    path: str
    manifest: dict
    models: dict[str, dict]

    @property
    def model_name(self) -> str:
        return self.manifest["model"]

    @property
    def num_classes(self) -> int:
        return int(self.manifest["num_classes"])

    @property
    def input_shape(self) -> tuple[int, ...]:
        return tuple(self.manifest["input_shape"])

    @property
    def precision(self) -> str:
        return self.manifest["precision"]

    @property
    def source_round(self) -> int:
        return int(self.manifest["source_round"])

    @property
    def sites(self) -> tuple[str, ...]:
        return tuple(self.manifest["sites"])

    def digest(self, model_key: str) -> str:
        return self.manifest["models"][model_key]["digest"]

    def route(self, site: str | None) -> str:
        """Site -> model key; an unknown or absent site falls back to the
        global model (the caller records the unknown-site verdict)."""
        if site is not None and _site_key(site) in self.models:
            return _site_key(site)
        return GLOBAL_KEY


def read_manifest(bundle_dir: str) -> dict:
    """Parse and schema-check ``manifest.json`` (no weights read)."""
    mpath = os.path.join(bundle_dir, MANIFEST_NAME)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except FileNotFoundError as e:
        raise BundleError(f"not a bundle: {mpath} missing") from e
    except json.JSONDecodeError as e:
        raise BundleError(f"corrupt manifest {mpath}: {e}") from e
    missing = [k for k in _REQUIRED_KEYS if k not in manifest]
    if missing:
        raise BundleError(
            f"stale manifest {mpath}: missing keys {missing} "
            f"(schema version {BUNDLE_VERSION} requires "
            f"{list(_REQUIRED_KEYS)})")
    if manifest["bundle_version"] != BUNDLE_VERSION:
        raise BundleError(
            f"bundle version mismatch in {mpath}: found "
            f"{manifest['bundle_version']!r}, this tree speaks "
            f"{BUNDLE_VERSION}")
    return manifest


def load_bundle(bundle_dir: str) -> ServeBundle:
    """Load and verify a bundle. Every drift raises ``BundleError`` naming
    the mismatch: schema, payload sha256, model set or per-model
    digest."""
    manifest = read_manifest(bundle_dir)
    wpath = os.path.join(bundle_dir, WEIGHTS_NAME)
    try:
        with open(wpath, "rb") as f:
            payload = f.read()
    except FileNotFoundError as e:
        raise BundleError(f"bundle {bundle_dir!r}: {WEIGHTS_NAME} "
                          "missing") from e
    got = _sha256(payload)
    if got != manifest["weights_sha256"]:
        raise BundleError(
            f"weights drift in {wpath}: sha256 {got[:12]}… != manifest "
            f"{manifest['weights_sha256'][:12]}…")
    try:
        models = msgpack_loads(payload)
    except Exception as e:  # noqa: BLE001 — a corrupt payload, any type
        raise BundleError(f"corrupt weights payload {wpath}: {e}") from e
    want_keys = {GLOBAL_KEY} | {_site_key(s) for s in manifest["sites"]}
    if set(models) != want_keys:
        raise BundleError(
            f"bundle {bundle_dir!r}: weights carry models "
            f"{sorted(models)} but manifest declares {sorted(want_keys)}")
    for key, entry in models.items():
        digest = _model_digest(entry)
        if digest != manifest["models"][key]["digest"]:
            raise BundleError(
                f"model {key!r} drift in {wpath}: digest {digest[:12]}… "
                f"!= manifest {manifest['models'][key]['digest'][:12]}…")
    return ServeBundle(path=os.path.abspath(bundle_dir),
                       manifest=manifest, models=models)
