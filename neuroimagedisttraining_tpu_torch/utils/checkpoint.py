"""Round-granular checkpoint and resume (the reference package's
``utils/checkpoint.py``, whose file contract this keeps).

The original code had no checkpoints: multi-day runs killed at a time
limit lost everything. An engine saves ``{"round": r, "state": state}``
after round ``r`` (the last one completed) every ``--checkpoint_every``
rounds and at the last round, and a run resumes at ``r + 1``.

- The file is ``<dir>/ckpt_%08d.msgpack``, written to a ``.tmp`` file,
  flushed, fsynced and moved into place with ``os.replace``; the newest
  ``keep`` (3) are kept.
- The encoding is msgpack as ``flax.serialization.msgpack_serialize``
  writes it (``codec/wire.py``: maps in sorted key order, an ndarray as
  ext type 1, an array above 1 GiB chunked as flax chunks it), so a port
  checkpoint loads with ``flax.serialization.msgpack_restore``. Tensors
  are saved as numpy arrays (on the host), and come back as numpy.
- The reference resumes bit for bit because each draw is keyed by the
  round index. The port's trainer draws its permutations, dropout masks
  and IterSNIP rows from one ``torch.Generator``, so the state carries
  the generator's state: a ``torch.Generator`` leaf is saved as
  ``{"__torch_generator_state__": uint8 array}`` (the reference marks its
  typed PRNG keys ``__prng_key_data__``) and loads back as that state, a
  ``uint8`` tensor, for the engine to set.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.codec.wire import (
    msgpack_loads, msgpack_parts,
)

_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.msgpack$")
#: the mark of a saved generator state
GEN_MARK = "__torch_generator_state__"


def _encode(tree: Any) -> Any:
    if isinstance(tree, torch.Generator):
        return {GEN_MARK: tree.get_state().numpy()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _encode(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_encode(v) for v in tree]
    if isinstance(tree, np.generic):
        return tree.item()
    return tree


def _decode(tree: Any) -> Any:
    if isinstance(tree, dict):
        if GEN_MARK in tree:
            return torch.from_numpy(np.asarray(tree[GEN_MARK], np.uint8))
        return {k: _decode(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_decode(v) for v in tree]
    return tree


def _path(ckpt_dir: str, round_idx: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{round_idx:08d}.msgpack")


def save_checkpoint(ckpt_dir: str, round_idx: int, state: dict,
                    keep: int = 3) -> str:
    """Write ``state`` as round ``round_idx``'s checkpoint (the round just
    completed), atomically; keep the newest ``keep``. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    parts = msgpack_parts({"round": int(round_idx), "state": _encode(state)})
    final = _path(ckpt_dir, round_idx)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        f.writelines(parts)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    for old in list_checkpoints(ckpt_dir)[:-keep]:
        os.unlink(_path(ckpt_dir, old))
    return final


def list_checkpoints(ckpt_dir: str) -> list[int]:
    """The rounds with a checkpoint in ``ckpt_dir``, ascending (none for a
    missing directory)."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def load_checkpoint(ckpt_dir: str, round_idx: int | None = None
                    ) -> tuple[int, dict] | None:
    """The given (or the latest) checkpoint as ``(round_idx, state)``:
    ``round_idx`` is the last completed round, the run resumes at
    ``round_idx + 1``. None where there is none; a missing round raises
    ``FileNotFoundError``."""
    rounds = list_checkpoints(ckpt_dir)
    if not rounds:
        return None
    if round_idx is None:
        round_idx = rounds[-1]
    elif round_idx not in rounds:
        raise FileNotFoundError(
            f"no checkpoint for round {round_idx} in {ckpt_dir} "
            f"(have {rounds})")
    with open(_path(ckpt_dir, round_idx), "rb") as f:
        payload = msgpack_loads(f.read())
    return int(payload["round"]), _decode(payload["state"])
