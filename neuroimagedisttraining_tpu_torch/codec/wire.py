"""Model-update wire codec: delta + mask/top-k sparse + int8/bf16 quant.

The reference package's ``codec/wire.py``, in numpy on the host: the spec
parser, the tagged frame and its encode / decode, and the exact byte
count of a frame once the message envelope serializes it, which the
engines add up in ``stat_info`` (``sum_comm_bytes`` against
``sum_comm_bytes_dense``).

Three composable stages, each optional (``parse_wire_spec``):

- **delta**: the payload is ``update - reference``, the reference being
  the round's broadcast model; the receiver adds it back.
- **sparse**: *mask mode* (``masks`` given) ships the values on the mask,
  with a packed bitmap or, when the receiver holds the same mask
  (``mask_on_wire=False``: SalientGrads' phase-1 mask), none; *top-k mode*
  keeps the ``topk_ratio`` largest magnitudes over the whole update, and
  the sender's error feedback carries what was dropped (and the
  quantization error) into the next round's residual.
- **quant**: per-leaf ``int8`` (symmetric, scale = amax / 127, round half
  to even) or ``bf16`` (round to nearest even).

The downlink has a frame of its own (``encode_sync_delta``): a sync reply
of the asynchronous plane as the lossless byte delta between two versions
of the model, ``{SYNC_DELTA_KEY, "base", "z", "body"}``.

A frame is ``{FRAME_KEY, "spec", "delta", "z", "body"}``; ``body`` is the
per-leaf record table as msgpack, deflated when that shrinks it. An update
here is a dict of numpy leaves named by their flax paths
(``"params/f0/conv/kernel"``) in flax's layout and order
(``weights.flax_named_leaves``), so the frame is byte for byte the
reference's. The msgpack encoding is this module's own (the subset the
frames use, as ``flax.serialization.msgpack_serialize`` lays it out: maps
in sorted key order, an ndarray as ext type 1 holding ``(shape, dtype
name, buffer)``); nothing here imports flax or msgpack.

numpy has no bfloat16 without ``ml_dtypes``, which the port does not use.
An ndarray ext whose dtype name is ``"bfloat16"`` (a serving bundle's
weights, ``serve/bundle.py``) decodes to a CPU ``torch.bfloat16`` tensor
holding the stored bits, and a ``torch.bfloat16`` tensor encodes back under
that name with the same bytes; any other tensor encodes as its numpy array.
"""

from __future__ import annotations

import struct
import sys
import zlib
from dataclasses import dataclass, replace
from typing import Any

import numpy as np

#: frame magic + version; decoders refuse other versions
FRAME_KEY = "__nidt_codec__"
FRAME_VERSION = 1

#: magic of the other tagged body of the wire, a secure quantized
#: field-element frame (privacy/secure_quant.py): defined here so that the
#: plain decode path can refuse one, without an import of privacy/
SECURE_QUANT_KEY = "__nidt_secure_quant__"

#: magic + version of the downlink delta-sync frame: a changed-version sync
#: reply shipped as the lossless byte delta against the version the
#: receiver last synced (the asynchronous plane's broadcast ring). The
#: receiver trains on the decoded tree, so the delta is a raw-byte XOR
#: against the base, exactly invertible for every dtype.
SYNC_DELTA_KEY = "__nidt_sync_delta__"
SYNC_DELTA_VERSION = 1

# sparse-record modes: how the receiver learns the support
_SP_DENSE = 0      # all values shipped
_SP_BITMAP = 1     # packed bitmap frame precedes the values
_SP_SHARED = 2     # receiver holds the same mask (engine mask handoff)

#: msgpack ext type of an ndarray (flax's ``_MsgpackExtType.ndarray``)
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3  # a numpy scalar: an ndarray ext of shape () (flax's)
#: an array above this many bytes, as a map's value or the whole tree, is
#: split into chunks of at most this size (flax's ``MAX_CHUNK_SIZE`` and
#: chunk layout); no frame of the zoo comes near it, a checkpoint may
_MAX_CHUNK = 2 ** 30
#: the key that marks a chunked array's map (flax's)
_CHUNKED = "__msgpack_chunked_array__"


@dataclass(frozen=True)
class WireSpec:
    """Parsed ``--wire_codec`` value. Hashable and order-insensitive:
    ``"quant+delta" == "delta+quant"``."""

    delta: bool = False
    sparse: bool = False
    quant: str = ""            # "" | "int8" | "bf16"
    topk_ratio: float = 0.25   # top-k keep fraction when sparse w/o masks

    @property
    def canonical(self) -> str:
        parts = ([p for p, on in (("delta", self.delta),
                                  ("sparse", self.sparse)) if on]
                 + ([{"int8": "quant", "bf16": "quant16"}[self.quant]]
                    if self.quant else []))
        return "+".join(parts) if parts else "none"

    @property
    def needs_ef(self) -> bool:
        """Error feedback applies only to lossy top-k sparsification; mask
        mode drops entries the engine's own training pins to zero."""
        return self.sparse


def parse_wire_spec(text: str, topk_ratio: float = 0.25) -> WireSpec | None:
    """``none | delta | sparse | quant | quant16`` joined by ``+`` in any
    order -> WireSpec, or None for "none"/empty (dense wire)."""
    text = (text or "none").strip().lower()
    if text in ("", "none"):
        return None
    spec = WireSpec(topk_ratio=float(topk_ratio))
    for tok in text.split("+"):
        tok = tok.strip()
        if tok == "delta":
            spec = replace(spec, delta=True)
        elif tok == "sparse":
            spec = replace(spec, sparse=True)
        elif tok in ("quant", "int8", "quant8"):
            spec = replace(spec, quant="int8")
        elif tok in ("quant16", "bf16"):
            spec = replace(spec, quant="bf16")
        elif tok in ("", "none"):
            raise ValueError(
                f"--wire_codec {text!r}: 'none' cannot compose with "
                "other stages")
        else:
            raise ValueError(
                f"--wire_codec {text!r}: unknown stage {tok!r} (have "
                "delta | sparse | quant | quant16)")
    if not 0.0 < spec.topk_ratio <= 1.0:
        raise ValueError(
            f"wire_topk_ratio ({spec.topk_ratio}) must be in (0, 1]")
    return spec


def is_codec_frame(obj: Any) -> bool:
    return isinstance(obj, dict) and FRAME_KEY in obj


# ---------------------------------------------------------------------------
# msgpack, the subset the frames use
# ---------------------------------------------------------------------------

def _pack_len(out: list, n: int, fix: int | None, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16- or
    32-bit form (``codes[0]`` None-coded as 0 where msgpack has no 8-bit
    form)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
    elif codes[0] and n < 256:
        out.append(bytes([codes[0], n]))
    elif n < 65536:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 128:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, top in ((0xcc, ">BB", 0xff), (0xcd, ">BH", 0xffff),
                               (0xce, ">BI", 0xffffffff),
                               (0xcf, ">BQ", 2 ** 64 - 1)):
            if v <= top:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(v)
    else:
        for code, fmt, bot in ((0xd0, ">Bb", -2 ** 7), (0xd1, ">Bh", -2 ** 15),
                               (0xd2, ">Bi", -2 ** 31),
                               (0xd3, ">Bq", -2 ** 63)):
            if v >= bot:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(v)


def _pack_ext(out: list, code: int, *parts) -> None:
    """An ext record of ``code`` whose data is the bytes-like ``parts``
    (appended as they are: an array's buffer is not copied)."""
    n = sum(len(p) for p in parts)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    elif n < 256:
        out.append(bytes([0xc7, n, code]))
    elif n < 65536:
        out.append(struct.pack(">BHB", 0xc8, n, code))
    else:
        out.append(struct.pack(">BIB", 0xc9, n, code))
    out.extend(parts)


def _pack_ndarray(out: list, obj: np.ndarray, dtype: str = "",
                  code: int = _EXT_NDARRAY) -> None:
    """Ext type 1 holding ``(shape, dtype name, buffer)``; the buffer is a
    view of the array's bytes, named ``dtype`` where given (bfloat16 bits
    held as int16). A numpy scalar is the same record under ext type 3."""
    a = np.ascontiguousarray(obj)  # at least 1-d: the shape is obj's
    raw = memoryview(a.reshape(-1).view(np.uint8)) if a.size else b""
    head: list = [b"\x93"]
    _pack(head, list(np.shape(obj)), False)
    _pack(head, dtype or a.dtype.name, False)
    _pack_len(head, len(raw), None, 0, (0xc4, 0xc5, 0xc6))
    _pack_ext(out, code, b"".join(head), raw)


def _is_tensor(obj) -> bool:
    """A torch tensor. torch is imported where a process first needs it, not
    here (the ingest workers never do); a process that has not imported it
    holds no tensor."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(obj, torch.Tensor)


def _pack_tensor(out: list, obj: torch.Tensor) -> None:
    """A tensor as the ndarray ext of its values; a bfloat16 one under the
    dtype name ``"bfloat16"`` with its raw bits, as flax writes an
    ``ml_dtypes.bfloat16`` array."""
    import torch

    t = obj.detach().cpu()
    if t.dtype == torch.bfloat16:
        _pack_ndarray(out, t.view(torch.int16).numpy(), "bfloat16")
    else:
        _pack_ndarray(out, t.numpy())


def _bf16_tensor(raw, shape) -> torch.Tensor:
    """The stored bits of a ``"bfloat16"`` ndarray ext as a CPU
    ``torch.bfloat16`` tensor."""
    import torch

    bits = np.frombuffer(raw, dtype="<i2").reshape(shape).copy()
    return torch.from_numpy(bits).view(torch.bfloat16)


def _chunked(arr: np.ndarray) -> dict:
    """flax's chunked form of an array above ``_MAX_CHUNK`` bytes: its
    shape and its flat chunks, each a map keyed ``"0"``, ``"1"``, ..."""
    size = max(1, int(_MAX_CHUNK / arr.dtype.itemsize))
    flat = np.ascontiguousarray(arr).reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.size, size))}}


def _pack(out: list, obj, sort_maps: bool) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xcb, obj))
    elif type(obj) is str:
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(b)
    elif type(obj) in (bytes, bytearray):
        _pack_len(out, len(obj), None, 0, (0xc4, 0xc5, 0xc6))
        out.append(bytes(obj))
    elif type(obj) in (list, tuple):
        _pack_len(out, len(obj), 0x90, 16, (0, 0xdc, 0xdd))
        for v in obj:
            _pack(out, v, sort_maps)
    elif type(obj) is dict:
        _pack_len(out, len(obj), 0x80, 16, (0, 0xde, 0xdf))
        for k in (sorted(obj) if sort_maps else obj):
            _pack(out, k, sort_maps)
            v = obj[k]
            if isinstance(v, np.ndarray) and v.nbytes > _MAX_CHUNK:
                # flax chunks after sorting the tree: the chunk maps keep
                # their own order
                _pack(out, _chunked(v), False)
            else:
                _pack(out, v, sort_maps)
    elif isinstance(obj, np.ndarray):
        _pack_ndarray(out, obj)
    elif isinstance(obj, np.generic):
        _pack_ndarray(out, np.asarray(obj), code=_EXT_NPSCALAR)
    elif _is_tensor(obj):
        if obj.nbytes > _MAX_CHUNK:
            raise ValueError("msgpack: a tensor above 1 GiB is not chunked; "
                             "pass its numpy array")
        _pack_tensor(out, obj)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def msgpack_parts(tree) -> list:
    """:func:`msgpack_dumps`'s bytes as a list of bytes-like parts, each
    array's buffer a view of the array (a writer streams them out without
    a copy of the whole tree)."""
    out: list = []
    if isinstance(tree, np.ndarray) and tree.nbytes > _MAX_CHUNK:
        tree = _chunked(tree)
        _pack(out, tree, False)
    else:
        _pack(out, tree, True)
    return out


def msgpack_dumps(tree) -> bytes:
    """``tree`` (dicts, lists, str, int, float, bytes, ndarrays, numpy
    scalars) as the
    bytes ``flax.serialization.msgpack_serialize`` gives: every map in
    sorted key order (flax rebuilds the tree first, which sorts them), an
    array above 1 GiB chunked as flax chunks it."""
    return b"".join(msgpack_parts(tree))


def _unpack(buf, i: int, view: bool = False):
    """The object at ``buf[i]`` and the offset past it; ``view``: a bin
    comes back as a view of ``buf`` instead of a copy."""
    b = buf[i]
    i += 1
    if b < 0x80:
        return b, i
    if b >= 0xe0:
        return b - 256, i
    if 0x80 <= b <= 0x8f:
        return _unpack_map(buf, i, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _unpack_list(buf, i, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return str(buf[i:i + n], "utf-8"), i + n
    if b == 0xc0:
        return None, i
    if b in (0xc2, 0xc3):
        return b == 0xc3, i
    ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
            0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
    if b in ints:
        fmt = ints[b]
        n = struct.calcsize(fmt)
        return struct.unpack(fmt, buf[i:i + n])[0], i + n
    lens = {0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xc4: ">B", 0xc5: ">H",
            0xc6: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I",
            0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
    fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
    if b in fixext:
        n = fixext[b]
    elif b in lens:
        w = struct.calcsize(lens[b])
        n = struct.unpack(lens[b], buf[i:i + w])[0]
        i += w
    else:
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")
    if b in (0xd9, 0xda, 0xdb):
        return str(buf[i:i + n], "utf-8"), i + n
    if b in (0xc4, 0xc5, 0xc6):
        return (buf[i:i + n] if view else bytes(buf[i:i + n])), i + n
    if b in (0xdc, 0xdd):
        return _unpack_list(buf, i, n)
    if b in (0xde, 0xdf):
        return _unpack_map(buf, i, n)
    code, data = buf[i], buf[i + 1:i + 1 + n]
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack: unsupported ext type {code}")
    if data[0] != 0x93:
        raise ValueError("msgpack: an ndarray ext is not (shape, dtype, "
                         "buffer)")
    shape, j = _unpack(data, 1)
    dtype, j = _unpack(data, j)
    raw, _ = _unpack(data, j, view=True)
    if dtype == "bfloat16":
        return _bf16_tensor(raw, shape), i + 1 + n
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
    return (arr[()] if code == _EXT_NPSCALAR else arr), i + 1 + n


def _unpack_list(buf, i, n):
    out = []
    for _ in range(n):
        v, i = _unpack(buf, i)
        out.append(v)
    return out, i


def _unpack_map(buf, i, n):
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    if _CHUNKED in out:  # a chunked array (flax's msgpack_restore)
        shape = tuple(out["shape"][str(j)] for j in range(len(out["shape"])))
        chunks = [out["chunks"][str(j)] for j in range(len(out["chunks"]))]
        return np.concatenate(chunks).reshape(shape), i
    return out, i


def msgpack_loads(buf) -> Any:
    """The tree of :func:`msgpack_dumps`'s bytes (any bytes-like), chunked
    arrays joined."""
    buf = memoryview(buf)
    obj, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError("msgpack: trailing bytes")
    return obj


# ---------------------------------------------------------------------------
# shared encode math (float32 numpy; codec/device.py is the same in torch)
# ---------------------------------------------------------------------------

def _topk_threshold_np(absflat: np.ndarray, k: int) -> np.float32:
    """Exact k-th largest of a 1-D float32 vector: a ``|x| >= thr`` mask
    keeps >= k entries (ties included), as ``ops/topk.kth_largest``."""
    k = min(max(int(k), 1), absflat.size)
    return np.partition(absflat, absflat.size - k)[absflat.size - k]


def _to_bf16_bits(vals: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 (round to nearest even) as its uint16 bits."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(vals, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    import torch

    t = torch.from_numpy(np.ascontiguousarray(bits, np.uint16).view(np.int16))
    return t.view(torch.bfloat16).to(torch.float32).numpy()


def _quant_encode(vals: np.ndarray, quant: str) -> tuple[np.ndarray, float]:
    """Kept values -> wire values + per-leaf scale (int8 symmetric)."""
    if quant == "int8":
        amax = np.float32(np.max(np.abs(vals))) if vals.size else np.float32(0)
        scale = np.float32(amax / np.float32(127.0)) if amax > 0 \
            else np.float32(1.0)
        q = np.clip(np.rint(vals / scale), -127, 127).astype(np.int8)
        return q, float(scale)
    if quant == "bf16":
        return _to_bf16_bits(vals), 0.0
    return vals, 0.0


def _quant_decode(wire_vals: np.ndarray, quant: str,
                  scale: float) -> np.ndarray:
    if quant == "int8":
        return wire_vals.astype(np.float32) * np.float32(scale)
    if quant == "bf16":
        return _from_bf16_bits(wire_vals)
    return np.asarray(wire_vals, np.float32)


# ---------------------------------------------------------------------------
# encode / decode over flax-named leaves
# ---------------------------------------------------------------------------

def encode_update(spec: WireSpec, update: dict[str, np.ndarray], *,
                  reference: dict[str, np.ndarray] | None = None,
                  masks: dict[str, np.ndarray] | None = None,
                  ef: dict[str, np.ndarray] | None = None,
                  mask_on_wire: bool = True,
                  zlib_level: int = 6,
                  threshold_fn=None) -> tuple[dict, dict | None]:
    """Encode one model update (flax-named numpy leaves, in order) into a
    wire frame. Returns ``(frame, new_ef)``: ``new_ef`` is the next
    round's error-feedback accumulator (top-k mode; None otherwise).
    ``reference`` is required when ``spec.delta``; ``masks`` switches the
    sparse stage to mask mode; ``mask_on_wire=False`` leaves the bitmap
    out for a mask the receiver holds. ``threshold_fn(absflat, k)`` gives
    the top-k stage's threshold, the exact k-th largest of the float32
    vector (default: ``np.partition``; a cross-silo silo's device select,
    ``distributed/cross_silo.CodecThreshold``)."""
    if spec.delta and reference is None:
        raise ValueError("wire codec: delta stage needs the round's "
                         "broadcast reference tree")
    track_ef = spec.sparse and masks is None
    residuals: dict[str, np.ndarray] = {}
    for name, leaf in update.items():
        x = np.asarray(leaf, np.float32)
        if spec.delta:
            x = x - np.asarray(reference[name], np.float32)
        if track_ef and ef is not None and name in ef:
            x = x + np.asarray(ef[name], np.float32)
        residuals[name] = x
    keep_by: dict[str, np.ndarray] = {}
    if spec.sparse:
        if masks is not None:
            keep_by = {name: np.asarray(m) > 0 for name, m in masks.items()}
        else:
            flat = np.concatenate([np.abs(v).reshape(-1)
                                   for v in residuals.values()])
            k = max(1, int(np.ceil(spec.topk_ratio * flat.size)))
            thr = (threshold_fn or _topk_threshold_np)(flat, k)
            keep_by = {name: np.abs(v) >= thr
                       for name, v in residuals.items()}

    leaves: dict[str, dict] = {}
    new_ef: dict[str, np.ndarray] = {}
    for name, leaf in update.items():
        x = residuals[name]
        rec: dict[str, Any] = {"sh": list(x.shape),
                               "dt": str(np.asarray(leaf).dtype)}
        if spec.sparse:
            keep = keep_by[name]
            if masks is not None:
                rec["sp"] = _SP_SHARED if not mask_on_wire else _SP_BITMAP
                # mask-zero semantics: off-mask entries decode to exact
                # zero, not to the delta reference
                rec["mz"] = 1
            else:
                rec["sp"] = _SP_BITMAP
            if rec["sp"] == _SP_BITMAP:
                if keep.all():
                    rec["sp"] = _SP_DENSE  # bitmap would be pure overhead
                else:
                    rec["bm"] = np.packbits(keep.reshape(-1))
            kept = x.reshape(-1)[keep.reshape(-1)]
        else:
            keep = None
            kept = x.reshape(-1)
        wire_vals, scale = _quant_encode(kept, spec.quant)
        rec["q"] = spec.quant
        if spec.quant == "int8":
            rec["sc"] = scale
        rec["v"] = wire_vals
        leaves[name] = rec
        if track_ef:
            deq = np.zeros(x.size, np.float32)
            pos = keep.reshape(-1) if keep is not None else slice(None)
            deq[pos] = _quant_decode(wire_vals, spec.quant, scale)
            new_ef[name] = x - deq.reshape(x.shape)

    body = msgpack_dumps({"leaves": leaves})
    packed = zlib.compress(body, zlib_level)
    z = 1 if len(packed) < len(body) else 0
    frame = {FRAME_KEY: FRAME_VERSION, "spec": spec.canonical,
             "delta": int(spec.delta), "z": z,
             "body": np.frombuffer(packed if z else body, np.uint8)}
    return frame, ({name: new_ef[name] for name in update} if track_ef
                   else None)


def decode_update(obj: Any, *, like: dict[str, Any],
                  reference: dict[str, np.ndarray] | None = None,
                  masks: dict[str, np.ndarray] | None = None
                  ) -> dict[str, np.ndarray]:
    """Decode a wire frame back into the leaves named by ``like`` (in its
    order). Anything without the frame magic is a dense update and passes
    through unchanged. ``reference`` is required for delta frames,
    ``masks`` for shared-mask frames. A secure quantized frame is refused:
    its values are masked GF(p) residues, not model floats."""
    if isinstance(obj, dict) and SECURE_QUANT_KEY in obj:
        raise ValueError(
            "received a secure-quant field-element frame on the plain "
            "decode path: its values are masked GF(p) residues, not "
            "model floats — the receiver must run the secure-quant "
            "server (--secure_quant on every rank; see "
            "privacy/secure_quant.py)")
    if not is_codec_frame(obj):
        return obj  # dense fallback: always decodable
    ver = obj[FRAME_KEY]
    if int(ver) != FRAME_VERSION:
        raise ValueError(f"wire codec frame version {ver} != supported "
                         f"{FRAME_VERSION}")
    raw = np.asarray(obj["body"], np.uint8).tobytes()
    if int(obj.get("z", 0)):
        raw = zlib.decompress(raw)
    leaves = msgpack_loads(raw)["leaves"]
    delta = bool(int(obj.get("delta", 0)))
    if delta and reference is None:
        raise ValueError("wire codec: delta frame needs the round's "
                         "broadcast reference to decode")
    out: dict[str, np.ndarray] = {}
    for name, rec in leaves.items():
        shape = tuple(int(s) for s in rec["sh"])
        size = int(np.prod(shape)) if shape else 1
        vals = _quant_decode(rec["v"], rec.get("q", ""),
                             float(rec.get("sc", 0.0)))
        sp = int(rec.get("sp", _SP_DENSE))
        if sp == _SP_DENSE:
            flat = vals.astype(np.float32)
            keep = None
        else:
            if sp == _SP_SHARED:
                if masks is None or name not in masks:
                    raise ValueError(
                        f"wire codec: frame for leaf {name!r} uses "
                        "shared-mask mode but the receiver holds no mask "
                        "— configure the same engine mask on both "
                        "endpoints (mask handoff)")
                keep = (np.asarray(masks[name]) > 0).reshape(-1)
            else:
                keep = np.unpackbits(np.asarray(rec["bm"], np.uint8),
                                     count=size).astype(bool)
            flat = np.zeros(size, np.float32)
            flat[keep] = vals
        x = flat.reshape(shape)
        if delta:
            ref = np.asarray(reference[name], np.float32)
            if keep is not None and int(rec.get("mz", 0)):
                x = np.where(keep.reshape(shape), x + ref, np.float32(0.0))
            else:
                x = x + ref
        out[name] = x.astype(rec.get("dt", "float32"))
    missing = [n for n in like if n not in out]
    if missing:
        raise ValueError(
            f"codec frame is missing leaf {missing[0]!r} present in the "
            "template tree — sender/receiver model structures differ")
    return {n: out[n] for n in like}


def nest(named: dict[str, np.ndarray]) -> dict:
    """Flax-named leaves -> the nested tree they name (the dense upload
    the plain wire ships)."""
    tree: dict = {}
    for name, v in named.items():
        *mods, leaf = name.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# the downlink delta sync: a lossless byte delta between two versions of one
# model tree
# ---------------------------------------------------------------------------

def _tree_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` of a nested dict tree, keys sorted at every level
    (the reference's ``jax.tree`` leaf order)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(_tree_leaves(v, path))
        else:
            out.append((path, v))
    return out


def is_sync_delta_frame(obj: Any) -> bool:
    return isinstance(obj, dict) and SYNC_DELTA_KEY in obj


def _tree_bytes(tree) -> bytes:
    """The tree's raw leaf bytes in leaf order: the byte image both ends of
    a delta agree on (two versions of one model)."""
    return b"".join(np.ascontiguousarray(np.asarray(x)).tobytes()
                    for _, x in _tree_leaves(tree))


def _byte_shuffle(x: np.ndarray) -> np.ndarray:
    """Stride-4 byte-plane transpose (HDF5's shuffle filter): the XOR of
    two float32 versions has near-zero sign and exponent bytes and noisy
    low mantissa bytes, interleaved; grouped by plane they deflate to long
    zero runs. A permutation (``_byte_unshuffle`` inverts it); the
    trailing ``len % 4`` bytes pass through."""
    n4 = (x.size // 4) * 4
    if n4 == 0:
        return x
    return np.concatenate([x[:n4].reshape(-1, 4).T.ravel(), x[n4:]])


def _byte_unshuffle(x: np.ndarray) -> np.ndarray:
    n4 = (x.size // 4) * 4
    if n4 == 0:
        return x
    return np.concatenate([x[:n4].reshape(4, -1).T.ravel(), x[n4:]])


def encode_sync_delta(new, base, *, base_version: int,
                      zlib_level: int = 6) -> dict:
    """``new`` as the lossless delta against ``base``: ``bytes(new) XOR
    bytes(base)``, byte-plane shuffled, deflated where that shrinks it.
    ``decode_sync_delta(frame, base)`` is ``new`` bit for bit for every
    leaf dtype, NaN and Inf included."""
    nb = _tree_bytes(new)
    bb = _tree_bytes(base)
    if len(nb) != len(bb):
        raise ValueError(
            "sync delta: base and new trees have different byte sizes "
            f"({len(bb)} vs {len(nb)}) — not two versions of one model")
    x = _byte_shuffle(
        np.frombuffer(nb, np.uint8) ^ np.frombuffer(bb, np.uint8))
    packed = zlib.compress(x.tobytes(), zlib_level)
    z = 1 if len(packed) < x.size else 0
    return {SYNC_DELTA_KEY: SYNC_DELTA_VERSION,
            "base": int(base_version), "z": z,
            "body": np.frombuffer(packed, np.uint8) if z else x}


def decode_sync_delta(frame: dict, base) -> dict:
    """Invert :func:`encode_sync_delta` against the receiver's base tree,
    which must be the version ``frame["base"]`` names (the caller checks
    that against its own sync record)."""
    ver = frame[SYNC_DELTA_KEY]
    if int(ver) != SYNC_DELTA_VERSION:
        raise ValueError(f"sync delta frame version {ver} != supported "
                         f"{SYNC_DELTA_VERSION}")
    raw = np.asarray(frame["body"], np.uint8).tobytes()
    if int(frame.get("z", 0)):
        raw = zlib.decompress(raw)
    bb = _tree_bytes(base)
    if len(raw) != len(bb):
        raise ValueError(
            f"sync delta: body is {len(raw)} bytes but the base tree "
            f"is {len(bb)} — receiver base differs from the encoder's")
    nb = (_byte_unshuffle(np.frombuffer(raw, np.uint8))
          ^ np.frombuffer(bb, np.uint8)).tobytes()
    out: dict[str, np.ndarray] = {}
    off = 0
    for name, leaf in _tree_leaves(base):
        arr = np.asarray(leaf)
        n = arr.nbytes
        out[name] = np.frombuffer(
            nb[off:off + n], arr.dtype).reshape(arr.shape)
        off += n
    return nest(out)


def frame_nbytes(frame: dict) -> int:
    """Exact on-the-wire size of a frame (or of a dense nested tree) once
    the message envelope serializes it."""
    return len(msgpack_dumps(frame))
