"""Tagged, versioned wire messages and their byte codec.

A :class:`WireMessage` is the unit every ``repro_torch.wire`` backend
moves: a protocol ``tag`` (data plane: ``emb``/``loss`` — the §V wire;
control plane: ``act``/``skip``/``collect``/``params``/``stop``/
``ping``/``pong``), the sending party, the global round, a small JSON
``meta`` dict and a named payload of tensors (or numpy arrays).

The encoding is the JAX package's, byte for byte:

    [!4sHI  magic | version | header_len] [header JSON] [raw leaf bytes]

Every payload leaf is serialized through
:func:`repro_torch.checkpoint.io.encode_tensor` — the checkpoint plane's
uint-view codec — so bfloat16 client embeddings round-trip losslessly
and a byte on the wire is the same byte a checkpoint would store. The
header records each leaf's true dtype for :func:`decode_tensor` on the
far side, which hands the payload back as CPU tensors. Frames carried by
a stream transport get a fixed 8-byte length prefix (:func:`frame`); the
prefix is part of the measured wire cost, so ``LoopbackBackend`` and
``SocketBackend`` report identical per-message byte counts.

Version 2 adds a CRC32 of the payload body to the header, so a frame
bitten by a faulty transport (bit flip, truncation) raises a typed
:class:`FrameCorruption` instead of decoding garbage. Version 1 frames
(no checksum) stay readable; any other version is refused.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import zlib
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.io import decode_tensor, encode_tensor

WIRE_VERSION = 2
_READABLE_VERSIONS = (1, 2)         # v1 = pre-checksum frames
_MAGIC = b"VFLW"
_HEAD = struct.Struct("!4sHI")      # magic, version, header length
_LENGTH = struct.Struct("!Q")       # stream frame prefix
FRAME_OVERHEAD = _LENGTH.size       # beyond len(encode(msg))


class FrameCorruption(ValueError):
    """A frame failed its integrity checks (truncated body, CRC32
    mismatch, or an unparseable header) — the bytes are damaged, not
    merely foreign."""


# the §V data plane (metered in the privacy ledger) vs scheduler/worker
# bookkeeping (metered separately as control bytes, never in the ledger);
# ping/pong is the liveness heartbeat — an empty control round-trip
DATA_TAGS = ("emb", "loss")
CONTROL_TAGS = ("act", "skip", "collect", "params", "stop", "ping", "pong")


@dataclasses.dataclass
class WireMessage:
    tag: str
    sender: str                                   # "client" | "server"
    round: int = 0
    meta: dict = dataclasses.field(default_factory=dict)
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.tag not in DATA_TAGS + CONTROL_TAGS:
            raise ValueError(f"unknown wire tag {self.tag!r}")


def _stored(leaf) -> Tuple[np.ndarray, str]:
    """(stored array, true dtype name) of a payload leaf: a tensor goes
    through ``encode_tensor`` (on the host), a numpy array as it is."""
    if isinstance(leaf, torch.Tensor):
        return encode_tensor(leaf)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def encode(msg: WireMessage) -> bytes:
    """Serialize a message (header + raw leaf bytes, no length prefix)."""
    names = sorted(msg.payload)
    enc = {k: _stored(msg.payload[k]) for k in names}
    # the header records the TRUE shape: a 0-d scalar loss stays shape ()
    body = b"".join(np.ascontiguousarray(enc[k][0]).tobytes() for k in names)
    header = {
        "v": WIRE_VERSION, "tag": msg.tag, "sender": msg.sender,
        "round": int(msg.round), "meta": msg.meta,
        "crc": zlib.crc32(body),
        "leaves": [[k, list(enc[k][0].shape), enc[k][1],
                    str(enc[k][0].dtype)] for k in names],
    }
    hb = json.dumps(header, sort_keys=True,
                    separators=(",", ":")).encode("utf-8")
    return _HEAD.pack(_MAGIC, WIRE_VERSION, len(hb)) + hb + body


def decode(buf: bytes) -> WireMessage:
    """Inverse of :func:`encode`; the payload comes back as CPU tensors.

    Rejects foreign/forward-version frames with ``ValueError``; raises
    :class:`FrameCorruption` for frames that claim a readable version but
    fail their integrity checks (short buffer, CRC32 mismatch, broken
    header JSON)."""
    if len(buf) < _HEAD.size:
        raise FrameCorruption(f"truncated wire frame ({len(buf)} bytes)")
    magic, version, hlen = _HEAD.unpack_from(buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"not a wire frame (magic {magic!r})")
    if version not in _READABLE_VERSIONS:
        raise ValueError(
            f"wire protocol version {version} not in "
            f"{_READABLE_VERSIONS}; refusing to guess at the frame layout")
    off = _HEAD.size
    if len(buf) < off + hlen:
        raise FrameCorruption(
            f"truncated wire frame: header claims {hlen} bytes, "
            f"{len(buf) - off} present")
    try:
        header = json.loads(buf[off:off + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameCorruption(f"unparseable frame header: {e}") from e
    off += hlen
    body = buf[off:]
    need = sum(int(np.prod(shape, dtype=np.int64))
               * np.dtype(wire_dtype).itemsize
               for _, shape, _, wire_dtype in header["leaves"])
    if len(body) < need:
        raise FrameCorruption(
            f"truncated wire frame body: {len(body)}/{need} payload bytes")
    if version >= 2 and zlib.crc32(body[:need]) != header["crc"]:
        raise FrameCorruption(
            "frame payload CRC32 mismatch (corrupted in transit)")
    payload: Dict[str, torch.Tensor] = {}
    for name, shape, dtype, wire_dtype in header["leaves"]:
        count = int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(buf, dtype=np.dtype(wire_dtype), count=count,
                            offset=off).reshape(shape)
        # a copy: the frame's buffer is read-only
        payload[name] = decode_tensor(arr.copy(), dtype)
        off += count * np.dtype(wire_dtype).itemsize
    return WireMessage(tag=header["tag"], sender=header["sender"],
                       round=header["round"], meta=header["meta"],
                       payload=payload)


def frame(encoded: bytes) -> bytes:
    """Prefix an encoded message with its length (stream framing)."""
    return _LENGTH.pack(len(encoded)) + encoded


def unframe_length(prefix: bytes) -> int:
    return int(_LENGTH.unpack(prefix)[0])


# ------------------------------------------------------- pytree payloads --
# Client parameter trees (the ``params``/``collect`` control exchange) are
# string-keyed nested dicts; flatten them with the checkpoint plane's key
# convention so both sides agree without a schema.

_SEP = "::"


def flatten_tree(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """{"a::b": leaf} over a string-keyed nested dict, keys sorted."""
    if not isinstance(tree, dict):
        if not prefix:
            raise ValueError("wire payloads only carry string-keyed dict "
                             f"trees; got a bare {type(tree).__name__}")
        return {_SEP.join(prefix): tree}
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        if isinstance(tree[k], (list, tuple)):
            raise ValueError(
                "wire payloads only carry string-keyed dict trees; got a "
                f"sequence at {_SEP.join(prefix + (str(k),))!r}")
        out.update(flatten_tree(tree[k], prefix + (str(k),)))
    return out


def unflatten_tree(flat: Dict[str, Any]) -> dict:
    tree: dict = {}
    for key in sorted(flat):
        node = tree
        parts = tuple(key.split(_SEP))
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return tree
