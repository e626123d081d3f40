"""Reader of the JAX trainers' checkpoint files (Flax msgpack).

The JAX package's ``ExperimentLogger.save_checkpoint``
(``fer_vit_tpu/utils/experiment_logger.py``) writes ``last_model.pt`` and
``best_model.pt`` as one msgpack map ``{epoch, state, metrics, config,
run_id[, scheduler_state]}``: ``metrics``, ``config`` and
``scheduler_state`` are JSON strings and ``state`` is the msgpack bytes of
the TrainState's state dict (``params``, ``batch_stats``, ``opt_state``).
Flax packs arrays as msgpack extension 1, whose data is itself msgpack of
``[shape, dtype name, C-order bytes]``, numpy scalars as extension 3 and
complex numbers as extension 2; arrays over ``2**30`` bytes are split into
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
maps with the tuples written as ``{"0": ..., "1": ...}``.

This module decodes that subset of msgpack by hand (the ``msgpack`` package
is not needed): maps, arrays, str, bin, ints, floats, bool, nil and the
three extensions. Arrays come back as read-only numpy arrays, except
``bfloat16`` ones, which numpy cannot hold: those are read as uint16 and
returned as ``torch.bfloat16`` tensors.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"truncated msgpack: {n} bytes wanted at "
                             f"{self.pos} of {len(self.data)}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _LENGTH:  # bin, ext, str, array, map with a length field
            kind, fmt = _LENGTH[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(1 << (b - 0xD4))))
        raise ValueError(f"msgpack type byte {b:#04x} at {self.pos - 1} is "
                         "not used by Flax checkpoints")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


_LENGTH = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
           0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
           0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
           0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
           0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _ndarray(data: bytes):
    shape, dtype, buf = unpackb(data)
    name = dtype.decode() if isinstance(dtype, bytes) else dtype
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr.reshape(()) if torch.is_tensor(arr) else arr[()]
    if code == EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    raise ValueError(f"msgpack extension type {code} is not used by Flax "
                     "checkpoints")


def unpackb(data: bytes) -> Any:
    """One msgpack value from ``data`` (all of it)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the "
                         "msgpack value")
    return out


def _tuple(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    """Flax's chunked-array maps back into arrays, everywhere in ``tree``."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(int(s) for s in _tuple(tree["shape"]))
        chunks = _tuple(tree["chunks"])
        if torch.is_tensor(chunks[0]):
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate([np.ravel(c) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the tree in ``data``, with
    chunked arrays joined."""
    return _unchunk(unpackb(data))


def read_checkpoint(path: str) -> dict:
    """A JAX trainer's checkpoint file -> ``{"epoch", "metrics", "config",
    "run_id", "scheduler_state", "state"}``: the JSON fields parsed
    (``scheduler_state`` None when absent) and ``state`` the TrainState's
    nested dict (``params``, ``batch_stats``, ``opt_state``)."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    if not isinstance(payload, dict) or "state" not in payload:
        raise ValueError(f"{path} is not a Flax msgpack checkpoint")
    sched = payload.get("scheduler_state")
    return {
        "epoch": payload["epoch"],
        "metrics": json.loads(payload["metrics"]),
        "config": json.loads(payload["config"]),
        "run_id": payload["run_id"],
        "scheduler_state": None if sched is None else json.loads(sched),
        "state": msgpack_restore(payload["state"]),
    }
