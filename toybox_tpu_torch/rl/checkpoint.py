"""Read flax msgpack checkpoints (``flax.serialization.to_bytes``) without
flax or msgpack, and carry their weights into the port's modules.

- ``unpackb`` decodes the msgpack subset flax writes: maps, arrays, str,
  bin, ints, floats, bool, nil, and the ext types flax uses for arrays
  (1: ndarray, 3: numpy scalar, each a msgpack [shape, dtype name, raw
  bytes]) and complex scalars (2).
- ``params_from_flax`` maps a flax ``PolicyWithValue(NatureCNN)`` param
  tree to the state_dict of ``rl.policies.PolicyWithValue``.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

__all__ = ["unpackb", "load_flax_tree", "params_from_flax",
           "load_state_dict"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ext(code: int, payload: bytes):
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype_name, buf = unpackb(payload)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr.copy() if code == _EXT_NDARRAY else arr[()]
    if code == _EXT_COMPLEX:
        re, im = unpackb(payload)
        return complex(re, im)
    raise ValueError(f"unsupported msgpack ext type {code}")


def _decode(r: _Reader):
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(r, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    sized = {
        0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
        0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
        0xDC: (">H", "array"), 0xDD: (">I", "array"),
        0xDE: (">H", "map"), 0xDF: (">I", "map"),
        0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    }
    if b in sized:
        fmt, kind = sized[b]
        n = r.unpack(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return bytes(r.take(n)).decode("utf-8")
        if kind == "array":
            return _array(r, n)
        if kind == "map":
            return _map(r, n)
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(fixext[b])))
    scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
               0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in scalars:
        return r.unpack(scalars[b])
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _array(r: _Reader, n: int) -> list:
    return [_decode(r) for _ in range(n)]


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    return out


def unpackb(data: bytes):
    """Decode one msgpack object (flax's subset) from ``data``."""
    r = _Reader(data)
    obj = _decode(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after msgpack "
                         "object")
    return obj


def load_flax_tree(path) -> dict:
    """The nested dict of numpy arrays saved by flax ``to_bytes``."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def params_from_flax(tree: dict) -> dict:
    """flax PolicyWithValue(NatureCNN) params -> port state_dict.

    Conv kernels go HWIO -> OIHW; Dense kernels [in, out] -> [out, in].
    The first Dense of the trunk reads the NHWC-flattened (h, w, c) conv
    output in flax and the NCHW-flattened (c, h, w) one here, so its input
    rows are reordered."""
    p = tree.get("params", tree)
    trunk = p["trunk"]
    sd = {}
    for i in range(3):
        conv = trunk[f"Conv_{i}"]
        sd[f"trunk.conv{i}.weight"] = np.transpose(conv["kernel"],
                                                   (3, 2, 0, 1))
        sd[f"trunk.conv{i}.bias"] = conv["bias"]
    fc = trunk["Dense_0"]["kernel"]                  # [h*w*c, 512]
    c = trunk["Conv_2"]["kernel"].shape[-1]
    hw = fc.shape[0] // c
    side = int(round(hw ** 0.5))
    if side * side * c != fc.shape[0]:
        raise ValueError(f"trunk Dense_0 input {fc.shape[0]} is not a square "
                         f"map of {c} channels")
    fc = fc.reshape(side, side, c, -1).transpose(2, 0, 1, 3)
    sd["trunk.fc.weight"] = fc.reshape(side * side * c, -1).T
    sd["trunk.fc.bias"] = trunk["Dense_0"]["bias"]
    for name, key in (("pi", "Dense_0"), ("vf", "Dense_1")):
        sd[f"{name}.weight"] = p[key]["kernel"].T
        sd[f"{name}.bias"] = p[key]["bias"]
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


def load_state_dict(path) -> dict:
    """state_dict of ``rl.policies.PolicyWithValue`` from a flax checkpoint."""
    return params_from_flax(load_flax_tree(path))
