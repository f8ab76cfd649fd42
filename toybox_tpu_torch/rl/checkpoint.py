"""Read and write flax msgpack checkpoints (``flax.serialization.to_bytes``)
without flax or msgpack, and carry their weights into and out of the
port's modules.

- ``unpackb`` decodes the msgpack subset flax writes: maps, arrays, str,
  bin, ints, floats, bool, nil, and the ext types flax uses for arrays
  (1: ndarray, 3: numpy scalar, each a msgpack [shape, dtype name, raw
  bytes]) and complex scalars (2).
- ``packb`` encodes the part of that subset a param tree needs (maps with
  str keys, sorted as a jax pytree orders them, and ndarrays as ext 1), so
  a policy's bytes equal what the JAX ``ppo.save_params`` writes for the
  same trained params (the models in models/ are written so), and the JAX
  ``ppo.load_params`` reads a model the port trained.
- ``params_from_flax`` maps a flax ``PolicyWithValue`` param tree over a
  ``NatureCNN`` or ``MLP`` trunk to the state_dict of
  ``rl.policies.PolicyWithValue``; ``params_to_flax`` is its inverse.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

__all__ = ["unpackb", "packb", "load_flax_tree", "save_flax_tree",
           "params_from_flax", "params_to_flax", "load_state_dict"]

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


def _sized(out: bytearray, n: int, small, codes) -> None:
    """A length header (or an unsigned int): ``small[0] | n`` when n <
    small[1], else the first of ``codes`` (8-, 16-, 32-bit) that fits."""
    if small is not None and n < small[1]:
        out.append(small[0] | n)
        return
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _encode(obj, out: bytearray) -> None:
    if isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        if obj < 0x80:
            out.append(obj)
        else:
            _sized(out, obj, None, (0xCC, 0xCD, 0xCE))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(out, len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, bytes):
        _sized(out, len(obj), None, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        payload = packb([list(a.shape), a.dtype.name, a.tobytes("C")])
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixext:
            out.append(fixext[len(payload)])
        else:
            _sized(out, len(payload), None, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY)
        out += payload
    elif isinstance(obj, list):
        _sized(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD))
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, dict):
        _sized(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF))
        for k in sorted(obj):
            _encode(k, out)
            _encode(obj[k], out)
    else:
        raise TypeError(f"cannot encode {obj!r} as a param tree's msgpack")


def packb(obj) -> bytes:
    """Encode a param tree as msgpack: dicts (str keys, written in sorted
    order) of numpy arrays (flax's ext 1: [shape, dtype name, raw bytes]),
    and the lists, str, bytes and non-negative ints those hold."""
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def load_flax_tree(path) -> dict:
    """The nested dict of numpy arrays saved by flax ``to_bytes``."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def save_flax_tree(path, tree: dict) -> None:
    """Write ``tree`` as flax ``to_bytes`` does."""
    with open(path, "wb") as f:
        f.write(packb(tree))


def _dense_from_flax(d: dict, name: str, sd: dict) -> None:
    sd[f"{name}.weight"] = d["kernel"].T
    sd[f"{name}.bias"] = d["bias"]


def params_from_flax(tree: dict) -> dict:
    """flax PolicyWithValue(NatureCNN or MLP) params -> port state_dict.

    Conv kernels go HWIO -> OIHW; Dense kernels [in, out] -> [out, in].
    The first Dense of the NatureCNN trunk reads the NHWC-flattened
    (h, w, c) conv output in flax and the NCHW-flattened (c, h, w) one
    here, so its input rows are reordered."""
    p = tree.get("params", tree)
    trunk = p["trunk"]
    sd = {}
    if "Conv_0" not in trunk:                        # MLP
        for i in range(len(trunk)):
            _dense_from_flax(trunk[f"Dense_{i}"], f"trunk.layers.{i}", sd)
        for name, key in (("pi", "Dense_0"), ("vf", "Dense_1")):
            _dense_from_flax(p[key], name, sd)
        return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
                for k, v in sd.items()}
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
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in sd.items()}


def params_to_flax(state_dict: dict) -> dict:
    """Port PolicyWithValue state_dict -> the flax param tree
    ``{"params": ...}`` of the same policy (the inverse of
    ``params_from_flax``), as numpy f32 arrays."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32)
          for k, v in state_dict.items()}
    trunk = {}
    if "trunk.conv0.weight" in sd:
        for i in range(3):
            trunk[f"Conv_{i}"] = {
                "kernel": np.transpose(sd[f"trunk.conv{i}.weight"],
                                       (2, 3, 1, 0)),
                "bias": sd[f"trunk.conv{i}.bias"]}
        fc = sd["trunk.fc.weight"].T                     # [c*h*w, 512]
        c = sd["trunk.conv2.weight"].shape[0]
        side = int(round((fc.shape[0] // c) ** 0.5))
        fc = fc.reshape(c, side, side, -1).transpose(1, 2, 0, 3)
        trunk["Dense_0"] = {"kernel": fc.reshape(side * side * c, -1),
                            "bias": sd["trunk.fc.bias"]}
    else:
        i = 0
        while f"trunk.layers.{i}.weight" in sd:
            trunk[f"Dense_{i}"] = {"kernel": sd[f"trunk.layers.{i}.weight"].T,
                                   "bias": sd[f"trunk.layers.{i}.bias"]}
            i += 1
    p = {"trunk": trunk}
    for name, key in (("pi", "Dense_0"), ("vf", "Dense_1")):
        p[key] = {"kernel": sd[f"{name}.weight"].T, "bias": sd[f"{name}.bias"]}

    def contiguous(d):
        return {k: contiguous(v) if isinstance(v, dict)
                else np.ascontiguousarray(v) for k, v in d.items()}

    return {"params": contiguous(p)}


def load_state_dict(path) -> dict:
    """state_dict of ``rl.policies.PolicyWithValue`` from a flax checkpoint."""
    return params_from_flax(load_flax_tree(path))
