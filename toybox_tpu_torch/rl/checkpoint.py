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
- ``params_from_flax`` maps the flax param tree of any eval head to the
  state_dict of the port's module, one mapping per template
  (``flax_template``: pi + V or Q over NatureCNN, SmallCNN, ConvOnly or
  MLP, deepq's dueling QNetwork, acktr's KfacCNNPolicy, and the LSTM
  trunks); it raises on a tree it does not know. ``params_to_flax`` is
  its inverse on the ``params`` collection.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

__all__ = ["unpackb", "packb", "load_flax_tree", "save_flax_tree",
           "flax_template", "state_dict_template", "params_from_flax",
           "params_to_flax", "load_state_dict"]

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


#: trunk kind -> (number of convolutions, a Dense after them)
_CONV_TRUNKS = {"cnn": (3, True), "cnn_small": (2, True),
                "conv_only": (3, False)}
#: (base trunk, LayerNorm) -> recurrent network name
_RECURRENT = {("cnn", False): "cnn_lstm", ("cnn", True): "cnn_lnlstm",
              ("mlp", False): "lstm"}
_BASE = {net: base for (base, _), net in _RECURRENT.items()}
_IGNORED = ("kfac", "perturbations")        # the K-FAC learner's taps
_GATES = "ifgo"


def _params(tree: dict) -> dict:
    """The ``params`` collection of a variable dict (the K-FAC taps
    ignored by name; any other collection raises), or ``tree`` itself if
    it has none."""
    if "params" not in tree:
        return tree
    extra = set(tree) - {"params", *_IGNORED}
    if extra:
        raise ValueError(f"unknown collections {sorted(extra)} beside "
                         "params")
    return tree["params"]


def _trunk_kind(keys) -> str:
    keys = set(keys)
    for kind, (n, fc) in _CONV_TRUNKS.items():
        if keys == {f"Conv_{i}" for i in range(n)} | (
                {"Dense_0"} if fc else set()):
            return kind
    if keys and keys == {f"Dense_{i}" for i in range(len(keys))}:
        return "mlp"
    raise ValueError(f"unknown trunk with layers {sorted(keys)}")


def flax_template(tree: dict) -> str:
    """The template of a flax param tree, as "head:network":

    - ``pi_v:<trunk>``: PolicyWithValue, pi and V (or acer's Q) heads over
      cnn, cnn_small, conv_only or mlp, and the recurrent
      RecurrentPolicyWithValue / RecurrentQPolicy over cnn_lstm,
      cnn_lnlstm or lstm;
    - ``dueling_q:<trunk>``: deepq's dueling QNetwork;
    - ``kfac:cnn``: acktr's KfacCNNPolicy.

    Raises ValueError on any other tree."""
    p = _params(tree)
    keys = set(p)
    if keys == {"conv0", "conv1", "conv2", "fc0", "pi", "vf"}:
        return "kfac:cnn"
    heads = keys - {"trunk"}
    if "trunk" in keys and isinstance(p["trunk"], dict):
        t = p["trunk"]
        if "OptimizedLSTMCell_0" in t:
            rest = set(t) - {"OptimizedLSTMCell_0", "base", "LayerNorm_0"}
            net = _RECURRENT.get((_trunk_kind(t.get("base", {})),
                                  "LayerNorm_0" in t))
            if net is not None and not rest and heads == {"Dense_0",
                                                          "Dense_1"}:
                return "pi_v:" + net
        elif heads == {"Dense_0", "Dense_1"}:
            return "pi_v:" + _trunk_kind(t)
        elif heads == {f"Dense_{i}" for i in range(4)}:
            return "dueling_q:" + _trunk_kind(t)
    raise ValueError(f"unknown param tree with top-level keys {sorted(keys)}")


def state_dict_template(state_dict: dict) -> str:
    """The template ("head:network", see ``flax_template``) of a port
    module's state_dict."""
    keys = set(state_dict)
    if "fc0.inner.weight" in keys:
        return "kfac:cnn"
    head = "dueling_q" if "adv_hidden.weight" in keys else "pi_v"
    recurrent = "trunk.cell.ih.weight" in keys
    pre = "trunk.base." if recurrent else "trunk."
    if f"{pre}layers.0.weight" in keys:
        base = "mlp"
    elif f"{pre}conv2.weight" in keys:
        base = "cnn" if f"{pre}fc.weight" in keys else "conv_only"
    elif f"{pre}conv1.weight" in keys:
        base = "cnn_small"
    else:
        raise ValueError(f"unknown state_dict with keys {sorted(keys)}")
    if not recurrent:
        return f"{head}:{base}"
    net = _RECURRENT.get((base, "trunk.norm.weight" in keys))
    if net is None:
        raise ValueError(f"unknown recurrent state_dict over {base}")
    return f"{head}:{net}"


def _layers(template: str, n_mlp: int) -> list:
    """[(flax path, state_dict prefix, kind)] of a template, trunk first;
    kind is conv, dense, dense_chw (a Dense reading a flattened conv map:
    its rows reordered), layer_norm or lstm."""
    head, net = template.split(":")
    if head == "kfac":
        return [((f"conv{i}", "inner"), f"conv{i}.inner", "conv")
                for i in range(3)] + [
            (("fc0", "inner"), "fc0.inner", "dense_chw"),
            (("pi", "inner"), "pi.inner", "dense"),
            (("vf", "inner"), "vf.inner", "dense")]
    base = _BASE.get(net, net)
    fp, sp = ((("trunk", "base"), "trunk.base.") if net in _BASE
              else (("trunk",), "trunk."))
    if base == "mlp":
        out = [(fp + (f"Dense_{i}",), f"{sp}layers.{i}", "dense")
               for i in range(n_mlp)]
    else:
        n, fc = _CONV_TRUNKS[base]
        out = [(fp + (f"Conv_{i}",), f"{sp}conv{i}", "conv")
               for i in range(n)]
        if fc:
            out.append((fp + ("Dense_0",), f"{sp}fc", "dense_chw"))
    if net == "cnn_lnlstm":
        out.append((("trunk", "LayerNorm_0"), "trunk.norm", "layer_norm"))
    if net in _BASE:
        out.append((("trunk", "OptimizedLSTMCell_0"), "trunk.cell", "lstm"))
    first = "dense_chw" if base == "conv_only" else "dense"
    names = ((("pi", first), ("vf", first)) if head == "pi_v" else
             (("adv_hidden", first), ("adv_out", "dense"),
              ("val_hidden", first), ("val_out", "dense")))
    return out + [((f"Dense_{i}",), name, kind)
                  for i, (name, kind) in enumerate(names)]


def _side(rows: int, c: int) -> int:
    side = int(round((rows // c) ** 0.5))
    if side * side * c != rows:
        raise ValueError(f"a Dense input of {rows} is not a square map of "
                         f"{c} channels")
    return side


def _hwc_to_chw(kernel: np.ndarray, c: int) -> np.ndarray:
    """Rows of a [h*w*c, out] kernel (flax's NHWC flatten) -> (c, h, w)."""
    s = _side(kernel.shape[0], c)
    return kernel.reshape(s, s, c, -1).transpose(2, 0, 1, 3).reshape(
        kernel.shape)


def _chw_to_hwc(kernel: np.ndarray, c: int) -> np.ndarray:
    s = _side(kernel.shape[0], c)
    return kernel.reshape(c, s, s, -1).transpose(1, 2, 0, 3).reshape(
        kernel.shape)


def _leaf(d, keys: set, where) -> dict:
    if not isinstance(d, dict) or set(d) != keys:
        raise ValueError(f"{'/'.join(where)}: want {sorted(keys)}, have "
                         f"{sorted(d) if isinstance(d, dict) else d!r}")
    return d


def _get(p: dict, path: tuple):
    for k in path:
        p = p[k]
    return p


def params_from_flax(tree: dict) -> dict:
    """flax param tree (a variable dict or its ``params``) of any eval head
    (``flax_template``) -> the state_dict of the port's module, f32.

    Conv kernels go HWIO -> OIHW; Dense kernels [in, out] -> [out, in];
    the Dense layers that read a flattened conv map (NatureCNN's and
    SmallCNN's trunk Dense, acktr's fc0, and the heads over ConvOnly) read
    it as (h, w, c) in flax and (c, h, w) here, so their input rows are
    reordered; the LSTM cell's per-gate kernels are concatenated in the
    order i, f, g, o (``rl.models.LSTMCell``)."""
    template = flax_template(tree)
    p = _params(tree)
    head, net = template.split(":")
    n_mlp = 0
    if head != "kfac" and _BASE.get(net, net) == "mlp":
        n_mlp = len(_get(p, ("trunk", "base") if net in _BASE
                         else ("trunk",)))
    sd, c = {}, None
    for path, name, kind in _layers(template, n_mlp):
        d = _get(p, path)
        if kind == "lstm":
            _leaf(d, {f"{s}{g}" for s in "ih" for g in _GATES}, path)
            for g in _GATES:
                _leaf(d[f"i{g}"], {"kernel"}, path + (f"i{g}",))
                _leaf(d[f"h{g}"], {"kernel", "bias"}, path + (f"h{g}",))
            sd[f"{name}.ih.weight"] = np.concatenate(
                [d[f"i{g}"]["kernel"] for g in _GATES], 1).T
            sd[f"{name}.hh.weight"] = np.concatenate(
                [d[f"h{g}"]["kernel"] for g in _GATES], 1).T
            sd[f"{name}.hh.bias"] = np.concatenate(
                [d[f"h{g}"]["bias"] for g in _GATES])
            continue
        if kind == "layer_norm":
            _leaf(d, {"scale", "bias"}, path)
            sd[f"{name}.weight"], sd[f"{name}.bias"] = d["scale"], d["bias"]
            continue
        _leaf(d, {"kernel", "bias"}, path)
        k = d["kernel"]
        if kind == "conv":
            k = np.transpose(k, (3, 2, 0, 1))
            c = k.shape[0]
        elif kind == "dense_chw":
            k = _hwc_to_chw(k, c).T
        else:
            k = k.T
        sd[f"{name}.weight"], sd[f"{name}.bias"] = k, d["bias"]
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in sd.items()}


def params_to_flax(state_dict: dict, template: str | None = None) -> dict:
    """Port module state_dict -> the flax param tree ``{"params": ...}`` of
    the same head (the inverse of ``params_from_flax``; the K-FAC taps are
    not written), as numpy f32 arrays. ``template`` (as
    ``flax_template`` names it), when given, must be the state_dict's."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32)
          for k, v in state_dict.items()}
    found = state_dict_template(sd)
    if template is not None and template != found:
        raise ValueError(f"the state_dict is a {found!r} head, not "
                         f"{template!r}")
    pre = "trunk.base." if found.split(":")[1] in _BASE else "trunk."
    n_mlp = sum(1 for k in sd
                if k.startswith(f"{pre}layers.") and k.endswith(".weight"))
    p, used, c = {}, set(), None

    def put(path, value):
        d = p
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = np.ascontiguousarray(value)

    for path, name, kind in _layers(found, n_mlp):
        if kind == "lstm":
            names = [f"{name}.ih.weight", f"{name}.hh.weight",
                     f"{name}.hh.bias"]
            used.update(names)
            ih, hh, hb = (np.split(sd[k].T if k.endswith("weight")
                                   else sd[k], 4, axis=-1) for k in names)
            for g, a, b, bias in zip(_GATES, ih, hh, hb):
                put(path + (f"i{g}", "kernel"), a)
                put(path + (f"h{g}", "kernel"), b)
                put(path + (f"h{g}", "bias"), bias)
            continue
        w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
        used.update((f"{name}.weight", f"{name}.bias"))
        if kind == "layer_norm":
            put(path + ("scale",), w)
        elif kind == "conv":
            put(path + ("kernel",), np.transpose(w, (2, 3, 1, 0)))
            c = w.shape[0]
        elif kind == "dense_chw":
            put(path + ("kernel",), _chw_to_hwc(w.T, c))
        else:
            put(path + ("kernel",), w.T)
        put(path + ("bias",), b)
    if used != set(sd):
        raise ValueError(f"state_dict entries not in the {found!r} "
                         f"template: {sorted(set(sd) - used)}")
    return {"params": p}


def load_state_dict(path) -> dict:
    """state_dict of the port's eval head for a flax checkpoint (any
    template ``flax_template`` knows); load it with ``strict=True``."""
    return params_from_flax(load_flax_tree(path))
