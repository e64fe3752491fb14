"""A minimal HDF5 writer in numpy, for Keras-layout archives.

It writes the subset of HDF5 that ``deeplearning4j_tpu_torch.modelimport.
hdf5`` reads, as h5py writes it with ``libver='earliest'``: superblock
version 0, version 1 object headers, symbol-table groups (a one-node group
B-tree over one ``SNOD`` symbol node, the names in a local heap; the
superblock's group leaf K is raised to fit the largest group), attributes
(version 1 messages) of fixed-length strings, integers and floats, scalars or
arrays, and contiguous datasets of integers and floats. h5py reads what it
writes. It needs numpy alone, so archives can be made where h5py is not
installed (``chip_smoke.py`` loads it by path).

    import numpy as np
    from torch_write_keras_h5 import Group, write_h5
    write_h5("a.h5", Group({"g": Group({"x": np.ones(3, np.float32)},
                                       attrs={"note": "hi"})}))

:func:`keras_model_archive` lays out a Keras 1 full-model save
(``model_config``, ``training_config``, ``model_weights`` with
``layer_names`` and each layer's ``weight_names``) and
:func:`keras_weights_archive` a weights-only save (layers at the root,
``param_0``, ``param_1``, ...).
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = b"\xff" * 8
SUPERBLOCK = 96  # version 0 with 8-byte offsets and lengths
INTERNAL_K = 16  # the group B-tree's K (HDF5's default)


class Group(dict):
    """An HDF5 group: member name -> :class:`Group` or numpy array (a
    dataset), and ``attrs`` (name -> str, bytes, number or array)."""

    def __init__(self, members=(), attrs=None):
        super().__init__(members)
        self.attrs = dict(attrs or {})


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _datatype(dt: np.dtype) -> bytes:
    """A datatype message (version 1) for a numpy dtype."""
    if dt.kind == "S":
        return struct.pack("<B3sI", 0x13, bytes([0x01, 0, 0]), max(dt.itemsize, 1))
    order = 1 if dt.byteorder == ">" else 0
    if dt.kind in "iu":
        bits = order | (0x08 if dt.kind == "i" else 0)
        return struct.pack("<B3sIHH", 0x10, bytes([bits, 0, 0]), dt.itemsize, 0,
                           8 * dt.itemsize)
    if dt.kind == "f":
        sign, exp_at, exp_bits, man_bits, bias = {
            2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127),
            8: (63, 52, 11, 52, 1023)}[dt.itemsize]
        return struct.pack("<B3sIHHBBBBI", 0x11, bytes([order | 0x20, sign, 0]),
                           dt.itemsize, 0, 8 * dt.itemsize, exp_at, exp_bits, 0,
                           man_bits, bias)
    raise TypeError(f"no HDF5 datatype for {dt} here")


def _dataspace(shape: Tuple[int, ...]) -> bytes:
    """A dataspace message (version 1; rank 0 is a scalar)."""
    return struct.pack("<BBBB4x", 1, len(shape), 0, 0) + b"".join(
        struct.pack("<Q", d) for d in shape)


def _as_array(value) -> np.ndarray:
    """An attribute value as the array h5py would store: text as
    fixed-length UTF-8 bytes."""
    if isinstance(value, str):
        value = value.encode("utf-8")
    if isinstance(value, (list, tuple)) and value and isinstance(value[0], (str, bytes)):
        value = [v.encode("utf-8") if isinstance(v, str) else v for v in value]
        value = np.array(value, dtype=f"S{max(1, max(len(v) for v in value))}")
    return np.asarray(value)


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _attribute(name: str, value) -> bytes:
    arr = _as_array(value)
    dt = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype
    arr = np.asarray(arr, dtype=dt)
    name_b = name.encode("utf-8") + b"\0"
    dtype_b, space_b = _datatype(dt), _dataspace(arr.shape)
    body = (struct.pack("<BBHHH", 1, 0, len(name_b), len(dtype_b), len(space_b))
            + _pad8(name_b) + _pad8(dtype_b) + _pad8(space_b) + arr.tobytes())
    if len(body) > 0xFFFF:
        raise ValueError(f"attribute '{name}' is {len(body)} bytes: over a header "
                         "message's 64 KiB")
    return _message(0x000C, body)


def _header(messages: List[bytes]) -> bytes:
    """A version 1 object header holding ``messages``."""
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _Writer:
    def __init__(self, f, leaf_k: int):
        self.f, self.leaf_k = f, leaf_k

    def tell(self) -> int:
        return self.f.tell()

    def put(self, data: bytes) -> int:
        """Append ``data`` 8-byte aligned; its address."""
        addr = self.tell()
        self.f.write(_pad8(data))
        return addr

    def dataset(self, arr: np.ndarray) -> int:
        arr = np.asarray(arr)
        if arr.dtype.kind not in "iuf":
            raise TypeError(f"dataset of {arr.dtype}: numbers only here")
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        if not arr.flags.c_contiguous:
            arr = arr.copy()
        if arr.nbytes:
            data_addr = self.tell()
            arr.reshape(-1).view(np.uint8).tofile(self.f)
            self.f.write(b"\0" * (-arr.nbytes % 8))
            where = struct.pack("<Q", data_addr)
        else:
            where = UNDEF
        layout = struct.pack("<BB", 3, 1) + where + struct.pack("<Q", arr.nbytes)
        return self.put(_header([_message(0x0001, _dataspace(arr.shape)),
                                 _message(0x0003, _datatype(arr.dtype), flags=1),
                                 _message(0x0008, layout)]))

    def group(self, g: Group) -> Tuple[int, int, int]:
        """(header, B-tree, local heap) addresses of ``g``, its members
        written first."""
        children = {}
        for name in sorted(g, key=lambda n: n.encode("utf-8")):
            m = g[name]
            children[name] = self.group(m)[0] if isinstance(m, Group) else self.dataset(m)
        heap, offsets = bytearray(8), {}  # offset 0: the empty name
        for name in children:
            offsets[name] = len(heap)
            heap += _pad8(name.encode("utf-8") + b"\0")
        heap_data = self.put(bytes(heap))
        heap_addr = self.put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_data))
        if len(children) > 2 * self.leaf_k:
            raise ValueError("group larger than the superblock's leaf K allows")
        entries = b"".join(struct.pack("<QQII16x", offsets[n], addr, 0, 0)
                           for n, addr in children.items())
        entries += b"\0" * (40 * (2 * self.leaf_k - len(children)))
        keys_children = struct.pack("<Q", 0)
        if children:
            snod = self.put(b"SNOD" + struct.pack("<BBH", 1, 0, len(children)) + entries)
            keys_children += struct.pack("<QQ", snod, offsets[list(children)[-1]])
        node = (b"TREE" + struct.pack("<BBH", 0, 0, 1 if children else 0) + UNDEF + UNDEF
                + keys_children)
        node += b"\0" * (8 + 16 + 8 * (2 * INTERNAL_K + 1) + 8 * 2 * INTERNAL_K - len(node))
        btree = self.put(node)
        msgs = [_message(0x0011, struct.pack("<QQ", btree, heap_addr))]
        msgs += [_attribute(k, v) for k, v in g.attrs.items()]
        return self.put(_header(msgs)), btree, heap_addr


def _largest_group(g: Group) -> int:
    return max([len(g)] + [_largest_group(m) for m in g.values() if isinstance(m, Group)])


def write_h5(path: str, root: Group) -> int:
    """Write ``root`` as an HDF5 file at ``path``; the file's size."""
    leaf_k = max(4, -(-_largest_group(root) // 2))
    with open(path, "wb") as f:
        f.write(b"\0" * SUPERBLOCK)
        w = _Writer(f, leaf_k)
        header, btree, heap = w.group(root)
        eof = f.tell()
        f.seek(0)
        f.write(SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                + struct.pack("<HHI", leaf_k, INTERNAL_K, 0)
                + struct.pack("<Q", 0) + UNDEF + struct.pack("<Q", eof) + UNDEF
                + struct.pack("<QQII", 0, header, 1, 0) + struct.pack("<QQ", btree, heap))
    return eof


def keras_model_archive(model_config: dict, training_config,
                        layer_weights: Dict[str, Sequence[Tuple[str, np.ndarray]]],
                        keras_version: str = "1.2.2") -> Group:
    """A Keras 1 full-model save: ``layer_weights`` maps each layer name,
    in the model's order, to its (weight name, array) pairs."""
    attrs = {"keras_version": keras_version, "backend": "theano",
             "model_config": json.dumps(model_config)}
    if training_config is not None:
        attrs["training_config"] = json.dumps(training_config)
    weights = Group({ln: _nested(ws, attrs={"weight_names": np.array(
                         [wn.encode() for wn, _ in ws], dtype="S64")})
                     for ln, ws in layer_weights.items()},
                    attrs={"layer_names": np.array([n.encode() for n in layer_weights],
                                                   dtype="S64")})
    return Group({"model_weights": weights}, attrs=attrs)


def _nested(pairs, attrs) -> Group:
    """A group holding each (path, array), a path's '/'s as subgroups (the
    Keras 2 names "layer/kernel:0")."""
    g = Group(attrs=attrs)
    for path, arr in pairs:
        *parents, leaf = path.split("/")
        node = g
        for p in parents:
            node = node.setdefault(p, Group())
        node[leaf] = arr
    return g


def keras_weights_archive(layers: Sequence[Sequence[np.ndarray]]) -> Group:
    """A weights-only save in the canonical layout of the published VGG16
    archive: groups ``layer_0``, ``layer_1``, ... (a group for every layer,
    empty where the layer has no weights), each with ``nb_params`` and its
    arrays as ``param_0``, ``param_1``, ...; the root lists them in order in
    ``layer_names`` beside ``nb_layers``."""
    names = [f"layer_{i}" for i in range(len(layers))]
    return Group({n: Group({f"param_{j}": a for j, a in enumerate(arrs)},
                           attrs={"nb_params": np.int64(len(arrs))})
                  for n, arrs in zip(names, layers)},
                 attrs={"nb_layers": np.int64(len(layers)),
                        "layer_names": np.array([n.encode() for n in names], dtype="S64")})
