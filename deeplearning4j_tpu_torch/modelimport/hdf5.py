"""HDF5 archive access (counterpart of ``deeplearning4j_tpu/modelimport/
hdf5.py``; reference: modelimport/.../Hdf5Archive.java).

The JAX package reads archives through h5py. The port reads the file itself,
with numpy and ``struct``, so that an import runs wherever the port runs,
h5py or not. It reads the layout h5py writes by default (``libver=
'earliest'``), which Keras archives have:

- superblock version 0 or 1, at the start of the file or after a user block;
- version 1 object headers, with their continuation blocks;
- symbol-table groups: a version 1 B-tree of group nodes over ``SNOD``
  symbol nodes, the names in the group's local heap;
- attributes (messages of versions 1-3) holding fixed-length strings,
  variable-length strings (kept in global heap collections, ``GCOL``),
  integers or floats, each a scalar or an array;
- contiguous and compact datasets of those types; a dataset whose storage
  was never allocated reads as its fill value (zeros if it has none).

Anything else raises ``OSError`` naming what is not supported: superblock
versions 2 and 3 (``libver='latest'``), version 2 object headers, chunked or
filtered datasets, shared messages, dense attribute storage, link-message
groups, soft and external links, and other datatype classes.

:class:`File` is the reader (its groups and datasets answer as h5py's do:
``attrs``, ``keys()``, ``[name]``, ``shape``, ``dtype``, ``read()``);
:class:`Hdf5Archive`, :func:`read_layer_weights`, :func:`read_model_config`
and :func:`read_training_config` keep the JAX module's surface over it.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Optional

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# header message types (HDF5 file format specification, section IV.A.2)
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT, _FILTERS, _ATTRIBUTE = 0x6, 0x7, 0x8, 0xB, 0xC
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x10, 0x11, 0x15

_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
                8: "enum", 10: "array"}


def _unsupported(what: str) -> OSError:
    return OSError(f"HDF5: {what} is not supported (the reader takes what h5py "
                   "writes with libver='earliest': contiguous or compact datasets "
                   "in symbol-table groups)")


class _VlenString:
    """A variable-length string type: 16 bytes an element (length, global
    heap collection address, object index)."""

    itemsize = 16

    def __init__(self, utf8: bool):
        self.encoding = "utf-8" if utf8 else "ascii"


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class File:
    """An HDF5 file opened for reading; the root group."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._size = self._f.seek(0, 2)
        self._heaps: Dict[int, Dict[int, bytes]] = {}
        try:
            self._superblock()
            self._root = Group(self, self._messages(self._root_addr), "/")
        except Exception:
            self._f.close()
            raise

    # -- lifecycle -----------------------------------------------------
    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the root group's surface ---------------------------------------
    @property
    def attrs(self) -> Dict[str, Any]:
        return self._root.attrs

    def keys(self) -> List[str]:
        return self._root.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._root

    def __getitem__(self, name: str):
        return self._root[name]

    # -- low level ------------------------------------------------------
    def _read(self, addr: int, n: int) -> bytes:
        if addr + n > self._size:
            raise OSError(f"HDF5: read of {n} bytes at {addr} past the end of the file "
                          f"({self._size} bytes): truncated or corrupt")
        self._f.seek(addr)
        return self._f.read(n)

    def _uint(self, b: bytes, p: int, n: int) -> int:
        return int.from_bytes(b[p:p + n], "little")

    def _addr(self, b: bytes, p: int) -> Optional[int]:
        """An address field (size of offsets) at ``p``: absolute, or None
        where it is undefined (all bits set)."""
        v = self._uint(b, p, self._o)
        return None if v == (1 << (8 * self._o)) - 1 else v + self._base

    def _superblock(self) -> None:
        base = 0
        while True:
            if base + 8 > self._size:
                raise OSError("HDF5: no superblock signature: not an HDF5 file")
            if self._read(base, 8) == SIGNATURE:
                break
            base = 512 if base == 0 else 2 * base
        b = self._read(base, 8 + 16 + 4)
        version = b[8]
        if version not in (0, 1):
            raise _unsupported(f"superblock version {version} (libver='latest' or "
                               "a later low bound writes it)")
        self._o, self._l = b[13], b[14]
        if self._o not in (2, 4, 8) or self._l not in (2, 4, 8):
            raise OSError(f"HDF5: sizes of offsets {self._o} and lengths {self._l}")
        p = 24 + (4 if version == 1 else 0)
        o = self._o
        b = self._read(base + p, 4 * o + 2 * o + 24)
        self._base = self._uint(b, 0, o)  # addresses are relative to it
        # the root group's symbol table entry: its object header address
        self._root_addr = self._uint(b, 4 * o + o, o) + self._base

    def _messages(self, addr: int) -> List[tuple]:
        """(type, flags, body) of every message of the object header at
        ``addr``, continuation blocks followed."""
        head = self._read(addr, 16)
        if head[:4] == b"OHDR":
            raise _unsupported("a version 2 object header")
        if head[0] != 1:
            raise OSError(f"HDF5: object header version {head[0]} at {addr}")
        blocks = [(addr + 16, self._uint(head, 8, 4))]
        out = []
        while blocks:
            start, length = blocks.pop(0)
            data = self._read(start, length)
            p = 0
            while p + 8 <= length:
                mtype, size, flags = struct.unpack_from("<HHB", data, p)
                body = data[p + 8:p + 8 + size]
                p += 8 + _pad8(size)
                if mtype == _CONTINUATION:
                    blocks.append((self._addr(body, 0), self._uint(body, self._o, self._l)))
                elif mtype != _NIL:
                    if flags & 0x02:
                        raise _unsupported("a shared header message")
                    out.append((mtype, body))
        return out

    def _datatype(self, b: bytes, p: int = 0):
        """(numpy dtype or _VlenString, bytes the message takes)."""
        cls, bits = b[p] & 0x0F, self._uint(b, p + 1, 3)
        size = self._uint(b, p + 4, 4)
        order = ">" if bits & 1 else "<"
        if cls == 0:  # fixed-point
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}"), 12
        if cls == 1:  # floating-point
            if size not in (2, 4, 8) or bits & 0x40:
                raise _unsupported(f"a {size}-byte or VAX-ordered float")
            return np.dtype(f"{order}f{size}"), 20
        if cls == 3:  # fixed-length string
            return np.dtype(f"S{size}"), 8
        if cls == 9:  # variable-length
            if bits & 0x0F != 1:
                raise _unsupported("a variable-length sequence (not a string)")
            _, used = self._datatype(b, p + 8)
            return _VlenString(((bits >> 8) & 0x0F) == 1), 8 + used
        raise _unsupported(f"datatype class {cls} ({_CLASS_NAMES.get(cls, 'unknown')})")

    def _dataspace(self, b: bytes):
        """The shape: () for a scalar, None for a null dataspace."""
        version, rank = b[0], b[1]
        if version == 1:
            p = 8
        elif version == 2:
            if b[3] == 2:
                return None
            p = 4
        else:
            raise OSError(f"HDF5: dataspace message version {version}")
        return tuple(self._uint(b, p + i * self._l, self._l) for i in range(rank))

    def _global_heap_object(self, addr: int, index: int) -> bytes:
        heap = self._heaps.get(addr)
        if heap is None:
            head = self._read(addr, 8 + self._l)
            if head[:4] != b"GCOL":
                raise OSError(f"HDF5: no global heap collection at {addr}")
            data = self._read(addr, self._uint(head, 8, self._l))
            heap, p = {}, 8 + self._l
            while p + 8 + self._l <= len(data):
                idx = self._uint(data, p, 2)
                if idx == 0:  # the collection's free space
                    break
                n = self._uint(data, p + 8, self._l)
                start = p + 8 + self._l
                heap[idx] = data[start:start + n]
                p = start + _pad8(n)
            self._heaps[addr] = heap
        return heap[index]

    def _values(self, dtype, shape, data: bytes, text: bool = True):
        """Elements of ``dtype`` in ``data`` as h5py returns them: a numpy
        scalar (``bytes_`` for a fixed string) for a scalar, else an array;
        variable strings as ``str`` (``text``: an attribute's) or ``bytes``
        (a dataset's), in an object array unless scalar."""
        if shape is None:
            return np.empty((0,), np.dtype(object) if isinstance(dtype, _VlenString) else dtype)
        n = int(np.prod(shape, dtype=np.int64))
        if isinstance(dtype, _VlenString):
            items = []
            for i in range(n):
                q = 16 * i
                length = self._uint(data, q, 4)
                coll = self._addr(data, q + 4)
                index = self._uint(data, q + 4 + self._o, 4)
                raw = b"" if coll is None else self._global_heap_object(coll, index)[:length]
                items.append(raw.decode(dtype.encoding) if text else raw)
            if shape == ():
                return items[0]
            arr = np.empty(n, dtype=object)
            arr[:] = items
            return arr.reshape(shape)
        arr = np.frombuffer(data, dtype, count=n).reshape(shape)
        return arr[()] if shape == () else arr.copy()

    def _attribute(self, b: bytes):
        version, flags = b[0], b[1]
        name_size, type_size, space_size = struct.unpack_from("<HHH", b, 2)
        if version not in (1, 2, 3):
            raise OSError(f"HDF5: attribute message version {version}")
        if version > 1 and flags & 0x03:
            raise _unsupported("an attribute with a shared datatype or dataspace")
        pad = _pad8 if version == 1 else (lambda n: n)
        p = 9 if version == 3 else 8
        name = b[p:p + name_size].split(b"\0", 1)[0].decode("utf-8")
        p += pad(name_size)
        dtype, _ = self._datatype(b, p)
        p += pad(type_size)
        shape = self._dataspace(b[p:p + space_size])
        p += pad(space_size)
        return name, self._values(dtype, shape, b[p:])

    def _local_heap(self, addr: int) -> bytes:
        head = self._read(addr, 8 + 2 * self._l + self._o)
        if head[:4] != b"HEAP":
            raise OSError(f"HDF5: no local heap at {addr}")
        size = self._uint(head, 8, self._l)
        return self._read(self._addr(head, 8 + 2 * self._l), size)

    def _symbols(self, btree: int, heap_addr: int) -> Dict[str, Optional[int]]:
        """name -> object header address (None for a soft link) of a
        symbol-table group, in the B-tree's (name) order."""
        heap = self._local_heap(heap_addr)
        out: Dict[str, Optional[int]] = {}
        o, entry = self._o, 2 * self._o + 24

        def node(addr: int) -> None:
            head = self._read(addr, 8 + 2 * o)
            if head[:4] != b"TREE" or head[4] != 0:
                raise OSError(f"HDF5: no group B-tree node at {addr}")
            level, used = head[5], self._uint(head, 6, 2)
            body = self._read(addr + 8 + 2 * o, used * (self._l + o) + self._l)
            for i in range(used):
                child = self._addr(body, i * (self._l + o) + self._l)
                if level:
                    node(child)
                else:
                    leaf(child)

        def leaf(addr: int) -> None:
            head = self._read(addr, 8)
            if head[:4] != b"SNOD":
                raise OSError(f"HDF5: no symbol table node at {addr}")
            count = self._uint(head, 6, 2)
            body = self._read(addr + 8, count * entry)
            for i in range(count):
                q = i * entry
                off = self._uint(body, q, o)
                name = heap[off:heap.index(b"\0", off)].decode("utf-8")
                cache = self._uint(body, q + 2 * o, 4)
                out[name] = None if cache == 2 else self._addr(body, q + o)

        node(btree)
        return out


class _Object:
    """What groups and datasets share: the file, the header's messages
    and the attributes (name -> value, in name order)."""

    def __init__(self, file: File, msgs: List[tuple], name: str):
        self.file, self.name, self._msgs = file, name, msgs
        attrs: Dict[str, Any] = {}
        for mtype, body in self._msgs:
            if mtype == _ATTRIBUTE:
                key, value = file._attribute(body)
                attrs[key] = value
            elif mtype == _ATTRIBUTE_INFO:
                # flags, [max creation index], fractal heap address, ...
                p = 2 + (2 if body[1] & 0x01 else 0)
                if file._addr(body, p) is not None:
                    raise _unsupported("dense attribute storage (a fractal heap)")
        # in name order, as h5py lists them
        self.attrs = {k: attrs[k] for k in sorted(attrs, key=lambda k: k.encode("utf-8"))}

    def _message(self, mtype: int) -> Optional[bytes]:
        return next((body for t, body in self._msgs if t == mtype), None)


class Group(_Object):
    """A symbol-table group: ``keys()`` in name order, ``[name]`` (a path
    of names joined by '/' too), ``in``, ``attrs``."""

    def __init__(self, file: File, msgs: List[tuple], name: str):
        super().__init__(file, msgs, name)
        stab = self._message(_SYMBOL_TABLE)
        if stab is None:
            raise _unsupported("a group without a symbol table (link messages)")
        self._members = file._symbols(file._addr(stab, 0), file._addr(stab, file._o))
        self._cache: Dict[str, Any] = {}

    def keys(self) -> List[str]:
        return list(self._members)

    def __contains__(self, name: str) -> bool:
        try:
            self[name]
        except KeyError:
            return False
        return True

    def __getitem__(self, name: str):
        node = self
        for part in [p for p in name.split("/") if p]:
            if not isinstance(node, Group):
                raise KeyError(name)
            node = node._child(part)
        return node

    def _child(self, name: str):
        if name not in self._members:
            raise KeyError(f"'{name}' is not in group '{self.name}'")
        if name not in self._cache:
            addr = self._members[name]
            if addr is None:
                raise _unsupported(f"the soft link '{name}'")
            path = self.name.rstrip("/") + "/" + name
            msgs = self.file._messages(addr)
            kinds = {t for t, _ in msgs}
            self._cache[name] = (Group if kinds & {_SYMBOL_TABLE, _LINK_INFO, _LINK}
                                 else Dataset)(self.file, msgs, path)
        return self._cache[name]


class Dataset(_Object):
    """A dataset: ``shape`` (None for a null dataspace), ``dtype``,
    ``read()`` (a numpy array; a 0-d array for a scalar), ``attrs``."""

    def __init__(self, file: File, msgs: List[tuple], name: str):
        super().__init__(file, msgs, name)
        space, dtype = self._message(_DATASPACE), self._message(_DATATYPE)
        if space is None or dtype is None:
            raise OSError(f"HDF5: '{name}' is neither a group nor a dataset")
        self.shape = file._dataspace(space)
        self._type, _ = file._datatype(dtype)
        self.dtype = (np.dtype(object) if isinstance(self._type, _VlenString)
                      else self._type)

    def _fill(self) -> Optional[bytes]:
        """The fill value's bytes, or None where none is defined."""
        body = self._message(_FILL)
        if body is not None:
            version = body[0]
            if version in (1, 2):
                defined = body[3] if version == 2 else 1
                if defined:
                    n = self.file._uint(body, 4, 4)
                    return body[8:8 + n] if n else None
                return None
            if body[1] & 0x20:  # version 3: "fill value defined"
                n = self.file._uint(body, 2, 4)
                return body[6:6 + n]
            return None
        old = self._message(_FILL_OLD)
        if old is not None:
            n = self.file._uint(old, 0, 4)
            return old[4:4 + n] if n else None
        return None

    def read(self) -> np.ndarray:
        f = self.file
        if self._message(_FILTERS) is not None:
            raise _unsupported(f"the filtered (compressed or checksummed) dataset '{self.name}'")
        if self._message(_EXTERNAL) is not None:
            raise _unsupported(f"the dataset '{self.name}' in external files")
        if self.shape is None:
            return f._values(self._type, None, b"")
        n = int(np.prod(self.shape, dtype=np.int64))
        nbytes = n * self._type.itemsize
        lay = self._message(_LAYOUT)
        version = lay[0]
        if version in (1, 2):
            rank, cls = lay[1], lay[2]
            addr = f._addr(lay, 8) if cls != 0 else None
            compact_at = 8 + (f._o if cls != 0 else 0) + 4 * rank
        elif version in (3, 4):
            cls = lay[1]
            addr = f._addr(lay, 2) if cls == 1 else None
            compact_at = 2
        else:
            raise OSError(f"HDF5: layout message version {version}")
        if cls == 2:
            raise _unsupported(f"the chunked dataset '{self.name}' (chunks=, compression "
                               "or a resizable maxshape make one)")
        if cls == 0:  # compact: the data in the message
            if version < 3:
                size, start = f._uint(lay, compact_at, 4), compact_at + 4
            else:
                size, start = f._uint(lay, compact_at, 2), compact_at + 2
            return self._array(lay[start:start + size], n)
        if cls != 1:
            raise _unsupported(f"layout class {cls} of '{self.name}'")
        if addr is None:  # never written: the fill value
            fill = self._fill()
            if isinstance(self._type, _VlenString) or fill is None:
                fill = b"\0" * self._type.itemsize
            return self._array(fill * n, n)
        if isinstance(self._type, _VlenString):
            return self._array(f._read(addr, nbytes), n)
        if addr + nbytes > f._size:
            raise OSError(f"HDF5: '{self.name}' runs past the end of the file: truncated")
        arr = np.empty(self.shape, self._type)
        f._f.seek(addr)
        if f._f.readinto(memoryview(arr.reshape(-1).view(np.uint8))) != nbytes:
            raise OSError(f"HDF5: short read of '{self.name}'")
        return arr

    def _array(self, data: bytes, n: int) -> np.ndarray:
        v = self.file._values(self._type, self.shape, data, text=False)
        return np.asarray(v) if self.shape == () else v


# ---------------------------------------------------------------------------
# the JAX module's surface
# ---------------------------------------------------------------------------


def _decode(v: Any) -> Any:
    if isinstance(v, bytes):
        return v.decode("utf-8")
    if isinstance(v, np.ndarray) and v.dtype.kind in ("S", "O"):
        return [_decode(x) for x in v.tolist()]
    return v


class Hdf5Archive:
    """Read-only view of a Keras HDF5 archive (the reference's
    ``Hdf5Archive`` query surface: attributes as strings or JSON, group
    and dataset listing, dataset reads as numpy arrays)."""

    def __init__(self, path: str):
        self._f = File(path)

    # -- lifecycle -----------------------------------------------------
    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "Hdf5Archive":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- queries -------------------------------------------------------
    def has_attribute(self, name: str, *groups: str) -> bool:
        return name in self._group(*groups).attrs

    def read_attribute_as_string(self, name: str, *groups: str) -> str:
        return _decode(self._group(*groups).attrs[name])

    def read_attribute_as_json(self, name: str, *groups: str) -> Any:
        return json.loads(self.read_attribute_as_string(name, *groups))

    def read_string_list_attribute(self, name: str, *groups: str) -> List[str]:
        return [_decode(x) for x in self._group(*groups).attrs[name]]

    def get_groups(self, *groups: str) -> List[str]:
        g = self._group(*groups)
        return [k for k in g.keys() if isinstance(g[k], Group)]

    def get_data_sets(self, *groups: str) -> List[str]:
        g = self._group(*groups)
        return [k for k in g.keys() if isinstance(g[k], Dataset)]

    def read_data_set(self, name: str, *groups: str) -> np.ndarray:
        return self._group(*groups)[name].read()

    def _group(self, *groups: str):
        g = self._f
        for name in groups:
            g = g[name]
        return g


def read_layer_weights(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read every layer's weights: {layer_name: {weight_name: array}}.

    Handles both archive flavors the reference handles: full-model saves
    (weights under ``/model_weights``) and weights-only saves (layers at the
    root), each carrying ``layer_names`` / per-layer ``weight_names`` attrs.
    """
    out: Dict[str, Dict[str, np.ndarray]] = {}
    with File(path) as f:
        root = f["model_weights"] if "model_weights" in f else f
        if "layer_names" in root.attrs:
            layer_names = [_decode(x) for x in root.attrs["layer_names"]]
        else:
            layer_names = [k for k in root.keys() if isinstance(root[k], Group)]
        for ln in layer_names:
            g = root[ln]
            if "weight_names" in g.attrs:
                weight_names = [_decode(x) for x in g.attrs["weight_names"]]
            else:
                weight_names = list(g.keys())
            weights = {}
            for wn in weight_names:
                node = g[wn]
                if isinstance(node, Group):  # keras2 nested "{layer}/{var}:0"
                    for sub in node.keys():
                        weights[f"{wn}/{sub}"] = node[sub].read()
                else:
                    weights[wn] = node.read()
            out[ln] = weights
    return out


def read_model_config(path: str) -> Optional[dict]:
    """Read the ``model_config`` JSON attribute of a full-model save."""
    with File(path) as f:
        if "model_config" not in f.attrs:
            return None
        return json.loads(_decode(f.attrs["model_config"]))


def read_training_config(path: str) -> Optional[dict]:
    with File(path) as f:
        if "training_config" not in f.attrs:
            return None
        return json.loads(_decode(f.attrs["training_config"]))
