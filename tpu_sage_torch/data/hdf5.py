"""The HDF5 subset of ``problem.h5``, read and written with numpy alone.

The card's machine has no ``h5py``, so the port reads and writes its
problem files itself. The subset is what the schema needs and what h5py
writes by default (HDF5's "earliest" file format):

- a version 0 superblock whose root group is a symbol table (a version 1
  B-tree of symbol-table nodes over a local heap of names);
- datasets of little-endian integers and IEEE floats, any rank, in
  contiguous storage, no filters;
- root-group attributes: scalar integers and floats, fixed-length and
  variable-length strings (h5py stores a ``str`` as the latter, in a global
  heap).

``write`` lays a file out as libhdf5 would for that format (every name in one
symbol-table node, so at most ``2·LEAF_K`` datasets); h5py and the JAX
package read it, and ``read`` reads the files they write. Anything outside
the subset (chunked or filtered storage, big-endian or compound types,
compact storage, object headers of version 2 and the messages and
superblocks of HDF5's later formats) raises ``ValueError``.
"""

from __future__ import annotations

import mmap
import struct
from typing import Dict, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
NO_FREE_BLOCK = 1  # a local heap's free-list head when it has none (libhdf5's H5HL_FREE_NULL)
LEAF_K, INTERNAL_K = 4, 16  # libhdf5's defaults: 2·LEAF_K names per symbol-table node

# object header message types
DATASPACE, DATATYPE, FILL, LAYOUT, FILTERS, ATTRIBUTE, CONTINUATION, STAB = (
    0x1, 0x3, 0x5, 0x8, 0xB, 0xC, 0x10, 0x11)

Attr = Union[str, int, float]


def _up8(n: int) -> int:
    return n + (-n % 8)


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


# -- writing ---------------------------------------------------------------------------

def _datatype(dt: np.dtype) -> bytes:
    """Datatype message (version 1) of a little-endian numeric or a
    fixed-length string dtype."""
    if dt.kind in "iu":
        return (bytes([0x10, 0x08 if dt.kind == "i" else 0, 0, 0])
                + struct.pack("<IHH", dt.itemsize, 0, 8 * dt.itemsize))
    if dt.kind == "f" and dt.itemsize in (4, 8):
        sign, exp_loc, exp_size, mant, bias = ((31, 23, 8, 23, 127) if dt.itemsize == 4
                                               else (63, 52, 11, 52, 1023))
        return (bytes([0x11, 0x20, sign, 0])
                + struct.pack("<IHHBBBBI", dt.itemsize, 0, 8 * dt.itemsize, exp_loc, exp_size,
                              0, mant, bias))
    if dt.kind == "S":
        return bytes([0x13, 0x01, 0, 0]) + struct.pack("<I", dt.itemsize)  # null-padded ASCII
    raise ValueError(f"hdf5: no datatype for {dt}")


def _dataspace(shape: Tuple[int, ...]) -> bytes:
    """Dataspace message (version 1); rank 0 is a scalar."""
    return bytes([1, len(shape), 0, 0, 0, 0, 0, 0]) + b"".join(
        struct.pack("<Q", d) for d in shape)


def _message(mtype: int, data: bytes) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), 0) + data


def _object_header(messages) -> bytes:
    """A version 1 object header holding ``messages`` (already framed)."""
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _attribute(name: str, value: Attr) -> bytes:
    if isinstance(value, str):
        arr = np.array(value.encode(), dtype=f"S{max(1, len(value.encode()))}")
    else:
        arr = np.asarray(value)
        if arr.dtype.kind not in "iuf":
            raise ValueError(f"hdf5: attribute {name!r} of unsupported type {type(value)}")
    arr = arr.astype(arr.dtype.newbyteorder("<"))
    dtype, space = _datatype(arr.dtype), _dataspace(())
    raw_name = name.encode() + b"\0"
    return _message(ATTRIBUTE, struct.pack("<BBHHH", 1, 0, len(raw_name), len(dtype), len(space))
                    + _pad8(raw_name) + _pad8(dtype) + _pad8(space) + arr.tobytes())


def _dataset_header(a: np.ndarray, data_at: int) -> bytes:
    """A dataset's object header: its shape, dtype, no fill value, and its
    ``a.nbytes`` stored contiguously at ``data_at``."""
    return _object_header([
        _message(DATASPACE, _dataspace(a.shape)), _message(DATATYPE, _datatype(a.dtype)),
        _message(FILL, bytes([2, 2, 2, 0])),  # version 2: allocated late, written if set, none
        _message(LAYOUT, bytes([3, 1]) + struct.pack("<QQ", data_at if a.nbytes else UNDEF,
                                                     a.nbytes))])


def write(path: str, datasets: Dict[str, np.ndarray], attrs: Dict[str, Attr]) -> None:
    """Write ``datasets`` (numeric arrays) and root ``attrs`` (str, int,
    float) as a new HDF5 file at ``path``."""
    names = sorted(datasets)  # a symbol-table node keeps its entries in name order
    if len(names) > 2 * LEAF_K:
        raise ValueError(f"hdf5: at most {2 * LEAF_K} datasets, got {len(names)}")
    arrays = {}
    for k in names:
        a = np.asarray(datasets[k])
        if a.dtype.kind not in "iuf":
            raise ValueError(f"hdf5: dataset {k!r} has unsupported dtype {a.dtype}")
        arrays[k] = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<"))

    heap_data = bytearray(8)  # offset 0: the empty name
    name_off = {}
    for k in names:
        name_off[k] = len(heap_data)
        heap_data += _pad8(k.encode() + b"\0")
    heap_data = bytes(heap_data)

    superblock_size = 96
    root_msgs_wo_stab = [_attribute(k, v) for k, v in attrs.items()]
    root_size = len(_object_header([_message(STAB, bytes(16))] + root_msgs_wo_stab))
    root_at = superblock_size
    heap_at = root_at + root_size
    heap_data_at = heap_at + 32
    btree_at = heap_data_at + len(heap_data)
    btree_size = 24 + (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8
    snod_at = btree_at + btree_size
    snod_size = 8 + 2 * LEAF_K * 40
    meta_end = snod_at + snod_size

    # the dataset headers (their size does not depend on the addresses), then
    # the data, each array 8-aligned
    oh_at, at = {}, meta_end
    for k in names:
        oh_at[k] = at
        at += len(_dataset_header(arrays[k], 0))
    data_at = {}
    for k in names:
        at += -at % 8
        data_at[k] = at
        at += arrays[k].nbytes
    eof = at
    headers = [_dataset_header(arrays[k], data_at[k]) for k in names]

    superblock = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                  + struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
                  + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
                  + struct.pack("<QQII", 0, root_at, 1, 0) + struct.pack("<QQ", btree_at, heap_at))
    root = _object_header([_message(STAB, struct.pack("<QQ", btree_at, heap_at))]
                          + root_msgs_wo_stab)
    heap = b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack("<QQQ", len(heap_data), NO_FREE_BLOCK,
                                                        heap_data_at)
    last_name = name_off[names[-1]] if names else 0
    btree = (b"TREE" + bytes([0, 0]) + struct.pack("<HQQ", 1 if names else 0, UNDEF, UNDEF)
             + struct.pack("<QQQ", 0, snod_at, last_name))
    btree += bytes(btree_size - len(btree))
    snod = b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(names)) + b"".join(
        struct.pack("<QQII16x", name_off[k], oh_at[k], 0, 0) for k in names)
    snod += bytes(snod_size - len(snod))
    meta = superblock + root + heap + heap_data + btree + snod
    assert len(superblock) == superblock_size and len(meta) == meta_end

    with open(path, "wb") as f:
        f.write(meta)
        for h in headers:
            f.write(h)
        pos = meta_end + sum(map(len, headers))
        for k in names:
            f.write(bytes(data_at[k] - pos))
            f.write(memoryview(arrays[k].reshape(-1)).cast("B"))
            pos = data_at[k] + arrays[k].nbytes


# -- reading ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf):
        self.buf = buf

    def unpack(self, fmt: str, at: int):
        return struct.unpack_from("<" + fmt, self.buf, at)

    def messages(self, at: int):
        """``(type, data offset, size)`` of each message of the version 1
        object header at ``at``, continuation blocks followed."""
        version, _, n_msgs, _, size = self.unpack("BBHII", at)
        if version != 1:
            raise ValueError(f"hdf5: object header version {version} at {at} is not supported")
        blocks, out = [(at + 16, size)], []
        while blocks and len(out) < n_msgs:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end and len(out) < n_msgs:
                mtype, msize, flags = self.unpack("HHB", p)
                if flags & 0x2:
                    raise ValueError("hdf5: shared object header messages are not supported")
                out.append((mtype, p + 8, msize))
                if mtype == CONTINUATION:
                    blocks.append(self.unpack("QQ", p + 8))
                p += 8 + msize
        return out

    def datatype(self, at: int):
        """``(numpy dtype or "vlen-str", message size)``."""
        cls_ver, b0, _, _, size = self.unpack("BBBBI", at)
        cls = cls_ver & 0x0F
        if cls in (0, 1) and b0 & 0x1:
            raise ValueError("hdf5: big-endian data is not supported")
        if cls == 0:
            return np.dtype(f"<{'i' if b0 & 0x8 else 'u'}{size}"), 12
        if cls == 1:
            return np.dtype(f"<f{size}"), 20
        if cls == 3:
            return np.dtype(f"S{size}"), 8
        if cls == 9 and b0 & 0x0F == 1:  # variable-length string
            return "vlen-str", 8 + self.datatype(at + 8)[1]
        raise ValueError(f"hdf5: datatype class {cls} is not supported")

    def dataspace(self, at: int) -> Tuple[int, ...]:
        version, rank = self.unpack("BB", at)
        if version != 1:
            raise ValueError(f"hdf5: dataspace version {version} is not supported")
        return tuple(self.unpack(f"{rank}Q", at + 8)) if rank else ()

    def global_heap_object(self, collection: int, index: int) -> bytes:
        if bytes(self.buf[collection:collection + 4]) != b"GCOL":
            raise ValueError("hdf5: bad global heap collection")
        (size,) = self.unpack("Q", collection + 8)
        p, end = collection + 16, collection + size
        while p + 16 <= end:
            idx, _, osize = self.unpack("HH4xQ", p)
            if idx == 0:
                break
            if idx == index:
                return bytes(self.buf[p + 16:p + 16 + osize])
            p += 16 + _up8(osize)
        raise ValueError(f"hdf5: global heap object {index} not found")

    def attribute(self, at: int) -> Tuple[str, Attr]:
        version, _, name_size, dt_size, ds_size = self.unpack("BBHHH", at)
        if version != 1:
            raise ValueError(f"hdf5: attribute message version {version} is not supported")
        p = at + 8  # name, datatype and dataspace, each padded to 8 bytes
        name = bytes(self.buf[p:p + name_size]).split(b"\0")[0].decode()
        p += _up8(name_size)
        dtype, _ = self.datatype(p)
        p += _up8(dt_size)
        shape = self.dataspace(p)
        p += _up8(ds_size)
        if shape not in ((), (1,)):
            raise ValueError(f"hdf5: attribute {name!r} is not a scalar")
        if isinstance(dtype, str):  # length, then (collection, index) in the global heap
            length, collection, index = self.unpack("IQI", p)
            return name, self.global_heap_object(collection, index)[:length].decode()
        value = np.frombuffer(self.buf, dtype, 1, p)[0]
        if dtype.kind == "S":
            return name, value.rstrip(b"\0").decode()
        return name, value.item()

    def dataset(self, at: int) -> np.ndarray:
        shape, dtype, layout = None, None, None
        for mtype, p, _ in self.messages(at):
            if mtype == DATASPACE:
                shape = self.dataspace(p)
            elif mtype == DATATYPE:
                dtype = self.datatype(p)[0]
            elif mtype == LAYOUT:
                layout = p
            elif mtype == FILTERS:
                raise ValueError("hdf5: filtered (compressed) datasets are not supported")
        if shape is None or dtype is None or layout is None or isinstance(dtype, str):
            raise ValueError(f"hdf5: object at {at} is not a numeric dataset")
        version, cls = self.unpack("BB", layout)
        count = int(np.prod(shape, dtype=np.int64))
        if version != 3 or cls != 1:
            raise ValueError("hdf5: only contiguous dataset storage is supported")
        data_at, _ = self.unpack("QQ", layout + 2)
        if data_at == UNDEF:  # never written: the fill value, zero
            return np.zeros(shape, dtype)
        return np.frombuffer(self.buf, dtype, count, data_at).reshape(shape).copy()

    def group_entries(self, btree: int, heap: int) -> Dict[str, int]:
        """``{name: object header address}`` of a symbol-table group."""
        if bytes(self.buf[heap:heap + 4]) != b"HEAP":
            raise ValueError("hdf5: bad local heap")
        (heap_data,) = self.unpack("Q", heap + 24)
        out = {}

        def visit(node: int) -> None:
            if bytes(self.buf[node:node + 4]) != b"TREE":
                raise ValueError("hdf5: bad B-tree node")
            _, level, used = self.unpack("BBH", node + 4)
            for i in range(used):
                (child,) = self.unpack("Q", node + 24 + 8 + 16 * i)
                if level:
                    visit(child)
                    continue
                if bytes(self.buf[child:child + 4]) != b"SNOD":
                    raise ValueError("hdf5: bad symbol table node")
                (n_syms,) = self.unpack("H", child + 6)
                for j in range(n_syms):
                    name_off, header = self.unpack("QQ", child + 8 + 40 * j)
                    name_at = heap_data + name_off
                    end = bytes(self.buf[name_at:name_at + 1024]).index(b"\0")
                    out[bytes(self.buf[name_at:name_at + end]).decode()] = header

        visit(btree)
        return out


def read(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Attr]]:
    """``(datasets, attrs)`` of the root group of the HDF5 file at ``path``."""
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm, \
            memoryview(mm) as buf:
        r = _Reader(buf)
        if bytes(buf[:8]) != SIGNATURE:
            raise ValueError(f"hdf5: {path!r} is not an HDF5 file")
        if buf[8] != 0:
            raise ValueError(f"hdf5: superblock version {buf[8]} is not supported")
        (root,) = r.unpack("Q", 64)  # the root group's symbol-table entry is at 56
        btree = heap = None
        attrs = {}
        for mtype, p, _ in r.messages(root):
            if mtype == STAB:
                btree, heap = r.unpack("QQ", p)
            elif mtype == ATTRIBUTE:
                name, value = r.attribute(p)
                attrs[name] = value
        if btree is None:
            raise ValueError("hdf5: the root group is not a symbol table")
        datasets = {name: r.dataset(at) for name, at in r.group_entries(btree, heap).items()}
    return datasets, attrs
