"""A finished HDF5 file's contiguous int8 datasets, read as memmaps with
numpy and ``struct`` alone (no ``h5py``).

The JAX package's preprocessing (``chunks=None``) and the reference (its
unchunked resave, DataProcesser.py:147-165) both finish a dataset as one
HDF5 file holding contiguous, unfiltered int8 datasets ``nodes``,
``edges`` and ``APDs`` in its root group.  That layout needs only a small
part of the format (HDF5 File Format Specification, version 3.0):

* the superblock, at offset 0 or after a user block (512, 1024, ...
  bytes), versions 0/1 and 2/3 (2/3 carry a Jenkins lookup3 checksum);
* object headers, version 1 (8-byte aligned messages, continuation
  message 0x10) and version 2 (``OHDR`` / ``OCHK``, checksummed);
* the root group as a symbol table (message 0x11: v1 B-tree ``TREE`` ->
  ``SNOD`` nodes -> names in the local heap ``HEAP``) or as link messages
  (0x06) in compact storage;
* each dataset's dataspace (0x01), datatype (0x03: fixed point, 1 byte,
  signed) and layout (0x08, versions 3 and 4: contiguous, or compact).

Everything else raises :class:`UnsupportedHDF5`, whose message names the
``.npd`` directory format the port writes on machines without ``h5py``:
chunked layouts (h5py's ``.chunked`` restart files among them), filter
pipelines (0x0B, any compression), external files (0x07), virtual
layouts, dense link storage (a fractal heap), shared messages, and any
unknown message flagged must-understand.  Nothing falls back to ``h5py``.

``read_datasets(path)`` -> ``{name: read-only np.memmap}`` for every
dataset of the root group.
"""

from __future__ import annotations

import mmap
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
NIL, DATASPACE, LINK_INFO, DATATYPE = 0x00, 0x01, 0x02, 0x03
LINK, EXTERNAL_FILES, LAYOUT, FILTER_PIPELINE = 0x06, 0x07, 0x08, 0x0B
CONTINUATION, SYMBOL_TABLE = 0x10, 0x11
KNOWN = set(range(0x18))   # the specification's types 0x00-0x17
MUST_UNDERSTAND = 0x80     # message flag: fail if the type is not known
SHARED = 0x02              # message flag: the data lives elsewhere


class UnsupportedHDF5(ValueError):
    """An HDF5 feature outside the finished-dataset layout."""

    def __init__(self, path: str, what: str) -> None:
        super().__init__(
            f"{path}: {what}; this reader takes contiguous, unfiltered int8 "
            "datasets only (as the JAX package's and the reference's "
            "preprocessing write them). Rewrite the dataset without "
            "chunking or compression, or preprocess into a '.npd' "
            "directory of .npy arrays instead")


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``, HDF5's metadata checksum."""
    mask = 0xFFFFFFFF

    def rot(x, k):
        return ((x << k) | (x >> (32 - k))) & mask

    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & mask
    if n == 0:
        return c
    i = 0
    while n - i > 12:
        x, y, z = struct.unpack_from("<3I", data, i)
        a, b, c = (a + x) & mask, (b + y) & mask, (c + z) & mask
        a = (a - c) & mask; a ^= rot(c, 4); c = (c + b) & mask
        b = (b - a) & mask; b ^= rot(a, 6); a = (a + c) & mask
        c = (c - b) & mask; c ^= rot(b, 8); b = (b + a) & mask
        a = (a - c) & mask; a ^= rot(c, 16); c = (c + b) & mask
        b = (b - a) & mask; b ^= rot(a, 19); a = (a + c) & mask
        c = (c - b) & mask; c ^= rot(b, 4); b = (b + a) & mask
        i += 12
    x, y, z = struct.unpack("<3I", data[i:].ljust(12, b"\0"))
    a, b, c = (a + x) & mask, (b + y) & mask, (c + z) & mask
    c ^= b; c = (c - rot(b, 14)) & mask
    a ^= c; a = (a - rot(c, 11)) & mask
    b ^= a; b = (b - rot(a, 25)) & mask
    c ^= b; c = (c - rot(b, 16)) & mask
    a ^= c; a = (a - rot(c, 4)) & mask
    b ^= a; b = (b - rot(a, 14)) & mask
    c ^= b; c = (c - rot(b, 24)) & mask
    return c


class _File:
    """The bytes of an HDF5 file with the superblock's sizes and base."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.creation_order = False
        with open(path, "rb") as fh:
            if not fh.seek(0, 2):
                self.corrupt("an empty file")
            # metadata is read in place; the datasets' bytes are never read
            self.raw = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        self.base, self.root = self._superblock()

    def close(self) -> None:
        self.raw.close()

    # ------------------------------------------------------------------
    def fail(self, what: str):
        raise UnsupportedHDF5(self.path, what)

    def corrupt(self, what: str):
        raise ValueError(f"{self.path}: not a readable HDF5 file ({what})")

    def uint(self, pos: int, size: int) -> int:
        if pos < 0 or pos + size > len(self.raw):
            self.corrupt(f"a field at byte {pos} lies past the end")
        return int.from_bytes(self.raw[pos:pos + size], "little")

    def undefined(self, addr: int) -> bool:
        return addr == (1 << (8 * self.so)) - 1

    def offset(self, addr: int) -> int:
        """A file position from an address (relative to the base)."""
        return self.base + addr

    def checksum(self, start: int, end: int, what: str) -> None:
        if lookup3(self.raw[start:end]) != self.uint(end, 4):
            self.corrupt(f"the {what} checksum does not match")

    # ------------------------------------------------------------------
    def _superblock(self) -> Tuple[int, int]:
        """-> (base address, root group's object header position)."""
        at = 0
        while self.raw[at:at + 8] != SIGNATURE:
            at = 512 if at == 0 else 2 * at
            if at + 8 > len(self.raw):
                self.corrupt("no HDF5 signature at 0, 512, 1024, ...")
        version = self.raw[at + 8]
        if version in (0, 1):
            self.so, self.sl = self.raw[at + 13], self.raw[at + 14]
            pos = at + 24 + (4 if version == 1 else 0)
            base = self.uint(pos, self.so)
            # base, free space, end of file, driver block; then the root
            # group's symbol table entry: name offset, header address
            entry = pos + 4 * self.so
            root = self.uint(entry + self.so, self.so)
        elif version in (2, 3):
            self.so, self.sl = self.raw[at + 9], self.raw[at + 10]
            pos = at + 12
            base = self.uint(pos, self.so)
            root = self.uint(pos + 3 * self.so, self.so)
            self.checksum(at, pos + 4 * self.so, "superblock")
        else:
            self.fail(f"superblock version {version}")
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            self.corrupt(f"offset size {self.so}, length size {self.sl}")
        return base, base + root

    # ------------------------------------------------------------------
    def messages(self, pos: int) -> List[Tuple[int, int, bytes]]:
        """(type, flags, data) of every message of the object header at
        file position ``pos``, continuation blocks followed."""
        out: List[Tuple[int, int, bytes]] = []
        if self.raw[pos:pos + 4] == b"OHDR":
            self._v2_header(pos, out)
        elif self.raw[pos] == 1:
            size = self.uint(pos + 8, 4)
            self._v1_block(pos + 16, size, out)
        else:
            self.fail(f"object header version {self.raw[pos]} at byte {pos}")
        for mtype, flags, _ in out:
            if mtype not in KNOWN and flags & MUST_UNDERSTAND:
                self.fail(f"message type 0x{mtype:04x} that must be "
                          "understood")
        return out

    def _continue(self, data: bytes, out, v2: bool) -> None:
        addr = int.from_bytes(data[:self.so], "little")
        length = int.from_bytes(data[self.so:self.so + self.sl], "little")
        pos = self.offset(addr)
        if v2:
            if self.raw[pos:pos + 4] != b"OCHK":
                self.corrupt("a continuation block without OCHK")
            self.checksum(pos, pos + length - 4, "OCHK")
            self._v2_block(pos + 4, pos + length - 4, out)
        else:
            self._v1_block(pos, length, out)

    def _v1_block(self, pos: int, size: int, out) -> None:
        end = pos + size
        while pos + 8 <= end:
            mtype, msize, flags = struct.unpack_from("<HHB", self.raw, pos)
            data = self.raw[pos + 8:pos + 8 + msize]
            pos += 8 + msize
            if mtype == CONTINUATION:
                self._continue(data, out, v2=False)
            elif mtype != NIL:
                out.append((mtype, flags, data))

    def _v2_header(self, pos: int, out) -> None:
        if self.raw[pos + 4] != 2:
            self.fail(f"OHDR version {self.raw[pos + 4]}")
        flags = self.raw[pos + 5]
        at = pos + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 0x03)
        size = self.uint(at, width)
        start = at + width
        self.checksum(pos, start + size, "OHDR")
        self.creation_order = bool(flags & 0x04)
        self._v2_block(start, start + size, out)

    def _v2_block(self, pos: int, end: int, out) -> None:
        head = 6 if self.creation_order else 4
        while pos + head <= end:
            mtype, msize, flags = struct.unpack_from("<BHB", self.raw, pos)
            data = self.raw[pos + head:pos + head + msize]
            pos += head + msize
            if mtype == CONTINUATION:
                self._continue(data, out, v2=True)
            elif mtype != NIL:
                out.append((mtype, flags, data))

    # ------------------------------------------------------------------
    def links(self) -> Dict[str, int]:
        """Name -> object header position of every hard link of the root
        group."""
        msgs = self.messages(self.root)
        out: Dict[str, int] = {}
        for mtype, _, data in msgs:
            if mtype == SYMBOL_TABLE:
                btree = int.from_bytes(data[:self.so], "little")
                heap = int.from_bytes(data[self.so:2 * self.so], "little")
                self._symbol_table(self.offset(btree), self._heap(heap), out)
            elif mtype == LINK_INFO:
                fheap = int.from_bytes(
                    data[2 + (8 if data[1] & 1 else 0):][:self.so], "little")
                if not self.undefined(fheap):
                    self.fail("the root group's links in dense storage "
                              "(a fractal heap)")
            elif mtype == LINK:
                name, addr = self._link(data)
                if addr is not None:
                    out[name] = self.offset(addr)
        return out

    def _heap(self, addr: int) -> int:
        """The file position of a local heap's data segment."""
        pos = self.offset(addr)
        if self.raw[pos:pos + 4] != b"HEAP":
            self.corrupt("a symbol table without its local heap")
        return self.offset(self.uint(pos + 8 + 2 * self.sl, self.so))

    def _name(self, heap: int, offset: int) -> str:
        start = heap + offset
        return self.raw[start:self.raw.find(b"\0", start)].decode()

    def _symbol_table(self, pos: int, heap: int, out) -> None:
        if self.raw[pos:pos + 4] == b"SNOD":
            count = self.uint(pos + 6, 2)
            entry = 2 * self.so + 24
            for k in range(count):
                e = pos + 8 + k * entry
                name = self._name(heap, self.uint(e, self.so))
                out[name] = self.offset(self.uint(e + self.so, self.so))
            return
        if self.raw[pos:pos + 4] != b"TREE" or self.raw[pos + 4] != 0:
            self.corrupt("a group's B-tree node")
        used = self.uint(pos + 6, 2)
        at = pos + 8 + 2 * self.so            # past both siblings
        for k in range(used):                 # key k, child k
            child = self.uint(at + self.sl + k * (self.sl + self.so),
                              self.so)
            self._symbol_table(self.offset(child), heap, out)

    def _link(self, data: bytes) -> Tuple[str, Optional[int]]:
        """(name, address) of a link message; address None for a soft or
        external link."""
        if data[0] != 1:
            self.fail(f"link message version {data[0]}")
        flags, at = data[1], 2
        kind = 0
        if flags & 0x08:
            kind, at = data[at], at + 1
        if flags & 0x04:
            at += 8
        if flags & 0x10:
            at += 1
        width = 1 << (flags & 0x03)
        n = int.from_bytes(data[at:at + width], "little")
        at += width
        name = data[at:at + n].decode()
        if kind != 0:
            return name, None
        return name, int.from_bytes(data[at + n:at + n + self.so], "little")

    # ------------------------------------------------------------------
    def dataset(self, name: str, pos: int) -> Optional[np.ndarray]:
        """The dataset at ``pos`` as a read-only array, or None where the
        object is not a dataset (a group)."""
        msgs = self.messages(pos)
        types = {m[0] for m in msgs}
        if LAYOUT not in types:
            return None
        what = f"dataset {name!r}"
        for mtype, flags, _ in msgs:
            if mtype == FILTER_PIPELINE:
                self.fail(f"{what} has a filter pipeline (compression)")
            if mtype == EXTERNAL_FILES:
                self.fail(f"{what} is stored in external files")
            if mtype in (DATASPACE, DATATYPE, LAYOUT) and flags & SHARED:
                self.fail(f"{what} has a shared message 0x{mtype:02x}")
        by_type = {m[0]: m[2] for m in msgs}
        shape = self._dataspace(by_type[DATASPACE], what)
        self._datatype(by_type[DATATYPE], what)
        return self._layout(by_type[LAYOUT], shape, what)

    def _dataspace(self, data: bytes, what: str) -> Tuple[int, ...]:
        version, rank, flags = data[0], data[1], data[2]
        if version == 1:
            at = 8
        elif version == 2:
            if data[3] == 2:
                self.fail(f"{what} has a null dataspace")
            at = 4
        else:
            self.fail(f"{what}: dataspace version {version}")
        return tuple(int.from_bytes(data[at + k * self.sl:
                                         at + (k + 1) * self.sl], "little")
                     for k in range(rank))

    def _datatype(self, data: bytes, what: str) -> None:
        cls = data[0] & 0x0F
        size = int.from_bytes(data[4:8], "little")
        signed = bool(data[1] & 0x08)
        precision = int.from_bytes(data[10:12], "little") if cls == 0 else 0
        if not (cls == 0 and size == 1 and signed and precision == 8):
            self.fail(f"{what} is not int8 (datatype class {cls}, {size} "
                      f"bytes, {'signed' if signed else 'unsigned'})")

    def _layout(self, data: bytes, shape: Tuple[int, ...], what: str
                ) -> np.ndarray:
        version, cls = data[0], data[1]
        if version not in (3, 4):
            self.fail(f"{what}: layout message version {version}")
        n = int(np.prod(shape, dtype=np.int64))
        if cls == 0:                           # compact: bytes in the header
            size = int.from_bytes(data[2:4], "little")
            if size != n:
                self.corrupt(f"{what}: {size} compact bytes for {n} elements")
            return np.frombuffer(data[4:4 + size], np.int8).reshape(shape)
        if cls == 2:
            self.fail(f"{what} has a chunked layout")
        if cls != 1:
            self.fail(f"{what} has layout class {cls} (virtual)")
        addr = int.from_bytes(data[2:2 + self.so], "little")
        size = int.from_bytes(data[2 + self.so:2 + self.so + self.sl],
                              "little")
        if n == 0:
            return np.empty(shape, np.int8)
        if self.undefined(addr) or size != n:
            self.corrupt(f"{what}: {size} contiguous bytes stored for {n} "
                         "elements")
        start = self.offset(addr)
        if start + n > len(self.raw):
            self.corrupt(f"{what} runs past the end of the file")
        return np.memmap(self.path, dtype=np.int8, mode="r", offset=start,
                         shape=shape)


def read_datasets(path: str) -> Dict[str, np.ndarray]:
    """Every dataset of the root group of the HDF5 file ``path``: a
    read-only ``np.memmap`` for a contiguous one, an array for a compact
    or empty one.  Raises :class:`UnsupportedHDF5` (a ``ValueError``
    naming ``.npd``) on any layout this reader does not take."""
    f = _File(path)
    out: Dict[str, np.ndarray] = {}
    try:
        for name, pos in f.links().items():
            arr = f.dataset(name, pos)
            if arr is not None:
                arr.flags.writeable = False
                out[name] = arr
    finally:
        f.close()
    return out
