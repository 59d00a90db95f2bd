"""Reading the JAX package's orbax checkpoints without orbax, tensorstore or JAX.

Every artifact that open_musiclm_tpu trains is a directory written by
``orbax.checkpoint.StandardCheckpointer`` (open_musiclm_tpu/checkpoint.py):
a stage's ``TrainState``, the CLAP RVQ and the k-means centroids.
``read_orbax(path)`` returns what ``StandardCheckpointer().restore(path)``
returns for such a directory, bit for bit, read with json, numpy and
ctypes alone. The layers, from the outside in:

  * ``_METADATA`` (JSON): ``tree_metadata`` maps each leaf's key path to
    its kinds (``key_type`` 1 a sequence index, 2 a dict key) and its
    ``value_metadata``. A sequence comes back as a list, a dict as a dict
    (as orbax restores them without a target, NamedTuples included);
    ``skip_deserialize`` leaves (optax's ``EmptyState``, empty containers)
    come back as None, {} or []; a ``scalar`` as a Python number. Each
    array is the zarr v2 array named by its key path joined with ``.``.
  * the key-value store: with ``use_ocdbt`` (orbax's default) an OCDBT
    database, else one file per key under the directory (earlier orbax
    versions). OCDBT (tensorstore's "optionally-cooperative distributed
    B+tree"): the root ``manifest.ocdbt``, or without one the
    per-process ``ocdbt.process_*/manifest.ocdbt``, names the newest
    version's B+tree root; every node and manifest is framed (a magic
    number, its length, a format version, a compression flag, the body,
    CRC32C); a body holds a table of data files and columns of varints;
    keys share prefixes with their neighbours and with their subtree; a
    leaf's value is inline or a (file, offset, length) reference into a
    data file. Data file paths are relative to the database's directory,
    each table's prefixed with the base path of the file that holds it.
  * zarr v2: ``.zarray`` gives the shape, the chunk grid, the dtype
    (``<f4``, ``<i4``, ``<i8``, ``|b1``, ``<f2``, ``|i1``, ``bfloat16`` and the
    other fixed-width numbers), C or F order, the compressor (zstd or
    none) and ``fill_value`` for absent chunks (null reads as zeros, as
    tensorstore reads it).
  * zstd: ``libzstd.so.1`` through ctypes.

bfloat16 arrays come back as ``torch.bfloat16`` tensors (numpy has no such
dtype); every other array as a numpy array in native byte order.

Refused with a ValueError naming what was found: a directory without
``_METADATA``, ``use_zarr3``, a manifest or node of an unknown format
version, magic, compression or manifest kind, a CRC that does not match, a
data file that is missing or too short, a zarr compressor other than zstd
or none, filters, an unsupported dtype or order, and a key that is absent.
Nothing partial is returned. A missing libzstd raises an OSError naming
the library.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import itertools
import json
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_FRAME_HEADER = 12  # magic (4, big-endian) + total length (8, little-endian)
_MISSING = (1 << 64) - 1  # a version's root location when its tree is empty

# a leaf value: inline bytes, or (data file path, offset, length)
Value = Union[bytes, Tuple[str, int, int]]


# ---------------------------------------------------------------------------
# zstd and CRC32C
# ---------------------------------------------------------------------------


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


@functools.lru_cache(maxsize=None)
def _libzstd() -> ctypes.CDLL:
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise OSError("reading an orbax checkpoint needs the zstd library (libzstd.so.1), which was not found "
                      "on this machine (Debian / Ubuntu: the libzstd1 package)")
    lib = ctypes.CDLL(name)
    for fn, restype, argtypes in (
        ("ZSTD_decompress", ctypes.c_size_t, [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]),
        ("ZSTD_isError", ctypes.c_uint, [ctypes.c_size_t]),
        ("ZSTD_getErrorName", ctypes.c_char_p, [ctypes.c_size_t]),
        ("ZSTD_createDStream", ctypes.c_void_p, []),
        ("ZSTD_freeDStream", ctypes.c_size_t, [ctypes.c_void_p]),
        ("ZSTD_decompressStream", ctypes.c_size_t,
         [ctypes.c_void_p, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)]),
    ):
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def _zstd_check(lib, n: int, what: str) -> int:
    if lib.ZSTD_isError(n):
        raise ValueError(f"{what}: zstd: {lib.ZSTD_getErrorName(n).decode()}")
    return n


def zstd_decompress_into(data: bytes, out: np.ndarray, what: str = "a zstd frame") -> np.ndarray:
    """Decompress the zstd frames in ``data`` into ``out`` (C-contiguous),
    which they must fill exactly; returns ``out``."""
    if not out.flags.c_contiguous:
        raise ValueError(f"{what}: the output buffer is not contiguous")
    lib = _libzstd()
    n = _zstd_check(lib, lib.ZSTD_decompress(out.ctypes.data, out.nbytes, data, len(data)), what)
    if n != out.nbytes:
        raise ValueError(f"{what}: zstd gave {n} bytes, want {out.nbytes}")
    return out


def zstd_decompress(data: bytes, what: str = "a zstd frame") -> bytes:
    """The content of the zstd frames in ``data``, streamed in blocks (a
    frame need not declare its size)."""
    lib = _libzstd()
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError(f"{what}: ZSTD_createDStream failed")
    try:
        src = ctypes.create_string_buffer(data, len(data))
        inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        block = np.empty(1 << 20, np.uint8)
        parts, pending = [], 1
        while inb.pos < inb.size or pending:
            outb = _OutBuffer(block.ctypes.data, block.size, 0)
            pending = _zstd_check(lib, lib.ZSTD_decompressStream(stream, ctypes.byref(outb), ctypes.byref(inb)), what)
            parts.append(block[:outb.pos].tobytes())
            if inb.pos == inb.size and pending and outb.pos < outb.size:
                raise ValueError(f"{what}: the zstd frame is truncated")
        return b"".join(parts)
    finally:
        lib.ZSTD_freeDStream(stream)


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT frames carry it."""
    c = 0xFFFFFFFF
    table = _CRC32C
    for x in data:
        c = table[(c ^ x) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------


class _Reader:
    """A cursor over a node's or manifest's body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError(f"{self.what}: truncated")
        self.pos += 1
        return self.data[self.pos - 1]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: a varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _unframe(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or B+tree node: the magic, the length, the
    format version 0, the CRC32C of all before it, zstd or no compression."""
    if len(raw) < _FRAME_HEADER + 2 + 4:
        raise ValueError(f"{what}: {len(raw)} bytes is too short for an OCDBT frame")
    found = int.from_bytes(raw[:4], "big")
    if found != magic:
        raise ValueError(f"{what}: magic {found:#010x}, want {magic:#010x}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"{what}: the frame says {length} bytes, the file holds {len(raw)}")
    want_crc = int.from_bytes(raw[-4:], "little")
    if crc32c(raw[:-4]) != want_crc:
        raise ValueError(f"{what}: CRC32C mismatch (the file is damaged)")
    r = _Reader(raw[:-4], what)
    r.pos = _FRAME_HEADER
    version = r.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version}; this reader knows version 0")
    compression = r.varint()
    body = raw[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decompress(body, what=what)
    raise ValueError(f"{what}: compression format {compression}; this reader knows 0 (none) and 1 (zstd)")


def _data_file_table(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """Each data file's (base path, path), relative to the database's
    directory: an entry's path shares a prefix with the one before it, and
    both are prefixed with ``base``, the base path of the file that holds
    the table (the nodes a file names read their own tables from there)."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: a data file path shares {prefix[i]} bytes with a {len(prev)}-byte path")
        full = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(full):
            raise ValueError(f"{r.what}: a base path of {base_len[i]} bytes in a {len(full)}-byte path")
        paths.append((base + full[:base_len[i]].decode(), base + full.decode()))
        prev = full
    return paths


def _keys(r: _Reader, n: int) -> Tuple[List[int], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    return prefix, r.varints(n)


def _join_keys(r: _Reader, prefix: List[int], suffix: List[int]) -> List[bytes]:
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"{r.what}: a key shares {p} bytes with a {len(prev)}-byte key")
        prev = prev[:p] + r.take(s)
        keys.append(prev)
    return keys


class _Store:
    """An OCDBT database or a plain directory of keys, read from ``root``."""

    def __init__(self, root: Path, ocdbt: bool):
        self.root = root
        self.items: Optional[Dict[str, Value]] = None
        if ocdbt:
            self.items = {}
            for manifest in self._manifests():
                self._read_manifest(manifest)

    # -- files --

    def _file(self, rel: str) -> Path:
        if Path(rel).is_absolute() or ".." in Path(rel).parts:
            raise ValueError(f"{self.root}: the data file path {rel!r} leaves the checkpoint")
        return self.root / rel

    def read(self, rel: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        path = self._file(rel)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read() if length is None else f.read(length)
        except FileNotFoundError:
            raise ValueError(f"{self.root}: the data file {rel} is missing") from None
        if length is not None and len(data) != length:
            raise ValueError(f"{self.root}: the data file {rel} holds {offset + len(data)} bytes, "
                             f"a value needs {offset + length}")
        return data

    # -- the B+tree --

    def _manifests(self) -> List[str]:
        if (self.root / "manifest.ocdbt").is_file():
            return ["manifest.ocdbt"]
        found = sorted(p.relative_to(self.root).as_posix()
                       for p in self.root.glob("ocdbt.process_*/manifest.ocdbt"))
        if not found:
            raise ValueError(f"{self.root}: use_ocdbt is set but there is no manifest.ocdbt "
                             f"(found {sorted(p.name for p in self.root.iterdir())})")
        return found

    def _read_manifest(self, rel: str) -> None:
        what = f"{self.root / rel}"
        r = _Reader(_unframe(self.read(rel), _MANIFEST_MAGIC, what), what)
        base = rel[:-len("manifest.ocdbt")]
        r.take(16)  # the database's uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{what}: manifest kind {kind} (numbered); this reader knows kind 0 (single)")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()  # version_tree_arity_log2
        method = r.varint()
        if method == 1:
            r.take(4)  # the zstd level, int32
        elif method != 0:
            raise ValueError(f"{what}: node compression method {method}; this reader knows 0 and 1")
        files = _data_file_table(r, base)
        n = r.varint()
        if n == 0:
            return  # no version yet: an empty database
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        latest = max(range(n), key=generation.__getitem__)  # the newest version's root
        if length[latest] == _MISSING:
            return  # the newest version's tree is empty
        self._walk(files, file_id[latest], offset[latest], length[latest], height[latest], b"")

    def _walk(self, files: List[Tuple[str, str]], fid: int, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        """The node at ``files[fid]``, ``offset``, ``length`` and, under it,
        every leaf's keys (``prefix`` + the node's own) into ``items``."""
        if fid >= len(files):
            raise ValueError(f"{self.root}: a node refers to data file {fid} of {len(files)}")
        base, path = files[fid]
        what = f"{self.root / path} at {offset}"
        r = _Reader(_unframe(self.read(path, offset, length), _NODE_MAGIC, what), what)
        found = r.byte()
        if found != height:
            raise ValueError(f"{what}: a node of height {found} where its parent says {height}")
        table = _data_file_table(r, base)
        n = r.varint()
        kp, ks = _keys(r, n)
        if height > 0:
            common = r.varints(n)
            keys = _join_keys(r, kp, ks)
            fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            for i in range(n):
                self._walk(table, fids[i], offsets[i], lengths[i], height - 1, prefix + keys[i][:common[i]])
            return
        keys = _join_keys(r, kp, ks)
        sizes = r.varints(n)
        kinds = [r.byte() for _ in range(n)]
        if any(k > 1 for k in kinds):
            raise ValueError(f"{what}: value kind {max(kinds)}; this reader knows 0 (inline) and 1 (in a data file)")
        indirect = [i for i in range(n) if kinds[i] == 1]
        vfids, voffsets = r.varints(len(indirect)), r.varints(len(indirect))
        where = dict(zip(indirect, zip(vfids, voffsets)))
        for i in range(n):
            key = (prefix + keys[i]).decode()
            if i in where:
                vfid, voffset = where[i]
                if vfid >= len(table):
                    raise ValueError(f"{what}: a value refers to data file {vfid} of {len(table)}")
                self.items[key] = (table[vfid][1], voffset, sizes[i])
            else:
                self.items[key] = r.take(sizes[i])

    # -- keys --

    def get(self, key: str) -> Optional[bytes]:
        """The value of ``key``, or None where the store has no such key."""
        if self.items is None:
            return self.read(key) if self._file(key).is_file() else None
        value = self.items.get(key)
        if value is None or isinstance(value, bytes):
            return value
        return self.read(*value)


# ---------------------------------------------------------------------------
# zarr v2
# ---------------------------------------------------------------------------


def _dtype(name, what: str) -> np.dtype:
    if name == "bfloat16":
        return np.dtype("<u2")
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"{what}: zarr dtype {name!r} is not supported") from None
    if dt.kind not in "biuf" or dt.fields is not None:
        raise ValueError(f"{what}: zarr dtype {name!r} is not supported (fixed-width numbers and bool only)")
    return dt


def _fill(value, name: str, what: str):
    """zarr's fill_value as a value of the array's dtype (bfloat16: its bits)."""
    if value is None:
        return 0
    if isinstance(value, str):
        if value not in _SPECIAL or not (name == "bfloat16" or np.dtype(name).kind == "f"):
            raise ValueError(f"{what}: fill_value {value!r} for dtype {name}")
        value = _SPECIAL[value]
    if name == "bfloat16":
        return int(np.array(value, np.float32).view(np.uint32)) >> 16
    return value


_SPECIAL = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


def _read_array(get: Callable[[str], Optional[bytes]], name: str):
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise ValueError(f"the checkpoint has no array {name!r} (no {name}/.zarray)")
    meta = json.loads(raw)
    what = f"array {name!r}"
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{what}: zarr_format {meta.get('zarr_format')}; this reader knows zarr v2")
    if meta.get("filters"):
        raise ValueError(f"{what}: zarr filters {meta['filters']} are not supported")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{what}: zarr compressor {compressor.get('id')!r}; this reader knows zstd and none")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{what}: zarr order {order!r}")
    dt = _dtype(meta["dtype"], what)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape):
        raise ValueError(f"{what}: chunks {list(chunks)} for shape {list(shape)}")
    sep = meta.get("dimension_separator", ".")
    fill = _fill(meta.get("fill_value"), meta["dtype"], what)
    out = np.empty(shape, dtype=dt.newbyteorder("="))
    chunk_bytes = math.prod(chunks) * dt.itemsize
    grid = [range(-(-s // c)) if c else range(0) for s, c in zip(shape, chunks)]
    # one chunk in the array's own layout (as orbax writes every array):
    # decompressed straight into the result, no copy of it on the way
    whole = chunks == shape and dt.isnative and (order == "C" or len(shape) <= 1)
    if not whole:
        out.fill(fill)
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = get(key)
        if data is None:  # an absent chunk holds the fill value
            if whole:
                out.fill(fill)
            continue
        if len(data) != chunk_bytes and compressor is None:
            raise ValueError(f"{what}: chunk {key} holds {len(data)} bytes, want {chunk_bytes}")
        if compressor is not None:
            dst = out.reshape(-1).view(np.uint8) if whole else np.empty(chunk_bytes, np.uint8)
            data = zstd_decompress_into(data, dst, f"{what}, chunk {key}")
        if whole:
            if compressor is None:
                out.reshape(-1).view(np.uint8)[:] = np.frombuffer(data, np.uint8)
            continue
        block = np.frombuffer(data, dt).reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

_SEQUENCE, _DICT = 1, 2
_EMPTY = {"None": None, "Dict": dict, "List": list}


def _set(tree: dict, keys: List[Tuple[str, int]], value, what: str) -> None:
    """Put ``value`` at ``keys`` (each (key, key_type)), making the dicts
    and lists on the way; a list's items are placed by index."""
    node = tree
    for (key, kind), (_, next_kind) in zip(keys, keys[1:] + [(None, None)]):
        slot = int(key) if kind == _SEQUENCE else key
        if kind not in (_SEQUENCE, _DICT):
            raise ValueError(f"{what}: key_type {kind}; this reader knows 1 (sequence) and 2 (dict)")
        if next_kind is None:
            child = value
        else:
            child = node.get(slot)
            if child is None:
                child = _Seq() if next_kind == _SEQUENCE else {}
        node[slot] = child
        node = child


class _Seq(dict):
    """A list being filled by index; ``_finish`` makes it a list."""


def _finish(node):
    if isinstance(node, _Seq):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"a sequence in the tree has indices {sorted(node)}")
        return [_finish(node[i]) for i in range(len(node))]
    if isinstance(node, dict):  # keys sorted, as a JAX tree flattens a dict
        return {k: _finish(node[k]) for k in sorted(node)}
    return node


def is_orbax_dir(path) -> bool:
    """Whether ``path`` is an orbax checkpoint directory (it holds ``_METADATA``)."""
    p = Path(path)
    return p.is_dir() and (p / "_METADATA").is_file()


def read_orbax(path) -> dict:
    """The tree an orbax ``StandardCheckpointer`` saved at ``path``, as
    ``StandardCheckpointer().restore(path)`` gives it: nested dicts and
    lists of numpy arrays (bfloat16 ones as ``torch.bfloat16`` tensors),
    Python scalars, and None, {} or [] for the nodes orbax skips."""
    root = Path(path)
    if not root.is_dir():
        raise ValueError(f"{root} is not a directory; an orbax checkpoint is one")
    if not (root / "_METADATA").is_file():
        raise ValueError(f"{root} holds no _METADATA, so it is not an orbax checkpoint of a tree "
                         f"(found {sorted(p.name for p in root.iterdir())})")
    meta = json.loads((root / "_METADATA").read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{root}: use_zarr3 is set; this reader knows zarr v2 arrays only")
    if "tree_metadata" not in meta:
        raise ValueError(f"{root}/_METADATA has no tree_metadata (keys {sorted(meta)})")
    ocdbt = meta.get("use_ocdbt")
    if ocdbt is None:
        ocdbt = (root / "manifest.ocdbt").is_file() or any(root.glob("ocdbt.process_*"))
    store = _Store(root, bool(ocdbt))
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        what = f"{root}: leaf {'.'.join(k for k, _ in keys)}"
        vm = entry["value_metadata"]
        if vm.get("skip_deserialize"):
            if vm["value_type"] not in _EMPTY:
                raise ValueError(f"{what}: a skipped value of type {vm['value_type']!r}")
            empty = _EMPTY[vm["value_type"]]
            value = empty() if empty is not None else None
        else:
            value = _read_array(store.get, ".".join(k for k, _ in keys))
            if vm["value_type"] == "scalar":
                value = value.item()
        _set(tree, keys, value, what)
    return _finish(tree)
