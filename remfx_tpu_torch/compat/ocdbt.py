"""Reader of the JAX package's orbax checkpoints, without JAX.

The port's counterpart of ``ocp.StandardCheckpointer().restore(path)``
with no template (``remfx_tpu/train/checkpoint.py:restore_tree``): the
checkpoint directory's raw tree, nested dicts (lists where orbax recorded
sequence keys) of numpy arrays, ``None`` where orbax saved ``None``.
Written with numpy, ``json``, ``struct`` and ``ctypes`` only, so that a
machine without JAX, orbax or tensorstore reads the vendored ``ckpts/``.

What is on disk (orbax with ``use_ocdbt``, zarr v2):

* ``_METADATA``: JSON; ``tree_metadata`` maps each tree path to its keys
  (``key_metadata``: the key and its type, 1 for a sequence index and 2
  for a dict key) and its value type (``np.ndarray``, or ``None``). The
  path's keys joined by ``.`` name its zarr array in the key-value store.
* The key-value store is tensorstore's OCDBT: a manifest
  (``manifest.ocdbt``) that lists versions, each with the location of the
  root of a B-tree whose leaves hold each key's value inline or as
  (data file, offset, length). The checkpoint directory's own manifest
  is read; its nodes reference the data files of ``ocdbt.process_0/``.
  Manifests and nodes start with a magic number, their length (u64 LE),
  a format version and a compression (1: zstd) as varints; the body
  follows, then a CRC-32C of all that precedes it (u32 LE).
* Each array is a zarr v2 array: ``<name>/.zarray`` (JSON: shape,
  chunks, dtype, order, compressor, fill value) and one value per chunk
  (``<name>/0.0.0``), a zstd frame of the chunk's bytes.

Params are stored as bfloat16, which numpy lacks: such an array comes
back as its raw ``uint16`` bits, viewed as ``Bfloat16Bits``;
``upcast_bfloat16`` makes it float32, exactly (the bits shifted into the
high half of a float32).

zstd is inflated through ``ctypes`` on the system ``libzstd``. Every
fault raises: no ``libzstd``, a missing file, a bad magic number, length
or checksum, a value out of its file's bounds, a chunk of the wrong size.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import struct
from pathlib import Path

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_HEADER = struct.Struct(">IQ")  # magic (big endian), then the length (LE)


class Bfloat16Bits(np.ndarray):
    """The raw ``uint16`` bits of a bfloat16 array."""


def upcast_bfloat16(a: np.ndarray) -> np.ndarray:
    """bfloat16 bits -> float32 (exact); any other array unchanged."""
    if not isinstance(a, Bfloat16Bits):
        return a
    bits = np.asarray(a).view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


# ------------------------------------------------------------------ zstd

class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


_zstd = None


def libzstd() -> ctypes.CDLL:
    """The system libzstd, loaded once; raises OSError naming it if absent."""
    global _zstd
    if _zstd is not None:
        return _zstd
    names = ["libzstd.so.1", ctypes.util.find_library("zstd")]
    errors = []
    for name in filter(None, names):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError as e:
            errors.append(f"{name}: {e}")
    else:
        raise OSError("cannot load the system libzstd, which reads the orbax "
                      f"checkpoints' zstd frames: {errors or 'not found'}")
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_decompress.argtypes = [vp, size_t, vp, size_t]
    lib.ZSTD_decompress.restype = size_t
    lib.ZSTD_isError.argtypes = [size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getErrorName.argtypes = [size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_createDCtx.argtypes = []
    lib.ZSTD_createDCtx.restype = vp
    lib.ZSTD_freeDCtx.argtypes = [vp]
    lib.ZSTD_freeDCtx.restype = size_t
    lib.ZSTD_decompressStream.argtypes = [
        vp, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)]
    lib.ZSTD_decompressStream.restype = size_t
    _zstd = lib
    return lib


def _zstd_check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def inflate(src: bytes, size: int | None = None) -> bytes:
    """The bytes of the zstd frame(s) ``src``. With ``size``, the output
    must be exactly that long; without, it is read by streaming (the
    frames here need not record their content size)."""
    lib = libzstd()
    if size is not None:
        out = ctypes.create_string_buffer(max(size, 1))
        n = _zstd_check(lib, lib.ZSTD_decompress(out, size, src, len(src)),
                        "decompress")
        if n != size:
            raise ValueError(f"zstd: frame holds {n} bytes, expected {size}")
        return out.raw[:size]
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("ZSTD_createDCtx failed")
    try:
        keep = ctypes.create_string_buffer(src, len(src))
        inb = _InBuffer(ctypes.cast(keep, ctypes.c_void_p), len(src), 0)
        step = 1 << 20
        chunks = []
        while True:
            out = ctypes.create_string_buffer(step)
            outb = _OutBuffer(ctypes.cast(out, ctypes.c_void_p), step, 0)
            left = _zstd_check(lib, lib.ZSTD_decompressStream(
                dctx, ctypes.byref(outb), ctypes.byref(inb)), "stream")
            chunks.append(out.raw[:outb.pos])
            if inb.pos == inb.size and left == 0:
                return b"".join(chunks)
            if inb.pos == inb.size and outb.pos < step:
                raise ValueError("zstd: frame is truncated")
    finally:
        lib.ZSTD_freeDCtx(dctx)


# ------------------------------------------------------------- CRC-32C

def _crc_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(0x82F63B78), table >> 1)
    return table.astype(np.uint32)


_CRC_TABLE = [int(v) for v in _crc_table()]


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -------------------------------------------------------------- decoding

class _Reader:
    """Cursor over a decoded body: varints, fixed-width ints and bytes."""

    def __init__(self, data: bytes, what: str):
        self.data = data
        self.pos = 0
        self.what = what

    def _need(self, n: int):
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated at byte {self.pos}")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def fixed(self, fmt: str) -> int:
        size = struct.calcsize(fmt)
        self._need(size)
        (v,) = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += size
        return v

    def take(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def end(self):
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} "
                             "bytes left over")


def _unwrap(raw: bytes, magic: int, what: str) -> _Reader:
    """Header, CRC and compression of a manifest or node -> its body."""
    if len(raw) < _HEADER.size + 4:
        raise ValueError(f"{what}: {len(raw)} bytes is too short")
    got_magic, = struct.unpack_from(">I", raw, 0)
    if got_magic != magic:
        raise ValueError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    length, = struct.unpack_from("<Q", raw, 4)
    if length != len(raw):
        raise ValueError(f"{what}: header says {length} bytes, found {len(raw)}")
    crc, = struct.unpack_from("<I", raw, len(raw) - 4)
    if crc32c(raw[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch")
    head = _Reader(raw[:-4], what)
    head.pos = _HEADER.size
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}")
    compression = head.varint()
    body = raw[head.pos:-4]
    if compression == 1:
        body = inflate(body)
    elif compression != 0:
        raise ValueError(f"{what}: unknown compression {compression}")
    return _Reader(body, what)


def _data_files(r: _Reader, base: str) -> list[tuple[str, str]]:
    """A data file table -> [(full path, base path)], each relative to the
    database root; ``base`` (the base path of the node that holds the
    table) prefixes both."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        path = prev[:prefix[i]] + r.take(suffix[i])
        prev = path
        s = path.decode()
        files.append((base + s, base + s[:base_len[i]]))
    return files


def _key_lengths(r: _Reader, n: int) -> tuple[list[int], list[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    return prefix, suffix


def _key_bytes(r: _Reader, prefix, suffix) -> list[bytes]:
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        key = prev[:p] + r.take(s)
        keys.append(key)
        prev = key
    return keys


class OcdbtStore:
    """The keys and values of an OCDBT database directory, read-only."""

    def __init__(self, root):
        self.root = Path(root)
        manifest = self.root / "manifest.ocdbt"
        if not manifest.is_file():
            raise FileNotFoundError(f"no OCDBT manifest at {manifest}")
        r = _unwrap(manifest.read_bytes(), MANIFEST_MAGIC, str(manifest))
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{manifest}: manifest kind {kind} (numbered "
                             "manifests are not read)")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()  # version_tree_arity_log2
        if r.varint() == 1:  # node compression: zstd, then its level
            r.fixed("<i")
        files = _data_files(r, "")
        n = r.varint()
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics: keys, tree bytes, indirect bytes
        for _ in range(n):
            r.fixed("<Q")  # commit time (ns)
        # references to the version tree nodes of older generations:
        # generation, file, offset, length, generations, commit time, height
        m = r.varint()
        r.varints(5 * m)
        for _ in range(m):
            r.fixed("<Q")
        r.take(m)
        r.end()
        if n == 0:
            raise ValueError(f"{manifest}: no version")
        last = int(np.argmax(generation))
        self._files = {}
        self.entries: dict[bytes, tuple] = {}
        self._read_node(files[file_id[last]], offset[last], length[last],
                        height[last], b"")

    def _bytes(self, path: str, offset: int, length: int) -> bytes:
        full = self.root / path
        f = self._files.get(path)
        if f is None:
            if not full.is_file():
                raise FileNotFoundError(f"OCDBT data file missing: {full}")
            f = self._files[path] = full.read_bytes()
        if offset + length > len(f):
            raise ValueError(f"{full}: bytes [{offset}, {offset + length}) "
                             f"beyond its {len(f)} bytes")
        return f[offset:offset + length]

    def _read_node(self, file, offset, length, height, prefix: bytes):
        path, base = file
        what = f"{self.root / path}@{offset}"
        r = _unwrap(self._bytes(path, offset, length), NODE_MAGIC, what)
        got = r.byte()
        if got != height:
            raise ValueError(f"{what}: node height {got}, expected {height}")
        files = _data_files(r, base)
        n = r.varint()
        if height == 0:
            kp, ks = _key_lengths(r, n)
            keys = _key_bytes(r, kp, ks)
            sizes = r.varints(n)
            kinds = r.varints(n)
            indirect = [i for i, k in enumerate(kinds) if k == 1]
            ids = r.varints(len(indirect))
            offs = r.varints(len(indirect))
            where = dict(zip(indirect, zip(ids, offs)))
            for i, key in enumerate(keys):
                if kinds[i] == 0:
                    self.entries[prefix + key] = ("inline", r.take(sizes[i]))
                elif kinds[i] == 1:
                    fid, off = where[i]
                    self.entries[prefix + key] = ("file", files[fid][0], off,
                                                  sizes[i])
                else:
                    raise ValueError(f"{what}: value kind {kinds[i]}")
            r.end()
            return
        kp, ks = _key_lengths(r, n)
        common = r.varints(n)
        keys = _key_bytes(r, kp, ks)
        ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics of each subtree
        r.end()
        for i in range(n):
            self._read_node(files[ids[i]], offs[i], lens[i], height - 1,
                            prefix + keys[i][:common[i]])

    def get(self, key: str) -> bytes | None:
        """The value of ``key``, or None where the store has no such key."""
        entry = self.entries.get(key.encode())
        if entry is None:
            return None
        if entry[0] == "inline":
            return entry[1]
        return self._bytes(*entry[1:])


# ------------------------------------------------------------------- zarr

def _zarr_dtype(name: str) -> tuple[np.dtype, bool]:
    """-> (numpy dtype of the stored bytes, whether it is bfloat16)."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    return np.dtype(name), False


def read_zarr(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"{store.root}: no zarr array {name!r}")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor} is not read")
    dtype, bf16 = _zarr_dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    out = np.zeros(shape, dtype)
    if fill is not None:  # a number, or "NaN" / "Infinity" / "-Infinity"
        if bf16:  # round the float32 to the nearest bfloat16, ties to even
            u = int(np.array(fill, np.float32).view(np.uint32))
            out[...] = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
        else:
            out[...] = np.array(fill, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in np.ndindex(*grid) if shape else [()]:
        key = sep.join(map(str, idx)) if shape else "0"
        value = store.get(f"{name}/{key}")
        if value is None:
            continue  # a chunk equal to the fill value is not stored
        if compressor is not None:
            value = inflate(value, chunk_bytes)
        elif len(value) != chunk_bytes:
            raise ValueError(f"{name}/{key}: {len(value)} bytes, expected "
                             f"{chunk_bytes}")
        block = np.frombuffer(value, dtype).reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, x.stop - x.start) for x in sl)]
    return out.view(Bfloat16Bits) if bf16 else out


# ------------------------------------------------------------------- tree

def restore_tree(path) -> dict:
    """The raw tree of the orbax checkpoint directory ``path``, as
    ``StandardCheckpointer().restore(path)`` gives it with no template."""
    d = Path(path)
    meta_file = d / "_METADATA"
    if not meta_file.is_file():
        raise FileNotFoundError(f"not an orbax checkpoint (no _METADATA): {d}")
    meta = json.loads(meta_file.read_text())
    if not meta.get("use_ocdbt", True) or meta.get("use_zarr3"):
        raise ValueError(f"{d}: only OCDBT with zarr v2 is read")
    store = OcdbtStore(d)
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k["key"], {})
        vtype = entry["value_metadata"]["value_type"]
        if vtype == "None":
            value = None
        elif vtype in ("np.ndarray", "jax.Array"):
            value = read_zarr(store, ".".join(str(k["key"]) for k in keys))
        else:
            raise ValueError(f"{d}: value type {vtype!r} is not read")
        node[keys[-1]["key"]] = value
    return _sequences(root, meta["tree_metadata"])


def _sequences(root: dict, tree_metadata: dict):
    """Turn each dict whose keys orbax recorded as sequence indices into a
    list, ordered by index."""
    seq_paths = set()
    for entry in tree_metadata.values():
        keys = entry["key_metadata"]
        for i, k in enumerate(keys):
            if k["key_type"] == 1:
                seq_paths.add(tuple(x["key"] for x in keys[:i]))

    def convert(node, path):
        if not isinstance(node, dict):
            return node
        out = {k: convert(v, path + (k,)) for k, v in node.items()}
        if path in seq_paths:
            return [out[k] for k in sorted(out, key=int)]
        return out

    return convert(root, ())
