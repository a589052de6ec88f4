"""The JAX package's orbax checkpoints, read without orbax or tensorstore.

orbax's StandardCheckpointer writes a pytree as a tensorstore OCDBT
key-value store holding one zarr v2 array per leaf. Three layers here:

  OcdbtStore(root)   the OCDBT store on the local file system: its files
                     (manifest.ocdbt, d/<id>, and under orbax the
                     per-process stores ocdbt.process_N/ that the root's
                     B+tree refers into) each framed as magic (4 bytes,
                     big-endian), total length (8, little-endian),
                     format version and compression (varints; 1 = one
                     zstd frame), body, CRC-32C of all bytes before it
                     (checked). The manifest's config and its newest
                     version (a single manifest, as orbax writes), the
                     B+tree
                     from that version's root down: interior entries with
                     their keys and subtree common prefixes, leaf entries
                     with inline values or indirect references into data
                     files. list() and read(key).
  read_zarr(store, name)
                     a zarr v2 array: .zarray (C order; the dtypes
                     tensorstore names <f4, <f2, <f8, bfloat16, <i1..<i8,
                     <u1..<u8 and |b1, any byte order numpy reads;
                     bfloat16 comes back as the float32 values it denotes);
                     chunks, the edge ones cut to the array, a missing one
                     as the fill value (0 for null); the zstd compressor
                     or none, each chunk decoded straight into the array's
                     buffer (ops/kernels/zstd.py, C on the host).
  read_pytree(path)  an orbax checkpoint directory: _METADATA's tree (the
                     key path of each leaf, None leaves skipped) read as
                     {"/".join(key path): array}, the flat names the
                     port's checkpoints use. A directory without
                     _METADATA gives every array the store holds, its
                     dotted name split at the dots.

Anything else (a numbered manifest, orbax without OCDBT, zarr v3,
filters, F order, another compressor, dtype or format version) raises
OrbaxError naming what it met.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..ops.kernels import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MISSING = (1 << 64) - 1  # the offset and length of an empty tree's root
_ZARR_DTYPES = {"bfloat16": np.dtype("<u2")}


class OrbaxError(ValueError):
    """The directory is not an orbax checkpoint the port reads."""


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OrbaxError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise OrbaxError(f"{self.what}: bad varint")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def unframe(data: bytes, magic: int, what: str) -> bytes:
    """The body of one OCDBT file or node, its length and CRC-32C
    checked and its zstd frame decoded."""
    if len(data) < 18:
        raise OrbaxError(f"{what}: truncated ({len(data)} bytes)")
    got = int.from_bytes(data[:4], "big")
    if got != magic:
        raise OrbaxError(f"{what}: magic 0x{got:08x}, expected "
                         f"0x{magic:08x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise OrbaxError(f"{what}: {len(data)} bytes, its header says "
                         f"{length}")
    if zstd.crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        raise OrbaxError(f"{what}: CRC-32C mismatch")
    r = _Reader(data[:-4], what)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OrbaxError(f"{what}: format version {version}")
    body = data[r.pos:-4]
    if compression == 1:
        return zstd.decompress(body)
    if compression != 0:
        raise OrbaxError(f"{what}: compression method {compression}")
    return body


def _data_files(r: _Reader) -> List[str]:
    """A data file table: each file's path relative to the store's root
    (its base path and relative path together), prefix-coded."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OrbaxError(f"{r.what}: bad data file table")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        if base[i] > len(prev):
            raise OrbaxError(f"{r.what}: bad data file table")
        paths.append(prev.decode())
    return paths


def _keys(r: _Reader, n: int, interior: bool
          ) -> Tuple[List[bytes], List[int]]:
    """A node's keys (each prefix-coded against the one before) and, in
    an interior node, the length of each child's common key prefix; the
    lengths all come before the key bytes."""
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OrbaxError(f"{r.what}: bad key prefix")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    return keys, common


class OcdbtStore:
    """An OCDBT store's newest version, read from the file system."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, "manifest.ocdbt")
        with open(path, "rb") as f:
            r = _Reader(unframe(f.read(), MANIFEST_MAGIC, path), path)
        r.take(16)  # uuid
        kind = r.varint()
        r.varints(2)  # max inline value bytes, max decoded node bytes
        r.u8()        # version tree arity (log2)
        if r.varint() == 1:
            r.take(4)  # zstd level
        if kind != 0:  # 1: numbered manifests, which orbax does not write
            raise OrbaxError(f"{path}: manifest kind {kind}")
        root = self._newest_root(r)
        self._items = dict(self._walk(root)) if root else {}

    @staticmethod
    def _newest_root(r: _Reader) -> Optional[Tuple[str, int, int]]:
        """(data file, offset, length) of the newest version's root node;
        None for an empty store."""
        files = _data_files(r)
        n = r.varint()
        if n == 0:
            return None
        r.varints(n)  # generation numbers
        r.take(n)     # root heights
        fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        # (statistics, commit times and the version tree's older nodes
        # follow; the newest version is the last inline one)
        if offsets[-1] == MISSING:
            return None
        if fids[-1] >= len(files):
            raise OrbaxError(f"{r.what}: bad data file id")
        return files[fids[-1]], offsets[-1], lengths[-1]

    def _read_range(self, rel: str, offset: int, length: int) -> bytes:
        path = os.path.join(self.root, rel)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise OrbaxError(f"{path}: {length} bytes at {offset} run past "
                             f"its end")
        return data

    def _node(self, rel: str, offset: int, length: int):
        what = f"{os.path.join(self.root, rel)}@{offset}"
        r = _Reader(unframe(self._read_range(rel, offset, length),
                            NODE_MAGIC, what), what)
        height = r.u8()
        files = _data_files(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)

        def ref(i):
            if fids[i] >= len(files):
                raise OrbaxError(f"{what}: bad data file id")
            return files[fids[i]], offsets[i]

        if height:
            fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            return height, [(keys[i], common[i], *ref(i), lengths[i])
                            for i in range(n)]
        lengths = r.varints(n)
        kinds = [r.u8() for _ in range(n)]
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k > 1 for k in kinds):
            raise OrbaxError(f"{what}: value kind {max(kinds)}")
        fids = dict(zip(indirect, r.varints(len(indirect))))
        offsets = dict(zip(indirect, r.varints(len(indirect))))
        out = []
        for i in range(n):
            if kinds[i]:
                out.append((keys[i], ("ref", *ref(i), lengths[i])))
            else:
                out.append((keys[i], ("inline", r.take(lengths[i]))))
        return 0, out

    def _walk(self, root) -> Iterator[Tuple[bytes, tuple]]:
        """Every leaf entry under `root`, each key with the prefixes the
        interior nodes above it strip."""
        stack = [(b"", root)]
        while stack:
            prefix, (rel, offset, length) = stack.pop()
            height, entries = self._node(rel, offset, length)
            if height == 0:
                for key, value in entries:
                    yield prefix + key, value
                continue
            for key, common, crel, coff, clen in reversed(entries):
                stack.append((prefix + key[:common], (crel, coff, clen)))

    def list(self) -> List[bytes]:
        """Every key, sorted."""
        return sorted(self._items)

    def read(self, key) -> Optional[bytes]:
        """A key's value; None where the store does not hold it."""
        key = key.encode() if isinstance(key, str) else key
        value = self._items.get(key)
        if value is None:
            return None
        if value[0] == "inline":
            return value[1]
        return self._read_range(*value[1:])


def _zarr_dtype(name: str) -> np.dtype:
    if name in _ZARR_DTYPES:
        return _ZARR_DTYPES[name]
    try:
        dt = np.dtype(name)
    except TypeError:
        raise OrbaxError(f"zarr dtype {name!r}") from None
    if dt.kind not in "biuf" or dt.fields is not None:
        raise OrbaxError(f"zarr dtype {name!r}")
    return dt


def read_zarr(store, name: str) -> np.ndarray:
    """The zarr v2 array `name` of a store."""
    raw = store.read(f"{name}/.zarray")
    if raw is None:
        raise OrbaxError(f"{name}: no .zarray in the store")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise OrbaxError(f"{name}: zarr format {meta.get('zarr_format')}")
    if meta.get("order", "C") != "C":
        raise OrbaxError(f"{name}: order {meta['order']!r}")
    if meta.get("filters"):
        raise OrbaxError(f"{name}: filters {meta['filters']}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxError(f"{name}: compressor {comp.get('id')!r}")
    dtype = _zarr_dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise OrbaxError(f"{name}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value") or 0
    fill_value = np.asarray(float(fill) if isinstance(fill, str) else fill)
    if meta["dtype"] == "bfloat16":  # its bits, rounded to nearest even
        bits = int(fill_value.astype(np.float32).view(np.uint32))
        fill_value = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    out = np.empty(shape, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    whole = tuple(chunks) == shape
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = store.read(key)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        if data is None:
            out[sl] = fill_value
            continue
        target = out if whole else np.empty(chunks, dtype)
        if comp is None:
            if len(data) != target.nbytes:
                raise OrbaxError(f"{key}: {len(data)} bytes, expected "
                                 f"{target.nbytes}")
            target.reshape(-1).view(np.uint8)[:] = np.frombuffer(data,
                                                                 np.uint8)
        else:
            try:
                zstd.decompress_into(data, target)
            except zstd.ZstdError as e:
                raise OrbaxError(f"{key}: {e}") from None
        if not whole:
            out[sl] = target[tuple(slice(0, e.stop - e.start) for e in sl)]
    if meta["dtype"] == "bfloat16":
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out if out.dtype.isnative else out.astype(out.dtype.newbyteorder())


def is_orbax_dir(path: str) -> bool:
    """Whether `path` is an orbax checkpoint directory (its _METADATA or
    an OCDBT manifest); read_pytree raises for one it does not read."""
    return os.path.isfile(os.path.join(path, "_METADATA")) or \
        os.path.isfile(os.path.join(path, "manifest.ocdbt"))


def read_pytree(path: str) -> Dict[str, np.ndarray]:
    """An orbax checkpoint directory as {"/".join(key path): array}."""
    path = os.path.abspath(path)
    if not is_orbax_dir(path):
        raise OrbaxError(f"{path}: not an orbax checkpoint (no _METADATA "
                         f"or manifest.ocdbt)")
    names = None
    meta_path = os.path.join(path, "_METADATA")
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("use_zarr3"):
            raise OrbaxError(f"{path}: zarr v3 arrays (use_zarr3)")
        names = []
        for entry in meta.get("tree_metadata", {}).values():
            keys = [str(k["key"]) for k in entry["key_metadata"]]
            vtype = entry.get("value_metadata", {}).get("value_type")
            if vtype == "None" or entry.get("value_metadata", {}).get(
                    "skip_deserialize"):
                continue
            names.append(keys)
    if not os.path.isfile(os.path.join(path, "manifest.ocdbt")):
        raise OrbaxError(f"{path}: no manifest.ocdbt (orbax without OCDBT)")
    store = OcdbtStore(path)
    if names is None:
        names = [k.decode()[:-len("/.zarray")].split(".")
                 for k in store.list() if k.endswith(b"/.zarray")]
    return {"/".join(keys): read_zarr(store, ".".join(keys))
            for keys in names}
