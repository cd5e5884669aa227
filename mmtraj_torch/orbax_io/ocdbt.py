"""A read-only OCDBT key-value store: tensorstore's on-disk B-tree, in which
Orbax keeps a checkpoint's arrays.

A store is a directory with a manifest (``manifest.ocdbt``) and data files
(``d/<id>``).  Every manifest and node file has one frame: a big-endian u32
magic, a little-endian u64 holding the frame's whole length, a varint
version (0), a varint compression (0 none, 1 zstd), the body and a
little-endian CRC-32C of all the bytes before it.  Inside a body, integers
are varints unless said otherwise, and a node stores each field for all of
its entries together, one column after another.

* The manifest: the config (16-byte uuid, manifest kind, largest inline
  value, largest decoded node, version tree arity as log2 in one byte,
  compression and, for zstd, its level as a little-endian i32), a data file
  table, the newest versions inline and references to version tree nodes.
  A ``numbered`` manifest keeps only the config; the newest
  ``manifest.<016x generation>`` beside it holds the rest.
* A data file table: the number of files, for each file after the first the
  length of the prefix it shares with the file before it, for each file the
  length of the rest and the length of its base path, then the rests' bytes.
  A file's path is the base path of the file that holds the table followed
  by its own path, and its base path is that prefix of it; so a merged
  store's top-level root reaches ``ocdbt.process_0/d/...``.
* A version: generation, root height (one byte), root location (file,
  offset, length; offset and length 2**64 - 1 for an empty tree), the
  tree's key count, node bytes and indirect value bytes, commit time (u64).
* A version tree node: arity log2 and height (one byte each), a data file
  table, then versions (height 0) or references to child nodes (generation,
  location, generation count, commit time; the manifest's also a height).
* A B-tree node: height (one byte), a data file table, the entries' keys
  compressed by the prefix shared with the key before, relative to the
  prefix the node inherits; a leaf then has each value's length and kind
  (0 inline, 1 in a data file; file and offset of those in data files) and
  the inline values' bytes, an interior node for each child the length of
  the prefix its subtree shares with its key, its location and statistics.

``OcdbtReader(dir)`` reads the manifest and the whole B-tree of the newest
version when it opens (a checkpoint's tree is small), and the value bytes
in data files when asked for them.  A frame whose magic, length, checksum
or layout is wrong raises ``ValueError`` naming its file.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

from mmtraj_torch.orbax_io import zstd
from mmtraj_torch.orbax_io.crc32c import verify_footer

MANIFEST_MAGIC = 0x0CDB3A2A
VERSION_NODE_MAGIC = 0x0CDB1234
BTREE_NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
_NUMBERED = re.compile(r"manifest\.[0-9a-f]{16}")
_NONE = (1 << 64) - 1  # the offset and length of an empty tree's root


class _Reader:
    """Reads the fields of a decoded body; running past its end raises."""

    __slots__ = ("data", "pos", "name")

    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 0, name

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.name}: truncated (needs {n} bytes at {self.pos} of "
                             f"{len(self.data)})")

    def varint(self) -> int:
        value = shift = 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.name}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def fixed(self, n: int, signed: bool = False) -> int:
        return int.from_bytes(self.raw(n), "little", signed=signed)

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.name}: {len(self.data) - self.pos} bytes after the last field")


def decode_frame(data: bytes, magic: int, name: str) -> bytes:
    """The body of a manifest or node frame, checked and decompressed."""
    if len(data) < 18:
        raise ValueError(f"{name}: {len(data)} bytes is too short for an OCDBT frame")
    got = int.from_bytes(data[:4], "big")
    if got != magic:
        raise ValueError(f"{name}: magic 0x{got:08x}, expected 0x{magic:08x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise ValueError(f"{name}: frame says {length} bytes, holds {len(data)}")
    verify_footer(data, name)
    head = _Reader(data[12:-4], name)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{name}: format version {version}")
    body = data[12 + head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        try:
            return zstd.decompress(body)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from e
    raise ValueError(f"{name}: unknown compression {compression}")


class Config(NamedTuple):
    uuid: bytes
    manifest_kind: int  # 0 single, 1 numbered
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: Optional[Tuple[str, int]]  # None or ("zstd", level)


class Location(NamedTuple):
    path: str  # relative to the store's directory
    base: str  # the base path the nodes stored in ``path`` resolve their files against
    offset: int
    length: int


class Version(NamedTuple):
    generation: int
    root_height: int
    root: Optional[Location]  # None: an empty tree
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int
    commit_time: int


class _VersionRef(NamedTuple):
    generation: int
    location: Location
    num_generations: int
    commit_time: int
    height: int


Value = Union[bytes, Location]


def _config(r: _Reader) -> Config:
    uuid, kind = r.raw(16), r.varint()
    max_inline, max_node, arity = r.varint(), r.varint(), r.byte()
    method = r.varint()
    if kind not in (0, 1):
        raise ValueError(f"{r.name}: unknown manifest kind {kind}")
    if method == 0:
        compression = None
    elif method == 1:
        compression = ("zstd", r.fixed(4, signed=True))
    else:
        raise ValueError(f"{r.name}: unknown compression method {method}")
    return Config(uuid, kind, max_inline, max_node, arity, compression)


def _data_files(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """A data file table: (path, base path) of each file, both relative to
    the store's directory."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix, base_len = r.varints(n), r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.name}: data file {i} shares {prefix[i]} bytes of a "
                             f"{len(prev)}-byte path")
        full = prev[:prefix[i]] + r.raw(suffix[i])
        if base_len[i] > len(full):
            raise ValueError(f"{r.name}: data file {i} has a base path longer than its path")
        files.append((base + full.decode(), base + full[:base_len[i]].decode()))
        prev = full
    return files


def _locations(r: _Reader, files, n: int) -> List[Optional[Location]]:
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    out = []
    for i, off, length in zip(ids, offsets, lengths):
        if off == _NONE and length == _NONE:
            out.append(None)
            continue
        if i >= len(files):
            raise ValueError(f"{r.name}: data file {i} of {len(files)}")
        out.append(Location(files[i][0], files[i][1], off, length))
    return out


def _versions(r: _Reader, files) -> List[Version]:
    n = r.varint()
    gens = r.varints(n)
    heights = [r.byte() for _ in range(n)]
    roots = _locations(r, files, n)
    keys, tree_bytes, indirect = r.varints(n), r.varints(n), r.varints(n)
    times = [r.fixed(8) for _ in range(n)]
    return [Version(*v) for v in zip(gens, heights, roots, keys, tree_bytes, indirect, times)]


def _version_refs(r: _Reader, files, height: Optional[int]) -> List[_VersionRef]:
    """References to version tree nodes: the manifest's carry their heights
    (``height`` None), an interior node's children are one below it."""
    n = r.varint()
    gens = r.varints(n)
    locs = _locations(r, files, n)
    counts = r.varints(n)
    times = [r.fixed(8) for _ in range(n)]
    heights = [r.byte() for _ in range(n)] if height is None else [height - 1] * n
    if any(loc is None for loc in locs):
        raise ValueError(f"{r.name}: a version tree reference without a location")
    return [_VersionRef(*v) for v in zip(gens, locs, counts, times, heights)]


class OcdbtReader:
    """The newest version of the OCDBT store in ``directory``: ``keys()``,
    ``read(key)`` and ``get(key)`` (None where ``read`` raises ``KeyError``).
    Keys are bytes; a ``str`` key is taken as its UTF-8 bytes."""

    def __init__(self, directory: str):
        self.directory = directory
        self._files: Dict[str, bytes] = {}
        r = self._manifest(MANIFEST)
        self.config = _config(r)
        if self.config.manifest_kind == 1:
            r.done()
            numbered = sorted(f for f in os.listdir(directory) if _NUMBERED.fullmatch(f))
            if not numbered:
                raise ValueError(f"{self._name(MANIFEST)}: a numbered manifest without "
                                 "manifest.<generation> files")
            r = self._manifest(numbered[-1])
            if _config(r).uuid != self.config.uuid:
                raise ValueError(f"{self._name(numbered[-1])}: another store's uuid")
        files = _data_files(r, "")
        versions = _versions(r, files)
        refs = _version_refs(r, files, None)
        r.done()
        for ref in refs:
            versions += self._version_node(ref)
        if not versions:
            raise ValueError(f"{self._name(MANIFEST)}: no version")
        versions.sort(key=lambda v: v.generation)
        self.versions = versions
        self.version = versions[-1]
        self._entries: Dict[bytes, Value] = {}
        if self.version.root is not None:
            self._node(self.version.root, self.version.root_height, b"")
        if len(self._entries) != self.version.num_keys:
            raise ValueError(f"{self._name(MANIFEST)}: the tree holds {len(self._entries)} keys, "
                             f"its version says {self.version.num_keys}")

    # -- files -------------------------------------------------------------------------

    def _name(self, path: str) -> str:
        return os.path.join(self.directory, path)

    def _file(self, path: str) -> bytes:
        if path not in self._files:
            with open(self._name(path), "rb") as f:
                self._files[path] = f.read()
        return self._files[path]

    def _slice(self, loc: Location) -> bytes:
        data = self._file(loc.path)
        if loc.offset + loc.length > len(data):
            raise ValueError(f"{self._name(loc.path)}: [{loc.offset}, {loc.offset + loc.length}) "
                             f"past its {len(data)} bytes")
        return data[loc.offset:loc.offset + loc.length]

    def _manifest(self, name: str) -> _Reader:
        body = decode_frame(self._file(name), MANIFEST_MAGIC, self._name(name))
        return _Reader(body, self._name(name))

    def _frame(self, loc: Location, magic: int) -> _Reader:
        name = f"{self._name(loc.path)} at {loc.offset}"
        return _Reader(decode_frame(self._slice(loc), magic, name), name)

    # -- the version tree -----------------------------------------------------------------

    def _version_node(self, ref: _VersionRef) -> List[Version]:
        r = self._frame(ref.location, VERSION_NODE_MAGIC)
        arity, height = r.byte(), r.byte()
        if arity != self.config.version_tree_arity_log2 or height != ref.height:
            raise ValueError(f"{r.name}: version node of arity log2 {arity} and height "
                             f"{height}, expected {self.config.version_tree_arity_log2} and "
                             f"{ref.height}")
        files = _data_files(r, ref.location.base)
        if height == 0:
            versions = _versions(r, files)
            r.done()
        else:
            children = _version_refs(r, files, height)
            r.done()
            versions = [v for child in children for v in self._version_node(child)]
        if len(versions) != ref.num_generations:
            raise ValueError(f"{r.name}: {len(versions)} versions, its reference says "
                             f"{ref.num_generations}")
        return versions

    # -- the B-tree -----------------------------------------------------------------------

    def _node(self, loc: Location, height: int, prefix: bytes) -> None:
        r = self._frame(loc, BTREE_NODE_MAGIC)
        got = r.byte()
        if got != height:
            raise ValueError(f"{r.name}: B-tree node of height {got}, expected {height}")
        files = _data_files(r, loc.base)
        n = r.varint()
        shared = [0] + r.varints(max(n - 1, 0))
        suffix = r.varints(n)
        subtree = r.varints(n) if height else []
        keys, prev = [], b""
        for i in range(n):
            if shared[i] > len(prev):
                raise ValueError(f"{r.name}: key {i} shares {shared[i]} bytes of a "
                                 f"{len(prev)}-byte key")
            prev = prev[:shared[i]] + r.raw(suffix[i])
            keys.append(prev)
        if height:
            locs = _locations(r, files, n)
            r.varints(3 * n)  # each child's key count, node bytes and indirect value bytes
            r.done()
            for key, common, child in zip(keys, subtree, locs):
                if common > len(key) or child is None:
                    raise ValueError(f"{r.name}: corrupt child reference")
                self._node(child, height - 1, prefix + key[:common])
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            raise ValueError(f"{r.name}: unknown value kind in {sorted(set(kinds))}")
        m = sum(kinds)
        ids, offsets = r.varints(m), r.varints(m)
        j = 0
        for key, length, kind in zip(keys, lengths, kinds):
            full = prefix + key
            if self._entries and full <= next(reversed(self._entries)):
                raise ValueError(f"{r.name}: keys out of order at {full!r}")
            if kind:
                if ids[j] >= len(files):
                    raise ValueError(f"{r.name}: data file {ids[j]} of {len(files)}")
                path, base = files[ids[j]]
                self._entries[full] = Location(path, base, offsets[j], length)
                j += 1
            else:
                self._entries[full] = r.raw(length)
        r.done()

    # -- the store ------------------------------------------------------------------------

    def keys(self) -> List[bytes]:
        return list(self._entries)

    def read(self, key: Union[bytes, str]) -> bytes:
        if isinstance(key, str):
            key = key.encode()
        value = self._entries[key]
        return value if isinstance(value, bytes) else self._slice(value)

    def get(self, key: Union[bytes, str]) -> Optional[bytes]:
        try:
            return self.read(key)
        except KeyError:
            return None
