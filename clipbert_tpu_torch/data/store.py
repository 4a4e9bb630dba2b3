# Copied from clipbert_tpu/data/store.py: JAX-free host code, kept importable without jax.
"""Media byte stores — the LMDB replacement.

The reference stores raw media bytes in LMDB keyed by id
(the reference's `src/preprocessing/lmdb_utils.py:56-105`, read side
`src/datasets/dataset_base.py:196-199`: `txn.get(str(id).encode())`).
This module keeps the same key->bytes contract with three backends:

 - :class:`PackStore` — our own single-file packed format ("CBPK"):
   an append-only data region + a JSON footer index, read via mmap
   (zero-copy `memoryview` values). Multi-host TPU friendly: one file per
   shard, no page-cache-hostile random writes, trivially rsync-able.
 - :class:`FileStore` — a directory of files keyed by stem (ingest-free path
   for small datasets / tests).
 - :class:`LmdbStore` — optional, only if the `lmdb` package is present, for
   reading datasets already ingested by the reference tooling.

The ingest CLI (reference `file2lmdb.py`) equivalent lives in the JAX
package (`clipbert_tpu/data/ingest.py`); its stores read here unchanged.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterator, Optional, Tuple

MAGIC = b"CBPK"
VERSION = 1
_FOOTER = struct.Struct("<QQ")  # index_offset, index_length


class PackWriter:
    """Append-only writer for the CBPK packed store."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(MAGIC + struct.pack("<I", VERSION))
        self._index: Dict[str, Tuple[int, int]] = {}

    def put(self, key: str, value: bytes) -> None:
        assert key not in self._index, f"duplicate key {key}"
        off = self._f.tell()
        self._f.write(value)
        self._index[key] = (off, len(value))

    def close(self) -> None:
        idx_off = self._f.tell()
        blob = json.dumps(self._index, separators=(",", ":")).encode()
        self._f.write(blob)
        self._f.write(_FOOTER.pack(idx_off, len(blob)))
        self._f.close()

    def __enter__(self) -> "PackWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MediaStore:
    """key -> bytes read interface (the reference's txn.get contract)."""

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def keys(self) -> Iterator[str]:
        raise NotImplementedError

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def close(self) -> None:
        pass


class PackStore(MediaStore):
    def __init__(self, path: str):
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        assert self._mm[:4] == MAGIC, f"{path}: not a CBPK store"
        idx_off, idx_len = _FOOTER.unpack(self._mm[-_FOOTER.size:])
        self._index: Dict[str, Tuple[int, int]] = json.loads(
            self._mm[idx_off:idx_off + idx_len].decode())

    def get(self, key: str):
        ent = self._index.get(key)
        if ent is None:
            return None
        off, length = ent
        return self._mm[off:off + length]

    def keys(self):
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)

    def close(self) -> None:
        self._mm.close()
        self._file.close()


class FileStore(MediaStore):
    """Directory of files; key = filename stem (reference keys are stems of
    the ingested files, lmdb_utils.py:30-34)."""

    def __init__(self, root: str):
        self._root = root
        self._paths: Dict[str, str] = {}
        for dirpath, _dirs, files in os.walk(root):
            for fn in files:
                stem = os.path.splitext(fn)[0]
                self._paths.setdefault(stem, os.path.join(dirpath, fn))

    def get(self, key: str):
        p = self._paths.get(str(key))
        if p is None:
            return None
        with open(p, "rb") as f:
            return f.read()

    def keys(self):
        return iter(self._paths)


class LmdbStore(MediaStore):
    """Read LMDBs produced by the reference tooling (optional dep)."""

    def __init__(self, lmdb_dir: str):
        import lmdb  # gated: not part of the baked-in environment
        self._env = lmdb.open(lmdb_dir, readonly=True, create=False,
                              lock=False)
        self._txn = self._env.begin(buffers=True)

    def get(self, key: str):
        val = self._txn.get(str(key).encode("utf-8"))
        return None if val is None else bytes(val)

    def keys(self):
        with self._env.begin() as txn:
            for k, _ in txn.cursor():
                yield k.decode("utf-8")

    def close(self) -> None:
        self._env.close()


def open_store(path: str) -> MediaStore:
    """Dispatch on path: .cbpk file -> PackStore, dir with data.mdb ->
    LmdbStore, dir -> FileStore."""
    if os.path.isfile(path):
        return PackStore(path)
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "data.mdb")):
            return LmdbStore(path)
        return FileStore(path)
    raise FileNotFoundError(path)
