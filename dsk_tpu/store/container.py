"""A numpy-only hierarchical container: groups, appendable datasets, attrs.

The count store (store/output.py) and the pass checkpoint
(engine/checkpoint.py) need a small part of what HDF5 offers: named
groups, typed datasets that grow along axis 0 and can be truncated, and
small attributes.  This module gives exactly that with numpy and the
filesystem, so the program needs no HDF5 library:

  <path>/                      the container is a directory
  <path>/.attrs.json           root attributes
  <path>/<group>/              a group is a subdirectory (attrs likewise)
  <path>/<group>/<name>.bin    a dataset's rows, raw little-endian records
  <path>/<group>/<name>.json   its dtype, row shape, attrs (and, when
                               compressed, the zlib block index)

Rows of an uncompressed dataset are read and written in place (a slice
read is one seek + read).  A compressed dataset stores each append as one
zlib block; reads decompress the blocks a slice overlaps.  Writes of a
dataset's metadata go through a temporary file and a rename, so a crash
leaves either the old or the new metadata.  The rows a dataset holds are
the whole rows of `.bin` (uncompressed) or the indexed blocks
(compressed); an append first cuts `.bin` back to them, so bytes a crash
left past them are written over, never read.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib

import numpy as np

_ATTRS = ".attrs.json"


def _encode(value):
    if isinstance(value, np.ndarray):
        return {"__ndarray__": value.tolist(), "dtype": value.dtype.str}
    if isinstance(value, np.generic):
        return value.item()
    return value


def _decode(value):
    if isinstance(value, dict) and "__ndarray__" in value:
        return np.asarray(value["__ndarray__"], dtype=value["dtype"])
    return value


def _dtype_to_json(dt: np.dtype):
    return np.lib.format.dtype_to_descr(dt)


def _dtype_from_json(descr) -> np.dtype:
    if isinstance(descr, str):
        return np.dtype(descr)
    return np.dtype(
        [tuple(f[:2]) + ((tuple(f[2]),) if len(f) > 2 else ()) for f in descr]
    )


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class Attrs:
    """Dict-like attributes, persisted on every change."""

    def __init__(self, load, save):
        self._load, self._save = load, save

    def __getitem__(self, key):
        return _decode(self._load()[key])

    def get(self, key, default=None):
        d = self._load()
        return _decode(d[key]) if key in d else default

    def __contains__(self, key) -> bool:
        return key in self._load()

    def __setitem__(self, key, value) -> None:
        d = self._load()
        d[key] = _encode(value)
        self._save(d)

    def __delitem__(self, key) -> None:
        d = self._load()
        del d[key]
        self._save(d)


class Dataset:
    """Rows of one dtype and row shape, appended along axis 0."""

    def __init__(self, base: str):
        self._bin = base + ".bin"
        self._meta_path = base + ".json"
        meta = self._meta()
        self.dtype = _dtype_from_json(meta["dtype"])
        self._row_shape = tuple(meta["row_shape"])
        self._row_bytes = self.dtype.itemsize * int(
            np.prod(self._row_shape, dtype=np.int64)
        )
        self.compression = meta.get("compression")
        self.attrs = Attrs(
            lambda: self._meta()["attrs"], self._save_attrs
        )
        self._cache = (None, None)  # (block index, decoded rows)

    @classmethod
    def create(cls, base: str, dtype, row_shape=(), compression=None):
        meta = {
            "dtype": _dtype_to_json(np.dtype(dtype)),
            "row_shape": list(row_shape),
            "attrs": {},
        }
        if compression:
            meta["compression"] = compression
            meta["blocks"] = []
        open(base + ".bin", "wb").close()
        _write_json(base + ".json", meta)
        return cls(base)

    def _meta(self) -> dict:
        return _read_json(self._meta_path)

    def _save_attrs(self, attrs: dict) -> None:
        meta = self._meta()
        meta["attrs"] = attrs
        _write_json(self._meta_path, meta)

    def _blocks(self) -> list[list[int]]:
        return self._meta()["blocks"]

    def __len__(self) -> int:
        if self.compression:
            return sum(n for n, _ in self._blocks())
        return os.path.getsize(self._bin) // max(self._row_bytes, 1)

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self),) + self._row_shape

    def _as_rows(self, arr) -> np.ndarray:
        arr = np.ascontiguousarray(arr, dtype=self.dtype)
        return arr.reshape((-1,) + self._row_shape)

    def _write_at(self, offset: int, data: bytes) -> None:
        # bytes past `offset` are a write a crash cut short (a torn row,
        # or a block that never reached the index): write over them
        with open(self._bin, "r+b") as f:
            f.seek(offset)
            f.truncate()
            f.write(data)

    def append(self, rows) -> None:
        rows = self._as_rows(rows)
        if rows.shape[0] == 0:
            return
        if not self.compression:
            self._write_at(len(self) * self._row_bytes, rows.tobytes())
            return
        meta = self._meta()
        blob = zlib.compress(rows.tobytes(), 1)
        self._write_at(sum(nb for _, nb in meta["blocks"]), blob)
        meta["blocks"].append([int(rows.shape[0]), len(blob)])
        _write_json(self._meta_path, meta)
        self._cache = (None, None)

    def resize(self, n: int) -> None:
        """Truncate to the first n rows (or zero-extend, uncompressed)."""
        if not self.compression:
            os.truncate(self._bin, n * self._row_bytes)
            return
        if n > len(self):
            raise ValueError("a compressed dataset cannot grow by resize")
        # keep the blocks wholly below n; the rows of the block cut in two
        # become a new block
        meta = self._meta()
        keep, row = [], 0
        for nr, nb in meta["blocks"]:
            if row + nr > n:
                break
            keep.append([nr, nb])
            row += nr
        tail = self[row:n]
        meta["blocks"] = keep
        _write_json(self._meta_path, meta)
        self._cache = (None, None)
        self.append(tail)

    def _read_raw(self, start: int, stop: int) -> np.ndarray:
        count = max(stop - start, 0)
        with open(self._bin, "rb") as f:
            f.seek(start * self._row_bytes)
            buf = f.read(count * self._row_bytes)
        return np.frombuffer(buf, self.dtype).reshape(
            (count,) + self._row_shape
        ).copy()

    def _block(self, i: int, off: int, nbytes: int) -> np.ndarray:
        if self._cache[0] != i:
            with open(self._bin, "rb") as f:
                f.seek(off)
                raw = zlib.decompress(f.read(nbytes))
            self._cache = (
                i,
                np.frombuffer(raw, self.dtype).reshape(
                    (-1,) + self._row_shape
                ),
            )
        return self._cache[1]

    def _read_blocks(self, start: int, stop: int) -> np.ndarray:
        parts = []
        row = byte = 0
        for i, (n, nbytes) in enumerate(self._blocks()):
            lo, hi = max(start, row), min(stop, row + n)
            if lo < hi:
                parts.append(self._block(i, byte, nbytes)[lo - row : hi - row])
            row += n
            byte += nbytes
        if not parts:
            return np.empty((0,) + self._row_shape, self.dtype)
        return np.concatenate(parts).copy()

    def __getitem__(self, key):
        n = len(self)
        if isinstance(key, (int, np.integer)):
            i = int(key) + (n if key < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(key)
            return self[i : i + 1][0]
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise TypeError(f"unsupported dataset index {key!r}")
        start, stop, _ = key.indices(n)
        if self.compression:
            return self._read_blocks(start, stop)
        return self._read_raw(start, stop)


class Group:
    """A directory of datasets and subgroups."""

    def __init__(self, path: str):
        self._path = path
        attrs_path = os.path.join(path, _ATTRS)
        self.attrs = Attrs(
            lambda: _read_json(attrs_path)
            if os.path.exists(attrs_path) else {},
            lambda d: _write_json(attrs_path, d),
        )

    def _child(self, name: str) -> str:
        if not name or name.startswith(".") or "/" in name:
            raise KeyError(name)
        return os.path.join(self._path, name)

    def __getitem__(self, key: str):
        head, _, rest = key.strip("/").partition("/")
        p = self._child(head)
        if rest:
            if not os.path.isdir(p):
                raise KeyError(key)
            return Group(p)[rest]
        if os.path.isdir(p):
            return Group(p)
        if os.path.exists(p + ".json"):
            return Dataset(p)
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        try:
            self[key]
        except KeyError:
            return False
        return True

    def __iter__(self):
        names = set()
        for entry in os.listdir(self._path):
            if entry.startswith("."):
                continue
            full = os.path.join(self._path, entry)
            if os.path.isdir(full):
                names.add(entry)
            elif entry.endswith(".json"):
                names.add(entry[: -len(".json")])
        return iter(sorted(names))

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def values(self):
        return [self[name] for name in self]

    def create_group(self, name: str) -> "Group":
        p = self._child(name)
        os.makedirs(p)
        return Group(p)

    def create_dataset(
        self, name: str, data=None, dtype=None, row_shape=(),
        compression: str | None = None,
    ) -> Dataset:
        """New dataset; `data` (an array) gives dtype, row shape and rows."""
        if data is not None:
            data = np.asarray(data)
            dtype, row_shape = data.dtype, data.shape[1:]
        ds = Dataset.create(self._child(name), dtype, row_shape, compression)
        if data is not None:
            ds.append(data)
        return ds

    def __delitem__(self, name: str) -> None:
        p = self._child(name)
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif os.path.exists(p + ".json"):
            os.unlink(p + ".json")
            os.unlink(p + ".bin")
        else:
            raise KeyError(name)


class Container(Group):
    """The root group of a container directory.

    mode "r": must exist; "a": open or create; "w": create, replacing any
    existing container at that path.  Nothing is held open or buffered:
    every write reaches its file before the call returns."""

    def __init__(self, path: str, mode: str = "r"):
        if mode == "w":
            remove(path)
        if mode in ("w", "a"):
            os.makedirs(path, exist_ok=True)
        elif not os.path.isdir(path):
            raise FileNotFoundError(f"no count store at {path}")
        super().__init__(path)


def remove(path: str) -> None:
    """Delete a container (no error when it does not exist)."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.unlink(path)
