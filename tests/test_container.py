"""The numpy-only container behind the count store and the pass
checkpoint (store/container.py)."""

import os

import numpy as np
import pytest

from dsk_tpu.store.container import Container, remove

REC = np.dtype([("value", "<u4", (2,)), ("abundance", "<i4")])


def _rows(n, base=0):
    r = np.zeros(n, REC)
    r["value"][:, 0] = np.arange(base, base + n)
    r["value"][:, 1] = 7
    r["abundance"] = np.arange(n) + 1
    return r


@pytest.mark.parametrize("compression", [None, "zlib"])
def test_append_read_truncate(tmp_path, compression):
    path = str(tmp_path / "s.dsk")
    f = Container(path, "w")
    g = f.create_group("dsk").create_group("solid")
    ds = g.create_dataset("0", dtype=REC, compression=compression)
    ds.append(_rows(5))
    ds.append(_rows(3, base=5))
    assert ds.shape == (8,)
    f = Container(path, "r")
    ds = f["dsk/solid/0"]
    assert ds.compression == compression
    got = ds[:]
    assert np.array_equal(got["value"][:, 0], np.arange(8))
    assert np.array_equal(ds[2:6], got[2:6])
    assert ds[-1]["abundance"] == 3
    assert ds[4]["value"][0] == 4
    f = Container(path, "a")
    f["dsk/solid/0"].resize(6)
    assert f["dsk/solid/0"].shape == (6,)
    assert np.array_equal(f["dsk/solid/0"][:], got[:6])


@pytest.mark.parametrize("compression", [None, "zlib"])
def test_append_after_crash_leftovers(tmp_path, compression):
    """Bytes a crash left in .bin past the dataset's rows (a torn row, or
    a block written before the index) are written over by the next
    append, and reads see only indexed rows."""
    path = str(tmp_path / "s.dsk")
    g = Container(path, "w").create_group("solid")
    ds = g.create_dataset("0", dtype=REC, compression=compression)
    ds.append(_rows(5))
    with open(path + "/solid/0.bin", "ab") as f:
        f.write(b"\x01" * (REC.itemsize - 1))  # an interrupted append
    ds = Container(path, "a")["solid/0"]
    assert ds.shape == (5,)
    ds.append(_rows(3, base=5))
    ds = Container(path, "r")["solid/0"]
    assert ds.shape == (8,)
    got = ds[:]
    assert np.array_equal(got["value"][:, 0], np.arange(8))
    assert np.array_equal(got["abundance"], [1, 2, 3, 4, 5, 1, 2, 3])
    assert np.array_equal(ds[4:7], got[4:7])


def test_groups_attrs_and_iteration(tmp_path):
    path = str(tmp_path / "c")
    f = Container(path, "w")
    f.attrs["fingerprint"] = "abc"
    g = f.create_group("dsk")
    g.attrs["kmer_size"] = "27"
    s = g.create_group("solid")
    for i in (2, 0, 10):
        s.create_dataset(str(i), data=_rows(i))
    s["10"].attrs["run_sizes"] = np.array([4, 6], np.int64)
    f = Container(path, "r")
    assert f.attrs["fingerprint"] == "abc"
    assert f["dsk"].attrs["kmer_size"] == "27"
    assert sorted(f["dsk/solid"], key=int) == ["0", "2", "10"]
    assert len(f["dsk/solid"]) == 3
    assert "10" in f["dsk/solid"] and "3" not in f["dsk/solid"]
    runs = f["dsk/solid/10"].attrs["run_sizes"]
    assert runs.dtype == np.int64 and list(runs) == [4, 6]
    assert f["dsk/solid/10"].attrs.get("missing", "d") == "d"
    assert sum(ds.shape[0] for ds in f["dsk/solid"].values()) == 12
    with pytest.raises(KeyError):
        f["dsk/nope"]


def test_multidim_datasets_and_delete(tmp_path):
    path = str(tmp_path / "ck")
    kmers = np.arange(24, dtype=np.uint32).reshape(8, 3)
    f = Container(path, "w")
    g = f.create_group("pass_0")
    g.create_dataset("kmers", data=kmers)
    g.create_dataset("empty", data=np.empty((0, 3), np.uint32))
    assert np.array_equal(g["kmers"][:], kmers)
    assert g["empty"].shape == (0, 3)
    del g["kmers"]
    assert "kmers" not in g
    del f["pass_0"]
    assert "pass_0" not in f


def test_modes_and_remove(tmp_path):
    path = str(tmp_path / "m")
    with pytest.raises(FileNotFoundError):
        Container(path, "r")
    f = Container(path, "w")
    f.create_group("g")
    f = Container(path, "w")  # "w" replaces
    assert list(f) == []
    remove(path)
    assert not os.path.exists(path)
    remove(path)  # absent: no error
