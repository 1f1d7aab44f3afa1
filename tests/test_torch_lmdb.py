"""PyTorch port vs the JAX package: the pure-Python LMDB reader and writer
(`attentiondm_tpu_torch/data/lmdb_reader.py`, a copy of JAX's).

`write_lmdb` writes JAX's bytes exactly, each reader reads the other's
files, and JAX's four tests/test_lmdb.py reader cases run on the port."""
import os
import random

import pytest

from attentiondm_tpu.data import lmdb_reader as jl
from attentiondm_tpu_torch.data import lmdb_reader as tl


def _items(kind):
    if kind == "empty":
        return {}
    if kind == "single_leaf":
        return {f"k{i:03d}".encode(): f"value-{i}".encode() * 3 for i in range(10)}
    rnd = random.Random(0)
    return {f"key-{i:05d}".encode(): bytes(rnd.randrange(256) for _ in range(rnd.choice([20, 200, 5000])))
            for i in range(300)}


@pytest.mark.parametrize("kind", ["empty", "single_leaf", "branch_and_overflow"])
@pytest.mark.parametrize("psize", [4096, 8192])
def test_write_lmdb_bytes_equal_jax(tmp_path, kind, psize):
    items = _items(kind)
    ours = tl.write_lmdb(str(tmp_path / "t") + os.sep, items, psize=psize)
    theirs = jl.write_lmdb(str(tmp_path / "j") + os.sep, items, psize=psize)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer,reader", [(jl, tl), (tl, jl)], ids=["jax_file_port_reader", "port_file_jax_reader"])
@pytest.mark.parametrize("kind", ["single_leaf", "branch_and_overflow"])
def test_readers_read_each_others_files(tmp_path, writer, reader, kind):
    items = _items(kind)
    p = writer.write_lmdb(str(tmp_path / "db") + os.sep, items)
    with reader.LMDBReader(p) as r:
        assert len(r) == len(items)
        assert r.keys() == sorted(items)
        assert dict(iter(r)) == items
        assert all(r.get(k) == v for k, v in items.items())


def test_roundtrip_single_leaf(tmp_path):
    items = _items("single_leaf")
    p = tl.write_lmdb(str(tmp_path / "small") + os.sep, items)
    with tl.LMDBReader(p) as r:
        assert len(r) == 10
        assert r.stat()["depth"] == 1
        assert r.get(b"k003") == items[b"k003"]
        assert r.get(b"missing") is None
        assert [k for k, _ in r] == sorted(items)
        assert dict(iter(r)) == items


def test_roundtrip_branch_and_overflow(tmp_path):
    items = _items("branch_and_overflow")
    p = tl.write_lmdb(str(tmp_path / "big") + os.sep, items)
    with tl.LMDBReader(p) as r:
        assert len(r) == 300
        assert r.stat()["depth"] == 2  # a branch level
        for k, v in items.items():
            assert r.get(k) == v
        assert dict(iter(r)) == items


def test_empty_db(tmp_path):
    p = tl.write_lmdb(str(tmp_path / "empty") + os.sep, {})
    with tl.LMDBReader(p) as r:
        assert len(r) == 0
        assert r.get(b"x") is None
        assert list(r) == []


def test_reader_picks_newer_meta(tmp_path):
    """write_lmdb stamps meta 1 with txnid 1 > meta 0's 0; with meta 1's
    magic broken the reader falls back to meta 0 (same contents here)."""
    p = tl.write_lmdb(str(tmp_path / "m") + os.sep, {b"a": b"1"})
    r = tl.LMDBReader(p)
    psize = r.psize
    r.close()
    with open(p, "rb") as f:
        data = bytearray(f.read())
    data[psize + 16] ^= 0xFF
    with open(p, "wb") as f:
        f.write(bytes(data))
    with tl.LMDBReader(p) as r2:
        assert r2.get(b"a") == b"1"


def test_not_an_lmdb_raises_lmdb_error(tmp_path):
    p = tmp_path / "junk" / "data.mdb"
    p.parent.mkdir()
    p.write_bytes(b"\0" * 8192)
    with pytest.raises(tl.LMDBError):
        tl.LMDBReader(str(p.parent))
    with pytest.raises(jl.LMDBError):
        jl.LMDBReader(str(p.parent))
