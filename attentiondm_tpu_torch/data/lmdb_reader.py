"""Pure-Python read-only LMDB access (a copy of
`attentiondm_tpu/data/lmdb_reader.py`; no `lmdb` package needed).

The reference's LSUN and FFHQ datasets are LMDB databases
(datasets/lsun.py:11-58, datasets/ffhq.py:8-40: `lmdb.open(readonly=True)`,
`txn.get(key)`, `txn.cursor()` iteration, `txn.stat()['entries']`).  This
module reimplements exactly that read surface from the on-disk format —
LMDB is a memory-mapped copy-on-write B+tree whose layout (openldap
liblmdb, mdb.c) is stable and versioned:

- pages of `psize` bytes; pages 0 and 1 are meta pages, the live one is the
  valid meta with the larger transaction id;
- meta holds two MDB_db records (freelist + main); the main record carries
  the entry count and root page number; the freelist record's `md_pad`
  field doubles as the environment page size;
- branch pages map keys -> child page numbers, leaf pages hold nodes of
  (key, value); values too large for a leaf move to contiguous overflow
  pages referenced by an 8-byte page number (F_BIGDATA).

Only the features LSUN/FFHQ databases use are supported: the main DB,
default (memcmp) key order, no dupsort, no LEAF2, 64-bit little-endian
files.  `write_lmdb` produces small compatible databases (single-level or
one-branch-level trees) so the reader is testable without network access —
it is a fixture generator, not a general writer.
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, Tuple

MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01

PAGEHDRSZ = 16
P_INVALID = 0xFFFFFFFFFFFFFFFF

# MDB_db: md_pad u32, md_flags u16, md_depth u16, md_branch_pages u64,
# md_leaf_pages u64, md_overflow_pages u64, md_entries u64, md_root u64
_DB_FMT = "<IHHQQQQQ"
_DB_SIZE = struct.calcsize(_DB_FMT)  # 48
assert _DB_SIZE == 48


class LMDBError(RuntimeError):
    pass


class LMDBReader:
    """Read-only view of an LMDB main database.

    `path` may be the environment directory (containing data.mdb) or the
    data file itself.  API mirrors the slice of py-lmdb the reference uses:
    `get`, `__len__` (= stat entries), iteration in key order.
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._map = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        m = self._map

        # psize lives in meta.mm_dbs[FREE].md_pad; read it from meta page 0
        # (both metas agree on it).  Meta struct starts at PAGEHDRSZ.
        magic, version = struct.unpack_from("<II", m, PAGEHDRSZ)
        if magic != MDB_MAGIC:
            raise LMDBError(f"{path}: bad LMDB magic {magic:#x}")
        if version != MDB_DATA_VERSION:
            raise LMDBError(f"{path}: unsupported LMDB data version {version}")
        psize = struct.unpack_from("<I", m, PAGEHDRSZ + 24)[0]
        if psize < 512 or psize & (psize - 1):
            raise LMDBError(f"{path}: implausible page size {psize}")
        self.psize = psize

        # pick the live meta: valid magic, larger txnid
        best = None
        for pg in (0, 1):
            base = pg * psize
            mg, ver = struct.unpack_from("<II", m, base + PAGEHDRSZ)
            if mg != MDB_MAGIC or ver != MDB_DATA_VERSION:
                continue
            txnid = struct.unpack_from("<Q", m, base + PAGEHDRSZ + 24 + 2 * _DB_SIZE + 8)[0]
            if best is None or txnid >= best[0]:
                best = (txnid, base)
        if best is None:
            raise LMDBError(f"{path}: no valid meta page")
        _, base = best
        main_off = base + PAGEHDRSZ + 24 + _DB_SIZE
        (_pad, self.db_flags, self.depth, _bp, _lp, _op,
         self.entries, self.root) = struct.unpack_from(_DB_FMT, m, main_off)
        if self.db_flags & 0x04:  # MDB_DUPSORT
            raise LMDBError("dupsort databases are not supported")

    # -- page primitives ---------------------------------------------------

    def _page(self, pgno: int):
        off = pgno * self.psize
        if off + PAGEHDRSZ > len(self._map):
            raise LMDBError(f"page {pgno} beyond end of map")
        flags, lower, upper = struct.unpack_from("<HHH", self._map, off + 10)
        return off, flags, lower, upper

    def _numkeys(self, lower: int) -> int:
        return (lower - PAGEHDRSZ) >> 1

    def _ptr(self, off: int, i: int) -> int:
        return off + struct.unpack_from("<H", self._map, off + PAGEHDRSZ + 2 * i)[0]

    def _node(self, noff: int):
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._map, noff)
        key = self._map[noff + 8 : noff + 8 + ksize]
        return lo, hi, flags, ksize, key

    def _branch_child(self, noff: int) -> int:
        lo, hi, flags, _ks, _k = self._node(noff)
        return lo | (hi << 16) | (flags << 32)

    def _leaf_value(self, noff: int) -> bytes:
        lo, hi, flags, ksize, _key = self._node(noff)
        dsize = lo | (hi << 16)
        dstart = noff + 8 + ksize
        if flags & F_BIGDATA:
            ovpg = struct.unpack_from("<Q", self._map, dstart)[0]
            ooff, oflags, _, _ = self._page(ovpg)
            if not oflags & P_OVERFLOW:
                raise LMDBError(f"page {ovpg}: expected overflow page")
            return bytes(self._map[ooff + PAGEHDRSZ : ooff + PAGEHDRSZ + dsize])
        return bytes(self._map[dstart : dstart + dsize])

    # -- public API ----------------------------------------------------------

    def __len__(self) -> int:
        return self.entries

    def stat(self) -> dict:
        return {"psize": self.psize, "depth": self.depth, "entries": self.entries}

    def get(self, key: bytes, default=None):
        """Binary-search the B+tree for `key` (memcmp order)."""
        if self.root == P_INVALID:
            return default
        pgno = self.root
        for _ in range(self.depth + 2):  # bounded walk; corrupt files can't loop
            off, flags, lower, upper = self._page(pgno)
            n = self._numkeys(lower)
            if flags & P_LEAF2:
                raise LMDBError("LEAF2 pages are not supported")
            if flags & P_BRANCH:
                # find rightmost child whose key <= search key; key of child 0
                # is empty (always <=)
                lo_i, hi_i = 1, n - 1
                child_i = 0
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) >> 1
                    _, _, _, ks, k = self._node(self._ptr(off, mid))
                    if bytes(k) <= key:
                        child_i = mid
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                pgno = self._branch_child(self._ptr(off, child_i))
                continue
            if flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) >> 1
                    noff = self._ptr(off, mid)
                    _, _, _, ks, k = self._node(noff)
                    kb = bytes(k)
                    if kb == key:
                        return self._leaf_value(noff)
                    if kb < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return default
            raise LMDBError(f"page {pgno}: unexpected flags {flags:#x}")
        raise LMDBError("B+tree deeper than recorded depth (corrupt file)")

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        """Yield (key, value) in key order — the reference's
        `txn.cursor()` scan that builds the LSUN key cache."""
        if self.root == P_INVALID:
            return
        yield from self._walk(self.root, 0)

    def _walk(self, pgno: int, level: int):
        if level > self.depth + 1:
            raise LMDBError("B+tree deeper than recorded depth (corrupt file)")
        off, flags, lower, _upper = self._page(pgno)
        n = self._numkeys(lower)
        if flags & P_BRANCH:
            for i in range(n):
                yield from self._walk(self._branch_child(self._ptr(off, i)), level + 1)
        elif flags & P_LEAF:
            for i in range(n):
                noff = self._ptr(off, i)
                _, _, _, ks, key = self._node(noff)
                yield bytes(key), self._leaf_value(noff)
        else:
            raise LMDBError(f"page {pgno}: unexpected flags {flags:#x}")

    def keys(self):
        return [k for k, _ in self]

    def close(self):
        self._map.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# fixture writer
# ---------------------------------------------------------------------------


def _node_bytes(key: bytes, data: bytes, flags: int, dsize: int | None = None) -> bytes:
    """`dsize` overrides the recorded data size (BIGDATA nodes record the
    overflow value's size while carrying only the 8-byte page number)."""
    dsize = len(data) if dsize is None else dsize
    b = struct.pack("<HHHH", dsize & 0xFFFF, dsize >> 16, flags, len(key)) + key + data
    return b + b"\x00" * (len(b) & 1)  # 2-byte node alignment


def _branch_node_bytes(key: bytes, pgno: int) -> bytes:
    b = struct.pack("<HHHH", pgno & 0xFFFF, (pgno >> 16) & 0xFFFF, pgno >> 32, len(key)) + key
    return b + b"\x00" * (len(b) & 1)


def _emit_page(psize: int, pgno: int, flags: int, nodes: list[bytes]) -> bytes:
    page = bytearray(psize)
    ptrs = []
    upper = psize
    for nb in nodes:
        upper -= len(nb)
        page[upper : upper + len(nb)] = nb
        ptrs.append(upper)
    lower = PAGEHDRSZ + 2 * len(nodes)
    if lower > upper:
        raise LMDBError("fixture page overflow — use fewer/smaller items per page")
    struct.pack_into("<QHHHH", page, 0, pgno, 0, flags, lower, upper)
    for i, p in enumerate(ptrs):
        struct.pack_into("<H", page, PAGEHDRSZ + 2 * i, p)
    return bytes(page)


def write_lmdb(path: str, items: dict[bytes, bytes], psize: int = 4096) -> str:
    """Write a minimal LMDB environment containing `items` in the main DB.

    Supports what fixtures need: sorted leaf pages, one branch level when
    multiple leaves are required, overflow pages for big values.  Returns
    the data.mdb path.
    """
    if os.path.isdir(path) or path.endswith(os.sep):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "data.mdb")
    kvs = sorted(items.items())
    nodemax = (psize - PAGEHDRSZ) // 4  # values above this go to overflow

    next_pg = 2  # 0, 1 = metas
    data_pages: list[bytes] = []  # (in page order, starting at pgno 2)
    n_overflow = 0

    # 1) plan leaf nodes, spilling large values to overflow pages
    planned = []  # (key, node_bytes)
    overflow_chunks: list[tuple[int, bytes]] = []

    def alloc(n):
        nonlocal next_pg
        pg = next_pg
        next_pg += n
        return pg

    pending_ov: list[tuple[int, bytes, int]] = []  # (pgno, data, npages)
    for k, v in kvs:
        if len(v) > nodemax:
            npg = (PAGEHDRSZ + len(v) + psize - 1) // psize
            pg = alloc(npg)
            pending_ov.append((pg, v, npg))
            n_overflow += npg
            planned.append((k, _node_bytes(k, struct.pack("<Q", pg), F_BIGDATA, dsize=len(v)), len(v)))
        else:
            planned.append((k, _node_bytes(k, v, 0), None))

    # 2) pack leaves
    leaves: list[list[bytes]] = [[]]
    used = PAGEHDRSZ
    for k, nb, dsize in planned:
        need = len(nb) + 2
        if used + need > psize and leaves[-1]:
            leaves.append([])
            used = PAGEHDRSZ
        leaves[-1].append(nb)
        used += need
    leaf_pgnos = [alloc(1) for _ in leaves]

    # 3) branch root if >1 leaf
    if len(leaves) > 1:
        first_keys = []
        idx = 0
        for lf in leaves:
            first_keys.append(planned[idx][0])
            idx += len(lf)
        bnodes = [
            _branch_node_bytes(b"" if i == 0 else first_keys[i], pg)
            for i, pg in enumerate(leaf_pgnos)
        ]
        root = alloc(1)
        depth = 2
        branch_pages = 1
    else:
        root = leaf_pgnos[0] if kvs else P_INVALID
        depth = 1 if kvs else 0
        branch_pages = 0

    # 4) serialize pages in pgno order
    pages: dict[int, bytes] = {}
    for pg, v, npg in pending_ov:
        blob = bytearray(npg * psize)
        struct.pack_into("<QHHI", blob, 0, pg, 0, P_OVERFLOW, npg)
        blob[PAGEHDRSZ : PAGEHDRSZ + len(v)] = v
        pages[pg] = bytes(blob)
    for pg, nodes in zip(leaf_pgnos, leaves):
        pages[pg] = _emit_page(psize, pg, P_LEAF, nodes)
    if branch_pages:
        pages[root] = _emit_page(psize, root, P_BRANCH, bnodes)

    # 5) metas
    def meta(pgno: int, txnid: int) -> bytes:
        page = bytearray(psize)
        struct.pack_into("<QHHHH", page, 0, pgno, 0, P_META, 0, 0)
        struct.pack_into("<II", page, PAGEHDRSZ, MDB_MAGIC, MDB_DATA_VERSION)
        struct.pack_into("<QQ", page, PAGEHDRSZ + 8, 0, next_pg * psize)  # addr, mapsize
        # free DB: md_pad = psize, empty
        struct.pack_into(_DB_FMT, page, PAGEHDRSZ + 24, psize, 0, 0, 0, 0, 0, 0, P_INVALID)
        struct.pack_into(
            _DB_FMT, page, PAGEHDRSZ + 24 + _DB_SIZE,
            0, 0, depth, branch_pages, len(leaves) if kvs else 0, n_overflow,
            len(kvs), root,
        )
        struct.pack_into("<QQ", page, PAGEHDRSZ + 24 + 2 * _DB_SIZE, next_pg - 1, txnid)
        return bytes(page)

    with open(path, "wb") as f:
        f.write(meta(0, 0))
        f.write(meta(1, 1))
        pg = 2
        while pg < next_pg:
            blob = pages.get(pg)
            if blob is None:
                raise LMDBError(f"writer lost page {pg}")
            f.write(blob)  # overflow blobs span multiple pages
            pg += len(blob) // psize
    return path
