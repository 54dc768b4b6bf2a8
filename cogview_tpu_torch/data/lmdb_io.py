"""Read (and minimally write) LMDB files without liblmdb.

Every corpus the reference ecosystem produced is an LMDB environment of
pickled rows keyed ``b'0'..b'N-1'`` plus a ``b'length'`` count
(the reference's ``preprocess/preprocess_text_image_data.py:29-64``,
read back by ``data_utils/datasets.py:34-61``).  This environment has no
``lmdb`` module, and the rebuild's native format is IndexedDataset — so
this module implements the stable, documented LMDB file format directly:

* :class:`LMDBReader` — a read-only B-tree reader over an ``mmap`` of
  ``data.mdb``: picks the live meta page by txnid, walks branch pages by
  memcmp binary search, handles overflow (big-data) pages.  Enough of the
  format for any corpus the reference writers produce (default unnamed
  database, no DUPSORT).
* :func:`write_lmdb` — a minimal bulk writer (sorted keys, leaf/branch
  pages, overflow chains, twin meta pages) used by the round-trip tests;
  files follow the same struct layout (lmdb.h / mdb.c page and node
  structs, OpenLDAP-documented).

Struct layout (64-bit, little-endian — the platform the reference ran on):

    page header (16B): pgno u64 | pad u16 | flags u16 | lower u16 | upper u16
                       (overflow pages: u32 page-count overlays lower/upper)
    meta (at +16 of pages 0/1): magic u32 = 0xBEEFC0DE | version u32 |
        address u64 | mapsize u64 | MDB_db free | MDB_db main |
        last_pg u64 | txnid u64
    MDB_db (48B): pad u32 (free-slot holds psize) | flags u16 | depth u16 |
        branch_pages u64 | leaf_pages u64 | overflow_pages u64 |
        entries u64 | root u64
    node: lo u16 | hi u16 | flags u16 | ksize u16 | key | data
        leaf:   datasize = lo | hi<<16; F_BIGDATA(0x01) -> data is u64 pgno
        branch: child pgno = lo | hi<<16 | flags<<32
"""

from __future__ import annotations

import mmap
import os
import pickle
import struct
from typing import Iterable, Iterator, List, Optional, Tuple

PAGEHDRSZ = 16
P_BRANCH, P_LEAF, P_OVERFLOW, P_META, P_LEAF2 = 0x01, 0x02, 0x04, 0x08, 0x20
F_BIGDATA = 0x01
MDB_MAGIC = 0xBEEFC0DE
P_INVALID = 0xFFFFFFFFFFFFFFFF
NODESZ = 8


def _even(n: int) -> int:
    return (n + 1) & ~1


class LMDBReader:
    """Read-only access to one LMDB environment's main database.

    ``path`` may be the environment directory (containing ``data.mdb``,
    the default subdir layout the reference uses) or the data file itself.
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta = self._pick_meta()
        (self.psize, self.db_flags, self.depth, self.branch_pages,
         self.leaf_pages, self.overflow_pages, self.entries, self.root) = meta
        if self.db_flags & 0x04:  # MDB_DUPSORT
            raise NotImplementedError("DUPSORT databases not supported")

    # -------------------------------------------------------------- #

    def _meta_at(self, off: int):
        mm = self._mm
        magic, version = struct.unpack_from("<II", mm, off)
        if magic != MDB_MAGIC:
            return None
        # free-db slot's pad field holds the page size
        psize = struct.unpack_from("<I", mm, off + 24)[0]
        main = struct.unpack_from("<IHHQQQQQ", mm, off + 24 + 48)
        txnid = struct.unpack_from("<Q", mm, off + 24 + 96 + 8)[0]
        _pad, flags, depth, branch, leaf, ovf, entries, root = main
        return txnid, (psize or 4096, flags, depth, branch, leaf, ovf, entries, root)

    def _pick_meta(self):
        # the two meta pages sit at offsets 0 and psize; psize is only
        # known from a valid meta, so probe common sizes
        candidates = []
        m0 = self._meta_at(PAGEHDRSZ)
        if m0:
            candidates.append(m0)
            psize = m0[1][0]
        else:
            psize = 4096
        for ps in {psize, 4096, 8192, 16384, 32768}:
            if ps + PAGEHDRSZ + 128 <= len(self._mm):
                m1 = self._meta_at(ps + PAGEHDRSZ)
                if m1 and m1[1][0] == ps:
                    candidates.append(m1)
        if not candidates:
            raise ValueError("not an LMDB data file (no valid meta page)")
        return max(candidates)[1]

    # -------------------------------------------------------------- #

    def _page(self, pgno: int) -> Tuple[int, int]:
        """-> (offset, flags)."""
        off = pgno * self.psize
        flags = struct.unpack_from("<H", self._mm, off + 10)[0]
        return off, flags

    def _num_keys(self, off: int) -> int:
        lower = struct.unpack_from("<H", self._mm, off + 12)[0]
        return (lower - PAGEHDRSZ) >> 1

    def _node(self, page_off: int, i: int) -> Tuple[int, int, int, int]:
        """-> (node_off, lo|hi<<16, flags, ksize)."""
        ptr = struct.unpack_from("<H", self._mm, page_off + PAGEHDRSZ + 2 * i)[0]
        noff = page_off + ptr
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._mm, noff)
        return noff, lo | (hi << 16), flags, ksize

    def _leaf_value(self, noff: int, size: int, flags: int, ksize: int) -> bytes:
        mm = self._mm
        data_off = noff + NODESZ + ksize
        if flags & F_BIGDATA:
            ovf_pgno = struct.unpack_from("<Q", mm, data_off)[0]
            start = ovf_pgno * self.psize
            pflags = struct.unpack_from("<H", mm, start + 10)[0]
            assert pflags & P_OVERFLOW, "bigdata node must point at overflow page"
            return bytes(mm[start + PAGEHDRSZ : start + PAGEHDRSZ + size])
        return bytes(mm[data_off : data_off + size])

    def _key(self, noff: int, ksize: int) -> bytes:
        return bytes(self._mm[noff + NODESZ : noff + NODESZ + ksize])

    # -------------------------------------------------------------- #

    def get(self, key: bytes) -> Optional[bytes]:
        if self.root == P_INVALID:
            return None
        pgno = self.root
        for _ in range(self.depth + 2):
            off, flags = self._page(pgno)
            n = self._num_keys(off)
            if flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    noff, size, nflags, ksize = self._node(off, mid)
                    k = self._key(noff, ksize)
                    if k == key:
                        return self._leaf_value(noff, size, nflags, ksize)
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            # branch: rightmost child whose separator <= key (node 0 is
            # the leftmost child, empty separator)
            lo_i, hi_i, child = 1, n - 1, 0
            while lo_i <= hi_i:
                mid = (lo_i + hi_i) // 2
                noff, _, _, ksize = self._node(off, mid)
                if self._key(noff, ksize) <= key:
                    child = mid
                    lo_i = mid + 1
                else:
                    hi_i = mid - 1
            noff, pg_lo, nflags, _ = self._node(off, child)
            pgno = pg_lo | (nflags << 32)
        raise RuntimeError("B-tree deeper than recorded depth (corrupt file?)")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """All (key, value) pairs in key order."""
        if self.root == P_INVALID:
            return
        stack: List[Tuple[int, int]] = [(self.root, 0)]
        while stack:
            pgno, i = stack.pop()
            off, flags = self._page(pgno)
            n = self._num_keys(off)
            if flags & P_LEAF:
                for j in range(n):
                    noff, size, nflags, ksize = self._node(off, j)
                    yield (self._key(noff, ksize),
                           self._leaf_value(noff, size, nflags, ksize))
                continue
            if i < n:
                stack.append((pgno, i + 1))
                noff, pg_lo, nflags, _ = self._node(off, i)
                stack.append((pg_lo | (nflags << 32), 0))

    def __len__(self) -> int:
        return self.entries

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class LMDBCorpusReader:
    """The reference corpus convention over :class:`LMDBReader`:
    ``b'length'`` holds the row count, rows are pickled under
    ``str(i)`` keys (datasets.py:34-61)."""

    def __init__(self, path: str):
        self.db = LMDBReader(path)
        raw = self.db.get(b"length")
        if raw is None:
            raise ValueError(f"{path}: no 'length' key — not a reference corpus")
        self.length = int(raw.decode("utf-8"))

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        raw = self.db.get(str(idx).encode("utf-8"))
        if raw is None:
            raise IndexError(idx)
        return pickle.loads(raw)

    def close(self):
        self.db.close()


# ------------------------------------------------------------------ #
# minimal bulk writer
# ------------------------------------------------------------------ #


def write_lmdb(path: str, items: Iterable[Tuple[bytes, bytes]],
               psize: int = 4096, subdir: bool = True) -> str:
    """Write a fresh single-commit LMDB environment holding ``items``.

    Bulk-build: keys sorted (memcmp), leaves packed left to right, branch
    levels built bottom-up, meta[1] committed with txnid 1 (meta[0] stays
    the empty txnid-0 snapshot, exactly like a real first commit).
    Returns the data file path.
    """
    items = sorted(items, key=lambda kv: kv[0])
    nodemax = ((psize - PAGEHDRSZ) // 2) & ~1
    pages: List[bytearray] = [bytearray(psize), bytearray(psize)]  # metas

    def alloc() -> int:
        pages.append(bytearray(psize))
        return len(pages) - 1

    n_overflow = 0

    def put_header(pgno: int, flags: int, lower: int, upper: int):
        struct.pack_into("<QHHHH", pages[pgno], 0, pgno, 0, flags, lower, upper)

    # ---- leaves
    leaves: List[Tuple[bytes, int]] = []  # (first_key, pgno)
    cur: List[Tuple[bytes, bytes, int]] = []  # (key, inline_data, ovf_pgno|-1)
    cur_size = 0

    def node_cost(k: bytes, d: bytes, big: bool) -> int:
        return 2 + _even(NODESZ + len(k) + (8 if big else len(d)))

    def flush_leaf():
        nonlocal cur, cur_size
        if not cur:
            return
        pgno = alloc()
        page = pages[pgno]
        lower = PAGEHDRSZ + 2 * len(cur)
        upper = psize
        for i, (k, d, ovf) in enumerate(cur):
            big = ovf >= 0
            payload = struct.pack("<Q", ovf) if big else d  # dsize stays len(d)
            sz = _even(NODESZ + len(k) + len(payload))
            upper -= sz
            struct.pack_into("<H", page, PAGEHDRSZ + 2 * i, upper)
            dsize = len(d)
            struct.pack_into("<HHHH", page, upper, dsize & 0xFFFF, dsize >> 16,
                             F_BIGDATA if big else 0, len(k))
            page[upper + NODESZ : upper + NODESZ + len(k)] = k
            page[upper + NODESZ + len(k) : upper + NODESZ + len(k) + len(payload)] = payload
        put_header(pgno, P_LEAF, lower, upper)
        leaves.append((cur[0][0], pgno))
        cur, cur_size = [], 0

    for k, d in items:
        big = NODESZ + len(k) + len(d) > nodemax
        cost = node_cost(k, d, big)
        if cur and PAGEHDRSZ + cur_size + cost > psize:
            flush_leaf()
        ovf = -1
        if big:
            npages = (PAGEHDRSZ - 1 + len(d)) // psize + 1
            ovf = alloc()
            for _ in range(npages - 1):
                alloc()
            n_overflow += npages
            struct.pack_into("<QHHI", pages[ovf], 0, ovf, 0, P_OVERFLOW, npages)
            blob = memoryview(d)
            # data starts after the first page's header, then runs raw
            # across the contiguous chain (no headers on continuations)
            first_cap = psize - PAGEHDRSZ
            pages[ovf][PAGEHDRSZ:PAGEHDRSZ + min(first_cap, len(d))] = blob[:first_cap]
            rem = blob[first_cap:]
            pi = ovf + 1
            while len(rem):
                take = min(psize, len(rem))
                pages[pi][0:take] = rem[:take]
                rem = rem[take:]
                pi += 1
        cur.append((k, d, ovf))  # keep real d: the node records len(d)
        cur_size += cost
    flush_leaf()

    # ---- branches
    n_branch = 0
    level = leaves
    depth = 1 if leaves else 0
    while len(level) > 1:
        nxt: List[Tuple[bytes, int]] = []
        i = 0
        while i < len(level):
            pgno = alloc()
            n_branch += 1
            page = pages[pgno]
            upper = psize
            taken: List[Tuple[bytes, int]] = []
            j = i
            used = 0
            while j < len(level):
                k = b"" if j == i else level[j][0]
                sz = 2 + _even(NODESZ + len(k))
                if taken and PAGEHDRSZ + used + sz > psize:
                    break
                used += sz
                taken.append((k, level[j][1]))
                j += 1
            lower = PAGEHDRSZ + 2 * len(taken)
            for t, (k, child) in enumerate(taken):
                sz = _even(NODESZ + len(k))
                upper -= sz
                struct.pack_into("<H", page, PAGEHDRSZ + 2 * t, upper)
                struct.pack_into("<HHHH", page, upper, child & 0xFFFF,
                                 (child >> 16) & 0xFFFF, (child >> 32) & 0xFFFF,
                                 len(k))
                page[upper + NODESZ : upper + NODESZ + len(k)] = k
            put_header(pgno, P_BRANCH, lower, upper)
            nxt.append((level[i][0], pgno))
            i = j
        level = nxt
        depth += 1

    root = level[0][1] if level else P_INVALID
    n_leaf = len(leaves)
    entries = len(items)
    last_pg = len(pages) - 1

    def meta_bytes(pgno: int, txnid: int, root_pg: int, dep: int,
                   nb: int, nl: int, no: int, ne: int) -> None:
        page = pages[pgno]
        struct.pack_into("<QHHHH", page, 0, pgno, 0, P_META, 0, 0)
        off = PAGEHDRSZ
        struct.pack_into("<II", page, off, MDB_MAGIC, 1)
        struct.pack_into("<QQ", page, off + 8, 0, psize * max(last_pg + 1, 256))
        # free DB (empty); its pad slot carries psize
        struct.pack_into("<IHHQQQQQ", page, off + 24, psize, 0, 0, 0, 0, 0, 0,
                         P_INVALID)
        struct.pack_into("<IHHQQQQQ", page, off + 72, 0, 0x08, dep, nb, nl, no,
                         ne, root_pg)  # 0x08 = MDB_INTEGERKEY off; keep 0
        struct.pack_into("<QQ", page, off + 120, last_pg, txnid)

    # main-db flags are 0 for a plain byte-key database
    def meta(pgno, txnid, root_pg, dep, nb, nl, no, ne):
        meta_bytes(pgno, txnid, root_pg, dep, nb, nl, no, ne)
        struct.pack_into("<IHHQQQQQ", pages[pgno], PAGEHDRSZ + 72, 0, 0, dep,
                         nb, nl, no, ne, root_pg)

    meta(0, 0, P_INVALID, 0, 0, 0, 0, 0)   # pristine snapshot
    meta(1, 1, root, depth if entries else 0, n_branch, n_leaf, n_overflow,
         entries)

    if subdir:
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, "data.mdb")
    else:
        out = path
    with open(out, "wb") as f:
        for page in pages:
            f.write(page)
    return out


def write_reference_corpus(path: str, rows, **kw) -> str:
    """Write rows in the reference corpus convention (pickled values under
    str(i) keys + a 'length' key — preprocess_text_image_data.py:29-64)."""
    items = [(str(i).encode(), pickle.dumps(row)) for i, row in enumerate(rows)]
    items.append((b"length", str(len(rows)).encode()))
    return write_lmdb(path, items, **kw)
