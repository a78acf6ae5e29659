"""Pure-Python LMDB (data.mdb) reader/writer — no liblmdb dependency.

The port's own copy of ``image_restoration_sde_tpu/data/mdb.py``: the same
format, the same bytes written for the same items.  The reference consumes
LMDB image datasets (ref data/util.py:17-51, data/LQGT_dataset.py:58-76)
through the ``lmdb`` C extension, which not every installation has, so this
module speaks the on-disk MDB format directly:

- ``MdbEnv``: read-only environment with the same ``begin()/txn.get(key)``
  surface the datasets use (io_utils.open_lmdb falls back to it).  Parses
  the dual meta pages (picks the higher txnid), walks the main B+tree
  (branch/leaf pages), and follows overflow chains for big values.
- ``MdbWriter``: single-transaction writer producing a ``data.mdb`` that
  both this reader and liblmdb can open (sorted keys, bulk-loaded leaves,
  one branch level per fanout step, F_BIGDATA overflow chains).

Format constants follow the LMDB file format (lmdb.h/mdb.c, 64-bit): 16-byte
page headers, MDB_meta at page offset 16 with the page size stashed in the
FREE_DBI's ``md_pad``, node headers of 8 bytes with 2-byte-aligned sizes.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterable, List, Optional, Tuple

PAGEHDRSZ = 16
MAGIC = 0xBEEFC0DE
VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

P_INVALID = 0xFFFFFFFFFFFFFFFF

_META = struct.Struct("<IIQQ")        # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")      # pad, flags, depth, branch, leaf, ovf, entries, root
_TAIL = struct.Struct("<QQ")          # last_pg, txnid
_PAGEHDR = struct.Struct("<QHHHH")    # pgno, pad, flags, lower, upper
_OVFHDR = struct.Struct("<QHHI")      # pgno, pad, flags, pb_pages
_NODEHDR = struct.Struct("<HHHH")     # lo, hi, flags, ksize


def _even(n: int) -> int:
    return (n + 1) & ~1


class _Db:
    __slots__ = ("pad", "flags", "depth", "branch", "leaf", "ovf", "entries", "root")

    def __init__(self, raw: bytes):
        (self.pad, self.flags, self.depth, self.branch,
         self.leaf, self.ovf, self.entries, self.root) = _DB.unpack(raw)


class _Meta:
    def __init__(self, buf: bytes):
        off = 0
        self.magic, self.version, self.address, self.mapsize = _META.unpack_from(buf, off)
        off += _META.size
        self.free_db = _Db(buf[off:off + _DB.size])
        off += _DB.size
        self.main_db = _Db(buf[off:off + _DB.size])
        off += _DB.size
        self.last_pg, self.txnid = _TAIL.unpack_from(buf, off)

    @property
    def valid(self) -> bool:
        return self.magic == MAGIC and self.version == VERSION

    @property
    def psize(self) -> int:
        return self.free_db.pad  # liblmdb: mm_psize == mm_dbs[FREE_DBI].md_pad


class _Txn:
    """Read transaction facade matching ``lmdb.Transaction.get``."""

    def __init__(self, env: "MdbEnv"):
        self._env = env

    def get(self, key: bytes, default=None):
        v = self._env._get(key)
        return default if v is None else v

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class MdbEnv:
    """Read-only LMDB environment (directory with data.mdb, or a bare file)."""

    def __init__(self, path: str):
        self.path = os.path.join(path, "data.mdb") if os.path.isdir(path) else path
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta0 = _Meta(self._mm[PAGEHDRSZ:PAGEHDRSZ + 136])
        if not meta0.valid:
            raise IOError(f"{self.path}: not an LMDB data file (bad meta 0)")
        psize = meta0.psize
        meta1 = _Meta(self._mm[psize + PAGEHDRSZ:psize + PAGEHDRSZ + 136])
        self.meta = meta1 if (meta1.valid and meta1.txnid >= meta0.txnid) else meta0
        self.psize = self.meta.psize

    # --- lmdb-package-compatible surface -------------------------------
    def begin(self, write: bool = False, **_kw) -> _Txn:
        if write:
            raise NotImplementedError("MdbEnv is read-only; use MdbWriter")
        return _Txn(self)

    def stat(self) -> dict:
        db = self.meta.main_db
        return {"psize": self.psize, "depth": db.depth, "entries": db.entries,
                "branch_pages": db.branch, "leaf_pages": db.leaf,
                "overflow_pages": db.ovf}

    def close(self):
        self._mm.close()
        self._f.close()

    # --- B+tree walk ---------------------------------------------------
    def _page(self, pgno: int) -> Tuple[int, memoryview]:
        off = pgno * self.psize
        flags = struct.unpack_from("<H", self._mm, off + 10)[0]
        return flags, memoryview(self._mm)[off:off + self.psize]

    def _nodes(self, page: memoryview) -> List[int]:
        lower = struct.unpack_from("<H", page, 12)[0]
        nkeys = (lower - PAGEHDRSZ) // 2
        return list(struct.unpack_from(f"<{nkeys}H", page, PAGEHDRSZ))

    def _node_key(self, page: memoryview, off: int) -> bytes:
        _, _, _, ksize = _NODEHDR.unpack_from(page, off)
        return bytes(page[off + 8:off + 8 + ksize])

    def _get(self, key: bytes) -> Optional[bytes]:
        db = self.meta.main_db
        if db.root == P_INVALID:
            return None
        pgno = db.root
        for _ in range(max(1, db.depth)):
            flags, page = self._page(pgno)
            ptrs = self._nodes(page)
            if flags & P_LEAF:
                return self._leaf_lookup(page, ptrs, key)
            # branch: rightmost child whose separator key <= target
            # (node 0 carries the empty "leftmost" key)
            child = None
            for off in reversed(ptrs[1:]):
                if self._node_key(page, off) <= key:
                    child = off
                    break
            off = child if child is not None else ptrs[0]
            lo, hi, nflags, _ = _NODEHDR.unpack_from(page, off)
            pgno = lo | (hi << 16) | (nflags << 32)
        return None

    def _leaf_lookup(self, page: memoryview, ptrs: List[int], key: bytes):
        lo_i, hi_i = 0, len(ptrs) - 1
        while lo_i <= hi_i:
            mid = (lo_i + hi_i) // 2
            off = ptrs[mid]
            k = self._node_key(page, off)
            if k == key:
                lo, hi, nflags, ksize = _NODEHDR.unpack_from(page, off)
                dsize = lo | (hi << 16)
                if nflags & F_BIGDATA:
                    (ovf_pgno,) = struct.unpack_from("<Q", page, off + 8 + ksize)
                    start = ovf_pgno * self.psize + PAGEHDRSZ
                    return bytes(self._mm[start:start + dsize])
                dstart = off + 8 + ksize
                return bytes(page[dstart:dstart + dsize])
            if k < key:
                lo_i = mid + 1
            else:
                hi_i = mid - 1
        return None


class MdbWriter:
    """Bulk single-transaction LMDB writer (sorted keys, fresh file).

    Usage::

        with MdbWriter("/path/out.lmdb") as w:
            w.put(b"key", b"value")
    """

    def __init__(self, dirpath: str, psize: int = 4096):
        self.dirpath = dirpath
        self.psize = psize
        self._items: Dict[bytes, bytes] = {}

    def put(self, key: bytes, value: bytes):
        # liblmdb's MDB_MAXKEYSIZE is 511: a longer key would write a file
        # our own reader accepts but real lmdb rejects (MDB_BAD_VALSIZE),
        # silently breaking the documented interop guarantee
        if not (0 < len(key) <= min(511, (self.psize - PAGEHDRSZ) // 4 - 1)):
            raise ValueError(f"key size {len(key)} unsupported (liblmdb max 511)")
        self._items[bytes(key)] = bytes(value)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.finish()
        return False

    # ----------------------------------------------------------- layout
    def finish(self):
        os.makedirs(self.dirpath, exist_ok=True)
        psize = self.psize
        items = sorted(self._items.items())
        # values too large for an in-leaf node go to overflow chains
        # (liblmdb threshold is ~psize/2; a fixed conservative cut is fine
        # for a writer that controls its own layout)
        inline_max = (psize - PAGEHDRSZ) // 4

        pages: Dict[int, bytes] = {}
        next_pg = 2  # 0, 1 are the meta pages
        n_ovf = 0

        def alloc(n: int = 1) -> int:
            nonlocal next_pg
            pg = next_pg
            next_pg += n
            return pg

        # ---- leaves (with their overflow chains allocated alongside)
        def node_size(k: bytes, v: bytes) -> int:
            inline = len(v) if len(v) <= inline_max else 8
            return _even(8 + len(k) + inline)

        leaf_groups: List[List[Tuple[bytes, bytes]]] = []
        cur: List[Tuple[bytes, bytes]] = []
        cur_sz = 0
        for k, v in items:
            sz = node_size(k, v) + 2  # + ptr slot
            if cur and PAGEHDRSZ + cur_sz + sz > psize:
                leaf_groups.append(cur)
                cur, cur_sz = [], 0
            cur.append((k, v))
            cur_sz += sz
        if cur:
            leaf_groups.append(cur)

        def build_page(pgno: int, flags: int, nodes: List[bytes]) -> bytes:
            lower = PAGEHDRSZ + 2 * len(nodes)
            upper = psize
            ptrs, blob_parts = [], {}
            for nd in nodes:
                upper -= _even(len(nd))
                ptrs.append(upper)
                blob_parts[upper] = nd
            page = bytearray(psize)
            _PAGEHDR.pack_into(page, 0, pgno, 0, flags, lower, upper)
            struct.pack_into(f"<{len(ptrs)}H", page, PAGEHDRSZ, *ptrs)
            for off, nd in blob_parts.items():
                page[off:off + len(nd)] = nd
            return bytes(page)

        leaf_entries: List[Tuple[bytes, int]] = []  # (first key, leaf pgno)
        for group in leaf_groups:
            nodes = []
            for k, v in group:
                if len(v) > inline_max:
                    n_pages = -(-(len(v) + PAGEHDRSZ) // psize)
                    ovf_pg = alloc(n_pages)
                    n_ovf += n_pages
                    chain = bytearray(n_pages * psize)
                    _OVFHDR.pack_into(chain, 0, ovf_pg, 0, P_OVERFLOW, n_pages)
                    chain[PAGEHDRSZ:PAGEHDRSZ + len(v)] = v
                    for j in range(n_pages):
                        pages[ovf_pg + j] = bytes(chain[j * psize:(j + 1) * psize])
                    dsize = len(v)
                    nd = _NODEHDR.pack(dsize & 0xFFFF, dsize >> 16, F_BIGDATA,
                                       len(k)) + k + struct.pack("<Q", ovf_pg)
                else:
                    dsize = len(v)
                    nd = _NODEHDR.pack(dsize & 0xFFFF, dsize >> 16, 0, len(k)) + k + v
                nodes.append(nd)
            pg = alloc()
            pages[pg] = build_page(pg, P_LEAF, nodes)
            leaf_entries.append((group[0][0], pg))

        # ---- branch levels up to a single root
        def branch_node(key: bytes, child: int) -> bytes:
            return _NODEHDR.pack(child & 0xFFFF, (child >> 16) & 0xFFFF,
                                 (child >> 32) & 0xFFFF, len(key)) + key

        depth = 1 if leaf_entries else 0
        n_branch = 0
        level = leaf_entries
        while len(level) > 1:
            depth += 1
            nxt: List[Tuple[bytes, int]] = []
            group_nodes: List[bytes] = []
            group_first: Optional[bytes] = None
            group_sz = 0

            def flush_group():
                nonlocal group_nodes, group_first, group_sz, n_branch
                if not group_nodes:
                    return
                pg = alloc()
                pages[pg] = build_page(pg, P_BRANCH, group_nodes)
                n_branch += 1
                nxt.append((group_first, pg))
                group_nodes, group_first, group_sz = [], None, 0

            for i, (k, child) in enumerate(level):
                sep = b"" if not group_nodes else k  # first node: empty key
                nd = branch_node(sep, child)
                sz = _even(len(nd)) + 2
                if group_nodes and PAGEHDRSZ + group_sz + sz > psize:
                    flush_group()
                    nd = branch_node(b"", child)
                    sz = _even(len(nd)) + 2
                if not group_nodes:
                    group_first = k
                group_nodes.append(nd)
                group_sz += sz
            flush_group()
            level = nxt

        root = level[0][1] if level else P_INVALID
        last_pg = next_pg - 1

        # ---- metas: page 0 = empty genesis (txn 0), page 1 = our txn 1
        def meta_page(pgno: int, txnid: int, db: bytes) -> bytes:
            page = bytearray(psize)
            _PAGEHDR.pack_into(page, 0, pgno, 0, P_META, 0, 0)
            free_db = _DB.pack(psize, 0, 0, 0, 0, 0, 0, P_INVALID)
            mapsize = max(1 << 20, (last_pg + 1) * psize)
            mapsize = -(-mapsize // psize) * psize
            body = (_META.pack(MAGIC, VERSION, 0, mapsize) + free_db + db
                    + _TAIL.pack(max(last_pg, 1), txnid))
            page[PAGEHDRSZ:PAGEHDRSZ + len(body)] = body
            return bytes(page)

        empty_db = _DB.pack(0, 0, 0, 0, 0, 0, 0, P_INVALID)
        main_db = _DB.pack(0, 0, depth, n_branch, len(leaf_groups), n_ovf,
                           len(items), root)

        with open(os.path.join(self.dirpath, "data.mdb"), "wb") as f:
            f.write(meta_page(0, 0, empty_db))
            f.write(meta_page(1, 1, main_db))
            for pg in range(2, next_pg):
                f.write(pages[pg])


def write_items(dirpath: str, items: Iterable[Tuple[bytes, bytes]], psize: int = 4096):
    with MdbWriter(dirpath, psize=psize) as w:
        for k, v in items:
            w.put(k, v)
