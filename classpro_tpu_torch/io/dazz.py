"""DAZZ_DB database and track I/O (ref DB.h/DB.c formats).

Reads and writes the on-disk representation directly (no vendored C):

* stub text file ``<root>.dam``/``.db`` — DB_NFILE/DB_FDATA/DB_NBLOCK/
  DB_PARAMS/DB_BDATA lines (DB.h:436-443);
* hidden ``.<root>.idx`` — a raw dump of the in-memory DAZZ_DB struct
  (112 bytes on LP64, offsets verified against the reference compiler)
  followed by DAZZ_READ records ({origin, rlen, fpulse, boff, coff,
  flags}, 40 bytes each, DB.h:287-297);
* hidden ``.<root>.bps`` — 2-bit packed bases, 4 per byte, first base
  in the top bits (Compress_Read, DB.c);
* ``.<root>.hdr`` (.dam only) — scaffold header lines addressed by
  DAZZ_READ.coff (ClassPro.c:173-177);
* tracks ``.<root>.<name>.anno``/``.data`` — anno = {nreads int32,
  size int32, int64 offsets...}, data = payload (io.c:299-313,
  DB.h:299-318).

``write_dam`` produces a database equivalent to fasta2DAM+DBsplit for
N-free reads (each record one contig), which the reference binary opens
directly — the interop test drives ClassPro -P on our output.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

_DB_STRUCT = struct.Struct("<4i4fiq5i4xq8sqqq")   # 112-byte DAZZ_DB image
_READ_STRUCT = struct.Struct("<3i4x2qi4x")        # 40-byte DAZZ_READ

_BASE = np.frombuffer(b"ACGT", np.uint8)
_CODE = np.full(256, 0, np.uint8)
for _i, _c in enumerate(b"acgt"):
    _CODE[_c] = _i
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i


@dataclasses.dataclass
class DazzRead:
    origin: int
    rlen: int
    fpulse: int
    boff: int
    coff: int
    flags: int


class DazzDB:
    """Read access to a .db/.dam (Open_DB + Load_Read + Trim_DB
    equivalents), including block-addressed opens: ``root.N[.db]``
    opens block N of a DBsplit database (Open_DB's part parse,
    DB.c:716-725, and the stub's DB_BDATA block table, DB.h:435-437)."""

    def __init__(self, path: str):
        if path.endswith(".dam"):
            self.is_dam = True
            root = path[:-4]
        elif path.endswith(".db"):
            self.is_dam = False
            root = path[:-3]
        else:
            for ext, dam in ((".dam", True), (".db", False)):
                if os.path.exists(path + ext):
                    self.is_dam = dam
                    root = path
                    break
            else:
                # maybe a block-addressed name root.N without extension
                base, dot, tail = path.rpartition(".")
                if dot and tail.isdigit():
                    for ext, dam in ((".dam", True), (".db", False)):
                        if os.path.exists(base + ext):
                            self.is_dam = dam
                            root = path
                            break
                    else:
                        raise FileNotFoundError(f"{path}(.db|.dam)")
                else:
                    raise FileNotFoundError(f"{path}(.db|.dam)")
        # trailing .N (numeric, nonzero) selects a block (DB.c:716-725)
        self.part = 0
        base, dot, tail = root.rpartition(".")
        if dot and tail.isdigit() and int(tail) != 0:
            self.part = int(tail)
            root = base
        self.root = root
        pwd, base = os.path.split(root)
        stub = root + (".dam" if self.is_dam else ".db")

        self.nblocks = 0
        self.cutoff = 0
        self.allarr = 1  # DB_ALL when unpartitioned (DB.c:777-779)
        ublocks: list[int] = []
        tblocks: list[int] = []
        with open(stub) as f:
            nfiles = int(f.readline().split("=")[1])
            self.files = []
            for _ in range(nfiles):
                last, fname, prolog = f.readline().split()
                self.files.append((int(last), fname, prolog))
            line = f.readline()
            if line.startswith("blocks"):
                self.nblocks = int(line.split("=")[1])
                params = f.readline().replace("=", " ").split()
                # size = S cutoff = C all = A
                self.block_size = int(params[1])
                self.cutoff = int(params[3])
                self.allarr = int(params[5])
                for _ in range(self.nblocks + 1):
                    u, t = f.readline().split()
                    ublocks.append(int(u))
                    tblocks.append(int(t))
            elif self.part > 0:
                raise ValueError(
                    f"{stub}: not partitioned, cannot open block "
                    f"{self.part}")
        if self.part > self.nblocks and self.part > 0:
            raise ValueError(f"{stub}: has only {self.nblocks} blocks")

        hidden = os.path.join(pwd, "." + base)
        with open(hidden + ".idx", "rb") as f:
            hdr = f.read(112)
            (self.ureads, self.treads, _idx_cutoff, _idx_all) = \
                struct.unpack_from("<4i", hdr, 0)
            self.freq = struct.unpack_from("<4f", hdr, 16)
            self.maxlen, = struct.unpack_from("<i", hdr, 32)
            self.totlen, = struct.unpack_from("<q", hdr, 40)
            if self.part > 0:
                self.ufirst = ublocks[self.part - 1]
                self.tfirst = tblocks[self.part - 1]
                ulast = ublocks[self.part]
            else:
                self.ufirst = self.tfirst = 0
                ulast = self.ureads
            f.seek(112 + _READ_STRUCT.size * self.ufirst)
            nr = ulast - self.ufirst
            self.reads: list[DazzRead] = []
            raw = f.read(_READ_STRUCT.size * nr)
            for i in range(nr):
                o, rl, fp, boff, coff, fl = _READ_STRUCT.unpack_from(
                    raw, i * _READ_STRUCT.size)
                self.reads.append(DazzRead(o, rl, fp, boff, coff, fl))
        self.nreads = len(self.reads)
        if self.part > 0:
            # a block open recomputes totlen/maxlen over its range
            self.totlen = sum(r.rlen for r in self.reads)
            self.maxlen = max((r.rlen for r in self.reads), default=0)
        self.trimmed = False
        self._bps = open(hidden + ".bps", "rb")
        self._hdr = open(hidden + ".hdr", "rb") if (
            self.is_dam and os.path.exists(hidden + ".hdr")) else None

    def trim(self) -> None:
        """Trim_DB (DB.c:908-1043): drop reads below the cutoff and,
        unless `all`, non-best subreads; recompute totals.  Tracks must
        be read AFTER trimming (the reference loads them post-trim)."""
        DB_ALL, DB_BEST, DB_CCS = 0x1, 0x0800, 0x0400
        if self.trimmed:
            return
        self.trimmed = True
        if self.cutoff <= 0 and (self.allarr & DB_ALL) != 0:
            return
        allflag = 0 if (self.allarr & DB_ALL) != 0 else DB_BEST
        kept = []
        css = 0
        for r in self.reads:
            if (r.flags & DB_CCS) == 0:
                css = 0
            if (r.flags & DB_BEST) >= allflag and r.rlen >= self.cutoff:
                r = dataclasses.replace(r)
                if css:
                    r.flags |= DB_CCS
                else:
                    r.flags &= ~DB_CCS
                css = 1
                kept.append(r)
        self.reads = kept
        self.nreads = len(kept)
        self.totlen = sum(r.rlen for r in kept)
        self.maxlen = max((r.rlen for r in kept), default=0)

    def load_read(self, i: int) -> str:
        """Sequence of read i as uppercase ACGT (Load_Read(...,2) —
        ascii mode 2 is upper case, DB.h:542-543)."""
        r = self.reads[i]
        nbytes = (r.rlen + 3) // 4
        self._bps.seek(r.boff)
        packed = np.frombuffer(self._bps.read(nbytes), np.uint8)
        codes = np.empty(nbytes * 4, np.uint8)
        codes[0::4] = (packed >> 6) & 3
        codes[1::4] = (packed >> 4) & 3
        codes[2::4] = (packed >> 2) & 3
        codes[3::4] = packed & 3
        return _BASE[codes[: r.rlen]].tobytes().decode("ascii")

    def header(self, i: int) -> str:
        """Read header line, '@'-prefixed (ClassPro.c:165-177)."""
        r = self.reads[i]
        if self._hdr is not None:
            self._hdr.seek(r.coff)
            line = self._hdr.readline().decode().rstrip("\n")
            return "@" + line[1:]
        gi = i + self.ufirst      # file table is in global read indices
        m = 0
        while gi >= self.files[m][0]:
            m += 1
        return (f"@{self.files[m][2]}/{r.origin}/"
                f"{r.fpulse}_{r.fpulse + r.rlen}")

    def close(self):
        self._bps.close()
        if self._hdr:
            self._hdr.close()


def compress_read(seq: str) -> bytes:
    """2-bit pack (Compress_Read, DB.c): 4 bases/byte, first base in the
    top bits; also used for COMPRESSED_LEN-sized track payloads."""
    s = _CODE[np.frombuffer(seq.encode("ascii"), np.uint8)]
    pad = (-len(s)) % 4
    if pad:
        s = np.concatenate([s, np.zeros(pad, np.uint8)])
    return ((s[0::4] << 6) | (s[1::4] << 4) | (s[2::4] << 2)
            | s[3::4]).tobytes()


def compress_codes(codes: np.ndarray) -> bytes:
    """2-bit pack an array of 0..3 codes (track payloads)."""
    s = np.asarray(codes, np.uint8)
    pad = (-len(s)) % 4
    if pad:
        s = np.concatenate([s, np.zeros(pad, np.uint8)])
    return ((s[0::4] << 6) | (s[1::4] << 4) | (s[2::4] << 2)
            | s[3::4]).tobytes()



def _stub_blocks(reads, nblocks: int, cutoff: int, all_: int):
    """DBsplit-style block table: contiguous blocks of roughly equal
    untrimmed read counts; returns [(ufirst, tfirst)] * (nblocks+1)
    (DB_BDATA lines, DB.h:437).  The trimmed index counts reads passing
    the (cutoff, all) filter, mirroring Trim_DB's predicate."""
    DB_BEST = 0x0800
    allflag = 0 if all_ else DB_BEST
    n = len(reads)
    t_prefix = [0]
    for r in reads:
        ok = (r.flags & DB_BEST) >= allflag and r.rlen >= cutoff
        t_prefix.append(t_prefix[-1] + (1 if ok else 0))
    out = []
    for b in range(nblocks + 1):
        u = n * b // nblocks
        out.append((u, t_prefix[u]))
    return out


def _write_stub(path: str, base: str, prolog: str, reads,
                nblocks: int, cutoff: int, all_: int) -> None:
    n = len(reads)
    with open(path, "w") as f:
        f.write(f"files = {1:9d}\n")
        f.write(f"  {n:9d} {base} {prolog}\n")
        f.write(f"blocks = {nblocks:9d}\n")
        f.write(f"size = {200000000:11d} cutoff = {cutoff:9d} "
                f"all = {all_:1d}\n")
        for u, t in _stub_blocks(reads, nblocks, cutoff, all_):
            f.write(f" {u:9d} {t:9d}\n")

def write_dam(root: str, records, nblocks: int = 1,
              cutoff: int = 0, all_: int = 1) -> int:
    """Create <root>.dam (+ hidden .idx/.bps/.hdr) from (header, seq)
    pairs — fasta2DAM-equivalent for N-free sequences, one contig per
    record; nblocks > 1 emits a DBsplit-style block table and
    cutoff/all_ set the Trim_DB parameters.  Returns the read count."""
    pwd, base = os.path.split(root)
    hidden = os.path.join(pwd, "." + base) if pwd else "." + base
    reads = []
    totlen = 0
    maxlen = 0
    boff = 0
    with open(hidden + ".bps", "wb") as bps, \
            open(hidden + ".hdr", "w") as hdr:
        coff = 0
        for origin, (name, seq) in enumerate(records):
            line = ">" + name + "\n"
            hdr.write(line)
            rl = len(seq)
            reads.append(DazzRead(origin, rl, 0, boff, coff, 0))
            payload = compress_read(seq)
            bps.write(payload)
            boff += len(payload)
            coff += len(line)
            totlen += rl
            maxlen = max(maxlen, rl)
    n = len(reads)
    with open(hidden + ".idx", "wb") as idx:
        hdr112 = bytearray(112)
        # allarr = DB_ALL so Trim_DB keeps every read (DB.c:918)
        struct.pack_into("<4i", hdr112, 0, n, n, -1, 1)
        struct.pack_into("<4f", hdr112, 16, .25, .25, .25, .25)
        struct.pack_into("<i", hdr112, 32, maxlen)
        struct.pack_into("<q", hdr112, 40, totlen)
        struct.pack_into("<5i", hdr112, 48, n, 0, 0, 0, 0)
        idx.write(hdr112)
        for r in reads:
            idx.write(_READ_STRUCT.pack(r.origin, r.rlen, r.fpulse,
                                        r.boff, r.coff, r.flags))
    _write_stub(root + ".dam", base, base, reads, nblocks, cutoff, all_)
    return n


def write_db(root: str, records, nblocks: int = 1,
             cutoff: int = 0, all_: int = 1) -> int:
    """Create <root>.db (+ hidden .idx/.bps) from (header, seq) pairs —
    fasta2DB-equivalent for N-free reads.  Headers of the PacBio form
    'movie/well/beg_end' populate origin/fpulse so DazzDB.header (and
    the reference's db-mode header reconstruction, ClassPro.c:165-177)
    reproduces them; other headers get origin = read index."""
    import re

    pwd, base = os.path.split(root)
    hidden = os.path.join(pwd, "." + base) if pwd else "." + base
    reads = []
    totlen = 0
    maxlen = 0
    boff = 0
    prolog = base
    pat = re.compile(r"^(\S+)/(\d+)/(\d+)_(\d+)$")
    with open(hidden + ".bps", "wb") as bps:
        for i, (name, seq) in enumerate(records):
            m = pat.match(name.split()[0]) if name else None
            rl = len(seq)
            if m:
                prolog = m.group(1)
                origin, fpulse = int(m.group(2)), int(m.group(3))
            else:
                origin, fpulse = i, 0
            reads.append(DazzRead(origin, rl, fpulse, boff, 0, 0))
            payload = compress_read(seq)
            bps.write(payload)
            boff += len(payload)
            totlen += rl
            maxlen = max(maxlen, rl)
    n = len(reads)
    with open(hidden + ".idx", "wb") as idx:
        hdr112 = bytearray(112)
        struct.pack_into("<4i", hdr112, 0, n, n, -1, 1)
        struct.pack_into("<4f", hdr112, 16, .25, .25, .25, .25)
        struct.pack_into("<i", hdr112, 32, maxlen)
        struct.pack_into("<q", hdr112, 40, totlen)
        struct.pack_into("<5i", hdr112, 48, n, 0, 0, 0, 0)
        idx.write(hdr112)
        for r in reads:
            idx.write(_READ_STRUCT.pack(r.origin, r.rlen, r.fpulse,
                                        r.boff, r.coff, r.flags))
    _write_stub(root + ".db", base, prolog, reads, nblocks, cutoff, all_)
    return n


class TrackWriter:
    """.anno/.data track writer (header layout per io.c:299-313)."""

    def __init__(self, root: str, name: str, nreads: int, size: int):
        pwd, base = os.path.split(root)
        hidden = os.path.join(pwd, "." + base) if pwd else "." + base
        self.afile = open(f"{hidden}.{name}.anno", "wb")
        self.dfile = open(f"{hidden}.{name}.data", "wb")
        self.afile.write(struct.pack("<iiq", nreads, size, 0))
        self.idx = 0

    def add(self, payload: bytes):
        self.dfile.write(payload)
        self.idx += len(payload)
        self.afile.write(struct.pack("<q", self.idx))

    def close(self):
        self.afile.close()
        self.dfile.close()


class IntPairTrackWriter:
    """Interval mask track (.rep style: size=0 header, int32 pairs,
    one int64 offset per read — io.c:308-313, seed.c:534-573)."""

    def __init__(self, root: str, name: str, nreads: int):
        pwd, base = os.path.split(root)
        hidden = os.path.join(pwd, "." + base) if pwd else "." + base
        self.afile = open(f"{hidden}.{name}.anno", "wb")
        self.dfile = open(f"{hidden}.{name}.data", "wb")
        self.afile.write(struct.pack("<iiq", nreads, 0, 0))
        self.idx = 0

    def add(self, intervals):
        for b, e in intervals:
            self.dfile.write(struct.pack("<ii", b, e))
            self.idx += 8
        self.afile.write(struct.pack("<q", self.idx))

    def close(self):
        self.afile.close()
        self.dfile.close()


def read_track(root: str, name: str):
    """Load a track -> (size, offsets int64 array, data bytes).

    offsets[0] is the header's initial 0; read i's payload is
    data[offsets[i]:offsets[i+1]] (io.c:299-307 write order)."""
    pwd, base = os.path.split(root)
    hidden = os.path.join(pwd, "." + base) if pwd else "." + base
    with open(f"{hidden}.{name}.anno", "rb") as f:
        nreads, size = struct.unpack("<ii", f.read(8))
        offs = np.frombuffer(f.read(), "<i8")
    with open(f"{hidden}.{name}.data", "rb") as f:
        data = f.read()
    return size, offs, data
