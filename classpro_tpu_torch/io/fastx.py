"""FASTA/FASTQ(.gz) streaming reader / FASTA writer.

Functional equivalent of the reference's kseq usage (ClassPro.h:49,
ClassPro.c:181-188): the C++ host plane's streaming reader
(``FastxReader``) hands out records chunk by chunk into numpy buffers
(``ReadChunk``: what the engine streams), and ``read_fastx``
yields (name, comment, seq, qual) per record from the same reader.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, NamedTuple, Sequence

import numpy as np

# FASTX extensions, in the reference's probe order (ClassPro.h:326)
FASTX_EXTS = (".fastq", ".fasta", ".fq", ".fa",
              ".fastq.gz", ".fasta.gz", ".fq.gz", ".fa.gz")


class FastxRecord(NamedTuple):
    name: str
    comment: str
    seq: str
    qual: str | None


def root_of(source: str) -> str:
    """``source`` without its FASTX extension."""
    for ext in FASTX_EXTS:
        if source.endswith(ext):
            return source[: -len(ext)]
    return source


def _open(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


# the reader's input block: bytes read (and, for gzip, inflated) a call
BLOCK = 1 << 20
# records a call of the records view (``read_fastx``) asks for
RECORD_CHUNK = 256
# cp_fx_next's status codes
_FULL_SEQ, _FULL_NAME, _FULL_QUAL = 1, 2, 3
_NOT_FASTX, _BAD_GZIP, _TOO_LONG, _IO_ERROR = -1, -2, -3, -4


class ReadChunk:
    """Up to ``B`` reads of a FASTX file in numpy buffers of its own that
    ``FastxReader.next_chunk`` fills (each chunk fresh, so a chunk stays
    valid for as long as it is referenced).  Read i's
    sequence is ``seq[seq_off[i]:seq_off[i + 1]]``, its name
    ``name[name_off[2i]:name_off[2i + 1]]``, its comment the bytes up to
    ``name_off[2i + 2]``, its FASTQ quality (``fastq``)
    ``qual[qual_off[i]:qual_off[i + 1]]``, its profile length ``plen[i]``
    = max(rlen - K + 1, 0); ``rid0`` is read 0's index in the file.
    ``engine.fastx_chunks`` adds each read's compressed profile
    (``prof_addr``, ``prof_nb``: ``ProfileIndex.ranges``) and keeps the
    index that maps them (``profiles``)."""

    def __init__(self, B: int, seq: int, name: int, qual: int):
        self.B = B
        self.n = 0
        self.rid0 = 0
        self.fastq = False
        self.seq = np.empty(seq, np.uint8)
        self.seq_off = np.zeros(B + 1, np.int64)
        self.name = np.empty(name, np.uint8)
        self.name_off = np.zeros(2 * B + 1, np.int64)
        self.qual = np.empty(qual, np.uint8)
        self.qual_off = np.zeros(B + 1, np.int64)
        self.plen = np.zeros(B, np.int64)
        self.prof_addr = self.prof_nb = self.profiles = None

    def _grow(self, what: str, need: int, filled: int) -> None:
        old = getattr(self, what)
        new = np.empty(max(int(need), 2 * len(old), 1 << 12), np.uint8)
        new[:filled] = old[:filled]
        setattr(self, what, new)

    @property
    def seq_len(self) -> np.ndarray:
        return np.diff(self.seq_off[: self.n + 1])

    def seq_addr(self) -> np.ndarray:
        """Each read's sequence address (int64), for the C++ stages."""
        return self.seq.ctypes.data + self.seq_off[: self.n]

    def seqs(self) -> list[str]:
        mv, o = memoryview(self.seq), self.seq_off
        return [str(mv[o[i]: o[i + 1]], "ascii") for i in range(self.n)]

    def names(self) -> list[tuple[str, str]]:
        """(name, comment) of each read."""
        mv, o = memoryview(self.name), self.name_off
        return [(str(mv[o[2 * i]: o[2 * i + 1]], "ascii"),
                 str(mv[o[2 * i + 1]: o[2 * i + 2]], "ascii"))
                for i in range(self.n)]

    def records(self) -> list[FastxRecord]:
        quals = [None] * self.n
        if self.fastq:
            mv, o = memoryview(self.qual), self.qual_off
            quals = [str(mv[o[i]: o[i + 1]], "ascii")
                     for i in range(self.n)]
        return [FastxRecord(nm, cm, sq, q) for (nm, cm), sq, q
                in zip(self.names(), self.seqs(), quals)]


class FastxReader:
    """The C++ streaming FASTX reader (``cp_fx_open`` / ``cp_fx_next``)
    on ``path`` (gzip when it ends in .gz): ``next_chunk(B)`` fills a
    ``ReadChunk`` with the next up to B records in one C++ call, which
    runs without the GIL, or returns None at the end of the file.  Its
    own memory is one input block (``block`` bytes) and a window of text
    holding the current record and a block more (``stats()["capacity"]``).
    ``K`` sets each read's profile length; a read longer than ``max_len``
    ends the reader with the reference's refusal (``read_fastx_checked``'s
    message): the chunk it is in comes back with the reads before it and
    the next call raises (``pending_error``).  A host library that cannot
    be built or loaded raises: there is no other reader on this path."""

    def __init__(self, path: str, K: int = 0, max_len: int | None = None,
                 block: int = BLOCK):
        from classpro_tpu_torch.native import get_lib

        self._lib = get_lib()
        self.path = path
        self.K = K
        self.max_len = (1 << 62) if max_len is None else int(max_len)
        self._h = self._lib.cp_fx_open(os.fsencode(path),
                                       int(path.endswith(".gz")), block)
        if not self._h:
            os.stat(path)                 # raises the OSError it met
            raise OSError(f"{path}: cannot open")
        self._status = np.zeros(4, np.int64)
        # a new chunk's byte buffers start at the largest sizes seen
        self._sizes = {"seq": 1 << 16, "name": 1 << 12, "qual": 0}
        self.rid = 0                      # reads handed out so far
        self.done = False
        self.pending_error: Exception | None = None

    def _error(self, code: int, st) -> Exception:
        if code == _NOT_FASTX:
            return ValueError(f"{self.path}: not FASTA/FASTQ (starts with "
                              f"{chr(int(st[1]))!r})")
        if code == _TOO_LONG:
            return ValueError(f"rlen ({int(st[3])}) > MAX_READ_LEN for "
                              f"FASTX inputs ({self.max_len})")
        if code == _BAD_GZIP:
            return OSError(f"{self.path}: corrupt gzip stream")
        return OSError(f"{self.path}: read error")

    def next_chunk(self, B: int) -> ReadChunk | None:
        """The next up to ``B`` records in a new chunk, or None after the
        last."""
        if self.pending_error is not None:
            raise self.pending_error
        if self.done:
            return None
        c = ReadChunk(B, **self._sizes)
        st, lib = self._status, self._lib
        n = 0
        while True:
            n = lib.cp_fx_next(
                self._h, B, n, self.K, self.max_len,
                c.seq.ctypes.data, len(c.seq), c.seq_off.ctypes.data,
                c.name.ctypes.data, len(c.name), c.name_off.ctypes.data,
                c.qual.ctypes.data, len(c.qual), c.qual_off.ctypes.data,
                c.plen.ctypes.data, st.ctypes.data)
            code = int(st[0])
            if code == _FULL_SEQ:
                c._grow("seq", st[1], c.seq_off[n])
            elif code == _FULL_NAME:
                c._grow("name", st[1], c.name_off[2 * n])
            elif code == _FULL_QUAL:
                c._grow("qual", st[1], c.qual_off[n])
            else:
                break
        for k in self._sizes:
            self._sizes[k] = max(self._sizes[k], len(getattr(c, k)))
        c.n, c.rid0, c.fastq = int(n), self.rid, bool(st[2])
        self.rid += c.n
        if code < 0:
            self.done = True
            self.pending_error = self._error(code, st)
        elif st[1]:
            self.done = True
        if c.n == 0:
            if self.pending_error is not None:
                raise self.pending_error
            return None
        return c

    def stats(self) -> dict:
        """The reader's own bytes (``capacity``: its input block and text
        window) and its seconds so far in read(2), inflate and the record
        scan."""
        out = np.zeros(4, np.int64)
        self._lib.cp_fx_stats(self._h, out.ctypes.data)
        return {"capacity": int(out[0]), "read_s": out[1] / 1e9,
                "inflate_s": out[2] / 1e9, "scan_s": out[3] / 1e9}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.cp_fx_close(self._h)
            self._h = None

    __del__ = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _records(path: str, max_len: int | None) -> Iterator[FastxRecord]:
    with FastxReader(path, max_len=max_len) as rd:
        while True:
            c = rd.next_chunk(RECORD_CHUNK)
            if c is None:
                return
            yield from c.records()


def read_fastx(path: str) -> Iterator[FastxRecord]:
    """Stream records from a FASTA or FASTQ file, optionally gzipped,
    through the C++ streaming reader (``FastxReader``), a few hundred at
    a time.  ``_read_fastx_plain`` is its plain version."""
    return _records(path, None)


def _read_fastx_plain(path: str) -> Iterator[FastxRecord]:
    """The pure-Python reader: the semantic spec of ``FastxReader`` (tests
    only)."""
    with _open(path) as f:
        first = f.read(1)
        if not first:
            return
        if first == ">":
            name_line = f.readline().rstrip("\n")
            while True:
                parts = name_line.split(None, 1)
                name = parts[0] if parts else ""
                comment = parts[1] if len(parts) > 1 else ""
                seq_chunks: list[str] = []
                line = f.readline()
                while line and not line.startswith(">"):
                    seq_chunks.append(line.strip())
                    line = f.readline()
                yield FastxRecord(name, comment, "".join(seq_chunks), None)
                if not line:
                    return
                name_line = line[1:].rstrip("\n")
        elif first == "@":
            line = f.readline().rstrip("\n")
            while True:
                parts = line.split(None, 1)
                name = parts[0] if parts else ""
                comment = parts[1] if len(parts) > 1 else ""
                seq = f.readline().strip()
                f.readline()  # '+'
                qual = f.readline().strip()
                yield FastxRecord(name, comment, seq, qual)
                hdr = f.readline()
                if not hdr:
                    return
                line = hdr[1:].rstrip("\n")
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def read_fastx_checked(path: str, max_read_len: int) -> Iterator[FastxRecord]:
    """read_fastx with the reference's FASTX read-length refusal
    (ClassPro.c:184-187, const.c:57 MAX_READ_LEN): the first read longer
    than ``max_read_len`` aborts with the reference's message, after the
    reads before it.  DAZZ inputs are exempt in the reference too (they
    size workspaces from db->maxlen instead, ClassPro.c:87)."""
    return _records(path, max_read_len)


def write_fasta(path: str, records: Sequence[tuple[str, str, str]]) -> None:
    """Write (name, comment, seq) triples as single-line FASTA."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "wt") as f:
        for name, comment, seq in records:
            hdr = f">{name} {comment}" if comment else f">{name}"
            f.write(hdr + "\n" + seq + "\n")
