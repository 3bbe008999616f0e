"""FASTA/FASTQ(.gz) streaming reader / FASTA writer.

Functional equivalent of the reference's kseq usage (ClassPro.h:49,
ClassPro.c:181-188): yields (name, comment, seq, qual) per record.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, NamedTuple, Sequence

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


def _read_fastx_native(path: str) -> list[FastxRecord] | None:
    """Whole-file parse through the C library (gzip inflate + record
    scan, both GIL-free).  Semantics match the Python reader below
    exactly (tested); returns None when the library is unavailable so
    the caller falls back."""
    try:
        from classpro_tpu_torch.native import get_lib

        lib = get_lib()
    except Exception:
        return None
    import numpy as np

    raw = np.fromfile(path, dtype=np.uint8)
    if path.endswith(".gz"):
        if len(raw) < 4:
            return []
        # ISIZE footer = size of the LAST member mod 2^32: right for the
        # common single-member file; retry with the true size otherwise
        cap = max(int(np.frombuffer(raw[-4:], "<u4")[0]), 1)
        while True:
            buf = np.empty(cap, np.uint8)
            n = lib.cp_gzip_inflate(raw.ctypes.data, len(raw),
                                    buf.ctypes.data, cap)
            if n < 0:
                raise OSError(f"{path}: corrupt gzip stream")
            if n <= cap:
                buf = buf[:n]
                break
            cap = n
    else:
        buf = raw
    if len(buf) == 0:
        return []
    max_rec = int(np.count_nonzero(buf == 0x0A)) // 2 + 2
    meta = np.empty(8 * max_rec, np.int64)
    seq = np.empty(len(buf), np.uint8)
    nrec = lib.cp_fastx_parse(buf.ctypes.data, len(buf), max_rec,
                              meta.ctypes.data, seq.ctypes.data)
    if nrec < 0:
        raise ValueError(
            f"{path}: not FASTA/FASTQ (starts with {chr(buf[0])!r})")
    bview = memoryview(buf)
    sview = memoryview(seq)
    out = []
    for i in range(int(nrec)):
        m = meta[8 * i: 8 * i + 8]
        qual = (str(sview[m[6]: m[6] + m[7]], "ascii")
                if m[6] >= 0 else None)
        out.append(FastxRecord(
            str(bview[m[0]: m[0] + m[1]], "ascii"),
            str(bview[m[2]: m[2] + m[3]], "ascii"),
            str(sview[m[4]: m[4] + m[5]], "ascii"),
            qual))
    return out


def read_fastx(path: str) -> Iterator[FastxRecord]:
    """Stream records from a FASTA or FASTQ file, optionally gzipped.

    Uses the native whole-file parser when the C library is available
    (the pure-Python reader below is the fallback and the semantic
    spec)."""
    recs = _read_fastx_native(path)
    if recs is not None:
        yield from recs
        return
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
    than ``max_read_len`` aborts with the reference's message.  DAZZ
    inputs are exempt in the reference too (they size workspaces from
    db->maxlen instead, ClassPro.c:87)."""
    for rec in read_fastx(path):
        if len(rec.seq) > max_read_len:
            raise ValueError(
                f"rlen ({len(rec.seq)}) > MAX_READ_LEN for FASTX inputs "
                f"({max_read_len})")
        yield rec


def write_fasta(path: str, records: Sequence[tuple[str, str, str]]) -> None:
    """Write (name, comment, seq) triples as single-line FASTA."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "wt") as f:
        for name, comment, seq in records:
            hdr = f">{name} {comment}" if comment else f">{name}"
            f.write(hdr + "\n" + seq + "\n")
