"""The fastq-like ``.class`` output format (ref ClassPro.c:289, README.md:40-52).

Per read, four lines::

    @<name> <comment>
    <sequence>
    +
    <class string>     # one of E/H/D/R per base; first K-1 positions are N
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Iterator, NamedTuple, Sequence

import numpy as np


class ClassRecord(NamedTuple):
    header: str  # full header line including leading '@'
    seq: str
    classes: str


def class_header(name: str, comment: str | None) -> str:
    """Header line as the reference binary prints it (ClassPro.c:289):
    ``fprintf("@%s %s\\n", name, comment)`` where kseq leaves comment NULL
    for headers without one — glibc renders that as the literal string
    ``(null)``.  Reproduced for byte identity."""
    return f"@{name} {comment if comment else '(null)'}"


def write_class(path: str, records: Sequence[ClassRecord] | Iterator[ClassRecord]) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(f"{r.header}\n{r.seq}\n+\n{r.classes}\n")


class ChunkClasses:
    """A chunk's class lines, read by read, in the uint8 buffers the host
    plane wrote them to: read i's line is ``length[i]`` (its sequence
    length) bytes at offset ``off[i]`` of ``bufs[buf[i]]``, or that many
    'N' where ``buf[i]`` is -1 (a read the device stage did not classify:
    rlen < K, or no records).  It holds every buffer its reads point
    into, so the lines stay valid for as long as it is referenced."""

    __slots__ = ("buf", "off", "length", "bufs")

    def __init__(self, buf, off, length, bufs):
        self.buf, self.off, self.length, self.bufs = buf, off, length, bufs

    @classmethod
    def none(cls, slen) -> "ChunkClasses":
        """Every read of lengths ``slen`` 'N' (no buffer yet)."""
        n = len(slen)
        return cls(np.full(n, -1, np.int32), np.zeros(n, np.int64),
                   np.asarray(slen, np.int64), [])

    def put(self, reads, buf: np.ndarray, off) -> None:
        """Reads ``reads`` take their lines from ``buf`` at ``off``."""
        self.buf[reads] = len(self.bufs)
        self.off[reads] = off
        self.bufs.append(buf)

    def __len__(self) -> int:
        return len(self.buf)

    def take(self, idx) -> "ChunkClasses":
        """The reads at positions ``idx`` (the buffers all kept)."""
        return ChunkClasses(self.buf[idx], self.off[idx], self.length[idx],
                            self.bufs)

    @classmethod
    def join(cls, parts) -> "ChunkClasses":
        """The reads of ``parts``, one part after another."""
        bufs, idx = [], []
        for p in parts:
            idx.append(np.where(p.buf >= 0, p.buf + len(bufs), -1))
            bufs += p.bufs
        return cls(np.concatenate(idx).astype(np.int32),
                   np.concatenate([p.off for p in parts]),
                   np.concatenate([p.length for p in parts]), bufs)

    def addrs(self) -> np.ndarray:
        """Each read's line address (int64), 0 for an all-'N' line.
        Raises ValueError unless every buffer is a C-contiguous byte
        array and every line lies inside its buffer."""
        if any(b.itemsize != 1 or not b.flags.c_contiguous
               for b in self.bufs):
            raise ValueError("a class buffer is not a contiguous byte array")
        size = np.array([b.nbytes for b in self.bufs] + [0], np.int64)
        k = self.buf
        if ((k >= 0) & ((self.off < 0) | (self.off + self.length > size[k]))
                ).any():
            raise ValueError("a class line runs outside its buffer")
        base = np.array([b.ctypes.data for b in self.bufs] + [0], np.int64)
        return np.where(k >= 0, base[k] + self.off, 0)

    def strs(self) -> list[str]:
        """The lines as one ``str`` a read."""
        mvs = [memoryview(b) for b in self.bufs]
        return [str(mvs[k][o: o + n], "ascii") if k >= 0 else "N" * n
                for k, o, n in zip(self.buf.tolist(), self.off.tolist(),
                                   self.length.tolist())]


# chunks a ClassWriter holds queued (a sort window's worth)
WRITER_DEPTH = 8


class ClassWriter:
    """The .class file at ``path`` written from reader chunks and their
    class lines, on a thread of its own: ``put(chunk, classes)`` queues
    a ``ReadChunk`` (``io.fastx``) and its ``ChunkClasses`` and
    returns; the writer thread composes the chunk's records in one C++
    call (``cp_class_compose``: the reader's name, comment and sequence
    bytes and the class lines, in ``write_class``'s format) into a
    buffer it keeps (grown to the next power of two, never shrunk), and
    writes them with write(2), in the order put.  No per-read object is
    made.  The queue holds up to ``WRITER_DEPTH`` chunks (a put waits
    for room) and keeps each chunk, and so every buffer its lines point
    into, until its bytes are written.

    An error on the writer thread (a failed write, such as ENOSPC or EIO,
    or a chunk whose class lines do not fit it) is raised on the caller's
    thread by the next ``put`` or by ``close``; the chunks after it are
    dropped.  ``close`` (or leaving the ``with`` block) waits for every
    chunk put, closes the file and raises that error if there was one;
    it returns once the file is complete.  ``reads`` and ``kmers`` count
    what was written (the k-mers: class bytes other than 'N');
    ``seconds`` holds the writer thread's time by part (compose, write,
    the Python around them)."""

    def __init__(self, path: str):
        from classpro_tpu_torch.native import get_lib

        self._lib = get_lib()
        self.path = path
        self.reads = self.kmers = 0
        self.seconds = {"compose": 0.0, "write": 0.0, "python": 0.0}
        self.error: BaseException | None = None
        self._res = np.zeros(4, np.int64)
        self._buf = np.empty(0, np.uint8)
        self._q: queue.Queue = queue.Queue(maxsize=WRITER_DEPTH)
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                           0o666)
        self._th = threading.Thread(target=self._run, daemon=True,
                                    name="classpro-writer")
        self._th.start()

    def put(self, chunk, classes) -> None:
        """Queue one chunk's records (after those put before)."""
        if self.error is not None:
            raise self.error
        if self._th is None:
            raise ValueError(f"{self.path}: the writer is closed")
        self._q.put((chunk, classes))

    def close(self) -> None:
        """Wait for every chunk put, close the file, raise the writer's
        error if it had one."""
        self._stop()
        if self.error is not None:
            raise self.error

    def _stop(self) -> None:
        if self._th is not None:
            self._q.put(None)
            self._th.join()
            self._th = None
            os.close(self._fd)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
            return
        # the caller's error: the writer thread drops what is still queued
        self.error = self.error or exc
        self._stop()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self.error is None:
                try:
                    self._write(*item)
                except BaseException as e:  # raised on the caller's thread
                    self.error = e
            del item

    def _write(self, c, classes) -> None:
        """Compose and write one chunk (on the writer thread)."""
        clk = time.perf_counter
        t0 = clk()
        if len(classes) != c.n:
            raise ValueError(f"{self.path}: a chunk of {c.n} reads came "
                             f"with {len(classes)} class lines")
        addr = classes.addrs()
        length = np.ascontiguousarray(classes.length, np.int64)
        res, compose = self._res, 0.0
        while True:
            t = clk()
            rc = self._lib.cp_class_compose(
                c.n, c.name.ctypes.data, c.name_off.ctypes.data,
                c.seq.ctypes.data, c.seq_off.ctypes.data, addr.ctypes.data,
                length.ctypes.data, self._buf.ctypes.data, len(self._buf),
                res.ctypes.data)
            compose += clk() - t
            if rc != 1:
                break
            self._buf = np.empty(1 << (int(res[0]) - 1).bit_length(),
                                 np.uint8)
        if rc:
            raise ValueError(f"{self.path}: read {c.rid0 + int(res[3])}'s "
                             f"class line is not as long as its sequence")
        t = clk()
        mv = memoryview(self._buf)[: int(res[0])]
        while mv:
            mv = mv[os.write(self._fd, mv):]
        t1 = clk()
        self.reads += int(res[1])
        self.kmers += int(res[2])
        sec = self.seconds
        sec["compose"] += compose
        sec["write"] += t1 - t
        sec["python"] += (t1 - t0) - compose - (t1 - t)


def read_class(path: str) -> Iterator[ClassRecord]:
    with open(path) as f:
        while True:
            hdr = f.readline()
            if not hdr:
                return
            seq = f.readline().rstrip("\n")
            f.readline()  # '+'
            classes = f.readline().rstrip("\n")
            yield ClassRecord(hdr.rstrip("\n"), seq, classes)
