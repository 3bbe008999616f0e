"""FASTK histogram / profile codecs.

Binary formats reverse-engineered from the reference reader:

``<root>.hist``   (ref libfastk.c:51-96)
    int32 kmer, int32 low, int32 high, int64 ilowcnt, int64 ihighcnt,
    int64 hist[low..high]  (unique k-mer counts; hist[low] aggregates
    counts <= low, hist[high] aggregates counts >= high; ilowcnt/ihighcnt
    are the corresponding *instance* totals hidden for mode toggling).

``<root>.prof``   (stub; ref libfastk.c:1278-1293)
    int32 kmer, int32 nparts.

``.<root>.pidx.N``  (per-part index; ref libfastk.c:1298-1336)
    int32 kmer, int64 <base>, int64 nreads, int64 offsets[nreads]
    where offsets are cumulative byte end-offsets of each read's
    compressed profile within ``.<root>.prof.N``.

``.<root>.prof.N``  (compressed count streams; ref libfastk.c:1464-1534)
    Per read: a first count in 1-2 bytes (2 bytes iff first byte has
    0x80 set: d = ((b0 & 0x7f) << 8) | b1), then tokens:
      * (b & 0xc0) == 0       : run — repeat previous count b times
      * (b & 0x80) != 0       : 2-byte 15-bit delta; d = (d + v) & 0x7fff
                                with v = two's-complement 15-bit value
      * else (0x40 set)       : 1-byte signed 5-bit delta in [-32, 31]

Both a decoder and an encoder are provided — the encoder lets the test
suite fabricate FASTK outputs for arbitrary synthetic read sets, which the
*reference* binary then consumes to produce golden outputs.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Iterable, Sequence

import numpy as np

from classpro_tpu_torch.constants import MAX_KMER_CNT


# ---------------------------------------------------------------------------
# Histogram
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Histogram:
    """FASTK count histogram (unique-count mode, as stored on disk)."""

    kmer: int
    low: int
    high: int
    ilowcnt: int
    ihighcnt: int
    hist: np.ndarray  # int64, indices low..high inclusive, hist[i - low]

    def __getitem__(self, cnt: int) -> int:
        return int(self.hist[cnt - self.low])

    def instance_counts(self) -> np.ndarray:
        """Return instance-count view used by the classifier.

        Mirrors Load_Histogram + Modify_Histogram(H, low, high, 0)
        (hist.c:33-37 + libfastk.c:22-47): interior buckets are multiplied
        by their count; the two edge buckets become the hidden instance
        totals.  Returned array is indexed by count ``c`` via
        ``out[c - low]``.
        """
        out = self.hist.astype(np.int64).copy()
        idx = np.arange(self.low, self.high + 1, dtype=np.int64)
        interior = (idx > self.low) & (idx < self.high)
        out[interior] *= idx[interior]
        out[0] = self.ilowcnt
        out[-1] = self.ihighcnt
        return out


def load_histogram(root: str) -> Histogram:
    """Read ``<root>.hist`` (ref libfastk.c:51-96)."""
    path = root if root.endswith(".hist") else root + ".hist"
    with open(path, "rb") as f:
        hdr = f.read(28)
        if len(hdr) < 28:
            raise ValueError(f"{path}: truncated histogram header "
                             f"({len(hdr)} of 28 bytes)")
        kmer, low, high = struct.unpack("<iii", hdr[:12])
        ilowcnt, ihighcnt = struct.unpack("<qq", hdr[12:])
        hist = np.fromfile(f, dtype="<i8", count=high - low + 1)
        if len(hist) != high - low + 1:
            raise ValueError(f"{path}: truncated histogram body "
                             f"({len(hist)} of {high - low + 1} bins)")
    return Histogram(kmer, low, high, ilowcnt, ihighcnt, hist)


def write_histogram(root: str, hist: Histogram) -> None:
    path = root if root.endswith(".hist") else root + ".hist"
    with open(path, "wb") as f:
        f.write(struct.pack("<iii", hist.kmer, hist.low, hist.high))
        f.write(struct.pack("<qq", hist.ilowcnt, hist.ihighcnt))
        hist.hist.astype("<i8").tofile(f)


def histogram_from_counts(
    kmer: int, counts: Iterable[int], low: int = 1, high: int = MAX_KMER_CNT
) -> Histogram:
    """Build a unique-mode Histogram from per-distinct-k-mer counts."""
    counts = np.asarray(list(counts) if not isinstance(counts, np.ndarray) else counts)
    counts = np.minimum(counts, MAX_KMER_CNT)
    nbins = high - low + 1
    clipped = np.clip(counts, low, high) - low
    hist = np.bincount(clipped, minlength=nbins).astype(np.int64)
    ilowcnt = int(np.sum(counts[counts <= low]))
    ihighcnt = int(np.sum(counts[counts >= high]))
    return Histogram(kmer, low, high, ilowcnt, ihighcnt, hist)


# ---------------------------------------------------------------------------
# Profile compression codec
# ---------------------------------------------------------------------------


def decode_profile(buf: bytes, max_len: int | None = None) -> np.ndarray:
    """Decode one compressed count stream (ref Fetch_Profile,
    libfastk.c:1464-1534)."""
    out: list[int] = []
    n = len(buf)
    if n == 0:
        return np.zeros(0, dtype=np.uint16)
    p = 0
    x = buf[p]
    p += 1
    if x & 0x80:
        d = ((x & 0x7F) << 8) | buf[p]
        p += 1
    else:
        d = x
    out.append(d)
    while p < n:
        x = buf[p]
        p += 1
        if (x & 0xC0) == 0:
            out.extend([d] * x)
        elif x & 0x80:
            if x & 0x40:
                v = ((x << 8) | buf[p]) & 0xFFFF
            else:
                v = ((x << 8) & 0x7FFF) | buf[p]
            p += 1
            d = (d + v) & 0x7FFF
            out.append(d)
        else:
            if x & 0x20:
                d = (d + ((x & 0x1F) | 0xFFE0)) & 0xFFFF
            else:
                d = (d + (x & 0x1F)) & 0xFFFF
            out.append(d)
    arr = np.asarray(out, dtype=np.uint16)
    if max_len is not None:
        arr = arr[:max_len]
    return arr


def encode_profile(counts: np.ndarray) -> bytes:
    """Encode counts so that :func:`decode_profile` (and the reference's
    Fetch_Profile) reproduces them exactly."""
    counts = np.asarray(counts, dtype=np.int64)
    if counts.size == 0:
        return b""
    if counts.min() < 0 or counts.max() > MAX_KMER_CNT:
        raise ValueError("profile counts must be within [0, 32767]")
    out = bytearray()
    d = int(counts[0])
    if d < 128:
        out.append(d)
    else:
        out.append(0x80 | (d >> 8))
        out.append(d & 0xFF)
    for c in counts[1:]:
        c = int(c)
        if c == d:
            # runs are emitted greedily below; collapse here
            pass
        delta = c - d
        if delta == 0:
            out.append(1)  # run of one more copy of d
        elif -32 <= delta <= 31:
            out.append(0x40 | (delta & 0x3F))
        else:
            v = delta & 0x7FFF
            out.append(0x80 | (v >> 8))
            out.append(v & 0xFF)
        d = c
    return bytes(_collapse_runs(out))


def _collapse_runs(tokens: bytearray) -> bytearray:
    """Merge consecutive run-of-1 bytes into run-of-<=63 bytes."""
    out = bytearray()
    i = 0
    n = len(tokens)
    # first count: 1 or 2 bytes
    first = tokens[i]
    out.append(first)
    i += 1
    if first & 0x80:
        out.append(tokens[i])
        i += 1
    run = 0
    while i < n:
        x = tokens[i]
        if x == 1:  # run token of length 1 emitted by encode_profile
            run += 1
            i += 1
            continue
        while run > 0:
            r = min(run, 63)
            out.append(r)
            run -= r
        out.append(x)
        i += 1
        if x & 0x80:
            out.append(tokens[i])
            i += 1
    while run > 0:
        r = min(run, 63)
        out.append(r)
        run -= r
    return out


# ---------------------------------------------------------------------------
# Profile index (multi-part layout)
# ---------------------------------------------------------------------------


def _hidden(root: str, suffix: str) -> str:
    d, b = os.path.split(root)
    return os.path.join(d if d else ".", f".{b}.{suffix}")


def mismatch_error(rid: int, rlen: int, plen: int, kmer: int) -> ValueError:
    """The reference's refusal of a read whose profile length is not
    rlen - K + 1 (ClassPro.c:184-187)."""
    return ValueError(f"Read {rid}: rlen ({rlen}) != plen+Km1 "
                      f"({plen + kmer - 1}) — profile/read mismatch")


class ProfileIndex:
    """Random access to FASTK read profiles (ref Open_Profiles /
    Fetch_Profile, libfastk.c:1267-1562).

    The per-part byte-offset indices are held in memory; each part file
    is mapped read-only at its first use.  Decoding runs in the C++ host
    plane (``cp_decode_profile``); a library that cannot be built or
    loaded raises, and ``decode_profile`` is the plain version."""

    def __init__(self, root: str):
        stub = root if root.endswith(".prof") else root + ".prof"
        with open(stub, "rb") as f:
            self.kmer, self.nparts = struct.unpack("<ii", f.read(8))
        base = stub[: -len(".prof")]
        self._root = base
        self.nbase: list[int] = []
        index_parts = [np.zeros(1, dtype=np.int64)]
        nreads = 0
        for p in range(self.nparts):
            with open(_hidden(base, f"pidx.{p + 1}"), "rb") as f:
                (kmer,) = struct.unpack("<i", f.read(4))
                _, n = struct.unpack("<qq", f.read(16))
                if kmer != self.kmer:
                    raise ValueError("pidx kmer mismatch with stub")
                index_parts.append(np.fromfile(f, dtype="<i8", count=n))
                nreads += n
                self.nbase.append(nreads)
        self.nreads = nreads
        self.index = np.concatenate(index_parts)
        self._nbase = np.asarray(self.nbase, np.int64)
        # the first read id of each part (its start offset is 0: offsets
        # restart per part, libfastk.c:1446-1454)
        self._first = np.concatenate([[0], self._nbase[:-1]]).astype(
            np.int64)
        self._part_data: dict[int, np.ndarray] = {}

    def _part_of(self, rid: int) -> int:
        if rid < 0 or rid >= self.nreads:
            raise IndexError(f"read id {rid} out of range [0,{self.nreads})")
        # nbase is cumulative read counts per part: binary search
        import bisect

        return bisect.bisect_right(self.nbase, rid)

    def _data(self, part: int) -> np.ndarray:
        if part not in self._part_data:
            path = _hidden(self._root, f"prof.{part + 1}")
            size = os.path.getsize(path)
            # mapped read-only: pages come in as the decode reads them
            data = (np.memmap(path, dtype=np.uint8, mode="r") if size
                    else np.zeros(0, np.uint8))
            # the part must hold at least its last read's end offset
            # (offsets restart per part, libfastk.c:1446-1454); a short
            # file would otherwise decode silently into garbage
            need = int(self.index[self.nbase[part]])
            if len(data) < need:
                raise ValueError(
                    f"{path}: truncated profile part ({len(data)} bytes, "
                    f"pidx needs {need})")
            self._part_data[part] = data
        return self._part_data[part]

    def ranges(self, rids) -> tuple[np.ndarray, np.ndarray]:
        """The compressed profiles of reads ``rids``: each one's address
        in its mapped part and its byte count (int64 arrays), the lo / hi
        of ``fetch``; the parts stay mapped while the index lives.
        Raises IndexError for a read id outside the profiles."""
        rids = np.asarray(rids, np.int64)
        if rids.size and (rids.min() < 0 or rids.max() >= self.nreads):
            bad = rids[(rids < 0) | (rids >= self.nreads)][0]
            raise IndexError(f"read id {int(bad)} out of range "
                             f"[0,{self.nreads})")
        parts = np.searchsorted(self._nbase, rids, side="right")
        lo = np.where(rids == self._first[parts], 0, self.index[rids])
        nb = self.index[rids + 1] - lo
        base = np.zeros(self.nparts, np.int64)
        for w in np.unique(parts):
            base[w] = self._data(int(w)).ctypes.data
        return base[parts] + lo, nb

    def fetch(self, rid: int, max_len: int | None = None) -> np.ndarray:
        """Uncompressed profile of read ``rid`` (0-based), decoded by the
        C++ codec (``cp_decode_profile``); ``decode_profile`` is its plain
        version."""
        from classpro_tpu_torch.native import get_lib

        lib = get_lib()
        w = self._part_of(rid)
        # the first read of a part has no stored start offset: it is 0
        first_of_part = rid == 0 or (w > 0 and rid == self.nbase[w - 1])
        lo = 0 if first_of_part else int(self.index[rid])
        hi = int(self.index[rid + 1])
        data = self._data(w)
        nb = hi - lo
        if nb == 0:
            return np.zeros(0, dtype=np.uint16)
        cap = 2 * nb + 16 if max_len is None else max_len
        while True:
            out = np.empty(cap, np.uint16)
            n = lib.cp_decode_profile(data[lo:hi].ctypes.data, nb,
                                      out.ctypes.data, cap)
            if n <= cap:
                return out[:n]
            if max_len is not None:
                return out[:max_len]
            cap = n

    def fetch_batch(self, rids, plens) -> list:
        """Decode many profiles in ONE native call (the per-read ctypes
        round trip dominates fetch cost).  ``plens`` are the reads'
        profile lengths (rlen - K + 1, or 0); a profile of another length
        raises the reference's profile/read mismatch (``mismatch_error``,
        its rlen taken as plen + K - 1) for the first such read."""
        from classpro_tpu_torch.native import get_lib

        lib = get_lib()
        n = len(rids)
        if not n:
            return []
        addr, nb = self.ranges(rids)
        caps = np.asarray(plens, np.int32)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(caps, out=offs[1:])
        cat = np.empty(int(offs[-1]), np.uint16)
        out_n = np.empty(n, np.int32)
        # offsets from the lowest address: one batch over every part
        base = int(addr.min())
        lo = addr - base
        hi = lo + nb
        lib.cp_decode_profile_batch(
            base, lo.ctypes.data, hi.ctypes.data, n,
            cat.ctypes.data, offs.ctypes.data, caps.ctypes.data,
            out_n.ctypes.data)
        bad = np.flatnonzero(out_n != caps)
        if bad.size:
            j = int(bad[0])
            raise mismatch_error(int(rids[j]), int(caps[j]) + self.kmer - 1,
                                 int(out_n[j]), self.kmer)
        return [cat[offs[j]: offs[j + 1]] for j in range(n)]

    def __len__(self) -> int:
        return self.nreads

    def __iter__(self):
        for rid in range(self.nreads):
            yield self.fetch(rid)


def open_profiles(root: str) -> ProfileIndex:
    return ProfileIndex(root)


def write_profiles(
    root: str, profiles: Sequence[np.ndarray], kmer: int, nparts: int = 1
) -> None:
    """Write a FASTK profile set readable by the reference binary.

    Splits ``profiles`` into ``nparts`` contiguous parts (mirroring
    FastK's thread-sharded layout)."""
    stub = root if root.endswith(".prof") else root + ".prof"
    base = stub[: -len(".prof")]
    n = len(profiles)
    with open(stub, "wb") as f:
        f.write(struct.pack("<ii", kmer, nparts))
    per = (n + nparts - 1) // nparts
    for p in range(nparts):
        chunk = profiles[p * per : (p + 1) * per]
        blobs = [encode_profile(c) for c in chunk]
        offsets = np.cumsum([len(b) for b in blobs]).astype("<i8")
        with open(_hidden(base, f"pidx.{p + 1}"), "wb") as f:
            f.write(struct.pack("<i", kmer))
            f.write(struct.pack("<qq", 0, len(chunk)))
            offsets.tofile(f)
        with open(_hidden(base, f"prof.{p + 1}"), "wb") as f:
            for b in blobs:
                f.write(b)
