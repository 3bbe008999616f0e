"""The input and output of ``classify``, part by part, on the card.

Times the feed and the output of a checkout's ``classify`` over one FASTX
file and its FASTK root, ms a pass, as a process of its own, and prints
one JSON line.  Run it with the checkout to time first on the path (so
a parent checkout can be timed with this script)::

    PYTHONPATH=<checkout> python3 classpro_tpu_torch/devtools/input_parts.py \\
        FASTA ROOT PASSES STREAM_PASSES [ROUTES]

The feed is the checkout's ``fastx_chunks``: the streaming reader's
(``io.fastx.FastxReader``) read(2), inflate and scan clocks, the Python
around the reader call and the profile ranges; the decode is in the wall
stage.  Each part per pass, alone (the feed drained, PASSES passes) and
on the prefetch thread while the stream runs on the card (sort_window 8,
STREAM_PASSES passes, after two warm-up passes); then, alone, the main
thread's parts of the same reads: the sort window's per-read list work
and the wall stage (with the decode in it, beside the same reads on
decoded profiles).  Also the reader's capacity and the process's
resident growth above the start of each timed block (sampled every 2
ms).

The output, route by route (ROUTES, comma-separated, default
``records,writer``), alone (class lines made before the clock starts,
PASSES passes) and under the stream (the stream with that output, as
``classify`` writes it: ``pass_ms``, beside the stream alone), ms a
pass, with the file's sha256 so that routes and trees can be held equal:

- ``records``: the record route, which ``classify`` took before the
  output plane and ``-s``, DAZZ, ``--engine exact`` and the tools still
  take: each chunk's ClassRecords (``engine.chunk_records``:
  ``records``) written by ``io.classfile.write_class``
  (``format_write``), both on the main thread;
- ``writer``: the output plane: each chunk's reader buffers and class
  buffers handed to ``io.classfile.ClassWriter`` (``handover``: the main
  thread's puts; ``close``: its wait for the file to be complete), whose
  thread composes (``compose``, one C++ call a chunk), writes
  (``write``, write(2)) and runs the Python around them (``python``).
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

PARTS = ("file_read", "inflate", "parse", "chunk_python", "ranges")
MAIN_PARTS = ("sorted_lists", "wall_stage", "wall_stage_plain")
# each output route's parts
OUT_PARTS = {"records": ("records", "format_write"),
             "writer": ("handover", "close", "compose", "write", "python")}
B = 200          # classify's batch
W = 8            # classify's sort window
clk = time.perf_counter


class RssPeak:
    """The process's resident bytes sampled every 2 ms inside the block:
    ``growth_mb``, its peak above the bytes resident when the block
    began."""

    PAGE = os.sysconf("SC_PAGE_SIZE")

    @classmethod
    def rss(cls) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * cls.PAGE

    def __enter__(self):
        self.base = self.peak = self.rss()
        self.stop = threading.Event()

        def run():
            while not self.stop.wait(0.002):
                self.peak = max(self.peak, self.rss())
        self.th = threading.Thread(target=run, daemon=True)
        self.th.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.th.join()
        self.peak = max(self.peak, self.rss())
        self.growth_mb = (self.peak - self.base) / 2**20


class Feed:
    """The checkout's feed over ``fasta``: ``chunks()`` yields its reader
    chunks, each with its profile ranges, and adds each part's seconds to
    ``acc``."""

    def __init__(self, fasta: str, root: str):
        from classpro_tpu_torch.constants import DEFAULTS
        from classpro_tpu_torch.estimation import build_global_model
        from classpro_tpu_torch.io import fastx as FX
        from classpro_tpu_torch.io.fastk import load_histogram, open_profiles

        self.FX = FX
        self.fasta = fasta
        self.gm = build_global_model(load_histogram(root))
        self.P = open_profiles(root)
        self.K, self.max_len = self.gm.kmer, DEFAULTS.max_read_len
        self.acc: collections.Counter = collections.Counter()

    def chunks(self):
        acc, P = self.acc, self.P
        rd = self.FX.FastxReader(self.fasta, K=self.K, max_len=self.max_len)
        call = 0.0
        while True:
            t = clk()
            c = rd.next_chunk(B)
            call += clk() - t
            if rd.pending_error is not None:
                raise rd.pending_error
            if c is None:
                break
            t = clk()
            c.prof_addr, c.prof_nb = P.ranges(np.arange(c.rid0,
                                                        c.rid0 + c.n))
            c.profiles = P
            acc["ranges"] += clk() - t
            yield c
        st = rd.stats()
        rd.close()
        acc["file_read"] += st["read_s"]
        acc["inflate"] += st["inflate_s"]
        acc["parse"] += st["scan_s"]
        acc["chunk_python"] += (call - st["read_s"] - st["inflate_s"]
                                - st["scan_s"])
        acc["capacity"] = max(acc["capacity"], st["capacity"])


def per_pass(acc, n: int) -> dict:
    out = {k: acc[k] / n * 1e3 for k in PARTS}
    out["total"] = sum(out.values())
    return out


def main_thread(feed: Feed, eng, passes: int) -> dict:
    """The main thread's parts of ``passes`` passes, alone, ms a pass."""
    import ctypes

    from classpro_tpu_torch import engine as E

    main: collections.Counter = collections.Counter()
    wall, P = eng.wall, feed.P
    for _ in range(passes):
        items = list(feed.chunks())
        t = clk()
        subs = []
        for k in range(0, len(items), W):
            wb = E.read_batch(items[k:k + W])
            order = np.argsort(wb.plen, kind="stable")
            subs += [E._take(wb, order[j:j + B])
                     for j in range(0, len(order), B)]
            order = order.tolist()
            flat = ["E"] * len(order)
            unsort = [None] * len(flat)
            for j, i in enumerate(order):
                unsort[i] = flat[j]
        main["sorted_lists"] += clk() - t
        for b in subs:
            todo = np.flatnonzero(b.plen > 0)
            g = todo[np.argsort(b.plen[todo], kind="stable")]
            t = clk()
            slab = wall.wall_stage_fastk(
                b.seq_addr[g], b.seq_len[g], b.prof_addr[g], b.prof_nb[g],
                b.plen[g], threads=eng.threads)[0]
            main["wall_stage"] += clk() - t
            wall.release_slab(slab)
            profs = P.fetch_batch(b.rid[g], b.plen[g])
            seqs = [ctypes.string_at(int(b.seq_addr[i]), int(b.seq_len[i]))
                    for i in g]
            t = clk()
            slab = wall.wall_stage_slab(seqs, profs, threads=eng.threads)[0]
            main["wall_stage_plain"] += clk() - t
            wall.release_slab(slab)
    return {k: main[k] / passes * 1e3 for k in MAIN_PARTS}


def _tmp_file() -> str:
    fd, path = tempfile.mkstemp(suffix=".class")
    os.close(fd)
    return path


def _sha256_and_remove(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while b := f.read(1 << 22):
            h.update(b)
    os.unlink(path)
    return h.hexdigest()


def _buffer_classes(c):
    """A chunk's class lines as the finish stage leaves them for the
    writer: one buffer of 'E' a read."""
    from classpro_tpu_torch.io.classfile import ChunkClasses

    cc = ChunkClasses.none(c.seq_len)
    off = np.zeros(c.n, np.int64)
    np.cumsum(c.seq_len[:-1], out=off[1:])
    cc.put(np.arange(c.n), np.full(int(c.seq_len.sum()), ord("E"), np.uint8),
           off)
    return cc


def _write_records(path: str, pairs, acc) -> None:
    """The record route: ``pairs`` yields (chunk, one str a read); each
    chunk's ClassRecords, then ``write_class`` over them all as
    ``classify`` streamed them.  ``acc`` gets ``records`` and
    ``format_write`` (``write_class``'s time outside ``pairs``)."""
    from classpro_tpu_torch import engine as E
    from classpro_tpu_torch.io.classfile import write_class

    inside = 0.0

    def recs():
        nonlocal inside
        it = iter(pairs)
        while True:
            t = clk()
            item = next(it, None)
            if item is None:
                inside += clk() - t
                return
            t1 = clk()
            rs = list(E.chunk_records(*item))
            acc["records"] += clk() - t1
            inside += clk() - t
            yield from rs
    t = clk()
    write_class(path, recs())
    acc["format_write"] += clk() - t - inside


def _write_plane(path: str, pairs, acc) -> None:
    """The output plane: ``pairs`` yields (chunk, ChunkClasses), each put
    to a ``ClassWriter``.  ``acc`` gets the main thread's ``handover``
    and ``close`` and the writer thread's parts."""
    from classpro_tpu_torch.io.classfile import ClassWriter

    w = ClassWriter(path)
    for c, cc in pairs:
        t = clk()
        w.put(c, cc)
        acc["handover"] += clk() - t
    t = clk()
    w.close()
    acc["close"] += clk() - t
    for k, v in w.seconds.items():
        acc[k] += v


def output_alone(route: str, chunks, acc) -> str:
    """The output of ``chunks`` alone by ``route`` (class lines of 'E'
    made before the clock starts), seconds by part into ``acc``; returns
    the file's sha256."""
    path = _tmp_file()
    if route == "records":
        classes = [["E" * int(n) for n in c.seq_len] for c in chunks]
        _write_records(path, zip(chunks, classes), acc)
    else:
        classes = [_buffer_classes(c) for c in chunks]
        _write_plane(path, zip(chunks, classes), acc)
    return _sha256_and_remove(path)


def stream_with_output(route: str, feed: Feed, eng, passes: int) -> dict:
    """``passes`` passes of the stream with the output written by
    ``route`` as ``classify`` writes it (sort window 8), ms a pass: the
    pass, the output's parts, the file's sha256."""
    import torch

    from classpro_tpu_torch import engine as E

    acc: collections.Counter = collections.Counter()
    src = (c for _ in range(passes) for c in feed.chunks())
    path = _tmp_file()
    t = clk()
    if route == "records":
        held: collections.deque = collections.deque()

        def it():
            for c in src:
                held.append(c)
                yield c
        _write_records(path, ((held.popleft(), classes) for classes in
                              eng.classify_stream(it(), sort_window=W)),
                       acc)
    else:
        _write_plane(path, E.chunk_classes(eng, src, buffers=True), acc)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = clk() - t
    rec = {k: acc[k] / passes * 1e3 for k in OUT_PARTS[route]}
    rec.update(pass_ms=wall / passes * 1e3, sha256=_sha256_and_remove(path))
    return rec


def measure(fasta: str, root: str, passes: int, spasses: int,
            routes=("records", "writer")) -> dict:
    import torch

    from classpro_tpu_torch import engine as E

    feed = Feed(fasta, root)
    acc = feed.acc
    first = list(feed.chunks())
    acc.clear()
    t = clk()
    with RssPeak() as alone_rss:
        for _ in range(passes):
            for _ in feed.chunks():
                pass
    rec = {"alone": per_pass(acc, passes)}
    rec["alone"]["wall"] = (clk() - t) / passes * 1e3
    rec["alone"]["rss_growth_mb"] = alone_rss.growth_mb
    rec["reader_capacity"] = int(acc["capacity"])

    # under the stream: the feed on the engine's prefetch thread
    eng = E.TorchEngine(feed.gm, batch_size=B, device="cuda")

    def stream_passes(n):
        src = (c for _ in range(n) for c in feed.chunks())
        for _ in eng.classify_stream(src, sort_window=W):
            pass
        torch.cuda.synchronize()
    stream_passes(2)                   # warm-up: the buckets' graphs
    acc.clear()
    t = clk()
    with RssPeak() as stream_rss:
        stream_passes(spasses)
    wall = clk() - t
    kmers = int(sum(int(c.plen[:c.n].sum()) for c in first))
    rec["stream"] = per_pass(acc, spasses)
    rec["stream"]["pass_ms"] = wall / spasses * 1e3
    rec["stream"]["rss_growth_mb"] = stream_rss.growth_mb
    rec["stream"]["kmers_per_s"] = kmers * spasses / wall
    rec["main_thread"] = main_thread(feed, eng, passes)
    rec["output"] = {}
    for route in routes:
        alone: collections.Counter = collections.Counter()
        shas = {output_alone(route, list(feed.chunks()), alone)
                for _ in range(passes)}
        rec["output"][route] = {
            "alone": {k: alone[k] / passes * 1e3 for k in OUT_PARTS[route]},
            "alone_sha256": sorted(shas),
            "stream": stream_with_output(route, feed, eng, spasses)}
    return rec


def main(argv=None) -> int:
    a = sys.argv[1:] if argv is None else argv
    routes = tuple(a[4].split(",")) if len(a) > 4 else ("records", "writer")
    print(json.dumps(measure(a[0], a[1], int(a[2]), int(a[3]), routes)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
