"""The input of ``classify``, part by part, on the card.

Times the feed of a checkout's ``classify`` over one FASTX file and its
FASTK root, ms a pass, as a process of its own, and prints one JSON line.
Run it with the checkout to time first on the path (so a parent
checkout can be timed with this script)::

    PYTHONPATH=<checkout> python3 classpro_tpu_torch/devtools/input_parts.py \\
        FASTA ROOT PASSES STREAM_PASSES

A checkout with the streaming reader (``io.fastx.FastxReader``) times its
own ``fastx_chunks``: the reader's read(2), inflate and scan clocks, the
Python around the reader call, the profile ranges; the decode is in its
wall stage.  A checkout from before it runs its classify's feed step by
step, as its ``fastx_chunks`` and whole-file reader did: np.fromfile,
``cp_gzip_inflate``, the newline count, ``cp_fastx_parse``, the record
objects, the length check and the chunk lists, ``fetch_batch`` with its
length check.  Each part per pass, alone (the feed drained, PASSES
passes) and on the prefetch thread while the stream runs on the card
(sort_window 8, STREAM_PASSES passes, after two warm-up passes); then,
alone, the main thread's parts of the same reads: the per-read encode
(before the reader), the sort window's per-read list work, the wall
stage (with the reader: with the decode in it, beside the same reads on
decoded profiles), and the output's records and write.  Also which
inflate the host library was built with and, with the reader, its
capacity; and the process's resident growth above the start of each
timed block (sampled every 2 ms).
"""
from __future__ import annotations

import collections
import ctypes
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

PARTS = ("file_read", "inflate", "newline_count", "parse", "records",
         "length_check", "chunk_python", "ranges", "decode")
MAIN_PARTS = ("encode", "sorted_lists", "wall_stage", "wall_stage_plain",
              "output")
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
    """The checkout's feed over ``fasta``: ``chunks()`` yields (what the
    output's records come from, what the stream takes) per chunk and
    adds each part's seconds to ``acc``."""

    def __init__(self, fasta: str, root: str):
        from classpro_tpu_torch.constants import DEFAULTS
        from classpro_tpu_torch.estimation import build_global_model
        from classpro_tpu_torch.io import fastx as FX
        from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
        from classpro_tpu_torch.native import get_lib

        self.FX, self.lib = FX, get_lib()
        self.new = hasattr(FX, "FastxReader")
        with open("/proc/self/maps") as f:
            maps = f.read()
        self.inflate = ("zlib streaming (FastxReader)" if self.new else
                        "libdeflate" if "libdeflate" in maps
                        else "zlib (whole file)")
        self.fasta = fasta
        self.gm = build_global_model(load_histogram(root))
        self.P = open_profiles(root)
        self.K, self.max_len = self.gm.kmer, DEFAULTS.max_read_len
        self.acc: collections.Counter = collections.Counter()

    def chunks(self):
        return self._new() if self.new else self._old()

    def _new(self):
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
            yield c, c
        st = rd.stats()
        rd.close()
        acc["file_read"] += st["read_s"]
        acc["inflate"] += st["inflate_s"]
        acc["parse"] += st["scan_s"]
        acc["chunk_python"] += (call - st["read_s"] - st["inflate_s"]
                                - st["scan_s"])
        acc["capacity"] = max(acc["capacity"], st["capacity"])

    def _flush(self, chunk, rid0):
        t = clk()
        plens = [max(len(r.seq) - self.K + 1, 0) for r in chunk]
        profs = self.P.fetch_batch(list(range(rid0, rid0 + len(chunk))),
                                   plens)
        for j, p in enumerate(profs):
            if len(p) != plens[j]:
                raise ValueError(f"Read {rid0 + j}: profile/read mismatch")
        self.acc["decode"] += clk() - t
        return [r.seq for r in chunk], profs

    def _old(self):
        acc, lib, fasta = self.acc, self.lib, self.fasta
        t = clk()
        raw = np.fromfile(fasta, dtype=np.uint8)
        acc["file_read"] += clk() - t
        buf = raw
        if fasta.endswith(".gz"):
            t = clk()
            cap = max(int(np.frombuffer(raw[-4:], "<u4")[0]), 1)
            while True:
                buf = np.empty(cap, np.uint8)
                n = lib.cp_gzip_inflate(raw.ctypes.data, len(raw),
                                        buf.ctypes.data, cap)
                if n <= cap:
                    buf = buf[:n]
                    break
                cap = n
            acc["inflate"] += clk() - t
        t = clk()
        max_rec = int(np.count_nonzero(buf == 0x0A)) // 2 + 2
        acc["newline_count"] += clk() - t
        t = clk()
        meta = np.empty(8 * max_rec, np.int64)
        seq = np.empty(len(buf), np.uint8)
        nrec = lib.cp_fastx_parse(buf.ctypes.data, len(buf), max_rec,
                                  meta.ctypes.data, seq.ctypes.data)
        acc["parse"] += clk() - t
        t = clk()
        bv, sv, recs = memoryview(buf), memoryview(seq), []
        for i in range(int(nrec)):
            m = meta[8 * i: 8 * i + 8]
            recs.append(self.FX.FastxRecord(
                str(bv[m[0]: m[0] + m[1]], "ascii"),
                str(bv[m[2]: m[2] + m[3]], "ascii"),
                str(sv[m[4]: m[4] + m[5]], "ascii"), None))
        acc["records"] += clk() - t
        chunk, rid, t = [], 0, clk()
        for rec in recs:
            if len(rec.seq) > self.max_len:
                raise ValueError("rlen > MAX_READ_LEN")
            chunk.append(rec)
            rid += 1
            if len(chunk) >= B:
                acc["length_check"] += clk() - t
                yield chunk, self._flush(chunk, rid - len(chunk))
                chunk, t = [], clk()
        acc["length_check"] += clk() - t
        if chunk:
            yield chunk, self._flush(chunk, rid - len(chunk))


def per_pass(acc, n: int) -> dict:
    out = {k: acc[k] / n * 1e3 for k in PARTS}
    out["total"] = sum(out.values())
    return out


def main_thread(feed: Feed, eng, passes: int) -> dict:
    """The main thread's parts of ``passes`` passes, alone, ms a pass."""
    from classpro_tpu_torch import engine as E
    from classpro_tpu_torch.io.classfile import (ClassRecord, class_header,
                                                 write_class)

    main: collections.Counter = collections.Counter()
    wall, P = eng.wall, feed.P
    for _ in range(passes):
        items = list(feed.chunks())
        if feed.new:
            t = clk()
            subs = []
            for k in range(0, len(items), W):
                win = [c for c, _ in items[k:k + W]]
                wb = E.read_batch(win)
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
                    b.seq_addr[g], b.seq_len[g], b.prof_addr[g],
                    b.prof_nb[g], b.plen[g], threads=eng.threads)[0]
                main["wall_stage"] += clk() - t
                wall.release_slab(slab)
                profs = P.fetch_batch(b.rid[g], b.plen[g])
                seqs = [ctypes.string_at(int(b.seq_addr[i]),
                                         int(b.seq_len[i])) for i in g]
                t = clk()
                slab = wall.wall_stage_slab(seqs, profs,
                                            threads=eng.threads)[0]
                main["wall_stage_plain"] += clk() - t
                wall.release_slab(slab)
            t = clk()
            with tempfile.NamedTemporaryFile("w") as f:
                write_class(f.name, (
                    r for c, _ in items for r in E.chunk_records(
                        c, ["E" * int(n) for n in c.seq_len])))
            main["output"] += clk() - t
            continue
        t = clk()
        subs = []
        for k in range(0, len(items), W):
            win = [it for _, it in items[k:k + W]]
            seqs = [s for ss, _ in win for s in ss]
            profs = [p for _, pp in win for p in pp]
            order = sorted(range(len(seqs)), key=lambda i: len(profs[i]))
            for j in range(0, len(order), B):
                idx = order[j:j + B]
                subs.append(([seqs[i] for i in idx],
                             [profs[i] for i in idx]))
            flat = ["E"] * len(order)
            unsort = [None] * len(flat)
            for j, i in enumerate(order):
                unsort[i] = flat[j]
        main["sorted_lists"] += clk() - t
        for sq, pf in subs:
            g = sorted([i for i in range(len(sq)) if len(pf[i])],
                       key=lambda i: len(pf[i]))
            t = clk()
            enc = [sq[i].encode("ascii") for i in g]
            main["encode"] += clk() - t
            t = clk()
            slab = wall.wall_stage_slab(enc, [pf[i] for i in g],
                                        threads=eng.threads)[0]
            main["wall_stage"] += clk() - t
            wall.release_slab(slab)
        t = clk()
        with tempfile.NamedTemporaryFile("w") as f:
            write_class(f.name, (ClassRecord(class_header(r.name, r.comment),
                                             r.seq, "E" * len(r.seq))
                                 for recs, _ in items for r in recs))
        main["output"] += clk() - t
    return {k: main[k] / passes * 1e3 for k in MAIN_PARTS}


def measure(fasta: str, root: str, passes: int, spasses: int) -> dict:
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
    rec = {"tree": ("streaming reader" if feed.new
                    else "whole-file reader"),
           "inflate": feed.inflate, "alone": per_pass(acc, passes)}
    rec["alone"]["wall"] = (clk() - t) / passes * 1e3
    rec["alone"]["rss_growth_mb"] = alone_rss.growth_mb
    if feed.new:
        rec["reader_capacity"] = int(acc["capacity"])

    # under the stream: the feed on the engine's prefetch thread
    eng = E.TorchEngine(feed.gm, batch_size=B, device="cuda")

    def stream_passes(n):
        src = (item for _ in range(n) for _, item in feed.chunks())
        for _ in eng.classify_stream(src, sort_window=W):
            pass
        torch.cuda.synchronize()
    stream_passes(2)                   # warm-up: the buckets' graphs
    acc.clear()
    t = clk()
    with RssPeak() as stream_rss:
        stream_passes(spasses)
    wall = clk() - t
    kmers = int(sum(int(c.plen[:c.n].sum()) if feed.new else
                    sum(len(p) for p in item[1]) for c, item in first))
    rec["stream"] = per_pass(acc, spasses)
    rec["stream"]["pass_ms"] = wall / spasses * 1e3
    rec["stream"]["rss_growth_mb"] = stream_rss.growth_mb
    rec["stream"]["kmers_per_s"] = kmers * spasses / wall
    rec["main_thread"] = main_thread(feed, eng, passes)
    return rec


def main(argv=None) -> int:
    a = sys.argv[1:] if argv is None else argv
    print(json.dumps(measure(a[0], a[1], int(a[2]), int(a[3]))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
