"""Batched classification engine (the production path).

Stage split:
  host C++  (csrc/classpro_host.cpp): FASTK profile decode, sequence
            context, wall-detection walk, reliable-interval selection,
            the two unreliable-relaxation sweeps, and assignment ->
            class-character expansion: the branchy, irregular work.
  device    (rel.rel_only): the merged fw/bw reliable-interval Viterbi
            DP (the CUDA kernel csrc/rel_dp.cu) with the no-H rescue;
            demotion, reconciliation and the exactness guard follow on
            the host.

``TorchEngine(alldev=True)`` takes the all-device path instead (the JAX
package's ``_chunk_alldev``): after the C++ wall stage, each chunk is
packed by ``pack.pack_chunk`` and classified whole by
``alldev.classify_batch`` (DP, demotions, reconciliation and both
relaxation sweeps, the last as the kernel csrc/unrel.cu); the host
expands the assignments into class strings, and each read the device
flags is re-decided whole, exactly, by the C++ host plane.

The production entry is ``classify_stream``: a depth-3 software pipeline
in which chunk k+1's host stages overlap chunk k's device work.  On a
card each chunk's blobs go up from pinned host memory on the engine's
CUDA stream, the DP runs on that stream, the packed result comes back
into a pinned buffer, and an event recorded after the copy is what
``_finish`` waits on.  ``classify_chunk`` is the synchronous
single-chunk form.  Interval arrays are padded to bucketed shapes
(``_bucket``, ``_bucket_m``).  ``TorchEngine(devices=[...])`` deals whole
chunks round robin over several devices, each with its own tables,
stream and events (``_enqueue``).
"""

from __future__ import annotations

import collections
from typing import Iterator

import numpy as np
import torch

from classpro_tpu_torch.constants import DEFAULTS
from classpro_tpu_torch.device import canonical_device, resolve_device
from classpro_tpu_torch.estimation import GlobalModel, build_global_model
from classpro_tpu_torch.io.classfile import ClassRecord, class_header
from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
from classpro_tpu_torch.io.fastx import read_fastx_checked
from classpro_tpu_torch.native import NativeWall
from classpro_tpu_torch.pack import _bucket, expand_asgn, pack_chunk
from classpro_tpu_torch.params import build_replicas
from classpro_tpu_torch.rel import (DIPLO, HAPLO, demote_host,
                                    reconcile_fwbw, rel_only, unpack_out)


_M_LADDER = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


def _bucket_m(x: int) -> int:
    """Coarse interval-count buckets; each row runs only its own steps,
    so padding costs memory, not DP time."""
    for b in _M_LADDER:
        if x <= b:
            return b
    b = _M_LADDER[-1]
    while b < x:
        b *= 2
    return b


def local_devices(n: int, device=None) -> list | None:
    """The device list of ``--devices n``: ``cuda:0`` .. ``cuda:n-1``, or
    None for n = 0 (the single ``device``).  Raises when fewer than n
    cards exist, or when ``device`` is not CUDA: a silently smaller run
    would hide the device count."""
    if n <= 0:
        return None
    if resolve_device(device).type != "cuda":
        raise ValueError("--devices round-robins over CUDA cards; it "
                         "needs --device cuda")
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"--devices {n}: only {have} CUDA device(s) "
                         f"present")
    return [torch.device("cuda", i) for i in range(n)]


def _prefetch_iter(chunks, depth: int):
    """Re-yield ``chunks`` produced on a background thread through a
    bounded queue (order preserved; generator exceptions re-raised at
    the consumer), so input production (file parse, profile decode)
    overlaps the consumer's host stages and device waits."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()

    def produce():
        try:
            for c in chunks:
                q.put(c)
            q.put(_END)
        except BaseException as e:  # re-raised below, in order
            q.put(e)

    threading.Thread(target=produce, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


class TorchEngine:
    """``devices`` (a list, which may repeat a device) round-robins whole
    chunks over those devices (the JAX package's ``TpuEngine(devices=)``):
    each distinct device holds its own replica of the tables and its own
    CUDA stream, each chunk runs entirely on the device it was dealt, and
    no chunk talks to another.  ``None`` is the single ``device``."""

    def __init__(self, gm: GlobalModel, batch_size: int = 200,
                 threads: int = 0, verbose: bool = False, device=None,
                 alldev: bool = False, devices=None):
        if devices:
            self.devices = [canonical_device(d) for d in devices]
            self.device = self.devices[0]
        else:
            self.devices = None
            self.device = canonical_device(device)
        self.gm = gm
        self.batch_size = batch_size
        self.threads = threads      # host-side C++ worker count (-T)
        self.verbose = verbose
        # the C++ host plane; a failed native build raises (no fallback)
        self.wall = NativeWall(gm)
        # per distinct device: (RelParams, the all-device path's
        # PipelineParams or None, CUDA stream or None); each replica holds
        # the 94.6 MB Skellam table, shared by its DP and sweep tables
        self._on: dict = {}
        for dev, rep in build_replicas(gm, self.devices or [self.device],
                                       alldev).items():
            P, PP = (rep.rel, rep) if alldev else (rep, None)
            stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
            self._on[dev] = (P, PP, stream)
        self.P, self.PP, _ = self._on[self.device]
        self._rr = 0
        # the (R, max_m) buckets the device ran, in first-use order
        self.shapes: dict = {}
        # exactness-guard telemetry: reads recomputed by the exact
        # oracle, and the smallest positive decision margin observed
        self.guard_flagged = 0
        self.guard_min_margin = float("inf")
        self.chunks_done = 0

    def _next_device(self) -> torch.device:
        """The device of the next chunk (round robin over ``devices``)."""
        if not self.devices:
            return self.device
        dev = self.devices[self._rr % len(self.devices)]
        self._rr += 1
        return dev

    def stats(self) -> dict:
        """Stream telemetry (the JAX engine's --stats-json keys): chunks,
        the exactness guard's flag count and smallest positive margin,
        the (R, max_m) buckets run, and absorbed_chunks, always 0 (the
        port has no shape absorption)."""
        return dict(
            chunks=self.chunks_done, absorbed_chunks=0,
            guard_flagged=int(self.guard_flagged),
            min_margin=(None if self.guard_min_margin == float("inf")
                        else float(self.guard_min_margin)),
            shapes=[list(k) for k in self.shapes])

    # ------------------------------------------------------------------
    def classify_chunk(self, seqs: list[str],
                       profiles: list[np.ndarray]) -> list[str]:
        """Synchronous single-chunk classification (= one submit +
        finish of the pipelined stream)."""
        return self._finish(self._submit(seqs, profiles))

    def classify_stream(self, chunks, prefetch: int = 2,
                        sort_window: int = 0):
        """Yield one list of class strings per (seqs, profiles) chunk,
        in order, with cross-chunk host/device overlap (three chunks in
        flight: host k+1 || device k || finish k-1).

        ``prefetch`` > 0 pulls the input iterable on a bounded
        background thread.  ``sort_window`` > 1 re-composes device
        batches from windows of that many input chunks, ordered by
        profile length (each DP warp runs as long as its longest row),
        and re-assembles the results into the original chunk structure
        and order, so output bytes are unchanged."""
        if sort_window > 1:
            yield from self._sorted_stream(chunks, prefetch, sort_window)
            return
        if prefetch > 0:
            chunks = _prefetch_iter(chunks, prefetch)
        # depth 3 covers one device (host k+1 || device k || finish
        # k-1); with N round-robin devices ~2 chunks stay in flight per
        # device, as in the JAX engine
        depth = max(3, 2 * len(self.devices) + 1) if self.devices else 3
        pending: collections.deque = collections.deque()
        for seqs, profiles in chunks:
            pending.append(self._submit(seqs, profiles))
            if len(pending) >= depth:
                yield self._finish(pending.popleft())
        while pending:
            yield self._finish(pending.popleft())

    def _sorted_stream(self, chunks, prefetch: int, W: int):
        """classify_stream body for sort_window: flatten windows of W
        input chunks, order reads by profile length, run the same
        pipeline over the re-composed batches, then un-sort each
        window's results back into the original chunk structure."""
        import itertools

        B = self.batch_size
        if prefetch > 0:
            chunks = _prefetch_iter(chunks, prefetch)
        win_meta: list = []    # (orig chunk sizes, sort order, n subchunks)

        def sorted_chunks():
            it = iter(chunks)
            while True:
                win = list(itertools.islice(it, W))
                if not win:
                    return
                seqs = [s for ss, _ in win for s in ss]
                profs = [p for _, pp in win for p in pp]
                order = sorted(range(len(seqs)),
                               key=lambda i: len(profs[i]))
                subs = [order[k: k + B] for k in range(0, len(order), B)]
                win_meta.append(([len(ss) for ss, _ in win], order,
                                 len(subs)))
                for idx in subs:
                    yield ([seqs[i] for i in idx],
                           [profs[i] for i in idx])

        # the generator runs ahead of the consumer (three chunks in
        # flight), so win_meta[wi] exists when its last subchunk finishes
        pending: list = []
        wi = 0
        for res in self.classify_stream(sorted_chunks(), prefetch=0):
            pending.append(res)
            sizes, order, nsub = win_meta[wi]
            if len(pending) < nsub:
                continue
            flat = [c for r in pending for c in r]
            unsort = [None] * len(flat)
            for j, i in enumerate(order):
                unsort[i] = flat[j]
            off = 0
            for sz in sizes:
                yield unsort[off: off + sz]
                off += sz
            pending = []
            wi += 1

    # ------------------------------------------------------------------
    def _stage(self, seqs, profiles):
        """Wall stage (C++) for one chunk, with the natural (R, max_m)
        bucket of its reliable intervals (no device work yet)."""
        todo = [i for i in range(len(seqs)) if len(profiles[i]) > 0]
        st = {"seqs": seqs, "profiles": profiles, "todo": todo}
        if not todo:
            return st
        g = sorted(todo, key=lambda i: len(profiles[i]))
        slab, n_out, n_rel, slot = self.wall.wall_stage_slab(
            [seqs[i].encode("ascii") for i in g],
            [profiles[i] for i in g], threads=self.threads)
        st.update(g=g, slab=slab, n_out=n_out, n_rel=n_rel, slot=slot,
                  max_m=0)
        sel_n = int((n_rel > 0).sum())
        if sel_n:
            st["_plens"] = np.array([len(profiles[i]) for i in g],
                                    np.int64)
            st["_R"] = _bucket(sel_n)
            st["_mm"] = _bucket_m(int(n_rel.max()))
        return st

    def _pack_st(self, st, R: int, max_m: int):
        """C++ rel pack for a staged chunk at the given bucket; records
        the views the host-side fw/bw reconciliation needs."""
        fb, ib = self.wall.pack_rel(st["slab"], st["slot"], st["n_out"],
                                    st["n_rel"], st["_plens"], R, max_m)
        st["max_m"] = max_m
        sz = R * max_m
        st["rel_b"] = ib[0:sz].reshape(R, max_m)
        st["rel_e"] = ib[sz:2 * sz].reshape(R, max_m)
        st["rel_ccb"] = ib[2 * sz:3 * sz].reshape(R, max_m)
        st["rel_cce"] = ib[3 * sz:4 * sz].reshape(R, max_m)
        st["rel_m"] = ib[4 * sz:4 * sz + R]
        return fb, ib

    def stage_pack(self, seqs, profiles):
        """The rel blobs one chunk sends to the device: (fblob, iblob, R,
        max_m), or None when no read has a reliable interval."""
        st = self._stage(seqs, profiles)
        if "_plens" not in st:
            return None
        fb, ib = self._pack_st(st, st["_R"], st["_mm"])
        return fb, ib, st["_R"], st["_mm"]

    def _submit(self, seqs, profiles):
        """Wall stage + rel pack (both C++) + the chunk's device work,
        enqueued without waiting for it."""
        st = self._stage(seqs, profiles)
        self.chunks_done += 1
        if self.PP is not None:
            return self._submit_alldev(st)
        if "_plens" not in st:
            return st
        R, max_m = st["_R"], st["_mm"]
        fb, ib = self._pack_st(st, R, max_m)
        self.shapes[(R, max_m)] = None
        return self._enqueue(st, fb, ib, "out", lambda f, i, P, PP:
                             rel_only(f, i, P, R, max_m))

    def _submit_alldev(self, st):
        """Pack the staged chunk's reads that have intervals and enqueue
        classify_batch on them (the JAX package's _dispatch)."""
        from classpro_tpu_torch.alldev import classify_batch

        if "g" not in st:
            return st
        g, slab, slot, n_out = st["g"], st["slab"], st["slot"], st["n_out"]
        rows = [r for r in range(len(g)) if n_out[r] > 0]
        if not rows:
            return st
        ivs = [slab[r * slot: r * slot + int(n_out[r])] for r in range(len(g))]
        plens = [len(st["profiles"][i]) for i in g]
        fb, ib, dims, st["meta"] = pack_chunk(rows, ivs, plens)
        self.shapes[(dims[2] // 2, dims[3])] = None

        def run(f, i, P, PP):
            out, flags = classify_batch(f, i, PP, *dims)
            return torch.cat([out.view(torch.uint8),
                              flags.to(torch.uint8)[:, None]], dim=1)

        return self._enqueue(st, fb, ib, "un", run)

    def _enqueue(self, st, fb, ib, key: str, run):
        """Deal the chunk to the next device and run ``run(fblob, iblob,
        P, PP)`` (-> uint8 tensor) there with that device's tables; the
        result lands in ``st[key]``.  On a card the blobs go up from
        pinned host memory on the device's own stream, the result comes
        back into a pinned buffer, and the event recorded after that copy
        (``st["done"]``) is what _finish waits on."""
        dev = st["dev"] = self._next_device()
        P, PP, stream = self._on[dev]
        if stream is None:
            st[key] = run(torch.from_numpy(fb), torch.from_numpy(ib), P, PP)
            return st
        fb_h = torch.from_numpy(fb).pin_memory()
        ib_h = torch.from_numpy(ib).pin_memory()
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            res = run(fb_h.to(dev, non_blocking=True),
                      ib_h.to(dev, non_blocking=True), P, PP)
            host = torch.empty(res.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(res, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        st.update({key: host, "done": done})
        return st

    def _finish_alldev(self, st) -> list[str]:
        """Class strings of an all-device chunk, in g order: expand the
        interval assignments, re-decide the flagged reads exactly."""
        g = st["g"]
        res_g = [""] * len(g)
        if "meta" in st:
            if "done" in st:
                st["done"].synchronize()
            buf = st["un"].numpy()
            out, flags = buf[:, :-1].view(np.int8), buf[:, -1] != 0
            expand_asgn(out, st["meta"], res_g, self.gm.kmer)
            for p, r in enumerate(st["meta"][0]):
                if flags[p]:
                    self.guard_flagged += 1
                    res_g[r] = self._exact_full(st, r)
        return res_g

    def _exact_full(self, st, r: int) -> str:
        """Whole-read exact classification of staged read ``r`` (the
        all-device path's guard): the C++ exact rel oracle on its rel
        records, then the C++ relaxation and expansion of that read
        alone."""
        slab, slot = st["slab"], st["slot"]
        n_out = st["n_out"][r:r + 1]
        n_rel = st["n_rel"][r:r + 1]
        recs = slab[r * slot: (r + 1) * slot]
        rel_recs = recs[: int(n_out[0])]
        rel_recs = rel_recs[rel_recs["is_rel"] != 0]
        rel_out = None
        if n_rel[0] > 0:
            plen = len(st["profiles"][st["g"][r]])
            rel_out = self.wall.exact_rel(rel_recs, plen)[None, :]
        out_off = np.array([0, len(st["seqs"][st["g"][r]])], np.int64)
        buf = self.wall.finish_batch(recs, slot, n_out, n_rel, rel_out,
                                     max(len(rel_recs), 1), out_off,
                                     threads=1)
        return str(memoryview(buf), "ascii")

    def _exact_guard(self, st, rel_out) -> None:
        """Host-exact recompute of flagged rows (in place)."""
        # margin EXACTLY 0 = a bit-equal (same-expression) tie that
        # resolves first-wins identically on device and in C: exempt.
        # The risky comparison ran on the device in f64 (rel.pack_out);
        # the fetched f32 margin is telemetry only.
        R = rel_out.shape[0]
        mm = st["mm"]
        pos = mm[(mm > 0.0) & np.isfinite(mm)]
        if pos.size:
            self.guard_min_margin = min(self.guard_min_margin,
                                        float(pos.min()))
        flagged = st["risky"][:R] | st["risky"][R:]
        if not flagged.any():
            return
        self.guard_flagged += int(flagged.sum())
        if self.verbose:
            import sys

            print(f"exactness guard: {int(flagged.sum())} read(s) within "
                  f"the decision-margin epsilon — recomputing exactly on "
                  f"the host", file=sys.stderr)
        slab, slot = st["slab"], st["slot"]
        n_out, n_rel = st["n_out"], st["n_rel"]
        live = np.nonzero(n_rel > 0)[0]          # row j -> slab read
        for j in np.nonzero(flagged)[0]:
            if j >= len(live):
                continue                          # padded dead row
            i = int(live[j])
            recs = slab[i * slot: i * slot + int(n_out[i])]
            rel_recs = recs[recs["is_rel"] != 0]
            rel_out[j, :len(rel_recs)] = self.wall.exact_rel(
                rel_recs, int(st["_plens"][i]))

    def _finish(self, st) -> list[str]:
        """Wait for the chunk's device result, run the host rel steps,
        then ONE C++ call: scatter rel assignments, relaxation sweeps,
        class expansion."""
        seqs = st["seqs"]
        res = [""] * len(seqs)
        if "g" in st and self.PP is not None:
            for i, c in zip(st["g"], self._finish_alldev(st)):
                res[i] = c
            self.wall.release_slab(st["slab"])
        elif "g" in st:
            g, slab, slot = st["g"], st["slab"], st["slot"]
            n_out, n_rel = st["n_out"], st["n_rel"]
            rel_out = None
            if "out" in st:
                if "done" in st:
                    st["done"].synchronize()
                v, st["risky"], rescue, st["mm"] = unpack_out(
                    st["out"].numpy(), st["max_m"])
                # the integer demotions (class_rel.c:650-713) and the
                # hdrr-tie reconciliation run on the host, exact
                v = demote_host(v, rescue, st["rel_b"], st["rel_e"],
                                st["rel_ccb"], st["rel_cce"], st["rel_m"],
                                int(self.gm.cov[HAPLO]),
                                int(self.gm.cov[DIPLO]))
                rel_out = reconcile_fwbw(v, st["rel_ccb"], st["rel_cce"],
                                         st["rel_m"])
                self._exact_guard(st, rel_out)
            out_off = np.zeros(len(g) + 1, np.int64)
            out_off[1:] = np.cumsum([len(seqs[i]) for i in g])
            buf = self.wall.finish_batch(slab, slot, n_out, n_rel,
                                         rel_out, st["max_m"], out_off,
                                         threads=self.threads)
            self.wall.release_slab(slab)
            mv = memoryview(buf)  # str() decodes straight from the slab
            for r, i in enumerate(g):
                res[i] = str(mv[out_off[r]: out_off[r + 1]], "ascii")
        for i in range(len(seqs)):
            if not res[i]:
                res[i] = "N" * len(seqs[i])
        return res


def classify_file_torch(fastx_path: str, fastk_root: str, coverage: int = 0,
                        read_len: int = 20000, model_path: str | None = None,
                        batch_size: int = 200, threads: int = 0,
                        verbose: bool = False, device=None,
                        devices: int = 0, stats_out: dict | None = None
                        ) -> Iterator[ClassRecord]:
    """Classify a FASTX file against its FASTK root; yields one
    ClassRecord per read, in input order.  ``devices`` > 0 round-robins
    the chunks over ``cuda:0`` .. ``cuda:devices-1`` (``local_devices``:
    raises when fewer cards exist).  Set-up (model, engine, device
    tables) runs eagerly at call time; the stream is the returned
    generator."""
    hist = load_histogram(fastk_root)
    gm = build_global_model(hist, coverage=coverage, read_len=read_len,
                            model_path=model_path)
    P = open_profiles(fastk_root)
    if P.kmer != gm.kmer:
        raise ValueError(f"{fastk_root}: .hist k-mer size ({gm.kmer}) != "
                         f".prof k-mer size ({P.kmer})")
    eng = TorchEngine(gm, batch_size=batch_size, threads=threads,
                      verbose=verbose, device=device,
                      devices=local_devices(devices, device))
    recs: list = []
    K = gm.kmer

    def flush(chunk, rid0):
        recs.append(chunk)
        plens = [max(len(r.seq) - K + 1, 0) for r in chunk]
        profs = P.fetch_batch(list(range(rid0, rid0 + len(chunk))), plens)
        for j, p in enumerate(profs):   # ClassPro.c:184-187 rlen check
            if len(p) != plens[j]:
                rlen = len(chunk[j].seq)
                raise ValueError(
                    f"Read {rid0 + j}: rlen ({rlen}) != plen+Km1 "
                    f"({len(p) + K - 1}) — profile/read mismatch")
        return [r.seq for r in chunk], profs

    def chunk_iter():
        chunk: list = []
        rid = 0
        for rec in read_fastx_checked(fastx_path, DEFAULTS.max_read_len):
            chunk.append(rec)
            rid += 1
            if len(chunk) >= batch_size:
                yield flush(chunk, rid - len(chunk))
                chunk = []
        if chunk:
            yield flush(chunk, rid - len(chunk))

    def stream():
        import time as _time

        t0 = _time.time()
        # sort_window=8: device batches composed from plen-ordered
        # windows (same bytes, shorter longest-row per batch)
        for classes in eng.classify_stream(chunk_iter(), sort_window=8):
            chunk_recs = recs.pop(0)
            for rec, cls in zip(chunk_recs, classes):
                yield ClassRecord(class_header(rec.name, rec.comment),
                                  rec.seq, cls)
        if stats_out is not None:
            stats_out.update(stream_wall_s=_time.time() - t0, **eng.stats())

    return stream()
