"""Batched classification engine (the production path).

Stage split:
  host C++  (csrc/classpro_host.cpp): FASTK profile decode, sequence
            context, wall-detection walk, reliable-interval selection,
            the two unreliable-relaxation sweeps, and assignment ->
            class-character expansion: the branchy, irregular work.
  device    (rel.rel_only): the merged fw/bw reliable-interval Viterbi
            DP (the CUDA kernel csrc/rel_dp.cu) with the no-H rescue;
            demotion, reconciliation and the exactness guard follow on
            the host.  On a card a chunk is one replay of its bucket's
            CUDA graph (rel.ChunkGraph: the DP kernel's two launches),
            captured once per (device, R, max_m) for the engine's tables,
            at warm-up or first use.

``TorchEngine(alldev=True)`` takes the all-device path instead (the JAX
package's ``_chunk_alldev``): after the C++ wall stage, each chunk is
packed by the C++ host plane (``NativeWall.pack_chunk``, on the -T
workers; ``pack.pack_chunk`` is its plain version) and classified whole
on the device (DP, demotions, reconciliation and both relaxation sweeps:
on a card one replay of its bucket's CUDA graph, alldev.BatchGraph, the
five launches of ``alldev.classify_glued``, captured once per (device,
Bn, max_n, R2, max_m) for the engine's tables; on the CPU
``alldev.classify_batch``'s plain versions); the host plane expands the
assignments into class strings (``NativeWall.expand_rows``, plain version
``pack.expand_asgn``), and each read the device flags is re-decided
whole, exactly, by the C++ host plane (one batched exact rel call and one
relaxation call per chunk, over the -T workers).

The production entry is ``classify_stream``: a depth-3 software pipeline
in which chunk k+1's host stages overlap chunk k's device work.  Each
chunk takes a slot of the engine's kept host staging
(``staging.StagingPool``; pinned on a card) and the C++ packer writes its
blobs straight into it; on a card they go from there into the bucket
graph's static inputs on the engine's CUDA stream (either path), the
graph replays on that stream, the packed result comes back from its
static output into the same slot, and an event recorded after the copy is
what ``_finish`` waits on before it reads the slot and releases it; the
one stream orders each chunk's use of the static buffers before the next
chunk's.  No chunk pins or allocates host memory once the pool has met
the stream's largest chunk.  ``classify_chunk`` is the
synchronous single-chunk form.  Interval arrays are padded to bucketed
shapes (``_bucket``, ``_bucket_m``).  ``TorchEngine(devices=[...])``
deals whole chunks round robin over several devices, each with its own
tables, stream, graphs and events (``_enqueue``).
"""

from __future__ import annotations

import collections
import contextlib
from typing import Iterator

import numpy as np
import torch

from classpro_tpu_torch import alldev as alldev_mod
from classpro_tpu_torch import rel as rel_mod
from classpro_tpu_torch.constants import DEFAULTS
from classpro_tpu_torch.device import canonical_device, resolve_device
from classpro_tpu_torch.estimation import GlobalModel, build_global_model
from classpro_tpu_torch.io.classfile import ClassRecord, class_header
from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
from classpro_tpu_torch.io.fastx import read_fastx_checked
from classpro_tpu_torch.native import NativeWall, chunk_dims
from classpro_tpu_torch.pack import _bucket
from classpro_tpu_torch.params import build_replicas
from classpro_tpu_torch.rel import DIPLO, HAPLO, rel_only, unpack_out
from classpro_tpu_torch.staging import StagingPool

# the buckets ``TorchEngine.warmup`` readies by default: (R, max_m) on the
# main path, (Bn, max_n, R2, max_m) on the all-device path (medium's
# commonest chunk at batch 200)
WARM_MAIN = ((256, 128), (256, 192))
WARM_ALLDEV = ((256, 192, 512, 128),)


_M_LADDER = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)

# the (R, max_m) buckets any engine of this process has run, warm-ups
# included (the serve daemon's ``warm_shapes``)
WARM_SHAPES: set = set()


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
    overlaps the consumer's host stages and device waits.  When the
    consumer stops early (an error downstream, or ``close``), the
    producer is told to stop, the queue is drained so it is not left
    blocked, and it closes ``chunks`` and exits."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        it = iter(chunks)
        try:
            for c in it:
                if not put(c):
                    return
            put(_END)
        except BaseException as e:  # re-raised below, in order
            put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    th = threading.Thread(target=produce, daemon=True,
                          name="classpro-prefetch")
    th.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while th.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass


@contextlib.contextmanager
def _prefetched(chunks, depth: int):
    """``chunks`` through ``_prefetch_iter`` when ``depth`` > 0, closed
    (its producer stopped) when the block exits, an error included."""
    if depth <= 0:
        yield chunks
        return
    it = _prefetch_iter(chunks, depth)
    try:
        yield it
    finally:
        it.close()


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
        # the main and the all-device chunk's CUDA graphs, by device and
        # bucket, for this engine's tables
        self._graphs = rel_mod.RelGraphs()
        self._batch_graphs = alldev_mod.BatchGraphs()
        self._rr = 0
        # chunks in flight: depth 3 covers one device (host k+1 ||
        # device k || finish k-1); with N round-robin devices ~2 chunks
        # stay in flight per device, as in the JAX engine
        self.depth = (max(3, 2 * len(self.devices) + 1) if self.devices
                      else 3)
        # each chunk's blobs and result, kept across chunks (pinned when
        # a device is a card)
        self.staging = StagingPool(
            any(d.type == "cuda" for d in self._on), self.depth + 1)
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

    def _ran(self, R: int, max_m: int) -> None:
        """Record a (R, max_m) bucket in ``shapes`` and ``WARM_SHAPES``."""
        self.shapes[(R, max_m)] = None
        WARM_SHAPES.add((R, max_m))

    def warmup(self, shapes=None) -> None:
        """Make every device of the engine ready for the given buckets
        before the stream (the JAX engine's ``warmup``, which compiles
        each bucket's program): (R, max_m) on the main path, (Bn, max_n,
        R2, max_m) on the all-device path (default ``WARM_MAIN`` /
        ``WARM_ALLDEV``).  The kernels built and loaded, the tables on the
        device (the engine's construction put them there), and on a card
        each bucket's CUDA graph captured (after an eager run on an
        all-padding pack), waited for; on the CPU the path's plain stage
        runs once on that pack.  The host plane's binomial-tail tables for
        this model, which the first chunk would otherwise build (seconds
        of numpy), are built too."""
        self.wall._walk_tables()
        alldev = self.PP is not None
        sizes = alldev_mod.blob_sizes if alldev else rel_mod.blob_sizes
        for shape in shapes or (WARM_ALLDEV if alldev else WARM_MAIN):
            n_f, n_i = sizes(*shape)
            fb = torch.full((n_f,), -np.inf, dtype=torch.float64)
            ib = torch.ones(n_i, dtype=torch.int32)
            for dev, (P, PP, stream) in self._on.items():
                if stream is None:
                    self._device_stage(fb, ib, P, PP, shape)
                    continue
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    self._graph(P, PP, shape)
                stream.synchronize()
            self._ran(*((shape[2] // 2, shape[3]) if alldev else shape))

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
        pending: collections.deque = collections.deque()
        with _prefetched(chunks, prefetch) as src:
            for seqs, profiles in src:
                pending.append(self._submit(seqs, profiles))
                if len(pending) >= self.depth:
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
        win_meta: list = []    # (orig chunk sizes, sort order, n subchunks)

        def sorted_chunks(src):
            it = iter(src)
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
        with _prefetched(chunks, prefetch) as src:
            for res in self.classify_stream(sorted_chunks(src), prefetch=0):
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
        """Wall stage (C++) for one chunk, with each staged read's profile
        length (``_plens``, by slab read) and the natural (R, max_m)
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
                  max_m=0,
                  _plens=np.array([len(profiles[i]) for i in g], np.int64))
        sel_n = int((n_rel > 0).sum())
        if sel_n:
            st["_R"] = _bucket(sel_n)
            st["_mm"] = _bucket_m(int(n_rel.max()))
        return st

    def _pack_st(self, st, R: int, max_m: int, host=None):
        """C++ rel pack for a staged chunk at the given bucket, into fresh
        blobs or into the staging slot ``host``; records the views the
        host-side fw/bw reconciliation needs."""
        fb, ib = self.wall.pack_rel(
            st["slab"], st["slot"], st["n_out"], st["n_rel"], st["_plens"],
            R, max_m, *((host.fblob, host.iblob) if host else ()))
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
        if "_R" not in st:
            return None
        fb, ib = self._pack_st(st, st["_R"], st["_mm"])
        return fb, ib, st["_R"], st["_mm"]

    def _submit(self, seqs, profiles):
        """Wall stage + rel pack (both C++, the pack into the chunk's
        staging slot) + the chunk's device work, enqueued without waiting
        for it."""
        st = self._stage(seqs, profiles)
        self.chunks_done += 1
        if self.PP is not None:
            return self._submit_alldev(st)
        if "_R" not in st:
            return st
        R, max_m = shape = (st["_R"], st["_mm"])
        self._pack_st(st, *shape, self._take(
            st, *rel_mod.blob_sizes(*shape), (2 * R, max_m + 5)))
        self._ran(*shape)
        return self._enqueue(st, "out", lambda f, i, P, PP:
                             self._device_stage(f, i, P, PP, shape))

    def _take(self, st, n_f: int, n_i: int, out_shape):
        """The chunk's staging slot (``st["host"]``): blobs of ``n_f``
        float64 and ``n_i`` int32 elements, a uint8 result of
        ``out_shape``; ``_finish`` releases it."""
        host = st["host"] = self.staging.take(n_f, n_i, out_shape)
        return host

    def _release(self, st) -> None:
        """Return the chunk's staging slot to the pool (``_finish``, after
        the device event and the last read of the slot's views)."""
        host = st.pop("host", None)
        if host is not None:
            self.staging.release(host)

    def _device_stage(self, fblob, iblob, P, PP, shape) -> torch.Tensor:
        """One chunk's device stage, the packed uint8 result: on a card
        the replay of the bucket's graph (the main chunk's, or with ``PP``
        the all-device chunk's), its host blobs copied into the graph's
        static inputs on the current stream (the result is the graph's
        static output); on the CPU the plain versions of ``rel_only`` or
        ``alldev.classify_batch``."""
        if P.device.type == "cuda":
            return self._graph(P, PP, shape).run(fblob, iblob)
        if PP is not None:
            return alldev_mod.pack_flags(*alldev_mod.classify_batch(
                fblob, iblob, PP, *shape))
        return rel_only(fblob, iblob, P, *shape)

    def _graph(self, P, PP, shape):
        """The bucket's CUDA graph for this engine's tables, captured at
        first use: the all-device chunk's with ``PP``, else the main
        chunk's."""
        if PP is not None:
            return self._batch_graphs.get(PP, *shape)
        return self._graphs.get(P, *shape)

    @staticmethod
    def _alldev_rows(st):
        """The staged chunk's slab reads that the all-device stage packs
        (those with records), or None when there are none."""
        if "g" not in st:
            return None
        rows = np.flatnonzero(st["n_out"] > 0).astype(np.int32)
        return rows if rows.size else None

    def alldev_shape(self, seqs, profiles):
        """The (Bn, max_n, R2, max_m) bucket the all-device stage runs a
        chunk of these reads at (staged, not packed), or None when the
        chunk has no device work."""
        st = self._stage(seqs, profiles)
        if "g" not in st:
            return None
        try:
            rows = self._alldev_rows(st)
            return None if rows is None else chunk_dims(
                st["n_out"], st["n_rel"], rows)
        finally:
            self.wall.release_slab(st["slab"])

    def _submit_alldev(self, st):
        """Pack the staged chunk's reads that have intervals (one C++
        call on the -T workers, into the chunk's staging slot) and enqueue
        the device stage on them (the JAX package's _dispatch)."""
        rows = self._alldev_rows(st)
        if rows is None:
            return st
        dims = chunk_dims(st["n_out"], st["n_rel"], rows)
        host = self._take(st, *alldev_mod.blob_sizes(*dims),
                          (dims[0], dims[1] + 1))
        self.wall.pack_chunk(
            st["slab"], st["slot"], st["n_out"], st["n_rel"], st["_plens"],
            rows, threads=self.threads, fblob=host.fblob, iblob=host.iblob)
        st["rows"] = rows
        self._ran(dims[2] // 2, dims[3])
        return self._enqueue(st, "un", lambda f, i, P, PP:
                             self._device_stage(f, i, P, PP, dims))

    def _enqueue(self, st, key: str, run):
        """Deal the chunk to the next device and run ``run(fblob, iblob,
        P, PP)`` (-> uint8 tensor) there with that device's tables, the
        blobs the torch views of the chunk's staging slot ``st["host"]``;
        the result lands in the slot's ``out`` view, which is
        ``st[key]``.  The engine owns the slot: on a card it is pinned,
        ``run`` copies the blobs from it on the device's own stream, the
        result comes back into it on that stream, and the event recorded
        after that copy (``st["done"]``) is what _finish waits on before
        it reads the slot and releases it.  Nothing here pins or
        allocates host memory."""
        host = st["host"]
        dev = st["dev"] = self._next_device()
        P, PP, stream = self._on[dev]
        if stream is None:
            res = run(host.fblob_t, host.iblob_t, P, PP)
            _check_out(res, host.out)
            st[key] = host.out.copy_(res)
            return st
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            res = run(host.fblob_t, host.iblob_t, P, PP)
            _check_out(res, host.out)
            host.out.copy_(res, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        st.update({key: host.out, "done": done})
        return st

    def _finish_alldev(self, st) -> list[str]:
        """Class strings of an all-device chunk, in g order: wait for the
        device event, expand the interval assignments from the staging
        slot's result (one C++ call on the -T workers), read the guard
        flags from it, release the slot (its last read), then re-decide
        the flagged reads exactly."""
        g = st["g"]
        res_g = [""] * len(g)
        if "rows" in st:
            if "done" in st:
                st["done"].synchronize()
            buf = st["un"].numpy()
            rows = st["rows"]
            out_off = np.zeros(len(rows) + 1, np.int64)
            out_off[1:] = np.cumsum([len(st["seqs"][g[r]]) for r in rows])
            cls = self.wall.expand_rows(st["slab"], st["slot"], st["n_out"],
                                        rows, buf[:, :-1].view(np.int8),
                                        out_off, threads=self.threads)
            mv = memoryview(cls)
            for k, r in enumerate(rows):
                res_g[r] = str(mv[out_off[k]: out_off[k + 1]], "ascii")
            rs = rows[buf[:len(rows), -1] != 0]
            self._release(st)
            if rs.size:
                self.guard_flagged += int(rs.size)
                for r, c in zip(rs, self._exact_alldev(st, rs)):
                    res_g[r] = c
        return res_g

    def _exact_alldev(self, st, rs: np.ndarray) -> list[str]:
        """Whole-read exact classification of the staged reads ``rs``
        (the all-device path's guard): one C++ exact rel call over their
        rel records, then one C++ relaxation and expansion over a compact
        copy of their slab rows, both on the -T workers."""
        slot = st["slot"]
        n_out, n_rel = st["n_out"][rs], st["n_rel"][rs]
        # row q of the compact slab = read rs[q]'s records
        slot_c = int(n_out.max())
        slab = st["slab"][: len(st["n_out"]) * slot].reshape(-1, slot)
        slab_c = slab[rs, :slot_c].reshape(-1)
        rel_out = None
        live = rs[n_rel > 0]              # rel row j = the j-th such read
        if live.size:
            rel_out = np.zeros((live.size, int(n_rel.max())), np.int8)
            self.wall.exact_rel_batch(st["slab"], slot, st["n_out"], live,
                                      st["_plens"][live], rel_out,
                                      np.arange(live.size),
                                      threads=self.threads)
        out_off = np.zeros(len(rs) + 1, np.int64)
        out_off[1:] = np.cumsum([len(st["seqs"][st["g"][r]]) for r in rs])
        buf = self.wall.finish_batch(
            slab_c, slot_c, n_out, n_rel, rel_out,
            rel_out.shape[1] if rel_out is not None else 1, out_off,
            threads=self.threads)
        mv = memoryview(buf)
        return [str(mv[out_off[q]: out_off[q + 1]], "ascii")
                for q in range(len(rs))]

    def _exact_guard(self, st, rel_out) -> None:
        """Host-exact recompute of flagged rows (in place), one C++ call
        over the -T workers."""
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
        live = np.nonzero(st["n_rel"] > 0)[0]    # row j -> slab read
        rows = np.nonzero(flagged)[0]
        rows = rows[rows < len(live)]              # padded dead rows
        self.wall.exact_rel_batch(st["slab"], st["slot"], st["n_out"],
                                  live[rows], st["_plens"][live[rows]],
                                  rel_out, rows, threads=self.threads)

    def _finish(self, st) -> list[str]:
        """Wait for the chunk's device result, run the host rel steps (one
        C++ call for the demotions and the reconciliation, one for the
        guard), release the chunk's staging slot (the rel planes and the
        result read by those two calls are its views), then ONE C++ call:
        scatter rel assignments, relaxation sweeps, class expansion."""
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
                # hdrr-tie reconciliation run on the host, exact: one
                # C++ call on the -T workers (plain versions:
                # rel.demote_host, rel.reconcile_fwbw)
                rel_out = self.wall.demote_reconcile(
                    v, rescue, st["rel_b"], st["rel_e"], st["rel_ccb"],
                    st["rel_cce"], st["rel_m"], int(self.gm.cov[HAPLO]),
                    int(self.gm.cov[DIPLO]), threads=self.threads)
                self._exact_guard(st, rel_out)
                self._release(st)
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


def _check_out(res: torch.Tensor, out: torch.Tensor) -> None:
    """Raise unless the device stage's result fits the slot's result view
    exactly (``copy_`` would broadcast)."""
    if res.dtype != out.dtype or res.shape != out.shape:
        raise ValueError(f"device stage result {res.dtype} "
                         f"{tuple(res.shape)}, the slot holds {out.dtype} "
                         f"{tuple(out.shape)}")


def _warmup_shape(eng: TorchEngine, fastx_path: str, P, batch_size: int):
    """The bucket ``--warmup`` readies (the JAX classify_file_tpu's
    choice): the C++ wall stage over the first max(batch_size, 200) reads
    gives the largest reliable-interval count; the shape is one
    ``_M_LADDER`` step above its bucket, at the batch's row bucket.
    Returns (shape, reads sampled, largest count)."""
    import itertools

    sample_n = max(batch_size, 200)
    seqs, profs = [], []
    for rid, rec in enumerate(itertools.islice(
            read_fastx_checked(fastx_path, DEFAULTS.max_read_len),
            sample_n)):
        prof = P.fetch(rid)
        if len(prof):
            seqs.append(rec.seq.encode("ascii"))
            profs.append(prof)
    nrel_max = 1
    if seqs:
        slab, _n_out, n_rel, _slot = eng.wall.wall_stage_slab(
            seqs, profs, threads=eng.threads)
        eng.wall.release_slab(slab)
        nrel_max = max(nrel_max, int(n_rel.max()))
    mb = _bucket_m(nrel_max)
    nxt = next((b for b in _M_LADDER if b > mb), mb * 2)
    return (_bucket(batch_size), nxt), sample_n, nrel_max


def fastx_chunks(fastx_path: str, P, K: int, batch_size: int):
    """The reads of a FASTX file in chunks of ``batch_size``, their
    profiles decoded from ``P`` (``fetch_batch``): (records, seqs,
    profiles) per chunk.  Raises ValueError for a read longer than the
    maximum and for a profile whose length is not the read's."""

    def flush(chunk, rid0):
        plens = [max(len(r.seq) - K + 1, 0) for r in chunk]
        profs = P.fetch_batch(list(range(rid0, rid0 + len(chunk))), plens)
        for j, p in enumerate(profs):   # ClassPro.c:184-187 rlen check
            if len(p) != plens[j]:
                rlen = len(chunk[j].seq)
                raise ValueError(
                    f"Read {rid0 + j}: rlen ({rlen}) != plen+Km1 "
                    f"({len(p) + K - 1}) — profile/read mismatch")
        return chunk, [r.seq for r in chunk], profs

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


def classify_file_torch(fastx_path: str, fastk_root: str, coverage: int = 0,
                        read_len: int = 20000, model_path: str | None = None,
                        batch_size: int = 200, threads: int = 0,
                        verbose: bool = False, device=None,
                        devices: int = 0, stats_out: dict | None = None,
                        warmup: bool = False) -> Iterator[ClassRecord]:
    """Classify a FASTX file against its FASTK root; yields one
    ClassRecord per read, in input order.  ``devices`` > 0 round-robins
    the chunks over ``cuda:0`` .. ``cuda:devices-1`` (``local_devices``:
    raises when fewer cards exist).  ``warmup`` readies the devices for
    the dataset's expected bucket before the stream (``_warmup_shape``).
    Set-up (model, engine, device tables, warm-up) runs eagerly at call
    time; the stream is the returned generator."""
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
    if warmup:
        import sys

        shape, sample_n, nrel_max = _warmup_shape(eng, fastx_path, P,
                                                  batch_size)
        print(f"warming up the device for shape {shape} (sampled "
              f"{sample_n} reads, max n_rel {nrel_max})...",
              file=sys.stderr)
        eng.warmup((shape,))
        print("warmup done", file=sys.stderr)
    recs: list = []

    def chunk_iter():
        for chunk, seqs, profs in fastx_chunks(fastx_path, P, gm.kmer,
                                               batch_size):
            recs.append(chunk)
            yield seqs, profs

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
