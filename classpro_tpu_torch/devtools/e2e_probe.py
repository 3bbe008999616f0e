"""Where the end-to-end stream's time sits, input production included.

Runs ``TorchEngine.classify_stream`` (sort_window 8) over a committed
fixture (default medium; ``--nreads`` keeps its first reads) with its
input produced on a metered prefetch thread, for four input variants:

* ``steady``: everything pre-staged (the steady-stream framing:
  decoded profiles);
* ``decode``: the C++ reader's chunks read beforehand and fed again
  every pass, so only the profile decode (in the wall stage's workers)
  is in the window;
* ``nogz``: a pre-inflated FASTA streamed by the C++ reader in the
  window (``engine.fastx_chunks``);
* ``full``: the gzip FASTA streamed, inflated and scanned by the C++
  reader in the window, each profile decoded in the wall stage (what
  ``classify`` does).

For each, two trials print the rate, ms per chunk, the producer's work
per pass, and who waited on whom (producer blocked on a full queue,
consumer blocked on an empty one).  The card's span per trial is taken
with CUDA events on the engine's stream, first to last chunk.

Usage::

    python -m classpro_tpu_torch.devtools.e2e_probe [--reps 8] \
        [--batch 200] [--fixture medium] [--nreads N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import gzip
import os
import queue
import tempfile
import threading
import time

from classpro_tpu_torch.devtools.parity_fuzz import REPO


class Meter:
    def __init__(self):
        self.produce = 0.0   # producer work
        self.p_block = 0.0   # producer blocked on a full queue
        self.c_block = 0.0   # consumer blocked on an empty queue


def metered_prefetch(gen_factory, reps: int, depth: int, meter: Meter):
    """The engine's prefetch (a bounded queue fed by a thread) with the
    producer's and the consumer's times metered."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    END = object()

    def produce():
        for _ in range(reps):
            t0 = time.perf_counter()
            for item in gen_factory():
                meter.produce += time.perf_counter() - t0
                t0 = time.perf_counter()
                q.put(item)
                meter.p_block += time.perf_counter() - t0
                t0 = time.perf_counter()
            meter.produce += time.perf_counter() - t0
        q.put(END)

    th = threading.Thread(target=produce, daemon=True)
    th.start()
    while True:
        t0 = time.perf_counter()
        item = q.get()
        meter.c_block += time.perf_counter() - t0
        if item is END:
            th.join()
            return
        yield item


def probe(reps: int = 8, batch: int = 200, device: str = "cuda",
          fixture: str = "medium", nreads: int = 0) -> dict:
    import torch

    from classpro_tpu_torch.engine import TorchEngine, fastx_chunks
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx

    fx = os.path.join(REPO, "tests", "fixtures", fixture)
    root = os.path.join(fx, "reads")
    gz = os.path.join(fx, "reads.fasta.gz")
    gm = build_global_model(load_histogram(root))
    P = open_profiles(root)
    seqs = [r.seq for r in read_fastx(gz)]
    n = len(seqs) if nreads <= 0 else min(nreads, len(seqs))
    seqs = seqs[:n]
    profs = [P.fetch(i) for i in range(n)]
    K, B = gm.kmer, batch
    total_kmers = sum(len(p) for p in profs)
    eng = TorchEngine(gm, batch_size=B, device=device)
    stream = eng._on[eng.device][2]

    def from_file(path):
        def gen():
            yield from fastx_chunks(path, P, K, B, count=n)
        return gen

    read = list(fastx_chunks(gz, P, K, B, count=n))

    def gen_decode():
        yield from read

    def gen_steady():
        for i in range(0, len(seqs), B):
            yield seqs[i:i + B], profs[i:i + B]

    for _ in eng.classify_stream(gen_steady(), sort_window=8):
        pass                                  # kernels built, tables warm

    nchunks = (len(seqs) + B - 1) // B
    print(f"{nchunks} chunks/pass, {total_kmers / 1e6:.2f} M k-mers/pass, "
          f"reps={reps}, {eng.device}")
    res: dict = {}
    with tempfile.TemporaryDirectory(prefix="cpe2e") as tmp:
        plain = os.path.join(tmp, "reads.fasta")
        with open(plain, "wb") as f, open(gz, "rb") as g:
            f.write(gzip.decompress(g.read()))
        for name, gf in (("steady", gen_steady), ("decode", gen_decode),
                         ("nogz", from_file(plain)), ("full", from_file(gz))):
            res[name] = []
            for trial in range(2):
                m = Meter()
                if stream is not None:
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record(stream)
                t0 = time.perf_counter()
                for _ in eng.classify_stream(
                        metered_prefetch(gf, reps, 2, m), prefetch=0,
                        sort_window=8):
                    pass
                wall = time.perf_counter() - t0
                span = None
                if stream is not None:
                    e1.record(stream)
                    e1.synchronize()
                    span = e0.elapsed_time(e1)
                r = {"kmers_per_s": reps * total_kmers / wall,
                     "ms_per_chunk": wall / (reps * nchunks) * 1e3,
                     "produce_ms_per_pass": m.produce / reps * 1e3,
                     "p_block_ms_per_pass": m.p_block / reps * 1e3,
                     "c_block_ms_per_pass": m.c_block / reps * 1e3,
                     "device_span_ms": span}
                res[name].append(r)
                print(f"{name:7s} trial{trial}: "
                      f"{r['kmers_per_s'] / 1e6:6.1f} M k-mers/s  "
                      f"{r['ms_per_chunk']:6.2f} ms/chunk  produce "
                      f"{r['produce_ms_per_pass']:6.2f} ms/pass  p_block "
                      f"{r['p_block_ms_per_pass']:6.2f}  c_block "
                      f"{r['c_block_ms_per_pass']:6.2f}"
                      + ("" if span is None else
                         f"  card span {span:8.2f} ms"), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=200)
    ap.add_argument("--fixture", default="medium")
    ap.add_argument("--nreads", type=int, default=0,
                    help="limit to the first N reads (0 = all)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)
    probe(a.reps, a.batch, a.device, a.fixture, a.nreads)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
