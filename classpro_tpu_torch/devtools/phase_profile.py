"""Per-stage timing of ``TorchEngine``'s main-path chunk work.

Runs each stage of a chunk in series (no pipeline overlap) over a dataset
(default the medium fixture), so the cost of every stage can be
attributed: the C++ wall stage, the C++ rel pack, the enqueue of the
device work (uploads, the K4 glue and the DP kernel's launches, the
result's copy back), the wait for the device, the host demotions +
fw/bw reconciliation + exactness guard, the C++ ``finish_batch``
(relaxation + expansion) and the string decode.  The device's time per
chunk is taken with CUDA events on the engine's stream around the
enqueued work; the host synchronizes only where it needs the result
(the wait stage).  Then the real pipelined stream (sort_window 8) runs
for the steady rate the stages must explain.

Usage::

    python -m classpro_tpu_torch.devtools.phase_profile [--batch 200] \
        [--passes 5] [--root FASTK_ROOT] [--nreads N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from classpro_tpu_torch.devtools.parity_fuzz import REPO


def load_dataset(root: str | None, nreads: int = 0):
    """(GlobalModel, seqs, profiles) of a FASTK root with its reads beside
    it (default: the medium fixture), limited to the first ``nreads``."""
    from classpro_tpu_torch.devtools.gpu_parity import load_reads
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles

    root = root or os.path.join(REPO, "tests", "fixtures", "medium",
                                "reads")
    gm = build_global_model(load_histogram(root))
    P = open_profiles(root)
    fa = next(root + e for e in (".fasta.gz", ".fasta", ".fastq.gz",
                                 ".fastq") if os.path.exists(root + e))
    seqs = load_reads(fa)
    n = len(seqs) if nreads <= 0 else min(nreads, len(seqs))
    return gm, seqs[:n], [P.fetch(i) for i in range(n)]


def profile(gm, seqs, profs, batch: int = 200, passes: int = 5,
            device: str = "cuda") -> dict:
    """Serial per-stage seconds per chunk, the device's ms per chunk
    (CUDA events; None on the CPU), and the pipelined stream's rate."""
    import torch

    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.rel import blob_sizes, rel_only, unpack_out

    eng = TorchEngine(gm, batch_size=batch, device=device)
    stream = eng._on[eng.device][2]
    kmers = sum(len(p) for p in profs)
    chunks = [(seqs[i:i + batch], profs[i:i + batch])
              for i in range(0, len(seqs), batch)]
    for sq, pf in chunks:                 # kernels built, tables warm
        eng.classify_chunk(sq, pf)

    acc: dict = {}
    dev_ms: list = []
    nch = 0

    def tick(name, t0):
        t1 = time.perf_counter()
        acc[name] = acc.get(name, 0.0) + (t1 - t0)
        return t1

    for _ in range(passes):
        for sq, pf in chunks:
            nch += 1
            t = time.perf_counter()
            st = eng._stage(sq, pf)
            t = tick("wall_stage(C++)", t)
            if "_R" not in st:
                continue
            R, mm = st["_R"], st["_mm"]
            eng._pack_st(st, R, mm, eng._take(st, *blob_sizes(R, mm),
                                              (2 * R, mm + 5)))
            t = tick("pack_rel(C++)", t)
            if stream is not None:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record(stream)
            eng._enqueue(st, "out", lambda f, i, P, PP:
                         rel_only(f, i, P, R, mm))
            if stream is not None:
                e1.record(stream)
            t = tick("enqueue(h2d+K4+K1+d2h)", t)
            if "done" in st:
                st["done"].synchronize()
                dev_ms.append(e0.elapsed_time(e1))
            t = tick("device wait", t)
            v, st["risky"], resc, st["mm"] = unpack_out(st["out"].numpy(),
                                                        st["max_m"])
            rel_out = eng.wall.demote_reconcile(
                v, resc, st["rel_b"], st["rel_e"], st["rel_ccb"],
                st["rel_cce"], st["rel_m"], int(gm.cov[2]), int(gm.cov[3]),
                threads=eng.threads)
            eng._exact_guard(st, rel_out)
            eng._release(st)
            t = tick("demote+reconcile+guard", t)
            g = st["g"]
            out_off = np.zeros(len(g) + 1, np.int64)
            out_off[1:] = np.cumsum([len(sq[i]) for i in g])
            buf = eng.wall.finish_batch(st["slab"], st["slot"],
                                        st["n_out"], st["n_rel"], rel_out,
                                        st["max_m"], out_off,
                                        threads=eng.threads)
            eng.wall.release_slab(st["slab"])
            t = tick("finish_batch(C++)", t)
            mv = memoryview(buf)
            for r in range(len(g)):
                str(mv[out_off[r]: out_off[r + 1]], "ascii")
            tick("str decode", t)

    tot = sum(acc.values())
    print(f"\nserial per-chunk stages ({nch} chunks, "
          f"{kmers * passes / 1e6:.1f} M k-mers, {eng.device}):")
    for k, v in acc.items():
        print(f"  {k:24s}: {v / nch * 1e3:8.2f} ms/chunk "
              f"({100 * v / tot:4.1f}%)")
    print(f"  {'TOTAL':24s}: {tot / nch * 1e3:8.2f} ms/chunk -> serial "
          f"rate {kmers * passes / tot / 1e6:.1f} M k-mers/s")
    if dev_ms:
        print(f"  device (CUDA events)    : {np.median(dev_ms):8.3f} ms/chunk "
              f"median ({min(dev_ms):.3f}-{max(dev_ms):.3f})")

    def stream_iter(reps):
        for _ in range(reps):
            yield from chunks

    for _ in eng.classify_stream(stream_iter(1), sort_window=8):
        pass                               # the stream path warm
    t0 = time.perf_counter()
    for _ in eng.classify_stream(stream_iter(passes), sort_window=8):
        pass
    dt = time.perf_counter() - t0
    print(f"pipelined stream          : "
          f"{dt / (passes * len(chunks)) * 1e3:8.2f} ms/chunk -> "
          f"{kmers * passes / dt / 1e6:.1f} M k-mers/s")
    return {"chunks": nch, "stage_ms_per_chunk":
            {k: v / nch * 1e3 for k, v in acc.items()},
            "device_ms_per_chunk": (float(np.median(dev_ms)) if dev_ms
                                    else None),
            "serial_kmers_per_s": kmers * passes / tot,
            "stream_kmers_per_s": kmers * passes / dt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=200)
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--root", default=None,
                    help="dataset root (default: the medium fixture)")
    ap.add_argument("--nreads", type=int, default=0,
                    help="limit to the first N reads (0 = all)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)
    gm, seqs, profs = load_dataset(a.root, a.nreads)
    profile(gm, seqs, profs, a.batch, a.passes, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
