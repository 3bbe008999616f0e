"""Multi-process data-parallel classification driver (the JAX package's
``parallel/driver.py``, on torch.distributed).

The reference's only parallelism (T pthreads over contiguous read ranges,
ClassPro.c:574-578 / io.c:175-176,353-354), mapped to processes:

* each PROCESS owns the contiguous read range [beg, end) of the same
  ceil-partition the reference uses for threads, and classifies it on its
  own device (``cuda:<LOCAL_RANK, else pid % device count>``, or the CPU
  with ``--device cpu``) through the pipelined ``TorchEngine`` stream;
* global estimation reads the shared ``.hist`` file (what the reference
  reads: exact parity) or, through ``estimate_distributed``, sums
  per-process partial instance histograms with one all-reduce
  (``mesh.psum_histogram``, the one collective of the program);
* every process writes ``<out>.<pid>`` (io.c:139's temp shard) with a
  ``.params`` stamp, so that ``--resume`` skips shards that are complete
  and were made with the same parameters;
* after one all-reduce as a barrier, process 0 checks every shard and
  concatenates them in read order (merge_files, io.c:70-112).

With ``--nproc`` > 1 the processes form a ``torch.distributed`` group at
``tcp://<coord>``: NCCL when the device is a card, gloo only with
``--device cpu``.  There is no switch between the two: where NCCL refuses
a rank, the run fails with NCCL's error.  Run one process per device::

    python -m classpro_tpu_torch.parallel.driver reads.fasta \\
        --coord 10.0.0.1:8476 --nproc 4 --pid $RANK

``--nproc 1`` (the default) needs no coordinator.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from classpro_tpu_torch.device import resolve_device
from classpro_tpu_torch.io.fastk import Histogram


def shard_range(nreads: int, nproc: int, pid: int) -> tuple[int, int]:
    """Contiguous ceil-partition of reads (io.c:175-176)."""
    per = (nreads + nproc - 1) // nproc
    beg = min(per * pid, nreads)
    return beg, min(beg + per, nreads)


def partial_instance_hist(profiles, low: int, high: int) -> np.ndarray:
    """Instance-count histogram of one read shard: positions of the
    shard's profiles bucketed by count, with the reference's boundary
    clamping (counts <= low into hist[low], >= high into hist[high],
    libfastk.c:22-47).  Summed over all shards it equals
    Modify_Histogram's instance counts, because every k-mer instance of
    the dataset appears at exactly one profile position."""
    out = np.zeros(high + 1, np.int64)
    for p in profiles:
        if len(p):
            c = np.clip(p.astype(np.int64), low, high)
            out += np.bincount(c, minlength=high + 1)
    return out


@dataclasses.dataclass
class _InstanceHist(Histogram):
    """Histogram whose buckets already ARE instance counts."""

    def instance_counts(self) -> np.ndarray:
        return self.hist.copy()


def estimate_distributed(profiles, kmer: int, low: int = 1,
                         high: int = 32767, **kw):
    """Global model from per-process partial histograms and one
    all-reduce (replaces process_global_hist's single-threaded load,
    hist.c:28-143, where no shared .hist exists).  ``kw`` goes to
    build_global_model."""
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.parallel.mesh import psum_histogram

    tot = psum_histogram(partial_instance_hist(profiles, low, high))
    hist = _InstanceHist(kmer=kmer, low=low, high=high,
                         ilowcnt=int(tot[low]), ihighcnt=int(tot[high]),
                         hist=tot[low:high + 1])
    return build_global_model(hist, **kw)


def shard_records(path: str) -> int:
    """Count and structurally validate a shard file: 4-line fastq-like
    records, newline-terminated, the last record's class line as long as
    its sequence line.  Returns -1 if the file is missing or malformed
    (e.g. a run killed mid-write).  Shard files are the resume unit."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return -1
    if not data:
        return 0
    if not data.endswith(b"\n"):
        return -1
    lines = data.split(b"\n")[:-1]
    if len(lines) % 4 != 0:
        return -1
    if lines and len(lines[-1]) != len(lines[-3]):
        return -1
    return len(lines) // 4


def _params_stamp(source: str, nproc: int, pid: int, coverage: int,
                  read_len: int, model_path: str | None) -> str:
    """Run-parameter fingerprint for shard resume: a stale shard made
    with other -c/-r/-M (or another partition) of the same dataset is
    structurally identical, so --resume checks WHAT made the shard, not
    just its shape.  The model file is hashed by content.  The same
    function as the JAX driver's, so either driver resumes the other's
    shards."""
    key = f"{source}|{nproc}|{pid}|{coverage}|{read_len}|{model_path or ''}"
    if model_path and os.path.exists(model_path):
        with open(model_path, "rb") as f:
            key += "|" + hashlib.sha256(f.read()).hexdigest()
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def _process_device(pid: int, device=None) -> torch.device:
    """The device of process ``pid``: ``cuda:<LOCAL_RANK>``, else
    ``cuda:<pid % device count>``, unless ``device`` names one (``cpu``,
    or ``cuda:k``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else pid % torch.cuda.device_count())
    return dev


def _init_group(coord: str | None, nproc: int, pid: int,
                dev: torch.device) -> None:
    """Join the process group at ``tcp://<coord>``: NCCL on a card (its
    device set first), gloo on the CPU."""
    if not coord:
        raise ValueError("--nproc > 1 needs --coord host:port")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coord}", world_size=nproc,
                            rank=pid)


def run_process(source: str, fastk_root: str | None, out: str | None,
                nproc: int = 1, pid: int = 0, coord: str | None = None,
                coverage: int = 0, read_len: int = 20000,
                model_path: str | None = None, batch_size: int = 200,
                verbose: bool = False, resume: bool = False, device=None,
                _skip_init: bool = False) -> str:
    """One process's share of the job.  Returns the shard path (the
    output itself when nproc is 1).

    With ``resume=True``, a shard whose file already exists, validates
    structurally, holds exactly this range's record count and carries
    this run's params stamp is skipped (kill-and-rerun recovery; the
    reference overwrites its temp shards, io.c:139, so resume is a
    superset, off by default).  ``_skip_init`` runs several pids in one
    process without a group (tests, chip_smoke.py)."""
    from classpro_tpu_torch.constants import DEFAULTS
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.classfile import class_header
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx_checked, root_of

    dev = _process_device(pid, device)
    if nproc > 1 and not _skip_init:
        _init_group(coord, nproc, pid, dev)

    root = root_of(source)
    fk_root = fastk_root or root
    final = out or root + ".class"

    gm = build_global_model(load_histogram(fk_root), coverage=coverage,
                            read_len=read_len, model_path=model_path)
    P = open_profiles(fk_root)
    beg, end = shard_range(P.nreads, nproc, pid)

    shard = final + (f".{pid}" if nproc > 1 else "")
    stamp = _params_stamp(source, nproc, pid, coverage, read_len,
                          model_path)
    stamp_path = shard + ".params"
    if resume and shard_records(shard) == end - beg:
        try:
            with open(stamp_path) as f:
                prior = f.read().strip()
        except OSError:
            prior = None
        if prior == stamp:
            if verbose:
                print(f"[{pid}/{nproc}] resume: {shard} complete "
                      f"({end - beg} reads), skipping", file=sys.stderr)
            return shard
        if verbose:
            print(f"[{pid}/{nproc}] resume: {shard} was produced with "
                  f"different parameters — reclassifying",
                  file=sys.stderr)
    eng = TorchEngine(gm, batch_size=batch_size, device=dev)
    recs: list = []
    K = gm.kmer

    def _flush(buf, rid0):
        recs.append(buf)
        plens = [max(len(r.seq) - K + 1, 0) for r in buf]
        return ([r.seq for r in buf],
                P.fetch_batch(list(range(rid0, rid0 + len(buf))), plens))

    def chunks():
        buf: list = []
        for rid, rec in enumerate(read_fastx_checked(source,
                                                     DEFAULTS.max_read_len)):
            if rid < beg:
                continue
            if rid >= end:
                break
            buf.append(rec)
            if len(buf) >= batch_size:
                yield _flush(buf, rid - len(buf) + 1)
                buf = []
        if buf:
            yield _flush(buf, end - len(buf))

    with open(shard, "w") as f:
        for classes in eng.classify_stream(chunks(), sort_window=8):
            chunk_recs = recs.pop(0)
            for rec, cls in zip(chunk_recs, classes):
                f.write(f"{class_header(rec.name, rec.comment)}\n"
                        f"{rec.seq}\n+\n{cls}\n")
    with open(stamp_path, "w") as f:
        f.write(stamp + "\n")
    if verbose:
        print(f"[{pid}/{nproc}] wrote {shard} (reads {beg}..{end}) on "
              f"{dev}", file=sys.stderr)
    return shard


def merge_shards(final: str, nproc: int,
                 expected: list[int] | None = None) -> None:
    """Read-order concatenation of the per-process shards (io.c:70-112).

    ``expected`` (per-shard record counts from the ceil-partition every
    process used) makes the merge check completeness first: a missing,
    truncated or short shard aborts the merge instead of silently
    producing a short output file."""
    from classpro_tpu_torch.io.merge import merge_files

    paths = [f"{final}.{p}" for p in range(nproc)]
    if expected is not None:
        for p, (path, want) in enumerate(zip(paths, expected)):
            got = shard_records(path)
            if got != want:
                raise RuntimeError(
                    f"shard {p} ({path}) incomplete: {got} records, "
                    f"expected {want} — not merging")
    merge_files(final, paths)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source")
    ap.add_argument("-N", "--fastk-root")
    ap.add_argument("-o", "--output")
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--pid", type=int,
                    default=int(os.environ.get("RANK", 0)))
    ap.add_argument("--coord", help="coordinator host:port (nproc > 1)")
    ap.add_argument("-c", "--coverage", type=int, default=0)
    ap.add_argument("-r", "--read-len", type=int, default=20000)
    ap.add_argument("-M", "--model")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip shards whose output file is already "
                         "complete (kill-and-rerun recovery)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where each process classifies: its card "
                         "(default; NCCL between processes) or the CPU "
                         "(gloo)")
    a = ap.parse_args(argv)
    from classpro_tpu_torch.io.fastk import open_profiles
    from classpro_tpu_torch.io.fastx import root_of
    from classpro_tpu_torch.parallel.mesh import psum_histogram

    try:
        shard = run_process(a.source, a.fastk_root, a.output, a.nproc, a.pid,
                            a.coord, a.coverage, a.read_len, a.model,
                            verbose=a.verbose, resume=a.resume,
                            device=a.device)
        if a.nproc > 1:
            # barrier before the merge: one all-reduce over the group
            psum_histogram(np.ones(1, np.int64))
            if a.pid == 0:
                nreads = open_profiles(a.fastk_root
                                       or root_of(a.source)).nreads
                expected = [e - b for b, e in
                            (shard_range(nreads, a.nproc, p)
                             for p in range(a.nproc))]
                merge_shards(shard.rsplit(".", 1)[0], a.nproc, expected)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
