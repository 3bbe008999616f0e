"""Cross-device work of the port (the JAX package's ``parallel/mesh.py``).

Classification needs no communication between devices: reads are
independent, every table is replicated.  The one collective of the whole
program is the global-histogram sum of ``psum_histogram`` (K8), a
``torch.distributed.all_reduce``: NCCL between cards, gloo between CPU
processes.  ``sharded_classify`` runs one read shard per device with no
collective at all.

The JAX module's ``data_parallel_mesh`` and ``shard_batch`` have no
counterpart: a list of torch devices takes the mesh's place, and each
shard is copied to its own device.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from classpro_tpu_torch.device import canonical_device

# all-reduces issued by psum_histogram (the calls without a process group,
# which copy, do not count)
LAUNCHES = {"all_reduce": 0}


def _group_device() -> torch.device:
    """The device a process's collectives run on: its current card under
    NCCL (the driver sets it before creating the group), the CPU under
    gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def psum_histogram(local_hist) -> np.ndarray:
    """All-reduce of per-process partial histograms (replaces the
    reference's single-threaded process_global_hist, hist.c:28-143, in
    the distributed setting): one contribution per process; every process
    gets the same int64 sum, reduced on the group's device (the card under
    NCCL, the CPU under gloo).  Without an initialised process group the
    sum is over one process, a copy of ``local_hist``, as the JAX function
    gives on a single-process mesh of any size."""
    h = np.asarray(local_hist).astype(np.int64)
    if not (dist.is_available() and dist.is_initialized()):
        return h
    t = torch.from_numpy(h).to(_group_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    LAUNCHES["all_reduce"] += 1
    return t.cpu().numpy()


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host blob on ``dev``; to a card from pinned memory without
    blocking, so that the next shard's upload does not wait for this
    shard's work."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def sharded_classify(devices, fblobs: np.ndarray, iblobs: np.ndarray, PPs,
                     dims: tuple):
    """The all-device classification of D read shards, shard d on
    ``devices[d]`` (the JAX program vmapped over a mesh, mesh.py:80-101).

    fblobs (D, Lf) float64 / iblobs (D, Li) int32: one transfer-blob pair
    per shard (pack.pack_chunk layout, every shard at the same ``dims`` =
    (Bn, max_n, R2, max_m)).  ``devices`` may repeat a device; ``PPs``
    maps each distinct device to its ``PipelineParams`` replica
    (``params.build_replicas(gm, devices, alldev=True)``).  Every shard is enqueued, on its device's
    current stream, before any result is fetched: on a card one replay
    of the bucket's CUDA graph (``alldev.classify_batch``), whose packed
    output is copied out on that stream before the next shard's replay
    on the same device overwrites it.  Returns ((D, Bn, max_n) int8,
    (D, Bn) bool exactness-guard flags: reads the caller re-decides
    exactly), as numpy.  Zero collectives.

    No entry point reaches it: the engine's ``devices=`` round robin deals
    whole chunks instead.  It is the counterpart of the JAX mesh program,
    held against it by the tests and run on the card by chip_smoke.py."""
    from classpro_tpu_torch.alldev import classify_batch

    devs = [canonical_device(d) for d in devices]
    if not (len(devs) == len(fblobs) == len(iblobs)):
        raise ValueError(f"{len(devs)} devices for {len(fblobs)} fblobs and "
                         f"{len(iblobs)} iblobs")
    outs = []
    for dev, fb, ib in zip(devs, fblobs, iblobs):
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            outs.append(classify_batch(_upload(fb, dev), _upload(ib, dev),
                                       PPs[dev], *dims))
    out = np.stack([o.cpu().numpy() for o, _ in outs])
    flags = np.stack([f.cpu().numpy() for _, f in outs])
    return out, flags
