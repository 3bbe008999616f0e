"""K8, the port's cross-device layer (classpro_tpu_torch.parallel.mesh),
against the JAX package's ``parallel/mesh.py`` on the CPU.

* ``psum_histogram`` with no process group (a copy, as the JAX function
  gives on a single-process mesh), in a gloo world of one process, and in
  a gloo world of two spawned processes (the exact int64 sum in both).
* ``sharded_classify`` over ``["cpu"] * 4``: four distinct tiny read
  groups at one common ``dims``; every shard equals a single
  ``classify_batch`` on it bit for bit, equals the JAX ``sharded_classify``
  on 4 virtual CPU devices on its unflagged rows with every flag equal,
  and its unflagged reads expand to the golden class strings.  With the
  shard axis rolled by one the same check fails (the routing check
  bites).
"""
import gzip
import json
import pathlib
import socket
import subprocess
import sys
from collections import Counter

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_kernel_shim import _load
from test_torch_unrel import _jax_pp

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"
ROOT = pathlib.Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_psum_histogram_without_group_is_a_copy():
    from classpro_tpu_torch.parallel.mesh import LAUNCHES, psum_histogram

    assert not dist.is_initialized()
    h = np.arange(40, dtype=np.int32) * 7
    n0 = LAUNCHES["all_reduce"]
    out = psum_histogram(h)
    assert out.dtype == np.int64 and out is not h
    np.testing.assert_array_equal(out, h)
    assert LAUNCHES["all_reduce"] == n0


def test_psum_histogram_gloo_world_of_one():
    """One gloo rank: the all-reduce runs and returns its input; the
    distributed estimate equals the .hist model."""
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.parallel.driver import estimate_distributed
    from classpro_tpu_torch.parallel.mesh import LAUNCHES, psum_histogram

    root = str(FIX / "tiny" / "reads")
    hist = load_histogram(root)
    P = open_profiles(root)
    profs = [P.fetch(i) for i in range(P.nreads)]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        n0 = LAUNCHES["all_reduce"]
        h = np.zeros(64, np.int64)
        h[27] = 1000
        np.testing.assert_array_equal(psum_histogram(h), h)
        gm = estimate_distributed(profs, kmer=hist.kmer, low=hist.low,
                                  high=hist.high)
        assert LAUNCHES["all_reduce"] == n0 + 2
    finally:
        dist.destroy_process_group()
    ref = build_global_model(hist)
    assert (gm.cov == ref.cov).all() and gm.dr_ratio == ref.dr_ratio


_RANK = """
import sys
import numpy as np
import torch.distributed as dist
sys.path.insert(0, {root!r})
from classpro_tpu_torch.parallel.mesh import psum_histogram
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method=sys.argv[2], world_size=2,
                        rank=rank)
try:
    h = np.arange(300, dtype=np.int64) * (rank + 1)
    h[-1] = 2 ** 40 + rank           # beyond int32: the sum is int64
    print(psum_histogram(h).tolist())
finally:
    dist.destroy_process_group()
"""


def test_psum_histogram_gloo_world_of_two():
    init = f"tcp://127.0.0.1:{free_port()}"
    code = _RANK.format(root=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), init],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    want = (np.arange(300, dtype=np.int64) * 3).tolist()
    want[-1] = 2 ** 41 + 1
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
        assert json.loads(so.strip().splitlines()[-1]) == want


def _gold(fx):
    with gzip.open(FIX / fx / "golden.class.gz", "rt") as f:
        return f.read().split("\n")[3::4]


def shard_inputs(fx="tiny", D=4):
    """D distinct read groups (sizes cycling 4/3/5) packed at one common
    dims, as __graft_entry__.dryrun_multichip picks them: (gm, groups,
    fblobs (D, Lf), iblobs (D, Li), dims, metas)."""
    from classpro_tpu_torch.native import NativeWall
    from classpro_tpu_torch.pack import pack_chunk

    gm, seqs, profs = _load(fx)
    wall = NativeWall(gm)
    slab, n_out, _n_rel, slot = wall.wall_stage_slab(
        [s.encode("ascii") for s in seqs], profs, threads=2)
    ivs = [slab[i * slot: i * slot + int(n_out[i])].copy()
           for i in range(len(seqs))]
    plens = [len(p) for p in profs]
    packs = []
    i0 = si = 0
    sizes = (4, 3, 5)
    while i0 + sizes[si % 3] <= len(seqs):
        g = list(range(i0, i0 + sizes[si % 3]))
        i0 += len(g)
        si += 1
        if all(len(ivs[i]) > 0 for i in g):
            packs.append((g, *pack_chunk(g, ivs, plens)))
    dims = Counter(p[3] for p in packs).most_common(1)[0][0]
    sel = [p for p in packs if p[3] == dims]
    sel = sorted(sel, key=lambda p: len(p[0]))
    sel = [sel[0], sel[-1], sel[1], sel[-2]][:D]
    assert len({len(p[0]) for p in sel}) > 1
    return (gm, [p[0] for p in sel], np.stack([p[1] for p in sel]),
            np.stack([p[2] for p in sel]), dims, [p[4] for p in sel])


def check_shards(out, flags, groups, metas, gold, K):
    """Each shard's unflagged reads expand to their golden class string
    (the reads of THAT shard: a mis-routed shard cannot pass)."""
    from classpro_tpu_torch.pack import expand_asgn

    for d, (g, meta) in enumerate(zip(groups, metas)):
        res = [None] * len(gold)
        expand_asgn(out[d], meta, res, K)
        for r, i in enumerate(g):
            if not flags[d][r]:
                assert res[i] == gold[i], \
                    f"shard {d} read {i}: sharded output != golden"


@pytest.fixture(scope="module")
def shards():
    from classpro_tpu_torch.params import build_replicas

    gm, groups, fbs, ibs, dims, metas = shard_inputs()
    PPs = build_replicas(gm, ["cpu"] * 4, alldev=True)
    assert list(PPs) == [torch.device("cpu")]
    return gm, groups, fbs, ibs, dims, metas, PPs


def test_sharded_classify_matches_jax_and_single(shards):
    from classpro_tpu.parallel.mesh import (data_parallel_mesh,
                                            sharded_classify as jax_sharded)

    from classpro_tpu_torch.alldev import classify_batch
    from classpro_tpu_torch.parallel.mesh import sharded_classify

    gm, groups, fbs, ibs, dims, metas, PPs = shards
    out, flags = sharded_classify(["cpu"] * 4, fbs, ibs, PPs, dims)
    assert out.shape == (4, dims[0], dims[1]) and out.dtype == np.int8
    assert flags.shape == (4, dims[0]) and flags.dtype == bool
    for d in range(4):
        o, f = classify_batch(torch.from_numpy(fbs[d]),
                              torch.from_numpy(ibs[d]), PPs[torch.device(
                                  "cpu")], *dims)
        np.testing.assert_array_equal(out[d], o.numpy())
        np.testing.assert_array_equal(flags[d], f.numpy())
    mesh = data_parallel_mesh(jax.devices()[:4])
    jo, jf = (np.asarray(x) for x in jax_sharded(mesh, fbs, ibs,
                                                  _jax_pp("tiny"), dims))
    np.testing.assert_array_equal(flags, jf)
    np.testing.assert_array_equal(out[~flags], jo[~jf])
    check_shards(out, flags, groups, metas, _gold("tiny"), gm.kmer)


def test_sharded_classify_rolled_shards_fail(shards):
    """The routing check bites: with the shard axis rolled by one, the
    shards' outputs no longer belong to their read groups."""
    from classpro_tpu_torch.parallel.mesh import sharded_classify

    gm, groups, fbs, ibs, dims, metas, PPs = shards
    out, flags = sharded_classify(["cpu"] * 4, np.roll(fbs, 1, axis=0),
                                  np.roll(ibs, 1, axis=0), PPs, dims)
    with pytest.raises(AssertionError, match="sharded output"):
        check_shards(out, flags, groups, metas, _gold("tiny"), gm.kmer)


def test_sharded_classify_refuses_mismatched_counts(shards):
    from classpro_tpu_torch.parallel.mesh import sharded_classify

    _, _, fbs, ibs, dims, _, PPs = shards
    with pytest.raises(ValueError, match="3 devices for 4"):
        sharded_classify(["cpu"] * 3, fbs, ibs, PPs, dims)
