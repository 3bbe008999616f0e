"""The all-device chunk as one CUDA graph per bucket (alldev.BatchGraph,
cached by alldev.BatchGraphs): the sweep kernel's gate tail, which writes
each read's assignment bytes and its guard flag as one packed row, the
five launches a graph captures (alldev.classify_glued), the refusals that
keep a card's path from falling back, and on the card the replay against
the eager launches and the plain glue, a stream with three chunks in
flight on one bucket, two models on one bucket and ``sharded_classify``
over one card named four times.

The gate tail runs through its g++ shim (``kernels.unrel_sweeps_host``
with ``gate``) on the sweeps' inputs of real chunks (tiny, medium chunk 0
and every ``branch/*`` fixture), the chunk's own margin gates from
rel_settle's shim, and on gates planted at each read's margin: open
([-inf, inf], a read with a risky rel margin), the unflagged gate
(``kernels.GATE_UNFLAGGED``), and gates whose edges sit at the read's
margin or one ulp beside it on either side (a sweep's margin cannot be
chosen, so the smallest positive double and the double below 1e-5, the
unflagged gate's edges, are held as the comparisons lo <= margin and
margin <= hi at equality and one ulp off).

On the CPU the engine runs the plain versions and captures nothing; the
``gpu`` tests run on the card and skip without one.  This file imports
no JAX.

Tolerance: every byte of the packed result and every bit of the margins
(the tail against the plain ``clamp ==`` + ``cat``; the shims against the
plain versions; the graph against the eager launches; the stream against
single chunks and the goldens).
"""
import gzip
import math
import pathlib
import types

import numpy as np
import pytest
import torch

from test_torch_kernel_shim import _load
from test_torch_unrel_shim import random_sweep_inputs

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"
BRANCH = sorted("branch/" + p.name for p in (FIX / "branch").iterdir()
                if p.is_dir())


def _gold(fx: str, name: str = "golden.class.gz") -> list:
    with gzip.open(FIX / fx / name, "rt") as f:
        return f.read().split("\n")[3::4]


def _shims():
    """The kernels' g++ shims under the kernels module's names."""
    from classpro_tpu_torch import kernels

    return types.SimpleNamespace(
        rel_prep=kernels.rel_prep_host, rel_dp=kernels.rel_dp_host,
        rel_dp_rescue=kernels.rel_dp_rescue_host,
        rel_settle=kernels.rel_settle_host,
        unrel_sweeps=kernels.unrel_sweeps_host)


def _packs(gm, seqs, profs, B: int = 200):
    """(fblob, iblob, dims) of each chunk of B reads, as
    TorchEngine(alldev=True) packs it (numpy)."""
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.pack import pack_chunk

    eng = TorchEngine(gm, device="cpu", alldev=True)
    out = []
    for lo in range(0, len(seqs), B):
        st = eng._stage(seqs[lo:lo + B], profs[lo:lo + B])
        if "g" not in st:
            continue
        slab, slot, n_out = st["slab"], st["slot"], st["n_out"]
        rows = [r for r in range(len(st["g"])) if n_out[r] > 0]
        if not rows:
            continue
        ivs = [slab[r * slot: r * slot + int(n_out[r])]
               for r in range(len(st["g"]))]
        fb, ib, dims, _ = pack_chunk(
            rows, ivs, [len(st["profiles"][i]) for i in st["g"]])
        out.append((fb, ib, dims))
    return out


def _chunk(fx: str, k: int = 0, device: str = "cpu"):
    """(PipelineParams, fblob, iblob, dims) of chunk k of a fixture."""
    from classpro_tpu_torch.params import build_pipeline_params

    gm, seqs, profs = _load(fx)
    fb, ib, dims = _packs(gm, seqs, profs)[k]
    return (build_pipeline_params(gm, device), torch.from_numpy(fb).to(device),
            torch.from_numpy(ib).to(device), dims)


def _sweep_inputs(PP, fb, ib, dims):
    """The sweep kernel's arguments of a chunk and its margin gates, as the
    shims of rel_prep, the DP's two passes and rel_settle leave them."""
    from classpro_tpu_torch import kernels

    Bn, max_n, R2, max_m = dims
    ops = _shims()
    V = kernels.blob_views(fb, ib, *dims)
    planes, cov, un = ops.rel_prep(fb, ib, PP.rel, R2 // 2, max_m,
                                   alldev=(Bn, max_n))
    a1, _, m1, rescue, cov2 = ops.rel_dp_rescue(*planes, cov, PP.rel)
    a2, _, m2 = ops.rel_dp(*planes, cov2, PP.rel, active=rescue)
    ops.rel_settle(a1, a2, m1, m2, rescue, planes, V["rel_rows"],
                   V["rel_cols"], PP.rel, un["asgn"], un["gate"])
    args = (un["is_rel"], un["asgn"], un["P13"], un["packL"], un["packR"],
            V["idx_desc"], V["idx_asc"], un["live"], V["n"])
    return args, un["gate"]


def _planted_gates(mm):
    """Gates (2, B) planted at each read's margin m, each with lo <= hi as
    rel_settle writes them: open; unflagged (lo, hi); [m, m]; one ulp
    above m to inf; -inf to one ulp below m; [lo, max(m, lo)]; [min(m,
    hi), hi]."""
    from classpro_tpu_torch.kernels import GATE_UNFLAGGED

    inf = math.inf
    full = lambda v: torch.full_like(mm, v)
    lo, hi = full(GATE_UNFLAGGED[0]), full(GATE_UNFLAGGED[1])
    return [torch.stack(g) for g in (
        (full(-inf), full(inf)), (lo, hi), (mm, mm),
        (torch.nextafter(mm, full(inf)), full(inf)),
        (full(-inf), torch.nextafter(mm, full(-inf))),
        (lo, torch.maximum(mm, lo)), (torch.minimum(mm, hi), hi))]


def _check_gate_tails(args, gates, P):
    """The shim's gate tail on each of ``gates`` against the plain sweeps
    and gate_ref, every byte; its margins and rows against the shim
    without the tail.  Returns the flags of the live reads, all gates'."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.alldev import gate_ref
    from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

    plain = unrel_sweeps_ref(*args, P)
    out, mm0 = kernels.unrel_sweeps_host(*args, P)
    live = args[8] > 0
    flags = []
    for gate in gates:
        packed, mm = kernels.unrel_sweeps_host(*args, P, gate=gate)
        assert packed.dtype == torch.uint8
        assert packed.shape == (out.shape[0], out.shape[1] + 1)
        assert torch.equal(packed, gate_ref(*plain, gate))
        assert torch.equal(packed[:, :-1].view(torch.int8), out)
        assert torch.equal(mm.view(torch.int64), mm0.view(torch.int64))
        flags.append(packed[live, -1])
    return torch.cat(flags)


@pytest.mark.parametrize("fx", ["tiny", "medium"] + BRANCH)
def test_gate_tail_matches_plain_on_chunks(fx):
    """The sweeps' gate tail through the g++ shim == the plain clamp == +
    cat, byte for byte, on chunk 0 of each fixture: with the chunk's own
    gates from rel_settle's shim, and with gates planted at each read's
    margin (open, unflagged, edges at the margin and one ulp off); both
    flag values are written."""
    from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

    PP, fb, ib, dims = _chunk(fx)
    args, gate = _sweep_inputs(PP, fb, ib, dims)
    mm = unrel_sweeps_ref(*args, PP.unrel)[1]
    flags = _check_gate_tails(args, [gate] + _planted_gates(mm), PP.unrel)
    assert bool(flags.any()) and not bool(flags.all())


def test_gate_tail_on_long_rows():
    """The gate tail on rows past the block's shared memory (the rows'
    state in the global scratch): 12 rows of up to 1100 intervals."""
    from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

    PP = _chunk("tiny")[0]
    args = random_sweep_inputs(5, PP.rel, case="n1100")
    mm = unrel_sweeps_ref(*args, PP.unrel)[1]
    _check_gate_tails(args, _planted_gates(mm), PP.unrel)


def test_gate_tail_refuses_a_bad_gate():
    from classpro_tpu_torch import kernels

    PP = _chunk("tiny")[0]
    args = random_sweep_inputs(3, PP.rel)
    B = args[1].shape[0]
    for bad in (torch.zeros((2, B), dtype=torch.float32),
                torch.zeros((2, B + 1), dtype=torch.float64),
                torch.zeros((B, 2), dtype=torch.float64)):
        with pytest.raises(ValueError, match="gate"):
            kernels.unrel_sweeps_host(*args, PP.unrel, gate=bad)


@pytest.mark.parametrize("fx,k", [("tiny", 0), ("medium", 0),
                                  ("branch/search9", 0)])
def test_classify_glued_packed_equals_plain(fx, k):
    """classify_glued on the shims (the five launches a graph captures)
    returns the packed (Bn, max_n + 1) uint8 of classify_batch's plain
    versions, every byte, and launches nothing on the CPU."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.alldev import (classify_batch, classify_glued,
                                           pack_flags)

    PP, fb, ib, dims = _chunk(fx, k)
    c0 = dict(kernels.LAUNCHES)
    got = classify_glued(fb, ib, PP, *dims, _shims())
    want = pack_flags(*classify_batch(fb, ib, PP, *dims, impl="ref"))
    assert got.dtype == torch.uint8 and got.shape == (dims[0], dims[1] + 1)
    assert torch.equal(got, want)
    assert kernels.LAUNCHES == c0


def test_padding_chunk_through_the_shims():
    """A graph's padding blobs (-inf, ones: every index in range, every
    read pair on one cell) run through the five launches' shims as
    through the plain versions."""
    from classpro_tpu_torch.alldev import (blob_sizes, classify_batch,
                                           classify_glued, pack_flags)

    PP = _chunk("tiny")[0]
    dims = (8, 32, 16, 32)
    n_f, n_i = blob_sizes(*dims)
    fb = torch.full((n_f,), -math.inf, dtype=torch.float64)
    ib = torch.ones(n_i, dtype=torch.int32)
    got = classify_glued(fb, ib, PP, *dims, _shims())
    assert torch.equal(got, pack_flags(*classify_batch(fb, ib, PP, *dims,
                                                       impl="ref")))


def test_batch_graphs_refuse_the_cpu():
    """No fallback: a batch graph, the graph cache and classify_batch's
    card path raise for PipelineParams on the CPU, and capture
    nothing."""
    from classpro_tpu_torch import alldev

    PP, fb, ib, dims = _chunk("tiny")
    n0 = dict(alldev.GRAPH_COUNTS)
    with pytest.raises(ValueError, match="CUDA"):
        alldev.BatchGraph(PP, *dims)
    cache = alldev.BatchGraphs()
    with pytest.raises(ValueError, match="CUDA"):
        cache.get(PP, *dims)
    assert len(cache) == 0
    with pytest.raises(ValueError, match="CUDA"):
        alldev.classify_batch(fb, ib, PP, *dims, impl="cuda")
    assert alldev.GRAPH_COUNTS == n0


def test_alldev_engine_on_the_cpu_runs_the_plain_stage():
    """On the CPU the all-device engine's device stage is classify_batch's
    plain versions, its warm-up included: the tiny golden, no graph
    captured or replayed, no kernel launch counted."""
    from classpro_tpu_torch import alldev, kernels, rel
    from classpro_tpu_torch.engine import TorchEngine

    gm, seqs, profs = _load("tiny")
    eng = TorchEngine(gm, device="cpu", alldev=True)
    counts = lambda: (dict(alldev.GRAPH_COUNTS), dict(rel.GRAPH_COUNTS),
                      dict(kernels.LAUNCHES), dict(kernels.TAIL_LAUNCHES))
    c0 = counts()
    eng.warmup(((8, 32, 16, 32),))
    assert eng.stats()["shapes"] == [[8, 32]]
    chunks = [(seqs[lo:lo + 50], profs[lo:lo + 50])
              for lo in range(0, len(seqs), 50)]
    got = [c for out in eng.classify_stream(iter(chunks)) for c in out]
    assert got == _gold("tiny")[:len(seqs)]
    assert len(eng._batch_graphs) == 0 and len(eng._graphs) == 0
    assert counts() == c0


# ----------------------------------------------------------------- card

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_counts() -> dict:
    from classpro_tpu_torch import alldev, kernels

    return dict(kernels.LAUNCHES, **{f"tails.{k}": n for k, n in
                                     kernels.TAIL_LAUNCHES.items()},
                **{f"graphs.{k}": n for k, n in alldev.GRAPH_COUNTS.items()})


# what one capture's eager run, and one replay, count: the five launches
BATCH_LAUNCHES = {"rel_prep": 1, "rel_dp": 2, "rel_settle": 1,
                  "unrel_sweeps": 1, "tails.rel_rescue": 1, "tails.gate": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("fx,k", [("medium", 0), ("medium", 1),
                                  ("branch/search9", 0)])
def test_batch_graph_replay_matches_eager_and_plain_on_card(fx, k):
    """A chunk's graph replay == its five eager launches (classify_glued)
    == the plain glue around the DP and sweep kernels, every byte; the
    gate tail's packed rows == K5 without the tail + gate_ref; the capture
    counts only its eager run, each replay the five launches; a blob of
    another shape is refused."""
    _need_card()
    from classpro_tpu_torch import alldev, kernels

    PP, fb, ib, dims = _chunk(fx, k, "cuda")
    c0 = _card_counts()
    g = alldev.BatchGraph(PP, *dims)
    c1 = _card_counts()
    got = g.run(fb, ib).clone()
    c2 = _card_counts()
    eager = alldev.classify_glued(fb, ib, PP, *dims, kernels)
    plain = alldev.pack_flags(*alldev.classify_batch(
        fb, ib, PP, *dims, impl=(kernels.rel_dp, kernels.unrel_sweeps)))
    torch.cuda.synchronize()
    assert torch.equal(got, eager) and torch.equal(got, plain)
    diff = lambda a, b: {x: b[x] - a[x] for x in b if b[x] != a[x]}
    assert diff(c0, c1) == dict(BATCH_LAUNCHES, **{"graphs.captures": 1})
    assert diff(c1, c2) == dict(BATCH_LAUNCHES, **{"graphs.replays": 1})
    with pytest.raises(ValueError):
        g.run(fb[:-1], ib)


@pytest.mark.gpu
def test_alldev_stream_with_three_in_flight_matches_single_chunks_on_card():
    """Chunks that share buckets, three in flight on the engine's one
    stream (each bucket's static buffers reused by every chunk), give the
    bytes of the same chunks run one at a time, and medium's golden."""
    _need_card()
    from classpro_tpu_torch import alldev
    from classpro_tpu_torch.engine import TorchEngine

    gm, seqs, profs = _load("medium")
    B = 50
    chunks = [(seqs[lo:lo + B], profs[lo:lo + B])
              for lo in range(0, len(seqs), B)]
    dims = [d for _, _, d in _packs(gm, seqs, profs, B)]
    assert len(dims) == len(chunks) and len(set(dims[1:])) == 1
    one = TorchEngine(gm, batch_size=B, device="cuda", alldev=True)
    want = [one.classify_chunk(s, p) for s, p in chunks]
    eng = TorchEngine(gm, batch_size=B, device="cuda", alldev=True)
    r0 = alldev.GRAPH_COUNTS["replays"]
    got = list(eng.classify_stream(iter(chunks), prefetch=0))
    assert got == want
    assert [c for w in got for c in w] == _gold("medium")[:len(seqs)]
    assert alldev.GRAPH_COUNTS["replays"] - r0 == len(chunks)
    assert len(eng._batch_graphs) == len(set(dims))


@pytest.mark.gpu
def test_two_models_on_one_bucket_on_card(tmp_path):
    """Models in one process: tiny with its .hist model and with its -M
    HIsim model, each through an all-device engine, write their goldens;
    tiny's pack with both and with medium's PipelineParams through one
    graph cache gets one graph per model, each replay equal to its own
    model's eager launches (medium's result differs from tiny's, so a
    graph replaying another model's tables would show)."""
    _need_card()
    from classpro_tpu_torch import alldev, kernels
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram
    from classpro_tpu_torch.params import build_pipeline_params

    model = tmp_path / "hisim.model"
    model.write_bytes(gzip.decompress(
        (FIX / "tiny" / "hisim.model.gz").read_bytes()))
    gm, seqs, profs = _load("tiny")
    gm_M = build_global_model(load_histogram(str(FIX / "tiny" / "reads")),
                              model_path=str(model))
    PPs = []
    for g, gold in ((gm, "golden.class.gz"), (gm_M, "golden_M.class.gz")):
        eng = TorchEngine(g, device="cuda", alldev=True)
        got = [c for out in eng.classify_stream(iter([(seqs, profs)]))
               for c in out]
        assert got == _gold("tiny", gold)[:len(seqs)]
        PPs.append(eng.PP)
    PPs.append(build_pipeline_params(_load("medium")[0], "cuda"))
    fb, ib, dims = _packs(gm, seqs, profs)[0]
    fb, ib = torch.from_numpy(fb).cuda(), torch.from_numpy(ib).cuda()
    cache = alldev.BatchGraphs()
    want = [alldev.classify_glued(fb, ib, P, *dims, kernels) for P in PPs]
    for j in (0, 1, 2, 0, 1, 2):
        assert torch.equal(cache.get(PPs[j], *dims).run(fb, ib), want[j])
    assert len(cache) == 3
    assert not torch.equal(want[0], want[2])


@pytest.mark.gpu
def test_sharded_classify_over_one_card_named_four_times_on_card():
    """sharded_classify over [cuda:0] * 4, four distinct medium read
    groups at one dims (one bucket graph replayed four times on one
    stream, its static output overwritten by each replay): each shard
    equals a single-shard call, and the shards differ."""
    _need_card()
    from classpro_tpu_torch.alldev import classify_batch
    from classpro_tpu_torch.native import NativeWall
    from classpro_tpu_torch.pack import pack_chunk
    from classpro_tpu_torch.params import build_replicas
    from classpro_tpu_torch.parallel.mesh import sharded_classify

    gm, seqs, profs = _load("medium")
    wall = NativeWall(gm)
    slab, n_out, n_rel, slot = wall.wall_stage_slab(
        [s.encode("ascii") for s in seqs], profs)
    ivs = [slab[i * slot: i * slot + int(n_out[i])].copy()
           for i in range(len(seqs))]
    wall.release_slab(slab)
    plens = [len(p) for p in profs]
    order = sorted((i for i in range(len(seqs)) if n_out[i] > 0),
                   key=lambda i: (int(n_out[i]), int(n_rel[i])))
    packs = [pack_chunk(sorted(order[d::4]), ivs, plens) for d in range(4)]
    dims = packs[0][2]
    assert all(p[2] == dims for p in packs)
    fbs = np.stack([p[0] for p in packs])
    ibs = np.stack([p[1] for p in packs])
    devices = ["cuda:0"] * 4
    PPs = build_replicas(gm, devices, alldev=True)
    out, flags = sharded_classify(devices, fbs, ibs, PPs, dims)
    dev = torch.device("cuda:0")
    for d in range(4):
        o, f = classify_batch(torch.from_numpy(fbs[d]).to(dev),
                              torch.from_numpy(ibs[d]).to(dev), PPs[dev],
                              *dims)
        np.testing.assert_array_equal(out[d], o.cpu().numpy())
        np.testing.assert_array_equal(flags[d], f.cpu().numpy())
    assert len({out[d].tobytes() for d in range(4)}) == 4
