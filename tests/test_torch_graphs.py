"""The main chunk as one CUDA graph per bucket (rel.ChunkGraph, cached by
rel.RelGraphs): the two launches it captures (rel.rel_glued: the DP
kernel's first pass with its prologue and tails, then its rescue pass
with its pack tail), the refusals that keep a card's path from falling
back, and on the card the replay against the eager launches and the
plain glue, a stream with three chunks in flight on one bucket, two
models on one bucket and the warm-up's captures.

On the CPU the engine runs the plain versions and captures nothing; the
``gpu`` tests run on the card and skip without one.  This file imports
no JAX.

Tolerance: every byte of the packed result (the kernels against their
plain glue around the same DP kernel, the graph against the eager
launches, the stream against single chunks and the goldens).
"""
import dataclasses
import gzip
import json
import pathlib

import numpy as np
import pytest
import torch

from test_torch_kernel_shim import _load

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"


def _gold(fx: str, name: str = "golden.class.gz") -> list:
    with gzip.open(FIX / fx / name, "rt") as f:
        return f.read().split("\n")[3::4]


def _pack(fx: str, n=None, device="cpu", k: int = 0):
    """(engine, fblob, iblob, R, max_m) of chunk k of a fixture at batch
    200, the blobs on ``device``."""
    from classpro_tpu_torch.engine import TorchEngine

    gm, seqs, profs = _load(fx, n)
    eng = TorchEngine(gm, device=device)
    lo = 200 * k
    fb, ib, R, max_m = eng.stage_pack(seqs[lo:lo + 200], profs[lo:lo + 200])
    return (eng, torch.from_numpy(fb).to(device),
            torch.from_numpy(ib).to(device), R, max_m)


class _Recorder:
    """The kernels' g++ shims under the wrappers' names, recording the
    calls (what rel_glued launches on a card, and in which order)."""

    def __init__(self):
        from classpro_tpu_torch import kernels

        self.calls = []
        for name in ("rel_dp_first", "rel_dp_pack", "rel_dp_rescue",
                     "rel_dp", "rel_prep"):
            shim = getattr(kernels, name + "_host")
            setattr(self, name, self._record(name, shim))

    def _record(self, name, fn):
        def call(*a, **kw):
            self.calls.append(name)
            return fn(*a, **kw)
        return call


@pytest.mark.parametrize("fx,n", [("tiny", None), ("branch/search9", None)])
def test_rel_glued_is_the_first_pass_then_the_rescue_pass(fx, n):
    """rel_glued, the work a chunk graph captures, is exactly two launches
    of the DP kernel (the first pass with its prologue, then the rescue
    pass with its pack tail; no rel_prep), and their shims' packed bytes
    equal rel_only's plain glue around the DP shim, every byte."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.rel import rel_glued, rel_only

    eng, fb, ib, R, max_m = _pack(fx, n)
    ops = _Recorder()
    got = rel_glued(fb, ib, eng.P, R, max_m, ops)
    assert ops.calls == ["rel_dp_first", "rel_dp_pack"]
    want = rel_only(fb, ib, eng.P, R, max_m, impl=kernels.rel_dp_host)
    assert torch.equal(got, want)
    if fx == "branch/search9":
        assert bool((got[:, max_m] & 2).any())     # rows rescued


def test_chunk_graphs_refuse_the_cpu():
    """No fallback: a chunk graph, the graph cache and rel_only's card
    path raise for RelParams on the CPU, and capture nothing."""
    from classpro_tpu_torch import rel

    eng, fb, ib, R, max_m = _pack("tiny")
    n0 = dict(rel.GRAPH_COUNTS)
    with pytest.raises(ValueError, match="CUDA"):
        rel.ChunkGraph(eng.P, R, max_m)
    cache = rel.RelGraphs()
    with pytest.raises(ValueError, match="CUDA"):
        cache.get(eng.P, R, max_m)
    assert len(cache) == 0
    with pytest.raises(ValueError, match="CUDA"):
        rel.rel_only(fb, ib, eng.P, R, max_m, impl="cuda")
    assert rel.GRAPH_COUNTS == n0


def test_engine_on_the_cpu_runs_the_plain_stage_and_captures_nothing():
    """On the CPU the engine's rel stage is rel_only's plain versions (its
    warm-up included): the tiny golden, no graph captured or replayed, no
    kernel launch counted."""
    from classpro_tpu_torch import kernels, rel
    from classpro_tpu_torch.engine import TorchEngine

    gm, seqs, profs = _load("tiny")
    eng = TorchEngine(gm, device="cpu")
    n0, c0 = dict(rel.GRAPH_COUNTS), dict(kernels.LAUNCHES)
    eng.warmup(((8, 32),))
    chunks = [(seqs[lo:lo + 50], profs[lo:lo + 50])
              for lo in range(0, len(seqs), 50)]
    got = [c for out in eng.classify_stream(iter(chunks)) for c in out]
    assert got == _gold("tiny")[:len(seqs)]
    assert len(eng._graphs) == 0
    assert rel.GRAPH_COUNTS == n0 and kernels.LAUNCHES == c0


def test_trace_share_counts_both_dp_entry_functions(tmp_path):
    """The profiler summary counts the DP kernel's events of both entry
    functions: the rescue pass's rel_dp_kernel and the first pass's
    rel_dp_first_kernel."""
    from classpro_tpu_torch.devtools import profile_summary as ps

    ev = lambda name, ts: {"ph": "X", "name": name, "cat": "kernel",
                           "ts": ts, "dur": 10}
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        ev("rel_dp_first_kernel(rd::Args, int)", 0),
        ev("rel_dp_kernel(rd::Args, int)", 20),
        ev("rel_prep_alldev_kernel(gl::Prep)", 40)]}))
    sh = ps.trace_share(str(path))
    assert sh["rel_dp_kernel_events"] == 2 and sh["rel_dp_kernel_us"] == 20


# ----------------------------------------------------------------- card

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_counts() -> dict:
    from classpro_tpu_torch import kernels, rel

    return dict(kernels.LAUNCHES, **{f"tails.{k}": n for k, n in
                                     kernels.TAIL_LAUNCHES.items()},
                **{f"graphs.{k}": n for k, n in rel.GRAPH_COUNTS.items()})


@pytest.mark.gpu
@pytest.mark.parametrize("fx,k", [("medium", 0), ("medium", 1),
                                  ("branch/search9", 0),
                                  ("branch/psum0", 0)])
def test_graph_replay_matches_eager_and_plain_on_card(fx, k):
    """A chunk's graph replay == its two eager launches (rel_glued) == the
    plain glue around the DP kernel (rel_only with rel_dp), every byte;
    the prologue's planes == rel.prep_ref's; each replay counts the DP
    kernel's two launches with its prologue and tails, the capture only
    its eager run."""
    _need_card()
    from classpro_tpu_torch import kernels, rel

    eng, fb, ib, R, max_m = _pack(fx, device="cuda", k=k)
    P = eng.P
    c0 = _card_counts()
    g = rel.ChunkGraph(P, R, max_m)
    c1 = _card_counts()
    got = g.run(fb, ib).clone()
    c2 = _card_counts()
    eager = rel.rel_glued(fb, ib, P, R, max_m, kernels)
    plain = rel.rel_only(fb, ib, P, R, max_m, impl=kernels.rel_dp)
    planes, cov = kernels.rel_dp_first(fb, ib, P, R, max_m)[:2]
    p_r, c_r = rel.prep_ref(fb, ib, P, R, max_m)
    torch.cuda.synchronize()
    assert torch.equal(got, eager) and torch.equal(got, plain)
    for a, b in zip(planes + (cov,), p_r + (c_r,)):
        assert torch.equal(a.view(torch.int64) if a.dtype == torch.float64
                           else a, b.view(torch.int64)
                           if b.dtype == torch.float64 else b)
    diff = lambda a, b: {x: b[x] - a[x] for x in b if b[x] != a[x]}
    assert diff(c0, c1) == {"rel_dp": 2, "tails.prologue": 1,
                            "tails.rel_rescue": 1, "tails.rel_pack": 2,
                            "graphs.captures": 1}
    assert diff(c1, c2) == {"rel_dp": 2, "tails.prologue": 1,
                            "tails.rel_rescue": 1, "tails.rel_pack": 2,
                            "graphs.replays": 1}
    with pytest.raises(ValueError):
        g.run(fb[:-1], ib)
    if fx == "branch/search9":
        assert bool((got[:, max_m] & 2).any())


@pytest.mark.gpu
def test_stream_with_three_in_flight_matches_single_chunks_on_card():
    """Many chunks that share buckets, three in flight on the engine's one
    stream (each bucket's static buffers reused by every chunk), give the
    bytes of the same chunks run one at a time, and medium's golden."""
    _need_card()
    from classpro_tpu_torch import rel
    from classpro_tpu_torch.engine import TorchEngine

    gm, seqs, profs = _load("medium")
    B = 25
    chunks = [(seqs[lo:lo + B], profs[lo:lo + B])
              for lo in range(0, len(seqs), B)]
    one = TorchEngine(gm, batch_size=B, device="cuda")
    want = [one.classify_chunk(s, p) for s, p in chunks]
    eng = TorchEngine(gm, batch_size=B, device="cuda")
    r0 = rel.GRAPH_COUNTS["replays"]
    got = list(eng.classify_stream(iter(chunks), prefetch=0))
    assert got == want
    assert [c for w in got for c in w] == _gold("medium")[:len(seqs)]
    replays = rel.GRAPH_COUNTS["replays"] - r0
    assert replays == len(chunks) and len(eng._graphs) * 3 <= replays


@pytest.mark.gpu
def test_two_models_on_one_bucket_on_card(tmp_path):
    """Two models in one process: tiny with its .hist model and with its
    -M HIsim model each write their golden; and tiny's pack run with
    tiny's and medium's RelParams through one graph cache gets one graph
    per model, each replay equal to its own model's eager launches."""
    _need_card()
    from classpro_tpu_torch import kernels, rel
    from classpro_tpu_torch.engine import TorchEngine, classify_file_torch

    model = tmp_path / "hisim.model"
    model.write_bytes(gzip.decompress(
        (FIX / "tiny" / "hisim.model.gz").read_bytes()))
    d = FIX / "tiny"
    for mp, gold in ((None, "golden.class.gz"),
                     (str(model), "golden_M.class.gz")):
        recs = list(classify_file_torch(str(d / "reads.fasta.gz"),
                                        str(d / "reads"), model_path=mp,
                                        device="cuda"))
        assert [r.classes for r in recs] == _gold("tiny", gold)[:len(recs)]
    eng, fb, ib, R, max_m = _pack("tiny", device="cuda")
    other = TorchEngine(_load("medium")[0], device="cuda").P
    cache = rel.RelGraphs()
    want = {id(P): rel.rel_glued(fb, ib, P, R, max_m, kernels)
            for P in (eng.P, other)}
    for P in (eng.P, other, eng.P, other):
        assert torch.equal(cache.get(P, R, max_m).run(fb, ib), want[id(P)])
    assert len(cache) == 2
    assert not torch.equal(want[id(eng.P)], want[id(other)])


@pytest.mark.gpu
def test_warmup_captures_each_shape_and_bad_params_raise_on_card():
    """TorchEngine.warmup captures one graph per shape (after the DP
    kernel's two launches run eagerly) and replays none; RelParams the
    kernels refuse raise at capture, and the next capture succeeds."""
    _need_card()
    from classpro_tpu_torch import kernels, rel
    from classpro_tpu_torch.engine import TorchEngine

    gm = _load("tiny")[0]
    eng = TorchEngine(gm, device="cuda")
    c0 = _card_counts()
    eng.warmup(((8, 32), (16, 64)))
    c1 = _card_counts()
    assert len(eng._graphs) == 2
    assert c1["graphs.captures"] - c0["graphs.captures"] == 2
    assert c1["graphs.replays"] == c0["graphs.replays"]
    assert c1["rel_dp"] - c0["rel_dp"] == 4
    bad = dataclasses.replace(eng.P, logfact=eng.P.logfact.float())
    with pytest.raises(ValueError):
        rel.ChunkGraph(bad, 8, 32)
    g = rel.ChunkGraph(eng.P, 8, 32)
    fb = torch.full((8 * 32,), -np.inf, dtype=torch.float64, device="cuda")
    ib = torch.ones(4 * 8 * 32 + 2 * 8, dtype=torch.int32, device="cuda")
    assert torch.equal(g.run(fb, ib),
                       rel.rel_glued(fb, ib, eng.P, 8, 32, kernels))
