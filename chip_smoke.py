#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (classpro_tpu_torch) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card; a few minutes

Phases, each of which fails the run (non-zero exit) when it fails:

1. probe   - CUDA present, card name and power limit (nvidia-smi).
2. build   - nvcc builds csrc/rel_dp.cu (the DP kernel with its
             first-pass prologue and its rescue and pack tails),
             csrc/unrel.cu and csrc/glue.cu (the two all-device glue
             kernels) for sm_90a (printing -Xptxas -v) while g++ builds the
             C++ host library (classpro_tpu_torch/csrc/host/
             classpro_host.cpp), all four at once, from the checkout; each
             entry function's registers, static shared bytes, stack and
             spill bytes (rel_dp_kernel and rel_dp_first_kernel, the DP
             kernel's two instantiations; unrel_kernel and
             unrel_gate_kernel, the sweep kernel's without and with its
             gate tail; rel_prep_alldev_kernel, rel_settle_kernel) are
             parsed from the log, and a stack or a spill fails the run.
3. kernel  - the DP kernel against its plain torch version (rel_ref) on
             the card: the packs of the medium fixture's chunks (batch 200,
             their natural (R, max_m) buckets), a pack whose rows the
             no-H rescue re-runs (branch/search9) and the all-dead row
             (branch/psum0); then the whole per-chunk stage (rel.rel_only:
             the replay of the bucket's CUDA graph of the DP kernel's two
             launches) against rel_only with the plain versions.
             Tolerance: asgn bit-equal on rows whose plain margin is >=
             1e-5, finite margins within 1e-9, the inf / 1e-30 margin
             patterns equal, rescue equal, risky equal except where the
             margin lies within 1e-9 of 1e-5.  On the same packs, against
             their plain versions on the kernel chain's own inputs, bit
             for bit: the fused first pass (rel_dp_first: its prologue's
             planes and coverages against rel.prep_ref, its pass against
             rel_dp's on those planes, rescue and cov2 against
             rel.rescue_rows); the rescue launch with its pack tail
             (rel_dp_pack) and the packed buffer against rel.pack_ref (a
             NaN margin's bytes only NaN on both sides); the chunk's CUDA
             graph (rel.ChunkGraph, captured per pack): its replay's bytes
             equal to the two eager launches' and to the plain glue around
             the DP kernel, every byte, its capture and replays counted
             (two launches per replay); and the pack tail's merge on every
             pair of margins at the f32 conversion's edges (inf, -inf,
             NaN, 0, -0, 1e-30, 1e-300, the smallest double, 1e-5 and the
             double below it, 3.5e38; kernels.rel_tail_probe), and the
             rescue launch's pack tail on first-pass margins at those
             edges.  Times the DP kernel (CUDA events; us per step of the
             longest row), the fused first pass beside this tree's DP
             launch with both tails and no prologue, and the rescue pass
             with its pack tail (CUDA events around a CUDA graph of 20
             launches), the chunk graph's replay against the two eager
             wrapper calls, with the plain versions and bounds, at the
             medium shapes, with the launch geometry.  With --parent DIR
             (a checkout of an earlier commit, its rel_dp.cu and glue.cu
             built too): from a tree before the prologue its rel_prep
             (main layout) + DP first pass with its tails, and its rescue
             pass with its pack tail (from a later tree its own two
             launches), held against this tree's launches bit for bit
             (planes, passes, packed bytes) and timed in turns with them
             (parent, this tree, this tree, parent).
   k1profile, k5profile, settleprofile (only when named) - K1 (medium
             chunks), K5 (medium alldev chunks and the long-row chunk) or
             rel_settle (medium alldev chunks) built with its per-phase
             clocks against the production kernel bit for bit, both timed
             in turns, and the clock sums per step (per read pair for
             rel_settle).
4. e2e     - the main path: classify_file_torch over the tiny and medium
             fixtures writes .class files byte-identical to their
             golden.class.gz (tiny's -M golden runs in the serve phase);
             the launch counts are reset just before and read just after,
             and the DP kernel must have launched with its prologue and
             its rescue and pack tails (kernels.TAIL_LAUNCHES), a chunk
             graph must have replayed (rel.GRAPH_COUNTS) and rel_prep must
             not have launched.  Then two models on one bucket: tiny's
             pack with tiny's and with medium's RelParams through
             rel_only's process-wide graph cache, each replay equal to its
             own model's eager launches, one graph per model.
   setup   - a cold job's set-up by stage: classify_file_torch on
             medium (cuda) in a fresh process (its in-memory caches cold;
             the libraries this run built loaded, the Skellam table from
             its disk cache when an earlier phase wrote it), its .class
             byte-equal to the golden; the seconds of the interpreter's
             start, torch's import, the probe, the port's import, the
             CUDA context, the histogram and model, build_tables (the C++
             tail table), the Skellam table load, the tables' upload
             (device_tables), the libraries' loads, the first wall stage,
             the first graph capture and the first chunk's finish, each
             without the timed calls nested in it; then the same model's
             tail table by tables.btg_plain (numpy, the plain version),
             timed, and a seeded draw of six error rates through both
             versions: the run fails unless both tables are equal bit for
             bit on this host.
5. stream  - steady stream over medium through
             TorchEngine.classify_stream(sort_window=8) (the depth-3
             pipeline), every chunk checked against the golden: a warm-up
             (whole sort windows, which capture the buckets' graphs, and
             at least the stream's depth + 1 device chunks), then three runs (turns) of --passes passes.  Per
             turn: k-mers/s, the main thread's seconds by stage (host_s,
             enqueue_h2d_dp_d2h, unpack_out, demote_reconcile and
             exact_guard among them), the rel stage's span on the card
             per chunk (CUDA events around each graph replay),
             launches, replays and captures per chunk (two DP launches per
             replay and per capture's eager run, no rel_prep),
             guard_flagged (must be 0) and max_memory_allocated, and the
             enqueue by part, ms a chunk (_FEED_CLOCK: the C++ pack into
             the chunk's staging slot, the blobs into the graph's static
             inputs with the replay, the result's copy back with the
             event, host pinning, the rest), with every Tensor.pin_memory
             call and pinned torch.empty counted: a run after the warm-up
             fails unless both counts are 0.  Then
             the host check: every chunk of the warm-up's passes as
             the stream staged it, each chunk's staging slot held against
             a fresh pack_rel of the chunk bit for bit (fblob as uint64)
             as the enqueue sends it, its host rel steps (the C++
             NativeWall.demote_reconcile, the stream's own result and
             again at T = 8 and T = 1) held to numpy rel.demote_host +
             rel.reconcile_fwbw byte for byte, each timed per chunk in
             HOST_REL_TURNS (numpy, C++ at T = 8, C++ at T = 1, numpy).
             With --parent DIR, that checkout's main stream and this
             tree's, each tree a process of its own, in turns (parent,
             this, this, parent; TREE_RUNS runs of --passes passes each,
             golden bytes on every chunk): k-mers/s, the host rel steps'
             median ms a chunk, the main thread's seconds by stage
             (wall_stage_cpp, finish_batch_cpp, unpack_out,
             demote_reconcile, exact_guard, enqueue, waiting) and the
             enqueue by part with the pinning counts (0 and 0 for this
             tree).  --batch-size sets both streams' device chunk.
6. alldev  - the all-device path (alldev.classify_batch): on every chunk
             pack of medium at batch 200 the sweep kernel (csrc/unrel.cu)
             against its plain version (unrel_ref) on the card, asgn and
             margins bit-equal; its gate tail (unrel_gate_kernel: the
             rows packed with each read's guard flag) against the plain
             clamp == + cat (alldev.gate_ref) every byte, on the chunk's
             margin gates and on 7 gates planted at each read's margin;
             rel_prep in the all-device layout (alldev.prep_ref), the
             DP's first pass with its rescue tail (rel.rescue_rows) and
             rel_settle (alldev.settle_ref: the sweeps' assignment rows
             and the margin gate) against their plain versions, bit for
             bit; the whole classify_batch (the replay of the bucket's
             CUDA graph) against it with the plain versions, outputs and
             flags equal; the chunk's own alldev.BatchGraph: its replay's
             packed bytes equal to the five eager launches' and to the
             plain glue's around the DP and sweep kernels, every byte,
             its capture and replay counted (five launches each); times
             each (every chunk kept): the glue kernels with their launch
             geometry (threads and blocks, shared bytes per block), the
             sweep kernel with and without its gate tail in turns (CUDA
             graphs of 20 launches), the graph replay beside the five
             launches called eagerly (events around 20 calls), and the
             memory the capture reserved.  With --parent DIR (a checkout
             of an earlier commit), that checkout's rel_prep, rel_settle
             and sweep kernel are held against this tree's on every
             chunk, bit for bit, and timed in turns with them (parent,
             this tree, this tree, parent; the sweep kernel against this
             tree's with its gate tail).  Then one synthetic long-row
             chunk (the tests' random_sweep_inputs, 256 rows of up to
             1100 intervals: the rows' state in the global scratch)
             through the sweep kernel with and without the tail,
             bit-equal and timed.  Then TorchEngine(alldev=True) over tiny
             and medium writes the golden bytes (launch counts reset just
             before and read after: every kernel of the path > 0, the
             rescue and gate tails run, the pack tail not, batch graphs
             replayed, main chunk graphs not).
   alldev_stream (in alldev, or alone) - the alldev stream over medium (a
             warm-up (as in stream), which captures the buckets'
             graphs: its captures, the graphs held and memory_reserved
             before and after; then three turns of --alldev-passes
             passes): k-mers/s, the replay's span on the card per chunk
             (CUDA events around each BatchGraph.replay), launches,
             replays and captures per chunk (five launches per replay and
             per capture's eager run), the enqueue ms per chunk and where
             the main thread's time goes (host_s: pack_chunk_cpp and
             expand_cpp, the feed's C++ entries), the enqueue by part and
             the pinning counts (as in stream; 0 and 0 after the
             warm-up).  Then the feed alone:
             every chunk of the warm-up's passes as the stream fed it (its
             staging slot held against a fresh pack_chunk bit for bit as
             the enqueue sends it), its C++
             blobs (NativeWall.pack_chunk, the stream's own and again at
             T = 8 and T = 1) held against numpy pack.pack_chunk bit for
             bit (fblob as uint64), its C++ class lines (expand_rows)
             against pack.expand_asgn byte for byte, and each stage timed
             per chunk in FEED_TURNS (numpy, C++ at T = 8 and T = 1, and
             back).  With --parent DIR, that checkout's all-device stream
             and this tree's, each tree a process of its own, in turns
             (parent, this, this, parent; TREE_RUNS runs of
             --alldev-passes passes each, golden bytes): k-mers/s, the
             wall stage's and the feed's seconds, the enqueue by part and
             the pinning counts.
   glue_ab (only when named) - both streams with the two compositions of
             the per-chunk glue taken in turns (plain glue, kernels,
             kernels, plain glue): the plain torch glue around the DP and
             sweep kernels, as before the glue kernels, against the glue
             kernels; then, in a process of its own (so that the serve
             phase's --torch-profile stays the main process's only
             profiler session), one torch.profiler pass over medium of
             each composition of each stream: the kernel launch calls per
             device chunk and the kernels' time on the card by name.
   guard   - the exactness guard where it fires: a dataset of
             --guard-gbp (default 0.02) Gbp at K = 28 and 83x
             (devtools.soak.generate, seed 11; ~1,650 reads of ~12 kb on
             a 241 kb genome), made once in a temp dir.  (a) The main
             stream over it (batch 200, sort_window 8): a warm-up, a
             reference run with the guard's re-decisions as the plain
             per-row exact_rel loop (chip_smoke swaps it in for
             TorchEngine._exact_guard), three runs as the path ships (one
             exact_rel_batch per chunk on the -T workers), every chunk's
             bytes equal to the reference's, and a second plain run:
             k-mers/s, guard_flagged and its rate (equal in every run),
             the main thread's seconds by stage with exact_guard on its
             own, the enqueue by part and the pinning counts (0 and 0 in
             every run after the warm-up, both paths); the warm-up's
             chunks through the host check (as in
             the stream phase: demote_reconcile at T = 8 and T = 1
             against the numpy pair, byte for byte, and timed in
             HOST_REL_TURNS).  (b) The guard alone on the reference
             run's staged chunks: the per-row loop and the batch (at the
             -T workers, 4, 2 and 1, and at 1 on a fresh thread) in
             turns (GUARD_TURNS), seconds per chunk and ms per flagged
             row, threads and os.cpu_count(), rel_out equal
             byte for byte to the reference's.  (c) The all-device stream
             (a warm-up, then four runs: the C++ feed, the numpy feed
             swapped in twice, the C++ feed): k-mers/s, guard_flagged
             (equal in every run), the main thread's seconds by stage
             (exact_guard among them, as the alldev_stream phase prints
             them); every run's bytes equal to the main path's.  (d) 50
             flagged
             reads against the port's exact oracle: 0 mismatches.  With
             --parent DIR, that checkout's main and all-device streams and
             this tree's, each tree a process of its own, in turns
             (parent, this, this, parent; TREE_RUNS runs a path after a
             warm-up): every stream's bytes equal to the reference's, the
             same guard_flagged, k-mers/s, the guard's seconds, the
             enqueue by part and the pinning counts.
   bench   - the port's benchmark runner (python -m
             classpro_tpu_torch.devtools.bench) as four child processes:
             medium and the guard dataset (the guard phase's directory
             when that phase ran in this call, else made the same way),
             each on the main and the all-device path.  Each run must
             exit 0 with phase "done", parity_ok (every read of its first
             pass against medium's golden, the guard dataset's first 64
             reads against the exact oracle) and both rates (the steady
             stream's and the end-to-end one's, each the median of up to
             5 windows of ~4 s) above 0; medium's guard_flagged must be 0.
             A dataset's two runs must write the same bytes in their
             untimed first pass (the sha256 of every read's classes);
             when the guard phase ran, the guard dataset's must also be
             that phase's reference stream's, and its reads flagged per
             pass that phase's count on the same path.  Prints each run's
             medians, its windows' spread and the phase's seconds.
7. shard   - the parallel layer (K8) and the rest of classify's surface:
             (a) psum_histogram in a NCCL world of one rank equals its
             input (medium's partial instance histogram), the all-reduce
             timed with CUDA events, estimate_distributed == the .hist
             model; (b) the shard driver (run_process) with one process
             and with 4 in-process shards + the checked merge writes the
             tiny and medium goldens, and --resume after a truncated and
             a deleted shard recomputes only those two; (c)
             sharded_classify of 4 distinct medium read groups (packed
             and expanded by the C++ feed, held against numpy's) over
             cuda:{i % cards} (cuda:0 four times on one card) equals
             one classify_batch per shard, the four shards differ, its
             unflagged reads the C++ exact path, every kernel of the path
             launched, one batch graph replay per shard;
             (d) TorchEngine(devices=...) (every card, or cuda:0 twice on
             one card) writes the medium golden on both paths; (e)
             classify -s on tiny FASTX and on the tiny .dam fixture, and
             --stats-json, byte-equal to the fixtures; (f) with two or
             more cards, two NCCL ranks as processes of the driver; with
             one card it prints that (f) did not run.  (c) times 7 calls
             after the warm-up and prints each and their median.
8. serve   - the serve daemon through its entry point (`python -m
             classpro_tpu_torch.cli serve --warmup-root <medium>` on
             cuda, a subprocess; READY awaited): job 1 tiny by
             serve.request, job 1b tiny with its -M model by request (its
             own graph on tiny's bucket), job 2 medium by `classify
             --server`, each .class byte-equal to its golden; the warm-up
             ran two DP launches and captured one graph per shape; stats
             then show 3 jobs, graph replays, one
             table upload, and DP launches on the path (stats read before
             job 1 and after job 2); a job on a missing source replies
             ok: false and a ping after it succeeds; shutdown exits 0 and
             removes the socket.  Then `classify --warmup --torch-profile`
             on medium in this process (golden bytes; the Chrome trace
             must hold rel_dp_kernel events) and the card's busy share
             over the traced window.
9. tools   - the port's dev tools on the card: (a) debug-read (cuda) on
             read 0 of branch/psum0 (with its -c/-r) and of medium must
             print every section and end in "RESULT: oracle == production";
             (b) crafted fuzz datasets (devtools.fuzzgen), one GlobalModel
             each, through TorchEngine's main path (K1) and all-device
             path (K1, K5) in this process, against the port's exact
             oracle (worker processes): the default generator at K = 16,
             24, 32 and 40, --extreme, --cap, --ndense, a -M random model,
             and a .dam with -s (its .class and four track files compared
             with the oracle's too); every dataset must have 0 mismatching
             reads on both paths, and both kernels' launch counts (reset
             just before, read just after) must be > 0; (c)
             devtools.profile_summary on the serve phase's trace.  Prints
             the phase's seconds.
   soak (only when named; --soak-gbp, default 0.05) - devtools.soak on
             cuda at K = 28: the generator's seconds, classify wall, stream
             wall, k-mers/s, RSS peak, guard_flagged and its rate, spot
             parity against the exact oracle (0 mismatches), the two-shard
             merge's byte equality and the served job's wall.

It prints one {"kernels": [...]} line (unrel_sweeps with its gate tail:
the tail's launches on the all-device path, its time beside K5's
without it in turns, with --parent the parent's K5 in turns; rel_dp,
with its two tails
(rel_rescue, rel_pack: each fused launch's time beside the DP launch's
without it, the plain versions' times, the fused bounds, and with
--parent the parent's rescue pass in turns); rel_dp_first, the DP
kernel's fused first pass (its prologue replaced rel_prep's main layout:
its time beside the DP launch with its tails and no prologue, per replay
of the chunk graph and per eager call, and with --parent the parent's
rel_prep + DP first pass in turns); unrel_sweeps, rel_prep (the
all-device layout), rel_settle; each with its registers, shared bytes,
stack and spill bytes and launch geometry, rel_prep and rel_settle with
the parent's times when --parent is given), {"setup": {...}} (the
cold set-up's seconds by stage, the numpy and C++ tail tables' seconds),
{"stream": {...}},
{"alldev_stream": {...}}, {"glue_ab": {...}} (when named), {"guard":
{...}} (the guard phase's runs, turns and spot parity), {"bench": [...],
"card": ..., "seconds": ...} (the runner's four records), {"shard":
{...}} and {"serve": {...}} lines (ready_s, each job's wall_s and
k-mers/s, table_uploads, launches and graph replays, the trace's busy
share), {"tools": {...}} and {"soak": {...}} lines, the card's name and
power limit, and, as its last line, {"ok": true, "device": {"platform":
"gpu", "kind": ..., "count": ...}}.  It imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import gzip
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

# when torch's import starts and ends (the setup phase's child)
_T0_WALL, _T0 = time.time(), time.perf_counter()
import torch  # noqa: E402
_T1 = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "tests", "fixtures")
EPS = 1e-5          # REL_MARGIN_EPS
DEV = "cuda"        # the alldev phases' device
MARGIN_TOL = 1e-9   # absolute tolerance on finite margins
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP64 (non-tensor) op/s
PEAK_BYTES = 3.35e12
PEAK_F64 = 34e12
# f64 operations of one live DP step (init cell and traceback not
# counted), read off rel_dp_row.cuh step(): 4 source cells x (R emission
# ~10 + two log-Skellam lookups ~50 each + lambdas ~8), then the 4x4
# score table, special cases, argmaxes with margins, dh ratios and
# register counts ~250; log/exp/sqrt/floor and compares count as one.
OPS_PER_STEP = 700
# f64 operations of one active relaxation step, read off unrel_row.cuh
# step(): 25 plane reads (+0.0), the R-binomial term ~17, four coverage
# interpolations ~28, four Skellam drifts (lambda 4 + lookup ~50 each)
# ~216, the side combinations ~34, argmax and margin ~20; the neighbour
# search is counted apart, as the JAX program's 4 masked reductions over
# the row (4 x max_n compare-selects per step).
OPS_PER_UNREL_STEP = 360
# operations of the glue kernels and the DP kernel's fused parts, read off
# prep_cell.cuh, glue_row.cuh and rel_tail.cuh: per plane cell of the
# first pass's prologue (the reversal index, two clamps, the E emission:
# 2 products, 6 sums, a max ~15), per interval cell of the all-device rel_prep
# (4 Poisson terms of 3 each, the E emission's max, 8 casts ~25; its 3
# logs are per chunk), per D cell of rel_rescue (length, half count,
# keyed min ~10; its other live cells cost the two state tests of
# OPS_RESCUE_TEST), per cell of rel_pack (a select ~2) and per live cell
# of rel_settle (length, half count and the stage sums, the state after
# the stages and the reconciliation's compares, the scatter: ~40)
OPS_PREP_CELL = 15
OPS_PREP_UN_CELL = 25
OPS_RESCUE_CELL = 10
OPS_RESCUE_TEST = 2
OPS_PACK_CELL = 2
OPS_SETTLE_CELL = 40
# each kernel's entry functions in its nvcc build log (the DP kernel's
# two: the planes from another launch, and the main path's first pass
# with its prologue)
ENTRIES = {"rel_dp": ("rel_dp_kernel", "rel_dp_first_kernel"),
           "unrel_sweeps": ("unrel_kernel", "unrel_gate_kernel"),
           "rel_prep": ("rel_prep_alldev_kernel",),
           "rel_settle": ("rel_settle_kernel",)}
# the kernels each path launches, and the DP and sweep kernels' fused
# parts each path runs (kernels.TAIL_LAUNCHES: launches that ran the part)
MAIN_PATH = ("rel_dp",)
ALLDEV_PATH = ("rel_prep", "rel_dp", "rel_settle", "unrel_sweeps")
MAIN_TAILS = ("prologue", "rel_rescue", "rel_pack")
ALLDEV_TAILS = ("rel_rescue", "gate")
# the JAX function each tail replaces (device_pipeline.py: _rel_pipeline's
# rescue predicate and merge, _pack_out)
TAIL_REPLACES = {"rel_rescue": "classpro_tpu/tpu/device_pipeline.py:153",
                 "rel_pack": "classpro_tpu/tpu/device_pipeline.py:638",
                 "gate": "classpro_tpu/tpu/device_pipeline.py:698"}
# the C argument lists of a tree before the prologue (its glue library
# holds rel_prep_main_kernel): its DP kernel's (rel_dp.cu RD_ARGS_DECL
# without the blobs) and its rel_prep's (glue.cu GP_ARGS_DECL with
# lf_bcnt among the outputs and the layout flag last)
_P_, _I_, _D_, _L_ = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                      ctypes.c_longlong)
PRE_PROLOGUE_ARGTYPES = {
    "rel_dp": [_P_] * 22 + [_I_, _I_, _P_, _P_, _I_, _D_, _L_] + [_D_] * 4,
    "rel_prep": ([_P_] * 4 + [_D_] + [_I_] * 4 + [_D_] * 2 + [_P_] * 18
                 + [_I_])}
# the sweep kernel's C argument list in a tree before its gate tail
# (unrel.cu UR_ARGS_DECL without the gate)
PRE_GATE_ARGTYPES = ([_P_] * 12 + [_I_, _I_, _P_, _P_, _I_, _P_, _I_]
                     + [_D_] * 5 + [_L_] * 3)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def _reset_launches() -> None:
    """Every kernel's launch count, the DP and sweep kernels' tail counts
    and both kinds of chunk graph's captures and replays to 0."""
    from classpro_tpu_torch import alldev, kernels, rel

    for counts in (kernels.LAUNCHES, kernels.TAIL_LAUNCHES,
                   rel.GRAPH_COUNTS, alldev.GRAPH_COUNTS):
        for k in counts:
            counts[k] = 0


def _path_launches(path: str, kernels_of, tails_of, graphs: str) -> dict:
    """The launch counts since the last _reset_launches, with the tail
    counts under "tails", the main chunk graphs' under "graphs" and the
    all-device chunk graphs' under "batch_graphs"; fails unless each
    kernel of ``kernels_of`` and each tail of ``tails_of`` ran at least
    once and graphs of the kind ``graphs`` names replayed ("graphs" or
    "batch_graphs"; the other kind none)."""
    from classpro_tpu_torch import alldev, kernels, rel

    launches = dict(kernels.LAUNCHES, tails=dict(kernels.TAIL_LAUNCHES),
                    graphs=dict(rel.GRAPH_COUNTS),
                    batch_graphs=dict(alldev.GRAPH_COUNTS))
    for k in kernels_of:
        if launches[k] <= 0:
            fail(f"{path} launched kernel {k} no time")
    for k in tails_of:
        if launches["tails"][k] <= 0:
            fail(f"{path} ran the {k} tail no time")
    for kind in ("graphs", "batch_graphs"):
        if (launches[kind]["replays"] > 0) != (kind == graphs):
            fail(f"{path} replayed {launches[kind]['replays']} {kind}")
    return launches


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def golden_classes(fx: str) -> list[str]:
    with gzip.open(os.path.join(FIX, fx, "golden.class.gz"), "rt") as f:
        return f.read().split("\n")[3::4]


# --------------------------------------------------------------------- 2
def phase_build():
    from classpro_tpu_torch import kernels, native

    t0 = time.time()
    jobs = {"host": lambda: native.get_lib(force=True)}
    libs: dict = {}                  # source -> the first kernel built of it
    for name, (src, _) in kernels.SOURCES.items():
        libs.setdefault(src, name)
    for name in libs.values():
        jobs[name] = (lambda n=name: kernels.build("cuda", n, force=True))
    secs: dict = {}
    errs: dict = {}

    def run(key):
        try:
            jobs[key]()
            secs[key] = time.time() - t0
        except BaseException as e:    # re-raised on the main thread
            errs[key] = e

    threads = [threading.Thread(target=run, args=(k,)) for k in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for e in errs.values():
        raise e
    for src, name in libs.items():
        for line in kernels.BUILD_LOG[(name, "cuda")].splitlines():
            if "ptxas" in line or "bytes stack frame" in line:
                say(f"  {line.strip()}")
        say(f"build: nvcc {src} {secs[name]:.1f} s")
    say(f"build: g++ host library {secs['host']:.1f} s (all {len(jobs)} at "
        f"once)")
    out = {}
    for name, entries in ENTRIES.items():
        for entry in entries:
            res = ptxas_resources(kernels.BUILD_LOG[(name, "cuda")], entry)
            say(f"build: {entry} {json.dumps(res)}")
            if res["stack_bytes"] or res["spill_store_bytes"] \
                    or res["spill_load_bytes"]:
                fail(f"{entry} keeps a stack or spills: {res}")
            out[entry] = res
    return out


def ptxas_resources(log: str, kernel: str) -> dict:
    """Registers, static shared bytes (0 where ptxas prints none), stack
    bytes and spill bytes of entry function ``kernel`` from nvcc's
    -Xptxas -v output."""
    import re

    res: dict = {"smem_bytes": 0}
    inside = False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
            continue
        if not inside:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            res.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                       spill_load_bytes=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            res["registers"] = int(m[1])
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            res["smem_bytes"] = int(m[1])
    if set(res) != {"stack_bytes", "spill_store_bytes", "spill_load_bytes",
                    "registers", "smem_bytes"}:
        fail(f"no -Xptxas -v resources for {kernel} in the build log")
    return res


# --------------------------------------------------------------------- 3
def _global_model(fx: str):
    """A fixture's GlobalModel (its args.json applied)."""
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram

    d = os.path.join(FIX, fx)
    args = {}
    if os.path.exists(os.path.join(d, "args.json")):
        with open(os.path.join(d, "args.json")) as f:
            args = json.load(f)
    return build_global_model(load_histogram(os.path.join(d, "reads")),
                              **args)


def _model(fx: str):
    from classpro_tpu_torch.io.fastk import open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx

    d = os.path.join(FIX, fx)
    gm = _global_model(fx)
    P = open_profiles(os.path.join(d, "reads"))
    reads = list(read_fastx(os.path.join(d, "reads.fasta.gz")))
    profs = [P.fetch(i) for i in range(len(reads))]
    return gm, [r.seq for r in reads], profs


def _packs(eng, seqs, profs, B=200):
    out = []
    for lo in range(0, len(seqs), B):
        pk = eng.stage_pack(seqs[lo:lo + B], profs[lo:lo + B])
        if pk is not None:
            out.append(pk)
    return out


def _margin_check(tag, m_k, m_r, rows):
    """Margin tolerance; returns the max |diff| of finite margins."""
    m_k, m_r = m_k[rows], m_r[rows]
    if not torch.equal(torch.isinf(m_k), torch.isinf(m_r)):
        fail(f"{tag}: inf margin pattern differs")
    if not torch.equal(m_k == 1e-30, m_r == 1e-30):
        fail(f"{tag}: 1e-30 force-flag pattern differs")
    fin = torch.isfinite(m_k) & torch.isfinite(m_r)
    err = float((m_k[fin] - m_r[fin]).abs().max()) if bool(fin.any()) \
        else 0.0
    if err > MARGIN_TOL:
        fail(f"{tag}: margin differs by {err:.3e} > {MARGIN_TOL}")
    return err


def _compare_dp(tag, planes, cov, P, active=None):
    """Kernel vs plain torch DP on the same card inputs; returns the
    largest margin difference, the rows compared and unflagged, the plain
    DP's assignments and its ms (one call, host clock around it and a
    synchronize)."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.rel_ref import rel_dp_ref

    a_k, d_k, m_k = kernels.rel_dp(*planes, cov, P, active=active)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a_r, d_r, m_r = rel_dp_ref(*planes, cov, P)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rows = (torch.ones_like(m_r, dtype=torch.bool) if active is None
            else active)
    ok = rows & (m_r >= EPS)
    bad = int(((a_k != a_r).any(1) & ok).sum())
    if bad:
        fail(f"{tag}: asgn differs on {bad} unflagged row(s)")
    err = _margin_check(tag, m_k, m_r, rows)
    dk, dr = d_k[rows], d_r[rows]
    if not torch.equal(torch.isneginf(dk), torch.isneginf(dr)):
        fail(f"{tag}: dead-state pattern of the final cell differs")
    fin = torch.isfinite(dk) & torch.isfinite(dr)
    if bool(fin.any()):
        err = max(err, float((dk[fin] - dr[fin]).abs().max()))
    return err, int(rows.sum()), int(ok.sum()), a_r, plain_ms


def _compare_rel_only(tag, fb, ib, P, R, max_m):
    """rel_only on the card (the bucket's graph replay) against rel_only
    with the plain versions; returns the rows rescued and the plain
    versions' ms (one call, host clock around it and a synchronize)."""
    from classpro_tpu_torch.rel import rel_only, unpack_out

    got = rel_only(fb, ib, P, R, max_m, impl="cuda").cpu().numpy()
    t0 = time.perf_counter()
    want = rel_only(fb, ib, P, R, max_m, impl="ref").cpu().numpy()
    plain_ms = (time.perf_counter() - t0) * 1e3
    gv, gr, gres, gm = unpack_out(got, max_m)
    wv, wr, wres, wm = unpack_out(want, max_m)
    ok = wm >= EPS
    if ((gv != wv).any(1) & ok).any():
        fail(f"{tag}: rel_only asgn differs on unflagged rows")
    if (gres != wres).any():
        fail(f"{tag}: rescue flags differ")
    near = abs(wm.astype("float64") - EPS) < MARGIN_TOL
    diff = (gr != wr) & ~near
    if diff.any():
        fail(f"{tag}: risky flags differ on rows {diff.nonzero()[0][:8]}: "
             f"kernel margins {gm[diff][:8]}, plain {wm[diff][:8]}")
    return int(wres.sum()), plain_ms


def _time_cuda(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def _bound_ms(planes, cov, P) -> dict:
    """Least time for one DP pass over these inputs: the bytes it must
    move (live plane cells and per-row inputs read once, the distinct
    40-byte Skellam-table records its live steps read once, lf_small
    once, outputs written once) against its operations (OPS_PER_STEP per
    live step).  The records are counted off the plain version run on
    the same inputs."""
    from classpro_tpu_torch.rel_ref import rel_dp_ref

    gathers: list = []
    rel_dp_ref(*planes, cov, P, gathers=gathers)
    records = int(torch.unique(torch.cat(gathers)).numel()) if gathers \
        else 0
    m = planes[7]
    R2, max_m = planes[0].shape
    cells = int(m.sum())
    steps = int((m - 1).clamp(min=0).sum())
    nbytes = (cells * (5 * 8 + 2 * 8) + R2 * (8 + 8 + 1 + 32)
              + records * 40 + P.lf_small.numel() * 8
              + R2 * max_m + R2 * (32 + 8))
    t_b = nbytes / PEAK_BYTES * 1e3
    t_o = steps * OPS_PER_STEP / PEAK_F64 * 1e3
    return {"ms": max(t_b, t_o),
            "by": "bytes" if t_b >= t_o else "operations",
            "bytes_ms": t_b, "ops_ms": t_o, "records": records,
            "steps": steps, "bytes": nbytes, "ops": steps * OPS_PER_STEP}


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _diff(got, want) -> float:
    """The largest |got - want| over the elements, as f64 (equal values,
    infinities included, and NaN against NaN count 0)."""
    g, w = got.to(torch.float64), want.to(torch.float64)
    d = torch.where((g == w) | (torch.isnan(g) & torch.isnan(w)), 0.0,
                    (g - w).abs())
    return float(d.max()) if d.numel() else 0.0


def _same(tag: str, what: str, got, want) -> float:
    """Bit for bit (f64 compared as their bit patterns); returns the
    largest difference (_diff), 0 when the run goes on."""
    err = _diff(got, want)
    if not torch.equal(_bits(got), _bits(want)):
        fail(f"{tag}: {what} differs from its plain version (max |diff| "
             f"{err!r})")
    return err


def _bound(nbytes: int, ops: int) -> dict:
    """The least time for ``nbytes`` moved once and ``ops`` operations."""
    t_b = nbytes / PEAK_BYTES * 1e3
    t_o = ops / PEAK_F64 * 1e3
    return {"ms": max(t_b, t_o), "by": "bytes" if t_b >= t_o
            else "operations", "bytes": nbytes, "ops": ops}


def _check_pack(tag: str, got, args) -> float:
    """The packed buffer ``got`` against pack_ref(*args), every byte; a NaN
    margin's four bytes only need to be NaN on both sides.  Returns the
    largest difference of the assignment and flag bytes and of the f32
    margins (_diff)."""
    from classpro_tpu_torch.rel import pack_ref

    want = pack_ref(*args)
    M = args[0].shape[1]
    mm = lambda t: t[:, M + 1:].contiguous().view(torch.float32)[:, 0]
    err = max(_diff(got[:, :M + 1], want[:, :M + 1]),
              _diff(mm(got), mm(want)))
    nan = torch.isnan(mm(want))
    if not torch.equal(torch.isnan(mm(got)), nan):
        fail(f"{tag}: the packed NaN margins differ from the plain version")
    bad = ((got != want).any(1) & ~nan) | (got[:, :M + 1]
                                           != want[:, :M + 1]).any(1)
    if bool(bad.any()):
        r = int(bad.nonzero()[0, 0])
        fail(f"{tag}: the pack tails differ from their plain version on "
             f"{int(bad.sum())} row(s); row {r}: margins "
             f"{float(args[2][r])!r}, {float(args[3][r])!r}, rescue "
             f"{bool(args[4][r])}: {got[r, M:].tolist()} against "
             f"{want[r, M:].tolist()}")
    return err


def _counts() -> dict:
    """The kernels' launch and tail counts and both kinds of chunk graph's
    captures and replays, flat (launches by kernel name, tails and graph
    counts by "tails."/"graphs."/"batch." names)."""
    from classpro_tpu_torch import alldev, kernels, rel

    out = dict(kernels.LAUNCHES)
    out.update({f"tails.{k}": n for k, n in kernels.TAIL_LAUNCHES.items()})
    out.update({f"graphs.{k}": n for k, n in rel.GRAPH_COUNTS.items()})
    out.update({f"batch.{k}": n for k, n in alldev.GRAPH_COUNTS.items()})
    return out


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


# what one replay of a main chunk's graph adds to _counts: the DP
# kernel's two launches, the first with its prologue and both tails, the
# second with its pack tail
REPLAY_COUNTS = {"rel_dp": 2, "tails.prologue": 1, "tails.rel_rescue": 1,
                 "tails.rel_pack": 2, "graphs.replays": 1}


def _first_main(tag, fb_d, ib_d, P, R: int, max_m: int) -> dict:
    """The main path's two launches on one pack, as its graph replays them
    (rel_dp_first, then rel_dp_pack), each held against its plain version
    on the kernel chain's own inputs, bit for bit: the planes and
    coverages the prologue wrote against rel.prep_ref, the first pass
    against rel_dp's on those planes (no prologue, no tails), its rescue
    and cov2 against rel.rescue_rows on its assignments, the rescue pass
    against rel_dp's on the rows it runs, the packed buffer against
    rel.pack_ref of the two passes.  Returns the outputs and, under
    "err", each part's largest difference."""
    from classpro_tpu_torch import kernels, rel

    planes, cov, a1, d1, m1, rescue, cov2, packed = kernels.rel_dp_first(
        fb_d, ib_d, P, R, max_m)
    p_r, c_r = rel.prep_ref(fb_d, ib_d, P, R, max_m)
    err = {"prologue": max(_same(tag, f"the prologue's output {k}", a, b)
                           for k, (a, b) in enumerate(
                               zip(planes + (cov,), p_r + (c_r,))))}
    b1, e1, n1 = kernels.rel_dp(*planes, cov, P)
    for what, a, b in (("assignments", a1, b1), ("final cells", d1, e1),
                       ("margins", m1, n1)):
        _same(tag, f"the first pass's {what} with its prologue and tails "
              f"against rel_dp's", a, b)
    r_r, c2_r = rel.rescue_rows(planes, a1, P, max_m)
    err["rel_rescue"] = max(_same(tag, "the rescue tail's rescue", rescue,
                                  r_r),
                            _same(tag, "the rescue tail's cov2", cov2, c2_r))
    a2, d2, m2 = kernels.rel_dp_pack(*planes, cov2, P, rescue, m1, packed)
    b2, e2, n2 = kernels.rel_dp(*planes, cov2, P, active=rescue)
    for what, a, b in (("assignments", a2, b2), ("final cells", d2, e2),
                       ("margins", m2, n2)):
        _same(tag, f"the rescue pass's {what} with its tail against "
              f"rel_dp's", a[rescue], b[rescue])
    err["rel_pack"] = _check_pack(tag, packed, (a1, a2, m1, m2, rescue))
    return {"planes": planes, "cov": cov, "a1": a1, "m1": m1,
            "rescue": rescue, "cov2": cov2, "a2": a2, "m2": m2,
            "packed": packed, "rescued": int(rescue.sum()), "err": err}


def _graph_main(tag, fb_d, ib_d, P, R: int, max_m: int, t: dict):
    """The chunk's CUDA graph (a rel.ChunkGraph of its own, captured here)
    against the eager launches and the plain glue, every byte: its
    replay's packed output == ``t["packed"]`` (rel_dp_first + rel_dp_pack,
    eager) == rel.rel_glued eagerly == rel_only with the plain glue
    (rel_planes, rescue_rows, pack_out) around the DP kernel; the capture
    counts nothing but its eager run, each replay counts the two launches
    and their prologue and tails (REPLAY_COUNTS); a blob of another shape
    is refused.  Returns the graph."""
    from classpro_tpu_torch import kernels, rel

    c0 = _counts()
    g = rel.ChunkGraph(P, R, max_m)
    c1 = _counts()
    got = g.run(fb_d, ib_d).clone()
    c2 = _counts()
    eager = rel.rel_glued(fb_d, ib_d, P, R, max_m, kernels)
    plain = rel.rel_only(fb_d, ib_d, P, R, max_m, impl=kernels.rel_dp)
    torch.cuda.synchronize()
    want_cap = {"rel_dp": 2, "tails.prologue": 1, "tails.rel_rescue": 1,
                "tails.rel_pack": 2, "graphs.captures": 1}
    if _delta(c0, c1) != want_cap or _delta(c1, c2) != REPLAY_COUNTS:
        fail(f"{tag}: the graph's capture counted {_delta(c0, c1)} "
             f"(want {want_cap}, its eager run), its replay "
             f"{_delta(c1, c2)} (want {REPLAY_COUNTS})")
    for what, other in (("the eager launches' packed buffer", t["packed"]),
                        ("rel_glued's, eagerly", eager),
                        ("the plain glue's around the DP kernel", plain)):
        if not torch.equal(got, other):
            bad = int((got != other).any(1).sum())
            fail(f"{tag}: the graph replay's packed output differs from "
                 f"{what} on {bad} row(s)")
    try:
        g.run(fb_d[:-1], ib_d)
    except ValueError:
        pass
    else:
        fail(f"{tag}: the chunk graph took a blob of another shape")
    return g


def _one_state_chunk(R: int, max_m: int = 4):
    """A main-layout chunk (fblob, iblob on the card) whose every row the
    DP leaves with one live state, so an infinite margin: one interval a
    read (m = 1) of counts 30000 (H and D dead, R alive), no error
    evidence."""
    b = torch.zeros((R, max_m), dtype=torch.int32)
    b[:, 0] = 1 + 7 * torch.arange(R, dtype=torch.int32)
    e = b + 20
    cc = torch.full((R, max_m), 30000, dtype=torch.int32)
    ib = torch.cat([b.ravel(), e.ravel(), cc.ravel(), cc.ravel(),
                    torch.ones(R, dtype=torch.int32),
                    torch.full((R,), 1000, dtype=torch.int32)])
    fb = torch.full((R * max_m,), -float("inf"), dtype=torch.float64)
    return fb.cuda(), ib.cuda()


def _check_pack_specials() -> float:
    """The pack tail on margins at the f32 conversion's edges (inf, -inf,
    NaN, 0, -0, the smallest double, 1e-300, 1e-30, 1e-5 and the double
    below it, 3.5e38): (a) its merge and conversion (rel_tail.cuh
    row_tail_byte, through kernels.rel_tail_probe on the card) on every
    pair of them, as the first pass writes a row it keeps and as the
    rescue pass writes a rescued row; (b) the rescue pass's DP launch
    with its pack tail (rel_dp_pack) on first-pass margins at the edges,
    every row rescued, on a chunk whose own margins are all inf
    (``_one_state_chunk``, the tiny model; its planes from rel_dp_first's
    prologue), so that each merged margin is its edge value.  Every byte
    against rel.pack_ref."""
    import math

    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.params import build_rel_params

    P = build_rel_params(_model("tiny")[0], "cuda")
    vals = [math.inf, -math.inf, math.nan, 0.0, -0.0, math.ulp(0.0),
            1e-300, 1e-30, 1e-5, math.nextafter(1e-5, 0.0), 3.5e38, 0.25]
    p1 = torch.tensor([a for a in vals for _ in vals], dtype=torch.float64,
                      device="cuda")
    p2 = torch.tensor([b for _ in vals for b in vals], dtype=torch.float64,
                      device="cuda")
    none = torch.zeros((p1.shape[0], 0), dtype=torch.int8, device="cuda")
    err = 0.0
    for tag, got, rescued in (
            ("the first pass", kernels.rel_tail_probe(p1), False),
            ("the rescue pass", kernels.rel_tail_probe(p2, p1), True)):
        err = max(err, _check_pack(
            f"margin edge pairs, {tag}", got,
            (none, none, p1, p2, torch.full_like(p1, rescued,
                                                 dtype=torch.bool))))
    R, M = len(vals), 4
    fb, ib = _one_state_chunk(R, M)
    planes, cov = kernels.rel_dp_first(fb, ib, P, R, M)[:2]
    every = torch.ones(2 * R, dtype=torch.bool, device="cuda")
    mm1 = torch.tensor(vals + vals, dtype=torch.float64, device="cuda")
    packed = torch.zeros((2 * R, M + 5), dtype=torch.uint8, device="cuda")
    a2, _, m2 = kernels.rel_dp_pack(*planes, cov, P, every, mm1, packed)
    if not bool(torch.isinf(m2).all()):
        fail("the one-state chunk's rescue pass left a finite margin")
    return max(err, _check_pack("margin edge cases", packed,
                                (a2, a2, mm1, m2, every)))


def _main_bounds(fb, ib, t, P, k1) -> dict:
    """Bounds on one pack (each input read once, each output written once,
    against the operations per cell of OPS_*).  The prologue alone, as
    the glue kernel it was (rel_prep's main layout: the blobs, the
    log-factorial entries its counts select, gcov; every plane cell and
    the row outputs written).  The tails alone, as the glue kernels they
    were (rel_rescue reads the first pass's assignments at the live cells
    and the four int64 planes at its D cells only; rel_pack the two
    passes).  The fused first pass (rel_dp_first): the prologue's bytes,
    plus the DP pass (``k1``, _bound_ms) without its reads of the planes
    and row inputs (the launch wrote them: re-reads of its own bytes),
    plus what its tails write (rescue, cov2, the packed rows of the rows
    it keeps).  The fused rescue pass: the DP on the rescued rows, its
    active flags and those rows' first-pass margins read, their packed
    rows written."""
    planes = t["planes"]
    R2, M = planes[0].shape
    cells = R2 * M
    inb = torch.arange(M, device=planes[0].device)[None, :] \
        < planes[7][:, None]
    live = int(inb.sum())
    n_d = int(((t["a1"] == 3) & inb).sum())
    counts = torch.cat([planes[1], planes[3]]).clamp(0, 32767)
    lf = int(torch.unique(counts).numel())
    res = t["rescue"]
    n_res = int(res.sum())
    k1r = (_bound_ms(tuple(x[res] for x in planes), t["cov2"][res], P)
           if n_res else {"bytes": 0, "ops": 0})
    prologue_b = (fb.nbytes + ib.nbytes + lf * 8 + 32 + cells * 7 * 8
                  + R2 * (8 + 8 + 1 + 32))
    prologue_o = cells * OPS_PREP_CELL
    k1_in = int(planes[7].sum()) * (5 * 8 + 2 * 8) + R2 * (8 + 8 + 1 + 32)
    rescue_out = 32 + R2 * (1 + 32)         # gcov; rescue, cov2 written
    rescue_b = live + n_d * 4 * 8 + R2 * 8 + rescue_out
    rescue_o = live * OPS_RESCUE_TEST + n_d * OPS_RESCUE_CELL
    row_b = M + 8 + 8 + 1 + (M + 5)         # a packed row, read and written
    pack_o = (R2 - n_res) * M * OPS_PACK_CELL
    return {
        "prologue": _bound(prologue_b, prologue_o),
        "rel_rescue": _bound(rescue_b, rescue_o),
        "rel_pack": _bound(R2 * row_b, cells * OPS_PACK_CELL),
        "first": _bound(
            prologue_b + k1["bytes"] - k1_in + rescue_out
            + (R2 - n_res) * (M + 5),
            prologue_o + k1["ops"] + rescue_o + pack_o),
        "fused_rel_pack": _bound(
            k1r["bytes"] + R2 + n_res * (8 + M + 5),
            k1r["ops"] + n_res * M * OPS_PACK_CELL)}


def _graph_ms(fn, reps: int) -> float:
    """ms per call of ``fn`` (launches only) on the card: ``reps`` calls
    captured in one CUDA graph, CUDA events around its replays (the card
    runs the launches back to back; a run of eager calls would time the
    wrappers' Python, which takes longer than these kernels)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    ms = _time_cuda(g.replay, 5) / reps
    del g
    return ms


def _time_glue(rec: dict, name: str, args, plain, bnd: dict) -> None:
    """A glue kernel's ms per launch on the card (``_graph_ms``, 20
    launches), its wrapper's ms per call (CUDA events around 20 eager
    calls: what the host pays) and its plain version's ms per call (CUDA
    events, 5 calls), with its bound, appended to rec[name]."""
    from classpro_tpu_torch import kernels

    wrapper = getattr(kernels, name)
    r = rec.setdefault(name, {"ms": [], "call_ms": [], "plain_ms": [],
                              "bound": []})
    r["ms"].append(_graph_ms(lambda: wrapper(*args), 20))
    r["call_ms"].append(_time_cuda(lambda: wrapper(*args), 20))
    r["plain_ms"].append(_time_cuda(lambda: plain(*args), 5))
    r["bound"].append(bnd)


def _parent_pairs(par: dict, fb_d, ib_d, P, R: int, M: int, t: dict,
                  tag: str) -> dict:
    """The parent tree's main-path launches on one pack, into buffers of
    their own: from a tree before the prologue its rel_prep (main layout)
    and its DP first pass with both tails, from a later tree its DP
    first pass with its prologue and tails; then its rescue pass with its
    pack tail (on this tree's rescue rows and cov2).  Their planes,
    passes, rescue, cov2 and packed buffer held against this tree's
    (``t``) bit for bit.  Returns the two as callables (ctypes launches
    on the current stream)."""
    from classpro_tpu_torch import kernels

    R2 = 2 * R
    dev = fb_d.device
    keep = []
    ptr = lambda x: x.data_ptr() if x is not None else None

    def new(shape, dt):
        x = torch.empty(shape, dtype=dt, device=dev)
        keep.append(x)
        return x

    planes = tuple(new((R2, M), torch.int64) for _ in range(5)) + (
        new((R2, M), torch.float64), new((R2, M), torch.float64),
        new((R2,), torch.int64), new((R2,), torch.int64),
        new((R2,), torch.bool))
    cov = new((R2, 4), torch.int64)

    def dp_args(c, active, tail, blobs):
        outs = (new((R2, M), torch.int8), new((R2, 4), torch.float64),
                new((R2,), torch.float64),
                new((R2, max(M - 1, 1), 4), torch.int8),
                new((R2, M), torch.uint8))
        args = ([x.data_ptr() for x in planes] + [c.data_ptr(), ptr(active)]
                + [x.data_ptr() for x in outs] + [ptr(x) for x in tail])
        if par["prologue"]:
            args += ([ptr(ib_d), ptr(fb_d), ptr(P.logfact)] if blobs
                     else [None] * 3) + [float(P.e_po_base)]
        return args + [R2, M, P.tab.data_ptr(), P.lf_small.data_ptr(),
                       int(P.lf_small.shape[0]), float(P.read_len),
                       int(P.offset), float(P.r_logp),
                       float(P.log_1m_pe_mean), float(P.log_pe_mean),
                       float(P.dr_ratio)], outs

    res, cov2 = new((R2,), torch.bool), new((R2, 4), torch.int64)
    out = new((R2, M + 5), torch.uint8)
    args1, o1 = dp_args(cov, None, (res, cov2, P.gcov, out, None), True)
    args2, o2 = dp_args(t["cov2"], t["rescue"],
                        (None, None, None, out, o1[2]), False)
    # the main layout of a rel_prep before the prologue (GP_ARGS_DECL of
    # then: lf_bcnt among the outputs, the all-device outputs null, the
    # layout flag 0)
    args_p = ([ib_d.data_ptr(), fb_d.data_ptr(), P.logfact.data_ptr(),
               P.gcov.data_ptr(), float(P.e_po_base), R, M, 0, 0,
               *kernels.GATE_UNFLAGGED]
              + [x.data_ptr() for x in planes[:5]]
              + [x.data_ptr() for x in (planes[7], planes[8], cov,
                                        planes[5], planes[6], planes[9])]
              + [None] * 7 + [0])

    def launch(name, args):
        err = par["fns"][name](*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"parent {name} launch failed: CUDA error {err}")

    def first():
        if not par["prologue"]:
            launch("rel_prep", args_p)
        launch("rel_dp", args1)

    def second():
        launch("rel_dp", args2)

    first()
    second()
    torch.cuda.synchronize()
    rows = t["rescue"]
    for k, (a, b) in enumerate(zip(planes + (cov,), t["planes"]
                                   + (t["cov"],))):
        _same(tag, f"the parent's plane {k} against the prologue's", a, b)
    for what, a, b in (("first pass's assignments", o1[0], t["a1"]),
                       ("first pass's margins", o1[2], t["m1"]),
                       ("rescue", res, t["rescue"]),
                       ("cov2", cov2, t["cov2"]),
                       ("rescue pass's assignments", o2[0][rows],
                        t["a2"][rows]),
                       ("packed buffer", out, t["packed"])):
        _same(tag, f"the parent's {what} against this tree's", a, b)
    return {"first": first, "rel_pack": second, "keep": keep,
            "what": ("K1 with its prologue and tails" if par["prologue"]
                     else "rel_prep + K1 with its tails")}


def _time_main(rec: dict, t: dict, fb_d, ib_d, P, R: int, max_m: int,
               g, bnds: dict, parent, tag: str, plain_ms: float) -> None:
    """The main path's launches on one medium pack, ms per launch on the
    card (``_graph_ms``, 20 launches): the fused first pass
    (rel_dp_first) beside this tree's DP launch with both tails but no
    prologue on the prologue's planes and the DP launch alone; the
    rescue pass with its pack tail beside the DP alone on the rescued
    rows; the rescue tail alone (rel_dp_rescue, the all-device path's
    first pass).  The chunk's graph: ms per replay (CUDA events around 20
    replays) against the two launches called eagerly (rel_glued, 20
    calls: the wrappers' Python).  The plain versions' ms per call (CUDA
    events; for the fused first pass ``plain_ms``, rel_only's plain
    versions as _compare_rel_only timed them: the prologue's, the DP's,
    the rescue predicate's and the pack's, no row rescued on medium).
    With ``parent`` its pairs (``_parent_pairs``) held against
    this tree's and timed in turns with them (parent, this tree, this
    tree, parent)."""
    from classpro_tpu_torch import kernels, rel

    planes, cov, M = t["planes"], t["cov"], max_m
    pk = t["packed"]
    both = kernels._rescue_tail(planes, P, pack=True)
    fused = {"first": lambda: kernels.rel_dp_first(fb_d, ib_d, P, R, M),
             "rel_pack": lambda: kernels.rel_dp_pack(
                 *planes, t["cov2"], P, t["rescue"], t["m1"], pk)}
    pairs = (_parent_pairs(parent, fb_d, ib_d, P, R, M, t, tag)
             if parent else None)
    for name in ("first", "rel_pack"):
        x = rec.setdefault(name, {"ms": [], "parent_ab_ms": []})
        if pairs is not None:
            ab = [_graph_ms(pairs[name], 20), _graph_ms(fused[name], 20),
                  _graph_ms(fused[name], 20), _graph_ms(pairs[name], 20)]
            x["parent_ab_ms"].append(ab)
            x["ms"].append(min(ab[1:3]))
        else:
            x["ms"].append(_graph_ms(fused[name], 20))

    times = {
        "k1_tails_ms": _graph_ms(lambda: kernels._dp_run(
            "cuda", planes, cov, P, tail=both), 20),
        "k1_ms": _graph_ms(lambda: kernels.rel_dp(*planes, cov, P), 20),
        "rescue_tail_ms": _graph_ms(lambda: kernels.rel_dp_rescue(
            *planes, cov, P), 20),
        "k1_rescue_pass_ms": _graph_ms(lambda: kernels.rel_dp(
            *planes, t["cov2"], P, active=t["rescue"]), 20),
        "replay_ms": _time_cuda(g.replay, 20),
        "eager_ms": _time_cuda(lambda: rel.rel_glued(fb_d, ib_d, P, R, M,
                                                     kernels), 20),
        "plain_ms": plain_ms,
        "pack_plain_ms": _time_cuda(lambda: rel.pack_ref(
            t["a1"], t["a2"], t["m1"], t["m2"], t["rescue"]), 5),
        "prologue_plain_ms": _time_cuda(lambda: rel.prep_ref(
            fb_d, ib_d, P, R, M), 5)}
    r = rec["first"]
    for k, v in times.items():
        r.setdefault(k, []).append(v)
    for k in ("first", "prologue", "rel_rescue", "rel_pack",
              "fused_rel_pack"):
        r.setdefault("bounds", {}).setdefault(k, []).append(bnds[k])
    first_ms, pack_ms = rec["first"]["ms"][-1], rec["rel_pack"]["ms"][-1]
    say(f"  fused first pass (prologue, K1, both tails): {first_ms:.4f} ms "
        f"per launch on the card; K1 with both tails, no prologue "
        f"{times['k1_tails_ms']:.4f} (the prologue "
        f"{(first_ms - times['k1_tails_ms']) * 1e3:.2f} us), K1 alone "
        f"{times['k1_ms']:.4f}, K1 with the rescue tail alone "
        f"{times['rescue_tail_ms']:.4f}; "
        + (f"the parent's {pairs['what']}: "
           f"{rec['first']['parent_ab_ms'][-1][0]:.4f}, "
           f"{rec['first']['parent_ab_ms'][-1][3]:.4f} ms, this tree "
           f"{rec['first']['parent_ab_ms'][-1][1]:.4f}, "
           f"{rec['first']['parent_ab_ms'][-1][2]:.4f} (in turns); "
           if pairs is not None else "")
        + f"plain {times['plain_ms']:.1f} ms (prologue's "
        f"{times['prologue_plain_ms']:.3f}); bound "
        f"{bnds['first']['ms']:.6f} ms ({bnds['first']['by']}, "
        f"{bnds['first']['bytes']} B; the prologue alone "
        f"{bnds['prologue']['ms']:.6f} ms, {bnds['prologue']['bytes']} B)")
    say(f"  rescue pass with its pack tail: {pack_ms:.4f} ms per launch, "
        f"K1 alone {times['k1_rescue_pass_ms']:.4f}; "
        + (f"the parent's {rec['rel_pack']['parent_ab_ms'][-1][0]:.4f}, "
           f"{rec['rel_pack']['parent_ab_ms'][-1][3]:.4f} ms, this tree "
           f"{rec['rel_pack']['parent_ab_ms'][-1][1]:.4f}, "
           f"{rec['rel_pack']['parent_ab_ms'][-1][2]:.4f} (in turns); "
           if pairs is not None else "")
        + f"plain pack {times['pack_plain_ms']:.3f} ms; bound "
        f"{bnds['fused_rel_pack']['ms']:.6f} ms")
    say(f"  the chunk's graph: {times['replay_ms']:.4f} ms per replay "
        f"(two launches), {times['eager_ms']:.4f} ms per eager call of "
        f"the two wrappers")


# the JAX function each kernel or fused part replaces (device_pipeline.py:
# _rel_only_core for the prologue, _unpack for the all-device rel_prep,
# _demotes_dev for rel_settle)
GLUE_REPLACES = {"rel_prep": "classpro_tpu/tpu/device_pipeline.py:119",
                 "rel_settle": "classpro_tpu/tpu/device_pipeline.py:257",
                 "rel_dp_first": "classpro_tpu/tpu/device_pipeline.py:541"}


def _glue_entry(name: str, g: dict, launches: int, err: float,
                brec) -> dict:
    """A glue kernel's entry of the {"kernels": [...]} line: its medium
    chunk timed last, its launches on its path, the largest difference
    from its plain version over the packs it was held against, its build
    resources (each entry function's, the first flattened) and launch
    geometry."""
    res = {e: (brec or {}).get(e, {}) for e in ENTRIES[name]}
    return {"name": name, "route": "cuda",
            "source": "classpro_tpu_torch/csrc/glue.cu",
            "replaces": GLUE_REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": g["ms"][-1],
            "plain_ms": g["plain_ms"][-1], "bound_ms": g["bound"][-1]["ms"],
            "bound_by": g["bound"][-1]["by"], "library_ms": None,
            "ms_per_chunk": g["ms"], "call_ms": g["call_ms"][-1],
            "bound_bytes": g["bound"][-1]["bytes"],
            **res[ENTRIES[name][0]], "resources": res, **g["geometry"]}


def _gate_entry(arec: dict, launches: int, Bn: int) -> dict:
    """The sweep kernel's gate tail for its entry of the {"kernels": [...]}
    line: the JAX code it replaces, the launches that ran it on the
    all-device path, its largest difference from its plain version (every
    byte was checked equal), the medium chunk timed last with and without
    the tail (in turns, CUDA graphs of 20 launches) and every chunk's, the
    long-row chunk's, with --parent the parent's sweep kernel in turns,
    and the tail's own bound (each read's gate read, its flag byte
    written)."""
    g, lr = arec["gate"], arec["long_row"]["gate"]
    ab = g["tail_ab"][-1]
    return {"replaces": TAIL_REPLACES["gate"], "launches": launches,
            "max_abs_err": 0.0, "ms": (ab[1] + ab[2]) / 2,
            "k5_ms": (ab[0] + ab[3]) / 2, "ab_ms": g["tail_ab"],
            "long_row_ab_ms": lr["tail_ab"],
            "parent_ab_ms": g.get("parent_ab"),
            "tail_bound_ms": _bound(Bn * (16 + 1), 2 * Bn)["ms"]}


def _first_entry(krec: dict, launches: dict, brec) -> dict:
    """The fused first pass's entry of the {"kernels": [...]} line (the
    DP kernel's rel_dp_first_kernel: the prologue that replaced rel_prep's
    main layout, K1, both tails): the medium chunk timed last, its
    launches on the main path (the DP launches that ran the prologue), the
    largest difference of its prologue and tails from their plain
    versions, the time without the prologue, per replay of the chunk's
    graph and per eager call, the bounds, and with --parent the parent's
    pair and this tree's launch in turns."""
    m = krec["main"]
    f, b = m["first"], m["first"]["bounds"]
    err = max(krec["tail_err"][k] for k in ("prologue", "rel_rescue",
                                             "rel_pack"))
    return {"name": "rel_dp_first", "route": "cuda",
            "source": "classpro_tpu_torch/csrc/rel_dp.cu",
            "replaces": GLUE_REPLACES["rel_dp_first"],
            "launches": launches["tails"]["prologue"], "max_abs_err": err,
            "ms": f["ms"][-1], "plain_ms": f["plain_ms"][-1],
            "bound_ms": b["first"][-1]["ms"],
            "bound_by": b["first"][-1]["by"], "library_ms": None,
            "bound_bytes": b["first"][-1]["bytes"],
            "ms_per_chunk": f["ms"], "k1_tails_ms": f["k1_tails_ms"][-1],
            "prologue_us": (f["ms"][-1] - f["k1_tails_ms"][-1]) * 1e3,
            "prologue_bound_ms": b["prologue"][-1]["ms"],
            "prologue_plain_ms": f["prologue_plain_ms"][-1],
            "replay_ms": f["replay_ms"], "eager_ms": f["eager_ms"],
            "parent_ab_ms": f["parent_ab_ms"],
            **(brec or {}).get("rel_dp_first_kernel", {}),
            **krec["geometry"]}


def _tails_entry(krec: dict, tails: dict) -> dict:
    """The DP kernel's tails for its entry of the {"kernels": [...]} line:
    per tail, the glue kernel it replaces and that one's JAX function, the
    launches that ran it on the main path, its largest difference from
    its plain version; the rescue tail's launch (rel_dp_rescue, the
    all-device path's first pass) beside K1's without it, the pack tail's
    (the rescue pass) beside K1's rescue pass without it and with
    --parent the parent's rescue pass in turns; the plain versions' ms,
    the fused launches' bounds and the tails' own."""
    f = krec["main"]["first"]
    p = krec["main"]["rel_pack"]
    b = f["bounds"]
    return {
        "rel_rescue": {
            "replaces": TAIL_REPLACES["rel_rescue"],
            "launches": tails["rel_rescue"],
            "max_abs_err": krec["tail_err"]["rel_rescue"],
            "ms": f["rescue_tail_ms"][-1], "k1_ms": f["k1_ms"][-1],
            "tail_bound_ms": b["rel_rescue"][-1]["ms"]},
        "rel_pack": {
            "replaces": TAIL_REPLACES["rel_pack"],
            "launches": tails["rel_pack"],
            "max_abs_err": krec["tail_err"]["rel_pack"],
            "ms": p["ms"][-1], "k1_ms": f["k1_rescue_pass_ms"][-1],
            "plain_ms": f["pack_plain_ms"][-1],
            "bound_ms": b["fused_rel_pack"][-1]["ms"],
            "bound_by": b["fused_rel_pack"][-1]["by"],
            "tail_bound_ms": b["rel_pack"][-1]["ms"],
            "ms_per_chunk": p["ms"], "parent_ab_ms": p["parent_ab_ms"]}}


def phase_kernel(parent=None):
    """K1 against its plain version on every pack of medium, search9 and
    psum0 (both passes); the main path's two launches (the fused first
    pass: prologue, K1 and both tails; the rescue pass with its pack
    tail) against their plain versions, bit for bit; the chunk's CUDA
    graph against those eager launches and the plain glue, every byte;
    rel_only with the kernels against the plain versions; times at the
    medium shapes.  ``parent``: the parent tree's launch entries
    (``_parent_kernels``), whose main-path launches are held against this
    tree's and timed in turns with them."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.rel import rel_planes, rescue_rows

    dev = torch.device("cuda")
    rec = {"max_abs_err": 0.0, "ms": [], "plain_ms": [], "bound": [],
           "main": {}, "tail_err": {"rel_pack": _check_pack_specials()}}
    say("kernel == plain: the pack tail's merge on every pair of margin "
        "edge cases and the rescue pass's pack tail on them, every byte")
    for fx in ("medium", "branch/search9", "branch/psum0"):
        gm, seqs, profs = _model(fx)
        eng = TorchEngine(gm, device=dev)
        packs = _packs(eng, seqs, profs)
        for k, (fb, ib, R, max_m) in enumerate(packs):
            tag = f"{fx} chunk {k} (R2={2 * R}, max_m={max_m})"
            fb_d = torch.from_numpy(fb).to(dev)
            ib_d = torch.from_numpy(ib).to(dev)
            P = eng.P
            planes = rel_planes(fb_d, ib_d, P, R, max_m)
            cov = P.gcov[None, :].expand(2 * R, 4).contiguous()
            err, n, n_ok, a_r, plain = _compare_dp(tag, planes, cov, P)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            # the rescue pass: the rows the plain first pass rescues,
            # with their coverages, through the active mask
            rescue, cov2 = rescue_rows(planes, a_r, P, max_m)
            if bool(rescue.any()):
                err2 = _compare_dp(tag + " rescue pass", planes, cov2, P,
                                   active=rescue)[0]
                rec["max_abs_err"] = max(rec["max_abs_err"], err2)
            n_res2, stage_plain = _compare_rel_only(tag, fb_d, ib_d, P, R,
                                                    max_m)
            t = _first_main(tag, fb_d, ib_d, P, R, max_m)
            g = _graph_main(tag, fb_d, ib_d, P, R, max_m, t)
            for name, e in t["err"].items():
                rec["tail_err"][name] = max(rec["tail_err"].get(name, 0.0),
                                            e)
            say(f"kernel == plain: {tag}: {n} rows ({n_ok} unflagged), "
                f"{n_res2} rescued, max |err| {rec['max_abs_err']:.3e}; the "
                f"first pass's prologue, K1's rescue tail ({t['rescued']} "
                f"rescued) and pack tails bit-equal; the graph replay == "
                f"the eager launches == the plain glue, every byte")
            if fx == "medium":
                bnd = _bound_ms(planes, cov, P)
                bnds = _main_bounds(fb, ib, t, P, bnd)
                _time_main(rec["main"], t, fb_d, ib_d, P, R, max_m, g, bnds,
                           parent, tag, stage_plain)
                ms = _time_cuda(lambda: kernels.rel_dp(*planes, cov, P), 20)
                rec["ms"].append(ms)
                rec["plain_ms"].append(plain)
                rec["bound"].append(bnd)
                longest = int(planes[7].max())
                rec["us_per_step"] = ms * 1e3 / max(longest - 1, 1)
                rec["geometry"] = kernels.rel_dp_geometry(2 * R, max_m)
                say(f"  launch geometry {json.dumps(rec['geometry'])}")
                say(f"  time per launch: kernel {ms:.3f} ms "
                    f"({ms * 1e3 / max(longest - 1, 1):.2f} us per step of "
                    f"the longest row, m={longest}), plain torch "
                    f"{plain:.1f} ms, bound {bnd['ms']:.6f} ms "
                    f"({bnd['by']}; bytes {bnd['bytes_ms']:.6f} ms with "
                    f"{bnd['records']} distinct table records, operations "
                    f"{bnd['ops_ms']:.6f} ms for {bnd['steps']} steps)")
            del g
        if fx == "branch/search9" and not n_res2:
            fail("branch/search9 pack rescued no row")
    return rec


# --------------------------------------------------------- 3b (opt-in)
K1_PARTS = ("A", "exchange1", "B1", "exchange2", "B2", "exchange3", "C")
K5_PARTS = ("S", "exchangeA", "I", "exchangeB", "K", "exchangesCD_H", "D")


def _clock_profile(name: str, entry: str, parts, cases,
                   timer=_time_cuda) -> dict:
    """A kernel's per-phase clocks (opt-in: --phases k1profile,
    k5profile, settleprofile).  Builds kernel ``name`` once more with -DRD_PHASE_CLOCKS;
    on each case (tag, C arguments, the tensors the launch writes, the
    production kernel's outputs) holds that build's outputs to the
    production kernel's bit for bit, times the two in turns (``timer``
    over 20 ctypes launches without the wrapper: CUDA events around eager
    launches by default) and reads the clock sums (cycles per step of the
    warp's loop, lane 0 of each row; per read pair, thread 0 of its
    block, for rel_settle)."""
    from classpro_tpu_torch import kernels

    lib = ctypes.CDLL(kernels.build("cuda", name, True, clocks=True))
    res = ptxas_resources(kernels.BUILD_LOG[(name, "cuda_clocks")], entry)
    stem = kernels._ENTRY[(name, "cuda")].rsplit("_", 1)[0]
    fns = {"plain": kernels._fn(name, "cuda"),
           "clocks": getattr(lib, f"{stem}_launch")}
    fns["clocks"].restype = ctypes.c_int
    fns["clocks"].argtypes = kernels._ARGTYPES[name] + [ctypes.c_void_p]
    clocks = getattr(lib, f"{stem}_phase_clocks")
    clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    stream = torch.cuda.current_stream().cuda_stream
    rec: dict = {"clocks_build": res, "ms": {"plain": [], "clocks": []},
                 "cycles_per_step": []}
    bits = lambda t: t.view(torch.int64) if t.dtype == torch.float64 else t
    for tag, args, outs, want in cases:
        out = (ctypes.c_ulonglong * (len(parts) + 1))()
        clocks(None, 1)
        if fns["clocks"](*args, stream) != 0:
            fail(f"{name} profile: the clocked build did not launch")
        torch.cuda.synchronize()
        clocks(ctypes.cast(out, ctypes.c_void_p), 0)
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(outs, want)):
            fail(f"{name} profile: the clocked build differs from the "
                 f"production kernel on {tag}")
        n = max(out[len(parts)], 1)
        rec["cycles_per_step"].append(
            {p: out[j] / n for j, p in enumerate(parts)})
        for v in ("plain", "clocks", "clocks", "plain"):
            rec["ms"][v].append(timer(
                lambda: fns[v](*args, torch.cuda.current_stream()
                               .cuda_stream), 20))
        say(f"{name} profile: {tag}: production "
            f"{rec['ms']['plain'][-2]:.4f}, {rec['ms']['plain'][-1]:.4f} ms; "
            f"clocked {rec['ms']['clocks'][-2]:.4f}, "
            f"{rec['ms']['clocks'][-1]:.4f} ms; cycles per step: "
            + json.dumps({p: round(c, 1) for p, c in
                          rec["cycles_per_step"][-1].items()}))
    return rec


def phase_k1profile() -> dict:
    """K1's per-phase clocks at the medium shapes."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.rel import rel_planes

    dev = torch.device("cuda")
    gm, seqs, profs = _model("medium")
    eng = TorchEngine(gm, device=dev)
    P = eng.P
    cases, alive = [], []
    for k, (fb, ib, R, max_m) in enumerate(_packs(eng, seqs, profs)):
        planes = rel_planes(torch.from_numpy(fb).to(dev),
                            torch.from_numpy(ib).to(dev), P, R, max_m)
        cov = P.gcov[None, :].expand(2 * R, 4).contiguous()
        want = [t.clone() for t in kernels.rel_dp(*planes, cov, P)]
        args, keep = kernels._args(planes, cov, P, None, 2 * R, max_m)
        cases.append((f"medium chunk {k}", args, keep[:3], want))
        alive.append((planes, cov, keep))   # the launches read them
    return _clock_profile("rel_dp", "rel_dp_kernel", K1_PARTS, cases)


def phase_k5profile() -> dict:
    """K5's per-phase clocks at the medium alldev shapes and on the
    long-row chunk."""
    from classpro_tpu_torch import kernels

    chunks = list(_alldev_chunks())
    PP = chunks[0]["PP"]
    cases = [(f"medium alldev chunk {k}", c["args"])
             for k, c in enumerate(chunks)]
    cases.append(("long-row chunk", _long_row_chunk(chunks[0]["gm"])))
    out, scratch = [], []
    for tag, a in cases:
        want = [t.clone() for t in kernels.unrel_sweeps(*a, PP.unrel)]
        args, o, mm, sc = kernels._unrel_args(tuple(a[:8]), a[8], PP.unrel,
                                              a[1].device, "cuda")
        out.append((tag, args, (o, mm), want))
        scratch.append(sc)          # the launches use it
    return _clock_profile("unrel_sweeps", "unrel_kernel", K5_PARTS, out)


SETTLE_PARTS = ("rows_load", "reduce1", "decide", "scan", "reduce2", "hdrr",
                "scatter")


def phase_settleprofile() -> dict:
    """rel_settle's cycles by part (thread 0 of each read pair's block) on
    the medium alldev chunks, the clocked build against the production
    kernel bit for bit, both timed in turns in CUDA graphs."""
    from classpro_tpu_torch import kernels

    cases, alive = [], []
    for k, c in enumerate(_alldev_chunks()):
        tag = f"medium alldev chunk {k}"
        g = _glue_alldev(tag, c["fb_d"], c["ib_d"], c["PP"].rel, c["dims"])
        outs = tuple(t.clone() for t in g["fresh"])
        alive.append(g)                  # the launches read its tensors
        cases.append((tag, kernels._settle_args(*g["rel_settle"][:-2],
                                                *outs),
                      outs, g["rel_settle"][-2:]))
    return _clock_profile("rel_settle", "rel_settle_kernel", SETTLE_PARTS,
                          cases, timer=_graph_ms)


# --------------------------------------------------------------------- 4
def _hisim_model(tmp: str) -> str:
    """tiny's HIsim error model (-M), unpacked into ``tmp``."""
    path = os.path.join(tmp, "hisim.model")
    with gzip.open(os.path.join(FIX, "tiny", "hisim.model.gz"), "rb") as f, \
            open(path, "wb") as g:
        g.write(f.read())
    return path


def _two_models() -> dict:
    """Two models on one bucket in one process: tiny's first chunk pack
    run with tiny's RelParams and with medium's (other coverages, so other
    outputs) through rel_only, whose process-wide cache (rel.GRAPHS) keys
    each chunk graph on its RelParams: each model's replays (twice, in
    turns with the other's) equal its own eager launches, every byte, the
    two models' outputs differ, and the bucket holds one graph per
    model."""
    from classpro_tpu_torch import kernels, rel
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.params import build_rel_params

    gm, seqs, profs = _model("tiny")
    eng = TorchEngine(gm, device="cuda")
    P_b = build_rel_params(_global_model("medium"), "cuda")
    fb, ib, R, max_m = _packs(eng, seqs, profs)[0]
    fb_d, ib_d = torch.from_numpy(fb).cuda(), torch.from_numpy(ib).cuda()
    n0 = len(rel.GRAPHS)
    want = {k: rel.rel_glued(fb_d, ib_d, P, R, max_m, kernels)
            for k, P in (("tiny", eng.P), ("medium", P_b))}
    for k, P in (("tiny", eng.P), ("medium", P_b), ("tiny", eng.P),
                 ("medium", P_b)):
        got = rel.rel_only(fb_d, ib_d, P, R, max_m, impl="cuda")
        if not torch.equal(got, want[k]):
            fail(f"two models on one bucket: the {k} model's graph replay "
                 f"differs from its eager launches")
    if len(rel.GRAPHS) != n0 + 2:
        fail(f"two models on one bucket: {len(rel.GRAPHS) - n0} graph(s) "
             f"captured, want 2")
    rows = int((want["tiny"] != want["medium"]).any(1).sum())
    if not rows:
        fail("two models on one bucket: the two models' outputs are equal")
    return {"bucket": [R, max_m], "rows_differing": rows}


def phase_e2e():
    from classpro_tpu_torch.engine import classify_file_torch
    from classpro_tpu_torch.io.classfile import write_class

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        _reset_launches()
        for fx in ("tiny", "medium"):
            d = os.path.join(FIX, fx)
            out = os.path.join(tmp, fx + ".class")
            st: dict = {}
            t0 = time.time()
            write_class(out, classify_file_torch(
                os.path.join(d, "reads.fasta.gz"), os.path.join(d, "reads"),
                device="cuda", stats_out=st))
            wall = time.time() - t0
            with gzip.open(os.path.join(d, "golden.class.gz"), "rb") as f:
                want = f.read()
            with open(out, "rb") as f:
                got = f.read()
            if got != want:
                fail(f"e2e {fx}: .class differs from golden.class.gz")
            say(f"e2e {fx}: byte-identical to golden ({len(got)} bytes, "
                f"{wall:.2f} s incl. set-up, guard_flagged "
                f"{st['guard_flagged']}, buckets {st['shapes']})")
        launches = _path_launches("main path", MAIN_PATH, MAIN_TAILS,
                                  "graphs")
        if launches["rel_prep"]:
            fail(f"main path launched rel_prep: {launches}")
        say(f"e2e launches: {launches}")
        two = _two_models()
        say(f"e2e two models on one bucket {two['bucket']}: each model's "
            f"graph replay == its eager launches, every byte; the models "
            f"differ on {two['rows_differing']} row(s)")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -------------------------------------------------------------------- 4b
# a cold job's set-up, stage by stage: (stage, the functions whose calls
# it times, as (module, class or None, attribute)); each call's seconds
# exclude those of the timed calls it makes
SETUP_STAGES = (
    ("hist_model", (("engine", None, "load_histogram"),
                    ("engine", None, "build_global_model"))),
    ("build_tables", (("tables", None, "build_tables"),)),
    ("skellam_load", (("skellam", None, "build_skellam_tables"),)),
    ("device_tables", (("params", None, "device_tables"),)),
    ("library_load", (("native", None, "get_lib"),
                      ("kernels", None, "_entry"))),
    ("wall_stage", (("engine", "TorchEngine", "_stage"),)),
    ("graph_capture", (("rel", "ChunkGraph", "__init__"),)),
    ("first_chunk", (("engine", "TorchEngine", "_finish"),)),
)


def _stage_clocks(rec: dict):
    """Wrap every function of SETUP_STAGES so that each call adds its own
    seconds (less those of the timed calls nested in it, per thread) to
    ``rec[stage]``: "first" (the first call of each of the stage's
    functions), "total" (every call) and "calls".  Returns the undo."""
    import importlib

    local = threading.local()
    seen: set = set()                # the functions called at least once
    undo = []
    for stage, fns in SETUP_STAGES:
        r = rec.setdefault(stage, {"first": 0.0, "total": 0.0, "calls": 0})
        for mod, cls, name in fns:
            obj = importlib.import_module(f"classpro_tpu_torch.{mod}")
            obj = getattr(obj, cls) if cls else obj
            f = getattr(obj, name)

            def g(*a, _f=f, _r=r, _key=(mod, cls, name), **kw):
                stack = local.__dict__.setdefault("stack", [])
                stack.append(0.0)
                t = time.perf_counter()
                try:
                    return _f(*a, **kw)
                finally:
                    dt = time.perf_counter() - t
                    own = dt - stack.pop()
                    if stack:
                        stack[-1] += dt
                    if _key not in seen:
                        seen.add(_key)
                        _r["first"] += own
                    _r["total"] += own
                    _r["calls"] += 1

            setattr(obj, name, g)
            undo.append(lambda o=obj, n=name, f=f: setattr(o, n, f))
    return lambda: [u() for u in reversed(undo)]


def _bits_differ(a, b) -> int:
    import numpy as np

    return int((np.asarray(a).view(np.int64)
                != np.asarray(b).view(np.int64)).sum())


def phase_setup_cold() -> dict:
    """The child of phase_setup, a fresh process: classify_file_torch on
    medium (cuda) with every set-up stage timed (SETUP_STAGES; before it,
    each on its own, the interpreter's start from the parent's spawn,
    torch's import, the probe, the port's import and the CUDA context),
    its bytes held to the golden; then the model's tail table by
    tables.btg_plain, the plain numpy version, timed and held to the one
    the job built bit for bit, and the C++ call timed again warm
    (three calls); and a seeded draw of error rates through both
    versions, bit for bit."""
    import numpy as np

    t = time.perf_counter()
    pre = {"torch_import": _T1 - _T0, "probe": t - _T1}
    if "CHIP_SMOKE_SPAWN" in os.environ:     # set by phase_setup
        pre = dict(interpreter=_T0_WALL
                   - float(os.environ["CHIP_SMOKE_SPAWN"]), **pre)
    from classpro_tpu_torch import kernels, native, rel, skellam, tables
    from classpro_tpu_torch.engine import classify_file_torch
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram
    from classpro_tpu_torch.numerics import LOGFACT

    pre["port_import"] = time.perf_counter() - t
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    pre["cuda_init"] = time.perf_counter() - t
    # before the job: the interpreter's start (from the parent's spawn),
    # torch's import, the probe (arguments, the CUDA device query,
    # nvidia-smi), the port's import and the CUDA context
    rec = {k: {"first": v, "total": v, "calls": 1} for k, v in pre.items()}
    d = os.path.join(FIX, "medium")
    npz = skellam._cache_path(skellam.NMAX)
    out = {"skellam_on_disk": os.path.exists(npz)}
    undo = _stage_clocks(rec)
    st: dict = {}
    try:
        t = time.perf_counter()
        recs = classify_file_torch(os.path.join(d, "reads.fasta.gz"),
                                   os.path.join(d, "reads"), device="cuda",
                                   stats_out=st)
        out["call_s"] = time.perf_counter() - t
        got = []
        for r in recs:
            if not got:
                out["to_first_record_s"] = time.perf_counter() - t
            got.append(f"{r.header}\n{r.seq}\n+\n{r.classes}\n".encode())
        out["wall_s"] = time.perf_counter() - t
    finally:
        undo()
    if b"".join(got) != _gold_bytes("medium"):
        fail("setup: medium's .class differs from golden.class.gz")
    if kernels.LAUNCHES["rel_dp"] <= 0 or rel.GRAPH_COUNTS["replays"] <= 0:
        fail(f"setup: the main path ran no DP launch or replay: "
             f"{kernels.LAUNCHES} {rel.GRAPH_COUNTS}")
    out["stages"] = rec
    # the job's seconds in no timed stage (on the card mostly the stream's
    # other chunks; on the CPU the plain DP)
    out["untimed_s"] = out["wall_s"] - sum(
        v["total"] for k, v in rec.items() if k not in pre)
    out["cold_s"] = sum(pre.values()) + out["wall_s"]
    out["guard_flagged"] = st["guard_flagged"]

    dt = tables.build_tables(build_global_model(
        load_histogram(os.path.join(d, "reads"))))
    t = time.perf_counter()
    plain = tables.btg_plain(dt.erates, dt.n_cap)
    out["numpy_btg_s"] = time.perf_counter() - t
    out["btg_shape"] = list(dt.btg.shape)
    out["btg_bits_differing"] = _bits_differ(dt.btg, plain)
    warm = []
    for _ in range(3):
        t = time.perf_counter()
        again = native.build_btg(dt.erates, dt.n_cap, LOGFACT)
        warm.append(time.perf_counter() - t)
    out["cpp_btg_warm_s"] = warm
    out["btg_bits_differing"] += _bits_differ(again, plain)
    rates = np.exp(np.random.default_rng(0).uniform(np.log(1e-4),
                                                    np.log(0.45), 6))
    out["random_bits_differing"] = _bits_differ(
        native.build_btg(rates, 300, LOGFACT), tables.btg_plain(rates, 300))
    return out


def phase_setup(smi: str) -> dict:
    """phase_setup_cold in a process of its own (its caches cold: the
    host tables, the Skellam table in memory, the tables on the card,
    the loaded libraries; the kernels and the host library this run
    built are loaded, not rebuilt, and the Skellam table comes from its
    disk cache when an earlier phase wrote it); fails unless the child
    wrote the golden bytes and both tail tables are equal bit for bit on
    this host."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--phases", "setup_cold"], cwd=HERE,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, CHIP_SMOKE_SPAWN=repr(
                           time.time())))
    recs = [json.loads(x) for x in r.stdout.splitlines()
            if x.startswith('{"setup_cold":')]
    if r.returncode != 0 or len(recs) != 1:
        fail(f"the cold set-up's process failed (rc {r.returncode}): "
             f"{r.stderr[-2000:]}")
    rec = recs[0]["setup_cold"]
    if rec["btg_bits_differing"] or rec["random_bits_differing"]:
        fail(f"setup: the C++ tail table differs from _btg_row's on this "
             f"host: {rec['btg_bits_differing']} entries (medium), "
             f"{rec['random_bits_differing']} (random rates)")
    st = rec["stages"]
    say("setup (medium, a fresh process, cold; seconds of each stage's "
        "first calls / all its calls): " + ", ".join(
        f"{k} {v['first']:.4f}/{v['total']:.4f} s" if v["calls"]
        else f"{k} not run" for k, v in st.items())
        + f", untimed {rec['untimed_s']:.4f} s; first record after "
        f"{rec['to_first_record_s']:.3f} s of classify_file_torch, whole "
        f"file {rec['wall_s']:.3f} s, cold {rec['cold_s']:.3f} s from the "
        f"process's spawn (Skellam table on disk: "
        f"{rec['skellam_on_disk']})")
    bt = st["build_tables"]["first"]
    say(f"setup: build_tables (C++ tail table) {bt:.4f} s cold, C++ call "
        f"warm {min(rec['cpp_btg_warm_s']):.4f} s; numpy btg_plain "
        f"{rec['numpy_btg_s']:.3f} s ({rec['numpy_btg_s'] / bt:.0f}x); "
        f"table {rec['btg_shape']} equal bit for bit, and on 6 random "
        f"rates")
    return dict(rec, card=smi)


# --------------------------------------------------------------------- 5
def _clock(obj, name: str, acc: dict):
    """Wrap obj.name to add its wall seconds to acc[name]; returns an
    undo callable."""
    f = getattr(obj, name)

    def g(*a, **kw):
        t = time.perf_counter()
        try:
            return f(*a, **kw)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t

    own = name in vars(obj)          # else f comes from obj's class
    setattr(obj, name, g)
    return ((lambda: setattr(obj, name, f)) if own
            else (lambda: delattr(obj, name)))


# the depth-3 stream's feed to the card by part, as source: this process
# runs it (``_feed_fns``) and the tree scripts below start with it, so
# that both trees are clocked alike.  ``feed_clock(eng, acc, alldev)``
# wraps, for one engine, the enqueue of every chunk (TorchEngine._submit
# without its wall stage; acc keys "feed.*", seconds): the C++ pack
# (``_pack_st`` / ``wall.pack_chunk``), the blobs into the bucket graph's
# static inputs and its replay (rel.BlobGraph.run), the result's copy back
# and the event (Tensor.copy_ and cuda.Event.record inside _enqueue,
# outside that run) and the host pinning inside _enqueue
# (Tensor.pin_memory, torch.empty(pin_memory=True)); it counts enqueues,
# and every pin_memory() call and pinned allocation anywhere in the
# process; returns the undo.  ``feed_parts(acc)`` gives ms per enqueued
# chunk by part (the slot's take, ``_take``, where the tree has one;
# "other_in_enqueue": the rest of _enqueue, the device pick, the stream
# and device contexts, the event's creation; "rest": the rest of the
# enqueue outside _enqueue, the blob sizes and dims) and the two counts
# per chunk.
_FEED_CLOCK = r'''
import time as _ft
import torch as _fto


def feed_clock(eng, acc, alldev):
    from classpro_tpu_torch import rel as _rel

    depth = {"enq": 0, "run": 0}
    undo = []

    def patch(owner, name, wrap):
        own = name in vars(owner)
        f = vars(owner)[name] if own else getattr(owner, name)
        setattr(owner, name, wrap(f))
        undo.append((lambda: setattr(owner, name, f)) if own
                    else (lambda: delattr(owner, name)))

    def timed(key, inner=None, when=None, count=None):
        """wrap(f): f's seconds into acc[key] when ``when(a, kw)`` (always
        when None), acc[count[0]] += 1 when ``count[1](a, kw)``; ``inner``
        names the depth counter raised during the call."""
        def wrap(f):
            def g(*a, **kw):
                if count is not None and count[1](a, kw):
                    acc[count[0]] = acc.get(count[0], 0) + 1
                if when is not None and not when(a, kw):
                    return f(*a, **kw)
                if inner:
                    depth[inner] += 1
                t = _ft.perf_counter()
                try:
                    return f(*a, **kw)
                finally:
                    acc[key] = acc.get(key, 0.0) + _ft.perf_counter() - t
                    if inner:
                        depth[inner] -= 1
            return g
        return wrap

    every = lambda a, kw: True                             # noqa: E731
    in_enq = lambda a, kw: depth["enq"] > 0                # noqa: E731
    pinned = lambda a, kw: bool(kw.get("pin_memory"))      # noqa: E731
    patch(eng, "_submit", timed("feed.submit"))
    patch(eng, "_stage", timed("feed.stage"))
    if alldev:
        patch(eng.wall, "pack_chunk", timed("feed.pack"))
    else:
        patch(eng, "_pack_st", timed("feed.pack"))
    patch(eng, "_enqueue", timed("feed.enqueue_call", "enq",
                                 count=("feed.enqueues", every)))
    if hasattr(eng, "_take"):                    # the staging slot's take
        patch(eng, "_take", timed("feed.take"))
    patch(_rel.BlobGraph, "run", timed("feed.h2d_replay", "run",
                                       when=in_enq))
    outside_run = (lambda a, kw: depth["enq"] > 0          # noqa: E731
                   and not depth["run"])
    patch(_fto.Tensor, "copy_", timed("feed.d2h_event", when=outside_run))
    patch(_fto.cuda.Event, "record", timed("feed.d2h_event",
                                           when=outside_run))
    patch(_fto.Tensor, "pin_memory", timed(
        "feed.pin", when=in_enq, count=("pin_memory_calls", every)))
    patch(_fto, "empty", timed(
        "feed.pin", when=lambda a, kw: in_enq(a, kw) and pinned(a, kw),
        count=("pinned_allocs", pinned)))

    def undo_all():
        for u in reversed(undo):
            u()
    return undo_all


def feed_parts(acc):
    a = lambda k: acc.get("feed." + k, 0.0)                # noqa: E731
    n = max(acc.get("feed.enqueues", 0), 1)
    enq = a("submit") - a("stage") - a("pack")
    ms = {k: 1e3 * a(k) / n for k in ("pack", "take", "h2d_replay",
                                      "d2h_event", "pin")}
    inside = a("h2d_replay") + a("d2h_event") + a("pin")
    ms["other_in_enqueue"] = 1e3 * (a("enqueue_call") - inside) / n
    ms["rest"] = 1e3 * (enq - a("take") - a("enqueue_call")) / n
    ms["enqueue"] = 1e3 * enq / n
    return {"chunks": acc.get("feed.enqueues", 0), "ms_per_chunk": ms,
            "pin_memory_calls": acc.get("pin_memory_calls", 0),
            "pinned_allocs": acc.get("pinned_allocs", 0)}
'''


def _feed_fns():
    """(feed_clock, feed_parts) of ``_FEED_CLOCK``, in this process."""
    ns: dict = {}
    exec(_FEED_CLOCK, ns)
    return ns["feed_clock"], ns["feed_parts"]


def _feed_line(f: dict) -> str:
    """One line of ``feed_parts``' record."""
    return (f"enqueue by part, ms a chunk ({f['chunks']} chunks): "
            + ", ".join(f"{k} {v:.4f}" for k, v in f["ms_per_chunk"].items())
            + f"; pin_memory() calls {f['pin_memory_calls']}, pinned "
            f"allocations {f['pinned_allocs']}")


def _no_pinning(tag: str, f: dict) -> None:
    """Fail unless a run after the warm-up pinned and allocated no host
    memory (``feed_parts``' counts)."""
    if f["pin_memory_calls"] or f["pinned_allocs"]:
        fail(f"{tag}: {f['pin_memory_calls']} pin_memory() call(s) and "
             f"{f['pinned_allocs']} pinned allocation(s) after the "
             f"warm-up over {f['chunks']} chunks (want 0 and 0)")


def _hold_slots(eng, alldev: bool, tag: str, held: list):
    """Hold each chunk's staging slot, as ``eng._enqueue`` sends it to the
    card, against a fresh pack of the same chunk (no destination), fblob
    as uint64 bit patterns; append each slot's buffer address to
    ``held``.  Returns the undo."""
    import numpy as np

    f = eng._enqueue

    def enqueue(st, key, run):
        host, w = st["host"], eng.wall
        args = (w, st["slab"], st["slot"], st["n_out"], st["n_rel"],
                st["_plens"])
        # the C++ entries themselves, past any wrapper on the instance
        if alldev:
            fb, ib, _ = type(w).pack_chunk(*args, st["rows"],
                                           threads=eng.threads)
        else:
            fb, ib = type(w).pack_rel(*args, st["_R"], st["_mm"])
        if host.iblob.shape != ib.shape or host.fblob.shape != fb.shape \
                or not np.array_equal(host.iblob, ib) \
                or not np.array_equal(host.fblob.view(np.uint64),
                                      fb.view(np.uint64)):
            fail(f"{tag}: chunk {len(held)}'s staging slot differs from a "
                 f"fresh pack of the chunk")
        held.append(host.buf.data_ptr())
        return f(st, key, run)

    eng._enqueue = enqueue
    return lambda: delattr(eng, "_enqueue")


def _launch_events(sink):
    """Record CUDA events on the launch stream just before and just after
    each kernel launch (inside kernels._launch, so they hold the launch
    and the kernel, not the wrapper's checks and allocations); the pair
    goes to the list ``sink(name, args)``.  Returns the undo."""
    from classpro_tpu_torch import kernels

    orig = kernels._launch

    def launch(name, device, args):
        stream = torch.cuda.current_stream(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(stream)
        orig(name, device, args)
        e1.record(stream)
        sink(name, args).append((e0, e1))

    kernels._launch = launch

    def undo():
        kernels._launch = orig
    return undo


def _profiled_launches(run, eng) -> dict:
    """Kernel launch calls per device chunk over one profiled pass
    (torch.profiler, CPU + CUDA; the cudaLaunchKernel events of its
    Chrome trace inside the pass's marked window), and the kernel events
    by name with their time on the card.  The window opens with spin
    kernels and a pause: kernels launched just after the profiler starts
    may be missing from the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from classpro_tpu_torch.devtools.profile_summary import load_events

    c0 = eng.chunks_done
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(16):
            torch.cuda._sleep(100000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        with record_function("chip_smoke_pass"):
            run(1)
    chunks = max(eng.chunks_done - c0, 1)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        evs = load_events(path)
    finally:
        os.remove(path)
    mark = [e for e in evs if e.get("name") == "chip_smoke_pass"
            and e.get("cat") == "user_annotation"]     # not the card's copy
    if len(mark) != 1:
        fail(f"the profiled pass's window is marked {len(mark)} times")
    lo = float(mark[0]["ts"])
    hi = lo + float(mark[0]["dur"])
    calls = [e for e in evs if e.get("cat") == "cuda_runtime"
             and ("LaunchKernel" in e.get("name", "")
                  or "GraphLaunch" in e.get("name", ""))
             and lo <= float(e["ts"]) <= hi]
    graph_calls = sum("GraphLaunch" in e["name"] for e in calls)
    kern = [e for e in evs if e.get("cat") == "kernel"
            and "spin_kernel" not in e.get("name", "")]
    if not calls:
        fail("the profiled pass holds no kernel launch call")
    by = {}
    for e in kern:
        k = e["name"].split("(")[0][:60]
        n, us = by.get(k, (0, 0.0))
        by[k] = (n + 1, us + float(e["dur"]))
    return {"chunks": chunks, "launch_calls_per_chunk": len(calls) / chunks,
            "graph_launch_calls_per_chunk": graph_calls / chunks,
            "kernels_per_chunk": len(kern) / chunks,
            "kernel_us_per_chunk": sum(us for _, us in by.values())
            / chunks,
            "by_kernel": {k: {"count": n, "us": us}
                          for k, (n, us) in sorted(by.items())}}


def _medium_stream(alldev: bool, batch_size: int = 200,
                   sort_window: int = 8):
    """The steady stream over medium on one path (main, or alldev) and
    its two compositions of the glue: a namespace of the engine, ``run(n)``
    (n passes, every chunk checked against the golden; returns seconds),
    k-mers and reads per pass, ``comps`` ("plain_glue": the plain torch
    glue around the DP and sweep kernels, the composition before the glue
    kernels, after an upload (on the main path rel_only's eager launches,
    on the all-device path classify_batch's plain glue); "kernels": the
    path as it ships, the bucket graph's replay) and ``install(fn)``,
    which puts fn in place of TorchEngine._device_stage and returns the
    undo."""
    import types

    from classpro_tpu_torch import alldev as alldev_mod
    from classpro_tpu_torch import engine as engine_mod
    from classpro_tpu_torch import kernels

    gm, seqs, profs = _model("medium")
    gold = golden_classes("medium")
    eng = engine_mod.TorchEngine(gm, batch_size=batch_size, device=DEV,
                                 alldev=alldev)
    B = 200                                  # input chunks, as the CLI
    spans = [(lo, min(lo + B, len(seqs))) for lo in range(0, len(seqs), B)]
    mod, attr = engine_mod.TorchEngine, "_device_stage"
    orig = getattr(mod, attr)

    def plain(self, f, i, P, PP, shape):
        f = f.to(P.device, non_blocking=True)
        i = i.to(P.device, non_blocking=True)
        if PP is not None:
            return alldev_mod.pack_flags(*alldev_mod.classify_batch(
                f, i, PP, *shape, impl=("cuda", "cuda")))
        return engine_mod.rel_only(f, i, P, *shape, impl=kernels.rel_dp)

    def run(n):
        chunks = ((seqs[lo:hi], profs[lo:hi])
                  for _ in range(n) for lo, hi in spans)
        t0 = time.perf_counter()
        for k, res in enumerate(eng.classify_stream(
                chunks, sort_window=sort_window)):
            lo, hi = spans[k % len(spans)]
            if res != gold[lo:hi]:
                fail(f"{'alldev ' if alldev else ''}stream chunk {k} "
                     f"differs from the golden")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def install(fn):
        setattr(mod, attr, fn)
        return lambda: setattr(mod, attr, orig)

    # a warm-up covers whole sort windows of input chunks, so that it
    # meets every batch (and so every bucket) of the steady passes, and at
    # least depth + 1 device chunks, so that the staging pool has held as
    # many chunks at once as the steady stream will
    win = max(1, -(-sort_window // len(spans)))
    fill = -(-(eng.depth + 1) * batch_size // len(seqs))
    return types.SimpleNamespace(
        eng=eng, run=run, install=install, reads=len(seqs),
        warm_passes=win * -(-max(win, fill) // win),
        kmers_pass=sum(len(c) - c.count("N") for c in gold[:len(seqs)]),
        comps={"plain_glue": plain, "kernels": orig})


def _warm(S, comps) -> None:
    """A warm-up of each of ``comps``: ``S.warm_passes`` passes."""
    for comp in comps:
        undo = S.install(S.comps[comp])
        try:
            S.run(S.warm_passes)
        finally:
            undo()


def phase_profiled() -> dict:
    """One profiled pass of each composition of each stream (only when
    named; the glue_ab phase runs it as a process of its own, so that its
    profiler sessions leave the serve phase's `--torch-profile` session
    the only one in the main process)."""
    out = {}
    for path, alldev in (("stream", False), ("alldev_stream", True)):
        S = _medium_stream(alldev)
        _warm(S, S.comps)
        out[path] = {}
        for comp in S.comps:
            undo = S.install(S.comps[comp])
            try:
                out[path][comp] = _profiled_launches(S.run, S.eng)
            finally:
                undo()
    return out


def _profiled_process() -> dict:
    """phase_profiled in a process of its own (the kernels and the host
    library this run built are loaded, not rebuilt)."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--phases", "profiled"], cwd=HERE,
                       capture_output=True, text=True, timeout=900)
    recs = [json.loads(x) for x in r.stdout.splitlines()
            if x.startswith('{"profiled":')]
    if r.returncode != 0 or len(recs) != 1:
        fail(f"the profiled passes' process failed (rc {r.returncode}): "
             f"{r.stderr[-2000:]}")
    prof = recs[0]["profiled"]
    for path, comps in prof.items():
        for comp, p in comps.items():
            say(f"{path} {comp}: {p['launch_calls_per_chunk']:.1f} launch "
                f"calls per device chunk ({p['chunks']} chunks profiled); "
                f"{p['kernels_per_chunk']:.1f} kernel events, "
                f"{p['kernel_us_per_chunk']:.1f} us on the card: "
                + json.dumps(p["by_kernel"]))
    return prof


def _spanned(fn, sink: list):
    """fn with CUDA events recorded on the current stream just before and
    after each call; the pairs go to ``sink``."""
    def g(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*a, **kw)
        e1.record()
        sink.append((e0, e1))
        return out
    return g


# the streams' turns: by default three runs of the path as it ships (the
# glue kernels); the glue_ab phase takes the two compositions of the
# per-chunk glue in turns, the plain torch glue around the DP (and sweep)
# kernels, as before the glue kernels, and the glue kernels
TURNS = ("kernels",) * 3
AB_TURNS = ("plain_glue", "kernels", "kernels", "plain_glue")


def _span_attr(obj, name: str, sink: list):
    """obj.name with CUDA events around each call (``_spanned``); returns
    the undo."""
    f = getattr(obj, name)
    setattr(obj, name, _spanned(f, sink))
    return lambda: setattr(obj, name, f)


def _main_clocks(eng, acc: dict) -> list:
    """Clock the main path's stages of ``eng`` into ``acc``
    (``_clock``); returns the undos."""
    from classpro_tpu_torch import engine as engine_mod

    undo = [_clock(eng, n, acc) for n in ("_stage", "_pack_st", "_submit",
                                          "_finish", "_exact_guard")]
    undo += [_clock(eng.wall, n, acc)
             for n in ("finish_batch", "demote_reconcile")]
    undo += [_clock(engine_mod, "unpack_out", acc)]
    return undo


def _main_host_s(acc: dict, wall: float) -> dict:
    """The main thread's seconds by stage of a main-path run of ``wall``
    seconds (``_main_clocks``), each without the stages nested in it."""
    a = lambda k: acc.get(k, 0.0)             # noqa: E731
    return {
        "wall_stage_cpp": a("_stage"), "pack_rel_cpp": a("_pack_st"),
        "enqueue_h2d_dp_d2h": a("_submit") - a("_stage") - a("_pack_st"),
        "wait_device": a("_finish") - a("unpack_out")
        - a("demote_reconcile") - a("_exact_guard") - a("finish_batch"),
        "unpack_out": a("unpack_out"),
        "demote_reconcile": a("demote_reconcile"),
        "exact_guard": a("_exact_guard"),
        "finish_batch_cpp": a("finish_batch"),
        "other": wall - a("_submit") - a("_finish")}


# the main path's host rel steps alone, per chunk, in turns: numpy
# demote_host + reconcile_fwbw (the plain versions) and the C++ entry at
# 8 and 1 workers
HOST_REL_TURNS = ("numpy", "cpp_t8", "cpp_t1", "numpy")


def _record_host_rel(wall, recs: list):
    """Record every ``wall.demote_reconcile`` call (copies of its inputs
    and its result) into ``recs``; returns the undo."""
    import numpy as np

    f = wall.demote_reconcile

    def rec(v, rescue, b, e, ccb, cce, m, gH, gD, threads=0):
        got = f(v, rescue, b, e, ccb, cce, m, gH, gD, threads=threads)
        recs.append({"args": (np.array(v), np.array(rescue), np.array(b),
                              np.array(e), np.array(ccb), np.array(cce),
                              np.array(m), gH, gD), "got": got.copy()})
        return got

    wall.demote_reconcile = rec

    def undo():
        del wall.demote_reconcile
    return undo


def _time_host_rel(tag: str, wall, recs: list) -> dict:
    """The host rel steps alone on every recorded chunk: the stream's C++
    result and the C++ entry at T = 8 and T = 1 held to numpy
    demote_host + reconcile_fwbw byte for byte (the run fails on any
    difference), then each timed per chunk in HOST_REL_TURNS."""
    import numpy as np

    from classpro_tpu_torch.rel import demote_host, reconcile_fwbw

    if not recs:
        fail(f"{tag} host check: the stream recorded no chunk")

    def numpy_pair(args):
        return reconcile_fwbw(demote_host(*args), args[4], args[5], args[6])

    def cpp(args, T):
        return wall.demote_reconcile(*args, threads=T)

    for k, c in enumerate(recs):
        want = numpy_pair(c["args"])
        for what, got in (("the stream's", c["got"]),
                          ("T=8", cpp(c["args"], 8)),
                          ("T=1", cpp(c["args"], 1))):
            if got.dtype != want.dtype or not np.array_equal(got, want):
                fail(f"{tag} host check chunk {k}: demote_reconcile "
                     f"({what}) differs from numpy demote_host + "
                     f"reconcile_fwbw")
    rec = {"chunks": len(recs),
           "shapes": sorted({c["args"][2].shape for c in recs}),
           "turns": list(HOST_REL_TURNS), "ms": [],
           "bytes_equal_to_numpy": True}
    for kind in HOST_REL_TURNS:
        ms = []
        for c in recs:
            t = time.perf_counter()
            if kind == "numpy":
                numpy_pair(c["args"])
            else:
                cpp(c["args"], int(kind[-1]))
            ms.append((time.perf_counter() - t) * 1e3)
        rec["ms"].append(ms)
    rec["ms_median"] = {
        kind: statistics.median(x for t, ms in zip(HOST_REL_TURNS, rec["ms"])
                                if t == kind for x in ms)
        for kind in dict.fromkeys(HOST_REL_TURNS)}
    say(f"{tag} host check ({len(recs)} chunks, (R, max_m) "
        f"{rec['shapes']}): demote_reconcile at T=8 and T=1 equal to numpy "
        f"demote_host + reconcile_fwbw byte for byte; median ms per chunk "
        f"in turns {' '.join(HOST_REL_TURNS)}: "
        + ", ".join(f"{k} {v:.4f}" for k, v in rec["ms_median"].items()))
    return rec


# one checkout's main stream over medium, as a process of its own (that
# tree's package first on its path): a warm-up of one sort window, then
# TREE_RUNS timed runs of argv[2] passes, every chunk checked against the
# golden; the main thread's seconds by stage (the host rel steps as the
# C++ demote_reconcile, or in a tree before it numpy demote_host and
# reconcile_fwbw in the engine module); prints one JSON line
_TREE_MAIN = _FEED_CLOCK + r"""
import gzip, json, sys, time
import torch
from classpro_tpu_torch import engine as engine_mod
from classpro_tpu_torch.estimation import build_global_model
from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
from classpro_tpu_torch.io.fastx import read_fastx
fx, passes, runs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
gm = build_global_model(load_histogram(fx + "/reads"))
P = open_profiles(fx + "/reads")
seqs = [r.seq for r in read_fastx(fx + "/reads.fasta.gz")]
profs = [P.fetch(i) for i in range(len(seqs))]
with gzip.open(fx + "/golden.class.gz", "rt") as f:
    gold = f.read().splitlines()[3::4]
kmers = sum(len(c) - c.count("N") for c in gold)
eng = engine_mod.TorchEngine(gm, batch_size=200, device="cuda")
acc, calls = {}, []
def clock(obj, name, key):
    f = getattr(obj, name, None)
    if f is None:
        return 0
    def g(*a, **kw):
        t = time.perf_counter()
        try:
            return f(*a, **kw)
        finally:
            dt = time.perf_counter() - t
            acc[key] = acc.get(key, 0.0) + dt
            if key == "demote_reconcile":
                calls.append(dt)
    setattr(obj, name, g)
    return 1
for n in ("_stage", "_pack_st", "_submit", "_finish", "_exact_guard"):
    clock(eng, n, n)
clock(eng.wall, "finish_batch", "finish_batch")
clock(engine_mod, "unpack_out", "unpack_out")
# the host rel steps: one call a chunk, or the numpy pair's two
per_chunk = clock(eng.wall, "demote_reconcile", "demote_reconcile") + sum(
    clock(engine_mod, n, "demote_reconcile")
    for n in ("demote_host", "reconcile_fwbw"))
spans = [(lo, min(lo + 200, len(seqs))) for lo in range(0, len(seqs), 200)]
def run(n):
    chunks = ((seqs[lo:hi], profs[lo:hi])
              for _ in range(n) for lo, hi in spans)
    t = time.perf_counter()
    for k, res in enumerate(eng.classify_stream(chunks, sort_window=8)):
        lo, hi = spans[k % len(spans)]
        if res != gold[lo:hi]:
            sys.exit(f"chunk {k} differs from the golden")
    torch.cuda.synchronize()
    return time.perf_counter() - t
run(max(1, -(-8 // len(spans))))
feed = {}
feed_clock(eng, feed, False)
out = []
for _ in range(runs):
    acc.clear()
    feed.clear()
    del calls[:]
    g0 = eng.guard_flagged
    wall = run(passes)
    a = lambda k: acc.get(k, 0.0)
    chunk_ms = sorted(1e3 * sum(calls[i:i + per_chunk])
                      for i in range(0, len(calls), per_chunk))
    out.append({"wall_s": wall, "kmers_per_s": passes * kmers / wall,
                "guard_flagged": eng.guard_flagged - g0,
                "demote_reconcile_ms_per_chunk": {
                    "median": chunk_ms[len(chunk_ms) // 2],
                    "max": chunk_ms[-1], "chunks": len(chunk_ms)},
                "feed": feed_parts(feed),
                "host_s": {
        "wall_stage_cpp": a("_stage"), "pack_rel_cpp": a("_pack_st"),
        "enqueue": a("_submit") - a("_stage") - a("_pack_st"),
        "waiting": a("_finish") - a("unpack_out") - a("demote_reconcile")
        - a("_exact_guard") - a("finish_batch"),
        "unpack_out": a("unpack_out"),
        "demote_reconcile": a("demote_reconcile"),
        "exact_guard": a("_exact_guard"),
        "finish_batch_cpp": a("finish_batch"),
        "other": wall - a("_submit") - a("_finish")}})
print(json.dumps({"runs": out}))
"""


def _tree_main(tree: str, passes: int) -> dict:
    """``_TREE_MAIN`` in checkout ``tree``."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    r = subprocess.run([sys.executable, "-c", _TREE_MAIN,
                        os.path.join(FIX, "medium"), str(passes),
                        str(TREE_RUNS)], cwd=tree, env=env,
                       capture_output=True, text=True, timeout=900)
    recs = [json.loads(x) for x in r.stdout.splitlines()
            if x.startswith("{")]
    if r.returncode != 0 or len(recs) != 1:
        fail(f"main stream of {tree} failed (rc {r.returncode}): "
             f"{r.stderr[-2000:]}")
    return recs[0]


def phase_stream(passes: int, batch_size: int = 200, sort_window: int = 8,
                 turns=TURNS, parent: str | None = None):
    """Steady stream over medium in the compositions of the main path's
    rel stage (``_medium_stream``) that ``turns`` names, in that order.
    After a warm-up of each (``_medium_stream``'s warm passes, which
    capture the buckets' graphs),
    each turn is a run of ``passes`` passes that records every kernel's
    launches and the chunk graphs' replays per chunk, the rel stage's
    span on the card per chunk (CUDA events on the stream around each
    graph replay, outside any capture; for the plain glue around its
    rel_only call) and where the main thread's time goes.  Then the host
    check (``_time_host_rel``) on every chunk of the warm-up's passes,
    and with ``parent`` (a checkout) that tree's main stream and this
    tree's, each a process of its own, in turns (parent, this, this,
    parent; ``_TREE_MAIN``)."""
    from classpro_tpu_torch import engine as engine_mod
    from classpro_tpu_torch import kernels, rel

    S = _medium_stream(False, batch_size, sort_window)
    eng = S.eng
    feed_clock, feed_parts = _feed_fns()

    def turn(comp):
        spans: list = []
        acc: dict = {}
        undo = [S.install(S.comps[comp]),
                _span_attr(rel.ChunkGraph, "replay", spans),
                _span_attr(engine_mod, "rel_only", spans)]
        undo += _main_clocks(eng, acc)
        undo.append(feed_clock(eng, acc, False))
        torch.cuda.reset_peak_memory_stats()
        g0, c0, n0 = eng.guard_flagged, eng.chunks_done, _counts()
        try:
            wall = S.run(passes)
        finally:
            for u in reversed(undo):
                u()
        d = _delta(n0, _counts())
        ms = [a.elapsed_time(b) for a, b in spans]
        chunks = max(eng.chunks_done - c0, 1)
        host = _main_host_s(acc, wall)
        return {
            "composition": comp,
            "kmers_per_s": passes * S.kmers_pass / wall,
            "wall_s": wall, "device_chunks": chunks,
            "launches_per_chunk": {k: d.get(k, 0) / chunks
                                   for k in kernels.LAUNCHES},
            "replays_per_chunk": d.get("graphs.replays", 0) / chunks,
            "captures": d.get("graphs.captures", 0),
            "rel_only_ms_per_chunk": sum(ms) / chunks,
            "rel_only_busy_share": sum(ms) / 1e3 / wall,
            "enqueue_ms_per_chunk": host["enqueue_h2d_dp_d2h"] * 1e3
            / chunks, "feed": feed_parts(acc),
            "host_s": host, "guard_flagged": eng.guard_flagged - g0,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}

    comps = tuple(dict.fromkeys(turns))
    _warm(S, comps)
    runs = [turn(c) for c in turns]
    res = {"batch_size": batch_size, "sort_window": sort_window,
           "passes": passes, "reads": passes * S.reads,
           "kmers": passes * S.kmers_pass, "turns": runs}
    for comp in comps:
        mine = [t for t in runs if t["composition"] == comp]
        res[comp] = {k: [t[k] for t in mine] for k in (
            "kmers_per_s", "rel_only_ms_per_chunk", "enqueue_ms_per_chunk",
            "replays_per_chunk")}
        res[comp]["enqueue_h2d_dp_d2h_s"] = [
            t["host_s"]["enqueue_h2d_dp_d2h"] for t in mine]
    for t in runs:
        if t["guard_flagged"]:
            fail(f"stream ({t['composition']}): guard_flagged "
                 f"{t['guard_flagged']} on medium")
        _no_pinning(f"stream ({t['composition']})", t["feed"])
        if t["composition"] == "kernels" and (
                t["launches_per_chunk"]["rel_prep"]
                or t["replays_per_chunk"] <= 0
                or t["launches_per_chunk"]["rel_dp"] * t["device_chunks"]
                != 2 * (t["replays_per_chunk"] * t["device_chunks"]
                        + t["captures"])):
            fail(f"stream: the main path is not two DP launches per "
                 f"replay (and per capture's eager run): {json.dumps(t)}")
        say(f"stream {t['composition']}: {t['kmers_per_s'] / 1e6:.2f} M "
            f"k-mers/s ({passes} passes of medium, {res['reads']} reads), "
            f"rel stage {t['rel_only_ms_per_chunk']:.3f} ms/chunk on the "
            f"card ({'the graph replay' if t['composition'] == 'kernels'
                     else 'rel_only'}), "
            f"{t['replays_per_chunk']:.2f} replays and launches "
            f"{json.dumps(t['launches_per_chunk'])} per chunk, enqueue "
            f"{t['enqueue_ms_per_chunk']:.3f} ms/chunk; main thread s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in t["host_s"].items())
            + "; " + _feed_line(t["feed"]))
    if "kernels" in comps:
        hrecs: list = []
        held: list = []
        undo = [S.install(S.comps["kernels"]),
                _record_host_rel(eng.wall, hrecs),
                _hold_slots(eng, False, "stream", held)]
        try:
            S.run(S.warm_passes)
        finally:
            for u in reversed(undo):
                u()
        res["host_rel"] = _time_host_rel("stream", eng.wall, hrecs)
        res["slots_held"] = {"chunks": len(held), "slots": len(set(held)),
                             "pool_allocs": eng.staging.allocs}
        say(f"stream staging: {len(held)} chunks' slots equal to a fresh "
            f"pack_rel bit for bit, {len(set(held))} distinct slots, "
            f"{eng.staging.allocs} allocated by the pool in this engine")
    if parent:
        ab = []
        for tree in (parent, HERE, HERE, parent):
            r = _tree_main(tree, passes)
            r["tree"] = "parent" if tree == parent else "this"
            ab.append(r)
            for x in r["runs"]:
                d = x["demote_reconcile_ms_per_chunk"]
                say(f"stream of the {r['tree']} tree ({passes} passes of "
                    f"medium, a process of its own, golden bytes): "
                    f"{x['kmers_per_s'] / 1e6:.2f} M k-mers/s; host rel "
                    f"steps {d['median']:.4f} ms a chunk (median; max "
                    f"{d['max']:.4f}); main thread s: "
                    + ", ".join(f"{k} {v:.4f}"
                                for k, v in x["host_s"].items())
                    + "; " + _feed_line(x["feed"]))
                if r["tree"] == "this":
                    _no_pinning("stream of this tree", x["feed"])
        if any(x["guard_flagged"] for r in ab for x in r["runs"]):
            fail("stream: a tree flagged reads on medium")
        res["parent_ab"] = ab
    return res


# --------------------------------------------------------------------- 6
def _alldev_packs(eng, seqs, profs, B=200):
    """(fblob, iblob, dims) of every chunk, as TorchEngine(alldev=True)
    packs them (the C++ entry, held bit for bit against numpy's)."""
    import numpy as np

    out = []
    for lo in range(0, len(seqs), B):
        st = eng._stage(seqs[lo:lo + B], profs[lo:lo + B])
        rows = np.flatnonzero(st["n_out"] > 0).astype(np.int32)
        plens = np.array([len(st["profiles"][i]) for i in st["g"]],
                         np.int64)
        fb, ib, dims = eng.wall.pack_chunk(
            st["slab"], st["slot"], st["n_out"], st["n_rel"], plens, rows)
        _numpy_pack(f"medium chunk {lo // B}", st["slab"], st["slot"],
                    st["n_out"], plens, rows, (fb, ib, dims))
        out.append((fb, ib, dims))
    return out


def _ivs(slab, slot: int, n_out) -> list:
    """Each slab read's records (the plain feed's input)."""
    return [slab[r * slot: r * slot + int(n_out[r])]
            for r in range(len(n_out))]


def _numpy_pack(tag: str, slab, slot: int, n_out, plens, rows, got):
    """numpy pack.pack_chunk of the slab reads ``rows`` (the plain
    version); fails unless the C++ pack ``got`` = (fblob, iblob, dims)
    equals it, fblob as uint64 bit patterns.  Returns numpy's pack."""
    import numpy as np

    from classpro_tpu_torch.pack import pack_chunk

    want = pack_chunk([int(r) for r in rows], _ivs(slab, slot, n_out),
                      plens)
    if got[2] != want[2] or not np.array_equal(got[1], want[1]) \
            or not np.array_equal(got[0].view(np.uint64),
                                  want[0].view(np.uint64)):
        fail(f"{tag}: the C++ pack_chunk differs from numpy's (dims "
             f"{got[2]} against {want[2]})")
    return want


def _numpy_feed(eng):
    """Swap ``eng``'s C++ feed for the plain numpy versions (pack_chunk,
    expand_asgn) behind the C++ entries' signatures, the expansion reading
    the metadata its chunk's pack made (as the engine before the C++ feed
    did); returns the undo."""
    import numpy as np

    from classpro_tpu_torch import pack

    metas: dict = {}

    def pack_chunk(slab, slot, n_out, n_rel, plens, rows, threads=0,
                   fblob=None, iblob=None):
        fb, ib, dims, meta = pack.pack_chunk(
            [int(r) for r in rows], _ivs(slab, slot, n_out), plens)
        metas[slab.ctypes.data, rows.tobytes()] = meta
        if fblob is not None:           # the engine's staging slot
            fblob[:], iblob[:] = fb, ib
        return fb, ib, dims

    def expand_rows(slab, slot, n_out, rows, asgn, out_off, threads=0):
        meta = metas.pop((slab.ctypes.data, rows.tobytes()))
        res = [None] * len(n_out)
        pack.expand_asgn(asgn, meta, res, eng.gm.kmer)
        return np.frombuffer("".join(res[r] for r in rows).encode("ascii"),
                             np.uint8)

    eng.wall.pack_chunk = pack_chunk
    eng.wall.expand_rows = expand_rows

    def undo():
        del eng.wall.pack_chunk, eng.wall.expand_rows
    return undo


def _unrel_bound(args, P, max_n: int) -> dict:
    """Least time for both sweeps over these inputs: each live interval's
    planes (P13, packL/R, the two step indices, live, is_rel, asgn) read
    once, n read once, the outputs written once, lf_small once, and the
    distinct 40-byte Skellam records and 8-byte binomial tails the active
    steps read, once each (counted off the plain version on the same
    inputs), against OPS_PER_UNREL_STEP + 4 x max_n operations per active
    step."""
    from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

    gathers: dict = {}
    unrel_sweeps_ref(*args, P, gathers=gathers)
    sk = torch.cat(gathers["skellam"]) if gathers["skellam"] else \
        torch.zeros(0)
    bt = torch.cat(gathers["btg"]) if gathers["btg"] else torch.zeros(0)
    records = int(torch.unique(sk).numel())
    tails = int(torch.unique(bt).numel())
    steps = sk.numel() // 4
    live = int(args[7].sum())
    B = args[1].shape[0]
    nbytes = (live * (13 * 8 + 2 * 3 * 8 + 2 * 4 + 1 + 1 + 4) + B * 4
              + B * max_n + B * 8 + records * 40 + tails * 8
              + P.lf_small.numel() * 8)
    t_b = nbytes / PEAK_BYTES * 1e3
    t_o = steps * (OPS_PER_UNREL_STEP + 4 * max_n) / PEAK_F64 * 1e3
    return {"ms": max(t_b, t_o), "by": "bytes" if t_b >= t_o
            else "operations", "bytes_ms": t_b, "ops_ms": t_o,
            "records": records, "tails": tails, "steps": steps,
            "bytes": nbytes, "ops": steps * (OPS_PER_UNREL_STEP + 4 * max_n)}


def _k6(U, asgn8, rescue, P, dims):
    """K6 alone: demotions, reconciliation, relaxation planes."""
    from classpro_tpu_torch import alldev

    Bn, max_n, R2, max_m = dims
    rel2 = alldev.demote_rows(U, asgn8, rescue, P)
    rel_out = alldev.reconcile_dev(rel2, U["m"], U["bcnt"], U["ecnt"],
                                   U["fwd"], R2 // 2, max_m)
    return alldev.sweep_inputs(U, rel_out, P, Bn, max_n)


def _k6_bound(fb, ib, dims) -> dict:
    """Least time for K6 of one chunk: the DP rows (int8) and the blob
    planes it reads, once (the whole blobs, a slight over-count), and its
    outputs written once (P13, packL/R f64 and the int32 assignment rows)."""
    Bn, max_n, R2, max_m = dims
    nbytes = (fb.nbytes + ib.nbytes + R2 * max_m
              + Bn * max_n * (13 + 6) * 8 + Bn * max_n * 4)
    return {"ms": nbytes / PEAK_BYTES * 1e3, "by": "bytes",
            "bytes": nbytes}


def _compare_sweeps(tag, args, P):
    """Sweep kernel vs plain on the same card inputs, bit for bit; returns
    the plain version's (asgn, margin) and its ms (one call)."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

    a_k, m_k = kernels.unrel_sweeps(*args, P)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a_r, m_r = unrel_sweeps_ref(*args, P)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    if not torch.equal(a_k, a_r):
        fail(f"{tag}: sweep asgn differs on "
             f"{int((a_k != a_r).any(1).sum())} row(s)")
    if not torch.equal(m_k.view(torch.int64), m_r.view(torch.int64)):
        fin = torch.isfinite(m_k) & torch.isfinite(m_r)
        fail(f"{tag}: sweep margins differ (finite max |err| "
             f"{float((m_k[fin] - m_r[fin]).abs().max()):.3e})")
    return (a_r, m_r), plain


def _time_sweeps(args, P, max_n: int, plain: float) -> dict:
    """The sweep kernel's ms per launch (CUDA events, 5 launches); us per
    step of the longest row, counted as PR 2 counted it (both sweeps' live
    steps) and as the kernel runs it (its active steps, the warp loop's
    trip count); with the plain version's ms and the bound on these
    inputs."""
    from classpro_tpu_torch import kernels

    ms = _time_cuda(lambda: kernels.unrel_sweeps(*args, P), 5)
    bnd = _unrel_bound(args, P, max_n)
    act = int(_active_steps(args).max())
    live = 2 * int(args[7].sum(1).max())
    return {"ms": ms, "plain_ms": plain, "bound": bnd,
            "longest_live_steps": live, "longest_active_steps": act,
            "us_per_step": ms * 1e3 / max(live, 1),
            "us_per_active_step": ms * 1e3 / max(act, 1)}


def _active_steps(args):
    """Active steps per row (both sweeps): live, index in [0, N), not a
    reliable interval fixed at H/D."""
    is_rel, asgn, live, n = args[0], args[1], args[7], args[8]
    N = asgn.shape[1]
    cols = torch.arange(N, device=asgn.device)[None, :]
    fixed = is_rel & (cols < n[:, None]) & ((asgn == 2) | (asgn == 3))
    tot = 0
    for xs in (args[5], args[6]):
        ok = live & (xs >= 0) & (xs < N)
        tot = tot + (ok & ~torch.gather(fixed, 1,
                                        xs.clamp(0, N - 1).long())).sum(1)
    return tot


def _long_row_chunk(gm):
    """256 synthetic rows of up to 1100 intervals (the tests'
    random_sweep_inputs, numpy from seed 5) on the card."""
    from classpro_tpu_torch.params import build_pipeline_params

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_torch_unrel_shim import random_sweep_inputs

    cpu = build_pipeline_params(gm, "cpu")
    return [t.to(DEV) for t in random_sweep_inputs(5, cpu.rel, B=256,
                                                   N=1100)]


def _alldev_chunks():
    """Every medium chunk as the all-device path runs it on the card, up
    to the sweeps' inputs: a dict of the engine's params, the pack and its
    dims, the unpacked planes, K1's outputs and the sweep arguments."""
    from classpro_tpu_torch import alldev
    from classpro_tpu_torch import rel as rel_mod
    from classpro_tpu_torch.engine import TorchEngine

    dev = torch.device(DEV)
    gm, seqs, profs = _model("medium")
    eng = TorchEngine(gm, device=dev, alldev=True)
    PP = eng.PP
    for fb, ib, dims in _alldev_packs(eng, seqs, profs):
        fb_d = torch.from_numpy(fb).to(dev)
        ib_d = torch.from_numpy(ib).to(dev)
        U = alldev.unpack(fb_d, ib_d, *dims)
        planes = alldev.dp_planes(U, PP.rel)
        asgn8, _mm, rescue = rel_mod.rel_pipeline(planes, PP.rel, dims[3],
                                                  "cuda")
        yield {"PP": PP, "gm": gm, "fb": fb, "ib": ib, "fb_d": fb_d,
               "ib_d": ib_d, "dims": dims, "U": U, "planes": planes,
               "asgn8": asgn8, "rescue": rescue,
               "args": _k6(U, asgn8, rescue, PP.rel, dims)}


def _glue_alldev(tag, fb_d, ib_d, P, dims) -> dict:
    """rel_prep (all-device layout), the DP's first pass with its rescue
    tail and rel_settle against their plain versions on one chunk, bit
    for bit, the rescue tail and rel_settle on the kernel chain's own DP
    passes; returns each kernel's arguments, bounds and, under "err",
    largest difference."""
    from classpro_tpu_torch import alldev, kernels
    from classpro_tpu_torch.rel import rescue_rows

    Bn, max_n, R2, max_m = dims
    R = R2 // 2
    planes, cov, un = kernels.rel_prep(fb_d, ib_d, P, R, max_m, (Bn, max_n))
    p_r, c_r, un_r = alldev.prep_ref(fb_d, ib_d, P, R, max_m, Bn, max_n)
    err = {"rel_prep": max(
        [_same(tag, f"rel_prep (alldev) output {k}", a, b)
         for k, (a, b) in enumerate(zip(planes + (cov,), p_r + (c_r,)))]
        + [_same(tag, f"rel_prep (alldev) {k}", un[k], un_r[k])
           for k in un])}
    asgn1, _, mm1, rescue, cov2 = kernels.rel_dp_rescue(*planes, cov, P)
    r_r, c_r = rescue_rows(planes, asgn1, P, max_m)
    err["rel_rescue"] = max(_same(tag, "the rescue tail's rescue", rescue,
                                  r_r),
                            _same(tag, "the rescue tail's cov2", cov2, c_r))
    asgn2, _, mm2 = kernels.rel_dp(*planes, cov2, P, active=rescue)
    V = kernels.blob_views(fb_d, ib_d, *dims)
    sargs = (asgn1, asgn2, mm1, mm2, rescue, planes, V["rel_rows"],
             V["rel_cols"], P)
    got = (un["asgn"].clone(), un["gate"].clone())
    want = (un["asgn"].clone(), un["gate"].clone())
    kernels.rel_settle(*sargs, *got)
    alldev.settle_ref(*sargs, *want)
    err["rel_settle"] = max(
        _same(tag, "rel_settle's sweep assignments", got[0], want[0]),
        _same(tag, "rel_settle's margin gate", got[1], want[1]))
    live = int(planes[7].sum())
    UN, cells = Bn * max_n, R2 * max_m
    return {
        "rel_prep": (fb_d, ib_d, P, R, max_m, (Bn, max_n)),
        "rel_settle": sargs + got, "fresh": (un["asgn"], un["gate"]),
        "flagged": int(torch.isinf(got[1][0]).sum()), "err": err,
        "bounds": {
            "rel_prep": _bound(
                5 * cells * 4 + 3 * R2 * 4 + 2 * cells * 8 + 8 * UN * 4
                + 5 * UN * 8 + 32 + cells * 6 * 8 + R2 * (8 + 8 + 1 + 32)
                + UN * (13 * 8 + 6 * 8 + 2 + 4) + 2 * Bn * 8,
                cells * OPS_PREP_CELL + UN * OPS_PREP_UN_CELL),
            "rel_settle": _bound(
                live * (1 + 4 * 8) + live // 2 * (4 + 4)
                + R2 * (8 + 8 + 1 + 8 + 1) + R * 4 + 32,
                live * OPS_SETTLE_CELL)}}


def _parent_kernels(parent: str) -> dict:
    """The launch entries of the checkout ``parent`` (an earlier commit of
    this repository): its classpro_tpu_torch/csrc/rel_dp.cu, glue.cu and
    unrel.cu built with this tree's nvcc flags into libraries of their
    own, all at once.  A tree with the DP kernel's prologue
    (rel_dp_first_kernel in its build log) is bound with this tree's
    argument lists; a tree before it (rel_prep_main_kernel in its glue
    library) with those of then (PRE_PROLOGUE_ARGTYPES), its rel_settle
    with this tree's; its sweep kernel with this tree's where it has the
    gate tail (unrel_gate_kernel), else with PRE_GATE_ARGTYPES.  Returns
    {"fns": name -> C launch entry, "prologue": bool, "gate": bool}."""
    from classpro_tpu_torch import kernels

    csrc = os.path.join(parent, "classpro_tpu_torch", "csrc")
    out = os.path.join(HERE, "classpro_tpu_torch", "_build")
    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    procs = {src: subprocess.Popen(
        [kernels._nvcc()] + kernels.NVCC_FLAGS
        + ["-I", csrc, os.path.join(csrc, src), "-o",
           os.path.join(out, f"lib{src[:-3]}_parent.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("rel_dp.cu", "glue.cu", "unrel.cu")}
    logs = {src: p.communicate()[0] for src, p in procs.items()}
    for src, p in procs.items():
        if p.returncode != 0:
            fail(f"nvcc failed on the parent's {src}:\n{logs[src]}")
    libs = {src: ctypes.CDLL(os.path.join(out, f"lib{src[:-3]}_parent.so"))
            for src in procs}
    prologue = "rel_dp_first_kernel" in logs["rel_dp.cu"]
    if not prologue and "rel_prep_main_kernel" not in logs["glue.cu"]:
        fail(f"--parent {parent}: neither the DP kernel's prologue nor "
             f"rel_prep's main layout in its build")
    gate = "unrel_gate_kernel" in logs["unrel.cu"]
    argtypes = kernels._ARGTYPES if prologue else dict(
        kernels._ARGTYPES, **PRE_PROLOGUE_ARGTYPES)
    if not gate:
        argtypes = dict(argtypes, unrel_sweeps=PRE_GATE_ARGTYPES)
    entries = (("rel_dp", "rel_dp.cu", ("rel_dp_kernel",)
                + (("rel_dp_first_kernel",) if prologue else ())),
               ("rel_prep", "glue.cu", ("rel_prep_alldev_kernel",)
                + (() if prologue else ("rel_prep_main_kernel",))),
               ("rel_settle", "glue.cu", ("rel_settle_kernel",)),
               ("unrel_sweeps", "unrel.cu", ("unrel_kernel",)
                + (("unrel_gate_kernel",) if gate else ())))
    fns = {}
    for name, src, names in entries:
        fn = getattr(libs[src], kernels._ENTRY[(name, "cuda")])
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes[name] + [ctypes.c_void_p]
        fns[name] = fn
        for entry in names:
            res = ptxas_resources(logs[src], entry)
            say(f"build: parent {entry} {json.dumps(res)}")
    say(f"build: nvcc {parent}'s rel_dp.cu, glue.cu and unrel.cu "
        f"{time.time() - t0:.1f} s ({'with' if prologue else 'before'} the "
        f"DP kernel's prologue, {'with' if gate else 'before'} the sweep "
        f"kernel's gate tail)")
    return {"fns": fns, "prologue": prologue, "gate": gate}


def _time_parent(g: dict, name: str, args, par: dict, fresh,
                 tag: str) -> None:
    """The parent's kernel ``name`` (its C launch entry in ``par``) on
    this chunk's arguments: its outputs against this tree's kernel's, bit
    for bit (rel_settle into copies of ``fresh``, the sweeps' assignment
    rows and gate as rel_prep left them), then both timed in turns
    (parent, this tree, this tree, parent; ms per launch, ``_graph_ms``),
    appended to g["ab"].  A rel_prep from before the prologue takes the
    argument list of then (lf_bcnt null, the all-device layout flag 1)."""
    from classpro_tpu_torch import kernels

    wrapper = getattr(kernels, name)
    fn = par["fns"][name]

    def parent(*a):
        if name == "rel_prep":
            cargs, planes, cov, un = kernels._prep_args(*a)
            if not par["prologue"]:
                cargs = cargs[:19] + [None] + cargs[19:] + [1]
            out = planes + (cov,) + tuple(un[k] for k in sorted(un))
        else:
            cargs, out = kernels._settle_args(*a), a[-2:]
        err = fn(*cargs, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"parent {name} launch failed: CUDA error {err}")
        return out

    if name == "rel_prep":
        planes, cov, un = wrapper(*args)
        mine = planes + (cov,) + tuple(un[k] for k in sorted(un))
        theirs = parent(*args)
    else:
        mine = args[-2:]
        theirs = parent(*args[:-2], *(t.clone() for t in fresh))
    for k, (a, b) in enumerate(zip(theirs, mine)):
        _same(tag, f"the parent's {name} output {k} against this tree's",
              a, b)
    ab = [_graph_ms(lambda: parent(*args), 20),
          _graph_ms(lambda: wrapper(*args), 20),
          _graph_ms(lambda: wrapper(*args), 20),
          _graph_ms(lambda: parent(*args), 20)]
    g.setdefault("ab", []).append(ab)
    say(f"  {name}: parent {ab[0]:.4f}, {ab[3]:.4f} ms per launch, this "
        f"tree {ab[1]:.4f}, {ab[2]:.4f} (in turns); the parent's outputs "
        f"bit-equal to this tree's")


def _planted_gates(mm):
    """Margin gates (2, B) planted at each read's margin m, each with lo <=
    hi as rel_settle writes them: open; unflagged (lo, hi); [m, m]; one
    ulp above m to inf; -inf to one ulp below m; [lo, max(m, lo)]; [min(m,
    hi), hi] (a sweep's margin cannot be chosen, so the unflagged gate's
    edges, the smallest positive double and the double below 1e-5, are
    held at the margins the chunk has, at equality and one ulp off)."""
    from classpro_tpu_torch.kernels import GATE_UNFLAGGED

    inf = float("inf")
    full = lambda v: torch.full_like(mm, v)
    lo, hi = full(GATE_UNFLAGGED[0]), full(GATE_UNFLAGGED[1])
    return [torch.stack(g) for g in (
        (full(-inf), full(inf)), (lo, hi), (mm, mm),
        (torch.nextafter(mm, full(inf)), full(inf)),
        (full(-inf), torch.nextafter(mm, full(-inf))),
        (lo, torch.maximum(mm, lo)), (torch.minimum(mm, hi), hi))]


def _check_gate_tail(tag, args, P, plain, gates) -> int:
    """The sweep kernel with its gate tail on each of ``gates`` against
    the plain sweeps' (asgn, margin) ``plain`` and alldev.gate_ref, every
    byte of the packed rows and every bit of the margins.  Returns the
    flags set over all gates."""
    from classpro_tpu_torch import alldev, kernels

    flagged = 0
    for k, gate in enumerate(gates):
        packed, mm = kernels.unrel_sweeps(*args, P, gate=gate)
        want = alldev.gate_ref(*plain, gate)
        if not torch.equal(packed, want):
            bad = int((packed != want).any(1).sum())
            fail(f"{tag}: the gate tail's packed rows differ from the plain "
                 f"clamp == + cat on {bad} row(s) (gate {k})")
        _same(tag, "the gate tail launch's margins", mm, plain[1])
        flagged += int(packed[:, -1].sum())
    return flagged


def _time_gate_tail(rec: dict, args, P, gate, par, tag: str) -> None:
    """The sweep kernel with and without its gate tail, ms per launch in a
    CUDA graph of 20 launches (``_graph_ms``), in turns (without, with,
    with, without), appended to rec; with ``par`` (the parent's launch
    entries) the parent's sweep kernel on the same inputs, its outputs
    bit-equal to this tree's launch without the tail, timed in turns with
    this tree's with the tail (parent, this tree, this tree, parent)."""
    from classpro_tpu_torch import kernels

    tail = lambda: kernels.unrel_sweeps(*args, P, gate=gate)
    bare = lambda: kernels.unrel_sweeps(*args, P)
    ab = [_graph_ms(bare, 20), _graph_ms(tail, 20), _graph_ms(tail, 20),
          _graph_ms(bare, 20)]
    rec.setdefault("tail_ab", []).append(ab)
    say(f"  sweep kernel in a CUDA graph: without its gate tail {ab[0]:.4f}, "
        f"{ab[3]:.4f} ms per launch, with it {ab[1]:.4f}, {ab[2]:.4f} (in "
        f"turns)")
    if par is None:
        return
    fn = par["fns"]["unrel_sweeps"]
    dev = args[1].device

    def parent():
        cargs, out, mm, scratch = kernels._unrel_args(
            tuple(args[:8]), args[8], P, dev, "cuda")
        if not par["gate"]:
            cargs = cargs[:9] + cargs[10:]       # no gate argument then
        err = fn(*cargs, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"parent unrel_sweeps launch failed: CUDA error {err}")
        return out, mm, scratch

    theirs = parent()
    mine = bare()
    for what, a, b in (("rows", theirs[0], mine[0]),
                       ("margins", theirs[1], mine[1])):
        _same(tag, f"the parent's sweep kernel's {what} against this "
              f"tree's", a, b)
    pab = [_graph_ms(parent, 20), _graph_ms(tail, 20), _graph_ms(tail, 20),
           _graph_ms(parent, 20)]
    rec.setdefault("parent_ab", []).append(pab)
    say(f"  sweep kernel: the parent's {pab[0]:.4f}, {pab[3]:.4f} ms per "
        f"launch, this tree's with its gate tail {pab[1]:.4f}, {pab[2]:.4f} "
        f"(in turns); the parent's outputs bit-equal to this tree's")


def _graph_alldev(tag, fb_d, ib_d, PP, dims) -> dict:
    """The chunk's CUDA graph (an alldev.BatchGraph of its own, captured
    here) against the eager launches and the plain glue, every byte: its
    replay's packed output == alldev.classify_glued's five launches,
    eagerly == the plain glue around the DP and sweep kernels
    (classify_batch with impl=(rel_dp, unrel_sweeps), pack_flags); the
    capture counts nothing but its eager run, each replay the five
    launches (BATCH_LAUNCHES); a blob of another shape is refused.  Then
    the replay's ms per chunk (CUDA events around 20 replays) beside the
    eager launches' (CUDA events around 20 calls: what the card waits for
    when the host launches them one by one).  Returns the times and the
    memory the capture reserved."""
    from classpro_tpu_torch import alldev, kernels

    torch.cuda.synchronize()
    r0, c0 = torch.cuda.memory_reserved(), _counts()
    g = alldev.BatchGraph(PP, *dims)
    c1 = _counts()
    got = g.run(fb_d, ib_d).clone()
    c2 = _counts()
    reserved = torch.cuda.memory_reserved() - r0
    eager = alldev.classify_glued(fb_d, ib_d, PP, *dims, kernels)
    plain = alldev.pack_flags(*alldev.classify_batch(
        fb_d, ib_d, PP, *dims, impl=(kernels.rel_dp, kernels.unrel_sweeps)))
    torch.cuda.synchronize()
    want_cap = dict(BATCH_LAUNCHES, **{"batch.captures": 1})
    want_rep = dict(BATCH_LAUNCHES, **{"batch.replays": 1})
    if _delta(c0, c1) != want_cap or _delta(c1, c2) != want_rep:
        fail(f"{tag}: the batch graph's capture counted {_delta(c0, c1)} "
             f"(want {want_cap}, its eager run), its replay "
             f"{_delta(c1, c2)} (want {want_rep})")
    for what, other in (("the eager launches'", eager),
                        ("the plain glue's around the DP and sweep kernels",
                         plain)):
        if not torch.equal(got, other):
            bad = int((got != other).any(1).sum())
            fail(f"{tag}: the batch graph replay's packed output differs "
                 f"from {what} on {bad} row(s)")
    try:
        g.run(fb_d[:-1], ib_d)
    except ValueError:
        pass
    else:
        fail(f"{tag}: the batch graph took a blob of another shape")
    replay = _time_cuda(g.replay, 20)
    eager_ms = _time_cuda(lambda: alldev.classify_glued(
        fb_d, ib_d, PP, *dims, kernels), 20)
    del g
    return {"replay_ms": replay, "eager_ms": eager_ms,
            "capture_reserved_bytes": reserved,
            "flagged": int(got[:, -1].sum())}


def phase_alldev(parent: dict | None = None):
    """Sweep kernel vs plain, the all-device glue kernels vs plain and
    classify_batch kernels vs plain on every medium chunk, and the sweep
    kernel on a long-row chunk, with times and bounds; with ``parent``
    (the launch entries of an earlier commit, ``_parent_kernels``), its
    rel_prep and rel_settle against this tree's on every chunk, timed in
    turns.  Returns the record."""
    from classpro_tpu_torch import alldev, kernels

    rec = {"max_abs_err": 0.0, "chunks": [], "glue": {}, "glue_err": {},
           "gate": {}}
    plains = {"rel_prep": lambda fb, ib, P, R, M, ad: alldev.prep_ref(
        fb, ib, P, R, M, *ad), "rel_settle": alldev.settle_ref}
    for k, c in enumerate(_alldev_chunks()):
        PP, fb, ib, fb_d, ib_d, dims = (c[x] for x in ("PP", "fb", "ib",
                                                       "fb_d", "ib_d",
                                                       "dims"))
        U, planes, asgn8, rescue, args = (c[x] for x in (
            "U", "planes", "asgn8", "rescue", "args"))
        Bn, max_n, R2, max_m = dims
        tag = f"medium alldev chunk {k} (Bn={Bn}, max_n={max_n}, " \
              f"R2={R2}, max_m={max_m})"
        (a_r, m_r), plain = _compare_sweeps(tag, args, PP.unrel)
        # the whole program with the kernels against the plain versions
        o_k, f_k = alldev.classify_batch(fb_d, ib_d, PP, *dims, impl="cuda")
        t0 = time.perf_counter()
        o_r, f_r = alldev.classify_batch(fb_d, ib_d, PP, *dims, impl="ref")
        torch.cuda.synchronize()
        k7_plain = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(o_k, o_r) and torch.equal(f_k, f_r)):
            fail(f"{tag}: classify_batch with the kernels differs from "
                 f"the plain versions")
        changed = int((a_r.to(torch.int32) != args[1]).sum())
        gargs = _glue_alldev(tag, fb_d, ib_d, PP.rel, dims)
        for name, e in gargs["err"].items():
            rec["glue_err"][name] = max(rec["glue_err"].get(name, 0.0), e)
        gate = gargs["rel_settle"][-1]
        tail_flags = _check_gate_tail(tag, args, PP.unrel, (a_r, m_r),
                                      [gate] + _planted_gates(m_r))
        kg = _graph_alldev(tag, fb_d, ib_d, PP, dims)
        say(f"kernel == plain: {tag}: sweeps bit-equal on {Bn} rows "
            f"({changed} intervals decided by the sweeps), rel_prep, K1's "
            f"rescue tail and rel_settle bit-equal ({gargs['flagged']} reads "
            f"with a risky rel margin), the sweeps' gate tail == the plain "
            f"clamp == + cat on the chunk's gate and 7 planted gates "
            f"({tail_flags} flags set), classify_batch equal "
            f"({int(f_k.sum())} flagged); the batch graph replay == the "
            f"eager launches == the plain glue, every byte")
        for name in ("rel_prep", "rel_settle"):
            _time_glue(rec["glue"], name, gargs[name], plains[name],
                       gargs["bounds"][name])
            g = rec["glue"][name]
            g["geometry"] = (
                kernels.glue_geometry(name, R2 * max_m, n2=Bn * max_n)
                if name == "rel_prep"
                else kernels.glue_geometry(name, R2 // 2, n2=max_m))
            say(f"  {name}: {g['ms'][-1]:.4f} ms per launch on the card "
                f"({g['call_ms'][-1]:.4f} ms per wrapper call), plain torch "
                f"{g['plain_ms'][-1]:.3f} ms, bound "
                f"{g['bound'][-1]['ms']:.6f} ms ({g['bound'][-1]['by']}, "
                f"{g['bound'][-1]['bytes']} B), geometry "
                f"{json.dumps(g['geometry'])}")
            if parent is not None:
                _time_parent(g, name, gargs[name], parent, gargs["fresh"],
                             tag)
        sw = _time_sweeps(args, PP.unrel, max_n, plain)
        _time_gate_tail(rec["gate"], args, PP.unrel, gate, parent, tag)
        bnd = sw["bound"]
        k6 = _time_cuda(lambda: _k6(U, asgn8, rescue, PP.rel, dims), 10)
        k7 = kg["replay_ms"]
        k6b = _k6_bound(fb, ib, dims)
        dpb = _bound_ms(planes, PP.rel.gcov[None, :].expand(
            R2, 4).contiguous(), PP.rel)
        k7b_bytes = fb.nbytes + ib.nbytes + Bn * max_n + Bn \
            + dpb["records"] * 40 + bnd["records"] * 40 + bnd["tails"] * 8
        k7b_ops = dpb["steps"] * OPS_PER_STEP + bnd["ops"]
        k7b = max(k7b_bytes / PEAK_BYTES, k7b_ops / PEAK_F64) * 1e3
        ch = dict(sw, dims=list(dims), k6_ms=k6, k6_bound=k6b, k7_ms=k7,
                  k7_eager_ms=kg["eager_ms"],
                  k7_capture_reserved_bytes=kg["capture_reserved_bytes"],
                  k7_plain_ms=k7_plain, k7_bound_ms=k7b,
                  k7_bound_by="bytes" if k7b_bytes / PEAK_BYTES
                  >= k7b_ops / PEAK_F64 else "operations")
        rec["chunks"].append(ch)
        say(f"  sweep kernel {sw['ms']:.3f} ms per launch "
            f"({sw['us_per_step']:.2f} us per live step of the longest "
            f"row, {sw['longest_live_steps']} live steps; "
            f"{sw['us_per_active_step']:.2f} us per active step, "
            f"{sw['longest_active_steps']}), plain torch "
            f"{sw['plain_ms']:.1f} ms, bound {bnd['ms']:.6f} ms "
            f"({bnd['by']}; bytes {bnd['bytes_ms']:.6f} ms with "
            f"{bnd['records']} Skellam records and {bnd['tails']} tails, "
            f"operations {bnd['ops_ms']:.6f} ms for {bnd['steps']} active "
            f"steps); K6 glue {k6:.3f} ms (bound {k6b['ms']:.6f} ms, "
            f"bytes); the chunk's graph replay {k7:.4f} ms per chunk "
            f"(five launches called eagerly {kg['eager_ms']:.4f}; the "
            f"capture reserved {kg['capture_reserved_bytes']} B), plain "
            f"{k7_plain:.1f} ms, bound {k7b:.6f} ms ({ch['k7_bound_by']})")
    rec["geometry"] = kernels.unrel_geometry(Bn, max_n)
    # a long-row chunk: the rows' state in the global scratch
    args = _long_row_chunk(c["gm"])
    B, N = args[1].shape
    tag = f"long-row chunk (B={B}, N={N})"
    lr_plain, plain = _compare_sweeps(tag, args, PP.unrel)
    gates = _planted_gates(lr_plain[1])
    _check_gate_tail(tag, args, PP.unrel, lr_plain, gates)
    lr = _time_sweeps(args, PP.unrel, N, plain)
    lr["gate"] = {}
    _time_gate_tail(lr["gate"], args, PP.unrel, gates[1], parent, tag)
    lr.update(B=B, N=N, geometry=kernels.unrel_geometry(B, N))
    rec["long_row"] = lr
    say(f"kernel == plain: long-row chunk (B={B}, N={N}, launch geometry "
        f"{json.dumps(lr['geometry'])}): bit-equal, the gate tail on 7 "
        f"planted gates every byte; {lr['ms']:.3f} ms per "
        f"launch ({lr['us_per_step']:.2f} us per live step, "
        f"{lr['longest_live_steps']}; {lr['us_per_active_step']:.2f} us per "
        f"active step, {lr['longest_active_steps']}), plain torch "
        f"{lr['plain_ms']:.1f} ms, bound {lr['bound']['ms']:.6f} ms "
        f"({lr['bound']['by']})")
    say(f"  launch geometry at the medium shapes {json.dumps(rec['geometry'])}")
    return rec


def _read_records(fx: str):
    from classpro_tpu_torch.io.fastx import read_fastx

    return list(read_fastx(os.path.join(FIX, fx, "reads.fasta.gz")))


def phase_alldev_e2e():
    """TorchEngine(alldev=True) over tiny and medium: golden bytes; both
    kernels launched by that run."""
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.io.classfile import class_header

    _reset_launches()
    for fx in ("tiny", "medium"):
        gm, seqs, profs = _model(fx)
        reads = _read_records(fx)
        t0 = time.time()
        eng = TorchEngine(gm, device=DEV, alldev=True)
        chunks = [(seqs[lo:lo + 200], profs[lo:lo + 200])
                  for lo in range(0, len(seqs), 200)]
        classes = [c for out in eng.classify_stream(iter(chunks),
                                                    sort_window=8)
                   for c in out]
        text = "".join(f"{class_header(r.name, r.comment)}\n{r.seq}\n+\n"
                       f"{c}\n" for r, c in zip(reads, classes)).encode()
        with gzip.open(os.path.join(FIX, fx, "golden.class.gz"), "rb") as f:
            if text != f.read():
                fail(f"alldev e2e {fx}: .class differs from golden.class.gz")
        say(f"alldev e2e {fx}: byte-identical to golden ({len(text)} bytes, "
            f"{time.time() - t0:.2f} s incl. set-up, guard_flagged "
            f"{eng.guard_flagged})")
    launches = _path_launches("alldev path", ALLDEV_PATH, ALLDEV_TAILS,
                              "batch_graphs")
    if launches["tails"]["rel_pack"] or launches["tails"]["prologue"]:
        fail("alldev path ran the DP kernel's pack tail or prologue")
    say(f"alldev e2e launches: {launches}")
    return launches


# what one replay of an all-device chunk's graph (and one capture's eager
# run) adds to the launch counts: its five launches, the first DP pass
# with its rescue tail, the sweeps with their gate tail
BATCH_LAUNCHES = {"rel_prep": 1, "rel_dp": 2, "rel_settle": 1,
                  "unrel_sweeps": 1, "tails.rel_rescue": 1, "tails.gate": 1}


def _alldev_clocks(eng, acc: dict) -> list:
    """Clock the all-device path's stages of ``eng`` into ``acc``
    (``_clock``; the feed's two C++ entries on ``eng.wall``, or whatever
    stands in their place); returns the undos."""
    undo = [_clock(eng, n, acc) for n in ("_stage", "_submit",
                                          "_device_stage", "_finish",
                                          "_exact_alldev")]
    return undo + [_clock(eng.wall, n, acc)
                   for n in ("pack_chunk", "expand_rows")]


def _alldev_host_s(acc: dict, wall: float, feed: str = "cpp") -> dict:
    """The main thread's seconds by stage of an all-device run of
    ``wall`` seconds (``_alldev_clocks``), each without the stages nested
    in it; ``feed`` names the feed's stages (the C++ entries, or with
    "numpy" the plain versions swapped in by ``_numpy_feed``)."""
    a = lambda k: acc.get(k, 0.0)             # noqa: E731
    enqueue = a("_submit") - a("_stage") - a("pack_chunk")
    return {"wall_stage_cpp": a("_stage"),
            f"pack_chunk_{feed}": a("pack_chunk"),
            "device_stage_enqueue": a("_device_stage"),
            "pin_h2d_d2h_other_enqueue": enqueue - a("_device_stage"),
            "wait_device": a("_finish") - a("expand_rows")
            - a("_exact_alldev"),
            ("expand_cpp" if feed == "cpp" else "expand_asgn_numpy"):
                a("expand_rows"),
            "exact_guard": a("_exact_alldev"),
            "other": wall - a("_submit") - a("_finish")}


# the all-device feed alone, per chunk, in turns: numpy pack_chunk /
# expand_asgn (the plain versions) and the C++ entries at 8 and 1 workers
FEED_TURNS = ("numpy", "cpp_t8", "cpp_t1", "cpp_t1", "cpp_t8", "numpy")


def _feed_chunks(S, held: list) -> list:
    """The all-device stream's chunks over the warm-up's passes (so
    every batch it composes), as its feed saw them: copies of the slab
    rows, n_out, n_rel, plens, rows, the C++ pack, and the device result's
    assignment columns with the class lines' offsets; each chunk's
    staging slot held against a fresh pack (``_hold_slots``, into
    ``held``)."""
    import numpy as np

    wall, recs = S.eng.wall, []
    pack, expand = wall.pack_chunk, wall.expand_rows

    def rec_pack(slab, slot, n_out, n_rel, plens, rows, threads=0, **dest):
        got = pack(slab, slot, n_out, n_rel, plens, rows, threads=threads,
                   **dest)
        recs.append({"slab": slab[: len(n_out) * slot].copy(), "slot": slot,
                     "n_out": n_out.copy(), "n_rel": n_rel.copy(),
                     "plens": plens.copy(), "rows": rows.copy(),
                     "pack": (got[0].copy(), got[1].copy(), got[2])})
        return got

    def rec_expand(slab, slot, n_out, rows, asgn, out_off, threads=0):
        c = next(c for c in recs if "asgn" not in c)   # chunks finish in order
        if not np.array_equal(c["rows"], rows):
            fail("alldev feed: a chunk was expanded out of its order")
        c["asgn"], c["out_off"] = asgn.copy(), out_off.copy()
        return expand(slab, slot, n_out, rows, asgn, out_off,
                      threads=threads)

    wall.pack_chunk, wall.expand_rows = rec_pack, rec_expand
    undo = _hold_slots(S.eng, True, "alldev stream", held)
    try:
        S.run(S.warm_passes)
    finally:
        undo()
        del wall.pack_chunk, wall.expand_rows
    return recs


def _time_feed(S) -> dict:
    """The feed alone on every chunk of ``_feed_chunks``: the C++ blobs
    (the stream's own and again at T = 8 and T = 1) held against numpy
    pack_chunk bit for bit and the C++ class lines against expand_asgn
    byte for byte, then each stage timed per chunk in FEED_TURNS."""
    import numpy as np

    from classpro_tpu_torch.pack import expand_asgn

    wall, K = S.eng.wall, S.eng.gm.kmer
    held: list = []
    chunks = _feed_chunks(S, held)
    if not chunks or any("asgn" not in c for c in chunks):
        fail("alldev feed: a chunk was packed but not expanded")
    for k, c in enumerate(chunks):
        args = (c["slab"], c["slot"], c["n_out"])
        c["meta"] = _numpy_pack(f"alldev feed chunk {k}", *args, c["plens"],
                                c["rows"], c["pack"])[3]
        res = [None] * len(c["n_out"])
        expand_asgn(c["asgn"], c["meta"], res, K)
        want = "".join(res[r] for r in c["rows"]).encode("ascii")
        for T in (8, 1):
            _numpy_pack(f"alldev feed chunk {k} at T={T}", *args,
                        c["plens"], c["rows"], wall.pack_chunk(
                            *args, c["n_rel"], c["plens"], c["rows"],
                            threads=T))
            if wall.expand_rows(*args, c["rows"], c["asgn"], c["out_off"],
                                threads=T).tobytes() != want:
                fail(f"alldev feed chunk {k}: the C++ class lines at T={T} "
                     f"differ from expand_asgn's")

    def pack(kind, c):
        if kind == "numpy":
            from classpro_tpu_torch.pack import pack_chunk
            pack_chunk([int(r) for r in c["rows"]],
                       _ivs(c["slab"], c["slot"], c["n_out"]), c["plens"])
        else:
            wall.pack_chunk(c["slab"], c["slot"], c["n_out"], c["n_rel"],
                            c["plens"], c["rows"], threads=int(kind[-1]))

    def expand(kind, c):
        if kind == "numpy":
            expand_asgn(c["asgn"], c["meta"], [None] * len(c["n_out"]), K)
        else:
            wall.expand_rows(c["slab"], c["slot"], c["n_out"], c["rows"],
                             c["asgn"], c["out_off"], threads=int(kind[-1]))

    rec = {"chunks": len(chunks), "dims": [list(c["pack"][2])
                                           for c in chunks],
           "slots_held": {"chunks": len(held), "slots": len(set(held)),
                          "pool_allocs": S.eng.staging.allocs},
           "turns": list(FEED_TURNS), "pack_ms": [], "expand_ms": []}
    for kind in FEED_TURNS:
        for stage, fn in (("pack_ms", pack), ("expand_ms", expand)):
            ms = []
            for c in chunks:
                t = time.perf_counter()
                fn(kind, c)
                ms.append((time.perf_counter() - t) * 1e3)
            rec[stage].append(ms)
    for stage in ("pack_ms", "expand_ms"):
        rec[stage + "_median"] = {
            kind: statistics.median(x for t, ms in zip(FEED_TURNS,
                                                       rec[stage])
                                    if t == kind for x in ms)
            for kind in dict.fromkeys(FEED_TURNS)}
    return rec


# one checkout's all-device stream over medium, as a process of its own
# (that tree's package first on its path): a warm-up of one sort window,
# then TREE_RUNS timed runs of argv[2] passes, every chunk checked against
# the golden; the feed's seconds (the C++ entries on NativeWall, or in a
# tree before them numpy pack_chunk / expand_asgn in the engine module);
# prints one JSON line
TREE_RUNS = 3
_TREE_ALLDEV = _FEED_CLOCK + r"""
import gzip, json, sys, time
import torch
from classpro_tpu_torch import engine as engine_mod
from classpro_tpu_torch.estimation import build_global_model
from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
from classpro_tpu_torch.io.fastx import read_fastx
fx, passes, runs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
gm = build_global_model(load_histogram(fx + "/reads"))
P = open_profiles(fx + "/reads")
seqs = [r.seq for r in read_fastx(fx + "/reads.fasta.gz")]
profs = [P.fetch(i) for i in range(len(seqs))]
with gzip.open(fx + "/golden.class.gz", "rt") as f:
    gold = f.read().splitlines()[3::4]
kmers = sum(len(c) - c.count("N") for c in gold)
eng = engine_mod.TorchEngine(gm, batch_size=200, device="cuda", alldev=True)
acc = {}
def clock(obj, name, key):
    f = getattr(obj, name, None)
    if f is None:
        return
    def g(*a, **kw):
        t = time.perf_counter()
        try:
            return f(*a, **kw)
        finally:
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t
    setattr(obj, name, g)
clock(engine_mod, "pack_chunk", "pack_s")
clock(engine_mod, "expand_asgn", "expand_s")
clock(eng.wall, "pack_chunk", "pack_s")
clock(eng.wall, "expand_rows", "expand_s")
clock(eng, "_stage", "stage_s")
spans = [(lo, min(lo + 200, len(seqs))) for lo in range(0, len(seqs), 200)]
def run(n):
    chunks = ((seqs[lo:hi], profs[lo:hi])
              for _ in range(n) for lo, hi in spans)
    t = time.perf_counter()
    for k, res in enumerate(eng.classify_stream(chunks, sort_window=8)):
        lo, hi = spans[k % len(spans)]
        if res != gold[lo:hi]:
            sys.exit(f"chunk {k} differs from the golden")
    torch.cuda.synchronize()
    return time.perf_counter() - t
run(max(1, -(-8 // len(spans))))
feed = {}
feed_clock(eng, feed, True)
out = []
for _ in range(runs):
    acc.clear()
    feed.clear()
    g0 = eng.guard_flagged
    wall = run(passes)
    out.append({"wall_s": wall, "kmers_per_s": passes * kmers / wall,
                "pack_s": acc.get("pack_s", 0.0),
                "expand_s": acc.get("expand_s", 0.0),
                "stage_s": acc.get("stage_s", 0.0),
                "feed": feed_parts(feed),
                "guard_flagged": eng.guard_flagged - g0})
print(json.dumps({"runs": out}))
"""


def _tree_alldev(tree: str, passes: int) -> dict:
    """``_TREE_ALLDEV`` in checkout ``tree``."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    r = subprocess.run([sys.executable, "-c", _TREE_ALLDEV,
                        os.path.join(FIX, "medium"), str(passes),
                        str(TREE_RUNS)], cwd=tree, env=env,
                       capture_output=True, text=True, timeout=900)
    recs = [json.loads(x) for x in r.stdout.splitlines()
            if x.startswith("{")]
    if r.returncode != 0 or len(recs) != 1:
        fail(f"alldev stream of {tree} failed (rc {r.returncode}): "
             f"{r.stderr[-2000:]}")
    return recs[0]


def phase_alldev_stream(passes: int, turns=TURNS,
                        parent: str | None = None, batch_size: int = 200):
    """The alldev stream over medium in the compositions of the device
    stage (``_medium_stream``) that ``turns`` names, in that order.  After
    a warm-up of each (``_medium_stream``'s warm passes, which capture
    the buckets' graphs; the graphs held and the memory the card's allocator
    reserved before and after it), each turn is a run of ``passes``
    passes that records every kernel's launches, the graphs' replays and
    captures per chunk, the device stage's span on the card per chunk
    (CUDA events on the stream around each graph replay; for the plain
    glue around its classify_batch call), the main thread's enqueue ms
    per chunk and where its time goes, and max_memory_allocated."""
    from classpro_tpu_torch import alldev as alldev_mod
    from classpro_tpu_torch import kernels

    S = _medium_stream(True, batch_size)
    eng = S.eng
    feed_clock, feed_parts = _feed_fns()

    def turn(comp):
        spans: list = []
        acc: dict = {}
        undo = [S.install(S.comps[comp]),
                _span_attr(alldev_mod.BatchGraph, "replay", spans),
                _span_attr(alldev_mod, "classify_batch", spans)]
        undo += _alldev_clocks(eng, acc)
        undo.append(feed_clock(eng, acc, True))
        torch.cuda.reset_peak_memory_stats()
        g0, c0, n0 = eng.guard_flagged, eng.chunks_done, _counts()
        try:
            wall = S.run(passes)
        finally:
            for u in reversed(undo):
                u()
        d = _delta(n0, _counts())
        ms = [a.elapsed_time(b) for a, b in spans]
        chunks = max(eng.chunks_done - c0, 1)
        host = _alldev_host_s(acc, wall)
        enqueue = host["device_stage_enqueue"] \
            + host["pin_h2d_d2h_other_enqueue"]
        return {"composition": comp,
                "kmers_per_s": passes * S.kmers_pass / wall, "wall_s": wall,
                "device_chunks": chunks,
                "launches_per_chunk": {k: d.get(k, 0) / chunks
                                       for k in kernels.LAUNCHES},
                "tails_per_chunk": {k: d.get(f"tails.{k}", 0) / chunks
                                    for k in kernels.TAIL_LAUNCHES},
                "replays_per_chunk": d.get("batch.replays", 0) / chunks,
                "captures": d.get("batch.captures", 0),
                "main_graph_replays": d.get("graphs.replays", 0),
                "span_ms_per_chunk": sum(ms) / chunks,
                "span_ms_min_max": [min(ms), max(ms)] if ms else None,
                "device_busy_share": sum(ms) / 1e3 / wall,
                "enqueue_ms_per_chunk": enqueue * 1e3 / chunks,
                "feed": feed_parts(acc),
                "guard_flagged": eng.guard_flagged - g0,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "host_s": host}

    comps = tuple(dict.fromkeys(turns))
    torch.cuda.synchronize()
    r0, c0 = torch.cuda.memory_reserved(), _counts()
    _warm(S, comps)
    torch.cuda.synchronize()
    warm = {"captures": _delta(c0, _counts()).get("batch.captures", 0),
            "graphs": len(eng._batch_graphs),
            "buckets": sorted(list(k[1:]) for k in eng._batch_graphs._graphs),
            "memory_reserved_before": r0,
            "memory_reserved_after": torch.cuda.memory_reserved()}
    say(f"alldev stream warm-up: {warm['captures']} capture(s), "
        f"{warm['graphs']} graph(s) held, buckets {warm['buckets']}; "
        f"memory_reserved {r0} -> {warm['memory_reserved_after']} B")
    runs = [turn(c) for c in turns]
    for r in runs:
        if r["guard_flagged"]:
            fail(f"alldev stream ({r['composition']}): guard_flagged "
                 f"{r['guard_flagged']} on medium")
        _no_pinning(f"alldev stream ({r['composition']})", r["feed"])
        n = r["device_chunks"] * r["replays_per_chunk"] + r["captures"]
        per = r["launches_per_chunk"]
        if r["composition"] == "kernels" and (
                r["main_graph_replays"] or r["replays_per_chunk"] <= 0
                or any(abs(per[k] * r["device_chunks"] - v * n) > 1e-6
                       for k, v in BATCH_LAUNCHES.items() if k in per)):
            fail(f"alldev stream: the chunk is not one replay of five "
                 f"launches: {json.dumps(r)}")
        say(f"alldev stream {r['composition']}: "
            f"{r['kmers_per_s'] / 1e6:.2f} M k-mers/s ({passes} passes of "
            f"medium), span {r['span_ms_per_chunk']:.3f} ms/chunk on the "
            f"card ({'the graph replay' if r['composition'] == 'kernels'
                     else 'classify_batch'}; min, max "
            f"{r['span_ms_min_max']}), {r['replays_per_chunk']:.2f} replays, "
            f"{r['captures']} captures, launches "
            f"{json.dumps(r['launches_per_chunk'])} per chunk, enqueue "
            f"{r['enqueue_ms_per_chunk']:.3f} ms/chunk, "
            f"max_memory_allocated {r['max_memory_allocated']}; main thread "
            f"s: " + ", ".join(f"{k} {v:.3f}" for k, v in r["host_s"].items())
            + "; " + _feed_line(r["feed"]))
    res = {"passes": passes, "batch_size": batch_size, "warmup": warm,
           "runs": runs}
    for comp in comps:
        mine = [r for r in runs if r["composition"] == comp]
        res[comp] = {k: [r[k] for r in mine] for k in (
            "kmers_per_s", "span_ms_per_chunk", "enqueue_ms_per_chunk",
            "replays_per_chunk")}
    feed = res["feed"] = _time_feed(S)
    say(f"alldev feed alone ({feed['chunks']} chunks, dims {feed['dims']}; "
        f"C++ blobs equal to numpy pack_chunk bit for bit and class lines "
        f"to expand_asgn at T=8 and T=1), median ms per chunk in turns "
        f"{' '.join(FEED_TURNS)}: pack "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    feed["pack_ms_median"].items())
        + "; expand " + ", ".join(f"{k} {v:.3f}" for k, v in
                                  feed["expand_ms_median"].items()))
    h = feed["slots_held"]
    say(f"alldev stream staging: {h['chunks']} chunks' slots equal to a "
        f"fresh pack_chunk bit for bit, {h['slots']} distinct slots, "
        f"{h['pool_allocs']} allocated by the pool in this engine")
    if parent:
        ab = []
        for tree in (parent, HERE, HERE, parent):
            r = _tree_alldev(tree, passes)
            r["tree"] = "parent" if tree == parent else "this"
            ab.append(r)
            for x in r["runs"]:
                say(f"alldev stream of the {r['tree']} tree ({passes} "
                    f"passes of medium, a process of its own): "
                    f"{x['kmers_per_s'] / 1e6:.2f} M k-mers/s, wall stage "
                    f"{x['stage_s']:.4f} s, feed pack {x['pack_s']:.4f} s, "
                    f"expand {x['expand_s']:.4f} s; "
                    + _feed_line(x["feed"]))
                if r["tree"] == "this":
                    _no_pinning("alldev stream of this tree", x["feed"])
        if any(x["guard_flagged"] for r in ab for x in r["runs"]):
            fail("alldev stream: a tree flagged reads on medium")
        res["parent_ab"] = ab
    return res


# ------------------------------------------------------------------ guard
# the guard phase's dataset (devtools.soak.generate): K and coverage of
# the 0.5 Gbp soak, whose DP force-flags a quarter of the reads
GUARD_KMER = 28
GUARD_COV = 83
GUARD_SEED = 11
GUARD_RUNS = 3          # timed runs of the main stream
GUARD_SPOT = 50         # flagged reads held against the exact oracle
# the guard alone, in turns: the plain per-row loop, the batch at the -T
# workers ("batch"), at 4, 2 and 1 ("batch_tN"; one worker is the
# calling thread), and at 1 on a fresh thread per chunk ("cold": its
# Skellam memo starts empty, as a spawned worker's does)
GUARD_TURNS = ("plain", "batch", "batch_t4", "batch_t2", "batch_t1",
               "cold", "cold", "batch_t1", "batch_t2", "batch_t4", "batch",
               "plain")


def _plain_guard(self, st, rel_out) -> None:
    """TorchEngine._exact_guard with the re-decisions as a per-row loop
    of the plain version, ``exact_rel`` (the guard before the batch):
    the guard phase's reference."""
    import numpy as np

    R = rel_out.shape[0]
    mm = st["mm"]
    pos = mm[(mm > 0.0) & np.isfinite(mm)]
    if pos.size:
        self.guard_min_margin = min(self.guard_min_margin, float(pos.min()))
    flagged = st["risky"][:R] | st["risky"][R:]
    if not flagged.any():
        return
    self.guard_flagged += int(flagged.sum())
    _plain_rows(self.wall, st, rel_out, np.nonzero(flagged)[0])


def _plain_rows(wall, st, rel_out, rows) -> None:
    """The per-row loop: rel_out[j] re-decided by ``exact_rel`` for each
    flagged row j that is not padding."""
    import numpy as np

    slab, slot, n_out = st["slab"], st["slot"], st["n_out"]
    live = np.nonzero(st["n_rel"] > 0)[0]
    for j in rows:
        if j >= len(live):
            continue
        i = int(live[j])
        recs = slab[i * slot: i * slot + int(n_out[i])]
        rel_recs = recs[recs["is_rel"] != 0]
        rel_out[j, :len(rel_recs)] = wall.exact_rel(rel_recs,
                                                    int(st["_plens"][i]))


def _guard_data(gbp: float, d: str):
    """The guard dataset in ``d``: (meta, GlobalModel, seqs, profiles)."""
    from classpro_tpu_torch.devtools import soak
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx

    meta = soak.generate(d, gbp, seed=GUARD_SEED, kmer=GUARD_KMER,
                         cov=GUARD_COV)
    root = os.path.join(d, "reads")
    gm = build_global_model(load_histogram(root))
    P = open_profiles(root)
    seqs = [r.seq for r in read_fastx(root + ".fasta")]
    return meta, gm, seqs, [P.fetch(i) for i in range(len(seqs))]


# both streams over the guard dataset from a checkout, as a process of
# its own (that tree's package first on its path): per path a warm-up and
# one timed run, the guard's seconds (the all-device guard is
# _exact_alldev, or _exact_full per read in a tree before the batch);
# prints one JSON line
_TREE_STREAM = _FEED_CLOCK + r"""
import hashlib, json, sys, time
import torch
from classpro_tpu_torch.engine import TorchEngine
from classpro_tpu_torch.estimation import build_global_model
from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
from classpro_tpu_torch.io.fastx import read_fastx
root, runs = sys.argv[1], int(sys.argv[2])
gm = build_global_model(load_histogram(root))
P = open_profiles(root)
seqs = [r.seq for r in read_fastx(root + ".fasta")]
profs = [P.fetch(i) for i in range(len(seqs))]
kmers = sum(len(p) for p in profs)
def stream(alldev):
    eng = TorchEngine(gm, batch_size=200, device="cuda", alldev=alldev)
    name = "_exact_guard"
    if alldev:
        name = ("_exact_alldev" if hasattr(eng, "_exact_alldev")
                else "_exact_full")
    f, acc = getattr(eng, name), [0.0]
    def g(*a):
        t = time.perf_counter()
        try:
            return f(*a)
        finally:
            acc[0] += time.perf_counter() - t
    setattr(eng, name, g)
    def run():
        chunks = ((seqs[lo:lo + 200], profs[lo:lo + 200])
                  for lo in range(0, len(seqs), 200))
        t = time.perf_counter()
        out = [c for o in eng.classify_stream(chunks, sort_window=8)
               for c in o]
        torch.cuda.synchronize()
        return time.perf_counter() - t, out
    run()
    feed = {}
    feed_clock(eng, feed, alldev)
    recs = []
    for _ in range(runs):
        acc[0], g0 = 0.0, eng.guard_flagged
        feed.clear()
        wall, out = run()
        recs.append({"wall_s": wall, "kmers_per_s": kmers / wall,
                     "exact_guard_s": acc[0],
                     "guard_flagged": eng.guard_flagged - g0,
                     "feed": feed_parts(feed)})
        sha = hashlib.sha256("\n".join(out).encode()).hexdigest()
        if recs[0].setdefault("sha256", sha) != sha:
            sys.exit("two runs wrote different bytes")
    return {"runs": recs, "sha256": recs[0]["sha256"]}
rec = stream(False)
rec["alldev"] = stream(True)
print(json.dumps(rec))
"""


def _tree_stream(tree: str, root: str) -> dict:
    """``_TREE_STREAM`` in checkout ``tree`` over the dataset ``root``."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    r = subprocess.run([sys.executable, "-c", _TREE_STREAM, root,
                        str(TREE_RUNS)],
                       cwd=tree, env=env, capture_output=True, text=True,
                       timeout=900)
    recs = [json.loads(x) for x in r.stdout.splitlines()
            if x.startswith("{")]
    if r.returncode != 0 or len(recs) != 1:
        fail(f"guard: the main stream of {tree} failed (rc "
             f"{r.returncode}): {r.stderr[-2000:]}")
    return recs[0]


def _time_guard(wall, chunks, kind: str, T: int) -> dict:
    """The guard's re-decisions of the staged ``chunks`` one way (a
    GUARD_TURNS kind; T the -T workers): the plain per-row loop or one
    batch per chunk; rel_out of each chunk checked against the reference
    byte for byte."""
    import numpy as np

    threads = {"plain": 1, "batch": T, "cold": 1}.get(kind) or int(
        kind.rsplit("t", 1)[1])
    secs = []
    for c in chunks:
        rel_out = c["pre"].copy()
        rows = c["rows"][c["rows"] < len(c["live"])]

        def batch():
            wall.exact_rel_batch(c["slab"], c["slot"], c["n_out"],
                                 c["live"][rows],
                                 c["_plens"][c["live"][rows]], rel_out,
                                 rows, threads=threads)
        t = time.perf_counter()
        if kind == "plain":
            _plain_rows(wall, c, rel_out, c["rows"])
        elif kind == "cold":
            th = threading.Thread(target=batch)
            th.start()
            th.join()
        else:
            batch()
        secs.append(time.perf_counter() - t)
        if not np.array_equal(rel_out, c["post"]):
            fail(f"guard: {kind} re-decisions differ from the reference "
                 f"in rel_out")
    n = sum(len(c["rows"]) for c in chunks)
    return {"kind": kind, "threads": threads, "s": sum(secs),
            "s_per_chunk": sum(secs) / max(len(secs), 1),
            "ms_per_flagged_row": 1e3 * sum(secs) / max(n, 1)}


def phase_guard(gbp: float, parent: str | None, smi: str, d: str) -> dict:
    """The exactness guard at the coverage that flags reads: a dataset of
    ``gbp`` Gbp at K = 28 and 83x (devtools.soak.generate) written into
    ``d`` (the bench phase reuses it), then (a) the
    main stream (a warm-up, a reference run with the guard as the plain
    per-row loop, GUARD_RUNS runs as it ships, a second plain run), every
    chunk's bytes equal to the reference's; (b) the guard alone on the
    reference run's staged chunks, the per-row loop and the batch in
    turns (GUARD_TURNS), rel_out equal; (c) the all-device stream (a
    warm-up, one run), its bytes equal to the main path's; (d)
    GUARD_SPOT flagged reads against the exact oracle; with ``parent``,
    that checkout's streams and this tree's in turns (``_TREE_STREAM``)."""
    import numpy as np

    from classpro_tpu_torch import engine as engine_mod
    from classpro_tpu_torch import native
    from classpro_tpu_torch.exact.pipeline import ReadClassifier

    t0 = time.time()
    meta, gm, seqs, profs = _guard_data(gbp, d)
    gen_s = time.time() - t0
    rec = {"gbp": gbp, "kmer": GUARD_KMER, "cov": GUARD_COV,
           "seed": GUARD_SEED, "reads": meta["n_reads"],
           "kmers": meta["n_kmers"], "gen_s": gen_s,
           "threads": native._threads(0), "cpu_count": os.cpu_count(),
           "card": smi}
    kmers = meta["n_kmers"]
    spans = [(lo, min(lo + 200, len(seqs)))
             for lo in range(0, len(seqs), 200)]

    def chunks():
        return ((seqs[lo:hi], profs[lo:hi]) for lo, hi in spans)

    # (a) the main stream
    eng = engine_mod.TorchEngine(gm, batch_size=200, device=DEV)
    cls = engine_mod.TorchEngine
    staged: list = []
    flagged_reads: list = []

    def reference(self, st, rel_out):
        """_plain_guard, keeping the chunk's guard inputs and
        outputs and the flagged reads for (b) and (d)."""
        R = rel_out.shape[0]
        rows = np.nonzero(st["risky"][:R] | st["risky"][R:])[0]
        pre = rel_out.copy()
        _plain_guard(self, st, rel_out)
        if not rows.size:
            return
        live = np.nonzero(st["n_rel"] > 0)[0]
        n = len(st["n_out"])
        staged.append({"slab": st["slab"][: n * st["slot"]].copy(),
                       "slot": st["slot"],
                       "n_out": st["n_out"].copy(),
                       "n_rel": st["n_rel"].copy(),
                       "_plens": st["_plens"].copy(), "live": live,
                       "rows": rows, "pre": pre,
                       "post": rel_out.copy()})
        flagged_reads.extend(st["seqs"][st["g"][live[j]]]
                             for j in rows if j < len(live))

    feed_clock, feed_parts = _feed_fns()

    def run(guard, check=None):
        acc: dict = {}
        undo = [lambda: setattr(cls, "_exact_guard", orig)]
        setattr(cls, "_exact_guard", guard)
        undo += _main_clocks(eng, acc)
        undo.append(feed_clock(eng, acc, False))
        g0 = eng.guard_flagged
        out = []
        t = time.perf_counter()
        try:
            for k, res in enumerate(eng.classify_stream(
                    chunks(), sort_window=8)):
                if check is not None and res != check[k]:
                    fail(f"guard: main stream chunk {k} differs from "
                         f"the plain guard's run")
                out.append(res)
            torch.cuda.synchronize()
        finally:
            for u in reversed(undo):
                u()
        wall = time.perf_counter() - t
        return out, {"wall_s": wall, "kmers_per_s": kmers / wall,
                     "guard_flagged": eng.guard_flagged - g0,
                     "flag_rate": (eng.guard_flagged - g0)
                     / meta["n_reads"],
                     "host_s": _main_host_s(acc, wall),
                     "feed": feed_parts(acc)}

    orig = cls._exact_guard
    hrecs: list = []
    undo = _record_host_rel(eng.wall, hrecs)
    try:
        run(orig)                          # warm-up, its host rel recorded
    finally:
        undo()
    ref, plain1 = run(reference)
    if not staged or plain1["guard_flagged"] == 0:
        fail("guard: the dataset flagged no read")
    runs = [run(orig, ref)[1] for _ in range(GUARD_RUNS)]
    plain2 = run(_plain_guard, ref)[1]
    for r in runs + [plain2]:
        if r["guard_flagged"] != plain1["guard_flagged"]:
            fail(f"guard: guard_flagged {r['guard_flagged']} against "
                 f"the plain guard's {plain1['guard_flagged']}")
    rec["main"] = {"runs": runs, "plain_guard_runs": [plain1, plain2],
                   "bytes_equal_to_plain_guard": True,
                   "sha256": hashlib.sha256("\n".join(
                       c for res in ref for c in res).encode()).hexdigest()}
    for tag, r in ([("batch", r) for r in runs]
                   + [("plain", plain1), ("plain", plain2)]):
        say(f"guard main stream ({tag} guard): "
            f"{r['kmers_per_s'] / 1e6:.2f} M k-mers/s, guard_flagged "
            f"{r['guard_flagged']} ({100 * r['flag_rate']:.2f}% of "
            f"{meta['n_reads']} reads); main thread s: "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["host_s"].items())
            + "; " + _feed_line(r["feed"]))
        _no_pinning("guard main stream", r["feed"])

    # the host rel steps alone, on every chunk as the stream staged it
    rec["host_rel"] = _time_host_rel("guard", eng.wall, hrecs)

    # (b) the guard alone
    T = rec["threads"]
    turns = [_time_guard(eng.wall, staged, k, T) for k in GUARD_TURNS]
    rows = sum(len(c["rows"]) for c in staged)
    rec["alone"] = {"chunks": len(staged), "flagged_rows": rows,
                    "turns": turns, "rel_out_equal": True}
    say(f"guard alone ({len(staged)} chunks, {rows} flagged rows, "
        f"threads {T}, os.cpu_count() {os.cpu_count()}): "
        + "; ".join(f"{t['kind']} {t['s_per_chunk'] * 1e3:.3f} ms per "
                    f"chunk, {t['ms_per_flagged_row']:.4f} ms per row"
                    for t in turns) + "; rel_out equal")

    # (c) the all-device stream: the C++ feed as it ships and the
    # numpy feed (the plain versions) in turns, every run's bytes equal
    # to the main path's, guard_flagged equal in every run
    aeng = engine_mod.TorchEngine(gm, batch_size=200, device=DEV,
                                  alldev=True)
    for _ in aeng.classify_stream(chunks(), sort_window=8):
        pass                                           # warm-up

    def arun(feed):
        acc: dict = {}
        g0 = aeng.guard_flagged
        undo = [_numpy_feed(aeng)] if feed == "numpy" else []
        undo += _alldev_clocks(aeng, acc)
        undo.append(feed_clock(aeng, acc, True))
        t = time.perf_counter()
        try:
            aout = list(aeng.classify_stream(chunks(), sort_window=8))
            torch.cuda.synchronize()
        finally:
            for u in reversed(undo):
                u()
        wall = time.perf_counter() - t
        if aout != ref:
            fail(f"guard: the all-device stream's bytes ({feed} feed) "
                 f"differ from the main path's")
        return {"feed": feed, "wall_s": wall, "kmers_per_s": kmers / wall,
                "guard_flagged": aeng.guard_flagged - g0,
                "host_s": _alldev_host_s(acc, wall, feed),
                "feed_parts": feed_parts(acc),
                "bytes_equal_to_main": True}

    aruns = [arun(f) for f in ("cpp", "numpy", "numpy", "cpp")]
    if len({r["guard_flagged"] for r in aruns}) != 1:
        fail(f"guard: all-device guard_flagged differs between the C++ "
             f"and the numpy feed: {[r['guard_flagged'] for r in aruns]}")
    rec["alldev"] = dict(aruns[0], feed_turns=aruns)
    for a in aruns:
        say(f"guard alldev stream ({a['feed']} feed): "
            f"{a['kmers_per_s'] / 1e6:.2f} M k-mers/s, guard_flagged "
            f"{a['guard_flagged']}; bytes equal to the main path's; main "
            f"thread s: " + ", ".join(f"{k} {v:.4f}"
                                      for k, v in a["host_s"].items())
            + "; " + _feed_line(a["feed_parts"]))
        _no_pinning("guard alldev stream", a["feed_parts"])

    # (d) spot parity
    flat = [c for res in ref for c in res]
    index = {sq: i for i, sq in enumerate(seqs)}
    rng = np.random.default_rng(GUARD_SEED)
    picks = rng.choice(len(flagged_reads),
                       size=min(GUARD_SPOT, len(flagged_reads)),
                       replace=False)
    clf = ReadClassifier(gm)
    t = time.time()
    mism = sum(clf.classify(flagged_reads[p], profs[index[
        flagged_reads[p]]]) != flat[index[flagged_reads[p]]]
        for p in picks)
    rec["spot_parity"] = {"sampled": len(picks), "mismatches": mism,
                          "oracle_s": time.time() - t}
    say(f"guard spot parity: {mism} of {len(picks)} flagged reads "
        f"differ from the exact oracle")
    if mism:
        fail(f"guard: {mism} flagged reads differ from the exact "
             f"oracle")

    # the parent's main stream in turns with this tree's
    if parent:
        root = os.path.join(d, "reads")
        ab = []
        for tree in (parent, HERE, HERE, parent):
            r = _tree_stream(tree, root)
            r["tree"] = "parent" if tree == parent else "this"
            ab.append(r)
            for path, x in (("main", r), ("alldev", r["alldev"])):
                for y in x["runs"]:
                    say(f"guard {path} stream of {r['tree']} tree: "
                        f"{y['kmers_per_s'] / 1e6:.2f} M k-mers/s, "
                        f"exact_guard {y['exact_guard_s']:.4f} s, "
                        f"guard_flagged {y['guard_flagged']}; "
                        + _feed_line(y["feed"]))
                    if r["tree"] == "this":
                        _no_pinning(f"guard {path} stream of this tree",
                                    y["feed"])
        shas = {x["sha256"] for r in ab for x in (r, r["alldev"])}
        if shas != {rec["main"]["sha256"]} or len(
                {y["guard_flagged"] for r in ab
                 for x in (r, r["alldev"]) for y in x["runs"]}) != 1:
            fail(f"guard: the parent's and this tree's streams differ: "
                 f"{json.dumps(ab)}")
        rec["parent_ab"] = ab
    return rec


# the bench phase's runs of the port's benchmark runner: (dataset, path)
BENCH_RUNS = (("medium", "main"), ("medium", "alldev"), ("guard", "main"),
              ("guard", "alldev"))
BENCH_TIMEOUT = 600


def _bench_child(fixture: str, path: str) -> dict:
    """``python -m classpro_tpu_torch.devtools.bench`` over ``fixture`` on
    ``path`` on the card, as a child process: its record (the last line
    of its stdout) with the child's wall seconds (``child_s``); fails
    unless it exits 0 with phase done, parity and both rates above 0."""
    cmd = [sys.executable, "-m", "classpro_tpu_torch.devtools.bench",
           "--fixture", fixture, "--path", path, "--device", "cuda"]
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t = time.time()
    r = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                       text=True, timeout=BENCH_TIMEOUT)
    lines = r.stdout.strip().splitlines()
    try:
        rec = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"bench: {path} over {fixture} printed no record (rc "
             f"{r.returncode}): {r.stderr[-2000:]}")
    rec["child_s"] = time.time() - t
    if (r.returncode != 0 or rec.get("phase") != "done"
            or rec.get("parity_ok") is not True
            or not (rec.get("value") or 0) > 0
            or not (rec.get("e2e") or 0) > 0):
        fail(f"bench: {path} over {fixture} (rc {r.returncode}): "
             f"{json.dumps(rec)}\n{r.stderr[-2000:]}")
    return rec


def phase_bench(gbp: float, d: str, guard: dict | None, smi: str) -> dict:
    """The port's benchmark runner (devtools.bench) as four child
    processes (BENCH_RUNS): medium against its golden and the guard
    dataset in ``d`` (generated here unless the guard phase wrote it;
    its first 64 reads against the exact oracle), each on both paths.
    Every run must end done with parity and both rates above 0, medium's
    with guard_flagged 0.  A dataset's two paths must write the same
    bytes in their untimed pass (parity_sha256), on the guard dataset
    also the guard phase's reference stream's when that phase ran, and
    there the reads flagged per pass must equal the guard phase's count
    on the same path."""
    from classpro_tpu_torch.devtools import soak

    t0 = time.time()
    rec: dict = {"runs": [], "card": smi}
    if not os.path.exists(os.path.join(d, "meta.json")):
        soak.generate(d, gbp, seed=GUARD_SEED, kmer=GUARD_KMER,
                      cov=GUARD_COV)
        rec["gen_s"] = time.time() - t0
    want = guard and {"main": guard["main"]["runs"][0]["guard_flagged"],
                      "alldev": guard["alldev"]["guard_flagged"]}
    for data, path in BENCH_RUNS:
        r = _bench_child(os.path.join(FIX, "medium") if data == "medium"
                         else d, path)
        r["dataset"] = data
        per = r["guard_flagged_per_pass"]
        line = (f"bench {path} over {data}: {r['value'] / 1e6:.2f} M "
                f"k-mers/s (windows {min(r['runs']) / 1e6:.2f}-"
                f"{max(r['runs']) / 1e6:.2f}), e2e {r['e2e'] / 1e6:.2f} "
                f"({min(r['e2e_runs']) / 1e6:.2f}-"
                f"{max(r['e2e_runs']) / 1e6:.2f}); parity against the "
                f"{'golden' if r['parity_ref'] == 'golden' else 'exact oracle'}"
                f" ({r['parity_reads']} reads); "
                f"guard_flagged {r['guard_flagged']} ({per} a pass); "
                f"warm-up {r['warmup_s']:.2f} s at {r['warmup_shape']}; "
                f"child {r['child_s']:.1f} s")
        if data == "medium" and r["guard_flagged"] != 0:
            fail(f"bench: guard_flagged {r['guard_flagged']} on medium")
        if data == "guard":
            line += (f"; the guard phase flagged "
                     f"{want[path] if want else 'NOT RUN'} a pass")
            if want and per != want[path]:
                fail(f"bench: {per} reads flagged a pass on the {path} "
                     f"path against the guard phase's {want[path]}")
        say(line)
        rec["runs"].append(r)
    for data in ("medium", "guard"):
        shas = {r["parity_sha256"] for r in rec["runs"]
                if r["dataset"] == data}
        if data == "guard" and guard:
            shas.add(guard["main"]["sha256"])
        if len(shas) != 1:
            fail(f"bench: the runs over {data} wrote different bytes "
                 f"(sha256 {sorted(shas)})")
        say(f"bench: both paths over {data} wrote the same bytes"
            + (", the guard phase's" if data == "guard" and guard else ""))
    rec["seconds"] = time.time() - t0
    say(f"bench: {rec['seconds']:.1f} s")
    return rec


# --------------------------------------------------------------------- 7
# the --stats-json keys of the JAX package's classify (cli.py:287-294 and
# engine.py:1035-1042)
STATS_KEYS = {"wall_s", "kmers", "reads", "stream_wall_s", "chunks",
              "absorbed_chunks", "guard_flagged", "min_margin", "shapes"}


# timed sharded_classify calls after the warm-up call
SHARD_REPEATS = 7


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gold_bytes(fx: str) -> bytes:
    with gzip.open(os.path.join(FIX, fx, "golden.class.gz"), "rb") as f:
        return f.read()


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _k8(rec: dict) -> None:
    """(a) K8 in a NCCL world of one rank: psum_histogram of medium's
    partial instance histogram is its input; the all-reduce timed with
    CUDA events; estimate_distributed gives the .hist model."""
    import numpy as np
    import torch.distributed as dist

    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.parallel import driver, mesh

    root = os.path.join(FIX, "medium", "reads")
    hist = load_histogram(root)
    P = open_profiles(root)
    profs = [P.fetch(i) for i in range(P.nreads)]
    part = driver.partial_instance_hist(profs, hist.low, hist.high)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        n0 = mesh.LAUNCHES["all_reduce"]
        got = mesh.psum_histogram(part)
        if got.dtype != np.int64 or not np.array_equal(got, part):
            fail("K8: psum_histogram in a NCCL world of one != its input")
        t = torch.from_numpy(part).to("cuda")
        ms = _time_cuda(lambda: dist.all_reduce(t, op=dist.ReduceOp.SUM),
                        20)
        if not torch.equal(t.cpu(), torch.from_numpy(part)):
            fail("K8: all_reduce in a world of one changed its tensor")
        t0 = time.perf_counter()
        for _ in range(20):
            mesh.psum_histogram(part)
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        gm = driver.estimate_distributed(profs, kmer=hist.kmer,
                                         low=hist.low, high=hist.high)
        calls = mesh.LAUNCHES["all_reduce"] - n0
    finally:
        dist.destroy_process_group()
    ref = build_global_model(load_histogram(root))
    if not ((gm.cov == ref.cov).all() and gm.dr_ratio == ref.dr_ratio):
        fail(f"K8: estimate_distributed cov {gm.cov} dr {gm.dr_ratio} != "
             f".hist model cov {ref.cov} dr {ref.dr_ratio}")
    nbytes = 2 * part.nbytes          # the input read once, the sum written
    rec.update(k8_all_reduce_ms=ms, k8_psum_histogram_ms=host_ms,
               k8_bytes=part.nbytes, k8_bound_ms=nbytes / PEAK_BYTES * 1e3,
               k8_bound_by="bytes", k8_psum_calls=calls, k8_world=1,
               k8_backend="nccl")
    say(f"shard (a) K8: NCCL all_reduce of {part.nbytes} B int64 in a "
        f"world of 1: {ms:.4f} ms (CUDA events, 20 reps), bound "
        f"{rec['k8_bound_ms']:.6f} ms (bytes); psum_histogram with its "
        f"copies {host_ms:.3f} ms; estimate_distributed == .hist model "
        f"(cov {gm.cov.tolist()}, dr_ratio {gm.dr_ratio})")


def _driver(rec: dict, tmp: str) -> None:
    """(b) The shard driver on the card: one process, 4 shards + merge,
    and the 4-shard resume, against the goldens."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.parallel.driver import (merge_shards,
                                                    run_process, shard_range,
                                                    shard_records)

    def src(fx):
        return (os.path.join(FIX, fx, "reads.fasta.gz"),
                os.path.join(FIX, fx, "reads"))

    secs: dict = {}
    _reset_launches()
    for fx in ("tiny", "medium"):
        s, fk = src(fx)
        out = os.path.join(tmp, f"{fx}.single.class")
        t0 = time.perf_counter()
        run_process(s, fk, out, device="cuda")
        secs[f"{fx}_single_s"] = time.perf_counter() - t0
        if _read(out) != _gold_bytes(fx):
            fail(f"driver nproc=1 {fx}: .class differs from the golden")
    launches = dict(kernels.LAUNCHES)
    if any(launches[k] <= 0 for k in MAIN_PATH):
        fail(f"driver path launched a kernel no time: {launches}")

    def four(fx, out, resume=False):
        s, fk = src(fx)
        t0 = time.perf_counter()
        for pid in range(4):
            run_process(s, fk, out, nproc=4, pid=pid, device="cuda",
                        resume=resume, _skip_init=True)
        return time.perf_counter() - t0

    def merge(fx, out):
        from classpro_tpu_torch.io.fastk import open_profiles

        n = open_profiles(src(fx)[1]).nreads
        want = [e - b for b, e in (shard_range(n, 4, p) for p in range(4))]
        t0 = time.perf_counter()
        merge_shards(out, 4, want)
        secs[f"{fx}_merge_s"] = time.perf_counter() - t0
        if _read(out) != _gold_bytes(fx):
            fail(f"driver 4 shards {fx}: merged .class differs from golden")
        return want

    for fx in ("tiny", "medium"):
        out = os.path.join(tmp, f"{fx}.four.class")
        secs[f"{fx}_four_shards_s"] = four(fx, out)
        merge(fx, out)
    # resume: shard 1 truncated mid-record, shard 2 deleted
    out = os.path.join(tmp, "medium.resume.class")
    four("medium", out)
    with open(out + ".1", "r+b") as f:
        f.truncate(os.path.getsize(out + ".1") - 37)
    os.remove(out + ".2")
    st = {p: os.stat(f"{out}.{p}") for p in (0, 3)}
    secs["medium_resume_s"] = four("medium", out, resume=True)
    for p in (0, 3):
        s2 = os.stat(f"{out}.{p}")
        if (s2.st_ino, s2.st_mtime_ns) != (st[p].st_ino, st[p].st_mtime_ns):
            fail(f"resume rewrote the complete shard {p}")
    want = merge("medium", out)
    if any(shard_records(f"{out}.{p}") != -1 for p in range(4)):
        fail("merge left shard files behind")
    rec.update(driver_s=secs, driver_launches=launches,
               medium_shard_reads=want)
    say(f"shard (b) driver: nproc=1 and 4 shards + merge write the tiny "
        f"and medium goldens; resume after truncate/delete recomputed "
        f"shards 1, 2 only; seconds {json.dumps(secs)}; launches "
        f"{launches}")


def _exact_classes(wall, seq: str, recs, plen: int) -> str:
    """The C++ exact path of one read (exact_rel + finish_batch), as the
    all-device guard re-decides a flagged read."""
    import numpy as np

    rel_recs = recs[recs["is_rel"] != 0]
    rel_out = (wall.exact_rel(rel_recs, plen)[None, :] if len(rel_recs)
               else None)
    buf = wall.finish_batch(
        np.ascontiguousarray(recs), len(recs),
        np.array([len(recs)], np.int32), np.array([len(rel_recs)], np.int32),
        rel_out, max(len(rel_recs), 1), np.array([0, len(seq)], np.int64),
        threads=1)
    return str(memoryview(buf), "ascii")


def _sharded(rec: dict, devices: list) -> None:
    """(c) sharded_classify of 4 distinct medium read groups (every
    fourth read in order of interval count, one common dims)."""
    import numpy as np

    from classpro_tpu_torch import alldev, kernels
    from classpro_tpu_torch.alldev import classify_batch
    from classpro_tpu_torch.native import NativeWall
    from classpro_tpu_torch.pack import expand_asgn
    from classpro_tpu_torch.params import build_replicas
    from classpro_tpu_torch.parallel.mesh import sharded_classify

    gm, seqs, profs = _model("medium")
    gold = golden_classes("medium")
    wall = NativeWall(gm)
    slab, n_out, n_rel, slot = wall.wall_stage_slab(
        [s.encode("ascii") for s in seqs], profs)
    ivs = [slab[i * slot: i * slot + int(n_out[i])].copy()
           for i in range(len(seqs))]
    plens = [len(p) for p in profs]
    order = sorted((i for i in range(len(seqs)) if n_out[i] > 0),
                   key=lambda i: (int(n_out[i]), int(n_rel[i])))
    groups = [np.array(sorted(order[d::4]), np.int32) for d in range(4)]
    # each shard packed by the C++ entry, held against numpy's
    packs = [wall.pack_chunk(slab, slot, n_out, n_rel, plens, g)
             for g in groups]
    metas = [_numpy_pack(f"sharded: shard {d}", slab, slot, n_out, plens, g,
                         p)[3] for d, (g, p) in enumerate(zip(groups, packs))]
    dims = packs[0][2]
    if any(p[2] != dims for p in packs):
        fail(f"sharded: groups differ in dims {[p[2] for p in packs]}")
    fbs = np.stack([p[0] for p in packs])
    ibs = np.stack([p[1] for p in packs])
    PPs = build_replicas(gm, devices, alldev=True)
    sharded_classify(devices, fbs, ibs, PPs, dims)      # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    runs = []                 # host ms of each call (it returns on host)
    for _ in range(SHARD_REPEATS):
        t0 = time.perf_counter()
        out, flags = sharded_classify(devices, fbs, ibs, PPs, dims)
        runs.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(runs)
    launches = dict(kernels.LAUNCHES)
    replays = alldev.GRAPH_COUNTS["replays"]
    if any(launches[k] <= 0 for k in ALLDEV_PATH) \
            or replays != SHARD_REPEATS * len(devices):
        fail(f"sharded_classify launches {launches}, {replays} graph "
             f"replays: a kernel ran no time, or a shard not by a replay")
    if len({out[d].tobytes() for d in range(len(devices))}) != len(devices):
        fail("sharded: two shards returned the same rows")
    checked = 0
    for d, (g, (fb, ib, _), meta) in enumerate(zip(groups, packs, metas)):
        dev = torch.device(devices[d])
        o, f = classify_batch(torch.from_numpy(fb).to(dev),
                              torch.from_numpy(ib).to(dev), PPs[dev], *dims)
        if not (np.array_equal(out[d], o.cpu().numpy())
                and np.array_equal(flags[d], f.cpu().numpy())):
            fail(f"sharded: shard {d} != a single classify_batch on it")
        # the class lines by the C++ expansion, held against expand_asgn
        res = [None] * len(seqs)
        expand_asgn(out[d], meta, res, gm.kmer)
        out_off = np.zeros(len(g) + 1, np.int64)
        out_off[1:] = np.cumsum([len(seqs[i]) for i in g])
        cls = wall.expand_rows(slab, slot, n_out, g, out[d], out_off)
        if cls.tobytes() != "".join(res[i] for i in g).encode("ascii"):
            fail(f"sharded: shard {d}'s C++ class lines differ from "
                 f"expand_asgn's")
        mv = memoryview(cls)
        res = {int(i): str(mv[out_off[r]: out_off[r + 1]], "ascii")
               for r, i in enumerate(g)}
        for r, i in enumerate(g):
            if flags[d][r]:
                continue
            want = _exact_classes(wall, seqs[i], ivs[i], plens[i])
            if res[i] != want or want != gold[i]:
                fail(f"sharded: shard {d} read {i} != the C++ exact path")
            checked += 1
    rec.update(sharded_devices=[str(d) for d in devices],
               sharded_dims=list(dims), sharded_ms=ms,
               sharded_ms_runs=runs,
               sharded_launches=launches, sharded_replays=replays,
               sharded_reads_checked=checked,
               sharded_flagged=int(flags.sum()))
    say(f"shard (c) sharded_classify over {devices}: 4 shards at dims "
        f"{dims} == one classify_batch each; {checked} unflagged reads == "
        f"the C++ exact path, {int(flags.sum())} flagged; ms for the 4 "
        f"shards, {SHARD_REPEATS} calls after a warm-up: {runs} (median "
        f"{ms}); launches {launches}")


def _round_robin(rec: dict, devices: list) -> None:
    """(d) TorchEngine(devices=...) on medium, both paths: the golden
    bytes, every kernel of the path launched."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.engine import TorchEngine

    gm, seqs, profs = _model("medium")
    gold = golden_classes("medium")
    chunks = [(seqs[lo:lo + 200], profs[lo:lo + 200])
              for lo in range(0, len(seqs), 200)]
    out = {}
    for alldev in (False, True):
        eng = TorchEngine(gm, devices=devices, alldev=alldev)
        _reset_launches()
        t0 = time.perf_counter()
        got = [c for r in eng.classify_stream(iter(chunks), sort_window=8)
               for c in r]
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        tag = "alldev" if alldev else "main"
        if got != gold[:len(seqs)]:
            fail(f"round robin ({tag}) over {devices} differs from golden")
        need = ALLDEV_PATH if alldev else MAIN_PATH
        if any(launches[k] <= 0 for k in need):
            fail(f"round robin ({tag}) launches {launches}")
        out[tag] = {"s": wall, "launches": launches,
                    "chunks_dealt": eng._rr, "replicas": len(eng._on)}
    rec.update(round_robin_devices=[str(d) for d in devices],
               round_robin=out)
    say(f"shard (d) round robin over {devices}: medium golden on the main "
        f"path and on alldev; {json.dumps(out)}")


def _cli(rec: dict, tmp: str) -> None:
    """(e) classify -s on tiny FASTX and on the tiny .dam fixture, with
    --stats-json, on the card."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.cli import main as cli_main
    from classpro_tpu_torch.io.fastk import open_profiles

    tiny = os.path.join(FIX, "tiny")
    K = open_profiles(os.path.join(tiny, "reads")).kmer
    out = os.path.join(tmp, "cli.class")
    stats = os.path.join(tmp, "stats.json")
    _reset_launches()
    if cli_main(["classify", "-s", os.path.join(tiny, "reads.fasta.gz"),
                 "-N", os.path.join(tiny, "reads"), "-o", out,
                 "--stats-json", stats]) != 0:
        fail("classify -s on tiny FASTX failed")
    if _read(out) != _gold_bytes("tiny"):
        fail("classify -s: .class differs from the golden")
    with gzip.open(os.path.join(tiny, "golden.seeds.gz"), "rt") as f:
        gseeds = f.read().splitlines()
    with open(out + ".seeds") as f:
        labels = [ln[K - 1:] for ln in f.read().splitlines()[1::2]]
    if labels[:len(gseeds)] != gseeds:
        fail("classify -s: .seeds labels differ from golden.seeds.gz")
    with open(stats) as f:
        st = json.load(f)
    if set(st) != STATS_KEYS:
        fail(f"--stats-json keys {sorted(st)} != the JAX keys "
             f"{sorted(STATS_KEYS)}")
    dam_dir = os.path.join(tmp, "dam")
    os.makedirs(dam_dir)
    for fn in ("reads.dam", ".reads.idx", ".reads.bps", ".reads.hdr"):
        shutil.copy(os.path.join(tiny, "dam", fn), dam_dir)
    if cli_main(["classify", "-s", os.path.join(dam_dir, "reads.dam"),
                 "-N", os.path.join(tiny, "reads")]) != 0:
        fail("classify -s on the tiny .dam failed")
    if _read(os.path.join(dam_dir, "reads.class")) != _gold_bytes("tiny"):
        fail("classify -s .dam: .class differs from the golden")
    for fn in (".reads.class.anno", ".reads.class.data", ".reads.rep.anno",
               ".reads.rep.data"):
        if _read(os.path.join(dam_dir, fn)) != \
                _read(os.path.join(tiny, "dam", fn)):
            fail(f"classify -s .dam: {fn} differs from the fixture")
    rec.update(cli_stats=st, cli_launches=dict(kernels.LAUNCHES))
    say(f"shard (e) CLI: classify -s on tiny FASTX (.class, .seeds) and on "
        f"the tiny .dam (.class + 4 track files) byte-equal; --stats-json "
        f"{json.dumps(st)}")


def _multi_card(rec: dict, tmp: str) -> None:
    """(f) Two NCCL ranks as real processes (the driver's main), merged
    output == the golden.  Needs two cards."""
    src = os.path.join(FIX, "tiny", "reads.fasta.gz")
    out = os.path.join(tmp, "nccl.class")
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "classpro_tpu_torch.parallel.driver", src,
         "-N", os.path.join(FIX, "tiny", "reads"), "-o", out, "--nproc", "2",
         "--pid", str(p), "--coord", f"127.0.0.1:{port}"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for p in range(2)]
    try:
        res = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_so, se) in zip(procs, res):
        if p.returncode != 0:
            fail(f"NCCL driver rank failed:\n{se.decode()[-2000:]}")
    if _read(out) != _gold_bytes("tiny"):
        fail("NCCL 2-rank driver: merged .class differs from the golden")
    rec["nccl_two_ranks_s"] = time.perf_counter() - t0
    say(f"shard (f) two NCCL ranks on two cards: merged tiny golden in "
        f"{rec['nccl_two_ranks_s']:.2f} s")


def phase_shard() -> dict:
    """K8 and the parallel layer on the card: (a) the NCCL all-reduce,
    (b) the shard driver with merge and resume, (c) sharded_classify,
    (d) round robin, (e) the CLI's -s/.dam/--stats-json, (f) two ranks
    and distinct cards when the machine has two or more."""
    # every group of this run is on this host
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    n = torch.cuda.device_count()
    devices = [f"cuda:{i % n}" for i in range(4)]
    rr = [f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0", "cuda:0"]
    rec: dict = {"cards": n}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        _k8(rec)
        _driver(rec, tmp)
        _sharded(rec, devices)
        _round_robin(rec, rr)
        _cli(rec, tmp)
        if n >= 2:
            _multi_card(rec, tmp)
            rec["multi_card"] = "run"
        else:
            rec["multi_card"] = ("NOT RUN: one card; NCCL cannot put two "
                                 "ranks on one GPU, and round robin over "
                                 "distinct cards needs two")
            say(f"shard (f) {rec['multi_card']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


# --------------------------------------------------------------------- 8
def _wait_ready(p, timeout: float) -> None:
    """Wait for the daemon's READY line on its stdout; fail if it exits
    or stays silent for ``timeout`` seconds."""
    line: list = []
    th = threading.Thread(target=lambda: line.append(p.stdout.readline()),
                          daemon=True)
    th.start()
    th.join(timeout)
    if not line or line[0].strip() != "READY":
        fail(f"serve: no READY line from the daemon (got {line!r}, exit "
             f"code {p.poll()})")


def phase_serve(keep: str) -> dict:
    """The serve daemon on the card, through its real entry point, and
    classify --warmup --torch-profile (its trace copied into ``keep`` for
    the tools phase)."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.cli import main as cli_main
    from classpro_tpu_torch.devtools.profile_summary import trace_share
    from classpro_tpu_torch.serve import request

    tmp = tempfile.mkdtemp(prefix="cps")
    sock = os.path.join(tmp, "cp.sock")
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    med = os.path.join(FIX, "medium")
    rec: dict = {}
    err = open(os.path.join(tmp, "daemon.err"), "w+")
    t0 = time.perf_counter()
    p = subprocess.Popen(
        [sys.executable, "-m", "classpro_tpu_torch.cli", "serve",
         "--socket", sock, "--warmup-root", os.path.join(med, "reads"),
         "--device", "cuda"], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=err, text=True)
    try:
        _wait_ready(p, 600)
        rec["ready_s"] = time.perf_counter() - t0
        st0 = request(sock, {"cmd": "stats"}, timeout=30)
        rec["warmup_launches"] = st0["launches"]
        rec["warmup_graphs"] = st0["graphs"]
        # each warm-up shape: the DP kernel's two launches run eagerly,
        # then the chunk graph captured
        n_warm = len(st0["warm_shapes"])
        if st0["launches"]["rel_dp"] != 2 * n_warm \
                or st0["launches"]["rel_prep"] \
                or st0["graphs"]["captures"] != n_warm:
            fail(f"serve: warm-up launches {st0['launches']} and graphs "
                 f"{st0['graphs']} for shapes {st0['warm_shapes']}")
        jobs = []
        # job 1: tiny, by request
        out1 = os.path.join(tmp, "tiny.class")
        t1 = time.perf_counter()
        rep = request(sock, {"cmd": "classify",
                             "source": os.path.join(FIX, "tiny",
                                                    "reads.fasta.gz"),
                             "fastk_root": os.path.join(FIX, "tiny",
                                                        "reads"),
                             "output": out1}, timeout=30)
        host1 = time.perf_counter() - t1
        if not rep.get("ok") or _read(out1) != _gold_bytes("tiny"):
            fail(f"serve job 1 (tiny): {rep}")
        jobs.append({"fixture": "tiny", "via": "request",
                     "wall_s": rep["wall_s"], "client_s": host1,
                     "kmers": rep["kmers"],
                     "kmers_per_s": rep["kmers"] / rep["wall_s"],
                     "launches": rep["launches"], "graphs": rep["graphs"]})
        # job 1b: tiny with the -M HIsim model, its bucket tiny's: the
        # job's own graph, the golden of that model
        out1m = os.path.join(tmp, "tiny_M.class")
        rep = request(sock, {"cmd": "classify",
                             "source": os.path.join(FIX, "tiny",
                                                    "reads.fasta.gz"),
                             "fastk_root": os.path.join(FIX, "tiny",
                                                        "reads"),
                             "model": _hisim_model(tmp), "output": out1m},
                      timeout=30)
        with gzip.open(os.path.join(FIX, "tiny", "golden_M.class.gz"),
                       "rb") as f:
            if not rep.get("ok") or _read(out1m) != f.read() \
                    or rep["graphs"]["replays"] <= 0:
                fail(f"serve job 1b (tiny -M): {rep}")
        jobs.append({"fixture": "tiny -M", "via": "request",
                     "wall_s": rep["wall_s"], "kmers": rep["kmers"],
                     "launches": rep["launches"], "graphs": rep["graphs"]})
        # job 2: medium, through the CLI client
        out2 = os.path.join(tmp, "medium.class")
        t2 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "classpro_tpu_torch.cli", "classify",
             "--server", sock, os.path.join(med, "reads.fasta.gz"), "-o",
             out2, "-v"], cwd=HERE, env=env, capture_output=True,
            text=True, timeout=600)
        host2 = time.perf_counter() - t2
        if r.returncode != 0 or _read(out2) != _gold_bytes("medium"):
            fail(f"serve job 2 (medium, classify --server): rc "
                 f"{r.returncode}\n{r.stderr[-2000:]}")
        import re

        m = re.search(r"server: (\d+) reads in ([0-9.e+-]+)s", r.stderr)
        if m is None:
            fail(f"serve job 2: no reply line in {r.stderr[-500:]!r}")
        gold = golden_classes("medium")
        kmers2 = sum(len(c) - c.count("N") for c in gold)
        wall2 = float(m.group(2))
        jobs.append({"fixture": "medium", "via": "classify --server",
                     "reads": int(m.group(1)), "wall_s": wall2,
                     "client_s": host2, "kmers": kmers2,
                     "kmers_per_s": kmers2 / wall2})
        st = request(sock, {"cmd": "stats"}, timeout=30)
        launches = {k: st["launches"][k] - st0["launches"][k]
                    for k in st["launches"]}
        replays = st["graphs"]["replays"] - st0["graphs"]["replays"]
        if st["jobs"] != 3 or st["table_uploads"] != 1 or replays <= 0 \
                or any(launches[k] <= 0 for k in MAIN_PATH):
            fail(f"serve stats after two jobs: {st} (path launches "
                 f"{launches})")
        # a failing job is replied, and the daemon serves on
        rep = request(sock, {"cmd": "classify",
                             "source": os.path.join(tmp, "missing.fasta")},
                      timeout=30)
        if rep.get("ok") or not request(sock, {"cmd": "ping"},
                                        timeout=30).get("ok"):
            fail(f"serve: a failing job was not isolated: {rep}")
        if not request(sock, {"cmd": "shutdown"}, timeout=30).get("ok") \
                or p.wait(timeout=120) != 0 or os.path.exists(sock):
            fail(f"serve: shutdown (exit code {p.poll()}, socket left "
                 f"{os.path.exists(sock)})")
        rec.update(jobs=jobs, launches=launches,
                   table_uploads=st["table_uploads"],
                   warm_shapes=st["warm_shapes"], failed_job=rep["error"])
        say(f"serve: READY in {rec['ready_s']:.2f} s (warm-up launches "
            f"{st0['launches']}); tiny by request and medium by classify "
            f"--server byte-equal to their goldens; jobs {json.dumps(jobs)};"
            f" table uploads {st['table_uploads']}; path launches "
            f"{launches}; a failing job replied ok: false; shutdown exit 0")

        # classify --warmup --torch-profile on medium, in this process
        out3 = os.path.join(tmp, "profiled.class")
        tdir = os.path.join(tmp, "trace")
        _reset_launches()
        t3 = time.perf_counter()
        if cli_main(["classify", "--warmup", "--torch-profile", tdir,
                     os.path.join(med, "reads.fasta.gz"), "-o", out3]) != 0:
            fail("classify --warmup --torch-profile failed")
        rec["profiled_run_s"] = time.perf_counter() - t3
        rec["profiled_launches"] = dict(kernels.LAUNCHES)
        if _read(out3) != _gold_bytes("medium"):
            fail("classify --warmup --torch-profile: .class differs from "
                 "the golden")
        traces = [f for f in os.listdir(tdir) if f.endswith(".json")]
        if len(traces) != 1:
            fail(f"--torch-profile wrote {traces}")
        tr = trace_share(os.path.join(tdir, traces[0]))
        if tr["rel_dp_kernel_events"] <= 0:
            fail(f"the profiler trace holds no rel_dp_kernel event: {tr}")
        rec["trace"] = tr
        rec["trace_path"] = shutil.copy(os.path.join(tdir, traces[0]), keep)
        say(f"serve: classify --warmup --torch-profile on medium: golden "
            f"bytes, {tr['rel_dp_kernel_events']} rel_dp_kernel events "
            f"({tr['rel_dp_kernel_us']:.1f} us), card busy "
            f"{100 * tr['busy_share']:.2f}% of the {tr['window_us']:.0f} us "
            f"traced window")
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=60)
        err.seek(0)
        tail = err.read()[-2000:]
        err.close()
        if p.returncode not in (0, None) and tail:
            print(f"serve daemon stderr:\n{tail}", file=sys.stderr)
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


# --------------------------------------------------------------------- 9
# the first seed of the tools phase's datasets (disjoint from the
# committed corpus); each K takes the first seed from here that draws it
TOOLS_SEED0 = 990000
# sections every debug-read dump prints (the last one when it agrees)
DEBUG_SECTIONS = ("oracle wall stage", "oracle rel DP", "oracle final",
                  "production wall stage (C++)", "device DP",
                  "production final", "RESULT: oracle == production")


def _seed_for_k(K: int) -> int:
    """The first seed from TOOLS_SEED0 whose fuzz dataset has k-mer size
    K (fuzzgen.build draws K first from the seed's generator)."""
    import numpy as np

    s = TOOLS_SEED0
    while int(np.random.default_rng(s).choice([16, 24, 32, 40])) != K:
        s += 1
    return s


def _debug_reads() -> list:
    """(a) debug-read on the card: read 0 of branch/psum0 with the
    fixture's -c/-r, and read 0 of medium."""
    import io

    from classpro_tpu_torch.tools.debug_read import debug_read

    out = []
    for fx in ("branch/psum0", "medium"):
        d = os.path.join(FIX, fx)
        kw = {}
        if os.path.exists(os.path.join(d, "args.json")):
            with open(os.path.join(d, "args.json")) as f:
                a = json.load(f)
            kw = {"coverage": a["coverage"], "read_len": a["read_len"]}
        buf = io.StringIO()
        t0 = time.perf_counter()
        same = debug_read(os.path.join(d, "reads.fasta.gz"), 0, out=buf,
                          device="cuda", **kw)
        text = buf.getvalue()
        missing = [x for x in DEBUG_SECTIONS if x not in text]
        if not same or missing:
            fail(f"debug-read {fx} read 0 on cuda: agrees {same}, missing "
                 f"sections {missing}\n{text[-3000:]}")
        out.append({"fixture": fx, "read": 0, **kw,
                    "seconds": time.perf_counter() - t0,
                    "device_dp": text.split("--- device DP")[1]
                    .split("\n")[0].strip(" -")})
    say(f"tools (a): debug-read on cuda, oracle == production, every "
        f"section printed: {json.dumps(out)}")
    return out


def phase_tools(trace: str | None) -> dict:
    """(a) debug-read on the card; (b) fuzz datasets (fuzzgen) in this
    process, one GlobalModel each, through the main path and the
    all-device path against the port's exact oracle (run in worker
    processes meanwhile): the default generator at K = 16, 24, 32 and
    40, --extreme, --cap, --ndense, a -M random model, and a .dam with
    -s (its five outputs compared too); the kernels' launch counts reset
    just before and read just after; (c) profile_summary on the serve
    phase's trace."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.devtools import fuzzgen, gpu_parity
    from classpro_tpu_torch.devtools import profile_summary

    t_all = time.perf_counter()
    rec: dict = {"debug_read": _debug_reads()}
    tmp = tempfile.mkdtemp(prefix="cpt")
    try:
        names, specs = [], []

        def add(name, seed, model=None, **kw):
            d = os.path.join(tmp, name)
            _K, fname = fuzzgen.build(seed, d, **kw)
            if model:
                fuzzgen.write_random_model(seed, os.path.join(d, model))
            names.append({"dataset": name, "seed": seed})
            specs.append((d, fname, model and os.path.join(d, model)))

        for K in (16, 24, 32, 40):
            add(f"random_k{K}", _seed_for_k(K))
        add("extreme", TOOLS_SEED0, gen=fuzzgen.GENERATORS["extreme"])
        add("cap", TOOLS_SEED0, gen=fuzzgen.GENERATORS["cap"])
        add("ndense", TOOLS_SEED0, ndense=True)
        add("model", TOOLS_SEED0, model="rand.model")
        _reset_launches()
        t0 = time.perf_counter()
        dam = gpu_parity.check_dam(os.path.join(tmp, "dam"), "cuda",
                                   seed=TOOLS_SEED0)
        if dam["differing_files"]:
            fail(f"tools (b): classify -s on the .dam differs from the "
                 f"oracle: {dam}")
        names.append({"dataset": "dam", "seed": TOOLS_SEED0})
        specs.append((os.path.join(tmp, "dam", "oracle"), "reads.dam", None))
        recs = gpu_parity.check_datasets(specs, "cuda", workers=4)
        launches = dict(kernels.LAUNCHES)
        rec["datasets_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for nm, r in zip(names, recs):
        r.update(nm)
        say(f"tools (b): {r['dataset']} (seed {r['seed']}) K={r['K']} "
            f"{r['reads']} reads {r['kmers']} k-mers [{r['oracle']}]: "
            + "; ".join(f"{p} {v['mismatches']} mismatches, guard_flagged "
                        f"{v['guard_flagged']}, min_margin "
                        f"{v['min_margin']}" for p, v in r["paths"].items()))
    bad = [r["dataset"] for r in recs if not gpu_parity.dataset_ok(r)]
    if bad:
        fail(f"tools (b): mismatches against the exact oracle on {bad}")
    if any(n <= 0 for n in launches.values()):
        fail(f"tools (b): a kernel of the path did not launch: {launches}")
    say(f"tools (b): .dam -s K={dam['K']}: all {dam['files']} outputs "
        f"byte-equal to the {dam['oracle']}'s; launches on the path "
        f"{launches}")
    rec.update(datasets=recs, dam=dam, launches=launches)
    if trace is None:
        say("tools (c): profile_summary NOT RUN (it reads the serve "
            "phase's trace)")
    else:
        if profile_summary.main([trace, "10"]) != 0:
            fail("tools (c): profile_summary failed")
        sh = profile_summary.trace_share(trace)
        if sh["device_events"] <= 0:
            fail(f"tools (c): no device event in the trace: {sh}")
        rec["trace_busy_share"] = sh["busy_share"]
    rec["seconds"] = time.perf_counter() - t_all
    say(f"tools: {rec['seconds']:.1f} s (debug-read "
        f"{sum(x['seconds'] for x in rec['debug_read']):.1f} s, datasets "
        f"{rec['datasets_s']:.1f} s)")
    return rec


def phase_soak(gbp: float) -> dict:
    """A soak of ``gbp`` billion bases at K = 28 on the card
    (devtools.soak): classify with its RSS sampled, the served job, spot
    parity against the exact oracle, the two-shard merge."""
    from classpro_tpu_torch.devtools import soak

    d = tempfile.mkdtemp(prefix="cpsoak")
    try:
        res = soak.soak(d, "cuda", gbp=gbp, kmer=28)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    c, es, m = res["classify"], res["classify"]["engine_stats"], res["meta"]
    say(f"soak: {gbp} Gbp, K={m['kmer']}, {m['n_reads']} reads, "
        f"{m['n_kmers']} k-mers; generator {m['gen_seconds']} s; classify "
        f"wall {c['wall_s']} s, stream wall {es['stream_wall_s']:.2f} s, "
        f"{c['kmers_per_s'] / 1e6:.2f} M k-mers/s (stream "
        f"{c['stream_kmers_per_s'] / 1e6:.2f}); RSS peak "
        f"{c['rss_peak_mb']} MB; guard_flagged {es['guard_flagged']} "
        f"({100 * c['guard_flag_rate']:.2f}% of reads), min_margin "
        f"{es['min_margin']}; spot parity {res['spot_parity']}; merge "
        f"equal {res['shard_merge']['merge_equal']}; served job "
        f"{res['served']['job_wall_s']} s (ready "
        f"{res['served']['server_warmup_s']} s, equal "
        f"{res['served']['equal_to_fresh']})")
    if not res["ok"]:
        fail(f"soak: spot parity, the merge or the served job disagree: "
             f"{res['spot_parity']}, {res['shard_merge']}, "
             f"{res['served']['equal_to_fresh']}")
    samples = c.pop("samples")
    c["rss_mb_curve"] = [x["rss_mb"]
                         for x in samples[:: max(1, len(samples) // 20)]]
    return res


# ---------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="build,kernel,e2e,setup,stream,alldev,guard,"
                            "bench,shard,serve,tools",
                    help="comma-separated subset (the probe always runs; "
                    "k1profile, k5profile and settleprofile, the kernels' "
                    "phase clocks, glue_ab, the streams with the plain glue "
                    "against the glue kernels, and soak only when named; "
                    "profiled is glue_ab's profiled passes, which it "
                    "starts as a process of its own)")
    ap.add_argument("--soak-gbp", type=float, default=0.05,
                    help="soak phase: dataset size in billions of bases")
    ap.add_argument("--guard-gbp", type=float, default=0.02,
                    help="guard and bench phases: the guard dataset's size "
                    "in billions of bases (K = 28, 83x)")
    ap.add_argument("--passes", type=int, default=40,
                    help="steady-stream passes over medium (per turn)")
    ap.add_argument("--alldev-passes", type=int, default=10,
                    help="alldev-stream passes over medium (per turn)")
    ap.add_argument("--batch-size", type=int, default=200,
                    help="stream and alldev_stream: reads per device chunk")
    ap.add_argument("--sort-window", type=int, default=8,
                    help="steady stream: classify_stream's sort_window")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of an earlier commit: the kernel "
                    "phase holds its main-path launches (from a tree "
                    "before the DP kernel's prologue, rel_prep's main "
                    "layout + the DP first pass with its tails) against "
                    "this tree's and times them in turns, the alldev "
                    "phase its rel_prep and rel_settle, the stream phase "
                    "its main stream, the alldev_stream phase its "
                    "all-device stream, the guard phase its streams")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    # 1. probe
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "classpro_tpu_torch")) \
            or not os.path.isdir(FIX):
        print("chip_smoke: run from a checkout of the repository "
              "(classpro_tpu_torch/ and tests/fixtures/ not found)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    say(f"probe: {kind}, {torch.cuda.device_count()} device(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    say(f"card: {smi}")
    t_all = time.time()

    brec = phase_build() if "build" in phases else None
    parent = (_parent_kernels(args.parent)
              if args.parent and phases & {"kernel", "alldev"} else None)
    krec = phase_kernel(parent) if "kernel" in phases else None
    if "k1profile" in phases:
        say(json.dumps({"k1_profile": phase_k1profile(), "card": smi}))
    if "k5profile" in phases:
        say(json.dumps({"k5_profile": phase_k5profile(), "card": smi}))
    if "settleprofile" in phases:
        say(json.dumps({"settle_profile": phase_settleprofile(),
                        "card": smi}))
    launches = phase_e2e() if "e2e" in phases else None
    if "setup_cold" in phases:               # the child of phase_setup
        say(json.dumps({"setup_cold": phase_setup_cold()}))
    serec = phase_setup(smi) if "setup" in phases else None
    srec = (phase_stream(args.passes, batch_size=args.batch_size,
                         sort_window=args.sort_window, parent=args.parent)
            if "stream" in phases else None)
    arec = alaunch = asrec = None
    if "alldev" in phases:
        arec = phase_alldev(parent)
        alaunch = phase_alldev_e2e()
    if phases & {"alldev", "alldev_stream"}:
        asrec = phase_alldev_stream(args.alldev_passes, parent=args.parent,
                                    batch_size=args.batch_size)
    if "profiled" in phases:                 # the child of _profiled_process
        say(json.dumps({"profiled": phase_profiled()}))
    abrec = None
    if "glue_ab" in phases:
        abrec = {"stream": phase_stream(args.passes, args.batch_size,
                                        args.sort_window, AB_TURNS),
                 "alldev_stream": phase_alldev_stream(args.alldev_passes,
                                                      AB_TURNS),
                 "profiled": _profiled_process()}
    # the guard dataset, written once for the guard and bench phases
    gdir = (tempfile.mkdtemp(prefix="cpguard")
            if phases & {"guard", "bench"} else None)
    try:
        gdrec = (phase_guard(args.guard_gbp, args.parent, smi, gdir)
                 if "guard" in phases else None)
        bnrec = (phase_bench(args.guard_gbp, gdir, gdrec, smi)
                 if "bench" in phases else None)
    finally:
        if gdir:
            shutil.rmtree(gdir, ignore_errors=True)
    shrec = phase_shard() if "shard" in phases else None
    keep = tempfile.mkdtemp(prefix="cpk")
    try:
        svrec = phase_serve(keep) if "serve" in phases else None
        tlrec = (phase_tools(svrec and svrec["trace_path"])
                 if "tools" in phases else None)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    skrec = phase_soak(args.soak_gbp) if "soak" in phases else None
    if srec is not None:
        say(json.dumps({"stream": srec, "card": smi}))
    if asrec is not None:
        say(json.dumps({"alldev_stream": asrec, "alldev": arec,
                        "card": smi}))
    if abrec is not None:
        say(json.dumps({"glue_ab": abrec, "card": smi}))
    if gdrec is not None:
        say(json.dumps({"guard": gdrec}))
    if bnrec is not None:
        say(json.dumps({"bench": bnrec["runs"], "card": smi,
                        "seconds": bnrec["seconds"]}))
    kern = []
    if krec is not None and arec is not None:   # the alldev rescue tails
        krec["tail_err"]["rel_rescue"] = max(krec["tail_err"]["rel_rescue"],
                                             arec["glue_err"]["rel_rescue"])
    if krec is not None and launches is not None:
        k = len(krec["ms"]) - 1              # the medium shape timed last
        kern.append({
            "name": "rel_dp", "route": "cuda",
            "source": "classpro_tpu_torch/csrc/rel_dp.cu",
            "replaces": "classpro_tpu/tpu/rel_dev2.py:636",
            "launches": launches["rel_dp"],
            "max_abs_err": krec["max_abs_err"],
            "ms": krec["ms"][k], "plain_ms": krec["plain_ms"][k],
            "bound_ms": krec["bound"][k]["ms"],
            "bound_by": krec["bound"][k]["by"],
            "library_ms": None, "us_per_step": krec["us_per_step"],
            "tails": _tails_entry(krec, launches["tails"]),
            **(brec or {}).get("rel_dp_kernel", {}),
            "resources": {e: (brec or {}).get(e, {})
                          for e in ENTRIES["rel_dp"]},
            **krec["geometry"]})
        kern.append(_first_entry(krec, launches, brec))
    if arec is not None:
        ch = arec["chunks"][-1]              # the medium chunk timed last
        kern.append({
            "name": "unrel_sweeps", "route": "cuda",
            "source": "classpro_tpu_torch/csrc/unrel.cu",
            "replaces": "classpro_tpu/tpu/unrel_dev2.py:67",
            "launches": alaunch["unrel_sweeps"],
            "max_abs_err": arec["max_abs_err"],
            "ms": ch["ms"], "plain_ms": ch["plain_ms"],
            "bound_ms": ch["bound"]["ms"], "bound_by": ch["bound"]["by"],
            "library_ms": None, "us_per_step": ch["us_per_step"],
            "us_per_active_step": ch["us_per_active_step"],
            "ms_per_chunk": [c["ms"] for c in arec["chunks"]],
            "long_row_ms": arec["long_row"]["ms"],
            "long_row_us_per_active_step":
                arec["long_row"]["us_per_active_step"],
            "tails": {"gate": _gate_entry(arec, alaunch["tails"]["gate"],
                                          ch["dims"][0])},
            "resources": {e: (brec or {}).get(e, {})
                          for e in ENTRIES["unrel_sweeps"]},
            **(brec or {}).get("unrel_kernel", {}), **arec["geometry"]})
    if arec is not None:
        for name in ("rel_prep", "rel_settle"):
            g = arec["glue"][name]
            kern.append(dict(_glue_entry(name, g, alaunch[name],
                                         arec["glue_err"][name], brec),
                             **({"parent_ab_ms": g["ab"]} if "ab" in g
                                else {})))
    if serec is not None:
        say(json.dumps({"setup": serec}))
    if shrec is not None:
        say(json.dumps({"shard": shrec, "card": smi}))
    if svrec is not None:
        say(json.dumps({"serve": svrec, "card": smi}))
    if tlrec is not None:
        say(json.dumps({"tools": tlrec, "card": smi}))
    if skrec is not None:
        say(json.dumps({"soak": skrec, "card": smi}))
    if kern:
        say(json.dumps({"kernels": kern}))
    say(smi)
    say(f"chip_smoke: all phases passed in {time.time() - t_all:.1f} s")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
