#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (classpro_tpu_torch) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card; a few minutes

Phases, each of which fails the run (non-zero exit) when it fails:

1. probe   - CUDA present, card name and power limit (nvidia-smi).
2. build   - nvcc builds csrc/rel_dp.cu and csrc/unrel.cu for sm_90a
             (printing -Xptxas -v) while g++ builds the C++ host library,
             all three at once, from the checkout; rel_dp_kernel's and
             unrel_kernel's registers, stack and spill bytes are parsed
             from the log, and a stack or a spill fails the run.
3. kernel  - the DP kernel against its plain torch version (rel_ref) on
             the card: the packs of the medium fixture's chunks (batch 200,
             their natural (R, max_m) buckets) and a pack whose rows the
             no-H rescue re-runs (branch/search9); then the whole per-chunk
             stage (rel.rel_only) with the kernel against rel_only with the
             plain DP.  Tolerance: asgn bit-equal on rows whose plain margin
             is >= 1e-5, finite margins within 1e-9, the inf / 1e-30
             margin patterns equal, rescue equal, risky equal except where
             the margin lies within 1e-9 of 1e-5.  Times the kernel (CUDA
             events; us per step of the longest row) and the plain version
             at the medium shapes, with the launch geometry.
   k1profile, k5profile (only when named) - K1 (medium chunks) or K5
             (medium alldev chunks and the long-row chunk) built with its
             per-phase clocks against the production kernel bit for bit,
             both timed in turns, and the clock sums per step.
4. e2e     - the main path: classify_file_torch over the tiny and medium
             fixtures writes .class files byte-identical to their
             golden.class.gz; the launch counts are reset just before and
             read just after, and the DP kernel's must be > 0.
5. stream  - steady stream: --passes passes over medium through
             TorchEngine.classify_stream(sort_window=8) (the depth-3
             pipeline), every chunk checked against the golden; prints
             k-mers/s, DP-kernel time per launch (CUDA events), launches
             per chunk, guard_flagged and max_memory_allocated.
6. alldev  - the all-device path (alldev.classify_batch): on every chunk
             pack of medium at batch 200 the sweep kernel (csrc/unrel.cu)
             against its plain version (unrel_ref) on the card, asgn and
             margins bit-equal, and the whole classify_batch with the
             kernels against it with the plain versions, outputs and flags
             equal; times each (every chunk kept).  Then one synthetic
             long-row chunk (the tests' random_sweep_inputs, 256 rows of
             up to 1100 intervals: the rows' state in the global scratch)
             through the sweep kernel, bit-equal and timed.  Then
             TorchEngine(alldev=True) over tiny
             and medium writes the golden bytes (launch counts reset just
             before and read after: both kernels > 0), and a timed alldev
             stream of --alldev-passes passes over medium, 3 runs.
7. shard   - the parallel layer (K8) and the rest of classify's surface:
             (a) psum_histogram in a NCCL world of one rank equals its
             input (medium's partial instance histogram), the all-reduce
             timed with CUDA events, estimate_distributed == the .hist
             model; (b) the shard driver (run_process) with one process
             and with 4 in-process shards + the checked merge writes the
             tiny and medium goldens, and --resume after a truncated and
             a deleted shard recomputes only those two; (c)
             sharded_classify of 4 distinct medium read groups over
             cuda:{i % cards} equals one classify_batch per shard, its
             unflagged reads the C++ exact path, both kernels launched;
             (d) TorchEngine(devices=...) (every card, or cuda:0 twice on
             one card) writes the medium golden on both paths; (e)
             classify -s on tiny FASTX and on the tiny .dam fixture, and
             --stats-json, byte-equal to the fixtures; (f) with two or
             more cards, two NCCL ranks as processes of the driver; with
             one card it prints that (f) did not run.

It prints one {"kernels": [...]} line (each with its registers, stack and
spill bytes, launch geometry and us per step), {"stream": {...}},
{"alldev_stream": {...}} and {"shard": {...}} lines, the card's name and
power limit, and, as
its last line, {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

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
# f64 / int operations per DP-plane cell of the K4 glue (reversals,
# log-factorial lookups, E emission, rescue predicate, pack)
OPS_PER_K4_CELL = 30


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


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
    for name in kernels.SOURCES:
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
    for name in kernels.SOURCES:
        for line in kernels.BUILD_LOG[(name, "cuda")].splitlines():
            if "ptxas" in line or "bytes stack frame" in line:
                say(f"  {line.strip()}")
        say(f"build: nvcc {kernels.SOURCES[name][0]} {secs[name]:.1f} s")
    say(f"build: g++ host library {secs['host']:.1f} s (all three at once)")
    out = {}
    for name, entry in (("rel_dp", "rel_dp_kernel"),
                        ("unrel_sweeps", "unrel_kernel")):
        res = ptxas_resources(kernels.BUILD_LOG[(name, "cuda")], entry)
        say(f"build: {entry} {json.dumps(res)}")
        if res["stack_bytes"] or res["spill_store_bytes"] \
                or res["spill_load_bytes"]:
            fail(f"{entry} keeps a stack or spills: {res}")
        out[name] = res
    return out


def ptxas_resources(log: str, kernel: str) -> dict:
    """Registers, stack bytes and spill bytes of entry function ``kernel``
    from nvcc's -Xptxas -v output."""
    import re

    res: dict = {}
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
    if set(res) != {"stack_bytes", "spill_store_bytes", "spill_load_bytes",
                    "registers"}:
        fail(f"no -Xptxas -v resources for {kernel} in the build log")
    return res


# --------------------------------------------------------------------- 3
def _model(fx: str):
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx

    d = os.path.join(FIX, fx)
    args = {}
    if os.path.exists(os.path.join(d, "args.json")):
        with open(os.path.join(d, "args.json")) as f:
            args = json.load(f)
    root = os.path.join(d, "reads")
    gm = build_global_model(load_histogram(root), **args)
    P = open_profiles(root)
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
    """Kernel vs plain torch DP on the same card inputs."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.rel_ref import rel_dp_ref

    a_k, d_k, m_k = kernels.rel_dp(*planes, cov, P, active=active)
    a_r, d_r, m_r = rel_dp_ref(*planes, cov, P)
    torch.cuda.synchronize()
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
    return err, int(rows.sum()), int(ok.sum())


def _compare_rel_only(tag, fb, ib, P, R, max_m):
    from classpro_tpu_torch.rel import rel_only, unpack_out

    got = rel_only(fb, ib, P, R, max_m, impl="cuda").cpu().numpy()
    want = rel_only(fb, ib, P, R, max_m, impl="ref").cpu().numpy()
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
    return int(wres.sum())


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
            "steps": steps}


def _k4_bound(fb, ib, R: int, max_m: int) -> dict:
    """Least time for the K4 glue of one chunk: its two blobs read once
    and its packed result (2R, max_m+5) written once, against
    OPS_PER_K4_CELL operations per DP-plane cell."""
    nbytes = fb.nbytes + ib.nbytes + 2 * R * (max_m + 5)
    t_b = nbytes / PEAK_BYTES * 1e3
    t_o = 2 * R * max_m * OPS_PER_K4_CELL / PEAK_F64 * 1e3
    return {"ms": max(t_b, t_o), "by": "bytes" if t_b >= t_o
            else "operations", "bytes": nbytes}


def phase_kernel():
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.rel import rel_only, rel_planes, rescue_rows
    from classpro_tpu_torch.rel_ref import rel_dp_ref

    dev = torch.device("cuda")
    rec = {"max_abs_err": 0.0, "ms": [], "plain_ms": [], "bound": []}
    for fx in ("medium", "branch/search9"):
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
            err, n, n_ok = _compare_dp(tag, planes, cov, P)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            # the rescue pass: the rows the plain first pass rescues,
            # with their coverages, through the active mask
            rescue, cov2 = rescue_rows(
                planes, rel_dp_ref(*planes, cov, P)[0], P, max_m)
            if bool(rescue.any()):
                err2, _, _ = _compare_dp(tag + " rescue pass", planes, cov2,
                                         P, active=rescue)
                rec["max_abs_err"] = max(rec["max_abs_err"], err2)
            n_res2 = _compare_rel_only(tag, fb_d, ib_d, P, R, max_m)
            say(f"kernel == plain: {tag}: {n} rows ({n_ok} unflagged), "
                f"{n_res2} rescued, max |err| {rec['max_abs_err']:.3e}")
            if fx == "medium":
                ms = _time_cuda(lambda: kernels.rel_dp(*planes, cov, P), 20)
                t0 = time.perf_counter()
                rel_dp_ref(*planes, cov, P)
                torch.cuda.synchronize()
                plain = (time.perf_counter() - t0) * 1e3
                rec["ms"].append(ms)
                rec["plain_ms"].append(plain)
                bnd = _bound_ms(planes, cov, P)
                rec["bound"].append(bnd)
                stage = _time_cuda(lambda: rel_only(fb_d, ib_d, P, R, max_m,
                                                    impl="cuda"), 10)
                k4 = _k4_bound(fb, ib, R, max_m)
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
                    f"{bnd['ops_ms']:.6f} ms for {bnd['steps']} steps); "
                    f"whole rel_only stage (glue + 2 launches) {stage:.3f} "
                    f"ms per chunk; K4 glue bound {k4['ms']:.6f} ms "
                    f"({k4['by']}, {k4['bytes']} B)")
        if fx == "branch/search9" and not n_res2:
            fail("branch/search9 pack rescued no row")
    return rec


# --------------------------------------------------------- 3b (opt-in)
K1_PARTS = ("A", "exchange1", "B1", "exchange2", "B2", "exchange3", "C")
K5_PARTS = ("S", "exchangeA", "I", "exchangeB", "K", "exchangesCD_H", "D")


def _clock_profile(name: str, entry: str, parts, cases) -> dict:
    """A kernel's per-phase clocks (opt-in: --phases k1profile,
    k5profile).  Builds kernel ``name`` once more with -DRD_PHASE_CLOCKS;
    on each case (tag, C arguments, the tensors the launch writes, the
    production kernel's outputs) holds that build's outputs to the
    production kernel's bit for bit, times the two in turns (CUDA events
    over 20 launches, ctypes launches without the wrapper) and reads the
    clock sums (cycles per step of the warp's loop, lane 0 of each row)."""
    import ctypes

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
            rec["ms"][v].append(_time_cuda(lambda: fns[v](*args, stream), 20))
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


# --------------------------------------------------------------------- 4
def phase_e2e():
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.engine import classify_file_torch
    from classpro_tpu_torch.io.classfile import write_class

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
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
                f"{st['guard_flagged']})")
        launches = dict(kernels.LAUNCHES)
        if launches["rel_dp"] <= 0:
            fail("main path launched kernel rel_dp no time")
        say(f"e2e launches: {launches}")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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

    setattr(obj, name, g)
    return lambda: setattr(obj, name, f)


# the ``active`` pointer's place in the DP kernel's C arguments
# (kernels._args: the ten planes, cov, active)
_ACTIVE_ARG = 11


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


def phase_stream(passes: int, repeats: int = 3, batch_size: int = 200,
                 sort_window: int = 8):
    """Steady stream: ``repeats`` timed runs of ``passes`` passes over
    medium after one warm-up pass; the last run also records the DP
    kernel's device time (CUDA events around each launch) and where the
    main thread's time goes."""
    from classpro_tpu_torch import engine as engine_mod
    from classpro_tpu_torch import kernels

    gm, seqs, profs = _model("medium")
    gold = golden_classes("medium")
    kmers_pass = sum(len(c) - c.count("N") for c in gold[:len(seqs)])
    eng = engine_mod.TorchEngine(gm, batch_size=batch_size,
                                 device="cuda")
    B = 200                                  # input chunks, as the CLI
    spans = [(lo, min(lo + B, len(seqs))) for lo in range(0, len(seqs), B)]

    def run(n):
        chunks = ((seqs[lo:hi], profs[lo:hi])
                  for _ in range(n) for lo, hi in spans)
        t0 = time.perf_counter()
        for k, res in enumerate(eng.classify_stream(
                chunks, sort_window=sort_window)):
            lo, hi = spans[k % len(spans)]
            if res != gold[lo:hi]:
                fail(f"stream chunk {k} differs from the golden")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(1)                                   # warm-up pass
    rates = [passes * kmers_pass / run(passes) for _ in range(repeats - 1)]

    # the recorded run: DP events per launch kind, host time by stage
    events: dict = {"main": [], "rescue": []}
    acc: dict = {}
    undo = [_clock(eng, n, acc) for n in ("_stage", "_pack_st", "_submit",
                                          "_finish", "_exact_guard")]
    undo += [_clock(eng.wall, "finish_batch", acc)]
    undo += [_clock(engine_mod, n, acc)
             for n in ("unpack_out", "demote_host", "reconcile_fwbw")]
    torch.cuda.reset_peak_memory_stats()
    l0 = kernels.LAUNCHES["rel_dp"]
    g0, c0 = eng.guard_flagged, eng.chunks_done
    undo.append(_launch_events(
        lambda name, args: events["main" if args[_ACTIVE_ARG] is None
                                  else "rescue"]))
    try:
        wall = run(passes)
    finally:
        for u in undo:
            u()
    rates.append(passes * kmers_pass / wall)
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in events.items()}
    dp_ms = sum(ms["main"]) + sum(ms["rescue"])
    launches = kernels.LAUNCHES["rel_dp"] - l0
    chunks = eng.chunks_done - c0
    host = {
        "wall_stage_cpp": acc["_stage"], "pack_rel_cpp": acc["_pack_st"],
        "enqueue_h2d_dp_d2h": acc["_submit"] - acc["_stage"]
        - acc["_pack_st"],
        "wait_device": acc["_finish"] - acc["unpack_out"]
        - acc["demote_host"] - acc["reconcile_fwbw"] - acc["_exact_guard"]
        - acc["finish_batch"],
        "demote_reconcile_guard": acc["unpack_out"] + acc["demote_host"]
        + acc["reconcile_fwbw"] + acc["_exact_guard"],
        "finish_batch_cpp": acc["finish_batch"],
        "other": wall - acc["_submit"] - acc["_finish"]}
    res = {
        "batch_size": batch_size, "sort_window": sort_window,
        "passes": passes, "reads": passes * len(seqs),
        "kmers": passes * kmers_pass, "kmers_per_s_runs": rates,
        "kmers_per_s": statistics.median(rates), "wall_s": wall,
        "device_chunks": chunks, "dp_launches": launches,
        "launches_per_device_chunk": launches / max(chunks, 1),
        "dp_ms_per_launch": dp_ms / max(launches, 1),
        "dp_ms_per_main_launch": sum(ms["main"]) / max(len(ms["main"]), 1),
        "dp_ms_per_rescue_launch":
            sum(ms["rescue"]) / max(len(ms["rescue"]), 1),
        "dp_busy_share": dp_ms / 1e3 / wall,
        "host_s": host,
        "guard_flagged": eng.guard_flagged - g0,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    say(f"stream: {res['kmers_per_s'] / 1e6:.2f} M k-mers/s (median of "
        f"{repeats} runs of {passes} passes of medium, {res['reads']} "
        f"reads each), DP kernel {res['dp_ms_per_main_launch']:.3f} ms per "
        f"main launch + {res['dp_ms_per_rescue_launch']:.3f} ms per rescue "
        f"launch, {res['launches_per_device_chunk']:.2f} launches/chunk, "
        f"guard_flagged {res['guard_flagged']}")
    return res


# --------------------------------------------------------------------- 6
def _alldev_packs(eng, seqs, profs, B=200):
    """(fblob, iblob, dims) of every chunk, as TorchEngine(alldev=True)
    packs them."""
    from classpro_tpu_torch.pack import pack_chunk

    out = []
    for lo in range(0, len(seqs), B):
        st = eng._stage(seqs[lo:lo + B], profs[lo:lo + B])
        slab, slot, n_out = st["slab"], st["slot"], st["n_out"]
        rows = [r for r in range(len(st["g"])) if n_out[r] > 0]
        ivs = [slab[r * slot: r * slot + int(n_out[r])]
               for r in range(len(st["g"]))]
        fb, ib, dims, _ = pack_chunk(
            rows, ivs, [len(st["profiles"][i]) for i in st["g"]])
        out.append((fb, ib, dims))
    return out


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
    the plain version's output and its ms (one call)."""
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
    return a_r, plain


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


def phase_alldev():
    """Sweep kernel vs plain and classify_batch kernels vs plain on every
    medium chunk, and the sweep kernel on a long-row chunk, with times and
    bounds; returns the record."""
    from classpro_tpu_torch import alldev, kernels

    rec = {"max_abs_err": 0.0, "chunks": []}
    for k, c in enumerate(_alldev_chunks()):
        PP, fb, ib, fb_d, ib_d, dims = (c[x] for x in ("PP", "fb", "ib",
                                                       "fb_d", "ib_d",
                                                       "dims"))
        U, planes, asgn8, rescue, args = (c[x] for x in (
            "U", "planes", "asgn8", "rescue", "args"))
        Bn, max_n, R2, max_m = dims
        tag = f"medium alldev chunk {k} (Bn={Bn}, max_n={max_n}, " \
              f"R2={R2}, max_m={max_m})"
        a_r, plain = _compare_sweeps(tag, args, PP.unrel)
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
        say(f"kernel == plain: {tag}: sweeps bit-equal on {Bn} rows "
            f"({changed} intervals decided by the sweeps), classify_batch "
            f"equal ({int(f_k.sum())} flagged)")
        sw = _time_sweeps(args, PP.unrel, max_n, plain)
        bnd = sw["bound"]
        k6 = _time_cuda(lambda: _k6(U, asgn8, rescue, PP.rel, dims), 10)
        k7 = _time_cuda(lambda: alldev.classify_batch(fb_d, ib_d, PP, *dims,
                                                      impl="cuda"), 5)
        k6b = _k6_bound(fb, ib, dims)
        dpb = _bound_ms(planes, PP.rel.gcov[None, :].expand(
            R2, 4).contiguous(), PP.rel)
        k7b_bytes = fb.nbytes + ib.nbytes + Bn * max_n + Bn \
            + dpb["records"] * 40 + bnd["records"] * 40 + bnd["tails"] * 8
        k7b_ops = dpb["steps"] * OPS_PER_STEP + bnd["ops"]
        k7b = max(k7b_bytes / PEAK_BYTES, k7b_ops / PEAK_F64) * 1e3
        ch = dict(sw, dims=list(dims), k6_ms=k6, k6_bound=k6b, k7_ms=k7,
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
            f"bytes); classify_batch {k7:.3f} ms per chunk, plain "
            f"{k7_plain:.1f} ms, bound {k7b:.6f} ms ({ch['k7_bound_by']})")
    rec["geometry"] = kernels.unrel_geometry(Bn, max_n)
    # a long-row chunk: the rows' state in the global scratch
    args = _long_row_chunk(c["gm"])
    B, N = args[1].shape
    _, plain = _compare_sweeps(f"long-row chunk (B={B}, N={N})", args,
                               PP.unrel)
    lr = _time_sweeps(args, PP.unrel, N, plain)
    lr.update(B=B, N=N, geometry=kernels.unrel_geometry(B, N))
    rec["long_row"] = lr
    say(f"kernel == plain: long-row chunk (B={B}, N={N}, launch geometry "
        f"{json.dumps(lr['geometry'])}): bit-equal; {lr['ms']:.3f} ms per "
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
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.io.classfile import class_header

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
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
    launches = dict(kernels.LAUNCHES)
    for k, n in launches.items():
        if n <= 0:
            fail(f"alldev path launched kernel {k} no time")
    say(f"alldev e2e launches: {launches}")
    return launches


def phase_alldev_stream(passes: int, repeats: int = 3):
    """The alldev stream over medium: per run, k-mers/s, the sweep
    kernel's ms per launch (CUDA events), launches per chunk, the K4 + K6
    glue's device ms per chunk (classify_batch's span less its kernels')
    and max_memory_allocated."""
    from classpro_tpu_torch import alldev, kernels
    from classpro_tpu_torch import engine as engine_mod

    gm, seqs, profs = _model("medium")
    gold = golden_classes("medium")
    kmers_pass = sum(len(c) - c.count("N") for c in gold[:len(seqs)])
    eng = engine_mod.TorchEngine(gm, device=DEV, alldev=True)
    spans = [(lo, min(lo + 200, len(seqs))) for lo in range(0, len(seqs), 200)]

    def run(n):
        chunks = ((seqs[lo:hi], profs[lo:hi])
                  for _ in range(n) for lo, hi in spans)
        t0 = time.perf_counter()
        for k, res in enumerate(eng.classify_stream(chunks, sort_window=8)):
            lo, hi = spans[k % len(spans)]
            if res != gold[lo:hi]:
                fail(f"alldev stream chunk {k} differs from the golden")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def timed(fn, acc, host=None):
        def g(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            if host is not None:
                host["classify_batch"] = host.get("classify_batch", 0.0) \
                    + time.perf_counter() - t
            acc.append((e0, e1))
            return out
        return g

    run(1)                                   # warm-up pass
    runs = []
    for _ in range(repeats):
        ev: dict = {"rel_dp": [], "unrel_sweeps": [], "classify_batch": []}
        orig = alldev.classify_batch
        acc: dict = {}
        alldev.classify_batch = timed(orig, ev["classify_batch"], acc)
        undo = [_launch_events(lambda name, args: ev[name])]
        undo += [_clock(eng, n, acc) for n in ("_stage", "_submit", "_finish",
                                               "_exact_full")]
        undo += [_clock(engine_mod, n, acc)
                 for n in ("pack_chunk", "expand_asgn")]
        torch.cuda.reset_peak_memory_stats()
        c0, g0 = eng.chunks_done, eng.guard_flagged
        try:
            wall = run(passes)
        finally:
            alldev.classify_batch = orig
            for u in undo:
                u()
        a = lambda k: acc.get(k, 0.0)
        host = {"wall_stage_cpp": a("_stage"),
                "pack_chunk_numpy": a("pack_chunk"),
                "classify_batch_enqueue": a("classify_batch"),
                "pin_h2d_d2h_other_enqueue": a("_submit") - a("_stage")
                - a("pack_chunk") - a("classify_batch"),
                "wait_device": a("_finish") - a("expand_asgn")
                - a("_exact_full"),
                "expand_asgn_numpy": a("expand_asgn"),
                "exact_guard": a("_exact_full"),
                "other": wall - a("_submit") - a("_finish")}
        ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in ev.items()}
        chunks = len(ms["classify_batch"])
        glue = (sum(ms["classify_batch"]) - sum(ms["rel_dp"])
                - sum(ms["unrel_sweeps"]))
        r = {"kmers_per_s": passes * kmers_pass / wall, "wall_s": wall,
             "device_chunks": chunks, "engine_chunks": eng.chunks_done - c0,
             "unrel_ms_per_launch": sum(ms["unrel_sweeps"])
             / max(len(ms["unrel_sweeps"]), 1),
             "unrel_launches_per_chunk": len(ms["unrel_sweeps"])
             / max(chunks, 1),
             "rel_dp_ms_per_launch": sum(ms["rel_dp"])
             / max(len(ms["rel_dp"]), 1),
             "rel_dp_launches_per_chunk": len(ms["rel_dp"]) / max(chunks, 1),
             "glue_k4_k6_ms_per_chunk": glue / max(chunks, 1),
             "classify_batch_ms_per_chunk": sum(ms["classify_batch"])
             / max(chunks, 1),
             "device_busy_share": sum(ms["classify_batch"]) / 1e3 / wall,
             "guard_flagged": eng.guard_flagged - g0,
             "max_memory_allocated": torch.cuda.max_memory_allocated(),
             "host_s": host}
        runs.append(r)
        say(f"alldev stream run {len(runs)}: {r['kmers_per_s'] / 1e6:.2f} M "
            f"k-mers/s ({passes} passes of medium), sweep kernel "
            f"{r['unrel_ms_per_launch']:.3f} ms per launch, "
            f"{r['unrel_launches_per_chunk']:.2f} launches/chunk, DP kernel "
            f"{r['rel_dp_ms_per_launch']:.3f} ms x "
            f"{r['rel_dp_launches_per_chunk']:.2f}/chunk, K4+K6 glue "
            f"{r['glue_k4_k6_ms_per_chunk']:.3f} ms/chunk, classify_batch "
            f"{r['classify_batch_ms_per_chunk']:.3f} ms/chunk, "
            f"guard_flagged {r['guard_flagged']}, max_memory_allocated "
            f"{r['max_memory_allocated']}; main thread s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))
    return {"passes": passes, "runs": runs,
            "kmers_per_s": statistics.median(r["kmers_per_s"] for r in runs)}


# --------------------------------------------------------------------- 7
# the --stats-json keys of the JAX package's classify (cli.py:287-294 and
# engine.py:1035-1042)
STATS_KEYS = {"wall_s", "kmers", "reads", "stream_wall_s", "chunks",
              "absorbed_chunks", "guard_flagged", "min_margin", "shapes"}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reset_launches() -> None:
    from classpro_tpu_torch import kernels

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0


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
    if launches["rel_dp"] <= 0:
        fail("driver path launched kernel rel_dp no time")

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

    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.alldev import classify_batch
    from classpro_tpu_torch.native import NativeWall
    from classpro_tpu_torch.pack import expand_asgn, pack_chunk
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
    groups = [sorted(order[d::4]) for d in range(4)]
    packs = [pack_chunk(g, ivs, plens) for g in groups]
    dims = packs[0][2]
    if any(p[2] != dims for p in packs):
        fail(f"sharded: groups differ in dims {[p[2] for p in packs]}")
    fbs = np.stack([p[0] for p in packs])
    ibs = np.stack([p[1] for p in packs])
    PPs = build_replicas(gm, devices, alldev=True)
    sharded_classify(devices, fbs, ibs, PPs, dims)      # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    out, flags = sharded_classify(devices, fbs, ibs, PPs, dims)
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    if launches["rel_dp"] <= 0 or launches["unrel_sweeps"] <= 0:
        fail(f"sharded_classify launches {launches}: a kernel ran no time")
    checked = 0
    for d, (g, (fb, ib, _, meta)) in enumerate(zip(groups, packs)):
        dev = torch.device(devices[d])
        o, f = classify_batch(torch.from_numpy(fb).to(dev),
                              torch.from_numpy(ib).to(dev), PPs[dev], *dims)
        if not (np.array_equal(out[d], o.cpu().numpy())
                and np.array_equal(flags[d], f.cpu().numpy())):
            fail(f"sharded: shard {d} != a single classify_batch on it")
        res = [None] * len(seqs)
        expand_asgn(out[d], meta, res, gm.kmer)
        for r, i in enumerate(g):
            if flags[d][r]:
                continue
            want = _exact_classes(wall, seqs[i], ivs[i], plens[i])
            if res[i] != want or want != gold[i]:
                fail(f"sharded: shard {d} read {i} != the C++ exact path")
            checked += 1
    rec.update(sharded_devices=[str(d) for d in devices],
               sharded_dims=list(dims), sharded_ms=ms,
               sharded_launches=launches, sharded_reads_checked=checked,
               sharded_flagged=int(flags.sum()))
    say(f"shard (c) sharded_classify over {devices}: 4 shards at dims "
        f"{dims} == one classify_batch each; {checked} unflagged reads == "
        f"the C++ exact path, {int(flags.sum())} flagged; {ms:.2f} ms for "
        f"the 4 shards; launches {launches}")


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
        need = ("rel_dp", "unrel_sweeps") if alldev else ("rel_dp",)
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


# ---------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="build,kernel,e2e,stream,alldev,shard",
                    help="comma-separated subset (the probe always runs; "
                    "k1profile and k5profile, the kernels' phase "
                    "clocks, only when named)")
    ap.add_argument("--passes", type=int, default=40,
                    help="steady-stream passes over medium")
    ap.add_argument("--alldev-passes", type=int, default=10,
                    help="alldev-stream passes over medium")
    ap.add_argument("--batch-size", type=int, default=200,
                    help="steady stream: reads per device chunk")
    ap.add_argument("--sort-window", type=int, default=8,
                    help="steady stream: classify_stream's sort_window")
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
    krec = phase_kernel() if "kernel" in phases else None
    if "k1profile" in phases:
        say(json.dumps({"k1_profile": phase_k1profile(), "card": smi}))
    if "k5profile" in phases:
        say(json.dumps({"k5_profile": phase_k5profile(), "card": smi}))
    launches = phase_e2e() if "e2e" in phases else None
    srec = (phase_stream(args.passes, batch_size=args.batch_size,
                         sort_window=args.sort_window)
            if "stream" in phases else None)
    arec = alaunch = asrec = None
    if "alldev" in phases:
        arec = phase_alldev()
        alaunch = phase_alldev_e2e()
        asrec = phase_alldev_stream(args.alldev_passes)
    shrec = phase_shard() if "shard" in phases else None
    if srec is not None:
        say(json.dumps({"stream": srec, "card": smi}))
    if asrec is not None:
        say(json.dumps({"alldev_stream": asrec, "alldev": arec,
                        "card": smi}))
    kern = []
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
            **(brec or {}).get("rel_dp", {}), **krec["geometry"]})
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
            **(brec or {}).get("unrel_sweeps", {}), **arec["geometry"]})
    if shrec is not None:
        say(json.dumps({"shard": shrec, "card": smi}))
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
