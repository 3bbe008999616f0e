"""Command-line interface of the PyTorch/CUDA port.

Subcommands mirror the JAX package's (and the reference tool family):

* ``classify``   — ClassPro: E/H/D/R per k-mer of every read, on FASTX
  input (``-s`` writes ``<out>.seeds`` and ``<out>.rep``) or DAZZ
  ``.db``/``.dam`` input (``.class`` and ``.rep`` tracks beside the
  database); ``--devices N`` round-robins the chunks over ``cuda:0`` ..
  ``cuda:N-1``; ``--engine exact`` runs the pure-Python oracle instead of
  the device engine; ``--pmm``, ``--warmup``, ``--stats-json`` and
  ``--torch-profile DIR`` (a profiler trace of the stream);
  ``--server SOCK`` hands the job to a running ``serve`` daemon
* ``serve``      — the warm-engine daemon (serve.py)
* ``classgs``, ``gs-thresholds`` — global-threshold classifier (ClassGS.c)
* ``prof2class`` — ground truth from a relative profile (prof2class.c)
* ``class2acc``  — accuracy evaluation (class2acc.c)
* ``class2cns``  — k-mer/class dump or consensus consistency (class2cns.c)
* ``show-seeds``, ``repdepanno`` — seed-track consumers of a classified
  DAZZ database (ShowSeeds.c, RepDepAnno.c)
* ``debug-read`` — one read's oracle and production internals side by
  side; exit 0 when they agree, 2 when they diverge
* ``simulate``   — synthetic dataset generator
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

from classpro_tpu_torch.io.fastx import FASTX_EXTS, root_of

# input extensions, in the reference's probe order (ClassPro.h:326)
_EXTS = (".db", ".dam") + FASTX_EXTS


def _check_classify_args(args) -> None:
    """The reference's argument refusals (ClassPro.c:348-500): -T
    positive, -c non-negative, -r positive, -P an existing directory,
    the input openable under a known extension (probed in the
    reference's order).  Each violation exits 1 with one stderr line."""
    if args.threads <= 0:
        raise ValueError(f"Number of threads must be positive "
                         f"({args.threads})")
    if args.coverage < 0:
        raise ValueError(f"Estimated k-mer coverage must be non-negative "
                         f"({args.coverage})")
    if args.read_len <= 0:
        raise ValueError(f"Average read length must be positive "
                         f"({args.read_len})")
    if not os.path.isdir(args.tmp_dir):
        raise ValueError(f"-P option: cannot open directory {args.tmp_dir}")
    for ext in _EXTS:
        root = (args.source[: -len(ext)]
                if args.source.endswith(ext) else args.source)
        if os.path.exists(root + ext):
            args.source = root + ext
            return
    raise ValueError(f"Cannot open {args.source} as a .db|.dam or "
                     f".f{{ast}}[aq][.gz] file")


def _classify_db(args, stats: dict) -> str:
    """DAZZ .db/.dam input: classify (on the device engine, or with
    ``--engine exact`` on the oracle), write the .class file and the DAZZ
    .class/.rep tracks (ClassPro.c:289-304, io.c); returns the .class
    path."""
    import time

    import numpy as np

    from classpro_tpu_torch.engine import TorchEngine, local_devices
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.dazz import (DazzDB, IntPairTrackWriter,
                                            TrackWriter, compress_codes)
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.native import NativeSeedWorkspace

    db = DazzDB(args.source)
    fk_root = args.fastk_root or db.root
    out = args.output or db.root + ".class"
    gm = build_global_model(load_histogram(fk_root), coverage=args.coverage,
                            read_len=args.read_len, model_path=args.model)
    P = open_profiles(fk_root)
    if args.engine == "exact":
        from classpro_tpu_torch.exact.pipeline import ReadClassifier

        clf = ReadClassifier(gm)

        def stream(chunks):
            for seqs, profs in chunks:
                yield [clf.classify(s, p) if len(p) else "N" * len(s)
                       for s, p in zip(seqs, profs)]
    else:
        eng = TorchEngine(gm, threads=args.threads, verbose=args.verbose,
                          device=args.device,
                          devices=local_devices(args.devices, args.device))
        stream = eng.classify_stream
    K = gm.kmer
    ctos = np.zeros(256, np.uint8)        # const.c stoc order E,R,H,D
    for code, ch in enumerate(b"ERHD"):
        ctos[ch] = code

    tw = TrackWriter(db.root, "class", db.nreads, 8)
    rw = IntPairTrackWriter(db.root, "rep", db.nreads)
    ws = NativeSeedWorkspace() if args.seeds else None
    bs = 200
    spans = [(lo, min(lo + bs, db.nreads))
             for lo in range(0, db.nreads, bs)]
    # classify_stream pulls this generator synchronously and keeps at most
    # 3 chunks in flight (more with --devices), and the consumer below
    # pops one entry per result, so the cache stays small
    cache: dict = {}

    def chunk_iter():
        for lo, hi in spans:
            seqs = [db.load_read(i) for i in range(lo, hi)]
            profs = [P.fetch(i) for i in range(lo, hi)]
            for j, p in enumerate(profs):  # ClassPro.c:184-187 rlen check
                want = max(len(seqs[j]) - K + 1, 0)
                if len(p) != want:
                    raise ValueError(
                        f"Read {lo + j}: rlen ({len(seqs[j])}) != "
                        f"plen+Km1 ({len(p) + K - 1}) — profile/read "
                        f"mismatch")
            cache[lo] = (seqs, profs)
            yield seqs, profs

    t0 = time.time()
    try:
        with open(out, "w") as cf:
            for (lo, hi), classes in zip(spans, stream(chunk_iter())):
                seqs, profs = cache.pop(lo)
                for j, i in enumerate(range(lo, hi)):
                    cf.write(f"{db.header(i)}\n{seqs[j]}\n+\n{classes[j]}\n")
                    stats["kmers"] += len(classes[j]) - classes[j].count("N")
                    stats["reads"] += 1
                    body = classes[j]
                    if ws is not None and len(profs[j]) > 0:
                        labels, rints = ws.find_seeds(
                            seqs[j], classes[j][K - 1:], profs[j], K)
                        body = "N" * (K - 1) + labels
                        rw.add(rints)
                    codes = ctos[np.frombuffer(body.encode(), np.uint8)]
                    tw.add(compress_codes(codes))
    finally:
        tw.close()
        rw.close()
        db.close()
    stats.update(stream_wall_s=time.time() - t0,
                 **({} if args.engine == "exact" else eng.stats()))
    return out


def _with_seeds(records, fk_root: str, out: str):
    """Pass the records through, writing each read's seed labels to
    ``<out>.seeds`` and its repeat intervals to ``<out>.rep``."""
    from classpro_tpu_torch.io.fastk import open_profiles
    from classpro_tpu_torch.native import NativeSeedWorkspace

    ws = NativeSeedWorkspace()
    P = open_profiles(fk_root)
    K = P.kmer
    with open(out + ".seeds", "w") as sf, open(out + ".rep", "w") as rf:
        for rid, rec in enumerate(records):
            prof = P.fetch(rid)
            if len(prof) > 0:
                labels, rints = ws.find_seeds(rec.seq, rec.classes[K - 1:],
                                              prof, K)
                sf.write(rec.header + "\n" + "N" * (K - 1) + labels + "\n")
                for b, e in rints:
                    rf.write(f"{rid}\t{b}\t{e}\n")
            else:
                sf.write(rec.header + "\n" + "N" * len(rec.seq) + "\n")
            yield rec


def _via_server(args) -> int:
    """Hand a plain FASTX job to the daemon at ``args.server``
    (absolute paths; the connect is bounded, the job is not)."""
    from classpro_tpu_torch.serve import request

    if args.seeds or args.engine == "exact" or \
            args.source.endswith((".db", ".dam")):
        raise ValueError("--server supports plain FASTX classify "
                         "jobs (no -s/--engine exact/.db/.dam)")
    root = root_of(args.source)
    rep = request(args.server, {
        "cmd": "classify", "source": os.path.abspath(args.source),
        "fastk_root": os.path.abspath(args.fastk_root or root),
        "output": os.path.abspath(args.output or root + ".class"),
        "coverage": args.coverage, "read_len": args.read_len,
        "model": args.model and os.path.abspath(args.model),
        "threads": args.threads, "warmup": args.warmup,
    }, timeout=30.0)
    if not rep.get("ok"):
        print(f"server error: {rep.get('error')}", file=sys.stderr)
        return 1
    if args.verbose:
        print(f"server: {rep['reads']} reads in {rep['wall_s']}s "
              f"-> {rep['output']} (warm shapes "
              f"{rep['warm_shapes']})", file=sys.stderr)
    return 0


def _print_pmm(args, fk_root: str) -> None:
    """Per-read Poisson-mixture H/D coverage estimates to stderr (the
    reference's DO_PMM, hist.c:159-310)."""
    import numpy as np

    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.pmm import PmmModel

    hist = load_histogram(fk_root)
    gm = build_global_model(hist, coverage=args.coverage,
                            read_len=args.read_len, model_path=args.model)
    by_count = np.zeros(hist.high + 1, np.int64)
    by_count[hist.low: hist.high + 1] = hist.instance_counts()
    pm = PmmModel(gm, by_count)
    P = open_profiles(fk_root)
    for rid in range(P.nreads):
        n, lam = pm.pmm_vi(P.fetch(rid))
        print(f"read {rid}: N={n} lambda=({lam[0]:.1f},{lam[1]:.1f})",
              file=sys.stderr)


def _profiled(trace_dir: str | None, device: str):
    """A context that traces its body with torch.profiler (CPU, plus
    CUDA on a card) and exports a Chrome trace into ``trace_dir``; a
    null context without it.  On a card the trace must hold device
    kernels whenever a kernel was launched: a profiler that could not
    record the card's activity fails the run."""
    import contextlib

    if not trace_dir:
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def ctx():
        import json
        import time

        import torch
        from torch.profiler import ProfilerActivity, profile

        from classpro_tpu_torch import kernels

        cuda = torch.device(device).type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"classify.{os.getpid()}."
                            f"{int(time.time())}.pt.trace.json")
        before = sum(kernels.LAUNCHES.values())
        with profile(activities=acts) as prof:
            yield
            if cuda:
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        print(f"wrote torch profiler trace to {path}", file=sys.stderr)
        if cuda and sum(kernels.LAUNCHES.values()) > before:
            with open(path) as f:
                evs = json.load(f).get("traceEvents", [])
            if not any(e.get("cat") == "kernel" for e in evs):
                raise RuntimeError(
                    f"{path}: the profiler recorded no CUDA kernel "
                    f"although kernels ran (no CUDA activity tracing "
                    f"on this machine?)")
    return ctx()


def cmd_classify(args: argparse.Namespace) -> int:
    import json
    import time

    from classpro_tpu_torch.io.classfile import write_class
    from classpro_tpu_torch.timing import PhaseTimer

    _check_classify_args(args)
    if args.server:
        return _via_server(args)
    timer = PhaseTimer()
    stats = {"kmers": 0, "reads": 0}
    exact = args.engine == "exact"
    if args.source.endswith((".db", ".dam")):
        out = _classify_db(args, stats) + " + .class/.rep tracks"
        wall = stats["stream_wall_s"]
    else:
        root = root_of(args.source)
        fk_root = args.fastk_root or root
        out = args.output or root + ".class"
        if args.pmm:
            _print_pmm(args, fk_root)
        # the device engine writes through the output plane (each
        # chunk's records composed in C++ and written off this thread);
        # -s and the exact oracle keep the record route
        job = recs = None
        if exact:
            from classpro_tpu_torch.exact.pipeline import classify_file

            recs = classify_file(args.source, fk_root,
                                 coverage=args.coverage,
                                 read_len=args.read_len,
                                 model_path=args.model)
        else:
            from classpro_tpu_torch.engine import ClassifyJob

            job = ClassifyJob(
                args.source, fk_root, coverage=args.coverage,
                read_len=args.read_len, model_path=args.model,
                threads=args.threads, verbose=args.verbose,
                device=args.device, devices=args.devices, stats_out=stats,
                warmup=args.warmup)
        if args.seeds:
            recs = _with_seeds(recs or job.records(), fk_root, out)

        def counted(records):
            for rec in records:
                stats["kmers"] += len(rec.classes) - rec.classes.count("N")
                stats["reads"] += 1
                yield rec

        t0 = time.time()       # set-up ran in ClassifyJob
        with _profiled(args.torch_profile, args.device):
            if recs is None:
                w = job.write(out)
                stats.update(reads=w.reads, kmers=w.kmers)
            else:
                write_class(out, counted(recs))
        wall = time.time() - t0
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(dict(wall_s=round(wall, 2), **stats), f)
    if args.verbose:
        where = "the exact oracle" if exact else args.device
        print(f"wrote {out}", file=sys.stderr)
        print(f"{stats['reads']} reads, {stats['kmers']} k-mers in "
              f"{wall:.2f}s = {stats['kmers'] / max(wall, 1e-9) / 1e6:.2f} "
              f"Mk-mers/s on {where}"
              + ("" if "guard_flagged" not in stats else
                 f"; exactness guard flagged {stats['guard_flagged']} "
                 f"read(s)"), file=sys.stderr)
        print(timer.report(total=True), file=sys.stderr)
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    from classpro_tpu_torch.serve import serve

    shapes = tuple(tuple(int(x) for x in s.lower().split("x"))
                   for s in args.warmup_shape)
    return serve(args.socket, warmup_root=args.warmup_root,
                 warmup_shapes=shapes, verbose=args.verbose,
                 device=args.device)


def cmd_debug_read(args: argparse.Namespace) -> int:
    from classpro_tpu_torch.tools.debug_read import debug_read

    same = debug_read(args.source, args.read_id,
                      fastk_root=args.fastk_root, coverage=args.coverage,
                      read_len=args.read_len, model_path=args.model,
                      device=args.device)
    return 0 if same else 2


def cmd_classgs(args: argparse.Namespace) -> int:
    from classpro_tpu_torch.io.classfile import write_class
    from classpro_tpu_torch.tools.classgs import classify_gs_file

    root = root_of(args.source)
    out = args.output or root + ".GS.class"
    write_class(out, classify_gs_file(args.source, args.fastk_root or root,
                                      (args.eh, args.hd, args.dr)))
    return 0


def cmd_prof2class(args: argparse.Namespace) -> int:
    from classpro_tpu_torch.io.classfile import write_class
    from classpro_tpu_torch.tools.prof2class import prof2class_file

    root = root_of(args.source)
    out = args.output or root + ".truth.class"
    write_class(out, prof2class_file(args.truth_prof, args.source))
    return 0


def cmd_class2acc(args: argparse.Namespace) -> int:
    from classpro_tpu_torch.tools.class2acc import main_run

    return main_run(args.estimate, args.truth, thres_e=args.max_e,
                    thres_r=args.min_r, thres_lq=args.show_lq,
                    show_class=args.show_class, min_r=args.lq_min_r,
                    max_r=args.lq_max_r, window=args.window,
                    prof_root=args.profile, out=sys.stdout)


def cmd_gsthresholds(args: argparse.Namespace) -> int:
    from classpro_tpu_torch.tools.classgs import genomescope_thresholds

    print(" ".join(str(t) for t in genomescope_thresholds(args.gs_dir)))
    return 0


def cmd_class2cns(args: argparse.Namespace) -> int:
    from classpro_tpu_torch.tools.class2cns import consistency, dump

    if args.consistency:
        print(f"Overall consistency = "
              f"{consistency(args.estimate, args.fastk_root)}")
    else:
        dump(args.estimate, args.fastk_root, sys.stdout)
    return 0


def cmd_show_seeds(args: argparse.Namespace) -> int:
    from classpro_tpu_torch.tools.seedtracks import show_seeds

    show_seeds(args.fastk_root, args.db, sys.stdout)
    return 0


def cmd_repdepanno(args: argparse.Namespace) -> int:
    from classpro_tpu_torch.tools.seedtracks import rep_dep_anno

    n = rep_dep_anno(args.fastk_root, args.db)
    print(f"{n} seed positions", file=sys.stderr)
    return 0


def cmd_simulate(args: argparse.Namespace) -> int:
    from classpro_tpu_torch.tools.simulate import SimConfig, generate_dataset

    extra = {}
    if args.repeat_rich:
        # ~15% of the genome in satellite arrays + two 10kb segdups
        n_arr = max(1, args.genome_len // 70_000)
        extra = dict(n_satellite_arrays=n_arr,
                     n_segdups=2 if args.genome_len > 25_000 else 0)
    cfg = SimConfig(seed=args.seed, genome_len=args.genome_len,
                    coverage=args.coverage, read_len_mean=args.read_len,
                    kmer=args.kmer, **extra)
    info = generate_dataset(args.outdir, cfg, nparts=args.nparts)
    print(info)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="classpro-tpu-torch",
                                 description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("classify", help="classify every k-mer of every read")
    c.add_argument("source",
                   help="reads (.db/.dam or .fasta/.fastq[.gz])")
    c.add_argument("-N", "--fastk-root",
                   help="FASTK output root (default: source root)")
    c.add_argument("-o", "--output", help="output .class path")
    c.add_argument("-c", "--coverage", type=int, default=0,
                   help="k-mer D-coverage override (-c in reference)")
    c.add_argument("-r", "--read-len", type=int, default=20000,
                   help="average read length (-r)")
    c.add_argument("-M", "--model", help="HIsim error model file (-M)")
    c.add_argument("-P", "--tmp-dir", default=".",
                   help="temp directory (-P in the reference; output is "
                        "streamed and no temp file is made, so it is "
                        "only checked, for CLI compatibility)")
    c.add_argument("-T", "--threads", type=int, default=4,
                   help="host-side worker count")
    c.add_argument("-v", "--verbose", action="store_true")
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the device work runs: the CUDA kernels "
                        "(default) or their plain PyTorch versions on the "
                        "CPU")
    c.add_argument("--engine", choices=["exact", "device"],
                   default="device",
                   help="device: the streaming engine on --device "
                        "(default); exact: the pure-Python oracle (slow, "
                        "no card)")
    c.add_argument("--pmm", action="store_true",
                   help="report per-read Poisson-mixture H/D coverage "
                        "estimates to stderr (ref DO_PMM, hist.c:159-310)")
    c.add_argument("-s", "--seeds", action="store_true",
                   help="also select alignment seeds (-s in reference): "
                        "FASTX input writes <out>.seeds (per-position "
                        "labels) and <out>.rep (repeat intervals per "
                        "read); DAZZ input writes the seeds into the "
                        ".class track and the intervals into the .rep "
                        "track")
    c.add_argument("--devices", type=int, default=0, metavar="N",
                   help="round-robin chunks over cuda:0..N-1 (replicated "
                        "tables, no cross-device traffic; 0 = the default "
                        "device only); fewer cards than N is an error")
    c.add_argument("--warmup", action="store_true",
                   help="before streaming, build and load the kernels, "
                        "put the tables on the device and run the DP once "
                        "at the dataset's expected shape bucket (sampled "
                        "from its first reads); output is unchanged")
    c.add_argument("--stats-json", metavar="PATH",
                   help="write run telemetry (wall, reads, k-mers, guard "
                        "flag count and min margin, shape buckets) as JSON")
    c.add_argument("--torch-profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace (CPU, plus "
                        "CUDA on a card) of the classification stream "
                        "into DIR")
    c.add_argument("--server", metavar="SOCK",
                   help="delegate the job to a running `serve` daemon at "
                        "this unix socket (kernels, CUDA context and "
                        "tables already warm)")
    c.set_defaults(fn=cmd_classify)

    sv = sub.add_parser(
        "serve", help="persistent warm-engine daemon: keeps the kernels, "
                      "the CUDA context and the tables across jobs; "
                      "clients attach with `classify --server SOCK`")
    sv.add_argument("--socket", required=True, metavar="SOCK",
                    help="unix socket path to listen on")
    sv.add_argument("--warmup-root", metavar="FASTK_ROOT",
                    help="run the DP once per warm-up shape with this "
                         "dataset's model before taking traffic")
    sv.add_argument("--warmup-shape", action="append", default=[],
                    metavar="RxM", help="shape bucket(s) to warm, e.g. "
                                        "256x192 (repeatable)")
    sv.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the jobs' device work runs (default cuda)")
    sv.add_argument("-v", "--verbose", action="store_true")
    sv.set_defaults(fn=cmd_serve)

    g = sub.add_parser("classgs", help="global-threshold classification")
    g.add_argument("source")
    g.add_argument("eh", type=int, help="E/H count threshold")
    g.add_argument("hd", type=int, help="H/D count threshold")
    g.add_argument("dr", type=int, help="D/R count threshold")
    g.add_argument("-N", "--fastk-root")
    g.add_argument("-o", "--output")
    g.set_defaults(fn=cmd_classgs)

    p = sub.add_parser("prof2class", help="ground truth from relative profile")
    p.add_argument("truth_prof", help="relative profile root (FastK -p:<genome>)")
    p.add_argument("source", help="reads fastx")
    p.add_argument("-o", "--output")
    p.set_defaults(fn=cmd_prof2class)

    a = sub.add_parser("class2acc", help="accuracy vs truth .class")
    a.add_argument("estimate")
    a.add_argument("truth")
    a.add_argument("-f", "--max-e", type=int, default=100,
                   help="ignore reads with %%E-mer above this (ref -f)")
    a.add_argument("-r", "--min-r", type=int, default=0,
                   help="reads with %%R-mer above this are Repeat (ref -r)")
    a.add_argument("-e", "--show-lq", type=int, default=None,
                   help="report each read with misclassification rate "
                        ">= this %% (ref -e)")
    a.add_argument("-s", "--show-class", action="store_true",
                   help="with -e: print truth + masked estimate strings")
    a.add_argument("-m", "--lq-min-r", type=int, default=0,
                   help="with -e: min %%R-mer of a read to show (ref -m)")
    a.add_argument("-n", "--lq-max-r", type=int, default=100,
                   help="with -e: max %%R-mer of a read to show (ref -n)")
    a.add_argument("-w", "--window", type=int, default=None,
                   help="with -p: per-window accuracy/coverage (ref -w)")
    a.add_argument("-p", "--profile", default=None,
                   help="read profile root for coverage columns (ref -p)")
    a.set_defaults(fn=cmd_class2acc)

    gt = sub.add_parser("gs-thresholds",
                        help="E/H, H/D, D/R count thresholds from a "
                             "GenomeScope --fitted_hist output dir")
    gt.add_argument("gs_dir")
    gt.set_defaults(fn=cmd_gsthresholds)

    n = sub.add_parser("class2cns",
                       help="k-mer/class dump or consensus consistency")
    n.add_argument("estimate")
    n.add_argument("fastk_root")
    n.add_argument("-c", "--consistency", action="store_true",
                   help="print the harmonic-mean most-common-class "
                        "fraction instead of the dump")
    n.set_defaults(fn=cmd_class2cns)

    ss = sub.add_parser("show-seeds",
                        help="print seeds from a classified DB's track")
    ss.add_argument("fastk_root")
    ss.add_argument("db")
    ss.set_defaults(fn=cmd_show_seeds)

    rda = sub.add_parser("repdepanno",
                         help="emit .seed tracks from a classified DB")
    rda.add_argument("fastk_root")
    rda.add_argument("db")
    rda.set_defaults(fn=cmd_repdepanno)

    dr = sub.add_parser(
        "debug-read",
        help="single-read triage dump: oracle vs production internals "
             "(the reference's compile-time DEBUG_SINGLE, ClassPro.h:11-13, "
             "as a runtime command); exit 2 when they diverge")
    dr.add_argument("source", help="reads (.fasta/.fastq[.gz])")
    dr.add_argument("read_id", type=int)
    dr.add_argument("-N", "--fastk-root")
    dr.add_argument("-c", "--coverage", type=int, default=0)
    dr.add_argument("-r", "--read-len", type=int, default=20000)
    dr.add_argument("-M", "--model")
    dr.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the production half's device work runs "
                         "(default cuda)")
    dr.set_defaults(fn=cmd_debug_read)

    s = sub.add_parser("simulate", help="generate synthetic dataset")
    s.add_argument("outdir")
    s.add_argument("--seed", type=int, default=7)
    s.add_argument("--genome-len", type=int, default=100_000)
    s.add_argument("--coverage", type=float, default=40.0)
    s.add_argument("--read-len", type=int, default=10_000)
    s.add_argument("--kmer", type=int, default=40)
    s.add_argument("--nparts", type=int, default=1)
    s.add_argument("--repeat-rich", action="store_true",
                   help="adversarial repeat structure: alpha-satellite-"
                        "like tandem arrays (divergent 171bp monomers) "
                        "+ segmental duplications (centromere-grade R "
                        "tracts and max_m bucket pressure)")
    s.set_defaults(fn=cmd_simulate)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError, struct.error) as e:
        # bad/missing input or a refused option: one line, exit 1, like
        # the reference
        print(f"classpro-tpu-torch: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
