"""Command-line interface of the PyTorch/CUDA port.

``python -m classpro_tpu_torch.cli classify <reads>`` classifies every
k-mer of every read (E/H/D/R) and writes the ``.class`` file, as the JAX
package's ``classify`` does:

* FASTX input (``.fasta``/``.fastq``, optionally gzipped), with ``-s``
  writing the alignment seeds to ``<out>.seeds`` and the repeat intervals
  to ``<out>.rep``;
* DAZZ ``.db``/``.dam`` input, writing the ``.class`` file and the
  ``.class`` and ``.rep`` DAZZ tracks beside the database;
* ``--devices N`` round-robins the chunks over ``cuda:0`` .. ``cuda:N-1``;
  ``--stats-json`` writes the run's telemetry.

``--server`` (the serve daemon) belongs to a later slice of the port and
is refused with a message saying so.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

from classpro_tpu_torch.io.fastx import FASTX_EXTS, root_of

# input extensions, in the reference's probe order (ClassPro.h:326)
_EXTS = (".db", ".dam") + FASTX_EXTS

_LATER = "not ported yet: {what} comes with a later slice of the " \
         "PyTorch port ({slice}); use `python -m classpro_tpu.cli` for it"


def _check_classify_args(args) -> None:
    """The reference's argument refusals (ClassPro.c:348-500): -T
    positive, -c non-negative, -r positive, the input openable under a
    known extension (probed in the reference's order); plus the option
    this slice does not carry."""
    if args.server:
        raise ValueError(_LATER.format(what="--server",
                                       slice="serve, M6"))
    if args.threads <= 0:
        raise ValueError(f"Number of threads must be positive "
                         f"({args.threads})")
    if args.coverage < 0:
        raise ValueError(f"Estimated k-mer coverage must be non-negative "
                         f"({args.coverage})")
    if args.read_len <= 0:
        raise ValueError(f"Average read length must be positive "
                         f"({args.read_len})")
    for ext in _EXTS:
        root = (args.source[: -len(ext)]
                if args.source.endswith(ext) else args.source)
        if os.path.exists(root + ext):
            args.source = root + ext
            return
    raise ValueError(f"Cannot open {args.source} as a .db|.dam or "
                     f".f{{ast}}[aq][.gz] file")


def _classify_db(args, stats: dict) -> str:
    """DAZZ .db/.dam input: classify, write the .class file and the DAZZ
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
    eng = TorchEngine(gm, threads=args.threads, verbose=args.verbose,
                      device=args.device,
                      devices=local_devices(args.devices, args.device))
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
            for (lo, hi), classes in zip(spans,
                                         eng.classify_stream(chunk_iter())):
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
    stats.update(stream_wall_s=time.time() - t0, **eng.stats())
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


def cmd_classify(args: argparse.Namespace) -> int:
    import json
    import time

    from classpro_tpu_torch.engine import classify_file_torch
    from classpro_tpu_torch.io.classfile import write_class

    _check_classify_args(args)
    stats = {"kmers": 0, "reads": 0}
    if args.source.endswith((".db", ".dam")):
        out = _classify_db(args, stats) + " + .class/.rep tracks"
        wall = stats["stream_wall_s"]
    else:
        root = root_of(args.source)
        fk_root = args.fastk_root or root
        out = args.output or root + ".class"
        recs = classify_file_torch(args.source, fk_root,
                                   coverage=args.coverage,
                                   read_len=args.read_len,
                                   model_path=args.model,
                                   threads=args.threads,
                                   verbose=args.verbose, device=args.device,
                                   devices=args.devices, stats_out=stats)
        if args.seeds:
            recs = _with_seeds(recs, fk_root, out)

        def counted(records):
            for rec in records:
                stats["kmers"] += len(rec.classes) - rec.classes.count("N")
                stats["reads"] += 1
                yield rec

        t0 = time.time()       # set-up ran in classify_file_torch
        write_class(out, counted(recs))
        wall = time.time() - t0
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(dict(wall_s=round(wall, 2), **stats), f)
    if args.verbose:
        print(f"wrote {out}", file=sys.stderr)
        print(f"{stats['reads']} reads, {stats['kmers']} k-mers in "
              f"{wall:.2f}s on {args.device}; exactness guard flagged "
              f"{stats['guard_flagged']} read(s)", file=sys.stderr)
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
    c.add_argument("-T", "--threads", type=int, default=4,
                   help="host-side worker count")
    c.add_argument("-v", "--verbose", action="store_true")
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the device work runs: the CUDA kernels "
                        "(default) or their plain PyTorch versions on the "
                        "CPU")
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
    c.add_argument("--stats-json", metavar="PATH",
                   help="write run telemetry (wall, reads, k-mers, guard "
                        "flag count and min margin, shape buckets) as JSON")
    c.add_argument("--server", metavar="SOCK",
                   help="refused: the serve daemon comes with a later "
                        "slice")
    c.set_defaults(fn=cmd_classify)
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
