"""Command-line interface of the PyTorch/CUDA port.

``python -m classpro_tpu_torch.cli classify reads.fasta`` classifies every
k-mer of every read (E/H/D/R) and writes the ``.class`` file, as the JAX
package's ``classify`` does on FASTX input.  DAZZ ``.db``/``.dam`` input,
``-s`` seeds and ``--server`` belong to later slices of the port and are
refused with a message saying so.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

# FASTX extensions, in the reference's probe order (ClassPro.h:326)
_EXTS = (".fastq", ".fasta", ".fq", ".fa",
         ".fastq.gz", ".fasta.gz", ".fq.gz", ".fa.gz")

_LATER = "not ported yet: {what} comes with a later slice of the " \
         "PyTorch port ({slice}); use `python -m classpro_tpu.cli` for it"


def _root_of(source: str) -> str:
    for ext in _EXTS:
        if source.endswith(ext):
            return source[: -len(ext)]
    return source


def _check_classify_args(args) -> None:
    """The reference's argument refusals (ClassPro.c:348-500): -T
    positive, -c non-negative, -r positive, the input openable under a
    known FASTX extension; plus the options this slice does not carry."""
    if args.seeds:
        raise ValueError(_LATER.format(what="-s seed selection",
                                       slice="CLI surface, M5"))
    if args.server:
        raise ValueError(_LATER.format(what="--server",
                                       slice="serve, M6"))
    if args.source.endswith((".db", ".dam")):
        raise ValueError(_LATER.format(what=".db/.dam input",
                                       slice="CLI surface, M5"))
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
    raise ValueError(f"Cannot open {args.source} as a "
                     f".f{{ast}}[aq][.gz] file")


def cmd_classify(args: argparse.Namespace) -> int:
    import time

    from classpro_tpu_torch.engine import classify_file_torch
    from classpro_tpu_torch.io.classfile import write_class

    _check_classify_args(args)
    root = _root_of(args.source)
    out = args.output or root + ".class"
    stats = {"kmers": 0, "reads": 0}
    recs = classify_file_torch(args.source, args.fastk_root or root,
                               coverage=args.coverage,
                               read_len=args.read_len,
                               model_path=args.model, threads=args.threads,
                               verbose=args.verbose, device=args.device,
                               stats_out=stats)

    def counted(records):
        for rec in records:
            stats["kmers"] += len(rec.classes) - rec.classes.count("N")
            stats["reads"] += 1
            yield rec

    t0 = time.time()
    write_class(out, counted(recs))
    wall = time.time() - t0
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
    c.add_argument("source", help="reads (.fasta/.fastq[.gz])")
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
                   help="where the DP runs: the CUDA kernel (default) or "
                        "the plain PyTorch version on the CPU")
    c.add_argument("-s", "--seeds", action="store_true",
                   help="refused: seeds come with a later slice")
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
