"""Parity battery of the port on the card, in one process.

The whole of a committed fixture (default medium) against its
``golden.class.gz``, then ``--seeds`` crafted fuzz datasets
(``fuzzgen.build``) against the oracle: the reference binary when it
exists (``--ref``), else the port's exact oracle (``exact.pipeline``),
run in ``--workers`` worker processes while this one runs the device
paths.  Every dataset goes through both device paths of
``TorchEngine``: the main path (the DP kernel K1 with the host demotions,
reconciliation and guard, C++ relaxation) and the all-device path
(``alldev=True``: K1, the device demotions and reconciliation, the sweep
kernel K5).  Both engines of a dataset share one ``GlobalModel``.

Writes a JSON artifact (``--out``, default ``GPU_PARITY.json`` in the
temporary directory) with the card's name and power limit, which oracle
decided, and per dataset and path the mismatching reads, ``guard_flagged``
and ``min_margin``.

Usage::

    python -m classpro_tpu_torch.devtools.gpu_parity [--seeds 32] \
        [--seed0 990000] [--fixture medium] [--extreme | --cap] \
        [--device cuda|cpu] [--ref PATH] [--workers 4] [--out PATH]

Exit code 1 on any mismatch.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import subprocess
import tempfile
import time

from classpro_tpu_torch.devtools import fuzzgen
from classpro_tpu_torch.devtools.parity_fuzz import (DAM_OUTS, REF_BINARY,
                                                     REPO, oracle_name,
                                                     run_oracle)

PATHS = ("main", "alldev")


def card_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    ``cpu``."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def load_reads(path: str) -> list[str]:
    """The read sequences of a FASTX file or a DAZZ .db/.dam."""
    if path.endswith((".db", ".dam")):
        from classpro_tpu_torch.io.dazz import DazzDB

        db = DazzDB(path)
        try:
            return [db.load_read(i) for i in range(db.nreads)]
        finally:
            db.close()
    from classpro_tpu_torch.io.fastx import read_fastx

    return [r.seq for r in read_fastx(path)]


def classify_reads(eng, seqs: list, profs: list) -> list[str]:
    """All reads through ``eng.classify_stream`` (the production stream,
    sort_window 8), in input order."""
    B = eng.batch_size
    chunks = [(seqs[i:i + B], profs[i:i + B])
              for i in range(0, len(seqs), B)]
    out: list = []
    for res in eng.classify_stream(iter(chunks), sort_window=8):
        out.extend(res)
    return out


def class_lines(path: str) -> list[str]:
    """Class strings (4th line of each record) of a .class file, plain or
    gzip."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return f.read().split("\n")[3::4]


def mismatches(a: list, b: list) -> int:
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def run_path(gm, seqs, profs, device, path: str) -> tuple[list, dict]:
    """``seqs`` through ``TorchEngine`` on ``path`` (``main`` or
    ``alldev``): the class strings and the engine's stats."""
    from classpro_tpu_torch.engine import TorchEngine

    eng = TorchEngine(gm, device=device, alldev=path == "alldev")
    return classify_reads(eng, seqs, profs), eng.stats()


def path_record(want: list, got: list, stats: dict) -> dict:
    """One path's record: the reads of ``got`` that differ from
    ``want``, the engine's guard_flagged and min_margin."""
    return {"mismatches": mismatches(want, got),
            "guard_flagged": stats["guard_flagged"],
            "min_margin": stats["min_margin"]}


def oracle_classes(d: str, fname: str, gm, seqs, profs, ref: str,
                   model: str | None = None) -> list[str]:
    """The oracle's class strings for the dataset ``d/fname``: the
    reference binary's .class when it exists, else the exact oracle's,
    in this process on ``gm``."""
    if os.path.exists(ref):
        r = run_oracle(d, fname, [f"-M{model}"] if model else [], ref)
        if r.returncode != 0:
            raise RuntimeError(f"reference binary failed: {r.stderr[-500:]}")
        return class_lines(os.path.join(d, "reads.class"))
    return exact_classes(gm, seqs, profs)


def exact_classes(gm, seqs, profs) -> list[str]:
    """The port's exact oracle's class strings (``exact.pipeline``), in
    this process on ``gm``; a read without a profile is all ``N``."""
    from classpro_tpu_torch.exact.pipeline import ReadClassifier

    clf = ReadClassifier(gm)
    return [clf.classify(s, p) if len(p) else "N" * len(s)
            for s, p in zip(seqs, profs)]


def _dataset(d: str, fname: str, model: str | None):
    """(GlobalModel, seqs, profiles) of the dataset ``d/fname``."""
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles

    root = os.path.join(d, "reads")
    gm = build_global_model(load_histogram(root), model_path=model)
    P = open_profiles(root)
    seqs = load_reads(os.path.join(d, fname))
    return gm, seqs, [P.fetch(i) for i in range(len(seqs))]


def _oracle_job(d: str, fname: str, model: str | None, ref: str
                ) -> tuple[list, float]:
    """The oracle's class strings of one dataset and its seconds (a
    worker process's job)."""
    t0 = time.perf_counter()
    gm, seqs, profs = _dataset(d, fname, model)
    return (oracle_classes(d, fname, gm, seqs, profs, ref, model),
            time.perf_counter() - t0)


def check_datasets(specs: list, device: str, ref: str = REF_BINARY,
                   paths=PATHS, workers: int = 0) -> list[dict]:
    """Each dataset ``(d, fname, model)`` of ``specs`` against the oracle
    on each path.  With ``workers`` > 0 the oracles run in that many
    worker processes while this one runs the device paths; each record
    has the dataset's K, reads, k-mers, oracle, and per path the
    mismatches, guard_flagged and min_margin."""
    import concurrent.futures as cf
    import multiprocessing as mp

    pool = (cf.ProcessPoolExecutor(workers, mp.get_context("spawn"))
            if workers > 0 else None)
    try:
        futs = [pool.submit(_oracle_job, d, f, m, ref) if pool else None
                for d, f, m in specs]
        out = []
        for (d, fname, model), fut in zip(specs, futs):
            gm, seqs, profs = _dataset(d, fname, model)
            t0 = time.perf_counter()
            got = {p: run_path(gm, seqs, profs, device, p) for p in paths}
            device_s = time.perf_counter() - t0
            want, oracle_s = (fut.result() if fut is not None
                              else _oracle_job(d, fname, model, ref))
            out.append({"K": gm.kmer, "reads": len(seqs),
                        "kmers": int(sum(len(p) for p in profs)),
                        "oracle": oracle_name(ref), "oracle_s": oracle_s,
                        "device_s": device_s,
                        "paths": {p: path_record(want, *g)
                                  for p, g in got.items()}})
        return out
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)


def check_dam(d: str, device: str, ref: str = REF_BINARY, gen=None,
              seed: int = 0) -> dict:
    """A ``.dam`` dataset with ``-s`` through the port's CLI on
    ``device`` against the oracle's run on a second copy (both in this
    process unless the reference binary decides): the .class file and
    the four track files compared."""
    from classpro_tpu_torch.cli import main as cli_main

    ro, ours = os.path.join(d, "oracle"), os.path.join(d, "ours")
    K, _ = fuzzgen.build(seed, ro, dam=True, gen=gen)
    fuzzgen.build(seed, ours, dam=True, gen=gen)
    if os.path.exists(ref):
        r = run_oracle(ro, "reads.dam", ["-s"], ref)
        if r.returncode != 0:
            raise RuntimeError(f"reference binary failed: {r.stderr[-500:]}")
    elif cli_main(["classify", "-s", "--engine", "exact",
                   os.path.join(ro, "reads.dam")]) != 0:
        raise RuntimeError("classify -s --engine exact on the .dam failed")
    if cli_main(["classify", "-s", "--device", device,
                 os.path.join(ours, "reads.dam")]) != 0:
        raise RuntimeError("classify -s on the .dam failed")
    diffs = []
    for f in DAM_OUTS:
        with open(os.path.join(ro, f), "rb") as a, \
                open(os.path.join(ours, f), "rb") as b:
            if a.read() != b.read():
                diffs.append(f)
    return {"K": K, "oracle": oracle_name(ref), "files": len(DAM_OUTS),
            "differing_files": diffs}


def check_fixture(name: str, device: str, paths=PATHS) -> dict:
    """A committed fixture (tests/fixtures/<name>) against its golden."""
    fx = os.path.join(REPO, "tests", "fixtures", name)
    gm, seqs, profs = _dataset(fx, "reads.fasta.gz", None)
    want = class_lines(os.path.join(fx, "golden.class.gz"))
    return {"name": name, "reads": len(seqs), "oracle": "golden",
            "kmers": int(sum(len(p) for p in profs)),
            "paths": {p: path_record(want, *run_path(gm, seqs, profs,
                                                     device, p))
                      for p in paths}}


def dataset_ok(rec: dict) -> bool:
    return (all(p["mismatches"] == 0 for p in rec.get("paths", {}).values())
            and not rec.get("differing_files"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=32,
                    help="fuzz datasets (0: the fixture only)")
    ap.add_argument("--seed0", type=int, default=990000,
                    help="first fuzz seed (disjoint from the committed "
                         "corpus by default)")
    ap.add_argument("--fixture", default="medium",
                    help="committed fixture checked against its golden")
    gen = ap.add_mutually_exclusive_group()
    gen.add_argument("--extreme", action="store_true",
                     help="the discrete-underflow generator")
    gen.add_argument("--cap", action="store_true",
                     help="the boundary-cap generator")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--ref", default=REF_BINARY)
    ap.add_argument("--workers", type=int, default=4,
                    help="processes running the oracle while this one "
                         "runs the device paths (0: in this process)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "GPU_PARITY.json"))
    a = ap.parse_args(argv)
    g = (fuzzgen.GENERATORS["extreme"] if a.extreme else
         fuzzgen.GENERATORS["cap"] if a.cap else None)

    rec: dict = {"card": card_line(a.device), "device": a.device,
                 "oracle": oracle_name(a.ref), "ts": time.time(),
                 "generator": ("extreme" if a.extreme else "cap" if a.cap
                               else "random"), "datasets": []}
    fx = check_fixture(a.fixture, a.device)
    rec["datasets"].append(fx)
    print(f"{a.fixture}: {fx['reads']} reads, mismatches "
          f"{ {p: v['mismatches'] for p, v in fx['paths'].items()} } "
          f"[golden; {rec['card']}]", flush=True)
    base = tempfile.mkdtemp(prefix="cpgpar")
    try:
        seeds = range(a.seed0, a.seed0 + a.seeds)
        specs = []
        for seed in seeds:
            d = os.path.join(base, str(seed))
            specs.append((d, fuzzgen.build(seed, d, gen=g)[1], None))
        for seed, r in zip(seeds, check_datasets(specs, a.device, a.ref,
                                                 workers=a.workers)):
            r["name"] = f"fuzz{seed}"
            rec["datasets"].append(r)
            print(f"fuzz seed {seed} (K={r['K']}): {r['reads']} reads, "
                  f"{r['kmers']} k-mers, "
                  + ", ".join(f"{p}: {v['mismatches']} mismatches, "
                              f"guard_flagged {v['guard_flagged']}, "
                              f"min_margin {v['min_margin']}"
                              for p, v in r["paths"].items())
                  + f" [{r['oracle']}]", flush=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    rec["ok"] = all(dataset_ok(r) for r in rec["datasets"])
    with open(a.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(("PARITY OK" if rec["ok"] else "*** PARITY FAILURES ***")
          + f" -> {a.out}", flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
