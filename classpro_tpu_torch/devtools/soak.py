"""Gbp-scale end-to-end soak of the port's ``classify`` on the card.

Generates a synthetic HiFi dataset of ``--gbp`` billion bases (the
simulator's genome and read model, ``tools.simulate``, with a vectorized
k-mer counter: 2-bit uint64 codes + ``np.unique``, so K <= 32; default
K = 28), then:

1. runs ``python -m classpro_tpu_torch.cli classify -v --warmup
   --stats-json`` on ``--device`` as a child process, sampling its RSS
   and the output file's growth once a second;
2. (unless ``--skip-serve``) starts the port's ``serve`` daemon on the
   dataset, sends the same job with ``classify --server`` and compares
   its output with the single run's;
3. spot-checks parity: ``--spot`` randomly sampled reads re-classified by
   the port's exact oracle against the produced records;
4. (unless ``--skip-shard``) runs the shard driver as two processes, one
   shard each, then the checked merge, and byte-compares the result with
   the single run;
5. writes a JSON record (``--out``): the generator's meta and seconds,
   the card's name and power limit, the classify wall, stream wall,
   k-mers/s, RSS peak, the engine's ``guard_flagged`` and
   ``min_margin``, spot-parity mismatches, merge equality and the served
   job's wall.

For the same ``--gbp``, ``--kmer``, ``--cov`` and seed the dataset is
byte-identical to ``tools/soak.py``'s.

Usage::

    python -m classpro_tpu_torch.devtools.soak [--gbp 0.5] [--kmer 28] \
        [--device cuda|cpu] [--dir DIR] [--out PATH] [--spot 420] \
        [--skip-gen] [--skip-shard] [--skip-serve]

Exit code 1 when spot parity, the merge or the served job disagree.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from classpro_tpu_torch.devtools.parity_fuzz import child_env

KMER = 28  # <= 32 so a canonical k-mer packs into one uint64

_CODE = np.full(256, 255, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
_COMP = np.array([3, 2, 1, 0], np.uint8)


def _kmer_codes(seq_u8: np.ndarray, K: int = KMER) -> np.ndarray:
    """Canonical 2-bit k-mer codes (uint64) for one read."""
    c = _CODE[seq_u8]
    n = len(c) - K + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    # windows of K 2-bit symbols, packed by shifts
    w = np.lib.stride_tricks.sliding_window_view(c, K).astype(np.uint64)
    shifts = (2 * (K - 1 - np.arange(K))).astype(np.uint64)
    fwd = (w << shifts).sum(axis=1, dtype=np.uint64)
    rc = _COMP[c][::-1]
    wr = np.lib.stride_tricks.sliding_window_view(rc, K).astype(np.uint64)
    rev_all = (wr << shifts).sum(axis=1, dtype=np.uint64)[::-1]
    return np.minimum(fwd, rev_all)


def generate(outdir: str, gbp: float, seed: int = 11, nparts: int = 2,
             kmer: int = 0, cov: float = 0.0) -> dict:
    """Write ``outdir/reads.{fasta,hist,prof}`` (+ hidden parts) and
    ``meta.json``; returns the meta.  The genome is capped at 6 Mbp so a
    0.5-1 Gbp dataset runs ~80-170x (HiFi-like), unless ``cov`` pins the
    coverage."""
    from classpro_tpu_torch.io.fastk import (histogram_from_counts,
                                             write_histogram, write_profiles)
    from classpro_tpu_torch.io.fastx import write_fasta
    from classpro_tpu_torch.tools.simulate import (SimConfig, make_diploid,
                                                   simulate_reads)

    os.makedirs(outdir, exist_ok=True)
    K = kmer or KMER
    if K > 32:
        raise ValueError("the vectorized counter packs K <= 32 in uint64")
    if cov:
        genome_len = int(gbp * 1e9 / cov)
    else:
        genome_len = min(6_000_000, int(gbp * 1e9 / 40))
    coverage = gbp * 1e9 / genome_len
    cfg = SimConfig(seed=seed, genome_len=genome_len, coverage=coverage,
                    read_len_mean=12_000, read_len_sd=2_500,
                    read_len_min=4_000, kmer=K)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    haps = make_diploid(cfg, rng)
    reads = simulate_reads(cfg, rng, haps)
    n_bases = sum(len(r[2]) for r in reads)
    print(f"[gen] {len(reads)} reads, {n_bases / 1e9:.3f} Gbp "
          f"({time.time() - t0:.0f}s)", flush=True)

    codes = [_kmer_codes(np.frombuffer(s.encode(), np.uint8), K)
             for _, _, s in reads]
    allc = np.concatenate(codes)
    print(f"[gen] {len(allc) / 1e6:.0f}M kmer instances, sorting...",
          flush=True)
    uniq, counts = np.unique(allc, return_counts=True)
    counts16 = np.minimum(counts, 32767).astype(np.uint16)
    del allc
    print(f"[gen] {len(uniq) / 1e6:.1f}M distinct "
          f"({time.time() - t0:.0f}s)", flush=True)

    profiles = [counts16[np.searchsorted(uniq, c)] for c in codes]
    del codes
    root = os.path.join(outdir, "reads")
    write_fasta(root + ".fasta", reads)
    write_profiles(root, profiles, K, nparts=nparts)
    write_histogram(root, histogram_from_counts(K, counts))
    meta = {"n_reads": len(reads), "n_bases": n_bases,
            "n_kmers": int(sum(len(p) for p in profiles)),
            "n_distinct": int(len(uniq)), "kmer": K, "nparts": nparts,
            "gen_seconds": round(time.time() - t0, 1)}
    with open(os.path.join(outdir, "meta.json"), "w") as f:
        json.dump(meta, f)
    print(f"[gen] done {meta}", flush=True)
    return meta


def _rss_kb(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


def _growth(samples: list) -> tuple[float, float, float]:
    """(growth seconds, stall seconds, MB grown) of an output-size
    curve."""
    grow_s = stall_s = grow_mb = 0.0
    for a, b in zip(samples, samples[1:]):
        dd = b["out_mb"] - a["out_mb"]
        if dd > 0:
            grow_s += b["t"] - a["t"]
            grow_mb += dd
        else:
            stall_s += b["t"] - a["t"]
    return grow_s, stall_s, grow_mb


def _watch(p, out: str, t0: float, rss: bool) -> list:
    """Sample the child's RSS and ``out``'s size once a second until it
    exits."""
    samples = []
    while p.poll() is None:
        time.sleep(1.0)
        s = {"t": round(time.time() - t0, 1),
             "out_mb": round((os.path.getsize(out) if os.path.exists(out)
                              else 0) / 1e6, 1)}
        if rss:
            s["rss_mb"] = round(_rss_kb(p.pid) / 1024, 1)
        samples.append(s)
        if len(samples) % 30 == 0:
            print(f"[watch] {samples[-1]}", flush=True)
    return samples


def _port(args: list, **kw) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "classpro_tpu_torch.cli",
                             *args], env=child_env(), text=True, **kw)


def run_classify(d: str, device: str) -> dict:
    """``classify -v --warmup --stats-json`` on ``device``, a child
    process, watched once a second."""
    out = os.path.join(d, "soak.class")
    stats_path = os.path.join(d, "soak.stats.json")
    # a stale output from a previous run would corrupt the growth curve
    for p in (out, stats_path):
        if os.path.exists(p):
            os.remove(p)
    t0 = time.time()
    p = _port(["classify", "-v", "--warmup", "--device", device,
               "--stats-json", stats_path, os.path.join(d, "reads.fasta"),
               "-o", out], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    err: list = []
    th = threading.Thread(target=lambda: err.append(p.stderr.read()),
                          daemon=True)
    th.start()
    samples = _watch(p, out, t0, rss=True)
    th.join()
    wall = time.time() - t0
    if p.returncode != 0:
        raise RuntimeError(f"classify failed: {err[0][-2000:]}")
    grow_s, stall_s, grow_mb = _growth(samples)
    with open(stats_path) as f:
        eng_stats = json.load(f)
    return {"wall_s": round(wall, 1), "engine_stats": eng_stats,
            "rss_peak_mb": max((s["rss_mb"] for s in samples), default=-1),
            "sustained_out_mb_s": (round(grow_mb / grow_s, 2) if grow_s
                                   else None),
            "growth_seconds": round(grow_s, 1),
            "stall_seconds": round(stall_s, 1),
            "samples": samples[:: max(1, len(samples) // 120)],
            "stderr_tail": err[0].strip().splitlines()[-3:]}


def run_classify_served(d: str, device: str) -> dict:
    """The port's ``serve`` daemon on the dataset, then the same job by
    ``classify --server``; its output compared with the single run's."""
    from classpro_tpu_torch.serve import request

    sdir = tempfile.mkdtemp(prefix="cpsk")   # unix socket paths are short
    sock = os.path.join(sdir, "cp.sock")
    out = os.path.join(d, "served.class")
    err = open(os.path.join(d, "daemon.err"), "w")
    t0 = time.time()
    srv = _port(["serve", "--socket", sock, "-v", "--device", device,
                 "--warmup-root", os.path.join(d, "reads"),
                 "--warmup-shape", "256x192", "--warmup-shape", "256x256"],
                stdout=subprocess.PIPE, stderr=err)
    try:
        line = srv.stdout.readline()
        if line.strip() != "READY":
            raise RuntimeError(f"serve: no READY line (got {line!r}, exit "
                               f"code {srv.poll()})")
        warm = round(time.time() - t0, 1)
        t1 = time.time()
        cli = _port(["classify", "--server", sock, "-v",
                     os.path.join(d, "reads.fasta"), "-o", out],
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        cerr: list = []
        th = threading.Thread(target=lambda: cerr.append(cli.stderr.read()),
                              daemon=True)
        th.start()
        samples = _watch(cli, out, t1, rss=False)
        th.join()
        wall = time.time() - t1
        if cli.returncode != 0:
            raise RuntimeError(f"classify --server: {cerr[0][-2000:]}")
        grow_s, stall_s, grow_mb = _growth(samples)
        if not request(sock, {"cmd": "shutdown"}, timeout=30).get("ok") \
                or srv.wait(timeout=120) != 0:
            raise RuntimeError("serve: shutdown failed")
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait(timeout=60)
        err.close()
        shutil.rmtree(sdir, ignore_errors=True)
    return {"server_warmup_s": warm, "job_wall_s": round(wall, 1),
            "client_reply": cerr[0].strip().splitlines()[-1:],
            "stall_seconds": round(stall_s, 1),
            "growth_seconds": round(grow_s, 1),
            "sustained_out_mb_s": (round(grow_mb / grow_s, 2) if grow_s
                                   else None),
            "equal_to_fresh": filecmp.cmp(out, os.path.join(d, "soak.class"),
                                          shallow=False)}


def spot_parity(d: str, n: int, meta: dict, seed: int = 5) -> dict:
    """``n`` sampled reads of the single run's output against the port's
    exact oracle."""
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.exact.pipeline import ReadClassifier
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles

    root = os.path.join(d, "reads")
    gm = build_global_model(load_histogram(root))
    P = open_profiles(root)
    rng = np.random.default_rng(seed)
    picks = sorted(rng.choice(meta["n_reads"], size=min(n, meta["n_reads"]),
                              replace=False))
    clf = ReadClassifier(gm)
    # stream the .class file once, grabbing the sampled records
    want = {}
    with open(os.path.join(d, "soak.class")) as f:
        rid = pi = 0
        while pi < len(picks):
            rec = [f.readline() for _ in range(4)]
            if not rec[0]:
                break
            if rid == picks[pi]:
                want[rid] = (rec[1].rstrip("\n"), rec[3].rstrip("\n"))
                pi += 1
            rid += 1
    t0 = time.time()
    mism = 0
    for rid in picks:
        seq, got = want[rid]
        if clf.classify(seq, P.fetch(int(rid))) != got:
            mism += 1
            print(f"[parity] read {rid} MISMATCH", flush=True)
    return {"sampled": len(picks), "mismatches": mism,
            "oracle_s": round(time.time() - t0, 1)}


def shard_merge(d: str, device: str) -> dict:
    """The shard driver as two processes, one shard each (no process
    group: each is a fresh process, as in a multi-host run without a
    coordinator), then the checked merge, compared with the single
    run."""
    from classpro_tpu_torch.io.fastk import open_profiles
    from classpro_tpu_torch.parallel.driver import merge_shards, shard_range

    root = os.path.join(d, "reads")
    out = os.path.join(d, "sharded.class")
    t0 = time.time()
    for pid in range(2):
        r = subprocess.run(
            [sys.executable, "-c",
             "from classpro_tpu_torch.parallel.driver import run_process; "
             f"run_process({(root + '.fasta')!r}, {root!r}, {out!r}, "
             f"nproc=2, pid={pid}, device={device!r}, _skip_init=True)"],
            env=child_env(), capture_output=True, text=True, timeout=7200)
        if r.returncode != 0:
            raise RuntimeError(f"shard {pid}: {r.stderr[-2000:]}")
    nreads = open_profiles(root).nreads
    expected = [e - b for b, e in (shard_range(nreads, 2, p)
                                   for p in range(2))]
    merge_shards(out, 2, expected)
    return {"wall_s": round(time.time() - t0, 1),
            "merge_equal": filecmp.cmp(out, os.path.join(d, "soak.class"),
                                       shallow=False)}


def soak(d: str, device: str, gbp: float = 0.5, kmer: int = 0,
         cov: float = 0.0, spot: int = 420, skip_gen: bool = False,
         skip_shard: bool = False, skip_serve: bool = False) -> dict:
    """The whole soak on ``device`` in directory ``d``; returns the
    record (``ok`` false when spot parity, the merge or the served job
    disagree)."""
    from classpro_tpu_torch.devtools.gpu_parity import card_line

    meta_path = os.path.join(d, "meta.json")
    if skip_gen and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    else:
        meta = generate(d, gbp, kmer=kmer, cov=cov)
    res = {"meta": meta, "device": device, "card": card_line(device),
           "ts": time.strftime("%Y-%m-%d %H:%M:%S")}
    c = res["classify"] = run_classify(d, device)
    es = c["engine_stats"]
    c["kmers_per_s"] = meta["n_kmers"] / c["wall_s"]
    c["stream_kmers_per_s"] = meta["n_kmers"] / es["stream_wall_s"]
    c["guard_flag_rate"] = es["guard_flagged"] / max(meta["n_reads"], 1)
    print(f"[classify] wall={c['wall_s']}s stream="
          f"{es['stream_wall_s']:.1f}s {c['kmers_per_s'] / 1e6:.2f} "
          f"M k-mers/s (stream {c['stream_kmers_per_s'] / 1e6:.2f}) "
          f"rss_peak={c['rss_peak_mb']}MB guard_flagged="
          f"{es['guard_flagged']} ({100 * c['guard_flag_rate']:.3f}%) "
          f"min_margin={es['min_margin']}", flush=True)
    if not skip_serve:
        s = res["served"] = run_classify_served(d, device)
        s["kmers_per_s_job"] = meta["n_kmers"] / s["job_wall_s"]
        print(f"[served] ready={s['server_warmup_s']}s job="
              f"{s['job_wall_s']}s equal={s['equal_to_fresh']}", flush=True)
    res["spot_parity"] = spot_parity(d, spot, meta)
    print(f"[parity] {res['spot_parity']}", flush=True)
    if not skip_shard:
        res["shard_merge"] = shard_merge(d, device)
        print(f"[shard] {res['shard_merge']}", flush=True)
    res["ok"] = bool(res["spot_parity"]["mismatches"] == 0
                     and (skip_shard or res["shard_merge"]["merge_equal"])
                     and (skip_serve or res["served"]["equal_to_fresh"]))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gbp", type=float, default=0.5)
    ap.add_argument("--kmer", type=int, default=0,
                    help=f"k-mer size for generation (<= 32; default "
                         f"{KMER})")
    ap.add_argument("--cov", type=float, default=0.0,
                    help="pin the dataset coverage (default: 6 Mbp genome "
                         "cap)")
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "soak"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "SOAK.json"))
    ap.add_argument("--spot", type=int, default=420,
                    help="sampled exact-oracle parity reads")
    ap.add_argument("--skip-gen", action="store_true",
                    help="reuse --dir's dataset when its meta.json exists")
    ap.add_argument("--skip-shard", action="store_true")
    ap.add_argument("--skip-serve", action="store_true")
    a = ap.parse_args(argv)
    res = soak(a.dir, a.device, a.gbp, a.kmer, a.cov, a.spot, a.skip_gen,
               a.skip_shard, a.skip_serve)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {a.out}", flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
