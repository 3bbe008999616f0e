"""Crafted-profile dataset generators for the port's parity fuzzing.

The port's own copy of the repo-root dev tools' generators: the
step / ramp / noise / error-dip read batches and the ``sc_*`` scenarios
of ``tools/branch_probe.py``, and ``_inject_n``, ``build`` and
``write_random_model`` of ``tools/parity_fuzz.py``.  The k-mer size the
generators read (a module constant there, set by ``build`` before each
call) is an argument here.  For the same seed and options the files
``build`` and ``write_random_model`` write are byte-identical to those of
the repo-root tools (``tests/test_torch_devtools.py``).

A dataset is a handful of crafted count profiles (each read's sequence is
random, its profile made up), a FASTK histogram with H/D peaks drawn per
seed, and the reads in a container drawn per seed (FASTA/FASTQ, plain or
gzip), or a DAZZ ``.dam``.
"""

from __future__ import annotations

import os

import numpy as np

from classpro_tpu_torch.io.fastk import (histogram_from_counts,
                                         write_histogram, write_profiles)
from classpro_tpu_torch.io.fastx import write_fasta


def _seq(rng: np.random.Generator, n: int, runs=None) -> str:
    """Random sequence, optionally with low-complexity runs.

    ``runs``: list of ints (12bp homopolymer at that position) or tuples
    (start, length, unit) with unit 1=HP, 2=dinuc, 3=trinuc satellite."""
    b = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    for r in runs or []:
        p, ln, unit = r if isinstance(r, tuple) else (r, 12, 1)
        pat = b[p: p + unit]
        for q in range(p, min(p + ln, n)):
            b[q] = pat[(q - p) % unit]
    return b.tobytes().decode()


def _hist_counts(rng, h_cov, d_cov, n_h=15000, n_d=30000, e_n=20000):
    """Per-distinct-kmer counts giving an H/D double-peak histogram."""
    return np.concatenate([
        rng.poisson(h_cov, n_h),
        rng.poisson(d_cov, n_d),
        rng.integers(1, 4, e_n),
    ]).clip(1, 32767)


def steps(levels, seg=70):
    return np.concatenate([np.full(seg, c) for c in levels])


# --- scenario builders: return (hist_counts, [(counts, hp_at)]) ---------

def sc_uniform_grid(rng, K: int = 40):
    reads = [(np.full(900, c), None)
             for c in (24, 27, 29, 31, 33, 35, 37, 44, 55, 65)]
    return _hist_counts(rng, 20, 40), reads


def sc_drift(rng, K: int = 40):
    reads = [
        (steps([22, 26, 30, 34, 38]), None),
        (steps([38, 34, 30, 26, 22]), None),
        (steps([20, 25, 30, 35, 40]), None),
        (steps([24, 29, 34, 39, 44]), None),
        (steps([26, 31, 36, 31, 26]), None),
        (steps([30, 36, 42, 36, 30]), None),
        (np.clip(30 + rng.integers(-1, 2, 900), 1, None), None),
        (np.clip(33 + rng.integers(-2, 3, 900), 1, None), None),
    ]
    return _hist_counts(rng, 20, 40), reads


def sc_high(rng, K: int = 40):
    reads = [
        (np.full(900, 100), None),                       # M == 0, all R
        (steps([100, 90, 100], 120), None),
        (steps([100, 50, 100], 120), None),              # unrel fallbacks
        (steps([100, 5, 100], 120), None),
        (np.clip(rng.poisson(90, 900), 1, None), None),
    ]
    return _hist_counts(rng, 20, 40), reads


def sc_errors(rng, K: int = 40):
    """Clustered error dips inside homopolymers: multi-error recovery,
    duplicate E-intervals, FINAL-thres pair rejects."""
    reads = []
    for gap in (3, 8, 15, 30):
        c = np.full(1000, 40)
        for at in (200, 600):
            c[at: at + K] -= 36           # error k-mers dip
            c[at + gap: at + gap + K] -= np.minimum(c[at + gap: at + gap + K] - 1, 36)
        reads.append((np.clip(c, 1, None), [160 + 39, 560 + 39]))
    c = np.full(1000, 40)
    c[300: 300 + K] = 2
    c[300 + K: 300 + K + 5] = 20          # half-recovered edge
    reads.append((c, [260 + 39]))
    return _hist_counts(rng, 20, 40), reads


def sc_overflow(rng, K: int = 40):
    """Counts near MAX_KMER_CNT with a rise: over-corrected intervals."""
    h, d = 15000, 30000
    reads = []
    c = np.concatenate([np.full(300, 30000),
                        np.full(300, 30000) + np.arange(300) * 9]).clip(1, 32600)
    reads.append((c, None))
    c2 = np.concatenate([np.full(200, 29000),
                         np.linspace(29000, 32700, 200).astype(int),
                         np.full(200, 32700)])
    reads.append((c2, None))
    reads.append((np.full(600, 31000), None))
    hist = np.concatenate([rng.poisson(h, 2000),
                           rng.poisson(d, 6000),
                           rng.integers(1, 4, 1000)]).clip(1, 32767)
    return hist, reads


def sc_tall_h(rng, K: int = 40):
    """Histogram whose tallest peak is H (hist.c:94-101 else-branch)."""
    hist = np.concatenate([
        rng.poisson(20, 40000),           # tall H peak
        rng.poisson(40, 12000),           # smaller D peak
        rng.integers(1, 4, 10000),
    ]).clip(1, 32767)
    reads = [(np.full(900, c), None) for c in (20, 30, 40, 60)]
    return hist, reads


def sc_longrun(rng, K: int = 40):
    """Context runs >= K-1 next to count changes: the run-length-adjusted
    pair search in find_gain/find_drop degenerates (j <= i -> return
    false, wall.c:354-366/445-457); also 130bp homopolymer for the
    127-cap."""
    reads = []
    for run_len, unit in ((50, 1), (90, 1), (130, 1), (60, 2), (90, 3)):
        c = np.full(1000, 40)
        for at in (300, 700):
            c[at: at + K] = 3            # dip right at the run edge
        # homopolymer / satellite run placed so its end coincides with
        # the drop wall at profile pos 300 (seq pos 300+K-1)
        reads.append((c, [(300 + K - 1 - run_len, run_len, unit),
                          (700 + K - 1 - 8, 8, unit)]))
    return _hist_counts(rng, 20, 40), reads


def sc_dips(rng, K: int = 40):
    """Dense error-dip clusters: multi-error recovery duplicates
    (remove_duplicates compaction, wall.c:563-573) + bs_eintvl left
    recursion (551)."""
    reads = []
    for ndip, width in ((6, K), (10, 20), (8, 5), (12, 2), (7, K + 10)):
        c = np.full(2000, 40)
        pos = np.sort(rng.choice(np.arange(K, 2000 - 2 * K), ndip,
                                 replace=False))
        for p in pos:
            c[p: p + width] = int(rng.integers(1, 5))
        reads.append((np.clip(c, 1, None), None))
    return _hist_counts(rng, 20, 40), reads


def sc_smallk(rng, K: int = 40):
    """K=16 profiles: with K-1 < MAX_N_LC the run-length-adjusted pair
    search can degenerate (j <= i in find_gain / j >= i in find_drop,
    pristine wall.c:354-355/445-446 = patched 365-366/456-457), which is
    unreachable at K=40 (l caps at MAX_N_LC=20 < K-1).  Runs end exactly
    at the drop wall's left-context position (profile i -> seq i+K-2)
    and start at the gain wall (seq position = profile position)."""
    k = 16
    reads = []
    for unit, run in ((1, 20), (1, 30), (2, 40), (3, 60)):
        c = np.full(1000, 40)
        c[300: 330] = 3
        runs = [(300 + k - 2 - run + 1, run, unit),   # ends at seq 300+k-2
                (330, run, unit)]                     # starts at gain wall
        reads.append((c, runs))
    c = np.full(1000, 40)
    c[500: 540] = 2
    reads.append((c, [(480, 60, 1)]))                 # run spanning the dip
    return _hist_counts(rng, 20, 40), reads, k


def sc_stepdip(rng, K: int = 40):
    """Error dips whose floor has an internal step: the step becomes an
    O-wall INSIDE an S-paired E-interval, so the multi-error recovery's
    backward GAIN probe searches (b, i) with i < the stored pair's e —
    the same-b/smaller-e left recursion of bs_eintvl (pristine
    wall.c:539-540 = patched 550-551)."""
    reads = []
    for f1, f2 in ((2, 12), (1, 10), (3, 14), (2, 20), (1, 8)):
        for half in (K // 2, K // 3, 2 * K // 3):
            c = np.full(900, 40)
            c[400: 400 + half] = f1
            c[400 + half: 400 + K] = f2
            reads.append((c.copy(), None))
            c2 = np.full(900, 40)
            c2[400: 400 + half] = f2          # step down inside dip
            c2[400 + half: 400 + K] = f1
            reads.append((c2, None))
    return _hist_counts(rng, 20, 40), reads


def _random_batch(seed: int, K: int = 40):
    """Randomized step/ramp/noise pattern batch for branch search."""
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(150):
        kind = rng.integers(0, 4)
        if kind == 0:      # random step levels
            nseg = int(rng.integers(1, 7))
            levels = rng.integers(8, 75, nseg)
            segs = rng.integers(45, 220, nseg)
            c = np.concatenate([np.full(s, l) for s, l in zip(segs, levels)])
        elif kind == 1:    # ramp
            a, b = rng.integers(10, 70, 2)
            c = np.linspace(a, b, int(rng.integers(200, 900))).astype(int)
        elif kind == 2:    # plateau with shoulders
            lo, hi = sorted(rng.integers(8, 75, 2))
            w = int(rng.integers(60, 300))
            c = np.concatenate([np.full(w, lo), np.full(w, hi),
                                np.full(w, lo)])
        else:              # noisy level
            lvl = int(rng.integers(10, 70))
            c = np.clip(lvl + rng.integers(-3, 4, int(rng.integers(200, 900))),
                        1, None)
        if rng.random() < 0.4:  # error dips (possibly clustered)
            c = c.copy()
            for _ in range(int(rng.integers(1, 5))):
                if len(c) <= 2 * K:
                    break
                p = int(rng.integers(K, len(c) - K))
                c[p: p + int(rng.integers(1, K))] = rng.integers(1, 5)
        reads.append((np.clip(c, 1, 32767), None))
    h = int(rng.integers(12, 40))
    return _hist_counts(rng, h, 2 * h), reads


def _extreme_batch(seed: int, K: int = 40):
    """Extreme-magnitude batch targeting the device DP's DISCRETE
    semantics (ref class_rel.c:321-336 normalization): the init-cell
    softmax-underflow kill, the exp()-underflow cutoff at raw score
    ~-745.13, the denormal band below ~-708, and the H<D<R count gate.
    Count levels drawn log-uniform over [6, 32767] put the four state
    scores hundreds-to-thousands of nats apart, so SOME-but-not-all
    states cross C's underflow lines — the fuzz-seed-21517 bug class
    (rel_dev2._lane_init), which the continuous margin guard cannot
    see because the flipped decision has a large margin."""
    rng = np.random.default_rng(np.uint64(seed) ^ np.uint64(0x5EED5EED))

    def loglvl(lo, hi):
        return int(np.exp(rng.uniform(np.log(lo), np.log(hi))))

    reads = []
    for _ in range(120):
        kind = rng.integers(0, 4)
        if kind == 0:      # extreme step levels
            nseg = int(rng.integers(2, 9))
            levels = [loglvl(6, 32767) for _ in range(nseg)]
            segs = rng.integers(30, 160, nseg)
            c = np.concatenate([np.full(s, l)
                                for s, l in zip(segs, levels)])
        elif kind == 1:    # huge ramp, either direction
            a, b = loglvl(8, 200), loglvl(200, 32767)
            if rng.random() < 0.5:
                a, b = b, a
            c = np.linspace(a, b, int(rng.integers(150, 700))).astype(int)
        elif kind == 2:    # sane plateau with one extreme excursion
            lvl = int(rng.integers(10, 60))
            c = np.full(int(rng.integers(300, 900)), lvl)
            p = int(rng.integers(K, len(c) - K))
            c[p: p + int(rng.integers(5, 3 * K))] = loglvl(100, 32767)
        else:              # noisy high level
            lvl = loglvl(60, 5000)
            c = np.clip(lvl + rng.integers(-(lvl // 8), lvl // 8 + 1,
                                           int(rng.integers(150, 600))),
                        1, None)
        if rng.random() < 0.5:  # deep error dips
            c = c.copy()
            for _ in range(int(rng.integers(1, 4))):
                if len(c) <= 2 * K:
                    break
                p = int(rng.integers(K, len(c) - K))
                c[p: p + int(rng.integers(1, K))] = rng.integers(1, 5)
        reads.append((np.clip(c, 1, 32767), None))
    h = int(rng.integers(12, 40))
    return _hist_counts(rng, h, 2 * h), reads


def sc_psum0(rng, K: int = 40):
    """The all-16-underflow 'No possible state' fallback
    (class_rel.c:326-331), hit for real (gcov: 327-331 executed).

    Requires -c186 -r4500 (ARGS below).  Geometry (COV = E1/H93/D186/
    R254): interval A = [60 x100 | +2-ramp | 161 ...] (45 kbp) kills
    E (logfact) and R (binom(60,254,.99) = -758 < exp-underflow) at
    the init cell, leaving {H, D}.  Interval X = [80 x100 | +2-ramp |
    161 ...] (14.5 kbp): its E emission underflows; its H argmax comes
    from the D-init predecessor (st_H=80 @ offset pos) and its D
    argmax from the H-init predecessor (st_H=161 @ adjacent pos), so
    BOTH hit the H<D<R gate at equality (curr=161 vs st=161,
    class_rel.c:496-498) and die; R's best predecessor is H-init whose
    st_D = 161+93 = 254 >= st_R -> gate-killed too.  All four dp at X
    are then -inf, so interval B's _update (flat 60 x300) computes
    psum == 0 -> the fallback fires.  The -2-slope ramps stay under
    MIN_CNT_CHANGE so A/X/B are single clean intervals; the A|X and
    X|B steps are OTHERS walls; all three intervals are reliable.
    Deterministic reference output verified (3 runs byte-equal): the
    C's all-dead traceback reads a never-written bt row = fresh zero
    pages -> all-ERROR + rpos (see exact/rel.py traceback note)."""
    A = np.concatenate([np.full(100, 60), 60 + 2 * np.arange(1, 51),
                        np.full(45000 - 150, 161)])
    X = np.concatenate([np.full(100, 80), 80 + 2 * np.arange(1, 41),
                        np.full(14500 - 140, 161)])
    B = np.full(300, 60)
    reads = [(np.concatenate([A, X, B]), None)]
    return _hist_counts(rng, 93, 186), reads


def sc_psum0multi(rng, K: int = 40):
    """Workspace-ordering probe for the psum0 all-dead traceback:
    the C's -T1 loop reuses bt across reads, and an
    all-dead final cell reads a bt row this read never wrote — so a
    psum0 read AFTER a read with MORE rel intervals (6 here) could in
    principle see the previous read's path bytes instead of fresh zero
    pages.  Measured: reference output is byte-identical
    across solo/multi orderings AND -T1/-T2 (the relaxation sweeps
    override the rel-DP assignment for this profile shape), and our
    fresh-workspace pin matches it byte-for-byte.  This fixture keeps
    that ordering case pinned."""
    hist, reads = sc_psum0(rng, K)
    psum0_prof = reads[0][0]
    r0 = np.concatenate([np.full(800, 93 if i % 2 == 0 else 161)
                         for i in range(6)])
    return hist, [(r0, None), (psum0_prof, None)]


def _cap_batch(seed: int, K: int = 40):
    """Boundary-cap batch: GLOBAL_COV[REPEAT] pushed against the 255
    hard cap (calc_init_thres exits above it, wall.c:174-178) and
    counts pinned at/near MAX_KMER_CNT=32767 (the logfact clamp,
    prob.c:22-31, and the over-correction exclusion, wall.c:1044).
    Drawn covD in [168, 186] puts CMAX=covR in [232, 254]; count
    levels cluster at {covR-2..covR+2, 32760..32767} so the wall scan's
    both->=covR skip, the cthres table's cout<CMAX edge, and the DP's
    max_cc>=COV[REPEAT] absolute-R clause all sit one count from
    flipping."""
    rng = np.random.default_rng(np.uint64(seed) ^ np.uint64(0xCAB0CAB0))
    import math as _math

    covd = int(rng.integers(168, 187))
    covr = covd + int(5 * _math.sqrt(covd))

    def lvl():
        r = rng.random()
        if r < 0.35:
            return int(covr + rng.integers(-3, 4))
        if r < 0.55:
            return int(rng.integers(32760, 32768))
        if r < 0.75:
            return int(rng.integers(covd - 10, covd + 11))
        return int(np.exp(rng.uniform(np.log(6), np.log(32767))))

    reads = []
    for _ in range(120):
        nseg = int(rng.integers(1, 8))
        segs = rng.integers(40, 220, nseg)
        c = np.concatenate([np.full(s, lvl()) for s in segs])
        if rng.random() < 0.4:   # deep dips at the cap boundary too
            c = c.copy()
            for _ in range(int(rng.integers(1, 4))):
                if len(c) <= 2 * K:
                    break
                p = int(rng.integers(K, len(c) - K))
                c[p: p + int(rng.integers(1, K))] = rng.integers(1, 5)
        reads.append((np.clip(c, 1, 32767), None))
    h = covd // 2
    hist = np.concatenate([
        rng.poisson(h, 30000), rng.poisson(covd, 60000),
        rng.integers(1, 4, 30000)]).clip(1, 32767)
    return hist, reads


def _inject_n(rng, seq: str, counts, K: int):
    """Overwrite 1-6 random runs (1-2K bases) with 'N' and drop the
    counts of every covering k-mer window to 1 (error-level).

    NOT 0: profile entries of 0 crash the reference binary (N bases in
    the sequence alone are fine), so byte-parity fuzzing stays at >= 1
    while still driving the sequence-context scan through N runs."""
    b = bytearray(seq.encode())
    counts = np.asarray(counts, np.uint16).copy()
    plen = len(counts)
    for _ in range(int(rng.integers(1, 7))):
        L = int(rng.integers(1, 2 * K))
        p = int(rng.integers(0, max(1, len(b) - L)))
        b[p: p + L] = b"N" * min(L, len(b) - p)
        lo = max(0, p - K + 1)
        hi = min(plen, p + L)
        counts[lo:hi] = 1
    return b.decode(), counts


# the generators ``build`` takes, by the fuzz driver's mode names
GENERATORS = {"random": _random_batch, "extreme": _extreme_batch,
              "cap": _cap_batch}


def build(seed: int, outdir: str, dam: bool = False, gen=None,
          ndense: bool = False) -> tuple[int, str]:
    """Crafted dataset for one seed; returns (K, input file name).

    K is drawn from {16, 24, 32, 40} per seed, and so is the container
    format (FASTA/FASTQ, plain/gzip), so the gzip-inflate + record-scan
    input path is fuzzed too.  ``gen(seed, K)`` makes the profiles
    (default ``_random_batch``); ``ndense`` puts N runs into every read
    (``_inject_n``); ``dam`` writes a DAZZ ``reads.dam`` instead."""
    rng = np.random.default_rng(seed)
    K = int(rng.choice([16, 24, 32, 40]))
    hist_counts, reads = (gen or _random_batch)(seed, K)
    os.makedirs(outdir, exist_ok=True)
    profiles, recs = [], []
    for i, (counts, runs) in enumerate(reads):
        counts = np.asarray(counts, np.uint16)
        seq = _seq(rng, len(counts) + K - 1, runs)
        if ndense:
            seq, counts = _inject_n(rng, seq, counts, K)
        profiles.append(counts)
        recs.append((f"fuzz/{seed}/{i}", "", seq))
    root = os.path.join(outdir, "reads")
    if dam:
        from classpro_tpu_torch.io.dazz import write_dam
        write_dam(root, [(h, s) for h, _, s in recs])
        fname = "reads.dam"
    else:
        import gzip as _gz

        fmt_rng = np.random.default_rng(seed ^ 0xF0F0)
        fname = "reads." + str(fmt_rng.choice(
            ["fasta", "fasta.gz", "fastq", "fastq.gz"]))
        if ".fastq" in fname:
            op = _gz.open if fname.endswith(".gz") else open
            with op(os.path.join(outdir, fname), "wt") as f:
                for name, comment, seq in recs:
                    hdr = f"@{name} {comment}" if comment else f"@{name}"
                    f.write(f"{hdr}\n{seq}\n+\n{'I' * len(seq)}\n")
        else:
            write_fasta(os.path.join(outdir, fname), recs)
    write_profiles(root, profiles, K)
    write_histogram(root, histogram_from_counts(K, hist_counts))
    return K, fname


def write_random_model(seed: int, path: str) -> int:
    """Random HIsim error-model file (load_himodel layout, wall.c:55-62:
    int32 kmer; 0x4000 heptamer E_Rates of 11 f4; per unit length 1..3,
    krange*4^ulen M_Rates of 7 f4).  Rates are resampled until the
    fitted quadratic keeps pe in (0,1) across l=1..lmax for every ctype
    (real HIsim models always do; out-of-range pe hits C's silent
    log(<=0)=nan, which is not a behavior worth byte-matching).
    Returns the model's k-mer size; raises RuntimeError when 64
    resamples find no valid model."""
    import struct

    from classpro_tpu_torch.constants import Defaults
    from classpro_tpu_torch.estimation import _quadfit

    dflt = Defaults()
    x = np.arange(1.0, 6.0)
    for sub in range(64):
        rng = np.random.default_rng((seed << 8) | sub)
        kmer = int(rng.choice([32, 40]))
        krange = kmer // 2 - 6
        blocks, ok = [], True
        for t in range(3):
            ulen = t + 1
            n = 1 << (2 * ulen)
            # gently increasing mean rate with run length, unit scatter
            base = rng.uniform(0.002, 0.02)
            slope = rng.uniform(0.001, 0.01)
            m = np.zeros((n, krange, 7))
            for col in range(krange):
                j = (col + 2 * ulen) / ulen  # run length of this column
                mu = base + slope * j
                m[:, col, :] = rng.uniform(0.3 * mu, 1.7 * mu, (n, 7))
            m[rng.random(m.shape) < 0.08] = 0.0  # p>0 filter, wall.c:94
            # replicate the fit to pre-check the pe range
            y = np.zeros(5)
            y[0] = 0.002
            for j in range(2, 6):
                col = j * ulen - 2 * ulen
                v = m[:, col, 0]
                v = v[v > 0.0]
                y[j - 1] = v.mean() if len(v) else float("nan")
            c = _quadfit(x, y)
            lmax = dflt.max_n_lc // ulen
            ls = np.arange(1, lmax + 1)
            pe = c[0] + c[1] * ls + c[2] * ls * ls
            if not np.all((pe > 1e-9) & (pe < 0.9)):
                ok = False
                break
            blocks.append(m.astype("<f4"))
        if not ok:
            continue
        with open(path, "wb") as f:
            f.write(struct.pack("<i", kmer))
            f.write(rng.uniform(0, 0.3, 0x4000 * 11).astype("<f4")
                    .tobytes())
            for m in blocks:
                f.write(m.tobytes())
        return kmer
    raise RuntimeError(f"seed {seed}: no valid model in 64 tries")
