"""Single-read triage dump (the reference's DEBUG_SINGLE analog).

The reference's per-stage diagnostics are compile-time stderr flags
(``DEBUG_SINGLE``/``DEBUG_SINGLE_ID`` and the DEBUG_* family,
ClassPro.h:11-29).  Here it is a runtime command::

    python -m classpro_tpu_torch.cli debug-read <source> <read-id> \
        [-N root] [-c cov] [-r rlen] [-M model] [--device cuda|cpu]

which dumps, side by side for ONE read:

* the global model (COV, DR_RATIO);
* ORACLE stages (the pure-Python ``exact`` package): every interval
  (b, e, cb, ce, ccb, cce, is_rel, pe, pe_o), the raw fw and bw DP
  matrices with their paths, and the final class string (run-length
  form);
* PRODUCTION stages (``TorchEngine`` on ``device``): the C++ wall-stage
  records, the device DP's assignments, risky / rescue flags and f32
  decision margins, and the final class string after the host
  demotions, the fw/bw reconciliation and the exactness guard;
* a diff summary (first divergent base and the oracle interval it
  falls in).

The production half stages the read ONCE: ``TorchEngine._submit`` runs
the wall stage and enqueues the DP, the wall records are copied out of
the slab before ``_finish`` returns it to the pool, the device result is
split with ``rel.unpack_out``, and only then does ``_finish`` produce the
class string.  ``devtools.parity_fuzz`` runs this command on the first
divergent read of a divergent seed.
"""

from __future__ import annotations

import sys

import numpy as np


def _rle(s: str) -> str:
    """Run-length render: 'N39 E10 H210 ...' (readable class strings)."""
    if not s:
        return "(empty)"
    out = []
    cur, n = s[0], 1
    for c in s[1:]:
        if c == cur:
            n += 1
        else:
            out.append(f"{cur}{n}")
            cur, n = c, 1
    out.append(f"{cur}{n}")
    return " ".join(out)


def _fmt_intvl_row(i, b, e, cb, ce, ccb, cce, is_rel, pe, peob, peoe,
                   asgn=None) -> str:
    a = "" if asgn is None else f" asgn={asgn}"
    return (f"  [{i:3d}] ({b:6d},{e:6d}) c=({cb:5d},{ce:5d}) "
            f"cc=({ccb:5d},{cce:5d}) rel={int(is_rel)} pe={pe:10.3f} "
            f"pe_o=({peob:10.3f},{peoe:10.3f}){a}")


def _dump_dp(dp, path, tag, out) -> None:
    print(f"  {tag} path: {''.join('ERHD?'[min(int(p), 4)] for p in path)}",
          file=out)
    for i in range(dp.shape[0]):
        cells = "  ".join(f"{'ERHD'[s]}:{dp[i, s]:12.4f}" for s in range(4))
        print(f"    dp[{i:3d}] {cells}", file=out)


_WALL_FIELDS = ("b", "e", "cb", "ce", "ccb", "cce", "is_rel", "pe",
                "pe_o_b", "pe_o_e")


def _production(eng, seq: str, profile, intvls, out) -> str:
    """The production half: one staging of the read through ``eng``;
    prints the wall records and the device DP, returns the class
    string."""
    from classpro_tpu_torch.rel import unpack_out

    print("\n--- production wall stage (C++) ---", file=out)
    st = eng._submit([seq], [profile])
    # the read's records, copied before _finish releases the slab
    arr = (st["slab"][: int(st["n_out"][0])].copy() if "slab" in st
           else np.zeros(0))
    n_rel = int(st["n_rel"][0]) if "n_rel" in st else 0
    print(f"  {len(arr)} intervals, {n_rel} reliable", file=out)
    wall_diff = []
    for i in range(len(arr)):
        a = arr[i]
        print(_fmt_intvl_row(i, a["b"], a["e"], a["cb"], a["ce"],
                             a["ccb"], a["cce"], a["is_rel"], a["pe"],
                             a["pe_o_b"], a["pe_o_e"]), file=out)
        if i < len(intvls):
            I = intvls[i]
            for f in _WALL_FIELDS:
                if getattr(I, f) != a[f]:
                    wall_diff.append((i, f, getattr(I, f), a[f]))
    if len(arr) != len(intvls):
        print(f"  !! interval COUNT differs: oracle {len(intvls)} vs "
              f"production {len(arr)}", file=out)
    for i, f, ov, pv in wall_diff:
        print(f"  !! wall diff at [{i}].{f}: oracle={ov} production={pv}",
              file=out)

    if "out" in st:
        if "done" in st:
            st["done"].synchronize()
        v, risky, rescue, mm = unpack_out(st["out"].numpy(), st["max_m"])
        R = v.shape[0] // 2
        m = int(st["rel_m"][0])
        print(f"\n--- device DP ({eng.device}, bucket R={R} "
              f"max_m={st['max_m']}) ---", file=out)
        for tag, j in (("fw", 0), ("bw", R)):
            path = "".join("ERHD?"[min(max(int(x), 0), 4)]
                           for x in v[j, :m])
            print(f"  {tag} asgn (scan order): {path}", file=out)
        print(f"  margins fw: {np.array2string(mm[:R], precision=3)}",
              file=out)
        print(f"  margins bw: {np.array2string(mm[R:], precision=3)}",
              file=out)
        print(f"  risky rows: {np.nonzero(risky)[0]}  rescue rows: "
              f"{np.nonzero(rescue)[0]}", file=out)
    else:
        print("\n--- device DP ---", file=out)
        print("  no reliable interval: the device DP did not run",
              file=out)
    return eng._finish(st).strs()[0]


def debug_read(source: str, rid: int, fastk_root: str | None = None,
               coverage: int = 0, read_len: int = 20000,
               model_path: str | None = None, out=None,
               device=None) -> bool:
    """Dump oracle + production internals for read ``rid``; production
    runs on ``device`` (default ``cuda``).

    Returns True when oracle and production class strings agree."""
    from classpro_tpu_torch.constants import STOC
    from classpro_tpu_torch.context import seq_context
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.exact.pipeline import ReadClassifier
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx, root_of

    out = out or sys.stdout
    fk = fastk_root or root_of(source)
    gm = build_global_model(load_histogram(fk), coverage=coverage,
                            read_len=read_len, model_path=model_path)
    P = open_profiles(fk)
    rec = None
    for i, r in enumerate(read_fastx(source)):
        if i == rid:
            rec = r
            break
    if rec is None:
        raise ValueError(f"read {rid} not found in {source}")
    profile = P.fetch(rid)
    K = gm.kmer

    print(f"=== read {rid} ({rec.name}) rlen={len(rec.seq)} "
          f"plen={len(profile)} ===", file=out)
    print(f"model: COV(E,R,H,D)=({gm.cov[0]},{gm.cov[1]},{gm.cov[2]},"
          f"{gm.cov[3]}) DR_RATIO={gm.dr_ratio:.6f} K={K} "
          f"READ_LEN={gm.read_len}", file=out)

    # ---------------- oracle stages ----------------------------------
    clf = ReadClassifier(gm)
    lctx, rctx = seq_context(rec.seq.encode("ascii"))
    intvls = clf.wall.find_wall(profile, lctx, rctx)
    rintvl = clf.wall.find_rel_intvl(intvls)
    print(f"\n--- oracle wall stage: {len(intvls)} intervals, "
          f"{len(rintvl)} reliable ---", file=out)
    for i, I in enumerate(intvls):
        print(_fmt_intvl_row(i, I.b, I.e, I.cb, I.ce, I.ccb, I.cce,
                             I.is_rel, I.pe, I.pe_o_b, I.pe_o_e),
              file=out)

    M = len(rintvl)
    if M:
        print("\n--- oracle rel DP (raw passes, pre-rescue) ---", file=out)
        for fwd, tag in ((True, "fw"), (False, "bw")):
            rc = clf.rel
            rc.fwd = fwd
            rc.COV = [int(c) for c in gm.cov]
            path = rc._classify_rel_pass([I.copy() for I in rintvl], M,
                                         len(profile))
            _dump_dp(np.asarray(rc.dp), path, tag, out)

    # the final oracle result on THE SAME interval objects
    clf.rel.classify(rintvl, intvls, len(profile))
    clf.unrel.classify(intvls)
    body = np.empty(len(profile), dtype="U1")
    for I in intvls:
        body[I.b:I.e] = STOC[I.asgn]
    oracle_cls = "N" * (K - 1) + "".join(body)
    print("\n--- oracle final ---", file=out)
    for i, I in enumerate(intvls):
        mark = "R" if I.is_rel else " "
        print(f"  [{i:3d}]{mark} ({I.b:6d},{I.e:6d}) -> "
              f"{STOC[I.asgn] if I.asgn < 4 else '?'}", file=out)
    print(f"  classes: {_rle(oracle_cls)}", file=out)

    # ---------------- production stages ------------------------------
    eng = TorchEngine(gm, batch_size=8, device=device)
    prod_cls = _production(eng, rec.seq, profile, intvls, out)
    print("\n--- production final ---", file=out)
    print(f"  classes: {_rle(prod_cls)}", file=out)
    print(f"  guard_flagged={eng.guard_flagged} "
          f"guard_min_margin={eng.guard_min_margin}", file=out)

    # ---------------- diff summary -----------------------------------
    same = prod_cls == oracle_cls
    if same:
        print("\nRESULT: oracle == production", file=out)
    else:
        pos = next(i for i, (a, b) in enumerate(zip(oracle_cls, prod_cls))
                   if a != b) if len(oracle_cls) == len(prod_cls) else -1
        print(f"\nRESULT: *** DIVERGENT *** first diff at base {pos}: "
              f"oracle={oracle_cls[pos] if pos >= 0 else '?'} "
              f"production={prod_cls[pos] if pos >= 0 else '?'}", file=out)
        hit = [i for i, I in enumerate(intvls)
               if pos >= 0 and I.b <= pos - (K - 1) < I.e]
        if hit:
            print(f"  divergent base falls in oracle interval {hit[0]}",
                  file=out)
    return same


def first_divergent_read(a_path: str, b_path: str) -> int:
    """Index of the first read whose class record differs between two
    .class files (-1 if byte-equal)."""
    with open(a_path) as fa, open(b_path) as fb:
        rid = 0
        while True:
            ra = [fa.readline() for _ in range(4)]
            rb = [fb.readline() for _ in range(4)]
            if not ra[0] and not rb[0]:
                return -1
            if ra != rb:
                return rid
            rid += 1
