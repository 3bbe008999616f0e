"""Byte-identity sweep of the port across simulated dataset regimes.

For each (coverage, genome length, seed) configuration: simulate a
dataset with the port's ``simulate``, classify it with the oracle (the
reference binary at ``--ref`` when it exists, else the port's exact
oracle, ``classify --engine exact``) and with the port's ``classify`` on
``--device``, and byte-compare the ``.class`` outputs.  The configurations
are those of ``tools/parity_sweep.py``, both edges of the reference's
stated ~10x-100x operating range included.

Usage::

    python -m classpro_tpu_torch.devtools.parity_sweep [--device cuda|cpu] \
        [--ref PATH] [--configs N]

Exit code 1 when any configuration differs.
"""

from __future__ import annotations

import argparse
import filecmp
import os
import tempfile

from classpro_tpu_torch.devtools.parity_fuzz import (REF_BINARY,
                                                     oracle_name, port_cli,
                                                     run_oracle)

CONFIGS = [
    (15, 31_000, 5),
    (60, 45_000, 9),
    (40, 80_000, 13),
    (25, 35_000, 21),
    # the reference's stated operating range is ~10x-100x diploid
    # coverage: both edges.  At 10x the D peak sits at the reference's
    # own peak-search floor (hist.c:63 exits when the tallest peak count
    # is < 10, telling the user to pass -c), so the low edge runs with
    # the -c override, which also pins -c parity at the edge.
    (10, 40_000, 31, ["-c10"]),
    (100, 30_000, 37),
]


def run_config(cfg, device: str, ref: str) -> bool:
    cov, glen, seed = cfg[:3]
    extra = list(cfg[3]) if len(cfg) > 3 else []
    with tempfile.TemporaryDirectory(prefix="cpsweep") as d:
        r = port_cli(["simulate", d, "--genome-len", str(glen),
                      "--coverage", str(cov), "--seed", str(seed)])
        if r.returncode != 0:
            raise RuntimeError(f"simulate failed: {r.stderr[-500:]}")
        r = run_oracle(d, "reads.fasta", extra, ref)
        if r.returncode != 0:
            raise RuntimeError(f"oracle failed: {r.stderr[-500:]}")
        r = port_cli(["classify", "--device", device, *extra,
                      os.path.join(d, "reads.fasta"), "-o",
                      os.path.join(d, "ours.class")])
        if r.returncode != 0:
            raise RuntimeError(f"classify failed: {r.stderr[-500:]}")
        same = filecmp.cmp(os.path.join(d, "reads.class"),
                           os.path.join(d, "ours.class"), shallow=False)
    print(f"cov={cov} glen={glen} seed={seed}: "
          + ("IDENTICAL" if same else "*** DIFFERS ***")
          + f" [{oracle_name(ref)}]", flush=True)
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--ref", default=REF_BINARY)
    ap.add_argument("--configs", type=int, default=len(CONFIGS),
                    help="run the first N configurations")
    a = ap.parse_args(argv)
    ok = True
    for cfg in CONFIGS[: a.configs]:
        ok &= run_config(cfg, a.device, a.ref)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
