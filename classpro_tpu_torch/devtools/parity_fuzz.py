"""Randomized byte-identity fuzzing of the port against an oracle.

Each seed builds a crafted-profile dataset (``fuzzgen.build``: random
step / ramp / noise patterns with clustered error dips, K drawn from
{16, 24, 32, 40}, H/D coverage peaks drawn per seed), classifies it with
``python -m classpro_tpu_torch.cli classify`` on ``--device`` and with the
oracle, and byte-compares the ``.class`` outputs.

The oracle is the reference ClassPro binary when it exists (``--ref``,
default ``/tmp/refbuild/ClassPro``, built as the verify notes say), else
the port's own exact oracle (``classify --engine exact``), which is held
byte-identical to the JAX package's exact oracle, itself byte-identical to
the reference on every committed golden.  Every result line names the
oracle that decided.

Modes: default; ``--dam`` (a DAZZ ``.dam`` with ``-s``: the ``.class`` file
and the four track files compared); ``--model`` (a random HIsim model with
``-M``); ``--extreme``, ``--cap`` (the discrete-underflow and boundary-cap
generators) and ``--ndense`` (N runs in every read).  On a divergence the
first divergent read goes through ``debug-read`` and the dataset is kept.

Usage::

    python -m classpro_tpu_torch.devtools.parity_fuzz [n_seeds] [seed0] \
        [--dam | --model] [--extreme | --cap] [--ndense] \
        [--device cuda|cpu] [--ref PATH] [--workdir DIR]

Exit code 1 when any seed diverges or crashes.
"""

from __future__ import annotations

import argparse
import filecmp
import os
import shutil
import subprocess
import sys
import tempfile

from classpro_tpu_torch.devtools import fuzzgen

REF_BINARY = "/tmp/refbuild/ClassPro"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# files of the DAZZ -s mode (ClassPro.c:289-304 track writers); all must
# be byte-identical between the oracle's run and the port's
DAM_OUTS = ("reads.class", ".reads.class.anno", ".reads.class.data",
            ".reads.rep.anno", ".reads.rep.data")


def oracle_name(ref: str) -> str:
    """Which oracle decides: the reference binary at ``ref`` when it
    exists, else the port's exact oracle."""
    return "reference binary" if os.path.exists(ref) else "exact oracle"


def child_env() -> dict:
    """The environment of a port CLI child: this checkout on its path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def port_cli(args: list, timeout: float = 600) -> subprocess.CompletedProcess:
    """``python -m classpro_tpu_torch.cli <args>`` as a child process."""
    return subprocess.run([sys.executable, "-m", "classpro_tpu_torch.cli",
                           *args], env=child_env(), capture_output=True,
                          text=True, timeout=timeout)


def run_oracle(d: str, fname: str, extra: list, ref: str
               ) -> subprocess.CompletedProcess:
    """The oracle on ``d/fname``, writing ``d/reads.class`` (and, with
    ``-s`` on a ``.dam``, its tracks beside it)."""
    if os.path.exists(ref):
        return subprocess.run([ref, "-T1", f"-P{d}", *extra, fname], cwd=d,
                              capture_output=True, text=True)
    return port_cli(["classify", "--engine", "exact", *extra,
                     os.path.join(d, fname), "-o",
                     os.path.join(d, "reads.class")])


def _same(a: str, b: str) -> bool:
    return filecmp.cmp(a, b, shallow=False)


def run_seed(seed: int, base: str, device: str, ref: str, gen=None,
             ndense: bool = False) -> tuple[bool, str]:
    """One default-mode seed; returns (ok, result line).  A divergent
    seed's dataset is kept under ``base`` and triaged."""
    d = os.path.join(base, f"fuzz_{seed}")
    shutil.rmtree(d, ignore_errors=True)
    K, fname = fuzzgen.build(seed, d, gen=gen, ndense=ndense)
    tag = f"seed {seed} (K={K},{fname}) [{oracle_name(ref)}]"
    r = run_oracle(d, fname, [], ref)
    if r.returncode != 0:
        shutil.rmtree(d, ignore_errors=True)
        return True, f"{tag}: oracle failed ({r.stderr.strip()[-120:]})"
    r2 = port_cli(["classify", "--device", device, os.path.join(d, fname),
                   "-o", os.path.join(d, "ours.class")])
    if r2.returncode != 0:
        return False, f"{tag}: OURS CRASHED: {r2.stderr.strip()[-300:]}"
    if _same(os.path.join(d, "reads.class"), os.path.join(d, "ours.class")):
        shutil.rmtree(d, ignore_errors=True)
        return True, f"{tag}: IDENTICAL"
    _triage(seed, d, fname, device)
    return False, f"{tag}: *** DIFFERS ***"


def run_model_seed(seed: int, base: str, device: str, ref: str, gen=None,
                   ndense: bool = False) -> tuple[bool, str]:
    """One -M seed: a crafted dataset and a random HIsim model, the
    oracle's ``-M`` run against the port's, .class byte-compared."""
    d = os.path.join(base, f"fuzzmod_{seed}")
    shutil.rmtree(d, ignore_errors=True)
    K, fname = fuzzgen.build(seed, d, gen=gen, ndense=ndense)
    model = os.path.join(d, "rand.model")
    try:
        mk = fuzzgen.write_random_model(seed, model)
    except RuntimeError as e:   # no in-range model after 64 resamples
        shutil.rmtree(d, ignore_errors=True)
        return True, f"seed {seed}: SKIPPED ({e})"
    tag = f"seed {seed} (K={K},mK={mk}) [{oracle_name(ref)}]"
    r = run_oracle(d, fname, [f"-M{model}"], ref)
    if r.returncode != 0:
        shutil.rmtree(d, ignore_errors=True)
        return True, f"{tag}: oracle failed ({r.stderr.strip()[-120:]})"
    r2 = port_cli(["classify", "--device", device, "-M", model,
                   os.path.join(d, fname), "-o",
                   os.path.join(d, "ours.class")])
    if r2.returncode != 0:
        return False, f"{tag}: OURS CRASHED: {r2.stderr.strip()[-300:]}"
    if _same(os.path.join(d, "reads.class"), os.path.join(d, "ours.class")):
        shutil.rmtree(d, ignore_errors=True)
        return True, f"{tag}: IDENTICAL"
    return False, f"{tag}: *** DIFFERS ***"


def run_dam_seed(seed: int, base: str, device: str, ref: str, gen=None,
                 ndense: bool = False) -> tuple[bool, str]:
    """One -s/.dam seed: the same dataset built twice (oracle/ and ours/,
    so the hidden track files cannot collide), the oracle's ``-s`` run
    against the port's, all five outputs compared."""
    d = os.path.join(base, f"fuzzdam_{seed}")
    shutil.rmtree(d, ignore_errors=True)
    ro, ours = os.path.join(d, "oracle"), os.path.join(d, "ours")
    K, _ = fuzzgen.build(seed, ro, dam=True, gen=gen, ndense=ndense)
    fuzzgen.build(seed, ours, dam=True, gen=gen, ndense=ndense)
    tag = f"seed {seed} (K={K}) [{oracle_name(ref)}]"
    r = run_oracle(ro, "reads.dam", ["-s"], ref)
    if r.returncode != 0:
        shutil.rmtree(d, ignore_errors=True)
        return True, f"{tag}: oracle failed ({r.stderr.strip()[-120:]})"
    r2 = port_cli(["classify", "-s", "--device", device,
                   os.path.join(ours, "reads.dam")])
    if r2.returncode != 0:
        return False, f"{tag}: OURS CRASHED: {r2.stderr.strip()[-300:]}"
    diffs = [f for f in DAM_OUTS
             if not _same(os.path.join(ro, f), os.path.join(ours, f))]
    if not diffs:
        shutil.rmtree(d, ignore_errors=True)
        return True, f"{tag}: IDENTICAL (class + 4 tracks)"
    return False, f"{tag}: *** DIFFERS *** {diffs}"


def _triage(seed: int, d: str, fname: str, device: str) -> None:
    """Find the first read whose .class record differs and run the
    port's ``debug-read`` on it (oracle + production internals side by
    side)."""
    from classpro_tpu_torch.tools.debug_read import first_divergent_read

    rid = first_divergent_read(os.path.join(d, "reads.class"),
                               os.path.join(d, "ours.class"))
    print(f"seed {seed}: first divergent read = {rid}; triage dump:",
          flush=True)
    if rid < 0:
        return
    args = ["debug-read", os.path.join(d, fname), str(rid), "--device",
            device]
    r = port_cli(args)
    print(r.stdout[-8000:], flush=True)
    if r.returncode not in (0, 2):
        print(f"(debug-read failed: {r.stderr[-500:]})", flush=True)
    print(f"(dataset kept at {d}; re-run: python -m classpro_tpu_torch.cli "
          f"{' '.join(args)})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=20,
                    help="number of seeds")
    ap.add_argument("seed0", type=int, nargs="?", default=1000)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--dam", action="store_true",
                      help="DAZZ .dam input with -s (five outputs)")
    mode.add_argument("--model", action="store_true",
                      help="a random HIsim model with -M")
    gen = ap.add_mutually_exclusive_group()
    gen.add_argument("--extreme", action="store_true",
                     help="the discrete-underflow generator")
    gen.add_argument("--cap", action="store_true",
                     help="the boundary-cap generator")
    ap.add_argument("--ndense", action="store_true",
                    help="N runs in every read")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--ref", default=REF_BINARY,
                    help="reference binary; the port's exact oracle "
                         "decides when it does not exist")
    ap.add_argument("--workdir", default=None,
                    help="where datasets are built (default: a new "
                         "temporary directory, removed at the end "
                         "unless a seed diverged)")
    a = ap.parse_args(argv)
    g = (fuzzgen.GENERATORS["extreme"] if a.extreme else
         fuzzgen.GENERATORS["cap"] if a.cap else None)
    base = a.workdir or tempfile.mkdtemp(prefix="cpfuzz")
    os.makedirs(base, exist_ok=True)
    bad = 0
    run = (run_dam_seed if a.dam else run_model_seed if a.model
           else run_seed)
    for seed in range(a.seed0, a.seed0 + a.n):
        ok, msg = run(seed, base, a.device, a.ref, gen=g, ndense=a.ndense)
        print(msg, flush=True)
        bad += not ok
    print(f"{bad} divergent/crashed of {a.n} [{oracle_name(a.ref)}]",
          flush=True)
    if not bad and a.workdir is None:
        shutil.rmtree(base, ignore_errors=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
