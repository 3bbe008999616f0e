"""The port's benchmark runner (``classpro_tpu_torch.devtools.bench``) on
the CPU, on the tiny fixture with ``--device cpu`` (the plain versions),
one timed window of 0.2 s per mode (no test waits on the 4 s windows).

- (a) A run of each path ends ``done`` with golden parity, both rates
  above 0 and the record's whole key set, printed exactly once as the
  only line of stdout.
- (b) The twin's stream (its chunks, sort_window 8) writes for tiny's
  first 64 reads what the JAX package's ``TpuEngine.classify_chunk``
  writes for them (CPU) and what the golden holds, on both paths.
- (c) One class character flipped in a copy's golden: ``parity_ok``
  false, no rate, exit code 1.
- (d) A copy without a golden is held against the exact oracle.
- (e), (f) The budget running out and SIGTERM each print exactly one
  record, flagged.
- (g) ``--device cuda`` without a card prints an ``error`` record and
  exits nonzero: no silent CPU run.
Tolerance: byte equality of the class strings.
"""
import gzip
import hashlib
import json
import os
import pathlib
import queue
import shutil
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from classpro_tpu_torch.devtools import bench
from classpro_tpu_torch.devtools.gpu_parity import class_lines

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = ROOT / "tests" / "fixtures" / "tiny"
WINDOW_S = 0.2
ARGS = ["--device", "cpu"]
DONE_KEYS = {"metric", "value", "unit", "phase", "path", "fixture",
             "device", "card", "batch_size", "sort_window",
             "kmers_per_pass", "warmup_s", "warmup_shape", "parity_ok",
             "parity_ref", "parity_reads", "parity_sha256", "runs", "e2e",
             "e2e_runs",
             "guard_flagged", "guard_flagged_per_pass", "min_margin"}
TIMEOUT = 180


def _copy_tiny(dst: pathlib.Path, golden: bool) -> pathlib.Path:
    """The reads and FASTK files of tiny (its hidden profile parts too),
    with or without its golden."""
    keep = ["reads.fasta.gz", "reads.hist", "reads.prof"]
    keep += [p.name for p in TINY.glob(".reads.*")]
    keep += ["golden.class.gz"] if golden else []
    dst.mkdir()
    for name in keep:
        shutil.copy(TINY / name, dst / name)
    return dst


def _run_main(capsys, argv) -> tuple[int, dict]:
    """``bench.main`` in this process: its exit code and its record,
    which must be the one line of stdout."""
    rc = bench.main(argv, windows=1, window_s=WINDOW_S)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


def _child(args, env=None, **kw) -> subprocess.Popen:
    e = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
             **(env or {}))
    return subprocess.Popen([sys.executable, "-m",
                             "classpro_tpu_torch.devtools.bench", *args],
                            cwd=str(ROOT), env=e, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, **kw)


def _finish(p: subprocess.Popen) -> tuple[int, dict, str]:
    """The child's exit code, its one stdout record and its stderr."""
    out, err = p.communicate(timeout=TIMEOUT)
    lines = out.splitlines()
    assert len(lines) == 1, (lines, err[-3000:])
    return p.returncode, json.loads(lines[0]), err


@pytest.mark.parametrize("path", ["main", "alldev"])
def test_run_is_done_with_golden_parity(path, capsys):
    rc, rec = _run_main(capsys, ARGS + ["--fixture", str(TINY), "--path",
                                        path])
    assert rc == 0
    assert set(rec) == DONE_KEYS
    assert rec["phase"] == "done" and rec["path"] == path
    assert rec["parity_ok"] is True and rec["parity_ref"] == "golden"
    assert rec["parity_reads"] == 221
    golden = class_lines(str(TINY / "golden.class.gz"))
    assert rec["parity_sha256"] == hashlib.sha256(
        "\n".join(golden).encode()).hexdigest()
    assert rec["value"] > 0 and rec["e2e"] > 0
    assert rec["runs"] == [rec["value"]] and rec["e2e_runs"] == [rec["e2e"]]
    assert rec["device"] == "cpu" and rec["card"] == "cpu"
    assert rec["batch_size"] == 200 and rec["sort_window"] == 8
    assert rec["guard_flagged"] == rec["guard_flagged_per_pass"] == 0
    assert rec["kmers_per_pass"] == 892_969
    assert len(rec["warmup_shape"]) == (4 if path == "alldev" else 2)


@pytest.fixture(scope="module")
def jax_first64():
    """TpuEngine.classify_chunk on tiny's first 64 reads (JAX on the CPU),
    as bench.py calls it."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram, open_profiles
    from classpro_tpu.io.fastx import read_fastx
    from classpro_tpu.tpu.engine import TpuEngine

    root = str(TINY / "reads")
    P = open_profiles(root)
    seqs = [r.seq for r in read_fastx(str(TINY / "reads.fasta.gz"))][:64]
    eng = TpuEngine(build_global_model(load_histogram(root)))
    return eng.classify_chunk(seqs, [P.fetch(i) for i in range(64)])


@pytest.mark.parametrize("path", ["main", "alldev"])
def test_first_reads_equal_jax_and_golden(path, jax_first64):
    from classpro_tpu_torch.engine import TorchEngine

    fx = bench.load_fixture(str(TINY))
    eng = TorchEngine(fx["gm"], device="cpu", alldev=path == "alldev")
    got = bench.stream(eng, bench.passes(fx, eng.batch_size, 1))
    assert len(got) == 221
    assert got[:64] == jax_first64
    assert got[:64] == class_lines(str(TINY / "golden.class.gz"))[:64]


def test_alldev_warmup_shape_is_the_first_chunks():
    """The all-device warm-up readies the bucket the stream's first
    device chunk runs at."""
    from classpro_tpu_torch.engine import TorchEngine

    fx = bench.load_fixture(str(TINY))
    eng = TorchEngine(fx["gm"], device="cpu", alldev=True)
    shapes = []
    orig = eng._device_stage

    def spy(fblob, iblob, P, PP, shape):
        shapes.append(tuple(shape))
        return orig(fblob, iblob, P, PP, shape)
    eng._device_stage = spy
    bench.stream(eng, bench.passes(fx, eng.batch_size, 1))
    assert len(shapes) == 2
    assert bench.alldev_shape(eng, fx) == shapes[0]


def test_e2e_chunks_are_the_decoded_reads():
    """The end-to-end passes carry the reads and profiles the steady
    passes carry, read as classify_file_torch reads them."""
    from classpro_tpu_torch.io.fastk import open_profiles

    fx = bench.load_fixture(str(TINY))
    P = open_profiles(fx["root"])
    e2e = list(bench.e2e_passes(fx, P, 100, 2))
    steady = list(bench.passes(fx, 100, 2))
    assert [len(s) for s, _ in e2e] == [100, 100, 21] * 2
    for (s1, p1), (s2, p2) in zip(e2e, steady, strict=True):
        assert s1 == s2
        assert all(np.array_equal(a, b) for a, b in zip(p1, p2,
                                                        strict=True))


def test_e2e_chunks_check_the_profile_length(tmp_path):
    """A read one base shorter than its profile stops the end-to-end
    pass, as it stops classify_file_torch."""
    from classpro_tpu_torch.engine import fastx_chunks
    from classpro_tpu_torch.io.fastk import open_profiles

    d = _copy_tiny(tmp_path / "tiny", golden=False)
    with gzip.open(d / "reads.fasta.gz", "rt") as f:
        lines = f.read().split("\n")
    lines[3] = lines[3][:-1]              # the second read's one line
    with gzip.open(d / "reads.fasta.gz", "wt") as f:
        f.write("\n".join(lines))
    P = open_profiles(str(d / "reads"))
    with pytest.raises(ValueError, match="Read 1: rlen .* profile/read "
                                         "mismatch"):
        list(fastx_chunks(str(d / "reads.fasta.gz"), P, P.kmer, 200))


def test_flipped_golden_has_no_speed(tmp_path):
    d = _copy_tiny(tmp_path / "tiny", golden=True)
    with gzip.open(d / "golden.class.gz", "rt") as f:
        lines = f.read().split("\n")
    cls = lines[4 * 100 + 3]
    j = next(i for i in range(len(cls) // 2, len(cls)) if cls[i] in "EHDR")
    lines[4 * 100 + 3] = cls[:j] + ("D" if cls[j] != "D" else "H") \
        + cls[j + 1:]
    with gzip.open(d / "golden.class.gz", "wt") as f:
        f.write("\n".join(lines))
    rc, rec, err = _finish(_child(ARGS + ["--fixture", str(d)]))
    assert rc == 1, err[-3000:]
    assert rec["parity_ok"] is False and rec["phase"] == "parity"
    assert rec["value"] is None and rec["e2e"] is None and not rec["runs"]


def test_no_golden_is_held_against_the_exact_oracle(tmp_path, capsys):
    d = _copy_tiny(tmp_path / "tiny", golden=False)
    rc, rec = _run_main(capsys, ARGS + ["--fixture", str(d)])
    assert rc == 0
    assert rec["phase"] == "done" and rec["parity_ok"] is True
    assert rec["parity_ref"] == "exact" and rec["parity_reads"] == 64
    assert rec["value"] > 0 and rec["e2e"] > 0


def test_budget_prints_one_record():
    rc, rec, err = _finish(_child(ARGS + ["--fixture", str(TINY)],
                                  env={"CP_BENCH_BUDGET_S": "0.3"}))
    assert rc == 0, err[-3000:]
    assert rec["budget_exceeded"] is True
    assert rec["warmup_exceeded"] == (rec["phase"] == "warmup")
    assert rec["phase"] != "done" and rec["value"] is None


def test_sigterm_prints_one_record():
    p = _child(ARGS + ["--fixture", str(TINY)])
    lines: queue.Queue = queue.Queue()
    err: list = []

    def read_err():
        for line in p.stderr:
            err.append(line)
            lines.put(line)
    reader = threading.Thread(target=read_err, daemon=True)
    reader.start()
    try:
        while "signal handlers installed" not in lines.get(timeout=TIMEOUT):
            pass
        p.send_signal(signal.SIGTERM)
        out = p.stdout.read()
        assert p.wait(timeout=TIMEOUT) == 0, "".join(err)[-3000:]
    finally:
        p.kill()
    reader.join(timeout=TIMEOUT)
    assert not reader.is_alive()
    recs = out.splitlines()
    assert len(recs) == 1, recs
    rec = json.loads(recs[0])
    assert rec["interrupted"] == "SIGTERM" and rec["phase"] != "done"


def test_cuda_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure it")
    rc, rec, err = _finish(_child(["--device", "cuda", "--fixture",
                                   str(TINY)]))
    assert rc != 0
    assert "CUDA is not available" in rec["error"]
    assert rec["phase"] == "init" and rec["value"] is None
    assert rec["device"] is None and "Traceback" in err
