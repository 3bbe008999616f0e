"""The all-device engine, TorchEngine(alldev=True, device="cpu"), writes
the reference golden bytes on tiny, a medium subset, the fuzz-seed
regression reads and the branch/* fixtures (split over this file and
test_torch_alldev_branch*.py so that each runs in under a minute on one
test worker).  The main path is held to the same goldens by
test_torch_engine.py and test_torch_branch*.py; on tiny the two engines
are also compared chunk by chunk.  Tolerance: byte equality.
"""
import gzip
import json
import pathlib

import numpy as np
import pytest
import torch

from test_torch_kernel_shim import _load

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"
BRANCH = sorted(p.name for p in (FIX / "branch").iterdir() if p.is_dir())
# the branch fixtures of test_torch_alldev_branch.py and _branch_more.py
BRANCH_B = ("extreme8", "search1", "search108", "search15", "search9")
BRANCH_C = ("dips", "errors", "extreme5", "high", "psum0", "search10",
            "smallk")


def _engine_text(d: pathlib.Path, n=None):
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.classfile import class_header
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx

    args = {}
    if (d / "args.json").exists():
        args = json.loads((d / "args.json").read_text())
    gm = build_global_model(load_histogram(str(d / "reads")), **args)
    eng = TorchEngine(gm, device="cpu", alldev=True)
    P = open_profiles(str(d / "reads"))
    reads = list(read_fastx(str(d / "reads.fasta.gz")))[:n]
    profs = [P.fetch(i) for i in range(len(reads))]
    B = eng.batch_size
    chunks = [([r.seq for r in reads[lo:lo + B]], profs[lo:lo + B])
              for lo in range(0, len(reads), B)]
    classes = [c for out in eng.classify_stream(iter(chunks), sort_window=8)
               for c in out]
    return "".join(f"{class_header(r.name, r.comment)}\n{r.seq}\n+\n{c}\n"
                   for r, c in zip(reads, classes))


def _golden(d: pathlib.Path, n=None) -> str:
    text = gzip.decompress((d / "golden.class.gz").read_bytes()).decode()
    if n is None:
        return text
    return "".join(text.splitlines(keepends=True)[:4 * n])


def check_branch(name):
    d = FIX / "branch" / name
    assert _engine_text(d) == _golden(d), name


def test_branch_split_covers_every_fixture():
    assert set(BRANCH_B) | set(BRANCH_C) <= set(BRANCH)
    assert not set(BRANCH_B) & set(BRANCH_C)


@pytest.mark.parametrize("name", [n for n in BRANCH
                                  if n not in BRANCH_B + BRANCH_C])
def test_alldev_engine_bytes_branch(name):
    check_branch(name)


@pytest.mark.parametrize("fx,n", [("tiny", None), ("medium", 100)])
def test_alldev_engine_bytes(fx, n):
    assert _engine_text(FIX / fx, n=n) == _golden(FIX / fx, n)


def test_alldev_engine_equals_main_path_tiny():
    """Chunk by chunk, alldev and the main path give the same classes."""
    from classpro_tpu_torch.engine import TorchEngine

    gm, seqs, profs = _load("tiny")
    main = TorchEngine(gm, batch_size=64, device="cpu")
    alld = TorchEngine(gm, batch_size=64, device="cpu", alldev=True)
    chunks = [(seqs[i:i + 64], profs[i:i + 64])
              for i in range(0, len(seqs), 64)]
    assert list(alld.classify_stream(iter(chunks))) \
        == list(main.classify_stream(iter(chunks)))
    # reads with no profile come back all-N on both paths
    out = alld.classify_chunk(["A" * 50] + seqs[:2],
                              [np.zeros(0, np.uint16)] + profs[:2])
    assert out == ["N" * 50] + main.classify_chunk(seqs[:2], profs[:2])


@pytest.mark.parametrize("fx,rid", [("tie8339", 94), ("initkill21517", 82)])
def test_alldev_regression_reads(fx, rid):
    """tie8339 read 94 (an exact f64 tie): the device flags the read and
    the host re-decides it whole; initkill21517 read 82 (-M model)."""
    from classpro_tpu_torch.engine import TorchEngine

    gm, seqs, profs = _load(fx)
    d = FIX / fx
    golden = gzip.open(d / f"golden{rid}.txt.gz", "rt").read().rstrip("\n")
    eng = TorchEngine(gm, device="cpu", alldev=True)
    assert eng.classify_chunk(seqs, profs)[0] == golden
    if fx == "tie8339":
        assert eng.guard_flagged >= 1
