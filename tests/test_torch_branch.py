"""The crafted branch-coverage fixtures through the port.

Each fixture under tests/fixtures/branch/ drives a rarely-taken branch of
the reference (rescue/demotion heuristics, psum==0, M==0, ...; see
test_branch_parity.py).  For each one, with one CPU engine:

* the port's rel stage matches the JAX package's ``rel_only_dev`` on the
  same C++ blobs (tolerance as in test_torch_rel.py);
* the engine's stream writes the reference golden byte for byte.

The fixtures are split over this file, test_torch_branch_more.py and
test_torch_branch_rest.py so that each file runs in well under a minute
on one test worker.
"""
import gzip
import json
import pathlib

import pytest

from test_torch_rel import check_fixture

FIX = pathlib.Path(__file__).parent / "fixtures" / "branch"
NAMES = sorted(p.name for p in FIX.iterdir() if p.is_dir())
# run in test_torch_branch_more.py and test_torch_branch_rest.py
MORE = ("dips", "extreme5", "extreme8", "search108", "stepdip")
REST = ("high", "search1", "search10", "search15", "search9", "uniform")


def check_branch(name):
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.classfile import class_header
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx

    d = FIX / name
    args = {}
    if (d / "args.json").exists():
        args = json.loads((d / "args.json").read_text())
    gm = build_global_model(load_histogram(str(d / "reads")), **args)
    eng = TorchEngine(gm, device="cpu")
    assert check_fixture(f"branch/{name}", eng=eng) > 0

    P = open_profiles(str(d / "reads"))
    reads = list(read_fastx(str(d / "reads.fasta.gz")))
    profs = [P.fetch(i) for i in range(len(reads))]
    B = eng.batch_size
    chunks = [([r.seq for r in reads[lo:lo + B]], profs[lo:lo + B])
              for lo in range(0, len(reads), B)]
    classes = [c for out in eng.classify_stream(iter(chunks), sort_window=8)
               for c in out]
    text = "".join(f"{class_header(r.name, r.comment)}\n{r.seq}\n+\n{c}\n"
                   for r, c in zip(reads, classes))
    golden = gzip.decompress((d / "golden.class.gz").read_bytes()).decode()
    assert text == golden, name


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n not in MORE + REST])
def test_branch_fixture_rel_and_bytes(name):
    check_branch(name)
