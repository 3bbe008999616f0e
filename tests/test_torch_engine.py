"""End-to-end bytes of the port's engine (TorchEngine on the CPU, the
plain torch DP) against the reference goldens, and its stream forms.

The branch/* fixtures run in test_torch_branch*.py; a test that needs the
card (``gpu`` marker) skips here.
"""
import gzip
import pathlib

import numpy as np
import pytest
import torch

# one intra-op thread per test worker (see test_torch_kernel_shim.py)
torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"


def _gold(fx):
    with gzip.open(FIX / fx / "golden.class.gz", "rt") as f:
        return f.read().split("\n")[3::4]


def _tiny(n):
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx

    root = str(FIX / "tiny" / "reads")
    gm = build_global_model(load_histogram(root))
    P = open_profiles(root)
    reads = list(read_fastx(str(FIX / "tiny" / "reads.fasta.gz")))[:n]
    return gm, [r.seq for r in reads], [P.fetch(i) for i in range(len(reads))]


def test_engine_byte_identity_tiny_subset():
    from classpro_tpu_torch.engine import TorchEngine

    gm, seqs, profs = _tiny(64)
    eng = TorchEngine(gm, batch_size=64, device="cpu")
    out = eng.classify_chunk(seqs, profs)
    gold = _gold("tiny")
    bad = [i for i in range(64) if out[i] != gold[i]]
    assert not bad, f"{len(bad)}/64 reads differ from the reference golden"
    assert eng.chunks_done == 1 and eng.guard_flagged == 0


def test_stream_equals_chunks_and_sorted_equals_plain():
    """The depth-3 stream yields per-chunk results identical to the
    synchronous path, in input order; the plen-sorted stream
    (sort_window) gives the same bytes in the original structure."""
    from classpro_tpu_torch.engine import TorchEngine

    gm, seqs, profs = _tiny(150)
    eng = TorchEngine(gm, batch_size=40, device="cpu")
    B = 40
    chunks = [(seqs[i:i + B], profs[i:i + B]) for i in range(0, 150, B)]
    want = [eng.classify_chunk(s, p) for s, p in chunks]
    assert list(eng.classify_stream(iter(chunks))) == want
    assert list(eng.classify_stream(iter(chunks), sort_window=3)) == want
    assert list(eng.classify_stream(iter(chunks), prefetch=0)) == want
    gold = _gold("tiny")
    assert [c for w in want for c in w] == gold[:150]


@pytest.mark.parametrize("fx,rid", [("tie8339", 94), ("initkill21517", 82)])
def test_regression_reads(fx, rid):
    """tie8339 read 94: an exact f64 tie the guard must flag and the
    host oracle re-decide; initkill21517 read 82 (-M model): the init
    cell's softmax-underflow kill."""
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram

    d = FIX / fx
    model = str(d / "rand.model") if fx == "initkill21517" else None
    gm = build_global_model(load_histogram(str(d / "reads")),
                            model_path=model)
    seq = gzip.open(d / f"read{rid}.fa.gz", "rt").read().split("\n")[1]
    prof = np.load(d / f"prof{rid}.npy")
    golden = gzip.open(d / f"golden{rid}.txt.gz", "rt").read().rstrip("\n")
    eng = TorchEngine(gm, device="cpu")
    assert eng.classify_chunk([seq], [prof])[0] == golden
    if fx == "tie8339":
        assert eng.guard_flagged >= 1


def test_classify_file_and_cli_tiny(tmp_path):
    """classify_file_torch (the entry point) and the CLI write the tiny
    golden byte for byte; the CLI refuses --server (a later slice), a bad
    -T and an input it cannot open."""
    from classpro_tpu_torch.cli import main

    want = gzip.decompress((FIX / "tiny" / "golden.class.gz").read_bytes())
    out = tmp_path / "tiny.class"
    rc = main(["classify", str(FIX / "tiny" / "reads.fasta.gz"),
               "-N", str(FIX / "tiny" / "reads"), "-o", str(out),
               "--device", "cpu", "-T", "2"])
    assert rc == 0 and out.read_bytes() == want

    for extra in (["--server", str(tmp_path / "sock")], ["-T", "0"]):
        assert main(["classify", str(FIX / "tiny" / "reads.fasta.gz"),
                     "--device", "cpu"] + extra) == 1
    assert main(["classify", str(tmp_path / "nothing.dam"),
                 "--device", "cpu"]) == 1
    assert main(["classify", str(tmp_path / "nothing.fasta"),
                 "--device", "cpu"]) == 1


def test_cli_refusal_names_the_later_slice(capsys):
    from classpro_tpu_torch.cli import main

    assert main(["classify", "x.fasta", "--server", "sock"]) == 1
    assert "later slice" in capsys.readouterr().err


def test_engine_without_device_raises_without_cuda():
    """Entry points run on the card unless the caller asks for the CPU:
    on a machine without CUDA, the default device raises."""
    from classpro_tpu_torch.device import resolve_device
    from classpro_tpu_torch.engine import TorchEngine

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    gm, _, _ = _tiny(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchEngine(gm)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
