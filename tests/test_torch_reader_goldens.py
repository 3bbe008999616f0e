"""Every committed golden through the port's input plane on the CPU: the
reads streamed by the C++ reader (``engine.fastx_chunks``), each read's
profile decoded in the wall stage's workers, on the main path
(``classify_file_torch``, with the fixture's -c/-r) and on the
all-device path (``TorchEngine(alldev=True).classify_stream`` over the
same chunks), write the golden's bytes; so does the shard driver
(``run_process``) in two shards and their merge.  Tolerance: byte
equality.
"""
import gzip
import json
import pathlib

import pytest
import torch

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).resolve().parent / "fixtures"
GOLDENS = sorted(str(p.parent.relative_to(FIX))
                 for p in FIX.rglob("golden.class.gz")
                 if (p.parent / "reads.fasta.gz").exists())


def _args(d: pathlib.Path) -> dict:
    f = d / "args.json"
    return json.loads(f.read_text()) if f.exists() else {}


def _golden(d: pathlib.Path) -> str:
    return gzip.decompress((d / "golden.class.gz").read_bytes()).decode()


def _text(recs) -> str:
    return "".join(f"{r.header}\n{r.seq}\n+\n{r.classes}\n" for r in recs)


@pytest.mark.parametrize("fx", GOLDENS)
def test_main_path_writes_the_golden(fx):
    from classpro_tpu_torch.engine import classify_file_torch

    d = FIX / fx
    recs = classify_file_torch(str(d / "reads.fasta.gz"), str(d / "reads"),
                               device="cpu", **_args(d))
    assert _text(recs) == _golden(d)


@pytest.mark.parametrize("fx", GOLDENS)
def test_alldev_path_writes_the_golden(fx):
    from classpro_tpu_torch.engine import (TorchEngine, chunk_records,
                                           fastx_chunks)
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles

    d = FIX / fx
    gm = build_global_model(load_histogram(str(d / "reads")), **_args(d))
    P = open_profiles(str(d / "reads"))
    eng = TorchEngine(gm, device="cpu", alldev=True)
    chunks = list(fastx_chunks(str(d / "reads.fasta.gz"), P, gm.kmer,
                               eng.batch_size))
    out = eng.classify_stream(iter(chunks), sort_window=8)
    assert _text(r for c, cls in zip(chunks, out)
                 for r in chunk_records(c, cls)) == _golden(d)


@pytest.mark.parametrize("fx", ["tiny", "branch/search9"])
def test_two_shards_and_merge_write_the_golden(fx, tmp_path):
    """Shard 1 skips to its first read through the reader (no records
    for the reads before it) and both shards merge to the golden."""
    from classpro_tpu_torch.parallel.driver import (merge_shards,
                                                    run_process,
                                                    shard_range)
    from classpro_tpu_torch.io.fastk import open_profiles

    d = FIX / fx
    out = tmp_path / "o.class"
    a = _args(d)
    for pid in (0, 1):
        run_process(str(d / "reads.fasta.gz"), str(d / "reads"), str(out),
                    2, pid, None, coverage=a.get("coverage", 0),
                    read_len=a.get("read_len", 20000), device="cpu",
                    batch_size=50, _skip_init=True)
    n = open_profiles(str(d / "reads")).nreads
    merge_shards(str(out), 2, [e - b for b, e in
                               (shard_range(n, 2, p) for p in (0, 1))])
    assert out.read_text() == _golden(d)
