"""Whole-chunk round robin over devices (``TorchEngine(devices=[...])``,
the JAX package's ``TpuEngine(devices=)``), on the CPU with
``devices=["cpu"] * 3``: the same outputs as the single-device engine,
including a chunk with an empty profile and a partial last chunk, on the
main path and on the all-device path (test_tpu_engine.py's
test_multidevice_round_robin_matches_single).  A device list that repeats
a device holds one table replica; three distinct CPU "devices" do not
exist, so the per-card streams are exercised on the card only
(chip_smoke.py phase shard).
"""
import gzip
import pathlib

import numpy as np
import pytest
import torch

from test_torch_kernel_shim import _load

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"


def _gold():
    with gzip.open(FIX / "tiny" / "golden.class.gz", "rt") as f:
        return f.read().split("\n")[3::4]


@pytest.mark.parametrize("alldev", [False, True])
def test_multidevice_round_robin_matches_single(alldev):
    from classpro_tpu_torch.engine import TorchEngine

    gm, seqs, profs = _load("tiny", 45)
    profs[7] = np.zeros(0, np.uint16)
    B = 10                                   # 4 full chunks + partial

    def run(eng):
        chunks = ((seqs[i:i + B], profs[i:i + B]) for i in range(0, 45, B))
        return [c for out in eng.classify_stream(chunks) for c in out]

    want = run(TorchEngine(gm, batch_size=B, device="cpu", alldev=alldev))
    eng = TorchEngine(gm, batch_size=B, alldev=alldev,
                      devices=["cpu"] * 3)
    assert len(eng._on) == 1                 # one replica per device
    assert run(eng) == want
    assert eng._rr >= 3                      # every device got a chunk
    gold = _gold()
    assert want[7] == "N" * len(seqs[7])
    assert [c for i, c in enumerate(want) if i != 7] == \
        [gold[i] for i in range(45) if i != 7]
    st = eng.stats()
    assert st["chunks"] == 5 and st["absorbed_chunks"] == 0
    assert st["shapes"] and all(len(s) == 2 for s in st["shapes"])


def test_sorted_stream_deals_round_robin():
    """sort_window re-composes the batches before they are dealt; the
    bytes stay the single-device engine's."""
    from classpro_tpu_torch.engine import TorchEngine

    gm, seqs, profs = _load("tiny", 60)
    chunks = [(seqs[i:i + 12], profs[i:i + 12]) for i in range(0, 60, 12)]
    want = list(TorchEngine(gm, batch_size=12, device="cpu")
                .classify_stream(iter(chunks), sort_window=3))
    eng = TorchEngine(gm, batch_size=12, devices=["cpu", "cpu"])
    assert list(eng.classify_stream(iter(chunks), sort_window=3)) == want


def test_devices_needs_enough_cards():
    """--devices N refuses to run on fewer cards (no silent slice), and
    refuses the CPU."""
    from classpro_tpu_torch.engine import local_devices

    assert local_devices(0, "cpu") is None
    with pytest.raises(ValueError, match="--device cuda"):
        local_devices(2, "cpu")
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        with pytest.raises(ValueError, match="only"):
            local_devices(n + 1)
        assert local_devices(n) == [torch.device("cuda", i)
                                    for i in range(n)]
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            local_devices(1)


@pytest.mark.gpu
@pytest.mark.parametrize("alldev", [False, True])
def test_round_robin_on_cards(alldev):
    """On the card: every card (or cuda:0 twice on a one-card machine),
    each chunk on its own card's stream, == the plain CPU engine."""
    from classpro_tpu_torch.engine import TorchEngine

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(n)] if n > 1
               else ["cuda:0", "cuda:0"])
    gm, seqs, profs = _load("tiny", 45)
    profs[7] = np.zeros(0, np.uint16)
    chunks = [(seqs[i:i + 10], profs[i:i + 10]) for i in range(0, 45, 10)]
    want = list(TorchEngine(gm, batch_size=10, device="cpu", alldev=alldev)
                .classify_stream(iter(chunks)))
    eng = TorchEngine(gm, batch_size=10, devices=devices, alldev=alldev)
    assert list(eng.classify_stream(iter(chunks))) == want
    assert len(eng._on) == len(set(devices))
