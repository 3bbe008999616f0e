"""The port's dev-tool twins run end to end on the CPU (small sizes).

``gpu_parity`` on the tiny fixture and one fuzz seed, ``soak`` at a tiny
size (spot parity, the two-shard merge and the served job all equal),
``parity_sweep`` on its first configuration, ``phase_profile`` and
``e2e_probe`` on a few tiny reads, and ``profile_summary`` on a synthetic
Chrome trace (its busy share is the union of the device intervals) and on
a real CPU trace of ``classify --torch-profile``: each exits 0.
"""
import gzip
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = ROOT / "tests" / "fixtures" / "tiny"
NO_REF = "/nonexistent/ClassPro"     # the exact oracle decides


def test_gpu_parity_tiny_on_cpu(tmp_path, capsys):
    from classpro_tpu_torch.devtools import gpu_parity

    out = tmp_path / "p.json"
    rc = gpu_parity.main(["--fixture", "tiny", "--seeds", "1", "--device",
                          "cpu", "--ref", NO_REF, "--workers", "1",
                          "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0, text
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["card"] == "cpu"
    assert rec["oracle"] == "exact oracle"
    assert [d["name"] for d in rec["datasets"]] == ["tiny", "fuzz990000"]
    for d in rec["datasets"]:
        for p in ("main", "alldev"):
            assert d["paths"][p]["mismatches"] == 0
            assert "guard_flagged" in d["paths"][p]
    assert rec["datasets"][1]["kmers"] > 0


def test_gpu_parity_check_dam_on_cpu(tmp_path):
    """The .dam with -s through the CLI in this process (chip_smoke's
    tools phase): its .class and four tracks equal the exact oracle's."""
    from classpro_tpu_torch.devtools import gpu_parity

    rec = gpu_parity.check_dam(str(tmp_path), "cpu", ref=NO_REF, seed=1000)
    assert rec == {"K": 16, "oracle": "exact oracle", "files": 5,
                   "differing_files": []}


def test_soak_tiny_on_cpu(tmp_path, capsys):
    from classpro_tpu_torch.devtools import soak

    out = tmp_path / "soak.json"
    rc = soak.main(["--gbp", "0.001", "--device", "cpu", "--dir",
                    str(tmp_path / "d"), "--out", str(out), "--spot", "4"])
    first = capsys.readouterr().out
    assert rc == 0, first
    assert "[gen] done" in first
    res = json.loads(out.read_text())
    assert res["ok"] and res["card"] == "cpu"
    assert res["spot_parity"]["sampled"] == 4
    assert res["spot_parity"]["mismatches"] == 0
    assert res["shard_merge"]["merge_equal"]
    assert res["served"]["equal_to_fresh"]
    c = res["classify"]
    assert c["rss_peak_mb"] > 0 and c["kmers_per_s"] > 0
    assert c["engine_stats"]["kmers"] == res["meta"]["n_kmers"]
    # a second run on the same dataset skips the generator
    rc = soak.main(["--gbp", "0.001", "--device", "cpu", "--dir",
                    str(tmp_path / "d"), "--out", str(out), "--spot", "2",
                    "--skip-gen", "--skip-shard", "--skip-serve"])
    assert rc == 0
    assert "[gen]" not in capsys.readouterr().out


def test_parity_sweep_first_config_on_cpu(capsys):
    from classpro_tpu_torch.devtools import parity_sweep

    rc = parity_sweep.main(["--device", "cpu", "--ref", NO_REF,
                            "--configs", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "cov=15 glen=31000 seed=5: IDENTICAL [exact oracle]" in out


def test_phase_profile_on_cpu(capsys):
    from classpro_tpu_torch.devtools import phase_profile

    gm, seqs, profs = phase_profile.load_dataset(str(TINY / "reads"), 12)
    res = phase_profile.profile(gm, seqs, profs, batch=6, passes=1,
                                device="cpu")
    out = capsys.readouterr().out
    assert res["chunks"] == 2 and res["device_ms_per_chunk"] is None
    for stage in ("wall_stage(C++)", "pack_rel(C++)", "finish_batch(C++)",
                  "demote+reconcile+guard"):
        assert stage in res["stage_ms_per_chunk"] and stage in out
    assert res["stream_kmers_per_s"] > 0


def test_e2e_probe_on_cpu(capsys):
    from classpro_tpu_torch.devtools import e2e_probe

    assert e2e_probe.main(["--fixture", "tiny", "--nreads", "8", "--reps",
                           "1", "--batch", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in ("steady", "decode", "nogz", "full"):
        assert f"{name:7s} trial1:" in out


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_profile_summary_synthetic_trace(tmp_path, capsys):
    from classpro_tpu_torch.devtools import profile_summary as ps

    evs = [_ev("classify", "cpu_op", 0, 1000),
           _ev("rel_dp_kernel(...)", "kernel", 100, 200),
           _ev("rel_dp_kernel(...)", "kernel", 250, 100),   # overlaps
           _ev("Memcpy HtoD", "gpu_memcpy", 500, 50),
           _ev("aten::add", "cpu_op", 800, 400),
           {"ph": "i", "name": "marker", "ts": 5000}]
    path = tmp_path / "t.pt.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": evs}, f)
    sh = ps.trace_share(str(path))
    assert sh["device_events"] == 3 and sh["rel_dp_kernel_events"] == 2
    assert sh["rel_dp_kernel_us"] == 300
    assert sh["device_busy_us"] == 250 + 50          # [100, 350) + 50
    assert sh["window_us"] == 1200
    top = ps.top_events(str(path), 2)
    assert [t[0] for t in top] == ["classify", "aten::add"]
    assert ps.main([str(tmp_path), "5"]) == 0
    out = capsys.readouterr().out
    assert "rel_dp_kernel" in out and "card busy 25.00%" in out


def test_profile_summary_cpu_classify_trace(tmp_path, capsys):
    from classpro_tpu_torch.cli import main
    from classpro_tpu_torch.devtools import profile_summary as ps

    src = tmp_path / "r.fasta"
    recs = gzip.decompress((TINY / "reads.fasta.gz").read_bytes()) \
        .decode().split("\n")
    src.write_text("\n".join(recs[:8]) + "\n")
    assert main(["classify", "--device", "cpu", "--torch-profile",
                 str(tmp_path / "tr"), str(src), "-N", str(TINY / "reads"),
                 "-o", str(tmp_path / "o.class")]) == 0
    capsys.readouterr()
    assert ps.main([str(tmp_path / "tr"), "5"]) == 0
    out = capsys.readouterr().out
    assert "cpu_op" in out and "card busy 0.00%" in out


@pytest.mark.parametrize("missing", ["dir", "file"])
def test_profile_summary_without_trace_raises(tmp_path, missing):
    from classpro_tpu_torch.devtools import profile_summary as ps

    with pytest.raises(FileNotFoundError):
        ps.find_trace(str(tmp_path) if missing == "dir"
                      else str(tmp_path / "none.json"))
