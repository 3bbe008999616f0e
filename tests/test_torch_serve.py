"""The port's warm-engine service (classpro_tpu_torch.serve, ``cli serve``
and ``classify --server``): a daemon on ``--device cpu`` serves jobs by
``request`` and through the client, byte-equal to the direct port CLI
and to the tiny golden; its tables are uploaded once; a job that fails at
its start or mid-stream is replied and leaves the daemon serving the
same bytes; ``shutdown`` exits 0 and removes the socket.  The client's
refusals give the JAX CLI's message.  The daemon on the card is a ``gpu``
test.
"""
import gzip
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures"
TINY_SRC = str(FIX / "tiny" / "reads.fasta.gz")
TINY_FK = str(FIX / "tiny" / "reads")


def _gold() -> bytes:
    return gzip.decompress((FIX / "tiny" / "golden.class.gz").read_bytes())


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


class Daemon:
    """A ``cli serve`` subprocess on a socket in a short temporary
    directory (unix socket paths are limited to 108 bytes)."""

    def __init__(self, extra=(), device="cpu", timeout=300):
        from classpro_tpu_torch.serve import request

        self.dir = tempfile.mkdtemp(prefix="cps")
        self.sock = os.path.join(self.dir, "cp.sock")
        assert len(self.sock) < 100, self.sock
        self.err = open(os.path.join(self.dir, "stderr"), "w+")
        t0 = time.time()
        self.p = subprocess.Popen(
            [sys.executable, "-m", "classpro_tpu_torch.cli", "serve",
             "--socket", self.sock, "--device", device, *extra],
            env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=self.err, text=True)
        while time.time() - t0 < timeout:
            if self.p.poll() is not None:
                raise AssertionError(f"daemon died: {self.stderr()}")
            if os.path.exists(self.sock):
                try:
                    rep = request(self.sock, {"cmd": "ping"}, timeout=5)
                except OSError:
                    time.sleep(0.2)
                    continue
                assert rep["ok"] and rep["pid"] == self.p.pid
                assert self.p.stdout.readline().strip() == "READY"
                return
            time.sleep(0.2)
        self.close()
        raise AssertionError("daemon never became ready")

    def stderr(self) -> str:
        self.err.seek(0)
        return self.err.read()[-3000:]

    def req(self, r: dict) -> dict:
        from classpro_tpu_torch.serve import request

        return request(self.sock, r, timeout=30)

    def close(self):
        if self.p.poll() is None:
            self.p.kill()
            self.p.wait(timeout=30)
        self.err.close()
        shutil.rmtree(self.dir, ignore_errors=True)


@pytest.fixture(scope="module")
def daemon():
    d = Daemon()
    yield d
    d.close()


def test_serve_two_jobs_byte_equal_and_warm(daemon, tmp_path):
    """Job 1 by ``request``, job 2 by ``classify --server``: both byte-
    equal to the direct port CLI and to the tiny golden; the tables were
    uploaded once; the buckets run are reported."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.cli import main

    direct = tmp_path / "direct.class"
    assert main(["classify", TINY_SRC, "-N", TINY_FK, "-o", str(direct),
                 "--device", "cpu"]) == 0
    assert direct.read_bytes() == _gold()
    jobs0 = daemon.req({"cmd": "stats"})["jobs"]

    out1 = tmp_path / "o1.class"
    rep = daemon.req({"cmd": "classify", "source": TINY_SRC,
                      "fastk_root": TINY_FK, "output": str(out1)})
    assert rep["ok"], rep
    assert rep["reads"] == 221 and rep["kmers"] == 892969
    assert rep["guard_flagged"] == 0 and rep["warm_shapes"]
    assert rep["launches"] == dict.fromkeys(kernels.LAUNCHES, 0)  # CPU
    assert out1.read_bytes() == direct.read_bytes()

    out2 = tmp_path / "o2.class"
    r = subprocess.run(
        [sys.executable, "-m", "classpro_tpu_torch.cli", "classify",
         "--server", daemon.sock, TINY_SRC, "-N", TINY_FK, "-o", str(out2),
         "-v"], env=_env(), cwd=str(ROOT), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "server: 221 reads" in r.stderr
    assert out2.read_bytes() == direct.read_bytes()

    st = daemon.req({"cmd": "stats"})
    assert st["ok"] and st["jobs"] - jobs0 == 2
    assert st["table_uploads"] == 1
    assert st["warm_shapes"] and all(len(s) == 2 for s in st["warm_shapes"])
    assert st["device"] == "cpu"


def _mismatched_fasta(path: pathlib.Path, bad: int) -> None:
    """The tiny reads with read ``bad`` four bases longer than its
    profile allows (the reference's rlen check refuses it)."""
    from classpro_tpu_torch.io.fastx import read_fastx, write_fasta

    recs = [(r.name, r.comment, r.seq + ("ACGT" if i == bad else ""))
            for i, r in enumerate(read_fastx(TINY_SRC))]
    write_fasta(str(path), recs)


def test_serve_isolates_failing_jobs(daemon, tmp_path):
    """A job whose source is missing (fails at its start) and a job whose
    read 170 mismatches its profile (fails mid-stream: with 10 reads a
    chunk, the stream had classified its first two windows of eight
    chunks and written the first) are replied ok: false; no thread is
    left behind; the next job writes the golden."""
    threads0 = daemon.req({"cmd": "stats"})["threads"]
    errors0 = daemon.req({"cmd": "stats"})["errors"]

    rep = daemon.req({"cmd": "classify", "source": "/nonexistent/r.fasta"})
    assert not rep["ok"] and "error" in rep
    assert daemon.req({"cmd": "ping"})["ok"]

    bad = tmp_path / "bad.fasta"
    _mismatched_fasta(bad, 170)
    out = tmp_path / "bad.class"
    rep = daemon.req({"cmd": "classify", "source": str(bad),
                      "fastk_root": TINY_FK, "output": str(out),
                      "batch_size": 10})
    assert not rep["ok"]
    assert "Read 170: rlen" in rep["error"] and "mismatch" in rep["error"]
    # the stream had written the reads before the failing window
    assert out.read_bytes().count(b"\n+\n") >= 80
    assert daemon.req({"cmd": "ping"})["ok"]

    st = daemon.req({"cmd": "stats"})
    assert st["errors"] - errors0 == 2
    assert st["threads"] == threads0, "a failed job left a thread"

    good = tmp_path / "good.class"
    rep = daemon.req({"cmd": "classify", "source": TINY_SRC,
                      "fastk_root": TINY_FK, "output": str(good),
                      "batch_size": 10})
    assert rep["ok"], rep
    assert good.read_bytes() == _gold()
    assert daemon.req({"cmd": "stats"})["table_uploads"] == 1


def test_serve_unknown_command_is_replied(daemon):
    rep = daemon.req({"cmd": "frobnicate"})
    assert not rep["ok"] and "unknown cmd" in rep["error"]
    assert daemon.req({"cmd": "ping"})["ok"]


def test_serve_shutdown_exits_zero_and_removes_socket(daemon):
    """(The last test of this file that uses the module's daemon: it ends
    it.)"""
    assert daemon.req({"cmd": "shutdown"})["ok"]
    assert daemon.p.wait(timeout=60) == 0
    assert not os.path.exists(daemon.sock)


def test_prefetch_stops_its_producer_when_the_consumer_fails():
    """The stream's input thread ends when the consumer raises mid-stream
    (it is not left blocked on its full queue)."""
    from classpro_tpu_torch.engine import _prefetched

    def chunks():
        for i in range(1000):
            yield i

    def consume():
        with _prefetched(chunks(), 2) as src:
            for i in src:
                if i == 3:
                    raise ValueError("boom")

    before = threading.active_count()
    with pytest.raises(ValueError, match="boom"):
        consume()
    assert threading.active_count() == before
    assert not [t for t in threading.enumerate()
                if t.name == "classpro-prefetch"]


@pytest.mark.parametrize("extra,source", [
    (["-s"], TINY_SRC),
    (["--engine", "exact"], TINY_SRC),
    ([], str(FIX / "tiny" / "dam" / "reads.dam")),
], ids=["seeds", "exact", "dam"])
def test_server_client_refusals_match_jax(extra, source, tmp_path, capsys):
    """The client refuses what the daemon does not serve, with the JAX
    CLI's message and exit code, before any connect."""
    from classpro_tpu.cli import main as jax_main
    from classpro_tpu_torch.cli import main

    sock = str(tmp_path / "no.sock")
    rc = main(["classify", "--server", sock, source, *extra])
    err = capsys.readouterr().err
    jrc = jax_main(["classify", "--server", sock, source, *extra])
    jerr = capsys.readouterr().err
    msg = ("--server supports plain FASTX classify jobs (no -s/--engine "
           "exact/.db/.dam)")
    assert rc == jrc == 1
    assert msg in err and msg in jerr


def test_server_client_without_daemon_exits_1(tmp_path, capsys):
    from classpro_tpu_torch.cli import main

    rc = main(["classify", "--server", str(tmp_path / "no.sock"), TINY_SRC])
    assert rc == 1 and "classpro-tpu-torch:" in capsys.readouterr().err


@pytest.mark.gpu
def test_serve_on_card_warms_one_launch_per_shape(tmp_path):
    """On the card: the daemon loads the kernels, uploads the tables once
    and readies each warm-up shape: one CUDA graph captured after the DP
    kernel's two launches run eagerly; a job's bytes are the golden and
    its launches and graph replays are counted in its reply."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d = Daemon(["--warmup-root", TINY_FK, "--warmup-shape", "256x128",
                "--warmup-shape", "256x192"], device="cuda")
    try:
        st = d.req({"cmd": "stats"})
        assert st["launches"]["rel_dp"] == 4
        assert st["graphs"]["captures"] == 2
        assert st["table_uploads"] == 1
        assert [256, 128] in st["warm_shapes"]
        out = tmp_path / "o.class"
        rep = d.req({"cmd": "classify", "source": TINY_SRC,
                     "fastk_root": TINY_FK, "output": str(out)})
        assert rep["ok"], rep
        assert rep["launches"]["rel_dp"] > 0
        assert rep["graphs"]["replays"] > 0
        assert out.read_bytes() == _gold()
        assert d.req({"cmd": "stats"})["table_uploads"] == 1
        assert d.req({"cmd": "shutdown"})["ok"]
        assert d.p.wait(timeout=60) == 0
    finally:
        d.close()
