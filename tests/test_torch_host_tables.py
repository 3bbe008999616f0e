"""A model's binomial-tail table, built by the port's C++ host plane.

``tables.build_tables`` fills its (rates, n_cap, n_cap) tail table with
one ``native.build_btg`` call (``cp_build_btg`` in
classpro_tpu_torch/csrc/host/classpro_host.cpp).  Held here, bit for bit
(``.view(np.int64)``), against:

* ``tables.btg_plain`` (``_btg_row`` per row), its plain numpy version,
  over every (rate, n, k)
  of the fixture models (tiny, medium, tiny with its -M model,
  branch/psum0multi at n_cap 510) and of seeded random error rates;
* the JAX package's ``classpro_tpu.tpu.tables.build_tables`` on the same
  fixtures (its numpy version, the reference the port is held to);
* the scalar ``numerics.binom_test_g`` at k = 0, k = n and the two k on
  either side of n * erate (the branch of the C loop).
"""
import gzip
import json
import pathlib

import numpy as np
import pytest

FIX = pathlib.Path(__file__).parent / "fixtures"
MODELS = ("tiny", "medium", "tiny_M", "branch/psum0multi")


def _args(name, tmp_path) -> tuple[str, dict]:
    """FASTK root and build_global_model's keyword arguments of a fixture
    model (``tiny_M``: tiny with its HIsim -M model, unpacked into
    ``tmp_path``)."""
    fx = "tiny" if name == "tiny_M" else name
    d = FIX / fx
    args = {}
    if (d / "args.json").exists():
        args = json.loads((d / "args.json").read_text())
    if name == "tiny_M":
        model = tmp_path / "hisim.model"
        model.write_bytes(gzip.decompress(
            (FIX / "tiny" / "hisim.model.gz").read_bytes()))
        args["model_path"] = str(model)
    return str(d / "reads"), args


def _port_model(name, tmp_path):
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram

    root, args = _args(name, tmp_path)
    return build_global_model(load_histogram(root), **args)


def _bits_equal(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.float64
    diff = np.argwhere(got.view(np.int64) != want.view(np.int64))
    assert diff.size == 0, (f"{len(diff)} entries differ, first "
                            f"[r, n, k] = {diff[0].tolist()}: "
                            f"{got[tuple(diff[0])]!r} != "
                            f"{want[tuple(diff[0])]!r}")


@pytest.mark.parametrize("name", MODELS)
def test_cpp_table_is_btg_row_bit_for_bit(name, tmp_path):
    """build_tables' table (one C++ call) == _btg_row's, every (rate, n,
    k), on each fixture model; psum0multi's cmax 254 gives n_cap 510."""
    from classpro_tpu_torch import native, tables
    from classpro_tpu_torch.numerics import LOGFACT
    from classpro_tpu_torch.tables import btg_plain

    gm = _port_model(name, tmp_path)
    dt = tables.build_tables(gm)
    assert dt.n_cap == max(2 * gm.cmax + 2, 300)
    if name == "branch/psum0multi":
        assert dt.n_cap == 510
    want = btg_plain(dt.erates, dt.n_cap)
    _bits_equal(dt.btg, want)
    _bits_equal(native.build_btg(dt.erates, dt.n_cap, LOGFACT), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cpp_table_is_btg_row_on_random_rates(seed):
    """Seeded error rates in [1e-4, 0.45] (log-uniform, both ends
    included) at n_cap 300."""
    from classpro_tpu_torch import native
    from classpro_tpu_torch.numerics import LOGFACT
    from classpro_tpu_torch.tables import btg_plain

    rng = np.random.default_rng(seed)
    erates = np.concatenate([[1e-4, 0.45], np.exp(rng.uniform(
        np.log(1e-4), np.log(0.45), 3))])
    _bits_equal(native.build_btg(erates, 300, LOGFACT),
                btg_plain(erates, 300))


@pytest.mark.parametrize("name", MODELS)
def test_port_table_is_the_jax_packages(name, tmp_path):
    """The port's build_tables == the JAX package's (its numpy version)
    on the same fixture model: the tail table bit for bit, and the rate
    order and indices it is read through."""
    from classpro_tpu.estimation import build_global_model as jax_gm
    from classpro_tpu.io.fastk import load_histogram as jax_hist
    from classpro_tpu.tpu.tables import build_tables as jax_tables
    from classpro_tpu_torch.tables import build_tables

    root, args = _args(name, tmp_path)
    want = jax_tables(jax_gm(jax_hist(root), **args))
    got = build_tables(_port_model(name, tmp_path))
    assert (got.n_cap, got.hc_idx, got.unrel_idx) == (
        want.n_cap, want.hc_idx, want.unrel_idx)
    np.testing.assert_array_equal(got.pe_idx, want.pe_idx)
    _bits_equal(got.erates, want.erates)
    _bits_equal(got.btg, want.btg)


def _spot_ks(n: int, erate: float) -> list[int]:
    """k = 0, k = n, and the two k on either side of n * erate: the
    smallest k with float(k) >= n * erate (the upward sum) and the one
    below it (1 - the downward sum)."""
    mean = n * erate
    hi = next(k for k in range(n + 1) if float(k) >= mean)
    return sorted({0, n, max(hi - 1, 0), hi})


@pytest.mark.parametrize("name", ["tiny", "random"])
def test_cpp_table_spot_checks_against_the_scalar_test(name, tmp_path):
    """Entries of the C++ table == numerics.binom_test_g(k, n, erate,
    False), bit for bit, at k = 0, n and either side of n * erate, for
    every rate and a spread of n."""
    from classpro_tpu_torch import native, tables
    from classpro_tpu_torch.numerics import LOGFACT, binom_test_g

    if name == "tiny":
        dt = tables.build_tables(_port_model("tiny", tmp_path))
        erates, n_cap, btg = dt.erates, dt.n_cap, dt.btg
    else:
        erates = np.exp(np.random.default_rng(7).uniform(
            np.log(1e-4), np.log(0.45), 6))
        n_cap = 300
        btg = native.build_btg(erates, n_cap, LOGFACT)
    checked = 0
    for r, erate in enumerate(erates):
        for n in (1, 2, 3, 7, 10, 33, 64, 100, 150, 211, n_cap - 1):
            for k in _spot_ks(n, float(erate)):
                want = binom_test_g(k, n, float(erate), False)
                assert np.float64(btg[r, n, k]).view(np.int64) == \
                    np.float64(want).view(np.int64), (r, erate, n, k)
                checked += 1
            assert not btg[r, n, n + 1:].any()
        assert not btg[r, 0].any()
    assert checked > 30 * len(erates)


def test_build_tables_reaches_no_btg_row(tmp_path, monkeypatch):
    """The main path's build_tables never calls the plain version."""
    from classpro_tpu_torch import tables

    def refuse(*a, **kw):
        raise AssertionError("build_tables called _btg_row")

    monkeypatch.setattr(tables, "_btg_row", refuse)
    monkeypatch.setattr(tables, "_CONTENT_CACHE", {})
    dt = tables.build_tables(_port_model("medium", tmp_path))
    assert dt.btg.shape == (len(dt.erates), dt.n_cap, dt.n_cap)
    assert dt.btg[:, 1:, 0].all()
