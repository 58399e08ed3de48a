"""scripts/biobank_axes_torch.py (BASELINE config 4's two axes on the port)
against the JAX package's scripts/biobank_axes.py, on the CPU at a small
size.

The JAX script's generators run here with its axis sizes shrunk
(``N_AXIS``/``P_AXIS`` patched for the call), into a temporary directory;
its ``run_n``/``run_p`` are never called (they write into docs/): the
runs are held against the JAX package's own functions, called as those
runs call them. Tolerances are the reference tests': extBIC rtol 1e-3
(tests/test_packed_stack.py's matrix-free tolerance), t rtol 2e-3
(tests/test_fuzz_parity.py)."""

import filecmp
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from eagleeverything_tpu.api.read import read_marker as jax_read_marker  # noqa: E402
from eagleeverything_tpu.models import bigscan as jbig  # noqa: E402
from eagleeverything_tpu.models import engine_jax  # noqa: E402
from eagleeverything_tpu.utils.config import (  # noqa: E402
    EagleConfig as JaxConfig)

from eagleeverything_tpu_torch.models import bigscan  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, P_N = 4096, 1024        # the n axis, shrunk
N_P, P = 256, 20000        # the p axis, shrunk


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


axes = _load("biobank_axes_torch", ROOT / "scripts" / "biobank_axes_torch.py")
jaxes = _load("biobank_axes_jax", ROOT / "scripts" / "biobank_axes.py")


def _jax_gen(fn, axis: dict, sizes: dict, d: str) -> None:
    with pytest.MonkeyPatch.context() as mp:
        for k, v in sizes.items():
            mp.setitem(axis, k, v)
        fn(d)


def _same_files(a: pathlib.Path, b: pathlib.Path, names) -> None:
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


def _one_store(jax: pathlib.Path, d: pathlib.Path) -> str:
    """The JAX script's n-axis store, split one shard a process directory,
    gathered beside its manifest for one process."""
    d.mkdir()
    for k in (0, 1):
        os.symlink(jax / f"proc{k}" / f"shard_{k:05d}.bin",
                   d / f"shard_{k:05d}.bin")
    os.symlink(jax / "proc0" / "manifest.json", d / "manifest.json")
    return str(d)


def _manifest(d: pathlib.Path) -> dict:
    m = json.loads((d / "manifest.json").read_text())
    m.pop("source")
    return m


@pytest.fixture(scope="module")
def n_cohorts(tmp_path_factory):
    """(port's cohort, JAX script's cohort) of the n axis at N x P_N."""
    port = tmp_path_factory.mktemp("n_port")
    jax = tmp_path_factory.mktemp("n_jax")
    axes.gen_n(str(port), N, P_N, device="cpu")
    _jax_gen(jaxes.gen_n, jaxes.N_AXIS, {"n": N, "p": P_N}, str(jax))
    return port, jax


@pytest.fixture(scope="module")
def p_cohorts(tmp_path_factory):
    """(port's text cohort, the JAX script's, the port's --store-only
    cohort) of the p axis at N_P x P."""
    port = tmp_path_factory.mktemp("p_port")
    jax = tmp_path_factory.mktemp("p_jax")
    only = tmp_path_factory.mktemp("p_store_only")
    axes.gen_p(str(port), N_P, P, device="cpu")
    axes.gen_p(str(only), N_P, P, store_only=True, device="cpu")
    _jax_gen(jaxes.gen_p, jaxes.P_AXIS, {"n": N_P, "p": P}, str(jax))
    return port, jax, only


@pytest.mark.parametrize("warm", [0, 1, 2, 3])
# 2**25 + 1 values take 2**23 + 1 words: raw_words draws them in two parts
@pytest.mark.parametrize("count", [0, 1, 2, 3, 1000, 1001, 2**25 + 1])
def test_uint16_draws_are_numpys(warm, count):
    """The raw-word form of a full-range uint16 draw gives numpy's values
    and leaves the generator where numpy leaves it, from either half of a
    kept 32-bit draw, so the draws after it stay numpy's too."""
    a = np.random.default_rng(11)
    b = np.random.default_rng(11)
    a.integers(0, 65536, size=warm, dtype=np.uint16)
    b.integers(0, 65536, size=warm, dtype=np.uint16)
    want = a.integers(0, 65536, size=count, dtype=np.uint16)
    got = axes.uint16_draws(b, count)
    assert got.dtype == np.uint16 and np.array_equal(want, got)
    assert a.bit_generator.state == b.bit_generator.state
    assert np.array_equal(a.uniform(size=5), b.uniform(size=5))


@pytest.mark.parametrize("warm", [0, 1])
@pytest.mark.parametrize("p", [1, 5, 1001])
@pytest.mark.parametrize("batch_bytes", [64, 1 << 28])
def test_ternary_rows_are_numpys(warm, p, batch_bytes):
    """Rows read off the 32-bit draws' bytes are numpy's bounded uint8
    rows, and the generator is left where numpy leaves it, from either
    half of a kept draw, in one batch or one batch a row."""
    a = np.random.default_rng(12)
    b = np.random.default_rng(12)
    a.integers(0, 65536, size=warm, dtype=np.uint16)
    b.integers(0, 65536, size=warm, dtype=np.uint16)
    want = [a.integers(0, 3, size=p, dtype=np.uint8) for _ in range(5)]
    got = list(axes.ternary_rows(b, 5, p, batch_bytes=batch_bytes))
    assert len(got) == 5
    for w, g in zip(want, got):
        assert g.dtype == np.uint8 and np.array_equal(w, g)
    assert a.bit_generator.state == b.bit_generator.state
    assert np.array_equal(a.uniform(size=5), b.uniform(size=5))


def test_gen_n_writes_the_jax_cohort(n_cohorts):
    """Shards, manifest, trait and meta file byte for byte; the port keeps
    both shards in store_full, the JAX script one a process directory."""
    port, jax = n_cohorts
    for k in (0, 1):
        _same_files(port / "store_full", jax / f"proc{k}",
                    [f"shard_{k:05d}.bin", "manifest.json"])
    meta_p = json.loads((port / "meta_n.json").read_text())
    meta_j = json.loads((jax / "meta_n.json").read_text())
    meta_p.pop("gen_seconds"), meta_j.pop("gen_seconds")
    assert meta_p == meta_j and (meta_p["n"], meta_p["p"]) == (N, P_N)
    _same_files(port, jax, ["y_n.npy"])


def test_gen_n_split_is_the_jax_layout(n_cohorts, tmp_path):
    """--split: one directory a shard, as the JAX script leaves them."""
    _, jax = n_cohorts
    axes.gen_n(str(tmp_path), N, P_N, split=True, device="cpu")
    for k in (0, 1):
        assert sorted(os.listdir(tmp_path / f"proc{k}")) \
            == sorted(os.listdir(jax / f"proc{k}"))
        _same_files(tmp_path / f"proc{k}", jax / f"proc{k}",
                    [f"shard_{k:05d}.bin", "manifest.json"])
    with pytest.raises(FileNotFoundError, match="--split"):
        axes.run_n(str(tmp_path), 1, device="cpu")


def test_run_n_selects_what_the_jax_engine_selects(n_cohorts, tmp_path,
                                                    monkeypatch):
    """The port's run on the port's cohort against the JAX package's
    forward_select_matfree over its TiledScan on the JAX script's cohort,
    both with the recorded protocol and a Krylov cache budget that binds
    as am()'s default budget does at n = 500 000: the [X y] solve bases
    fit it and are cached, the sweep's probe basis does not and is
    rebuilt at each call. The probe block is 32 columns wide, not the
    recorded 16, so that its basis binds at the size the port counts it
    (f32 on the device: 6.3 MB here, the solve bases' f64 at most
    3.9 MB, the budget 4.2 MB)."""
    port, jax = n_cohorts
    protocol = dict(axes.N_PROTOCOL, diag_probes=32, cache_max_bytes=1 << 22)
    built, uncached = [], []

    class CountingKrylov(bigscan.ShiftedKrylov):
        def __init__(self, *a, **k):
            built.append(k.get("reorth", False))
            super().__init__(*a, **k)

    shifts = bigscan.MatfreeContext.isqrt_probes_shifts

    def counting_shifts(self, *a, **k):
        uncached.append(1)
        return shifts(self, *a, **k)

    monkeypatch.setattr(bigscan, "ShiftedKrylov", CountingKrylov)
    monkeypatch.setattr(bigscan.MatfreeContext, "isqrt_probes_shifts",
                        counting_shifts)
    got = axes.run_n(str(port), 3, device="cpu", protocol=protocol,
                     out=str(tmp_path / "n.json"))
    assert json.loads((tmp_path / "n.json").read_text())["selected"] \
        == got["selected"]
    cache = got["krylov_cache"]
    assert cache["probe_basis_binds"] and not cache["solve_basis_binds"]
    assert any(built)         # the reorthogonalised [X y] bases, cached
    assert uncached           # the probe basis, over the budget

    meta = json.loads((jax / "meta_n.json").read_text())
    y = np.load(jax / "y_n.npy")
    full = _one_store(jax, tmp_path / "jax_full")
    backend = engine_jax.TiledScan(engine_jax.StoreTileSource(full),
                                   JaxConfig(device_cache_gb=8.0))
    ref = jbig.forward_select_matfree(
        y, np.ones((N, 1)), backend, maxit=3,
        column_f64=backend.column_f64, **protocol)
    assert len(ref.indices) >= 2
    assert got["selected"] == list(ref.indices)
    assert set(got["selected"]) <= set(meta["qtl_indices"])
    assert got["selected_all_planted"]
    np.testing.assert_allclose(got["extbic_path"], ref.extbic_path,
                               rtol=1e-3)


def test_gen_p_text_and_ingest_are_the_jax_packages(p_cohorts, tmp_path):
    """The text, trait and meta file byte for byte; the port's read_marker
    (native ingest, 4 packed shards) writes the JAX read_marker's store
    from it."""
    port, jax, _ = p_cohorts
    _same_files(port, jax, ["geno_p.txt", "y_p.npy"])
    meta_p = json.loads((port / "meta_p.json").read_text())
    meta_j = json.loads((jax / "meta_p.json").read_text())
    meta_p.pop("write_seconds"), meta_j.pop("write_seconds")
    assert meta_p == meta_j
    from eagleeverything_tpu_torch import read_marker
    kw = dict(type="text", AA="0", AB="1", BB="2", missing="9", n_shards=4,
              packed=True)
    text = str(port / "geno_p.txt")
    h = read_marker(text, store_dir=str(tmp_path / "port"), **kw)
    jax_read_marker(text, store_dir=str(tmp_path / "jax"), **kw)
    assert (h.n, h.p) == (N_P, P)
    _same_files(tmp_path / "port", tmp_path / "jax",
                ["manifest.json"] + [f"shard_{k:05d}.bin" for k in range(4)])


def test_store_only_is_the_ingested_store(p_cohorts, tmp_path):
    """--store-only packs the rows into the store the text's ingest
    writes (the manifests differ in their source path only)."""
    port, _, only = p_cohorts
    from eagleeverything_tpu_torch import read_marker
    read_marker(str(port / "geno_p.txt"), type="text", AA="0", AB="1",
                BB="2", missing="9", store_dir=str(tmp_path / "ingest"),
                n_shards=4, packed=True)
    _same_files(only / "store_p", tmp_path / "ingest",
                [f"shard_{k:05d}.bin" for k in range(4)])
    assert _manifest(only / "store_p") == _manifest(tmp_path / "ingest")
    _same_files(only, port, ["y_p.npy"])


def test_run_p_takes_the_jax_argmax(p_cohorts, tmp_path):
    """run_p on the port's text (its ingest, then the sweep) against the
    JAX package's REML fit and stat sweep over its TiledScan on the JAX
    store: the same argmax, t within rtol 2e-3."""
    port, jax, _ = p_cohorts
    res, t = axes.run_p(str(port), device="cpu",
                        out=str(tmp_path / "p.json"))
    assert res["ingest_seconds"] > 0 and res["column_roundtrip_ok"]
    h = jax_read_marker(str(jax / "geno_p.txt"), type="text", AA="0",
                        AB="1", BB="2", missing="9",
                        store_dir=str(tmp_path / "jax_store"), n_shards=4,
                        packed=True)
    y = np.load(jax / "y_p.npy")
    backend = engine_jax.TiledScan(engine_jax._make_source(h, None),
                                   JaxConfig(device_cache_gb=8.0))
    ctx = jbig.make_context(backend, N_P, **axes.P_CONTEXT)
    X0 = np.ones((N_P, 1))
    fit = jbig.reml_maximize_matfree(ctx, y, X0)
    t_ref, cand, _ = jbig.score_sweep_matfree(
        ctx, backend, y, X0, fit, column_f64=backend.column_f64,
        **axes.P_SWEEP)
    assert res["argmax"] == cand and res["argmax_is_planted"]
    # atol: t near 0 (â² of f32 dot products) rounds in absolute terms
    np.testing.assert_allclose(t, t_ref, rtol=2e-3, atol=1e-6)
    assert res["t_at_planted"] == [float(t[j]) for j in res["qtl_planted"]]


def test_run_n_am_entry_is_the_jax_am(n_cohorts, tmp_path):
    """--entry am: the user's ``am(engine="auto")`` with EagleConfig's
    matrix-free fields at the protocol's values, against the JAX
    package's ``am`` with the same config. At this n auto takes the exact
    engine in both: the same selections, extBIC rtol 1e-6
    (tests/test_golden.py's tolerance)."""
    import eagleeverything_tpu as ee
    from eagleeverything_tpu.api.read import GenoHandle
    port, jax = n_cohorts
    got = axes.run_n(str(port), 3, device="cpu", entry="am",
                     out=str(tmp_path / "am.json"))
    cfg = axes.protocol_config()
    fields = {k: getattr(cfg, k) for k in ("device_cache_gb",)
              + tuple(k for k in vars(cfg) if k.startswith("matfree_"))}
    handle = GenoHandle(n=N, p=P_N, source="biobank-n-axis",
                        store_dir=_one_store(jax, tmp_path / "jax_full"))
    ref = ee.am("y", handle, {"y": np.load(jax / "y_n.npy")}, maxit=3,
                engine="auto", config=JaxConfig(**fields))
    assert got["entry"] == "am" and len(ref.indices) >= 2
    assert got["selected"] == list(ref.indices)
    np.testing.assert_allclose(got["extbic_path"], ref.extbic_path,
                               rtol=1e-6)
