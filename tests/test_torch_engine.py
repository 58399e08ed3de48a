"""The port's matrix-free backend (engine_torch.TiledScan) and genotype
store against the JAX package's.

The store is the ``pallas_store`` fixture of tests/test_packed_stack.py
(256 × 3000, 2% missing, 2-bit packed); the JAX scan runs its Pallas
kernels in interpret mode (``pallas_packed=True``), the port its plain
versions on the CPU. Tolerances are those of tests/test_packed_stack.py."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from eagleeverything_tpu.data.simulate import simulate_dataset  # noqa: E402
from eagleeverything_tpu.io.genostore import (  # noqa: E402
    GenotypeStore as JaxStore)
from eagleeverything_tpu.models import engine_jax  # noqa: E402
from eagleeverything_tpu.utils.config import (  # noqa: E402
    EagleConfig as JaxConfig)
from eagleeverything_tpu_torch.io.genostore import (  # noqa: E402
    GenotypeStore)
from eagleeverything_tpu_torch.models import engine_torch  # noqa: E402
from eagleeverything_tpu_torch.utils.config import EagleConfig  # noqa: E402

NP_, PP_ = 256, 3000


@pytest.fixture(scope="module")
def pallas_store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ppstore"))
    sim = simulate_dataset(n=NP_, p=PP_, n_qtl=2, seed=13,
                           missing_rate=0.02)
    JaxStore.create_from_dense(d, sim.geno, n_shards=2, packed=True)
    return d, sim


@pytest.fixture(scope="module")
def scans(pallas_store):
    """(port scan, JAX Pallas-forced packed scan, JAX streamed scan)."""
    d, _ = pallas_store
    port = engine_torch.TiledScan(engine_torch.StoreTileSource(d),
                                  EagleConfig(snp_tile=256), "cpu")
    jp = engine_jax.TiledScan(
        engine_jax.StoreTileSource(d),
        JaxConfig(snp_tile=256, device_cache_gb=3e-3, pallas_packed=True))
    assert jp.cache_packed_device and jp._use_pallas
    js = engine_jax.TiledScan(engine_jax.StoreTileSource(d),
                              JaxConfig(snp_tile=256))
    return port, jp, js


def test_stack_matches_jax_stack(scans):
    port, jp, _ = scans
    Wp = np.asarray(jp._packed_stack())
    means = np.asarray(jp._pmeans)
    Wt, mt = engine_torch.stack_from_jax(Wp, means, NP_, PP_, "cpu")
    np.testing.assert_array_equal(port._packed_stack().numpy(), Wt.numpy())
    np.testing.assert_array_equal(port._pmeans.numpy(), mt.numpy())


def test_kernel_matvec_matches(scans):
    port, jp, _ = scans
    V = np.random.default_rng(0).standard_normal((NP_, 5))
    np.testing.assert_allclose(port.kernel_matvec(V), jp.kernel_matvec(V),
                               rtol=1e-4, atol=1e-2)


def test_sweep_dots_and_stats_match(scans):
    port, jp, _ = scans
    rng = np.random.default_rng(1)
    A = rng.standard_normal((NP_, 9))
    np.testing.assert_allclose(port.sweep_dots(A), jp.sweep_dots(A),
                               rtol=1e-4, atol=1e-3)
    q, r = 3, 12
    A2 = np.column_stack([rng.standard_normal((NP_, 1 + q)),
                          rng.choice((-1.0, 1.0), size=(NP_, r))])
    M = rng.standard_normal((q, q))
    Minv = M @ M.T + np.eye(q)
    for got, ref in zip(port.matfree_stat_rows(A2, q, Minv),
                        jp.matfree_stat_rows(A2, q, Minv)):
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-2)


def test_device_cg_matches(scans):
    port, jp, js = scans
    rng = np.random.default_rng(2)
    B = rng.standard_normal((NP_, 3))
    s0 = float(np.trace(js.compute_K()) / NP_)
    Xt = port.device_cg(B, delta=0.7, s0=s0, tol=1e-6, maxiter=400)
    Xj = jp.device_cg(B, delta=0.7, s0=s0, tol=1e-6, maxiter=400)
    np.testing.assert_allclose(Xt, Xj, rtol=5e-3, atol=5e-3)
    # warm start: the same solution to tolerance
    Xw = port.device_cg(B, delta=0.7, s0=s0, tol=1e-6, maxiter=400,
                        x0=0.9 * Xt)
    np.testing.assert_allclose(Xw, Xt, rtol=5e-3, atol=5e-3)


def test_column_f64_matches(scans):
    port, jp, _ = scans
    for j in (0, 1234, PP_ - 1):
        np.testing.assert_array_equal(port.column_f64(j), jp.column_f64(j))


def test_stack_from_every_source_is_the_same(pallas_store, scans):
    """A dense handle and an unpacked store are packed on the host into the
    stack a 2-bit store ships raw; a row mask packs the kept rows."""
    d, sim = pallas_store
    port, _, _ = scans
    ref = port._packed_stack().numpy()
    cfg = EagleConfig(snp_tile=384)
    dense = engine_torch.TiledScan(
        engine_torch.DenseTileSource(sim.geno), cfg, "cpu")
    np.testing.assert_array_equal(dense._packed_stack().numpy(), ref)
    keep = np.setdiff1d(np.arange(NP_), [3, 77, 200])
    masked = engine_torch.TiledScan(
        engine_torch.StoreTileSource(d, keep=keep), cfg, "cpu")
    direct = engine_torch.TiledScan(
        engine_torch.DenseTileSource(sim.geno[keep]), cfg, "cpu")
    np.testing.assert_array_equal(masked._packed_stack().numpy(),
                                  direct._packed_stack().numpy())
    np.testing.assert_array_equal(masked._pmeans.numpy(),
                                  direct._pmeans.numpy())


def test_stack_above_budget_is_refused(pallas_store, monkeypatch):
    """The stack (3000 × 16 words = 192 000 bytes) is held against the
    card's free memory, not against a configured budget."""
    d, _ = pallas_store
    src = engine_torch.StoreTileSource(d)
    free = {"bytes": 191_999}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free["bytes"], 80 * 10**9))
    with pytest.raises(ValueError, match="more than the 0.000 GB free"):
        engine_torch.TiledScan(src, EagleConfig(), "cuda")
    free["bytes"] = 192_000
    sc = engine_torch.TiledScan(src, EagleConfig(device_cache_gb=1e-9),
                                "cuda")
    assert sc._pstack is None          # nothing is allocated on the card yet


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("packed_store", [True, False])
def test_store_bytes_identical_both_ways(pallas_store, tmp_path,
                                         packed_store):
    """The port writes the JAX package's bytes, and reads its stores to
    the same tiles and columns."""
    _, sim = pallas_store
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    JaxStore.create_from_dense(dj, sim.geno, n_shards=3,
                               packed=packed_store, source="s")
    GenotypeStore.create_from_dense(dt, sim.geno, n_shards=3,
                                    packed=packed_store, source="s")
    assert _files(dj) == _files(dt)
    js, ts = JaxStore.open(dj), GenotypeStore.open(dj)
    for (j0, a), (k0, b) in zip(js.iter_raw_tiles(700),
                                ts.iter_raw_tiles(700)):
        assert j0 == k0
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ts.to_dense(), sim.geno)
    np.testing.assert_array_equal(ts.column(2999), js.column(2999))


def test_store_from_torch_blocks(pallas_store, tmp_path):
    """SNP-major blocks given as torch tensors are packed to the same
    bytes as numpy blocks."""
    _, sim = pallas_store
    Gt = np.ascontiguousarray(sim.geno.T)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    JaxStore.create_from_snp_blocks(
        dj, ((j, Gt[j : j + 512]) for j in range(0, PP_, 512)),
        n=NP_, p=PP_, n_shards=2, packed=True)
    GenotypeStore.create_from_snp_blocks(
        dt, ((j, torch.from_numpy(Gt[j : j + 512]))
             for j in range(0, PP_, 512)),
        n=NP_, p=PP_, n_shards=2, packed=True)
    assert _files(dj) == _files(dt)


def test_simulate_cohort_writes_a_store_both_packages_read(tmp_path):
    """The cohort generator packs its torch blocks into a store the JAX
    package decodes to the same genotypes as this package."""
    from eagleeverything_tpu_torch.data.simulate import simulate_cohort
    c = simulate_cohort(str(tmp_path / "c"), n=101, p=5000, n_qtl=4,
                        seed=3, device="cpu")
    assert c.y.shape == (101,) and np.all(np.isfinite(c.y))
    assert len(set(c.qtl_idx.tolist())) == 4 and c.qtl_idx.max() < 4096
    G = GenotypeStore.open(c.store_dir).to_dense()
    np.testing.assert_array_equal(JaxStore.open(c.store_dir).to_dense(), G)
    assert set(np.unique(G).tolist()) <= {0, 1, 2}
