"""The port's ``am()`` against the JAX package's.

- matfree: the 256 × 3000 store of tests/test_packed_stack.py, the JAX
  engine with its Pallas kernels in interpret mode, the port on the CPU:
  identical selections and extBIC paths within rtol 1e-3 (that file's
  tolerance; CG iteration counts differ between the two, solutions do not).
- oracle: the committed tutorial data, rtol 1e-6 (tests/test_golden.py).
- the host-f64 REML core and Krylov primitives to f64 roundoff."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import eagleeverything_tpu as ee  # noqa: E402
from eagleeverything_tpu.api.read import GenoHandle as JaxHandle  # noqa: E402
from eagleeverything_tpu.data.simulate import simulate_dataset  # noqa: E402
from eagleeverything_tpu.io.genostore import (  # noqa: E402
    GenotypeStore as JaxStore)
from eagleeverything_tpu.models import bigscan as jax_bigscan  # noqa: E402
from eagleeverything_tpu.models import reml_core as jax_reml  # noqa: E402
from eagleeverything_tpu.utils.config import (  # noqa: E402
    EagleConfig as JaxConfig)

import eagleeverything_tpu_torch as port  # noqa: E402
from eagleeverything_tpu_torch.models import bigscan, reml_core  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUT = os.path.join(ROOT, "examples", "tutorial")
NP_, PP_ = 256, 3000


@pytest.fixture(scope="module")
def pallas_store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ppstore"))
    sim = simulate_dataset(n=NP_, p=PP_, n_qtl=2, seed=13,
                           missing_rate=0.02)
    JaxStore.create_from_dense(d, sim.geno, n_shards=2, packed=True)
    return d, sim


@pytest.fixture(scope="module")
def port_matfree(pallas_store):
    d, sim = pallas_store
    return port.am("y", port.GenoHandle(n=NP_, p=PP_, source="t",
                                        store_dir=d),
                   {"y": sim.y}, maxit=3, engine="matfree", device="cpu")


def test_matfree_matches_jax_pallas_engine(pallas_store, port_matfree):
    d, sim = pallas_store
    cfg = JaxConfig(snp_tile=256, device_cache_gb=3e-3, pallas_packed=True)
    ref = ee.am("y", JaxHandle(n=NP_, p=PP_, source="t", store_dir=d),
                {"y": sim.y}, maxit=3, engine="matfree", config=cfg)
    assert port_matfree.indices == ref.indices
    assert len(port_matfree.indices) >= 1
    np.testing.assert_allclose(port_matfree.extbic_path, ref.extbic_path,
                               rtol=1e-3)
    np.testing.assert_allclose(port_matfree.loglik_path, ref.loglik_path,
                               rtol=1e-3)


def test_matfree_dense_handle_matches_store(pallas_store, port_matfree):
    """A dense handle is packed on the host into the bytes the store ships,
    so the scan is the same to the last bit."""
    _, sim = pallas_store
    res = port.am("y", sim.geno, {"y": sim.y}, maxit=3, engine="matfree",
                  device="cpu")
    assert res.indices == port_matfree.indices
    np.testing.assert_array_equal(res.extbic_path, port_matfree.extbic_path)


@pytest.fixture(scope="module")
def tutorial():
    geno = ee.read_marker(os.path.join(TUT, "geno.txt"))
    return (geno.geno, port.read_pheno(os.path.join(TUT, "pheno.txt")),
            port.read_map(os.path.join(TUT, "map.txt")))


def test_oracle_matches_jax_oracle(tutorial):
    geno, pheno, mp = tutorial
    got = port.am("y", geno, pheno, fformula="age + sex", map=mp, maxit=8,
                  engine="oracle", device="cpu")
    ref = ee.am("y", geno, ee.read_pheno(os.path.join(TUT, "pheno.txt")),
                fformula="age + sex",
                map=ee.read_map(os.path.join(TUT, "map.txt")), maxit=8,
                engine="oracle")
    assert got.indices == ref.indices and got.marker_names == ref.marker_names
    np.testing.assert_allclose(got.extbic_path, ref.extbic_path, rtol=1e-6)
    np.testing.assert_allclose(got.loglik_path, ref.loglik_path, rtol=1e-6)


def test_reml_core_matches_jax():
    rng = np.random.default_rng(5)
    n = 120
    d = np.sort(rng.gamma(1.0, 2.0, size=n))
    X = np.column_stack([np.ones(n), rng.standard_normal((n, 2))])
    y = X @ [1.0, 0.3, -0.2] + rng.standard_normal(n) * np.sqrt(1.0 + d)
    got = reml_core.reml_maximize_diag(d, y, X)
    ref = jax_reml.reml_maximize_diag(d, y, X)
    for a, b in zip((got.delta, got.loglik, got.sigma2_g, got.sigma2_e),
                    (ref.delta, ref.loglik, ref.sigma2_g, ref.sigma2_e)):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-12)
    for k in (0, 1, 5):
        assert reml_core.extbic(-321.5, n, 5000, k, 0.7) == pytest.approx(
            jax_reml.extbic(-321.5, n, 5000, k, 0.7), rel=1e-12)


def test_krylov_primitives_match_jax():
    """The host-f64 Krylov pieces of the decision path equal the
    reference's (the port contracts the isqrt basis in one einsum where the
    reference loops, so equality is to f64 roundoff)."""
    rng = np.random.default_rng(6)
    n, r = 300, 7
    M = rng.standard_normal((n, n))
    H = M @ M.T / n + 0.5 * np.eye(n)
    Z = rng.choice((-1.0, 1.0), size=(n, r))
    mv = lambda V: H @ V  # noqa: E731
    np.testing.assert_allclose(
        bigscan.lanczos_isqrt_apply(mv, Z, m=40),
        jax_bigscan.lanczos_isqrt_apply(mv, Z, m=40), rtol=1e-10, atol=1e-12)
    assert bigscan.slq_logdet(mv, n, Z, m=30) == pytest.approx(
        jax_bigscan.slq_logdet(mv, n, Z, m=30), rel=1e-12)
    sk = bigscan.ShiftedKrylov(lambda V: M @ (M.T @ V) / n, Z, m=60,
                               reorth=True)
    ref = jax_bigscan.ShiftedKrylov(lambda V: M @ (M.T @ V) / n, Z, m=60,
                                    reorth=True)
    for d in (0.3, 2.0):
        np.testing.assert_allclose(sk.solve(d), ref.solve(d), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(sk.isqrt(d), ref.isqrt(d), rtol=1e-12,
                                   atol=1e-12)
        assert sk.logdet(d) == pytest.approx(ref.logdet(d), rel=1e-12)


def test_engines_not_in_this_slice_raise(pallas_store):
    _, sim = pallas_store
    with pytest.raises(NotImplementedError, match="exact eigenbasis"):
        port.am("y", sim.geno, {"y": sim.y}, engine="auto", device="cpu")
    with pytest.raises(NotImplementedError, match="exact eigenbasis"):
        port.am("y", sim.geno, {"y": sim.y}, engine="jax", device="cpu")
    with pytest.raises(NotImplementedError, match="Zmat"):
        port.am("y", sim.geno, {"y": sim.y}, Zmat=np.eye(NP_),
                engine="matfree", device="cpu")


def test_cuda_asked_for_and_absent_raises(pallas_store, monkeypatch):
    _, sim = pallas_store
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.am("y", sim.geno, {"y": sim.y}, engine="matfree")
