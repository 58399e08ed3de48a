"""The port's exact eigenbasis engine against the JAX package's, on the CPU.

- per module: the torch ops of ops/kernels against the JAX package's XLA
  kernels (recode and unpack bit for bit, products and scores to rtol
  1e-5), the host helpers to f64 roundoff, ``TiledScan.compute_K`` and
  ``sweep_eig`` against the JAX ``TiledScan``;
- the slice: ``am(engine="jax")`` on the tutorial golden at
  tests/test_golden.py's rtol 1e-6, tests/test_engine.py's configurations
  and tests/test_fuzz_parity.py's seeds against the JAX oracle, checkpoint
  resume and the MMt cache (tests/test_ops.py), and ``am_multi`` against
  the JAX ``am_multi`` (tests/test_multitrait.py)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import eagleeverything_tpu as ee  # noqa: E402
from eagleeverything_tpu.api.read import GenoHandle as JaxHandle  # noqa: E402
from eagleeverything_tpu.data.simulate import simulate_dataset  # noqa: E402
from eagleeverything_tpu.io.genostore import (  # noqa: E402
    GenotypeStore as JaxStore)
from eagleeverything_tpu.models import engine_jax, oracle  # noqa: E402
from eagleeverything_tpu.ops import kernels as jk  # noqa: E402
from eagleeverything_tpu.utils.config import (  # noqa: E402
    EagleConfig as JaxConfig)

import eagleeverything_tpu_torch as port  # noqa: E402
from eagleeverything_tpu_torch.io import genostore  # noqa: E402
from eagleeverything_tpu_torch.models import engine_torch  # noqa: E402
from eagleeverything_tpu_torch.ops import kernels, packed  # noqa: E402
from eagleeverything_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from eagleeverything_tpu_torch.utils.config import EagleConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUT = os.path.join(ROOT, "examples", "tutorial")


def _np(x) -> np.ndarray:
    """A JAX array or torch tensor (any float type) as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _close(got, ref, rtol: float) -> None:
    """Elementwise rtol, with an atol of rtol times the result's scale for
    the elements that cancel to near zero."""
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _geno(seed: int, b: int, n: int, miss: float) -> np.ndarray:
    """SNP-major int8 (b, n) genotypes; SNP 1 is all missing when miss > 0."""
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 3, size=(b, n)).astype(np.int8)
    if miss > 0:
        G[rng.random((b, n)) < miss] = -9
        G[1] = -9
    return G


# ---------------------------------------------------------------------------
# per module: ops/kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_recode_impute_tile_bitwise(compute_dtype):
    G = _geno(1, 37, 203, 0.05)
    got = kernels.recode_impute_tile(torch.from_numpy(G), compute_dtype)
    ref = jk.recode_impute_tile(jnp.asarray(G), compute_dtype=compute_dtype)
    np.testing.assert_array_equal(_np(got), _np(ref))
    assert not got[1].any()                      # all missing → W = 0


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["uint8", "int32"])
def test_unpack_recode_tile_bitwise(layout, compute_dtype):
    """Both typings of the packed bytes, n no multiple of 4 or 16."""
    n = 203
    G = _geno(2, 37, n, 0.05)
    raw = genostore.pack2(G)                     # uint8 (b, ⌈n/4⌉)
    if layout == "int32":
        wb = np.full((G.shape[0], packed.words_per_row(n) * 4), 0x55,
                     np.uint8)
        wb[:, : raw.shape[1]] = raw
        raw = wb.view(np.int32)
    got = kernels.unpack_recode_tile(torch.from_numpy(raw), n, compute_dtype)
    ref = jk.unpack_recode_tile(jnp.asarray(raw), n=n,
                                compute_dtype=compute_dtype)
    np.testing.assert_array_equal(_np(got), _np(ref))
    np.testing.assert_array_equal(
        _np(got), _np(kernels.recode_impute_tile(torch.from_numpy(G),
                                                 compute_dtype)))


def test_mmt_accumulate_and_eig_T_tile():
    rng = np.random.default_rng(3)
    n = 203
    W = _np(jk.recode_impute_tile(jnp.asarray(_geno(3, 300, n, 0.02))))
    A = rng.standard_normal((n, n)).astype(np.float32)
    K0 = (A + A.T).astype(np.float32)
    got = kernels.mmt_accumulate(torch.from_numpy(K0.copy()),
                                 torch.from_numpy(W))
    _close(got, jk.mmt_accumulate(jnp.asarray(K0), jnp.asarray(W)), 1e-5)
    U = np.linalg.qr(rng.standard_normal((n, n)))[0].astype(np.float32)
    _close(kernels.eig_T_tile(torch.from_numpy(W), torch.from_numpy(U)),
           jk.eig_T_tile(jnp.asarray(W), jnp.asarray(U)), 1e-5)


def test_t_from_ahat_vara_guard():
    ahat = np.array([1.5, -2.0, 3.0, 0.5, 4.0, 1e-3], np.float32)
    vara = np.array([2.0, 1e-13, 0.0, -1.0, 1e-11, 3.0], np.float32)
    got = _np(kernels.t_from_ahat_vara(torch.from_numpy(ahat),
                                       torch.from_numpy(vara)))
    _close(got, jk.t_from_ahat_vara(jnp.asarray(ahat), jnp.asarray(vara)),
           1e-5)
    np.testing.assert_array_equal(got[1:4], 0.0)


def test_score_from_T_parts_guard():
    """Rows whose var(â) keeps less than 1e-6 of ts2 (fully inside the
    model, or zero) score 0; the others score â²/(σ²_g·var_raw)."""
    rng = np.random.default_rng(4)
    b, q = 8, 5
    TQ = rng.standard_normal((b, q)).astype(np.float32)
    q2 = np.sum(TQ * TQ, axis=1)
    ts2 = (q2 * np.array([2, 1, 1 + 1e-8, 1.5, 1, 3, 1.01, 1])).astype(
        np.float32)
    TQ[4] = 0.0
    ts2[4] = 0.0                                  # a zero-variance SNP
    ahat = rng.standard_normal(b).astype(np.float32)
    s2g = np.float32(0.7)
    got = _np(kernels.score_from_T_parts(
        torch.from_numpy(ahat), torch.from_numpy(ts2), torch.from_numpy(TQ),
        torch.tensor(s2g)))
    ref = jk.score_from_T_parts(jnp.asarray(ahat), jnp.asarray(ts2),
                                jnp.asarray(TQ), s2g)
    _close(got, ref, 1e-5)
    np.testing.assert_array_equal(got[[1, 2, 4, 7]], 0.0)
    assert np.all(got[[0, 3, 5, 6]] > 0)


def _score_inputs(seed: int, b: int, n: int, q: int, R=None):
    """T (b, n) with a zero row and a row inside span(Q) (guarded), s, Q
    orthonormal with zero pad columns, z3, σ²_g — R states if R given."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((b, n)).astype(np.float32)
    T[0] = 0.0

    def state():
        s = rng.uniform(0.3, 2.0, size=n)
        Q = np.zeros((n, q + 3))
        Q[:, :q] = np.linalg.qr(rng.standard_normal((n, q)))[0]
        return s, Q, rng.standard_normal(n), rng.uniform(0.2, 2.0)

    states = [state() for _ in range(R or 1)]
    s, Q = states[0][0], states[0][1]
    T[1] = (Q[:, :q] @ rng.standard_normal(q) / s).astype(np.float32)
    if R is None:
        return (T,) + tuple(np.asarray(a, np.float32) for a in states[0])
    return (T,) + tuple(np.asarray([st[k] for st in states], np.float32)
                        for k in range(4))


def test_score_from_T():
    T, s, Q, z3, s2g = _score_inputs(5, 300, 150, 6)
    got = _np(kernels.score_from_T(*(torch.from_numpy(np.asarray(a))
                                     for a in (T, s, Q, z3, s2g))))
    ref = jk.score_from_T(*(jnp.asarray(a) for a in (T, s, Q, z3, s2g)))
    _close(got, ref, 1e-5)
    assert got[0] == 0.0 and got[1] == 0.0


def test_score_from_T_batched():
    args = _score_inputs(6, 300, 150, 6, R=3)
    got = _np(kernels.score_from_T_batched(*(torch.from_numpy(a)
                                             for a in args)))
    ref = jk.score_from_T_batched(*(jnp.asarray(a) for a in args))
    assert got.shape == (3, 300)
    _close(got, ref, 1e-5)


# ---------------------------------------------------------------------------
# per module: engine_torch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_z", [False, True])
def test_normalized_kernel(with_z):
    rng = np.random.default_rng(7)
    A = rng.standard_normal((40, 90))
    K = A @ A.T
    Z = np.kron(np.eye(40), np.ones((2, 1))) if with_z else None
    np.testing.assert_allclose(engine_torch.normalized_kernel(K, Z),
                               engine_jax.normalized_kernel(K, Z),
                               rtol=1e-13, atol=1e-13)


def test_eig_iteration_state():
    rng = np.random.default_rng(8)
    n = 60
    d = np.sort(rng.gamma(1.0, 2.0, size=n))
    Xs = np.column_stack([rng.standard_normal((n, 3)),
                          rng.standard_normal(n)])
    Xs = np.column_stack([Xs, Xs[:, 0] + Xs[:, 1]])    # a dependent column
    y_star = rng.standard_normal(n)
    for got, ref in zip(
            engine_torch._eig_iteration_state(d, y_star, Xs, 0.8, 16),
            engine_jax._eig_iteration_state(d, y_star, Xs, 0.8, 16)):
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("miss", [0.0, 0.02])
def test_compute_K_matches_jax(miss):
    """Integer genotypes without missing codes: every f32 sum is exact, so
    the MMt is equal bit for bit; with 2% missing the means round alike
    and only the order of the f32 sums differs."""
    G = _geno(9, 700, 130, miss).T                  # (n, p)
    got = engine_torch.TiledScan(engine_torch.DenseTileSource(G),
                                 EagleConfig(snp_tile=256), "cpu").compute_K()
    ref = engine_jax.TiledScan(engine_jax.DenseTileSource(G),
                               JaxConfig(snp_tile=256)).compute_K()
    if miss == 0.0:
        np.testing.assert_array_equal(got, ref)
    else:
        _close(got.astype(np.float32), ref.astype(np.float32), 1e-6)


@pytest.mark.parametrize("cache_gb", [8.0, 1e-6])
def test_sweep_eig_matches_jax(cache_gb):
    """The same U and per-iteration state through both sweeps, with the
    T tiles cached and recomputed every sweep."""
    G = _geno(10, 700, 130, 0.02).T
    cfg = dict(snp_tile=256, device_cache_gb=cache_gb)
    sc = engine_torch.TiledScan(engine_torch.DenseTileSource(G),
                                EagleConfig(**cfg), "cpu")
    sj = engine_jax.TiledScan(engine_jax.DenseTileSource(G), JaxConfig(**cfg))
    d, U = np.linalg.eigh(engine_jax.normalized_kernel(sj.compute_K()))
    d = np.maximum(d, 0.0)
    sc.set_eigenbasis(U)
    sj.set_eigenbasis(U)
    assert sc.cache_device == (cache_gb == 8.0)
    rng = np.random.default_rng(10)
    X = np.column_stack([np.ones(130), rng.standard_normal(130)])
    y = rng.standard_normal(130)
    for delta in (0.5, 2.0):
        s, Q, z3 = engine_jax._eig_iteration_state(d, U.T @ y, U.T @ X,
                                                   delta, 8)
        _close(sc.sweep_eig(s, Q, z3, 0.9), sj.sweep_eig(s, Q, z3, 0.9),
               1e-5)
    assert (sc._tcache is not None) == sc.cache_device
    assert sc._wcache is None


# ---------------------------------------------------------------------------
# the slice: am(engine="jax") and its configurations
# ---------------------------------------------------------------------------


def test_tutorial_matches_golden():
    with open(os.path.join(ROOT, "tests", "fixtures",
                           "tutorial_golden.json")) as f:
        golden = json.load(f)
    geno = port.read_marker(os.path.join(TUT, "geno.txt"))
    res = port.am("y", geno.geno, port.read_pheno(os.path.join(TUT,
                                                               "pheno.txt")),
                  fformula="age + sex",
                  map=port.read_map(os.path.join(TUT, "map.txt")), maxit=8,
                  engine="jax", device="cpu")
    assert res.indices == golden["indices"]
    assert res.marker_names == golden["marker_names"]
    np.testing.assert_allclose(res.extbic_path, golden["extbic_path"],
                               rtol=1e-6)
    np.testing.assert_allclose(res.loglik_path, golden["loglik_path"],
                               rtol=1e-6)
    assert res.delta == pytest.approx(golden["delta"], rel=1e-6)
    assert res.sigma2_g == pytest.approx(golden["sigma2_g"], rel=1e-6)


@pytest.fixture(scope="module")
def sim():
    return simulate_dataset(n=150, p=1200, n_qtl=3, seed=11)


def _design(sim):
    n = sim.y.shape[0]
    return np.column_stack(
        [np.ones(n), sim.covariate - sim.covariate.mean(),
         sim.group.astype(float)])


def _handle(geno, store_dir=None):
    return port.GenoHandle(n=geno.shape[0], p=geno.shape[1], source="<t>",
                           geno=None if store_dir else geno,
                           store_dir=store_dir)


@pytest.fixture(scope="module")
def oracle_res(sim):
    return oracle.forward_select(sim.y, _design(sim), sim.geno, maxit=10)


def _check_matches_oracle(res, ref):
    """tests/test_engine.py's check of an engine against the oracle."""
    assert res.indices == ref.indices
    np.testing.assert_allclose(res.extbic_path, ref.extbic_path, rtol=1e-3)
    assert res.delta == pytest.approx(ref.delta, rel=1e-2)
    for t_e, t_o in zip(res.outlier_stats, ref.outlier_stats):
        np.testing.assert_allclose(t_e, t_o, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("case", ["default", "small_tiles", "store",
                                  "bfloat16", "device_eigh"])
def test_engine_matches_oracle(sim, oracle_res, case, tmp_path):
    """tests/test_engine.py's single-device configurations: small tiles,
    a store source with no device cache (T recomputed every sweep), the
    bf16 policy and the f32 device eigendecomposition (selections only,
    as there)."""
    handle = _handle(sim.geno)
    cfg = {"default": EagleConfig(), "small_tiles": EagleConfig(snp_tile=256),
           "store": EagleConfig(snp_tile=256, device_cache_gb=1e-6),
           "bfloat16": EagleConfig(compute_dtype="bfloat16"),
           "device_eigh": EagleConfig(host_eigh_max_n=8)}[case]
    if case == "store":
        d = str(tmp_path / "store")
        JaxStore.create_from_dense(d, sim.geno, n_shards=3)
        handle = _handle(sim.geno, store_dir=d)
    res = engine_torch.forward_select(sim.y, _design(sim), handle, maxit=10,
                                      config=cfg, device="cpu")
    if case in ("bfloat16", "device_eigh"):
        assert res.indices == oracle_res.indices
    else:
        _check_matches_oracle(res, oracle_res)


def test_engine_missing_genotypes():
    simm = simulate_dataset(n=150, p=1200, n_qtl=3, seed=11,
                            missing_rate=0.02)
    X0 = _design(simm)
    ref = oracle.forward_select(simm.y, X0, simm.geno, maxit=10)
    res = engine_torch.forward_select(simm.y, X0, _handle(simm.geno),
                                      maxit=10, device="cpu")
    assert res.indices == ref.indices
    np.testing.assert_allclose(res.extbic_path, ref.extbic_path, rtol=1e-3)


@pytest.fixture(scope="module")
def zmat_case():
    simz = simulate_dataset(n=100, p=600, n_qtl=2, seed=5, h2_qtl=0.45)
    n = simz.y.shape[0]
    Z = np.kron(np.eye(n), np.ones((2, 1)))
    rng = np.random.default_rng(1)
    y_rec = Z @ simz.y + 0.3 * rng.standard_normal(2 * n)
    X0 = np.ones((2 * n, 1))
    ref = oracle.forward_select(y_rec, X0, simz.geno, maxit=6, Z=Z)
    return simz, Z, y_rec, X0, ref


@pytest.mark.parametrize("host_eigh_max_n", [8192, 8])
def test_engine_zmat(zmat_case, host_eigh_max_n):
    """Zmat through am(): Zᵀ·U folded on the host (U host f64), or on the
    device when the eigendecomposition runs there (U never on the host)."""
    simz, Z, y_rec, X0, ref = zmat_case
    res = port.am("y", simz.geno, {"y": y_rec}, Zmat=Z, maxit=6,
                  engine="jax", device="cpu",
                  config=EagleConfig(host_eigh_max_n=host_eigh_max_n))
    assert res.indices == ref.indices
    if host_eigh_max_n == 8192:
        np.testing.assert_allclose(res.extbic_path, ref.extbic_path,
                                   rtol=1e-3)


def _fuzz_case(seed):
    """tests/test_fuzz_parity.py's generator for ``seed``."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(60, 140))
    p = int(rng.integers(150, 500))
    n_qtl = int(rng.integers(0, 4))
    h2 = float(rng.uniform(0.15, 0.6))
    miss = float(rng.choice([0.0, 0.0, 0.03]))
    sim = simulate_dataset(n=n, p=p, n_qtl=max(n_qtl, 1), h2_qtl=h2,
                           h2_poly=float(rng.uniform(0.1, 0.4)),
                           seed=seed, missing_rate=miss)
    y = sim.y if n_qtl > 0 else rng.standard_normal(n)
    return sim, y, np.column_stack([np.ones(n), sim.covariate])


# three of the seeds also run the JAX engine itself, whose compile time
# per shape dominates this file
_FUZZ_VS_JAX_ENGINE = (41, 50, 59)


@pytest.mark.parametrize("seed", range(41, 61))
def test_fuzz_matches_oracle(seed):
    sim, y, X0 = _fuzz_case(seed)
    ref = oracle.forward_select(y, X0, sim.geno, maxit=4)
    res = engine_torch.forward_select(y, X0, _handle(sim.geno), maxit=4,
                                      device="cpu")
    assert res.indices == ref.indices, (
        f"seed={seed}: port {res.indices} vs oracle {ref.indices}")
    np.testing.assert_allclose(res.extbic_path, ref.extbic_path, rtol=2e-3)
    if seed in _FUZZ_VS_JAX_ENGINE:
        n, p = sim.geno.shape
        jres = engine_jax.forward_select(
            y, X0, JaxHandle(n=n, p=p, source="<f>", geno=sim.geno), maxit=4)
        assert res.indices == jres.indices
        np.testing.assert_allclose(res.extbic_path, jres.extbic_path,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# checkpointing (tests/test_ops.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ck_sim():
    return simulate_dataset(n=120, p=800, n_qtl=3, seed=21, h2_qtl=0.45)


def _ck_run(sim, **kw):
    return engine_torch.forward_select(
        sim.y, np.ones((sim.y.shape[0], 1)),
        port.GenoHandle(n=sim.geno.shape[0], p=sim.geno.shape[1],
                        source="<ops-test>", geno=sim.geno),
        device="cpu", **kw)


def test_checkpoint_resume_matches_fresh(ck_sim, tmp_path):
    d = str(tmp_path / "ck")
    fresh = _ck_run(ck_sim, maxit=6)
    assert len(fresh.indices) >= 2
    _ck_run(ck_sim, maxit=1, fixit=True, ckpt_dir=d)
    state = ckpt.load_scan_state(d)
    assert state is not None and state["selected"] == fresh.indices[:1]
    resumed = _ck_run(ck_sim, maxit=6, ckpt_dir=d, resume=True)
    assert resumed.indices == fresh.indices
    np.testing.assert_allclose(resumed.extbic_path, fresh.extbic_path,
                               rtol=1e-10)
    with pytest.raises(ValueError, match="refusing to resume"):
        _ck_run(ck_sim, maxit=3, lam_ebic=2.5, ckpt_dir=d, resume=True)


def test_mmt_cache_reused(ck_sim, tmp_path):
    d = str(tmp_path / "ck2")
    handle = port.GenoHandle(n=ck_sim.geno.shape[0], p=ck_sim.geno.shape[1],
                             source="<ops-test>", geno=ck_sim.geno)
    key = ckpt.mmt_cache_key("<ops-test>", handle.n, handle.p, None,
                             content_token=ckpt.genotype_content_token(handle))
    assert ckpt.load_mmt(d, key) is None
    _ck_run(ck_sim, maxit=1, fixit=True, ckpt_dir=d)
    K = ckpt.load_mmt(d, key)
    assert K is not None and K.shape == (handle.n,) * 2
    # poison the cache; if it is really used, the fit changes
    A = np.random.default_rng(0).standard_normal(K.shape)
    ckpt.save_mmt(d, key, A @ A.T)
    poisoned = _ck_run(ck_sim, maxit=1, fixit=True, ckpt_dir=d)
    clean = _ck_run(ck_sim, maxit=1, fixit=True)
    assert poisoned.delta != pytest.approx(clean.delta, rel=1e-6)


# ---------------------------------------------------------------------------
# am_multi (tests/test_multitrait.py)
# ---------------------------------------------------------------------------


def test_am_multi_matches_jax():
    sim1 = simulate_dataset(n=130, p=900, n_qtl=2, seed=31, h2_qtl=0.45)
    rng = np.random.default_rng(8)
    W = sim1.geno.astype(np.float64)
    W = W - W.mean(axis=0)
    g = W[:, [123, 700]] @ np.array([1.5, -1.5])
    y2 = g / g.std() * np.sqrt(0.5) + rng.standard_normal(130) * np.sqrt(0.5)
    y1 = sim1.y.copy()
    y1[5] = np.nan                                 # union NA drop
    pheno = {"y1": y1, "y2": y2, "age": sim1.covariate,
             "sex": np.where(sim1.group, "M", "F")}
    got = port.am_multi(["y1", "y2"], sim1.geno, pheno, fformula="age + sex",
                        maxit=6, engine="jax", device="cpu")
    ref = ee.am_multi(["y1", "y2"], geno=sim1.geno, pheno=pheno,
                      fformula="age + sex", maxit=6, engine="jax")
    assert set(got) == {"y1", "y2"}
    for t in ("y1", "y2"):
        assert got[t].indices == ref[t].indices
        assert len(got[t].indices) >= 1
        np.testing.assert_allclose(got[t].extbic_path, ref[t].extbic_path,
                                   rtol=1e-6)
        assert list(got[t].dropped_records) == [5]
    keep = np.arange(130) != 5
    single = port.am("y2", sim1.geno[keep],
                     {k: v[keep] for k, v in pheno.items()},
                     fformula="age + sex", maxit=6, engine="jax",
                     device="cpu")
    assert got["y2"].indices == single.indices
    np.testing.assert_allclose(got["y2"].extbic_path, single.extbic_path,
                               rtol=1e-8)
