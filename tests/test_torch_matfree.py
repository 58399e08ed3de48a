"""The port's matrix-free engine beyond the single-trait scan, against the
JAX package's, on the CPU: the device-resident Lanczos, Zmat designs
(record-space CG and Lanczos, ``am``/``summary_am`` with a one-hot and a
weighted Zmat), the multi-trait pieces (``matfree_stat_rows_multi``,
``solve_block_shifts``, ``score_sweep_matfree_multi`` with and without a
Zmat, ``am_multi``), the one-trait loop's checkpoint files, and
``fpr4am`` on the matrix-free engine.

The same seeded numpy inputs go through both packages. The JAX backend of
the kernel-level tests is its packed-stack scan (the device programs the
port's steps are written from); the scan-level tests use the JAX package's
default CPU configuration, as its own tests do. Tolerances are the
reference tests': tests/test_packed_stack.py for the device Krylov pieces,
rtol 1e-3 on extBIC (tests/test_packed_stack.py's matrix-free tolerance),
rtol 2e-3 on λ_crit (tests/test_fuzz_parity.py), rtol 1e-4 on the
summary (tests/test_torch_api.py)."""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import eagleeverything_tpu as ee  # noqa: E402
from eagleeverything_tpu.data.simulate import simulate_dataset  # noqa: E402
from eagleeverything_tpu.io.genostore import (  # noqa: E402
    GenotypeStore as JaxStore)
from eagleeverything_tpu.models import bigscan as jbig  # noqa: E402
from eagleeverything_tpu.models import engine_jax  # noqa: E402
from eagleeverything_tpu.utils.config import (  # noqa: E402
    EagleConfig as JaxConfig)

import eagleeverything_tpu_torch as port  # noqa: E402
from eagleeverything_tpu_torch.models import bigscan, engine_torch  # noqa: E402
from eagleeverything_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from eagleeverything_tpu_torch.utils.config import EagleConfig  # noqa: E402

N, P = 200, 1500
S0 = 300.0


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mfstore"))
    sim = simulate_dataset(n=N, p=P, n_qtl=2, seed=11, missing_rate=0.02)
    JaxStore.create_from_dense(d, sim.geno, n_shards=2, packed=True)
    return d, sim


@pytest.fixture(scope="module")
def scans(store):
    """(port scan, JAX packed-stack scan) over one store. The JAX budget
    rules out its recoded W cache and keeps the packed bytes resident, so
    its device CG and Lanczos are the packed step programs."""
    d, _ = store
    tp = engine_torch.TiledScan(engine_torch.StoreTileSource(d),
                                EagleConfig(snp_tile=256), "cpu")
    jp = engine_jax.TiledScan(engine_jax.StoreTileSource(d),
                              JaxConfig(snp_tile=256, device_cache_gb=1e-4))
    assert jp.cache_packed_device and not jp.cache_device
    return tp, jp


def _records(seed: int):
    """A repeated-measures index: every individual once, 30 drawn again."""
    rng = np.random.default_rng(seed)
    z_idx = np.concatenate([np.arange(N), rng.integers(0, N, size=30)])
    return z_idx, rng


# ---------------------------------------------------------------------------
# the device Lanczos and the record-space Krylov steps
# ---------------------------------------------------------------------------


def test_device_lanczos_matches_jax(scans):
    """tests/test_packed_stack.py:107's bounds: z_norm at rtol 1e-6, the
    leading 8 α and β at rtol/atol 1e-3 (later coefficients drift in
    f32); the padded columns stay inert."""
    tp, jp = scans
    Z = np.random.default_rng(3).standard_normal((N, 5))
    at, bt, zt, Vt = tp.device_lanczos(Z, 20, True, S0)
    aj, bj, zj, _ = jp.device_lanczos(Z, 20, True, S0)
    assert at.shape == aj.shape == (20, 8) and bt.shape == bj.shape
    assert tuple(Vt.shape) == (8, 20, N) and Vt.device.type == "cpu"
    np.testing.assert_allclose(zt, zj, rtol=1e-6)
    np.testing.assert_allclose(at[:8, :5], aj[:8, :5], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(bt[:8, :5], bj[:8, :5], rtol=1e-3, atol=1e-3)
    assert not at[:, 5:].any() and not bt[:, 5:].any()
    # the reorthogonalised basis is orthonormal a column
    G = torch.einsum("rkn,rln->rkl", Vt[:5], Vt[:5])
    np.testing.assert_allclose(G.numpy(), np.broadcast_to(np.eye(20),
                                                          G.shape),
                               atol=1e-4)


def test_device_lanczos_zidx_matches_jax_and_host(scans):
    """Record space (tests/test_packed_stack.py:242-280's bounds): the
    tridiagonal of Z·K·Zᵀ/s0 matches the JAX device program and the host
    f64 recurrence over the same matvec."""
    tp, jp = scans
    z_idx, rng = _records(5)
    Zc = rng.standard_normal((len(z_idx), 2))
    at, _, zt, _ = tp.device_lanczos(Zc, 10, True, S0, z_idx=z_idx)
    aj, _, zj, _ = jp.device_lanczos(Zc, 10, True, S0, z_idx=z_idx)
    np.testing.assert_allclose(at[:, :2], aj[:, :2], rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(zt[:2], zj[:2], rtol=1e-6)
    Zm = np.zeros((len(z_idx), N))
    Zm[np.arange(len(z_idx)), z_idx] = 1.0
    ah, _, zh, _ = bigscan._lanczos(
        lambda V: Zm @ tp.kernel_matvec(Zm.T @ V) / S0, Zc, 10, reorth=True)
    np.testing.assert_allclose(at[:, :2], ah, rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(zt[:2], zh, rtol=1e-6)


@pytest.mark.parametrize("warm", [False, True])
def test_device_cg_zidx_matches_jax(scans, warm):
    """Record-space CG, cold and warm-started, at rtol 2e-4 / atol 2e-5
    against the JAX device CG and the host f64 blocked CG."""
    tp, jp = scans
    z_idx, rng = _records(7)
    Zm = np.zeros((len(z_idx), N))
    Zm[np.arange(len(z_idx)), z_idx] = 1.0
    B = rng.standard_normal((len(z_idx), 3))
    X_host = bigscan.blocked_cg(
        lambda V: Zm @ tp.kernel_matvec(Zm.T @ V) / S0 + 0.3 * V, B,
        tol=1e-7)
    x0 = X_host + 0.01 if warm else None
    Xt = tp.device_cg(B, 0.3, S0, tol=1e-7, z_idx=z_idx, x0=x0)
    Xj = jp.device_cg(B, 0.3, S0, tol=1e-7, z_idx=z_idx, x0=x0)
    np.testing.assert_allclose(Xt, Xj, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(Xt, X_host, rtol=2e-4, atol=2e-5)


def test_blocked_cg_matches_jax():
    rng = np.random.default_rng(4)
    M = rng.standard_normal((90, 90))
    H = M @ M.T / 90 + 0.4 * np.eye(90)
    B = rng.standard_normal((90, 3))
    got = bigscan.blocked_cg(lambda V: H @ V, B, tol=1e-10)
    np.testing.assert_allclose(got, jbig.blocked_cg(lambda V: H @ V, B,
                                                    tol=1e-10),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, np.linalg.solve(H, B), rtol=1e-7,
                               atol=1e-9)


def _contexts(scans):
    tp, jp = scans
    return (bigscan.make_context(tp, N, s0=S0),
            jbig.make_context(jp, N, s0=S0))


def test_shifted_krylov_device_basis_matches_jax(scans):
    """ShiftedKrylov over each package's device Lanczos: solves (whole and
    column slices, as _UnionKrylov takes them), the inverse square root and
    the SLQ log-determinant agree to f32 Lanczos accuracy."""
    ct, cj = _contexts(scans)
    B = np.random.default_rng(8).standard_normal((N, 5))
    skt = bigscan.ShiftedKrylov(ct.kernel_matvec, B, 40, reorth=True,
                                device_lanczos=ct.device_lanczos)
    skj = jbig.ShiftedKrylov(cj.kernel_matvec, B, 40, reorth=True,
                             device_lanczos=cj.device_lanczos)
    assert skt.V is None and skt._V_dev is not None
    K = scans[0].kernel_matvec(np.eye(N)) / S0
    for d in (0.05, 1.0):
        ref = skj.solve(d)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(skt.solve(d), ref, atol=1e-4 * scale)
        np.testing.assert_allclose(skt.solve(d, sl=slice(2, 4)),
                                   ref[:, 2:4], atol=1e-4 * scale)
        np.testing.assert_allclose(skt.isqrt(d), skj.isqrt(d), rtol=1e-3,
                                   atol=1e-4)
        # against the exact solve of the normalised kernel (f64)
        np.testing.assert_allclose(skt.solve(d),
                                   np.linalg.solve(K + d * np.eye(N), B),
                                   atol=2e-3 * scale)
    assert ct.logdet(0.5) == pytest.approx(cj.logdet(0.5), rel=1e-4)
    assert ct._logdet_sk._V_dev is None     # dropped: quadrature only


def test_isqrt_probes_over_budget_runs_on_the_device(scans, monkeypatch):
    """Over the cache budget nothing is cached, and the probe block's
    inverse square root still comes from the device Lanczos (the host
    recurrence is reached by nothing where the hook exists)."""
    ct, _ = _contexts(scans)
    probes = np.random.default_rng(9).choice((-1.0, 1.0), size=(N, 16))
    cached = ct.isqrt_probes(0.7, probes)

    def no_host(*a, **k):
        raise AssertionError("the host Lanczos ran")

    monkeypatch.setattr(bigscan, "_lanczos", no_host)
    monkeypatch.setattr(bigscan, "lanczos_isqrt_apply", no_host)
    ct.cache_max_bytes = 1
    ct._isqrt_sk = None
    uncached = ct.isqrt_probes(0.7, probes)
    assert ct._isqrt_sk is None
    np.testing.assert_allclose(uncached, cached, rtol=1e-5, atol=1e-6)
    # several shifts share one uncached pass: one Lanczos, not one a shift
    calls = []
    hook = ct.device_lanczos
    ct.device_lanczos = lambda *a: calls.append(1) or hook(*a)
    shifted = ct.isqrt_probes_shifts([0.7, 3.0], probes)
    assert len(calls) == 1
    np.testing.assert_array_equal(shifted[0], uncached)
    np.testing.assert_allclose(shifted[1], ct.isqrt_probes(3.0, probes),
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# Zmat designs on the matrix-free engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zdesign():
    """tests/test_bigscan.py:160's repeated-measures design (two records an
    individual), and a weighted variant of the same Z that is not
    one-hot."""
    sim = simulate_dataset(n=80, p=400, n_qtl=1, seed=5, h2_qtl=0.6)
    Z = np.kron(np.eye(80), np.ones((2, 1)))
    rng = np.random.default_rng(2)
    y = Z @ sim.y + 0.3 * rng.standard_normal(160)
    weights = np.where(np.arange(160) % 3 == 0, 0.5, 1.0)
    return sim, y, {"onehot": Z, "weighted": Z * weights[:, None]}


@pytest.fixture(scope="module")
def zscans(zdesign):
    sim, y, Zs = zdesign
    out = {}
    for kind, Z in Zs.items():
        got = port.am("y", sim.geno, {"y": y}, Zmat=Z, maxit=3,
                      engine="matfree", device="cpu")
        ref = ee.am("y", sim.geno, {"y": y}, Zmat=Z, maxit=3,
                    engine="matfree")
        out[kind] = (got, ref)
    return out


@pytest.mark.parametrize("kind", ["onehot", "weighted"])
def test_am_matfree_zmat_matches_jax(zscans, kind):
    got, ref = zscans[kind]
    assert got.indices == ref.indices and len(got.indices) >= 1
    np.testing.assert_allclose(got.extbic_path, ref.extbic_path, rtol=1e-3)


@pytest.mark.parametrize("kind", ["onehot", "weighted"])
def test_summary_matfree_zmat_matches_jax(zdesign, zscans, kind):
    sim, y, Zs = zdesign
    res = zscans[kind][0]
    got = port.summary_am(res, "y", sim.geno, {"y": y}, Zmat=Zs[kind],
                          engine="matfree", quiet=True, device="cpu")
    ref = ee.summary_am(res, "y", sim.geno, {"y": y}, Zmat=Zs[kind],
                        engine="matfree", quiet=True)
    assert got.indices == ref.indices
    for f in ("beta", "se", "pvalue"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-4, err_msg=f)


def test_make_context_zmat_hooks(zdesign):
    """A one-hot Z becomes an index vector and keeps both device hooks; a
    weighted Z has none and solves by the host blocked CG, whose matvec
    is the wrapped kernel. Both solve H = Z·K·Zᵀ/s0 + δI."""
    sim, _, Zs = zdesign
    sc = engine_torch.TiledScan(engine_torch.DenseTileSource(sim.geno),
                                EagleConfig(), "cpu")
    K = sc.kernel_matvec(np.eye(80))
    B = np.random.default_rng(1).standard_normal((160, 2))
    for kind, Z in Zs.items():
        ctx = bigscan.make_context(sc, 160, Z=Z, s0=50.0)
        onehot = kind == "onehot"
        assert (ctx.z_idx is not None) == onehot
        assert (ctx.device_solve is not None) == onehot
        assert (ctx.device_lanczos is not None) == onehot
        H = Z @ K @ Z.T / 50.0 + 0.4 * np.eye(160)
        np.testing.assert_allclose(ctx.solve_block(0.4, B),
                                   np.linalg.solve(H, B), rtol=1e-4,
                                   atol=1e-5)
        W = np.random.default_rng(2).standard_normal((80, 3))
        np.testing.assert_allclose(ctx.z_apply(Z, W), Z @ W, rtol=1e-12)
        A = np.random.default_rng(3).standard_normal((160, 3))
        np.testing.assert_allclose(ctx.zt_apply(Z, A), Z.T @ A, rtol=1e-12)


# ---------------------------------------------------------------------------
# multi-trait pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qs,r", [((1, 3), 12), ((1, 3, 9, 2, 1), 128)],
                         ids=["one_launch", "sub_batched"])
def test_matfree_stat_rows_multi_matches_jax(scans, qs, r):
    """R traits' statistics from the wide K1 pass against the JAX package's
    and against one matfree_stat_rows a trait. The second case asks for
    5 × (1 + 16 + 128) = 725 > 640 columns, so it runs as sub-batches of
    4 and 1, with a q8 of 16 shared by traits of differing q."""
    tp, jp = scans
    rng = np.random.default_rng(len(qs))
    A_list, M_list = [], []
    for q in qs:
        A_list.append(np.column_stack([
            rng.standard_normal((N, 1 + q)),
            rng.choice((-1.0, 1.0), size=(N, r))]))
        M = rng.standard_normal((q, q))
        M_list.append(M @ M.T + np.eye(q))
    got = tp.matfree_stat_rows_multi(A_list, list(qs), M_list)
    ref = jp.matfree_stat_rows_multi(A_list, list(qs), M_list)
    assert len(got) == len(qs)
    for t, q in enumerate(qs):
        serial = tp.matfree_stat_rows(A_list[t], q, M_list[t])
        for g, f, s in zip(got[t], ref[t], serial):
            np.testing.assert_allclose(g, f, rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(g, s, rtol=1e-5, atol=1e-5)
        assert got[t][1].shape == (P, q)


@pytest.fixture(scope="module")
def multi():
    """tests/test_multitrait.py's two traits over one genotype matrix, and
    a pure-noise third trait."""
    sim1 = simulate_dataset(n=130, p=900, n_qtl=2, seed=31, h2_qtl=0.45)
    rng = np.random.default_rng(8)
    q2 = np.array([123, 700])
    W = sim1.geno.astype(np.float64)
    W = W - W.mean(axis=0)
    g = W[:, q2] @ np.array([1.5, -1.5])
    y2 = g / g.std() * np.sqrt(0.5) + rng.standard_normal(130) * np.sqrt(0.5)
    pheno = {"y1": sim1.y, "y2": y2,
             "noise": np.random.default_rng(0).standard_normal(130)}
    return sim1, pheno


def _multi_contexts(multi):
    sim1, _ = multi
    tp = engine_torch.TiledScan(engine_torch.DenseTileSource(sim1.geno),
                                EagleConfig(), "cpu")
    jp = engine_jax.TiledScan(engine_jax.DenseTileSource(sim1.geno),
                              JaxConfig())
    return (tp, bigscan.make_context(tp, 130, probes=16),
            jp, jbig.make_context(jp, 130, probes=16))


def test_solve_block_shifts_matches_jax(multi):
    """One multi-shift CG against the JAX one and against one solve a
    shift, column by column (tests/test_multitrait.py's tolerance)."""
    _, ct, _, cj = _multi_contexts(multi)
    B = np.random.default_rng(3).standard_normal((130, 5))
    shifts = np.array([0.3, 0.3, 2.0, 7.0, 0.01])
    got = ct.solve_block_shifts(shifts, B)
    np.testing.assert_allclose(got, cj.solve_block_shifts(shifts, B),
                               rtol=2e-4, atol=1e-6)
    for c in range(5):
        ref = ct.solve_block(float(shifts[c]), B[:, c : c + 1])
        np.testing.assert_allclose(got[:, c], ref[:, 0], rtol=2e-4,
                                   atol=1e-7)
    with pytest.raises(ValueError, match="shifts"):
        ct.solve_block_shifts(shifts[:4], B)


def test_score_sweep_matfree_multi_matches_jax(multi):
    """The batched sweep on the JAX package's fits (so the sweep alone is
    compared), with diverged models (different q and exclusions): the
    same candidates and probe estimates, the rescored statistics at
    rtol 1e-4; and the same candidates as the port's serial sweeps."""
    sim1, pheno = multi
    tp, ct, jp, cj = _multi_contexts(multi)
    X0 = np.ones((130, 1))
    col = tp.column_f64
    ys = [np.asarray(pheno["y1"], np.float64),
          np.asarray(pheno["y2"], np.float64)]
    Xs = [X0, np.column_stack([X0, col(123)])]
    excludes = [[], [123]]
    fits = [jbig.reml_maximize_matfree(cj, ys[t], Xs[t]) for t in range(2)]
    kw = dict(diag_probes=96, exact_topk=16, column_f64=col,
              excludes=excludes)
    got = bigscan.score_sweep_matfree_multi(ct, tp, ys, Xs, fits, **kw)
    ref = jbig.score_sweep_matfree_multi(cj, jp, ys, Xs, fits, **kw)
    for t in range(2):
        (tg, cg_, ig), (tr, cr, ir) = got[t], ref[t]
        assert cg_ == cr and not ig["exhausted"]
        np.testing.assert_allclose(tg[cr], tr[cr], rtol=1e-4)
        assert tg[excludes[t]].sum() == 0.0
        _, cs, _ = bigscan.score_sweep_matfree(
            ct, tp, ys[t], Xs[t], fits[t], diag_probes=96, exact_topk=16,
            column_f64=col, exclude=excludes[t])
        assert cs == cg_


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("kind", ["onehot", "weighted"])
def test_score_sweep_matfree_multi_zmat_matches_jax(zdesign, kind, R):
    """The lockstep sweep with one Zmat shared by its traits (a one-hot Z
    on the device hooks, a weighted one on the host CG), at R = 1 and 2,
    against the JAX package's one-trait sweep a trait on the JAX fits:
    the same candidates, the rescored t at rtol 1e-4."""
    sim, y, Zs = zdesign
    Z = Zs[kind]
    tp = engine_torch.TiledScan(engine_torch.DenseTileSource(sim.geno),
                                EagleConfig(), "cpu")
    jp = engine_jax.TiledScan(engine_jax.DenseTileSource(sim.geno),
                              JaxConfig())
    ct = bigscan.make_context(tp, 160, Z=Z, probes=16)
    cj = jbig.make_context(jp, 160, Z=Z, probes=16)
    col = tp.column_f64
    X0 = np.ones((160, 1))
    ys = [y, np.tanh(y) + 0.2 * np.random.default_rng(4).standard_normal(160)]
    Xs = [X0, np.column_stack([X0, Z @ col(7)])]
    excludes = [[], [7]]
    fits = [jbig.reml_maximize_matfree(cj, ys[t], Xs[t]) for t in range(R)]
    kw = dict(diag_probes=96, exact_topk=16, column_f64=col, Z=Z)
    got = bigscan.score_sweep_matfree_multi(ct, tp, ys[:R], Xs[:R], fits,
                                            excludes=excludes[:R], **kw)
    assert len(got) == R
    for t in range(R):
        tg, cg_, ig = got[t]
        tr, cr, ir = jbig.score_sweep_matfree(cj, jp, ys[t], Xs[t], fits[t],
                                              exclude=excludes[t], **kw)
        assert cg_ == cr and not ig["exhausted"]
        np.testing.assert_allclose(tg[cr], tr[cr], rtol=1e-4)
        assert tg[excludes[t]].sum() == 0.0


# am()'s scan_state.json layout, as every build of the port writes it
_STATE_KEYS = {"version", "selected", "extbic_path", "loglik_path",
               "delta", "sigma2_g", "sigma2_e", "meta"}
_META_KEYS = {"trait_n", "p", "lam_ebic", "trait_sum", "trait_sq",
              "fit_exact"}


def test_am_matfree_checkpoint_keeps_its_files(multi, tmp_path):
    """am() on the matrix-free engine writes its own checkpoint,
    scan_state.json with its key set and the accepted fit, and the
    sweep's stage-0 cache beside it; never am_multi's file."""
    sim1, pheno = multi
    d = str(tmp_path / "ck")
    res = port.am("y1", sim1.geno, pheno, maxit=2, engine="matfree",
                  device="cpu", ckpt_dir=d)
    assert len(res.indices) >= 1
    assert sorted(os.listdir(d)) == ["scan_state.json", "sweep_h0.npz"]
    with open(os.path.join(d, "scan_state.json")) as f:
        st = json.load(f)
    assert set(st) == _STATE_KEYS and set(st["meta"]) == _META_KEYS
    assert st["selected"] == res.indices and st["meta"]["fit_exact"]
    assert (st["meta"]["trait_n"], st["meta"]["p"]) == (130, 900)
    np.testing.assert_array_equal(st["extbic_path"], res.extbic_path)
    assert st["delta"] == res.delta and st["sigma2_g"] == res.sigma2_g
    with np.load(os.path.join(d, "sweep_h0.npz")) as z:
        assert set(z.files) == {"key", "ahat_l", "U_l", "diag_l", "proj_l",
                                "XtHiX_inv"}


def test_am_matfree_resumes_a_scan_state_of_the_old_layout(multi,
                                                            tmp_path):
    """A scan_state.json laid out as am() has always written it (here by
    hand, from a one-marker scan's result) resumes to the fresh scan's
    selections; another trait's is refused."""
    sim1, pheno = multi
    kw = dict(maxit=4, engine="matfree", device="cpu")
    fresh = port.am("y1", sim1.geno, pheno, **kw)
    one = port.am("y1", sim1.geno, pheno, maxit=1, engine="matfree",
                  device="cpu")
    assert one.indices == fresh.indices[:1]
    y = np.asarray(pheno["y1"], np.float64)
    state = {"version": 1, "selected": one.indices,
             "extbic_path": one.extbic_path, "loglik_path": one.loglik_path,
             "delta": one.delta, "sigma2_g": one.sigma2_g,
             "sigma2_e": one.sigma2_e,
             "meta": {"trait_n": 130, "p": 900, "lam_ebic": 1.0,
                      "trait_sum": round(float(np.sum(y)), 6),
                      "trait_sq": round(float(y @ y), 6),
                      "fit_exact": True}}
    d = tmp_path / "old"
    d.mkdir()
    with open(d / "scan_state.json", "w") as f:
        json.dump(state, f, indent=1)
    log = str(tmp_path / "resume.jsonl")
    resumed = port.am("y1", sim1.geno, pheno, ckpt_dir=str(d), resume=True,
                      log_jsonl=log, **kw)
    assert resumed.indices == fresh.indices
    np.testing.assert_allclose(resumed.extbic_path, fresh.extbic_path,
                               rtol=1e-6)
    with open(log) as f:
        assert '"event": "resume"' in f.read()
    assert not os.path.exists(d / "multi_scan_state.json")
    with pytest.raises(ValueError, match="refusing to resume"):
        port.am("y2", sim1.geno, pheno, ckpt_dir=str(d), resume=True, **kw)


def test_am_matfree_passes_over_another_engines_scan_state(multi, tmp_path):
    """A scan_state.json with no trait fingerprint, as the exact engine
    writes it, is passed over with a warning and the scan starts fresh;
    a fingerprinted one that holds no exact fit is refused."""
    sim1, pheno = multi
    kw = dict(maxit=2, engine="matfree", device="cpu")
    fresh = port.am("y1", sim1.geno, pheno, **kw)
    y = np.asarray(pheno["y1"], np.float64)
    meta = {"trait_n": 130, "p": 900, "lam_ebic": 1.0}
    d = str(tmp_path / "exact")
    ckpt.save_scan_state(d, [3], [1.0, 0.5], [-2.0, -1.0], 1.0, 1.0, 1.0,
                         meta=meta)
    with pytest.warns(UserWarning, match="no trait fingerprint"):
        got = port.am("y1", sim1.geno, pheno, ckpt_dir=d, resume=True, **kw)
    assert got.indices == fresh.indices
    np.testing.assert_array_equal(got.extbic_path, fresh.extbic_path)
    ckpt.save_scan_state(d, [3], [1.0, 0.5], [-2.0, -1.0], 1.0, 1.0, 1.0,
                         meta=dict(meta, trait_sum=round(float(np.sum(y)), 6),
                                   trait_sq=round(float(y @ y), 6)))
    with pytest.raises(ValueError, match="no exact fit"):
        port.am("y1", sim1.geno, pheno, ckpt_dir=d, resume=True, **kw)


@pytest.fixture(scope="module")
def multi_scans(multi):
    sim1, pheno = multi
    traits = ["y1", "y2", "noise"]
    got = port.am_multi(traits, sim1.geno, pheno, maxit=5, engine="matfree",
                        device="cpu")
    ref = ee.am_multi(traits, sim1.geno, pheno, maxit=5, engine="matfree")
    return got, ref


def test_am_multi_matfree_matches_jax(multi_scans):
    got, ref = multi_scans
    assert list(got) == list(ref) == ["y1", "y2", "noise"]
    for t in got:
        assert got[t].indices == ref[t].indices, t
        np.testing.assert_allclose(got[t].extbic_path, ref[t].extbic_path,
                                   rtol=1e-3, err_msg=t)
    assert len(got["y1"].indices) >= 1 and len(got["y2"].indices) >= 1


@pytest.mark.parametrize("trait", ["y1", "noise"])
def test_am_multi_matfree_matches_single_trait(multi, multi_scans, trait):
    """Each trait of the lockstep scan selects what the single-trait
    matrix-free am() selects; the noise trait selects nothing."""
    sim1, pheno = multi
    got, _ = multi_scans
    single = port.am(trait, sim1.geno, pheno, maxit=5, engine="matfree",
                     device="cpu")
    assert got[trait].indices == single.indices
    np.testing.assert_allclose(got[trait].extbic_path, single.extbic_path,
                               rtol=1e-3)
    if trait == "noise":
        assert single.indices == []


def test_am_multi_auto_routes_to_matfree(multi, monkeypatch):
    sim1, pheno = multi
    called = {}
    orig = bigscan.forward_select_matfree_multi

    def spy(*a, **k):
        called["yes"] = True
        return orig(*a, **k)

    monkeypatch.setattr(bigscan, "forward_select_matfree_multi", spy)
    port.am_multi(["y1"], sim1.geno, pheno, maxit=1, device="cpu",
                  config=port.EagleConfig(matfree_min_n=64))
    assert called.get("yes")


def test_am_multi_matfree_checkpoint_resume(multi, tmp_path):
    """A lockstep scan stopped after one iteration resumes from its
    checkpoint to the fresh scan's selections, through the am_multi
    keywords; a checkpoint of other traits is refused."""
    sim1, pheno = multi
    kw = dict(maxit=4, engine="matfree", device="cpu")
    traits = ["y1", "y2"]
    fresh = port.am_multi(traits, sim1.geno, pheno, **kw)
    d = str(tmp_path / "mck")
    port.am_multi(traits, sim1.geno, pheno, maxit=1, fixit=True,
                  engine="matfree", device="cpu", ckpt_dir=d)
    log = str(tmp_path / "resume.jsonl")
    resumed = port.am_multi(traits, sim1.geno, pheno, ckpt_dir=d,
                            resume=True, log_jsonl=log, **kw)
    for t in traits:
        assert resumed[t].indices == fresh[t].indices, t
        np.testing.assert_allclose(resumed[t].extbic_path,
                                   fresh[t].extbic_path, rtol=1e-6)
    with open(log) as f:
        assert '"event": "resume"' in f.read()
    bad = dict(pheno, y1=np.asarray(pheno["y1"]) + 1.0)
    with pytest.raises(ValueError, match="refusing to resume"):
        port.am_multi(traits, sim1.geno, bad, ckpt_dir=d, resume=True, **kw)


# ---------------------------------------------------------------------------
# fpr4am on the matrix-free engine
# ---------------------------------------------------------------------------


def _jax_matfree_fpr(*args, **kw):
    """The JAX matrix-free calibration and the candidates it prints (its
    result does not list them)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = ee.fpr4am(*args, engine="matfree", quiet=False, **kw)
    return out, [int(c) for c in re.findall(r"cand=(\d+)", buf.getvalue())]


@pytest.mark.parametrize("kind", ["no_zmat", "onehot"])
def test_fpr4am_matfree_matches_jax(zdesign, kind):
    """The same permutations pick the same candidates; λ_crit at rtol
    2e-3. With a Zmat too, a chunk's sweeps run as one batched sweep."""
    sim, y_rec, Zs = zdesign
    if kind == "no_zmat":
        args, extra = ("y", sim.geno, {"y": sim.y}), {}
    else:
        args, extra = ("y", sim.geno, {"y": y_rec}), {"Zmat": Zs["onehot"]}
    got = port.fpr4am(*args, numreps=6, seed=5, engine="matfree",
                      device="cpu", **extra)
    ref, cands = _jax_matfree_fpr(*args, numreps=6, seed=5, **extra)
    assert got["candidates"].tolist() == cands
    np.testing.assert_allclose(got["lambda_crits"], ref["lambda_crits"],
                               rtol=2e-3)
    assert got["lambda"] == pytest.approx(ref["lambda"], rel=2e-3)


def test_fpr4am_zmat_rides_the_batched_sweep(zdesign, monkeypatch):
    """With a Zmat, a chunk's permutations are swept by ONE lockstep call
    that carries the Zmat (no sweep a permutation)."""
    sim, y_rec, Zs = zdesign
    calls = []
    orig = bigscan.score_sweep_matfree_multi

    def spy(ctx, backend, ys, *a, **k):
        calls.append((len(ys), k.get("Z") is not None))
        return orig(ctx, backend, ys, *a, **k)

    monkeypatch.setattr(bigscan, "score_sweep_matfree_multi", spy)
    out = port.fpr4am("y", sim.geno, {"y": y_rec}, Zmat=Zs["onehot"],
                      numreps=3, seed=5, engine="matfree", device="cpu")
    assert calls == [(3, True)]
    assert len(out["candidates"]) == 3
