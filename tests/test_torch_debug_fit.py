"""scripts/debug_resume_fit_torch.py (the REML profile of one model on the
matrix-free and the exact engine) against the JAX package, on the CPU at
a 600 x 9000 cohort of scripts/cohort_run_torch.py (the JAX script's
cohort byte for byte), the model 1 + [3175, 3863, 922] and that model plus
2366 (all planted):

- the exact profile, on the grid and on the tail past it, equals the JAX
  package's reml_core.reml_loglik on its own eigenbasis (spectral_inputs
  of the same kernel), rtol 1e-8, and its δ → ∞ limit equals that
  reml_loglik at δ = 1e12; the port's MMt equals the JAX TiledScan's
  (rtol 1e-6, f32 sums);
- the matrix-free profile equals the JAX package's ShiftedKrylov +
  MatfreeContext.logdet + _ll_from_solution over its TiledScan on the
  same store, probes and s0, rtol 1e-6;
- the exact profile by a blocked f64 Cholesky of K + δI at each δ (the
  f64 cross-check of the eigenbasis route) equals the eigenbasis one,
  rtol 1e-10, and the eigenbasis route is the default at every n;
- the two engines' profiles agree within rtol 1e-3 away from the grid's
  two ends on each side, each matrix-free δ̂ is a maximiser of the exact
  profile within 0.05 log-likelihood units, and each engine's extBIC
  change for the added SNP agrees;
- tests/jax_matfree_profile.py, the JAX side of ROADMAP F5 at sizes
  beyond the suite, holds the port here as the tests above do."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, P = 600, 9000
SELECTED, ADD = [3175, 3863, 922], 2366


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


dbg = _load("debug_resume_fit_torch",
            ROOT / "scripts" / "debug_resume_fit_torch.py")
crt = _load("cohort_run_torch_dbg", ROOT / "scripts" / "cohort_run_torch.py")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dbg")
    crt.generate(str(d), N, P, device="cpu")
    out = d / "f4.json"
    # both exact routes; 128-row Cholesky blocks, so that the blocked
    # factor and substitutions run several blocks
    res = dbg.run(str(d), SELECTED, ADD, True, ["default"], device="cpu",
                  out=str(out), routes=("eigh", "cholesky"), block=128)
    assert json.loads(out.read_text())["exact"]["models"].keys() == \
        res["exact"]["models"].keys()
    return d, res


def _models(d):
    meta, y = crt._load(str(d))
    backend = crt._backend(str(d), meta, "off", torch.device("cpu"))
    return backend, y, dbg.models(backend, N, SELECTED, ADD)


def test_exact_profile_is_the_jax_reml_loglik(run):
    from eagleeverything_tpu.models import reml_core as jrc

    d, res = run
    backend, y, Xs = _models(d)
    # the kernel on the matrix-free δ scale of the profile
    K = backend.compute_K() / res["s0"]
    ex = res["exact"]
    assert ex["eig_residual"] < 1e-12 and ex["orth_residual"] < 1e-12
    for name, X in Xs.items():
        lam, eta2, _ = jrc.spectral_inputs(y, X, K)
        got = [r["ll"] for r in ex["models"][name]["profile"]]
        want = [jrc.reml_loglik(dd, lam, eta2) for dd in dbg.GRID]
        np.testing.assert_allclose(got, want, rtol=1e-8)
        m = ex["models"][name]
        np.testing.assert_allclose(
            [r["ll"] for r in m["tail"]],
            [jrc.reml_loglik(dd, lam, eta2) for dd in dbg.TAIL], rtol=1e-8)
        assert m["loglik_limit"] == pytest.approx(
            jrc.reml_loglik(1e12, lam, eta2), rel=1e-8)
        assert m["loglik_sup"] == max(m["loglik"], m["loglik_limit"],
                                      *(r["ll"] for r in m["tail"]))


def test_mmt_is_the_jax_tiled_scans(run):
    from eagleeverything_tpu.api.read import GenoHandle
    from eagleeverything_tpu.models import engine_jax
    from eagleeverything_tpu.utils.config import EagleConfig as JCfg

    d, _ = run
    backend, _, _ = _models(d)
    jsrc = engine_jax._make_source(
        GenoHandle(n=N, p=P, source="cohort", store_dir=str(d / "store")),
        None)
    want = engine_jax.TiledScan(jsrc, JCfg(snp_tile=1024)).compute_K()
    got = backend.compute_K()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_matfree_profile_is_the_jax_krylov_profile(run):
    from eagleeverything_tpu.api.read import GenoHandle
    from eagleeverything_tpu.models import bigscan as jbs
    from eagleeverything_tpu.models import engine_jax
    from eagleeverything_tpu.models import reml_core as jrc
    from eagleeverything_tpu.utils.config import EagleConfig as JCfg

    d, res = run
    meta, y = crt._load(str(d))
    jsrc = engine_jax._make_source(
        GenoHandle(n=N, p=P, source="cohort", store_dir=str(d / "store")),
        None)
    jb = engine_jax.TiledScan(jsrc, JCfg(snp_tile=1024))
    proto = dbg.protocol("default")
    ctx = jbs.make_context(jb, N, probes=proto["probes"],
                           lanczos_m=proto["lanczos_m"], s0=res["s0"])
    X = np.ones((N, 1))
    for j in SELECTED:
        X = np.hstack([X, jb.column_f64(j)[:, None]])
    Xs = {"model": X,
          f"model+{ADD}": np.hstack([X, jb.column_f64(ADD)[:, None]])}
    mf = res["matfree"]["default"]["models"]
    for name, Xm in Xs.items():
        Xi, _ = jrc.independent_cols(Xm)
        sk = jbs.ShiftedKrylov(ctx.kernel_matvec, np.column_stack([Xi, y]),
                               m=proto["solve_m"], reorth=True,
                               device_lanczos=ctx.device_lanczos)
        want = [jbs._ll_from_solution(y, Xi, sk.solve(dd),
                                      ctx.logdet(dd))[0] for dd in dbg.GRID]
        got = [r["ll"] for r in mf[name]["profile"]]
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert all(r["sol_finite"] for r in mf[name]["profile"])


def test_the_cholesky_route_is_the_eigenbasis_route(run):
    _, res = run
    eig, chol = res["exact"], res["exact_cholesky"]
    assert eig["route"] == "eigh" and chol["route"] == "cholesky"
    assert chol["chol_residual"] < 1e-13
    assert chol["factorizations"] >= len(dbg.GRID)
    for name, m in eig["models"].items():
        for rows in ("profile", "tail"):
            for key in ("ll", "logdet"):
                np.testing.assert_allclose(
                    [r[key] for r in chol["models"][name][rows]],
                    [r[key] for r in m[rows]], rtol=1e-10)
    # the limit is one formula; δ̂ come from two searches (reml_maximize_diag
    # and reml_maximize_matfree's), each within its own tolerance
    assert chol["extbic_change_limit"] == pytest.approx(
        eig["extbic_change_limit"], abs=1e-9)
    for key in ("extbic_change", "extbic_change_sup"):
        assert chol[key] == pytest.approx(eig[key], abs=1e-3)


def test_exact_route_follows_n():
    """The exact engine's own eigenbasis REML at every n, on either side of
    the card's library limit (eigh_basis takes engine_torch.eigh_large
    above it); the Cholesky route runs only when forced."""
    from eagleeverything_tpu_torch.models import engine_torch
    limit = engine_torch.DEVICE_EIGH_MAX_N
    for dev in (torch.device("cuda"), torch.device("cpu")):
        for n in (2000, limit, limit + 1, 50_000):
            assert dbg.exact_route(n, dev) == "eigh"


def test_the_two_engines_agree_away_from_the_grids_ends(run):
    _, res = run
    mf = res["matfree"]["default"]
    ex = res["exact"]
    for name, m in mf["models"].items():
        a = np.array([r["ll"] for r in m["profile"]])
        b = np.array([r["ll"] for r in ex["models"][name]["profile"]])
        np.testing.assert_allclose(a[2:-2], b[2:-2], rtol=1e-3)
        # the SLQ log-determinant at δ̂ beside the exact one
        assert m["exact_logdet_at_delta_hat"] == pytest.approx(
            m["logdet_at_delta_hat"], rel=1e-3)
        assert m["loglik"] == pytest.approx(ex["models"][name]["loglik"],
                                            rel=1e-3)
        assert m["exact_ll_at_delta_hat"] > ex["models"][name]["loglik"] \
            - 0.05
    assert mf["extbic_change"] == pytest.approx(ex["extbic_change"],
                                                abs=0.5)
    assert np.sign(mf["extbic_change_hinted"]) == np.sign(
        ex["extbic_change"])


def test_the_jax_side_of_f5_holds_the_port(run):
    """tests/jax_matfree_profile.py (the JAX package's matrix-free profile
    and fit, for cohorts too large for the suite) on the same cohort: the
    profiles within rtol 1e-6, the fits' log-likelihoods within 1e-6 of
    their size, and the extBIC excess over the exact supremum alike. The
    Krylov diagnostics of ROADMAP F5 are equal too: each column's guard
    step (the guard fires nowhere here) and the count of negative raw Ritz
    values exactly; the raw Ritz values, T's first coefficients and the
    guard ratios to f32 tolerance of the kernel's scale (two f32 device
    Lanczos runs, XLA's and torch's, on the same inputs: 1e-5 of the
    largest Ritz value), and the weight on Ritz values below the exact
    floor within 1e-6."""
    d, res = run
    jm = _load("jax_matfree_profile", ROOT / "tests" / "jax_matfree_profile.py")
    got = jm.profile(str(d), res, "default")
    mf = res["matfree"]["default"]["models"]
    assert set(got["models"]) == set(mf)
    for name, m in got["models"].items():
        assert m["profile_rel_gap_max"] < 1e-6
        assert abs(m["loglik_gap"]) < 1e-6 * abs(m["loglik"])
        assert m["extbic_excess"] == pytest.approx(m["port_extbic_excess"],
                                                   abs=1e-3)
        pm = mf[name]
        assert m["lanczos"] == "device"
        assert m["guard_step"] == pm["guard_step"]
        assert set(m["guard_step"]) == {-1}
        assert m["n_negative"] == pm["n_negative"]
        scale = 1e-5 * pm["w_max"]
        assert m["w_raw_min"] == pytest.approx(pm["w_raw_min"], abs=scale)
        np.testing.assert_allclose(m["w_raw_low"], pm["w_raw_low"],
                                   atol=scale)
        np.testing.assert_allclose(m["alpha_head"], pm["alpha_head"],
                                   rtol=1e-5, atol=scale)
        np.testing.assert_allclose(m["beta_head"], pm["beta_head"],
                                   rtol=1e-5, atol=scale)
        np.testing.assert_allclose(m["guard_ratio_min"],
                                   pm["guard_ratio_min"], rtol=1e-4)
        np.testing.assert_allclose(m["weight_below_floor"],
                                   pm["weight_below_floor"], atol=1e-6)
