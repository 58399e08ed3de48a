"""The port's workflow around ``am()`` against the JAX package's, on the CPU.

tests/test_api.py's fixture (``write_tutorial(n=120, p=1000, seed=13)``),
read through each package's own ``read_marker``: the same selections, the
exact ``summary_am`` and ``fpr4am``'s λ_crits at rtol 1e-6, the matrix-free
summary at rtol 1e-4 and within that file's bands, the same ``.html`` plot,
and that file's batching-invariance and λ_crit-semantics properties on the
port. Also ``am_multi``'s JAX keywords, and the matrix-free routes this
port took last (Zmat in the summary, ``fpr4am``) against the JAX
package's, and the fields of the two EagleConfigs."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import eagleeverything_tpu as ee  # noqa: E402
from eagleeverything_tpu.data import simulate as jsim  # noqa: E402

import eagleeverything_tpu_torch as port  # noqa: E402
from eagleeverything_tpu_torch.api.common import prepare_inputs  # noqa: E402

FF = "age + sex"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tutorial"))
    sim = jsim.write_tutorial(d, n=120, p=1000, seed=13)
    return d, sim


def _read(pkg, d):
    return (pkg.read_marker(os.path.join(d, "geno.txt")),
            pkg.read_pheno(os.path.join(d, "pheno.txt")),
            pkg.read_map(os.path.join(d, "map.txt")))


@pytest.fixture(scope="module")
def handles(data_dir):
    return {"jax": _read(ee, data_dir[0]), "port": _read(port, data_dir[0])}


@pytest.fixture(scope="module")
def scans(handles):
    g, ph, mp = handles["jax"]
    ref = ee.am("y", g, ph, fformula=FF, map=mp, maxit=8, engine="jax")
    g, ph, mp = handles["port"]
    got = port.am("y", g, ph, fformula=FF, map=mp, maxit=8, engine="jax",
                  device="cpu")
    return ref, got


def test_exports_cover_jax_api():
    assert set(ee.__all__) <= set(port.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name


def test_am_matches_jax(scans, data_dir):
    ref, got = scans
    assert got.indices == ref.indices and len(got.indices) >= 1
    assert got.marker_names == ref.marker_names
    np.testing.assert_allclose(got.extbic_path, ref.extbic_path, rtol=1e-6)
    # tests/test_api.py's recovery rule: every planted QTL within its
    # 25-SNP LD block, at most 2 extra selections
    sim = data_dir[1]
    idx = np.array(got.indices)
    assert all(np.min(np.abs(idx - q)) <= 25 for q in sim.qtl_idx)
    assert sum(np.min(np.abs(sim.qtl_idx - j)) > 25 for j in idx) <= 2


def test_summary_exact_matches_jax(handles, scans):
    ref_res, got_res = scans
    g, ph, _ = handles["jax"]
    ref = ee.summary_am(ref_res, "y", g, ph, fformula=FF, quiet=True,
                        engine="exact")
    g, ph, _ = handles["port"]
    got = port.summary_am(got_res, "y", g, ph, fformula=FF, quiet=True,
                          engine="exact", device="cpu")
    assert got.indices == ref.indices
    for f in ("beta", "se", "wald", "pvalue", "var_explained"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-6, err_msg=f)
    assert got.sigma2_g == pytest.approx(ref.sigma2_g, rel=1e-6)
    assert (got.pvalue < 0.05).all()


def test_summary_matfree_within_reference_bands(handles, scans, capsys):
    """tests/test_api.py's bands: the matrix-free summary reuses the scan's
    (δ, σ²) and solves by CG, so β within 5% and se within 10% of the
    exact refit; printed as the reference prints it."""
    _, res = scans
    g, ph, _ = handles["port"]
    s = port.summary_am(res, "y", g, ph, fformula=FF, quiet=True,
                        engine="exact", device="cpu")
    sm = port.summary_am(res, "y", g, ph, fformula=FF, quiet=False,
                         engine="matfree", device="cpu")
    np.testing.assert_allclose(sm.beta, s.beta, rtol=0.05)
    np.testing.assert_allclose(sm.se, s.se, rtol=0.10)
    assert (sm.pvalue < 0.05).all()
    out = capsys.readouterr().out
    assert "Summary of the" in out
    for name in res.marker_names:
        assert name in out


@pytest.mark.parametrize("delta", [None, 0.1])
def test_summary_matfree_matches_jax(handles, scans, delta):
    """The matrix-free summary against the JAX package's on the same scan:
    both solve H⁻¹·[X y] by f32 CG to a relative residual of 1e-6 over the
    same s0 probe, so β, se and p agree far inside the bands above. The
    scan's δ̂ sits at the top of its search range here, where H = K/s0 + δI
    is nearly δI; at δ = 0.1 the kernel dominates H (β moves by 5%)."""
    ref_res, got_res = scans
    if delta is not None:
        ref_res = dataclasses.replace(ref_res, delta=delta)
        got_res = dataclasses.replace(got_res, delta=delta)
    g, ph, _ = handles["jax"]
    ref = ee.summary_am(ref_res, "y", g, ph, fformula=FF, quiet=True,
                        engine="matfree")
    g, ph, _ = handles["port"]
    got = port.summary_am(got_res, "y", g, ph, fformula=FF, quiet=True,
                          engine="matfree", device="cpu")
    assert got.indices == ref.indices
    for f in ("beta", "se", "pvalue"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-4, err_msg=f)


def test_summary_matfree_zmat_not_ported(handles, scans):
    """The matrix-free summary with a Zmat, which raised before Zmat was
    ported to the matrix-free engine, agrees with the JAX package's at
    rtol 1e-4 (an identity Zmat, one-hot: the record-space device CG)."""
    ref_res, res = scans
    g, ph, _ = handles["jax"]
    ref = ee.summary_am(ref_res, "y", g, ph, fformula=FF, Zmat=np.eye(g.n),
                        quiet=True, engine="matfree")
    g, ph, _ = handles["port"]
    got = port.summary_am(res, "y", g, ph, fformula=FF, Zmat=np.eye(g.n),
                          quiet=True, engine="matfree", device="cpu")
    assert got.indices == ref.indices
    for f in ("beta", "se", "pvalue"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-4, err_msg=f)


def test_fpr4am_matches_jax(handles):
    g, ph, _ = handles["jax"]
    ref = ee.fpr4am("y", g, ph, fformula=FF, numreps=6, seed=1)
    g, ph, _ = handles["port"]
    got = port.fpr4am("y", g, ph, fformula=FF, numreps=6, seed=1,
                      device="cpu")
    np.testing.assert_allclose(got["lambda_crits"], ref["lambda_crits"],
                               rtol=1e-6)
    assert got["lambda"] == pytest.approx(ref["lambda"], rel=1e-6)
    assert got["lambda"] >= 0 and len(got["candidates"]) == 6
    assert (got["falseposrate"], got["numreps"]) == (0.05, 6)


def test_fpr4am_batching_invariance(handles):
    """Permutation batching must not change the calibration (SURVEY.md §5
    property tests: permutation batching equivalence)."""
    g, ph, _ = handles["port"]
    a = port.fpr4am("y", g, ph, fformula=FF, numreps=5, seed=3,
                    perm_batch=1, device="cpu")
    b = port.fpr4am("y", g, ph, fformula=FF, numreps=5, seed=3,
                    perm_batch=5, device="cpu")
    np.testing.assert_allclose(a["lambda_crits"], b["lambda_crits"],
                               rtol=1e-8)
    np.testing.assert_array_equal(a["candidates"], b["candidates"])


def test_fpr_lambda_crit_semantics(handles):
    """λ_crit is the exact accept/reject threshold: scanning the SAME
    permuted trait with λ just below λ_crit must select ≥1 marker, just
    above must select none."""
    g, ph, _ = handles["port"]
    out = port.fpr4am("y", g, ph, fformula=FF, numreps=1, seed=11,
                      device="cpu")
    lam_crit = float(out["lambda_crits"][0])
    assert lam_crit > 0
    prep = prepare_inputs("y", g, ph, FF, None)
    assert len(prep.keep) == g.n           # no NA in the fixture
    cols = {"y": np.random.default_rng(11).permutation(prep.y),
            "age": ph.columns["age"], "sex": ph.columns["sex"]}
    r_low = port.am("y", g, cols, fformula=FF, maxit=1, lam=lam_crit * 0.98,
                    device="cpu")
    r_high = port.am("y", g, cols, fformula=FF, maxit=1,
                     lam=lam_crit * 1.02, device="cpu")
    assert r_low.indices == [int(out["candidates"][0])]
    assert r_high.indices == []


@pytest.mark.parametrize("engine,cfg", [("matfree", None),
                                        ("auto", {"matfree_min_n": 10})])
def test_fpr4am_matfree_not_ported(handles, engine, cfg):
    """The matrix-free calibration, which raised before it was ported,
    forced and by "auto" above matfree_min_n: the JAX package's
    permutations pick the same candidates (it prints them) and λ_crit
    agrees at rtol 2e-3 (tests/test_fuzz_parity.py)."""
    import contextlib
    import io
    import re

    from eagleeverything_tpu.utils.config import EagleConfig as JaxConfig
    g, ph, _ = handles["jax"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref = ee.fpr4am("y", g, ph, numreps=3, seed=2, engine=engine,
                        config=JaxConfig(**(cfg or {})), quiet=False)
    cands = [int(c) for c in re.findall(r"matfree\] rep=\d+ cand=(\d+)",
                                        buf.getvalue())]
    g, ph, _ = handles["port"]
    got = port.fpr4am("y", g, ph, numreps=3, seed=2, engine=engine,
                      config=port.EagleConfig(**(cfg or {})), device="cpu")
    assert got["candidates"].tolist() == cands and len(cands) == 3
    np.testing.assert_allclose(got["lambda_crits"], ref["lambda_crits"],
                               rtol=2e-3)


def test_plot_html_matches_jax(handles, scans, tmp_path):
    ref, got = scans
    paths = {}
    for name, pkg, res in (("jax", ee, ref), ("port", port, got)):
        paths[name] = str(tmp_path / f"{name}.html")
        assert pkg.plot_am(res, map=handles[name][2],
                           save=paths[name]) == paths[name]
    with open(paths["port"]) as f:
        html = f.read()
    with open(paths["jax"]) as f:
        assert html == f.read()
    assert "eeDrawManhattan" in html and '"rank"' in html
    for name in got.marker_names:
        assert name in html
    with pytest.raises(ValueError):
        port.plot_am(got, save=str(tmp_path / "t.html"), type="trace")


def test_plot_png_and_trace(handles, scans, tmp_path):
    pytest.importorskip("matplotlib")
    _, res = scans
    out = str(tmp_path / "p.png")
    port.plot_am(res, map=handles["port"][2], save=out,
                 highlight_changes=True)
    assert os.path.getsize(out) > 1000
    out2 = str(tmp_path / "t.png")
    port.plot_am(res, type="trace", save=out2)
    assert os.path.getsize(out2) > 1000
    fig = port.plot_am(res, itnum=0)
    assert fig.axes


def test_am_multi_takes_jax_keywords(handles, tmp_path):
    """The JAX package's am_multi keywords run unchanged on the exact
    engine (fault F1): ckpt_dir, resume and log_jsonl are accepted."""
    g, ph, mp = handles["jax"]
    ref = ee.am_multi(["y", "age"], g, ph, map=mp, maxit=3, engine="jax",
                      log_jsonl=str(tmp_path / "jax.jsonl"))
    g, ph, mp = handles["port"]
    got = port.am_multi(["y", "age"], g, ph, map=mp, maxit=3, engine="jax",
                        ckpt_dir=str(tmp_path / "ck"), resume=True,
                        log_jsonl=str(tmp_path / "port.jsonl"),
                        device="cpu")
    assert list(got) == list(ref) == ["y", "age"]
    for t in got:
        assert got[t].indices == ref[t].indices
        assert got[t].marker_names == ref[t].marker_names
        np.testing.assert_allclose(got[t].extbic_path, ref[t].extbic_path,
                                   rtol=1e-6)
    assert len(got["y"].indices) >= 1


def test_eagle_config_fields_are_the_jax_packages():
    """The port's EagleConfig has the JAX package's fields, in its order,
    with its defaults (fault F2: ``pallas_packed`` was refused), and takes
    the reference's Pallas switch at every value without effect."""
    from eagleeverything_tpu.utils.config import EagleConfig as JaxConfig

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(port.EagleConfig) == fields(JaxConfig)
    for value in (None, True, False):
        cfg = port.EagleConfig(pallas_packed=value)
        assert cfg.pallas_packed is value
        assert dataclasses.replace(cfg, pallas_packed=None) \
            == port.EagleConfig()


def test_zmat_file_scan_matches_jax(handles, tmp_path):
    """A Zmat read from file through both packages gives one selection."""
    z = str(tmp_path / "z.txt")
    n = handles["port"][0].n
    jsim.write_zmat(np.eye(n), z)
    g, ph, _ = handles["jax"]
    ref = ee.am("y", g, ph, fformula=FF, Zmat=ee.read_zmat(z), maxit=4,
                engine="jax")
    g, ph, _ = handles["port"]
    got = port.am("y", g, ph, fformula=FF, Zmat=port.read_zmat(z), maxit=4,
                  engine="jax", device="cpu")
    assert got.indices == ref.indices
    np.testing.assert_allclose(got.extbic_path, ref.extbic_path, rtol=1e-6)
