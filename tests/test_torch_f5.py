"""ROADMAP F5 (the matrix-free REML profile's bias at BASELINE config 3)
held between the port and the JAX package on the CPU.

The step that makes the bias is the device Lanczos's breakdown guard
(engine_torch._lanczos_step, engine_jax._lanczos_chunk_steps), which
zeroes a step where β_k ≤ 1e-5·(|α_k| + β_{k-1} + 1e-3). In a genotype
kernel the uncentred mean component (W = dose - 1) dominates the spectrum:
α_1 and β_0 of a marker column carry that top eigenvalue, while β_1 is
the bulk's, so β_1 / (α_1 + β_0) falls as 1/√(n·p). At config 3 (50 000 x
1 000 000) it reaches the guard on five of the six marker columns, whose
tridiagonals then decouple after two steps: a block of exact zeros (Ritz
values of exactly 0.0, with no weight) and solves from a two-vector
space. Config 3's recipe reaches the guard only near n·p = 5·10¹⁰, far
beyond a test, so the cohort here raises the top eigenvalue over the bulk
instead: scripts/cohort_run_torch.py's generator with only its first 128
SNPs polymorphic and 180 096 monomorphic ones after them (their W is -1
throughout: the mean component alone), which takes β_1 / (α_1 + β_0) of
six marker columns to 3.4-5.3e-6 at 96 individuals.

- ShiftedKrylov's w (the clipped Ritz values) and every solve are the
  JAX package's bit for bit on the host recurrence; the new ``w_raw``,
  ``guard_step`` and ``guard_ratio`` only add to it.
- On the cohort, both packages' device Lanczos on the same [X y] (the
  same store, the same s0) fire the guard at the same step of the same
  columns, with T's coefficients equal to f32 tolerance up to it and
  exact zeros after it.
- The REML profile over those bases is the JAX package's within the
  bound of f32 roundoff carried through the solve.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(kind: str):
    """(matvec, Z, the guard step each column must show): "dense", a PSD
    kernel of full rank with one dominant eigenvalue (a genotype kernel's
    shape), where the host guard (1e-12) never fires in 24 steps;
    "invariant", a diagonal kernel whose column j lives on j + 2
    coordinates, so its Krylov space closes after j + 2 steps and the
    guard zeroes β_{j+1}."""
    n = 64
    rng = np.random.default_rng(3)
    if kind == "dense":
        G = rng.standard_normal((n, 2 * n))
        G[:, 0] += 6.0
        K = G @ G.T / (2 * n)
        return (lambda V: K @ V), rng.standard_normal((n, 5)), [-1] * 5
    d = np.linspace(0.5, 40.0, n)
    Z = np.zeros((n, 5))
    for j in range(5):
        Z[: j + 2, j] = rng.standard_normal(j + 2)
    return (lambda V: d[:, None] * V), Z, [j + 1 for j in range(5)]


@pytest.mark.parametrize("kind", ["dense", "invariant"])
def test_shifted_krylov_is_the_jax_packages_bit_for_bit(kind):
    """The port's ShiftedKrylov on the host recurrence against the JAX
    package's on the same matvec and block: w, Q, z_norm, the basis, every
    solve, isqrt and the SLQ log-determinant equal bit for bit, so keeping
    w_raw, guard_step and guard_ratio changed nothing of them; w is w_raw
    clipped at 0, and guard_step is the step the guard zeroed."""
    from eagleeverything_tpu.models import bigscan as jbs
    from eagleeverything_tpu_torch.models import bigscan as tbs

    mv, Z, steps = _case(kind)
    m = 24
    got = tbs.ShiftedKrylov(mv, Z, m, reorth=True)
    want = jbs.ShiftedKrylov(mv, Z, m, reorth=True)
    for key in ("w", "Q", "Q0", "z_norm", "V"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    for delta in (1e-3, 0.3, 7.0):
        np.testing.assert_array_equal(got.solve(delta), want.solve(delta))
        np.testing.assert_array_equal(got.isqrt(delta), want.isqrt(delta))
        assert got.logdet(delta) == want.logdet(delta)
    np.testing.assert_array_equal(got.w, np.maximum(got.w_raw, 0.0))
    assert got.guard_step.tolist() == steps
    for j, k in enumerate(steps):
        if k >= 0:
            # the guard's zero and every step after it; the decoupled block
            # is exact zeros, so Ritz values of exactly 0.0
            assert np.all(got.betas[k:, j] == 0.0)
            assert np.all(got.alphas[k + 1:, j] == 0.0)
            assert np.sum(got.w_raw[:, j] == 0.0) == m - k - 1
        assert np.all(got.betas[: k if k >= 0 else None, j] > 0.0)
    assert np.all(got.guard_ratio > 0.0)


def test_guard_steps_and_ratios_from_t():
    """guard_steps / guard_ratio_min on a hand-made (α, β): the first zero
    β of each column (-1 where there is none) and the smallest β_k /
    (|α_k| + β_{k-1}) over the kept steps."""
    from eagleeverything_tpu_torch.models import bigscan as tbs

    alphas = np.array([[100.0, 5.0], [50.0, -2.0], [0.0, 1.0]])
    betas = np.array([[40.0, 3.0], [0.0, 0.5]])
    np.testing.assert_array_equal(tbs.guard_steps(betas), [1, -1])
    np.testing.assert_allclose(tbs.guard_ratio_min(alphas, betas),
                               [40.0 / 100.0, 0.5 / (2.0 + 3.0)])
    assert tbs.guard_steps(np.zeros((0, 3))).tolist() == [-1, -1, -1]


# the cohort whose top eigenvalue is raised over the bulk: N individuals
# of scripts/cohort_run_torch.py's generator (seed 7, config 3's MAF
# range) with only the first POLY SNPs polymorphic and the rest
# monomorphic (W = -1: the mean component alone). β_1 / (α_1 + β_0) of
# the six marker columns falls to 3.4-5.3e-6 (f64, the host recurrence;
# the guard zeroes below 1e-5), while the intercept's (1.52e-5, at step
# 0) and y's (3.3e-5) stay above it
N, P, POLY = 96, 180_224, 128
MARKERS = [3, 17, 40, 77, 90, 120]
M = 16


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Both packages' TiledScan over one packed store, [1, W_markers], y,
    the shared Hutchinson s0 (the port's debug script's), and the exact
    kernel on that scale (f64, from the port's compute_K)."""
    from eagleeverything_tpu.api.read import GenoHandle
    from eagleeverything_tpu.models import engine_jax
    from eagleeverything_tpu.utils.config import EagleConfig as JCfg

    d = tmp_path_factory.mktemp("f5")
    crt = _load("cohort_run_torch_f5", ROOT / "scripts" / "cohort_run_torch.py")
    dbg = _load("debug_resume_fit_torch_f5",
                ROOT / "scripts" / "debug_resume_fit_torch.py")
    crt.generate(str(d), N, P, device="cpu", poly=POLY)
    meta, y = crt._load(str(d))
    tb = crt._backend(str(d), meta, "off", torch.device("cpu"))
    jb = engine_jax.TiledScan(
        engine_jax._make_source(
            GenoHandle(n=N, p=P, source="cohort", store_dir=str(d / "store")),
            None), JCfg(snp_tile=1024))
    X = dbg.models(tb, N, MARKERS, None)["model"]
    s0 = dbg.hutchinson_s0(tb, N)
    K = tb.compute_K() / s0
    return tb, jb, X, y, s0, K


def _bases(cohort):
    """Each package's device Lanczos on the same [X y], at M steps."""
    tb, jb, X, y, s0, _ = cohort
    B = np.column_stack([X, y])
    return (B, tb.device_lanczos(B, M, True, s0),
            jb.device_lanczos(B, M, True, s0))


def test_the_guard_fires_at_the_same_steps_in_both_packages(cohort):
    """The port's device Lanczos (engine_torch._lanczos_step) and the JAX
    package's (engine_jax._lanczos_chunk_steps) on the same [X y]: the
    guard zeroes the same columns at the same step (step 1 of four marker
    columns, none of the other four), T's coefficients agree up to it
    (rtol 1e-4: two f32 recurrences, XLA's and torch's, whose roundoff
    differs and compounds over the reorthogonalised steps; atol 1e-6 of
    the largest α), and after it both hold exact zeros, so each package's
    raw Ritz values include m - 2 values of exactly 0.0 a tripped column
    and no negative one."""
    from eagleeverything_tpu_torch.models import bigscan as tbs

    jm = _load("jax_matfree_profile_f5", ROOT / "tests" / "jax_matfree_profile.py")
    B, (at, bt, _, _), (aj, bj, _, _) = _bases(cohort)
    r = B.shape[1]
    at, bt, aj, bj = at[:, :r], bt[:, :r], aj[:, :r], bj[:, :r]
    steps = tbs.guard_steps(bt)
    assert steps.tolist() == tbs.guard_steps(bj).tolist()
    assert steps.tolist() == [-1] + [1] * len(MARKERS) + [-1]
    atol = 1e-6 * np.abs(at).max()
    for j, k in enumerate(steps):
        kept = slice(None) if k < 0 else slice(0, k + 1)
        np.testing.assert_allclose(at[kept, j], aj[kept, j], rtol=1e-4,
                                   atol=atol)
        np.testing.assert_allclose(bt[kept, j][: M - 1], bj[kept, j][: M - 1],
                                   rtol=1e-4, atol=atol)
        if k >= 0:
            for a, b in ((at, bt), (aj, bj)):
                assert np.all(a[k + 1:, j] == 0.0) and np.all(b[k:, j] == 0.0)
    ft = jm.krylov_fields(at, bt, None)
    fj = jm.krylov_fields(aj, bj, None)
    assert ft["guard_step"] == fj["guard_step"] == steps.tolist()
    assert ft["n_negative"] == fj["n_negative"] == 0
    assert ft["w_raw_min"] == fj["w_raw_min"] == 0.0
    np.testing.assert_allclose(ft["w_raw_low"], fj["w_raw_low"], rtol=1e-4,
                               atol=atol)


def test_the_profile_over_the_guarded_bases_is_the_jax_packages(cohort):
    """Each package's ShiftedKrylov over its own device basis on [X y]
    (the guard fired in six columns), and its _ll_from_solution on the
    debug script's δ grid with the exact log|H| shared: the port's REML
    profile is the JAX package's within max(1e-6, 8·ε·κ(δ)) of |LL|, ε
    f32's unit roundoff and κ(δ) = (λ_max + δ) / (λ_min + δ) the
    condition number of H = K + δI. That is the first-order bound of two
    f32 recurrences' roundoff carried through the solve; where κ ≤ 8 it is
    the 1e-6 that tests/test_torch_debug_fit.py holds, and at the grid's
    small end the raised top eigenvalue takes κ to ~4·10⁴ here."""
    from eagleeverything_tpu.models import bigscan as jbs
    from eagleeverything_tpu_torch.models import bigscan as tbs

    tb, jb, X, y, s0, K = cohort
    B = np.column_stack([X, y])
    skt = tbs.ShiftedKrylov(None, B, M, reorth=True, device_lanczos=(
        lambda Z, m, ro: tb.device_lanczos(Z, m, ro, s0)))
    skj = jbs.ShiftedKrylov(None, B, M, reorth=True, device_lanczos=(
        lambda Z, m, ro: jb.device_lanczos(Z, m, ro, s0)))
    assert (skt.guard_step == 1).sum() == len(MARKERS)
    lam = np.linalg.eigvalsh(K)
    eps = np.finfo(np.float32).eps / 2
    for delta in np.exp(np.linspace(-6.0, 8.0, 25)):
        logdet = float(np.sum(np.log(lam + delta)))
        got = tbs._ll_from_solution(y, X, skt.solve(delta), logdet)[0]
        want = jbs._ll_from_solution(y, X, skj.solve(delta), logdet)[0]
        kappa = (lam[-1] + delta) / (lam[0] + delta)
        assert abs(got - want) <= max(1e-6, 8 * eps * kappa) * abs(want), \
            (delta, got, want, kappa)
