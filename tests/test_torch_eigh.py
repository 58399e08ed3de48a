"""The exact engine's eigendecomposition above the card's library limit
(``engine_torch.eigh_large``: Householder tridiagonalisation, divide and
conquer, compact-WY back-transform) on the CPU, at small n with small
leaves and panels so that every stage and several merge levels run.

- per stage: the tridiagonal form and its Q against the matrix;
- the route against f64 LAPACK (``np.linalg.eigh``): eigenvalues within
  1e-5 of d_max, residual and orthogonality within 10x of what f32
  ``torch.linalg.eigh`` reaches on the same matrix; on a seeded Wishart
  kernel, a ``simulate_dataset`` genomic kernel and the edge cases of the
  merge (1 × 1, exact ties, a rank-deficient kernel);
- ``eigh_basis`` routed by n, against the JAX package's ``eigh_basis``
  (f32 ``jnp.linalg.eigh``): d and U·diag(1/(d+δ))·Uᵀ·y at rtol 1e-4;
- ``am(engine="jax")`` through the route against the JAX ``am()``."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import eagleeverything_tpu as ee  # noqa: E402
from eagleeverything_tpu.data.simulate import simulate_dataset  # noqa: E402
from eagleeverything_tpu.models import engine_jax  # noqa: E402
from eagleeverything_tpu.utils.config import (  # noqa: E402
    EagleConfig as JaxConfig)

import eagleeverything_tpu_torch as port  # noqa: E402
from eagleeverything_tpu_torch.models import engine_torch  # noqa: E402
from eagleeverything_tpu_torch.utils.config import EagleConfig  # noqa: E402


def _wishart(n: int, p: int, seed: int) -> np.ndarray:
    W = np.random.default_rng(seed).standard_normal((n, p))
    return W @ W.T / p


def _genomic(n: int, p: int, seed: int) -> np.ndarray:
    """The normalized kernel of a simulated cohort's W = G − 1."""
    W = simulate_dataset(n=n, p=p, seed=seed).geno.astype(np.float64) - 1.0
    return engine_torch.normalized_kernel(W @ W.T)


KERNELS = {
    "wishart": lambda: _wishart(512, 2048, 3),
    "genomic": lambda: _genomic(400, 3000, 5),
}


def _residuals(K: np.ndarray, d, U) -> tuple[float, float]:
    return engine_torch.eig_residuals(
        torch.as_tensor(K), torch.as_tensor(d, dtype=torch.float64),
        torch.as_tensor(U, dtype=torch.float64))


def _check_route(K: np.ndarray, max_n: int, nb: int) -> dict:
    """eigh_large on the f32 K against f64 LAPACK and f32 torch.linalg.eigh
    (both on the same f32 matrix)."""
    K32 = torch.as_tensor(K, dtype=torch.float32)
    K64 = K32.double().numpy()
    stats = {}
    d, U = engine_torch.eigh_large(K32.clone(), max_n, nb, stats=stats)
    assert d.dtype == torch.float64 and U.dtype == torch.float32
    assert U.shape == K.shape
    ref = np.linalg.eigh(K64)[0]
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert np.all(np.diff(d.numpy()) >= 0)
    assert np.abs(d.numpy() - ref).max() <= 1e-5 * scale
    res, orth = _residuals(K64, d, U)
    res_lib, orth_lib = _residuals(K64, *torch.linalg.eigh(K32))
    floor = 1e-7      # f32 residuals of an exact (diagonal) input are 0
    assert res <= 10 * max(res_lib, floor), (res, res_lib)
    assert orth <= 10 * max(orth_lib, floor), (orth, orth_lib)
    assert set(stats) == {"tridiagonal_s", "divide_conquer_s",
                          "back_transform_s", "last_product_s"}
    return {"res": res, "orth": orth}


@pytest.mark.parametrize("nb", [1, 7, 32])
def test_tridiagonalize_and_reflectors(nb):
    """Q·T·Qᵀ = A and QᵀQ = I for the reduction's T and its Q (the
    reflectors applied to I), at panel widths that do and do not divide
    n − 1."""
    n = 97
    A = _wishart(n, 300, 1)
    Ar = torch.as_tensor(A).clone()
    d, e, tau = engine_torch._tridiagonalize(Ar, nb)
    Q = torch.eye(n, dtype=torch.float64)
    engine_torch._apply_reflectors(Ar, tau, Q, nb)
    T = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
    np.testing.assert_allclose((Q @ T @ Q.T).numpy(), A, atol=1e-12)
    np.testing.assert_allclose((Q.T @ Q).numpy(), np.eye(n), atol=1e-13)
    # the last reflector has one entry: a sign flip (τ = 2)
    assert bool(torch.all((tau >= 1) & (tau <= 2))) and float(tau[-1]) == 2


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("max_n, nb", [(64, 16), (8, 5), (1000, 32)])
def test_eigh_large_matches_lapack(kernel, max_n, nb):
    """Leaves of 64 and of 8 (three and six merge levels) and none at all
    (one leaf: the library call on T, then the back-transform)."""
    _check_route(KERNELS[kernel](), max_n, nb)


@pytest.mark.parametrize("case", ["n1", "n2", "n3", "identity", "ties",
                                  "diagonal", "rank_deficient"])
def test_eigh_large_edge_cases(case):
    """The merge's deflation: an identity (every z deflates), exact ties
    beside a low-rank part (Givens deflation), a diagonal (ρ = 0), a
    kernel of rank 40 in 300 (a cluster at 0), and the smallest n."""
    rng = np.random.default_rng(9)
    K = {
        "n1": lambda: np.array([[2.5]]),
        "n2": lambda: _wishart(2, 8, 1),
        "n3": lambda: _wishart(3, 8, 2),
        "identity": lambda: np.eye(200),
        "ties": lambda: np.eye(300) + (lambda X: X @ X.T)(
            rng.standard_normal((300, 3))),
        "diagonal": lambda: np.diag(np.arange(256.0)),
        "rank_deficient": lambda: _wishart(300, 40, 4),
    }[case]()
    _check_route(K, 16, 8)


@pytest.fixture(scope="module", params=sorted(KERNELS))
def both_bases(request):
    """The port's eigh_basis above DEVICE_EIGH_MAX_N (patched to 64, so
    that it takes eigh_large with leaves of 64) and the JAX package's
    device eigh_basis, on one kernel."""
    K = KERNELS[request.param]()
    mp = pytest.MonkeyPatch()
    mp.setattr(engine_torch, "DEVICE_EIGH_MAX_N", 64)
    calls = []
    route = engine_torch.eigh_large
    mp.setattr(engine_torch, "eigh_large",
               lambda *a, **k: calls.append(a[1]) or route(*a, **k))
    try:
        mine = engine_torch.eigh_basis(K, EagleConfig(host_eigh_max_n=8),
                                       "cpu")
    finally:
        mp.undo()
    assert calls == [64]
    ref = engine_jax.eigh_basis(K, JaxConfig(host_eigh_max_n=8))
    return K, mine, ref


def test_eigh_basis_route_matches_jax_eigenvalues(both_bases):
    K, mine, ref = both_bases
    assert mine.host_f64 is None and ref.host_f64 is None
    np.testing.assert_allclose(mine.d, ref.d, rtol=1e-4,
                               atol=1e-4 * float(ref.d.max()))


@pytest.mark.parametrize("delta", [math.exp(-2), 1.0, math.exp(2)])
def test_eigh_basis_route_matches_jax_solves(both_bases, delta):
    """U·diag(1/(d+δ))·Uᵀ·y, which eigenvector signs do not change; rtol
    with an atol of rtol times the result's scale for the elements that
    cancel to near zero (tests/test_torch_exact.py's ``_close``)."""
    K, mine, ref = both_bases
    y = np.random.default_rng(2).standard_normal(K.shape[0])
    U_m = mine.device_basis().double().numpy()
    U_r = np.asarray(ref.device_basis(), dtype=np.float64)

    def solve(U, d):
        return U @ ((U.T @ y) / (d + delta))

    ref_y = solve(U_r, ref.d)
    np.testing.assert_allclose(solve(U_m, mine.d), ref_y, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref_y).max()))


@pytest.mark.parametrize("n, routed", [(64, False), (65, True)])
def test_eigh_basis_routes_by_n(monkeypatch, n, routed):
    """Above host_eigh_max_n: torch.linalg.eigh up to DEVICE_EIGH_MAX_N,
    eigh_large above it; no exception decides the route."""
    monkeypatch.setattr(engine_torch, "DEVICE_EIGH_MAX_N", 64)
    calls = []
    route = engine_torch.eigh_large
    monkeypatch.setattr(engine_torch, "eigh_large",
                        lambda *a, **k: calls.append(1) or route(*a, **k))
    K = _wishart(n, 4 * n, 6)
    basis = engine_torch.eigh_basis(K, EagleConfig(host_eigh_max_n=8),
                                    "cpu")
    assert bool(calls) == routed
    np.testing.assert_allclose(basis.d, np.linalg.eigh(K)[0], rtol=1e-5,
                               atol=1e-5)


def test_am_through_eigh_large_matches_jax(monkeypatch):
    """am(engine="jax") whose eigendecomposition takes eigh_large
    (DEVICE_EIGH_MAX_N patched to 64, host_eigh_max_n 8) against the JAX
    am() with its f32 device eigh: the same selections, extBIC at rtol
    1e-4 (the f32 eigenbasis's tolerance in tests/test_torch_cuda.py)."""
    sim = simulate_dataset(n=300, p=2000, n_qtl=3, seed=11,
                           missing_rate=0.02)
    monkeypatch.setattr(engine_torch, "DEVICE_EIGH_MAX_N", 64)
    calls = []
    route = engine_torch.eigh_large
    monkeypatch.setattr(engine_torch, "eigh_large",
                        lambda *a, **k: calls.append(1) or route(*a, **k))
    mine = port.am("y", sim.geno, {"y": sim.y}, maxit=6, engine="jax",
                   config=EagleConfig(host_eigh_max_n=8), device="cpu")
    ref = ee.am("y", sim.geno, {"y": sim.y}, maxit=6, engine="jax",
                config=JaxConfig(host_eigh_max_n=8))
    assert calls == [1]
    assert len(ref.indices) >= 1
    assert mine.indices == ref.indices
    np.testing.assert_allclose(mine.extbic_path, ref.extbic_path,
                               rtol=1e-4)
