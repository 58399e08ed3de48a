"""The exact engine's kernel kept on the device from the MMt to its
eigendecomposition (``forward_select``'s card route), against the host
route it replaces, on the CPU device.

The route is taken with no Z, no ``ckpt_dir``, not sharded and n above
``host_eigh_max_n`` (set low here): ``TiledScan.compute_K(on_card=True)``
hands back the raw f32 MMt, ``normalized_kernel_on_card`` normalizes it
where it lies and ``eigh_basis`` decomposes it with no upload. The f32
kernel it decomposes, and so the whole scan, must be bit for bit the host
route's. On the CPU no copy crosses a link, so the counter tests credit
every ``to_host`` as a copy from a card would be credited.

These tests import neither JAX nor the JAX package; the one marked
``cuda`` repeats the bitwise kernel on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_k_on_card.py
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from eagleeverything_tpu_torch.api.read import GenoHandle  # noqa: E402
from eagleeverything_tpu_torch.data.simulate import (  # noqa: E402
    simulate_dataset)
from eagleeverything_tpu_torch.models import engine_torch  # noqa: E402
from eagleeverything_tpu_torch.utils import logging as scanlog  # noqa: E402
from eagleeverything_tpu_torch.utils.config import EagleConfig  # noqa: E402

# below every n here, so that the card route is taken
CARD = EagleConfig(host_eigh_max_n=8)
N, P, MAXIT = 160, 1200, 4


def _scan(n: int, p: int, seed: int, device="cpu"):
    """A TiledScan over int8 genotypes with 3% missing (SNP 2 all
    missing): the imputed means make the diagonal's mean s0 a fraction."""
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 3, size=(n, p)).astype(np.int8)
    G[rng.random((n, p)) < 0.03] = -9
    G[:, 2] = -9
    return engine_torch.TiledScan(engine_torch.DenseTileSource(G),
                                  EagleConfig(snp_tile=256), device,
                                  matfree=False)


def _check_bitwise(sc, device) -> None:
    """The card route's f32 kernel against the host route's (the host f64
    normalization of compute_K, uploaded), and the divide itself: the f32
    rounding hides all but about one quotient in 2²⁹ of a divide by the
    reciprocal of s0, so the f64 raw MMt, normalized where it lies, must
    give the host's f64 quotients."""
    K_raw = sc.compute_K(on_card=True)
    n = K_raw.shape[0]
    assert K_raw.dtype == torch.float32 and K_raw.shape == (n, n)
    assert K_raw.device.type == torch.device(device).type
    host = sc.compute_K()
    assert math.frexp(float(np.mean(np.diag(host))))[0] != 0.5
    got = engine_torch.normalized_kernel_on_card(K_raw)
    assert got.dtype == torch.float32
    want = engine_torch.normalized_kernel(host)
    assert torch.equal(got, scanlog.to_device(want, device))
    got64 = engine_torch.normalized_kernel_on_card(
        torch.from_numpy(host).to(device))
    np.testing.assert_array_equal(got64.cpu().numpy(), want)


@pytest.mark.parametrize("n,seed,block", [
    (37, 1, None), (300, 2, None), (300, 3, "ragged"), (1001, 4, None),
    (1001, 5, "ragged")])
def test_card_kernel_is_the_host_routes_bit_for_bit(monkeypatch, n, seed,
                                                    block):
    """``ragged``: row blocks of a few rows, the last one short."""
    if block == "ragged":
        monkeypatch.setattr(engine_torch, "_NORM_BLOCK", 7 * n + 3)
    _check_bitwise(_scan(n, 600, seed), "cpu")


@pytest.fixture(scope="module")
def sim():
    return simulate_dataset(n=N, p=P, n_qtl=3, seed=23, missing_rate=0.02)


def _select(sim, y=None, **kw):
    n, p = sim.geno.shape
    y = sim.y if y is None else y
    return engine_torch.forward_select(
        y, np.ones((y.shape[0], 1)),
        GenoHandle(n=n, p=p, source="<k-on-card>", geno=sim.geno),
        maxit=MAXIT, device="cpu", **kw)


def test_card_route_scan_is_the_host_routes_bit_for_bit(sim, tmp_path):
    """The host route reached with a ckpt_dir, at the same
    host_eigh_max_n: the same eigendecomposition of the same f32 kernel."""
    card = _select(sim, config=CARD)
    host = _select(sim, config=CARD, ckpt_dir=str(tmp_path / "ck"))
    assert len(card.indices) >= 2
    assert card.indices == host.indices
    assert card.extbic_path == host.extbic_path
    assert card.loglik_path == host.loglik_path
    assert len(card.outlier_stats) == len(host.outlier_stats)
    for a, b in zip(card.outlier_stats, host.outlier_stats):
        np.testing.assert_array_equal(a, b)
    assert (card.delta, card.sigma2_g, card.sigma2_e) == (
        host.delta, host.sigma2_g, host.sigma2_e)


def _credit_copies(monkeypatch):
    def to_host(t):
        return scanlog.on_card(t.numpy, d2h=t.numel() * t.element_size())
    monkeypatch.setattr(scanlog, "to_host", to_host)


@pytest.mark.parametrize("route", ["card", "Z", "ckpt_dir", "host_eigh"])
def test_route_and_its_copies(sim, tmp_path, monkeypatch, route):
    """The card route opens no k_to_host or k_upload span, and the host
    reads n·4 bytes of K (its diagonal) in mmt and k_norm; every other
    route copies the whole f32 MMt, n²·4."""
    _credit_copies(monkeypatch)
    log = str(tmp_path / "scan.jsonl")
    kw = {"config": CARD, "log_jsonl": log}
    y = None
    if route == "Z":
        Z = np.kron(np.eye(N), np.ones((2, 1)))
        rng = np.random.default_rng(3)
        y = Z @ sim.y + 0.3 * rng.standard_normal(2 * N)
        kw["Z"] = Z
    elif route == "ckpt_dir":
        kw["ckpt_dir"] = str(tmp_path / "ck")
    elif route == "host_eigh":
        kw["config"] = EagleConfig()
    _select(sim, y=y, **kw)
    with open(log) as f:
        spans = [e for e in map(json.loads, f) if e["event"] == "phase"]
    names = {e["phase"] for e in spans}
    trip = sum(e["d2h_bytes"] for e in spans
               if e["phase"] in ("mmt", "k_to_host", "k_norm"))
    if route == "card":
        assert not names & {"k_to_host", "k_upload"}
        assert {"mmt", "k_norm", "eigh_solve"} <= names
        assert trip == N * 4
    else:
        assert "k_to_host" in names
        assert ("k_upload" in names) == (route != "host_eigh")
        assert trip == N * N * 4


def test_raw_mmt_is_left_as_accumulated(sim, monkeypatch):
    """What compute_K(on_card=True) handed back, as a caller holding it
    (a check that judges the MMt) finds it after the scan."""
    kept = []
    compute_K = engine_torch.TiledScan.compute_K

    def spy(self, *args, **kwargs):
        out = compute_K(self, *args, **kwargs)
        kept.append((out, out.clone()))
        return out
    monkeypatch.setattr(engine_torch.TiledScan, "compute_K", spy)
    _select(sim, config=CARD)
    (K, K_at_return), = kept
    assert isinstance(K, torch.Tensor)
    assert torch.equal(K, K_at_return)


@pytest.mark.cuda
def test_card_kernel_is_the_host_routes_bit_for_bit_on_cuda():
    """The bitwise kernel and divide on the card at n = 4 096, and the
    diagonal as the only bytes of K read to the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    n = 4096
    sc = _scan(n, 3001, 6, dev)
    _check_bitwise(sc, dev)
    K_raw = sc.compute_K(on_card=True)
    with scanlog.Phase(scanlog.ScanLogger(), "k_norm") as span:
        engine_torch.normalized_kernel_on_card(K_raw)
    assert span.d2h_bytes == n * 4
