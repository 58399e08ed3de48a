"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
without one. They import neither JAX nor the JAX package, so they run on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from eagleeverything_tpu_torch.models import engine_torch  # noqa: E402
from eagleeverything_tpu_torch.ops import packed  # noqa: E402
from eagleeverything_tpu_torch.utils.config import EagleConfig  # noqa: E402

pytestmark = pytest.mark.cuda

P = 3001


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scan(n: int, device) -> tuple:
    """A TiledScan over int8 genotypes (3% missing, SNP 5 all missing) and
    the genotypes, packed into the port's own stack on ``device``."""
    rng = np.random.default_rng(n)
    G = rng.integers(0, 3, size=(n, P)).astype(np.int8)
    G[rng.random((n, P)) < 0.03] = -9
    G[:, 5] = -9
    sc = engine_torch.TiledScan(engine_torch.DenseTileSource(G),
                                EagleConfig(snp_tile=1024), device)
    return sc, sc._packed_stack(), sc._pmeans, rng


# every column tiling of both kernels and its ragged edge: N = 8, 16, 32,
# 64 and 144, the same for both (mma_tile_width; r > 144: two tiles)
WIDTHS = [1, 2, 8, 9, 16, 17, 32, 33, 64, 65, 137, 144, 145]


@pytest.mark.parametrize("n", [1001, 1015])
@pytest.mark.parametrize("r", WIDTHS)
def test_kernels_match_plain(cuda, n, r):
    """fp32 sums in another order than the plain torch.matmul, and the
    kernels' split bf16 products (at most about 2⁻¹⁷ of each term): both far
    below 1e-4 of the result's scale. The all-missing SNP's row of D is
    exactly 0."""
    _, Wp, means, rng = _scan(n, cuda)
    A = torch.from_numpy(rng.standard_normal((n, r)).astype(np.float32)
                         ).to(cuda)
    T = torch.from_numpy(rng.standard_normal((P, r)).astype(np.float32)
                         ).to(cuda)
    cases = ((packed.packed_dot(Wp, A, means, n),
              packed.packed_dot_plain(Wp, A, means, n)),
             (packed.packed_tdot(Wp, T, means, n),
              packed.packed_tdot_plain(Wp, T, means, n)))
    torch.cuda.synchronize()
    for got, ref in cases:
        scale = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= 1e-4 * scale
    assert not cases[0][0][5].any()


def test_stack_and_scan_on_card_match_cpu(cuda):
    """The stack built on the card holds the CPU stack's words and means,
    and the backend's kernel matvec and stat rows agree with the CPU's."""
    sc_g, Wg, mg, rng = _scan(1001, cuda)
    sc_c, Wc, mc, _ = _scan(1001, "cpu")
    np.testing.assert_array_equal(Wg.cpu().numpy(), Wc.numpy())
    np.testing.assert_array_equal(mg.cpu().numpy(), mc.numpy())
    V = rng.standard_normal((1001, 16))
    np.testing.assert_allclose(sc_g.kernel_matvec(V), sc_c.kernel_matvec(V),
                               rtol=1e-4, atol=1e-2)
    A = rng.standard_normal((1001, 1 + 3 + 20))
    for got, ref in zip(sc_g.matfree_stat_rows(A, 3, np.eye(3)),
                        sc_c.matfree_stat_rows(A, 3, np.eye(3))):
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-2)


def test_launch_counts_and_repeatability(cuda):
    _, Wp, means, rng = _scan(1015, cuda)
    T = torch.from_numpy(rng.standard_normal((P, 64)).astype(np.float32)
                         ).to(cuda)
    packed.reset_launches()
    a = packed.packed_tdot(Wp, T, means, 1015)
    b = packed.packed_tdot(Wp, T, means, 1015)
    packed.kernel_matvec(Wp, a, means, 1015)
    torch.cuda.synchronize()
    assert torch.equal(a, b)          # split-K reduced in a fixed order
    assert packed.LAUNCHES == {"packed_dot": 1, "packed_tdot": 3}


@pytest.mark.parametrize("r", [2, 8, 16, 32, 64, 137, 145])
@pytest.mark.parametrize("kernel", ["packed_dot", "packed_tdot"])
def test_bitwise_repeatable(cuda, kernel, r):
    """No float atomics: packed_dot sums each output element in one thread,
    packed_tdot adds its splits in a fixed order, so two calls on the same
    operands give the same bits at every column tiling."""
    _, Wp, means, rng = _scan(1001, cuda)
    rows = 1001 if kernel == "packed_dot" else P
    X = torch.from_numpy(rng.standard_normal((rows, r)).astype(np.float32)
                         ).to(cuda)
    fn = getattr(packed, kernel)
    a = fn(Wp, X, means, 1001)
    b = fn(Wp, X, means, 1001)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
