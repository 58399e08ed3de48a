"""The port's packed-stack kernels (ops/packed) against the JAX package's
Pallas kernels (ops/pallas_packed, interpret mode on the CPU).

On the CPU each wrapper runs its plain PyTorch version; the same inputs,
made with numpy from a seed, go through both packages. The JAX stack is
padded to its Pallas blocks and takes its skinny operand in plane order;
the port's stack comes from ``jax_stack.stack_from_jax`` and works in
natural genotype order. Tolerances are those of tests/test_pallas_packed.py.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from eagleeverything_tpu.models import engine_jax  # noqa: E402
from eagleeverything_tpu.ops import pallas_packed as pp  # noqa: E402
from eagleeverything_tpu_torch.models import engine_torch  # noqa: E402
from eagleeverything_tpu_torch.ops import packed  # noqa: E402
from eagleeverything_tpu_torch.utils.config import EagleConfig  # noqa: E402
from jax_stack import stack_from_jax  # noqa: E402

N, P = 1000, 400          # the logical shape of tests/test_pallas_packed.py
P_PAD = pp.BLK_P


def _jax_stack(codes: np.ndarray, n: int):
    """JAX-layout stack for codes (p, n): rows padded to BLK_P, words to
    NW_BLK, pad codes het (0x55), little-endian int32 words — the
    construction of tests/test_pallas_packed.py. Returns (Wp, means (p_pad,
    1) f32, W f64 (p, n))."""
    p = codes.shape[0]
    nw = -(-packed.words_per_row(n) // pp.NW_BLK) * pp.NW_BLK
    g = codes.astype(np.float64)
    cnt = np.sum(codes != 3, axis=1)
    s = np.where(codes == 3, 0, g).sum(axis=1)
    mean = np.where(cnt > 0, s / np.maximum(cnt, 1), 1.0)
    W = np.where(codes == 3, mean[:, None], g) - 1.0
    full = np.full((P_PAD, 16 * nw), 1, dtype=np.uint8)
    full[:p, :n] = codes
    Wb = (full[:, 0::4] | (full[:, 1::4] << 2)
          | (full[:, 2::4] << 4) | (full[:, 3::4] << 6)).astype(np.uint8)
    Wp = np.ascontiguousarray(Wb).view(np.int32)
    means = np.ones((P_PAD, 1), np.float32)
    means[:p, 0] = mean
    return Wp, means, W


def _codes(rng, p: int, n: int) -> np.ndarray:
    codes = rng.integers(0, 3, size=(p, n)).astype(np.uint8)
    codes[rng.random((p, n)) < 0.03] = 3
    return codes


@pytest.fixture(scope="module")
def stacks():
    """The fixture of tests/test_pallas_packed.py (N=1000, P=400, 3%
    missing) in both layouts."""
    rng = np.random.default_rng(3)
    Wp, means, W = _jax_stack(_codes(rng, P, N), N)
    Wt, mt = stack_from_jax(Wp, means, N, P, "cpu")
    return Wp, means, W, Wt, mt


def test_stack_from_jax_layout(stacks):
    Wp, _, _, Wt, mt = stacks
    assert Wt.dtype == torch.int32 and tuple(Wt.shape) == (
        P, packed.words_per_row(N))
    assert mt.dtype == torch.float32 and tuple(mt.shape) == (P,)
    np.testing.assert_array_equal(Wt.numpy(), Wp[:P, : Wt.shape[1]])


def test_row_means_match_reference(stacks):
    Wp, means, _, Wt, _ = stacks
    ref = np.asarray(engine_jax._packed_rowmeans_jit(
        jnp.asarray(Wp), n=N, tile=256))[:P, 0]
    got = packed.row_means(Wt, N).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, means[:P, 0], rtol=1e-6)


def test_packed_dot_matches_pallas(stacks):
    Wp, means, W, Wt, mt = stacks
    rng = np.random.default_rng(1)
    A = rng.standard_normal((N, 9)).astype(np.float32)
    nw = Wp.shape[1]
    A3 = pp.to_plane(jnp.asarray(A), N, nw).reshape(pp.PLANES, nw, 9)
    ref = np.asarray(pp.packed_dot(jnp.asarray(Wp), A3, jnp.asarray(means),
                                   interpret=True))[:P]
    got = packed.packed_dot(Wt, torch.from_numpy(A), mt, N).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, W @ A, rtol=1e-5, atol=1e-4)


def test_packed_tdot_matches_pallas(stacks):
    Wp, means, W, Wt, mt = stacks
    rng = np.random.default_rng(2)
    T = np.zeros((P_PAD, 7), np.float32)
    T[:P] = rng.standard_normal((P, 7))
    nw = Wp.shape[1]
    T3 = np.asarray(pp.packed_tdot(jnp.asarray(Wp), jnp.asarray(T),
                                   jnp.asarray(means), interpret=True))
    ref = np.asarray(pp.from_plane(
        jnp.asarray(T3.reshape(pp.PLANES * nw, 7)), N, nw))
    got = packed.packed_tdot(Wt, torch.from_numpy(T[:P]), mt, N).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, W.T @ T[:P], rtol=1e-5, atol=1e-4)


def test_kernel_matvec_matches_pallas(stacks):
    Wp, means, W, Wt, mt = stacks
    rng = np.random.default_rng(4)
    V = rng.standard_normal((N, 3)).astype(np.float32)
    ref = np.asarray(pp.kernel_matvec(jnp.asarray(Wp), jnp.asarray(V),
                                      jnp.asarray(means), N, interpret=True))
    got = packed.kernel_matvec(Wt, torch.from_numpy(V), mt, N).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got, W.T @ (W @ V), rtol=1e-5, atol=1e-3)


def _ragged(n: int):
    """A stack of P SNPs at an n that is no multiple of 16, one SNP all
    missing (mean 1.0, so its W row is 0)."""
    rng = np.random.default_rng(n)
    codes = _codes(rng, P, n)
    codes[17] = 3
    Wp, means, W = _jax_stack(codes, n)
    assert means[17, 0] == 1.0 and not W[17].any()
    Wt, mt = stack_from_jax(Wp, means, n, P, "cpu")
    return rng, Wp, means, W, Wt, mt


@pytest.mark.parametrize("n", [1001, 1015])
@pytest.mark.parametrize("r", [1, 137])
def test_ragged_packed_dot_matches_pallas(n, r):
    rng, Wp, means, W, Wt, mt = _ragged(n)
    A = rng.standard_normal((n, r)).astype(np.float32)
    nw = Wp.shape[1]
    A3 = pp.to_plane(jnp.asarray(A), n, nw).reshape(pp.PLANES, nw, r)
    ref = np.asarray(pp.packed_dot(jnp.asarray(Wp), A3, jnp.asarray(means),
                                   interpret=True))[:P]
    got = packed.packed_dot(Wt, torch.from_numpy(A), mt, n).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    assert not got[17].any()


@pytest.mark.parametrize("n", [1001, 1015])
@pytest.mark.parametrize("r", [1, 137])
def test_ragged_packed_tdot_matches_pallas(n, r):
    rng, Wp, means, W, Wt, mt = _ragged(n)
    T = np.zeros((P_PAD, r), np.float32)
    T[:P] = rng.standard_normal((P, r))
    nw = Wp.shape[1]
    T3 = np.asarray(pp.packed_tdot(jnp.asarray(Wp), jnp.asarray(T),
                                   jnp.asarray(means), interpret=True))
    ref = np.asarray(pp.from_plane(
        jnp.asarray(T3.reshape(pp.PLANES * nw, r)), n, nw))
    got = packed.packed_tdot(Wt, torch.from_numpy(T[:P]), mt, n).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _split_product(W: torch.Tensor, X: torch.Tensor,
                   pieces: int) -> torch.Tensor:
    """W·X with the kernels' tensor-core numerics, in torch ops: W split
    into bf16 halves, X into ``pieces`` bf16 pieces (each the bf16 of what
    the earlier ones leave), the products W_hi·X_0 + ... + W_hi·X_{P-1} +
    W_lo·X_0 (each exact in fp32) accumulated in fp32. packed_tdot splits
    its T in 2 (bf16x3), packed_dot its A in 3."""
    w_hi = _bf16(W)
    w_lo = _bf16(W - w_hi)
    xs = []
    for _ in range(pieces):
        xs.append(_bf16(X))
        X = X - xs[-1]
    return sum(w_hi @ x for x in xs) + w_lo @ xs[0]


PIECES = {"packed_dot": 3, "packed_tdot": 2}


@pytest.mark.parametrize("r", [8, 137])
@pytest.mark.parametrize("kernel", ["packed_dot", "packed_tdot"])
def test_bf16_split_numerics(kernel, r):
    """The split products hold each kernel to 1e-4 of scale at the main
    path's contraction length — packed_dot's n = 50 000 genotypes,
    packed_tdot's p = 262 144 SNPs — with 3% missing codes and one
    all-missing SNP, whose row of packed_dot's D stays exactly 0; bf16
    W_hi·X_0 alone does not hold that tolerance."""
    n, p = (50000, 37) if kernel == "packed_dot" else (37, 262144)
    rng = np.random.default_rng(r)
    codes = _codes(rng, p, n)
    codes[11] = 3
    nw = packed.words_per_row(n)
    full = np.full((p, 16 * nw), 1, np.uint8)
    full[:, :n] = codes
    Wb = (full[:, 0::4] | (full[:, 1::4] << 2) | (full[:, 2::4] << 4)
          | (full[:, 3::4] << 6)).astype(np.uint8)
    Wp = torch.from_numpy(np.ascontiguousarray(Wb).view(np.int32))
    means = packed.row_means(Wp, n)
    assert means[11].item() == 1.0
    W = packed.recode(Wp, means, n)
    w_lo = _bf16(W - _bf16(W))
    assert not w_lo[torch.from_numpy(codes != 3)].any()  # only at missing
    rows = n if kernel == "packed_dot" else p
    X = torch.from_numpy(rng.standard_normal((rows, r)).astype(np.float32))
    if kernel == "packed_dot":
        ref = packed.packed_dot_plain(Wp, X, means, n)
    else:
        ref = packed.packed_tdot_plain(Wp, X, means, n)
        W = W.T
    scale = ref.abs().max().item()
    got = _split_product(W, X, PIECES[kernel])
    assert (got - ref).abs().max().item() <= 1e-4 * scale
    if kernel == "packed_dot":
        assert not got[11].any()
    hi_only = _bf16(W) @ _bf16(X)
    assert (hi_only - ref).abs().max().item() > 1e-4 * scale


def test_kernel_matvec_split_numerics():
    """Why packed_dot splits A in three pieces: kernel_matvec with both
    kernels' numerics emulated meets the tolerance that the card test
    test_stack_and_scan_on_card_match_cpu holds the card to (rtol 1e-4,
    atol 1e-2, at its 1001 x 3001 inputs), and with A in two pieces it
    does not. A's rounding is one vector δA, so packed_dot's error W·δA
    comes out of packed_tdot as K·δA, amplified along K's top
    eigenvectors."""
    n, p = 1001, 3001
    rng = np.random.default_rng(n)
    G = rng.integers(0, 3, size=(n, p)).astype(np.int8)
    G[rng.random((n, p)) < 0.03] = -9
    G[:, 5] = -9
    sc = engine_torch.TiledScan(engine_torch.DenseTileSource(G),
                                EagleConfig(snp_tile=1024), "cpu")
    V = rng.standard_normal((n, 16))
    ref = sc.kernel_matvec(V)
    W = packed.recode(sc._packed_stack(), sc._pmeans, n)
    X = torch.from_numpy(V).float()

    def excess(a_pieces: int) -> float:
        D = _split_product(W, X, a_pieces)
        got = _split_product(W.T, D, PIECES["packed_tdot"]).numpy()
        return float((np.abs(got - ref) - (1e-2 + 1e-4 * np.abs(ref))).max())

    assert excess(PIECES["packed_dot"]) <= 0.0
    assert excess(2) > 0.0


def test_wrappers_reject_bad_operands(stacks):
    _, _, _, Wt, mt = stacks
    A = torch.zeros((N, 4))
    with pytest.raises(ValueError, match="f32"):
        packed.packed_dot(Wt, A.double(), mt, N)
    with pytest.raises(ValueError, match="words a row"):
        packed.packed_dot(Wt, torch.zeros((N + 16, 4)), mt, N + 16)
    with pytest.raises(ValueError, match="T must be"):
        packed.packed_tdot(Wt, torch.zeros((P + 1, 4)), mt, N)
    with pytest.raises(ValueError, match="means"):
        packed.packed_dot(Wt, A, mt[:-1], N)
    with pytest.raises(ValueError, match="unsupported device"):
        packed.packed_dot(Wt.to("meta"), A.to("meta"), mt.to("meta"), N)


# the narrow packed_dot's SNP rows a block by width, as its library reports
# them (ee_packed_dot_narrow_rows; NarrowTile in csrc/packed_dot.cu): 256
# at r <= 8, 512 at r <= 16, 256 at r <= 32, none above
NARROW_ROWS = {8: 256, 16: 512, 32: 256, 33: 0, 144: 0}

# (p, r, design) on a card of 132 SMs: narrow from 66 blocks (half a wave)
K1_CHOICES = [(262144, 8, "narrow"), (262144, 32, "narrow"),
              (262144, 33, "wide"), (32768, 8, "narrow"),
              (32768, 16, "wide"), (32768, 32, "narrow"),
              (16641, 8, "narrow"), (16640, 8, "wide"),
              (33281, 16, "narrow"), (33280, 16, "wide"),
              (5000000, 144, "wide")]


@pytest.mark.parametrize("p,r,design", K1_CHOICES)
def test_k1_path_follows_the_shapes(p, r, design):
    """BASELINE config 3's 262 144 SNPs take the narrow K1 at every width
    up to 32, none above; config 4's n axis (32 768 SNPs) takes it at r = 8
    and 32 (128 blocks) but not at 16 (64 blocks of 512 rows); the edge is
    half a wave of blocks."""
    assert packed.k1_path(p, NARROW_ROWS[r], 132, True) == design


@pytest.mark.parametrize("r", [8, 16, 32, 33, 144])
@pytest.mark.parametrize("p", [16640, 262144])
def test_k1_path_keeps_a_misaligned_stack_wide(p, r):
    """A stack that does not start on a 16-byte boundary (a view from row
    k with k·nw no multiple of 4) takes the wide design at every shape."""
    assert packed.k1_path(p, NARROW_ROWS[r], 132, False) == "wide"


def test_reset_launches_clears_the_k1_paths(stacks):
    """The per-design count sits beside LAUNCHES, whose keys stay; a CPU
    call runs the plain version and counts no launch of either."""
    _, _, _, Wt, mt = stacks
    packed.K1_PATHS["narrow"] = 3
    packed.reset_launches()
    assert packed.K1_PATHS == {"narrow": 0, "wide": 0}
    assert set(packed.LAUNCHES) == {"packed_dot", "packed_tdot"}
    packed.packed_dot(Wt, torch.zeros((N, 4)), mt, N)
    assert packed.K1_PATHS == {"narrow": 0, "wide": 0}
