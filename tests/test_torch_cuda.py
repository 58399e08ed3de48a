"""The port's CUDA kernels against their plain PyTorch versions, and the
exact engine, the device Lanczos, ``fpr4am`` and ``summary_am`` on the card
against the CPU.

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


def test_exact_uncached_passes_fit_their_reserve(cuda):
    """With no device tile cache, the exact engine's passes (MMt, the
    Lp-form sweep, an eigenbasis sweep) recode each 31 232-SNP tile anew;
    their peak beside the resident stack stays within the fixed part of
    stack_reserve, which is all a streamed stack's ring leaves free."""
    n, p = 4096, 40000
    rng = np.random.default_rng(4096)
    G = rng.integers(0, 3, size=(n, p)).astype(np.int8)
    cfg = EagleConfig(device_cache_gb=1e-6)
    sc = engine_torch.TiledScan(engine_torch.DenseTileSource(G), cfg, cuda,
                                matfree=False)
    assert not sc.cache_device and sc.tile_snps == 31232
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    fixed, per_row = engine_torch.stack_reserve(n, p, cfg, sms, False, 0,
                                                sc.tile_snps)
    assert per_row == 0
    sc._packed_stack()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    L = rng.standard_normal((n, n)).astype(np.float32)
    t = sc.sweep(L, rng.standard_normal(n), 1.0)
    sc.compute_K()
    sc.set_eigenbasis(L)
    t_eig = sc.sweep_eig(rng.standard_normal(n), np.linalg.qr(
        rng.standard_normal((n, 8)))[0], rng.standard_normal(n), 1.0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - base
    assert np.all(np.isfinite(t)) and np.all(np.isfinite(t_eig))
    assert peak <= fixed, (peak, fixed)


def _card_kernel(n: int, seed: int, device) -> "torch.Tensor":
    """W·Wᵀ/n on the card, W standard normal n × n from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    W = torch.randn((n, n), generator=g, device=device)
    return W @ W.T / n


def test_eigh_large_matches_cusolver(cuda):
    """engine_torch.eigh_large at n = 4 096 with leaves of 1 024 (two merge
    levels) against torch.linalg.eigh on the same kernel: eigenvalues
    within 1e-5 of d_max, residual and orthogonality within 10x of
    cuSOLVER's."""
    engine_torch._ieee_fp32()
    K = _card_kernel(4096, 1, cuda)
    d_lib, U_lib = torch.linalg.eigh(K)
    lib = engine_torch.eig_residuals(K, d_lib, U_lib)
    d, U = engine_torch.eigh_large(K.clone(), 1024)
    mine = engine_torch.eig_residuals(K, d, U)
    assert U.device.type == "cuda" and U.dtype == torch.float32
    gap = float(torch.max(torch.abs(d - d_lib.double()))) / float(d[-1])
    assert gap <= 1e-5, gap
    for got, ref in zip(mine, lib):
        assert got <= 10 * ref, (mine, lib)


@pytest.fixture(scope="module")
def past_the_limit():
    """eigh_basis of a kernel one past DEVICE_EIGH_MAX_N (so through
    eigh_large, counted by its stage a: a wrapper of eigh_large itself
    would hold K alive through the call) and torch.linalg.eigh of its
    leading block at the limit, with the residuals of both and
    eigh_basis's peak beside K."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    engine_torch._ieee_fp32()
    n = engine_torch.DEVICE_EIGH_MAX_N + 1
    Kd = _card_kernel(n, 2, dev)
    lim = Kd[:n - 1, :n - 1].contiguous()
    d_l, U_l = torch.linalg.eigh(lim)
    lib = engine_torch.eig_residuals(lim, d_l, U_l)
    del lim, d_l, U_l
    K = Kd.double().cpu().numpy()
    torch.cuda.empty_cache()
    calls = []
    stage_a = engine_torch._tridiagonalize
    mp = pytest.MonkeyPatch()
    mp.setattr(engine_torch, "_tridiagonalize",
               lambda *a: calls.append(a[0].shape[0]) or stage_a(*a))
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        basis = engine_torch.eigh_basis(K, EagleConfig(), dev)
        torch.cuda.synchronize()
    finally:
        mp.undo()
    peak = torch.cuda.max_memory_allocated(dev) - base
    mine = engine_torch.eig_residuals(
        Kd, torch.as_tensor(basis.d, device=dev), basis.device_basis())
    return {"n": n, "calls": calls, "lib": lib, "mine": mine, "peak": peak,
            "basis": basis}


def test_eigh_basis_past_the_limit(cuda, past_the_limit):
    """At the first n above the bisected limit eigh_basis routes by n to
    eigh_large (once), keeps U on the card, and reaches residual and
    orthogonality within 10x of cuSOLVER's at the limit."""
    r = past_the_limit
    assert r["calls"] == [r["n"]]
    assert r["basis"].host_f64 is None
    assert np.all(np.diff(r["basis"].d) >= 0)
    for got, ref in zip(r["mine"], r["lib"]):
        assert got <= 10 * ref, (r["mine"], r["lib"])


def test_eigh_large_peak_fits_the_reserve(cuda, past_the_limit):
    """eigh_basis's peak beside the rest of the scan (K uploaded, the route
    and U) stays within stack_reserve's exact-engine eigendecomposition
    term (eigh_reserve: the route's measured squares and its secular
    blocks)."""
    r = past_the_limit
    n = r["n"]
    reserve = engine_torch.eigh_reserve(n, EagleConfig())
    assert reserve > engine_torch.EIGH_SQUARES_ROUTE * 4 * n * n
    assert r["peak"] <= reserve, (r["peak"] / (4 * n * n))


@pytest.mark.parametrize("slots", [2, 3])
def test_streamed_stack_on_card_matches_resident(cuda, monkeypatch, slots):
    """The copy ring on the card: the stack forced to stream from pinned
    host memory in 1024-row chunks (1024, 1024, 953) through two or three
    slots. K·V agrees with the resident stack's to 1e-5 of its scale (K2's
    split-K groups the rows by chunk), and with itself bit for bit; the
    stat rows and MMt (the same 1024-row tiles) agree too; every pass copies
    the whole stack, and each K·V launches K1 and K2 once a chunk."""
    res, _, _, rng = _scan(1001, cuda)
    monkeypatch.setattr(
        engine_torch, "_stack_plan",
        lambda p, nw, n, device, config, tile_snps, cache_device, matfree,
        row_format:
        engine_torch.StackPlan("streamed", 1024, slots, 0, 0))
    st, _, _, _ = _scan(1001, cuda)
    assert st.stack_mode == "streamed" and st._pstack.is_pinned()
    for r in (8, 137):
        V = torch.from_numpy(rng.standard_normal((1001, r)).astype(
            np.float32)).to(cuda)
        packed.reset_launches()
        got, again = st._device_kv(V), st._device_kv(V)
        torch.cuda.synchronize()
        assert packed.LAUNCHES == {"packed_dot": 6, "packed_tdot": 6}
        assert torch.equal(got, again)
        ref = res._device_kv(V)
        scale = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= 1e-5 * scale
    A = rng.standard_normal((1001, 1 + 3 + 20))
    for got, ref in zip(st.matfree_stat_rows(A, 3, np.eye(3)),
                        res.matfree_stat_rows(A, 3, np.eye(3))):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.compute_K(), res.compute_K(), rtol=1e-5,
                               atol=1e-5)
    assert st.h2d_bytes == st.stream_passes * st.stack_info()["stack_bytes"]
    assert res.stream_passes == res.h2d_bytes == 0


@pytest.mark.parametrize("packed_store", [True, False])
def test_store_streamed_stack_on_card_matches_pinned(cuda, monkeypatch,
                                                     tmp_path, packed_store):
    """The stack read from a 3-shard store on every pass, through the two
    page-locked staging buffers, in 1024-row chunks (1024, 1024, 953, the
    first two across a shard boundary): raw 2-bit bytes, or int8 rows
    packed on the card. K·V at r = 8 and 137 equals itself over two calls
    and the pinned-streamed K·V at the same chunking bit for bit (the same
    words in each chunk), which a staging buffer refilled before its copy
    was done would break; no host stack is built."""
    from eagleeverything_tpu_torch.io.genostore import GenotypeStore
    rng = np.random.default_rng(1001)
    G = rng.integers(0, 3, size=(1001, P)).astype(np.int8)
    G[rng.random((1001, P)) < 0.03] = -9
    d = str(tmp_path / "store")
    GenotypeStore.create_from_dense(d, G, n_shards=3, packed=packed_store)
    scans = {}
    for host in ("pinned", "store"):
        monkeypatch.setattr(
            engine_torch, "_stack_plan",
            lambda p, nw, n, device, config, tile_snps, cache_device,
            matfree, row_format, host=host:
            engine_torch.StackPlan("streamed", 1024, 3, 0, 0, host=host))
        scans[host] = engine_torch.TiledScan(
            engine_torch.StoreTileSource(d), EagleConfig(snp_tile=1024),
            cuda)
    st = scans["store"]
    for r in (8, 137):
        V = torch.from_numpy(rng.standard_normal((1001, r)).astype(
            np.float32)).to(cuda)
        got, again = st._device_kv(V), st._device_kv(V)
        ref = scans["pinned"]._device_kv(V)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(got, ref)
    info = st.stack_info()
    assert st._pstack is None and info["host"] == "store"
    row = -(-1001 // 4) if packed_store else 1001
    # raw rows cross as whole words, int8 rows as they are
    assert st.h2d_bytes == st.stream_passes * P * (
        st.nw * 4 if packed_store else 1001)
    assert info["read_bytes"] == st.stream_passes * P * row
    assert 0 < info["host_bytes"] <= 2 * 1024 * max(row, st.nw * 4)
    assert all(t.is_pinned() for t in st._staging)


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


def test_exact_ops_on_card_match_cpu(cuda):
    """The exact engine's MMt and eigenbasis sweep on the card against the
    CPU: fp32 sums of up to 3001 terms in another order (≈ 3e-6 of scale),
    no TF32, and no launch of the packed-stack kernels."""
    packed.reset_launches()
    sc_g, _, _, rng = _scan(1001, cuda)
    sc_c, _, _, _ = _scan(1001, "cpu")
    Kg, Kc = sc_g.compute_K(), sc_c.compute_K()
    np.testing.assert_allclose(Kg, Kc, rtol=1e-5,
                               atol=1e-5 * np.abs(Kc).max())
    d, U = np.linalg.eigh(engine_torch.normalized_kernel(Kc))
    d = np.maximum(d, 0.0)
    sc_g.set_eigenbasis(U)
    sc_c.set_eigenbasis(U)
    X = np.column_stack([np.ones(1001), rng.standard_normal(1001)])
    y = rng.standard_normal(1001)
    s, Q, z3 = engine_torch._eig_iteration_state(d, U.T @ y, U.T @ X, 0.7, 8)
    tg, tc = sc_g.sweep_eig(s, Q, z3, 0.9), sc_c.sweep_eig(s, Q, z3, 0.9)
    np.testing.assert_allclose(tg, tc, rtol=1e-4, atol=1e-4 * tc.max())
    assert tg[5] == 0.0                 # the all-missing SNP
    assert packed.LAUNCHES == {"packed_dot": 0, "packed_tdot": 0}


@pytest.mark.parametrize("host_eigh_max_n", [8192, 8])
def test_exact_am_on_card_matches_cpu(cuda, host_eigh_max_n):
    """am(engine="jax") on the card and on the CPU select the same SNPs,
    with the eigendecomposition on the host (f64) or on the card (f32
    cuSOLVER against f32 LAPACK: a looser extBIC tolerance)."""
    from eagleeverything_tpu_torch import am
    from eagleeverything_tpu_torch.data.simulate import simulate_dataset
    sim = simulate_dataset(n=300, p=2000, n_qtl=3, seed=11,
                           missing_rate=0.02)
    cfg = EagleConfig(host_eigh_max_n=host_eigh_max_n)
    res = {d: am("y", sim.geno, {"y": sim.y}, maxit=6, engine="jax",
                 config=cfg, device=d) for d in (cuda, "cpu")}
    assert res[cuda].indices == res["cpu"].indices
    assert len(res["cpu"].indices) >= 1
    np.testing.assert_allclose(res[cuda].extbic_path, res["cpu"].extbic_path,
                               rtol=1e-6 if host_eigh_max_n == 8192 else 1e-4)


@pytest.mark.parametrize("r", [1, 2, 8, 9, 16, 17, 32, 64, 137, 145])
@pytest.mark.parametrize("kernel", ["packed_dot", "packed_tdot"])
def test_bitwise_repeatable(cuda, monkeypatch, kernel, r):
    """No float atomics: packed_dot sums each output element in one thread,
    packed_tdot adds its splits in a fixed order, so two calls on the same
    operands give the same bits at every column tiling; at r <= 32 through
    either of packed_dot's designs, the same bits."""
    _, Wp, means, rng = _scan(1001, cuda)
    rows = 1001 if kernel == "packed_dot" else P
    X = torch.from_numpy(rng.standard_normal((rows, r)).astype(np.float32)
                         ).to(cuda)
    fn = getattr(packed, kernel)
    a = fn(Wp, X, means, 1001)
    b = fn(Wp, X, means, 1001)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    if kernel == "packed_dot" and r <= 32:
        monkeypatch.setattr(packed, "k1_path", _forced("narrow"))
        c = fn(Wp, X, means, 1001)
        d = fn(Wp, X, means, 1001)
        torch.cuda.synchronize()
        for got in (c, d):
            assert torch.equal(got.view(torch.int32), a.view(torch.int32))


def _forced(design: str):
    """A k1_path that takes one packed_dot design whatever the shapes."""
    return lambda *_: design


_STACKS: dict = {}


def _random_stack(n: int, p: int, seed: int, device) -> tuple:
    """A packed stack (p, nw) of random codes as the store packs them (3%
    missing, SNP 0 all missing, code-0 pad genotypes in each row's last real
    byte, het pad bytes after it) and its row means, kept by shape."""
    key = (n, p, seed)
    if key not in _STACKS:
        rng = np.random.default_rng(seed)
        nw = packed.words_per_row(n)
        codes = np.full((p, nw * 16), 1, dtype=np.uint8)
        codes[:, n : -(-n // 4) * 4] = 0
        c = rng.integers(0, 3, size=(p, n), dtype=np.uint8)
        c[rng.random((p, n), dtype=np.float32) < 0.03] = 3
        c[0] = 3
        codes[:, :n] = c
        q = codes.reshape(p, nw * 4, 4)
        byts = q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) \
            | (q[..., 3] << 6)
        Wp = torch.from_numpy(np.ascontiguousarray(byts).view(np.int32)
                              ).to(device)
        _STACKS[key] = (Wp, packed.row_means(Wp, n))
    return _STACKS[key]


# chip_smoke.py's SHAPES_RAGGED: n no multiple of 16 (1001); p no multiple
# of any narrow row block (20 011, 3001) and below one (201)
NARROW_SHAPES = [(1001, 20011), (50000, 3001), (50000, 201)]


@pytest.mark.parametrize("shape", NARROW_SHAPES)
@pytest.mark.parametrize("r", [1, 2, 8, 9, 16, 17, 32])
def test_packed_dot_narrow_matches_wide_bits(cuda, monkeypatch, shape, r):
    """The narrow K1 keeps the wide design's arithmetic: through it,
    packed_dot(Wp, A[:, :r]) equals the first r columns of packed_dot(Wp,
    A) at 40 and 137 columns (one wide tile of 64 and one of 144) bit for
    bit, twice; the all-missing SNP's row is +0.0."""
    n, p = shape
    Wp, means = _random_stack(n, p, 7, cuda)
    g = torch.Generator(device=cuda).manual_seed(r)
    A = torch.randn((n, 137), generator=g, device=cuda)
    monkeypatch.setattr(packed, "k1_path", _forced("wide"))
    wide = [packed.packed_dot(Wp, A[:, :c].contiguous(), means, n)[:, :r]
            for c in (40, 137)]
    monkeypatch.setattr(packed, "k1_path", _forced("narrow"))
    packed.reset_launches()
    Ar = A[:, :r].contiguous()
    D = packed.packed_dot(Wp, Ar, means, n)
    again = packed.packed_dot(Wp, Ar, means, n)
    torch.cuda.synchronize()
    assert packed.K1_PATHS == {"narrow": 2, "wide": 0}
    bits = D.view(torch.int32)
    for ref in wide + [again]:
        assert torch.equal(bits, ref.contiguous().view(torch.int32))
    assert not bits[0].any()


def test_k1_path_counter_follows_the_choice(cuda):
    """Each packed_dot launch counts under the design k1_path picks for its
    shapes on this card, with the narrow tiling the library reports:
    narrow at r <= 32 once its row blocks number half the SMs, else wide."""
    lib = packed._dot_lib()
    assert all(lib.ee_packed_dot_narrow_rows(r) > 0
               for r in (1, 8, 9, 16, 17, 32))
    assert lib.ee_packed_dot_narrow_rows(33) == 0
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = 64
    rows = lib.ee_packed_dot_narrow_rows(8)
    half = rows * -(-sms // 2)
    Wp, means = _random_stack(n, half, 3, cuda)
    A = torch.randn((n, 40), device=cuda)
    packed.reset_launches()
    expected = {"narrow": 0, "wide": 0}
    for p, r in ((half, 8), (half, 40), (half - rows, 8), (half, 32)):
        packed.packed_dot(Wp[:p], A[:, :r].contiguous(), means[:p], n)
        expected[packed.k1_path(p, lib.ee_packed_dot_narrow_rows(r), sms,
                                True)] += 1
    torch.cuda.synchronize()
    assert expected["narrow"] >= 1 and expected["wide"] >= 2
    assert packed.K1_PATHS == expected
    assert packed.LAUNCHES == {"packed_dot": 4, "packed_tdot": 0}


def test_packed_dot_takes_a_misaligned_view(cuda):
    """A view of a stack from row 1 with an odd number of words a row does
    not start on a 16-byte boundary: packed_dot takes the wide design there,
    where the shapes alone would take the narrow one, and gives the bits of
    the same rows copied to a fresh, aligned stack."""
    lib = packed._dot_lib()
    n = 1001                                  # 63 words a row
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    p = lib.ee_packed_dot_narrow_rows(8) * sms + 1
    Wp, means = _random_stack(n, p, 11, cuda)
    view, m = Wp[1:], means[1:]
    assert packed.words_per_row(n) % 2 == 1 and view.data_ptr() % 16 != 0
    A = torch.randn((n, 8), device=cuda)
    packed.reset_launches()
    got = packed.packed_dot(view, A, m, n)
    ref = packed.packed_dot(view.clone(), A, m, n)
    torch.cuda.synchronize()
    assert packed.K1_PATHS == {"narrow": 1, "wide": 1}
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("r", [548, 640])
def test_packed_dot_wide_matches_plain_and_repeats(cuda, r):
    """K1 at the multi-trait widths (matfree_stat_rows_multi: 4 traits of
    1 + 8 + 128 columns, and the 640-column cap): several 144-wide column
    tiles on grid.y over one split pre-pass, against the plain version at
    1e-4 of scale and against itself bit for bit."""
    _, Wp, means, rng = _scan(1001, cuda)
    A = torch.from_numpy(rng.standard_normal((1001, r)).astype(np.float32)
                         ).to(cuda)
    D = packed.packed_dot(Wp, A, means, 1001)
    again = packed.packed_dot(Wp, A, means, 1001)
    ref = packed.packed_dot_plain(Wp, A, means, 1001)
    torch.cuda.synchronize()
    assert torch.equal(D, again)
    assert (D - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert not D[5].any()


@pytest.mark.parametrize("zidx", [False, True])
def test_device_lanczos_on_card_matches_cpu(cuda, zidx):
    """The device Lanczos on the card against the same steps on the CPU
    (plain kernel versions): z_norm at rtol 1e-6, the leading 8 α and β at
    rtol/atol 1e-3 (tests/test_packed_stack.py:107's bounds), and the
    basis's solves through ShiftedKrylov at 1e-3 of scale."""
    from eagleeverything_tpu_torch.models import bigscan
    sc_g, _, _, rng = _scan(1001, cuda)
    sc_c, _, _, _ = _scan(1001, "cpu")
    z_idx = (np.concatenate([np.arange(1001), rng.integers(0, 1001, 99)])
             if zidx else None)
    Z = rng.standard_normal((1001 if z_idx is None else 1100, 6))
    out = {}
    for name, sc in (("card", sc_g), ("cpu", sc_c)):
        out[name] = sc.device_lanczos(Z, 24, True, 900.0, z_idx=z_idx)
    (ag, bg, zg, Vg), (ac, bc, zc, _) = out["card"], out["cpu"]
    assert Vg.device.type == "cuda"
    np.testing.assert_allclose(zg, zc, rtol=1e-6)
    np.testing.assert_allclose(ag[:8, :6], ac[:8, :6], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(bg[:8, :6], bc[:8, :6], rtol=1e-3, atol=1e-3)
    sk = {}
    for name, sc in (("card", sc_g), ("cpu", sc_c)):
        ctx = bigscan.make_context(sc, Z.shape[0], s0=900.0,
                                   Z=None if z_idx is None else
                                   _incidence(z_idx, 1001))
        sk[name] = bigscan.ShiftedKrylov(ctx.kernel_matvec, Z, 24,
                                         reorth=True,
                                         device_lanczos=ctx.device_lanczos)
    ref = sk["cpu"].solve(0.5)
    np.testing.assert_allclose(sk["card"].solve(0.5), ref,
                               atol=1e-3 * np.abs(ref).max())


def _incidence(z_idx, n):
    Z = np.zeros((len(z_idx), n))
    Z[np.arange(len(z_idx)), z_idx] = 1.0
    return Z


def _workflow_data(missing_rate: float):
    from eagleeverything_tpu_torch.data.simulate import simulate_dataset
    sim = simulate_dataset(n=300, p=2000, n_qtl=3, seed=11,
                           missing_rate=missing_rate)
    return sim, {"y": sim.y, "age": sim.covariate}


def test_fpr4am_on_card_matches_cpu(cuda):
    """The same permutations pick the same candidates on the card and on
    the CPU, and their λ_crits agree: with no missing genotypes MMt is a
    sum of integers, exact in f32 at this size, and the REML that follows
    runs on the host in f64."""
    from eagleeverything_tpu_torch import fpr4am
    sim, pheno = _workflow_data(0.0)
    out = {d: fpr4am("y", sim.geno, pheno, fformula="age", numreps=8,
                     seed=1, device=d) for d in (cuda, "cpu")}
    np.testing.assert_array_equal(out[cuda]["candidates"],
                                  out["cpu"]["candidates"])
    np.testing.assert_allclose(out[cuda]["lambda_crits"],
                               out["cpu"]["lambda_crits"], rtol=1e-6)


def test_summary_matfree_on_card_matches_cpu(cuda):
    """The matrix-free summary solves by device CG over the packed stack:
    on the card it launches both kernels and agrees with the CPU's plain
    versions to the CG's f32 tolerance."""
    from eagleeverything_tpu_torch import am, summary_am
    sim, pheno = _workflow_data(0.02)
    res = am("y", sim.geno, pheno, fformula="age", maxit=6, engine="jax",
             device="cpu")
    assert res.indices
    packed.reset_launches()
    got = summary_am(res, "y", sim.geno, pheno, fformula="age", quiet=True,
                     engine="matfree", device=cuda)
    launches = dict(packed.LAUNCHES)
    ref = summary_am(res, "y", sim.geno, pheno, fformula="age", quiet=True,
                     engine="matfree", device="cpu")
    assert launches["packed_dot"] >= 1 and launches["packed_tdot"] >= 1
    for f in ("beta", "se", "pvalue"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-3, err_msg=f)
