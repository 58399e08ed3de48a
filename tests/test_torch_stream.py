"""Out-of-core streaming: a packed stack that does not stay on the device
streams through it chunk by chunk (engine_torch.TiledScan._stack_chunks),
against the resident stack and against the JAX package's streamed path.

The gate (engine_torch._stack_plan) is forced here: on the CPU it always
keeps the stack resident, so each test replaces it with a plan of 768-row
chunks, which cuts the 2000-SNP store into three, the last one ragged
(768, 768, 464; 768 is three 256-SNP tiles, so the exact engine's tiles
fall as on the resident stack). On the CPU a chunk is a row slice of the
host stack; the copy ring runs only on a card (tests/test_torch_cuda.py,
chip_smoke.py phase 18).

Tolerances: the streamed primitives sum the same f32 terms in chunk order,
so they agree with the resident ones to rel 1e-5 (f32 roundoff of sums of
2000 terms) and with themselves bit for bit. The scans are held to the JAX
package's streamed path (``device_cache_gb=1e-6``, as
tests/test_edge_cases.py:130-165 force it) at that file's and
tests/test_packed_stack.py's tolerances: rtol 1e-3 on the matrix-free
engine (the single-trait, Zmat and multi-trait scans, and two ranks), 1e-6
on the exact one."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import eagleeverything_tpu as ee  # noqa: E402
from eagleeverything_tpu.api.read import GenoHandle as JaxHandle  # noqa: E402
from eagleeverything_tpu.data.simulate import simulate_dataset  # noqa: E402
from eagleeverything_tpu.io.genostore import (  # noqa: E402
    GenotypeStore as JaxStore)
from eagleeverything_tpu.models import engine_jax  # noqa: E402
from eagleeverything_tpu.utils.config import (  # noqa: E402
    EagleConfig as JaxConfig)

import eagleeverything_tpu_torch as port  # noqa: E402
from eagleeverything_tpu_torch.models import engine_torch  # noqa: E402
from eagleeverything_tpu_torch.utils.config import EagleConfig  # noqa: E402

from torch_ranks import assert_ranks_equal, run_ranks  # noqa: E402

N, P = 160, 2000
CHUNK = 768
# W recomputed from the stack on every exact-engine pass (no W/T cache), so
# every sweep streams; the JAX side's budget makes its TiledScan stream too
CFG = EagleConfig(snp_tile=256, device_cache_gb=1e-6)
JAX_CFG = JaxConfig(snp_tile=256, device_cache_gb=1e-6)


def _streamed_plan(rows: int, slots: int = 2):
    def plan(p, nw, n, device, config, tile_snps, cache_device, matfree,
             row_format):
        return engine_torch.StackPlan("streamed", min(rows, p), slots, 0, 0)
    return plan


@pytest.fixture
def streamed(monkeypatch):
    """Every TiledScan made in the test streams in CHUNK-row chunks."""
    monkeypatch.setattr(engine_torch, "_stack_plan", _streamed_plan(CHUNK))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("streamstore"))
    sim = simulate_dataset(n=N, p=P, n_qtl=2, seed=21, h2_qtl=0.5,
                           missing_rate=0.02)
    JaxStore.create_from_dense(d, sim.geno, n_shards=2, packed=True)
    return d, sim


@pytest.fixture(scope="module")
def scans(store):
    """(resident, streamed) TiledScans over one store."""
    d, _ = store
    res = engine_torch.TiledScan(engine_torch.StoreTileSource(d), CFG, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_torch, "_stack_plan", _streamed_plan(CHUNK))
        st = engine_torch.TiledScan(engine_torch.StoreTileSource(d), CFG,
                                    "cpu")
    assert res.stack_mode == "resident" and st.stack_mode == "streamed"
    return res, st


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.max(np.abs(got - ref)) <= rel * np.max(np.abs(ref))


def _handle(d):
    return port.GenoHandle(n=N, p=P, source="stream", store_dir=d)


def _stack_events(path):
    with open(path) as f:
        return [e for e in map(json.loads, f) if e["event"] == "stack"]


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------


def _eig_state(rng, q=8):
    s = 1.0 / np.sqrt(rng.uniform(0.5, 3.0, N))
    Q, _ = np.linalg.qr(rng.standard_normal((N, q)))
    return s, Q, rng.standard_normal(N)


def _run(scan, name, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    if name == "kernel_matvec":
        return scan.kernel_matvec(rng.standard_normal((N, 9)))
    if name == "device_kv":
        V = torch.from_numpy(rng.standard_normal((N, 8)).astype(np.float32))
        return scan._device_kv(V).numpy()
    if name == "sweep_dots":
        return scan.sweep_dots(rng.standard_normal((N, 11)))
    if name == "stat_rows":
        q, r = 3, 12
        A = np.column_stack([rng.standard_normal((N, 1 + q)),
                             rng.choice((-1.0, 1.0), size=(N, r))])
        M = rng.standard_normal((q, q))
        return np.column_stack(scan.matfree_stat_rows(A, q, M @ M.T))
    if name == "stat_rows_multi":
        qs, r = (1, 3, 9), 12
        As = [np.column_stack([rng.standard_normal((N, 1 + q)),
                               rng.choice((-1.0, 1.0), size=(N, r))])
              for q in qs]
        Ms = [np.eye(q) + 0.1 for q in qs]
        out = scan.matfree_stat_rows_multi(As, list(qs), Ms)
        return np.concatenate([np.column_stack(t) for t in out], axis=1)
    if name == "compute_K":
        return scan.compute_K()
    if name == "sweep_eig":
        U, _ = np.linalg.qr(rng.standard_normal((N, N)))
        scan.set_eigenbasis(U)
        s, Q, z3 = _eig_state(rng)
        return scan.sweep_eig(s, Q, z3, 0.6)
    raise ValueError(name)


PRIMITIVES = ["kernel_matvec", "device_kv", "sweep_dots", "stat_rows",
              "stat_rows_multi", "compute_K", "sweep_eig"]


@pytest.mark.parametrize("name", PRIMITIVES)
def test_streamed_primitive_matches_resident(scans, name):
    """Each primitive over three chunks against the resident stack (rel
    1e-5), and against itself over two calls (bitwise); every call of the
    streamed scan is whole passes through the chunks."""
    res, st = scans
    before = st.stream_passes
    got = _run(st, name)
    again = _run(st, name)
    assert st.stream_passes > before
    assert st.h2d_bytes == 0           # on the CPU a chunk is a view
    np.testing.assert_array_equal(got, again)
    _close(got, _run(res, name))


def test_streamed_stack_and_means_are_the_resident_ones(scans):
    res, st = scans
    np.testing.assert_array_equal(st._packed_stack().numpy(),
                                  res._packed_stack().numpy())
    np.testing.assert_array_equal(st._pmeans.numpy(), res._pmeans.numpy())
    chunks = [(r0, Wc.shape[0]) for r0, Wc in st._stack_chunks()]
    assert chunks == [(0, CHUNK), (CHUNK, CHUNK), (2 * CHUNK, P - 2 * CHUNK)]
    info = st.stack_info()
    assert (info["mode"], info["chunks"], info["chunk_rows"]) == (
        "streamed", 3, CHUNK)
    assert res.stack_info()["chunks"] == 1


def test_chunk_stopped_early_leaves_the_scan_usable(scans):
    """A consumer that stops inside a pass does not count it, and the next
    pass starts from the first chunk."""
    _, st = scans
    passes = st.stream_passes
    for r0, _ in st._stack_chunks():
        if r0 > 0:
            break
    assert st.stream_passes == passes
    assert [r0 for r0, _ in st._stack_chunks()] == [0, CHUNK, 2 * CHUNK]
    assert st.stream_passes == passes + 1


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


WIDE, NARROW = engine_torch.MULTI_STAT_COLS, engine_torch.KRYLOV_COLS


@pytest.mark.parametrize("matfree,spare,mode,rows,slots,width", [
    (True, 10**12, "resident", 30000, 0, WIDE),
    # the stack and the reserve at the narrow stat-row width, exactly
    (True, 30000 * (12500 + 1728), "resident", 30000, 0, NARROW),
    # room for three 2560-row tiles a slot: 3 slots of 7680 rows
    (True, 7680 * (3 * 12500 + 1728), "streamed", 7680, 3, NARROW),
    # less than one tile a slot: 128-row multiples
    (True, 1000 * (3 * 12500 + 1728), "streamed", 896, 3, NARROW),
    # three slots of 128 rows do not fit, two do
    (True, 150 * (2 * 12500 + 1728), "streamed", 128, 2, NARROW),
    # the exact engine holds nothing a stack row beyond the stack
    (False, 30000 * 12500, "resident", 30000, 0, 0),
    (False, 7680 * 3 * 12500, "streamed", 7680, 3, 0),
])
def test_stack_plan(monkeypatch, matfree, spare, mode, rows, slots, width):
    """The gate at n = 50 000 (12 500 B a stack row, 2560-SNP tiles):
    resident when the stack and the reserve fit, at the wide stat-row
    width, else at the narrow one; else the largest chunk of whole tiles
    (of 128 rows when not one tile fits) that three slots, or two, leave
    room for beside the fixed reserve at the narrow width. The exact
    engine's reserve is its own. Free memory counts what the caching
    allocator holds unallocated."""
    from types import SimpleNamespace
    n, p, cfg = 50000, 30000, EagleConfig()
    tile = cfg.resolve_snp_tile(n, p)
    fixed, per_row = engine_torch.stack_reserve(
        n, p, cfg, 132, False, NARROW if matfree else 0, tile)
    free = fixed + spare
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free - 6 * 2**20, 80 * 10**9))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: 8 * 2**20)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 2 * 2**20)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: SimpleNamespace(
                            multi_processor_count=132))
    plan = engine_torch._stack_plan(p, 12500 // 4, n, torch.device("cuda"),
                                    cfg, tile, False, matfree)
    assert tile == 2560 and per_row == (1728 if matfree else 0)
    assert (plan.mode, plan.chunk_rows, plan.slots, plan.stat_cols) == (
        mode, rows, slots, width)
    assert plan.free_bytes == free
    if width != WIDE:
        assert plan.reserve_bytes == fixed + per_row * p


def test_failed_pinned_allocation_raises(store, monkeypatch):
    """A streamed stack that cannot be page-locked is an error with its
    sizes, never a quiet fall back to pageable memory."""
    d, _ = store
    monkeypatch.setattr(engine_torch, "_stack_plan", _streamed_plan(CHUNK))
    st = engine_torch.TiledScan(engine_torch.StoreTileSource(d), CFG, "cuda")
    real = torch.empty

    def empty(*a, pin_memory=False, **k):
        if pin_memory:
            raise RuntimeError("CUDA error: out of memory")
        return real(*a, **k)

    monkeypatch.setattr(torch, "empty", empty)
    with pytest.raises(ValueError, match=r"page-locked host stack of 2000 "
                                         r"SNPs x 10 words \(0\.000 GB\)"):
        st._packed_stack()
    assert st._pstack is None


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_matfree(store):
    d, sim = store
    return ee.am("y", JaxHandle(n=N, p=P, source="stream", store_dir=d),
                 {"y": sim.y}, maxit=3, engine="matfree", config=JAX_CFG)


def test_matfree_streamed_matches_jax_streamed(store, streamed, jax_matfree,
                                               tmp_path):
    d, sim = store
    log = str(tmp_path / "scan.jsonl")
    got = port.am("y", _handle(d), {"y": sim.y}, maxit=3, engine="matfree",
                  config=CFG, device="cpu", log_jsonl=log)
    ref = jax_matfree
    assert got.indices == ref.indices and len(ref.indices) >= 1
    np.testing.assert_allclose(got.extbic_path, ref.extbic_path, rtol=1e-3)
    np.testing.assert_allclose(got.loglik_path, ref.loglik_path, rtol=1e-3)
    (ev,) = _stack_events(log)
    assert (ev["mode"], ev["chunks"], ev["chunk_rows"]) == ("streamed", 3,
                                                            CHUNK)


def test_exact_streamed_matches_jax_streamed(store, streamed):
    d, sim = store
    jb = engine_jax.TiledScan(engine_jax.StoreTileSource(d), JAX_CFG)
    assert not jb.cache_device and not jb.cache_packed_device
    X0 = np.ones((N, 1))
    ref = engine_jax.forward_select(
        sim.y, X0, JaxHandle(n=N, p=P, source="stream", store_dir=d),
        maxit=3, config=JAX_CFG)
    got = engine_torch.forward_select(sim.y, X0, _handle(d), maxit=3,
                                      config=CFG, device="cpu")
    assert got.indices == ref.indices and len(ref.indices) >= 1
    np.testing.assert_allclose(got.extbic_path, ref.extbic_path, rtol=1e-6)


def test_zmat_scan_streamed_matches_jax_and_resident(store, monkeypatch):
    """A repeated-measures one-hot Zmat: the record-space device CG and
    Lanczos over the streamed stack select what the JAX package's streamed
    scan selects, and what they select over the resident stack."""
    d, sim = store
    rng = np.random.default_rng(4)
    z_idx = np.concatenate([np.arange(N), rng.integers(0, N, 40)])
    Z = np.zeros((len(z_idx), N))
    Z[np.arange(len(z_idx)), z_idx] = 1.0
    y = sim.y[z_idx] + 0.3 * rng.standard_normal(len(z_idx))

    def scan():
        return port.am("y", _handle(d), {"y": y}, Zmat=Z, maxit=3,
                       engine="matfree", config=CFG, device="cpu")

    res = scan()
    monkeypatch.setattr(engine_torch, "_stack_plan", _streamed_plan(CHUNK))
    got = scan()
    ref = ee.am("y", JaxHandle(n=N, p=P, source="stream", store_dir=d),
                {"y": y}, Zmat=Z, maxit=3, engine="matfree", config=JAX_CFG)
    assert got.indices == ref.indices == res.indices
    assert len(ref.indices) >= 1
    np.testing.assert_allclose(got.extbic_path, ref.extbic_path, rtol=1e-3)
    np.testing.assert_allclose(got.loglik_path, ref.loglik_path, rtol=1e-3)
    np.testing.assert_allclose(got.extbic_path, res.extbic_path, rtol=1e-3)


def test_am_multi_streamed_matches_jax_and_resident(store, monkeypatch):
    d, sim = store
    rng = np.random.default_rng(6)
    pheno = {"y": sim.y, "y2": np.tanh(sim.y) + 0.5 * rng.standard_normal(N)}

    def scan():
        return port.am_multi(["y", "y2"], _handle(d), pheno, maxit=3,
                             engine="matfree", config=CFG, device="cpu")

    res = scan()
    monkeypatch.setattr(engine_torch, "_stack_plan", _streamed_plan(CHUNK))
    got = scan()
    ref = ee.am_multi(["y", "y2"], JaxHandle(n=N, p=P, source="stream",
                                              store_dir=d), pheno, maxit=3,
                      engine="matfree", config=JAX_CFG)
    assert any(r.indices for r in ref.values())
    for t in pheno:
        assert got[t].indices == ref[t].indices == res[t].indices, t
        np.testing.assert_allclose(got[t].extbic_path, ref[t].extbic_path,
                                   rtol=1e-3)
        np.testing.assert_allclose(got[t].extbic_path, res[t].extbic_path,
                                   rtol=1e-3)


_RANKS = r"""
from eagleeverything_tpu_torch.api.am import am
from eagleeverything_tpu_torch.api.read import GenoHandle
from eagleeverything_tpu_torch.models import engine_torch
from eagleeverything_tpu_torch.utils.config import EagleConfig
chunk = int(os.environ.get("EAGLE_TEST_CHUNK", "0"))
if chunk:
    def plan(p, nw, n, device, config, tile_snps, cache_device, matfree,
             row_format):
        return engine_torch.StackPlan("streamed", min(chunk, p), 2, 0, 0)
    engine_torch._stack_plan = plan
with np.load(os.environ["EAGLE_TEST_IN"]) as z:
    y = z["y"]
handle = GenoHandle(n=y.shape[0], p=int(os.environ["EAGLE_TEST_P"]),
                    source="<st>", store_dir=os.environ["EAGLE_TEST_STORE"])
backend = engine_torch.scan_backend(
    engine_torch._make_source(handle, None), EagleConfig(snp_tile=256), "cpu")
OUT["mode"] = backend.stack_mode
OUT["chunks"] = backend.stack_info()["chunks"]
res = am("y", handle, {"y": y}, engine="matfree", maxit=3,
         config=EagleConfig(snp_tile=256), device="cpu")
OUT["indices"], OUT["extbic"] = res.indices, res.extbic_path
"""


def test_two_ranks_streamed_select_what_one_process_selects(
        store, jax_matfree, tmp_path):
    """Two gloo ranks, each streaming its 1000-SNP range in 384-row chunks
    (384, 384, 232): each step's K·V sums the rank's chunks, then one
    all-reduce; the ranks agree bit for bit and select what the JAX
    package's streamed scan in one process selects, and what one port
    process over the resident stack selects."""
    d, sim = store
    inp = str(tmp_path / "in.npz")
    np.savez(inp, y=sim.y)
    env = {"EAGLE_TEST_IN": inp, "EAGLE_TEST_STORE": d,
           "EAGLE_TEST_P": str(P)}
    outs = run_ranks(_RANKS, 2, tmp_path, timeout=300,
                     env={**env, "EAGLE_TEST_CHUNK": "384"}, tag="streamed")
    assert_ranks_equal(outs)
    assert str(outs[0]["mode"]) == "streamed" and int(outs[0]["chunks"]) == 3
    one = run_ranks(_RANKS, 1, tmp_path, timeout=300, env=env, tag="one")[0]
    assert str(one["mode"]) == "resident"
    assert list(outs[0]["indices"]) == list(one["indices"])
    assert len(one["indices"]) >= 1
    np.testing.assert_allclose(outs[0]["extbic"], one["extbic"], rtol=1e-3)
    assert list(outs[0]["indices"]) == jax_matfree.indices
    np.testing.assert_allclose(outs[0]["extbic"], jax_matfree.extbic_path,
                               rtol=1e-3)
