"""A stack read from its source on every pass: when a streamed stack does
not fit ``availmem_gb`` (engine_torch._stack_plan's host decision), no host
stack is built; a reader thread fills two staging buffers from the source
(engine_torch._StoreReader, TileSource.read_rows), and each chunk goes
through the ring as a pinned stack's would — the raw 2-bit bytes of a
packed store with every individual kept, else int8 rows packed into the
stack's words (genostore.pack2_words).

As in tests/test_torch_stream.py, the gate is forced: on the CPU it always
keeps the stack resident. Most tests replace it with a plan of 768-row
chunks read from the store, which cuts the 2000-SNP, 2-shard store into
(768, 768, 464) rows, the second chunk across the shard boundary at 1000;
the gate's own decision is run with a faked card (as test_stack_plan fakes
it). On the CPU a chunk is the staging buffer itself (or its packed
words); the copies to the card run in tests/test_torch_cuda.py and
chip_smoke.py phase 19.

Tolerances: a chunk holds the resident stack's words bit for bit, so the
primitives equal the pinned-streamed scan's at the same chunking bit for
bit and the resident ones to rel 1e-5 (f32 roundoff of sums of 2000
terms). The scans are held to the JAX package's streamed path
(``device_cache_gb=1e-6``) at tests/test_torch_stream.py's tolerances:
rtol 1e-3 on the matrix-free engine, 1e-6 on the exact one. A test that
breaks the store runs its pass on a thread of its own and fails when the
pass has not returned within 60 s."""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import eagleeverything_tpu as ee  # noqa: E402
from eagleeverything_tpu.api.read import GenoHandle as JaxHandle  # noqa: E402
from eagleeverything_tpu.data.simulate import simulate_dataset  # noqa: E402
from eagleeverything_tpu.io.genostore import (  # noqa: E402
    GenotypeStore as JaxStore)
from eagleeverything_tpu.utils.config import (  # noqa: E402
    EagleConfig as JaxConfig)

import eagleeverything_tpu_torch as port  # noqa: E402
from eagleeverything_tpu_torch.io import genostore  # noqa: E402
from eagleeverything_tpu_torch.models import engine_torch  # noqa: E402
from eagleeverything_tpu_torch.utils.config import EagleConfig  # noqa: E402

from test_torch_stream import PRIMITIVES, _run  # noqa: E402
from torch_ranks import assert_ranks_equal, run_ranks  # noqa: E402

N, P = 160, 2000
CHUNK = 768
CFG = EagleConfig(snp_tile=256, device_cache_gb=1e-6)
JAX_CFG = JaxConfig(snp_tile=256, device_cache_gb=1e-6)
# a host budget below the 80 000-byte stack that holds two 768-row staging
# buffers of its raw bytes (61 440 B), and two 128-row ones of int8 rows
# (40 960 B)
SMALL = EagleConfig(snp_tile=256, device_cache_gb=1e-6, availmem_gb=7e-5)
READER = "eagle-store-reader"
LIMIT_S = 60


def _forced_plan(rows: int, host: str, slots: int = 2):
    def plan(p, nw, n, device, config, tile_snps, cache_device, matfree,
             row_format):
        return engine_torch.StackPlan("streamed", min(rows, p), slots, 0, 0,
                                      host=host)
    return plan


def _readers() -> list:
    return [t for t in threading.enumerate() if t.name == READER]


def _within(fn, seconds: float = LIMIT_S):
    """fn() on a thread of its own: its result, or what it raised; fails
    when it has not returned within ``seconds``."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:   # handed to the test below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"the pass did not return within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The cohort and its stores: 2-bit packed and int8, two shards each."""
    sim = simulate_dataset(n=N, p=P, n_qtl=2, seed=21, h2_qtl=0.5,
                           missing_rate=0.02)
    d = str(tmp_path_factory.mktemp("store2bit"))
    u = str(tmp_path_factory.mktemp("store8bit"))
    JaxStore.create_from_dense(d, sim.geno, n_shards=2, packed=True)
    JaxStore.create_from_dense(u, sim.geno, n_shards=2, packed=False)
    keep = np.sort(np.random.default_rng(3).choice(N, N - 9, replace=False))
    return {"sim": sim, "packed": d, "unpacked": u, "keep": keep}


SOURCES = ["packed", "unpacked", "keep", "dense"]


def _source(data, kind: str) -> engine_torch.TileSource:
    if kind == "packed":
        return engine_torch.StoreTileSource(data["packed"])
    if kind == "unpacked":
        return engine_torch.StoreTileSource(data["unpacked"])
    if kind == "keep":
        return engine_torch.StoreTileSource(data["packed"], data["keep"])
    return engine_torch.DenseTileSource(data["sim"].geno)


def _scan(data, kind: str, host: str, config=CFG, matfree=True):
    """A TiledScan over ``kind`` streamed in CHUNK-row chunks from ``host``
    ("store" or "pinned"), or resident (None)."""
    if host is None:
        return engine_torch.TiledScan(_source(data, kind), config, "cpu",
                                      matfree)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_torch, "_stack_plan", _forced_plan(CHUNK, host))
        return engine_torch.TiledScan(_source(data, kind), config, "cpu",
                                      matfree)


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.max(np.abs(got - ref)) <= rel * np.max(np.abs(ref))


def _handle(d):
    return port.GenoHandle(n=N, p=P, source="store", store_dir=d)


def _jax_handle(d):
    return JaxHandle(n=N, p=P, source="store", store_dir=d)


# ---------------------------------------------------------------------------
# the reader and the chunks
# ---------------------------------------------------------------------------


def test_source_row_formats(data):
    """A packed store with every individual kept gives its raw bytes, a
    range of it too; every other source gives int8 rows."""
    formats = {k: _source(data, k).row_format for k in SOURCES}
    assert formats == {"packed": "raw", "unpacked": "int8", "keep": "int8",
                       "dense": "int8"}
    rng = engine_torch.RangeTileSource(_source(data, "packed"), 900, 1700)
    assert rng.row_format == "raw"


def test_read_rows_across_the_shard_boundary(data):
    """Rows [700, 1300) cross the shard boundary at 1000: the raw bytes are
    the store's own, the pad bytes past them untouched; int8 rows are the
    genotypes (the kept ones under a mask)."""
    G = data["sim"].geno
    src = _source(data, "packed")
    nb = -(-N // 4)
    out = torch.full((600, nb + 3), 0x55, dtype=torch.uint8)
    src.read_rows(700, 1300, out)
    np.testing.assert_array_equal(out[:, :nb].numpy(),
                                  genostore.pack2(G[:, 700:1300].T))
    assert bool((out[:, nb:] == 0x55).all())
    for kind, cols in (("unpacked", G), ("keep", G[data["keep"]]),
                       ("dense", G)):
        src = _source(data, kind)
        out = torch.empty((600, src.n), dtype=torch.int8)
        src.read_rows(700, 1300, out)
        np.testing.assert_array_equal(out.numpy(), cols[:, 700:1300].T)


def test_pack2_words_are_the_stack_rows(data):
    """The device form of pack2 (here on the CPU) writes the resident
    stack's words bit for bit, 0x55 pad bytes included, into a buffer or a
    new tensor."""
    res = _scan(data, "dense", None)
    G = data["sim"].geno
    Wp = res._packed_stack()
    block = torch.from_numpy(np.ascontiguousarray(G.T[1000:1400]))
    np.testing.assert_array_equal(
        genostore.pack2_words(block, res.nw).numpy(), Wp[1000:1400].numpy())
    out = torch.zeros((400, res.nw), dtype=torch.int32)
    genostore.pack2_words(block, res.nw, out=out)
    np.testing.assert_array_equal(out.numpy(), Wp[1000:1400].numpy())


@pytest.mark.parametrize("kind", SOURCES)
def test_store_chunks_are_the_resident_rows(data, kind):
    """Each chunk read from the source holds the resident stack's rows bit
    for bit, and the means are the resident ones; no host stack is built,
    and every pass reads each row once."""
    res, st = _scan(data, kind, None), _scan(data, kind, "store")
    Wp = res._packed_stack()
    assert st._packed_stack() is None and st._pstack is None
    np.testing.assert_array_equal(st._pmeans.numpy(), res._pmeans.numpy())
    chunks = []
    for r0, Wc in st._stack_chunks():
        np.testing.assert_array_equal(Wc.numpy(),
                                      Wp[r0 : r0 + Wc.shape[0]].numpy())
        chunks.append((r0, Wc.shape[0]))
    assert chunks == [(0, CHUNK), (CHUNK, CHUNK), (2 * CHUNK, P - 2 * CHUNK)]
    info = st.stack_info()
    row = -(-st.src.n // 4) if kind == "packed" else st.src.n
    assert (info["mode"], info["host"], info["chunks"]) == ("streamed",
                                                            "store", 3)
    assert st.stream_passes == 2 and info["read_bytes"] == 2 * P * row
    assert info["read_s"] > 0 and info["h2d_bytes"] == 0
    assert info["host_bytes"] == sum(t.numel() * t.element_size()
                                     for t in st._staging)
    assert res.stack_info()["host"] == "device"
    assert not _readers()


@pytest.fixture(scope="module")
def scans(data):
    """{kind: (resident, pinned-streamed, store-streamed)} TiledScans."""
    return {kind: (_scan(data, kind, None), _scan(data, kind, "pinned"),
                   _scan(data, kind, "store"))
            for kind in ("packed", "unpacked")}


@pytest.mark.parametrize("kind", ["packed", "unpacked"])
@pytest.mark.parametrize("name", PRIMITIVES)
def test_store_primitive_matches_pinned_and_resident(scans, kind, name):
    """Each primitive over the chunks read from the store (raw bytes, or
    int8 rows packed on the host) equals the pinned-streamed scan's at the
    same chunking bit for bit, the resident one's to rel 1e-5, and itself
    over two calls."""
    res, pinned, st = scans[kind]
    before = st.stream_passes
    got = _run(st, name)
    again = _run(st, name)
    assert st.stream_passes > before and st._pstack is None
    np.testing.assert_array_equal(got, again)
    np.testing.assert_array_equal(got, _run(pinned, name))
    _close(got, _run(res, name))
    assert not _readers()


# ---------------------------------------------------------------------------
# the gate's host decision
# ---------------------------------------------------------------------------


def _fake_card(monkeypatch) -> dict:
    """The card the gate sees: 132 SMs, and ``state["free"]`` bytes free
    (set by the caller), none of them cached by the allocator."""
    from types import SimpleNamespace
    state = {}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (state["free"], 80 * 10**9))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: SimpleNamespace(
                            multi_processor_count=132))
    return state


WIDE, NARROW = engine_torch.MULTI_STAT_COLS, engine_torch.KRYLOV_COLS


@pytest.mark.parametrize("availmem,fmt,spare_rows,rows,slots,host", [
    # the 375 MB stack fits the default host budget: the pinned stack
    (8.0, "raw", 7680, 7680, 3, "pinned"),
    # exactly at the budget: still pinned
    (0.375, "raw", 7680, 7680, 3, "pinned"),
    # over it: read from the store; two staging buffers of 7680 raw rows
    # (192 MB) fit 0.2 GB, so the card's chunk stands
    (0.2, "raw", 7680, 7680, 3, "store"),
    # 0.1 GB holds two buffers of 4000 rows: the chunk shrinks to whole
    # tiles (2560)
    (0.1, "raw", 7680, 2560, 3, "store"),
    # below one tile: 128-row multiples (0.01 GB: 400 rows → 384)
    (0.01, "raw", 7680, 384, 3, "store"),
    # int8 rows: 50 000 B a staging row (0.3 GB: 3000 → 2560), and a row of
    # the card's chunk also holds its int8 slot and the pack's temporaries
    # (200 000 B), so the card's chunk is the smaller one: 1152 rows
    (0.3, "int8", 7680, 1152, 3, "store"),
    # an int8 source whose stack fits the budget is packed into it
    (8.0, "int8", 7680, 7680, 3, "pinned"),
])
def test_stack_plan_host(monkeypatch, availmem, fmt, spare_rows, rows, slots,
                         host):
    """The host decision at n = 50 000 (12 500 B a stack row, 2560-SNP
    tiles), p = 30 000 (a 375 MB stack) on a card that streams the stack in
    three slots of ``spare_rows`` rows: the whole stack in page-locked
    memory when it fits availmem_gb, else read from the store through two
    staging buffers that must fit it too."""
    n, p, nw = 50000, 30000, 3125
    cfg = EagleConfig(availmem_gb=availmem)
    tile = cfg.resolve_snp_tile(n, p)
    fixed, per_row = engine_torch.stack_reserve(n, p, cfg, 132, False,
                                                NARROW, tile)
    fixed8, per_row8 = engine_torch.stack_reserve(n, p, cfg, 132, False,
                                                  NARROW, tile, True)
    assert fixed8 == fixed and per_row8 == per_row + n + 48 * nw
    state = _fake_card(monkeypatch)
    state["free"] = fixed + spare_rows * (3 * 12500 + per_row)
    plan = engine_torch._stack_plan(p, nw, n, torch.device("cuda"), cfg,
                                    tile, False, True, fmt)
    assert (plan.mode, plan.chunk_rows, plan.slots, plan.host) == (
        "streamed", rows, slots, host)
    if host == "store":
        stage_row = 12500 if fmt == "raw" else n
        assert 2 * plan.chunk_rows * stage_row <= availmem * 1e9


def test_stack_plan_refuses_staging_over_availmem(monkeypatch):
    """Two 128-row staging buffers of raw rows (3.2 MB) over availmem_gb:
    an error with the sizes, not a quiet pinned stack."""
    n, p, nw = 50000, 30000, 3125
    cfg = EagleConfig(availmem_gb=0.003)
    tile = cfg.resolve_snp_tile(n, p)
    fixed, per_row = engine_torch.stack_reserve(n, p, cfg, 132, False,
                                                NARROW, tile)
    state = _fake_card(monkeypatch)
    state["free"] = fixed + 7680 * (3 * 12500 + per_row)
    with pytest.raises(ValueError, match=r"exceeds availmem_gb \(0\.003 GB\)"
                       r".*128 rows.*need 0\.003 GB"):
        engine_torch._stack_plan(p, nw, n, torch.device("cuda"), cfg, tile,
                                 False, True, "raw")


@pytest.mark.parametrize("kind", SOURCES)
def test_gate_reads_the_store_within_availmem(data, kind, monkeypatch):
    """The gate's own decision, on a faked card that streams the stack, for
    a 80 000-byte stack over a 70 000-byte host budget: every source is
    read from the store (768-row chunks of raw bytes, 128 of int8 rows), no
    host stack exists, the scan holds at most availmem_gb of staging, and
    K·V is the resident one."""
    real = engine_torch._stack_plan
    state = _fake_card(monkeypatch)

    def plan(p, nw, n, device, config, tile_snps, cache_device, matfree,
             row_format):
        fixed, per_row = engine_torch.stack_reserve(
            n, p, config, 132, cache_device, NARROW, tile_snps)
        state["free"] = fixed + per_row * p + p * nw * 4 - 1
        return real(p, nw, n, torch.device("cuda"), config, tile_snps,
                    cache_device, matfree, row_format)

    monkeypatch.setattr(engine_torch, "_stack_plan", plan)
    st = engine_torch.TiledScan(_source(data, kind), SMALL, "cpu")
    monkeypatch.undo()
    res = _scan(data, kind, None)
    V = np.random.default_rng(5).standard_normal((st.src.n, 8))
    _close(st.kernel_matvec(V), res.kernel_matvec(V))
    info = st.stack_info()
    assert (info["mode"], info["host"], info["chunk_rows"]) == (
        "streamed", "store", 768 if kind == "packed" else 128)
    assert st._pstack is None
    assert 0 < info["host_bytes"] <= SMALL.availmem_gb * 1e9
    assert info["stack_bytes"] > SMALL.availmem_gb * 1e9


# ---------------------------------------------------------------------------
# faults and early stops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", ["removed", "truncated"])
def test_broken_shard_raises_in_the_caller(data, tmp_path, fault):
    """A shard file removed or cut short before the second pass: the
    reader's error reaches the caller of that pass, within the time limit,
    and no reader thread is left."""
    d = str(tmp_path / "store")
    JaxStore.create_from_dense(d, data["sim"].geno, n_shards=2, packed=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_torch, "_stack_plan", _forced_plan(CHUNK, "store"))
        st = engine_torch.TiledScan(engine_torch.StoreTileSource(d), CFG,
                                    "cpu")
    V = np.random.default_rng(1).standard_normal((N, 4))
    first = _within(lambda: st.kernel_matvec(V))
    shard = os.path.join(d, "shard_00001.bin")
    if fault == "removed":
        os.remove(shard)
        err = FileNotFoundError
    else:
        os.truncate(shard, os.path.getsize(shard) // 2)
        err = ValueError
    with pytest.raises(err):
        _within(lambda: st.kernel_matvec(V))
    assert not _readers()
    assert np.all(np.isfinite(first))


def test_early_stop_leaves_no_thread_and_the_scan_usable(scans):
    """A consumer that stops inside a pass stops and joins the reader; the
    pass is not counted, and the next one is whole and right."""
    res, pinned, st = scans["packed"]
    passes = st.stream_passes
    chunks = st._stack_chunks()
    next(chunks)
    # the reader holds the second chunk and waits for the first's buffer
    assert len(_readers()) == 1
    chunks.close()
    assert not _readers() and st.stream_passes == passes
    assert [r0 for r0, _ in st._stack_chunks()] == [0, CHUNK, 2 * CHUNK]
    assert st.stream_passes == passes + 1
    V = np.random.default_rng(2).standard_normal((N, 3))
    np.testing.assert_array_equal(st.kernel_matvec(V),
                                  pinned.kernel_matvec(V))


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_matfree(data):
    return ee.am("y", _jax_handle(data["packed"]), {"y": data["sim"].y},
                 maxit=3, engine="matfree", config=JAX_CFG)


@pytest.fixture
def from_store(monkeypatch):
    """Every TiledScan made in the test reads CHUNK-row chunks from the
    store."""
    monkeypatch.setattr(engine_torch, "_stack_plan",
                        _forced_plan(CHUNK, "store"))


def _stack_events(path):
    import json
    with open(path) as f:
        return [e for e in map(json.loads, f) if e["event"] == "stack"]


def test_matfree_from_store_matches_jax_streamed(data, from_store,
                                                 jax_matfree, tmp_path):
    log = str(tmp_path / "scan.jsonl")
    got = port.am("y", _handle(data["packed"]), {"y": data["sim"].y},
                  maxit=3, engine="matfree", config=CFG, device="cpu",
                  log_jsonl=log)
    ref = jax_matfree
    assert got.indices == ref.indices and len(ref.indices) >= 1
    np.testing.assert_allclose(got.extbic_path, ref.extbic_path, rtol=1e-3)
    np.testing.assert_allclose(got.loglik_path, ref.loglik_path, rtol=1e-3)
    (ev,) = _stack_events(log)
    row = -(-N // 4)
    assert (ev["mode"], ev["host"], ev["chunks"]) == ("streamed", "store", 3)
    assert ev["read_bytes"] == ev["stream_passes"] * P * row > 0
    assert ev["host_bytes"] == 2 * CHUNK * 40
    assert not _readers()


@pytest.mark.parametrize("kind", ["packed", "unpacked"])
def test_exact_from_store_matches_jax_streamed(data, from_store, kind,
                                               tmp_path):
    """am(engine="jax") over chunks read from the store — raw bytes, or the
    int8 store packed on the host — against the JAX package's streamed
    path on the same store."""
    d, sim = data[kind], data["sim"]
    ref = ee.am("y", _jax_handle(d), {"y": sim.y}, maxit=3, engine="jax",
                config=JAX_CFG)
    log = str(tmp_path / "scan.jsonl")
    got = port.am("y", _handle(d), {"y": sim.y}, maxit=3, engine="jax",
                  config=CFG, device="cpu", log_jsonl=log)
    assert got.indices == ref.indices and len(ref.indices) >= 1
    np.testing.assert_allclose(got.extbic_path, ref.extbic_path, rtol=1e-6)
    (ev,) = _stack_events(log)
    assert (ev["host"], ev["rows"]) == (
        "store", "raw" if kind == "packed" else "int8")


def test_am_multi_from_store_matches_jax_and_resident(data, monkeypatch):
    d, sim = data["packed"], data["sim"]
    rng = np.random.default_rng(6)
    pheno = {"y": sim.y, "y2": np.tanh(sim.y) + 0.5 * rng.standard_normal(N)}

    def scan():
        return port.am_multi(["y", "y2"], _handle(d), pheno, maxit=3,
                             engine="matfree", config=CFG, device="cpu")

    res = scan()
    monkeypatch.setattr(engine_torch, "_stack_plan",
                        _forced_plan(CHUNK, "store"))
    got = scan()
    ref = ee.am_multi(["y", "y2"], _jax_handle(d), pheno, maxit=3,
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

def plan(p, nw, n, device, config, tile_snps, cache_device, matfree,
         row_format):
    return engine_torch.StackPlan("streamed", min(384, p), 2, 0, 0,
                                  host="store")
engine_torch._stack_plan = plan
with np.load(os.environ["EAGLE_TEST_IN"]) as z:
    y = z["y"]
handle = GenoHandle(n=y.shape[0], p=int(os.environ["EAGLE_TEST_P"]),
                    source="<st>", store_dir=os.environ["EAGLE_TEST_STORE"])
cfg = EagleConfig(snp_tile=256)
backend = engine_torch.scan_backend(
    engine_torch._make_source(handle, None), cfg, "cpu")
backend.sweep_dots(np.ones((y.shape[0], 1)))
info = backend.stack_info()
OUT["host"], OUT["chunks"] = info["host"], info["chunks"]
OUT["read_bytes"], OUT["range"] = info["read_bytes"], backend.snp_range
res = am("y", handle, {"y": y}, engine="matfree", maxit=3, config=cfg,
         device="cpu")
OUT["indices"], OUT["extbic"] = res.indices, res.extbic_path
"""


def test_two_ranks_read_their_ranges_from_the_store(data, jax_matfree,
                                                    tmp_path):
    """Two gloo ranks, each reading its 1000-SNP range — its own shard —
    from the store in 384-row chunks (384, 384, 232) on every pass: the
    ranks agree bit for bit, each pass reads only the rank's rows, and they
    select what the JAX package's streamed scan in one process selects."""
    inp = str(tmp_path / "in.npz")
    np.savez(inp, y=data["sim"].y)
    env = {"EAGLE_TEST_IN": inp, "EAGLE_TEST_STORE": data["packed"],
           "EAGLE_TEST_P": str(P)}
    outs = run_ranks(_RANKS, 2, tmp_path, timeout=300, env=env, tag="store")
    assert [list(o["range"]) for o in outs] == [[0, 1000], [1000, 2000]]
    for o in outs:
        o.pop("range")
    assert_ranks_equal(outs)
    assert (str(outs[0]["host"]), int(outs[0]["chunks"])) == ("store", 3)
    # the means' pass and the sweep's: 1000 rows of 40 bytes each
    assert int(outs[0]["read_bytes"]) == 2 * 1000 * (-(-N // 4))
    assert list(outs[0]["indices"]) == jax_matfree.indices
    np.testing.assert_allclose(outs[0]["extbic"], jax_matfree.extbic_path,
                               rtol=1e-3)
