"""The port's multi-process layer against the JAX package's.

- utils/distributed at world 3 (gloo ranks): the f64 collectives are bit
  for bit equal on every rank and to the process-order numpy sum; the SNP
  split is the JAX package's formula.
- parallel/collectives at world 2 and 4 on (1, 2), (1, 4) and (2, 2)
  meshes against the JAX package's shard_map programs on the same numpy
  inputs (its mesh over 2 or 4 of the suite's 8 virtual CPU devices):
  ``mmt_psum`` (the bound of tests/test_engine.py's shard-count test),
  ``score_and_argmax`` and ``score_and_argmax_from_T`` (t within rtol
  1e-5, the same index and max), a tie planted across two shards (the
  lower index wins), an all-masked sweep (max 0) and ``gather_column``.
- the Lp-form sweep ops (``score_tile*``, ``projector_sqrt``) and
  ``TiledScan.sweep`` / ``sweep_batched`` in one process.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from eagleeverything_tpu.api.read import GenoHandle as JaxHandle  # noqa: E402
from eagleeverything_tpu.data.simulate import simulate_dataset  # noqa: E402
from eagleeverything_tpu.models import engine_jax  # noqa: E402
from eagleeverything_tpu.ops import kernels as jk  # noqa: E402
from eagleeverything_tpu.parallel import collectives as jc  # noqa: E402
from eagleeverything_tpu.parallel import mesh as jm  # noqa: E402
from eagleeverything_tpu.utils import distributed as jdist  # noqa: E402
from eagleeverything_tpu.utils.config import (  # noqa: E402
    EagleConfig as JaxConfig)

from eagleeverything_tpu_torch.api.read import GenoHandle  # noqa: E402
from eagleeverything_tpu_torch.models import engine_torch  # noqa: E402
from eagleeverything_tpu_torch.ops import kernels  # noqa: E402
from eagleeverything_tpu_torch.utils.config import EagleConfig  # noqa: E402

from torch_ranks import assert_ranks_equal, run_ranks  # noqa: E402

N, P = 100, 512

_DIST = r"""
rng = np.random.default_rng(100 + RANK)
OUT["sum"] = distributed.allreduce_sum_f64(rng.standard_normal((4, 5)))
OUT["gather"] = distributed.allgather_f64(np.full(3, RANK + 0.5))
sizes = [3, 0, 5]
OUT["concat"] = distributed.allgather_concat_f64(
    rng.standard_normal((sizes[RANK], 2)), sizes)
OUT["varlen"] = distributed.allgather_varlen_f64(
    rng.standard_normal((RANK + 1, 2)))
for p in (512, 513):
    OUT[f"own_range{p}"] = distributed.process_snp_range(p)
    OUT[f"sizes{p}"] = distributed.local_snp_sizes(p)
"""


def test_distributed_f64_collectives_world3(tmp_path, monkeypatch):
    outs = run_ranks(_DIST, 3, tmp_path)
    shared = [{k: v for k, v in o.items() if not k.startswith("own_")}
              for o in outs]
    assert_ranks_equal(shared)
    blocks = []
    for r in range(3):
        rng = np.random.default_rng(100 + r)
        blocks.append([rng.standard_normal((4, 5)),
                       rng.standard_normal(([3, 0, 5][r], 2)),
                       rng.standard_normal((r + 1, 2))])
    want = blocks[0][0].copy()
    for r in (1, 2):
        want += blocks[r][0]
    np.testing.assert_array_equal(outs[0]["sum"], want)
    np.testing.assert_array_equal(
        outs[0]["gather"], np.stack([np.full(3, r + 0.5) for r in range(3)]))
    for key, i in (("concat", 1), ("varlen", 2)):
        np.testing.assert_array_equal(
            outs[0][key], np.concatenate([b[i] for b in blocks]))
    # the SNP split: the JAX package's own functions at world 3
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    for p in (512, 513):
        np.testing.assert_array_equal(outs[0][f"sizes{p}"],
                                      jdist.local_snp_sizes(p))
        for r in range(3):
            monkeypatch.setattr(jax, "process_index", lambda r=r: r)
            assert tuple(outs[r][f"own_range{p}"]) == \
                jdist.process_snp_range(p)


def _inputs(p_loc_tie: int) -> dict:
    sim = simulate_dataset(n=N, p=P, n_qtl=2, seed=17, h2_qtl=0.5)
    W = np.array(jk.recode_impute_tile(sim.geno.T.astype(np.int8)),
                 np.float32)
    rng = np.random.default_rng(5)
    Py = rng.standard_normal(N).astype(np.float32)
    Lp = rng.standard_normal((N, 8)).astype(np.float32) / 10
    U, _ = np.linalg.qr(rng.standard_normal((N, N)))
    Q, _ = np.linalg.qr(rng.standard_normal((N, 8)))
    mask = np.ones(P, np.float32)
    mask[[3, 200]] = 0.0
    Wtie = W.copy()
    Wtie[5] = Wtie[p_loc_tie + 5] = np.sign(Py) + (Py == 0)
    return {"W": W, "Wtie": Wtie, "Py": Py, "Lp": Lp,
            "T": (W @ U).astype(np.float32),
            "s": rng.uniform(0.5, 1.5, N).astype(np.float32),
            "Q": Q.astype(np.float32),
            "z3": rng.standard_normal(N).astype(np.float32),
            "s2g": np.float32(0.7), "mask": mask,
            "cols": np.array([3, p_loc_tie + 7, P - 1])}


_COLL = r"""
from eagleeverything_tpu_torch.parallel import collectives
from eagleeverything_tpu_torch.parallel import mesh as meshlib
shape = tuple(int(v) for v in os.environ["MESH"].split(","))
mesh = meshlib.make_mesh(shape)
with np.load(os.environ["EAGLE_TEST_IN"]) as z:
    d = {k: z[k] for k in z.files}
ns, ni = mesh.shape["snp"], mesh.shape["ind"]
pl, nl = d["W"].shape[0] // ns, d["W"].shape[1] // ni
rows = slice(mesh.coord["snp"] * pl, (mesh.coord["snp"] + 1) * pl)
cols = slice(mesh.coord["ind"] * nl, (mesh.coord["ind"] + 1) * nl)
OUT["own_coord"] = (mesh.coord["ind"], mesh.coord["snp"])


def tt(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


W, mask, s2g = tt(d["W"][rows, cols]), tt(d["mask"][rows]), tt(d["s2g"])
OUT["K"] = collectives.mmt_psum(W, mesh)
runs = {
    "sa": collectives.score_and_argmax(W, tt(d["Lp"][cols]),
                                       tt(d["Py"][cols]), s2g, mask, mesh),
    "tie": collectives.score_and_argmax(tt(d["Wtie"][rows, cols]),
                                        tt(d["Lp"][cols]), tt(d["Py"][cols]),
                                        s2g, mask, mesh),
    "masked": collectives.score_and_argmax(W, tt(d["Lp"][cols]),
                                           tt(d["Py"][cols]), s2g,
                                           torch.zeros_like(mask), mesh),
    "fromT": collectives.score_and_argmax_from_T(
        tt(d["T"][rows, cols]), tt(d["s"][cols]), tt(d["Q"][cols]),
        tt(d["z3"][cols]), s2g, mask, mesh)}
for k, (t, i, m) in runs.items():
    OUT[k + "_t"], OUT[k + "_i"], OUT[k + "_m"] = t, int(i), float(m)
OUT["rows"] = torch.stack([collectives.gather_column(W, int(j), mesh)
                           for j in d["cols"]])
"""


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)],
                         ids=["mesh1x2", "mesh1x4", "mesh2x2"])
def test_collectives_match_jax(shape, tmp_path):
    ind, snp = shape
    d = _inputs(P // snp)
    np.savez(tmp_path / "in.npz", **d)
    outs = run_ranks(_COLL, ind * snp, tmp_path,
                     env={"MESH": f"{ind},{snp}",
                          "EAGLE_TEST_IN": str(tmp_path / "in.npz")})
    assert [tuple(o["own_coord"]) for o in outs] == \
        [(r // snp, r % snp) for r in range(ind * snp)]
    assert_ranks_equal([{k: v for k, v in o.items() if k != "own_coord"}
                        for o in outs])
    got = outs[0]

    mesh = jm.make_mesh(shape)
    put = jax.device_put
    Wd = put(d["W"], jm.snp_sharding(mesh))
    K = np.asarray(jc.mmt_psum(Wd, mesh))
    np.testing.assert_allclose(got["K"], K, rtol=1e-5, atol=1e-4)
    ref = {
        "sa": jc.score_and_argmax(Wd, d["Lp"], d["Py"], d["s2g"],
                                  d["mask"], mesh),
        "tie": jc.score_and_argmax(put(d["Wtie"], jm.snp_sharding(mesh)),
                                   d["Lp"], d["Py"], d["s2g"], d["mask"],
                                   mesh),
        "masked": jc.score_and_argmax(Wd, d["Lp"], d["Py"], d["s2g"],
                                      np.zeros(P, np.float32), mesh),
        "fromT": jc.score_and_argmax_from_T(
            put(d["T"], jm.snp_sharding(mesh)), d["s"], d["Q"], d["z3"],
            d["s2g"], d["mask"], mesh)}
    for k, (t, i, m) in ref.items():
        t = np.asarray(t)
        np.testing.assert_allclose(got[k + "_t"], t, rtol=1e-5,
                                   atol=1e-5 * np.abs(t).max(), err_msg=k)
        assert int(got[k + "_i"]) == int(i), k
        assert float(got[k + "_m"]) == pytest.approx(float(m), rel=1e-5), k
        assert float(got[k + "_m"]) == got[k + "_t"][int(got[k + "_i"])], k
    # the planted tie: equal maxima in shards 0 and 1, the lower index wins
    assert int(got["tie_i"]) == 5
    assert got["tie_t"][5] == got["tie_t"][P // snp + 5]
    # nothing left to score: max 0, index 0
    assert float(got["masked_m"]) == 0.0 and int(got["masked_i"]) == 0
    for row, j in zip(got["rows"], d["cols"]):
        np.testing.assert_array_equal(row, d["W"][j])
        np.testing.assert_array_equal(
            row, np.asarray(jc.gather_column(Wd, int(j), mesh)))


# ---------------------------------------------------------------------------
# the Lp-form sweep, one process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sweep_inputs():
    sim = simulate_dataset(n=N, p=P, n_qtl=2, seed=17, h2_qtl=0.5,
                           missing_rate=0.03)
    W = np.array(jk.recode_impute_tile(sim.geno.T.astype(np.int8)),
                 np.float32)
    rng = np.random.default_rng(9)
    A = rng.standard_normal((N, N))
    Pm = (A @ A.T / N).astype(np.float32)
    return {"sim": sim, "W": W, "Pm": Pm,
            "Lp": jk.projector_sqrt(Pm.astype(np.float64)),
            "Py": rng.standard_normal(N).astype(np.float32),
            "Lps": rng.standard_normal((3, N, 6)).astype(np.float32) / 5,
            "Pys": rng.standard_normal((3, N)).astype(np.float32),
            "s2gs": np.array([0.5, 1.0, 2.0], np.float32)}


# bf16 forms: both packages round the same operands to bf16 and sum exact
# products in f32, in different orders; the JAX package states ~1e-2
# relative for its bf16 policy (ops/kernels.score_tile_bf16)
_TOL = {"score_tile": 1e-5, "score_tile_sqrt": 1e-5,
        "score_tile_sqrt_bf16": 1e-2, "score_tile_bf16": 1e-2}


@pytest.mark.parametrize("name", sorted(_TOL))
def test_score_tile_matches_jax(name, sweep_inputs):
    d = sweep_inputs
    second = d["Pm"] if name in ("score_tile", "score_tile_bf16") else \
        d["Lp"].astype(np.float32)
    ref = np.asarray(getattr(jk, name)(d["W"], second, d["Py"],
                                       np.float32(0.8)))
    got = getattr(kernels, name)(torch.from_numpy(d["W"]),
                                 torch.from_numpy(np.asarray(second)),
                                 torch.from_numpy(d["Py"]),
                                 torch.tensor(0.8)).numpy()
    np.testing.assert_allclose(got, ref, rtol=_TOL[name],
                               atol=_TOL[name] * ref.max())


def test_score_tile_batched_and_projector_sqrt_match_jax(sweep_inputs):
    d = sweep_inputs
    L = kernels.projector_sqrt(d["Pm"].astype(np.float64))
    np.testing.assert_allclose(L @ L.T, d["Pm"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(L @ L.T, d["Lp"] @ d["Lp"].T, rtol=1e-9,
                               atol=1e-12)
    ref = np.asarray(jk.score_tile_batched(d["W"], d["Lps"], d["Pys"],
                                           d["s2gs"]))
    got = kernels.score_tile_batched(
        *(torch.from_numpy(d[k]) for k in ("W", "Lps", "Pys", "s2gs")))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * ref.max())


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_tiledscan_sweep_matches_jax(compute_dtype, sweep_inputs):
    """TiledScan.sweep / sweep_batched over a 2-tile source against the
    JAX package's (tile 256 of 512 SNPs, 3% missing codes)."""
    d = sweep_inputs
    sim = d["sim"]
    jback = engine_jax.TiledScan(
        engine_jax._make_source(JaxHandle(n=N, p=P, source="<s>",
                                          geno=sim.geno), None),
        JaxConfig(snp_tile=256, compute_dtype=compute_dtype))
    pback = engine_torch.TiledScan(
        engine_torch._make_source(GenoHandle(n=N, p=P, source="<s>",
                                             geno=sim.geno), None),
        EagleConfig(snp_tile=256, compute_dtype=compute_dtype), "cpu")
    tol = 1e-5 if compute_dtype == "float32" else 1e-2
    for method, args in (("sweep", (d["Lp"], d["Py"], 0.8)),
                         ("sweep_batched", (d["Lps"], d["Pys"], d["s2gs"]))):
        ref = getattr(jback, method)(*args)
        got = getattr(pback, method)(*args)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * ref.max(),
                                   err_msg=method)
