"""Multi-process runs of the port (gloo ranks on 127.0.0.1) against the JAX
package and against the port's own single-process runs.

- the SNP-sharded exact engine at world 2, from memory and from a store,
  against the JAX package's sharded scan (extBIC rtol 1e-6), and at world
  4 on an (ind = 2, snp = 2) mesh against the oracle's selection
  (tests/test_engine.py's 2-axis test);
- the matrix-free engine at world 2 (MultiHostTiledScan): the collective
  device CG and Lanczos engage (one all_reduce a step) and agree with the
  host forms over the collective matvec; ``am`` matches the JAX package's
  single-process matrix-free scan (rtol 1e-3, tests/test_packed_stack.py);
- split stores (each rank's directory holds its own shard and the
  manifest only): the forced-escalation sweep, the scan, ``fpr4am`` and
  ``am_multi`` against the port in one process;
- kill and resume: rank 1 is killed once the checkpoint holds an accepted
  marker, the job restarts with ``resume=True`` and ends as the
  uninterrupted run did.

Every job runs under one deadline that kills all its ranks (torch_ranks),
and every rank's results must be bit for bit equal.
"""

import json
import os
import shutil
import subprocess
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import eagleeverything_tpu as ee  # noqa: E402
from eagleeverything_tpu.api.read import GenoHandle as JaxHandle  # noqa: E402
from eagleeverything_tpu.data.simulate import simulate_dataset  # noqa: E402
from eagleeverything_tpu.io.genostore import (  # noqa: E402
    GenotypeStore as JaxStore)
from eagleeverything_tpu.models import engine_jax, oracle  # noqa: E402

import eagleeverything_tpu_torch as port  # noqa: E402
from eagleeverything_tpu_torch.models import bigscan, engine_torch  # noqa: E402

from torch_ranks import (  # noqa: E402
    assert_ranks_equal, kill_all, run_ranks, spawn)

N, P = 100, 512

_LOAD = r"""
from eagleeverything_tpu_torch.api.read import GenoHandle
from eagleeverything_tpu_torch.models import bigscan, engine_torch
from eagleeverything_tpu_torch.utils.config import EagleConfig
with np.load(os.environ["EAGLE_TEST_IN"]) as z:
    d = {k: z[k] for k in z.files}
n, p = d["geno"].shape
store = os.environ.get(f"EAGLE_TEST_STORE_{RANK}",
                       os.environ.get("EAGLE_TEST_STORE", ""))
handle = (GenoHandle(n=n, p=p, source="<mh>", store_dir=store) if store
          else GenoHandle(n=n, p=p, source="<mh>", geno=d["geno"]))
"""


def _sim(**kw):
    kw = {"n": N, "p": P, "n_qtl": 2, "seed": 17, "h2_qtl": 0.5, **kw}
    return simulate_dataset(**kw)


def _save_inputs(tmp_path, sim, X0=None) -> dict:
    path = str(tmp_path / "in.npz")
    np.savez(path, geno=sim.geno, y=sim.y,
             X0=np.ones((sim.geno.shape[0], 1)) if X0 is None else X0)
    return {"EAGLE_TEST_IN": path}


def _split_store(tmp_path, sim) -> tuple[str, dict]:
    """The full 2-shard store and one directory a rank holding only its
    own shard and the manifest."""
    full = str(tmp_path / "full")
    JaxStore.create_from_dense(full, sim.geno, n_shards=2, packed=True)
    env = {}
    for r in (0, 1):
        d = str(tmp_path / f"rank{r}")
        os.makedirs(d)
        shutil.copy(os.path.join(full, "manifest.json"), d)
        shutil.copy(os.path.join(full, f"shard_{r:05d}.bin"), d)
        env[f"EAGLE_TEST_STORE_{r}"] = d
    return full, env


# ---------------------------------------------------------------------------
# the SNP-sharded exact engine
# ---------------------------------------------------------------------------

_SHARDED = _LOAD + r"""
mesh = os.environ.get("MESH")
cfg = EagleConfig(mesh_shape=tuple(int(v) for v in mesh.split(","))
                  if mesh else None)
res = engine_torch.forward_select(d["y"], d["X0"], handle,
                                  maxit=int(os.environ["MAXIT"]),
                                  sharded=True, config=cfg, device="cpu")
OUT["indices"], OUT["extbic"] = res.indices, res.extbic_path
OUT["t"] = np.stack(res.outlier_stats)
"""


@pytest.mark.parametrize("source", ["memory", "store"])
def test_two_rank_sharded_scan_matches_jax(source, tmp_path):
    sim = _sim()
    env = {**_save_inputs(tmp_path, sim), "MAXIT": "4"}
    jhandle = JaxHandle(n=N, p=P, source="<mh>", geno=sim.geno)
    if source == "store":
        env["EAGLE_TEST_STORE"] = str(tmp_path / "store")
        JaxStore.create_from_dense(env["EAGLE_TEST_STORE"], sim.geno,
                                   n_shards=2, packed=True)
    outs = run_ranks(_SHARDED, 2, tmp_path, env=env)
    assert_ranks_equal(outs)
    ref = engine_jax.forward_select(sim.y, np.ones((N, 1)), jhandle,
                                    maxit=4, sharded=True)
    assert list(outs[0]["indices"]) == ref.indices
    np.testing.assert_allclose(outs[0]["extbic"], ref.extbic_path,
                               rtol=1e-6)
    if source == "memory":
        # one process, no group: the same code on its one device
        one = port.am("y", sim.geno, {"y": sim.y}, engine="sharded",
                      maxit=4, device="cpu")
        assert one.indices == ref.indices
        np.testing.assert_allclose(one.extbic_path, ref.extbic_path,
                                   rtol=1e-6)


def test_sharded_scan_with_zmat_matches_jax():
    """One process, no group: the sharded engine with a repeated-records
    Zmat (its eigenbasis Zᵀ·U is records wide) against the JAX package's
    sharded scan (rtol 1e-6)."""
    sim = _sim()
    rng = np.random.default_rng(2)
    z_idx = np.concatenate([np.arange(N), rng.integers(0, N, 20)])
    Z = np.zeros((len(z_idx), N))
    Z[np.arange(len(z_idx)), z_idx] = 1.0
    y = sim.y[z_idx] + 0.3 * rng.standard_normal(len(z_idx))
    got = port.am("y", sim.geno, {"y": y}, Zmat=Z, engine="sharded",
                  maxit=3, device="cpu")
    ref = ee.am("y", sim.geno, {"y": y}, Zmat=Z, engine="sharded", maxit=3)
    assert got.indices == ref.indices
    np.testing.assert_allclose(got.extbic_path, ref.extbic_path, rtol=1e-6)


def test_sharded_scan_2x2_mesh_selects_oracle(tmp_path):
    """World 4 on an (ind = 2, snp = 2) mesh: every contraction over
    individuals is a partial summed over ``ind``; the scan must select
    the oracle's markers (tests/test_engine.py's (2, 4) mesh test)."""
    sim = simulate_dataset(n=150, p=1200, n_qtl=3, seed=11)
    X0 = np.column_stack([np.ones(150), sim.covariate - sim.covariate.mean(),
                          sim.group.astype(float)])
    env = {**_save_inputs(tmp_path, sim, X0), "MAXIT": "10", "MESH": "2,2"}
    outs = run_ranks(_SHARDED, 4, tmp_path, env=env)
    assert_ranks_equal(outs)
    ref = oracle.forward_select(sim.y, X0, sim.geno, maxit=10)
    assert list(outs[0]["indices"]) == ref.indices


_CLI = r"""
import json
from eagleeverything_tpu_torch import cli
tut = os.path.join(os.getcwd(), "examples", "tutorial")
out = os.environ["EAGLE_TEST_OUT"] + ".json"
OUT["rc"] = cli.main(["am", "--geno", os.path.join(tut, "geno.txt"),
                      "--pheno", os.path.join(tut, "pheno.txt"),
                      "--trait", "y", "--fformula", "age + sex",
                      "--maxit", "8", "--engine", "sharded", "--summary",
                      "--device", "cpu", "--json", out])
with open(out) as f:
    r = json.load(f)
OUT["indices"], OUT["extbic"] = r["indices"], r["extbic_path"]
"""


def test_cli_sharded_two_ranks(tmp_path):
    """The CLI as two ranks (its maybe_initialize joins the group the
    EAGLE_* variables name): ``--engine sharded`` selects what the JAX
    CLI's tutorial run selects (4356 then 2260), and ``--summary`` runs
    over the collective kernel."""
    outs = run_ranks(_CLI, 2, tmp_path, timeout=180)
    assert_ranks_equal(outs)
    assert int(outs[0]["rc"]) == 0
    assert list(outs[0]["indices"]) == [4356, 2260]


# ---------------------------------------------------------------------------
# the matrix-free engine over MultiHostTiledScan
# ---------------------------------------------------------------------------

_MATFREE = _LOAD + r"""
from eagleeverything_tpu_torch.api.am import am
backend = engine_torch.MultiHostTiledScan(
    engine_torch._make_source(handle, None), EagleConfig(), "cpu")
rng = np.random.default_rng(3)
B = rng.standard_normal((n, 4))
steps = backend.stack_passes
Xd = backend.device_cg(B, 0.7, 120.0, tol=1e-7)
OUT["cg_steps"] = backend.stack_passes - steps
OUT["cg_allreduces"] = backend.device_allreduces
Xh = bigscan.blocked_cg(lambda V: backend.kernel_matvec(V) / 120.0 + 0.7 * V,
                        B, tol=1e-7)
OUT["cg_rel_err"] = np.max(np.abs(Xd - Xh)) / np.max(np.abs(Xh))
Zl = rng.standard_normal((n, 3))
before = backend.device_allreduces
a, b, zn, _ = backend.device_lanczos(Zl, 12, True, 120.0)
OUT["lz_allreduces"] = backend.device_allreduces - before
ah, bh, zh, _ = bigscan._lanczos(lambda V: backend.kernel_matvec(V) / 120.0,
                                 Zl, 12, reorth=True)
OUT["lz_dev"] = np.concatenate([a[:, :3], b[:, :3]])
OUT["lz_host"] = np.concatenate([ah, bh])
res = am("y", handle, {"y": d["y"]}, engine="matfree", maxit=4,
         device="cpu")
OUT["indices"], OUT["extbic"] = res.indices, res.extbic_path
"""


def test_two_rank_matfree_scan_matches_jax(tmp_path):
    sim = _sim()
    store = str(tmp_path / "store")
    JaxStore.create_from_dense(store, sim.geno, n_shards=2, packed=True)
    env = {**_save_inputs(tmp_path, sim), "EAGLE_TEST_STORE": store}
    outs = run_ranks(_MATFREE, 2, tmp_path, env=env, timeout=240)
    assert_ranks_equal(outs)
    got = outs[0]
    # the collective device CG: one all_reduce a step, agreeing with the
    # host blocked CG over the collective f64 matvec
    # (tests/test_multihost_split_store.py's bound)
    assert got["cg_steps"] >= 1 and got["cg_allreduces"] == got["cg_steps"]
    assert got["cg_rel_err"] < 5e-4
    # the collective device Lanczos against the host f64 recurrence
    # (tests/test_torch_matfree.py's record-space bound)
    assert got["lz_allreduces"] == 12
    np.testing.assert_allclose(got["lz_dev"][:8], got["lz_host"][:8],
                               rtol=5e-4, atol=1e-4)
    ref = ee.am("y", JaxHandle(n=N, p=P, source="<mh>", store_dir=store),
                {"y": sim.y}, engine="matfree", maxit=4)
    assert list(got["indices"]) == ref.indices
    np.testing.assert_allclose(got["extbic"], ref.extbic_path, rtol=1e-3)


_SPLIT = _LOAD + r"""
from eagleeverything_tpu_torch.api.am import am_multi
from eagleeverything_tpu_torch.api.fpr import fpr4am
backend = engine_torch.scan_backend(engine_torch._make_source(handle, None),
                                    EagleConfig(), "cpu")
if WORLD > 1:
    lo, hi = backend.snp_range
    try:
        backend.global_src.column(hi if RANK == 0 else lo - 1)
        OUT["own_foreign_raises"] = 0
    except FileNotFoundError:
        OUT["own_foreign_raises"] = 1
X0 = d["X0"]
ctx = bigscan.make_context(backend, n)
fit = bigscan.reml_maximize_matfree(ctx, d["y"], X0)
_, cand, info = bigscan.score_sweep_matfree(
    ctx, backend, d["y"], X0, fit, diag_probes=16, exact_topk=2,
    column_f64=backend.column_f64)
OUT["esc_rounds"], OUT["esc_cand"] = info["escalation_rounds"], cand
res = bigscan.forward_select_matfree(
    d["y"], X0, backend, maxit=4, diag_probes=16, exact_topk=2,
    column_f64=backend.column_f64)
OUT["mf_indices"], OUT["mf_extbic"] = res.indices, res.extbic_path
pheno = {"y": d["y"], "y2": np.tanh(d["y"]) + 0.1 * np.arange(n)}
OUT["lam"] = fpr4am("y", handle, pheno, numreps=6, seed=5, engine="eig",
                    device="cpu")["lambda_crits"]
OUT["lam_mf"] = fpr4am("y", handle, pheno, numreps=3, seed=5,
                       engine="matfree", device="cpu")["lambda_crits"]
for engine in ("jax", "matfree"):
    multi = am_multi(["y", "y2"], handle, pheno, maxit=3, engine=engine,
                     device="cpu")
    for k, v in multi.items():
        OUT[f"multi_{engine}_{k}"] = np.asarray(v.indices, np.int64)
"""


def test_split_store_matches_single_process(tmp_path):
    """Two ranks over split store directories against one process over
    the whole store, the same snippet under the same settings: the
    forced-escalation sweep (diag_probes 16, exact_topk 2), the scan,
    fpr4am on both engines and am_multi on both."""
    sim = _sim()
    full, env = _split_store(tmp_path, sim)
    env.update(_save_inputs(tmp_path, sim))
    outs = run_ranks(_SPLIT, 2, tmp_path, env=env, timeout=300, tag="split")
    assert [int(o.pop("own_foreign_raises")) for o in outs] == [1, 1]
    assert_ranks_equal(outs)
    got = outs[0]
    one = run_ranks(_SPLIT, 1, tmp_path, timeout=300, tag="one",
                    env={**env, "EAGLE_TEST_STORE_0": full})[0]
    # the escalation loop ran in both (its collectives are not dead code)
    assert one["esc_rounds"] >= 1 and got["esc_rounds"] >= 1
    assert int(got["esc_cand"]) == int(one["esc_cand"])
    assert list(got["mf_indices"]) == list(one["mf_indices"])
    np.testing.assert_allclose(got["mf_extbic"], one["mf_extbic"], rtol=1e-3)
    # the eigenbasis calibration: K is an integer sum (no missing codes),
    # so the collective K, sweeps and columns reproduce λ_crit bit for bit
    np.testing.assert_array_equal(got["lam"], one["lam"])
    # the f32 Krylov sums differ in order between one and two processes
    # (tests/test_multihost_split_store.py's band)
    np.testing.assert_allclose(got["lam_mf"], one["lam_mf"], atol=2e-3)
    for key in ("multi_jax_y", "multi_jax_y2", "multi_matfree_y",
                "multi_matfree_y2"):
        assert list(got[key]) == list(one[key]), key


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------

# rank 1 parks before its next sweep once the checkpoint (which every rank
# writes, identical bytes, atomically) holds an accepted marker, and says
# so in a file: the kill below then always lands mid-scan
_PARK = r"""
import time
from eagleeverything_tpu_torch.models import bigscan, engine_torch
_state = os.path.join(os.environ["EAGLE_CKPT"], "scan_state.json")


def _parked(fn):
    def call(*a, **k):
        if RANK == 1 and os.environ.get("EAGLE_PARK") == "1" \
                and os.path.exists(_state):
            import json
            with open(_state) as f:
                if len(json.load(f)["selected"]) >= 1:
                    open(os.environ["EAGLE_PARKED"], "w").close()
                    while True:
                        time.sleep(1)
        return fn(*a, **k)
    return call


engine_torch.ShardedScan.sweep_eig = _parked(engine_torch.ShardedScan.sweep_eig)
bigscan.score_sweep_matfree_multi = _parked(
    bigscan.score_sweep_matfree_multi)
"""

_RESUME = {
    "sharded": _PARK + _LOAD + r"""
res = engine_torch.forward_select(
    d["y"], d["X0"], handle, maxit=4, fixit=True, sharded=True,
    device="cpu", ckpt_dir=os.environ["EAGLE_CKPT"],
    resume=os.environ["EAGLE_RESUME"] == "1")
OUT["indices"], OUT["extbic"] = res.indices, res.extbic_path
""",
    "matfree": _PARK + _LOAD + r"""
from eagleeverything_tpu_torch.api.am import am
res = am("y", handle, {"y": d["y"]}, engine="matfree", maxit=3, fixit=True,
         device="cpu", ckpt_dir=os.environ["EAGLE_CKPT"],
         resume=os.environ["EAGLE_RESUME"] == "1")
OUT["indices"], OUT["extbic"] = res.indices, res.extbic_path
"""}


@pytest.mark.parametrize("engine", ["sharded", "matfree"])
def test_kill_and_resume(engine, tmp_path):
    sim = _sim(n_qtl=3, seed=29, h2_qtl=0.6)
    env = _save_inputs(tmp_path, sim)
    if engine == "matfree":
        env.update(_split_store(tmp_path, sim)[1])
    code, maxit = _RESUME[engine], 4 if engine == "sharded" else 3

    def job(ckpt, resume, tag, park="0"):
        return {**env, "EAGLE_CKPT": str(tmp_path / ckpt),
                "EAGLE_RESUME": "1" if resume else "0", "EAGLE_PARK": park,
                "EAGLE_PARKED": str(tmp_path / f"{tag}.parked")}

    ref = run_ranks(code, 2, tmp_path, env=job("ckpt_ref", False, "ref"),
                    tag="ref", timeout=240)
    assert_ranks_equal(ref)
    assert len(ref[0]["indices"]) == maxit     # fixit: every iteration

    procs, _ = spawn(code, 2, tmp_path, job("ckpt", False, "cut", "1"),
                     tag="cut")
    parked = str(tmp_path / "cut.parked")
    deadline = time.monotonic() + 240
    try:
        while not os.path.exists(parked):
            assert time.monotonic() < deadline, "rank 1 never parked"
            assert all(pr.poll() is None for pr in procs), \
                "a rank ended before the kill"
            time.sleep(0.05)
        procs[1].kill()
        procs[1].wait()
        try:
            procs[0].wait(timeout=20)   # may see the lost peer and exit
        except subprocess.TimeoutExpired:
            pass                        # stranded in a collective
    finally:
        kill_all(procs)                 # SIGKILL whatever is left
    with open(tmp_path / "ckpt" / "scan_state.json") as f:
        st = json.load(f)
    assert 1 <= len(st["selected"]) < maxit
    assert st["selected"] == list(ref[0]["indices"][: len(st["selected"])])

    got = run_ranks(code, 2, tmp_path, env=job("ckpt", True, "resumed"),
                    tag="resumed", timeout=240)
    assert_ranks_equal(got)
    assert list(got[0]["indices"]) == list(ref[0]["indices"])
    np.testing.assert_allclose(got[0]["extbic"], ref[0]["extbic"],
                               rtol=1e-8 if engine == "sharded" else 1e-4)
