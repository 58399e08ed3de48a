"""scripts/cohort_run_torch.py (BASELINE config 3 on the port) against the
JAX package's scripts/cohort_run.py, on the CPU at 600 x 9000 SNPs (the
last 4096-SNP block is short).

The JAX script's ``generate`` and ``run`` run here into a temporary
directory; its ``rescore_truth`` and ``pallas_bench`` are never called
(they write into docs/). extBIC is held at rtol 1e-3, the matrix-free
tolerance of tests/test_packed_stack.py."""

import filecmp
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, P = 600, 9000      # 9000 = 2 x 4096 + 808: a short last block
MAXIT = 3


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


crt = _load("cohort_run_torch", ROOT / "scripts" / "cohort_run_torch.py")
jcr = _load("cohort_run_jax", ROOT / "scripts" / "cohort_run.py")


def _tree(d: pathlib.Path) -> dict:
    """Every file under ``d``: path → (size, mtime)."""
    return {str(f.relative_to(d)): (f.stat().st_size, f.stat().st_mtime_ns)
            for f in d.rglob("*") if f.is_file()}


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    """(port's cohort directory, JAX script's) at N x P, each scanned by
    its own script's ``run`` (MAXIT steps)."""
    d = tmp_path_factory.mktemp("cohort")
    port, jax = d / "port", d / "jax"
    crt.generate(str(port), N, P, device="cpu")
    jcr.generate(str(jax), N, P)
    gen_bytes = {k: (port / k).read_bytes() for k in ("meta.json", "y.npy")}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX script's run turns on JAX's compilation cache
        mp.setenv("EAGLE_TPU_XLA_CACHE", str(d / "xla_cache"))
        jcr.run(str(jax), MAXIT, "matfree")
    crt.run(str(port), MAXIT, device="cpu")
    return port, jax, gen_bytes


def test_generate_writes_the_jax_scripts_bytes(cohorts):
    port, jax, gen = cohorts
    names = sorted(os.listdir(jax / "store"))
    assert sorted(os.listdir(port / "store")) == names
    assert len(names) == 9          # 8 shards and the manifest
    for name in names:
        assert filecmp.cmp(port / "store" / name, jax / "store" / name,
                           shallow=False), name
    assert gen["y.npy"] == (jax / "y.npy").read_bytes()
    meta = json.loads(gen["meta.json"])
    want = json.loads((jax / "meta.json").read_text())
    meta.pop("gen_seconds")
    want.pop("gen_seconds")
    assert meta == want
    assert meta["p"] % crt.BLOCK != 0


def test_run_selects_what_the_jax_script_selects(cohorts):
    port, jax, _ = cohorts
    got = json.loads((port / "result.json").read_text())
    want = json.loads((jax / "result.json").read_text())
    for k in want:
        assert k in got, k
    assert got["selected"] == want["selected"]
    assert got["selected"], "the scan selected nothing"
    assert all(j in want["qtl_truth"] for j in got["selected"])
    np.testing.assert_allclose(got["extbic_path"], want["extbic_path"],
                               rtol=1e-3)
    assert (got["config"], got["n"], got["p"], got["iterations"]) == (
        want["config"], want["n"], want["p"], want["iterations"])
    assert got["device"] == "cpu"
    # the CPU runs the kernels' plain versions: no launch is counted
    assert got["launches"] == {"packed_dot": 0, "packed_tdot": 0}


def test_rescore_and_warm_sweep_write_only_under_out(cohorts, tmp_path):
    """--rescore-truth, --warm-sweep and --pallas-bench write their result
    files under --out alone (the JAX script's write into docs/)."""
    port, _, _ = cohorts
    out = tmp_path / "out"
    docs, before = ROOT / "docs", _tree(ROOT / "docs")
    top = sorted(os.listdir(ROOT))
    cohort = _tree(port)
    check = crt.rescore_truth(str(port), "cpu", str(out))
    warm = crt.warm_sweep(str(port), "off", "cpu", str(out))
    bench = crt.pallas_bench(str(port), "cpu", str(out))
    assert sorted(os.listdir(out)) == ["cohort_power_check.json",
                                       "pallas_cohort_bench.json",
                                       "warm_sweep.json"]
    assert _tree(docs) == before
    assert sorted(os.listdir(ROOT)) == top
    assert _tree(port) == cohort
    selected = json.loads((port / "result.json").read_text())["selected"]
    assert check["selected"] == selected
    rows = {r["snp"]: r for r in check["truth_snps"]}
    meta = json.loads((port / "meta.json").read_text())
    assert sorted(rows) == sorted(meta["qtl_indices"])
    for j, r in rows.items():
        assert r["selected"] == (j in selected)
        assert (r["t"] == 0.0) == (j in selected)
        assert (j in selected) or np.isfinite(r["extbic_delta_if_added"])
    assert warm["selected_model"] == selected
    assert warm["candidate"] not in selected
    assert warm["sweep_stack_passes"] > 0 and warm["refit_stack_passes"] > 0
    assert json.loads((out / "warm_sweep.json").read_text()) == warm
    # on the CPU both forms are the plain versions
    assert bench["kv_rel_err"] == 0.0 and bench["stats_rel_err"] == 0.0
