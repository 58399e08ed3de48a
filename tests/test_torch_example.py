"""examples/python_api_torch.py, the vignette on the port, run on the CPU:
it selects what the JAX package's ``am`` selects on the tutorial files
(4356 then 2260, as tests/test_torch_cli.py holds the CLI to), its extBIC
path within rtol 1e-6 of the JAX one (tests/test_golden.py's tolerance),
both engines agree, and its plots land in the directory it is given."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
TUT = ROOT / "examples" / "tutorial"


@pytest.fixture(scope="module")
def vignette(tmp_path_factory):
    plots = tmp_path_factory.mktemp("plots")
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "python_api_torch.py"),
         "--device", "cpu", "--plots", str(plots)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1]), plots


def test_vignette_selects_what_the_jax_package_selects(vignette):
    import eagleeverything_tpu as jee

    out, _ = vignette
    assert out["selected"] == [4356, 2260]
    assert out["matfree_selected"] == out["selected"]
    geno = jee.read_marker(str(TUT / "geno.txt"), type="text")
    pheno = jee.read_pheno(str(TUT / "pheno.txt"))
    want = jee.am(trait="y", fformula="age + sex", geno=geno, pheno=pheno,
                  maxit=8)
    assert out["selected"] == [int(j) for j in want.indices]
    np.testing.assert_allclose(out["extbic_path"], want.extbic_path,
                               rtol=1e-6)
    assert out["device"] == "cpu"
    assert 0.0 < out["lambda"] < 10.0


def test_vignette_writes_its_plots_where_it_is_told(vignette):
    out, plots = vignette
    assert out["plots"][0] == str(plots / "manhattan.html")
    for path in out["plots"]:
        assert pathlib.Path(path).parent == plots
        assert os.path.getsize(path) > 0
