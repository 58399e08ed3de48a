"""The port's CLI and GUI against the JAX package's, on the CPU.

- CLI: ``am --device cpu`` on the committed tutorial selects the JAX CLI's
  markers, ``simulate`` writes its files byte for byte, the error paths
  return 2, ``--profile`` writes a torch.profiler trace, and the module runs
  as ``python -m eagleeverything_tpu_torch.cli``;
- GUI: ``_plot_data`` equals the JAX package's, and a port server on the
  CPU serves tests/test_gui.py's workflow and error paths."""

import filecmp
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from eagleeverything_tpu import cli as jcli  # noqa: E402
from eagleeverything_tpu import gui as jgui  # noqa: E402
from eagleeverything_tpu.data import simulate as jsim  # noqa: E402
from eagleeverything_tpu.models.oracle import AMResult as JaxResult  # noqa: E402

from eagleeverything_tpu_torch import cli, gui  # noqa: E402
from eagleeverything_tpu_torch.models.oracle import AMResult  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUT = os.path.join(ROOT, "examples", "tutorial")
SCAN = ["--geno", os.path.join(TUT, "geno.txt"),
        "--pheno", os.path.join(TUT, "pheno.txt"), "--trait", "y",
        "--fformula", "age + sex", "--map", os.path.join(TUT, "map.txt")]


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_cli_am_tutorial_matches_jax_cli(tmp_path, capsys):
    got, ref = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert cli.main(["am", *SCAN, "--maxit", "8", "--summary", "--json",
                     got, "--plot", str(tmp_path / "p.html"),
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Summary of the 2-marker model" in out
    assert jcli.main(["am", *SCAN, "--maxit", "8", "--json", ref]) == 0
    g, r = _load(got), _load(ref)
    assert g["indices"] == r["indices"] == [4356, 2260]
    assert g["marker_names"] == r["marker_names"]
    np.testing.assert_allclose(g["extbic_path"], r["extbic_path"],
                               rtol=1e-6)
    assert os.path.getsize(str(tmp_path / "p.html")) > 1000


def test_cli_multi_trait_and_fpr(tmp_path, capsys):
    got = str(tmp_path / "multi.json")
    assert cli.main(["am", *SCAN, "--traits", "y,age", "--maxit", "3",
                     "--json", got, "--log-jsonl",
                     str(tmp_path / "log.jsonl"), "--device", "cpu"]) == 0
    payload = _load(got)
    assert set(payload) == {"y", "age"}
    assert payload["y"]["indices"][:2] == [4356, 2260]
    assert cli.main(["fpr4am", *SCAN, "--numreps", "3", "--engine", "jax",
                     "--device", "cpu"]) == 0
    assert "calibrated lambda" in capsys.readouterr().out


def test_cli_fpr4am_matfree_matches_jax_cli(capsys):
    """The calibration on the matrix-free engine through the CLI: the same
    per-permutation candidates and λ* line as the JAX CLI's."""
    argv = ["fpr4am", *SCAN, "--numreps", "2", "--seed", "3", "--engine",
            "matfree"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jcli.main(argv) == 0
    ref = capsys.readouterr().out

    def cands(out):
        return [ln.split("lambda_crit")[0] for ln in out.splitlines()
                if ln.startswith("[fpr4am:matfree]")]

    assert cands(got) == cands(ref) and len(cands(got)) == 2
    lam = [float(out.split("calibrated lambda = ")[1].split()[0])
           for out in (got, ref)]
    assert lam[0] == pytest.approx(lam[1], rel=2e-3, abs=1e-3)


@pytest.mark.parametrize("argv", [
    ["am", "--trait", "zzz"],
    ["am", "--trait", "y", "--geno", "/does/not/exist"],
    ["am", "--trait", "zzz", "--engine", "sharded"],
    ["fpr4am", "--trait", "zzz", "--engine", "matfree"],
])
def test_cli_error_paths(argv, capsys):
    """As in tests/test_api.py: a bad input ends with rc 2 and a message,
    on the sharded engine and the matrix-free calibration too."""
    base = {"--geno": os.path.join(TUT, "geno.txt"),
            "--pheno": os.path.join(TUT, "pheno.txt")}
    for flag, path in base.items():
        if flag not in argv:
            argv = argv + [flag, path]
    assert cli.main(argv + ["--device", "cpu"]) == 2
    assert "error:" in capsys.readouterr().err


def test_cli_simulate_matches_jax_cli(tmp_path):
    d_port, d_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cli.main(["simulate", "--out", d_port, "--n", "40", "--p", "300",
                     "--seed", "3"]) == 0
    assert jcli.main(["simulate", "--out", d_jax, "--n", "40", "--p", "300",
                      "--seed", "3"]) == 0
    names = ["geno.txt", "pheno.txt", "map.txt", "qtl_truth.txt"]
    assert sorted(os.listdir(d_port)) == sorted(names)
    match, mismatch, errors = filecmp.cmpfiles(d_port, d_jax, names,
                                               shallow=False)
    assert match == names, (mismatch, errors)


def test_cli_profile_writes_torch_trace(tmp_path):
    prof = str(tmp_path / "trace")
    assert cli.main(["am", *SCAN, "--maxit", "1", "--fixit", "--profile",
                     prof, "--device", "cpu"]) == 0
    trace = _load(os.path.join(prof, "trace.json"))
    assert trace["traceEvents"]


def test_cli_runs_as_module(tmp_path):
    out = str(tmp_path / "r.json")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "eagleeverything_tpu_torch.cli", "am", *SCAN,
         "--maxit", "8", "--json", out, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert _load(out)["indices"] == [4356, 2260]
    assert "jax" not in res.stderr.lower()


# ---------------------------------------------------------------------------
# the GUI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,stats", [(1000, "two"), (60000, "two"),
                                     (60000, "zero")])
def test_plot_data_matches_jax(p, stats):
    """The interactive payload, under and over its cap (priority fill when
    the whole genome is change-flagged), with and without a map."""
    rng = np.random.default_rng(p)
    outl = ([rng.uniform(0, 50, p), rng.uniform(0, 50, p)]
            if stats == "two" else [np.zeros(p)])
    kw = dict(indices=[5, 70], extbic_path=[1.0], outlier_stats=outl,
              loglik_path=[0.0], sigma2_g=1, sigma2_e=1, delta=1, n=100,
              p=p, lam_ebic=1.0)
    chrom = np.repeat(np.arange(1, 5), -(-p // 4))[:p]

    class Map:
        marker_names = [f"m{j}" for j in range(p)]
        pos = np.arange(p) * 7 % 100003
    Map.chrom = chrom
    for m in (None, Map):
        got = gui._plot_data(AMResult(**kw), m, max_points=20000)
        ref = jgui._plot_data(JaxResult(**kw), m, max_points=20000)
        assert got == ref
        assert len(got["x"]) <= 20002 and max(got["rank"]) == 2
    assert gui.render_manhattan_html(got, "t") == \
        jgui.render_manhattan_html(ref, "t")


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _wait(url):
    for _ in range(240):
        st = json.loads(_get(url))
        if not st["running"]:
            return st
        time.sleep(0.5)
    raise AssertionError(f"{url} still running")


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("guidata"))
    jsim.write_tutorial(d, n=100, p=500, seed=4)
    srv = gui.open_gui(port=0, open_browser=False, block=False, device="cpu")
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield base, d
    srv.shutdown()
    srv.server_close()


def _read(base, d, **extra):
    return _post(base + "/api/read", {
        "geno": os.path.join(d, "geno.txt"), "gtype": "text",
        "pheno": os.path.join(d, "pheno.txt"), **extra})


def test_gui_full_workflow(server):
    base, d = server
    page = _get(base + "/")
    assert b"eagle-tpu" in page and b"Run AM" in page
    r = _read(base, d, map=os.path.join(d, "map.txt"))
    assert r["genotypes"].startswith("100 individuals")
    assert _post(base + "/api/am", {"trait": "y", "fformula": "age + sex",
                                    "maxit": "5", "lam": "1.0"})["started"]
    st = _wait(base + "/api/status")
    assert st["error"] is None, st
    assert st["result"]["indices"], "the tutorial scan selects markers"
    assert st["log"][-1].startswith("done:")
    s = json.loads(_get(base + "/api/summary"))
    assert len(s["pvalue"]) == len(st["result"]["indices"])
    pd = json.loads(_get(base + "/api/plotdata"))
    assert len(pd["x"]) == len(pd["t"]) == len(pd["name"]) \
        == len(pd["rank"]) == len(pd["change_it"])
    assert max(pd["rank"]) == len(st["result"]["indices"])
    assert pd["tick_labels"]


def test_gui_plot_png(server):
    pytest.importorskip("matplotlib")
    base, d = server
    _read(base, d)
    _post(base + "/api/am", {"trait": "y", "maxit": "3"})
    assert _wait(base + "/api/status")["error"] is None
    png = _get(base + "/api/plot.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


def test_gui_error_paths(server):
    base, _ = server
    r = _post(base + "/api/read", {"geno": "/nope", "pheno": "/nope"})
    assert "error" in r
    with pytest.raises(urllib.error.HTTPError):
        _get(base + "/api/nothing")


def test_gui_fpr_endpoint(server):
    base, d = server
    _read(base, d)
    r = _post(base + "/api/fpr", {"trait": "y", "numreps": "4"})
    assert r.get("started"), r
    st = _wait(base + "/api/fpr_status")
    assert st["error"] is None, st
    assert st["result"]["lambda"] >= 0.0
    assert len(st["result"]["lambda_crits"]) == 4


def test_gui_multi_trait_endpoint(server):
    base, d = server
    _read(base, d)
    r = _post(base + "/api/multi", {"traits": "y,age", "maxit": "3"})
    assert r.get("started"), r
    st = _wait(base + "/api/multi_status")
    assert st["error"] is None, st
    assert set(st["result"]) == {"y", "age"}
    assert "extbic_path" in st["result"]["y"]


def test_gui_zmat_scan(server, tmp_path):
    """Identity Z read through the GUI reproduces the no-Z selection."""
    base, d = server
    zpath = str(tmp_path / "z.txt")
    np.savetxt(zpath, np.eye(100), fmt="%d")

    def scan(zmat):
        r = _read(base, d, zmat=zmat)
        _post(base + "/api/am", {"trait": "y", "maxit": "3"})
        st = _wait(base + "/api/status")
        assert st["error"] is None, st
        return r, st["result"]["indices"]

    r, with_z = scan(zpath)
    assert "100 records x 100 individuals" in r["zmat"]
    assert with_z == scan("")[1]


def test_gui_device_defaults_to_cuda():
    """Without a device the server takes the card, and says so when there
    is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the server would start on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gui.open_gui(port=0, open_browser=False, block=False)
