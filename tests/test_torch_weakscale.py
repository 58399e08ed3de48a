"""scripts/weakscale_torch.py on the CPU (``--device cpu --quick``, N = 1
and 2, one round) against the JAX package's scripts/weakscale.py: the
report's keys, each point's and each phase's, are the JAX script's (read
from its source: running it takes jax.distributed workers), and the
two-process results equal one process on the same store.

The two ranks' K·V is each rank's partial on its own SNP range, summed in
f64 in process order: it equals the same two partials of one process
(RangeTileSource) summed so, rtol 1e-10, and one process's K·V over the
whole store to f32 rounding (rtol 1e-6; that one sums all p in f32). The
gathered stat rows are per-SNP and equal one process's, rtol 1e-10. Both
are also held to the JAX package's TiledScan on the same store (its
kernel_matvec and matfree_stat_rows, in f32 on the CPU) to f32 rounding."""

import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread, as each rank runs: the plain K3's f32 sums then go in the
# ranks' order
torch.set_num_threads(1)

from eagleeverything_tpu_torch.models import engine_torch  # noqa: E402
from eagleeverything_tpu_torch.utils.config import EagleConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_SRC = (ROOT / "scripts" / "weakscale.py").read_text()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ws")
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "weakscale_torch.py"),
         "--device", "cpu", "--quick", "--rounds", "1", "--dir",
         str(d / "data"), "--out", str(d / "ws.json"), "--timeout", "300"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:] + res.stdout[-3000:]
    return d, json.loads((d / "ws.json").read_text())


def _jax_keys(pattern: str, text: str) -> set:
    return set(re.findall(pattern, text))


def test_report_keys_are_the_jax_scripts(run):
    _, rep = run
    worker = JAX_SRC[JAX_SRC.index("_WORKER"):JAX_SRC.index("def _free_port")]
    want_out = _jax_keys(r'out\["(\w+)"\]', worker)
    report_src = JAX_SRC[JAX_SRC.index("report = {"):]
    want_top = _jax_keys(r'"(\w+)":', report_src[:report_src.index(
        '"note"') + 7])
    want_pt = _jax_keys(r'pt\["(\w+)"\]', report_src)
    phase_src = report_src[report_src.index("pt[phase] = {"):]
    want_phase = _jax_keys(r'"(\w+)":', phase_src[:phase_src.index("}")])

    assert want_top and want_pt and want_phase and want_out
    assert set(rep) == want_top | {"mode", "device"}
    assert rep["mode"] == rep["device"] == "cpu"
    assert set(rep["points"]) == {"1", "2"}
    phases = {f"{k}" for k in ("sweep_eig", "matvec", "mmt", "statrows")}
    for pt in rep["points"].values():
        assert set(pt) == phases | want_pt | {"shared_card", "launches"}
        assert pt["shared_card"] is False
        for ph in phases:
            assert set(pt[ph]) == want_phase
            assert pt[ph]["t_s_median"] > 0
    raw = json.loads((run[0] / "data" / "ws_2.json").read_text())
    assert set(raw) == want_out | {"launches", "device"}
    assert raw["p_global"] == 2 * raw["p_local"] == 4096


def test_two_ranks_equal_one_process(run):
    d, _ = run
    got = np.load(d / "data" / "ws_2_r0.npz")
    src = engine_torch.StoreTileSource(str(d / "data" / "store_2"))
    cfg, cpu = EagleConfig(), torch.device("cpu")
    one = engine_torch.TiledScan(src, cfg, cpu)
    parts = [engine_torch.TiledScan(engine_torch.RangeTileSource(src, lo, hi),
                                    cfg, cpu).kernel_matvec(got["V"])
             for lo, hi in ((0, 2048), (2048, 4096))]
    np.testing.assert_allclose(got["KV"], parts[0] + parts[1], rtol=1e-10)
    np.testing.assert_allclose(got["KV"], one.kernel_matvec(got["V"]),
                               rtol=1e-6, atol=1e-6 * np.abs(got["KV"]).max())
    rows = np.column_stack(one.matfree_stat_rows(got["A"], 8, np.eye(8)))
    np.testing.assert_allclose(got["statrows"], rows, rtol=1e-10)


def test_two_ranks_equal_the_jax_tiled_scan(run):
    from eagleeverything_tpu.api.read import GenoHandle
    from eagleeverything_tpu.models import engine_jax
    from eagleeverything_tpu.utils.config import EagleConfig as JCfg

    d, _ = run
    got = np.load(d / "data" / "ws_2_r0.npz")
    store = d / "data" / "store_2"
    meta = json.loads((store / "manifest.json").read_text())
    jsrc = engine_jax._make_source(
        GenoHandle(n=meta["n"], p=meta["p"], source="ws",
                   store_dir=str(store)), None)
    jax_scan = engine_jax.TiledScan(jsrc, JCfg())
    KV = jax_scan.kernel_matvec(got["V"])
    np.testing.assert_allclose(got["KV"], KV, rtol=1e-6,
                               atol=1e-6 * np.abs(KV).max())
    rows = np.column_stack(jax_scan.matfree_stat_rows(got["A"], 8,
                                                      np.eye(8)))
    np.testing.assert_allclose(got["statrows"], rows, rtol=1e-5,
                               atol=1e-6 * np.abs(rows).max())
