"""The PyTorch port imports without JAX and without the JAX package, and
its GPU smoke script refuses to run where it cannot do its job."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "eagleeverything_tpu_torch"


def _modules() -> list[str]:
    out = []
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_port_imports_with_jax_blocked():
    """A process where ``import jax`` fails imports every module of the
    port (sys.modules["jax"] = None makes any jax import raise)."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'eagleeverything_tpu' or "
        "k.startswith('eagleeverything_tpu.') for k in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+eagleeverything_tpu\b(?!_)"
    r"|from\s+eagleeverything_tpu\b(?!_))", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py", "scripts/biobank_axes_torch.py", "bench_cuda.py",
       "scripts/cohort_run_torch.py", "scripts/debug_resume_fit_torch.py",
       "scripts/eigh_limit_torch.py", "scripts/ingest_bench_torch.py",
       "scripts/weakscale_torch.py", "examples/python_api_torch.py"]))
def test_port_sources_import_no_jax(path):
    src = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(src), path
    assert "eagleeverything_tpu." not in src.replace(
        "eagleeverything_tpu_torch.", ""), path


@pytest.mark.parametrize("path", [
    "scripts/debug_resume_fit_torch.py", "scripts/eigh_limit_torch.py",
    "scripts/ingest_bench_torch.py", "scripts/weakscale_torch.py",
    "examples/python_api_torch.py"])
def test_port_scripts_start_with_jax_blocked(path):
    """Each of the port's scripts parses its command line (``--help``) in
    a process where ``import jax`` fails."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.argv = [{path!r}, '--help']\n"
        f"runpy.run_path({path!r}, run_name='__main__')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "usage:" in res.stdout


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card the smoke script exits non-zero and prints no result
    line; the same holds in a directory with nothing of the repo."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    for cwd in (ROOT, alone):
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
