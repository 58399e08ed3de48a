"""scripts/ingest_bench_torch.py against the JAX package's
scripts/ingest_bench.py at a few MB: the same generated files byte for
byte, the same store bytes from the two read_markers (native and Python
parsers), and the same JSON keys a result."""

import filecmp
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, P_VCF, P_TXT = 300, 1500, 6000


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


port = _load("ingest_bench_torch", ROOT / "scripts" / "ingest_bench_torch.py")
jax = _load("ingest_bench_jax", ROOT / "scripts" / "ingest_bench.py")


@pytest.fixture(autouse=True)
def _native_state():
    """bench_one marks each package's native library unavailable for the
    Python parsers; put both back for the tests that follow in this
    process."""
    from eagleeverything_tpu.io import native as jn
    from eagleeverything_tpu_torch.io import native as tn
    saved = [(m, m._lib, m._lib_failed) for m in (jn, tn)]
    yield
    for m, lib, failed in saved:
        m._lib, m._lib_failed = lib, failed


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ingest")
    for mod, tag in ((port, "port"), (jax, "jax")):
        mod.gen_vcf(str(d / f"{tag}.vcf"), N, P_VCF, seed=3)
        mod.gen_ascii(str(d / f"{tag}.txt"), N, P_TXT, seed=3)
    return d


def test_generators_write_the_jax_scripts_bytes(files):
    for ext in ("vcf", "txt"):
        assert filecmp.cmp(files / f"port.{ext}", files / f"jax.{ext}",
                           shallow=False), ext
    assert (files / "port.vcf").stat().st_size > 1_000_000


@pytest.mark.parametrize("fmt,ext", [("vcf", "vcf"), ("text", "txt")])
@pytest.mark.parametrize("use_python", [False, True])
def test_stores_equal_the_jax_read_markers(files, fmt, ext, use_python):
    tag = f"{fmt}_{int(use_python)}"
    got = port.bench_one(str(files / f"port.{ext}"), fmt,
                         str(files / f"store_port_{tag}"), use_python)
    want = jax.bench_one(str(files / f"port.{ext}"), fmt,
                         str(files / f"store_jax_{tag}"), use_python)
    assert set(got) == set(want)
    assert list(got) == list(want)
    for k in ("format", "input_gb", "n", "p", "store_gb", "parser"):
        assert got[k] == want[k], k
    a, b = files / f"store_port_{tag}", files / f"store_jax_{tag}"
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names and len(names) == 9
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


def test_cli_prints_a_result_for_each_format(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="2", EE_NCPU="2")
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "ingest_bench_torch.py"),
         "--gb", "0.004", "--n", "200", "--format", "both",
         "--dir", str(tmp_path / "b")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert [r["format"] for r in last["results"]] == ["vcf", "text"]
    assert all(r["mb_per_s"] > 0 and r["parser"] == "native"
               for r in last["results"])
    assert not (tmp_path / "b").exists()     # removed without --keep
