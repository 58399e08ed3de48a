"""The port's native ingest under ThreadSanitizer: both threaded paths of
its ingest.cpp (the ASCII recode and the VCF GT scan) parse multi-block
files in a child interpreter with libtsan preloaded, with no report, as
the JAX package's ``make tsan`` checks its ASCII path."""

import subprocess

import pytest

from eagleeverything_tpu_torch.io import native
from eagleeverything_tpu_torch.io.native import tsan_check


@pytest.fixture(scope="module")
def child():
    if native.tsan_runtime() is None:
        pytest.skip("g++ has no libtsan.so")
    return tsan_check.run()


def test_tsan_build_lands_beside_the_native_library():
    if native.tsan_runtime() is None:
        pytest.skip("g++ has no libtsan.so")
    lib = native.build_tsan()
    assert lib.parent == native.BUILD_DIR
    assert lib.name.startswith("libeagleingest_tsan_")
    assert lib != native.lib_path()


def test_both_threaded_paths_pass_under_tsan(child):
    assert tsan_check.passed(child), child.stdout
    assert "512 ASCII rows, 700 VCF variants" in child.stdout


def test_a_tsan_report_fails_the_check():
    report = subprocess.CompletedProcess(
        [], 0, stdout="WARNING: ThreadSanitizer: data race (pid=1)\n")
    assert not tsan_check.passed(report)
    assert not tsan_check.passed(subprocess.CompletedProcess([], 66, ""))
