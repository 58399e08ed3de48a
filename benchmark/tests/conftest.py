"""Shared fixtures of the benchmark's tests: a copy of the benchmark with
tiny cells added as files (see ``tiny.py``), built once a test run."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
# the tests, the benchmark's modules (as its run script puts them on the
# path) and the checkout's root (the program)
for _p in (HERE.parents[1], HERE.parent, HERE):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    import tiny
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
