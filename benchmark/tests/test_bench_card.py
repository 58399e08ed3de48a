"""On a card: the tiny cells through the same harness, judged alike."""

import pytest

import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny_mf.scan", "tiny_ex.scan"])
def test_tiny_cell_on_the_card(tiny_root, cuda, cell):
    run, line = tiny.run_tiny(tiny_root, cell, seed=13, device="cuda")
    assert line["correct"], line["compared"]
    assert line["device"]["platform"] == "gpu"
