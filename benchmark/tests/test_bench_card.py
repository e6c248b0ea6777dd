"""On the card: each cell's control (its path one precision down, as
``limits/<cell>.json`` names it) comes out not correct, and the program
correct, at the cells' own sizes (DEEP-10M cut to 2M rows so that a test run
holds it). ``python -m pytest benchmark/tests -m card`` on the card."""

import pytest

from benchmark.harness import cell as cell_mod
from benchmark.harness.spec import load_cell

CELLS = ("sift1m-heap.batch", "sift1m-heap.batch-codes", "deep10m-ti.batch")


def _cell(workload):
    c = load_cell(workload)
    if c.config["n"] > 2_000_000:
        c.config = {**c.config, "n": 2_000_000}
    return c


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_and_the_program_passes(card, workload):
    c = _cell(workload)
    prog = cell_mod.run_cell(c, 2**31 + 17, 2.0, False, card)
    ctl = cell_mod.run_cell(c, 2**31 + 17, 2.0, False, card,
                            variant="control")
    assert prog["line"]["correct"] is True, prog["numbers"]
    assert ctl["line"]["correct"] is False, ctl["numbers"]
