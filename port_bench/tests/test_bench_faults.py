"""Runs with the timed path broken underneath come out not correct: every
fault that a cell can have (its rehearsal file's ``faults``), planted in
the program at a small size on the CPU, found by name as ``calibrate.py``
finds it (``faults.find``)."""

import pytest

from port_bench.faults import find

from ._tiny import BENCH, cells, rehearsal, rehearsal_file, rehearse, root

# a cell without a rehearsal file fails test_every_cell_has_a_rehearsal_file, not collection
CASES = [(cell, fault) for cell in cells() if rehearsal_file(cell).is_file()
         for fault in rehearsal(cell)["faults"]]


def fault_is_not_correct(cell, fault, bench=BENCH):
    with find(fault, root(bench))():
        result, checks = rehearse(cell, bench=bench)
    assert result["correct"] is False, checks


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    fault_is_not_correct(cell, fault)
