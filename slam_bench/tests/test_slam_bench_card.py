"""On the card: each cell at its own size through a run's window is
``correct``; its control (every float32 matrix product with TF32 operands,
one precision below the configuration's) is not, and neither is the loop
fault (each loop closure's ICP result moved 2 m).  Skips without a card;
run on the card with

    python -m pytest slam_bench/tests -m card -n 0 -q
"""

import time

import pytest

from slam_bench import control
from slam_bench.harness import Bench, run_cell

pytestmark = pytest.mark.card

SEED = 2 ** 31 + 977
CELLS = ["vlp16.replay.laps"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_correct_on_the_card(card, cell):
    res = run_cell(Bench(), cell, SEED, 30.0, False, card,
                   time.perf_counter())
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("precision", ["tf32", "loop_z"])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_loop_fault_are_not_correct(card, cell,
                                                        precision):
    ((_, res),) = control.readings(cell, [SEED + 1], 30.0, precision, card)
    assert not res["correct"], res["values"]
