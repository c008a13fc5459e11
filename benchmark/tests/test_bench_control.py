"""The control, the plain reference a precision below the configuration's
put in the program's place, is not correct by the cell's limits; the
program, read at the same size, is. Here at a tiny size on the CPU;
``benchmark/control.py`` reads both at the cells' own sizes on the chip."""

import math

import pytest

from benchmark.control import readings
from benchmark.tests.tiny import tiny_cell

WORKLOADS = ["search-e5s-msmarco8m-exact", "score-bge-mining-pairs",
             "encode-e5s-msmarco-passages", "train-e5s-kd"]


def within(numbers, limits):
    """Every number the cell compares, of those read, within its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= v
               for k, v in limits.items() if k in numbers)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_and_the_program_passes(workload):
    cell = tiny_cell(workload)
    got = readings(cell, 2**34 + 3, 0.4, "cpu")
    assert within(got["program"], cell.limits), got
    assert not within(got["control"], cell.limits), got
