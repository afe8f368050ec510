"""On a CUDA card: every cell at its own size through the whole run, and
its lower-precision control (``python3 -m pytest benchmark/tests -m card``;
about two minutes a cell)."""

import time

import pytest

from benchmark import harness
from benchmark.tests.test_bench_discovery import CELLS

pytestmark = pytest.mark.card


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cuda_device, cell):
    spec = harness.cell_spec(cell)
    out, checks = harness.run_cell(spec, 2 ** 31 + 41, 5.0, False,
                                   cuda_device, time.perf_counter())
    assert all(v <= lim for _, v, lim in checks), checks
    assert out["device"]["platform"] == "gpu" and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in spec["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cuda_device, cell):
    spec = harness.cell_spec(cell)
    drv = harness.load_module("drivers", spec["workload"]["driver"])
    c = drv.Cell(harness.Context(spec, 2 ** 31 + 43, cuda_device))
    c.setup()
    c.window(5.0)
    c.release()
    limits = spec["workload"]["limits"]
    assert any(v > limits[k] for k, v in c.control())
