"""On the card, at each cell's own size: the program passes every number
that decides ``correct`` and the lower-precision control (the reference in
int4 where the configuration states int8, or with TF32 on where it states
fp32 with TF32 off) fails at least one. ``portbench/readings.py`` makes the
same readings over many seeds; this keeps one seed of them as a test."""

import time

import pytest
import torch

from portbench import harness, readings
from portbench.tests.tiny import CELLS, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run only "
                    "there")
    cell = harness.load_cell(ROOT, name)
    fn = (readings.serving if cell.traffic["driver"] == "serving"
          else readings.training)
    t0 = time.time()
    row = fn(cell, 2 ** 31 + 77, "cuda:0", lambda: time.time() - t0)
    limits = cell.workload["limits"]
    assert all(row["program"][k] <= lim for k, lim in limits.items())
    assert any(row["control"][k] > lim for k, lim in limits.items())
