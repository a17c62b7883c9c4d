"""The control comes out not correct: the reference one precision below the
configuration's (fp8 for bf16) put in the program's place, on a run's
inputs, fails one of the cell's limits. On the card the same readings come
from ``gpubench/calibrate.py --control-seeds`` at the cells' own size."""

import pytest

from gpubench import common
from conftest import tiny

BENCH = common.benchmark()


@pytest.mark.parametrize("cell", ["unet3d-bf16.train", "unet3d-dann-bf16.train"])
def test_control_fails_a_limit(cell):
    files = common.cell_files(BENCH, cell)
    small = tiny()
    # the configuration's widths: narrower nets round less in fp8
    config = {**files["config"], **small["config"], "features": files["config"]["features"],
              "volume_size": 32}
    numbers = files["loop"].control(config, {**files["mix"], **small["mix"]}, 2147483900, "cpu")
    limits = files["cell"]["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers
