"""On the card: the control, the reference computed with float8 e4m3
operands in every linear map in the program's place, fails a limit that the
program passes, at each cell's own widths and depth (a 10 s window)."""
import time

import pytest

import calibrate
import run
from harness import files

BENCH = files.load_benchmark()


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_a_limit(name, card):
    run.set_environment()
    cell = files.cell(BENCH, name)
    cfg = files.load_data("configs", cell["config"])
    traffic = files.load_data("traffic", cell["traffic"])
    limits = files.load_data("limits", name)
    seed = 2**31 + 99
    result, record = run.run_cell(BENCH, cell, cfg, traffic, limits, seed,
                                  10.0, False, card, time.perf_counter())
    assert result["correct"], result["check"]
    ctrl = calibrate.control_readings(cfg, traffic, seed, record, True,
                                      False)["control"]
    assert [k for k, lim in limits["limits"].items() if ctrl[k] > lim], ctrl
