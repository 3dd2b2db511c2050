"""Each fault a cell can have, planted underneath a whole run, turns
``correct`` false; and the lower-precision control fails the cells'
limits.  (The runs skip the harness's look for a card: they are driven on
the CPU at the small cells' sizes, with the cells' own limits.)"""
import time

import pytest
import torch

from portbench import faults, harness, weights
from portbench.reference import fold as ref_fold
from portbench.reference import transformer as ref

CASES = [(cell, f) for cell in ("smoke.train-dense", "smoke.train-moe",
                                 "smoke.fold") for f in faults.KINDS]


@pytest.mark.parametrize("cell, fault", CASES)
def test_a_planted_fault_is_not_correct(smoke_root, cell, fault):
    kind = harness.load_cell(cell, smoke_root).entry["traffic"]
    with faults.planted(kind, fault):
        out = harness.run_cell(cell, 2_147_483_659, 0.0, False, "cpu",
                               root=smoke_root)
    assert not out["correct"], out["checks"]
    # and unplanted, the same run is
    assert harness.run_cell(cell, 2_147_483_659, 0.0, False, "cpu",
                            root=smoke_root)["correct"]


def _driver(root, cell):
    c = harness.load_cell(cell, root)
    kind = c.entry["traffic"]
    return c, harness.load_module(root / "portbench" / "traffic" /
                                  f"{kind}.py", "f_" + kind)


@pytest.mark.parametrize("cell, seed", [
    ("smoke.train-dense", 5), ("smoke.train-dense", 2_147_483_659),
    ("smoke.train-moe", 5), ("smoke.train-moe", 3_000_000_019)])
def test_the_fp8_control_fails_a_training_cells_limits(smoke_root, cell,
                                                        seed):
    c, driver = _driver(smoke_root, cell)
    run = harness.Run(c, seed, 0.0, False, torch.device("cpu"),
                      time.perf_counter())
    p = run.params
    _, _, batches, _, layout = driver.setup(run)
    checked = batches[:p["checked_steps"]]
    want = ref.train(c.config, weights.make(layout, seed, "cpu"), checked,
                     driver.hyper(p))
    low = ref.train(c.config, weights.make(layout, seed, "cpu"), checked,
                    driver.hyper(p), quant=ref.fp8)
    got = driver.gaps(low, want)
    assert any(v > run.limits[k] for k, v in got.items()), got


@pytest.mark.parametrize("seed", [5, 2_147_483_659, 3_000_000_019])
def test_the_fp32_accumulator_control_fails_the_fold(smoke_root, seed):
    c, driver = _driver(smoke_root, "smoke.fold")
    run = harness.Run(c, seed, 0.0, False, torch.device("cpu"),
                      time.perf_counter())
    _, _, d = driver.inputs(run)
    want = ref_fold.fold(d["base"], d["sites"], driver.QCHUNK)
    low = ref_fold.fold(d["base"], d["sites"], driver.QCHUNK,
                        acc_dtype=torch.float32)
    assert ref_fold.mismatches(low, want) > \
        run.limits["first_round_mismatches"]

