"""The readings a cell's limits are set from, in one process on the card
(set-up is long): the program's numbers over many seeds (the lower
reading), the lower-precision control's over a few (the upper reading),
and, for a training cell, the half-batch fault's.  The benchmark's own
runs never run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --control 3 [--first-seed N] [--out FILE]

Prints one JSON line a reading: ``{"seed", "who", "numbers"}``, ``who``
being ``program``, ``control`` or ``fault:<name>``.  A state left
unchanged reads 1 by the training cells' measure and needs no run.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import faults, harness, weights  # noqa: E402
from portbench.reference import fold as ref_fold  # noqa: E402
from portbench.reference import transformer as ref_tf  # noqa: E402


def train_readings(driver, run):
    """The program's checked steps' readings; its state freed."""
    step_fn, state, batches, prog, layout = driver.setup(run)
    del step_fn, state
    gc.collect()
    torch.cuda.empty_cache()
    return prog, batches, layout


def by_leaf(got, want):
    """Each leaf's relative gap of the first gradient's and the change's
    norm, and the losses, to see which leaf a worst gap comes from."""
    return {"losses": [got["losses"], want["losses"]],
            "grad": {k: got["first_grad"][k] / v - 1
                     for k, v in want["first_grad"].items()},
            "change": {k: got["change"][k] / v - 1 if v else None
                       for k, v in want["change"].items()}}


def calibrate_train(driver, run, control: bool, emit):
    conf, p = run.cell.config, run.params
    prog, batches, layout = train_readings(driver, run)
    checked = batches[:p["checked_steps"]]
    want = ref_tf.train(conf, weights.make(layout, run.seed, run.device),
                        checked, driver.hyper(p))
    emit("program", driver.gaps(prog, want), by_leaf(prog, want))
    if not control:
        return
    ctrl = ref_tf.train(conf, weights.make(layout, run.seed, run.device),
                        checked, driver.hyper(p), quant=ref_tf.fp8)
    emit("control", driver.gaps(ctrl, want), by_leaf(ctrl, want))
    with faults.planted("train_steps", "half_batch"):
        bad, _, _ = train_readings(driver, run)
    emit("fault:half_batch", driver.gaps(bad, want), by_leaf(bad, want))


def calibrate_fold(driver, run, control: bool, emit):
    out = driver.run(run)
    emit("program", {k: v for k, (v, _) in out["checks"].items()})
    if not control:
        return
    layout, shapes, d = driver.inputs(run)
    base = d["base"]
    want = ref_fold.fold(base, d["sites"], driver.QCHUNK, run.device)
    low = ref_fold.fold(base, d["sites"], driver.QCHUNK, run.device,
                        acc_dtype=torch.float32)
    emit("control", {"first_round_mismatches":
                     ref_fold.mismatches(low, want)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_019)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    sys.path.insert(0, str(harness.ROOT / "src_torch"))
    cell = harness.load_cell(args.workload)
    kind = cell.entry["traffic"]
    driver = harness.load_module(
        harness.ROOT / "portbench" / "traffic" / f"{kind}.py",
        f"portbench_traffic_{kind}")
    sink = open(args.out, "a") if args.out else None
    try:
        for j in range(args.seeds):
            seed = args.first_seed + 7919 * j
            run = harness.Run(cell, seed, 0.0, False, torch.device("cuda"),
                              time.perf_counter())
            t0 = time.perf_counter()

            def emit(who, numbers, detail=None):
                line = json.dumps({"seed": seed, "who": who,
                                   "numbers": numbers, "detail": detail,
                                   "at_s": time.perf_counter() - t0})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()

            fn = calibrate_train if kind == "train_steps" else calibrate_fold
            fn(driver, run, j < args.control, emit)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
