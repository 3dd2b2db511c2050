"""One run of one cell: find its files by name, run its traffic driver on
the program, read the cell's metrics, and print the result's last line.

The run refuses (exit code other than 0, no result) when the card the cell
asks for is missing, when the checkout lacks the program, and when JAX, the
JAX package (``repro``) or Flax is loaded in the process once the window
has closed.  Modules are compared by their top-level name, whole: the
program's own name, ``repro_torch``, begins with ``repro``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the program's package, which the references may not load
PROGRAM = "repro_torch"
#: build and kernel caches, each at a fixed path inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "nv_compute"}


class Refused(RuntimeError):
    """The run cannot give a result (exit code 3)."""


def loaded(names: Sequence[str]) -> List[str]:
    """Which of the top-level module ``names`` ``sys.modules`` holds."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(n for n in names if n in tops)


def guard_start() -> None:
    """Before the program is imported: nothing forbidden is loaded, and
    the references load nothing of the program."""
    import portbench.reference.fold  # noqa: F401
    import portbench.reference.transformer  # noqa: F401

    bad = loaded(FORBIDDEN + (PROGRAM,))
    if bad:
        raise Refused(f"loaded before the program: {bad}")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name`` (file names may
    hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise Refused(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A cell's entry in ``BENCHMARK.json`` and its files."""
    name: str
    entry: Dict
    workload: Dict
    config: Dict
    bench: Dict

    def metrics(self, section: str) -> List[Dict]:
        """The metrics of ``section`` (``end_to_end`` / ``per_layer``)
        this cell reports: those that list it, and a per-layer metric that
        lists no cells wherever the metric it moves is reported."""
        e2e = {m["name"] for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])}
        if section == "end_to_end":
            return [m for m in self.bench[section] if m["name"] in e2e]
        return [m for m in self.bench[section]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    here = root / "portbench"
    wl = load_json(here / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if wl.get(key) != entry[key]:
            raise Refused(f"workloads/{name}.json: {key}={wl.get(key)!r}, "
                          f"BENCHMARK.json says {entry[key]!r}")
    conf = load_json(here / "configs" / f"{entry['config']}.json")
    return Cell(name, entry, wl, conf, bench)


@dataclass
class Run:
    """What a traffic driver gets: the cell, the run's arguments, the
    device and the process's start on the host clock."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float
    log: Callable[[str], None] = field(default=lambda s: print(
        s, file=sys.stderr, flush=True))

    @property
    def params(self) -> Dict:
        return self.cell.workload["params"]

    @property
    def limits(self) -> Dict[str, float]:
        return self.cell.workload["check"]

    def span(self, name: str):
        """The benchmark's own span around a call into the program."""
        import torch

        return torch.profiler.record_function("portbench." + name)


def power_limit_w() -> Optional[float]:
    """The card's power limit by ``nvidia-smi``; None where it cannot
    say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def read_layer(reader, record: Dict, metric: str, on_card: bool):
    """Per-layer metric ``metric`` by its ``reader`` from the traced
    run's ``record``.  Off a card a device metric has nothing to read and
    is left out (None); on a card every metric a cell reports has, so a
    reader that finds nothing (a renamed kernel, a card missing from the
    table of peaks) refuses the run."""
    value = reader.read(record)
    if value is None and on_card:
        raise Refused(f"the reader of {metric} found nothing to read")
    return value


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             root: Path = ROOT, t0: Optional[float] = None) -> Dict:
    """Run cell ``name`` on ``device`` and return the result's fields
    (``checks`` last).  The caller has checked for the card."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    cell = load_cell(name, root)
    kind = cell.entry["traffic"]
    driver = load_module(root / "portbench" / "traffic" / f"{kind}.py",
                         f"portbench_traffic_{kind}")
    run = Run(cell, int(seed), float(seconds), bool(trace),
              torch.device(device), t0)
    res = driver.run(run)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(section):
        if trace:
            reader = load_module(
                root / "portbench" / "metrics" / f"{m['name']}.py",
                "portbench_metric_" + m["name"].replace(".", "_"))
            value = read_layer(reader, res["record"], m["name"],
                               run.device.type == "cuda")
        else:
            value = res["end_to_end"].get(m["name"])
            if value is None:
                raise Refused(f"cell {name} reports no {m['name']}")
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {k: {"value": float(v), "limit": float(lim)}
              for k, (v, lim) in res["checks"].items()}
    correct = bool(checks) and res["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    dev = {"platform": "gpu" if run.device.type == "cuda" else
           run.device.type,
           "kind": torch.cuda.get_device_name(run.device)
           if run.device.type == "cuda" else "cpu",
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(res["memory_peak_bytes"])}
    out: Dict[str, Any] = {"correct": correct,
                           "attempted": int(res["attempted"]),
                           "failed": int(res["failed"]),
                           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = float(res["busy_s"])
        dev["window_s"] = float(res["window_s"])
        out["breakdown"] = res["breakdown"]
    if run.device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    out["checks"] = checks
    return out


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout, whatever the environment said."""
    for var, sub in CACHE_DIRS.items():
        path = root / ".portbench_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def main(argv: Optional[Sequence[str]] = None, t0: Optional[float] = None
         ) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    err = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    try:
        cell = load_cell(args.workload)
        import torch

        chips = int(cell.entry["chips"])
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise Refused(f"cell {args.workload} needs {chips} CUDA "
                          f"card(s); this machine has "
                          f"{torch.cuda.device_count()}")
        program = ROOT / "src_torch" / PROGRAM
        if not program.is_dir():
            raise Refused(f"the program is not in this checkout: {program}")
        guard_start()
        set_cache_dirs()
        sys.path.insert(0, str(ROOT / "src_torch"))
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", t0=t0)
    except Refused as e:
        err(f"refused: {e}")
        return 3
    bad = loaded(FORBIDDEN)
    if bad:
        err(f"refused: modules loaded in this process: {bad}")
        return 4
    for k, c in out["checks"].items():
        err(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0
