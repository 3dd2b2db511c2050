"""The port stands alone: importing any ``repro_torch`` module loads none of
``jax``, ``repro``, ``msgpack`` or ``ml_dtypes``, no source imports them,
and a missing card is an error, never a silent demotion to the CPU."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import ast
import subprocess
from pathlib import Path

import pytest
import torch

from repro_torch.device import resolve_device

SRC_TORCH = Path(__file__).resolve().parent.parent / "src_torch"
FORBIDDEN = ("jax", "repro", "msgpack", "ml_dtypes")

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules if k.split(".")[0] in {forbidden!r})
print(len(names), bad)
print(" ".join(names))
"""

#: modules the walk must reach (one per slice of the port at least)
EXPECTED = ("repro_torch.fl.agg_kernels", "repro_torch.kernels.agg_reduce",
            "repro_torch.kernels.flash_attention",
            "repro_torch.models.transformer",
            "repro_torch.models.recurrent", "repro_torch.kernels.rglru_scan",
            "repro_torch.configs.recurrentgemma_2b",
            "repro_torch.kernels.secagg_mask", "repro_torch.kernels.ops",
            "repro_torch.fl.mods", "repro_torch.launch.mesh",
            "repro_torch.optim", "repro_torch.optim.optimizers",
            "repro_torch.optim.schedules", "repro_torch.checkpoint",
            "repro_torch.checkpoint.checkpoint", "repro_torch.data.loader",
            "repro_torch.data.partition", "repro_torch.utils.pytree",
            "repro_torch.launch.train", "repro_torch.train.steps",
            "repro_torch.configs.flower_quickstart",
            "repro_torch.core.flowcontrol", "repro_torch.core.transport",
            "repro_torch.core.collective", "repro_torch.launch.shardings",
            "repro_torch.sharding", "repro_torch.examples.federated_llm",
            "repro_torch.launch.analytic", "repro_torch.launch.dryrun",
            "repro_torch.launch.roofline")


def test_importing_every_module_loads_no_reference_dependency():
    env = dict(os.environ, PYTHONPATH=str(SRC_TORCH))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, env=env, timeout=240, check=True)
    head, walked = out.stdout.strip().split("\n")
    count, bad = head.split(" ", 1)
    assert int(count) >= 30, out.stdout
    assert bad == "[]", out.stdout
    assert set(EXPECTED) <= set(walked.split()), out.stdout


def test_no_source_imports_a_reference_dependency():
    offenders = []
    for path in sorted(SRC_TORCH.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            offenders += [f"{path}:{node.lineno} {m}" for m in mods
                          if m.split(".")[0] in FORBIDDEN]
    assert offenders == []


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_resolve_device_raises_without_cuda(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(device)


def test_resolve_device_cpu_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
