"""Cells at a size a CPU test holds: small configurations of the same
architectures and small workloads of the same traffic kinds, written as
files into a scratch checkout beside the benchmark's own, as a later cell
would be added.  The tests drive whole runs through them
(:func:`portbench.harness.run_cell`) on the CPU."""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, Tuple

from portbench.harness import ROOT

DENSE = {"arch": "h2o-danube-1.8b", "num_hidden_layers": 2,
         "hidden_size": 64, "intermediate_size": 96,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "vocab_size": 300, "sliding_window": 24, "rope_theta": 10000.0,
         "tie_word_embeddings": False, "rms_norm_eps": 1e-6,
         "torch_dtype": "float32", "param_dtype": "float32", "remat": True}
MOE = {"arch": "granite-moe-1b-a400m", "num_hidden_layers": 2,
       "hidden_size": 64, "intermediate_size": 32,
       "num_attention_heads": 4, "num_key_value_heads": 2,
       "num_local_experts": 8, "num_experts_per_tok": 2, "vocab_size": 300,
       "rope_theta": 10000.0, "tie_word_embeddings": True,
       "rms_norm_eps": 1e-6, "attention_multiplier": 0.25,
       "router_aux_loss_coef": 0.01, "router_z_loss_coef": 0.001,
       "expert_capacity_factor": 1.25, "torch_dtype": "float32",
       "param_dtype": "float32", "remat": True}
TRAIN = {"batch": 4, "seq_len": 32, "microbatches": 2,
         "learning_rate": 1e-3, "warmup_steps": 2, "total_steps": 10,
         "weight_decay": 0.1, "beta1": 0.9, "beta2": 0.95, "eps": 1e-8,
         "grad_clip": 1.0, "impl": "eager", "distinct_batches": 5,
         "checked_steps": 3, "trace_steps": 1,
         "markov": {"site": 0, "non_iid_alpha": 0.5, "latent_vocab": 256}}
FOLD = {"sites": 8, "frac": 0.05, "examples": [100, 1000],
        "strategy": "fedavg", "trace_rounds": 1}


def cells() -> Dict[str, Tuple[Dict, Dict]]:
    """name -> (workload file, configuration file) of the small cells;
    the training cells' limits are the benchmark's own."""
    def limits(name):
        with open(ROOT / "portbench" / "workloads" / f"{name}.json") as f:
            return json.load(f)["check"]

    dense_limits = limits("train.danube-1.8b")
    moe_limits = limits("train.granite-moe-1b-a400m")
    fold_limits = limits("fold.danube-1.8b-4l.topk5x8")
    return {
        "smoke.train-dense": (
            {"config": "smoke-dense", "traffic": "train_steps", "chips": 1,
             "why": "test", "params": TRAIN, "check": dense_limits},
            DENSE),
        "smoke.train-moe": (
            {"config": "smoke-moe", "traffic": "train_steps", "chips": 1,
             "why": "test", "params": TRAIN, "check": moe_limits}, MOE),
        "smoke.fold": (
            {"config": "smoke-dense", "traffic": "sparse_fold", "chips": 1,
             "why": "test", "params": FOLD, "check": fold_limits}, DENSE),
    }


def make_root(tmp: Path, which=None) -> Path:
    """A checkout under ``tmp`` whose ``BENCHMARK.json`` and
    ``portbench/`` hold the benchmark's files plus the small cells'
    (``which``: their names; all by default), each in files of its own."""
    root = Path(tmp) / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    for name, (wl, conf) in cells().items():
        if which is not None and name not in which:
            continue
        cfile = root / "portbench" / "configs" / f"{wl['config']}.json"
        cfile.write_text(json.dumps(conf))
        (root / "portbench" / "workloads" / f"{name}.json").write_text(
            json.dumps(wl))
        if not any(c["name"] == wl["config"] for c in bench["configs"]):
            bench["configs"].append(
                {"name": wl["config"], "source": "test", "reduced": [],
                 "file": f"portbench/configs/{wl['config']}.json",
                 "why": "test"})
        bench["workloads"].append({"name": name, "config": wl["config"],
                                   "traffic": wl["traffic"], "chips": 1,
                                   "why": "test"})
        # the metrics of the cells of its traffic kind are its metrics too
        peers = {w["name"] for w in bench["workloads"]
                 if w["traffic"] == wl["traffic"]}
        for section in ("end_to_end", "per_layer"):
            for m in bench[section]:
                if peers & set(m.get("workloads", ())):
                    m["workloads"] = m["workloads"] + [name]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
