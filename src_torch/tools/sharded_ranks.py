"""The port's sharded steps on real ranks: gloo, one CPU process a rank, on
a ``(data, model)`` mesh, against the plain steps on the same inputs.

Every family of the registry but the quickstart MLP, at its smoke size in
fp32, with inputs from :meth:`repro_torch.models.api.Model.make_batch`
(Whisper's audio embeddings, InternVL2's prefix embeddings):

- ``prefill``: the prefill under the ``prefill_32k`` rules, its last
  logits within 1e-5 of the plain one's largest (at least 1);
- ``decode``: greedy decode steps under the ``decode_32k`` rules from the
  plain prefill's cache, the logits within 2e-6 of the largest (at least
  1) and the same ids;
- ``step``: one train step (``get_train_step(mesh=...)`` under the
  activation mesh) from the plain step's state: loss within 1e-5 and grad
  norm within 2e-5 relative, Adam moments within 2e-5 of each leaf's
  largest entry plus 1e-8 of the largest moment of all (a leaf whose
  gradient vanishes holds round-off alone).

:data:`LAYOUTS` adds the layouts the full configurations take on 16
ranks where their head counts do not divide "model", each at a smoke
size whose counts fail to divide its mesh's axis the same way: the
key-split attention and ``wo``'s product on each rank's rows (Yi-34B's
56 heads, RecurrentGemma's 10; prefill and step), InternVL2's residual
after its prefix embeddings (14 heads), and ``long_decode``: 10 greedy
steps at batch 1 under the ``long_500k`` rules (the cache's slots over
"data", the query heads over "model": danube's 32 of 8 KV heads, 2 a
rank), at the decode's tolerance; and ``block_diag``: RecurrentGemma's
block-diagonal gates on 3 heads over 2 ranks, the weight split inside the
heads (as ``params_shardings``' salvage pass splits a stacked weight of
8 MB or more), output and gradients within 1e-6 of the plain ones.

A rank process runs ``header + body``: the header starts the group on a
``FileStore`` and its ``mesh`` (:func:`start`), which the checks below
take first.  Every rank must print ``RANK_OK``.

On the CPU, from the repo root (one process a rank, every family in
turn on a mesh's ranks, the meshes at once; ``--jobs`` bounds the ranks
that run at once, default the CPU count):

  python3 src_torch/tools/sharded_ranks.py --mesh 1x2 --mesh 2x2
  python3 src_torch/tools/sharded_ranks.py --arch granite-moe-1b-a400m \\
      --mesh 1x4 --paths decode --steps 10
  python3 src_torch/tools/sharded_ranks.py --layouts

It prints one JSON line per (arch, mesh, path) -- ``ok``, the largest
error and its tolerance, the seconds -- and exits 1 if any failed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
SRC_TORCH = os.path.dirname(HERE)
if SRC_TORCH not in sys.path:
    sys.path.insert(0, SRC_TORCH)

from repro_torch.config import list_archs  # noqa: E402

#: every registered family but the quickstart MLP (the dry-run's rule)
ARCHS = tuple(a for a in list_archs() if a != "flower-quickstart")
PATHS = ("prefill", "decode", "step")
#: heads that split neither 2 ranks of "model" nor their KV heads over
#: them: the key-split attention, as Yi-34B's 56 / 8, InternVL2's 14 / 2
#: and RecurrentGemma's 10 / 1 on 16 ranks (on the families' (1, 2) ranks:
#: no rank start-up of its own)
KEY_SPLIT_HEADS = dict(num_heads=3, num_kv_heads=1, head_dim=32)
#: RecurrentGemma's: the RG-LRU's width, split over 2 ranks, cut into the
#: heads
RG_KEY_SPLIT_HEADS = dict(KEY_SPLIT_HEADS, lru_width=96)
#: 2 query heads a rank of 2, one KV head: as danube's 32 / 8 on 16
LONG_DECODE_HEADS = dict(num_heads=4, num_kv_heads=1)
#: the repaired layouts: (arch, path, mesh, config overrides)
LAYOUTS = (
    ("yi-34b", "prefill", (1, 2), KEY_SPLIT_HEADS),
    ("yi-34b", "step", (1, 2), KEY_SPLIT_HEADS),
    ("recurrentgemma-2b", "step", (1, 2), RG_KEY_SPLIT_HEADS),
    ("internvl2-1b", "prefill", (1, 2), KEY_SPLIT_HEADS),
    ("internvl2-1b", "step", (1, 2), KEY_SPLIT_HEADS),
    ("h2o-danube-1.8b", "long_decode", (2, 2), LONG_DECODE_HEADS),
    ("recurrentgemma-2b", "block_diag", (1, 2), {}),
)
BLOCK_DIAG_TOL = 1e-6
#: the long decode's steps
LONG_DECODE_STEPS = 10
#: the prefill's and the train step's sequence length
SEQ = 32
PREFILL_TOL, DECODE_TOL = 1e-5, 2e-6
LOSS_RTOL, GNORM_RTOL, MOMENT_RTOL, MOMENT_FLOOR = 1e-5, 2e-5, 2e-5, 1e-8
RESULT = "SHARDED_RANKS_RESULT "

_HEADER = """
import os, sys
sys.path[:0] = [{src!r}, {tools!r}]
import torch, torch.distributed as dist
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", store=dist.FileStore({store!r}, WORLD),
                        rank=RANK, world_size=WORLD)
DATA, MODEL = {data}, {model}
import sharded_ranks as SR
SR.strict_flatten()
mesh = SR.start(DATA, MODEL)
"""


class RankFailure(AssertionError):
    """A rank that did not print ``RANK_OK``; its output's tail."""


def run_ranks(body: str, data: int, model: int, workdir,
              timeout: float) -> List[str]:
    """Run ``body`` in ``data`` x ``model`` fresh interpreters, one gloo
    rank each, after the header (the group, ``mesh``, this module as
    ``SR``); returns each rank's output, or raises :class:`RankFailure`
    with the first failed rank's.  Every rank is killed at ``timeout``."""
    world = data * model
    # a FileStore's file serves one group: each call starts its own
    d = Path(tempfile.mkdtemp(dir=workdir))
    code = textwrap.dedent(_HEADER).format(
        src=SRC_TORCH, tools=HERE, store=str(d / "store"), data=data,
        model=model) + textwrap.dedent(body) + \
        "\ndist.destroy_process_group()\nprint('RANK_OK', flush=True)\n"
    script = d / "rank.py"
    script.write_text(code)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(world)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    outs = []
    t_end = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(t_end - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += f"\n[rank killed at its {timeout} s limit]"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, out in enumerate(outs):
        if "RANK_OK" not in out:
            raise RankFailure(f"rank {r} of {data}x{model}:\n{out[-3000:]}")
    return outs


# ---------------------------------------------------------------------------
# in a rank process
# ---------------------------------------------------------------------------
def start(data: int, model: int):
    """This rank's ``(data, model)`` mesh on its process group."""
    from repro_torch.launch.mesh import make_local_mesh

    return make_local_mesh(data=data, model=model, device="cpu")


def strict_flatten() -> None:
    """Torch 2.11's rule for a DTensor ``view`` that flattens dims, on a
    later torch that has relaxed it: a flattened dim other than the first
    that a mesh dim splits raises, as on the card (torch 2.11 has no
    ``_ViewShardingPropagator``; there this is a no-op)."""
    from torch.distributed.tensor._ops import _view_ops

    cls = getattr(_view_ops, "_ViewShardingPropagator", None)
    if cls is None or getattr(cls, "_strict_flatten", False):
        return
    orig = cls._analyze_flatten

    def analyze(self, cmd):
        if self.strict_view:
            for dim in cmd.input_dims[1:]:
                if self._find_plain_shard(dim)[0] is not None:
                    raise RuntimeError(
                        "Attempted to flatten multiple dimensions, with "
                        f"dimension {dim.input_dim} being sharded. It cannot "
                        "be performed without redistribution, which is "
                        "disallowed by the current operator.")
        return orig(self, cmd)

    cls._analyze_flatten = analyze
    cls._strict_flatten = True
    cls._torch_flatten = orig


@contextlib.contextmanager
def torch_flatten():
    """This torch's own rule for a flattening view while the block runs
    (:func:`strict_flatten` undone): for a yardstick the port does not
    take on the card."""
    from torch.distributed.tensor._ops import _view_ops

    cls = getattr(_view_ops, "_ViewShardingPropagator", None)
    if cls is None or not getattr(cls, "_strict_flatten", False):
        yield
        return
    strict, cls._analyze_flatten = cls._analyze_flatten, cls._torch_flatten
    try:
        yield
    finally:
        cls._analyze_flatten = strict


def _check(ok: bool, *what) -> None:
    """An assertion that ``python -O`` keeps."""
    if not ok:
        raise AssertionError(what)


def sharded(mesh, fn):
    """``fn()`` under the activation mesh, batch over "data"."""
    from repro_torch import sharding as shlib

    shlib.set_activation_mesh(mesh, batch_axes=("data",))
    try:
        return fn()
    finally:
        shlib.set_activation_mesh(None)


def smoke(arch: str, **over):
    import repro_torch.config as TC
    from repro_torch.models import build_model

    cfg = TC.get_model_config(arch, smoke=True).replace(dtype="float32",
                                                        **over)
    return cfg, build_model(cfg)


def _torch_batch(batch):
    import torch

    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _err(got, want) -> Tuple[float, float]:
    """(largest absolute error, the scale: the largest entry, at least
    1)."""
    return (float((got - want).abs().max()),
            max(1.0, float(want.abs().max())))


def _placed(mesh, model, rules, params, batch):
    from repro_torch.launch.shardings import batch_shardings, params_shardings
    from repro_torch.train import steps as TS

    return (TS.distribute_tree(params, params_shardings(model, mesh,
                                                        rules=rules)),
            TS.distribute_tree(batch, batch_shardings(batch, mesh,
                                                      rules=rules)))


def check_prefill(mesh, arch: str, B: int = 4, S: int = SEQ,
                  **over) -> Dict:
    """The sharded prefill's last logits against the plain one's."""
    from torch.distributed.tensor.experimental import implicit_replication

    import repro_torch.config as TC
    from repro_torch.launch.shardings import rules_for_shape
    from repro_torch.train import steps as TS

    cfg, model = smoke(arch, **over)
    params = model.init(3, device="cpu")
    batch = _torch_batch(model.make_batch(
        TC.InputShape("prefill", S, B, "prefill"), seed=19))
    prefill = TS.make_prefill_step(model, max_len=S)
    want, _ = prefill(params, batch)
    p_d, b_d = _placed(mesh, model,
                       rules_for_shape(TC.INPUT_SHAPES["prefill_32k"]),
                       params, batch)

    def run():
        with implicit_replication():
            return prefill(p_d, b_d)

    got, _ = sharded(mesh, run)
    err, scale = _err(got.full_tensor(), want)
    _check(err <= PREFILL_TOL * scale, arch, "prefill", err, scale)
    return {"max_err": err / scale, "tol": PREFILL_TOL}


def decode_cache_len(cfg, prompt: int, steps: int) -> int:
    """A cache of at least the prompt, a VLM's prefix and the steps, a
    multiple of 12 (so its slots split over 2, 3 or 4 ranks)."""
    need = prompt + (cfg.num_prefix_tokens if cfg.frontend == "vision"
                     else 0) + steps
    return -(-need // 12) * 12


def decode_setup(mesh, arch: str, B: int, L: int, prompt: int,
                 shape: str = "decode_32k", **over):
    """``(cfg, model, params, placed params, last logits, cache, placed
    cache)``: the plain prefill of a ``prompt``-token batch (with its
    embeddings) into an ``L``-slot cache, the params and cache placed by
    ``shape``'s rules."""
    import repro_torch.config as TC
    from repro_torch.launch.shardings import (cache_shardings,
                                              params_shardings,
                                              rules_for_shape)
    from repro_torch.train import steps as TS

    rules = rules_for_shape(TC.INPUT_SHAPES[shape])
    cfg, model = smoke(arch, **over)
    params = model.init(3, device="cpu")
    batch = _torch_batch(model.make_batch(
        TC.InputShape("prefill", prompt, B, "prefill"), seed=11))
    last, cache = TS.make_prefill_step(model, max_len=L)(params, batch)
    p_d = TS.distribute_tree(params, params_shardings(model, mesh,
                                                      rules=rules))
    c_d = TS.distribute_tree(cache, cache_shardings(model, B, L, mesh,
                                                    rules=rules)[0])
    return cfg, model, params, p_d, last, cache, c_d


def check_decode(mesh, arch: str, B: int = 2, prompt: int = 7,
                 steps: int = 4, shape: str = "decode_32k",
                 **over) -> Dict:
    """Greedy decode steps under ``shape``'s rules, sharded and plain,
    each from its own cache: the logits within 2e-6 of the largest, the
    same ids."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    import repro_torch.config as TC
    from repro_torch.launch.shardings import batch_shardings, rules_for_shape
    from repro_torch.train import steps as TS

    cfg, _ = smoke(arch, **over)
    L = decode_cache_len(cfg, prompt, steps)
    cfg, model, params, p_d, last, cache, c_d = decode_setup(
        mesh, arch, B, L, prompt, shape, **over)
    decode = TS.make_decode_step(model)
    t_sh = batch_shardings({"tokens": (B, 1)}, mesh, rules=rules_for_shape(
        TC.INPUT_SHAPES[shape]))["tokens"]
    tok = torch.argmax(last, -1)[:, None]
    worst = 0.0
    for t in range(steps):
        want, cache = decode(params, cache, tok)

        def run():
            with implicit_replication():
                return decode(p_d, c_d, TS.distribute_tree(tok, t_sh))

        got, c_d = sharded(mesh, run)
        got = got.full_tensor()
        err, scale = _err(got, want)
        _check(err <= DECODE_TOL * scale, arch, t, "logits", err, scale)
        worst = max(worst, err / scale)
        ids = torch.argmax(want, -1)
        _check(torch.equal(torch.argmax(got, -1), ids), arch, t, "ids")
        tok = ids[:, None]
    return {"max_err": worst, "tol": DECODE_TOL, "steps": steps}


def check_step(mesh, arch: str, seq: int = SEQ, steps: int = 1, B: int = 4,
               **over) -> Dict:
    """Train steps, sharded and plain, from the same state and batches."""
    import repro_torch.config as TC
    from repro_torch.models import build_model
    from repro_torch.train import steps as TS
    from repro_torch.utils.pytree import tree_flatten_with_paths

    cfg, _ = smoke(arch, **over)
    tt = TC.TrainConfig(global_batch=B, seq_len=seq, learning_rate=1e-2,
                        warmup_steps=2, total_steps=10, grad_clip=1.0,
                        microbatches=1)
    plain = TS.get_train_step(cfg, tt, device="cpu")
    step = TS.get_train_step(cfg, tt, mesh=mesh)
    model = build_model(cfg)
    a = b = TS.make_train_state(model, tt, 3, device="cpu")
    loss_err = gnorm_err = 0.0
    for t in range(steps):
        batch = model.make_batch(B, seq, seed=23 + t)
        a, ma = plain(a, batch)
        b, mb = sharded(mesh, lambda: step(b, batch))
        la, lb = float(ma["loss"]), float(mb["loss"])
        loss_err = max(loss_err, abs(lb / la - 1))
        _check(abs(lb / la - 1) <= LOSS_RTOL, arch, t, la, lb)
        ga, gb = float(ma["grad_norm"]), float(mb["grad_norm"])
        gnorm_err = max(gnorm_err, abs(gb / ga - 1))
        _check(abs(gb / ga - 1) <= GNORM_RTOL, arch, t, ga, gb)
    got = dict(tree_flatten_with_paths(TS.full_tree(b)))
    want = {k: w for k, w in tree_flatten_with_paths(a)
            if k.startswith(".opt_state")}
    # a leaf whose gradient vanishes (xLSTM's input-gate bias: the gate's
    # exponent cancels against its stabiliser) holds round-off alone: an
    # fp32 floor of 1e-8 of the largest moment
    floor = MOMENT_FLOOR * max(float(w.abs().max()) for w in want.values())
    share = 0.0
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        limit = MOMENT_RTOL * float(w.abs().max()) + floor
        share = max(share, err / limit)
        _check(err <= limit, arch, k, err)
    return {"max_err": loss_err, "tol": LOSS_RTOL,
            "grad_norm_rel_err": gnorm_err, "moments_share_of_tol": share}


def check_block_diag(mesh) -> Dict:
    """``recurrent._block_diag_apply`` on 3 heads of 4, which a "model"
    axis of 2 does not divide, the width split over the axis and the
    weight split over each per-head dim in turn: output and the gradients
    of x and w against the plain ones."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import recurrent

    heads, per = 3, 4
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, heads * per, generator=g)
    w = torch.randn(heads, per, per, generator=g)
    ct = torch.randn(2, 6, heads * per, generator=g)
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = recurrent._block_diag_apply(wp, xp, heads)
    (want * ct).sum().backward()
    worst = 0.0
    for dim in (1, 2):
        xd = distribute_tensor(x, mesh, [Replicate(), Shard(2)]
                               ).requires_grad_()
        wd = distribute_tensor(w, mesh, [Replicate(), Shard(dim)]
                               ).requires_grad_()

        def run():
            y = recurrent._block_diag_apply(wd, xd, heads)
            (y * distribute_tensor(ct, mesh, y.placements)).sum().backward()
            return y

        y = sharded(mesh, run)
        for name, got, ref in (("y", y, want), ("dx", xd.grad, xp.grad),
                               ("dw", wd.grad, wp.grad)):
            err = float((got.full_tensor() - ref).abs().max())
            _check(err <= BLOCK_DIAG_TOL, "block_diag", dim, name, err)
            worst = max(worst, err)
    return {"max_err": worst, "tol": BLOCK_DIAG_TOL}


def run_checks(mesh, checks: Sequence[Tuple[str, str, Dict]],
               decode_steps: int = 4) -> bool:
    """Each ``(arch, path, config overrides)`` of ``checks``, one after
    another; rank 0 prints a result line for each.  A check that raises
    is reported and the next one runs (every rank raises alike: the ranks
    hold the same gathered values).  Returns whether every check
    passed."""
    import torch.distributed as dist

    runs = {"prefill": lambda arch, over: check_prefill(mesh, arch, **over),
            "decode": lambda arch, over: check_decode(
                mesh, arch, steps=decode_steps, **over),
            "step": lambda arch, over: check_step(mesh, arch, **over),
            "long_decode": lambda arch, over: check_decode(
                mesh, arch, B=1, steps=LONG_DECODE_STEPS,
                shape="long_500k", **over),
            "block_diag": lambda arch, over: check_block_diag(mesh, **over)}
    ok_all = True
    for arch, path, over in checks:
        t0 = time.perf_counter()
        try:
            res = dict(runs[path](arch, over), ok=True)
        except Exception as e:  # noqa: BLE001 -- one path's failure is its line
            ok_all = False
            tb = traceback.extract_tb(e.__traceback__)
            ours = [f for f in tb if "repro_torch" in f.filename]
            where = ours[-1] if ours else tb[-1]
            res = {"ok": False, "error": f"{type(e).__name__}: {e}"[:1500],
                   "where": f"{where.filename.rsplit('src_torch/')[-1]}"
                            f":{where.lineno}"}
        res = dict(arch=arch, path=path, over=over,
                   seconds=round(time.perf_counter() - t0, 2), **res)
        if dist.get_rank() == 0:
            print(RESULT + json.dumps(res), flush=True)
    return ok_all


# ---------------------------------------------------------------------------
# every family on every mesh: a job a mesh, the meshes in parallel
# ---------------------------------------------------------------------------
def _job(checks: Sequence[Tuple[str, str, Dict]], data: int, model: int,
         decode_steps: int, workdir, timeout: float) -> List[Dict]:
    """Every check of one mesh on one set of ranks (a rank's start-up,
    the group and the first sharded ops, is most of a family's time)."""
    body = (f"import sys\nif not SR.run_checks(mesh, {list(checks)!r}, "
            f"{decode_steps}):\n    sys.exit(1)\n")
    t0 = time.perf_counter()
    try:
        outs = run_ranks(body, data, model, workdir, timeout)
        failure = None
    except RankFailure as e:
        outs, failure = [str(e)], str(e)
    lines = [json.loads(line[len(RESULT):]) for out in outs[:1]
             for line in out.splitlines() if line.startswith(RESULT)]
    if failure is not None:
        # a rank that died: the paths it did not report failed, with its
        # output
        seen = {(r["arch"], r["path"], repr(r["over"])) for r in lines}
        lines += [{"arch": a, "path": p, "over": o, "ok": False,
                   "error": failure[-1500:]}
                  for a, p, o in checks if (a, p, repr(o)) not in seen]
        if all(r["ok"] for r in lines):
            lines.append({"arch": checks[-1][0], "path": "ranks",
                          "ok": False, "error": failure[-1500:]})
    for r in lines:
        r["mesh"] = f"{data}x{model}"
        r["job_s"] = round(time.perf_counter() - t0, 2)
    return lines


def _cpus() -> int:
    return len(os.sched_getaffinity(0))


def run_all(archs: Sequence[str], meshes: Sequence[Tuple[int, int]],
            paths: Sequence[str] = PATHS, decode_steps: int = 4,
            jobs=None, timeout: float = 600, workdir=None,
            emit=None, layouts: Sequence = ()) -> List[Dict]:
    """Every arch's checks on each mesh, and each of ``layouts`` (as
    :data:`LAYOUTS`) on its own mesh: a job a mesh, the largest first, as
    many ranks at once as ``jobs`` allows: a count, or a function that
    returns the count free now (polled); default the CPUs this process
    may use.  ``emit`` sees each result line as its job ends.  Returns
    the lines."""
    total = _cpus()
    cap = jobs if callable(jobs) else (lambda: jobs or total)
    by_mesh: Dict[Tuple[int, int], List] = {
        tuple(m): [(a, p, {}) for a in archs for p in paths] for m in meshes}
    for arch, path, mesh, over in layouts:
        by_mesh.setdefault(tuple(mesh), []).append((arch, path, dict(over)))
    todo = sorted(by_mesh, key=lambda m: -m[0] * m[1])
    results: List[Dict] = []
    lock = threading.Condition()
    busy = [0]

    def one(data, model):
        try:
            lines = _job(by_mesh[data, model], data, model, decode_steps,
                         workdir, timeout)
        finally:
            with lock:
                busy[0] -= data * model
                lock.notify_all()
        with lock:
            results.extend(lines)
            for r in lines:
                if emit is not None:
                    emit(r)

    threads = []
    with tempfile.TemporaryDirectory(dir=workdir) as wd:
        workdir = wd
        for data, model in todo:
            n = data * model
            with lock:
                while True:
                    free = cap()
                    if busy[0] + n <= free or (
                            not busy[0] and free >= min(n, total)):
                        break
                    lock.wait(timeout=0.5)
                busy[0] += n
            t = threading.Thread(target=one, args=(data, model))
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
    return results


def _mesh(s: str) -> Tuple[int, int]:
    data, model = (int(v) for v in s.lower().split("x"))
    return data, model


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", default=None,
                    help="repeatable; default: every family")
    ap.add_argument("--mesh", action="append", type=_mesh, default=None,
                    help="DATAxMODEL, repeatable; default 1x2 and 2x2")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--steps", type=int, default=4, help="decode steps")
    ap.add_argument("--jobs", type=int, default=None,
                    help="ranks at once (default: the CPUs this process "
                         "may use)")
    ap.add_argument("--timeout", type=float, default=600,
                    help="seconds a mesh's ranks may take")
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--layouts", action="store_true",
                    help="run LAYOUTS, each on its own mesh, instead of "
                         "the families")
    args = ap.parse_args(argv)
    paths = [p for p in args.paths.split(",") if p]
    bad = set(paths) - set(PATHS)
    if bad:
        ap.error(f"unknown paths {sorted(bad)}")

    def emit(r):
        print(json.dumps(r), flush=True)

    t0 = time.perf_counter()
    if args.layouts:
        lines = run_all((), (), jobs=args.jobs, timeout=args.timeout,
                        emit=emit, layouts=LAYOUTS)
    else:
        lines = run_all(args.arch or ARCHS, args.mesh or [(1, 2), (2, 2)],
                        paths, args.steps, args.jobs, args.timeout,
                        emit=emit)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
    n_bad = sum(not r["ok"] for r in lines)
    print(f"sharded ranks: {len(lines) - n_bad} ok, {n_bad} failed, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
