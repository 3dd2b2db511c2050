"""Traffic kind ``sparse_fold``: the server's FedAvg fold of one round of
sites' structured-sparse 0xF5 TopK deltas, closed loop, each round's
result the next round's base.

Set-up draws on the card, from the seed, the first global model (fp32)
and each site's delta: ``frac`` of the coordinates without replacement
(the set a TopK of an i.i.d. delta picks), int8 values and one fp32 scale
a ``QCHUNK`` of them, and unequal example counts; the frames are written on
the host by the frozen 0xF5 writer and kept in memory.  A round is what
the server does with the frames: ``decode_fit_res``, the round base
attached, ``acc.add`` for each site, then ``acc.finalize``: the new global
model as host fp32 arrays.

Once the window has closed, three rounds are folded again by the plain
reference and compared bit for bit: the first (set-up's, from the
benchmark's own model), one of the window's drawn from the seed, and the
last; each of the latter two from the program's result of the round
before it, which is the program's state the reference has to follow.

Parameters: ``config`` names the model whose parameters the fold holds;
``sites``, ``frac``, ``examples`` (low, high), ``strategy``,
``trace_rounds``.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import counts, trace, weights, wire
from portbench.reference import fold as ref_fold
from portbench.reference import transformer as ref_tf

QCHUNK = wire.QCHUNK


def draw(run, n: int) -> Dict:
    """The round's inputs from the seed: the first model (fp32 host
    vector) and per site its name, indices, values, scales and weight."""
    p, dev = run.params, run.device
    g = weights.generator(run.seed, dev)
    base = (torch.randn(n, generator=g, device=dev) * 0.02).cpu().numpy()
    k = max(1, int(math.ceil(p["frac"] * n)))
    lo, hi = p["examples"]
    sites = []
    for s in range(p["sites"]):
        idx = torch.randperm(n, generator=g, device=dev)[:k]
        idx = torch.sort(idx).values
        vals = torch.randint(-127, 128, (k,), generator=g, device=dev,
                             dtype=torch.int8)
        nsc = -(-k // QCHUNK)
        scales = torch.pow(10.0, torch.rand(nsc, generator=g, device=dev)
                           * 2.0 - 7.0)
        w = int(torch.randint(lo, hi + 1, (1,), generator=g, device=dev))
        sites.append((f"site-{s:02d}", idx.cpu().numpy(),
                      vals.cpu().numpy(),
                      scales.to(torch.float32).cpu().numpy(), float(w)))
        del idx, vals, scales
    return {"base": base, "sites": sites, "k": k}


def flat_of(arrays: List[np.ndarray], layout):
    """``arrays`` (a fold's result: views of one buffer) as the
    ``FlatParams`` the next round's deltas are taken against, without a
    copy where they are such views; packed otherwise."""
    from repro_torch.fl.flat import FlatParams

    root = arrays[0]
    while isinstance(root.base, np.ndarray):
        root = root.base
    if root.dtype == np.uint8 and root.ndim == 1 \
            and root.nbytes == layout.total_bytes:
        return FlatParams(root, layout)
    return FlatParams.from_arrays(arrays, layout)


class Rounds:
    """The server's rounds over the fixed frames; the harness's host
    clock around each call into the program, by call."""

    def __init__(self, run, frames, layout, base):
        from repro_torch.fl.strategy import make_strategy

        self.run, self.frames, self.layout = run, frames, layout
        self.strategy = make_strategy(run.params["strategy"],
                                      backend="torch", device=run.device)
        self.base = base
        self.current = base.to_arrays()
        self.rnd = 0
        self.host = {"decode": 0.0, "add": 0.0, "finalize": 0.0}

    def one(self) -> List[np.ndarray]:
        from repro_torch.fl.messages import decode_fit_res

        run, host = self.run, self.host
        self.rnd += 1
        acc = self.strategy.fit_accumulator(self.rnd, self.current)
        for node, frame in self.frames:
            t = time.perf_counter()
            with run.span("decode"):
                res = decode_fit_res(frame)
                res.sparse.base = self.base
            t1 = time.perf_counter()
            with run.span("add"):
                acc.add(node, res)
            t2 = time.perf_counter()
            host["decode"] += t1 - t
            host["add"] += t2 - t1
        t = time.perf_counter()
        with run.span("finalize"):
            out, _ = acc.finalize([])
        host["finalize"] += time.perf_counter() - t
        self.current = out
        self.base = flat_of(out, self.layout)
        return out


def inputs(run):
    """(layout, leaf shapes, :func:`draw`'s inputs) of the cell's model."""
    from repro_torch.fl.flat import layout_for

    shapes = [tuple(v[0])
              for v in ref_tf.param_layout(run.cell.config).values()]
    layout = layout_for([("float32", s) for s in shapes])
    return layout, shapes, draw(run, layout.total_size)


def run(run) -> Dict:
    from repro_torch.fl.flat import FlatParams

    p, dev = run.params, run.device
    cuda = dev.type == "cuda"
    layout, shapes, d = inputs(run)
    frames = [(name, wire.sparse_frame(shapes, int(w), idx, vals, sc))
              for name, idx, vals, sc, w in d["sites"]]
    base0 = FlatParams(d["base"].view(np.uint8), layout)
    rounds = Rounds(run, frames, layout, base0)
    # the first round warms up every shape (and builds the kernels on a
    # fresh checkout); its result is the first one checked
    first = rounds.one()
    setup_s = time.perf_counter() - run.t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    rounds.host = {k: 0.0 for k in rounds.host}
    # a window round drawn from the seed (reservoir sampling: each round
    # equally likely, whatever their number) and the last one are checked
    rng = np.random.default_rng(run.seed)
    done = 0
    round_ms = []
    t_start = time.perf_counter()
    while True:
        inp = rounds.base
        t = time.perf_counter()
        res = rounds.one()
        round_ms.append((time.perf_counter() - t) * 1e3)
        done += 1
        if rng.integers(done) == 0:
            sampled = (inp, res)
        last = (inp, res)
        if time.perf_counter() - t_start >= run.seconds:
            break
    window_s = time.perf_counter() - t_start
    del inp, res
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    host = {k: v / done for k, v in rounds.host.items()}
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    bound = counts.scatter_bound_s(d["k"], kind, True, -(-d["k"] // QCHUNK))
    record = {"window_rounds": done, "window_s": window_s,
              "host_s_per_round": host, "device_kind": kind,
              "scatter_bound_s_per_round":
                  None if bound is None else bound * p["sites"]}
    out = {"end_to_end": {"fold_ms": window_s / done * 1e3,
                          "setup_s": setup_s},
           "record": record, "attempted": done * p["sites"], "failed": 0,
           "memory_peak_bytes": window_peak}
    run.log(f"set-up {setup_s:.1f} s; window {done} rounds in "
            f"{window_s:.2f} s; peak {window_peak / 1e9:.2f} GB; a round "
            f"(ms): decode {host['decode'] * 1e3:.1f}, add "
            f"{host['add'] * 1e3:.1f}, finalize "
            f"{host['finalize'] * 1e3:.1f}; each round (ms): "
            + " ".join(f"{x:.0f}" for x in round_ms))
    if run.trace:
        t_trace = time.perf_counter()
        n = p["trace_rounds"]

        def traced_rounds():
            for _ in range(n):
                rounds.one()

        # the busy share from a trace of the device alone, the kernel's
        # time and the breakdown from a trace of host and device
        dp = trace.device_pass(traced_rounds, dev, (trace.SPAN,))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with run.span("window"):
                traced_rounds()
        events = prof.events()
        b = trace.busy(events)
        record["traced"] = dict(
            rounds=n, scatter_s=trace.kernel_seconds(events, "scatter_wsum"),
            busy_s=dp["busy_s"], window_s=dp["window_s"])
        out.update(busy_s=dp["busy_s"], window_s=dp["window_s"],
                   breakdown={"device_ops": trace.top_ops(events),
                              "idle_gaps": trace.top_gaps(b)})
        del prof, events
        run.log(f"traced {n} rounds ({dp['window_s'] / n * 1e3:.0f} ms a "
                f"round under the device trace), read in "
                f"{time.perf_counter() - t_trace:.1f} s")
    # the program's results are what is judged; its state goes before
    # the reference runs
    judged = {"first_round": (base0, first), "sampled_round": sampled,
              "last_round": last}
    judged = {k: (b.math_view(), np.concatenate([a.reshape(-1) for a in r]))
              for k, (b, r) in judged.items()}
    del rounds, first, sampled, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    out["checks"] = {}
    for k, (b, got) in judged.items():
        want = ref_fold.fold(b, d["sites"], QCHUNK, device=dev)
        bad = ref_fold.mismatches(got, want)
        out["checks"][k + "_mismatches"] = (bad, run.limits[k + "_mismatches"])
    record["reference_s"] = time.perf_counter() - t_ref
    run.log(f"reference {record['reference_s']:.1f} s")
    return out
