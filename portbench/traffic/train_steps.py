"""Traffic kind ``train_steps``: a federated site's local training, closed
loop (the next step starts when the last one has ended in a device sync).

Set-up makes the weights on the card from the seed, the token batches on
the host by the program's Markov generator, and one ``TrainState``; its
first ``checked_steps`` steps go through the window's own call and feed
(``get_train_step(cfg, tcfg, impl)``) on batches that all differ, and warm
up every shape the window uses.  Their losses, the first clipped gradient
as the optimizer holds it (AdamW's first moment over ``1 - beta1``) and the
parameters' change after them are what the plain fp32 reference is
compared with once the window has closed and the program's state is gone.

Parameters (the workload file's ``params``): ``batch`` rows of ``seq_len``
tokens a step in ``microbatches``; the AdamW settings; ``impl``;
``distinct_batches`` drawn (the window cycles through them);
``checked_steps``; ``trace_steps`` profiled after the window in a traced
run; ``markov`` (the generator's site and mixing).
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict

import torch

from portbench import counts, markov, trace, weights
from portbench.archs import port_config
from portbench.reference import transformer as ref

#: a leaf whose reference gradient is under this share of the median
#: leaf's moves by round-off alone under Adam: its change is not compared
DEAD_LEAF = 1e-3
HYPER = ("learning_rate", "warmup_steps", "total_steps", "weight_decay",
         "beta1", "beta2", "eps", "grad_clip", "microbatches")


def hyper(p: Dict) -> Dict:
    return {k: p[k] for k in HYPER}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_layout(abstract: Dict, layout: Dict) -> None:
    """The program's parameter tree has the reference's keys and
    shapes."""
    got = {k: tuple(v.shape) for k, v in ref.flatten(abstract).items()}
    want = {k: tuple(v[0]) for k, v in layout.items()}
    if got != want:
        raise ValueError(f"the program's parameters {got} are not the "
                         f"reference's {want}")


def gaps(prog: Dict, want: Dict) -> Dict[str, float]:
    """The numbers compared: the largest relative loss gap over the
    checked steps, and by the worst leaf the gap between the program's and
    the reference's norm of the first clipped gradient and of the change,
    each against the larger of that leaf's reference norm and the median
    leaf's.  Leaves whose reference gradient is under ``DEAD_LEAF`` of the
    median leaf's are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   want["losses"]))
    g_med = statistics.median(want["first_grad"].values())
    grad = max(abs(prog["first_grad"][k] - v) / max(v, g_med)
               for k, v in want["first_grad"].items())
    live = [k for k, v in want["first_grad"].items()
            if v >= DEAD_LEAF * g_med]
    c_med = statistics.median(want["change"][k] for k in live)
    change = max(abs(prog["change"][k] - want["change"][k])
                 / max(want["change"][k], c_med) for k in live)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def setup(run):
    """Everything before the window: (step_fn, state, batches, the
    checked steps' readings, record)."""
    from repro_torch.config import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train.steps import TrainState, get_train_step

    p, conf, dev = run.params, run.cell.config, run.device
    mcfg = port_config(conf)
    tcfg = TrainConfig(global_batch=p["batch"], seq_len=p["seq_len"],
                       optimizer="adamw", seed=0, **hyper(p))
    layout = ref.param_layout(conf)
    check_layout(build_model(mcfg).abstract(), layout)
    batches = markov.batches(int(conf["vocab_size"]), p["seq_len"],
                             p["batch"], p["distinct_batches"], run.seed,
                             **p["markov"])
    step_fn = get_train_step(mcfg, tcfg, impl=p["impl"], device=dev)
    params = ref.nest(weights.make(layout, run.seed, dev))
    state = TrainState(params, make_optimizer(tcfg).init(params),
                       torch.zeros((), dtype=torch.int32, device=dev))
    del params
    prog = {"losses": []}
    for i in range(p["checked_steps"]):
        with run.span("step"):
            state, m = step_fn(state, batches[i])
            prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["first_grad"] = {
                k: float(t.double().norm()) / (1.0 - p["beta1"])
                for k, t in ref.flatten(state.opt_state.mu).items()}
    p0 = weights.make(layout, run.seed, dev)
    now = ref.flatten(state.params)
    prog["change"] = {k: float((now[k].double() - p0[k].double()).norm())
                      for k in p0}
    del p0, now
    _sync(dev)
    return step_fn, state, batches, prog, layout


def run(run) -> Dict:
    p, conf, dev = run.params, run.cell.config, run.device
    from repro_torch.train.steps import UPDATE_SPAN

    step_fn, state, batches, prog, layout = setup(run)
    cuda = dev.type == "cuda"
    setup_s = time.perf_counter() - run.t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    nb, i = len(batches), p["checked_steps"]
    steps = failed = 0
    t_start = time.perf_counter()
    while True:
        with run.span("step"):
            state, m = step_fn(state, batches[i % nb])
            loss = float(m["loss"])        # the step ends in a device sync
        i += 1
        steps += 1
        failed += not math.isfinite(loss)
        if time.perf_counter() - t_start >= run.seconds:
            break
    window_s = time.perf_counter() - t_start
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    tokens = p["batch"] * p["seq_len"]
    record = {"window_steps": steps, "window_s": window_s,
              "tokens_per_step": tokens,
              "model_flops_per_step": counts.train_model_flops(
                  conf, p["batch"], p["seq_len"]),
              "device_kind": torch.cuda.get_device_name(dev) if cuda
              else "cpu",
              "peak_window_bytes": window_peak}
    out = {"end_to_end": {"train_tokens_per_s": steps * tokens / window_s,
                          "setup_s": setup_s},
           "record": record, "attempted": steps, "failed": failed,
           "memory_peak_bytes": window_peak}
    run.log(f"set-up {setup_s:.1f} s; window {steps} steps in "
            f"{window_s:.2f} s")
    if run.trace:
        t_trace = time.perf_counter()
        n = p["trace_steps"]

        def traced_steps():
            # the one state steps on: a second reference would keep the
            # old state's parameters and moments alive
            nonlocal state, i
            for _ in range(n):
                with run.span("step"):
                    state, m = step_fn(state, batches[i % nb])
                    float(m["loss"])
                i += 1

        # the busy share from a trace of the device alone (recording each
        # host op would lengthen the step), the split and the breakdown
        # from a trace of host and device
        dp = trace.device_pass(traced_steps, dev, (UPDATE_SPAN, trace.SPAN))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        _sync(dev)
        with torch.profiler.profile(activities=acts,
                                    record_shapes=True) as prof:
            with run.span("window"):
                traced_steps()
                _sync(dev)
        events = prof.events()
        b = trace.busy(events)
        record["traced"] = dict(
            steps=n, split=trace.device_split(events, UPDATE_SPAN,
                                              p["seq_len"]),
            busy_s=dp["busy_s"], window_s=dp["window_s"],
            window_step_s=window_s / steps)
        out.update(busy_s=dp["busy_s"], window_s=dp["window_s"],
                   breakdown={"device_ops": trace.top_ops(events),
                              "idle_gaps": trace.top_gaps(b)})
        del prof, events
        run.log(f"traced {n} steps ({dp['window_s'] / n:.3f} s a step "
                f"under the device trace, {window_s / steps:.3f} s in the "
                f"window), read in {time.perf_counter() - t_trace:.1f} s")
    del state, m, step_fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the reference, from the same weights (made again from the seed) and
    # the same batches
    t_ref = time.perf_counter()
    want = ref.train(conf, weights.make(layout, run.seed, dev),
                     batches[:p["checked_steps"]], hyper(p))
    record["reference_s"] = time.perf_counter() - t_ref
    got = gaps(prog, want)
    run.log(f"losses program {prog['losses']} reference {want['losses']}; "
            f"reference {record['reference_s']:.1f} s")
    out["checks"] = {k: (v, run.limits[k]) for k, v in got.items()}
    return out
