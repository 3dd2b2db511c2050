"""Chip smoke test of the PyTorch + CUDA port (``src_torch/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port's main path from the sources in
the checkout, holds each kernel against its plain PyTorch twin on the
card, folds a round that mixes codecs and bases against the numpy engine,
drives the main path (the quickstart FedAvg round, natively and as
a FLARE job, clients fitting on the card and the server folding with the
kernel), folds a 50M-parameter x 16-client round at the benchmark's
geometry, and prints one JSON line per phase.  The line before the last
is the ``kernels`` line; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero.  It imports nothing of JAX or of the JAX package: every
parity check is against the plain twin and the port's own numpy engine.
It exits non-zero when CUDA is not available.
"""
import os
import sys

# deterministic cuBLAS: the clients' fits run concurrently in SuperNode
# threads and native == FLARE must hold bitwise on the card
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src_torch"))

#: H100 SXM published rates (NVIDIA data sheet): HBM3 bytes/s, and fp64
#: outside the tensor cores (the kernel's adds and multiplies)
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12

SITES = ["site-1", "site-2", "site-3"]
#: the benchmark's geometry (benchmarks/run.py, ``_LEAF`` / ``_case_data``)
LEAF, NLEAVES, CLIENTS = 250_000, 200, 16


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sync_ms(fn, reps: int = 1):
    """Host clock around ``reps`` calls ending in a device sync, in ms
    per call, and the last result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def event_ms(fn, reps: int = 5) -> float:
    """CUDA-event time per call over ``reps`` calls after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def wsum_bound(c: int, n: int, itemsize: int, *, acc: bool, base: bool,
               nscales: int = 0):
    """(ms, "bytes" | "operations"): the least time for ``weighted_sum``
    on these inputs — every input byte read once and the fp64 output
    written once, against HBM, or its fp64 multiplies and adds (plus the
    base adds) against the fp64 rate, whichever is larger."""
    nbytes = c * n * itemsize + c * nscales * 4 + c * 8 + n * 8 \
        + (n * 8 if acc else 0) + (n * 8 if base else 0)
    flops = c * n * (2 + (1 if base else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP64_FLOPS
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# phase 1: environment and build
# ---------------------------------------------------------------------------
def phase_env():
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build("weighted_sum")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("weighted_sum",
                                                       "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit("env", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvcc_build_s=build_s,
         ptxas=ptxas[:12])
    return card


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain twin, bitwise
# ---------------------------------------------------------------------------
def _inputs(rng, kind: str, c: int, n: int, dev, with_acc: bool,
            qchunk: int = 1024):
    scales = base = None
    if kind.startswith("int8"):
        data = torch.from_numpy(
            rng.integers(-127, 128, (c, n), dtype=np.int8))
        scales = torch.from_numpy((10.0 ** rng.uniform(
            -44, -1, (c, -(-n // qchunk)))).astype(np.float32))
        if kind == "int8_base":
            base = torch.from_numpy(rng.normal(0, 1, n))
    else:
        data = torch.from_numpy(rng.normal(0, 2, (c, n))) \
            .to(getattr(torch, kind))
    w = torch.from_numpy(rng.uniform(0.05, 2.0, c))
    acc = torch.from_numpy(rng.normal(0, 1, n)) if with_acc else None
    mv = lambda t: None if t is None else t.to(dev)  # noqa: E731
    return mv(data), mv(w), dict(scales=mv(scales), qchunk=qchunk,
                                 base=mv(base), acc=mv(acc))


def phase_kernel_vs_twin(dev):
    from repro_torch.kernels import agg_reduce

    rng = np.random.default_rng(2024)
    worst, cases = 0.0, 0
    for kind in ("int8", "int8_base", "float16", "bfloat16", "float32",
                 "float64"):
        for c in (1, 2, 3, 7, 16):
            for n in (6922, 1_000_003):
                for with_acc in (False, True):
                    data, w, kw = _inputs(rng, kind, c, n, dev, with_acc)
                    got = agg_reduce.weighted_sum(data, w, **kw)
                    want = agg_reduce.weighted_sum_plain(data, w, **kw)
                    torch.cuda.synchronize()
                    diff = float((got - want).abs().max())
                    worst = max(worst, diff)
                    check(torch.equal(got, want),
                          f"kernel != twin: {kind} C={c} N={n} "
                          f"acc={with_acc} max|d|={diff}")
                    cases += 1
    emit("kernel_vs_twin", cases=cases, max_abs_diff=worst)
    return worst


# ---------------------------------------------------------------------------
# phase 3: the slice at full width (quickstart, native and in FLARE)
# ---------------------------------------------------------------------------
def _history(codec, backend, flare: bool, low_memory: bool = False,
             faults: bool = False):
    from repro_torch.core import run_in_flare, run_native
    from repro_torch.fl import FedAvg, ServerApp, ServerConfig
    from repro_torch.fl.quickstart import make_client_app
    from repro_torch.runtime import FlareRuntime
    from repro_torch.runtime.transport import FaultSpec

    app = ServerApp(config=ServerConfig(num_rounds=3, round_timeout=120,
                                        codec=codec, agg_backend=backend),
                    strategy=FedAvg(low_memory=low_memory))
    # the quickstart at its own width: dim 32, hidden 64, 10 classes
    clients = lambda s: make_client_app(s, dim=32, classes=10,  # noqa: E731
                                        n_train=512, n_test=256)
    if not flare:
        return run_native(app, clients, SITES)
    rt = FlareRuntime(faults=FaultSpec(drop_prob=0.15, dup_prob=0.1,
                                       max_delay_s=0.01, seed=42)
                      if faults else None)
    for s in SITES:
        rt.provision_site(s)
    try:
        hist = run_in_flare(rt, app, clients, SITES)
        check(not faults or rt.network.stats["dropped"] > 0,
              "fault injection did not fire")
        return hist
    finally:
        rt.shutdown()


def _same(a, b) -> bool:
    return a.losses() == b.losses() and all(
        x.tobytes() == y.tobytes()
        for x, y in zip(a.final_parameters, b.final_parameters))


def phase_mixed_round(dev):
    """A round whose clients mix raw, bf16, int8 and int8-delta payloads
    (two bases), interleaved: the deferred mean chains one launch per run
    of like clients through ``acc``, the streaming fold keeps its
    accumulator on the card; both bitwise equal to the numpy engine."""
    from repro_torch.fl import agg_kernels as K
    from repro_torch.fl import flat as F

    rng = np.random.default_rng(7)
    layout = F.layout_for([("float32", (1000, 123)), ("float32", (4567,))])
    n = layout.total_size
    vec = lambda s: rng.normal(0, s, n).astype(np.float32)  # noqa: E731
    bases = [F.FlatParams.from_arrays(F.unflatten_vector(vec(0.5), layout),
                                      layout),
             F.QuantParams(layout, "q8", *F.quantize_int8(vec(0.5)))]
    pays = []
    for i in range(12):
        kind = i % 5
        if kind == 0:
            pays.append(F.FlatParams.from_arrays(
                F.unflatten_vector(vec(1.0 + i), layout), layout))
        elif kind == 1:
            pays.append(F.QuantParams(layout, "bf16", F.to_bf16(vec(1.0))))
        elif kind == 2:
            pays.append(F.QuantParams(layout, "q8", *F.quantize_int8(vec(2))))
        else:
            q, s = F.quantize_int8(vec(1e-3))
            pays.append(F.QuantParams(layout, "q8", q, s, is_delta=True,
                                      base=bases[kind - 3]))
    pairs = [(p, 3.0 + i) for i, p in enumerate(pays)]
    runs = len(K._launch_runs([p.tile_source() for p in pays]))
    got = K.weighted_mean(pairs, layout, backend="torch", device=dev)
    want = K.weighted_mean(pairs, layout, backend="numpy")
    check(got.buf.tobytes() == want.buf.tobytes(),
          "mixed round: deferred torch fold != numpy engine")
    folds = {}
    for backend in ("torch", "numpy"):
        s = K.StreamingWeightedSum(layout, backend=backend, device=dev)
        for p, w in pairs:
            s.add(p, w)
        folds[backend] = s.finalize()
    check(folds["torch"].buf.tobytes() == folds["numpy"].buf.tobytes(),
          "mixed round: streaming torch fold != numpy engine")
    emit("mixed_round", clients=len(pays), params=n, launch_runs=runs,
         bitwise=True)


def phase_slice():
    from repro_torch.kernels import agg_reduce

    out = {}
    agg_reduce.LAUNCHES["weighted_sum"] = 0
    for codec in ("flat", "bf16", "q8"):
        t0 = time.perf_counter()
        native = _history(codec, "torch", flare=False)
        flare = _history(codec, "torch", flare=True)
        t1 = time.perf_counter()
        numpy_ref = _history(codec, "numpy", flare=False)
        # the low-memory (fold-on-arrival) fold, natively and in FLARE
        # under transport faults
        native_lm = _history(codec, "torch", flare=False, low_memory=True)
        faulty_lm = _history(codec, "torch", flare=True, low_memory=True,
                             faults=True)
        losses = [l for _, l in native.losses()]
        check(_same(native, flare), f"{codec}: native != FLARE")
        check(_same(native, numpy_ref), f"{codec}: torch != numpy backend")
        check(_same(native_lm, faulty_lm),
              f"{codec}: low-memory native != FLARE under faults")
        check(len(losses) == 3 and all(np.isfinite(losses))
              and losses[-1] < losses[0], f"{codec}: losses {losses}")
        check(all(np.isfinite(p).all() for p in native.final_parameters),
              f"{codec}: non-finite parameters")
        out[codec] = {"losses": losses, "native_and_flare_s": t1 - t0}
    launches = agg_reduce.LAUNCHES["weighted_sum"]
    check(launches > 0, "the quickstart rounds launched no weighted_sum")
    emit("slice", launches=launches, codecs=out)
    return launches


# ---------------------------------------------------------------------------
# phase 4: the server fold at a real state size (50M params x 16 clients)
# ---------------------------------------------------------------------------
def _frames(codec: str):
    """One client frame, reused by all clients (as in the benchmark), the
    round's current parameters, and the downlink frame a delta decodes
    against."""
    from repro_torch.fl.messages import (FitIns, FitRes, encode_fit_ins,
                                         encode_fit_res, peek_params)

    rng = np.random.default_rng(42)
    arrays = [rng.random(LEAF, np.float32) for _ in range(NLEAVES)]
    current = [np.zeros(LEAF, np.float32) for _ in range(NLEAVES)]
    if codec == "flat":
        return encode_fit_res(FitRes(arrays, 0, {})), current, None
    start = [(a * np.float32(0.9)).astype(np.float32) for a in arrays]
    downlink = encode_fit_ins(FitIns(start, {}), codec="q8")
    base = peek_params(downlink).to_flat()     # what a client trained from
    frame = encode_fit_res(FitRes(arrays, 0, {}), codec="q8", base=base)
    return frame, current, downlink


def _fold(frame, current, downlink, *, backend, low_memory):
    from repro_torch.fl import FedAvg
    from repro_torch.fl.messages import decode_fit_res, peek_params

    round_base = peek_params(downlink) if downlink is not None else None
    acc = FedAvg(backend=backend, low_memory=low_memory) \
        .fit_accumulator(1, current)
    for c in range(CLIENTS):
        res = decode_fit_res(frame)
        res.num_examples = 10 + c
        if res.quant is not None and res.quant.is_delta:
            res.quant.base = round_base
        acc.add(f"site-{c:02d}", res)
    params, _ = acc.finalize([])
    return params


def phase_fold(dev):
    from repro_torch.fl import agg_kernels
    from repro_torch.fl.messages import decode_fit_res, peek_params
    from repro_torch.kernels import agg_reduce

    n = LEAF * NLEAVES
    weights = np.array([10.0 + c for c in range(CLIENTS)])
    weights /= weights.sum()
    report, kernel_row = {}, None
    agg_reduce.LAUNCHES["weighted_sum"] = 0
    for codec in ("flat", "q8"):
        frame, current, downlink = _frames(codec)
        row = {}
        for low_memory in (False, True):
            mode = "streaming" if low_memory else "deferred"
            fold = lambda: _fold(frame, current, downlink,  # noqa: E731
                                 backend="torch", low_memory=low_memory)
            # the first round also pays the caching allocator's first
            # cudaMalloc of the stack; the second is the steady state
            cold_ms, _ = sync_ms(fold)
            fold_ms, got = sync_ms(fold)
            t0 = time.perf_counter()
            want = _fold(frame, current, downlink, backend="numpy",
                         low_memory=low_memory)
            numpy_ms = (time.perf_counter() - t0) * 1e3
            check(all(a.tobytes() == b.tobytes() for a, b in zip(got, want)),
                  f"{codec}/{mode}: torch fold != numpy engine")
            check(all(np.isfinite(a).all() for a in got),
                  f"{codec}/{mode}: non-finite output")
            row[mode] = {"fold_ms": fold_ms, "fold_cold_ms": cold_ms,
                         "numpy_ms": numpy_ms}
        # the deferred fold's pieces, on this codec's real inputs
        res = decode_fit_res(frame)
        if res.quant is not None and res.quant.is_delta:
            res.quant.base = peek_params(downlink)
        src = (res.quant or res.flat).tile_source()
        base_ms = None
        if src.base is not None:    # the host decode of the q8 downlink
            base_ms, _ = sync_ms(src.base.to_f64)
        h2d_ms, stack = sync_ms(lambda: agg_kernels._device_stack(
            [src] * CLIENTS, dev, {}))
        w = torch.from_numpy(weights).to(dev)
        args = dict(scales=stack["scales"], qchunk=stack["qchunk"],
                    base=stack["base"])
        kernel_ms = event_ms(lambda: agg_reduce.weighted_sum(
            stack["data"], w, **args))
        vec = agg_reduce.weighted_sum(stack["data"], w, **args)
        layout = (res.quant or res.flat).layout
        finalize_ms, _ = sync_ms(lambda: agg_kernels._vec_to_flat(
            agg_reduce.to_host(vec), layout))
        del vec
        plain_ms = event_ms(lambda: agg_reduce.weighted_sum_plain(
            stack["data"], w, **args), reps=2)
        # yardstick only (never called by the port): one dgemv over the
        # pre-widened fp64 stack; NOT the kernel's summation order
        wide = torch.empty((CLIENTS, n), dtype=torch.float64, device=dev)
        for i in range(CLIENTS):
            wide[i] = agg_reduce._decode_plain(
                stack["data"][i], None if stack["scales"] is None
                else stack["scales"][i], stack["qchunk"])
        library_ms = event_ms(lambda: torch.mv(wide.T, w))
        del wide
        itemsize = stack["data"].element_size()
        nscales = 0 if stack["scales"] is None else stack["scales"].shape[1]
        bound, bound_by = wsum_bound(CLIENTS, n, itemsize, acc=False,
                                     base=stack["base"] is not None,
                                     nscales=nscales)
        row.update(kernel_ms=kernel_ms, plain_ms=plain_ms, h2d_ms=h2d_ms,
                   base_to_f64_ms=base_ms, d2h_and_cast_ms=finalize_ms,
                   bound_ms=bound, bound_by=bound_by, library_ms=library_ms,
                   library_note="torch.mv over a pre-widened fp64 stack; "
                                "not the same summation order")
        report[codec] = row
        if codec == "flat":
            kernel_row = dict(ms=kernel_ms, plain_ms=plain_ms,
                              bound_ms=bound, bound_by=bound_by,
                              library_ms=library_ms,
                              shape=f"{CLIENTS}x{n} float32, no acc/base")
        del stack
        torch.cuda.empty_cache()
    emit("fold_50Mx16", params=n, clients=CLIENTS,
         launches=agg_reduce.LAUNCHES["weighted_sum"], codecs=report)
    return kernel_row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "src_torch", "repro_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(src_torch/repro_torch is missing)", file=sys.stderr)
        return 3
    torch.use_deterministic_algorithms(True)
    # deterministic mode would also fill every torch.empty with NaN: an
    # extra write pass in each timed launch that the port does not need
    torch.utils.deterministic.fill_uninitialized_memory = False
    dev = torch.device("cuda")
    phase_env()
    max_diff = phase_kernel_vs_twin(dev)
    phase_mixed_round(dev)
    launches = phase_slice()
    row = phase_fold(dev)
    print(json.dumps({"kernels": [{
        "name": "weighted_sum", "route": "cuda",
        "source": "src_torch/repro_torch/kernels/csrc/weighted_sum.cu",
        "replaces": "src/repro/kernels/agg_reduce.py:200",
        "launches": launches, "max_abs_err": max_diff,
        "max_abs_diff": max_diff, "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": row["shape"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
