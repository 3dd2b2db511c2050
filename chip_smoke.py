"""Chip smoke test of the PyTorch + CUDA port (``src_torch/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the sources in the checkout
(``weighted_sum``, ``sort_reduce``, ``gram``: one ``nvcc`` each, all
started together), holds each kernel against its plain PyTorch twin on
the card, folds a round that mixes codecs and bases against the numpy
engine, drives the two main paths -- the quickstart FedAvg round (slice 1)
and the quickstart with the robust strategies FedMedian, FedTrimmedMean
and Krum on five sites (slice 2), each natively and as a FLARE job,
clients fitting on the card and the server reducing with the kernels --
folds a 50M-parameter x 16-client round at the benchmark's geometry
(FedAvg, then median, trimmed mean and Krum on distinct payloads), and
prints one JSON line per phase.  The line before the last is the
``kernels`` line; the last line is ``{"ok": true, "device": {...}}``.  Any
failed check raises and the script exits non-zero.  It imports nothing of
JAX or of the JAX package: every parity check is against the plain twins
and the port's own numpy engine.  It exits non-zero when CUDA is not
available.
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

#: H100 SXM published rates (NVIDIA data sheet): HBM3 bytes/s, fp64 outside
#: the tensor cores (the kernels' adds, multiplies and FMAs) and fp64 in the
#: tensor cores (the least time the card could take for a Gram product)
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
FP64_TENSOR_FLOPS = 67e12
KERNELS = ("weighted_sum", "sort_reduce", "gram")

SITES = ["site-1", "site-2", "site-3"]
#: the robust quickstart: five sites, so that FedTrimmedMean(beta=0.2) trims
#: k = 1 and Krum(num_byzantine=1) meets its quorum 2f + 3 = 5
ROBUST_SITES = [f"site-{i}" for i in range(1, 6)]
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


def _bound(nbytes: float, flops: float, rate: float = FP64_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def wsum_bound(c: int, n: int, itemsize: int, *, acc: bool, base: bool,
               nscales: int = 0):
    """(ms, "bytes" | "operations"): the least time for ``weighted_sum``
    on these inputs — every input byte read once and the fp64 output
    written once, against HBM, or its fp64 multiplies and adds (plus the
    base adds) against the fp64 rate, whichever is larger."""
    nbytes = c * n * itemsize + c * nscales * 4 + c * 8 + n * 8 \
        + (n * 8 if acc else 0) + (n * 8 if base else 0)
    return _bound(nbytes, c * n * (2 + (1 if base else 0)))


def sort_bound(c: int, n: int, itemsize: int, *, base: bool,
               nscales: int = 0):
    """(ms, bound_by) for ``sort_reduce``: the stack (+ scales, base) read
    once and the fp64 result written once, against HBM; its adds are too
    few to bind (the sort is integer compare-exchanges, not counted)."""
    nbytes = c * n * itemsize + c * nscales * 4 + n * 8 \
        + (n * 8 if base else 0)
    return _bound(nbytes, 2 * n)


def gram_bound(c: int, n: int, itemsize: int, *, base: bool,
               nscales: int = 0):
    """(ms, bound_by) for ``gram``: the stack (+ scales, base) read once and
    the (C, C) fp64 result written once, against HBM, or its C(C+1)/2
    products per column (2 flops each) against the card's fp64 tensor-core
    peak (67 TFLOP/s; the kernel itself uses CUDA-core FMAs, 34)."""
    nbytes = c * n * itemsize + c * nscales * 4 + c * c * 8 \
        + (n * 8 if base else 0)
    return _bound(nbytes, c * (c + 1) // 2 * n * 2, FP64_TENSOR_FLOPS)


# ---------------------------------------------------------------------------
# phase 1: environment and build
# ---------------------------------------------------------------------------
def _ptxas(log: str):
    """``[entry function, registers, spills]`` for each kernel instance in
    an ``nvcc -Xptxas=-v`` log."""
    rows, fn, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn, spill = (ln.split("'")[1] if "'" in ln else ln.strip()), ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and fn is not None:
            rows.append([fn, ln.split("Used")[-1].split(",")[0].strip(),
                         spill])
            fn = None
    return rows


def phase_env():
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    build_s = time.perf_counter() - t0
    ptxas = {k: _ptxas(_build.BUILD_LOG.get(k, "")) for k in KERNELS}
    emit("env", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvcc_build_s=build_s,
         ptxas=ptxas)
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


def _robust_inputs(gen, kind: str, c: int, n: int, dev, specials: bool,
                   qchunk: int = 1024):
    """A (C, N) payload stack made on the card from ``gen``.  With
    ``specials``, columns that hold only signed zeros, zeros and +-1, and
    NaNs (for int8: one NaN and one -0.0 scale window)."""
    scales = base = None
    if kind.startswith("int8"):
        data = torch.randint(-127, 128, (c, n), dtype=torch.int8,
                             device=dev, generator=gen)
        lo, hi = (-40.0, -1.0) if specials else (-3.0, -1.0)
        scales = (10.0 ** (lo + (hi - lo) * torch.rand(
            (c, -(-n // qchunk)), dtype=torch.float64, device=dev,
            generator=gen))).to(torch.float32)
        if specials:
            scales[-1, 0] = float("nan")
            scales[0, -1] = -0.0
        if kind == "int8_base":
            base = torch.randn(n, dtype=torch.float64, device=dev,
                               generator=gen)
    else:
        x = 2.0 * torch.randn((c, n), dtype=torch.float64, device=dev,
                              generator=gen)
        if specials:
            pick = lambda vals, cols: torch.tensor(  # noqa: E731
                vals, dtype=torch.float64, device=dev)[torch.randint(
                    len(vals), (c, cols), device=dev, generator=gen)]
            x[:, 0:64] = pick([-0.0, 0.0], 64)
            x[:, 64:128] = pick([-0.0, 0.0, 1.0, -1.0], 64)
            rows = torch.randint(c, (96,), device=dev, generator=gen)
            x[rows, torch.arange(128, 224, device=dev)] = float("nan")
            x[:, n - 1] = float("nan")
        data = x.to(getattr(torch, kind))
    return data, dict(scales=scales, qchunk=qchunk, base=base)


ROBUST_KINDS = ("int8", "int8_base", "float16", "bfloat16", "float32",
                "float64")
ROBUST_CLIENTS = (1, 2, 3, 7, 16, 33, 64)
ROBUST_N = (6922, 1_000_003)


def phase_sort_vs_twin(dev):
    """``sort_reduce`` against its twin, bitwise (int64 views: NaNs too)."""
    from repro_torch.kernels import agg_reduce

    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    cases = 0
    for kind in ROBUST_KINDS:
        for c in ROBUST_CLIENTS:
            for n in ROBUST_N:
                data, kw = _robust_inputs(gen, kind, c, n, dev, True)
                ops = [("median", 0)] + [("trim_sum", k) for k in
                                         sorted({0, 1, c // 3})
                                         if c - 2 * k >= 1]
                for op, k in ops:
                    got = agg_reduce.sort_reduce(data, kind=op, trim_k=k,
                                                 **kw)
                    want = agg_reduce.sort_reduce_plain(data, kind=op,
                                                        trim_k=k, **kw)
                    torch.cuda.synchronize()
                    check(torch.equal(got.view(torch.int64),
                                      want.view(torch.int64)),
                          f"sort_reduce != twin: {kind} C={c} N={n} {op} "
                          f"k={k}")
                    cases += 1
                del data, kw
    emit("sort_reduce_vs_twin", cases=cases, max_abs_diff=0.0, bitwise=True)
    return 0.0


def phase_gram_vs_twin(dev):
    """``gram`` against its twin within |dG| <= 1e-9 |G| + 1e-9, and
    bitwise equal to itself over two launches."""
    from repro_torch.kernels import agg_reduce

    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    worst, worst_rel, cases = 0.0, 0.0, 0
    for kind in ROBUST_KINDS:
        for c in ROBUST_CLIENTS:
            for n in ROBUST_N:
                data, kw = _robust_inputs(gen, kind, c, n, dev, False)
                got = agg_reduce.gram(data, **kw)
                again = agg_reduce.gram(data, **kw)
                want = agg_reduce.gram_plain(data, **kw)
                torch.cuda.synchronize()
                check(torch.equal(got.view(torch.int64),
                                  again.view(torch.int64)),
                      f"gram differs between launches: {kind} C={c} N={n}")
                diff = (got - want).abs()
                worst = max(worst, float(diff.max()))
                worst_rel = max(worst_rel, float(
                    (diff / want.abs().clamp_min(1e-300)).max()))
                check(torch.allclose(got, want, rtol=1e-9, atol=1e-9),
                      f"gram != twin: {kind} C={c} N={n} "
                      f"max|d|={float(diff.max())}")
                cases += 1
                del data, kw
    emit("gram_vs_twin", cases=cases, max_abs_diff=worst,
         max_rel_diff=worst_rel, rtol=1e-9, atol=1e-9,
         bitwise_across_launches=True)
    return worst


# ---------------------------------------------------------------------------
# phase 3: the slice at full width (quickstart, native and in FLARE)
# ---------------------------------------------------------------------------
def _history(codec, backend, flare: bool, low_memory: bool = False,
             faults: bool = False, strategy=None, sites=SITES):
    """One 3-round quickstart run (FedAvg unless ``strategy`` is given)."""
    from repro_torch.core import run_in_flare, run_native
    from repro_torch.fl import FedAvg, ServerApp, ServerConfig
    from repro_torch.fl.quickstart import make_client_app
    from repro_torch.runtime import FlareRuntime
    from repro_torch.runtime.transport import FaultSpec

    app = ServerApp(config=ServerConfig(num_rounds=3, round_timeout=120,
                                        codec=codec, agg_backend=backend),
                    strategy=strategy or FedAvg(low_memory=low_memory))
    # the quickstart at its own width: dim 32, hidden 64, 10 classes
    clients = lambda s: make_client_app(s, dim=32, classes=10,  # noqa: E731
                                        n_train=512, n_test=256)
    if not flare:
        return run_native(app, clients, sites)
    rt = FlareRuntime(faults=FaultSpec(drop_prob=0.15, dup_prob=0.1,
                                       max_delay_s=0.01, seed=42)
                      if faults else None)
    for s in sites:
        rt.provision_site(s)
    try:
        hist = run_in_flare(rt, app, clients, sites)
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


def _robust_strategy(name: str):
    from repro_torch.fl import FedMedian, FedTrimmedMean, Krum

    if name == "fedmedian":
        return FedMedian()
    if name == "fedtrimmedmean":
        return FedTrimmedMean(beta=0.2)
    return Krum(num_byzantine=1, num_selected=2)


def _robust_history(name: str, codec, backend, flare: bool):
    return _history(codec, backend, flare, strategy=_robust_strategy(name),
                    sites=ROBUST_SITES)


def phase_robust_slice():
    """Slice 2's main path: the quickstart on five sites with FedMedian,
    FedTrimmedMean(0.2) and Krum(f=1, two selected), three codecs, natively
    and in FLARE on the card; the numpy backend is the reference."""
    from repro_torch.kernels import agg_reduce

    out = {}
    for k in KERNELS:
        agg_reduce.LAUNCHES[k] = 0
    for name in ("fedmedian", "fedtrimmedmean", "krum"):
        for codec in ("flat", "bf16", "q8"):
            t0 = time.perf_counter()
            native = _robust_history(name, codec, "torch", flare=False)
            flare = _robust_history(name, codec, "torch", flare=True)
            t1 = time.perf_counter()
            numpy_ref = _robust_history(name, codec, "numpy", flare=False)
            tag = f"{name}/{codec}"
            metrics = [r.metrics for r in native.rounds]
            check(_same(native, flare)
                  and metrics == [r.metrics for r in flare.rounds],
                  f"{tag}: native != FLARE")
            check(_same(native, numpy_ref)
                  and metrics == [r.metrics for r in numpy_ref.rounds],
                  f"{tag}: torch != numpy backend")
            losses = [l for _, l in native.losses()]
            check(len(losses) == 3 and all(np.isfinite(losses))
                  and losses[-1] < losses[0], f"{tag}: losses {losses}")
            check(all(np.isfinite(p).all() for p in native.final_parameters),
                  f"{tag}: non-finite parameters")
            row = {"losses": losses, "native_and_flare_s": t1 - t0}
            if name == "krum":
                row["krum_selected"] = [m["krum_selected"] for m in metrics]
            out[tag] = row
    launches = {k: agg_reduce.LAUNCHES[k] for k in KERNELS}
    check(launches["sort_reduce"] > 0 and launches["gram"] > 0,
          f"the robust quickstart launched no sort_reduce/gram: {launches}")
    emit("robust_slice", sites=len(ROBUST_SITES), launches=launches,
         runs=out)
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


# ---------------------------------------------------------------------------
# phase 5: the robust fold at the benchmark's geometry (50M x 16, distinct)
# ---------------------------------------------------------------------------
#: FedTrimmedMean(beta=0.2) over 16 clients trims k = 3 at each end
TRIM_K = int(0.2 * CLIENTS)
#: the numpy engine's check runs on the first PREFIX_LEAVES leaves (1M
#: parameters): at 50M its median alone takes tens of seconds on the host
PREFIX_LEAVES = 4


def _robust_payloads(codec: str, dev):
    """16 distinct client payloads at the benchmark's geometry, made on the
    card: a shared vector plus per-client noise (fp32), or per-client int8
    deltas against a q8 round base (the shared vector quantized)."""
    from repro_torch.fl import flat as F

    layout = F.layout_for([("float32", (LEAF,))] * NLEAVES)
    n = layout.total_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(50)
    shared = np.random.default_rng(50).random(n, dtype=np.float32)
    if codec == "flat":
        shared_d = torch.from_numpy(shared).to(dev)
        flats = [F.FlatParams((shared_d + (0.01 * (c + 1)) * torch.randn(
            n, device=dev, generator=gen)).cpu().numpy().view(np.uint8),
            layout) for c in range(CLIENTS)]
        return layout, flats
    base = F.QuantParams(layout, "q8", *F.quantize_int8(shared))
    nsc = -(-n // F.QCHUNK)
    flats = []
    for c in range(CLIENTS):
        q = torch.randint(-127, 128, (n,), dtype=torch.int8, device=dev,
                          generator=gen)
        sc = (0.5 + torch.rand(nsc, device=dev, generator=gen)) \
            * (0.01 * (c + 1) / 127)
        flats.append(F.QuantParams(layout, "q8", q.cpu().numpy(),
                                   sc.cpu().numpy(), is_delta=True,
                                   base=base))
    return layout, flats


def _prefix(flats, nleaves: int):
    """The same payloads cut to their first ``nleaves`` leaves (views)."""
    from repro_torch.fl import flat as F

    layout = F.layout_for([("float32", (LEAF,))] * nleaves)
    n = layout.total_size
    if isinstance(flats[0], F.FlatParams):
        return layout, [F.FlatParams(fp.buf[:layout.total_bytes], layout)
                        for fp in flats]
    nsc = -(-n // F.QCHUNK)
    b = flats[0].base
    base = F.QuantParams(layout, "q8", b.data[:n], b.scales[:nsc])
    return layout, [F.QuantParams(layout, "q8", q.data[:n], q.scales[:nsc],
                                  is_delta=True, base=base) for q in flats]


def _aggregate(name: str, flats, backend, dev):
    st = _robust_strategy(name)
    st.backend, st.device = backend, dev
    weights = [10.0 + c for c in range(len(flats))]
    nodes = [f"site-{c:02d}" for c in range(len(flats))]
    return st._aggregate_flats(1, flats, weights, [], nodes)


def phase_robust_fold(dev):
    from repro_torch.fl import agg_kernels as K
    from repro_torch.kernels import agg_reduce as A

    report = {}
    for codec in ("flat", "q8_delta"):
        layout, flats = _robust_payloads(codec, dev)
        n = layout.total_size
        row = {}
        # one robust round each, the server's fold end to end: stack to the
        # card, one launch (Krum: gram, then weighted_sum over the chosen
        # two), result back and cast
        for name in ("fedmedian", "fedtrimmedmean", "krum"):
            fold_ms, (params, metrics) = sync_ms(
                lambda: _aggregate(name, flats, "torch", dev))
            check(all(np.isfinite(a).all() for a in params),
                  f"{codec}/{name}: non-finite output")
            row[name] = {"fold_ms": fold_ms}
            if name == "krum":
                row[name]["krum_selected"] = metrics["krum_selected"]
        # the numpy engine on the first 1M parameters: bitwise for median
        # and trimmed mean, tolerance + exact selection for Krum
        pl, pre = _prefix(flats, PREFIX_LEAVES)
        t0 = time.perf_counter()
        for name in ("fedmedian", "fedtrimmedmean", "krum"):
            got = _aggregate(name, pre, "torch", dev)
            want = _aggregate(name, pre, "numpy", None)
            check(got[1] == want[1] and all(
                a.tobytes() == b.tobytes() for a, b in zip(got[0], want[0])),
                f"{codec}/{name}: torch != numpy engine at 1M")
        d_t = K.krum_distances(pre, pl, backend="torch", device=dev)
        d_n = K.krum_distances(pre, pl, backend="numpy")
        check(np.allclose(d_t, d_n, rtol=1e-9, atol=1e-9) and (d_t >= 0).all(),
              f"{codec}: Krum distances != numpy engine at 1M")
        check(np.argsort(K.krum_scores(d_t, 1)).tolist()
              == np.argsort(K.krum_scores(d_n, 1)).tolist(),
              f"{codec}: Krum order != numpy engine at 1M")
        numpy_check_s = time.perf_counter() - t0
        # the pieces at 50M: the stack's copy, each kernel against its twin
        sources = [K._tile(fp) for fp in flats]
        h2d_ms, stack = sync_ms(lambda: K._device_stack(sources, dev, {}))
        data = stack["data"]
        args = dict(scales=stack["scales"], qchunk=stack["qchunk"],
                    base=stack["base"])
        itemsize = data.element_size()
        nscales = 0 if args["scales"] is None else args["scales"].shape[1]
        has_base = args["base"] is not None
        sort_b = sort_bound(CLIENTS, n, itemsize, base=has_base,
                            nscales=nscales)
        gram_b = gram_bound(CLIENTS, n, itemsize, base=has_base,
                            nscales=nscales)
        for op, k in (("median", 0), ("trim_sum", TRIM_K)):
            got = A.sort_reduce(data, kind=op, trim_k=k, **args)
            want = A.sort_reduce_plain(data, kind=op, trim_k=k, **args)
            check(torch.equal(got.view(torch.int64), want.view(torch.int64)),
                  f"{codec}: sort_reduce {op} != twin at 50M")
            del got, want
            row[op] = {
                "kernel_ms": event_ms(lambda: A.sort_reduce(
                    data, kind=op, trim_k=k, **args)),
                "plain_ms": event_ms(lambda: A.sort_reduce_plain(
                    data, kind=op, trim_k=k, **args), reps=2),
                "bound_ms": sort_b[0], "bound_by": sort_b[1]}
        g1 = A.gram(data, **args)
        g2 = A.gram(data, **args)
        gt = A.gram_plain(data, **args)
        check(torch.equal(g1.view(torch.int64), g2.view(torch.int64)),
              f"{codec}: gram differs between launches at 50M")
        check(torch.allclose(g1, gt, rtol=1e-9, atol=1e-9),
              f"{codec}: gram != twin at 50M")
        order = lambda g: np.argsort(K.krum_scores(  # noqa: E731
            K.gram_to_distances(A.to_host(g)), 1)).tolist()
        check(order(g1) == order(gt),
              f"{codec}: Krum order from the kernel != twin at 50M")
        row["gram"] = {
            "kernel_ms": event_ms(lambda: A.gram(data, **args)),
            "plain_ms": event_ms(lambda: A.gram_plain(data, **args), reps=2),
            "max_abs_diff": float((g1 - gt).abs().max()),
            "bound_ms": gram_b[0], "bound_by": gram_b[1]}
        del g1, g2, gt
        # yardsticks only (never called by the port): one torch.sort and one
        # torch.mm over the pre-widened fp64 stack
        wide = A._decoded_plain(data, args["scales"], args["qchunk"],
                                args["base"])
        row["median"]["library_ms"] = row["trim_sum"]["library_ms"] = \
            event_ms(lambda: torch.sort(wide, dim=0), reps=2)
        centred = wide - wide[0]
        del wide
        row["gram"]["library_ms"] = event_ms(
            lambda: torch.mm(centred, centred.T), reps=2)
        del centred, stack, data, args
        torch.cuda.empty_cache()
        row.update(h2d_ms=h2d_ms, numpy_check_1M_s=numpy_check_s)
        report[codec] = row
        del flats, pre, sources
    emit("robust_fold_50Mx16", params=LEAF * NLEAVES, clients=CLIENTS,
         trim_k=TRIM_K, numpy_check_params=PREFIX_LEAVES * LEAF,
         codecs=report)
    flat = report["flat"]
    shape = f"{CLIENTS}x{LEAF * NLEAVES} float32, distinct clients"
    return {
        "sort_reduce": dict(flat["median"], shape=shape + ", median"),
        "gram": dict(flat["gram"], shape=shape)}


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
    sort_diff = phase_sort_vs_twin(dev)
    gram_diff = phase_gram_vs_twin(dev)
    phase_mixed_round(dev)
    launches = phase_slice()
    robust_launches = phase_robust_slice()
    row = phase_fold(dev)
    robust = phase_robust_fold(dev)
    src = "src_torch/repro_torch/kernels/csrc/"
    lines = [
        dict(name="weighted_sum", source=src + "weighted_sum.cu",
             replaces="src/repro/kernels/agg_reduce.py:200",
             launches=launches, max_abs_diff=max_diff, **row),
        dict(name="sort_reduce", source=src + "sort_reduce.cu",
             replaces="src/repro/kernels/agg_reduce.py:283",
             launches=robust_launches["sort_reduce"],
             max_abs_diff=sort_diff, **robust["sort_reduce"]),
        dict(name="gram", source=src + "gram.cu",
             replaces="src/repro/kernels/agg_reduce.py:339",
             launches=robust_launches["gram"],
             **dict(robust["gram"], max_abs_diff=max(
                 gram_diff, robust["gram"]["max_abs_diff"]))),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "max_abs_diff", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    out = []
    for k in lines:
        k = dict(k, route="cuda", max_abs_err=k["max_abs_diff"],
                 ms=k.get("ms", k.get("kernel_ms")))
        out.append({key: k[key] for key in keys})
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
