"""Chip smoke test of the PyTorch + CUDA port (``src_torch/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the sources in the checkout
(``weighted_sum``, ``sort_reduce``, ``gram``, ``flash_attention``,
``rglru_scan``, ``scatter_wsum``, ``secagg_mask``, ``decode_rows``: one
``nvcc`` each, all started together), holds each kernel against its plain
PyTorch twin on the card (``rglru_scan``, also at the edges of its
shared-memory ring and on strided views, ``scatter_wsum``, also at the
edges of its warps' staged chunks and in the sharded 0xF5 fold against
the numpy engine, ``decode_rows``,
over every payload kind with and without a base, odd N, ``row0`` 1 and 3
and qchunk 3 and 1000, and ``weighted_sum``'s fp32 tiles bitwise,
``secagg_mask`` exactly; ``sort_reduce`` bitwise and ``gram`` to 1e-9 up to 1000 clients,
``sort_reduce`` also at 20000, in global scratch, and both at the edges of
their register paths -- every client-count bucket boundary, N at every
stage width +-1, ragged row starts, qchunk not dividing a stage, every
payload kind with and without a base; flash attention on both
of its routes, the bf16 tensor-core kernel and the fp32 CUDA-core one,
each at the other's tile edges too),
folds a round that mixes codecs and bases against the numpy engine (the
weighted folds, and the robust reductions through ``decode_rows``), and
drives the main paths: the
quickstart FedAvg round (slice 1) and the quickstart with the robust
strategies FedMedian, FedTrimmedMean and Krum on five sites (slice 2),
each natively and as a FLARE job, clients fitting on the card and the
server reducing with the kernels; H2O-Danube-1.8B at full width and depth
serving 4 requests of 4500 prompt tokens and 32 new tokens with flash
attention in every layer's prefill (every launch on the tensor-core
route), against the same model on the eager attention path (slice 3);
RecurrentGemma-2B at full width and depth
serving 4 requests of 4096 prompt tokens and 32 new tokens with the
``rglru_scan`` kernel in its 18 RG-LRU layers and the flash kernel at
head dim 256 in its 8 local-attention layers, against the eager paths
(slice 4); the dense, VLM, MoE and MLA families at full width (slice 12:
Granite-MoE-1B-A400M and InternVL2-1B at full depth, DeepSeek-V2-236B
cut to its dense first layer and one MoE layer of 160 experts, Qwen3-32B,
Yi-34B and Granite-34B cut to 2 layers), each served with flash and
eager attention, the flash kernel held to its twin at each family's head
group and timed at head dims 64 and 128 (the fp32 route too, held to its
twin at each timed shape; its launches counted on the fp32 prefills that
hold RecurrentGemma-2B's and Whisper-medium's flash path against eager);
and slice 5's server folds: the
sharded fold at the benchmark's 50M x 16 geometry over 8 shard ranges
(fp64 and fp32 tiles),
the 0xF5 sparse fold of 100M-parameter deltas from 8 clients through
``scatter_wsum`` (COO and adapter ranges), the SecAgg quickstart
natively and in FLARE and a DP + TopK round, and ``secagg_mask`` through
its public entry point ``kernels/ops.py``; and slice 9's training:
H2O-Danube-1.8B at full width and depth trained by ``get_train_step`` for
a few AdamW steps of 4 x 4096 tokens in 4 microbatches (eager, so no
kernel's count may move), timed and profiled, with the card's fp32 step
held against the CPU's at 2 layers, remat on against off bitwise, and the
training launcher's save and resume; and slice 14's examples: the
paper's quickstart (Fig. 5), secure federation, hybrid tracking (Fig. 6)
and multi-job runs through each example's ``main()`` on the card, and the
legacy baseline: the frozen per-layer ``LegacyFedAvg`` on the host against
the port's FedAvg fold on the card at 50M x 16, bitwise; and slice 15's
launch tools: three dry-runs of the port's steps on fake process groups
of 256 and 512 ranks on the card's device type (H2O-Danube-1.8B's
``train_4k``, its tight FL round across two pods, DeepSeek-V2-236B's
``decode_32k``; later pairs in ``DRYRUN_PAIRS``, Granite-MoE-1B-A400M's
``decode_32k`` on one node of eight cards among them), their roofline
report, and a one-rank dry-run of the training configuration above,
whose predicted peak is held within 5% of the peak the card measured,
and five more pairs at full width and cut depth (``DRYRUN_CUT_PAIRS``),
none of them, nor any other, with a view resharded by the trace;
beside them, every family's sharded prefill, decode and train step on
real gloo ranks of a (1, 2) and a (2, 2) mesh under this machine's
torch, and the layouts of ``sharded_ranks.LAYOUTS`` on their meshes,
against the plain ones (``src_torch/tools/sharded_ranks.py``; phase
``sharded_ranks``).  It also folds a
50M-parameter x 16-client round at the benchmark's geometry (FedAvg,
then median, trimmed mean and Krum on distinct payloads), times each
kernel at its main path's shape beside its bound (``scatter_wsum`` also
beside its floor, the same read-modify-write with no values, and with
its wrapper's time split), and prints one JSON
line per phase.  The line before the last is the ``kernels`` line; the
last line is ``{"ok": true, "device": {...}}``.  Any failed check raises
and the script exits non-zero.  It imports nothing of JAX or of the JAX
package: every parity check is against the plain twins, the port's own
numpy engine and the port's full-matrix attention oracle.  It exits
non-zero when CUDA is not available.
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
#: bf16 in the tensor cores (dense) and fp32 outside them: attention's bound
#: and the least time of a kernel on the fp32 CUDA cores
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12
AGG_KERNELS = ("weighted_sum", "sort_reduce", "gram")
KERNELS = AGG_KERNELS + ("flash_attention", "rglru_scan", "scatter_wsum",
                         "secagg_mask", "decode_rows")

SITES = ["site-1", "site-2", "site-3"]
#: the robust quickstart: five sites, so that FedTrimmedMean(beta=0.2) trims
#: k = 1 and Krum(num_byzantine=1) meets its quorum 2f + 3 = 5
ROBUST_SITES = [f"site-{i}" for i in range(1, 6)]
#: the benchmark's geometry (benchmarks/run.py, ``_LEAF`` / ``_case_data``)
LEAF, NLEAVES, CLIENTS = 250_000, 200, 16


#: the script's start on the host clock; every phase line carries the
#: seconds since then (``at_s``), so a phase's cost is the difference
T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - T_START}), flush=True)


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


def sort_bytes(c: int, n: int, itemsize: int, *, base: bool,
               nscales: int = 0) -> int:
    """Bytes ``sort_reduce`` must move: the stack (+ scales, base) read
    once, the fp64 result written once."""
    return c * n * itemsize + c * nscales * 4 + n * 8 + (n * 8 if base else 0)


def sort_bound(c: int, n: int, itemsize: int, *, base: bool,
               nscales: int = 0):
    """(ms, bound_by) for ``sort_reduce``: :func:`sort_bytes` against HBM;
    its adds are too few to bind (the sort is integer compare-exchanges,
    not counted)."""
    return _bound(sort_bytes(c, n, itemsize, base=base, nscales=nscales),
                  2 * n)


def gram_bytes(c: int, n: int, itemsize: int, *, base: bool,
               nscales: int = 0) -> int:
    """Bytes ``gram`` must move: the stack (+ scales, base) read once, the
    (C, C) fp64 result written once."""
    return c * n * itemsize + c * nscales * 4 + c * c * 8 \
        + (n * 8 if base else 0)


def gram_bound(c: int, n: int, itemsize: int, *, base: bool,
               nscales: int = 0):
    """(ms, bound_by) for ``gram``: :func:`gram_bytes` against HBM, or its
    C(C+1)/2 products per column (2 flops each) against the card's fp64
    tensor-core peak (67 TFLOP/s), where the kernel's products run."""
    return _bound(gram_bytes(c, n, itemsize, base=base, nscales=nscales),
                  c * (c + 1) // 2 * n * 2, FP64_TENSOR_FLOPS)


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


def _ptxas_summary(name: str, main: tuple) -> dict:
    """Registers and spills of a source's kernel instances from its build
    log: the most registers of any instance, the instances that spill, and
    the rows of the instances whose mangled names hold one of ``main``."""
    from repro_torch.kernels import _build

    rows = _ptxas(_build.BUILD_LOG.get(name, ""))
    spills = [r for r in rows if r[2] and
              "0 bytes spill stores, 0 bytes spill loads" not in r[2]]
    regs = [int(r[1].split()[0]) for r in rows if r[1].split()[0].isdigit()]
    return {"instances": len(rows), "max_registers": max(regs, default=None),
            "spilling": spills,
            "main_path": [r for r in rows if any(m in r[0] for m in main)]}


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
    """A (C, N) payload stack made on the card from ``gen``; a kind ending
    in ``_base`` adds an fp64 delta base.  With ``specials``, columns that
    hold only signed zeros, zeros and +-1, and NaNs, as far as N has room
    (for int8: one NaN and one -0.0 scale window), and base entries +-inf
    and NaN."""
    scales = base = None
    dt = kind[:-5] if kind.endswith("_base") else kind
    if dt == "int8":
        data = torch.randint(-127, 128, (c, n), dtype=torch.int8,
                             device=dev, generator=gen)
        lo, hi = (-40.0, -1.0) if specials else (-3.0, -1.0)
        scales = (10.0 ** (lo + (hi - lo) * torch.rand(
            (c, -(-n // qchunk)), dtype=torch.float64, device=dev,
            generator=gen))).to(torch.float32)
        if specials:
            scales[-1, 0] = float("nan")
            scales[0, -1] = -0.0
    else:
        x = 2.0 * torch.randn((c, n), dtype=torch.float64, device=dev,
                              generator=gen)
        if specials:
            pick = lambda vals, cols: torch.tensor(  # noqa: E731
                vals, dtype=torch.float64, device=dev)[torch.randint(
                    len(vals), (c, cols), device=dev, generator=gen)]
            w0, w1 = min(64, n), min(128, n)
            x[:, 0:w0] = pick([-0.0, 0.0], w0)
            x[:, w0:w1] = pick([-0.0, 0.0, 1.0, -1.0], w1 - w0)
            cols = torch.arange(min(128, n - 1), min(224, n - 1), device=dev)
            rows = torch.randint(c, (cols.numel(),), device=dev,
                                 generator=gen)
            x[rows, cols] = float("nan")
            x[:, n - 1] = float("nan")
        data = x.to(getattr(torch, dt))
    if kind.endswith("_base"):
        base = torch.randn(n, dtype=torch.float64, device=dev, generator=gen)
        if specials:  # columns whose base is not finite
            base[0], base[n // 2] = float("inf"), float("-inf")
            base[n - 1 - n // 3] = float("nan")
    return data, dict(scales=scales, qchunk=qchunk, base=base)


def _at_offset(data, offset: int):
    """The same stack at a storage offset of ``offset`` elements: still
    contiguous, but row 0 starts ``offset`` elements past a 16-byte
    boundary (and the other rows wherever that puts them)."""
    if offset == 0:
        return data
    flat = torch.empty(offset + data.numel(), dtype=data.dtype,
                       device=data.device)
    flat[offset:] = data.reshape(-1)
    return flat[offset:].view(data.shape)


ROBUST_KINDS = ("int8", "int8_base", "float16", "bfloat16", "float32",
                "float64")
ROBUST_CLIENTS = (1, 2, 3, 7, 16, 33, 64)
ROBUST_N = (6922, 1_000_003)
#: past the kernels' register path, at the quickstart's N: shared-memory
#: sorts and the Gram matrix tiled by 64-client blocks
MANY_CLIENTS = (65, 200, 1000)
#: a client count whose padded keys (32768 x 8 bytes) do not fit a block's
#: shared memory: sort_reduce sorts in global scratch; at a small N
SCRATCH_CASE = (20000, 1000)
#: the register paths' edges: C at every CMAX bucket boundary; N tiny, one
#: less and one more than the smallest stage widths (64 for ``gram``, 128
#: for ``sort_reduce``) and the largest (1024; the ``cuda`` tests of
#: ``tests/test_torch_agg_reduce.py`` take every width), and odd (no row
#: start 16-byte aligned); every payload kind with and without a base;
#: qchunk 1024, 1000 and 3 in turn (1000 and 3 divide no stage width)
EDGE_CLIENTS = (1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64)
EDGE_N = (1, 3, 63, 65, 127, 129, 1023, 1025, 6923)
EDGE_KINDS = tuple(k + b for k in ("int8", "float16", "bfloat16", "float32",
                                   "float64") for b in ("", "_base"))


def _robust_grid():
    """(kind, C, N, qchunk, storage offset) of the robust kernels' checks:
    the main grid, then the edge grid."""
    main = [(kind, c, n, 1024, 0) for kind in ROBUST_KINDS
            for c in ROBUST_CLIENTS + MANY_CLIENTS
            for n in (ROBUST_N if c <= 64 else ROBUST_N[:1])]
    edge = [(kind, c, n, (1024, 1000, 3)[i % 3], (i + c) % 2)
            for kind in EDGE_KINDS for c in EDGE_CLIENTS
            for i, n in enumerate(EDGE_N)]
    return main + edge


def phase_sort_vs_twin(dev):
    """``sort_reduce`` against its twin, bitwise (int64 views: NaNs too)."""
    from repro_torch.kernels import agg_reduce

    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    cases, many_ms = 0, {}
    grid = _robust_grid() + [(kind, *SCRATCH_CASE, 1024, 0)
                             for kind in ("int8_base", "float32")]
    for kind, c, n, qchunk, off in grid:
        data, kw = _robust_inputs(gen, kind, c, n, dev, True, qchunk)
        data = _at_offset(data, off)
        # an edge-grid case takes the median and one trim; the main grid
        # trims 0, 1 and C / 3
        edge = n in EDGE_N and c <= 64
        ops = [("median", 0)] + [("trim_sum", k) for k in
                                 ([max(1, c // 3)] if edge else
                                  sorted({0, 1, c // 3})) if c - 2 * k >= 1]
        for op, k in ops:
            got = agg_reduce.sort_reduce(data, kind=op, trim_k=k, **kw)
            want = agg_reduce.sort_reduce_plain(data, kind=op, trim_k=k,
                                                **kw)
            torch.cuda.synchronize()
            check(torch.equal(got.view(torch.int64), want.view(torch.int64)),
                  f"sort_reduce != twin: {kind} C={c} N={n} q={qchunk} "
                  f"offset={off} {op} k={k}")
            cases += 1
        if c > 64 and kind == "float32":
            many_ms[f"{c}x{n}"] = event_ms(lambda: agg_reduce.sort_reduce(
                data, kind="median", **kw))
        del data, kw
    emit("sort_reduce_vs_twin", cases=cases, max_abs_diff=0.0, bitwise=True,
         clients=sorted({c for _, c, *_ in grid}),
         n_edges=list(EDGE_N), kinds=sorted({k for k, *_ in grid}),
         median_ms_over_64_clients_f32=many_ms)
    return 0.0, many_ms


def phase_gram_vs_twin(dev):
    """``gram`` against its twin within |dG| <= 1e-9 |G| + 1e-9, and
    bitwise equal to itself over two launches."""
    from repro_torch.kernels import agg_reduce

    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    worst, worst_rel, cases, many_ms = 0.0, 0.0, 0, {}
    grid = _robust_grid()
    for kind, c, n, qchunk, off in grid:
        data, kw = _robust_inputs(gen, kind, c, n, dev, False, qchunk)
        data = _at_offset(data, off)
        got = agg_reduce.gram(data, **kw)
        again = agg_reduce.gram(data, **kw)
        want = agg_reduce.gram_plain(data, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int64), again.view(torch.int64)),
              f"gram differs between launches: {kind} C={c} N={n}")
        diff = (got - want).abs()
        worst = max(worst, float(diff.max()))
        worst_rel = max(worst_rel, float(
            (diff / want.abs().clamp_min(1e-300)).max()))
        check(torch.allclose(got, want, rtol=1e-9, atol=1e-9),
              f"gram != twin: {kind} C={c} N={n} q={qchunk} offset={off} "
              f"max|d|={float(diff.max())}")
        if c > 64 and kind == "float32":
            many_ms[f"{c}x{n}"] = event_ms(lambda: agg_reduce.gram(data, **kw))
        cases += 1
        del data, kw
    emit("gram_vs_twin", cases=cases, max_abs_diff=worst,
         max_rel_diff=worst_rel, rtol=1e-9, atol=1e-9,
         bitwise_across_launches=True,
         clients=sorted({c for _, c, *_ in grid}), n_edges=list(EDGE_N),
         ms_over_64_clients_f32=many_ms)
    return worst, many_ms


#: decode_rows' grid: N tiny, one less, equal and one more than the
#: 16-element int8 chunk, and odd; rows written at row0 0, 1 and 3 (odd
#: N with odd row0 puts the output off 16 bytes against the payload's
#: chunks); qchunk 3 and 1000 (windows that split a chunk) and 1024
DECODE_N = (1, 3, 15, 16, 17, 6923)
DECODE_ROW0 = (0, 1, 3)
DECODE_QCHUNK = (3, 1000, 1024)


def _bits_equal(got, want) -> bool:
    """Bitwise equal as int64, NaNs compared by position (the card's NaN
    payload bits are its own; the reductions canonicalize them)."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)) and bool(torch.equal(
        got[~nan].view(torch.int64), want[~nan].view(torch.int64)))


def phase_decode_vs_twin(dev):
    """``decode_rows`` against its twin, bitwise (NaNs by position), on 3
    rows of every payload kind with and without a base, over
    :data:`DECODE_N` x :data:`DECODE_ROW0` (x :data:`DECODE_QCHUNK` for
    int8), the payload and the base at storage offsets 0 and 1: each call
    one launch, and the rows of ``out`` outside ``[row0, row0 + 3)``
    untouched."""
    from repro_torch.kernels import agg_reduce as A

    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    cases, c = 0, 3
    for kind in EDGE_KINDS:
        qchunks = DECODE_QCHUNK if kind.startswith("int8") else (1024,)
        for n in DECODE_N:
            for row0 in DECODE_ROW0:
                for qchunk in qchunks:
                    off = cases % 2
                    data, kw = _robust_inputs(gen, kind, c, n, dev, True,
                                              qchunk)
                    data = _at_offset(data, off)
                    if kw["base"] is not None:
                        kw["base"] = _at_offset(kw["base"], 1 - off)
                    out = torch.full((c + 4, n), 3.0, dtype=torch.float64,
                                     device=dev)
                    before = A.LAUNCHES["decode_rows"]
                    A.decode_rows(data, out=out, row0=row0, **kw)
                    want = A.decode_rows_plain(data, **kw)
                    torch.cuda.synchronize()
                    tag = f"{kind} N={n} row0={row0} q={qchunk} off={off}"
                    check(A.LAUNCHES["decode_rows"] == before + 1,
                          f"decode_rows {tag}: not one launch")
                    check(_bits_equal(out[row0:row0 + c], want),
                          f"decode_rows != twin: {tag}")
                    rest = torch.cat([out[:row0], out[row0 + c:]])
                    check(bool((rest == 3.0).all()),
                          f"decode_rows {tag}: wrote outside its rows")
                    cases += 1
                    del data, kw, out, want
    emit("decode_rows_vs_twin", cases=cases, max_abs_diff=0.0,
         bitwise=True, kinds=list(EDGE_KINDS), n=list(DECODE_N),
         row0=list(DECODE_ROW0), qchunk=list(DECODE_QCHUNK))
    return 0.0


# ---------------------------------------------------------------------------
# phase 3: the slice at full width (quickstart, native and in FLARE)
# ---------------------------------------------------------------------------
def _history(codec, backend, flare: bool, low_memory: bool = False,
             faults: bool = False, strategy=None, sites=SITES, mods=None,
             rounds: int = 3, transport: str = "inproc"):
    """One quickstart run of ``rounds`` rounds (FedAvg unless ``strategy``
    is given; ``mods(site)`` gives a site's client mods; ``transport``
    "tcp" runs the native fleet over loopback sockets)."""
    from repro_torch.core import run_in_flare, run_native
    from repro_torch.fl import FedAvg, ServerApp, ServerConfig
    from repro_torch.fl.quickstart import make_client_app
    from repro_torch.runtime import FlareRuntime
    from repro_torch.runtime.transport import FaultSpec

    app = ServerApp(config=ServerConfig(num_rounds=rounds, round_timeout=120,
                                        codec=codec, agg_backend=backend,
                                        transport=transport),
                    strategy=strategy or FedAvg(low_memory=low_memory))
    # the quickstart at its own width: dim 32, hidden 64, 10 classes
    clients = lambda s: make_client_app(  # noqa: E731
        s, mods=mods(s) if mods else None, dim=32, classes=10, n_train=512,
        n_test=256)
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
    # the robust reductions over the same round, two raw clients holding
    # signed zeros and NaNs: each run of like clients decoded into its rows
    # of one fp64 stack on the card (decode_rows), then one sort_reduce or
    # gram launch; bitwise the numpy engine (Krum: 1e-9, the same order)
    from repro_torch.kernels import agg_reduce as A

    special = []
    for i, p in enumerate(pays):
        if i % 5 == 0:
            v = p.math_view().copy()
            v[:64] = rng.choice([-0.0, 0.0], 64)
            v[64:128] = rng.choice([-0.0, 0.0, 1.0, -1.0], 64)
            v[rng.integers(128, n, 5)] = np.nan
            p = F.FlatParams.from_arrays(F.unflatten_vector(v, layout),
                                         layout)
        special.append(p)
    for key in ("decode_rows", "sort_reduce", "gram"):
        A.LAUNCHES[key] = 0
    robust = {}
    for name, fn, args in (("median", K.median, ()),
                           ("trimmed_mean", K.trimmed_mean, (2,))):
        got = fn(special, layout, *args, backend="torch", device=dev)
        want = fn(special, layout, *args, backend="numpy")
        check(got.buf.tobytes() == want.buf.tobytes(),
              f"mixed round: {name} on the card != numpy engine")
        robust[name] = {"bitwise": True,
                        "nan": int(np.isnan(want.math_view()).sum())}
    d_t = K.krum_distances(pays, layout, backend="torch", device=dev)
    d_n = K.krum_distances(pays, layout, backend="numpy")
    check(np.allclose(d_t, d_n, rtol=1e-9, atol=1e-9)
          and np.argsort(K.krum_scores(d_t, 1)).tolist()
          == np.argsort(K.krum_scores(d_n, 1)).tolist(),
          "mixed round: Krum on the card != numpy engine")
    robust["krum"] = {"max_abs_diff": float(np.abs(d_t - d_n).max())}
    launches = {k: A.LAUNCHES[k] for k in ("decode_rows", "sort_reduce",
                                           "gram")}
    check(launches == {"decode_rows": 3 * runs, "sort_reduce": 2,
                       "gram": 1},
          f"mixed round: robust launches {launches}, want {runs} "
          f"decode_rows per reduction and one reduction each")
    emit("mixed_round", clients=len(pays), params=n, launch_runs=runs,
         bitwise=True, robust=robust, robust_launches=launches)
    return launches["decode_rows"]


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
    for k in AGG_KERNELS:
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
    launches = {k: agg_reduce.LAUNCHES[k] for k in AGG_KERNELS}
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
    launches = agg_reduce.LAUNCHES["weighted_sum"]
    emit("fold_50Mx16", params=n, clients=CLIENTS, launches=launches,
         codecs=report)
    return dict(kernel_row, fold_launches=launches)


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
        sort_nb = sort_bytes(CLIENTS, n, itemsize, base=has_base,
                             nscales=nscales)
        gram_nb = gram_bytes(CLIENTS, n, itemsize, base=has_base,
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
            row[op].update(_rates(row[op], sort_nb))
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
        row["gram"].update(_rates(row["gram"], gram_nb))
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
    # registers and spills of the register paths' kernels; main_path: the
    # instances this phase runs (C = 16: fp32 and int8 + base, both on
    # 32-bit keys; gram's two 8-row blocks)
    ptxas = {"sort_reduce": _ptxas_summary(
        "sort_reduce", ("sort_reduce_kernelILi3ELi16ELi0E",
                        "sort_reduce_kernelILi0ELi16ELi1E")),
             "gram": _ptxas_summary(
        "gram", ("gram_dmma_kernelILi3ELi2E", "gram_dmma_kernelILi0ELi2E"))}
    emit("robust_fold_50Mx16", params=LEAF * NLEAVES, clients=CLIENTS,
         trim_k=TRIM_K, numpy_check_params=PREFIX_LEAVES * LEAF,
         codecs=report, ptxas=ptxas)
    flat, q8 = report["flat"], report["q8_delta"]
    shape = f"{CLIENTS}x{LEAF * NLEAVES} float32, distinct clients"
    return {
        "sort_reduce": dict(flat["median"], shape=shape + ", median",
                            trim_sum=flat["trim_sum"],
                            q8_delta={"median": q8["median"],
                                      "trim_sum": q8["trim_sum"]}),
        "gram": dict(flat["gram"], shape=shape, q8_delta=q8["gram"])}


def _rates(row: dict, nbytes: int) -> dict:
    """The kernel's share of its bound and its rate in GB/s."""
    return {"share_of_bound": row["bound_ms"] / row["kernel_ms"],
            "gb_per_s": nbytes / (row["kernel_ms"] * 1e-3) / 1e9}


def decode_bound(c: int, n: int, itemsize: int, *, base: bool,
                 nscales: int = 0):
    """(ms, bound_by) for ``decode_rows``: the stack (+ scales, base) read
    once and the (C, N) fp64 rows written once, against HBM; its base adds
    are too few to bind."""
    nbytes = c * n * itemsize + c * nscales * 4 + c * n * 8 \
        + (n * 8 if base else 0)
    return _bound(nbytes, c * n if base else 0)


def phase_decode_timing(dev, card: str):
    """``decode_rows`` at the robust fold's geometry (16 clients x 50M): a
    mixed round of that size widens each run into the fp64 stack.  fp32
    payloads (the library yardstick: one ``copy_`` into fp64, the same
    function) and q8 deltas (no one PyTorch call decodes them)."""
    from repro_torch.kernels import agg_reduce as A

    n = LEAF * NLEAVES
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    out = torch.empty((CLIENTS, n), dtype=torch.float64, device=dev)
    rows = {}
    for kind in ("float32", "int8_base"):
        data, kw = _robust_inputs(gen, kind, CLIENTS, n, dev, False)
        got = A.decode_rows(data, out=out, **kw)
        want = A.decode_rows_plain(data, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int64), want.view(torch.int64)),
              f"decode_rows != twin at {CLIENTS}x{n} {kind}")
        del want
        nsc = 0 if kw["scales"] is None else kw["scales"].shape[1]
        b_ms, b_by = decode_bound(CLIENTS, n, data.element_size(),
                                  base=kw["base"] is not None, nscales=nsc)
        rows[kind] = {
            "ms": event_ms(lambda: A.decode_rows(data, out=out, **kw)),
            "plain_ms": event_ms(lambda: A.decode_rows_plain(data, **kw),
                                 reps=2),
            "library_ms": (event_ms(lambda: out.copy_(data))
                           if kind == "float32" else None),
            "bound_ms": b_ms, "bound_by": b_by}
        del data, kw
    del out
    torch.cuda.empty_cache()
    emit("decode_timing", card=card, clients=CLIENTS, params=n, rows=rows)
    return dict(rows["float32"], max_abs_diff=0.0,
                q8_delta=rows["int8_base"],
                shape=f"{CLIENTS}x{n} float32 into fp64 rows")


# ---------------------------------------------------------------------------
# phase 6: flash attention, the kernel against its twin (slice 3)
# ---------------------------------------------------------------------------
#: assert_allclose tolerances (rtol = atol), as tests/test_kernels.py holds
#: the reference's Pallas kernel
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: the largest fp32 score matrix the full-matrix oracle may build
REF_SCORE_BYTES = 2 * 2 ** 30
#: the serving shape: H2O-Danube-1.8B's attention at 4 x 4500 tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 4500, 32
FLASH_SERVE = dict(B=SERVE_BATCH, S=SERVE_PROMPT, H=32, KV=8, hd=80,
                   window=4096, causal=True)
#: RecurrentGemma-2B's serving shape: 4 x 4096 tokens, so that the prompt
#: is over the 2048 window; its local attention and its RG-LRU recurrence
RG_BATCH, RG_PROMPT, RG_NEW = 4, 4096, 32
FLASH_SERVE_RG = dict(B=RG_BATCH, S=RG_PROMPT, H=10, KV=1, hd=256,
                      window=2048, causal=True)
RGLRU_SERVE = dict(B=RG_BATCH, S=RG_PROMPT, W=2560)
#: the (H, KV) head groups of the dense, VLM and MoE families
FAMILY_GROUPS = ((16, 8), (14, 2), (56, 8), (64, 8), (48, 1))
#: serve_families: arch -> (layers run, batch, prompt, new tokens), the
#: depth cut only where one card cannot hold the model (a MoE period is one
#: layer: DeepSeek-V2 keeps its dense first layer and one MoE layer).
#: Whisper's requests carry 1500 frames each besides the prompt; 256 + 16
#: tokens stay inside its 448-position decoder context
FAMILIES = {
    "granite-moe-1b-a400m": (24, 4, 4096, 16),
    "internvl2-1b": (24, 4, 2048, 16),
    "deepseek-v2-236b": (2, 1, 2048, 16),
    "qwen3-32b": (2, 1, 2048, 8),
    "yi-34b": (2, 1, 2048, 8),
    "granite-34b": (2, 1, 2048, 8),
    "xlstm-350m": (24, 4, 2048, 16),
    "whisper-medium": (24, 4, 256, 16),
}
#: serve_families: the archs whose flash-vs-eager logits are held within
#: SERVE_TOL in fp32, as RecurrentGemma-2B's: Whisper's 48 bf16 attention
#: layers (24 encoder, 24 decoder) move its bf16 logits by 0.0625 between
#: the two paths' roundings on the card; the bf16 gap and each bf16
#: path's distance from the fp32 logits are reported
F32_LOGITS = ("whisper-medium",)
#: the families' prefill attention shapes (InternVL2's sequence holds its
#: 256 patch embeddings before the prompt; Whisper's encoder attends over
#: its 1500 frames both ways, its decoder over the prompt causally);
#: DeepSeek-V2's MLA takes the eager path, as the reference's does, and
#: xLSTM has no attention
FLASH_FAMILIES = {
    "granite-moe-1b-a400m": dict(B=4, S=4096, H=16, KV=8, hd=64, window=0,
                                 causal=True),
    "internvl2-1b": dict(B=4, S=256 + 2048, H=14, KV=2, hd=64, window=0,
                         causal=True),
    "qwen3-32b": dict(B=1, S=2048, H=64, KV=8, hd=128, window=0,
                      causal=True),
    "yi-34b": dict(B=1, S=2048, H=56, KV=8, hd=128, window=0, causal=True),
    "granite-34b": dict(B=1, S=2048, H=48, KV=1, hd=128, window=0,
                        causal=True),
    "whisper-medium": dict(B=4, S=1500, H=16, KV=16, hd=64, window=0,
                           causal=False),
    "whisper-medium.decoder": dict(B=4, S=256, H=16, KV=16, hd=64, window=0,
                                   causal=True),
}
#: secagg_mask's cases: up to the benchmark's N (benchmarks/run.py:259-263)
SECAGG_N = (1, 7, 4097, 1 << 16)
#: secagg_mask's second timed shape: one client of a 16-client round of
#: the 50M-parameter fold (N, P)
SECAGG_BIG = (50_000_000, 15)


def _flash_inputs(gen, B, S, H, KV, hd, dtype, dev):
    q = torch.randn((B, S, H, hd), generator=gen, device=dev) / hd ** 0.5
    k = torch.randn((B, S, KV, hd), generator=gen, device=dev)
    v = torch.randn((B, S, KV, hd), generator=gen, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _excess(got, want, tol: float):
    """(max |got - want|, max |got - want| / (tol + tol * |want|)): the
    second is <= 1 exactly when assert_allclose(rtol=atol=tol) passes."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), float((d / (tol + tol * want.float().abs())).max())


def _flash_cases():
    grid = []
    for S in (64, 509):
        for B in (1, 4):
            for H, KV in ((4, 4), (8, 2), (32, 8)):
                for hd in (64, 80, 128):
                    for window in (0, 16, 4096):
                        for causal in (True, False):
                            grid.append((B, S, H, KV, hd, window, causal))
    big = [(1, 4, 4), (1, 8, 2), (4, 32, 8)]
    i = 0
    for hd in (64, 80, 128):
        for window in (0, 16, 4096):
            for causal in (True, False):
                B, H, KV = big[i % 3]
                grid.append((B, SERVE_PROMPT, H, KV, hd, window, causal))
                i += 1
    # head dim 256 (RecurrentGemma's local attention: MQA, window 2048),
    # causal, up to its serving length
    for S in (64, 509, 4096):
        B = 2 if S < 4096 else 1
        for H, KV in ((10, 1), (4, 1), (8, 2)):
            for window in (0, 16, 2048):
                grid.append((B, S, H, KV, 256, window, True))
    # the query-head groups of the dense, VLM and MoE families: g = 2
    # (granite-moe 16/8), 7 (internvl2 14/2, yi 56/8), 8 (qwen3 64/8) and
    # 48 (granite-34b, MQA), each at hd 64 and 128
    for H, KV in FAMILY_GROUPS:
        for hd in (64, 128):
            for S in (64, 509):
                for window in (0, 16):
                    for causal in (True, False):
                        grid.append((1, S, H, KV, hd, window, causal))
    # head dim 16: Yi-34B's smoke variant (8/2 heads of 16), the serving
    # launcher's default
    for S, window in ((64, 0), (509, 0), (509, 16), (200, 37)):
        for causal in (True, False):
            grid.append((2, S, 8, 2, 16, window, causal))
    for f in (FLASH_SERVE, FLASH_SERVE_RG) + tuple(FLASH_FAMILIES.values()):
        grid.append((f["B"], f["S"], f["H"], f["KV"], f["hd"], f["window"],
                     f["causal"]))
    # the earlier mma.sync kernel's tile edges (64 keys, 32 at hd 256;
    # 64-row q blocks), kept as cases: S one past, one short of and between
    # tiles, and windows whose lower edge falls inside a key tile
    for hd in (32, 80, 128, 256):
        for S, window in ((65, 0), (127, 37), (200, 100), (333, 65),
                          (1000, 257)):
            grid.append((2, S, 8, 2, hd, window, True))
        grid.append((1, 200, 4, 4, hd, 37, False))
    # the wgmma kernel's tile edges (192-row q blocks up to hd 80, 128
    # above; 128-key tiles, 64 at hd 256): S one short of, at and one past
    # a query block and a key tile, causal and not; windows whose lower
    # edge falls inside a key tile, one key past its start and one before
    # its end
    from repro_torch.kernels import flash_attention as FA

    def edges(rows, keys):
        return {keys - 1, keys, keys + 1, rows - 1, rows, rows + 1,
                2 * rows + 1}

    for hd in (16, 64, 80, 128, 256):
        rows, keys = FA.tc_rows(hd), FA.tc_keys(hd)
        for S in sorted(edges(rows, keys)):
            for causal in (True, False):
                grid.append((2, S, 8, 2, hd, 0, causal))
        for window in (keys // 2 + 3, keys + 1, 2 * keys - 1, rows + 5):
            grid.append((1, 3 * rows + 7, 4, 1, hd, window, True))
    # the CUDA-core kernel's tile edges (128-row query blocks, 64 at hd
    # 256; 64-key tiles, 48 at hd 128, 32 at hd 80 and 256), the same way,
    # each S the lines above do not already take
    for hd in (16, 64, 80, 128, 256):
        rows, keys = FA.f32_rows(hd), FA.f32_keys(hd)
        taken = edges(FA.tc_rows(hd), FA.tc_keys(hd))
        for S in sorted(edges(rows, keys) - taken):
            for causal in (True, False):
                grid.append((2, S, 8, 2, hd, 0, causal))
        for window in (keys // 2 + 3, keys + 1, 2 * keys - 1, rows + 5):
            grid.append((1, 3 * rows + 7, 4, 1, hd, window, True))
    return grid


def phase_flash_vs_twin(dev):
    """``flash_attention`` against its plain twin (every case) and the
    full-matrix oracle ``flash_attention_ref`` (where its (S, S) scores fit
    in REF_SCORE_BYTES), in fp32 (the CUDA-core route) and bf16 (the
    tensor-core route), over B x S x (H, KV) x hd x window x causal, S =
    4500 (padded to 4608 by the reference's block rule) included, head dim
    256 (MQA and GQA, windows up to 2048, S up to 4096), the tensor-core
    kernel's tile edges, and a case with fully masked rows (window < 0).
    Every call must be counted on its dtype's route."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import flash_attention_ref

    for key in FA.LAUNCHES:
        FA.LAUNCHES[key] = 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(1303)
    worst = {str(dt): {"twin_max_abs": 0.0, "ref_max_abs": 0.0,
                       "twin_excess": 0.0, "ref_excess": 0.0, "tol": tol}
             for dt, tol in FLASH_TOL.items()}
    cases = ref_cases = 0
    for B, S, H, KV, hd, window, causal in _flash_cases():
        for dtype, tol in FLASH_TOL.items():
            q, k, v = _flash_inputs(gen, B, S, H, KV, hd, dtype, dev)
            got = FA.flash_attention(q, k, v, causal=causal, window=window)
            twin = FA.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            tag = f"B{B} S{S} H{H}/{KV} hd{hd} w{window} c{int(causal)} {dtype}"
            check(got.dtype == dtype and got.shape == q.shape,
                  f"flash {tag}: {got.dtype} {tuple(got.shape)}")
            w = worst[str(dtype)]
            err, exc = _excess(got, twin, tol)
            check(exc <= 1.0, f"flash {tag}: |kernel - twin| = {err}")
            w["twin_max_abs"] = max(w["twin_max_abs"], err)
            w["twin_excess"] = max(w["twin_excess"], exc)
            if B * H * S * S * 4 <= REF_SCORE_BYTES:
                want = flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
                err, exc = _excess(got, want, tol)
                check(exc <= 1.0, f"flash {tag}: |kernel - ref| = {err}")
                w["ref_max_abs"] = max(w["ref_max_abs"], err)
                w["ref_excess"] = max(w["ref_excess"], exc)
                ref_cases += 1
                del want
            cases += 1
            del q, k, v, got, twin
    # fully masked rows: key kp is visible from qp only when kp > qp + 445,
    # so rows 63.. of S = 509 see no key and must be exactly 0
    masked = 0
    for dtype, tol in FLASH_TOL.items():
        q, k, v = _flash_inputs(gen, 2, 509, 8, 2, 80, dtype, dev)
        got = FA.flash_attention(q, k, v, causal=False, window=-445)
        twin = FA.flash_attention_plain(q, k, v, causal=False, window=-445)
        err, exc = _excess(got, twin, tol)
        check(exc <= 1.0, f"flash fully-masked rows {dtype}: {err}")
        check(bool((got[:, 63:] == 0).all()) and bool((got[:, :63] != 0).any()),
              f"flash fully-masked rows {dtype}: masked rows are not 0")
        masked += 1
    # query blocks whose every key is masked: causal with a negative window
    # (kp <= qp and kp > qp + 5) leaves no row a key, though the kernels
    # visit the tiles [qp + 6, qp] would span; every row must be exactly 0
    for dtype, tol in FLASH_TOL.items():
        for hd in (64, 128, 256):
            q, k, v = _flash_inputs(gen, 1, 300, 4, 2, hd, dtype, dev)
            got = FA.flash_attention(q, k, v, causal=True, window=-5)
            check(bool((got == 0).all()),
                  f"flash fully-masked blocks {dtype} hd{hd}: not all 0")
            masked += 1
    per_dtype = cases // 2 + masked // 2
    routes = {r: FA.LAUNCHES[f"flash_attention.{r}"]
              for r in FA.ROUTES.values()}
    check(routes == {"tensor_core": per_dtype, "cuda_core": per_dtype}
          and FA.LAUNCHES["flash_attention"] == 2 * per_dtype,
          f"flash: route launches {routes}, want {per_dtype} each")
    emit("flash_vs_twin", cases=cases, ref_cases=ref_cases,
         fully_masked_cases=masked, route_launches=routes,
         worst={str(dt): dict(w, route=FA.flash_route(dt))
                for dt, w in zip(FLASH_TOL, worst.values())})
    return {FA.flash_route(dt): w["twin_max_abs"]
            for dt, w in zip(FLASH_TOL, worst.values())}


def band_pairs(S: int, causal: bool, window: int) -> int:
    """(q, k) pairs the masks leave visible over one (batch, head)."""
    qp = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros_like(qp)
    hi = qp if causal else np.full_like(qp, S - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_bound(B, S, H, KV, hd, window, causal, itemsize: int):
    """(ms, bound_by, fp32-core ms) for one ``flash_attention`` launch:
    q, k, v read once and o written once against HBM, or 4 * hd flops per
    visible (q, k) pair against the bf16 tensor cores (989 TFLOP/s); the
    third is the same flops against the fp32 CUDA cores (67 TFLOP/s), the
    least time a kernel on those cores could take."""
    flops = 4 * hd * B * H * band_pairs(S, causal, window)
    nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * itemsize
    ms, by = _bound(nbytes, flops, BF16_TENSOR_FLOPS)
    return ms, by, flops / FP32_FLOPS * 1e3, flops


# ---------------------------------------------------------------------------
# phase 7: the slice at full width -- serve H2O-Danube-1.8B (slice 3)
# ---------------------------------------------------------------------------
#: assert_allclose tolerance (rtol = atol) of the last-position prefill
#: logits of impl="flash" against impl="eager", both in bf16: the two
#: differ in how the softmax weights are rounded (fp32 in the kernel, bf16
#: before the value product in the eager path), as the tests' 5e-2 for bf16.
#: RecurrentGemma-2B's two paths are held to it in fp32 (see
#: phase_serve_recurrentgemma), and so are Whisper-medium's (F32_LOGITS)
SERVE_TOL = 5e-2


def phase_serve(dev, card: str):
    """Slice 3's main path: H2O-Danube-1.8B at full width and depth, random
    weights from seed 0, 4 requests of 4500 prompt tokens and 32 new tokens
    through ``launch.serve.serve`` with impl="flash" (the kernel in every
    layer's prefill), then the same weights and prompt with impl="eager"."""
    from repro_torch.config import get_model_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    from repro_torch.models.base import iter_leaves

    cfg = get_model_config("h2o-danube-1.8b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(cfg).init(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in iter_leaves(params))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int64)
    for key in FA.LAUNCHES:
        FA.LAUNCHES[key] = 0
    flash = serve(cfg, params, tokens, new_tokens=SERVE_NEW, impl="flash",
                  device=dev)
    launches = FA.LAUNCHES["flash_attention"]
    routes = {r: FA.LAUNCHES[f"flash_attention.{r}"]
              for r in FA.ROUTES.values()}
    peak_flash = torch.cuda.max_memory_allocated()
    check(launches == cfg.num_layers,
          f"serve: {launches} flash launches, want {cfg.num_layers}")
    # the bf16 prefill: every launch on the tensor cores
    check(routes == {"tensor_core": cfg.num_layers, "cuda_core": 0},
          f"serve: flash launches by route {routes}, want all "
          f"{cfg.num_layers} on the tensor cores")
    torch.cuda.reset_peak_memory_stats()
    eager = serve(cfg, params, tokens, new_tokens=SERVE_NEW, impl="eager",
                  device=dev)
    peak_eager = torch.cuda.max_memory_allocated()
    check(FA.LAUNCHES["flash_attention"] == launches,
          "serve: impl='eager' launched the flash kernel")
    for name, r in (("flash", flash), ("eager", eager)):
        check(r.finite, f"serve {name}: non-finite logits")
        check(tuple(r.ids.shape) == (SERVE_BATCH, SERVE_NEW),
              f"serve {name}: ids {tuple(r.ids.shape)}")
    lf, le = flash.prefill_logits, eager.prefill_logits
    err, exc = _excess(lf, le, SERVE_TOL)
    check(exc <= 1.0, f"serve: prefill logits flash vs eager |d| = {err}")
    agree = float((flash.ids == eager.ids).float().mean())
    emit("serve", card=card, arch=cfg.name, params=n_params, layers=cfg.num_layers,
         d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         head_dim=cfg.resolved_head_dim, window=cfg.window,
         batch=SERVE_BATCH, prompt=SERVE_PROMPT, new_tokens=SERVE_NEW,
         flash_launches=launches, flash_launches_by_route=routes,
         init_s=init_s,
         prefill_ms={"flash": flash.prefill_s * 1e3,
                     "eager": eager.prefill_s * 1e3},
         decode_ms_per_token={
             "flash": flash.decode_s * 1e3 / (SERVE_NEW - 1),
             "eager": eager.decode_s * 1e3 / (SERVE_NEW - 1)},
         peak_mem_gb={"flash": peak_flash / 1e9, "eager": peak_eager / 1e9},
         logits_max_abs_diff=err, logits_tol=SERVE_TOL, logits_excess=exc,
         logits_max_abs=float(le[:, :cfg.vocab_size].abs().max()),
         ids_agree=agree,
         ids_flash=flash.ids.tolist(), ids_eager=eager.ids.tolist())
    del params, flash, eager
    torch.cuda.empty_cache()
    return launches


def flash_mask(S: int, causal: bool, window: int, dev):
    """The boolean (S, S) causal + window mask the library yardstick
    ``scaled_dot_product_attention`` takes, or None for a non-causal layer
    with no window."""
    qpos = torch.arange(S, device=dev)[:, None]
    kpos = torch.arange(S, device=dev)[None, :]
    mask = None
    if causal:
        mask = kpos <= qpos
    if window:
        band = kpos > qpos - window
        mask = band if mask is None else mask & band
    return mask


#: launches a time of the fp32 (CUDA-core) route in phase_flash_timing
FLASH_F32_REPS = 10


def _f32_row(timing: dict) -> dict:
    """The fp32 route's numbers of a ``phase_flash_timing`` result, as a
    kernel entry of the ``kernels`` line holds them."""
    r = timing["routes"]["cuda_core"]
    return dict(ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
                share_of_bound=r["share_of_bound"],
                kernel_over_library=r["kernel_over_library"],
                max_abs_diff=r["max_abs_diff"],
                shape=timing["shape"].replace(", bf16", ", fp32"))


def phase_flash_timing(dev, card: str, f=FLASH_SERVE, seed: int = 4500):
    """The kernel per launch at a serving layer's shape ``f``, by CUDA
    events, beside its bound, its twin and the library yardstick
    ``scaled_dot_product_attention`` (enable_gqa, the same boolean causal +
    window mask, or none for a non-causal layer with no window; timed only,
    never on the port's path); then the fp32 route on the same values (the
    CUDA-core kernel), held to its twin within FLASH_TOL[float32] and timed
    the same way, beside its bound on the fp32 CUDA cores."""
    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = _flash_inputs(gen, f["B"], f["S"], f["H"], f["KV"], f["hd"],
                            torch.bfloat16, dev)
    args = dict(causal=f["causal"], window=f["window"])
    got = FA.flash_attention(q, k, v, **args)
    twin = FA.flash_attention_plain(q, k, v, **args)
    err, exc = _excess(got, twin, FLASH_TOL[torch.bfloat16])
    check(exc <= 1.0, f"flash at the serving shape: |kernel - twin| = {err}")
    kernel_ms = event_ms(lambda: FA.flash_attention(q, k, v, **args),
                         reps=20)
    plain_ms = event_ms(lambda: FA.flash_attention_plain(q, k, v, **args),
                        reps=2)
    # the fp32 route on the same values (the CUDA-core kernel)
    q32, k32, v32 = q.float(), k.float(), v.float()
    got32 = FA.flash_attention(q32, k32, v32, **args)
    twin32 = FA.flash_attention_plain(q32, k32, v32, **args)
    err32, exc32 = _excess(got32, twin32, FLASH_TOL[torch.float32])
    check(got32.dtype == torch.float32 and exc32 <= 1.0,
          f"flash fp32 at the serving shape: |kernel - twin| = {err32}")
    del got32, twin32
    cuda_core_ms = event_ms(lambda: FA.flash_attention(q32, k32, v32,
                                                       **args),
                            reps=FLASH_F32_REPS)
    plain_f32_ms = event_ms(lambda: FA.flash_attention_plain(
        q32, k32, v32, **args), reps=1)
    S = f["S"]
    mask = flash_mask(S, f["causal"], f["window"], dev)

    def sdpa(q, k, v):
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, scale=1.0, enable_gqa=True)

    # the yardstick's kernels need not be deterministic: they are timed
    # only; the fp32 route's yardstick is the same call on the fp32 values
    torch.use_deterministic_algorithms(False)
    try:
        lib = sdpa(q, k, v)().transpose(1, 2)
        library_ms = event_ms(sdpa(q, k, v))
        library_f32_ms = event_ms(sdpa(q32, k32, v32), reps=3)
    finally:
        torch.use_deterministic_algorithms(True)
    del q32, k32, v32
    lib_err = float((lib.float() - twin.float()).abs().max())
    bound_ms, bound_by, fp32_ms, flops = flash_bound(
        f["B"], S, f["H"], f["KV"], f["hd"], f["window"], f["causal"], 2)
    # the fp32 route's bound: its fp32 bytes against HBM, or its flops
    # against the fp32 CUDA cores (fp32_ms)
    f32_bytes = (2 * f["B"] * S * f["H"] * f["hd"]
                 + 2 * f["B"] * S * f["KV"] * f["hd"]) * 4
    f32_bound_ms, f32_bound_by = _bound(f32_bytes, flops, FP32_FLOPS)
    shape = (f"B{f['B']} S{S} H{f['H']}/KV{f['KV']} hd{f['hd']} "
             f"window {f['window']} {'causal' if f['causal'] else 'non-causal'}"
             f", bf16")
    routes = {"tensor_core": {"dtype": "bfloat16", "ms": kernel_ms,
                              "tflops": flops / kernel_ms / 1e9,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": library_ms},
              "cuda_core": {"dtype": "float32", "ms": cuda_core_ms,
                            "reps": FLASH_F32_REPS,
                            "tflops": flops / cuda_core_ms / 1e9,
                            "plain_ms": plain_f32_ms,
                            "bound_ms": f32_bound_ms,
                            "bound_by": f32_bound_by,
                            "library_ms": library_f32_ms,
                            "share_of_bound": f32_bound_ms / cuda_core_ms,
                            "kernel_over_library":
                                cuda_core_ms / library_f32_ms,
                            "max_abs_diff": err32,
                            "tol": FLASH_TOL[torch.float32]}}
    emit("flash_timing", card=card, shape=shape,
         route=FA.flash_route(q.dtype), kernel_ms=kernel_ms,
         kernel_tflops=flops / kernel_ms / 1e9, library_ms=library_ms,
         library_tflops=flops / library_ms / 1e9, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by,
         share_of_bound=bound_ms / kernel_ms,
         kernel_over_library=kernel_ms / library_ms,
         fp32_core_bound_ms=fp32_ms, gflop=flops / 1e9, routes=routes,
         max_abs_diff=err, library_max_abs_diff_vs_twin=lib_err)
    del q, k, v, got, twin, lib, mask
    torch.cuda.empty_cache()
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / kernel_ms,
                kernel_over_library=kernel_ms / library_ms, shape=shape,
                routes=routes, max_abs_diff=err)


# ---------------------------------------------------------------------------
# phase 8: rglru_scan, the kernel against its twin, bitwise (slice 4)
# ---------------------------------------------------------------------------
def _rglru_inputs(gen, B, S, W, dev, h0_zero: bool):
    """a in (0.9, 1) as the serving model's gates give it, with an edge
    column of a = 0 (forget) and one of a = 1 (sum); b normal; h0 zero or
    normal."""
    a = 0.9 + 0.1 * torch.rand((B, S, W), generator=gen, device=dev)
    a[:, :, 0] = 0.0
    a[:, :, W // 2] = 1.0
    b = torch.randn((B, S, W), generator=gen, device=dev)
    h0 = (torch.zeros((B, W), device=dev) if h0_zero
          else torch.randn((B, W), generator=gen, device=dev))
    return a, b, h0


def _strided(x, pad_steps: int = 3, pad_cols: int = 5):
    """``x`` (B, S, W) as a view of a larger tensor: steps [2, S + 2) and
    columns [1, W + 1) of a (B, S + pad_steps, W + pad_cols) tensor
    (``pad_steps`` >= 2, ``pad_cols`` >= 1): batch stride
    (S + pad_steps) (W + pad_cols), not S W; sequence stride W + pad_cols;
    W contiguous; the start one element past the allocation's."""
    B, S, W = x.shape
    big = torch.zeros((B, S + pad_steps, W + pad_cols), dtype=x.dtype,
                      device=x.device)
    view = big[:, 2:S + 2, 1:W + 1]
    view.copy_(x)
    return view


def _rglru_case(RS, a, b, h0, tag: str) -> None:
    """One launch of ``rglru_scan``, bitwise its twin; h_final the last
    step."""
    B, S, W = a.shape
    before = RS.LAUNCHES["rglru_scan"]
    ys, hf = RS.rglru_scan(a, b, h0)
    ys_t, hf_t = RS.rglru_scan_plain(a, b, h0)
    torch.cuda.synchronize()
    check(RS.LAUNCHES["rglru_scan"] == before + 1,
          f"rglru {tag}: not one launch")
    check(ys.shape == (B, S, W) and hf.shape == (B, W),
          f"rglru {tag}: shapes {tuple(ys.shape)}")
    check(torch.equal(ys.view(torch.int32), ys_t.view(torch.int32))
          and torch.equal(hf.view(torch.int32), hf_t.view(torch.int32)),
          f"rglru {tag}: kernel != twin, max|d| = "
          f"{float((ys - ys_t).abs().max())}")
    check(torch.equal(hf, ys[:, -1]), f"rglru {tag}: h_final != ys[:, -1]")


def phase_rglru_vs_twin(dev):
    """``rglru_scan`` against its twin (``h = a[:, t] * h + b[:, t]``, two
    rounded ops a step), bitwise, over B 1/4 x S 1/7/257/4096 x W
    128/2560/2561 x h0 zero or random, then at the ring's edges (B 3): S
    at one stage -1/0/+1 and at the ring's depth (stages x steps) -1/0/+1,
    W at the CTA width -1/0/+1, with a, b and h0 contiguous or strided
    views (:func:`_strided`); S = 0 launches nothing."""
    from repro_torch.kernels import rglru_scan as RS

    gen = torch.Generator(device=dev)
    gen.manual_seed(1404)
    cases = 0
    for B in (1, 4):
        for S in (1, 7, 257, 4096):
            for W in (128, 2560, 2561):
                for h0_zero in (True, False):
                    a, b, h0 = _rglru_inputs(gen, B, S, W, dev, h0_zero)
                    _rglru_case(RS, a, b, h0, f"B{B} S{S} W{W} "
                                f"h0={'0' if h0_zero else 'rand'}")
                    cases += 1
                    del a, b, h0
    ring = RS.RING
    step, depth, cols = ring["steps"], ring["steps"] * ring["stages"], \
        ring["cols"]
    edge_s = (step - 1, step, step + 1, depth - 1, depth, depth + 1)
    edge_w = (cols - 1, cols, cols + 1)
    for S in edge_s:
        for W in edge_w:
            for strided in (False, True):
                a, b, h0 = _rglru_inputs(gen, 3, S, W, dev, False)
                if strided:
                    a, b = _strided(a), _strided(b, 2, 2)
                    h0 = _strided(h0[:, None])[:, 0]
                _rglru_case(RS, a, b, h0, f"B3 S{S} W{W} strided={strided}")
                cases += 1
                del a, b, h0
    a, b, h0 = _rglru_inputs(gen, 2, 0, 64, dev, False)
    before = RS.LAUNCHES["rglru_scan"]
    ys, hf = RS.rglru_scan(a, b, h0)
    check(ys.shape == (2, 0, 64) and torch.equal(hf, h0)
          and RS.LAUNCHES["rglru_scan"] == before,
          "rglru S = 0: not the empty ys and h0, or a launch")
    emit("rglru_vs_twin", cases=cases, max_abs_diff=0.0, bitwise=True,
         empty_sequence_ok=True, ring=ring, edge_s=list(edge_s),
         edge_w=list(edge_w))
    return 0.0


def rglru_bound(B: int, S: int, W: int):
    """(ms, bound_by): a and b read once and ys written once (h0 and
    h_final are W-sized) against HBM, or 2 flops an element against the
    fp32 cores, whichever is larger."""
    nbytes = 3 * B * S * W * 4 + 2 * B * W * 4
    return _bound(nbytes, 2 * B * S * W, FP32_FLOPS)


def phase_rglru_timing(dev, card: str):
    """The kernel per launch at RecurrentGemma's serving shape (B 4, S 4096,
    W 2560), by CUDA events, beside its bound, its twin and the eager
    log-depth scan of ``models.recurrent`` (the yardstick: no single
    PyTorch call computes a linear recurrence)."""
    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.models.recurrent import linear_scan_eager

    r = RGLRU_SERVE
    gen = torch.Generator(device=dev)
    gen.manual_seed(4096)
    a, b, h0 = _rglru_inputs(gen, r["B"], r["S"], r["W"], dev, False)
    ys, hf = RS.rglru_scan(a, b, h0)
    ys_t, _ = RS.rglru_scan_plain(a, b, h0)
    check(torch.equal(ys.view(torch.int32), ys_t.view(torch.int32)),
          "rglru at the serving shape: kernel != twin")
    b0 = b.clone()
    b0[:, 0] += a[:, 0] * h0

    def eager():
        return linear_scan_eager(a, b0)

    ys_e = eager()
    eager_err = float((ys_e - ys).abs().max())
    check(torch.allclose(ys_e, ys, rtol=1e-4, atol=1e-4),
          f"rglru at the serving shape: eager scan |d| = {eager_err}")
    del ys_t, ys_e
    kernel_ms = event_ms(lambda: RS.rglru_scan(a, b, h0), reps=20)
    plain_ms = event_ms(lambda: RS.rglru_scan_plain(a, b, h0), reps=2)
    eager_ms = event_ms(eager, reps=3)
    bound_ms, bound_by = rglru_bound(r["B"], r["S"], r["W"])
    shape = f"B{r['B']} S{r['S']} W{r['W']} fp32"
    gbytes = (3 * r["B"] * r["S"] * r["W"] * 4) / 1e9
    emit("rglru_timing", card=card, shape=shape, kernel_ms=kernel_ms,
         plain_ms=plain_ms, eager_scan_ms=eager_ms, bound_ms=bound_ms,
         bound_by=bound_by, kernel_gbps=gbytes / kernel_ms * 1e3,
         eager_scan_max_abs_diff=eager_err)
    del a, b, h0, b0, ys, hf
    torch.cuda.empty_cache()
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
                eager_scan_ms=eager_ms, bound_ms=bound_ms,
                bound_by=bound_by, shape=shape)


# ---------------------------------------------------------------------------
# phase 9: the slice at full width -- serve RecurrentGemma-2B (slice 4)
# ---------------------------------------------------------------------------
def phase_serve_recurrentgemma(dev, card: str):
    """Slice 4's main path: RecurrentGemma-2B at full width and depth (26
    layers: 18 RG-LRU, 8 local attention at head dim 256), random weights
    from seed 0, 4 requests of 4096 prompt tokens (over the 2048 window)
    and 32 new tokens through ``launch.serve.serve`` with impl="flash"
    (both kernels in the prefill), then the same weights and prompt with
    impl="eager".  The launches are read right after the prefill and after
    the decode loop, through a wrapper around the prefill step that
    ``serve`` builds.  Then the same prompt's prefill in fp32, flash and
    eager, whose logits must agree."""
    from repro_torch.config import RGLRU, get_model_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import build_model
    from repro_torch.models.base import iter_leaves

    cfg = get_model_config("recurrentgemma-2b")
    kinds = cfg.layer_kinds
    n_rglru = sum(k == RGLRU for k in kinds)
    n_attn = len(kinds) - n_rglru
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(cfg).init(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in iter_leaves(params))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (RG_BATCH, RG_PROMPT), dtype=np.int64)

    counts = lambda: (FA.LAUNCHES["flash_attention"],  # noqa: E731
                      RS.LAUNCHES["rglru_scan"],
                      FA.LAUNCHES["flash_attention.tensor_core"])
    after_prefill = []
    make_prefill = serve_mod.make_prefill_step

    def counting_prefill(model, **kw):
        step = make_prefill(model, **kw)

        def run(params, batch):
            out = step(params, batch)
            after_prefill.append(counts())
            return out

        return run

    serve_mod.make_prefill_step = counting_prefill
    try:
        runs, peaks, launches = {}, {}, {}
        for impl in ("flash", "eager"):
            for key in FA.LAUNCHES:
                FA.LAUNCHES[key] = 0
            RS.LAUNCHES["rglru_scan"] = 0
            torch.cuda.reset_peak_memory_stats()
            runs[impl] = serve_mod.serve(cfg, params, tokens,
                                         new_tokens=RG_NEW, impl=impl,
                                         device=dev)
            peaks[impl] = torch.cuda.max_memory_allocated()
            pf, total = after_prefill[-1], counts()
            launches[impl] = {
                "prefill": {"flash_attention": pf[0], "rglru_scan": pf[1],
                            "flash_attention.tensor_core": pf[2]},
                "decode": {"flash_attention": total[0] - pf[0],
                           "rglru_scan": total[1] - pf[1],
                           "flash_attention.tensor_core": total[2] - pf[2]}}
    finally:
        serve_mod.make_prefill_step = make_prefill
    fl = launches["flash"]
    # the bf16 prefill: every flash launch on the tensor cores
    check(fl["prefill"] == {"flash_attention": n_attn, "rglru_scan": n_rglru,
                            "flash_attention.tensor_core": n_attn}
          and (n_attn, n_rglru) == (8, 18),
          f"serve_recurrentgemma: flash prefill launches {fl['prefill']}, "
          f"want 8 flash_attention (all on the tensor cores) and 18 "
          f"rglru_scan")
    check(all(v == 0 for v in fl["decode"].values()),
          f"serve_recurrentgemma: decode launched kernels {fl['decode']}")
    ea = launches["eager"]
    check(all(v == 0 for part in ea.values() for v in part.values()),
          f"serve_recurrentgemma: impl='eager' launched kernels {ea}")
    flash, eager = runs["flash"], runs["eager"]
    for name, r in runs.items():
        check(r.finite, f"serve_recurrentgemma {name}: non-finite logits")
        check(tuple(r.ids.shape) == (RG_BATCH, RG_NEW),
              f"serve_recurrentgemma {name}: ids {tuple(r.ids.shape)}")
    # flash against eager: in fp32, where the two paths must agree (the
    # kernels against the eager scan and eager attention, nothing else
    # differs), the same prompt's last-position prefill logits within
    # SERVE_TOL.  In bf16 they are not held to it: at this depth a change of
    # rounding anywhere (the attention path alone, or the recurrence alone)
    # moves them by ~0.17, as far as either lies from the fp32 logits
    # (PERF.md, section 6); those distances are reported.
    f32 = {}
    f32_launches = 0
    model32 = build_model(cfg.replace(dtype="float32"))
    for impl in ("flash", "eager"):
        for key in FA.LAUNCHES:
            FA.LAUNCHES[key] = 0
        RS.LAUNCHES["rglru_scan"] = 0
        step = make_prefill(model32, max_len=RG_PROMPT + RG_NEW, impl=impl)
        f32[impl] = step(params, {"tokens": torch.as_tensor(
            tokens, device=dev)})[0][:, :cfg.vocab_size].float()
        torch.cuda.synchronize()
        # fp32: the flash launches on the CUDA cores
        want = (n_attn, n_rglru, 0) if impl == "flash" else (0, 0, 0)
        check(counts() == want
              and FA.LAUNCHES["flash_attention.cuda_core"] == want[0],
              f"serve_recurrentgemma fp32 {impl}: launches {counts()}, "
              f"want {want}")
        if impl == "flash":
            f32_launches = FA.LAUNCHES["flash_attention.cuda_core"]
    err, exc = _excess(f32["flash"], f32["eager"], SERVE_TOL)
    check(exc <= 1.0, f"serve_recurrentgemma: fp32 prefill logits flash vs "
          f"eager |d| = {err}")
    lf = flash.prefill_logits[:, :cfg.vocab_size]
    le = eager.prefill_logits[:, :cfg.vocab_size]
    bf16_err, bf16_exc = _excess(lf, le, SERVE_TOL)
    bf16_vs_f32 = {"flash": _excess(lf, f32["flash"], SERVE_TOL)[0],
                   "eager": _excess(le, f32["flash"], SERVE_TOL)[0]}
    agree = float((flash.ids == eager.ids).float().mean())
    emit("serve_recurrentgemma", card=card, arch=cfg.name, params=n_params,
         layers=cfg.num_layers, rglru_layers=n_rglru, attention_layers=n_attn,
         d_model=cfg.d_model, lru_width=cfg.lru_width, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
         window=cfg.window, batch=RG_BATCH, prompt=RG_PROMPT,
         new_tokens=RG_NEW, launches=launches,
         f32_flash_launches_by_route={"tensor_core": 0,
                                      "cuda_core": f32_launches},
         init_s=init_s,
         prefill_ms={"flash": flash.prefill_s * 1e3,
                     "eager": eager.prefill_s * 1e3},
         decode_ms_per_token={
             "flash": flash.decode_s * 1e3 / (RG_NEW - 1),
             "eager": eager.decode_s * 1e3 / (RG_NEW - 1)},
         peak_mem_gb={k: v / 1e9 for k, v in peaks.items()},
         f32_logits_max_abs_diff=err, logits_tol=SERVE_TOL,
         f32_logits_excess=exc, bf16_logits_max_abs_diff=bf16_err,
         bf16_logits_excess=bf16_exc, bf16_vs_f32_max_abs=bf16_vs_f32,
         logits_max_abs=float(f32["flash"].abs().max()),
         ids_agree=agree,
         ids_flash=flash.ids.tolist(), ids_eager=eager.ids.tolist())
    del params, runs, flash, eager, f32
    torch.cuda.empty_cache()
    return dict(fl["prefill"], f32_cuda_core=f32_launches)


# ---------------------------------------------------------------------------
# phase 9b: the dense, VLM, MoE and MLA families at full width (slice 12)
# ---------------------------------------------------------------------------
def _routing_flips(sets: dict) -> list:
    """Per MoE layer, the share of prompt tokens whose top-k expert set
    differs between the flash and the eager prefill (``sets[impl]``: one
    (tokens, k) tensor of sorted expert indices per MoE layer, in order)."""
    flash, eager = sets["flash"], sets["eager"]
    check(len(flash) == len(eager),
          f"serve_families: {len(flash)} MoE layers routed with flash, "
          f"{len(eager)} with eager")
    return [float((f != e).any(-1).float().mean())
            for f, e in zip(flash, eager)]


def phase_serve_families(dev, card: str):
    """Slices 12 and 13's main path: each of the six dense, VLM, MoE and
    MLA architectures, xLSTM-350M and Whisper-medium at full width, random
    weights from seed 0, through ``launch.serve.serve`` with impl="flash",
    then the same weights and prompt with impl="eager" (FAMILIES: depth
    cut only where one card cannot hold the model).  InternVL2-1B's
    requests carry its 256 patch embeddings, Whisper's its 1500 audio
    frames (seeded normals).  Flash launches are read after each prefill
    and after its decode loop (after one uncounted warm-up serve per path
    at the same shapes): every attention layer's prefill launches the
    kernel once on the tensor-core route (Whisper: each encoder layer,
    non-causal, and each decoder self-attention; DeepSeek-V2's MLA none,
    as the reference pins it to XLA; xLSTM has no attention), decode
    none.  The last-position prefill logits of flash and eager agree
    within SERVE_TOL (for the F32_LOGITS archs, those of a further fp32
    prefill each, whose flash path launches every attention layer on the
    CUDA-core route); for the MoE archs each layer's top-k expert sets over
    every prompt token are
    compared between the two runs, and a logit gap past SERVE_TOL fails
    only where no routing differs (a bf16 difference upstream can flip a
    routing, and a flip moves the logits)."""
    from repro_torch.config import ATTENTION_KINDS, MLA, get_model_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import build_model
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.models.base import iter_leaves

    make_prefill = serve_mod.make_prefill_step
    top_k = mlp_mod.top_k
    launches = lambda: dict(FA.LAUNCHES)  # noqa: E731
    state = {"prefill": False, "sets": [], "after_prefill": None}

    def counting_prefill(model, **kw):
        step = make_prefill(model, **kw)

        def run(params, batch):
            state["prefill"] = True
            try:
                out = step(params, batch)
            finally:
                state["prefill"] = False
            state["after_prefill"] = launches()
            return out

        return run

    def recording_top_k(probs, k):
        vals, idx = top_k(probs, k)
        if state["prefill"]:
            state["sets"].append(
                torch.sort(idx.reshape(-1, k), dim=-1).values.cpu())
        return vals, idx

    out = {}
    serve_mod.make_prefill_step = counting_prefill
    mlp_mod.top_k = recording_top_k
    try:
        for arch, (layers, batch, prompt, new) in FAMILIES.items():
            full = get_model_config(arch)
            cfg = full.replace(num_layers=layers)
            n_attn = sum(k in ATTENTION_KINDS and k != MLA
                         for k in cfg.layer_kinds)
            if cfg.is_encoder_decoder:
                n_attn += cfg.num_encoder_layers
            moe_layers = (cfg.num_layers - cfg.moe.first_dense_layers
                          if cfg.moe.enabled else 0)
            gc_collect()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params = build_model(cfg).init(0, device=dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            n_params = sum(t.numel() for _, t in iter_leaves(params))
            rng = np.random.default_rng(0)
            tokens = rng.integers(0, cfg.vocab_size, (batch, prompt),
                                  dtype=np.int64)
            extra = audio = None
            if cfg.frontend == "vision":
                extra = torch.from_numpy(rng.normal(size=(
                    batch, cfg.num_prefix_tokens, cfg.d_model)).astype(
                        np.float32)).to(dev)
            if cfg.is_encoder_decoder:
                audio = torch.from_numpy(rng.normal(size=(
                    batch, cfg.encoder_seq, cfg.d_model)).astype(
                        np.float32)).to(dev)
            # warm-up at the timed shapes (cuBLAS's and the allocator's
            # first calls), uncounted: the counts are zeroed below
            for impl in ("flash", "eager"):
                serve_mod.serve(cfg, params, tokens, new_tokens=2, impl=impl,
                                device=dev, extra_embeds=extra,
                                audio_embeds=audio)
            runs, peaks, counts, sets = {}, {}, {}, {}
            for impl in ("flash", "eager"):
                for key in FA.LAUNCHES:
                    FA.LAUNCHES[key] = 0
                state["sets"] = []
                torch.cuda.reset_peak_memory_stats()
                runs[impl] = serve_mod.serve(cfg, params, tokens,
                                             new_tokens=new, impl=impl,
                                             device=dev, extra_embeds=extra,
                                             audio_embeds=audio)
                peaks[impl] = torch.cuda.max_memory_allocated()
                pf, total = state["after_prefill"], launches()
                counts[impl] = {
                    "prefill": {r: pf[f"flash_attention.{r}"]
                                for r in FA.ROUTES.values()},
                    "decode": {r: total[f"flash_attention.{r}"]
                               - pf[f"flash_attention.{r}"]
                               for r in FA.ROUTES.values()}}
                sets[impl] = state["sets"]
            fl, ea = counts["flash"], counts["eager"]
            # the bf16 prefill: every attention layer on the tensor cores
            check(fl["prefill"] == {"tensor_core": n_attn, "cuda_core": 0},
                  f"serve_families {arch}: flash prefill launches "
                  f"{fl['prefill']}, want {n_attn} on the tensor cores")
            check(all(v == 0 for v in fl["decode"].values()),
                  f"serve_families {arch}: decode launched {fl['decode']}")
            check(all(v == 0 for part in ea.values() for v in part.values()),
                  f"serve_families {arch}: impl='eager' launched {ea}")
            n_prefill = batch * (prompt + (cfg.num_prefix_tokens
                                           if extra is not None else 0))
            flips = None
            if moe_layers:
                check(all(len(v) == moe_layers for v in sets.values())
                      and all(t.shape[0] == n_prefill
                              for v in sets.values() for t in v),
                      f"serve_families {arch}: routing recorded for "
                      f"{[len(v) for v in sets.values()]} MoE layers, want "
                      f"{moe_layers} of {n_prefill} tokens")
                flips = _routing_flips(sets)
            for name, r in runs.items():
                check(r.finite, f"serve_families {arch} {name}: non-finite "
                      f"logits")
                check(tuple(r.ids.shape) == (batch, new),
                      f"serve_families {arch} {name}: ids "
                      f"{tuple(r.ids.shape)}")
            V = cfg.vocab_size
            lf = runs["flash"].prefill_logits[:, :V]
            le = runs["eager"].prefill_logits[:, :V]
            err, exc = _excess(lf, le, SERVE_TOL)
            flipped = bool(flips) and max(flips) > 0
            f32, f32_routes = {}, None
            if arch in F32_LOGITS:
                # the same prompt's prefill in fp32 through both paths:
                # flash launches every attention layer on the CUDA-core
                # route, eager none
                model32 = build_model(cfg.replace(dtype="float32"))
                batch32 = {"tokens": torch.as_tensor(tokens, device=dev)}
                if audio is not None:
                    batch32["audio_embeds"] = audio
                for impl in ("flash", "eager"):
                    for key in FA.LAUNCHES:
                        FA.LAUNCHES[key] = 0
                    step = make_prefill(model32, max_len=prompt + new,
                                        impl=impl)
                    f32[impl] = step(params, batch32)[0][:, :V].float()
                    torch.cuda.synchronize()
                    got = {r: FA.LAUNCHES[f"flash_attention.{r}"]
                           for r in FA.ROUTES.values()}
                    want = {"tensor_core": 0,
                            "cuda_core": n_attn if impl == "flash" else 0}
                    check(got == want,
                          f"serve_families {arch}: fp32 {impl} prefill "
                          f"launches {got}, want {want}")
                    if impl == "flash":
                        f32_routes = got
                f32_err, f32_exc = _excess(f32["flash"], f32["eager"],
                                           SERVE_TOL)
                check(f32_exc <= 1.0,
                      f"serve_families {arch}: fp32 prefill logits flash vs "
                      f"eager |d| = {f32_err}")
            else:
                check(exc <= 1.0 or flipped,
                      f"serve_families {arch}: prefill logits flash vs eager "
                      f"|d| = {err} with the same routing")
            row = dict(
                card=card, arch=arch, params=n_params, layers=layers,
                full_layers=full.num_layers,
                encoder_layers=cfg.num_encoder_layers,
                frames=(cfg.encoder_seq if audio is not None else 0),
                depth_cut=layers < full.num_layers,
                d_model=cfg.d_model, heads=cfg.num_heads,
                kv_heads=cfg.num_kv_heads,
                head_dim=(cfg.resolved_head_dim if n_attn else None),
                attention_layers=n_attn, moe_layers=moe_layers,
                batch=batch, prompt=prompt,
                prefix=(cfg.num_prefix_tokens if extra is not None else 0),
                new_tokens=new, init_s=init_s,
                flash_launches_by_route=fl,
                f32_flash_launches_by_route=f32_routes,
                prefill_ms={k: r.prefill_s * 1e3 for k, r in runs.items()},
                decode_ms_per_token={k: r.decode_s * 1e3 / (new - 1)
                                     for k, r in runs.items()},
                peak_mem_gb={k: v / 1e9 for k, v in peaks.items()},
                finite=all(r.finite for r in runs.values()),
                logits_max_abs_diff=err, logits_tol=SERVE_TOL,
                logits_excess=exc,
                logits_max_abs=float(le.abs().max()),
                logits_held_in=("float32" if f32 else "bfloat16"),
                f32_logits_max_abs_diff=(f32_err if f32 else None),
                f32_logits_excess=(f32_exc if f32 else None),
                bf16_vs_f32_max_abs=(
                    {"flash": _excess(lf, f32["flash"], SERVE_TOL)[0],
                     "eager": _excess(le, f32["flash"], SERVE_TOL)[0]}
                    if f32 else None),
                routing_flip_share=flips,
                routing_flips_explain_gap=(exc > 1.0 and flipped),
                ids_agree=float((runs["flash"].ids
                                 == runs["eager"].ids).float().mean()))
            emit("serve_families", **row)
            out[arch] = row
            del params, runs, extra, audio, sets, f32
            state["sets"] = []
    finally:
        serve_mod.make_prefill_step = make_prefill
        mlp_mod.top_k = top_k
    gc_collect()
    return ({arch: r["flash_launches_by_route"]["prefill"]["tensor_core"]
             for arch, r in out.items()},
            {arch: r["f32_flash_launches_by_route"]["cuda_core"]
             for arch, r in out.items()
             if r["f32_flash_launches_by_route"] is not None})


# ---------------------------------------------------------------------------
# phase 10: slice 5's kernels against their twins
# ---------------------------------------------------------------------------
def phase_secagg_vs_twin(dev):
    """``secagg_mask`` against its twin, exactly, over N 1 / 7 / 4097 /
    2**16 x P 0 / 1 / 3 / 15 masks x weights 1 and 3, x holding values
    that clip, NaN and +-inf, masks over the whole int32 range (their sum
    wraps)."""
    from repro_torch.kernels import secagg_mask as SM

    gen = torch.Generator(device=dev)
    gen.manual_seed(1505)
    edge = torch.tensor([1e6, -1e6, float("nan"), float("inf"),
                         -float("inf"), 2.5 / 65536, -2.5 / 65536, 1e30],
                        device=dev)
    cases = 0
    for n in SECAGG_N:
        for p in (0, 1, 3, 15):
            for w in (1.0, 3.0):
                x = 3e3 * torch.randn(n, device=dev, generator=gen)
                k = min(n, edge.numel())
                x[:k] = edge[:k]
                if n > 64:
                    x[torch.randint(n, (n // 50,), device=dev,
                                    generator=gen)] = float("nan")
                masks = _int32_masks(gen, p, n, dev)
                got = SM.secagg_mask(x, masks, w)
                want = SM.secagg_mask_plain(x, masks, w)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"secagg_mask != twin: N={n} P={p} w={w}")
                cases += 1
    emit("secagg_vs_twin", cases=cases, max_abs_diff=0.0, exact=True)
    return 0.0


def _int32_masks(gen, p: int, n: int, dev):
    """(P, N) int32 masks drawn over the whole int32 range."""
    return torch.randint(-2 ** 31, 2 ** 31, (p, n), dtype=torch.int64,
                         device=dev, generator=gen).to(torch.int32)


def phase_wsum_f32_vs_twin(dev):
    """``weighted_sum`` with fp32 tiles against its twin, bitwise, and
    against the fp64 tiles on the weighted mean (the sum over the summed
    weights, the quantity the reference holds its fp32 tiles to) at rtol
    1e-4 / atol 1e-5 (tests/test_agg_pallas.py:536-546)."""
    from repro_torch.kernels import agg_reduce

    rng = np.random.default_rng(2025)
    worst = 0.0
    cases = 0
    for kind in ("int8", "float16", "bfloat16", "float32", "float64"):
        for c in (1, 3, 16):
            for n in (6922, 1_000_003):
                for with_acc in (False, True):
                    data, w, kw = _inputs(rng, kind, c, n, dev, with_acc)
                    got = agg_reduce.weighted_sum(data, w,
                                                  tile_dtype="float32", **kw)
                    want = agg_reduce.weighted_sum_plain(
                        data, w, tile_dtype="float32", **kw)
                    f64 = agg_reduce.weighted_sum(data, w, **kw)
                    torch.cuda.synchronize()
                    tag = f"{kind} C={c} N={n} acc={with_acc}"
                    check(torch.equal(got.view(torch.int64),
                                      want.view(torch.int64)),
                          f"weighted_sum fp32 tiles != twin: {tag}")
                    wsum = float(w.sum())
                    check(torch.allclose(got / wsum, f64 / wsum, rtol=1e-4,
                                         atol=1e-5),
                          f"weighted_sum fp32 tiles vs fp64: {tag}")
                    worst = max(worst, float(((got - f64) / wsum).abs()
                                             .max()))
                    cases += 1
    emit("wsum_f32_vs_twin", cases=cases, bitwise=True,
         max_abs_diff_vs_f64_mean=worst, rtol=1e-4, atol=1e-5)
    return 0.0


def _scatter_case(dev, gen, *, q8, slice_dest, nnz, pos0, voff=0, ioff=0,
                  d0=12_345, qchunk=1024, host_index=False, m=4_000_037):
    """One ``scatter_wsum`` call against its twin, bitwise, and its launch
    count: ``vals`` a view at element ``voff`` of a longer tensor, the
    index a view at ``ioff`` of a longer sorted unique one (copied to the
    host first with ``host_index``), or the slice ``acc[d0:d0 + nnz]``."""
    from repro_torch.kernels import agg_reduce

    acc = torch.randn(m, dtype=torch.float64, device=dev, generator=gen)
    scales = None
    if q8:
        vals = torch.randint(-127, 128, (voff + nnz,), dtype=torch.int8,
                             device=dev, generator=gen)[voff:]
        scales = 1e-4 + 1e-2 * torch.rand(
            -(-(pos0 + nnz) // qchunk) + 1, device=dev, generator=gen)
    else:
        vals = torch.randn(voff + nnz, device=dev, generator=gen)[voff:]
    if slice_dest:
        dest = d0
    else:
        dest = torch.sort(torch.randperm(
            m, device=dev, generator=gen)[:ioff + nnz]).values[ioff:]
        if host_index:
            dest = dest.cpu()
    p0 = pos0 if q8 else 0
    got, want = acc.clone(), acc.clone()
    before = agg_reduce.LAUNCHES["scatter_wsum"]
    agg_reduce.scatter_wsum(got, dest, vals, 2.5, scales=scales,
                            qchunk=qchunk, pos0=p0)
    agg_reduce.scatter_wsum_plain(
        want, dest if slice_dest else dest.to(dev), vals, 2.5,
        scales=scales, qchunk=qchunk, pos0=p0)
    torch.cuda.synchronize()
    tag = (f"q8={q8} slice={slice_dest} nnz={nnz} pos0={p0} voff={voff} "
           f"ioff={ioff} d0={d0} qchunk={qchunk} host={host_index}")
    check(agg_reduce.LAUNCHES["scatter_wsum"] == before + (nnz > 0),
          f"scatter_wsum launches: {tag}")
    check(torch.equal(got.view(torch.int64), want.view(torch.int64)),
          f"scatter_wsum != twin: {tag}")


def _scatter_sharded_fold(dev):
    """The sharded 0xF5 fold on the card (shard ranges at lo > 0) against
    the numpy engine, bitwise: q8 COO and fp32 ranges deltas from 3
    clients into 3 and 8 shards; returns the launches."""
    from repro_torch.fl.agg_kernels import StreamingWeightedSum
    from repro_torch.fl.flat import (FlatParams, SparseDelta, layout_of,
                                     quantize_int8)
    from repro_torch.kernels import agg_reduce

    rng = np.random.default_rng(21)
    arrays = [rng.normal(0, 0.5, (700_001,)).astype(np.float32),
              rng.normal(0, 0.5, (1_300_003,)).astype(np.float32)]
    layout = layout_of(arrays)
    n = layout.total_size
    base = FlatParams.from_arrays(arrays, layout)
    deltas = []
    for c in range(3):
        idx = np.sort(rng.choice(n, n // 20, replace=False)).astype(np.int64)
        q, sc = quantize_int8(rng.normal(0, 1e-3, idx.size)
                              .astype(np.float32))
        deltas.append(SparseDelta(layout, "coo", idx, q, sc, base=base))
        starts = np.arange(1000 + 37 * c, n - 5000, 99_991)
        r = np.stack([starts, starts + 3001], 1).astype(np.int64)
        deltas.append(SparseDelta(layout, "ranges", r.ravel(),
                                  rng.normal(0, 1e-3, 3001 * len(starts))
                                  .astype(np.float32), base=base))
    launches = 0
    for shards in (3, 8):
        outs = []
        for backend in ("torch", "numpy"):
            # the numpy engine without its decode pipeline, which (here as
            # in the reference) hangs on a second sparse arrival
            acc = StreamingWeightedSum(
                layout, backend=backend, shards=shards, overlap=False,
                device=dev if backend == "torch" else None)
            before = agg_reduce.LAUNCHES["scatter_wsum"]
            for i, d in enumerate(deltas):
                acc.add(d, 10.0 + i)
            launches += agg_reduce.LAUNCHES["scatter_wsum"] - before
            outs.append(acc.finalize())
        check(outs[0].buf.tobytes() == outs[1].buf.tobytes(),
              f"sharded sparse fold ({shards} shards) != numpy engine")
    return launches


def phase_scatter_vs_twin(dev):
    """``scatter_wsum`` against its twin, bitwise: int8 and fp32 values,
    a slice and unique indices (on the host, checked on the card after the
    copy; or already on the card), ``pos0`` 0 and 1000 (the windows
    straddle a qchunk edge), nnz 0 / 1 / 777 / 10**6; then the kernel's
    edges: nnz 2, 31 / 33 (a warp's chunk of 32 +- 1), 63 / 65 (a slice's
    chunk of 64), 15 / 17 and 511 / 513 (16 positions a lane, and a warp's
    chunk at 16, the A/B tool's variant) and 100,003, values and indices at
    odd offsets (the staging's scalar head and tail), a slice at odd and
    even starts (acc's double2 pairs, and its scalar head), spans that
    cross qchunk edges (pos0 1020 / 1023, and qchunk 3 / 10 / 1000:
    several edges in a chunk); and the sharded fold, whose shard spans lie
    at lo > 0, against the numpy engine."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1506)
    cases = 0
    for q8 in (True, False):
        for slice_dest in (True, False):
            for nnz in (0, 1, 777, 1_000_000):
                for pos0 in (0, 1000):
                    _scatter_case(dev, gen, q8=q8, slice_dest=slice_dest,
                                  nnz=nnz, pos0=pos0,
                                  host_index=pos0 == 0)
                    cases += 1
            for nnz in (2, 15, 17, 31, 33, 63, 65, 511, 513, 100_003):
                _scatter_case(dev, gen, q8=q8, slice_dest=slice_dest,
                              nnz=nnz, pos0=1000)
                cases += 1
        for voff in (1, 3, 13):
            for ioff in (1, 2, 3):
                _scatter_case(dev, gen, q8=q8, slice_dest=False,
                              nnz=100_003, pos0=voff, voff=voff, ioff=ioff,
                              host_index=ioff == 2)
                cases += 1
            for d0 in (12_345, 12_346):
                _scatter_case(dev, gen, q8=q8, slice_dest=True, nnz=100_003,
                              pos0=voff, voff=voff, d0=d0)
                cases += 1
    for slice_dest in (True, False):
        for pos0, nnz, qchunk in ((1020, 40, 1024), (1023, 40, 1024),
                                  (7, 5000, 3), (7, 5000, 10),
                                  (7, 5000, 1000)):
            _scatter_case(dev, gen, q8=True, slice_dest=slice_dest, nnz=nnz,
                          pos0=pos0, voff=pos0 % 16, qchunk=qchunk)
            cases += 1
    fold_launches = _scatter_sharded_fold(dev)
    emit("scatter_vs_twin", cases=cases, max_abs_diff=0.0, bitwise=True,
         sharded_fold_launches=fold_launches, sharded_fold_bitwise=True)
    return 0.0


# ---------------------------------------------------------------------------
# phase 11: the sharded fold at the benchmark's geometry (50M x 16)
# ---------------------------------------------------------------------------
#: benchmarks/run.py::_shard_agg_case: 50M parameters as one leaf, q8 deltas
#: against a q8 downlink, 16 clients reusing one payload, weights 10 + i,
#: seed 23, 8 shards
SHARD_PARAMS, SHARD_COUNT = 50_000_000, 8


def wsum_arrival_bound(n: int, nscales: int, shards: int):
    """(ms, bound_by) for one arrival of an int8 payload folded into the
    shards' fp64 accumulators: the payload and its scales read once, each
    shard's fp64 weight, the accumulator read and the result written
    (fp32 and fp64 tiles move the same bytes), against HBM; or a multiply
    and an add an element against the fp64 rate."""
    nbytes = n + nscales * 4 + shards * 8 + 2 * n * 8
    return _bound(nbytes, 2 * n)


def phase_shard_fold(dev, card: str):
    """Slice 5's sharded path: ``StreamingWeightedSum(shards=8)`` on the
    torch backend at the benchmark's geometry, every arrival folded per
    shard through ``weighted_sum`` with the base deferred, finalize on the
    card.  Gates: 8 shards == 1 shard == the numpy engine's sharded fold,
    bitwise; each shard's accumulator within (1/8 + 10%) of the
    single-host one.  Then the same with fp32 tiles (within rtol 1e-4 /
    atol 1e-5 of fp64), and one arrival's eight shard launches by CUDA
    events in both tile types beside its bound and the twin."""
    from repro_torch.fl import agg_kernels as K
    from repro_torch.fl.flat import QuantParams, layout_for, quantize_int8
    from repro_torch.kernels import agg_reduce as A

    n = SHARD_PARAMS
    layout = layout_for([("float32", (n,))])
    rng = np.random.default_rng(23)
    t0 = time.perf_counter()
    bq, bs = quantize_int8(rng.random(n, np.float32))
    base = QuantParams(layout, "q8", bq, bs)            # the q8 downlink
    dq, ds = quantize_int8(
        rng.standard_normal(n, dtype=np.float32) * 1e-3)
    payload = QuantParams(layout, "q8", dq, ds, is_delta=True, base=base)
    data_s = time.perf_counter() - t0
    weights = [10.0 + i for i in range(CLIENTS)]

    split = {}

    def fold(backend, **kw):
        s = K.StreamingWeightedSum(
            layout, backend=backend, device=dev if backend == "torch"
            else None, **kw)
        split["arrivals_ms"], _ = sync_ms(
            lambda: [s.add(payload, w) for w in weights])
        split["finalize_ms"], out = sync_ms(s.finalize)
        return s, out

    A.LAUNCHES["weighted_sum"] = 0
    cold_ms, _ = sync_ms(lambda: fold("torch", shards=SHARD_COUNT))
    launches = A.LAUNCHES["weighted_sum"]
    check(launches == (CLIENTS + 1) * SHARD_COUNT,
          f"shard fold: {launches} weighted_sum launches, want "
          f"{(CLIENTS + 1) * SHARD_COUNT}")
    fold_ms, (s8, out8) = sync_ms(lambda: fold("torch", shards=SHARD_COUNT))
    fold_split = dict(split)
    _, (_, out1) = sync_ms(lambda: fold("torch", shards=1))
    check(out8.buf.tobytes() == out1.buf.tobytes(),
          "shard fold: 8 shards != 1 shard")
    t0 = time.perf_counter()
    _, outn = fold("numpy", shards=SHARD_COUNT)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    check(out8.buf.tobytes() == outn.buf.tobytes(),
          "shard fold: torch != numpy engine")
    mem_ok = s8.per_shard_acc_bytes() <= n * 8 * (1 / SHARD_COUNT + 0.10)
    check(mem_ok, f"shard fold: {s8.per_shard_acc_bytes()} B per shard")
    v8 = out8.math_view()
    check(bool(np.isfinite(v8).all()), "shard fold: non-finite output")
    A.LAUNCHES["weighted_sum"] = 0
    f32_ms, (_, out32) = sync_ms(lambda: fold(
        "torch", shards=SHARD_COUNT, tile_dtype="float32"))
    f32_launches = A.LAUNCHES["weighted_sum"]
    check(f32_launches == launches,
          f"shard fold fp32 tiles: {f32_launches} launches")
    v32 = out32.math_view()
    f32_err = float(np.abs(v32.astype(np.float64) - v8).max())
    check(np.allclose(v32, v8, rtol=1e-4, atol=1e-5),
          f"shard fold fp32 tiles vs fp64: max |d| = {f32_err}")
    # one arrival's eight shard launches on the card, both tile types
    live = [(lo, hi) for lo, hi in s8._bounds if hi > lo]
    stacks = [K._device_stack([K._tile(payload, lo, hi)], dev, {})
              for lo, hi in live]
    accs = [torch.zeros(hi - lo, dtype=torch.float64, device=dev)
            for lo, hi in live]
    w = torch.tensor([weights[-1]], dtype=torch.float64, device=dev)

    def arrival(tile, fn=A.weighted_sum):
        return [fn(st["data"], w, scales=st["scales"], qchunk=st["qchunk"],
                   acc=a, tile_dtype=tile) for st, a in zip(stacks, accs)]

    for tile in ("float32", "float64"):
        got = arrival(tile)
        want = arrival(tile, A.weighted_sum_plain)
        check(all(torch.equal(g.view(torch.int64), t.view(torch.int64))
                  for g, t in zip(got, want)),
              f"shard arrival {tile} tiles: kernel != twin")
        del got, want
    f64_arrival_ms = event_ms(lambda: arrival("float64"), reps=10)
    f32_arrival_ms = event_ms(lambda: arrival("float32"), reps=10)
    plain_ms = event_ms(lambda: arrival("float32", A.weighted_sum_plain),
                        reps=2)
    bound_ms, bound_by = wsum_arrival_bound(n, -(-n // 1024), len(live))
    emit("shard_fold_50Mx16", card=card, params=n, clients=CLIENTS,
         shards=SHARD_COUNT, launches=launches, fold_ms=fold_ms,
         fold_split_ms=fold_split, fold_cold_ms=cold_ms, numpy_ms=numpy_ms, data_gen_s=data_s,
         match=True, numpy_match=True, shard_mem_ok=mem_ok,
         per_shard_acc_bytes=s8.per_shard_acc_bytes(),
         f32_tiles={"fold_ms": f32_ms, "launches": f32_launches,
                    "max_abs_diff_vs_f64": f32_err, "rtol": 1e-4,
                    "atol": 1e-5},
         arrival={"f64_tiles_ms": f64_arrival_ms,
                  "f32_tiles_ms": f32_arrival_ms,
                  "f32_plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "launches_per_arrival": len(live)})
    del stacks, accs, s8
    torch.cuda.empty_cache()
    return dict(ms=f32_arrival_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, launches=f32_launches,
                max_abs_diff=0.0, max_abs_diff_vs_f64=f32_err,
                f64_tiles_ms=f64_arrival_ms,
                shape=f"one arrival of {n} int8 delta params as "
                      f"{len(live)} shard launches into fp64 accumulators")


# ---------------------------------------------------------------------------
# phase 12: the sparse fold at the benchmark's geometry (100M x 8)
# ---------------------------------------------------------------------------
#: benchmarks/run.py::_sparse_delta_case: 100M parameters as 400 leaves of
#: 250,000, 8 clients reusing one result, weights 10 + i, seed 13
SPARSE_PARAMS, SPARSE_CLIENTS = 100_000_000, 8
#: (index mode, fraction of coordinates that travel); ranges mode keeps the
#: first fraction of every leaf, an adapter's layout
SPARSE_RUNS = (("coo", 1e-3), ("coo", 1e-2), ("ranges", 1e-3))


def scatter_bound(nnz: int, slice_dest: bool, q8: bool, nscales: int):
    """(ms, bound_by) for one ``scatter_wsum`` launch: each value (1 B int8
    or 4 B fp32), its index (8 B, none for a slice) and its scales read
    once, and the fp64 accumulator read and written at its destination
    (16 B), against HBM; or a multiply and an add a coordinate against the
    fp64 rate."""
    nbytes = nnz * ((1 if q8 else 4) + (0 if slice_dest else 8) + 16) \
        + nscales * 4
    return _bound(nbytes, 2 * nnz)


def phase_sparse_fold(dev, card: str):
    """Slice 5's sparse path: FedAvg on the torch backend folds eight 0xF5
    deltas (the TopK COO mode at 1e-3 and 1e-2, and the adapter ranges
    mode) through ``scatter_wsum`` into the card's accumulator, finalize on
    the card.  Gates: bitwise the numpy engine; within the int8 bound
    (``match_tol``) of the dense fp32 fold of the masked update.  Then the
    kernel per launch at the COO 1e-3 span, by CUDA events, beside its
    bound, its twin and ``index_add_`` (the scatter part alone)."""
    from repro_torch.fl.flat import FlatParams, topk_indices
    from repro_torch.fl.messages import (FitRes, decode_fit_res,
                                         encode_fit_res)
    from repro_torch.fl.strategy import make_strategy
    from repro_torch.kernels import agg_reduce as A

    nleaves = SPARSE_PARAMS // LEAF
    rng = np.random.default_rng(13)
    t0 = time.perf_counter()
    model = [rng.normal(0, 0.5, (LEAF,)).astype(np.float32)
             for _ in range(nleaves)]
    result = [m + rng.normal(0, 1e-3, (LEAF,)).astype(np.float32)
              for m in model]
    base = FlatParams.from_arrays(model)
    data_s = time.perf_counter() - t0
    weights = [10 + i for i in range(SPARSE_CLIENTS)]

    split = {}

    def fold(frame, backend, dense=False):
        st = make_strategy("fedavg", backend=backend,
                           device=dev if backend == "torch" else None)
        acc = st.fit_accumulator(1, model)
        t0 = time.perf_counter()
        for c in range(SPARSE_CLIENTS):
            r = decode_fit_res(frame)
            r.num_examples = weights[c]
            if not dense:
                r.sparse.base = base
            acc.add(f"site-{c:02d}", r)
        split["arrivals_ms"] = (time.perf_counter() - t0) * 1e3
        # the sparse deltas fold in finalize, in canonical node order
        split["finalize_ms"], out = sync_ms(lambda: acc.finalize([])[0])
        return out

    rows, timing = {}, None
    for mode, frac in SPARSE_RUNS:
        if mode == "coo":
            mag = np.abs(np.concatenate(result) - np.concatenate(model))
            idx = topk_indices(mag, max(1, int(np.ceil(frac * base.layout
                                                       .total_size))))
            del mag
            keep = np.zeros(base.layout.total_size, bool)
            keep[idx] = True
            masked = [np.where(keep[i * LEAF:(i + 1) * LEAF], r, m)
                      for i, (m, r) in enumerate(zip(model, result))]
            ranges = None
            del keep, idx
        else:
            per = int(frac * LEAF)
            ranges = [(i * LEAF, i * LEAF + per) for i in range(nleaves)]
            masked = [np.concatenate((r[:per], m[per:]))
                      for m, r in zip(model, result)]
        frame = encode_fit_res(FitRes(result, 0, {}), codec="sparse",
                               base=base, sparse_frac=frac,
                               sparse_ranges=ranges)
        sp = decode_fit_res(frame).sparse
        A.LAUNCHES["scatter_wsum"] = 0
        cold_ms, _ = sync_ms(lambda: fold(frame, "torch"))
        launches = A.LAUNCHES["scatter_wsum"]
        check(launches > 0, f"sparse {mode} {frac}: no scatter_wsum launch")
        fold_ms, got = sync_ms(lambda: fold(frame, "torch"))
        fold_split = dict(split)
        t0 = time.perf_counter()
        want = fold(frame, "numpy")
        numpy_ms = (time.perf_counter() - t0) * 1e3
        check(all(a.tobytes() == b.tobytes() for a, b in zip(got, want)),
              f"sparse {mode} {frac}: torch fold != numpy engine")
        dense = encode_fit_res(FitRes(masked, 0, {}), codec="flat")
        dense_ms, out32 = sync_ms(lambda: fold(dense, "torch", dense=True))
        del dense, masked
        tol = 0.5 * float(sp.scales.max()) * (1 + 1e-5) + 1e-6
        err = max(float(np.abs(a.astype(np.float64)
                               - b.astype(np.float64)).max())
                  for a, b in zip(out32, got))
        check(err <= tol, f"sparse {mode} {frac}: |sparse - dense| = {err} "
                          f"> {tol}")
        rows[f"{mode}_{frac}"] = {
            "nnz": sp.nnz, "launches": launches, "fold_ms": fold_ms,
            "fold_split_ms": fold_split, "fold_cold_ms": cold_ms, "numpy_ms": numpy_ms,
            "dense_fold_ms": dense_ms, "max_err": err, "tol": tol,
            "match_tol": True, "numpy_match": True,
            "wire_mb": len(frame) / 1e6}
        if timing is None:
            timing = _scatter_timing(dev, sp)
            timing["launches"] = launches
        del frame, sp, got, want, out32
    emit("sparse_fold_100Mx8", card=card, params=SPARSE_PARAMS,
         clients=SPARSE_CLIENTS, data_gen_s=data_s, runs=rows,
         kernel=timing)
    torch.cuda.empty_cache()
    return timing


def _scatter_timing(dev, sp):
    """One launch at the main path's span (a whole COO delta on one
    accumulator), by CUDA events:

    - ``ms``: the kernel through its C entry point (no checks or copies),
      and ``floor_ms``: ``repro_scatter_floor``, the same read-modify-write
      of ``acc[idx[i]]`` at the same indices with a constant addend and no
      values, scales or scale index (in turns: kernel, floor, floor,
      kernel; each the mean of its two readings);
    - ``fold_call_ms``: the wrapper as the fold calls it, the index already
      on the card (checked there: one min/max and one sync);
    - ``wrapper_ms``: the wrapper with the index on the host, and its split
      ``wrapper_split_ms``: ``copy_ms`` (the pageable copy of the index to
      the card), ``check_ms`` (the min/max and its sync), and beside them
      ``stage_ms``, the fold's once-per-arrival staging of the frame's
      values, scales and index through its page-locked buffer;
    - the twin, and ``index_add_`` of the precomputed contributions (the
      scatter part alone)."""
    from repro_torch.kernels import agg_reduce as A

    n = sp.layout.total_size
    acc = torch.zeros(n, dtype=torch.float64, device=dev)
    arrays = (sp.values, sp.scales, sp.indices)
    stage = A.PinnedStage()
    vals, scales, idx = stage.to_device(arrays, dev)
    host_idx = A._host_tensor(sp.indices)
    w = 13.0
    want = acc.clone()
    A.scatter_wsum_plain(want, idx, vals, w, scales=scales)
    got = acc.clone()
    A.scatter_wsum(got, host_idx, vals, w, scales=scales)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int64), want.view(torch.int64)),
          "scatter_wsum at the main path's span (host index) != twin")
    got.copy_(acc)
    A.scatter_wsum(got, idx, vals, w, scales=scales)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int64), want.view(torch.int64)),
          "scatter_wsum at the main path's span (staged index) != twin")
    lib = A._kernel_lib("scatter_wsum")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def kernel():
        err = lib.repro_scatter_wsum(
            got.data_ptr(), idx.data_ptr(), 0, vals.data_ptr(), 1,
            scales.data_ptr(), sp.qchunk, 0, w, sp.nnz, stream)
        check(err == 0, f"scatter_wsum launch: CUDA error {err}")

    def floor():
        err = lib.repro_scatter_floor(got.data_ptr(), idx.data_ptr(), 1.0,
                                      sp.nnz, stream)
        check(err == 0, f"scatter_floor launch: CUDA error {err}")

    turns = {"kernel": [], "floor": []}
    for name in ("kernel", "floor", "floor", "kernel"):
        turns[name].append(event_ms(kernel if name == "kernel" else floor,
                                    reps=50))
    ms, floor_ms = (sum(turns[k]) / 2 for k in ("kernel", "floor"))
    fold_call_ms = event_ms(lambda: A.scatter_wsum(got, idx, vals, w,
                                                   scales=scales), reps=20)
    wrapper_ms = event_ms(lambda: A.scatter_wsum(got, host_idx, vals, w,
                                                 scales=scales), reps=20)
    split = dict(
        copy_ms=event_ms(lambda: host_idx.to(dev), reps=10),
        check_ms=event_ms(lambda: torch.stack(torch.aminmax(idx)).tolist(),
                          reps=20),
        stage_ms=event_ms(lambda: stage.to_device(arrays, dev), reps=10))
    plain_ms = event_ms(lambda: A.scatter_wsum_plain(
        got, idx, vals, w, scales=scales), reps=5)
    contrib = (vals.float() * scales[torch.arange(
        sp.nnz, device=dev) // sp.qchunk]).double() * w
    torch.use_deterministic_algorithms(False)
    try:
        library_ms = event_ms(lambda: got.index_add_(0, idx, contrib),
                              reps=50)
    finally:
        torch.use_deterministic_algorithms(True)
    bound_ms, bound_by = scatter_bound(sp.nnz, False, True, sp.scales.size)
    del acc, got, want, contrib, vals, scales, idx, stage
    return dict(ms=ms, floor_ms=floor_ms, turns_ms=turns,
                share_of_floor=floor_ms / ms, plain_ms=plain_ms,
                fold_call_ms=fold_call_ms, wrapper_ms=wrapper_ms,
                wrapper_split_ms=split, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_diff=0.0,
                library_note="index_add_ of precomputed fp64 contributions: "
                             "the scatter part alone",
                shape=f"{sp.nnz} int8 values at unique indices into {n} "
                      f"fp64")


# ---------------------------------------------------------------------------
# phase 13: SecAgg on the quickstart, and the secagg_mask kernel's times
# ---------------------------------------------------------------------------
def _pair_seed(a: str, b: str) -> int:
    import zlib

    lo, hi = sorted([a, b])
    return zlib.crc32(f"{lo}|{hi}".encode())


def phase_secagg_slice():
    """The 3-site quickstart with ``SecAggMod`` on every client and
    ``SecAggFedAvg`` on the torch backend (the mod-2^64 sum on the card),
    clients fitting on the card: native == FLARE bitwise, final parameters
    within 1e-3 of plain FedAvg; then one FedAvg round with ``[DPMod,
    TopKCompressionMod]`` composed on every client."""
    from repro_torch.fl import (DPMod, FedAvg, SecAggFedAvg, SecAggMod,
                                TopKCompressionMod)
    from repro_torch.kernels import agg_reduce

    def secagg(site):
        return [SecAggMod(site=site, peers=SITES,
                          pairwise_seed_fn=_pair_seed)]

    t0 = time.perf_counter()
    native = _history(None, "torch", flare=False, strategy=SecAggFedAvg(),
                      mods=secagg)
    flare = _history(None, "torch", flare=True, strategy=SecAggFedAvg(),
                     mods=secagg)
    secagg_s = time.perf_counter() - t0
    check(_same(native, flare), "secagg: native != FLARE")
    plain = _history(None, "torch", flare=False)
    delta = max(float(np.abs(a.astype(np.float64) - b.astype(np.float64))
                      .max()) for a, b in zip(native.final_parameters,
                                              plain.final_parameters))
    check(delta < 1e-3, f"secagg vs plain FedAvg: max |d| = {delta}")
    losses = [l for _, l in native.losses()]
    check(len(losses) == 3 and all(np.isfinite(losses)),
          f"secagg: losses {losses}")
    check([r.metrics.get("secagg") for r in native.rounds] == [1, 1, 1],
          "secagg: rounds did not aggregate masked shares")
    agg_reduce.LAUNCHES["weighted_sum"] = 0
    composed = _history(
        None, "torch", flare=False, rounds=1,
        mods=lambda s: [DPMod(clip_norm=5.0, noise_multiplier=0.01,
                              site_id=SITES.index(s), seed=3),
                        TopKCompressionMod(fraction=0.5)])
    launches = agg_reduce.LAUNCHES["weighted_sum"]
    check(launches > 0, "the DP + TopK round launched no weighted_sum")
    check(all(np.isfinite(p).all() for p in composed.final_parameters),
          "DP + TopK: non-finite parameters")
    metrics = composed.rounds[0].metrics
    emit("secagg_slice", sites=len(SITES), losses=losses,
         native_and_flare_s=secagg_s, max_abs_diff_vs_fedavg=delta,
         composed={"mods": ["DPMod", "TopKCompressionMod"],
                   "loss": composed.losses()[-1][1],
                   "weighted_sum_launches": launches,
                   "num_clients": metrics.get("num_clients")})


def secagg_bound(n: int, p: int):
    """(ms, bound_by): x and the P masks read once and the int32 share
    written once, against HBM; or its ops (two fp32 multiplies, the round,
    P adds) against the fp32 rate."""
    return _bound((8 + 4 * p) * n, (3 + p) * n, FP32_FLOPS)


def phase_secagg_timing(dev, card: str):
    """``secagg_mask`` through its public entry point
    (``repro_torch.kernels.ops.secagg_mask``, the path of the JAX package's
    kernel) at the benchmark's shape (N 2**16, P 3, weight 3;
    benchmarks/run.py:259-263), with its launches counted; then the kernel
    by CUDA events beside its twin and its bound there and at N 50M, P 15
    (one client of a 16-client round).  No PyTorch call computes it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import secagg_mask as SM

    gen = torch.Generator(device=dev)
    gen.manual_seed(1507)
    x = torch.randn(1 << 16, device=dev, generator=gen)
    masks = _int32_masks(gen, 3, 1 << 16, dev)
    SM.LAUNCHES["secagg_mask"] = 0
    out = ops.secagg_mask(x, masks, 3.0)
    torch.cuda.synchronize()
    launches = SM.LAUNCHES["secagg_mask"]
    check(launches == 1, f"ops.secagg_mask launched {launches} kernels")
    check(torch.equal(out, SM.secagg_mask_plain(x, masks, 3.0)),
          "ops.secagg_mask != twin")
    rows = {}
    for n, p in ((1 << 16, 3), SECAGG_BIG):
        x = torch.randn(n, device=dev, generator=gen)
        masks = torch.empty((p, n), dtype=torch.int32, device=dev)
        for i in range(p):
            masks[i] = _int32_masks(gen, 1, n, dev)[0]
        got = SM.secagg_mask(x, masks, 3.0)
        check(torch.equal(got, SM.secagg_mask_plain(x, masks, 3.0)),
              f"secagg_mask != twin at N={n} P={p}")
        del got
        bound_ms, bound_by = secagg_bound(n, p)
        rows[f"{n}x{p}"] = dict(
            ms=event_ms(lambda: SM.secagg_mask(x, masks, 3.0), reps=20),
            plain_ms=event_ms(lambda: SM.secagg_mask_plain(x, masks, 3.0),
                              reps=2),
            bound_ms=bound_ms, bound_by=bound_by)
        del x, masks
    torch.cuda.empty_cache()
    emit("secagg_timing", card=card, launches=launches, shapes=rows)
    head = rows[f"{1 << 16}x3"]
    return dict(head, launches=launches, library_ms=None, max_abs_diff=0.0,
                at_50M_P15=rows["{}x{}".format(*SECAGG_BIG)],
                shape="N 65536, P 3 (the benchmark's), weight 3")


# ---------------------------------------------------------------------------
# phase 13b: the paper's four examples on the card (slice 14)
# ---------------------------------------------------------------------------
EXAMPLES = ("quickstart", "secure_federation", "hybrid_tracking",
            "multi_job")


def _run_example(name: str, dev):
    """``main([], device=dev)`` of ``repro_torch.examples.<name>``;
    hybrid_tracking runs in a temporary working directory (it exports
    ``metrics_fig6.json`` there), removed afterwards."""
    import importlib
    import shutil
    import tempfile

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    if name != "hybrid_tracking":
        return mod, mod.main([], device=dev)
    cwd, tmp = os.getcwd(), tempfile.mkdtemp(prefix="fig6_")
    os.chdir(tmp)
    try:
        return mod, mod.main([], device=dev)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp)


def phase_examples(dev):
    """Each ported example's ``main()`` on the card, clients fitting and
    servers folding there: quickstart's Fig. 5 (native == FLARE bitwise,
    losses falling), secure_federation's SecAgg within the fixed-point
    quantization of plain FedAvg, hybrid_tracking's streamed tags and
    exported JSON, multi_job's two concurrent jobs COMPLETED.  Counts
    ``weighted_sum`` launches per example and times each on the host
    clock."""
    from repro_torch.kernels import agg_reduce

    report, launches = {}, {}
    for name in EXAMPLES:
        agg_reduce.LAUNCHES["weighted_sum"] = 0
        t0 = time.perf_counter()
        mod, res = _run_example(name, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[name] = agg_reduce.LAUNCHES["weighted_sum"]
        row = {"seconds": seconds, "weighted_sum_launches": launches[name]}
        if name == "quickstart":
            losses = [l for _, l in res["native"].losses()]
            check(res["bitwise"], "quickstart: native != FLARE (Fig. 5)")
            check(len(losses) == mod.ROUNDS and all(np.isfinite(losses))
                  and losses[-1] < losses[0], f"quickstart: losses {losses}")
            row.update(losses=losses, bitwise=True)
        elif name == "secure_federation":
            delta = res["max_param_delta"]
            check(delta < mod.SECAGG_TOL,
                  f"secure_federation: SecAgg vs plain FedAvg max |d| "
                  f"{delta}")
            check([r.metrics.get("secagg") for r in res["secagg"].rounds]
                  == [1] * mod.ROUNDS,
                  "secure_federation: rounds did not sum masked shares")
            row.update(max_param_delta=delta, **{
                f"{k}_losses": [l for _, l in res[k].losses()]
                for k in ("plain", "secagg", "dp")})
        elif name == "hybrid_tracking":
            want = [f"{s}/{t}" for s in mod.SITES for t in mod.CLIENT_TAGS]
            check(set(want) <= set(res["tags"]),
                  f"hybrid_tracking: streamed {res['tags']}")
            check(all(any(k.startswith(s + "/") for k in res["exported"])
                      for s in mod.SITES),
                  "hybrid_tracking: the export misses a site")
            check(all(len(res["series"][f"{s}/train_loss"]) == mod.ROUNDS
                      for s in mod.SITES),
                  "hybrid_tracking: one train_loss point per round")
            row.update(tags=len(res["tags"]),
                       losses=[l for _, l in res["history"].losses()])
        else:
            recs = res["records"]
            check([r.status.value for r in recs] == ["COMPLETED"] * 2,
                  f"multi_job: {[(r.status.value, r.error) for r in recs]}")
            row.update(status=[r.status.value for r in recs], losses={
                job: [l for _, l in r.result.losses()]
                for (job, _, _), r in zip(mod.JOBS, recs)})
        report[name] = row
    for name in EXAMPLES:
        check(launches[name] > 0, f"{name} launched no weighted_sum")
    emit("examples", examples=report, weighted_sum_launches=launches)
    return launches


def phase_legacy_baseline(dev, card: str):
    """The reference bench's ``agg_throughput_50M_16clients`` row on the
    port: the frozen per-layer numpy ``LegacyFedAvg`` over legacy-codec
    frames on the host against the port's FedAvg folding flat frames on
    the card (decode, ``weighted_sum``, finalize), at ``phase_fold``'s
    geometry, one payload reused for every client; the two models
    bitwise equal."""
    from repro_torch.fl.legacy import LegacyFedAvg
    from repro_torch.fl.messages import FitRes, decode_fit_res, encode_fit_res

    frame, current, _ = _frames("flat")
    legacy_frame = encode_fit_res(
        FitRes(list(decode_fit_res(frame).parameters), 0, {}),
        codec="legacy")

    def legacy():
        results = []
        for c in range(CLIENTS):
            r = decode_fit_res(legacy_frame)
            r.num_examples = 10 + c
            results.append((f"site-{c:02d}", r))
        return LegacyFedAvg().aggregate_fit(1, results, [], current)[0]

    fold = lambda: _fold(frame, current, None, backend="torch",  # noqa: E731
                         low_memory=False)
    sync_ms(fold)                       # the stack's first cudaMalloc
    fold_ms, got = sync_ms(fold)
    t0 = time.perf_counter()
    want = legacy()
    legacy_ms = (time.perf_counter() - t0) * 1e3
    match = len(got) == len(want) and all(
        a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for a, b in zip(got, want))
    check(match, "legacy baseline: the port's FedAvg != LegacyFedAvg")
    emit("legacy_baseline", card=card, params=LEAF * NLEAVES,
         clients=CLIENTS, legacy_ms=legacy_ms, fold_ms=fold_ms,
         speedup_vs_legacy=legacy_ms / fold_ms, match=match)
    del got, want, legacy_frame, frame
    gc_collect()


# ---------------------------------------------------------------------------
# phase 14: training on the card -- H2O-Danube-1.8B at full width (slice 9)
# ---------------------------------------------------------------------------
#: the main path's shape: the reference's train_4k sequence length
#: (config.py INPUT_SHAPES), cut to the 4 sequences one card holds, in 4
#: microbatches (the reference's memory lever); AdamW at lr 2e-5, reached
#: after a 4-step linear warmup (cosine over 100 steps), clipped at 1.0.
#: From random weights Adam's first updates move every weight by about lr
#: in the direction of a low-rank gradient's sign: the reference's default
#: 3e-4 with a 1-step warmup, and 1e-4 with a 4-step warmup, each sent the
#: loss from 8.6-9.8 up to 13.3-13.5 once the updates summed to about
#: 1.5e-4; here they sum to 5e-5 over the 4 steps.  Batches from
#: FederatedDataLoader(seed=0), weights from seed 0
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 4096, 4, 3
TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL = 2e-5, 4, 100
#: the card's fp32 step against the port's CPU step (full width, 2 layers,
#: 2 x 128 tokens in 2 microbatches, one step): loss within 1e-5 and grad
#: norm within 1e-4 relative, the Adam moments (the step's gradients)
#: within 1e-3 of each leaf's largest entry (fp32 sums in another order on
#: each device)
TRAIN_CPU = dict(layers=2, batch=2, seq=128, micro=2, steps=1)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_MOMENT_TOL = 1e-5, 1e-4, 1e-3
#: the ops whose kernels are matmuls, split by dtype by the kernel's name:
#: cuBLAS and CUTLASS spell the operand types into it (on the card, torch
#: 2.11: bf16 ``nvjet_tst_*``; fp32 ``sm80_xmma_gemm_f32f32_*`` and
#: ``cutlass_80_simt_sgemm_*``)
_GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
             "aten::addbmm")
_FP32_GEMM_NAMES = ("f32f32", "sgemm", "nvjet_s")
_BF16_GEMM_NAMES = ("bf16", "nvjet_t")


def _launch_counts():
    from repro_torch.kernels import agg_reduce, flash_attention, rglru_scan
    from repro_torch.kernels import secagg_mask

    return {f"{m.__name__.rsplit('.', 1)[-1]}.{k}": v
            for m in (agg_reduce, flash_attention, rglru_scan, secagg_mask)
            for k, v in m.LAUNCHES.items()}


def _train_tcfg(batch: int, seq: int, micro: int):
    from repro_torch.config import TrainConfig

    return TrainConfig(global_batch=batch, seq_len=seq, microbatches=micro,
                       optimizer="adamw", grad_clip=1.0,
                       learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_TOTAL, seed=0)


def train_model_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one step (no recompute): 6 x the matmul parameters
    (all but the embedding table) x tokens, plus 3 x the forward's
    attention products (QK^T and PV, 4 x hd flops per visible causal
    pair)."""
    from repro_torch.models import build_model

    n = build_model(cfg).param_count() - cfg.padded_vocab_size * cfg.d_model
    pairs = band_pairs(seq, True, cfg.window)
    attn = 4 * cfg.resolved_head_dim * cfg.num_heads * batch * pairs
    return 6.0 * n * batch * seq + 3.0 * attn * cfg.num_layers


def _profile_split(prof, update_span: str) -> dict:
    """Device ms of one profiled step by kind: bf16 matmuls, fp32 matmuls
    (the eager attention's score einsums and their gradients), the
    optimizer (the kernels under the step's update span) and the rest."""
    from torch.autograd import DeviceType

    split = {"bf16_matmul": 0.0, "fp32_attention_einsum": 0.0,
             "other_matmul": 0.0, "optimizer_update": 0.0, "rest": 0.0}
    total, names, ops, other = 0.0, {}, {}, set()
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        own = sum(k.duration for k in e.kernels) / 1e3
        total += own
        if own:
            ops[e.name] = ops.get(e.name, 0.0) + own
        for k in e.kernels:
            names[k.name] = names.get(k.name, 0.0) + k.duration / 1e3
        if e.name == update_span:
            split["optimizer_update"] += e.device_time_total / 1e3
        if e.name not in _GEMM_OPS:
            continue
        for k in e.kernels:
            n = k.name.lower()
            key = ("bf16_matmul" if any(t in n for t in _BF16_GEMM_NAMES) else
                   "fp32_attention_einsum"
                   if any(t in n for t in _FP32_GEMM_NAMES) else
                   "other_matmul")
            split[key] += k.duration / 1e3
            if key == "other_matmul":
                other.add(k.name[:90])
    split["rest"] = total - sum(v for k, v in split.items() if k != "rest")
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:15]
    return dict(split, device_ms=total,
                top_kernels=[[n[:160], ms] for n, ms in top],
                top_ops=[[n, ms] for n, ms in top_ops],
                other_matmul_kernels=sorted(other)[:8])


def _train_run(cfg, tcfg, params, dev, steps: int, batches):
    """``steps`` train steps from ``params`` on ``dev`` through
    ``get_train_step``; returns the state, the metrics and the host ms of
    each step (ending in a device sync)."""
    from repro_torch.optim import make_optimizer
    from repro_torch.train.steps import TrainState, get_train_step

    step_fn = get_train_step(cfg, tcfg, impl="eager", device=dev)
    state = TrainState(params, make_optimizer(tcfg).init(params),
                       torch.zeros((), dtype=torch.int32, device=dev))
    # the state alone holds the initial params: each step's old state is
    # freed as the new one is assigned, as in a training loop
    del params
    metrics, times = [], []
    for b in batches[:steps]:
        if dev.type == "cuda":
            ms, (state, m) = sync_ms(lambda: step_fn(state, b))
        else:
            t0 = time.perf_counter()
            state, m = step_fn(state, b)
            ms = (time.perf_counter() - t0) * 1e3
        metrics.append({k: float(v) for k, v in m.items()})
        times.append(ms)
    return state, metrics, times


def _moments_excess(a, b):
    """(max over leaves of |a - b| / (tol x the leaf's largest |b|), the
    leaf's path)."""
    from repro_torch.utils.pytree import tree_flatten_with_paths

    worst = (0.0, "")
    for (path, x), (_, y) in zip(tree_flatten_with_paths(a),
                                 tree_flatten_with_paths(b)):
        x, y = x.double().cpu(), y.double().cpu()
        scale = float(y.abs().max()) or 1.0
        worst = max(worst, (float((x - y).abs().max())
                            / (TRAIN_MOMENT_TOL * scale), path))
    return worst


def phase_train(dev, card: str):
    """Slice 9's main path: H2O-Danube-1.8B at full width and depth (24 x
    2560, ~1.83B parameters) trained by ``get_train_step(cfg, tcfg,
    impl="eager")`` for ``TRAIN_STEPS`` AdamW steps of 4 x 4096 tokens in 4
    microbatches, remat on; then the card's fp32 step against the port's
    CPU step at full width and 2 layers, remat on and off bitwise, and the
    launcher's save and resume on the card."""
    import contextlib
    import io
    import tempfile

    from repro_torch.config import get_model_config
    from repro_torch.data.loader import FederatedDataLoader
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.train.steps import UPDATE_SPAN, get_train_step
    from repro_torch.utils.pytree import tree_leaves, tree_map

    before = _launch_counts()
    t_phase = time.perf_counter()
    cfg = get_model_config("h2o-danube-1.8b")
    check(cfg.remat, "danube's config trains with remat")
    tcfg = _train_tcfg(TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO)
    loader = FederatedDataLoader(cfg.vocab_size, TRAIN_SEQ, 1, TRAIN_BATCH,
                                 seed=0)
    batches = [loader.next_batch(0) for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.reset_peak_memory_stats()
    n_params = build_model(cfg).param_count()
    state, metrics, times = _train_run(
        cfg, tcfg, build_model(cfg).init(0, device=dev), dev, TRAIN_STEPS,
        batches)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    gnorms = [m["grad_norm"] for m in metrics]
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"train: non-finite loss or grad norm {losses} {gnorms}")
    check(losses[-1] < losses[0], f"train: losses do not fall {losses}")
    check(int(state.step) == TRAIN_STEPS, f"train: step {int(state.step)}")
    check(all(float(m.abs().max()) > 0 for m in tree_leaves(state.opt_state)),
          "train: an Adam moment is all zero")
    # one more step under the profiler: the device time by kind
    step_fn = get_train_step(cfg, tcfg, impl="eager", device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[TRAIN_STEPS])
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    check(np.isfinite(float(m["loss"])), "train: profiled step's loss")
    split = _profile_split(prof, UPDATE_SPAN)
    profile_s = time.perf_counter() - t_prof
    del prof, state, m
    torch.cuda.empty_cache()
    step_ms = float(np.median(times[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tflops = flops / step_ms / 1e9

    # the card's fp32 step against the port's CPU step, full width, 2 layers
    t_cpu_vs_card = time.perf_counter()
    small = cfg.replace(num_layers=TRAIN_CPU["layers"], dtype="float32")
    stcfg = _train_tcfg(TRAIN_CPU["batch"], TRAIN_CPU["seq"],
                        TRAIN_CPU["micro"])
    sl = FederatedDataLoader(cfg.vocab_size, TRAIN_CPU["seq"], 1,
                             TRAIN_CPU["batch"], seed=0)
    sbatches = [sl.next_batch(0) for _ in range(TRAIN_CPU["steps"])]
    cpu = torch.device("cpu")
    p_card = build_model(small).init(0, device=dev)
    p_cpu = tree_map(lambda t: t.to(cpu), p_card)
    st_card, m_card, _ = _train_run(small, stcfg, p_card, dev,
                                    TRAIN_CPU["steps"], sbatches)
    st_cpu, m_cpu, t_cpu = _train_run(small, stcfg, p_cpu, cpu,
                                      TRAIN_CPU["steps"], sbatches)
    del p_card, p_cpu
    loss_rel = max(abs(a["loss"] / b["loss"] - 1)
                   for a, b in zip(m_card, m_cpu))
    gnorm_rel = max(abs(a["grad_norm"] / b["grad_norm"] - 1)
                    for a, b in zip(m_card, m_cpu))
    mom, mom_leaf = _moments_excess(st_card.opt_state, st_cpu.opt_state)
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"train: card vs CPU loss rel diff {loss_rel}")
    check(gnorm_rel <= TRAIN_GNORM_RTOL,
          f"train: card vs CPU grad norm rel diff {gnorm_rel}")
    check(mom <= 1.0, f"train: card vs CPU moments excess {mom}")
    param_diff = max(float((a.cpu() - b).abs().max()) for a, b in
                     zip(tree_leaves(st_card.params),
                         tree_leaves(st_cpu.params)))
    del st_cpu, st_card

    # remat on and off, bitwise, at the main path's shape with 2 layers
    t_remat = time.perf_counter()
    two = cfg.replace(num_layers=TRAIN_CPU["layers"])
    outs = [_train_run(two.replace(remat=r), tcfg,
                       build_model(two).init(0, device=dev), dev, 1, batches)
            for r in (True, False)]
    (sa, ma, _), (sb, mb, _) = outs
    remat_bitwise = ma == mb and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(sa), tree_leaves(sb)))
    check(remat_bitwise, f"train: remat on != off {ma} {mb}")
    del outs, sa, sb
    torch.cuda.empty_cache()

    # the launcher: train, save, resume on the card
    t_launcher = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        common = ["--smoke", "--batch", "2", "--seq", "64", "--ckpt-dir", d,
                  "--log-every", "2"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            launch_train.main(common + ["--steps", "4", "--ckpt-every", "2"])
            launch_train.main(common + ["--steps", "6"])
        log = out.getvalue()
        saved = sorted(os.listdir(d))
    done = float(log.strip().splitlines()[-1].split()[-1])
    check("resumed from step 4" in log and np.isfinite(done)
          and "ckpt_00000006.npz" in saved,
          f"train: launcher did not save and resume: {log!r} {saved}")

    after = _launch_counts()
    check(after == before, f"train: a kernel launched during training "
                           f"{before} -> {after}")
    emit("train", card=card, arch=cfg.name, params=n_params,
         layers=cfg.num_layers, d_model=cfg.d_model, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, microbatches=TRAIN_MICRO, optimizer="adamw",
         lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, remat=cfg.remat,
         losses=losses, grad_norms=gnorms,
         step_ms=times, step_ms_median=step_ms,
         tokens_per_s=tokens / step_ms * 1e3, model_tflop=flops / 1e12,
         model_tflops=tflops, bf16_peak_share=tflops * 1e12
         / BF16_TENSOR_FLOPS, peak_mem_gb=peak / 1e9,
         profiled_step_ms=profiled_ms, profile_ms=split,
         # the profiled step's device time over an unprofiled step's wall
         # time: the profiler's own host work slows the profiled step
         device_busy_share=split["device_ms"] / step_ms,
         cpu_vs_card=dict(layers=TRAIN_CPU["layers"], dtype="float32",
                          loss_max_rel_diff=loss_rel, loss_rtol=TRAIN_LOSS_RTOL,
                          grad_norm_max_rel_diff=gnorm_rel,
                          grad_norm_rtol=TRAIN_GNORM_RTOL,
                          moments_excess=mom, moments_worst_leaf=mom_leaf,
                          moment_tol=TRAIN_MOMENT_TOL,
                          params_max_abs_diff=param_diff,
                          cpu_step_ms=t_cpu, losses=[m["loss"] for m in m_card]),
         remat_on_off_bitwise=remat_bitwise, launcher_done_loss=done,
         part_s={"full_width_training": t_cpu_vs_card - t_phase,
                 "of_which_profile": profile_s,
                 "cpu_vs_card": t_remat - t_cpu_vs_card,
                 "remat": t_launcher - t_remat,
                 "launcher": time.perf_counter() - t_launcher},
         kernel_launches=after)
    return dict(tcfg=tcfg, peak_bytes=peak, step_ms=step_ms,
                model_flops=flops)


# ---------------------------------------------------------------------------
# slice 15: the launch tools (dry-run, analytic cost model, roofline)
# ---------------------------------------------------------------------------
#: the dry-run's pairs, each ``python -m repro_torch.launch.dryrun`` in a
#: process of its own (a fake group of 256 or 512 ranks): the train step on
#: the single pod, the tight FL round across two pods, the decode of the
#: model that never materialises, RecurrentGemma's decode, whose gates
#: cut through heads on "model" (the card's torch refused the partial sum
#: that left before their bias), Qwen3's decode on its sequence-split KV
#: cache (written and read on each rank's own shard; gathered whole before,
#: it did not fit) and xLSTM's prefill, whose mLSTM runs on local shards
#: (DTensor replicated it over "model" on the card's torch before)
DRYRUN_PAIRS = (
    ("h2o-danube-1.8b", "train_4k", ()),
    ("h2o-danube-1.8b", "train_4k", ("--multi-pod", "--fl-round")),
    ("deepseek-v2-236b", "decode_32k", ()),
    ("recurrentgemma-2b", "decode_32k", ()),
    ("qwen3-32b", "decode_32k", ()),
    ("xlstm-350m", "prefill_32k", ()),
    # one node of eight cards serving the MoE tensor-parallel
    ("granite-moe-1b-a400m", "decode_32k", ("--mesh", "1x8")))
#: pairs at full width and cut depth, (arch, shape, layers) on the 16x16
#: group: the layouts whose heads do not divide "model" (the key-split
#: attention's ``wo`` on each rank's rows, InternVL2's residual after its
#: prefix, RecurrentGemma's gates at 4 periods, where their stacked weight
#: is split inside the heads) and the decode against a cache whose slots
#: lie on "data" (``long_500k``).  No pair of the phase may take a view the card's torch
#: refuses (the trace reshards it; on real ranks it raises)
DRYRUN_CUT_PAIRS = (
    ("h2o-danube-1.8b", "long_500k", 1),
    ("internvl2-1b", "prefill_32k", 1),
    ("internvl2-1b", "train_4k", 1),
    ("yi-34b", "train_4k", 1),
    ("recurrentgemma-2b", "train_4k", 12))
_CUT_PAIR = """
import json, sys
import repro_torch.launch.dryrun as D
from repro_torch.config import get_model_config
arch, shape, layers, out = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
D.get_model_config = lambda a: get_model_config(a).replace(num_layers=layers)
rec = dict(D.run_one(arch, shape, verbose=False), layers=layers)
with open(out, "w") as f:
    f.write(json.dumps(rec) + "\\n")
"""
#: xLSTM's counted FLOPs a device at most this many times its analytic
#: count (the parallel form computes every key of a query's chunk, the
#: analytic count the causal half)
DRYRUN_XLSTM_FLOPS_MAX = 2.5
#: the one-rank dry-run of phase train's configuration: its predicted peak
#: against the peak the card measured there
DRYRUN_PEAK_RTOL = 0.05
DRYRUN_TIMEOUT_S = 600
_CALIBRATE = """
import json, sys
from repro_torch.config import TrainConfig
from repro_torch.launch.dryrun import run_one
rec = run_one("h2o-danube-1.8b", "train_4k", verbose=False,
              train_cfg=TrainConfig(**json.loads(sys.argv[1])),
              mesh_shape=(1, 1))
print(json.dumps(rec))
"""


class DryrunProcs:
    """Phase ``dryrun``'s processes, started together: one for each of
    :data:`DRYRUN_PAIRS`, :data:`DRYRUN_CUT_PAIRS` and the
    calibration."""

    def __init__(self, train: dict):
        import dataclasses
        import tempfile

        self.t0 = time.perf_counter()
        self.dir = tempfile.mkdtemp(prefix="dryrun-")
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src_torch"))
        cmds = {}
        for i, (arch, shape, flags) in enumerate(DRYRUN_PAIRS):
            cmds[f"pair{i}"] = [
                sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--shape", shape, *flags,
                "--out", os.path.join(self.dir, f"pair{i}.jsonl")]
        for i, (arch, shape, layers) in enumerate(DRYRUN_CUT_PAIRS,
                                                  len(DRYRUN_PAIRS)):
            cmds[f"pair{i}"] = [
                sys.executable, "-c", _CUT_PAIR, arch, shape, str(layers),
                os.path.join(self.dir, f"pair{i}.jsonl")]
        cmds["calibration"] = [sys.executable, "-c", _CALIBRATE, json.dumps(
            dataclasses.asdict(train["tcfg"]))]
        self.env, self.procs, self.logs = env, {}, {}
        try:
            for name, cmd in cmds.items():
                self.logs[name] = open(os.path.join(self.dir, name + ".log"),
                                       "w+")
                self.procs[name] = subprocess.Popen(
                    cmd, cwd=HERE, env=env, stdout=self.logs[name],
                    stderr=subprocess.STDOUT)
        except BaseException:
            self.stop()
            raise

    def running(self) -> int:
        return sum(p.poll() is None for p in self.procs.values())

    def stop(self) -> None:
        import shutil

        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs.values():
            f.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def phase_dryrun(card: str, train: dict, procs: DryrunProcs):
    """Slice 15's main path: the dry-run of :data:`DRYRUN_PAIRS` on fake
    process groups (fake tensors on the card's device type: no storage, no
    kernel), the roofline report of their records, and a one-rank dry-run
    of phase ``train``'s exact ``TrainConfig``, whose predicted peak is
    held to the peak the card measured there, and the pairs of
    :data:`DRYRUN_CUT_PAIRS`.  The processes run at once (started by
    ``procs``); a failed one fails the phase, as does a decode pair that
    does not fit 80 GB, an xLSTM pair that counts more than
    :data:`DRYRUN_XLSTM_FLOPS_MAX` times its analytic FLOPs, or any pair
    with a view that took the relaxed rule.  Each pair's line lists its
    relaxed views by site."""
    from repro_torch.launch.mesh import (HBM_BW, NET_BW, NVLINK_BW,
                                         PEAK_FLOPS_BF16)

    before = _launch_counts()
    d = procs.dir
    try:
        rcs = {name: p.wait(timeout=max(
            DRYRUN_TIMEOUT_S - (time.perf_counter() - procs.t0), 1))
            for name, p in procs.procs.items()}
        out = {}
        for name, f in procs.logs.items():
            f.seek(0)
            out[name] = f.read()
        wall_s = time.perf_counter() - procs.t0
        for name, rc in rcs.items():
            check(rc == 0, f"dryrun: {name} exited {rc}: "
                           f"{out[name][-3000:]}")
        recs = []
        n_pairs = len(DRYRUN_PAIRS) + len(DRYRUN_CUT_PAIRS)
        for i in range(n_pairs):
            with open(os.path.join(d, f"pair{i}.jsonl")) as f:
                recs += [json.loads(line) for line in f]
        joined = os.path.join(d, "dryrun_results.jsonl")
        with open(joined, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in recs)
        report = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.roofline", "--md",
             "--in", joined], cwd=HERE, env=procs.env, capture_output=True,
            text=True, timeout=120, check=True).stdout
    finally:
        procs.stop()
    check(len(recs) == n_pairs and all(r["status"] == "ok" for r in recs),
          f"dryrun: a pair is not ok: {[r.get('error') for r in recs]}")
    print(report, flush=True)
    for r in recs:
        pd = r["per_device"]
        emit("dryrun_pair", card=card, arch=r["arch"], shape=r["shape"],
             mesh=r["mesh"], layers=r.get("layers"), fl_round=r["fl_round"],
             devices=r["devices"],
             device_type=r["device_type"], roofline=r["roofline"],
             counted_flops_per_device=pd["counted_flops_raw"],
             analytic_flops_per_device=pd["analytic_flops"],
             analytic_hbm_bytes_per_device=pd["analytic_hbm_bytes"],
             collective_bytes_per_device=pd["collective_bytes"],
             peak_gb_per_device=pd["peak_bytes_est"] / 1e9,
             fits_80GB=pd["fits_80GB"],
             useful_flops_frac=r["useful_flops_frac"],
             place_s=r["place_s"], trace_s=r["trace_s"],
             sharding_fallbacks=len(r["sharding_fallbacks"]),
             relaxed_views=r["relaxed_views"],
             dominant=r["roofline"]["dominant"])
    for r in recs:
        pd = r["per_device"]
        check(r["shape"] not in ("decode_32k", "long_500k")
              or pd["fits_80GB"],
              f"dryrun: {r['arch']} {r['shape']} does not fit 80 GB: "
              f"{pd['peak_bytes_est'] / 1e9:.2f} GB")
        ratio = pd["counted_flops_raw"] / pd["analytic_flops"]
        check(not r["arch"].startswith("xlstm")
              or ratio <= DRYRUN_XLSTM_FLOPS_MAX,
              f"dryrun: {r['arch']} {r['shape']} counts {ratio:.2f}x its "
              f"analytic FLOPs")
        check(not r["relaxed_views"],
              f"dryrun: {r['arch']} {r['shape']} {r['mesh']} resharded "
              f"views: {r['relaxed_views']}")
    cal = json.loads(out["calibration"].strip().splitlines()[-1])
    check(cal["status"] == "ok", f"dryrun: calibration {cal}")
    predicted = cal["per_device"]["peak_bytes_est"]
    peak_rel = predicted / train["peak_bytes"] - 1
    check(abs(peak_rel) <= DRYRUN_PEAK_RTOL,
          f"dryrun: predicted peak {predicted} vs measured "
          f"{train['peak_bytes']}: {peak_rel:+.4f}")
    after = _launch_counts()
    check(after == before, f"dryrun: a kernel launched {before} -> {after}")
    emit("dryrun", card=card, pairs=len(recs), wall_s=wall_s,
         constants=dict(peak_flops_bf16=PEAK_FLOPS_BF16, hbm_bw=HBM_BW,
                        net_bw=NET_BW, nvlink_bw=NVLINK_BW),
         calibration=dict(
             arch=cal["arch"], mesh=cal["mesh"],
             global_batch=cal["global_batch"], seq_len=cal["seq_len"],
             microbatches=train["tcfg"].microbatches,
             predicted_peak_gb=predicted / 1e9,
             measured_peak_gb=train["peak_bytes"] / 1e9,
             peak_rel_diff=peak_rel, peak_rtol=DRYRUN_PEAK_RTOL,
             counted_tflop=cal["per_device"]["counted_flops_raw"] / 1e12,
             analytic_tflop=cal["per_device"]["analytic_flops"] / 1e12,
             train_model_tflop=train["model_flops"] / 1e12,
             roofline=cal["roofline"],
             measured_step_s=train["step_ms"] / 1e3,
             place_s=cal["place_s"], trace_s=cal["trace_s"]),
         kernel_launches=after)


# ---------------------------------------------------------------------------
# the sharded steps on real ranks under the card's own torch
# ---------------------------------------------------------------------------
SHARDED_MESHES = ((1, 2), (2, 2))
SHARDED_BUDGET_S = 240


def run_sharded_ranks(busy=lambda: 0) -> dict:
    """``src_torch/tools/sharded_ranks.py``'s checks of every family on
    each of :data:`SHARDED_MESHES` (gloo, one CPU process a rank), on as
    many of the host's cores as ``busy()`` (processes of another phase
    still running) leaves free."""
    sys.path.insert(0, os.path.join(HERE, "src_torch", "tools"))
    import sharded_ranks as SR

    cpus = len(os.sched_getaffinity(0))
    t0 = time.perf_counter()
    lines = SR.run_all(SR.ARCHS, SHARDED_MESHES,
                       jobs=lambda: cpus - busy(),
                       timeout=SHARDED_BUDGET_S, layouts=SR.LAYOUTS)
    return dict(lines=lines, wall_s=time.perf_counter() - t0, cpus=cpus,
                archs=SR.ARCHS, paths=SR.PATHS, layouts=SR.LAYOUTS)


def phase_sharded_ranks(card: str, run: dict):
    """The sharded prefill, decode and train step of every family but the
    quickstart MLP on real gloo ranks of a (1, 2) and a (2, 2) mesh, and
    the layouts of ``sharded_ranks.LAYOUTS`` on their meshes, each against
    the plain one, under this machine's torch (run by
    :func:`run_sharded_ranks` beside phase ``dryrun``'s processes): one
    line per (family, mesh, path) with ``ok``, the largest error and the
    seconds.  A failed check or rank, or a run past
    :data:`SHARDED_BUDGET_S`, fails the phase."""
    lines = sorted(run["lines"], key=lambda r: (r["arch"], r["mesh"],
                                                r["path"]))
    for r in lines:
        emit("sharded_ranks_check", card=card, **r)
    def key(arch, mesh, path, over):
        return arch, mesh, path, json.dumps(over, sort_keys=True)

    want = {key(a, f"{d}x{m}", p, {}) for a in run["archs"]
            for d, m in SHARDED_MESHES for p in run["paths"]}
    want |= {key(a, "x".join(map(str, mesh)), p, o)
             for a, p, mesh, o in run["layouts"]}
    got = {key(r["arch"], r["mesh"], r["path"], r.get("over", {}))
           for r in lines if r["ok"]}
    emit("sharded_ranks", card=card, torch=torch.__version__,
         wall_s=run["wall_s"], cpus=run["cpus"], checks=len(lines),
         passed=len(got & want),
         max_err={p: max((r.get("max_err", 0.0) for r in lines
                          if r["path"] == p and r["ok"]), default=None)
                  for p in sorted({r["path"] for r in lines})})
    bad = [r for r in lines if not r["ok"]]
    check(not bad and got == want,
          f"sharded_ranks: failed {[(r['arch'], r['mesh'], r['path'], r.get('where'), r.get('error', '')[:300]) for r in bad]}, missing {sorted(want - got)}")
    check(run["wall_s"] <= SHARDED_BUDGET_S,
          f"sharded_ranks: {run['wall_s']:.1f} s > {SHARDED_BUDGET_S} s")


# ---------------------------------------------------------------------------
# slice 10: the TCP fleet, the federated LLM and the tight-mode round
# ---------------------------------------------------------------------------
#: the 16-process TCP round: the reference's
#: ``test_tcp_16proc_round_bitwise_vs_inproc`` fleet at ``fold_50Mx16``'s
#: geometry (200 leaves of 250,000 fp32 a client), two rounds
TCP_PROCS, TCP_ROUNDS = 16, 2
TCP_CREDITS = 256 << 20
#: the federated LLM: H2O-Danube-1.8B at full width, depth cut 24 -> 4 (four
#: sites' fp32 params and Adam moments, 5.3 GB each, share the card); the
#: example's four sites, 0xF5 TopK deltas at its default 5%, phase train's
#: TrainConfig, 2 rounds of 1 local step (2 local steps made the phase 325
#: s on the card, most of it the sites' host work: the rounds stay, the
#: width stays)
FED_LAYERS, FED_ROUNDS, FED_LOCAL_STEPS, FED_FRAC = 4, 2, 1, 0.05
#: the sharded step against the plain one: the reference's
#: tests/test_federated_llm.py tolerances (loss rtol; params rtol + atol)
FED_LOSS_RTOL, FED_PARAM_RTOL, FED_PARAM_ATOL = 1e-5, 1e-5, 1e-6
#: the tight-mode round: 2 pods stacked on the card, 2 local steps each
TIGHT_PODS, TIGHT_LOCAL_STEPS = 2, 2


def _tcp_app(node_id: str):
    """A SuperNode's app for the TCP round (a spawned process builds it
    from this module): fit adds a site-derived constant, so the TCP and
    in-process fleets can be compared bitwise."""
    from repro_torch.fl import ClientApp, NumPyClient

    idx = int(node_id.rsplit("-", 1)[-1])

    class Shift(NumPyClient):
        def fit(self, parameters, config):
            return ([np.asarray(p, np.float32) + np.float32(idx + 1)
                     for p in parameters], 10 + idx, {})

        def evaluate(self, parameters, config):
            return (float(sum(np.abs(np.asarray(p, np.float64)).sum()
                              for p in parameters)), 10 + idx, {})

    return ClientApp(lambda cid: Shift().to_client())


class _Timed:
    """A FitAccumulator that records the host ms of each ``add`` and of
    ``finalize`` (ending in a device sync) and keeps the first result it
    was given."""

    def __init__(self, acc, log: dict):
        self._acc, self._log = acc, log

    def add(self, node, res):
        self._log.setdefault("first", res)
        t0 = time.perf_counter()
        self._acc.add(node, res)
        self._log.setdefault("add_ms", []).append(
            (time.perf_counter() - t0) * 1e3)

    def finalize(self, failures):
        ms, out = sync_ms(lambda: self._acc.finalize(failures))
        self._log.setdefault("finalize_ms", []).append(ms)
        return out


def _timed_fedavg(log: dict, **kw):
    from repro_torch.fl import FedAvg

    class TimedFedAvg(FedAvg):
        def fit_accumulator(self, rnd, current):
            log.setdefault("opened_s", []).append(time.perf_counter())
            return _Timed(super().fit_accumulator(rnd, current), log)

    return TimedFedAvg(**kw)


def phase_tcp_round(dev, card: str):
    """Slice 10's transport: 16 SuperNode processes (spawned) connect over
    loopback TCP to the port's ``TcpSuperLink``; each uploads a
    50M-parameter fp32 payload; FedAvg folds on the card.  Gate: the
    history and the aggregate bitwise equal to the same rounds run
    in-process.  Then the 3-site quickstart over TCP, flat and q8, bitwise
    ``run_native``'s in-process history."""
    import multiprocessing as mp

    from repro_torch.core.framing import FT_RES, data_frame_parts, \
        frame_nbytes
    from repro_torch.core.superlink import (NativeConnection, SuperLink,
                                            SuperLinkDriver, SuperNode)
    from repro_torch.core.transport import TcpSuperLink, run_supernode
    from repro_torch.fl import ServerApp, ServerConfig, agg_kernels
    from repro_torch.kernels import agg_reduce as A

    class CountingLink(TcpSuperLink):
        """The server's link, counting the bytes of every frame."""
        wire = {"rx": 0, "tx": 0}

        def _on_frame(self, peer, conn, frame):
            self.wire["rx"] += frame[1].nbytes + 5
            return super()._on_frame(peer, conn, frame)

        def _send_res(self, peer, msg_id, resp):
            extra, body = resp
            self.wire["tx"] += frame_nbytes(data_frame_parts(
                FT_RES, dict({"i": msg_id}, **extra), body))
            super()._send_res(peer, msg_id, resp)

    sites = [f"proc-{i}" for i in range(TCP_PROCS)]
    rng = np.random.default_rng(10)
    initial = [rng.random(LEAF, np.float32) for _ in range(NLEAVES)]

    def app(log):
        return ServerApp(ServerConfig(num_rounds=TCP_ROUNDS,
                                      round_timeout=600.0,
                                      agg_backend="torch",
                                      agg_device=dev.type),
                         _timed_fedavg(log, initial_parameters=initial))

    ref_log = {}
    link = SuperLink()
    nodes = [SuperNode(s, _tcp_app(s), NativeConnection(link)) for s in sites]
    for n in nodes:
        n.start()
    try:
        inproc_s, h_ref = sync_ms(lambda: app(ref_log).run(
            SuperLinkDriver(link, expected_nodes=TCP_PROCS)))
    finally:
        for n in nodes:
            n.stop()
    del nodes, link
    log = {}
    ctx = mp.get_context("spawn")
    A.LAUNCHES["weighted_sum"] = 0
    # a peer's credit window must hold half of its largest frame (the
    # server drops a peer more than one window over): 256 MB for the 200 MB
    # payloads (the default 64 MB suits the quickstart's frames).  A node's
    # socket timeout, half its PING interval, also bounds each send: at the
    # default 0.5 s interval, 16 concurrent 200 MB uploads into one server
    # left a node's socket undrained past 0.25 s and the nodes dropped
    # mid-frame, again and again.  So the nodes PING every 20 s (a 10 s
    # socket timeout) and wait 120 s, the server's value, for its PONGs
    with CountingLink("127.0.0.1", 0, poll_wait=1.0, heartbeat_timeout=120.0,
                      credits_per_peer=TCP_CREDITS) as tcp:
        host, port = tcp.address
        t0 = time.perf_counter()
        procs = [ctx.Process(target=run_supernode,
                             args=(host, port, s, _tcp_app),
                             kwargs=dict(run_seconds=900.0,
                                         heartbeat_interval=20.0,
                                         heartbeat_timeout=120.0,
                                         max_disconnected=10.0),
                             daemon=True) for s in sites]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + 300
            while len(tcp.node_ids()) < TCP_PROCS:
                check(time.monotonic() < deadline,
                      f"tcp_round: {len(tcp.node_ids())}/{TCP_PROCS} "
                      "SuperNodes joined")
                time.sleep(0.2)
            join_s = time.perf_counter() - t0
            tcp.wire.update(rx=0, tx=0)
            round_ms, h_tcp = sync_ms(lambda: app(log).run(
                SuperLinkDriver(tcp, expected_nodes=TCP_PROCS)))
            wire = dict(tcp.wire)
        finally:
            tcp.close()
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
    launches = A.LAUNCHES["weighted_sum"]
    check(h_tcp.losses() == h_ref.losses(), "tcp_round: losses != in-process")
    check(_same(h_tcp, h_ref), "tcp_round: aggregate != in-process")
    check(all(not r.failures for r in h_tcp.rounds), "tcp_round: failures")
    check(launches > 0, "tcp_round: no weighted_sum launch")
    check(all(not p.is_alive() for p in procs), "tcp_round: a child lived")
    # the host-to-device copy of one round's 16 payloads, as the fold makes
    # it (phase fold_50Mx16's h2d_ms, on a payload this round received)
    src = log["first"].flat.tile_source()
    h2d_ms, stack = sync_ms(lambda: agg_kernels._device_stack(
        [src] * TCP_PROCS, dev, {}))
    del stack
    nbytes = wire["rx"] + wire["tx"]
    quick = {}
    for codec in ("flat", "q8"):
        native = _history(codec, "torch", flare=False)
        over_tcp = _history(codec, "torch", flare=False, transport="tcp")
        check(_same(native, over_tcp),
              f"tcp_round: quickstart {codec} over TCP != in-process")
        quick[codec] = [l for _, l in over_tcp.losses()]
    torch.cuda.empty_cache()
    per_round = round_ms / TCP_ROUNDS
    fold = [a + f for a, f in zip(
        [sum(log["add_ms"][i * TCP_PROCS:(i + 1) * TCP_PROCS])
         for i in range(TCP_ROUNDS)], log["finalize_ms"])]
    row = dict(card=card, procs=TCP_PROCS, rounds=TCP_ROUNDS,
               params=LEAF * NLEAVES, join_s=join_s, run_ms=round_ms,
               round_ms=per_round, inproc_round_ms=inproc_s / TCP_ROUNDS,
               wire_bytes=wire, wire_mb_per_s=nbytes / 1e6 / (round_ms / 1e3),
               fold_ms=fold, finalize_ms=log["finalize_ms"],
               inproc_fold_ms=[sum(ref_log["add_ms"][i * TCP_PROCS:(i + 1)
                                                      * TCP_PROCS]) + f
                               for i, f in enumerate(ref_log["finalize_ms"])],
               h2d_ms=h2d_ms, weighted_sum_launches=launches,
               bitwise_vs_inproc=True, quickstart_tcp_losses=quick)
    emit("tcp_round", **row)
    return launches


def _fed_cfg():
    from repro_torch.config import get_model_config

    return get_model_config("h2o-danube-1.8b").replace(num_layers=FED_LAYERS)


def _params_excess(a, b) -> float:
    """max over leaves of |a - b| - (atol + rtol |a|), in fp64 (the
    reference test's ``assert_allclose``): <= 0 passes."""
    from repro_torch.utils.pytree import tree_leaves

    worst = -float("inf")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = x.double(), y.double()
        worst = max(worst, float(((x - y).abs() - (
            FED_PARAM_ATOL + FED_PARAM_RTOL * x.abs())).max()))
    return worst


def phase_federated_llm(dev, card: str):
    """Slice 10's main path: the federated-LLM example on the card --
    H2O-Danube-1.8B at full width and 4 layers, four ``LMClient`` sites on
    ``make_local_mesh()`` (the sharded step), 0xF5 TopK deltas at 5%,
    FedAvg through ``run_in_flare`` folding on the card through
    ``scatter_wsum``.  First the sharded step against the plain one for 2
    steps; then the federation as the example runs it (the sites overlap),
    and each site's last fit task handled again one site at a time, so the
    split of a fit is each piece's own; then round 1's received frames
    folded again, by the card and by the numpy engine (bitwise), and
    ``scatter_wsum`` timed at one frame's span."""
    from repro_torch.data.loader import FederatedDataLoader
    from repro_torch.examples import federated_llm as ex
    from repro_torch.fl import ClientApp
    from repro_torch.fl.flat import FlatParams
    from repro_torch.fl.messages import decode_fit_res, decode_task_res
    from repro_torch.fl.strategy import make_strategy
    from repro_torch.kernels import agg_reduce as A
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.train.steps import (full_tree, get_train_step,
                                         make_train_state)
    from repro_torch.utils.pytree import tree_leaves

    t_phase = time.perf_counter()
    cfg = _fed_cfg()
    tcfg = _train_tcfg(TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO)
    model = build_model(cfg)
    mesh = make_local_mesh(device=dev)
    # -- the sharded step against the plain one, 2 steps from one state
    loader = FederatedDataLoader(cfg.vocab_size, TRAIN_SEQ, 1, TRAIN_BATCH,
                                 seed=0)
    batches = [loader.next_batch(0) for _ in range(2)]
    plain = get_train_step(cfg, tcfg, device=dev)
    sharded = get_train_step(cfg, tcfg, mesh=mesh)
    a = b = make_train_state(model, tcfg, 0, device=dev)
    step_ms = {"plain": [], "sharded": []}
    loss_pairs = []
    for bt in batches:
        ms, (a, ma) = sync_ms(lambda: plain(a, bt))
        step_ms["plain"].append(ms)
        ms, (b, mb) = sync_ms(lambda: sharded(b, bt))
        step_ms["sharded"].append(ms)
        loss_pairs.append((float(ma["loss"]), float(mb["loss"])))
        check(abs(loss_pairs[-1][1] / loss_pairs[-1][0] - 1)
              <= FED_LOSS_RTOL, f"federated_llm: sharded loss {loss_pairs}")
    b = full_tree(b)
    excess = _params_excess(a.params, b.params)
    check(excess <= 0, f"federated_llm: sharded params off by {excess}")
    bitwise = all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))
    del a, b, plain
    torch.cuda.empty_cache()

    # -- the federation as the example runs it: the sites' tasks overlap,
    # and the timers around each piece serialize nothing.  ``ex.ClientApp``,
    # ``ex.FedAvg`` and ``ex.params_to_arrays`` are swapped for timed ones
    # for the run
    def fresh():
        return {"steps_ms": [], "to_numpy_ms": [], "fit_handle_ms": [],
                "eval_handle_ms": [], "fit_wire_bytes": [], "frames": {}}

    rec = fresh()   # the timers write to whatever dict ``rec`` names
    apps = []
    to_numpy, client_app, fedavg = ex.params_to_arrays, ex.ClientApp, ex.FedAvg

    def timed_to_numpy(params):
        ms, out = sync_ms(lambda: to_numpy(params))
        rec["to_numpy_ms"].append(ms)
        return out

    class TimedApp(ClientApp):
        """The site's app, its step and handling timed; it keeps the site's
        last fit task."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            apps.append(self)

        def handle(self, task_ins_bytes, cid="0"):
            np_client = self._client(cid).np_client
            if not getattr(np_client, "_timed", False):
                step = np_client._step_fn

                def timed_step(state, batch):
                    ms, out = sync_ms(lambda: step(state, batch))
                    rec["steps_ms"].append(ms)
                    return out
                np_client._step_fn, np_client._timed = timed_step, True
            t0 = time.perf_counter()
            out = super().handle(task_ins_bytes, cid)
            ms = (time.perf_counter() - t0) * 1e3
            res = decode_task_res(out)
            if res.task_type == "fit":
                self.last_fit = (task_ins_bytes, cid)
                rec["fit_handle_ms"].append(ms)
                rec["fit_wire_bytes"].append(len(res.payload))
                if res.round == 1:
                    rec["frames"][np_client.site] = bytes(res.payload)
            elif res.task_type == "evaluate":
                rec["eval_handle_ms"].append(ms)
            return out

    fold_log = {}
    before = _launch_counts()
    A.LAUNCHES["scatter_wsum"] = 0
    torch.cuda.reset_peak_memory_stats()
    ex.params_to_arrays, ex.ClientApp = timed_to_numpy, TimedApp
    ex.FedAvg = lambda: _timed_fedavg(fold_log)
    try:
        t0 = time.perf_counter()
        history = ex.federate(cfg, tcfg, FED_ROUNDS, FED_LOCAL_STEPS,
                              codec="sparse", sparse_frac=FED_FRAC,
                              device=dev)
        t_end = time.perf_counter()
        launches = A.LAUNCHES["scatter_wsum"]
        # the split: each site's last fit task again, one site at a time,
        # so each piece is its own (no other site's host work beside it)
        run_rec, rec = rec, fresh()
        for app in sorted(apps, key=lambda x: x.last_fit[1]):
            app.handle(*app.last_fit)
    finally:
        ex.params_to_arrays, ex.ClientApp, ex.FedAvg = (to_numpy, client_app,
                                                        fedavg)
    serial_rec, rec = rec, run_rec
    del apps
    # the server's fold launches scatter_wsum for the deltas and
    # weighted_sum for the rest of its sum; training and evaluation run
    # the eager paths and launch nothing
    moved = {k: v - before.get(k, 0) for k, v in _launch_counts().items()
             if v != before.get(k, 0) and k != "agg_reduce.scatter_wsum"}
    wsum_launches = moved.pop("agg_reduce.weighted_sum", 0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gc_collect()
    losses = [l for _, l in history.losses()]
    check(len(losses) == FED_ROUNDS and all(np.isfinite(losses)),
          f"federated_llm: eval losses {losses}")
    check(losses[-1] < losses[0], f"federated_llm: loss did not improve "
                                  f"{losses}")
    check(all(not r.failures for r in history.rounds),
          f"federated_llm: failures {[r.failures for r in history.rounds]}")
    check(launches > 0, "federated_llm: no scatter_wsum launch")
    check(moved == {}, f"federated_llm: other kernels launched: {moved}")
    # -- round 1's frames, folded again by the card and the numpy engine
    current = to_numpy(model.init(0, device=dev))
    base = FlatParams.from_arrays(current)

    def refold(backend):
        st = make_strategy("fedavg", backend=backend,
                           device=dev if backend == "torch" else None)
        acc = st.fit_accumulator(1, current)
        for site in sorted(rec["frames"]):
            r = decode_fit_res(rec["frames"][site])
            r.sparse.base = base
            acc.add(site, r)
        return acc.finalize([])[0]

    A.LAUNCHES["scatter_wsum"] = 0
    card_ms, got = sync_ms(lambda: refold("torch"))
    refold_launches = A.LAUNCHES["scatter_wsum"]
    t0r = time.perf_counter()
    want = refold("numpy")
    numpy_ms = (time.perf_counter() - t0r) * 1e3
    check(all(x.tobytes() == y.tobytes() for x, y in zip(got, want)),
          "federated_llm: the card's 0xF5 fold != the numpy engine")
    del got, want
    sp = decode_fit_res(rec["frames"][sorted(rec["frames"])[0]]).sparse
    timing = _scatter_timing(dev, sp)
    timing.update(launches=launches, nnz=sp.nnz,
                  share_of_bound=timing["bound_ms"] / timing["ms"])
    # a round: from its fit tasks' dispatch to the next round's (the last
    # to the run's end), its evaluation included
    opened = fold_log["opened_s"] + [t_end]
    round_s = [b - a for a, b in zip(opened, opened[1:])]
    steps = serial_rec["steps_ms"]
    split = dict(
        client_steps_ms=steps,
        fit_to_numpy_ms=serial_rec["to_numpy_ms"],
        fit_host_rest_ms=[h - s - t for h, s, t in zip(
            serial_rec["fit_handle_ms"], steps, serial_rec["to_numpy_ms"])],
        fit_handle_ms=serial_rec["fit_handle_ms"])
    run = dict(
        step_ms=rec["steps_ms"], to_numpy_ms=rec["to_numpy_ms"],
        fit_handle_ms=rec["fit_handle_ms"],
        evaluate_ms=rec["eval_handle_ms"],
        server_add_ms=fold_log["add_ms"],
        server_finalize_ms=fold_log["finalize_ms"])
    row = dict(card=card, layers=cfg.num_layers, params=model.param_count(),
               sites=len(ex.SITES), rounds=FED_ROUNDS,
               local_steps=FED_LOCAL_STEPS, sparse_frac=FED_FRAC,
               eval_losses=losses, run_s=t_end - t0, round_s=round_s,
               run_ms=run, serial_fit_split_ms=split,
               fit_wire_bytes=rec["fit_wire_bytes"],
               peak_gb=peak_gb, scatter_wsum_launches=launches,
               weighted_sum_launches=wsum_launches,
               refold_launches=refold_launches, refold_card_ms=card_ms,
               refold_numpy_ms=numpy_ms, fold_bitwise_numpy=True,
               sharded_vs_plain=dict(step_ms=step_ms, losses=loss_pairs,
                                     params_excess=excess, bitwise=bitwise),
               kernel=timing, phase_s=time.perf_counter() - t_phase)
    emit("federated_llm", **row)
    del history, current, base, sp, rec, serial_rec, run_rec
    gc_collect()
    return timing


def gc_collect() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_tight_round(dev, card: str):
    """Slice 10's tight mode: ``make_fl_round_step`` on the 4-layer danube,
    two pods stacked on the card, 2 local steps each, then FedAvg over the
    pod dim.  Gates: params and moments identical across pods after
    FedAvg, losses finite, no kernel launched (training is eager)."""
    from repro_torch.core import make_fl_round_step
    from repro_torch.core.collective import pod_stacked_state
    from repro_torch.data.loader import FederatedDataLoader
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.train.steps import make_train_state
    from repro_torch.utils.pytree import tree_leaves

    cfg = _fed_cfg()
    tcfg = _train_tcfg(TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO)
    model = build_model(cfg)
    before = _launch_counts()
    torch.cuda.reset_peak_memory_stats()
    state = pod_stacked_state(make_train_state(model, tcfg, 0, device=dev),
                              TIGHT_PODS)
    loader = FederatedDataLoader(cfg.vocab_size, TRAIN_SEQ, TIGHT_PODS,
                                 TRAIN_BATCH, seed=0)
    batches = {k: torch.from_numpy(np.stack([
        np.stack([loader.next_batch(p)[k] for _ in range(TIGHT_LOCAL_STEPS)])
        for p in range(TIGHT_PODS)])) for k in ("tokens", "labels")}
    round_fn = make_fl_round_step(model, tcfg, make_local_mesh(device=dev),
                                  local_steps=TIGHT_LOCAL_STEPS)
    ms, (new, metrics) = sync_ms(lambda: round_fn(state, batches))
    del state
    losses = metrics["round_losses"].float().cpu()
    check(tuple(losses.shape) == (TIGHT_PODS, TIGHT_LOCAL_STEPS),
          f"tight_round: losses {tuple(losses.shape)}")
    check(bool(torch.isfinite(losses).all()), f"tight_round: {losses}")
    same = all(torch.equal(x[0], x[p]) for x in tree_leaves(new.params)
               + tree_leaves(new.opt_state) for p in range(1, TIGHT_PODS))
    check(same, "tight_round: pods differ after FedAvg")
    moved = {k: v - before.get(k, 0) for k, v in _launch_counts().items()
             if v != before.get(k, 0)}
    check(moved == {}, f"tight_round: kernels launched: {moved}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("tight_round", card=card, layers=cfg.num_layers, pods=TIGHT_PODS,
         local_steps=TIGHT_LOCAL_STEPS, round_ms=ms,
         losses=losses.tolist(), pods_equal=True, peak_gb=peak_gb)
    del new, metrics
    gc_collect()


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
    card = phase_env()
    max_diff = phase_kernel_vs_twin(dev)
    sort_diff, sort_many = phase_sort_vs_twin(dev)
    gram_diff, gram_many = phase_gram_vs_twin(dev)
    flash_diff = phase_flash_vs_twin(dev)
    rglru_diff = phase_rglru_vs_twin(dev)
    secagg_diff = phase_secagg_vs_twin(dev)
    phase_wsum_f32_vs_twin(dev)
    scatter_diff = phase_scatter_vs_twin(dev)
    decode_diff = phase_decode_vs_twin(dev)
    decode_launches = phase_mixed_round(dev)
    launches = phase_slice()
    robust_launches = phase_robust_slice()
    row = phase_fold(dev)
    robust = phase_robust_fold(dev)
    decode = phase_decode_timing(dev, card)
    flash_launches = phase_serve(dev, card)
    flash = phase_flash_timing(dev, card)
    rg_launches = phase_serve_recurrentgemma(dev, card)
    fam_launches, fam_f32_launches = phase_serve_families(dev, card)
    flash_rg = phase_flash_timing(dev, card, FLASH_SERVE_RG, seed=4096)
    # the families' two head dims: granite-moe's prefill (hd 64) and
    # qwen3's (hd 128)
    flash_hd64 = phase_flash_timing(
        dev, card, FLASH_FAMILIES["granite-moe-1b-a400m"], seed=64)
    flash_hd128 = phase_flash_timing(dev, card, FLASH_FAMILIES["qwen3-32b"],
                                     seed=128)
    # Whisper's encoder layer: the non-causal route at a serving shape
    flash_enc = phase_flash_timing(dev, card, FLASH_FAMILIES["whisper-medium"],
                                   seed=1500)
    rglru = phase_rglru_timing(dev, card)
    f32_tile = phase_shard_fold(dev, card)
    scatter = phase_sparse_fold(dev, card)
    phase_secagg_slice()
    secagg = phase_secagg_timing(dev, card)
    example_launches = phase_examples(dev)
    phase_legacy_baseline(dev, card)
    train = phase_train(dev, card)
    dryrun = DryrunProcs(train)
    try:
        ranks = run_sharded_ranks(busy=dryrun.running)
    except BaseException:
        dryrun.stop()
        raise
    phase_dryrun(card, train, dryrun)
    phase_sharded_ranks(card, ranks)
    tcp_launches = phase_tcp_round(dev, card)
    fed = phase_federated_llm(dev, card)
    phase_tight_round(dev, card)
    src = "src_torch/repro_torch/kernels/csrc/"
    f32_launches = rg_launches["f32_cuda_core"] + sum(
        fam_f32_launches.values())
    lines = [
        # the fp32-tile mode (the sharded fold's tile_dtype="float32") under
        # "f32_tile": its launches are the sharded fold's at 50M x 16
        dict(name="weighted_sum", source=src + "weighted_sum.cu",
             replaces="src/repro/kernels/agg_reduce.py:200",
             launches=launches, max_abs_diff=max_diff,
             launches_by_path={"slice": launches,
                               "fold": row["fold_launches"],
                               "tcp_round": tcp_launches,
                               "examples": sum(example_launches.values())},
             f32_tile=dict(f32_tile, route="cuda",
                           replaces="src/repro/kernels/agg_reduce.py:92-118,"
                                    " :174-197, :223-232",
                           max_abs_err=f32_tile["max_abs_diff"]), **row),
        # past 64 clients (small N, fp32) under "over_64_clients"
        dict(name="sort_reduce", source=src + "sort_reduce.cu",
             replaces="src/repro/kernels/agg_reduce.py:283",
             launches=robust_launches["sort_reduce"],
             max_abs_diff=sort_diff, over_64_clients=sort_many,
             **robust["sort_reduce"]),
        dict(name="gram", source=src + "gram.cu",
             replaces="src/repro/kernels/agg_reduce.py:339",
             launches=robust_launches["gram"], over_64_clients=gram_many,
             **dict(robust["gram"], max_abs_diff=max(
                 gram_diff, robust["gram"]["max_abs_diff"]))),
        # launches: the mixed robust round's (one per run of like clients
        # and reduction); the times at 16 x 50M (q8 deltas under
        # "q8_delta")
        dict(decode, name="decode_rows", source=src + "decode_rows.cu",
             max_abs_diff=max(decode_diff, decode["max_abs_diff"]),
             replaces="src/repro/fl/flat.py:466, :595 (f64_chunk, the "
                      "numpy engine's per-client decode of a mixed round, "
                      "src/repro/fl/agg_kernels.py:819 _rowstack)",
             launches=decode_launches),
        # launches: the bf16 prefills of the serving paths (H2O-Danube, hd
        # 80; RecurrentGemma, hd 256; the families, hd 64 and 128, per
        # arch: Whisper's encoder layers non-causal), all on the
        # tensor-core route (the fp32 route's, below, by route); the
        # times at danube's shape, at RecurrentGemma's under "hd256", at
        # granite-moe's and qwen3's under "hd64" and "hd128", at Whisper's
        # encoder layer under "hd64_noncausal"; per route under "routes"
        # (fp32: the CUDA-core kernel)
        dict(name="flash_attention", source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:94",
             design="bf16: wgmma products (S = Q K^T from shared memory, "
                    "O += P V with P from registers) fed by TMA through a "
                    "2-stage mbarrier ring, one producer warp and two or "
                    "three consumer warpgroups of 64 rows (setmaxnreg), a "
                    "persistent grid; fp32: the CUDA-core kernel",
             launches=flash_launches + rg_launches["flash_attention"]
             + sum(fam_launches.values()),
             launches_by_path={
                 "serve": flash_launches,
                 "serve_recurrentgemma": rg_launches["flash_attention"],
                 "serve_families": fam_launches},
             launches_by_route={"tensor_core": flash_launches
                                + rg_launches["flash_attention.tensor_core"]
                                + sum(fam_launches.values()),
                                "cuda_core": f32_launches},
             hd256=flash_rg, hd64=flash_hd64, hd128=flash_hd128,
             hd64_noncausal=flash_enc,
             max_abs_diff_by_route=flash_diff,
             **dict(flash, max_abs_diff=max(*flash_diff.values(),
                                            flash["max_abs_diff"],
                                            flash_rg["max_abs_diff"],
                                            flash_hd64["max_abs_diff"],
                                            flash_hd128["max_abs_diff"],
                                            flash_enc["max_abs_diff"]))),
        # the fp32 route's kernel (f32::flash_f32_kernel): launches on the
        # fp32 prefills that hold flash against eager (RecurrentGemma's 8
        # attention layers, Whisper's 24 encoder + 24 decoder layers); the
        # times on the fp32 values of flash_timing's inputs, at the same
        # shapes, beside the bound on the fp32 CUDA cores and SDPA on
        # those values
        dict(_f32_row(flash), name="flash_attention_f32",
             source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:94",
             design="fp32 FMAs register-tiled like a SIMT GEMM (2-4 rows x "
                    "4-16 keys of S, 2-4 rows x 4-20 columns of O a "
                    "thread), K / V tiles in dynamic shared memory filled "
                    "by 16-byte cp.async through a 2-stage ring, one exp2 "
                    "a score, masks on edge tiles only",
             launches=f32_launches,
             launches_by_path={
                 "serve_recurrentgemma_f32": rg_launches["f32_cuda_core"],
                 "serve_families_f32": fam_f32_launches},
             max_abs_diff=max(flash_diff["cuda_core"], *(
                 r["routes"]["cuda_core"]["max_abs_diff"] for r in
                 (flash, flash_rg, flash_hd64, flash_hd128, flash_enc))),
             hd256=_f32_row(flash_rg), hd64=_f32_row(flash_hd64),
             hd128=_f32_row(flash_hd128),
             hd64_noncausal=_f32_row(flash_enc)),
        dict(name="rglru_scan", source=src + "rglru_scan.cu",
             replaces="src/repro/kernels/rglru_scan.py:51",
             launches=rg_launches["rglru_scan"], max_abs_diff=rglru_diff,
             **rglru),
        # launches: the federated LLM's run (4 sites x 2 rounds); the times
        # at its span (one site's 0xF5 delta at 5% of danube's 4-layer
        # 442M: the kernel, its floor, the wrapper as the fold calls it and
        # with a host index, split), and at the sparse fold's COO 1e-3 span
        # (100M x 8) under "sparse_fold"
        dict(fed, name="scatter_wsum", source=src + "scatter_wsum.cu",
             replaces="src/repro/kernels/agg_reduce.py:396",
             launches_by_path={"sparse_fold": scatter["launches"],
                               "federated_llm": fed["launches"]},
             sparse_fold=scatter,
             max_abs_diff=max(scatter_diff, scatter["max_abs_diff"],
                              fed["max_abs_diff"])),
        # launches: the public entry point at the benchmark's shape; the
        # times there, and at 50M x 15 masks under "at_50M_P15"
        dict(secagg, name="secagg_mask", source=src + "secagg_mask.cu",
             replaces="src/repro/kernels/secagg_mask.py:36",
             max_abs_diff=max(secagg_diff, secagg["max_abs_diff"])),
    ]
    keys = ("name", "route", "source", "replaces", "design", "launches",
            "max_abs_err",
            "max_abs_diff", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "share_of_bound", "kernel_over_library",
            "gb_per_s", "trim_sum", "shape",
            "launches_by_path", "launches_by_route",
            "routes", "max_abs_diff_by_route", "hd256", "hd64", "hd128",
            "hd64_noncausal",
            "over_64_clients",
            "q8_delta", "eager_scan_ms", "f32_tile", "floor_ms",
            "share_of_floor", "fold_call_ms", "wrapper_ms",
            "wrapper_split_ms", "at_50M_P15", "sparse_fold")
    out = []
    for k in lines:
        k = dict(k, route="cuda", max_abs_err=k["max_abs_diff"],
                 ms=k.get("ms", k.get("kernel_ms")))
        out.append({key: k[key] for key in keys if key in k})
    # the script's own time, the kernels' builds included
    emit("done", seconds=time.perf_counter() - T_START)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
