"""A/B of two kernels' designs on the card: a parent commit's kernel, this
checkout's, and variants of this checkout's (string edits of its source),
timed in turns in one process on one card.

Run from the root of a checkout on a machine with one NVIDIA H100, with
the parent commit unpacked beside it (``git archive <parent> | tar -x -C
DIR``):

    python3 src_torch/tools/ab_kernels.py --parent DIR
    python3 src_torch/tools/ab_kernels.py --parent DIR --kernels decode_rows
    python3 src_torch/tools/ab_kernels.py --parent DIR --kernels flash_attention

For each kernel it builds the parent's ``csrc/<name>.cu`` (with the
parent's headers), this checkout's and each variant of :data:`VARIANTS`
(a copy of ``csrc/`` with the edits applied), one ``nvcc`` each with
``_build.flags(name)``, all started together, into
``kernels/build/ab/``.  Each library is checked against the plain twin
at the timed shape, bitwise but for flash (``rglru_scan``: int32 views;
``decode_rows``: int64 views, NaNs by position), then all are timed by
CUDA events in
turns, the list forwards and then backwards, ``--rounds`` times, at the
main paths' shapes:

- ``rglru_scan``: B 4, S 4096, W 2560 fp32 (RecurrentGemma-2B's prefill);
- ``decode_rows``: 16 x 50M fp32, and 16 x 50M q8 deltas (int8, a scale
  per 1024, an fp64 base) into a (16, 50M) fp64 stack;
- ``flash_attention``: its bf16 (tensor-core) route at the five prefill
  shapes of :data:`FLASH_SHAPES` (``chip_smoke.FLASH_SERVE``,
  ``FLASH_SERVE_RG`` and three of ``FLASH_FAMILIES``), each library held
  to ``flash_attention_plain`` within 2e-2 (not bitwise: the kernels
  round differently), timed in turns with the library yardstick
  ``scaled_dot_product_attention`` beside them (``sdpa``; timed only);
  then its fp32 (CUDA-core) route at the same shapes on fp32 values, the
  parent's ``repro_flash_attention_f32``, this checkout's and the
  ``f32`` variants, each held to the twin within 2e-5, timed in turns
  beside ``sdpa`` on the fp32 values (the bf16 A/B skips the ``f32``
  variants, the fp32 A/B the others);
- ``scatter_wsum``: one site's 0xF5 frame in the federated LLM of
  ``chip_smoke.py`` (danube at 4 layers, 441,735,680 parameters, TopK at
  5%: 22,086,784 int8 values, a scale per 1024, at sorted unique indices
  into an fp64 accumulator of that size).  The indices are the port's
  TopK (``fl.flat.topk_indices``, as the 0xF5 encoder takes them) over a
  seeded normal tensor, since a real frame needs a training run.  Beside
  the libraries it times their floors (``floor_<variant>``; the parent's
  library has none), ``repro_scatter_floor``: the same read-modify-write
  of ``acc[idx[i]]`` at the same indices with a constant addend, and no
  values, scales or scale index.  Then the frame's three arrays' ways to
  the card, in turns (host clock, each ending in a sync): a pageable
  ``.to``, the fold's reused page-locked buffer
  (``agg_reduce.PinnedStage``), and the frame's own pages registered
  with ``cudaHostRegister``.

It prints the card's name and power limit, one JSON line per library
with its registers and spills (``ptxas -v``), and one JSON line per
kernel and shape with each library's times (ms per launch: every round's,
and their median) beside the bound of ``chip_smoke.py``; the same lines go
to ``--out``.
"""
import argparse
import concurrent.futures as cf
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", ".."))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src_torch"))

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import agg_reduce as A  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rglru_scan as RS  # noqa: E402

#: per kernel: variant name -> edits (old, new) of this checkout's source;
#: every edit must apply
VARIANTS = {
    "rglru_scan": {
        "cols64": [("kCols = 32;", "kCols = 64;")],
        "cols16": [("kCols = 32;", "kCols = 16;")],
        "stages4": [("kStages = 6;", "kStages = 4;")],
        "stages8": [("kStages = 6;", "kStages = 8;")],
        "stages12": [("kStages = 6;", "kStages = 12;")],
        "steps16_stages12": [("kSteps = 32;", "kSteps = 16;"),
                             ("kStages = 6;", "kStages = 12;")],
    },
    "scatter_wsum": {
        # more positions a lane, all its acc loads in flight at once
        "per2": [("kPer = 1;", "kPer = 2;")],
        "per4": [("kPer = 1;", "kPer = 4;")],
        "per16": [("kPer = 1;", "kPer = 16;"),
                  ("kWarps = 8;", "kWarps = 4;")],
        # 128-thread CTAs
        "warps4": [("kWarps = 8;", "kWarps = 4;")],
        # acc loads through L1 as well; acc stores evict-first
        "acc_l1": [("old[k] = __ldcg(a.acc + d[k]);",
                    "old[k] = a.acc[d[k]];")],
        "store_cs": [("if (at(k) < n) a.acc[d[k]] = old[k];",
                      "if (at(k) < n) __stcs(a.acc + d[k], old[k]);")],
    },
    "flash_attention": {
        # Q K^T, softmax and P V one after another at every head dim
        "no_overlap": [("return consumer_regs(hd) - (hd / 2 + 3 * "
                        "keys_for(hd) / 4) >= 32;", "return false;")],
        # timing probes, wrong by design (timed, never checked): the
        # softmax without its exp2s, and no softmax at all (the products,
        # the ring and the epilogue alone)
        "probe_no_exp2": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) '
                           ': "f"(x));', "y = x;")],
        "probe_products_only": [
            ("auto softmax = [&](int t0, float (&alpha)[2]) {",
             "auto softmax = [&](int t0, float (&alpha)[2]) {\n"
             "      alpha[0] = alpha[1] = 1.f;\n"
             "      if (t0 >= 0) return;")],
        # the fp32 route's timing probes: no exp2; no mask and no softmax
        # (P = S); no P V; no Q K^T
        "probe_f32_no_exp2": [("s[i][j] = exp2f(s[i][j] - mx);",
                               "s[i][j] = s[i][j] - mx;")],
        "probe_f32_no_softmax": [
            ("if (tc::edge_tile(t0, kKeys, q0, kRows, S, causal, window)) {",
             "if (t0 < 0) {"),
            ("for (int i = 0; i < kTR; ++i) {\n        float mx = m[i];",
             "for (int i = 0; i < 0; ++i) {\n        float mx = m[i];")],
        "probe_f32_no_pv": [("for (int n = 0; n < kKeys; ++n) {",
                             "for (int n = 0; n < 0; ++n) {")],
        "probe_f32_no_qk": [("for (int d = 0; d < kCols / 4; ++d) {",
                             "for (int d = 0; d < 0; ++d) {")],
    },
    "decode_rows": {
        # write-back stores (not evict-first)
        "store_wb": [("__stcs(op + c0 * V + e,", "__stwb(op + c0 * V + e,"),
                     ("__stcs(orow + j,", "__stwb(orow + j,")],
    },
}


def variant_sources(name: str, dest: str):
    """{variant: directory holding its ``<name>.cu`` and the headers}:
    ``new`` (this checkout's source) and each of :data:`VARIANTS`."""
    src = open(_build.CSRC / f"{name}.cu").read()
    dirs = {}
    for var, edits in [("new", [])] + list(VARIANTS[name].items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name} {var}: edit {old!r} does not apply")
            text = text.replace(old, new)
        d = os.path.join(dest, f"{name}-{var}")
        os.makedirs(d, exist_ok=True)
        for hdr in _build.CSRC.glob("*.cuh"):
            shutil.copy(hdr, d)
        with open(os.path.join(d, f"{name}.cu"), "w") as f:
            f.write(text)
        dirs[var] = d
    return dirs


def build(name: str, dirs: dict):
    """{variant: (loaded library, ptxas rows)}; one nvcc per variant, all
    started together."""
    procs = {}
    for var, d in dirs.items():
        so = os.path.join(d, f"lib{name}.so")
        procs[var] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.flags(name), "-o", so,
             os.path.join(d, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for var, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            if var in ("parent", "new"):
                raise RuntimeError(f"{name} {var}: nvcc failed\n{log}")
            print(json.dumps({"kernel": name, "variant": var,
                              "dropped": "nvcc failed", "log": log[-2000:]}),
                  flush=True)
            continue
        libs[var] = (ctypes.CDLL(so), CS._ptxas(log))
    return libs


def _checked(name: str, var: str, ok: bool) -> bool:
    """``ok``, or raise for the parent's and this checkout's kernel; a
    variant that disagrees with the twin is dropped with a note.  A
    ``probe_`` variant is wrong by design: it is timed, never checked."""
    if ok or var.startswith("probe_"):
        return True
    if var in ("parent", "new"):
        raise AssertionError(f"{name} {var} != twin")
    print(json.dumps({"kernel": name, "variant": var,
                      "dropped": "!= twin"}), flush=True)
    return False


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def rglru_call(lib):
    fn = lib.repro_rglru_scan
    fn.restype, fn.argtypes = ctypes.c_int, RS._ARGTYPES

    def call(a, b, h0, ys, hf):
        B, S, W = a.shape
        err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), ys.data_ptr(),
                 hf.data_ptr(), B, S, W, a.stride(0), a.stride(1),
                 b.stride(0), b.stride(1), h0.stride(0), _stream())
        if err:
            raise RuntimeError(f"rglru_scan launch: CUDA error {err}")
    return call


def decode_call(lib):
    fn = lib.repro_decode_rows
    argtypes, restype = A._SIGNATURES["decode_rows"]["repro_decode_rows"]
    fn.restype, fn.argtypes = restype, argtypes

    def call(data, out, scales, qchunk, base):
        err = fn(A._KIND[data.dtype], data.data_ptr(), A._ptr(scales),
                 int(qchunk), A._nscales(scales), A._ptr(base),
                 out.data_ptr(), data.shape[0], data.shape[1], _stream())
        if err:
            raise RuntimeError(f"decode_rows launch: CUDA error {err}")
    return call


def scatter_call(lib):
    fn = lib.repro_scatter_wsum
    argtypes, restype = A._SIGNATURES["scatter_wsum"]["repro_scatter_wsum"]
    fn.restype, fn.argtypes = restype, argtypes

    def call(acc, idx, vals, scales, w):
        err = fn(acc.data_ptr(), idx.data_ptr(), 0, vals.data_ptr(), 1,
                 scales.data_ptr(), A.DEFAULT_QCHUNK, 0, w, vals.numel(),
                 _stream())
        if err:
            raise RuntimeError(f"scatter_wsum launch: CUDA error {err}")
    return call


def floor_call(lib):
    fn = lib.repro_scatter_floor
    argtypes, restype = A._SIGNATURES["scatter_wsum"]["repro_scatter_floor"]
    fn.restype, fn.argtypes = restype, argtypes

    def call(acc, idx, add):
        err = fn(acc.data_ptr(), idx.data_ptr(), add, idx.numel(), _stream())
        if err:
            raise RuntimeError(f"scatter_floor launch: CUDA error {err}")
    return call


def federated_frame(seed: int = 21):
    """(n, indices, int8 values, fp32 scales) of one site's 0xF5 frame at
    the federated LLM's span, host numpy arrays: the TopK at
    ``chip_smoke.FED_FRAC`` of a seeded normal tensor of the model's
    size."""
    from repro_torch.fl.flat import topk_indices
    from repro_torch.models import build_model

    n = build_model(CS._fed_cfg()).param_count()
    k = max(1, int(np.ceil(CS.FED_FRAC * n)))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n, dtype=np.float32)
    np.abs(x, out=x)
    idx = topk_indices(x, k)
    del x
    vals = rng.integers(-127, 128, k, dtype=np.int8)
    scales = rng.uniform(1e-4, 1e-2, -(-k // A.DEFAULT_QCHUNK)) \
        .astype(np.float32)
    return n, idx, vals, scales


def _staging(frame_arrays, rounds: int) -> dict:
    """{way: [ms, one per turn]}: the frame's arrays to the card by a
    pageable copy, the fold's page-locked buffer, and registered pages."""
    cudart = torch.cuda.cudart()
    stage = A.PinnedStage()
    dev = torch.device("cuda")

    def pageable():
        return [A.to_device(a, dev) for a in frame_arrays]

    def pinned():
        return stage.to_device(frame_arrays, dev)

    def registered():
        host = [A._host_tensor(a) for a in frame_arrays]
        done = []
        try:
            for t in host:
                err = int(cudart.cudaHostRegister(
                    t.data_ptr(), t.numel() * t.element_size(), 0))
                if err != 0:
                    raise RuntimeError(f"cudaHostRegister: error {err}")
                done.append(t)
            out = [t.to(dev, non_blocking=True) for t in host]
            torch.cuda.synchronize()
        finally:
            for t in done:
                cudart.cudaHostUnregister(t.data_ptr())
        return out

    ways = {"pageable": pageable, "pinned_stage": pinned,
            "registered": registered}
    want = [torch.from_numpy(np.ascontiguousarray(a)) for a in frame_arrays]
    times = {w: [] for w in ways}
    for _ in range(rounds):
        for order in (list(ways), list(ways)[::-1]):
            for w in order:
                try:
                    ms, out = CS.sync_ms(ways[w])
                except RuntimeError as e:
                    times[w] = str(e)
                    continue
                if isinstance(times[w], list):
                    if not all(torch.equal(o.cpu(), t)
                               for o, t in zip(out, want)):
                        raise AssertionError(f"staging {w}: bytes differ")
                    times[w].append(ms)
                del out
    return times


def ab_scatter(libs: dict, card: str, rounds: int):
    n, idx_np, vals_np, scales_np = federated_frame()
    dev = torch.device("cuda")
    idx, vals, scales = (A.to_device(a, dev)
                         for a in (idx_np, vals_np, scales_np))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(442)
    acc0 = torch.randn(n, dtype=torch.float64, device=dev, generator=gen)
    w = 13.0
    want = acc0.clone()
    A.scatter_wsum_plain(want, idx, vals, w, scales=scales)
    acc = torch.empty_like(acc0)
    fns = {}
    for var, (lib, _) in libs.items():
        call = scatter_call(lib)
        acc.copy_(acc0)
        call(acc, idx, vals, scales, w)
        torch.cuda.synchronize()
        if not _checked("scatter_wsum", var, torch.equal(
                acc.view(torch.int64), want.view(torch.int64))):
            continue
        fns[var] = (lambda c: lambda: c(acc, idx, vals, scales, w))(call)
    del want, acc0
    for var, (lib, _) in libs.items():
        if var != "parent" and var in fns:
            fns[f"floor_{var}"] = (lambda f: lambda: f(acc, idx, 1.0))(
                floor_call(lib))
    times = in_turns(fns, rounds, reps=20)
    bound_ms, bound_by = CS.scatter_bound(idx.numel(), False, True,
                                          scales.numel())
    del acc, idx, vals, scales
    torch.cuda.empty_cache()
    staging = _staging((vals_np, scales_np, idx_np), rounds)
    return {"kernel": "scatter_wsum", "card": card,
            "shape": f"{idx_np.size} int8 values at unique TopK indices "
                     f"into {n} fp64",
            "bound_ms": bound_ms,
            "bound_by": bound_by, "bitwise": True,
            "median_ms": {k: statistics.median(v) for k, v in times.items()},
            "ms": times,
            "staging_ms": staging,
            "staging_median_ms": {k: statistics.median(v)
                                  for k, v in staging.items()
                                  if isinstance(v, list) and v},
            "staged_mb": (idx_np.nbytes + vals_np.nbytes
                          + scales_np.nbytes) / 1e6}


#: the entry point of the parent's flash library when it is the mma.sync
#: kernel's (one function, both dtypes)
_PARENT_FLASH = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 \
    + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12 \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def flash_call(lib, var: str):
    """call(q, k, v, out, causal, window): one bf16 launch of ``lib``'s
    tensor-core kernel: an mma.sync kernel's library through its one
    entry point, a TMA kernel's (this checkout's, its variants', a later
    parent's) through the wrapper's TMA path."""
    if not hasattr(lib, "repro_flash_attention_tc"):
        fn = lib.repro_flash_attention
        fn.restype, fn.argtypes = ctypes.c_int, _PARENT_FLASH

        def call(q, k, v, out, causal, window):
            B, S, H, hd = q.shape
            st = [s for t in (q, k, v, out) for s in t.stride()[:3]]
            err = fn(1, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), B, S, H, k.shape[2], *st, int(causal),
                     int(window), _stream())
            if err:
                raise RuntimeError(f"flash parent launch: error {err}")
        return call
    fn = lib.repro_flash_attention_tc
    fn.restype = ctypes.c_int
    fn.argtypes = FA._SIGNATURES["repro_flash_attention_tc"]

    def call(q, k, v, out, causal, window):
        err = FA.launch_tc(lib, q, k, v, out, causal, window, _stream())
        if err:
            raise RuntimeError(f"flash {var} launch: error {err}")
    return call


#: the bf16 prefill shapes the A/B times: danube (hd 80), RecurrentGemma
#: (hd 256), granite-moe (hd 64), qwen3 (hd 128), Whisper's encoder (hd 64,
#: non-causal)
FLASH_SHAPES = {"hd80": CS.FLASH_SERVE, "hd256": CS.FLASH_SERVE_RG,
                "hd64": CS.FLASH_FAMILIES["granite-moe-1b-a400m"],
                "hd128": CS.FLASH_FAMILIES["qwen3-32b"],
                "hd64_noncausal": CS.FLASH_FAMILIES["whisper-medium"]}


def f32_call(lib, var: str):
    """call(q, k, v, out, causal, window): one fp32 launch of ``lib``'s
    CUDA-core kernel (the parent's and this checkout's share the entry
    point)."""
    fn = lib.repro_flash_attention_f32
    fn.restype = ctypes.c_int
    fn.argtypes = FA._SIGNATURES["repro_flash_attention_f32"]

    def call(q, k, v, out, causal, window):
        B, S, H, hd = q.shape
        st = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        err = fn(hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, S, H, k.shape[2], *st, int(causal),
                 int(window), _stream())
        if err:
            raise RuntimeError(f"flash f32 {var} launch: error {err}")
    return call


def ab_flash(libs: dict, card: str, rounds: int, dtype=torch.bfloat16):
    """One route of each library against ``flash_attention_plain`` within
    ``chip_smoke.FLASH_TOL`` at each shape of :data:`FLASH_SHAPES`, then
    all timed in turns with the library yardstick
    ``scaled_dot_product_attention`` (as ``chip_smoke.phase_flash_timing``
    calls it) on the same values beside them.  bf16: the tensor-core
    kernel, its bound the bf16 tensor cores' (the ``f32`` variants
    skipped); fp32: the CUDA-core kernel, its bound the fp32 CUDA cores'
    (only the ``f32`` variants beside the parent's and this one)."""
    route = FA.flash_route(dtype)
    f32 = route == "cuda_core"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(31 if f32 else 30)
    tol = CS.FLASH_TOL[dtype]
    rows = []
    for tag, f in FLASH_SHAPES.items():
        q, k, v = CS._flash_inputs(gen, f["B"], f["S"], f["H"], f["KV"],
                                   f["hd"], dtype, dev)
        causal, window = f["causal"], f["window"]
        twin = FA.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        out = torch.empty_like(q)
        fns, errs = {}, {}
        for var, (lib, _) in libs.items():
            if var not in ("parent", "new") and ("f32" in var) != f32:
                continue
            call = (f32_call if f32 else flash_call)(lib, var)
            out.fill_(float("nan"))
            call(q, k, v, out, causal, window)
            torch.cuda.synchronize()
            err, exc = CS._excess(out, twin, tol)
            errs[var] = err
            if not _checked(f"flash_attention {route}", var, exc <= 1.0):
                continue
            fns[var] = (lambda c: lambda: c(q, k, v, out, causal,
                                            window))(call)
        del twin
        mask = CS.flash_mask(f["S"], causal, window, dev)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fns["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=1.0, enable_gqa=True)
        torch.use_deterministic_algorithms(False)
        try:
            times = in_turns(fns, rounds, reps=3 if f32 else 20)
        finally:
            torch.use_deterministic_algorithms(True)
        bound = CS.flash_bound(f["B"], f["S"], f["H"], f["KV"], f["hd"],
                               window, causal, dtype.itemsize)
        bound_ms, bound_by = (bound[2], "operations") if f32 else bound[:2]
        med = {n: statistics.median(t) for n, t in times.items()}
        rows.append({"kernel": "flash_attention", "route": route,
                     "card": card, "shape": tag, "dims": f,
                     "bound_ms": bound_ms, "bound_by": bound_by, "tol": tol,
                     "max_abs_vs_twin": errs, "median_ms": med,
                     "share_of_bound": {n: bound_ms / m
                                        for n, m in med.items()},
                     "over_sdpa": {n: m / med["sdpa"]
                                   for n, m in med.items()},
                     "ms": times})
        del q, k, v, out, qt, kt, vt, mask
        torch.cuda.empty_cache()
    return rows


def in_turns(fns: dict, rounds: int, reps: int) -> dict:
    """{name: [ms per launch, one per turn]}: every fn timed by
    ``chip_smoke.event_ms``, the names forwards then backwards, ``rounds``
    times."""
    names = list(fns)
    times = {n: [] for n in names}
    for _ in range(rounds):
        for order in (names, names[::-1]):
            for n in order:
                times[n].append(CS.event_ms(fns[n], reps=reps))
    return times


def ab_rglru(libs: dict, card: str, rounds: int):
    r = CS.RGLRU_SERVE
    B, S, W = r["B"], r["S"], r["W"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4096)
    a, b, h0 = CS._rglru_inputs(gen, B, S, W, "cuda", False)
    want, _ = RS.rglru_scan_plain(a, b, h0)
    ys = torch.empty_like(want)
    hf = torch.empty_like(h0)
    fns = {}
    for var, (lib, _) in libs.items():
        call = rglru_call(lib)
        ys.fill_(float("nan"))
        call(a, b, h0, ys, hf)
        torch.cuda.synchronize()
        if not _checked("rglru_scan", var, torch.equal(
                ys.view(torch.int32), want.view(torch.int32))):
            continue
        fns[var] = (lambda c: lambda: c(a, b, h0, ys, hf))(call)
    times = in_turns(fns, rounds, reps=20)
    bound_ms, bound_by = CS.rglru_bound(B, S, W)
    return {"kernel": "rglru_scan", "card": card,
            "shape": f"B{B} S{S} W{W} fp32", "bound_ms": bound_ms,
            "bound_by": bound_by, "bitwise": True,
            "median_ms": {k: statistics.median(v)
                          for k, v in times.items()},
            "ms": times}


def ab_decode(libs: dict, card: str, rounds: int):
    n = CS.LEAF * CS.NLEAVES
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    out = torch.empty((CS.CLIENTS, n), dtype=torch.float64, device="cuda")
    rows = []
    for kind in ("float32", "int8_base"):
        data, kw = CS._robust_inputs(gen, kind, CS.CLIENTS, n, "cuda", False)
        want = A.decode_rows_plain(data, **kw)
        fns = {}
        for var, (lib, _) in libs.items():
            call = decode_call(lib)
            out.fill_(float("nan"))
            call(data, out, kw["scales"], kw["qchunk"], kw["base"])
            torch.cuda.synchronize()
            if not _checked("decode_rows", var, CS._bits_equal(out, want)):
                continue
            fns[var] = (lambda c: lambda: c(data, out, kw["scales"],
                                            kw["qchunk"], kw["base"]))(call)
        del want
        times = in_turns(fns, rounds, reps=5)
        nsc = 0 if kw["scales"] is None else kw["scales"].shape[1]
        bound_ms, bound_by = CS.decode_bound(
            CS.CLIENTS, n, data.element_size(), base=kw["base"] is not None,
            nscales=nsc)
        rows.append({"kernel": "decode_rows", "card": card,
                     "shape": f"{CS.CLIENTS}x{n} {kind}",
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bitwise": True,
                     "median_ms": {k: statistics.median(v)
                                   for k, v in times.items()},
                     "ms": times})
        del data, kw
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="an unpacked checkout of the parent commit")
    ap.add_argument("--kernels", nargs="+",
                    default=["rglru_scan", "decode_rows"])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(
        _build.BUILD_DIR, "ab", "ab_kernels.jsonl"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dest = os.path.join(_build.BUILD_DIR, "ab")
    parent_csrc = os.path.join(args.parent, "src_torch", "repro_torch",
                               "kernels", "csrc")
    dirs = {}
    for name in args.kernels:
        pdir = os.path.join(dest, f"{name}-parent")
        os.makedirs(pdir, exist_ok=True)
        for f in os.listdir(parent_csrc):
            if f.endswith(".cuh") or f == f"{name}.cu":
                shutil.copy(os.path.join(parent_csrc, f), pdir)
        dirs[name] = {"parent": pdir, **variant_sources(name, dest)}
    t0 = time.perf_counter()
    # one thread per kernel, each starting all its variants' nvcc at once
    with cf.ThreadPoolExecutor(len(args.kernels)) as ex:
        built = dict(zip(args.kernels, ex.map(
            lambda n: build(n, dirs[n]), args.kernels)))
    lines = [{"phase": "build", "card": card,
              "nvcc_s": time.perf_counter() - t0}]
    for name, libs in built.items():
        for var, (_, rows) in libs.items():
            lines.append({"kernel": name, "variant": var, "ptxas": rows})
    for line in lines:
        print(json.dumps(line), flush=True)
    results = []
    if "rglru_scan" in built:
        results.append(ab_rglru(built["rglru_scan"], card, args.rounds))
    if "decode_rows" in built:
        results += ab_decode(built["decode_rows"], card, args.rounds)
    if "scatter_wsum" in built:
        results.append(ab_scatter(built["scatter_wsum"], card, args.rounds))
    if "flash_attention" in built:
        for dtype in (torch.bfloat16, torch.float32):
            results += ab_flash(built["flash_attention"], card, args.rounds,
                                dtype)
    for line in results:
        print(json.dumps(line), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for line in lines + results:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
