"""A/B of two kernels' designs on the card: a parent commit's kernel, this
checkout's, and variants of this checkout's (string edits of its source),
timed in turns in one process on one card.

Run from the root of a checkout on a machine with one NVIDIA H100, with
the parent commit unpacked beside it (``git archive <parent> | tar -x -C
DIR``):

    python3 src_torch/tools/ab_kernels.py --parent DIR
    python3 src_torch/tools/ab_kernels.py --parent DIR --kernels decode_rows

For each kernel it builds the parent's ``csrc/<name>.cu`` (with the
parent's headers), this checkout's and each variant of :data:`VARIANTS`
(a copy of ``csrc/`` with the edits applied), one ``nvcc`` each with
``_build.flags(name)``, all started together, into
``kernels/build/ab/``.  Each library is checked bitwise against the plain
twin at the timed shape (``rglru_scan``: int32 views; ``decode_rows``:
int64 views, NaNs by position), then all are timed by CUDA events in
turns, the list forwards and then backwards, ``--rounds`` times, at the
main paths' shapes:

- ``rglru_scan``: B 4, S 4096, W 2560 fp32 (RecurrentGemma-2B's prefill);
- ``decode_rows``: 16 x 50M fp32, and 16 x 50M q8 deltas (int8, a scale
  per 1024, an fp64 base) into a (16, 50M) fp64 stack.

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

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", ".."))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src_torch"))

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import agg_reduce as A  # noqa: E402
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
    variant that disagrees with the twin is dropped with a note."""
    if ok:
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
    for line in results:
        print(json.dumps(line), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for line in lines + results:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
