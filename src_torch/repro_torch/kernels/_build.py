"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes one shared
library, ``build/lib<name>-<hash>.so``, where the hash covers the source,
the shared headers ``csrc/*.cuh`` and the flags; a library already built
for the same source is reused.  The
build runs at first use, on the machine with the card; nothing here runs
at import time, so the package imports where there is no ``nvcc``.

Flags (:func:`flags`): every source builds for ``sm_90a`` (Hopper) without
``--use_fast_math`` (subnormals are kept, divides and ``exp2f`` are the
accurate ones).  The aggregation kernels (``weighted_sum``,
``sort_reduce``, ``gram``, ``scatter_wsum``, ``decode_rows``),
``secagg_mask`` and
``rglru_scan`` also take ``-fmad=false``: they must round every product and
sum on its own, because they are held bitwise against the numpy engine or
their twin.  ``flash_attention`` is held to a tolerance, so it lets
``nvcc`` contract a multiply and an add into one FMA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
#: flags each source adds to :data:`NVCC_FLAGS`; every source is listed
SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {
    "weighted_sum": ("-fmad=false",),
    "sort_reduce": ("-fmad=false",),
    "gram": ("-fmad=false",),
    "flash_attention": (),
    "rglru_scan": ("-fmad=false",),
    "scatter_wsum": ("-fmad=false",),
    "secagg_mask": ("-fmad=false",),
    "decode_rows": ("-fmad=false",),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: per kernel source: the compiler's log of its last build (ptxas -v lines)
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH,
    then ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on the machine with the card")


def flags(name: str) -> Tuple[str, ...]:
    """The ``nvcc`` flags ``csrc/<name>.cu`` is built with."""
    if name not in SOURCE_FLAGS:
        raise KeyError(f"no build flags for kernel source {name!r}")
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def _target(name: str) -> Path:
    """``build/lib<name>-<hash>.so``; the hash covers the source, every
    shared header in ``csrc/`` and the source's flags."""
    h = hashlib.sha256(" ".join(flags(name)).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str]) -> List[Path]:
    """The shared libraries of ``csrc/<name>.cu`` for each name, compiled
    unless current ones exist: one ``nvcc`` per source, all started
    together.  Raises with the compiler's output when one fails."""
    targets = [_target(n) for n in names]
    jobs = []
    for name, target in zip(names, targets):
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, tmp, proc))
    failed = []
    for name, target, tmp, proc in jobs:
        BUILD_LOG[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{BUILD_LOG[name]}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return targets


def build(name: str) -> Path:
    """The shared library of ``csrc/<name>.cu`` (see :func:`build_all`)."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib
