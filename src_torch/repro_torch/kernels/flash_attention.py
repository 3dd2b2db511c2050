"""Flash attention (causal / GQA / sliding-window) as hand-written Hopper
kernels, replacing the Pallas TPU kernel
``repro/kernels/flash_attention.py:94``.

- :func:`flash_attention` on a CUDA tensor launches one of two kernels of
  ``csrc/flash_attention.cu`` (built by ``nvcc`` for ``sm_90a`` at first
  use, see :mod:`repro_torch.kernels._build`) or raises; it never falls
  back.  The route is chosen by dtype alone (:func:`flash_route`): bf16
  runs on the tensor cores (Hopper's ``wgmma`` with fp32 accumulation, fed
  by TMA through an ``mbarrier`` ring by a producer warp, two or three
  consumer warpgroups, a persistent grid; P rounded to bf16 for the value
  product), fp32 on the CUDA cores (fp32 FMAs in register tiles fed by
  ``cp.async`` through a ring of K / V tiles in shared memory, one CTA a
  query block).  On a CPU tensor it runs :func:`flash_attention_plain`.
- The tensor-core kernel's tiles (:func:`tc_rows`, :func:`tc_keys`,
  :data:`TC_STAGES`, :func:`tc_slab`, :func:`tc_padded`,
  :func:`tc_smem_bytes`, :func:`tc_registers`) are mirrored here in
  Python, and its TMA tensor maps are computed here (:func:`tma_params`:
  dims, byte strides and box, checked against TMA's rules and encoded by
  the library), so that the CPU tests check them.  So are the CUDA-core
  kernel's (:func:`f32_rows`, :func:`f32_keys`, :data:`F32_STAGES`,
  :func:`f32_threads`, :func:`f32_colgroups`, :func:`f32_slices`,
  :func:`f32_strides`, :func:`f32_smem_bytes`).
- :func:`flash_attention_plain` is the twin: plain PyTorch in the Pallas
  kernel's arithmetic -- the reference's block rule (:func:`_choose_block`,
  the sequence padded to the blocks' lcm), an fp32 online softmax over kv
  blocks with the same masks and guards, the output cast back to the input
  dtype.  Blocks that lie wholly outside the causal / window band are
  skipped; visiting one would leave ``m``, ``l`` and ``acc`` as they were.

q is ``(B, S, H, hd)`` and already scaled by ``1/sqrt(hd)``; k and v are
``(B, S, KV, hd)``; the kv head of q head ``h`` is ``h // (H // KV)``.  A
key at ``kp`` is visible from the query at ``qp`` when ``kp <= qp``
(``causal``) and ``kp > qp - window`` (``window != 0``).  A row whose every
key is masked gives 0.  Both paths take fp32 and bf16 and the head dims of
:data:`HEAD_DIMS`; anything else raises, on either device, so that what the
card refuses is refused on the CPU too.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.ref import NEG_INF

#: head dims the kernel is instantiated for: 80 (H2O-Danube), 256
#: (RecurrentGemma's local attention), 64 and 128 (the repo's other
#: attention configs) and 16 and 32 (their smoke variants: 16 is
#: Yi-34B's, the serving launcher's default)
HEAD_DIMS = (16, 32, 64, 80, 128, 256)

#: the kernel each input dtype runs on the card: bf16 on the tensor cores,
#: fp32 on the CUDA cores (no bf16 or TF32 product holds fp32's tolerance)
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}

#: kernel launches of the wrapper, in all and per route; the main path's
#: runs read them
LAUNCHES = {"flash_attention": 0,
            **{f"flash_attention.{r}": 0 for r in ROUTES.values()}}

_DTYPES = (torch.float32, torch.bfloat16)

#: the tensor-core kernel's tiles start on this many bytes: the 128-byte
#: swizzle's atom (8 rows of 128 bytes), which TMA and wgmma both need
TC_ALIGN = 1024
#: the tensor-core kernel's mbarriers, after its tiles, in bytes
TC_BARRIER_BYTES = 128
#: the shared memory one block may use on Hopper, in bytes
SMEM_LIMIT = 232_448
#: stages of the tensor-core kernel's K / V ring (``tc::kStages``)
TC_STAGES = 2
#: a head-dim slab's width in bf16 columns -> TMA's swizzle of it (bytes):
#: the swizzle spans exactly one slab's row
TC_SWIZZLE = {16: 32, 32: 64, 64: 128}


def flash_route(dtype: torch.dtype) -> str:
    """The route a CUDA tensor of ``dtype`` takes: ``"tensor_core"`` for
    bf16, ``"cuda_core"`` for fp32; other dtypes raise."""
    if dtype not in ROUTES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, not "
                        f"{dtype}")
    return ROUTES[dtype]


def tc_keys(hd: int) -> int:
    """Keys per K / V tile of the tensor-core kernel at head dim ``hd``:
    128, or 64 at hd 256 (its O accumulator alone is 128 registers a
    thread)."""
    return 64 if hd > 128 else 128


def tc_rows(hd: int) -> int:
    """Query rows per CTA of the tensor-core kernel at head dim ``hd``: a
    consumer warpgroup's 64 each, three warpgroups up to hd 80 and two
    above (``tc::consumers_for``)."""
    return 192 if hd <= 80 else 128


def tc_registers(hd: int) -> tuple:
    """``(producer, consumer)`` registers a thread of the tensor-core
    kernel after ``setmaxnreg`` at head dim ``hd``: the producer warpgroup
    and the ``tc_rows(hd) // 64`` consumer warpgroups share the SM's 64K
    registers, so one CTA runs per SM (``tc::producer_regs``,
    ``tc::consumer_regs``)."""
    return (24, 240) if tc_rows(hd) == 128 else (32, 160)


def tc_slab(hd: int) -> int:
    """Columns of one swizzled head-dim slab of the tensor-core kernel's
    tiles: 64 (128-byte swizzle), or a narrower head dim's own width (16
    or 32: 32- or 64-byte swizzle)."""
    return min(hd, 64)


def tc_padded(hd: int) -> int:
    """The head dim in whole slabs: hd 80 takes two 64-column slabs, TMA
    zero-filling the second past column 80 (it reads no bytes there)."""
    return -(-hd // tc_slab(hd)) * tc_slab(hd)


def tc_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of the tensor-core kernel at head dim ``hd``:
    alignment slack, the Q block, :data:`TC_STAGES` stages of K and V
    tiles, and the barriers (``tc::smem_bytes``)."""
    return (TC_ALIGN + (tc_rows(hd) + 2 * TC_STAGES * tc_keys(hd))
            * tc_padded(hd) * 2 + TC_BARRIER_BYTES)


#: K / V tile pairs in the CUDA-core (fp32) kernel's ``cp.async`` ring
#: (``f32::kStages``): 2 * F32_STAGES slots, taking K_0, V_0, K_1, V_1, ...
#: in turn (at hd 256 each as :func:`f32_slices` column slices)
F32_STAGES = 2


def f32_threads(hd: int) -> int:
    """Threads a CTA of the CUDA-core kernel: 256, or 128 at hd 64 and 80,
    where two CTAs share an SM (``f32::threads_for``)."""
    return 128 if hd in (64, 80) else 256


def f32_colgroups(hd: int) -> int:
    """Threads of the CUDA-core kernel that share a query row: 8; 4 where
    an eighth of the head dim is not whole float4s (hd 16, 80); 16 above
    hd 80 (``f32::colgroups_for``)."""
    if hd in (16, 80):
        return 4
    return 16 if hd > 80 else 8


def f32_slices(hd: int) -> int:
    """Column slices the CUDA-core kernel copies and consumes a K / V tile
    in: 2 at hd 256, so that its ring holds 64-key tiles beside the Q
    block, else 1 (``f32::slices_for``)."""
    return 2 if hd > 128 else 1


def f32_rows(hd: int) -> int:
    """Query rows per CTA of the CUDA-core kernel: 128, or 64 at hd 256
    (``f32::rows_for``)."""
    return 64 if hd > 128 else 128


def f32_keys(hd: int) -> int:
    """Keys per K / V tile of the CUDA-core kernel: 64; 48 at hd 128 and
    32 for a 128-thread CTA, the most the ring holds (``f32::keys_for``)."""
    if f32_slices(hd) > 1:
        return 64
    if f32_threads(hd) == 128:
        return 32
    return 48 if hd > 80 else 64


def f32_strides(hd: int) -> tuple:
    """``(q, kv, p)``: floats between two rows of the CUDA-core kernel's Q
    block and of a K / V slice (the columns and one float4 of padding), and
    between two keys of its transposed P tile (the rows and 4 or 8 floats)
    (``f32::q_stride``, ``f32::kv_stride``, ``f32::p_stride``)."""
    return (hd + 4, hd // f32_slices(hd) + 4,
            f32_rows(hd) + (8 if f32_colgroups(hd) == 4 else 4))


def f32_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of the CUDA-core kernel at head dim ``hd``:
    the Q block, 2 * :data:`F32_STAGES` K / V slices, the P tile, fp32
    (``f32::smem_bytes``)."""
    qs, ks, ps = f32_strides(hd)
    keys = f32_keys(hd)
    return 4 * (f32_rows(hd) * qs + 2 * F32_STAGES * keys * ks + keys * ps)


def tma_params(t: torch.Tensor, rows: int) -> tuple:
    """``(dims, strides, box)`` of the TMA tensor map of ``t`` ``(B, S,
    heads, hd)``, bf16, for tiles of ``rows`` rows: dims ``(hd, S, heads,
    B)`` innermost first; ``strides`` in bytes for dims 1-3 (a dim of size
    1 is never stepped: it gets 16); the box one slab (:func:`tc_slab`) by
    ``rows`` rows, loaded once per slab.
    Raises where TMA's rules do not hold (:func:`_rows_aligned` says
    whether a view passes)."""
    B, S, Hh, hd = t.shape
    es = t.element_size()
    w = tc_slab(hd)
    dims = (hd, S, Hh, B)
    strides = tuple(st * es if n > 1 else 16 for st, n in (
        (t.stride(1), S), (t.stride(2), Hh), (t.stride(0), B)))
    box = (w, rows, 1, 1)
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        raise ValueError("TMA needs a contiguous head dim and a 16-byte "
                         "aligned base")
    if any(st <= 0 or st % 16 or st >= 1 << 40 for st in strides):
        raise ValueError(f"TMA needs byte strides that are positive "
                         f"multiples of 16 below 2**40, not {strides}")
    if any(not 1 <= x <= 256 for x in box) or w * es > TC_SWIZZLE[w]:
        raise ValueError(f"TMA box {box} out of bounds")
    return dims, strides, box


def _choose_block(S: int, requested: int) -> int:
    """The reference's block rule: the largest divisor of ``S`` that is
    <= ``requested`` and a multiple of 8, else ``min(requested, S)`` with
    the sequence padded up to a multiple of it."""
    b = max(1, min(requested, S))
    if S % b == 0:
        return b
    for cand in range(b, 7, -1):
        if S % cand == 0 and cand % 8 == 0:
            return cand
    return b


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, heads, hd)")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one of {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = 512, block_kv: int = 512) -> torch.Tensor:
    """Attention of pre-scaled ``q`` over ``k``, ``v``: ``(B, S, H, hd)``
    in q's dtype.  The kernel on a CUDA tensor, the twin on a CPU one.
    ``block_q`` / ``block_kv`` are the reference's requested blocks: the
    twin follows them, the kernels have tiles of their own."""
    _check(q, k, v)
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"block_q={block_q} and block_kv={block_kv} must "
                         "be positive")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_kv=block_kv)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    route = flash_route(q.dtype)
    q, k, v = (_readable(t) for t in (q, k, v))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if q.numel() == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "tensor_core":
            err = launch_tc(lib, q, k, v, out, causal, window, stream)
        else:
            st = [s for t in (q, k, v, out) for s in t.stride()[:3]]
            err = lib.repro_flash_attention_f32(
                hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, H, KV, *st, int(bool(causal)), int(window), stream)
    if err < 0:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled "
                           f"failed: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention.{route}"] += 1
    return out


def launch_tc(lib: ctypes.CDLL, q, k, v, out, causal: bool, window: int,
              stream: int) -> int:
    """One launch of ``lib``'s tensor-core kernel on bf16 CUDA tensors
    that pass :func:`_rows_aligned`, into ``out`` (contiguous); returns the
    library's error code (0, a CUDA error, or a CUresult negated)."""
    B, S, H, hd = q.shape
    plans = [tma_params(q, tc_rows(hd))] + [
        tma_params(t, tc_keys(hd)) for t in (k, v)]
    dims = (ctypes.c_ulonglong * 12)(*(x for p in plans for x in p[0]))
    strides = (ctypes.c_ulonglong * 9)(*(x for p in plans for x in p[1]))
    box = (ctypes.c_uint * 12)(*(x for p in plans for x in p[2]))
    return lib.repro_flash_attention_tc(
        hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
        H, k.shape[2], dims, strides, box, *out.stride()[:3],
        int(bool(causal)), int(window), stream)


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` as both kernels read it: itself where its rows pass
    :func:`_rows_aligned` (TMA and 16-byte ``cp.async`` copies read rows
    from a 16-byte aligned base at strides of 16 bytes), else a contiguous
    copy."""
    return t if _rows_aligned(t) else t.contiguous()


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every (batch, position, head) row of ``t`` starts on 16 bytes, and
    the axes TMA steps have positive strides below 2**40 bytes: TMA's rules
    on a tensor map's base and strides (:func:`tma_params`), which also
    cover the CUDA-core kernel's 16-byte ``cp.async`` copies."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s > 0 and s * es % 16 == 0 and s * es < 1 << 40
        for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          block_q: int = 512, block_kv: int = 512
                          ) -> torch.Tensor:
    """The kernel's twin, in the Pallas kernel's arithmetic (see the module
    docstring).  Takes any head dim; ``block_q`` / ``block_kv`` are the
    reference's requested blocks."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    hdv = v.shape[-1]
    bq = _choose_block(S, block_q)
    bk = _choose_block(S, block_kv)
    lcm = math.lcm(bq, bk)
    s_pad = -(-S // lcm) * lcm
    dev = q.device
    # (B, KV, g, S, hd): q head h = kv * g + j reads kv head h // g
    qf = q.float().permute(0, 2, 1, 3).reshape(B, KV, g, S, hd)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    if s_pad != S:
        pad = (0, 0, 0, s_pad - S)
        qf = torch.nn.functional.pad(qf, pad)
        kf = torch.nn.functional.pad(kf, pad)
        vf = torch.nn.functional.pad(vf, pad)
    out = torch.empty((B, KV, g, s_pad, hdv), dtype=torch.float32,
                      device=dev)
    for qs in range(0, s_pad, bq):
        qpos = torch.arange(qs, qs + bq)[:, None]
        qb = qf[:, :, :, qs:qs + bq]                   # (B, KV, g, bq, hd)
        m = torch.full((B, KV, g, bq, 1), NEG_INF, device=dev)
        l = torch.zeros((B, KV, g, bq, 1), device=dev)
        acc = torch.zeros((B, KV, g, bq, hdv), device=dev)
        for ks in range(0, s_pad, bk):
            kpos = torch.arange(ks, ks + bk)[None, :]
            mask = kpos < S                # padded kv positions contribute 0
            if causal:
                mask = mask & (kpos <= qpos)
            if window:
                mask = mask & (kpos > qpos - window)
            if not bool(mask.any()):
                continue                   # a no-op step: m, l, acc unchanged
            mask = mask.to(dev)
            s = qb @ kf[:, :, None, ks:ks + bk].transpose(-1, -2)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            # guard fully-masked rows (exp(NEG_INF - NEG_INF) would be 1)
            row_any = mask.any(dim=-1, keepdim=True)
            p = torch.where(row_any, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = alpha * acc + p @ vf[:, :, None, ks:ks + bk]
            m = m_new
        out[:, :, :, qs:qs + bq] = acc / torch.clamp(l, min=1e-30)
    out = out.reshape(B, H, s_pad, hdv)[:, :, :S]
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous()


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_flash_attention_f32": [_I, _P, _P, _P, _P, _I, _I, _I, _I]
    + [_LL] * 12 + [_I, _I, _P],
    "repro_flash_attention_tc": [_I, _P, _P, _P, _P, _I, _I, _I, _I,
                                 ctypes.POINTER(ctypes.c_ulonglong),
                                 ctypes.POINTER(ctypes.c_ulonglong),
                                 ctypes.POINTER(ctypes.c_uint)]
    + [_LL] * 3 + [_I, _I, _P],
    "repro_flash_tc_smem_bytes": [_I],
    "repro_flash_tc_plan": [_I, ctypes.POINTER(ctypes.c_int)],
    "repro_flash_f32_smem_bytes": [_I],
    "repro_flash_f32_plan": [_I, ctypes.POINTER(ctypes.c_int)],
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument types of this source's C functions set."""
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.restype = _I
            fn.argtypes = argtypes
    return lib


def _kernel_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    return bind(_build.load("flash_attention"))
