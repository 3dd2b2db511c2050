"""Flash attention (causal / GQA / sliding-window) as hand-written Hopper
kernels, replacing the Pallas TPU kernel
``repro/kernels/flash_attention.py:94``.

- :func:`flash_attention` on a CUDA tensor launches one of two kernels of
  ``csrc/flash_attention.cu`` (built by ``nvcc`` for ``sm_90a`` at first
  use, see :mod:`repro_torch.kernels._build`) or raises; it never falls
  back.  The route is chosen by dtype alone (:func:`flash_route`): bf16
  runs on the tensor cores (``mma.sync`` with fp32 accumulation, P rounded
  to bf16 for the value product), fp32 on the CUDA cores.  On a CPU tensor
  it runs :func:`flash_attention_plain`.
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

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: a shared-memory row's padding in elements, in the tensor-core kernel
#: (``tc::`` in ``csrc/flash_attention.cu``)
TC_PAD = 8
#: the shared memory one block may use on Hopper, in bytes
SMEM_LIMIT = 232_448


def flash_route(dtype: torch.dtype) -> str:
    """The route a CUDA tensor of ``dtype`` takes: ``"tensor_core"`` for
    bf16, ``"cuda_core"`` for fp32; other dtypes raise."""
    if dtype not in ROUTES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, not "
                        f"{dtype}")
    return ROUTES[dtype]


def tc_keys(hd: int) -> int:
    """Keys per K / V tile of the tensor-core kernel at head dim ``hd``."""
    return 32 if hd > 128 else 64


def tc_rows(hd: int) -> int:
    """Query rows per CTA of the tensor-core kernel at head dim ``hd``:
    4 warps of two 16-row tiles up to hd 80, of one above."""
    return 4 * 16 * (2 if hd <= 80 else 1)


def tc_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of the tensor-core kernel at head dim ``hd``:
    the Q block and two stages of K and V tiles, bf16 rows padded by
    :data:`TC_PAD` elements (``tc::smem_bytes``)."""
    return (tc_rows(hd) + 4 * tc_keys(hd)) * (hd + TC_PAD) * 2


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
    if route == "tensor_core":
        # cp.async copies 16-byte chunks: rows must start on 16 bytes
        q, k, v = (t if _rows_aligned(t) else t.contiguous()
                   for t in (q, k, v))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if q.numel() == 0:
        return out
    lib = _kernel_lib()
    st = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_flash_attention(
            _DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, S, H, KV, *st, int(bool(causal)), int(window),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention.{route}"] += 1
    return out


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every (batch, position, head) row of ``t`` starts on 16 bytes."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s % step == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


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
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I] + [_LL] * 12 \
    + [_I, _I, _P]


def _kernel_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = _ARGTYPES
        lib.repro_flash_tc_smem_bytes.restype = _I
        lib.repro_flash_tc_smem_bytes.argtypes = [_I]
    return lib
