"""Client-side app layer (Flower analogue, paper Listing 2).

    class MyClient(NumPyClient):
        def fit(self, parameters, config): ...
        def evaluate(self, parameters, config): ...

    def client_fn(cid): return MyClient(cid).to_client()
    app = ClientApp(client_fn=client_fn, mods=[DPMod(...)])

``ClientApp.handle(bytes) -> bytes`` is the entire transport contract —
which is what lets the SAME app object run natively or inside the FLARE
runtime with no code changes (the paper's core claim).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fl.flat import FlatParams, QuantParams, quantizable
from repro_torch.fl.messages import (BF16_MAGIC, FLAT_MAGIC, Q8_MAGIC,
                                     QUANT_CODECS, WIRE_CODECS, EvaluateIns,
                                     EvaluateRes, FitIns, FitRes, TaskIns,
                                     TaskRes, decode_evaluate_ins,
                                     decode_fit_ins, decode_fit_res,
                                     decode_task_ins, encode_evaluate_res,
                                     encode_fit_res, encode_properties_res,
                                     encode_task_res, arrays_to_bytes,
                                     peek_config, peek_params)

NDArrays = List[np.ndarray]


class NumPyClient:
    """Subclass and override fit / evaluate / get_parameters."""

    context: Dict[str, Any] = {}

    def get_parameters(self, config: Dict[str, Any]) -> NDArrays:
        raise NotImplementedError

    def get_properties(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Site capabilities/metadata; the ClientApp merges in the wire
        codecs this build speaks (``{"codecs": [...]}``) so the server can
        negotiate a compressed payload encoding."""
        return {}

    def fit(self, parameters: NDArrays, config: Dict[str, Any]
            ) -> Tuple[NDArrays, int, Dict[str, Any]]:
        raise NotImplementedError

    def trainable_ranges(self) -> Optional[Sequence[Tuple[int, int]]]:
        """Adapter/LoRA mode for the negotiated ``sparse`` codec: sorted,
        non-overlapping ``[start, stop)`` element ranges into the flat
        fp32 math vector that this client actually trains.  When set,
        a sparse fit result ships ONLY those coordinate ranges (0xF5
        ranges mode) instead of the TopK of the delta.  ``None`` (the
        default) means every coordinate is trainable — TopK mode."""
        return None

    def evaluate(self, parameters: NDArrays, config: Dict[str, Any]
                 ) -> Tuple[float, int, Dict[str, Any]]:
        raise NotImplementedError

    def to_client(self) -> "Client":
        return Client(self)


class Client:
    """Byte-level client wrapper."""

    def __init__(self, numpy_client: NumPyClient):
        self.np_client = numpy_client

    def handle_fit(self, ins: FitIns) -> FitRes:
        params, n, metrics = self.np_client.fit(ins.parameters, ins.config)
        return FitRes(params, n, metrics)

    def handle_evaluate(self, ins: EvaluateIns) -> EvaluateRes:
        loss, n, metrics = self.np_client.evaluate(ins.parameters, ins.config)
        return EvaluateRes(loss, n, metrics)


# Mod signature: (task_ins, call_next) -> task_res  — Flower "mods" chain.
ModFn = Callable[[TaskIns, Callable[[TaskIns], TaskRes]], TaskRes]


class ClientApp:
    """Owns client_fn + the mod chain; transport-agnostic."""

    def __init__(self, client_fn: Callable[[str], Client],
                 mods: Optional[Sequence[ModFn]] = None):
        self.client_fn = client_fn
        self.mods = list(mods or [])
        self._clients: Dict[str, Client] = {}

    def _client(self, cid: str) -> Client:
        if cid not in self._clients:
            self._clients[cid] = self.client_fn(cid)
        return self._clients[cid]

    # -------------------------------------------------------------- handle
    def handle(self, task_ins_bytes: bytes, cid: str = "0") -> bytes:
        task = decode_task_ins(task_ins_bytes)
        # round-start params stashed by the innermost fit decode, so a
        # quantized downlink is dequantized once (+ one memcpy), not once
        # for training and again for the delta base in _maybe_compress
        stash: Dict[str, Any] = {}

        def call(t: TaskIns) -> TaskRes:
            client = self._client(cid)
            try:
                if t.task_type == "fit":
                    ins = decode_fit_ins(t.payload)
                    codec = ins.config.get("codec")
                    lossy = codec in QUANT_CODECS or codec == "sparse"
                    if lossy and ins.flat is not None \
                            and len(t.payload) \
                            and t.payload[0] in (BF16_MAGIC, Q8_MAGIC):
                        # copy BEFORE fit() may mutate the views in place
                        stash["base"] = FlatParams(ins.flat.buf.copy(),
                                                   ins.flat.layout)
                        stash["base_payload"] = t.payload
                    if codec == "sparse":
                        # adapter/LoRA mask, read once per handle so the
                        # mod-chain re-encode sees the same subset
                        stash["ranges"] = client.np_client \
                            .trainable_ranges()
                        stash["frac"] = ins.config.get("sparse_frac",
                                                       0.01)
                    res = client.handle_fit(ins)
                    enc_codec = enc_base = None
                    if not self.mods and lossy:
                        # no mod chain to feed: skip the intermediate
                        # lossless frame and encode compressed directly
                        # (the encoder still falls back to 0xF1 when the
                        # result is not uniform fp32)
                        base = stash.get("base")
                        if base is None:            # raw 0xF1 downlink
                            base = peek_params(t.payload)
                            if isinstance(base, QuantParams):
                                base = base.to_flat()
                        if base is not None:        # delta-encodable only
                            enc_codec, enc_base = codec, base
                    return TaskRes("fit", t.round,
                                   encode_fit_res(
                                       res, codec=enc_codec, base=enc_base,
                                       sparse_frac=stash.get("frac", 0.01),
                                       sparse_ranges=_valid_ranges(
                                           stash.get("ranges"), enc_base)),
                                   task_id=t.task_id)
                if t.task_type == "evaluate":
                    res = client.handle_evaluate(decode_evaluate_ins(t.payload))
                    return TaskRes("evaluate", t.round,
                                   encode_evaluate_res(res), task_id=t.task_id)
                if t.task_type == "get_parameters":
                    arrays = client.np_client.get_parameters({})
                    return TaskRes("get_parameters", t.round,
                                   arrays_to_bytes(arrays), task_id=t.task_id)
                if t.task_type == "get_properties":
                    props = dict(client.np_client.get_properties({}) or {})
                    props.setdefault("codecs", list(WIRE_CODECS))
                    return TaskRes("get_properties", t.round,
                                   encode_properties_res(props),
                                   task_id=t.task_id)
                return TaskRes(t.task_type, t.round, b"",
                               task_id=t.task_id, error="unknown task type")
            except Exception as e:  # noqa: BLE001
                return TaskRes(t.task_type, t.round, b"", task_id=t.task_id,
                               error=repr(e))

        chain = call
        for mod in reversed(self.mods):
            chain = _bind_mod(mod, chain)
        return encode_task_res(self._maybe_compress(task, chain(task),
                                                    stash))

    def _maybe_compress(self, task: TaskIns, res: TaskRes,
                        stash: Optional[Dict[str, Any]] = None) -> TaskRes:
        """Re-encode the final (post-mod-chain) fit result with the
        negotiated lossy codec, as a **delta** against the round-start
        parameters peeked from the pristine task payload (immune to
        in-place mutation by ``fit``).

        Running OUTSIDE the mod chain means DP/TopK/SecAgg compose
        naturally: mods see exact fp32 buffers, and only the final wire
        hop is quantized.  Results a mod already re-encoded to something
        not uniform fp32 (e.g. SecAgg's uint64 masked shares, whose
        pairwise masks must keep cancelling exactly in the server's
        integer-domain sum) skip compression via the encoder's lossless
        0xF1 fallback — which the header pre-check below shortcuts."""
        codec = None
        cfg: Dict[str, Any] = {}
        if task.task_type == "fit" and not res.error and res.payload:
            cfg = peek_config(task.payload)
            codec = cfg.get("codec")
        if (codec not in QUANT_CODECS and codec != "sparse") \
                or res.payload[0] != FLAT_MAGIC:
            return res                  # nothing requested, or non-flat out
        fit = decode_fit_res(res.payload)          # zero-copy (0xF1)
        if not quantizable(fit.flat.layout):
            return res                  # lossy encode would fall back anyway
        if stash and stash.get("base_payload") is task.payload:
            base = stash["base"]        # pristine copy from the fit decode
        else:
            base = peek_params(task.payload)
            if isinstance(base, QuantParams):
                base = base.to_flat()   # what *we* trained from this round
        if base is not None and base.layout != fit.flat.layout:
            base = None                 # result re-shaped: no delta possible
        if base is None:
            return res                  # keep lossless rather than quantize
        payload = encode_fit_res(
            fit, codec=codec, base=base,
            sparse_frac=(stash or {}).get("frac",
                                          cfg.get("sparse_frac", 0.01)),
            sparse_ranges=_valid_ranges((stash or {}).get("ranges"), base))
        return TaskRes(res.task_type, res.round, payload,
                       task_id=res.task_id)


def _valid_ranges(ranges, base: Optional[FlatParams]):
    """Sanitize a client's adapter mask: sorted, non-overlapping
    ``[start, stop)`` int64 ranges inside the base layout, or ``None``
    (falls back to TopK mode) when the mask is absent or malformed —
    better a denser-than-asked update than a byzantine rejection."""
    if ranges is None or base is None:
        return None
    try:
        r = np.asarray(ranges, np.int64).reshape(-1, 2)
    except (TypeError, ValueError):
        return None
    if r.size == 0:
        return None
    if bool((r[:, 0] >= r[:, 1]).any()) or int(r[0, 0]) < 0 \
            or int(r[-1, 1]) > base.layout.total_size \
            or bool((r[1:, 0] < r[:-1, 1]).any()):
        return None
    return r


def _bind_mod(mod: ModFn, nxt: Callable[[TaskIns], TaskRes]):
    def bound(task: TaskIns) -> TaskRes:
        return mod(task, nxt)
    return bound
