"""Server-side app layer (Flower analogue, paper Listing 1).

    strategy = FedAdam(...)
    app = ServerApp(config=ServerConfig(num_rounds=3), strategy=strategy)

``ServerApp.run(driver)`` drives FL rounds against an abstract
:class:`Driver` (Flower Next's Driver API): the native simulation and the
FLARE-bridged deployment provide different drivers, the app code is
identical — the "no code changes" property under test in benchmarks.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.fl.messages import (WIRE_CODECS, EvaluateRes, TaskIns,
                                     decode_evaluate_res, decode_fit_res,
                                     decode_properties_res, decode_task_res,
                                     encode_evaluate_ins, encode_fit_ins,
                                     encode_task_ins, bytes_to_arrays,
                                     peek_params)
from repro_torch.fl.fedbuff import FedBuffBuffer
from repro_torch.fl.registry import PopulationRegistry
from repro_torch.fl.strategy import Strategy

NDArrays = List[np.ndarray]


@dataclass(frozen=True)
class ServerConfig:
    num_rounds: int = 3
    round_timeout: float = 120.0
    # requested wire codec for the model payloads ("sparse" structured-
    # sparse TopK/adapter deltas, "q8" int8+per-chunk scales, "bf16", or
    # None/"flat" for the lossless default).  A lossy codec is only used
    # after every node advertises it via get_properties; otherwise the
    # run demotes down the ladder sparse -> q8 -> flat (see
    # repro_torch.fl.messages module docstring, "Codec negotiation").
    codec: Optional[str] = None
    # "sparse" codec knob: fraction of coordinates a TopK client update
    # keeps (clients exposing trainable_ranges() ship their adapter
    # subset instead and ignore this).  Rides in the fit config.
    sparse_frac: float = 0.01
    # aggregation kernel backend for the strategy ("numpy" | "torch" |
    # None = auto: torch).  Applied to the strategy at app construction
    # so streaming arrival-order accumulation folds through the fused
    # device kernel (see repro_torch.fl.agg_kernels "Backend dispatch").
    agg_backend: Optional[str] = None
    # device the torch backend folds on ("cuda", "cuda:1", "cpu"; None =
    # the CUDA card).  Applied to the strategy like agg_backend.
    agg_device: Optional[str] = None
    # server-state sharding: split the round's streaming accumulator and
    # any FedOpt moments into this many contiguous qchunk-aligned ranges
    # (per-shard memory ~1/agg_shards of the single-host fp64 footprint,
    # all-gather at finalize).  None keeps the single-host reference
    # state.  ``shard_mesh`` instead derives the count from its "data"
    # axis and, on the torch backend, places each shard's accumulator on
    # its devices (StreamingWeightedSum).
    agg_shards: Optional[int] = None
    shard_mesh: Optional[Any] = None
    # fleet sampling: draw sample_k of the connected nodes each round
    # (availability-weighted via repro_torch.fl.registry.PopulationRegistry,
    # seeded by sample_seed so runs replay).  None = everyone, the
    # pre-sampling behavior.
    sample_k: Optional[int] = None
    sample_seed: int = 0
    sample_min_weight: float = 0.05
    # async FedBuff mode (repro_torch.fl.fedbuff): fold updates as they
    # arrive with a staleness-discounted weight; advance the global
    # version every async_buffer_k folds; drop updates staler than
    # async_max_staleness.  num_rounds counts version advances.
    # async_concurrency caps in-flight fit tasks (None = whole pool);
    # evaluate runs every async_eval_every advances (0 = never).
    async_mode: bool = False
    async_buffer_k: int = 2
    async_max_staleness: int = 4
    async_staleness_exponent: float = 0.5
    async_concurrency: Optional[int] = None
    async_eval_every: int = 1
    # fleet transport: "inproc" keeps the in-process SuperLink queues;
    # "tcp" serves the same Fleet API over real sockets
    # (repro_torch.core.transport.TcpSuperLink) with per-peer credit
    # backpressure, heartbeats, and reconnect-resume.  The app layer is
    # identical either way — run_native() reads these to build the link.
    # bind_port=0 picks an ephemeral port (the link exposes .address).
    transport: str = "inproc"
    bind_host: str = "127.0.0.1"
    bind_port: int = 0


class Driver:
    """Transport abstraction the ServerApp runs against."""

    def node_ids(self) -> List[str]:
        raise NotImplementedError

    def send_and_receive(self, tasks: Dict[str, bytes],
                         timeout: float) -> Dict[str, bytes]:
        """node_id -> TaskIns bytes; returns node_id -> TaskRes bytes.

        All-or-nothing batch API: raises ``TimeoutError`` if any task
        misses the (shared) deadline.  Callers that tolerate partial
        participation use :meth:`send_and_receive_iter` instead.
        """
        raise NotImplementedError

    def send_and_receive_iter(self, tasks: Dict[str, bytes], timeout: float):
        """Yield (node_id, TaskRes bytes) pairs as results become
        available, releasing each buffer to the consumer.

        Streaming transports yield in **arrival order** and simply stop
        yielding once the shared deadline passes — a straggler or dead
        node means *fewer* pairs, never an exception.  The caller records
        the missing nodes as per-node failures (the FedAvg-family
        accumulators are order-insensitive up to fp64 rounding).

        The default adapts the blocking API and yields in sorted node
        order, which keeps aggregation deterministic.  The blocking API is
        all-or-nothing, so on timeout the adapter yields nothing and every
        node is recorded as a failure — the contract holds either way.
        """
        try:
            res = self.send_and_receive(tasks, timeout)
        except TimeoutError:
            return
        for node in sorted(res):
            yield node, res.pop(node)


@dataclass
class RoundRecord:
    round: int
    loss: Optional[float] = None
    metrics: Dict[str, Any] = field(default_factory=dict)
    # (node_id, reason) for every node that errored or missed the deadline
    # in this round (fit and evaluate phases combined)
    failures: List[Tuple[str, str]] = field(default_factory=list)


@dataclass
class History:
    rounds: List[RoundRecord] = field(default_factory=list)
    final_parameters: Optional[NDArrays] = None

    def losses(self) -> List[Tuple[int, float]]:
        return [(r.round, r.loss) for r in self.rounds if r.loss is not None]


class ServerApp:
    def __init__(self, config: ServerConfig, strategy: Strategy):
        self.config = config
        self.strategy = strategy
        self.registry = PopulationRegistry(
            seed=config.sample_seed, min_weight=config.sample_min_weight)
        if config.agg_backend is not None and hasattr(strategy, "backend"):
            strategy.backend = config.agg_backend
        if config.agg_device is not None and hasattr(strategy, "device"):
            strategy.device = config.agg_device
        if config.agg_shards is not None and hasattr(strategy, "shards"):
            strategy.shards = config.agg_shards
        if config.shard_mesh is not None and hasattr(strategy,
                                                     "shard_mesh"):
            strategy.shard_mesh = config.shard_mesh

    @staticmethod
    def _memo_encode(memo: Dict[Any, bytes], ins, enc_fn,
                     codec: Optional[str]) -> bytes:
        """One (potentially lossy, model-size) encode per distinct
        broadcast (params, config) per round — all nodes usually share
        the same parameters object, so this is one quantization pass per
        round, not one per node.  Shared by the fit and evaluate phases
        so their key scheme can never desynchronize."""
        try:
            key = (id(ins.parameters), id(ins.flat),
                   tuple(sorted(ins.config.items())))
            payload = memo.get(key)
        except TypeError:
            # unhashable/unsortable config value: skip the memo so the
            # encoder's own "not wire-safe" error (the pre-memo
            # behavior) surfaces
            return enc_fn(ins, codec=codec)
        if payload is None:
            payload = memo[key] = enc_fn(ins, codec=codec)
        return payload

    @staticmethod
    def _exchange(driver: Driver, tasks: Dict[str, bytes], timeout: float,
                  on_result) -> List[Tuple[str, str]]:
        """Stream one round-trip: decode each TaskRes as it arrives and
        hand successes to ``on_result(node, task_res)``; return the
        failures — errored responses plus a ``(node, "timeout")`` entry
        for every node that missed the shared deadline."""
        failures: List[Tuple[str, str]] = []
        received = set()
        for node, tr_bytes in driver.send_and_receive_iter(tasks, timeout):
            received.add(node)
            try:
                tr = decode_task_res(tr_bytes)
                if tr.error:
                    failures.append((node, tr.error))
                else:
                    on_result(node, tr)
            except Exception as e:  # noqa: BLE001 — byzantine/buggy payload
                failures.append((node, f"malformed response: {e!r}"))
        for node in sorted(set(tasks) - received):
            failures.append((node, "timeout"))
        return failures

    # -------------------------------------------------------- negotiation
    def _negotiate_codec(self, driver: Driver,
                         nodes: List[str]) -> Tuple[str, str]:
        """Pick the wire codec for this run: the configured lossy codec if
        EVERY node advertises it in get_properties, else lossless "flat".

        A node that errors on the unknown task type (older peer) or
        misses the deadline demotes the whole fleet — a lossy frame it
        cannot decode would cost the round anyway.  Returns ``(codec,
        demotion_note)``; the note names the nodes responsible so a
        demoted run is visible in every RoundRecord, not silent."""
        want = self.config.codec or "flat"
        if want == "flat":
            return "flat", ""
        if want not in WIRE_CODECS:
            raise ValueError(f"unknown codec {want!r}; have {WIRE_CODECS}")
        note = ""
        if want == "sparse" and not self.strategy.supports_partial():
            # the sparse fold scatters into a weighted-sum accumulator;
            # strategies that need dense per-client rows (median/trim/
            # Krum — exactly the ones that refuse 0xF4 partials) get the
            # next rung down instead of a protocol violation per node
            note = ("sparse demoted to q8: strategy needs dense "
                    "per-client updates")
            want = "q8"
        tasks = {node: encode_task_ins(TaskIns(
            "get_properties", 0, b"", task_id=uuid.uuid4().hex))
            for node in nodes}
        supported: Optional[set] = None
        lacking: List[str] = []

        def on_props(node, tr):
            nonlocal supported
            cs = set(decode_properties_res(tr.payload)
                     .get("codecs", ("flat", "legacy")))
            if want not in cs:
                lacking.append(node)
            supported = cs if supported is None else supported & cs

        failures = self._exchange(driver, tasks, self.config.round_timeout,
                                  on_props)
        if failures or supported is None or want not in supported:
            culprits = sorted(set(lacking) | {n for n, _ in failures})
            who = ",".join(culprits) or "empty fleet"
            if want == "sparse" and not failures and supported \
                    and "q8" in supported:
                # a fleet that lacks sparse but all speaks q8 keeps the
                # int8-delta rung instead of falling to raw fp32
                return "q8", f"sparse demoted to q8 by {who}"
            demote = f"{want} demoted to flat by {who}"
            return "flat", f"{note}; {demote}" if note else demote
        return want, note

    # ------------------------------------------------ shared round phases
    def _initial_parameters(self, driver: Driver,
                            nodes: List[str]) -> NDArrays:
        """Round 0: pull initial parameters from the fleet — probed in
        small waves, each under ONE shared deadline and first success
        wins, so dead nodes neither abort the run nor stack up per-node
        timeouts, and a large fleet doesn't upload N models.  (On a
        blocking-only driver each wave is all-or-nothing: a dead node
        costs its whole wave, and the next wave is probed instead.)"""
        parameters = None
        errors: List[Tuple[str, str]] = []
        for lo in range(0, len(nodes), 3):
            wave = nodes[lo:lo + 3]
            tasks = {node: encode_task_ins(TaskIns(
                "get_parameters", 0, b"", task_id=uuid.uuid4().hex))
                for node in wave}
            received = set()
            for node, tr_bytes in driver.send_and_receive_iter(
                    tasks, self.config.round_timeout):
                received.add(node)
                try:
                    tr = decode_task_res(tr_bytes)
                    if tr.error:
                        errors.append((node, tr.error))
                        continue
                    parameters = bytes_to_arrays(tr.payload)
                except Exception as e:  # noqa: BLE001 — bad payload
                    errors.append((node, f"malformed response: {e!r}"))
                    continue
                break                # closing the iter reaps the rest
            if parameters is not None:
                return parameters
            errors.extend((n, "timeout") for n in wave
                          if n not in received)
        raise RuntimeError(
            f"no node returned initial parameters: {errors}")

    def _round_participants(self, nodes: List[str], rnd: int) -> List[str]:
        """The nodes this round talks to: everyone, or ``sample_k`` of
        them drawn availability-weighted from the registry."""
        if self.config.sample_k is None:
            return nodes
        return self.registry.sample(nodes, self.config.sample_k, rnd)

    def _evaluate_phase(self, driver: Driver, rnd: int,
                        parameters: NDArrays, nodes: List[str],
                        enc_codec: Optional[str], record: RoundRecord
                        ) -> None:
        """Configure/dispatch/aggregate one evaluate phase into
        ``record`` (no-op if the strategy declines to evaluate)."""
        ev_cfg = self.strategy.configure_evaluate(rnd, parameters, nodes)
        if not ev_cfg:
            return
        tasks = {}
        ev_memo: Dict[Any, bytes] = {}
        for node, ins in ev_cfg.items():
            payload = self._memo_encode(ev_memo, ins,
                                        encode_evaluate_ins, enc_codec)
            t = TaskIns("evaluate", rnd, payload,
                        task_id=uuid.uuid4().hex)
            tasks[node] = encode_task_ins(t)
        ev_results: List[Tuple[str, EvaluateRes]] = []
        ev_failures = self._exchange(
            driver, tasks, self.config.round_timeout,
            lambda node, tr: ev_results.append(
                (node, decode_evaluate_res(tr.payload))))
        ev_results.sort()              # arrival order -> deterministic
        loss, ev_metrics = self.strategy.aggregate_evaluate(
            rnd, ev_results, ev_failures)
        record.loss = loss
        record.metrics.update(ev_metrics)
        record.failures.extend(ev_failures)

    # ------------------------------------------------------------- rounds
    def run(self, driver: Driver) -> History:
        if self.config.async_mode:
            return self.run_async(driver)
        history = History()
        nodes = sorted(driver.node_ids())
        if not nodes:
            raise RuntimeError("no connected nodes")
        wire_codec, demotion = self._negotiate_codec(driver, nodes)
        # "flat" means: leave the encode to the process default (which may
        # legitimately be "legacy" for mixed-fleet deployments)
        enc_codec = None if wire_codec == "flat" else wire_codec

        parameters = self.strategy.initialize_parameters()
        if parameters is None:
            parameters = self._initial_parameters(driver, nodes)
        partial_ok = self.strategy.supports_partial()

        for rnd in range(1, self.config.num_rounds + 1):
            participants = self._round_participants(nodes, rnd)
            # ---- fit phase ----------------------------------------------
            fit_cfg = self.strategy.configure_fit(rnd, parameters,
                                                  participants)
            tasks = {}
            fit_payloads: Dict[str, bytes] = {}
            enc_memo: Dict[Any, bytes] = {}
            for node, ins in fit_cfg.items():
                if wire_codec != "flat":
                    ins.config.setdefault("codec", wire_codec)
                if wire_codec == "sparse":
                    ins.config.setdefault("sparse_frac",
                                          self.config.sparse_frac)
                if partial_ok:
                    # edge aggregators may pre-reduce their subtree into
                    # one 0xF4 partial-sum frame; leaf clients ignore it
                    ins.config.setdefault("partial", 1)
                payload = self._memo_encode(enc_memo, ins, encode_fit_ins,
                                            enc_codec)
                fit_payloads[node] = payload
                t = TaskIns("fit", rnd, payload, task_id=uuid.uuid4().hex)
                tasks[node] = encode_task_ins(t)
            # delta reconstruction bases: OUR OWN downlink bytes, i.e.
            # exactly what each client decoded and trained from — client
            # and server agree on the round base bitwise even when the
            # downlink itself is quantized
            bases: Dict[int, Any] = {}

            def _base_for(node):
                p = fit_payloads[node]
                bp = bases.get(id(p))
                if bp is None:
                    bp = bases[id(p)] = peek_params(p)
                return bp

            fit_ok: List[str] = []

            def on_fit(node, tr):
                res = decode_fit_res(tr.payload)
                q = res.quant
                if q is not None and q.is_delta and q.base is None:
                    q.base = _base_for(node)
                sp = res.sparse
                if sp is not None and sp.base is None:
                    sp.base = _base_for(node)
                acc.add(node, res)
                fit_ok.append(node)

            # results fold into the strategy's accumulator as they arrive
            # (zero-copy flat views / streaming sums — no per-layer stacking)
            acc = self.strategy.fit_accumulator(rnd, parameters)
            # stragglers / dead nodes: recorded failures, not round-aborting
            failures = self._exchange(
                driver, tasks, self.config.round_timeout, on_fit)
            parameters, agg_metrics = acc.finalize(failures)

            # ---- evaluate phase ------------------------------------------
            record = RoundRecord(rnd, metrics=dict(agg_metrics),
                                 failures=list(failures))
            if self.config.codec and self.config.codec != "flat":
                # a requested lossy codec is ALWAYS reported — seeing
                # wire_codec="flat" (+ the demotion note) tells the
                # operator the fleet fell back to raw fp32
                record.metrics.setdefault("wire_codec", wire_codec)
                if demotion:
                    record.metrics.setdefault("wire_codec_demotion",
                                              demotion)
            self._evaluate_phase(driver, rnd, parameters, participants,
                                 enc_codec, record)
            # availability feedback drives the next round's sampling
            self.registry.observe(fit_ok, record.failures)
            history.rounds.append(record)

        history.final_parameters = parameters
        return history

    # -------------------------------------------------------------- async
    def run_async(self, driver: Driver) -> History:
        """FedBuff-style asynchronous run (see :mod:`repro_torch.fl.fedbuff`).

        Needs a streaming driver exposing ``open_stream()`` (e.g.
        SuperLinkDriver): fit tasks stay in flight continuously, each
        arriving update folds immediately with a staleness-discounted
        weight, and the global version advances every ``async_buffer_k``
        folds — ``num_rounds`` counts advances.  One RoundRecord per
        advance; evaluate runs every ``async_eval_every`` advances.
        """
        open_stream = getattr(driver, "open_stream", None)
        if open_stream is None:
            raise RuntimeError(
                "async_mode needs a streaming driver with open_stream() "
                "(e.g. SuperLinkDriver)")
        cfg = self.config
        history = History()
        nodes = sorted(driver.node_ids())
        if not nodes:
            raise RuntimeError("no connected nodes")
        wire_codec, demotion = self._negotiate_codec(driver, nodes)
        enc_codec = None if wire_codec == "flat" else wire_codec
        parameters = self.strategy.initialize_parameters()
        if parameters is None:
            parameters = self._initial_parameters(driver, nodes)
        partial_ok = self.strategy.supports_partial()
        buf = FedBuffBuffer(
            self.strategy, buffer_k=cfg.async_buffer_k,
            max_staleness=cfg.async_max_staleness,
            staleness_exponent=cfg.async_staleness_exponent)
        pool = self._round_participants(nodes, 0)
        width = min(cfg.async_concurrency or len(pool), len(pool))

        # one encoded downlink per (version, distinct config).  The memos
        # are kept for the whole run: delta bases are keyed by payload
        # identity, so every dispatched payload must stay alive or a
        # recycled id() could alias a stale base.
        enc_memos: Dict[int, Dict[Any, bytes]] = {}
        bases: Dict[int, Any] = {}

        def base_for(payload: bytes):
            bp = bases.get(id(payload))
            if bp is None:
                bp = bases[id(payload)] = peek_params(payload)
            return bp

        # task_id -> (node, trained_version, downlink payload)
        outstanding: Dict[str, Tuple[str, int, bytes]] = {}

        def dispatch(stream, node: str) -> None:
            ver = buf.version
            ins = self.strategy.configure_fit(ver, parameters,
                                              [node])[node]
            if wire_codec != "flat":
                ins.config.setdefault("codec", wire_codec)
            if wire_codec == "sparse":
                ins.config.setdefault("sparse_frac", cfg.sparse_frac)
            if partial_ok:
                ins.config.setdefault("partial", 1)
            memo = enc_memos.setdefault(ver, {})
            payload = self._memo_encode(memo, ins, encode_fit_ins,
                                        enc_codec)
            t = TaskIns("fit", ver, payload, task_id=uuid.uuid4().hex)
            tids = stream.send({node: encode_task_ins(t)})
            outstanding[tids[node]] = (node, ver, payload)

        fit_ok: List[str] = []
        failures: List[Tuple[str, str]] = []
        stream = open_stream()
        try:
            for node in pool[:width]:
                dispatch(stream, node)
            while buf.version < cfg.num_rounds:
                got = stream.recv(cfg.round_timeout)
                if got is None:
                    # nothing arrived within a full round_timeout: the
                    # in-flight fleet is dead/stalled — record and stop
                    for _tid, sent in sorted(outstanding.items()):
                        failures.append((sent[0], "timeout"))
                    break
                _node, tid, tr_bytes = got
                sent = outstanding.pop(tid, None)
                if sent is None:
                    continue         # late duplicate of a reaped task
                node, ver, payload = sent
                try:
                    tr = decode_task_res(tr_bytes)
                    if tr.error:
                        failures.append((node, tr.error))
                    else:
                        res = decode_fit_res(tr.payload)
                        q = res.quant
                        if q is not None and q.is_delta and q.base is None:
                            q.base = base_for(payload)
                        sp = res.sparse
                        if sp is not None and sp.base is None:
                            sp.base = base_for(payload)
                        if buf.offer(node, res, ver,
                                     parameters) == "stale":
                            failures.append(
                                (node, f"stale update dropped (trained "
                                       f"at v{ver}, server at "
                                       f"v{buf.version})"))
                        else:
                            fit_ok.append(node)
                except Exception as e:  # noqa: BLE001 — byzantine payload
                    failures.append((node, f"malformed response: {e!r}"))
                if buf.ready():
                    parameters, adv_metrics = buf.advance(parameters)
                    record = RoundRecord(buf.version,
                                         metrics=dict(adv_metrics),
                                         failures=list(failures))
                    if cfg.codec and cfg.codec != "flat":
                        record.metrics.setdefault("wire_codec",
                                                  wire_codec)
                        if demotion:
                            record.metrics.setdefault(
                                "wire_codec_demotion", demotion)
                    if cfg.async_eval_every and (
                            buf.version % cfg.async_eval_every == 0
                            or buf.version == cfg.num_rounds):
                        self._evaluate_phase(driver, buf.version,
                                             parameters, pool,
                                             enc_codec, record)
                    self.registry.observe(fit_ok, record.failures)
                    fit_ok, failures = [], []
                    history.rounds.append(record)
                if buf.version < cfg.num_rounds:
                    dispatch(stream, node)
        finally:
            stream.close()
        if fit_ok or failures:
            # stragglers that landed after the final advance
            self.registry.observe(fit_ok, failures)
            if history.rounds:
                history.rounds[-1].failures.extend(failures)
        history.final_parameters = parameters
        return history
