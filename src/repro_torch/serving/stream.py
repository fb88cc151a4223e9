"""Streaming retrieval-decode engine: prefill / insert / generate_step
serving over the Pyramid search engine (JetStream-style; port of
``repro.serving.stream``).

A continuous-batching LM decode loop in which every decode step is a
batched similarity query: kNN-LM (Khandelwal et al., the paper's
reference [10]) over a Pyramid-sharded datastore of (hidden state ->
next token) memories. The engine composes the port's pieces:

  * lookups go through :class:`~repro_torch.core.client.PyramidClient`
    futures against a :class:`~repro_torch.serving.engine.ServingEngine`
    (the int8 arena when the datastore client is opened with
    ``quantize=True``), so hedging, supervised recovery and the exact
    rerank all run under sustained decode traffic;
  * slot scheduling generalises :class:`~repro_torch.serving.batcher.
    ContinuousBatcher` (whose cache-scatter helper it shares);
  * sampling is :func:`repro_torch.serving.sampler.sample_np` on the host.

API (explicit, JetStream-shaped)::

    with StreamEngine(params, cfg, datastore=ds, num_slots=8,
                      max_seq=64) as eng:
        sess = eng.prefill(Request(0, prompt, max_new_tokens=16))
        eng.insert(sess)                  # queued; admitted into a slot
        while ...:
            emitted = eng.generate_step() # [(request_id, token), ...]
        done = eng.done                   # Completion records

Retrieval/decode overlap (``overlap=True``, the default) is
double-buffered across two slot *groups*: while group A's decode step
runs, group B's ``SearchFuture``s resolve inside the search engine's
executor threads, and vice versa. Per-session semantics are exact kNN-LM
either way: a session lives in one group, and its own timeline is always
``forward -> retrieve -> interpolate -> sample``; ``overlap=False`` (the
serialized baseline) awaits each step's futures at once and gives the
same tokens, without hiding the retrieval latency. On the card the
executors launch the beam kernel on the decode's stream, so a group's
copy of its logits may also wait for the other group's shard walks: that
changes timing, not tokens.

The decode step is one plain function: the trunk with ``skip_head=True``
(the final-norm hidden state is the kNN query key), then the head in
float32 (``h @ lm_head``, or ``h @ embedding.T`` when tied). Prefill and
decode run under ``torch.no_grad()``: the slot caches are written in
place by :func:`scatter_slot` and by decode, which tensors made under
``torch.inference_mode()`` would refuse.

Backpressure: admission is bounded (``max_queue``; :class:`
BackpressureError` on overflow) and decode never runs ahead of the
search engine by more than one step per group: the sampler blocks on
``gather_arrays`` (bounded by ``retrieval_timeout_s``) before the next
dispatch.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import ArchConfig, BlockKind
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.utils import nearest_rank
from repro_torch.core.client import PyramidClient, gather_arrays
from repro_torch.models.transformer import forward, grow_cache, make_cache
from repro_torch.obs import NULL_TRACER, MetricsRegistry
from repro_torch.serving.batcher import Completion, Request, scatter_slot
from repro_torch.serving.retrieval import (Datastore, interpolate,
                                           knn_vocab_probs,
                                           open_datastore_client)
from repro_torch.serving.sampler import SamplerConfig, sample_np


class BackpressureError(RuntimeError):
    """``insert`` refused a session: the admission queue is full
    (``max_queue``). Callers should back off and retry: completing
    sessions free queue capacity every ``generate_step``."""


def _float_head(params: dict, cfg: ArchConfig) -> torch.Tensor:
    """The LM head as a float32 [D, V] matrix (a view of the parameters
    when they are float32 already)."""
    if cfg.tie_embeddings:
        return params["embedding"].float().T
    return params["lm_head"].float()


def _load_kernels(cfg: ArchConfig) -> None:
    """Build and load the kernels of the decode and prefill path in the
    calling thread: flash-decode for attention layers, the SSD scan for
    Mamba2 layers."""
    kinds = set(cfg.layer_kinds())
    if BlockKind.ATTENTION in kinds:
        from repro_torch.kernels.decode_attention import load_kernel
        load_kernel()
    if BlockKind.MAMBA2 in kinds:
        from repro_torch.kernels.ssd import load_kernel
        load_kernel()


@dataclasses.dataclass
class Session:
    """One request's lifecycle through the engine:
    ``prefilled -> queued -> active -> done``. Created by
    :meth:`StreamEngine.prefill`, which stores the prompt's grown cache
    plus the last prompt position's LM logits and hidden state (the
    first token's interpolation inputs)."""
    request: Request
    lm_logits: Optional[np.ndarray] = None     # [V] last-prompt-pos
    hidden: Optional[np.ndarray] = None        # [D] kNN query key
    pcache: Optional[dict] = None              # grown prefill cache
    future: Optional[object] = None            # first-token SearchFuture
    submitted_at: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    state: str = "prefilled"

    @property
    def request_id(self) -> int:
        return self.request.request_id


@dataclasses.dataclass
class _Inflight:
    """One dispatched decode step awaiting its sample phase."""
    logits: np.ndarray            # [L, V] live-slot LM logits
    slots: List[int]              # live slot index per row
    futures: Optional[List]       # per-row SearchFutures (None: LM-only)
    submitted_at: float


class _SlotGroup:
    """One of the engine's two decode microbatches; its decode step runs
    at the group's full width."""

    def __init__(self, cfg: ArchConfig, slots: int, max_seq: int,
                 device: torch.device):
        self.cache = make_cache(cfg, slots, max_seq, device=device)
        self.pos = np.zeros(slots, np.int64)       # next write position
        self.last = np.zeros(slots, np.int64)      # last sampled token
        self.sessions: List[Optional[Session]] = [None] * slots
        self.inflight: Optional[_Inflight] = None


class StreamEngine:
    """Continuous-batching retrieval-augmented decode over a Pyramid
    datastore (or plain LM decode with ``datastore=None``), on ``device``
    (the parameters' device; ``"cuda"`` by default, which raises without
    a card).

    Parameters
    ----------
    num_slots : total decode slots, split over two double-buffer groups
        (rounded up to even).
    datastore / client : a kNN-LM :class:`Datastore` and (optionally) an
        already-open :class:`PyramidClient` session serving its index.
        Without ``client`` the engine opens one itself (engine kwargs
        pass through: ``quantize=True, rerank_factor=4`` serves the int8
        arena) and shuts it down on :meth:`close`.
    knn_k / lam / knn_temperature / branching_factor : kNN-LM knobs:
        neighbours per lookup, interpolation weight, kNN softmax
        temperature, and the Pyramid routing fan-out.
    overlap : double-buffer retrieval behind the counter-group's decode
        step (default). ``False`` = serialized await-every-step baseline
        (identical tokens, no latency hiding).
    max_queue / retrieval_timeout_s : backpressure knobs: admission
        bound (``insert`` raises :class:`BackpressureError` beyond it)
        and the per-step bound on waiting for the search engine.
    """

    def __init__(self, params: dict, cfg: ArchConfig, *, num_slots: int = 8,
                 max_seq: int = 64,
                 datastore: Optional[Datastore] = None,
                 client: Optional[PyramidClient] = None,
                 knn_k: int = 8, lam: float = 0.25,
                 knn_temperature: float = 10.0,
                 branching_factor: Optional[int] = None,
                 sampler: SamplerConfig = SamplerConfig(greedy=True),
                 seed: int = 0, overlap: bool = True,
                 max_queue: int = 64, retrieval_timeout_s: float = 30.0,
                 stats_window: int = 4096,
                 registry: Optional[MetricsRegistry] = None,
                 tracer=None, device: DeviceLike = "cuda", **engine_kw):
        self.device = resolve_device(device)
        if datastore is None and client is not None:
            raise ValueError("client= needs the datastore= it serves")
        if engine_kw and (datastore is None or client is not None):
            raise ValueError(
                f"engine kwargs {sorted(engine_kw)} only apply when the "
                "engine opens its own datastore client")
        self.params = params
        self.cfg = cfg
        self.max_seq = max_seq
        self.datastore = datastore
        self.knn_k = knn_k
        self.lam = lam
        self.knn_temperature = knn_temperature
        self.branching_factor = branching_factor
        self.sampler = sampler
        self.overlap = overlap
        self.max_queue = max_queue
        self.retrieval_timeout_s = retrieval_timeout_s

        # the slot caches first (sliding layers keep rings of the window)
        self.slots_per_group = max(1, (num_slots + 1) // 2)
        self.num_slots = 2 * self.slots_per_group
        self.groups = [_SlotGroup(cfg, self.slots_per_group, max_seq,
                                  self.device) for _ in range(2)]
        self._head = _float_head(params, cfg)
        if self.device.type == "cuda":
            # build and load the decode and prefill kernels before the
            # datastore client starts its executor threads
            _load_kernels(cfg)

        # shared observability plane: the owned datastore client's
        # serving engine joins this registry/tracer (unless engine_kw
        # overrides), so one scrape / one trace covers decode steps and
        # the shard searches they fan out to
        self.obs = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER

        self._owns_client = False
        self._client = client
        if datastore is not None and client is None:
            engine_kw.setdefault("registry", self.obs)
            engine_kw.setdefault("tracer", self.tracer)
            self._client = open_datastore_client(datastore, **engine_kw)
            self._owns_client = True

        self._turn = 0
        self._rng = np.random.default_rng(seed)

        self.queue: collections.deque = collections.deque()
        self.done: List[Completion] = []
        self._closed = False
        self._t0: Optional[float] = None
        # counter-backed bookkeeping (the same objects /metrics renders,
        # so the Prometheus endpoint and stats() never disagree); the
        # deques stay for exact windowed percentiles
        m = self.obs
        self._m_steps = m.counter(
            "pyramid_stream_steps_total", "decode steps dispatched")
        self._m_tokens = m.counter(
            "pyramid_stream_tokens_total", "tokens emitted")
        self._m_admitted = m.counter(
            "pyramid_stream_admitted_total", "sessions admitted to slots")
        self._m_rejected = m.counter(
            "pyramid_stream_rejected_total",
            "sessions refused by backpressure")
        self._m_lookups = m.counter(
            "pyramid_stream_lookups_total", "kNN lookups resolved")
        self._m_knn_hits = m.counter(
            "pyramid_stream_knn_hits_total",
            "tokens whose retrieved memories contained them")
        self._m_knn_tokens = m.counter(
            "pyramid_stream_knn_tokens_total",
            "tokens scored against retrieved memories")
        self._m_hedges = m.counter(
            "pyramid_stream_hedges_total",
            "hedge re-dispatches observed on resolved lookups")
        self._h_ret_wait = m.histogram(
            "pyramid_stream_retrieval_wait_seconds",
            "sampler block time per resolve (non-overlapped remainder)")
        self._h_ret_lat = m.histogram(
            "pyramid_stream_retrieval_latency_seconds",
            "lookup submit-to-resolve latency")
        m.gauge("pyramid_stream_queued_sessions", "admission queue depth",
                fn=lambda: len(self.queue))
        m.gauge("pyramid_stream_active_sessions", "occupied decode slots",
                fn=lambda: sum(s is not None for grp in self.groups
                               for s in grp.sessions))
        self._ret_wait = collections.deque(maxlen=stats_window)
        self._ret_lat = collections.deque(maxlen=stats_window)

    # -- lifecycle ---------------------------------------------------------

    @property
    def client(self) -> Optional[PyramidClient]:
        return self._client

    def close(self) -> None:
        """Tear down the engine; shuts down the datastore client's
        serving engine iff this engine opened it."""
        if self._closed:
            return
        self._closed = True
        if self._owns_client and self._client is not None:
            self._client.shutdown()

    def __enter__(self) -> "StreamEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- prefill / insert --------------------------------------------------

    def _head_logits(self, hidden: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Final-norm hidden states [B, D] -> (float32 logits [B, V],
        float32 hidden [B, D])."""
        h = hidden.float()
        return h @ self._head, h

    @torch.no_grad()
    def prefill(self, request: Request) -> Session:
        """Run the prompt through the model (batch 1); returns a
        ``prefilled`` :class:`Session` holding the grown cache and the
        first token's interpolation inputs. The session is not serving
        yet: :meth:`insert` it."""
        prompt = np.asarray(request.prompt)
        if len(prompt) >= self.max_seq:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_seq {self.max_seq}")
        with self.tracer.span("stream.prefill",
                              request_id=request.request_id,
                              prompt_len=len(prompt)):
            toks = torch.as_tensor(prompt[None, :].astype(np.int64),
                                   device=self.device)
            hid, _, pcache = forward(self.params, self.cfg, toks,
                                     build_cache=True, skip_head=True)
        pcache = grow_cache(pcache, self.max_seq,
                            window=self.cfg.sliding_window)
        logits, h = self._head_logits(hid[:, -1])
        return Session(request=request,
                       lm_logits=logits[0].cpu().numpy(),
                       hidden=h[0].cpu().numpy(),
                       pcache=pcache)

    def insert(self, session: Session) -> None:
        """Queue a prefilled session for slot admission. Issues its
        first-token kNN lookup at once, so the retrieval overlaps the
        queue wait. Raises :class:`BackpressureError` when the admission
        queue is at ``max_queue``."""
        if session.state != "prefilled":
            raise ValueError(f"session {session.request_id} is "
                             f"{session.state}, expected 'prefilled'")
        if len(self.queue) >= self.max_queue:
            self._m_rejected.inc()
            raise BackpressureError(
                f"admission queue full ({self.max_queue}); retry after "
                "generate_step frees capacity")
        if self._client is not None:
            session.future = self._client.search(
                session.hidden, self.knn_k,
                branching_factor=self.branching_factor)
            session.submitted_at = time.monotonic()
        session.state = "queued"
        self.queue.append(session)

    def submit(self, request: Request) -> Session:
        """Convenience: ``insert(prefill(request))``."""
        sess = self.prefill(request)
        self.insert(sess)
        return sess

    # -- decode loop -------------------------------------------------------

    def generate_step(self) -> List[Tuple[int, int]]:
        """One scheduler turn: finish the turn group's previous decode
        step (resolve retrieval, interpolate, sample, evict), admit
        queued sessions into freed slots, dispatch the group's next
        decode step and its batched kNN lookup. Returns the
        ``(request_id, token)`` pairs emitted this turn.

        With ``overlap=True`` the dispatched step is left in flight (its
        futures resolve while the other group takes its turn); with
        ``overlap=False`` it is finished before returning.
        """
        if self._t0 is None:
            self._t0 = time.monotonic()
        g = self.groups[self._turn]
        with self.tracer.span("stream.generate_step",
                              group=self._turn) as step_span:
            self._turn = 1 - self._turn
            emitted: List[Tuple[int, int]] = []
            self._finish(g, emitted)
            self._admit(g, emitted)
            self._dispatch(g)
            if not self.overlap:
                self._finish(g, emitted)
            step_span.set(emitted=len(emitted))
        return emitted

    def has_work(self) -> bool:
        return bool(self.queue
                    or any(s is not None for grp in self.groups
                           for s in grp.sessions)
                    or any(grp.inflight is not None
                           for grp in self.groups))

    def run_until_drained(self, max_steps: int = 100_000
                          ) -> List[Completion]:
        steps = 0
        while self.has_work() and steps < max_steps:
            self.generate_step()
            steps += 1
        return self.done

    # -- internals ---------------------------------------------------------

    def _knn_logprobs(self, lm_logits: np.ndarray, ids: np.ndarray,
                      scores: np.ndarray) -> np.ndarray:
        knn = knn_vocab_probs(self.datastore.values, ids, scores,
                              vocab_size=self.cfg.vocab_size,
                              temperature=self.knn_temperature)
        return interpolate(lm_logits, knn, lam=self.lam)

    def _count_hits(self, ids: np.ndarray, toks: np.ndarray) -> None:
        """Per-token kNN hit: the sampled token appeared among the
        retrieved memories' values."""
        vals = np.where(ids >= 0, self.datastore.values[
            np.where(ids >= 0, ids, 0)], -1)
        self._m_knn_hits.inc(
            int((vals == toks[:, None]).any(axis=1).sum()))
        self._m_knn_tokens.inc(len(toks))

    def _finish(self, g: _SlotGroup, emitted: List) -> None:
        inf = g.inflight
        if inf is None:
            return
        g.inflight = None
        if inf.futures is not None:
            with self.tracer.span("stream.gather",
                                  n=len(inf.futures)):
                t0 = time.monotonic()
                ids, scores = gather_arrays(inf.futures, self.knn_k,
                                            self.retrieval_timeout_s)
                now = time.monotonic()
            self._ret_wait.append(now - t0)
            self._ret_lat.append(now - inf.submitted_at)
            self._h_ret_wait.observe(now - t0)
            self._h_ret_lat.observe(now - inf.submitted_at)
            self._m_lookups.inc(len(inf.futures))
            self._m_hedges.inc(sum(f.hedges for f in inf.futures))
            logp = self._knn_logprobs(inf.logits, ids, scores)
        else:
            logp = inf.logits
        toks = sample_np(logp, self._rng, self.sampler)
        if inf.futures is not None:
            self._count_hits(ids, toks)
        for row, slot in enumerate(inf.slots):
            sess = g.sessions[slot]
            tok = int(toks[row])
            sess.tokens.append(tok)
            g.pos[slot] += 1
            g.last[slot] = tok
            emitted.append((sess.request_id, tok))
            self._m_tokens.inc()
            if self._finished(sess, int(g.pos[slot])):
                self._complete(sess)
                g.sessions[slot] = None

    def _finished(self, sess: Session, pos: int) -> bool:
        req = sess.request
        hit_eos = (req.eos_id is not None and sess.tokens
                   and sess.tokens[-1] == req.eos_id)
        return (len(sess.tokens) >= req.max_new_tokens or hit_eos
                or pos >= self.max_seq - 1)

    def _complete(self, sess: Session) -> None:
        sess.state = "done"
        self.done.append(Completion(
            sess.request_id, sess.tokens, len(sess.request.prompt),
            len(sess.tokens)))

    def _admit(self, g: _SlotGroup, emitted: List) -> None:
        """Fill free slots from the admission queue. A session's first
        token is sampled here (prefill logits x its insert-time lookup,
        which has been resolving since ``insert``), so the slot enters
        the next dispatch with a valid last token.

        With ``overlap=True`` admission is balanced across the two slot
        groups (this group only admits up to its fair share of the
        queue): an empty peer group leaves nothing to hide retrieval
        behind. Serialized mode packs one group densely instead: each
        group's decode runs at full width whatever its occupancy, so
        splitting a small load across groups would double the steps for
        nothing."""
        budget = self.slots_per_group
        if self.overlap:
            peer = self.groups[1] if g is self.groups[0] else self.groups[0]
            peer_active = sum(s is not None for s in peer.sessions)
            this_active = sum(s is not None for s in g.sessions)
            fair = peer_active + max(1, (len(self.queue) + 1) // 2)
            budget = max(0, fair - this_active)
        for slot in range(self.slots_per_group):
            if budget <= 0:
                break
            if g.sessions[slot] is not None:
                continue
            while self.queue:
                sess = self.queue.popleft()
                tok = self._first_token(sess)
                emitted.append((sess.request_id, tok))
                self._m_tokens.inc()
                pos = len(sess.request.prompt)
                if self._finished(sess, pos):
                    self._complete(sess)   # done at token 1: the slot
                    continue               # stays free for the next in line
                scatter_slot(g.cache, sess.pcache, slot)
                sess.pcache = None         # freed: the slot owns it now
                sess.state = "active"
                g.sessions[slot] = sess
                g.pos[slot] = pos
                g.last[slot] = tok
                self._m_admitted.inc()
                budget -= 1
                break

    def _first_token(self, sess: Session) -> int:
        ids = None
        if sess.future is not None:
            t0 = time.monotonic()
            ids, scores = gather_arrays([sess.future], self.knn_k,
                                        self.retrieval_timeout_s)
            now = time.monotonic()
            self._ret_wait.append(now - t0)
            self._h_ret_wait.observe(now - t0)
            # no _ret_lat sample: this lookup was issued at insert() and
            # may have sat behind the admission queue for many steps;
            # that residency is queueing, not retrieval latency
            self._m_lookups.inc()
            self._m_hedges.inc(sess.future.hedges)
            sess.future = None
            logp = self._knn_logprobs(sess.lm_logits[None], ids, scores)
        else:
            logp = sess.lm_logits[None]
        tok = sample_np(logp, self._rng, self.sampler)
        if ids is not None:
            self._count_hits(ids, np.asarray(tok))
        tok = int(tok[0])
        sess.tokens.append(tok)
        return tok

    @torch.no_grad()
    def _dispatch(self, g: _SlotGroup) -> None:
        live = [s for s in range(self.slots_per_group)
                if g.sessions[s] is not None]
        if not live:
            return
        # the step runs at the group's full width: a free slot decodes at
        # its last position, which eviction at max_seq - 1 keeps inside
        # the cache
        if (g.pos >= self.max_seq).any():
            raise RuntimeError(f"decode position {g.pos.max()} outside the "
                               f"cache of {self.max_seq} rows")
        with self.tracer.span("stream.dispatch", n=len(live)):
            tokens = torch.as_tensor(g.last[:, None], device=self.device)
            pos = torch.as_tensor(g.pos.astype(np.int32),
                                  device=self.device)
            hid, _, g.cache = forward(self.params, self.cfg, tokens,
                                      cache=g.cache, decode_pos=pos,
                                      skip_head=True)
            logits_d, hidden_d = self._head_logits(hid[:, 0])
            # the copy waits for this group's decode: the overlap window
            # in which the counter-group's lookups resolve in the
            # engine's threads
            rows = torch.as_tensor(live, device=self.device)
            logits = logits_d[rows].cpu().numpy()
            hidden = hidden_d[rows].cpu().numpy()
            futures = None
            submitted = time.monotonic()
            if self._client is not None:
                futures = self._client.search_batch(
                    hidden, self.knn_k,
                    branching_factor=self.branching_factor)
        g.inflight = _Inflight(logits, live, futures, submitted)
        self._m_steps.inc()

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Engine snapshot: scheduler state, throughput, and per-step
        retrieval latency percentiles (``latency`` = submit to resolved,
        the engine-side service time; ``wait`` = time the sampler
        actually blocked, the non-overlapped remainder)."""
        lat = sorted(self._ret_lat)
        wait = sorted(self._ret_wait)
        active = sum(s is not None for grp in self.groups
                     for s in grp.sessions)
        dt = (time.monotonic() - self._t0) if self._t0 else float("nan")

        def pct(xs, q):
            return nearest_rank(xs, q) if xs else float("nan")

        tokens = int(self._m_tokens.value)
        knn_tokens = int(self._m_knn_tokens.value)
        return {
            "num_slots": self.num_slots,
            "slots_per_group": self.slots_per_group,
            "overlap": self.overlap,
            "steps": int(self._m_steps.value),
            "tokens_emitted": tokens,
            "tokens_per_s": (tokens / dt if dt and dt > 0
                             else float("nan")),
            "sessions": {"queued": len(self.queue), "active": active,
                         "admitted": int(self._m_admitted.value),
                         "completed": len(self.done),
                         "rejected": int(self._m_rejected.value)},
            "retrieval": {
                "enabled": self._client is not None,
                "knn_k": self.knn_k, "lam": self.lam,
                "lookups": int(self._m_lookups.value),
                "hedges": int(self._m_hedges.value),
                "latency_p50_s": pct(lat, 50),
                "latency_p99_s": pct(lat, 99),
                "wait_p50_s": pct(wait, 50),
                "wait_p99_s": pct(wait, 99),
                "knn_hit_rate": (int(self._m_knn_hits.value) / knn_tokens
                                 if knn_tokens else float("nan")),
            },
        }
