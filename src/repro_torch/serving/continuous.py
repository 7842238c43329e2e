"""Continuous-batching speculative serving engine
(``repro.serving.continuous``).

Unlike the static ``ServingEngine`` (one batch = one generation, grouped by
identical shapes), this engine keeps a fixed set of ``max_batch`` decode
slots running one shared round (chain ``sd_round`` or ``tree_round``) and
changes *membership* between rounds: new requests join as soon as a slot
and KV pages free up, finished rows retire immediately, and prompt prefill
is fed through the paged decode path in fixed-size chunks interleaved with
decode rounds, so a long prompt never stalls ongoing generation for more
than one chunk.

Shapes are fixed at engine construction (slot count, token-buffer width,
page-table width, pool sizes); membership changes are pure data (the
``active`` mask and page-table rows). KV memory is a shared paged pool
(serving.kv_pool): admission reserves a request's worst case up front,
which bounds the queue instead of bounding concurrency by the longest
request. The pools are zeroed at construction and page 0 is the null page
(models.attention.paged_decode_attention).

API: ``submit()`` (callbacks optional) / ``step()`` / ``stream()`` /
``run()`` / ``serve()``; per-request ``RequestStats`` (TTFT/TPOT/tau) and
engine-level ``ServingTelemetry`` (queue depth, active rows, free pages per
step). With ``tree=TreeSpec(...)`` the decode round is the tree-speculative
one: per-row slack grows to the tree's node count, and up to depth+1 tokens
commit per round instead of gamma+1.

With ``prefix_cache=True`` a radix cache (serving.prefix_cache) maps each
admitted request's longest cached prompt prefix read-only into its page
table: the scheduler's prefix probe stamps the hit before the capacity
check, chunked prefill resumes at the hit boundary, an admission-time COW
copies the tail shared page when the resumed prefill would write into it,
retirement invalidates only pages whose refcount reached zero, and under
pool pressure admission evicts LRU radix leaves. At temperature 0 the
output is token-identical to the engine without the cache.

Host traffic: a decode round makes exactly one device-to-host fetch (the
lengths, the committed token windows and the new pending tokens together);
the end of a request's prefill makes one (its first token). Admission and
retirement write page-table rows, prompts and page ids host-to-device
without waiting for the card. A request's result is assembled from the
tokens already streamed, not read back.

Randomness: one ``torch.Generator`` per engine, seeded with 0 as the
reference seeds its key (the reference splits a JAX key per round, so
sampled tokens agree with it only at temperature 0). The clock is
``time.perf_counter``.

With ``draft_heads`` (a ``draftheads.HeadDrafter``) and
``draft_head_params`` in place of ``draft``/``draft_params`` the engine is
self-speculative: no drafter pool is allocated, prefill chunks run the
target alone with ``return_hidden``, and the last chunk seeds the slot's
``h_feat`` (the target's compute dtype) from the last prompt position.

Observability (``obs``), every hook opt-in and off by default, each
falling through on one attribute check when off: ``tracer`` (engine
spans, per-request tracks stamped with the engine's own clock, counters),
``registry`` (the scheduler's and telemetry's emitters, the
accepted-per-round histogram, ``metrics_out`` JSONL snapshots),
``time_phases`` (draft / verify / commit / prefill fenced by a CUDA event
each and timed), ``quality`` (per-depth TVD, entropy and acceptance
pooled per request, tenant and engine, with a drift alarm; the buffers
ride the round's one device-to-host copy bit for bit), ``flight_record``
(a ring of round records dumped on drift alarm, SLO breach or crash) and
``slo`` (burn-rate tracking of TTFT/TPOT at retirement).

Recurrent models are refused with ``ValueError``, as in the reference.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.metrics import RequestStats, ServingTelemetry
from ..core.sampling import probs_from_logits, sample_from_probs
from ..core.speculative import (SDConfig, attention_only,
                                init_quality_buffer, sd_commit_phase,
                                sd_draft_phase, sd_round, sd_verify_phase,
                                trim_paged_cache)
from ..draftheads.drafter import HeadDrafter
from ..models.model import Model
from ..obs import (NULL_TRACER, FlightRecorder, PhaseTimer, QualityStats,
                   SLOTracker)
from ..spectree.round import (tree_commit_phase, tree_draft_phase,
                              tree_round, tree_verify_phase)
from ..spectree.tree import TreeSpec
from .engine import Request, Result
from .kv_pool import PagedKVPool, ceil_div, copy_pages, invalidate_pages
from .prefix_cache import PrefixCache
from .scheduler import Scheduler, ServeRequest


def _to_device(a, device):
    """A host array on ``device`` as int64, without a host sync: the copy
    stages the numpy buffer before it returns."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
    return t.to(device, non_blocking=True)


def check_pageable(cfg, name: str) -> None:
    """The reference engine's refusal of a model (``cfg``) with recurrent
    layers: its state is one per row, with nothing to page."""
    if not attention_only(cfg):
        raise ValueError(f"{name} has recurrent layers; the paged KV pool "
                         "supports attention-only models")


@dataclass
class _Slot:
    state: str = "free"                # free | prefill | decode
    req: Optional[ServeRequest] = None
    stats: Optional[RequestStats] = None
    prompt_len: int = 0
    target_len: int = 0                # prompt_len + max_new_tokens
    prefill_pos: int = 0               # prompt tokens fed so far
    emitted: int = 0                   # generated tokens already streamed
    admit_seq: int = 0
    out: List[np.ndarray] = field(default_factory=list)   # streamed tokens


def fetch_to_host(t):
    """The decode round's one device-to-host copy (``_decode_round``): the
    lengths, committed windows, pending tokens and quality buffers in one
    int64 tensor, as a numpy array. The one point of a round that waits for
    the card; ``analysis.recompile`` counts its calls."""
    return t.cpu().numpy()


@dataclass
class ContinuousEngine:
    target: Model
    target_params: object
    draft: Model = None
    draft_params: object = None
    # self-speculative alternative to a drafter model (draftheads): no
    # drafter pool, and prefill feeds only the target
    draft_heads: Optional[HeadDrafter] = None
    draft_head_params: object = None
    sd: SDConfig = field(default_factory=SDConfig)
    tree: Optional[TreeSpec] = None    # tree-speculative rounds (spectree)
    max_batch: int = 8                 # concurrent decode slots
    max_seq_len: int = 256             # per-request prompt + max_new cap
    page_size: int = 16
    num_pages: Optional[int] = None    # default: worst case for max_batch rows
    prefill_chunk: int = 32
    policy: str = "fcfs"
    aging_s: Optional[float] = None    # priority aging (scheduler), seconds
    kv_quant: bool = False             # int8 KV pools (quant.kvcache)
    # prefix sharing (serving.prefix_cache): radix cache over the paged pool
    # with per-page refcounts + COW
    prefix_cache: bool = False
    # observability (obs): all opt-in, all off by default.
    # tracer — span tracer; per-request lifecycle tracks + engine spans,
    #   exported as Chrome/Perfetto trace-event JSON (tracer.write).
    # registry — metrics registry; telemetry dataclasses emit into it live.
    # time_phases — run the round's draft / verify / commit phases one by
    #   one, each fenced by a CUDA event it synchronizes on, filling
    #   ``self.phases`` with a draft/verify/commit/prefill wall-time split
    #   and ``self.phase_device_ms`` with each phase's span on the card's
    #   clock. The fences serialize host and card, which is why this is not
    #   free and not the default.
    # metrics_out — JSONL path; a registry snapshot is appended every
    #   ``metrics_every`` steps and once at drain.
    tracer: Optional[object] = None
    registry: Optional[object] = None
    time_phases: bool = False
    metrics_out: Optional[str] = None
    metrics_every: int = 50
    # quality — speculation-quality telemetry (obs.quality): the round
    #   leaves per-depth TVD/entropy/accept buffers in the round state,
    #   fetched in the SAME per-round device-to-host copy as the token
    #   windows. Pooled per request, per tenant and engine-wide; the engine
    #   pool runs the Page–Hinkley drafter-drift detector.
    # flight_record — bounded ring of per-round records (accept masks, TVD,
    #   pool/queue snapshot, phase times when time_phases is on), dumped as
    #   a post-mortem JSON bundle into ``flight_dir`` on drift alarm, SLO
    #   breach, or engine crash.
    # slo — obs.sketch.SLOConfig; TTFT/TPOT observed per retired request
    #   into multi-window burn-rate trackers + quantile sketches.
    quality: bool = False
    flight_record: bool = False
    flight_dir: str = "flight"
    slo: Optional[object] = None
    # sanitize — debug mode: every ``sanitize_every`` decode rounds (and once
    # at drain) sweep the paged-pool bookkeeping (``_sanitize_check``); pure
    # host work, no device syncs.
    sanitize: bool = False
    sanitize_every: int = 8

    def __post_init__(self):
        if self.draft is None and self.draft_heads is None:
            raise ValueError("continuous engine is speculative-only; pass a "
                             "draft model or draft_heads")
        if self.draft is not None and self.draft_heads is not None:
            raise ValueError("pass either draft or draft_heads, not both")
        models = [(self.target, "target")]
        if self.draft is not None:
            models.append((self.draft, "draft"))
        for m, name in models:
            check_pageable(m.cfg, name)
            if m.cfg.num_codebooks > 1:
                raise ValueError("multi-codebook decode is not supported")
        if self.draft_heads is not None:
            if self.tree is not None:
                self.draft_heads.validate_tree(self.tree.depth)
            else:
                self.draft_heads.validate_chain(self.sd.gamma)
        if self.quality:
            self.sd = replace(self.sd, quality=True)
        g = self.sd.gamma
        # tokens committable per decode round (accepted + pending) and the
        # per-row storage overshoot: a chain round writes at most gamma+1
        # positions past the committed length, a tree round writes its whole
        # node buffer (slots L .. L+N-1) before committing the root path.
        self._span = (self.tree.depth if self.tree else g) + 1
        self._slack = (self.tree.num_nodes + 1) if self.tree else (g + 2)
        self._row_cap = self.max_seq_len + self._slack
        max_pages = ceil_div(self._row_cap + self.prefill_chunk, self.page_size)
        if self.num_pages is None:
            self.num_pages = 1 + self.max_batch * max_pages
        self.pool = PagedKVPool(self.num_pages, self.page_size, max_pages)
        self.prefix = (PrefixCache(self.pool, self.page_size)
                       if self.prefix_cache else None)
        self.scheduler = Scheduler(
            self.policy, aging_s=self.aging_s,
            prefix_probe=None if self.prefix is None else self._probe_prefix,
            registry=self.registry)
        self.telemetry = ServingTelemetry(registry=self.registry)
        self.stats: Dict[int, RequestStats] = {}
        self._tr = self.tracer if self.tracer is not None else NULL_TRACER
        self.phases = PhaseTimer()
        self.phase_device_ms: Dict[str, float] = {}
        if self.registry is not None:
            # committed-tokens-per-round histogram: the live acceptance
            # signal an adaptive-speculation controller would consume
            self._m_accept = self.registry.histogram(
                "sd_accepted_per_round",
                buckets=tuple(float(i) for i in range(self._span + 1)),
                help="tokens committed per row per decode round")
        else:
            self._m_accept = None

        dev = self.device = self.target.device
        B, buf = self.max_batch, self._row_cap + self._span + 1

        def zeros(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self._state = {
            "tokens": zeros(B, buf), "lengths": zeros(B), "pending": zeros(B),
            "active": zeros(B, dtype=torch.bool),
            "page_table": zeros(B, max_pages),
            "t_cache": self.target.init_paged_cache(
                self.num_pages, self.page_size, kv_quant=self.kv_quant),
        }
        if self.draft_heads is not None:
            # no drafter pool: h_feat carries each slot's target feature
            self._state["h_feat"] = zeros(B, self.target.cfg.d_model,
                                          dtype=self.target.cfg.compute_dtype)
            self._drafter, self._d_params = (self.draft_heads,
                                             self.draft_head_params)
        else:
            self._state["d_cache"] = self.draft.init_paged_cache(
                self.num_pages, self.page_size, kv_quant=self.kv_quant)
            self._drafter, self._d_params = self.draft, self.draft_params
        # draft positions per round the quality buffers cover (tree rounds
        # report along the committed root path, depth-indexed like a chain)
        self._qdepth = self.tree.depth if self.tree is not None else g
        self.quality_stats: Optional[QualityStats] = None
        self.tenant_quality: Dict[str, QualityStats] = {}
        if self.quality:
            self._state["qual"] = init_quality_buffer(B, self._qdepth, dev)
            self.quality_stats = QualityStats(depth=self._qdepth)
        self.recorder = (FlightRecorder(out_dir=self.flight_dir)
                         if self.flight_record else None)
        self.slo_tracker = (SLOTracker(self.slo) if self.slo is not None
                            else None)
        self._slots = [_Slot() for _ in range(B)]
        self._lengths_h = np.zeros((B,), np.int64)
        self._table_h = np.zeros((B, max_pages), np.int64)
        self._window = torch.arange(self._span, device=dev)[None]
        self._gen = torch.Generator(device=dev).manual_seed(0)
        self._admit_seq = 0
        self._t0: Optional[float] = None
        self._last_sanitize = 0

    # ---------------------------------------------------------------- clock
    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return time.perf_counter() - self._t0

    # ---------------------------------------------------------------- submit
    def _worst_case_tokens(self, req: ServeRequest) -> int:
        plen = len(req.prompt)
        padded = ceil_div(plen, self.prefill_chunk) * self.prefill_chunk
        return max(padded, plen + req.max_new_tokens + self._slack)

    def submit(self, req: ServeRequest):
        plen = len(req.prompt)
        if plen + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"request {req.request_id}: prompt {plen} + max_new "
                f"{req.max_new_tokens} exceeds max_seq_len {self.max_seq_len}")
        need = self.pool.pages_needed(self._worst_case_tokens(req))
        cap = min(self.num_pages - 1, self.pool.max_pages_per_seq)
        if need > cap:
            # would never be admissible even into an empty pool -> the
            # engine would otherwise spin on it forever
            raise ValueError(f"request {req.request_id}: needs {need} KV "
                             f"pages; the pool can ever free {cap}")
        # simulated arrivals are submitted early; latency clocks start at the
        # later of now and the request's nominal arrival
        stats = RequestStats(request_id=req.request_id,
                             submit_time_s=max(self._now(), req.arrival_time_s),
                             prompt_tokens=plen)
        if self.quality:
            stats.quality = QualityStats(depth=self._qdepth)
        self.stats[req.request_id] = stats
        # request lifecycle track, stamped with the clock RequestStats uses
        # (engine-relative -> absolute perf_counter; ``_now`` above set
        # ``_t0``), so TTFT/TPOT rebuilt from the trace match the stats
        self._tr.async_begin("request", req.request_id,
                             ts=self._t0 + stats.submit_time_s,
                             prompt_tokens=plen,
                             max_new_tokens=req.max_new_tokens)
        self.scheduler.submit(req)

    # ---------------------------------------------------------------- admit
    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s.state == "free":
                return i
        return None

    def _probe_prefix(self, req: ServeRequest) -> int:
        """Scheduler hook: stamp the request's longest cached prefix, clamped
        to prompt_len - 1 (the last prompt token is always re-prefilled, its
        logits seed the first sample; on a page-aligned full-prompt hit that
        write lands in the last shared page, hence the COW in ``_admit``)."""
        hit_tokens, pages = self.prefix.match(req.prompt)
        req.prefix_hit = min(hit_tokens, len(req.prompt) - 1)
        req.prefix_pages = list(pages)
        return req.prefix_hit

    @staticmethod
    def _needs_cow(req: ServeRequest, page_size: int) -> bool:
        """Resumed prefill writes inside the last shared page?"""
        return bool(req.prefix_pages) and \
            len(req.prefix_pages) * page_size > req.prefix_hit

    def _caches(self):
        """The paged pools: the target's, and the drafter model's if any."""
        return [self._state[n] for n in ("d_cache", "t_cache")
                if n in self._state]

    def _evict_one(self, protect) -> bool:
        """Drop the LRU prefix-cache leaf; invalidate pages actually freed."""
        freed = self.prefix.evict_lru_leaf(protect=protect)
        if freed is None:
            return False
        if freed:
            for cache in self._caches():
                invalidate_pages(cache, freed)
        return True

    def _can_admit(self, req: ServeRequest) -> bool:
        if self._free_slot() is None:
            return False
        need = self._worst_case_tokens(req)
        if self.prefix is None:
            return self.pool.can_alloc(need)
        n_shared = len(req.prefix_pages)
        cow = self._needs_cow(req, self.page_size)

        def fits():
            return self.pool.can_alloc_shared(need, n_shared, cow)

        # under memory pressure, cached-but-idle prefixes yield to live work
        # (LRU leaf first); the just-matched pages are protected so eviction
        # cannot free what this admission is about to map
        while not fits() and self._evict_one(protect=req.prefix_pages):
            pass
        return fits()

    def _admit(self, req: ServeRequest, now: float):
        i = self._free_slot()
        shared = req.prefix_pages if self.prefix is not None else []
        self.pool.alloc(i, self._worst_case_tokens(req), shared=shared)
        if self.prefix is not None and self._needs_cow(req, self.page_size):
            # the resumed prefill's first write lands inside the last shared
            # page: give this row a private, bit-identical copy first
            old, new = self.pool.cow_page(i, len(shared) - 1)
            if old != new:
                for cache in self._caches():
                    copy_pages(cache, [old], [new])
                self.prefix.tel.cow_copies += 1
        self._table_h[i] = self.pool.table_row(i)
        slot = self._slots[i]
        plen = len(req.prompt)
        slot.state, slot.req = "prefill", req
        slot.prompt_len, slot.target_len = plen, plen + req.max_new_tokens
        slot.prefill_pos, slot.emitted, slot.out = 0, 0, []
        slot.admit_seq, self._admit_seq = self._admit_seq, self._admit_seq + 1
        slot.stats = self.stats[req.request_id]
        slot.stats.admit_time_s = now
        self._tr.async_instant("admit", req.request_id, ts=self._t0 + now,
                               slot=i, prefix_hit=req.prefix_hit)
        if self.prefix is not None:
            # resume chunked prefill at the hit boundary: the shared pages
            # already hold positions [0, prefix_hit) for both models
            slot.prefill_pos = req.prefix_hit
            slot.stats.prefix_hit_tokens = req.prefix_hit
            tel = self.prefix.tel
            tel.lookups += 1
            tel.hits += int(req.prefix_hit > 0)
            tel.hit_tokens += req.prefix_hit
            tel.prompt_tokens += plen
        st = self._state
        st["tokens"][i, :plen] = _to_device(req.prompt, self.device)
        st["page_table"].copy_(_to_device(self._table_h, self.device))
        self.telemetry.admitted += 1

    # ---------------------------------------------------------------- prefill
    def _prefill_one_chunk(self, i: int) -> Optional[int]:
        """Feed the next ``prefill_chunk`` prompt tokens of slot i through
        the paged decode path of both models (of the target alone with draft
        heads); after the last chunk, sample the first token and return it
        (one host fetch), else None."""
        slot, st = self._slots[i], self._state
        req, C = slot.req, self.prefill_chunk
        start = slot.prefill_pos
        real = min(C, slot.prompt_len - start)
        chunk = np.zeros((1, C), np.int64)
        chunk[0, :real] = np.asarray(req.prompt[start:start + real])
        toks = _to_device(chunk, self.device)
        positions = torch.arange(start, start + C, device=self.device)[None]
        table = st["page_table"][i:i + 1]
        heads = self.draft_heads is not None
        if not heads:
            _, st["d_cache"] = self.draft.decode_step(
                self.draft_params, toks, positions, st["d_cache"],
                long_context=self.sd.long_context, page_table=table)
        out = self.target.decode_step(self.target_params, toks, positions,
                                      st["t_cache"],
                                      long_context=self.sd.long_context,
                                      page_table=table, return_hidden=heads)
        logits, st["t_cache"] = out[0], out[1]
        slot.prefill_pos = start + real
        self.telemetry.prefill_chunks += 1
        if slot.prefill_pos < slot.prompt_len:
            return None
        if self.prefix is not None:
            # register the prompt's full pages (all positions < prompt_len,
            # so they are immutable from here on)
            n_full = slot.prompt_len // self.page_size
            if n_full > 0:
                self.prefix.insert(
                    np.asarray(req.prompt[:n_full * self.page_size]),
                    [int(p) for p in self._table_h[i][:n_full]])
        # prompt fully fed: drop the chunk's padding, sample the first token
        limit = torch.full((1,), slot.prompt_len - 1, device=self.device)
        for cache in self._caches():
            trim_paged_cache(cache, table, limit)
        last = slot.prompt_len - 1 - start
        if heads:
            st["h_feat"][i] = out[2][0, last]
        p = probs_from_logits(logits[0, last], self.sd.temperature,
                              self.sd.top_p)
        tok = sample_from_probs(p, self._gen)
        st["pending"][i] = tok
        st["lengths"][i] = slot.prompt_len
        st["active"][i] = True
        self._lengths_h[i] = slot.prompt_len
        slot.state = "decode"
        first = int(tok)
        slot.stats.first_token_time_s = self._now()   # after the fetch
        self._tr.async_instant("first_token", req.request_id,
                               ts=self._t0 + slot.stats.first_token_time_s)
        return first

    # ---------------------------------------------------------------- step
    def step(self) -> List[tuple]:
        """One engine iteration: admit; one prefill chunk; one decode round.

        Returns a list of events: ("token", request_id, np.ndarray of new
        token ids) and ("finish", request_id, Result).
        """
        t_step = time.perf_counter()
        now = self._now()
        events: List[tuple] = []
        did_work = False
        with self._tr.span("admit"):
            while True:
                req = self.scheduler.pop_admissible(now, self._can_admit)
                if req is None:
                    break
                self._admit(req, now)
                did_work = True

        prefilling = [i for i, s in enumerate(self._slots)
                      if s.state == "prefill"]
        if prefilling:
            i = min(prefilling, key=lambda j: self._slots[j].admit_seq)
            with self._tr.span("prefill_chunk", slot=i):
                if self.time_phases:
                    with self.phases.phase("prefill"), self._fence("prefill"):
                        first_tok = self._prefill_one_chunk(i)
                else:
                    first_tok = self._prefill_one_chunk(i)
            if first_tok is not None:
                events.extend(self._emit(i, np.asarray([first_tok], np.int64)))
            did_work = True

        if any(s.state == "decode" for s in self._slots):
            with self._tr.span("decode_round"):
                events.extend(self._decode_round())
            did_work = True

        if self.sanitize and self.telemetry.decode_rounds >= \
                self._last_sanitize + self.sanitize_every:
            self._last_sanitize = self.telemetry.decode_rounds
            self._sanitize_check()

        if did_work:   # idle ticks (waiting on arrivals) don't skew telemetry
            qd = self.scheduler.ready_depth(self._now())
            act = sum(s.state == "decode" for s in self._slots)
            self.telemetry.sample(qd, act, self.pool.num_free,
                                  self.pool.shared_page_fraction())
            if self._tr.enabled:
                self._tr.counter("queue_depth", qd)
                self._tr.counter("active_rows", act)
                self._tr.counter("free_pages", self.pool.num_free)
            if self.time_phases:
                self.phases.add_step(time.perf_counter() - t_step)
            if self.registry is not None:
                if self.prefix is not None:
                    self.prefix.tel.emit(self.registry)
                if self.quality_stats is not None:
                    self.quality_stats.emit(self.registry)
                if self.slo_tracker is not None:
                    self.slo_tracker.emit(self.registry)
                if self.metrics_out and \
                        self.telemetry.steps % self.metrics_every == 0:
                    self.registry.write_snapshot(self.metrics_out)
        else:
            time.sleep(5e-4)
        return events

    @contextmanager
    def _fence(self, name: str):
        """The port's ``block_until_ready`` around one timed phase: on the
        card, CUDA events at the phase's start and end, a wait on the end
        event (so the host clock around this covers the phase's device
        work), and the events' elapsed time added to
        ``phase_device_ms[name]`` (the phase's span on the card's clock,
        idle gaps included); a ``torch.profiler`` range of the same name
        marks the phase in a trace. On the CPU a no-op."""
        if self.device.type != "cuda":
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(f"phase_{name}"):
            start.record()
            yield
            end.record()
            end.synchronize()
        self.phase_device_ms[name] = (self.phase_device_ms.get(name, 0.0)
                                      + start.elapsed_time(end))

    def _run_round_phased(self, st):
        """The same round as ``_round``'s fused call, phase by phase, each
        traced, timed and fenced (``time_phases``): identical math and
        generator draws, observable seams."""
        tr, timer, gen = self._tr, self.phases, self._gen
        drafter, dp, target, tp = (self._drafter, self._d_params, self.target,
                                   self.target_params)
        with tr.span("draft"), timer.phase("draft"), self._fence("draft"):
            if self.tree is not None:
                draft_out = tree_draft_phase(drafter, self.sd, self.tree, dp,
                                             st, gen, None, target, tp)
            else:
                draft_out = sd_draft_phase(drafter, self.sd, dp, st, gen, None,
                                           target, tp)
        with tr.span("verify"), timer.phase("verify"), self._fence("verify"):
            if self.tree is not None:
                verify_out = tree_verify_phase(target, self.sd, self.tree, tp,
                                               st, draft_out)
            else:
                verify_out = sd_verify_phase(target, self.sd, tp, st, draft_out)
        with tr.span("commit"), timer.phase("commit"), self._fence("commit"):
            if self.tree is not None:
                return tree_commit_phase(self.sd, self.tree, st, draft_out,
                                         verify_out, gen)
            return sd_commit_phase(self.sd, st, draft_out, verify_out, gen)

    def _round(self, st):
        if self.time_phases:
            return self._run_round_phased(st)
        if self.tree is not None:
            return tree_round(self._drafter, self.target, self.sd, self.tree,
                              self._d_params, self.target_params, st,
                              self._gen)
        return sd_round(self._drafter, self.target, self.sd, self._d_params,
                        self.target_params, st, self._gen)

    def _decode_round(self) -> List[tuple]:
        old_len = self._lengths_h.copy()
        # the round returns a new lengths tensor: this one keeps the
        # pre-round lengths for the window gather on the card
        base = self._state["lengths"]
        t_round = time.perf_counter()
        st, _ = self._round(self._state)
        self._state = st
        # one transfer: lengths + committed windows + the fresh pending token
        # (+ the quality buffers when enabled: their float32 bits ride the
        # int64 copy unchanged)
        win = st["tokens"].gather(1, base[:, None] + self._window)
        fetch = [st["lengths"][:, None], win, st["pending"][:, None]]
        if self.quality:
            q = st["qual"]
            fetch += [q["tvd"].view(torch.int32).long(),
                      q["ent"].view(torch.int32).long(),
                      q["acc"].long(), q["drafted"].long()]
        got = fetch_to_host(torch.cat(fetch, dim=1))
        S, K = self._span, self._qdepth
        lengths_h, win_h, pending_h = got[:, 0], got[:, 1:S + 1], got[:, S + 1]
        qual_h = None
        if self.quality:
            q = got[:, S + 2:]
            qual_h = (q[:, :K].astype(np.int32).view(np.float32),
                      q[:, K:2 * K].astype(np.int32).view(np.float32),
                      q[:, 2 * K:3 * K].astype(bool), q[:, 3 * K:].astype(bool))
        # the fetch above waits for the card, so this spans the real round
        round_dt = time.perf_counter() - t_round
        self._lengths_h = lengths_h.copy()
        self.telemetry.decode_rounds += 1

        events: List[tuple] = []
        retiring: List[int] = []
        for i, slot in enumerate(self._slots):
            if slot.state != "decode":
                continue
            n_committed = int(lengths_h[i] - old_len[i])
            slot.stats.sd.update(n_committed)
            slot.stats.sd.rounds += 1
            slot.stats.sd.wall_time_s += round_dt
            if self._m_accept is not None:
                self._m_accept.observe(n_committed)
                self.registry.counter("sd_tokens_total",
                                      "committed tokens").inc(n_committed)
                self.registry.counter("sd_blocks_total",
                                      "speculation rounds").inc()
            # stream: window[0] is the previous pending (already emitted);
            # the new pending is available now and always commits next round
            fresh = np.concatenate([win_h[i, 1:n_committed], [pending_h[i]]])
            events.extend(self._emit(i, fresh.astype(np.int64)))
            if lengths_h[i] >= slot.target_len:
                retiring.append(i)
        if self.quality:
            self._pool_quality(qual_h)
        if self.recorder is not None:
            self._record_round(qual_h, old_len, lengths_h)
        for i in retiring:
            events.append(self._retire(i))
        return events

    def _pool_quality(self, qual_h):
        """Fold this round's quality buffers into the per-request,
        per-tenant and engine-wide accumulators; a drift alarm on the
        engine pool triggers a flight-recorder dump."""
        tvd_h, ent_h, acc_h, drafted_h = qual_h
        rows = [i for i, s in enumerate(self._slots) if s.state == "decode"]
        if not rows:
            return
        for i in rows:
            rq = self._slots[i].stats.quality
            if rq is not None:
                rq.update_round(tvd_h[i], ent_h[i], acc_h[i], drafted_h[i])
        by_tenant: Dict[str, List[int]] = {}
        for i in rows:
            tenant = getattr(self._slots[i].req, "tenant", "") or ""
            by_tenant.setdefault(tenant, []).append(i)
        for tenant, idxs in by_tenant.items():
            qs = self.tenant_quality.get(tenant)
            if qs is None:
                qs = self.tenant_quality[tenant] = QualityStats(
                    depth=self._qdepth)
            qs.update_round(tvd_h[idxs], ent_h[idxs], acc_h[idxs],
                            drafted_h[idxs])
        alarm = self.quality_stats.update_round(
            tvd_h[rows], ent_h[rows], acc_h[rows], drafted_h[rows])
        if alarm and self.recorder is not None:
            self.recorder.dump("drift_alarm", context={
                "decode_rounds": self.telemetry.decode_rounds,
                "quality": self.quality_stats.snapshot()})

    def _record_round(self, qual_h, old_len, lengths_h):
        """One bounded flight-recorder entry per decode round."""
        slots = {}
        for i, s in enumerate(self._slots):
            if s.state != "decode":
                continue
            rec = {"request_id": s.req.request_id,
                   "committed": int(lengths_h[i] - old_len[i])}
            if qual_h is not None:
                tvd_h, _, acc_h, drafted_h = qual_h
                d = drafted_h[i]
                rec["accept"] = [bool(b) for b in acc_h[i]]
                rec["mean_tvd"] = float(tvd_h[i][d].mean()) if d.any() else None
            slots[i] = rec
        entry = {"slots": slots,
                 "queue_depth": self.scheduler.ready_depth(self._now()),
                 "free_pages": self.pool.num_free,
                 "active_rows": len(slots)}
        if self.time_phases:
            entry["phase_s"] = {k: round(v, 6)
                                for k, v in self.phases.seconds.items()}
        self.recorder.record_round(**entry)

    # ---------------------------------------------------------------- sanitize
    def _sanitize_check(self):
        """Debug-mode paged-pool invariant sweep (``sanitize=True``).

        Pure host-side bookkeeping checks, no device syncs:
          1. ``PagedKVPool.check_invariants`` with the prefix cache's live
             node count;
          2. the host page-table mirror (what the round reads) matches the
             pool's per-slot mapping;
          3. a physical page mapped by k rows carries a refcount >= k;
          4. shared pages (refcount > 1) mapped by a decode row lie strictly
             below that row's committed length (the read-only contract).
        Raises AssertionError naming the slot/page on violation.
        """
        cache_refs = self.prefix.num_nodes if self.prefix is not None else 0
        self.pool.check_invariants(cache_refs=cache_refs)
        mapped_by: Dict[int, List[int]] = {}
        for i, slot in enumerate(self._slots):
            row = self.pool.table_row(i)
            if not np.array_equal(row, self._table_h[i]):
                raise AssertionError(
                    f"sanitize: slot {i} host table mirror "
                    f"{self._table_h[i].tolist()} diverged from pool mapping "
                    f"{row.tolist()}")
            for page in row:
                if page != 0:
                    mapped_by.setdefault(int(page), []).append(i)
            if slot.state == "decode":
                committed = int(self._lengths_h[i])
                for logical, page in enumerate(row):
                    if page != 0 and self.pool.page_ref(int(page)) > 1 and \
                            (logical + 1) * self.page_size > committed:
                        raise AssertionError(
                            f"sanitize: slot {i} maps shared page {page} at "
                            f"logical index {logical} covering positions up "
                            f"to {(logical + 1) * self.page_size} but has "
                            f"only committed {committed} — decode would "
                            f"write a shared page")
        for page, rows in mapped_by.items():
            if len(rows) > 1 and self.pool.page_ref(page) < len(rows):
                raise AssertionError(
                    f"sanitize: page {page} mapped by rows {rows} with "
                    f"refcount {self.pool.page_ref(page)} < {len(rows)}")

    def _emit(self, i: int, toks: np.ndarray) -> List[tuple]:
        slot = self._slots[i]
        room = (slot.target_len - slot.prompt_len) - slot.emitted
        toks = toks[:max(room, 0)]
        if toks.size == 0:
            return []
        slot.emitted += int(toks.size)
        slot.stats.new_tokens = slot.emitted
        slot.out.append(toks)
        if slot.req.on_token is not None:
            slot.req.on_token(slot.req.request_id, toks)
        return [("token", slot.req.request_id, toks)]

    def _retire(self, i: int) -> tuple:
        """Finish slot i: its result is the streamed tokens (exactly the
        committed tokens[prompt_len:target_len]); only pages whose refcount
        hit zero are invalidated, since prefix pages may back other rows."""
        slot, st = self._slots[i], self._state
        slot.stats.finish_time_s = self._now()
        slot.stats.new_tokens = slot.target_len - slot.prompt_len
        if self.slo_tracker is not None:
            breached = self.slo_tracker.observe(slot.stats.ttft_s,
                                                slot.stats.tpot_s)
            if breached and self.recorder is not None:
                self.recorder.dump("slo_breach", context={
                    "request_id": slot.req.request_id,
                    "metrics": breached,
                    "slo": self.slo_tracker.snapshot()})
        freed = self.pool.free_slot(i)
        if freed:
            for cache in self._caches():
                invalidate_pages(cache, freed)
        self._table_h[i] = 0
        st["page_table"].copy_(_to_device(self._table_h, self.device))
        st["active"][i] = False
        result = Result(request_id=slot.req.request_id,
                        tokens=np.concatenate(slot.out),
                        tau=slot.stats.sd.tau,
                        wall_time_s=slot.stats.finish_time_s
                        - slot.stats.submit_time_s,
                        rounds=slot.stats.sd.rounds)
        self._tr.async_end("request", slot.req.request_id,
                           ts=self._t0 + slot.stats.finish_time_s,
                           new_tokens=slot.stats.new_tokens,
                           tau=round(slot.stats.sd.tau, 4))
        req = slot.req
        self._slots[i] = _Slot()
        self.telemetry.completed += 1
        if req.on_finish is not None:
            req.on_finish(result)
        return ("finish", result.request_id, result)

    # ---------------------------------------------------------------- run loop
    def has_work(self) -> bool:
        return len(self.scheduler) > 0 or any(
            s.state != "free" for s in self._slots)

    def stream(self):
        """Generator yielding events until the engine drains. With the
        flight recorder on, an exception escaping the loop dumps the ring
        (reason "crash") before propagating."""
        try:
            while self.has_work():
                yield from self.step()
        except Exception as e:
            if self.recorder is not None:
                ctx = {"error": f"{type(e).__name__}: {e}"}
                if self.quality_stats is not None:
                    ctx["quality"] = self.quality_stats.snapshot()
                self.recorder.dump("crash", context=ctx)
            raise

    def run(self) -> List[Result]:
        out = [ev[2] for ev in self.stream() if ev[0] == "finish"]
        if self.sanitize:
            self._sanitize_check()   # drained end state: no leaked pages
        self.finalize_metrics()
        return out

    def finalize_metrics(self):
        """Final registry snapshot at drain (periodic ones are step-gated)."""
        if self.registry is not None and self.metrics_out:
            self.registry.write_snapshot(self.metrics_out)

    def serve(self, requests: Sequence) -> List[Result]:
        """Submit ``requests`` (``ServeRequest``s, or the static engine's
        ``Request``s) and run until all finish; results by request id."""
        for r in requests:
            if isinstance(r, Request):
                r = ServeRequest(prompt=r.prompt,
                                 max_new_tokens=r.max_new_tokens,
                                 request_id=r.request_id)
            self.submit(r)
        return sorted(self.run(), key=lambda r: r.request_id)
