"""Continuous-batching decode loop over the paged KV arena.

The scheduler's micro-batching coalesces decode steps that happen to
arrive inside one window; between windows the (possibly fused) instance
idles while every client round-trips its own future. The continuous
batcher replaces that rendezvous with a *persistent in-flight batch*: one
decode loop drives a fixed power-of-two-capacity batch step after step,
and requests JOIN the batch at any step boundary (post-prefill) and LEAVE
on EOS or their step limit. Empty slots are masked — their block-table
rows point at the arena's scratch page and their ``cur_len`` is zero — so
the step's shapes never change (one fused unit serves every step) and no
request ever waits for a batch to "form".

Admission runs through SLO class lanes (:class:`ClassLanes`): when a slot
frees, the waiting request of the *strictest* class takes it first — the
slot-assignment analogue of the admission queues' window preemption. A
transient :class:`~repro_torch.serving.kvpool.ArenaFull` re-queues the
request at the front of its lane; optionally best-effort arrivals beyond
``max_queue`` are shed (fail fast) so an overload degrades background
traffic before strict classes queue.

Chunked prefill: a joiner's prompt no longer serializes in front of the
batch. Admission starts a *prefill job* (pages allocated through the
arena's shared-prefix cache) and the loop advances it ONE budgeted chunk
between decode steps, so residents keep emitting while the joiner's
prompt streams in. The per-step chunk budget comes from the strict lane's
inter-token slack: with EWMA estimates of per-token prefill time and the
batch step time (same :class:`ServiceTimeEstimate` the queueing windows
use), the budget is the token count that fits inside
``slack_fraction x min-strict-slack - step_time``, floored at
``min_chunk`` so prefills always progress. ``serialize_prefill=True``
restores the old admit-time full prefill (the comparison baseline), and
``prefill_chunk=N`` pins the chunk size for deterministic tests.

Every request's RAM bill is its pages: on exit the batcher records an
:class:`~repro_torch.core.billing.ArenaLease` — peak pages held x page
bytes x residency seconds — the per-request GB-s the paper's RAM-reduction
story is about.

The card is read twice per request path and no more: one device-to-host
fetch of the batch's next tokens per decode step, and one of the first
token per seated request. Prompts stay on the host.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future

import numpy as np

from repro_torch import tree
from repro_torch.core.billing import ArenaLease
from repro_torch.scheduler.adaptive import ServiceTimeEstimate
from repro_torch.scheduler.batching import largest_pow2_le
from repro_torch.scheduler.scheduler import OverloadShedError
from repro_torch.scheduler.slo import BEST_EFFORT, ClassLanes, SLOClass
from repro_torch.serving.engine import ServingEngine, _greedy_token
from repro_torch.serving.kvpool import ArenaFull, KVArena


class ShedError(OverloadShedError):
    """Best-effort request shed at admission (batcher queue bound hit).
    Subclasses the scheduler's OverloadShedError so one except clause
    implements a client's back-off policy for both admission paths."""


def _deliver(future: Future, *, result=None, exc=None) -> None:
    """Resolve a future the client may have CANCELLED meanwhile — the
    InvalidStateError must not fail co-resident requests or kill the decode
    loop thread (same contract as the coalescer's _resolve)."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except Exception:
        if not future.cancelled():
            raise


class _Request:
    __slots__ = (
        "inputs", "max_new_tokens", "eos_id", "slo", "future",
        "t_submit", "t_alloc", "t_admit", "tokens", "step_s", "seq_id",
        "cur_len", "remaining", "next_token", "last_emit", "job",
        "span", "psid",
    )

    def __init__(self, inputs, max_new_tokens, eos_id, slo, future, t_submit):
        self.inputs = inputs
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.slo = slo
        self.future = future
        self.t_submit = t_submit
        self.t_alloc = 0.0
        self.t_admit = 0.0
        self.tokens: list[int] = []
        self.step_s: list[float] = []
        self.seq_id = None
        self.cur_len = 0
        self.remaining = 0
        self.next_token = 0
        self.last_emit = 0.0
        self.job = None  # PagedPrefillJob while the chunked prefill runs
        self.span = None  # obs.SpanContext root (None when tracing off)
        self.psid = None  # pre-allocated prefill-stall span id (chunk parent)


class ContinuousBatcher:
    """Persistent decode batch over a paged ServingEngine.

    ``capacity`` clamps to the largest power of two <= the request (one
    step shape serves every step). ``max_queue`` (optional) bounds
    the admission lanes: best-effort arrivals beyond it are shed.

    The batcher assumes exclusive use of the engine's arena while running:
    all page allocation and all decode-step store-backs happen on its one
    loop thread (don't interleave ``generate_paged`` with a live batcher)."""

    # provlint: submit-side state shared with the loop thread. Slot state
    # (_slots/_bt/_cur/_tok/...) is loop-thread-only and needs no lock.
    GUARDED_FIELDS = {
        "_lanes": "_cv",
        "_stopped": "_cv",
        "shed": "_cv",
    }

    def __init__(self, engine: ServingEngine, *, capacity: int = 8,
                 max_queue: int | None = None,
                 prefill_chunk: int | None = None,
                 serialize_prefill: bool = False,
                 min_chunk: int = 8,
                 slack_fraction: float = 0.5):
        if engine.arena is None:
            raise ValueError("engine needs enable_paging() before continuous batching")
        self.engine = engine
        self.clock = engine.platform.clock
        self.capacity = largest_pow2_le(capacity)
        self.max_queue = max_queue
        self.prefill_chunk = prefill_chunk      # fixed chunk size override
        self.serialize_prefill = serialize_prefill
        self.min_chunk = max(1, int(min_chunk))
        self.slack_fraction = float(slack_fraction)
        self._est_prefill = ServiceTimeEstimate()  # seconds per PREFILL TOKEN
        self._est_step = ServiceTimeEstimate()     # seconds per batch decode step
        self._job: _Request | None = None          # the one in-flight chunked prefill
        self.prefill_chunks = 0
        self._slots: list[_Request | None] = [None] * self.capacity
        # persistent per-slot step inputs: block-table rows are rebuilt only
        # when a slot's page set changes (join / page-boundary extend /
        # leave), not on every step — empty rows stay all-scratch
        self._bt = np.zeros((self.capacity, engine.block_width), np.int32)
        self._cur = np.zeros((self.capacity,), np.int32)
        self._tok = np.zeros((self.capacity, 1), np.int32)
        self._lanes = ClassLanes()
        self._cv = threading.Condition()
        self._stopped = False
        self._seq = 0
        self.steps = 0
        self.tokens_out = 0
        self.completed = 0
        self.shed = 0
        self._occupancy_sum = 0
        # a tracer (duck-typed; the port's platform has none yet, so this
        # stays None): every submit mints a "serve" trace whose queue-wait /
        # prefill-stall (+ chunk children) / batch-compute phases tile
        # [t_submit, t_done] exactly
        self._tracer = getattr(engine.platform, "tracer", None)
        self._thread = threading.Thread(target=self._loop, daemon=True, name="continuous-batcher")
        self._thread.start()

    # ----------------------------------------------------------------- API

    def submit(self, inputs: dict, max_new_tokens: int, *,
               slo: SLOClass | None = None, eos_id: int | None = None) -> Future:
        """Admit one generation request. Returns a Future resolving to
        ``{"tokens": (1, n) int32, "step_s": per-token seconds, "pages":
        peak pages held, "queued_s": lane wait}``."""
        slo = slo or BEST_EFFORT
        b = tree.leaves(inputs)[0].shape[0]
        if b != 1:
            # one request = one sequence = one slot; a multi-row prompt
            # would silently serve only row 0 (split it client-side)
            raise ValueError(f"ContinuousBatcher serves one sequence per request, got batch {b}")
        fut: Future = Future()
        req = _Request(inputs, max_new_tokens, eos_id, slo, fut, self.clock.now())
        if self._tracer is not None:
            req.span = self._tracer.begin_request(
                self.engine.entry, "serve", t0=req.t_submit,
                attrs={"slo": slo.name, "max_new_tokens": req.max_new_tokens})
        with self._cv:
            if self._stopped:
                raise RuntimeError("batcher is shut down")
            be_depth = self._lanes.best_effort_depth()
            if (
                self.max_queue is not None
                and slo.best_effort
                and be_depth >= self.max_queue
            ):
                # shed on the BEST-EFFORT backlog only (queued strict
                # traffic must not push background work out — same depth
                # semantics as the scheduler's be_shed_depth)
                self.shed += 1
                fut.set_exception(ShedError(
                    f"best-effort shed: {be_depth} queued >= {self.max_queue}"
                ))
                self._fail_span(req, "ShedError")
                return fut
            self._lanes.push(req, slo)
            self._cv.notify_all()
        return fut

    def stats(self) -> dict:
        with self._cv:
            active = sum(1 for s in self._slots if s is not None)
            return {
                "capacity": self.capacity,
                "active": active,
                "queued": self._lanes.counts(),
                "steps": self.steps,
                "tokens": self.tokens_out,
                "completed": self.completed,
                "shed": self.shed,
                "prefill_chunks": self.prefill_chunks,
                "prefilling": self._job is not None,
                "mean_occupancy": (self._occupancy_sum / self.steps / self.capacity)
                if self.steps else 0.0,
                "arena": self.engine.arena.stats(),
            }

    def reset_stats(self) -> None:
        """Zero the step/occupancy/completion counters (benchmark warmup
        isolation — same discipline as scheduler.reset_stats)."""
        with self._cv:
            self.steps = 0
            self.tokens_out = 0
            self.completed = 0
            self.shed = 0
            self.prefill_chunks = 0
            self._occupancy_sum = 0

    def shutdown(self, timeout: float = 30.0) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout)

    # ------------------------------------------------------------ internals

    @staticmethod
    def _fail_span(req: _Request, error: str) -> None:
        """Close a request's trace root on an error/shed path — the span tree
        stays latency-conserving (an unfinished root would drop the whole
        trace from attribution)."""
        if req.span is not None:
            req.span.finish(args={"error": error})

    def _admit(self) -> None:
        """Fill free slots from the lanes, strictest class first. Runs on
        the loop thread. The chunked path (default for token prompts)
        starts ONE prefill job and returns — the loop interleaves its
        chunks with decode steps via :meth:`_prefill_tick`, and the next
        admission waits for the job to seat. ``serialize_prefill`` (or a
        non-token prompt) takes the old full-prefill-at-admit path."""
        while True:
            if self._job is not None:
                return  # a chunked prefill is in flight: it owns admission
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                return
            with self._cv:
                got = self._lanes.pop()
            if got is None:
                return
            req, slo = got
            arena = self.engine.arena
            t_in = tree.leaves(req.inputs)[0].shape[1]
            # the LAST decode step writes position t_in + max_new - 2; the
            # whole lifetime must fit the table and the pool, or the request
            # is permanently unservable: fail fast — requeueing would starve
            # the lane forever, and admitting would blow up mid-flight and
            # take every co-resident stream down with it
            final_len = t_in + max(0, req.max_new_tokens - 1)
            need = arena.pages_for(final_len)
            if need > min(arena.num_pages - 1, self.engine.block_width):
                _deliver(req.future, exc=ArenaFull(
                    f"prompt {t_in} + {req.max_new_tokens} generated tokens needs "
                    f"{need} pages; pool holds {arena.num_pages - 1}, "
                    f"table {self.engine.block_width}"
                ))
                self._fail_span(req, "ArenaFull")
                continue
            self._seq += 1
            req.seq_id = ("cb", self._seq)
            # residency starts when the pages do: both admission paths
            # allocate BEFORE running any chain, and the lease bills that too
            req.t_alloc = self.clock.now()
            if not self.serialize_prefill and "tokens" in req.inputs:
                try:
                    req.job = self.engine.begin_prefill_paged(req.seq_id, req.inputs)
                except ArenaFull:
                    with self._cv:
                        self._lanes.requeue(req, slo)  # transient: residents
                    return                             # will free pages
                except BaseException as exc:  # noqa: BLE001 — deliver, don't kill the loop
                    _deliver(req.future, exc=exc)
                    self._fail_span(req, type(exc).__name__)
                    continue
                self._job = req
                return
            try:
                logits, t_in = self.engine.prefill_paged(req.seq_id, req.inputs)
            except ArenaFull:
                with self._cv:
                    self._lanes.requeue(req, slo)  # transient: residents will
                return                             # free pages; retry first
            except BaseException as exc:  # noqa: BLE001 — deliver, don't kill the loop
                _deliver(req.future, exc=exc)
                self._fail_span(req, type(exc).__name__)
                continue
            req.cur_len = t_in
            self._seat(req, logits)

    def _seat(self, req: _Request, logits) -> None:
        """Prefill finished (either path): emit the first token and take a
        free slot — one is guaranteed, because slots only fill through this
        method and admission checked before starting."""
        req.t_admit = self.clock.now()
        if req.span is not None:
            # exact tiling of [t_submit, t_admit]: lane wait, then prompt
            # processing (chunk spans nest under the stall, so stall
            # self-time = time the prompt WAITED between chunks)
            req.span.emit("queue-wait", "queue-wait", req.t_submit, req.t_alloc)
            req.span.emit("prefill-stall", "prefill-stall", req.t_alloc,
                          req.t_admit, span_id=req.psid)
        req.last_emit = req.t_admit  # first token emitted at admission
        req.remaining = req.max_new_tokens
        first = int(_greedy_token(logits)[0, 0])  # the one fetch per seated request
        req.tokens.append(first)
        req.remaining -= 1
        req.next_token = first
        if req.remaining <= 0 or first == req.eos_id:
            self._finish(req)
            return
        slot = next(i for i, s in enumerate(self._slots) if s is None)
        self._slots[slot] = req
        self._bt[slot] = self.engine.arena.block_row(req.seq_id, self.engine.block_width)

    def _chunk_budget(self, req: _Request) -> int:
        """Prompt tokens the in-flight prefill may process this tick.

        Derived from the strict residents' inter-token slack: the chunk
        must fit inside ``slack_fraction x min(target - time_since_last
        _emit)`` minus the decode step the residents still need, using the
        EWMA per-token prefill estimate. Floored at ``min_chunk`` so cold
        starts and exhausted slack still make progress (starving the
        prefill forever would just move the stall to the joiner)."""
        remaining = req.job.remaining
        if self.prefill_chunk is not None:
            return self.prefill_chunk
        strict = [r for r in self._slots if r is not None and not r.slo.best_effort]
        if not strict:
            return max(self.min_chunk, remaining)  # nobody to protect
        per_tok = self._est_prefill.value
        if per_tok is None or per_tok <= 0.0:
            return self.min_chunk  # cold start: seed the estimate cheaply
        now = self.clock.now()
        slack = min(max(0.0, r.slo.target_s - (now - r.last_emit)) for r in strict)
        step_s = self._est_step.value or 0.0
        budget_s = max(0.0, self.slack_fraction * slack - step_s)
        return max(self.min_chunk, int(budget_s / per_tok))

    def _prefill_tick(self) -> bool:
        """Advance the in-flight chunked prefill by one budgeted chunk;
        seat the request when its prompt completes. Returns True if a
        chunk ran (the loop uses it to keep spinning while idle-but-
        prefilling)."""
        req = self._job
        if req is None:
            return False
        budget = self._chunk_budget(req)
        pos0 = req.job.pos
        t0 = self.clock.now()
        try:
            logits = self.engine.prefill_chunk_paged(req.job, budget)
        except BaseException as exc:  # noqa: BLE001 — deliver, don't kill the loop
            self._job = None
            self.engine.arena.free(req.seq_id)
            _deliver(req.future, exc=exc)
            self._fail_span(req, type(exc).__name__)
            return True
        done = req.job.pos - pos0
        t1 = self.clock.now()
        if done > 0:  # a whole-prompt cache hit computes zero prompt tokens
            self._est_prefill.observe((t1 - t0) / done)
        if req.span is not None:
            if req.psid is None:
                # parent for every chunk: the prefill-stall span _seat emits
                # over [t_alloc, t_admit] once the prompt completes
                req.psid = req.span.alloc_id()
            req.span.emit("prefill-chunk", "prefill-chunk", t0, t1,
                          parent_id=req.psid, args={"tokens": done})
        self.prefill_chunks += 1
        if logits is None:
            return True  # more chunks to go
        self._job = None
        req.cur_len = req.job.t_in
        req.job = None
        self._seat(req, logits)
        return True

    def _release_slot(self, i: int) -> None:
        """Clear a slot back to masked: all-scratch row, zero length/token."""
        self._slots[i] = None
        self._bt[i] = KVArena.RESERVED_PAGE
        self._cur[i] = 0
        self._tok[i, 0] = 0

    def _finish(self, req: _Request) -> None:
        pages = self.engine.arena.peak_pages(req.seq_id)
        # sampled BEFORE free: each still-held page weighted by 1/refcount,
        # so a shared prefix is billed once across the fleet holding it
        amortized = self.engine.arena.amortized_pages(req.seq_id)
        self.engine.arena.free(req.seq_id)
        t_done = self.clock.now()
        self.engine.platform.meter.record_arena(ArenaLease(
            function=self.engine.entry,
            request_id=str(req.seq_id),
            pages=pages,
            page_bytes=self.engine.arena.page_bytes,
            t_alloc=req.t_alloc,
            t_free=t_done,
            amortized_pages=amortized,
        ))
        self.completed += 1
        self.tokens_out += len(req.tokens)
        if req.span is not None:
            req.span.emit("batch-compute", "batch-compute", req.t_admit, t_done,
                          args={"tokens": len(req.tokens)})
            req.span.finish(t_done, args={"tokens": len(req.tokens),
                                          "pages": pages})
        _deliver(req.future, result={
            "tokens": np.asarray(req.tokens, np.int32)[None, :],
            "step_s": list(req.step_s),
            "pages": pages,
            "amortized_pages": amortized,
            "queued_s": req.t_admit - req.t_submit,
        })

    def _step(self) -> None:
        """One decode step for the whole fixed-capacity batch."""
        width = self.engine.block_width
        active = []
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            try:
                added = self.engine.arena.extend(req.seq_id, req.cur_len + 1)
                # the write position may sit on a SHARED page (a prefix-
                # cache hit whose partial tail page another sequence also
                # holds): copy-on-write it before the step's scatter
                moved = self.engine.arena.make_private(req.seq_id, req.cur_len)
            except ArenaFull:
                # pool exhausted mid-flight: truncate THIS request (deliver
                # what it generated) instead of failing the whole batch
                self._release_slot(i)
                self._finish(req)
                continue
            if added or moved:  # this slot's page set changed
                self._bt[i] = self.engine.arena.block_row(req.seq_id, width)
                if req.span is not None:
                    # page-extend / copy-on-write land as instants on the
                    # request's own timeline (CoW = a shared prefix page
                    # privatized before this step's scatter)
                    req.span.event("page-cow" if moved else "page-extend",
                                   args={"added": bool(added),
                                         "cow": bool(moved),
                                         "len": req.cur_len})
            self._tok[i, 0] = req.next_token
            self._cur[i] = req.cur_len
            active.append(i)
        logits = self.engine.paged_decode_step(self._tok, self._cur, self._bt)
        nxt = _greedy_token(logits).cpu().numpy()  # the one fetch per decode step
        now = self.clock.now()
        self.steps += 1
        self._occupancy_sum += len(active)
        for i in active:
            req = self._slots[i]
            tok = int(nxt[i, 0])
            req.tokens.append(tok)
            # inter-token time = gap since this request's LAST emission, so
            # stalls between steps (a joining request's serialized prefill)
            # are charged honestly, not just the decode-step compute
            req.step_s.append(now - req.last_emit)
            req.last_emit = now
            req.cur_len += 1
            req.remaining -= 1
            req.next_token = tok
            if req.remaining <= 0 or tok == req.eos_id:
                self._release_slot(i)
                self._finish(req)

    def _loop(self) -> None:
        while True:
            self._admit()
            # one prefill chunk rides between decode steps: residents keep
            # emitting while a joiner's prompt streams in
            prefilled = self._prefill_tick()
            busy = any(s is not None for s in self._slots)
            if not busy:
                if prefilled:
                    continue  # mid-prefill with no residents: next chunk now
                with self._cv:
                    if self._stopped:
                        break
                    # parks for new submits AND paces admission retries when
                    # the arena is transiently full (externally held pages);
                    # through the injected clock so the batcher is drivable
                    # in simulated time like every other timed wait
                    self.clock.wait_on(self._cv, 0.05)
                    continue
            t0 = self.clock.now()
            try:
                self._step()
                self._est_step.observe(self.clock.now() - t0)
            except BaseException as exc:  # noqa: BLE001 — a raising step must
                # fail the in-flight requests, not silently kill the loop
                for i, req in enumerate(self._slots):
                    if req is not None:
                        self._release_slot(i)
                        self.engine.arena.free(req.seq_id)
                        _deliver(req.future, exc=exc)
                        self._fail_span(req, type(exc).__name__)
            with self._cv:
                if self._stopped and all(s is None for s in self._slots) \
                        and self._lanes.depth() == 0 and self._job is None:
                    break
        # drain: fail the in-flight prefill and whatever is still queued so
        # no client hangs
        if self._job is not None:
            req, self._job = self._job, None
            self.engine.arena.free(req.seq_id)
            _deliver(req.future, exc=RuntimeError("batcher shut down"))
            self._fail_span(req, "shutdown")
        with self._cv:
            while True:
                got = self._lanes.pop()
                if got is None:
                    break
                _deliver(got[0].future, exc=RuntimeError("batcher shut down"))
                self._fail_span(got[0], "shutdown")
