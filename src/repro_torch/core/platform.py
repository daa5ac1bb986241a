"""Provuse platform: deploy / invoke / observe / fuse / split / replicate.

Two external invocation paths, as in the JAX package:

* ``invoke`` — the paper's serial path: one request executed to completion
  in (or via) the calling thread.
* ``invoke_async`` — returns a Future; the request scheduler coalesces
  concurrent compatible requests into micro-batches that run as one
  batched program (``FunctionInstance.execute_batch``).

With ``enable_snapshots`` (or ``snapshot_dir=``) the platform gains
scale-to-zero: ``scale_to_zero(name)`` snapshots an instance's weights into
the content-addressed :class:`~repro_torch.checkpointing.SnapshotStore` and
unroutes it (a "park" epoch); the next invoke resurrects it — restore from
the snapshot to each leaf's own device, health check on the captured canary,
publish — and its entries come from the executable index when they were
seen before. ``idle_park_s > 0`` parks instances from the reconciler tick
once every member has been idle that long.

A merge can be undone: with ``fission=True`` the reconciler runs the regret
check over the committed groups (``Merger.evaluate_splits``) and splits a
group whose live signals say the merge was a mistake. A name may be served
by an ordered replica set: ``enable_autoscaler`` (or ``autoscale=True``)
scales replicas out on sustained predicted load and back in at troughs, and
a replica holds the spec's own tensors (it never copies the weights).

Two backends mirror the paper's two implementations:

* :class:`TinyTorchBackend` — the tinyFaaS analogue: a minimal in-process
  dispatcher. Invocations execute in the calling thread; routing is a dict
  lookup; async branches run on a small shared pool.
* :class:`OrchestratedBackend` — the Kubernetes analogue: every execution
  unit gets a worker (queue + thread = Pod), invocations travel through a
  Service-like indirection (routing table -> worker queue -> Future),
  merged units go through a readiness gate before the Service selector
  flips (rolling swap), and displaced units are drained before their worker
  stops. On the card every pod launches on its device's current stream, as
  every execution of an XLA device runs on that device's one compute stream.

The Function Handler, Merger, policy, control plane and billing meter are
backend-agnostic, as the paper shows.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import torch

from repro_torch import tree
from repro_torch.core.billing import BillingMeter, ProvisioningRecord
from repro_torch.core.context import AbstractContext
from repro_torch.core.errors import DeploymentError, InvocationError, UnknownFunctionError
from repro_torch.core.function import FunctionInstance, FunctionSpec, _cuda_device, _struct_key, _structs_of
from repro_torch.core.handler import FunctionHandler
from repro_torch.core.lifecycle import ControlPlane
from repro_torch.core.merger import Merger
from repro_torch.core.policy import FusionPolicy
from repro_torch.core.registry import RoutingTable
from repro_torch.obs.critical_path import EdgeCostModel
from repro_torch.obs.trace import Tracer
from repro_torch.scheduler.clock import SYSTEM_CLOCK
from repro_torch.scheduler.scheduler import RequestScheduler
from repro_torch.scheduler.slo import SLOClass


@dataclasses.dataclass
class _ParkedFunction:
    """Scale-to-zero residue of one function: a params-free spec stub plus
    the snapshot address to resurrect from. While parked the function holds
    NO live weights or programs — and generates no billing records.
    ``devices``: each leaf's device (a meta tensor has none), so that a leaf
    that lived on the card is restored there and nowhere else."""

    spec: FunctionSpec        # params=None stub (behavior only)
    digest: str               # SnapshotStore content address of the params
    like: Any                 # meta-tensor tree for restore()
    devices: Any              # the same tree of device names
    parked_t: float


class ProvusePlatform:
    """Base platform: ``invoke`` (serial) and ``invoke_async`` (scheduled,
    micro-batched); with snapshots, ``scale_to_zero`` and resurrect; with
    ``fission``, splits; with an autoscaler, replica sets."""

    backend_name = "base"

    GUARDED_FIELDS = {
        "_pending_candidates": "_pending_lock",
        "_parked": "_parked_lock",
        "_resurrecting": "_parked_lock",
        "_deployed_at": "_parked_lock",
        "_prov_records": "_prov_lock",
        "_resurrect_parts": "_prov_lock",
        "_compile_hits": "_prov_lock",
        "_compile_misses": "_prov_lock",
        "_compile_saved_s": "_prov_lock",
        "_compile_spent_s": "_prov_lock",
        "_spinup_ewma_s": "_prov_lock",
    }

    def __init__(self, policy: FusionPolicy | None = None, *, async_build: bool = False,
                 health_rtol: float = 2e-2, health_atol: float = 1e-2,
                 max_batch: int = 8, max_delay_ms: float = 2.0,
                 adaptive: bool = False, adaptive_config=None,
                 be_shed_depth: int | None = None,
                 fission: bool = False, fission_interval_s: float = 0.25,
                 trough_merges: bool = False, max_defer_s: float = 1.0,
                 snapshot_dir: str | None = None, idle_park_s: float = 0.0,
                 spread=None, autoscale: bool = False,
                 autoscale_config: dict | None = None,
                 clock=None, tracing: bool = True):
        self.clock = clock or SYSTEM_CLOCK
        # Always-on causal tracing: every entry point mints a SpanContext,
        # every phase lands in the tracer's flight recorder, and the
        # EdgeCostModel turns measured sync waits / merge stalls into the
        # policy's cost inputs. ``tracing=False`` disables span minting
        # (the overhead-gate baseline) without touching any call site.
        self.tracer = Tracer(clock=self.clock, enabled=tracing)
        self.edge_costs = EdgeCostModel()
        # spread: replica selection policy for multi-replica routes —
        # "least-outstanding" (default) or "round-robin" (see registry).
        self.registry = RoutingTable(spread=spread)
        self.meter = BillingMeter(clock=self.clock)
        self.policy = policy or FusionPolicy()
        if self.policy.cost_model is None:
            self.policy.cost_model = self.edge_costs
        self.handler = FunctionHandler(self.meter, on_fusion_candidate=self._on_candidate,
                                       clock=self.clock, tracer=self.tracer)
        # Control plane: every deploy/merge/split/redeploy/park/resurrect/scale
        # is an epoch transition published through here; the reconciler thread
        # (started lazily) runs the tick hooks and executes deferred
        # transitions during traffic troughs.
        self.lifecycle = ControlPlane(self, self.registry, max_defer_s=max_defer_s,
                                      clock=self.clock)
        # trough_merges: promoted merges queue on the reconciler and run at
        # the next observed trough instead of stalling live traffic.
        self.trough_merges = trough_merges
        self.merger = Merger(self, self.policy, async_build=async_build,
                             health_rtol=health_rtol, health_atol=health_atol)
        self.scheduler = RequestScheduler(
            self._dispatch_batch, max_batch=max_batch, max_delay_ms=max_delay_ms,
            adaptive=adaptive, adaptive_config=adaptive_config,
            be_shed_depth=be_shed_depth,
            on_request_done=lambda name, lat_s, k: self.meter.observe_latency(name, lat_s),
            clock=self.clock,
            tracer=self.tracer,
        )
        # fission: the reconciler periodically runs the regret check
        # (Merger.evaluate_splits) so a merge the live signals say was a
        # mistake gets reversed — see FusionPolicy.decide_split. Registered
        # after the scheduler exists: the hook starts the reconciler thread,
        # which reads scheduler signals.
        self._fission_interval_s = fission_interval_s
        self._last_fission_eval = 0.0
        if fission:
            self.lifecycle.add_tick_hook(self._fission_tick)
        self._specs: dict[str, FunctionSpec] = {}
        self._shape_cache: dict[tuple, Any] = {}
        self._shape_stack: list[str] = []
        self._shape_lock = threading.RLock()
        # Fusion candidates are processed OFF the data path: an edge observed
        # mid-request is queued and the merge runs after the request
        # completes — control-plane work does not belong on the request path.
        self._pending_candidates: list[tuple[str, str]] = []
        self._pending_lock = threading.Lock()
        self._draining = threading.Lock()
        # --- warm provisioning / scale-to-zero state ---
        self.snapshots = None  # SnapshotStore once enable_snapshots() runs
        self._idle_park_s = 0.0
        self._parked: dict[str, _ParkedFunction] = {}
        self._resurrecting: dict[str, tuple[threading.Thread, threading.Event]] = {}
        self._deployed_at: dict[str, float] = {}
        self._parked_lock = threading.Lock()
        self._prov_records: list = []
        self._resurrect_parts: collections.deque[dict] = collections.deque(maxlen=32)
        self._compile_hits = 0
        self._compile_misses = 0
        self._compile_saved_s = 0.0
        self._compile_spent_s = 0.0
        # EWMA of measured replica spin-up wall time (None until the first
        # spin-up) — the fusion policy's replicate-arm cost input.
        self._spinup_ewma_s: float | None = None
        self._prov_lock = threading.Lock()
        if snapshot_dir is not None:
            self.enable_snapshots(snapshot_dir, idle_park_s=idle_park_s)
        # --- replicated data plane ---
        self.autoscaler = None
        if autoscale:
            self.enable_autoscaler(**(autoscale_config or {}))

    # ------------------------------------------------------------- deploy

    def deploy(self, spec: FunctionSpec) -> FunctionInstance:
        if spec.name in self._specs:
            raise DeploymentError(f"function {spec.name!r} already deployed")
        self._specs[spec.name] = spec
        instance = FunctionInstance({spec.name: spec}, self)
        self.attach_instance(instance)
        instance.mark_ready()
        self.lifecycle.publish({spec.name: instance}, kind="deploy", reason="deploy")
        with self._parked_lock:
            self._deployed_at[spec.name] = self.clock.now()
        return instance

    def spec_of(self, name: str) -> FunctionSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise UnknownFunctionError(name) from None

    # ------------------------------------- scale-to-zero / warm provisioning

    def enable_snapshots(self, directory: str, *, idle_park_s: float = 0.0,
                         retain: int = 0):
        """Turn on instance snapshots (warm-provisioning level 2) backed by a
        :class:`SnapshotStore` at ``directory``. ``idle_park_s > 0`` also
        registers a reconciler tick hook that parks instances whose members
        have ALL been idle at least that long (scale-to-zero)."""
        from repro_torch.checkpointing import SnapshotStore

        self.snapshots = SnapshotStore(directory, retain=retain, clock=self.clock)
        self._idle_park_s = float(idle_park_s)
        if self._idle_park_s > 0:
            self.lifecycle.add_tick_hook(self._idle_park_tick)
        return self.snapshots

    def scale_to_zero(self, name: str, *, idle_since: float | None = None) -> tuple[str, ...]:
        """Park the instance serving ``name``: snapshot every member's
        weights (content-addressed — identical weights store once), release
        the live spec params, and unroute via a "park" epoch. The functions
        stop resolving and stop billing; the next invoke resurrects them.
        Returns the parked names (empty if nothing was routed here).

        ``idle_since`` (the idle tick's judgement time): the park is dropped
        if a member saw traffic after it, checked once the snapshots are
        written, which takes seconds on the card (a port-only check; the
        written snapshots stay, and the next park of the same weights is a
        dedup)."""
        if self.snapshots is None:
            raise RuntimeError("scale_to_zero requires enable_snapshots(...)")
        inst = self.registry.get(name)
        if inst is None:
            return ()
        t0 = self.clock.now()
        members = tuple(sorted(
            m for m in inst.members if self.registry.get(m) is inst
        ))
        if not members:
            return ()
        recs: dict[str, _ParkedFunction] = {}
        live_specs: dict[str, FunctionSpec] = {}
        for m in members:
            spec = self.spec_of(m)
            recs[m] = _ParkedFunction(
                spec=dataclasses.replace(spec, params=None),
                digest=self.snapshots.put(spec.params),
                like=_structs_of(spec.params),
                devices=tree.map(lambda x: str(x.device), spec.params),
                parked_t=t0,
            )
            live_specs[m] = spec
        if idle_since is not None and any(
                (t := self.handler.last_activity(m)) is not None and t > idle_since for m in members):
            return ()
        with self._parked_lock:
            if any(m in self._parked for m in members):
                # a concurrent park of this instance won (e.g. the idle tick
                # racing an explicit scale_to_zero) — claiming is atomic with
                # this check, so exactly one caller installs the park state
                return ()
            for m in members:
                self._parked[m] = recs[m]
                # drop the live param references: the snapshot is now the
                # only copy, so the weights' memory actually frees when the
                # instance retires below
                self._specs[m] = recs[m].spec
        event = self.lifecycle.park(inst, reason=f"scale-to-zero {'+'.join(members)}")
        if event is None:
            # a publish raced the park (redeploy/merge rerouted the names):
            # the functions are still live — undo the bookkeeping
            with self._parked_lock:
                for m in members:
                    self._parked.pop(m, None)
                    self._specs[m] = live_specs[m]
            return ()
        # a parked fused group must not leave "committed" policy edges
        # behind, or the resurrected singletons could never re-merge
        self.merger.forget_instance(inst)
        self.note_provisioning("park", self.clock.now() - t0, warm=True,
                               functions=members)
        return members

    def _ensure_live(self, name: str) -> None:
        """Data-path gate: if ``name`` is parked, resurrect it (one thread
        does the work, the rest wait on its event). No-op for live names —
        one dict lookup under a short lock."""
        if self.snapshots is None:
            return
        while True:
            with self._parked_lock:
                rec = self._parked.get(name)
                waiter = self._resurrecting.get(name)
                if waiter is not None and waiter[0] is threading.current_thread():
                    # re-entrant: the resurrect's own canary health check
                    # dispatches through the data path
                    return
                if rec is None and waiter is None:
                    return  # live
                if rec is not None and waiter is None:
                    ev = threading.Event()
                    self._resurrecting[name] = (threading.current_thread(), ev)
                    break  # we own the resurrect
                ev = waiter[1]
            ev.wait(60.0)  # owner finished (or failed) -> re-check
        try:
            self._resurrect(name)
        finally:
            with self._parked_lock:
                self._resurrecting.pop(name, None)
            ev.set()

    def _resurrect(self, name: str) -> None:
        """PROVISIONING fast path: restore(snapshot) -> health-check on the
        captured canary -> publish. The restored params are digest-verified
        bit-exact, and the entries normally come from the executable index.

        When a request trace is active (the data-path gate resurrecting on
        the invoke path), the whole restore is a "cold-provision" span in
        that trace — the canary execute nests under it, not beside it."""
        t0 = self.clock.now()
        cur = self.tracer.current()
        if cur is None:
            self._resurrect_impl(name, t0)
            return
        ctx, parent = cur
        sid = ctx.alloc_id()
        try:
            with self.tracer.activate(ctx, sid):
                self._resurrect_impl(name, t0)
        finally:
            ctx.emit(f"resurrect:{name}", "cold-provision", t0,
                     self.clock.now(), parent_id=parent, span_id=sid,
                     args={"function": name})

    def _resurrect_impl(self, name: str, t0: float) -> None:
        """Restore, health check, publish, and a billed ``resurrect`` record.
        An integrity error or a failing health check propagates: the
        function stays parked. Its seconds by part (host wall clock: the
        restore with the instance's construction, and within it reading,
        hashing and copying the snapshot to the device; the health check;
        the publish) land in ``provisioning_stats()["resurrects"]``; an
        unfused chain's health check runs the chain below it, so it holds
        the resurrects of the members below."""
        with self._parked_lock:
            rec = self._parked[name]
        parts: dict = {}
        w0 = time.perf_counter()
        params = self.snapshots.restore(rec.digest, rec.like, devices=rec.devices, parts=parts)
        spec = dataclasses.replace(rec.spec, params=params)
        inst = FunctionInstance({name: spec}, self)
        self.attach_instance(inst)
        w1 = time.perf_counter()
        canary = self.handler.canary(name)
        if canary is not None:
            inst.execute(name, canary)  # health check before routing
        w2 = time.perf_counter()
        inst.mark_ready()
        self._specs[name] = spec
        self.lifecycle.publish({name: inst}, kind="resurrect",
                               reason=f"resurrect {name}")
        with self._parked_lock:
            self._parked.pop(name, None)
            self._deployed_at[name] = self.clock.now()
        w3 = time.perf_counter()
        profile = inst.provision_profile()
        warm = profile["cache_misses"] == 0
        with self._prov_lock:
            self._resurrect_parts.append({
                "function": name, "warm": warm, "wall_s": w3 - w0, "restore_s": w1 - w0, **parts,
                "health_s": w2 - w1, "publish_s": w3 - w2})
        self.note_provisioning(
            "resurrect", self.clock.now() - t0, warm=warm,
            functions=(name,), resident_bytes=inst.resident_bytes(),
            billed=True,  # restore time IS billed; parked idle time was not
        )

    def _idle_park_tick(self) -> None:
        """Reconciler tick hook: scale-to-zero instances whose members have
        all been idle >= idle_park_s. A member ages from its last activity or
        from its last deploy or resurrect, whichever is later (the JAX
        package reads the deploy time only for never-invoked members, so a
        resurrected member whose last request came before its park is parked
        again by the next tick, before the request that resurrected it
        reaches it). The tick takes the platform's merge lock: it skips a
        tick while fusion candidates are being merged (a park then would
        take a spec from under the merge building it), and no merge starts
        while it parks."""
        if self.snapshots is None or self._idle_park_s <= 0:
            return
        if not self._draining.acquire(blocking=False):
            return
        try:
            now = self.clock.now()
            for inst in self.registry.live_instances():
                members = sorted(inst.members)
                idle = True
                for m in members:
                    last = self.handler.last_activity(m)
                    with self._parked_lock:
                        deployed = self._deployed_at.get(m, now)
                    if last is None or last < deployed:
                        last = deployed
                    if now - last < self._idle_park_s:
                        idle = False
                        break
                if idle:
                    try:
                        self.scale_to_zero(members[0], idle_since=now)
                    except Exception:  # noqa: BLE001 — a failed park must not
                        pass  # kill the reconciler; the instance stays live
        finally:
            self._draining.release()

    def note_compile(self, *, hit: bool, seconds: float, saved_s: float = 0.0) -> None:
        """FunctionInstance callback: one compiled entry came into being (an
        executable-index hit or a shape-only run). Feeds
        ``stats()["provisioning"]``."""
        with self._prov_lock:
            if hit:
                self._compile_hits += 1
                self._compile_saved_s += saved_s
            else:
                self._compile_misses += 1
                self._compile_spent_s += seconds

    def provisioning_stats(self) -> dict:
        """Warm/cold provisioning latency aggregates + executable-index and
        snapshot-store counters — ``stats()["provisioning"]``."""
        from repro_torch.launch.compile_cache import EXECUTABLE_INDEX

        with self._prov_lock:
            records = list(self._prov_records)
            resurrects = list(self._resurrect_parts)
            compile_cache = {
                "hits": self._compile_hits,
                "misses": self._compile_misses,
                "saved_s": round(self._compile_saved_s, 4),
                "spent_s": round(self._compile_spent_s, 4),
            }
        builds = [r for r in records if r.kind != "park"]
        warm = [r for r in builds if r.warm]
        cold = [r for r in builds if not r.warm]
        warm_mean = sum(r.seconds for r in warm) / len(warm) if warm else 0.0
        cold_mean = sum(r.seconds for r in cold) / len(cold) if cold else 0.0
        counts: dict[str, int] = {}
        for r in records:
            counts[r.kind] = counts.get(r.kind, 0) + 1
        with self._parked_lock:
            parked = sorted(self._parked)
        out = {
            "counts": counts,
            "warm": len(warm),
            "cold": len(cold),
            "warm_mean_s": round(warm_mean, 4),
            "cold_mean_s": round(cold_mean, 4),
            "warm_speedup": (
                round(cold_mean / warm_mean, 2) if warm and cold and warm_mean > 0
                else None
            ),
            "compile_cache": compile_cache,
            "executable_index": EXECUTABLE_INDEX.stats(),
            "parked": parked,
            "events": [
                {"kind": r.kind, "functions": list(r.functions),
                 "seconds": round(r.seconds, 4), "warm": r.warm, "billed": r.billed}
                for r in records[-32:]
            ],
            "resurrects": resurrects,
        }
        if self.snapshots is not None:
            out["snapshots"] = self.snapshots.stats()
        return out

    # ------------------------------------- replicated data plane / autoscaling

    def enable_autoscaler(self, **knobs):
        """Turn on rho-driven replica autoscaling: registers an
        :class:`repro_torch.core.autoscaler.Autoscaler` as a reconciler tick
        hook. ``knobs`` forward to its constructor (rho_high, rho_low,
        depth_high, sustain, max_replicas, min_replicas, cooldown_s,
        eval_interval_s)."""
        from repro_torch.core.autoscaler import Autoscaler

        self.autoscaler = Autoscaler(self, **knobs)
        self.lifecycle.add_tick_hook(self.autoscaler.tick)
        return self.autoscaler

    def request_replica(self, name: str, reason: str = "") -> None:
        """Scale-out hint (the fusion policy's replicate arm routes here).
        No-op without an autoscaler — the hint is advisory, and the
        autoscaler owns the max-replica/cooldown guards."""
        scaler = self.autoscaler
        if scaler is not None:
            scaler.request_scale_out(name, reason=reason)

    def replica_spinup_estimate(self, name: str | None = None) -> float | None:
        """EWMA of measured warm replica spin-up seconds, or None before any
        replica has ever spun up (the policy's replicate arm then stays
        cold — it never bets on an unmeasured cost)."""
        with self._prov_lock:
            return self._spinup_ewma_s

    def _spawn_replica(self, name: str) -> FunctionInstance | None:
        """Build one replica of the unit currently routed for ``name`` and
        publish it through a scale-out epoch. The replica holds the specs'
        own tensors (the weights are never copied); its entries come from
        the executable index, and it captures graphs of its own (two replicas
        must never replay one graph's static buffers at once).

        The canary health check runs via DIRECT ``replica.execute`` — never
        ``invoke`` — so spin-up traffic stamps no demand (note_demand) and
        bills nothing: per-replica demand attribution stays consistent with
        what clients actually sent. Returns None when the route vanished
        under us (a racing park/merge won)."""
        inst = self.registry.get(name)
        if inst is None:
            return None
        t0 = self.clock.now()
        specs = {m: self.spec_of(m) for m in inst.members}
        replica = FunctionInstance(specs, self)
        self.attach_instance(replica)
        for m in sorted(replica.members):
            canary = self.handler.canary(m)
            if canary is None:
                continue
            if replica.get_compiled(m, canary) is None:
                # boundary entry: replaying it would dispatch outbound calls
                # through live routing (edge stats + billing pollution);
                # get_compiled above still recorded what it could
                continue
            replica.execute(m, canary)
        replica.mark_ready()
        event = self.lifecycle.scale_out(
            replica, tuple(sorted(replica.members)),
            reason=f"replica of {inst.instance_id}",
        )
        if event is None:
            self.detach_instance(replica)
            return None
        seconds = self.clock.now() - t0
        profile = replica.provision_profile()
        self.note_provisioning(
            "scale-out", seconds, warm=profile["cache_misses"] == 0,
            functions=tuple(sorted(replica.members)),
            resident_bytes=replica.resident_bytes(), billed=True,
        )
        with self._prov_lock:
            prev = self._spinup_ewma_s
            self._spinup_ewma_s = seconds if prev is None else 0.5 * prev + 0.5 * seconds
        return replica

    def replica_stats(self, per_instance: dict | None = None) -> dict:
        """Per-replica view for ``stats()["replicas"]``: replica ids, spread
        pick counts, in-flight counts, per-replica billing split, and the
        name-level demand rate. Demand is stamped ONCE per client request at
        the entry points (note_demand) — never per replica pick — so the
        fission divergence signals see replicated traffic exactly once.
        ``stats()`` passes the per-instance split from its coherent meter
        snapshot; standalone callers let it be computed fresh."""
        summary = self.registry.replica_summary()
        if per_instance is None:
            per_instance = self.meter.by_instance()
        functions = {}
        for name, info in summary.items():
            functions[name] = {
                **info,
                "demand_rps": round(self.handler.recent_rate(name), 3),
                "billing": {
                    iid: per_instance[iid]
                    for iid in info["replicas"]
                    if iid in per_instance
                },
            }
        out = {
            "spread": self.registry.spread_name,
            "spinup_estimate_s": self.replica_spinup_estimate(),
            "functions": functions,
        }
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.stats()
        return out

    # ------------------------------------------------------------- shapes

    def output_structs(self, name: str, args: tuple):
        """Output signature (meta tensors) of ``name`` called with ``args``'s
        shapes and dtypes — computed by running the function on meta
        tensors, nested calls resolved recursively; nothing is executed."""
        self._ensure_live(name)  # a parked spec is a params-free stub
        key = (name, _struct_key(args))
        with self._shape_lock:
            if key in self._shape_cache:
                return self._shape_cache[key]
            if name in self._shape_stack:
                raise InvocationError(f"call cycle through {name!r}: {self._shape_stack}")
            spec = self.spec_of(name)
            self._shape_stack.append(name)
            try:
                with torch.no_grad():
                    out = spec.fn(AbstractContext(self, name), _structs_of(spec.params), *_structs_of(args))
            finally:
                self._shape_stack.pop()
            self._shape_cache[key] = out
            return out

    # ------------------------------------------------------------- hooks

    def _on_candidate(self, caller: str, callee: str) -> None:
        with self._pending_lock:
            if (caller, callee) not in self._pending_candidates:
                self._pending_candidates.append((caller, callee))

    def _drain_candidates(self) -> None:
        if not self._draining.acquire(blocking=False):
            return  # a merge in progress is already invoking health checks
        try:
            # a merge's canary replays are control-plane traffic: they run
            # outside the trace of the request that happened to trigger it
            # (the merge shows on the control timeline instead)
            with _outside_traces(self.tracer):
                while True:
                    with self._pending_lock:
                        if not self._pending_candidates:
                            return
                        caller, callee = self._pending_candidates.pop(0)
                    self.merger.submit(caller, callee)
        finally:
            self._draining.release()

    def attach_instance(self, instance: FunctionInstance) -> None:
        """Backend hook: provision execution resources for an instance."""

    def detach_instance(self, instance: FunctionInstance) -> None:
        """Backend hook: tear down resources for a never-promoted instance."""

    def retire_instance(self, instance: FunctionInstance) -> int:
        freed = instance.retire()
        self.detach_instance(instance)
        return freed

    # ------------------------------------------------------------- running

    def _run_request(self, instance: FunctionInstance, entry: str, args: tuple):
        instance.begin_request()
        self.handler.enter(entry, instance)
        try:
            out = instance.execute(entry, args)
        except BaseException:
            # failed attempts are not billed — the retry path would otherwise
            # double-bill the same request (swap races, redeploys)
            self.handler.abort(entry)
            raise
        else:
            self.handler.exit(entry)
            return out
        finally:
            instance.end_request()

    def _run_batch(self, instance: FunctionInstance, entry: str, args_list: list[tuple]) -> list:
        instance.begin_request()
        self.handler.enter(entry, instance, batch_size=len(args_list))
        try:
            out = instance.execute_batch(entry, args_list, max_bucket=self.scheduler.max_batch)
        except BaseException:
            self.handler.abort(entry)
            raise
        else:
            self.handler.exit(entry)
            return out
        finally:
            instance.end_request()

    def _invoke_with_retry(self, name: str, args: tuple):
        """Serial dispatch with swap-race recovery. Also the Merger's canary
        replay path — no latency observation here, so control-plane traffic
        never pollutes the external latency percentiles."""
        self._ensure_live(name)
        try:
            try:
                return self._dispatch_sync(name, args)
            except UnknownFunctionError:
                # raced a scale-to-zero park: the route vanished between
                # _ensure_live and resolve — resurrect and retry (a truly
                # unknown name stays unknown and re-raises)
                self._ensure_live(name)
                return self._dispatch_sync(name, args)
            except InvocationError:
                # A request can race a merge swap: it resolved the old
                # instance, the Merger retired it mid-flight. Re-resolving
                # picks up the new routing; only if THAT fails is the
                # container actually gone and a fresh one provisioned.
                try:
                    return self._dispatch_sync(name, args)
                except InvocationError:
                    self._redeploy(name)
                    return self._dispatch_sync(name, args)
        finally:
            self._drain_candidates()

    def invoke(self, name: str, *args):
        """External (client) invocation — serial path. Mints the request's
        trace and activates it so every phase below (execute, cross-function
        hops) nests under this root."""
        self.handler.record_canary(name, args)
        self.handler.note_demand(name)
        t0 = self.clock.now()
        ctx = self.tracer.begin_request(name, "invoke", t0=t0)
        try:
            with self.tracer.activate(ctx):
                out = self._invoke_with_retry(name, args)
        except BaseException as exc:
            if ctx is not None:
                ctx.finish(args={"error": type(exc).__name__})
            raise
        t1 = self.clock.now()
        if ctx is not None:
            ctx.finish(t1)
        self.meter.observe_latency(name, t1 - t0)
        return out

    def invoke_async(self, name: str, *args, priority: int = 0,
                     slo: SLOClass | None = None) -> Future:
        """External invocation through the request scheduler. Returns a
        Future; compatible concurrent requests may execute as one batch.
        ``slo=SLOClass(name, target_p95_ms)`` admits the request into its
        class's own lane (single-class batches, window from the class's
        target slack); ``priority=PRIORITY_HIGH`` is the two-level shim —
        it maps to the zero-target class, jumps queued normal traffic, and
        closes an open batching window early (SLO admission)."""
        self.handler.record_canary(name, args)
        self.handler.note_demand(name)
        return self.scheduler.submit(name, args, priority=priority, slo=slo)

    def scheduler_signals(self, names):
        """Live scheduler feedback for the fusion policy (Merger.submit)."""
        return self.scheduler.signals_for(names)

    def _dispatch_batch(self, name: str, args_list: list[tuple]) -> list:
        """Scheduler callback: execute one coalesced batch."""
        self._ensure_live(name)
        try:
            try:
                return self._dispatch_batch_impl(name, args_list)
            except UnknownFunctionError:
                self._ensure_live(name)  # raced a park — resurrect and retry
                return self._dispatch_batch_impl(name, args_list)
            except InvocationError:
                try:  # routing may have swapped mid-flight (see invoke)
                    return self._dispatch_batch_impl(name, args_list)
                except InvocationError:
                    self._redeploy(name)
                    return self._dispatch_batch_impl(name, args_list)
        finally:
            self._drain_candidates()

    def _redeploy(self, name: str) -> None:
        if self.snapshots is not None:
            with self._parked_lock:
                parked = name in self._parked
            if parked:
                # a parked spec is a params-free stub — resurrect instead of
                # rebuilding from it
                self._ensure_live(name)
                return
        spec = self.spec_of(name)
        fresh = FunctionInstance({name: spec}, self)
        self.attach_instance(fresh)
        fresh.mark_ready()
        # Epoch transition: the displaced (dead-routed) instance is drained
        # AND retired, and on the orchestrated backend its pod's loop exits.
        self.lifecycle.publish({name: fresh}, kind="redeploy", reason=f"redeploy {name}")

    def _fission_tick(self) -> None:
        """Reconciler-tick hook: rate-limited regret evaluation over the
        committed fusion groups (control-plane work, off the data path)."""
        now = self.clock.now()
        if now - self._last_fission_eval < self._fission_interval_s:
            return
        self._last_fission_eval = now
        self.merger.evaluate_splits()

    def remote_call(self, caller_instance: FunctionInstance, caller_fn: str, callee: str, args: tuple):
        """Blocking function-to-function dispatch from eager glue: the caller
        is parked until this returns, and the wait is the observed sync edge."""
        self.handler.record_canary(callee, args)
        # Boundary hop: the wait is a distinct "cross-function-sync" span in
        # the caller's trace (a fused-inline call records no hop — see
        # EagerContext.call), and the measured wait feeds the edge-cost EWMA
        # the fusion policy weighs instead of its static knobs.
        cur = self.tracer.current()
        sid = cur[0].alloc_id() if cur is not None else None
        self._ensure_live(callee)
        t0 = self.clock.now()
        with self.tracer.activate(cur[0] if cur else None, sid or 1):
            try:
                out = self._dispatch_sync(callee, args)
            except UnknownFunctionError:
                self._ensure_live(callee)  # raced a park — resurrect and retry
                out = self._dispatch_sync(callee, args)
            except InvocationError:
                # Raced a merge swap, as _invoke_with_retry's entry can: the
                # hop resolved the callee's old instance and a publish retired
                # it before the request began. Re-resolving takes the new
                # route. (The reference lets the hop fail; a merge's health
                # check that made the hop then aborted with no record, and the
                # chain stayed split.)
                out = self._dispatch_sync(callee, args)
        wait = self.clock.now() - t0
        if cur is not None:
            cur[0].emit(f"{caller_fn}->{callee}", "cross-function-sync",
                        t0, t0 + wait, parent_id=cur[1], span_id=sid,
                        args={"caller": caller_fn, "callee": callee})
        self.handler.attribute_blocked(wait)
        self.handler.observe_edge(caller_fn, callee, sync=True, wait_s=wait)
        self.edge_costs.observe_sync_edge(caller_fn, callee, wait)
        return out

    def async_call(self, caller_instance: FunctionInstance, caller_fn: str, callee: str, args: tuple) -> None:
        self.handler.observe_edge(caller_fn, callee, sync=False)
        self._dispatch_async(callee, args)

    # ------------------------------------------------------------- metrics

    def note_provisioning(self, kind: str, seconds: float, *, warm: bool,
                          functions=(), resident_bytes: int = 0,
                          billed: bool = False) -> None:
        """Record one provisioning transition (merge/split/park/resurrect/
        scale-out) with its
        warm-vs-cold classification on the billing meter (billed records —
        a resurrect's restore time — are billed; a park's idle time is not),
        as a span ending now on the control-plane timeline, and — for a
        merge — as a sample of the measured merge stall the policy's cost
        model weighs."""
        rec = ProvisioningRecord(
            kind=kind, functions=tuple(functions), seconds=float(seconds),
            resident_bytes=int(resident_bytes), warm=bool(warm), billed=bool(billed),
        )
        with self._prov_lock:
            self._prov_records.append(rec)
        self.meter.record_provisioning(rec)
        t1 = self.clock.now()
        self.tracer.control_span(
            f"{kind}:{'+'.join(rec.functions) or '?'}", t1 - rec.seconds, t1,
            args={"kind": kind, "warm": rec.warm, "billed": rec.billed,
                  "seconds": rec.seconds})
        if kind == "merge":
            # the queue depth the stall was inflicted on rides along: the
            # measured replacement for the static saturation_penalty
            depth = self.scheduler.signals_for(rec.functions).queue_depth
            self.edge_costs.observe_merge_stall(rec.seconds, depth)

    def ram_bytes(self) -> int:
        return sum(inst.resident_bytes() for inst in self.registry.live_instances())

    def stats(self) -> dict:
        meter_snap = self.meter.snapshot()
        return {
            "backend": self.backend_name,
            "ram_bytes": self.ram_bytes(),
            "instances": [repr(i) for i in self.registry.live_instances()],
            "edges": self.handler.stats(),
            "merges": [
                {
                    "members": e.members,
                    "freed_bytes": e.freed_bytes,
                    "build_s": round(e.build_s, 4),
                    "healthy": e.healthy,
                    "epoch": e.epoch,
                    "reason": e.reason,
                    "warm": e.warm,
                }
                for e in self.merger.merge_log
            ],
            "splits": [
                {
                    "members": e.members,
                    "partition": e.partition,
                    "healthy": e.healthy,
                    "epoch": e.epoch,
                    "reason": e.reason,
                    "build_s": round(e.build_s, 4),
                    "warm": e.warm,
                }
                for e in self.merger.split_log
            ],
            "lifecycle": self.lifecycle.stats(),
            "provisioning": self.provisioning_stats(),
            "billing": meter_snap["billing"],
            "latency": meter_snap["latency"],
            "scheduler": self.scheduler.stats(),
            "batching": self.batching_stats(),
            "replicas": self.replica_stats(per_instance=meter_snap["by_instance"]),
            "edge_costs": self.edge_costs.stats(),
        }

    def batching_stats(self) -> dict:
        """Per live instance: the requests that ran per request because
        their entry cannot be one batched program, and why."""
        return {inst.instance_id: inst.batch_stats() for inst in self.registry.live_instances()}

    # ------------------------------------------------------------- backend API

    def _dispatch_sync(self, name: str, args: tuple):
        raise NotImplementedError

    def _dispatch_async(self, name: str, args: tuple) -> None:
        raise NotImplementedError

    def _dispatch_batch_impl(self, name: str, args_list: list[tuple]) -> list:
        raise NotImplementedError

    def shutdown(self) -> None:
        self.merger.wait_idle()
        self.lifecycle.shutdown()
        self.scheduler.shutdown()


class TinyTorchBackend(ProvusePlatform):
    """tinyFaaS analogue: direct in-thread dispatch, minimal overhead."""

    backend_name = "tinytorch"

    def __init__(self, *args, async_workers: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self._async_pool = ThreadPoolExecutor(max_workers=async_workers, thread_name_prefix="tinytorch-async")

    def _dispatch_sync(self, name: str, args: tuple):
        instance = self.registry.resolve(name)
        return self._run_request(instance, name, args)

    def _dispatch_batch_impl(self, name: str, args_list: list[tuple]) -> list:
        instance = self.registry.resolve(name)
        return self._run_batch(instance, name, args_list)

    def _dispatch_async(self, name: str, args: tuple) -> None:
        self._async_pool.submit(self._safe_async, name, args)

    def _safe_async(self, name: str, args: tuple) -> None:
        try:
            self._dispatch_sync(name, args)
        except Exception:
            pass  # async branches are fire-and-forget; failures show as billing absence

    def shutdown(self) -> None:
        super().shutdown()
        self._async_pool.shutdown(wait=True)


class _Worker:
    """A Pod: serial request loop over a queue, on a thread of its own. On
    the card the thread sets its instance's device, then launches on that
    device's current stream, as every pod does (no stream of its own)."""

    def __init__(self, platform: "OrchestratedBackend", instance: FunctionInstance):
        self.instance = instance
        self.platform = platform
        self.q: "queue.Queue[tuple | None]" = queue.Queue()  # (entry, payload, fut, is_batch, trace-ctx)
        self.thread = threading.Thread(target=self._loop, daemon=True, name=f"worker-{instance.instance_id}")
        self.thread.start()

    def _loop(self):
        dev = _cuda_device(self.instance.params)
        if dev is not None:
            torch.cuda.set_device(dev)
        tracer = self.platform.tracer
        while True:
            item = self.q.get()
            if item is None:
                return
            entry, payload, fut, is_batch, cur = item
            try:
                # re-activate the submitter's trace context: spans emitted
                # inside the pod (handler execute, nested calls) land in the
                # request's tree even though it hopped threads
                with tracer.activate_snapshot(cur):
                    if is_batch:
                        fut.set_result(self.platform._run_batch(self.instance, entry, payload))
                    else:
                        fut.set_result(self.platform._run_request(self.instance, entry, payload))
            except Exception as exc:  # noqa: BLE001 — reaches the caller through its Future
                fut.set_exception(exc)

    def submit(self, entry: str, args: tuple) -> Future:
        fut: Future = Future()
        self.q.put((entry, args, fut, False, self.platform.tracer.current()))
        return fut

    def submit_batch(self, entry: str, args_list: list[tuple]) -> Future:
        fut: Future = Future()
        self.q.put((entry, args_list, fut, True, self.platform.tracer.current()))
        return fut

    def stop(self):
        self.q.put(None)


class OrchestratedBackend(ProvusePlatform):
    """Kubernetes analogue: queue+thread Pods, Service indirection, rolling
    swaps with readiness gating."""

    backend_name = "orchestrated"

    GUARDED_FIELDS = {"_workers": "_workers_lock"}

    def __init__(self, *args, **kwargs):
        # the workers exist before the base constructor, which may already
        # attach instances (an autoscaler's first tick)
        self._workers: dict[str, _Worker] = {}
        self._workers_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def attach_instance(self, instance: FunctionInstance) -> None:
        with self._workers_lock:
            self._workers[instance.instance_id] = _Worker(self, instance)

    def detach_instance(self, instance: FunctionInstance) -> None:
        with self._workers_lock:
            worker = self._workers.pop(instance.instance_id, None)
        if worker:
            worker.stop()

    def _worker_for(self, instance: FunctionInstance) -> _Worker:
        with self._workers_lock:
            worker = self._workers.get(instance.instance_id)
        if worker is None:
            raise InvocationError(f"no worker for {instance.instance_id}")
        return worker

    def pods(self) -> dict[str, threading.Thread]:
        """The live pods' threads, by instance id."""
        with self._workers_lock:
            return {iid: w.thread for iid, w in self._workers.items()}

    def _dispatch_sync(self, name: str, args: tuple):
        instance = self.registry.resolve(name)
        current = threading.current_thread()
        worker = self._worker_for(instance)
        if worker.thread is current:
            # self-call inside the same pod: run inline (avoids deadlock)
            return self._run_request(instance, name, args)
        return worker.submit(name, args).result()

    def _dispatch_batch_impl(self, name: str, args_list: list[tuple]) -> list:
        instance = self.registry.resolve(name)
        worker = self._worker_for(instance)
        if worker.thread is threading.current_thread():
            return self._run_batch(instance, name, args_list)
        return worker.submit_batch(name, args_list).result()

    def _dispatch_async(self, name: str, args: tuple) -> None:
        instance = self.registry.resolve(name)
        self._worker_for(instance).submit(name, args)

    def shutdown(self) -> None:
        """Stop every pod once the work queued to it has run (its async
        calls included), and wait for its thread to end."""
        super().shutdown()
        with self._workers_lock:
            workers, self._workers = list(self._workers.values()), {}
        for worker in workers:
            worker.stop()
        for worker in workers:
            if worker.thread is not threading.current_thread():
                worker.thread.join(timeout=30.0)


@contextlib.contextmanager
def _outside_traces(tracer):
    """Run the block with no trace active on this thread, then restore the
    thread's activations as they were."""
    held = []
    while (cur := tracer.current()) is not None:
        held.append(cur)
        tracer.pop()
    try:
        yield
    finally:
        for ctx, parent in reversed(held):
            tracer.push(ctx, parent)
