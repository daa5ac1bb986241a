"""Invocation contexts — where fusion actually happens.

* **Eager glue** (:class:`EagerContext`) — the vanilla runtime. User function
  code runs op-by-op in the host interpreter (a container's language
  runtime); every ``ctx.call`` is a *real blocking host dispatch* through the
  platform to the callee instance. The wait is observed by the Function
  Handler — the paper's blocking-socket detection.
* **Compiled unit** (:class:`TraceContext`) — when an entry point is
  *self-contained* (a leaf function, or a fused group whose internal calls
  all resolve to co-located members) the instance runs it as ONE host call:
  co-located calls inline. Whether an entry is self-contained is decided by
  a shape-only run on meta tensors (the port's ``jax.jit(...).trace``):
  reaching a *synchronous boundary* call raises :class:`BoundaryCall` and
  the platform falls back to eager glue for that entry. Async calls inside
  a unit are queued and dispatched on the host after the run (the
  counterpart of JAX's ``io_callback``).
* :class:`AbstractContext` mirrors user code on meta tensors so the platform
  can compute output signatures without running anything.
"""
from __future__ import annotations

import torch


class BoundaryCall(Exception):
    """Raised when a shape-only run of an entry reaches a synchronous call to
    a function that is NOT co-located — the entry cannot be one unit."""

    def __init__(self, caller: str, callee: str):
        super().__init__(f"{caller} -> {callee} crosses the instance boundary")
        self.caller = caller
        self.callee = callee


class TraceContext:
    """Context of a compiled unit: co-located calls inline.

    ``pending`` collects ``(caller, callee, args)`` of async calls: during a
    real run the instance dispatches them after the unit finished; during
    the shape-only run (``shape_only``) they only show that the entry has
    effects (such an entry is never captured or batched)."""

    def __init__(self, platform, instance, params_by_member, member: str, pending: list,
                 shape_only: bool = False):
        self._platform = platform
        self._instance = instance
        self._params = params_by_member
        self.member = member
        self.pending = pending
        self.shape_only = shape_only

    def _child(self, member: str) -> "TraceContext":
        return TraceContext(self._platform, self._instance, self._params, member, self.pending,
                            self.shape_only)

    def call(self, name: str, *args):
        if name in self._instance.members:  # co-located: inline (FUSION)
            if self.shape_only:
                # recorded ONCE per program, at its shape-only run: a
                # fused-inline edge makes no runtime dispatch (and a replay
                # runs no Python), which is exactly the point — the trace
                # timeline shows the edge folding into the compiled unit
                self._platform.tracer.control_event(
                    f"fused-inline:{self.member}->{name}",
                    args={"caller": self.member, "callee": name,
                          "instance": self._instance.instance_id})
            spec = self._instance.members[name]
            return spec.fn(self._child(name), self._params[name], *args)
        raise BoundaryCall(self.member, name)

    def call_async(self, name: str, *args):
        """Fire-and-forget: queued, dispatched on the host after the run."""
        self.pending.append((self.member, name, args))
        return torch.zeros((), dtype=torch.int32, device="meta" if self.shape_only else "cpu")


class EagerContext:
    """Context for interpreter-glued (vanilla) execution."""

    def __init__(self, platform, instance, params_by_member, member: str):
        self._platform = platform
        self._instance = instance
        self._params = params_by_member
        self.member = member

    def _child(self, member: str) -> "EagerContext":
        return EagerContext(self._platform, self._instance, self._params, member)

    def call(self, name: str, *args):
        if name in self._instance.members:  # co-located member: run its code here
            # fused-inline: a distinct span kind from the boundary hop, so a
            # trace shows WHICH calls fusion already absorbed
            platform = self._platform
            cur = platform.tracer.current()
            spec = self._instance.members[name]
            if cur is None:
                return spec.fn(self._child(name), self._params[name], *args)
            ctx, parent = cur
            sid = ctx.alloc_id()
            t0 = platform.clock.now()
            with platform.tracer.activate(ctx, sid):
                out = spec.fn(self._child(name), self._params[name], *args)
            ctx.emit(f"{self.member}->{name}", "call-inline", t0,
                     platform.clock.now(), parent_id=parent, span_id=sid,
                     args={"caller": self.member, "callee": name})
            return out
        # real blocking dispatch through the platform (observed sync edge)
        return self._platform.remote_call(self._instance, self.member, name, args)

    def call_async(self, name: str, *args):
        self._platform.async_call(self._instance, self.member, name, args)
        return torch.zeros((), dtype=torch.int32)


class AbstractContext:
    """Shape-inference twin, run on meta tensors.

    A nested ``call`` resolves the callee's output signature through the
    platform's (memoized, cycle-checked) shape registry. Async calls
    contribute only their token."""

    def __init__(self, platform, member: str):
        self._platform = platform
        self.member = member

    def call(self, name: str, *args):
        return self._platform.output_structs(name, args)

    def call_async(self, name: str, *args):
        return torch.zeros((), dtype=torch.int32, device="meta")
