"""Token-addressed simulated message bus.

Port of ``foundationdb_tpu/sim/network.py``.

Re-design of FlowTransport + Sim2Conn (fdbrpc/FlowTransport.actor.cpp,
fdbrpc/sim2.actor.cpp:180-675) as one deterministic object: endpoints are
(process address, token) pairs; a request spawns the registered handler on
the destination process and routes the reply back; every hop pays a randomly
drawn latency from the simulation RNG; clogging and partitions delay or
strand packets; killing a process breaks outstanding replies
(request_maybe_delivered semantics, fdbrpc/fdbrpc.h NetSAV).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Dict, Optional, Set, Tuple

from ..core import error
from .actors import ActorCollection
from .failmon import FailureMonitor
from .loop import Future, Scheduler, TaskPriority


@dataclass(frozen=True)
class Endpoint:
    """Addressable mailbox (reference: Endpoint, FlowTransport.h:28-50)."""

    address: str   # process address, e.g. "1.0.0.1:1"
    token: str     # well-known or generated service token


Handler = Callable[[Any], Awaitable[Any]]


class SimProcess:
    """One simulated process (reference: ISimulator::ProcessInfo,
    simulator.h:47-121). Roles register token handlers; every spawned actor
    belongs to the process and dies with it."""

    def __init__(self, address: str, machine_id: str, dc_id: str, name: str = "") -> None:
        self.address = address
        self.machine_id = machine_id
        self.dc_id = dc_id
        self.name = name or address
        self.alive = True
        self.handlers: Dict[str, Handler] = {}
        self.actors = ActorCollection()
        self.globals: Dict[str, Any] = {}   # per-process globals (simulator.h:62,101)
        self.reboots = 0

    def register(self, token: str, handler: Handler) -> Endpoint:
        self.handlers[token] = handler
        return Endpoint(self.address, token)

    def unregister(self, token: str) -> None:
        self.handlers.pop(token, None)


class SimNetwork:
    """The one message bus for a simulation."""

    def __init__(self, sched: Scheduler, min_latency: float = 0.0001, max_latency: float = 0.001):
        self.sched = sched
        self.processes: Dict[str, SimProcess] = {}
        self.monitor = FailureMonitor()
        self.min_latency = min_latency
        self.max_latency = max_latency
        # (src, dst) -> virtual time until which packets are held (SimClogging)
        self._clogged_until: Dict[Tuple[str, str], float] = {}
        self._partitioned: Set[Tuple[str, str]] = set()
        #: extra one-way latency between processes in DIFFERENT DCs (the
        #: DCN tier of a multi-region topology; 0 = single-region exact)
        self.inter_dc_latency: float = 0.0

    # -- topology ------------------------------------------------------------
    def add_process(self, proc: SimProcess) -> None:
        self.processes[proc.address] = proc

    def clog_pair(self, a: str, b: str, seconds: float) -> None:
        until = self.sched.time + seconds
        for pair in ((a, b), (b, a)):
            self._clogged_until[pair] = max(self._clogged_until.get(pair, 0.0), until)

    def partition(self, a: str, b: str) -> None:
        self._partitioned.add((a, b))
        self._partitioned.add((b, a))

    def heal_partition(self, a: str, b: str) -> None:
        self._partitioned.discard((a, b))
        self._partitioned.discard((b, a))

    # -- delivery ------------------------------------------------------------
    def _latency(self) -> float:
        r = self.sched.rng.random01()
        return self.min_latency + (self.max_latency - self.min_latency) * r

    def _hop_delay(self, src: str, dst: str) -> Optional[float]:
        """Latency for one packet, or None if it can never arrive now."""
        if (src, dst) in self._partitioned:
            return None
        base = self.sched.time + self._latency()
        if self.inter_dc_latency:
            ps, pd = self.processes.get(src), self.processes.get(dst)
            if ps is not None and pd is not None and ps.dc_id != pd.dc_id:
                base += self.inter_dc_latency
        clog = self._clogged_until.get((src, dst), 0.0)
        return max(base, clog) - self.sched.time

    def request(
        self,
        src: str,
        endpoint: Endpoint,
        payload: Any,
        priority: int = TaskPriority.DEFAULT_ENDPOINT,
        timeout: Optional[float] = None,
    ) -> Future:
        """Send payload to endpoint; future of the handler's return value.

        reference: RequestStream<T>::getReply (fdbrpc/fdbrpc.h:229-249).
        Errors: connection_failed if the destination is dead, unroutable, or
        marked failed by the failure monitor (fdbrpc/FailureMonitor.h:81);
        request_maybe_delivered if it dies or is declared failed mid-flight,
        or if `timeout` virtual seconds elapse without a reply. Handler
        exceptions propagate to the caller like serialized error replies.
        """
        reply = Future()
        if self.monitor.is_failed(endpoint.address):
            reply._set_error(error.connection_failed(f"{endpoint.address} marked failed"))
            return reply
        fwd = self._hop_delay(src, endpoint.address)
        if fwd is None:
            # Partition: the packet never arrives. The failure monitor or the
            # caller's timeout must fire — the future may not hang forever.
            self._arm_watchdogs(reply, endpoint.address, timeout)
            return reply
        # Outstanding-reply breakage on process death rides the failure
        # monitor: kill marks the address failed, which errors every armed
        # reply with request_maybe_delivered (the NetSAV broken-connection
        # semantics, fdbrpc/fdbrpc.h:64-89).
        self._arm_watchdogs(reply, endpoint.address, timeout)

        def deliver() -> None:
            proc = self.processes.get(endpoint.address)
            if proc is None or not proc.alive:
                if not reply.is_ready:
                    reply._set_error(error.connection_failed())
                return
            handler = proc.handlers.get(endpoint.token)
            if handler is None:
                if not reply.is_ready:
                    reply._set_error(error.connection_failed())
                return

            async def run() -> None:
                try:
                    result = await handler(payload)
                except error.FDBError as e:
                    self._send_reply(endpoint.address, src, reply, None, e, priority)
                    return
                self._send_reply(endpoint.address, src, reply, result, None, priority)

            proc.actors.add(self.sched.spawn(run(), priority, name=f"handle:{endpoint.token}"))

        self.sched.at(self.sched.time + fwd, deliver, priority)
        return reply

    def _arm_watchdogs(self, reply: Future, dst: str, timeout: Optional[float]) -> None:
        """Error the reply if the destination is declared failed while it is
        outstanding, or after `timeout` virtual seconds (whichever first)."""
        watch = self.monitor.on_failed(
            dst,
            lambda: (not reply.is_ready)
            and reply._set_error(error.request_maybe_delivered(f"{dst} declared failed")),
        )
        if watch is not None:
            reply.on_ready(lambda _: watch.cancel())
        if timeout is not None:
            self.sched.at(
                self.sched.time + timeout,
                lambda: (not reply.is_ready)
                and reply._set_error(error.request_maybe_delivered(f"timeout to {dst}")),
                TaskPriority.DEFAULT_DELAY,
            )

    def _send_reply(
        self, src: str, dst: str, reply: Future, value: Any, err: Optional[BaseException], priority: int
    ) -> None:
        back = self._hop_delay(src, dst)
        if back is None:
            return  # reply stranded by partition; caller's reply future hangs

        def deliver() -> None:
            if reply.is_ready:
                return
            if err is not None:
                reply._set_error(err)
            else:
                reply._set(value)

        self.sched.at(self.sched.time + back, deliver, priority)

    def one_way(self, src: str, endpoint: Endpoint, payload: Any, priority: int = TaskPriority.DEFAULT_ENDPOINT) -> None:
        """Fire-and-forget send (reference: FlowTransport::sendUnreliable)."""
        self.request(src, endpoint, payload, priority)
