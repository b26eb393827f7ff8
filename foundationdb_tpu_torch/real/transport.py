"""Real transport: token-addressed RPC over TCP (asyncio).

Port of ``foundationdb_tpu/real/transport.py``.

The FlowTransport analog (fdbrpc/FlowTransport.actor.cpp) for clusters of
actual OS processes: the same Endpoint/request/one_way surface the sim
network exposes, so code written against that seam can run over real
sockets. Frames are length-prefixed and carry the repo's versioned flat
wire format (core/wire.py) — the on-disk encoding and the on-wire
encoding are the same bytes, like flow/serialize.h serving both.

    frame := [u32 len][wire payload]
    payload := {"kind": "req"|"reply"|"err"|"oneway",
                "id": int, "token": str, "body": any,
                "ttl": float?,        # propagated deadline budget
                "tc": TraceContext?}  # propagated trace context
                                      # (core/trace.py; spans enabled only)

Every dataclass in server/messages.py is wire-registered at import, so
role interfaces serialize without pickle. Connections are per-peer,
created on demand, reconnected on failure; replies match requests by id.
A request to an address with no listener (or a handler raising) surfaces
as the same FDBError codes the sim transport uses, keeping failure
handling uniform across both worlds.
"""
from __future__ import annotations

import asyncio
import dataclasses
import socket as _socket
import struct
from typing import Any, Callable, Dict, Optional, Tuple

from ..core import buggify, error, wire
from ..core.knobs import FLOW_KNOBS
from ..core.trace import (
    current_trace_context,
    g_spans,
    pop_trace_context,
    push_trace_context,
)
from ..sim.network import Endpoint


def _register_messages() -> None:
    """Wire-register every role-interface dataclass, so the full dynamic
    cluster's RPC surface (recruitment, coordination, recovery, DD,
    ratekeeper) serializes — the real-mode analog of the reference's
    serializable interface structs (fdbclient/*Interface.h)."""
    from ..core import types as t
    from ..server import cluster_controller as cc
    from ..server import coordinated_state as cst
    from ..server import coordination as coord
    from ..server import log_system as ls
    from ..server import master as master_mod
    from ..server import masterserver as ms
    from ..server import messages as msgs
    from ..server import proxy as proxy_mod
    from ..server import ratekeeper as rk
    from ..server import storage as storage_mod
    from ..server import worker as worker_mod
    from ..sim import network as simnet

    for mod in (msgs, t, coord, cst, ls, worker_mod, cc, ms, storage_mod,
                rk, master_mod, proxy_mod, simnet):
        for name in dir(mod):
            obj = getattr(mod, name)
            if dataclasses.is_dataclass(obj) and isinstance(obj, type):
                if obj not in wire._RECORD_NAMES and obj not in wire._ADAPTERS:
                    wire.register_record(obj)


_register_messages()

_LEN = struct.Struct("<I")
MAX_FRAME = 64 << 20

#: wire protocol version, exchanged in the connection handshake (the
#: FlowTransport ConnectPacket's protocolVersion, FlowTransport.actor.cpp):
#: both sides must agree before any request crosses the link — a version
#: skew surfaces as an immediate typed error, never a mis-decoded frame
PROTOCOL_VERSION = 1


async def _read_frame(reader: asyncio.StreamReader) -> Any:
    hdr = await reader.readexactly(4)
    (n,) = _LEN.unpack(hdr)
    if n > MAX_FRAME:
        raise error.connection_failed("oversized frame")
    if buggify.buggify():
        # straddled frame: the body arrives a beat after the header —
        # readers must tolerate a frame split across socket reads
        await asyncio.sleep(0)
    return wire.loads(await reader.readexactly(n))


def _nodelay(writer: asyncio.StreamWriter) -> None:
    """Disable Nagle on an RPC connection: with several small frames in
    flight per connection, Nagle + delayed ACK serializes successive
    writes into ~40 ms stalls — the classic small-RPC latency cliff. Every
    serious RPC transport (the reference's FlowTransport included) runs
    NODELAY; measured here as a 30-60 ms p99 tail under concurrency."""
    sock = writer.get_extra_info("socket")
    if sock is not None:
        try:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        except (OSError, ValueError):
            pass   # non-TCP transport (tests may stub); nothing to tune


def _write_frame(writer: asyncio.StreamWriter, payload: Any) -> None:
    raw = wire.dumps(payload)
    if buggify.buggify():
        # torn write: header and body leave in separate writes, so the
        # peer's reader sees a partial frame on the wire mid-request
        writer.write(_LEN.pack(len(raw)))
        writer.write(raw)
        return
    writer.write(_LEN.pack(len(raw)) + raw)


class _Peer:
    """One outgoing connection + its in-flight request table, with
    jittered-exponential reconnect backoff: consecutive connect failures
    widen `retry_at`, and requests landing inside the window fail fast
    (connection_failed) instead of hammering a dead peer with SYNs."""

    def __init__(self, addr: str, src: str = "", chaos=None):
        self.addr = addr
        #: owning network's process name (chaos targets faults by name)
        self.src = src
        #: optional NetworkNemesis hook (real/chaos.py): consulted at
        #: connect time for injected handshake stalls
        self.chaos = chaos
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.pending: Dict[int, asyncio.Future] = {}
        self.lock = asyncio.Lock()
        self._pump: Optional[asyncio.Task] = None
        #: consecutive failed connects; 0 after any successful handshake
        self.fail_streak = 0
        #: loop time before which reconnect attempts fail fast
        self.retry_at = 0.0

    def note_connect_failure(self, rng01=None) -> float:
        """Advance the backoff window after a failed connect; returns the
        backoff applied. Jitter draws from `rng01` when given (a seeded
        campaign), else the peer spreads itself with hash-derived jitter."""
        self.fail_streak += 1
        base = float(FLOW_KNOBS.real_reconnect_backoff_initial_s)
        cap = float(FLOW_KNOBS.real_reconnect_backoff_max_s)
        jit = float(FLOW_KNOBS.real_reconnect_backoff_jitter)
        backoff = min(base * (2 ** (self.fail_streak - 1)), cap)
        if jit > 0:
            u = rng01() if rng01 is not None else (
                (hash((self.addr, self.fail_streak)) & 0xFFFF) / 0xFFFF)
            backoff *= (1 - jit) + 2 * jit * u
        self.retry_at = asyncio.get_running_loop().time() + backoff
        return backoff

    async def connect(self) -> None:
        from . import tls

        # ONE snapshot for the whole connection: a concurrent set_tls()
        # can't desync the handshake context from the subject rules.
        # The half-open connection lives in LOCALS until the handshake
        # completes: a concurrent _fail_all() (reset fault, pump death of
        # the previous incarnation) must not be able to null out the
        # writer mid-handshake — it simply never sees this one until it
        # is published whole.
        snap = tls.current()
        host, port = self.addr.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(
            host, int(port), ssl=snap.client_ctx if snap else None)
        _nodelay(writer)
        try:
            if snap is not None and not tls.verify_peer(writer, snap):
                raise error.connection_failed("peer failed TLS subject check")

            async def _handshake():
                # EVERYTHING between accept and a validated hello counts
                # against the handshake bound — including an injected
                # chaos stall, so a stall longer than the knob surfaces
                # as connection_failed, never as an unbounded hang
                if self.chaos is not None:
                    await self.chaos.on_connect(self.src, self.addr)
                # protocol-version handshake BEFORE the reply pump owns
                # the reader: hello out, hello back, versions must match
                _write_frame(writer, {"kind": "hello", "id": 0,
                                      "token": "", "body": PROTOCOL_VERSION})
                await writer.drain()
                return await _read_frame(reader)

            try:
                reply = await asyncio.wait_for(
                    _handshake(),
                    timeout=float(FLOW_KNOBS.real_handshake_timeout_s))
            except asyncio.TimeoutError:
                raise error.connection_failed("handshake timeout")
            except asyncio.IncompleteReadError:
                # no timeout happened: the peer CLOSED mid-handshake — the
                # classic symptom of a plaintext/TLS listener mismatch
                raise error.connection_failed(
                    "connection closed during handshake (TLS mismatch?)")
            if reply.get("kind") == "err":
                raise error.connection_failed(
                    f"peer refused connection: {reply.get('body')}")
            if reply.get("kind") != "hello" or reply.get("body") != PROTOCOL_VERSION:
                raise error.connection_failed(
                    f"protocol version mismatch: ours {PROTOCOL_VERSION}, "
                    f"theirs {reply.get('body')}")
        except BaseException:
            writer.close()
            raise
        self.reader, self.writer = reader, writer
        self._pump = asyncio.create_task(self._pump_replies())
        self.fail_streak = 0
        self.retry_at = 0.0

    async def _pump_replies(self) -> None:
        try:
            while True:
                msg = await _read_frame(self.reader)
                fut = self.pending.pop(msg.get("id"), None)
                if fut is None or fut.done():
                    continue
                if msg["kind"] == "err":
                    code, name = msg["body"]
                    fut.set_exception(error.FDBError(code, name))
                else:
                    fut.set_result(msg["body"])
        except asyncio.CancelledError:
            raise
        except Exception:
            # ANY pump death (decode error, oversized frame, socket loss)
            # must fail the in-flight table and drop the connection, or the
            # peer wedges: requests keep writing to a socket nobody reads
            self._fail_all()

    def _fail_all(self) -> None:
        """Tear down the connection: fail waiters, close the socket, stop
        the pump (unless we ARE the pump, which is exiting anyway)."""
        for fut in self.pending.values():
            if not fut.done():
                fut.set_exception(error.connection_failed("peer connection lost"))
        self.pending.clear()
        if self.writer is not None:
            self.writer.close()
        self.reader = self.writer = None
        pump = self._pump
        if pump is not None and pump is not asyncio.current_task():
            pump.cancel()
        self._pump = None

    def close(self) -> None:
        self._fail_all()


class RealProcess:
    """The listener half: a handler registry bound to a TCP port
    (workerServer's mailbox). `address` is "host:port"."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self.handlers: Dict[str, Callable] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self._tls = None   # TLS snapshot, captured at start()
        #: strong refs — the loop keeps only weak ones, and a collected
        #: handler task means a silently dropped reply
        self._tasks: set = set()
        #: how handler coroutines are driven: None = plain asyncio await
        #: (handlers are asyncio coroutines); the real-cluster runtime
        #: installs a dispatcher that runs them on the node's cooperative
        #: scheduler instead (handlers there await scheduler Futures,
        #: which asyncio cannot drive)
        self.dispatcher: Optional[Callable] = None
        #: requests shed because their propagated deadline (frame ttl)
        #: expired before the handler finished — work nobody was waiting
        #: for anymore (docs/real_cluster.md, deadline propagation)
        self.shed_expired = 0

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def register(self, token: str, handler: Callable) -> None:
        self.handlers[token] = handler

    def unregister(self, token: str) -> None:
        self.handlers.pop(token, None)

    async def start(self) -> None:
        from . import tls

        # snapshot at listen time; _serve checks peers against the SAME
        # policy the listener's handshake context came from
        self._tls = tls.current()
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port,
            ssl=self._tls.server_ctx if self._tls else None)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # drop live connections too: wait_closed() blocks on them
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()
            self._server = None

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        from . import tls

        self._conns.add(writer)
        _nodelay(writer)
        shaken = False
        try:
            if self._tls is not None and not tls.verify_peer(writer,
                                                             self._tls):
                # consume the client's in-flight hello first — closing
                # with unread bytes degenerates to an RST that destroys
                # the diagnostic frame below
                try:
                    await asyncio.wait_for(
                        _read_frame(reader),
                        float(FLOW_KNOBS.real_handshake_timeout_s))
                except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                        ConnectionError, OSError):
                    pass
                # tell the peer WHY before dropping — a silent close
                # reads as a spurious transport failure and sends the
                # operator chasing the network instead of the certs
                _write_frame(writer, {
                    "kind": "err", "id": 0,
                    "body": (error.connection_failed("").code,
                             "tls_subject_rejected")})
                await writer.drain()
                return
            while True:
                msg = await _read_frame(reader)
                if msg["kind"] == "hello":
                    if msg.get("body") != PROTOCOL_VERSION:
                        _write_frame(writer, {"kind": "err", "id": 0,
                                              "body": (error.connection_failed("").code,
                                                       "protocol_mismatch")})
                        await writer.drain()
                        return
                    _write_frame(writer, {"kind": "hello", "id": 0,
                                          "token": "", "body": PROTOCOL_VERSION})
                    await writer.drain()
                    shaken = True
                    continue
                if not shaken:
                    # no frame is serviced before the version handshake: a
                    # peer speaking a pre-handshake protocol must fail HERE,
                    # not be decoded under skew
                    _write_frame(writer, {"kind": "err", "id": msg.get("id", 0),
                                          "body": (error.connection_failed("").code,
                                                   "handshake_required")})
                    await writer.drain()
                    return
                if msg["kind"] == "oneway":
                    handler = self.handlers.get(msg["token"])
                    if handler is not None:
                        self._track(asyncio.create_task(
                            self._run_oneway(handler, msg["body"],
                                             msg.get("tc"))))
                    continue
                self._track(asyncio.create_task(self._answer(writer, msg)))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self._conns.discard(writer)
            writer.close()

    def _track(self, task: asyncio.Task) -> None:
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _run_oneway(self, handler, body, tc=None) -> None:
        # inbound trace context installed task-locally (this coroutine IS
        # its own asyncio task, so the set never leaks to other requests)
        tok = push_trace_context(tc) if tc is not None else None
        try:
            if self.dispatcher is not None:
                await self.dispatcher(handler, body)
            else:
                await handler(body)
        except Exception:
            pass
        finally:
            if tok is not None:
                pop_trace_context(tok)

    async def _answer(self, writer: asyncio.StreamWriter, msg) -> None:
        if buggify.buggify():
            # slow service: client timeouts race (knob-derived, was 0.05)
            await asyncio.sleep(float(FLOW_KNOBS.max_buggified_delay) / 4)
        # inbound trace context: installed for the whole handler await —
        # task-local (each _answer is its own asyncio task), and handed
        # across the cooperative-scheduler boundary by the dispatcher
        # (real/runtime.make_dispatcher wraps the handler coroutine)
        tc = msg.get("tc")
        tok = push_trace_context(tc) if tc is not None else None
        try:
            await self._answer_inner(writer, msg)
        finally:
            if tok is not None:
                pop_trace_context(tok)

    async def _answer_inner(self, writer: asyncio.StreamWriter, msg) -> None:
        handler = self.handlers.get(msg["token"])
        #: propagated client deadline (seconds of budget left at send time):
        #: handler work is bounded by it — a reply the client stopped
        #: waiting for is shed as request_maybe_delivered instead of
        #: occupying the service path (deadline propagation,
        #: docs/real_cluster.md)
        ttl = msg.get("ttl")
        try:
            if handler is None:
                raise error.FDBError(error.request_maybe_delivered("").code,
                                     "request_maybe_delivered")
            if self.dispatcher is not None:
                work = self.dispatcher(handler, msg["body"])
            else:
                work = handler(msg["body"])
            if ttl is not None:
                try:
                    body = await asyncio.wait_for(work, float(ttl))
                except asyncio.TimeoutError:
                    # cancel the HANDLER too (scheduler-dispatched work
                    # carries its Task as sim_task): shedding must stop
                    # the work, not just abandon its reply. Work a
                    # handler already handed to a role-internal batcher
                    # still completes — the cancel bounds everything
                    # upstream of that handoff.
                    task = getattr(work, "sim_task", None)
                    if task is not None:
                        task.cancel()
                    self.shed_expired += 1
                    raise error.FDBError(
                        error.request_maybe_delivered("").code,
                        "request_maybe_delivered")
            else:
                body = await work
            reply = {"kind": "reply", "id": msg["id"], "body": body}
        except error.FDBError as e:
            reply = {"kind": "err", "id": msg["id"], "body": (e.code, e.name)}
        except Exception:
            reply = {"kind": "err", "id": msg["id"],
                     "body": (error.internal_error("").code, "internal_error")}
        try:
            _write_frame(writer, reply)
            await writer.drain()
        except (ConnectionError, OSError):
            pass


class RealNetwork:
    """The sender half: the sim network's request/one_way surface over
    real sockets. One instance per OS process; peers cached per address.

    `name` is this process's identity for fault targeting (real/chaos.py
    partitions between NAMED processes); `chaos` is an optional
    NetworkNemesis handed down to peers for connect-time injection."""

    def __init__(self, name: str = "", chaos=None):
        self.name = name
        self.chaos = chaos
        self._peers: Dict[str, _Peer] = {}
        self._next_id = 0
        #: degradation counters (docs/real_cluster.md): reconnect attempts
        #: gated by backoff fail fast here instead of SYN-flooding the peer
        self.backoff_failfasts = 0
        self.reconnects = 0

    def transport_degraded(self) -> bool:
        """True while any peer is inside a reconnect-backoff window — the
        transport-level analog of ResilientEngine.degraded, consumed by
        depth-collapse (pipeline/resolver_pipeline.py) and admission."""
        return any(p.fail_streak > 0 for p in self._peers.values())

    async def _peer(self, addr: str, deadline: Optional[float] = None) -> _Peer:
        p = self._peers.get(addr)
        if p is None:
            p = self._peers[addr] = _Peer(addr, src=self.name,
                                          chaos=self.chaos)

        async def ensure_connected() -> None:
            async with p.lock:
                if p.writer is not None:
                    return
                loop_now = asyncio.get_running_loop().time()
                if loop_now < p.retry_at:
                    # inside the backoff window: fail fast — the caller's
                    # retry policy owns pacing, not a per-request SYN storm
                    self.backoff_failfasts += 1
                    raise error.connection_failed(
                        f"reconnect backoff ({p.retry_at - loop_now:.3f}s left)")
                try:
                    if p.fail_streak:
                        self.reconnects += 1
                    await p.connect()
                except error.FDBError:
                    p.note_connect_failure()
                    raise
                except (ConnectionError, OSError) as e:
                    p.note_connect_failure()
                    raise error.connection_failed(str(e))

        if p.writer is not None or deadline is None:
            # hot path: an already-connected peer skips the wait_for
            # task/timer allocation entirely (every request carries a
            # deadline, so this is the per-RPC steady state)
            await ensure_connected()
            return p
        # the request budget is end to end: the connect phase — including
        # TCP to a SYN-blackholed host and waiting out another request's
        # in-flight connect on the peer lock — must not outlive it
        remaining = deadline - asyncio.get_running_loop().time()
        if remaining <= 0:
            raise error.connection_failed("deadline exceeded before connect")
        try:
            await asyncio.wait_for(ensure_connected(), remaining)
        except asyncio.TimeoutError:
            raise error.connection_failed("connect deadline exceeded")
        return p

    async def request(self, src: str, ep: Endpoint, payload: Any,
                      priority: int = 0,
                      timeout: Optional[float] = None) -> Any:
        if timeout is None:
            timeout = float(FLOW_KNOBS.real_rpc_timeout_s)
        # distributed tracing: capture the ambient context NOW, in the
        # caller's synchronous prefix — on a cooperative-scheduler node
        # the shared ambient var is only guaranteed before the first
        # suspension (core/trace.py's discipline), and the connect below
        # suspends. The captured value is re-attached on every send, so a
        # retry after a reset/backoff/failover re-joins the same trace.
        tc = current_trace_context() if g_spans.enabled else None
        # deadline propagation: the budget is END TO END — connect (incl.
        # handshake) and the reply wait share it, and the remaining budget
        # rides the frame as `ttl` so the server can shed work whose
        # client already gave up (a healed partition flushes a backlog of
        # frames nobody is waiting on; resolving them only adds queue)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        p = await self._peer(ep.address, deadline)
        self._next_id += 1
        rid = self._next_id
        fut: asyncio.Future = loop.create_future()
        p.pending[rid] = fut
        try:
            ttl = max(0.001, deadline - loop.time())
            frame = {"kind": "req", "id": rid, "token": ep.token,
                     "body": payload, "ttl": round(ttl, 4)}
            if tc is not None:
                frame["tc"] = tc
            _write_frame(p.writer, frame)
            if buggify.buggify():
                # duplicate delivery (the transport's redelivery semantics):
                # the server answers twice; handlers must be idempotent and
                # the pump drops the orphan reply
                _write_frame(p.writer, frame)
            await p.writer.drain()
        except (ConnectionError, OSError) as e:
            p.pending.pop(rid, None)
            p._fail_all()
            raise error.connection_failed(str(e))
        try:
            return await asyncio.wait_for(
                fut, max(0.001, deadline - loop.time()))
        except asyncio.TimeoutError:
            p.pending.pop(rid, None)
            raise error.request_maybe_delivered("request timed out")

    async def one_way(self, src: str, ep: Endpoint, payload: Any,
                      priority: int = 0) -> None:
        if buggify.buggify():
            return   # unreliable by contract: drop outright
        # context captured before the first suspension (see request())
        tc = current_trace_context() if g_spans.enabled else None
        try:
            p = await self._peer(ep.address)
            frame = {"kind": "oneway", "id": 0,
                     "token": ep.token, "body": payload}
            if tc is not None:
                frame["tc"] = tc
            _write_frame(p.writer, frame)
            await p.writer.drain()
        except (error.FDBError, ConnectionError, OSError):
            pass   # unreliable by contract

    def close(self) -> None:
        for p in self._peers.values():
            p.close()
        self._peers.clear()
