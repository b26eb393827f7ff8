"""The port's real transport (foundationdb_tpu_torch/real/transport.py)
against the JAX package's: the same frames give the same bytes, each
package's client completes the protocol handshake with the other's
server and round-trips the role messages, and the port passes
tests/test_real_transport.py's cases (request/reply, typed errors,
reconnect, the handshake bound, backoff, a second OS process)."""
import asyncio
import os
import re
import subprocess
import sys

import pytest

from torch_sim_world import BOTH, JAX, PORT, clean_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    clean_world()
    yield
    clean_world()


def run(coro):
    return asyncio.run(coro)


class _Sink:
    """A stand-in StreamWriter that keeps what is written."""

    def __init__(self):
        self.chunks = []

    def write(self, b):
        self.chunks.append(bytes(b))


def frames(P):
    ms = P.messages
    T = P.types
    payloads = [
        {"kind": "hello", "id": 0, "token": "", "body": P.transport.PROTOCOL_VERSION},
        {"kind": "req", "id": 7, "token": "demo.get",
         "body": ms.GetValueRequest(key=b"k1", version=0), "ttl": 4.9876},
        {"kind": "req", "id": 8, "token": "demo.getRange",
         "body": ms.GetKeyValuesRequest(begin=b"", end=b"\xff", version=3, limit=10),
         "ttl": 1.0},
        {"kind": "rep", "id": 8, "body": ms.GetKeyValuesReply(
            data=[(b"k1", b"v1"), (b"k2", b"v2")], more=False)},
        {"kind": "req", "id": 9, "token": "resolver.resolve",
         "body": ms.ResolveTransactionBatchRequest(
             prev_version=10, version=20, last_received_version=10,
             transactions=[T.CommitTransaction(
                 read_snapshot=5, read_conflict_ranges=[T.KeyRange(b"a", b"b")],
                 write_conflict_ranges=[T.KeyRange(b"c", b"c\x00")])])},
        {"kind": "err", "id": 0, "body": (P.error.connection_failed("").code,
                                          "protocol_mismatch")},
        {"kind": "oneway", "id": 0, "token": "demo.set", "body": (b"y", b"1")},
    ]
    out = []
    for p in payloads:
        sink = _Sink()
        P.transport._write_frame(sink, p)
        out.append(b"".join(sink.chunks))
    return out


def test_frame_bytes_equal_jax():
    port, jax = frames(PORT), frames(JAX)
    assert port == jax
    assert port[0][:4] == len(port[0][4:]).to_bytes(4, "little")


def test_protocol_constants_equal_jax():
    assert PORT.transport.PROTOCOL_VERSION == JAX.transport.PROTOCOL_VERSION
    assert PORT.transport.MAX_FRAME == JAX.transport.MAX_FRAME
    assert sorted(PORT.wire._RECORD_NAMES.values()) == sorted(JAX.wire._RECORD_NAMES.values())


@pytest.mark.parametrize("server_pkg,client_pkg", [("port", "jax"), ("jax", "port")])
def test_cross_package_handshake_and_rpc(server_pkg, client_pkg):
    """Each package's client shakes hands with the other's server and
    round-trips the demo KV's messages: the two speak one protocol."""
    S = PORT if server_pkg == "port" else JAX
    C = PORT if client_pkg == "port" else JAX

    async def go():
        proc = S.transport.RealProcess()
        S.demo_server.DemoKV(proc)
        await proc.start()
        net = C.transport.RealNetwork()
        Ep = C.network.Endpoint
        try:
            assert await net.request("c", Ep(proc.address, "demo.set"), (b"k1", b"v1")) is True
            await net.request("c", Ep(proc.address, "demo.set"), (b"k2", b"v2"))
            reply = await net.request("c", Ep(proc.address, "demo.get"),
                                      C.messages.GetValueRequest(key=b"k1", version=0))
            rng = await net.request("c", Ep(proc.address, "demo.getRange"),
                                    C.messages.GetKeyValuesRequest(begin=b"", end=b"\xff",
                                                                   version=0, limit=10))
            return reply.value, rng.data, rng.more, type(reply).__module__
        finally:
            net.close()
            await proc.stop()

    value, data, more, module = run(go())
    assert value == b"v1" and data == [(b"k1", b"v1"), (b"k2", b"v2")] and not more
    assert module.startswith(C.name + ".")


def test_request_reply_errors_and_unknown_tokens():
    E = PORT.error

    async def go():
        proc = PORT.transport.RealProcess()

        async def failing(_body):
            raise E.not_committed()

        proc.register("svc.fail", failing)
        await proc.start()
        net = PORT.transport.RealNetwork()
        Ep = PORT.network.Endpoint
        try:
            with pytest.raises(E.FDBError) as ei:
                await net.request("c", Ep(proc.address, "svc.fail"), None)
            assert ei.value.name == "not_committed"
            with pytest.raises(E.FDBError) as ei2:
                await net.request("c", Ep(proc.address, "no.such.token"), None, timeout=2.0)
            assert ei2.value.code == E.request_maybe_delivered("").code
            with pytest.raises(E.FDBError) as ei3:
                await net.request("c", Ep("127.0.0.1:1", "x"), None)
            assert ei3.value.code == E.connection_failed("").code
        finally:
            net.close()
            await proc.stop()

    run(go())


def test_reconnect_after_listener_restart():
    E, Ep = PORT.error, PORT.network.Endpoint

    async def go():
        proc = PORT.transport.RealProcess()

        async def ping(body):
            return body

        proc.register("demo.ping", ping)
        await proc.start()
        addr = proc.address
        net = PORT.transport.RealNetwork()
        try:
            assert await net.request("c", Ep(addr, "demo.ping"), 7) == 7
            await proc.stop()
            with pytest.raises(E.FDBError):
                await net.request("c", Ep(addr, "demo.ping"), 8, timeout=1.0)
            proc2 = PORT.transport.RealProcess(port=int(addr.rsplit(":", 1)[1]))
            proc2.register("demo.ping", ping)
            await proc2.start()
            for _ in range(50):
                try:
                    assert await net.request("c", Ep(addr, "demo.ping"), 9) == 9
                    break
                except E.FDBError:
                    await asyncio.sleep(0.1)
            else:
                raise AssertionError("never reconnected")
            await proc2.stop()
        finally:
            net.close()

    run(go())


def test_stalled_handshake_bounded_by_knob():
    """A peer that accepts but never answers the hello surfaces as
    connection_failed (the handshake bound), not a hang."""
    E, Ep = PORT.error, PORT.network.Endpoint
    FLOW = PORT.knobs.FLOW_KNOBS

    async def go():
        silent_conns = []

        async def silent(reader, writer):
            silent_conns.append(writer)

        server = await asyncio.start_server(silent, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        FLOW._values["real_handshake_timeout_s"] = 0.3
        net = PORT.transport.RealNetwork()
        try:
            with pytest.raises(E.FDBError) as ei:
                await net.request("c", Ep(f"127.0.0.1:{port}", "x"), None, timeout=10.0)
            assert ei.value.code == E.connection_failed("").code
            assert "handshake" in str(ei.value)
        finally:
            net.close()
            for w in silent_conns:
                w.close()
            server.close()
            await server.wait_closed()

    run(go())


def test_reconnect_backoff_fails_fast_then_recovers():
    E, Ep = PORT.error, PORT.network.Endpoint
    FLOW = PORT.knobs.FLOW_KNOBS

    async def go():
        FLOW._values["real_reconnect_backoff_initial_s"] = 0.2
        FLOW._values["real_reconnect_backoff_max_s"] = 1.0
        net = PORT.transport.RealNetwork()
        import socket as s

        probe = s.socket()
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        probe.close()
        addr = f"127.0.0.1:{port}"
        try:
            with pytest.raises(E.FDBError):
                await net.request("c", Ep(addr, "x"), None, timeout=1.0)
            peer = net._peers[addr]
            assert peer.fail_streak == 1 and peer.retry_at > 0
            with pytest.raises(E.FDBError) as ei:
                await net.request("c", Ep(addr, "x"), None, timeout=1.0)
            assert "backoff" in str(ei.value)
            assert net.backoff_failfasts >= 1
            assert net.transport_degraded()
            proc2 = PORT.transport.RealProcess(port=port)

            async def ping(body):
                return body

            proc2.register("demo.ping", ping)
            await proc2.start()
            for _ in range(50):
                await asyncio.sleep(0.1)
                try:
                    assert await net.request("c", Ep(addr, "demo.ping"), 5) == 5
                    break
                except E.FDBError:
                    continue
            assert peer.fail_streak == 0
            assert not net.transport_degraded()
            await proc2.stop()
        finally:
            net.close()

    run(go())


@pytest.mark.timeout(120)
def test_two_os_processes():
    """A port demo server in a second OS process serves a port client over
    real TCP."""
    Ep = PORT.network.Endpoint
    server = subprocess.Popen(
        [sys.executable, "-m", "foundationdb_tpu_torch.real.demo_server", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=ROOT)
    try:
        line = server.stdout.readline()
        m = re.search(r"listening on ([\d.]+:\d+)", line)
        assert m, f"no listen line: {line!r}"
        addr = m.group(1)

        async def go():
            net = PORT.transport.RealNetwork()
            try:
                await net.request("c", Ep(addr, "demo.set"), (b"x", b"42"))
                reply = await net.request("c", Ep(addr, "demo.get"),
                                          PORT.messages.GetValueRequest(key=b"x", version=0))
                assert reply.value == b"42"
                await net.one_way("c", Ep(addr, "demo.set"), (b"y", b"1"))
                for _ in range(100):
                    r = await net.request("c", Ep(addr, "demo.get"),
                                          PORT.messages.GetValueRequest(key=b"y", version=0))
                    if r.value == b"1":
                        return True
                    await asyncio.sleep(0.05)
                return False
            finally:
                net.close()

        assert run(go())
    finally:
        server.kill()
        server.wait()
