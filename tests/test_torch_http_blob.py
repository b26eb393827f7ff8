"""The HTTP/1.1 blob store: the port's server and client against the JAX
package's.

The cases of tests/test_http_blob.py that need no wall-clock runtime,
written once over a package's modules and run on both: the round trip of
put, get, list and delete (escaped names, atomic overwrite, reconnect, dot
names), a torn request that must not clobber an object, the startup sweep
of orphaned temp files, stop() with a client still connected, concurrent
requests on one client, the 4xx / 5xx classification of the blobstore
container, and a shut-down client's permanent error. Each server binds
127.0.0.1 at a port it is given by the system (port 0). Each case returns
what it read back; the port's must equal the JAX package's.

The blobstore container of each package bridges the client into its own
wall-clock scheduler (real/runtime.py) with its own TLS policy
(real/tls.py): test_backup_agent_blobstore_container_io's twin drives a
BackupAgent's container IO on both.

Every compared value is bytes, a bool, an int or a string: tolerance 0
(exact equality).
"""
import asyncio
import os
import tempfile

import pytest

from torch_sim_world import BOTH, JAX, PORT


def each_package(case):
    """case(P) under asyncio.run on the port, then on the JAX package."""
    return [asyncio.run(case(P)) for P in BOTH]


async def serving(P):
    srv = P.http_blob.HTTPBlobServer(tempfile.mkdtemp(prefix="blob_"))
    await srv.start()
    return srv, P.http_blob.HTTPBlobClient(f"127.0.0.1:{srv.port}")


async def case_roundtrip(P):
    srv, cli = await serving(P)
    seen = []
    try:
        seen.append(await cli.get("missing"))
        await cli.put("range/0001", b"\x00\xffbinary" * 100)
        await cli.put("range/0002", b"two")
        await cli.put("log/000123", b"log")
        await cli.put("weird /na%me\n", b"escaped")
        seen += [await cli.get("range/0001"), await cli.get("weird /na%me\n"),
                 await cli.list("range/"), await cli.list()]
        await cli.put("range/0001", b"v2")   # overwrite is an atomic install
        seen.append(await cli.get("range/0001"))
        await cli.delete("range/0002")
        seen += [await cli.get("range/0002"), await cli.list("range/")]
        cli.close()                           # transparent reconnect
        seen.append(await cli.get("log/000123"))
        await cli.put("x.tmp", b"i am real")
        await cli.put("x", b"sibling")
        seen += [await cli.get("x.tmp"), await cli.list("x")]
        await cli.put("zA", b"1")
        await cli.put("z[", b"2")
        seen.append(await cli.list("z"))      # raw-name order
        for nasty in (".tmp", ".", ".."):
            await cli.put(nasty, b"dot" + nasty.encode())
            seen.append(await cli.get(nasty))
        seen.append(await cli.list("."))
    finally:
        cli.close()
        await srv.stop()
    return seen


def test_roundtrip_equal():
    port, jax_ = each_package(case_roundtrip)
    assert port == jax_
    assert port[0] is None and port[1] == b"\x00\xffbinary" * 100
    assert port[3] == ["range/0001", "range/0002"] and port[-1] == [".", "..", ".tmp"]


async def case_torn_request(P):
    srv, cli = await serving(P)
    await cli.put("x", b"precious data")
    _r, w = await asyncio.open_connection("127.0.0.1", srv.port)
    w.write(b"PUT /obj/x HTTP/1.1\r\n")   # no headers, no body
    await w.drain()
    w.close()
    await asyncio.sleep(0.1)
    got = await cli.get("x")
    cli.close()
    await srv.stop()
    return got


def test_torn_request_does_not_clobber_object_equal():
    assert each_package(case_torn_request) == [b"precious data"] * 2


async def case_startup_sweep(P):
    root = tempfile.mkdtemp(prefix="blob_")
    srv = P.http_blob.HTTPBlobServer(root)
    await srv.start()
    cli = P.http_blob.HTTPBlobClient(f"127.0.0.1:{srv.port}")
    await cli.put("a", b"1")
    cli.close()
    await srv.stop()
    orphan = os.path.join(root, ".tmp", "7-crashed")
    with open(orphan, "wb") as f:
        f.write(b"partial")
    srv2 = P.http_blob.HTTPBlobServer(root)
    swept = not os.path.exists(orphan)
    await srv2.start()
    cli = P.http_blob.HTTPBlobClient(f"127.0.0.1:{srv2.port}")
    out = (swept, await cli.get("a"), await cli.list())
    cli.close()
    await srv2.stop()
    return out


def test_startup_sweeps_orphaned_temp_files_equal():
    assert each_package(case_startup_sweep) == [(True, b"1", ["a"])] * 2


async def case_stop_with_client_connected(P):
    srv, cli = await serving(P)
    await cli.put("a", b"1")
    await asyncio.wait_for(srv.stop(), timeout=5)   # the client is left open
    cli.close()
    return True


def test_stop_returns_with_client_still_connected_equal():
    assert each_package(case_stop_with_client_connected) == [True, True]


async def case_concurrent_requests(P):
    srv, cli = await serving(P)
    try:
        await asyncio.gather(*[cli.put("c/%03d" % i, b"v%d" % i * 500) for i in range(40)])
        return await asyncio.gather(*[cli.get("c/%03d" % i) for i in range(40)])
    finally:
        cli.close()
        await srv.stop()


def test_concurrent_requests_one_client_equal():
    port, jax_ = each_package(case_concurrent_requests)
    assert port == jax_ == [b"v%d" % i * 500 for i in range(40)]


async def case_error_classification(P):
    """The blobstore container's status mapping (`_classify` needs no
    connection): 4xx is permanent, 5xx retryable connection_failed."""
    container = object.__new__(P.backup_agent._HTTPContainer)

    async def boom(status):
        raise P.http_blob.BlobHTTPError("put", "x", status)

    out = []
    for status in (400, 404, 413, 499, 500, 503):
        with pytest.raises(P.error.FDBError) as e:
            await container._classify(boom(status))
        out.append((status, e.value.code, e.value.is_retryable()))
    return out


def test_blob_http_error_classification_equal():
    port, jax_ = each_package(case_error_classification)
    assert port == jax_
    assert [r for _, _, r in port] == [False] * 4 + [True] * 2


async def case_shutdown_is_permanent(P):
    srv, cli = await serving(P)
    await cli.put("a", b"1")
    cli.shutdown()
    with pytest.raises(P.http_blob.BlobClientShutdown):
        await cli.get("a")
    container = object.__new__(P.backup_agent._HTTPContainer)
    with pytest.raises(P.error.FDBError) as ei:
        await container._classify(cli.get("a"))
    await srv.stop()
    return ei.value.code, ei.value.is_retryable()


def test_shutdown_is_permanent_and_nonretryable_equal():
    port, jax_ = each_package(case_shutdown_is_permanent)
    assert port == jax_ and port[1] is False


async def case_many_small_objects(P):
    srv, cli = await serving(P)
    try:
        for i in range(200):
            await cli.put("o/%04d" % i, b"x%d" % i)
        out = [len(await cli.list("o/"))] + [await cli.get("o/%04d" % i) for i in (0, 57, 199)]
        # an oversized body draws a real 413 on the first attempt and the
        # connection stays usable (the limit is patched in P's own module)
        saved = P.http_blob.MAX_BODY
        P.http_blob.MAX_BODY = 1024
        try:
            with pytest.raises(IOError, match="413"):
                await cli.put("big", b"z" * 2048)
        finally:
            P.http_blob.MAX_BODY = saved
        return out + [await cli.get("big"), await cli.get("o/0000")]
    finally:
        cli.close()
        await srv.stop()


def test_many_small_objects_one_connection_equal():
    port, jax_ = each_package(case_many_small_objects)
    assert port == jax_ == [200, b"x0", b"x57", b"x199", None, b"x0"]


def test_port_blobstore_container_raises_not_implemented():
    """The port's blobstore container no longer raises: a BackupAgent on a
    blobstore:// address builds in both packages, each over its own
    HTTPBlobClient (the name is kept from when the port raised here)."""
    for P in BOTH:
        agent = P.backup.BackupAgent(None, None, "blobstore://127.0.0.1:1")
        assert isinstance(agent._container, P.backup_agent._HTTPContainer)
        assert isinstance(agent._container.client, P.http_blob.HTTPBlobClient)
        agent.close()


async def case_container_io(P):
    """tests/test_http_blob.py::test_backup_agent_blobstore_container_io:
    a BackupAgent on blobstore://host:port puts, gets and lists through
    HTTPBlobClient, bridged from the cooperative RealScheduler loop."""
    root = tempfile.mkdtemp(prefix="blob_")
    srv = P.http_blob.HTTPBlobServer(root)
    await srv.start()
    sched = P.runtime.RealScheduler(seed=0)
    agent = P.backup.BackupAgent(None, None, f"blobstore://127.0.0.1:{srv.port}")

    async def work():
        await agent._put("range/0001", b"rows")
        await agent._put("log/0001", b"muts")
        return [await agent._get("range/0001"), await agent._get("range/none"),
                await agent._list("range/"), await agent._list("")]

    run = asyncio.ensure_future(sched.run_async())
    try:
        got = await asyncio.wait_for(P.runtime.sim_to_aio(sched.spawn(work())), timeout=30.0)
    finally:
        sched.shutdown()
        await asyncio.wait([run])
        agent.close()
        await srv.stop()
    return got, sorted(os.listdir(root))


def test_backup_agent_blobstore_container_io_equal():
    port, jax_ = each_package(case_container_io)
    assert port == jax_
    assert port[0] == [b"rows", None, ["range/0001"], ["log/0001", "range/0001"]]
