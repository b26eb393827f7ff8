"""HTTP/1.1 blob store: server + client for real-mode backup targets.

Port of ``foundationdb_tpu/backup/http_blob.py``.

Re-design of fdbrpc/HTTP.actor.cpp + BlobStore.actor.cpp reduced to the
load-bearing surface: a persistent-connection HTTP/1.1 client speaking
PUT/GET/DELETE on objects and a prefix LIST, and a matching asyncio
server storing objects under a directory (each object a file; names
escaped). A BackupAgent pointed at `blobstore://host:port` drives its
container IO through this client (bridged from the cooperative scheduler
into asyncio) — the real-transport backup target, wire-real sibling of
the sim's in-process container (backup/container.py). End-to-end:
`python -m foundationdb_tpu.real.cluster --backup`.

Protocol (a strict, tiny subset of S3-ish semantics):

    PUT    /obj/<name>        body = object bytes      -> 200
    GET    /obj/<name>                                  -> 200 body | 404
    DELETE /obj/<name>                                  -> 200
    GET    /list?prefix=<p>                             -> 200 newline-joined names
"""
from __future__ import annotations

import asyncio
import itertools
import os
import urllib.parse
from typing import List, Optional, Set

MAX_BODY = 64 << 20
# in-flight writes live one directory down; _esc escapes '.' precisely so
# no object name ('.tmp', '.', '..') can alias this entry or escape root
_TMP_DIR = ".tmp"


def io_timeout(nbytes: int) -> float:
    """Wire-time deadline for transferring `nbytes`: a 5s floor plus
    ~4MB/s of headroom, so a near-MAX_BODY object gets ~21s instead of a
    flat cap it can never clear. Callers that don't know the response
    size ahead of time budget for MAX_BODY."""
    return 5.0 + nbytes / (4 << 20)


def _esc(name: str) -> str:
    # quote() leaves '.' alone, which would let objects named '.', '..'
    # or '.tmp' collide with the filesystem's dot entries / the temp dir
    return urllib.parse.quote(name, safe="").replace(".", "%2E")


async def _read_headers(reader: asyncio.StreamReader) -> int:
    """Consume headers through the blank line; return the content-length
    (0 when absent). Malformed or negative lengths raise ValueError —
    both sides treat that as a framing error and drop the connection."""
    length = 0
    while True:
        h = await reader.readline()
        if h == b"":
            # EOF is NOT end-of-headers: dispatching a torn request as a
            # zero-length-body one would overwrite objects with b""
            raise ValueError("EOF inside headers")
        if h in (b"\r\n", b"\n"):
            return length
        k, _, v = h.decode("latin-1").partition(":")
        if k.strip().lower() == "content-length":
            length = int(v.strip())
            if length < 0:
                raise ValueError("negative content-length")


class HTTPBlobServer:
    """Objects-on-disk blob server; address is host:port."""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0,
                 ssl_context=None):
        self.root = root
        self.host = host
        self.port = port
        self._ssl = ssl_context   # mutual-TLS listener when provided
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: Set[asyncio.StreamWriter] = set()
        self._tmp_seq = itertools.count()
        tmp = os.path.join(root, _TMP_DIR)
        os.makedirs(tmp, exist_ok=True)
        # sweep temp files orphaned by a crash between write and the
        # atomic os.replace — nothing can be in flight before start()
        for leftover in os.listdir(tmp):
            os.unlink(os.path.join(tmp, leftover))

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port, ssl=self._ssl)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # wait_closed() waits for every handler; unblock the ones
            # parked on an idle persistent connection
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()
            self._server = None

    def _path(self, name: str) -> str:
        return os.path.join(self.root, _esc(name))

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                try:
                    method, target, _ver = line.decode().split(" ", 2)
                    length = await _read_headers(reader)
                except ValueError:
                    return
                if length > MAX_BODY:
                    # drain and refuse — the connection stays usable and
                    # the client sees a real status instead of a reset
                    # (which its reconnect would answer by re-sending
                    # the whole oversized body)
                    remaining = length
                    while remaining:
                        chunk = await reader.read(min(1 << 20, remaining))
                        if not chunk:
                            return
                        remaining -= len(chunk)
                    status, out = 413, b""
                else:
                    body = await reader.readexactly(length) if length else b""
                    try:
                        # disk work (fsync of up-to-64MB bodies, full-file
                        # reads, listdir) off the event loop
                        status, out = await asyncio.to_thread(
                            self._dispatch, method, target, body)
                    except OSError:
                        # a SERVER-side filesystem failure (ENOSPC,
                        # permissions) is an answerable error, not a
                        # reason to reset the socket
                        status, out = 500, b""
                writer.write(
                    b"HTTP/1.1 %d X\r\ncontent-length: %d\r\n\r\n"
                    % (status, len(out)))
                writer.write(out)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                ValueError):
            # ValueError: an over-long request line overflows the
            # StreamReader limit inside readline() itself
            pass
        finally:
            self._conns.discard(writer)
            writer.close()

    def _dispatch(self, method: str, target: str, body: bytes):
        url = urllib.parse.urlsplit(target)
        if url.path == "/list" and method == "GET":
            prefix = urllib.parse.parse_qs(url.query).get("prefix", [""])[0]
            # filter + sort on RAW names (matching the sim container's
            # order); names ride the wire ESCAPED (a raw name may contain
            # the newline the framing uses) and the client unquotes
            names = sorted(
                raw for raw in (urllib.parse.unquote(n)
                                for n in os.listdir(self.root)
                                if n != _TMP_DIR)
                if raw.startswith(prefix))
            return 200, "\n".join(_esc(n) for n in names).encode()
        if not url.path.startswith("/obj/"):
            return 404, b""
        name = urllib.parse.unquote(url.path[len("/obj/"):])
        path = self._path(name)
        if method == "PUT":
            tmp = os.path.join(self.root, _TMP_DIR,
                               "%d-%s" % (next(self._tmp_seq), _esc(name)))
            with open(tmp, "wb") as f:
                f.write(body)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)   # objects appear atomically
            # the rename itself must be durable before we ack: without a
            # directory fsync a power failure rolls it back and the
            # startup sweep then reclaims the fully-written temp file
            self._sync_root()
            return 200, b""
        if method == "GET":
            try:
                with open(path, "rb") as f:
                    return 200, f.read()
            except FileNotFoundError:
                return 404, b""
        if method == "DELETE":
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            else:
                self._sync_root()   # an acked delete must survive a crash
            return 200, b""
        return 405, b""

    def _sync_root(self) -> None:
        fd = os.open(self.root, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


class BlobClientShutdown(ConnectionError):
    """Raised by a client whose shutdown() has run: PERMANENT, unlike the
    transient connection errors the retry paths are allowed to chew on."""


class BlobHTTPError(IOError):
    """A non-200 answered by the blob server; `.status` lets callers
    separate permanent refusals (4xx: oversized body, bad request) from
    server-side failures — retrying a 413 forever can never succeed."""

    def __init__(self, op: str, name: str, status: int):
        super().__init__(f"blob {op} {name!r}: HTTP {status}")
        self.status = status


class HTTPBlobClient:
    """Persistent-connection blob client (the BlobStore client's role)."""

    def __init__(self, address: str, ssl_context=None):
        self.address = address
        self._ssl = ssl_context
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._shutdown = False
        # one connection, one in-flight request: concurrent callers
        # (asyncio.gather of puts) serialize here instead of interleaving
        # reads on the shared stream and desyncing every later response
        self._lock = asyncio.Lock()

    async def _conn(self):
        if self._shutdown:
            # a final shutdown() must stick: without this, an in-flight
            # request's transparent-reconnect path would resurrect the
            # connection after teardown and leak it
            raise BlobClientShutdown("client is shut down")
        if self._writer is None or self._writer.is_closing():
            host, port = self.address.rsplit(":", 1)
            r, w = await asyncio.open_connection(host, int(port),
                                                 ssl=self._ssl)
            if self._shutdown:
                # shutdown() ran while open_connection was in flight and
                # saw nothing to close — don't adopt the new socket
                w.close()
                raise BlobClientShutdown("client is shut down")
            self._reader, self._writer = r, w
        return self._reader, self._writer

    async def _once(self, method: str, target: str, body: bytes):
        r, w = await self._conn()
        w.write(b"%s %s HTTP/1.1\r\ncontent-length: %d\r\n\r\n"
                % (method.encode(), target.encode(), len(body)))
        if body:
            w.write(body)
        await w.drain()
        status_line = await r.readline()
        status = int(status_line.split()[1])
        length = await _read_headers(r)
        out = await r.readexactly(length) if length else b""
        return status, out

    async def _request(self, method: str, target: str, body: bytes = b"",
                       timeout: Optional[float] = None):
        async with self._lock:
            for attempt in (0, 1):   # one transparent reconnect
                try:
                    # the deadline starts HERE, after the lock: queue wait
                    # behind other transfers on the shared connection must
                    # not eat a request's wire-time budget
                    coro = self._once(method, target, body)
                    if timeout is not None:
                        return await asyncio.wait_for(coro, timeout)
                    return await coro
                except BlobClientShutdown:
                    raise   # permanent by contract: retrying is pointless
                except asyncio.CancelledError:
                    # a cancelled half-read would leave the persistent
                    # connection desynced (every later response off by
                    # one) — drop it before propagating
                    self.close()
                    raise
                except (ConnectionError, OSError, asyncio.TimeoutError,
                        asyncio.IncompleteReadError, IndexError, ValueError):
                    # asyncio.TimeoutError is spelled explicitly: it only
                    # became an OSError on 3.11+, and a deadline that
                    # skipped close() would leave the connection desynced
                    self.close()
                    if attempt:
                        raise
            raise ConnectionError("unreachable")

    async def put(self, name: str, data: bytes,
                  timeout: Optional[float] = None) -> None:
        status, _ = await self._request("PUT", "/obj/" + _esc(name), data,
                                        timeout=timeout)
        if status != 200:
            raise BlobHTTPError("put", name, status)

    async def get(self, name: str,
                  timeout: Optional[float] = None) -> Optional[bytes]:
        status, body = await self._request("GET", "/obj/" + _esc(name),
                                           timeout=timeout)
        if status == 404:
            return None
        if status != 200:
            raise BlobHTTPError("get", name, status)
        return body

    async def delete(self, name: str,
                     timeout: Optional[float] = None) -> None:
        status, _ = await self._request("DELETE", "/obj/" + _esc(name),
                                        timeout=timeout)
        if status != 200:
            # a swallowed 500 here would make retention loops believe
            # the object is gone while it still exists
            raise BlobHTTPError("delete", name, status)

    async def list(self, prefix: str = "",
                   timeout: Optional[float] = None) -> List[str]:
        status, body = await self._request(
            "GET", "/list?prefix=" + urllib.parse.quote(prefix),
            timeout=timeout)
        if status != 200:
            raise BlobHTTPError("list", prefix, status)
        return [urllib.parse.unquote(n) for n in body.decode().split("\n") if n]

    def close(self) -> None:
        """Drop the current connection; the next request reconnects."""
        if self._writer is not None:
            self._writer.close()
        self._reader = self._writer = None

    def shutdown(self) -> None:
        """Final close: drops the connection AND refuses reconnects, so
        an in-flight retry can't bring the socket back."""
        self._shutdown = True
        self.close()
