"""Wait-failure keepalive protocol.

Port of ``foundationdb_tpu/server/wait_failure.py``.

Re-design of fdbserver/WaitFailure.actor.cpp: a role exposes a tiny ping
endpoint; watchers ping it in a loop with a reply-timeout. Silence — whether
from death, partition, or severe clogging — is treated as failure. This is
the mechanism by which the cluster controller notices a dead master and the
master notices dead tlogs/resolvers/proxies, turning "a partitioned request
hangs forever" into a detected role failure (round-1 VERDICT weak #4).

The server holds each ping for `hold` seconds before replying, so a healthy
link costs one round trip per `hold` interval; the client allows
`hold + react` seconds before declaring failure, giving a detection latency
of about `react` after the last successful exchange.
"""
from __future__ import annotations

from ..core import error
from ..sim.loop import TaskPriority, delay
from ..sim.network import Endpoint, SimProcess

WAIT_FAILURE_TOKEN = "waitFailure"

#: reference knobs WAIT_FAILURE_DELAY_LIMIT / FAILURE_REACTION_TIME analogs
HOLD_SECONDS = 0.5
REACT_SECONDS = 1.0


def serve_wait_failure(proc: SimProcess, token: str = WAIT_FAILURE_TOKEN) -> Endpoint:
    """Register the keepalive endpoint on a role's process."""

    async def handler(_req) -> None:
        await delay(HOLD_SECONDS, TaskPriority.FAILURE_MONITOR)
        return None

    return proc.register(token, handler)


async def wait_failure_client(
    net,
    src_addr: str,
    endpoint: Endpoint,
    react_seconds: float = REACT_SECONDS,
) -> None:
    """Returns (normally) when the endpoint is considered failed
    (reference: waitFailureClient). Cancel the surrounding actor to stop
    watching."""
    while True:
        try:
            await net.request(
                src_addr,
                endpoint,
                None,
                TaskPriority.FAILURE_MONITOR,
                timeout=HOLD_SECONDS + react_seconds,
            )
        except error.FDBError:
            # connection_failed / request_maybe_delivered / timeout: failed.
            return
