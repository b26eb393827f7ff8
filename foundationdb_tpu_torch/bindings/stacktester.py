"""Stack-machine conformance tester (the bindings/bindingtester/ role).

Port of ``foundationdb_tpu/bindings/stacktester.py``.

The reference's bindingtester drives two language bindings through an
identical randomized instruction stream and diffs the resulting database
state + logged stack results (bindingtester.py + spec/). Here the two
"bindings" are two full STACKS OF THE FRAMEWORK differing in their
conflict engine (oracle vs TPU kernel vs sharded mesh) — every op goes
through the real client (RYW, selectors, atomics, tuple layer) into a
real simulated cluster, so a diff catches divergence anywhere from tuple
encoding to resolver verdicts.

Instruction set (the load-bearing subset of the reference's spec/):
    PUSH x | DUP | SWAP | POP | CONCAT | TUPLE_PACK n | TUPLE_UNPACK
    NEW_TRANSACTION | COMMIT | RESET
    SET | GET | CLEAR | CLEAR_RANGE | GET_RANGE | ATOMIC_ADD
    LOG_STACK  (append the popped stack to the result journal)

Execution semantics mirror the reference: GET pushes the value (or
b'RESULT_NOT_PRESENT'); COMMIT pushes b'COMMITTED' or the error name;
every engine must produce an IDENTICAL journal + final keyspace.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ..core import error
from ..core.rng import DeterministicRandom
from . import fdb_tuple

NOT_PRESENT = b"RESULT_NOT_PRESENT"

OPS = (
    "PUSH", "DUP", "SWAP", "POP", "CONCAT", "TUPLE_PACK", "TUPLE_UNPACK",
    "NEW_TRANSACTION", "COMMIT", "RESET",
    "SET", "GET", "CLEAR", "CLEAR_RANGE", "GET_RANGE", "ATOMIC_ADD",
    "LOG_STACK",
)


def generate_stream(seed: int, n: int = 120) -> List[Tuple]:
    """A deterministic instruction stream: weighted toward data ops, with
    enough stack shuffling to exercise encode/decode paths."""
    rng = DeterministicRandom(seed)

    def rkey() -> bytes:
        return b"st/%03d" % rng.random_int(0, 40)

    def rval() -> bytes:
        return b"v%06d" % rng.random_int(0, 10**6)

    out: List[Tuple] = [("NEW_TRANSACTION",)]
    for _ in range(n):
        r = rng.random01()
        if r < 0.22:
            out.append(("PUSH", rkey()))
            out.append(("PUSH", rval()))
            out.append(("SET",))
        elif r < 0.38:
            out.append(("PUSH", rkey()))
            out.append(("GET",))
        elif r < 0.46:
            out.append(("PUSH", rkey()))
            out.append(("CLEAR",))
        elif r < 0.52:
            a, b = sorted([rkey(), rkey()])
            out.append(("PUSH", a))
            out.append(("PUSH", b + b"\x00"))
            out.append(("CLEAR_RANGE",))
        elif r < 0.60:
            a, b = sorted([rkey(), rkey()])
            out.append(("PUSH", a))
            out.append(("PUSH", b + b"\x00"))
            out.append(("GET_RANGE",))
        elif r < 0.66:
            out.append(("PUSH", rkey()))
            out.append(("PUSH", rng.random_int(0, 1000).to_bytes(8, "little")))
            out.append(("ATOMIC_ADD",))
        elif r < 0.72:
            out.append(("PUSH", (rkey(), rng.random_int(0, 99), "s")))
            out.append(("TUPLE_PACK",))
        elif r < 0.76 and rng.random01() < 0.5:
            out.append(("TUPLE_UNPACK",))
        elif r < 0.82:
            out.append(("DUP",))
        elif r < 0.86:
            out.append(("SWAP",))
        elif r < 0.90:
            out.append(("POP",))
        elif r < 0.94:
            out.append(("LOG_STACK",))
        elif r < 0.97:
            out.append(("COMMIT",))
            out.append(("NEW_TRANSACTION",))
        else:
            out.append(("RESET",))
    out.append(("COMMIT",))
    out.append(("LOG_STACK",))
    return out


async def run_stream(db, stream: List[Tuple]) -> List[bytes]:
    """Execute the stream against a Database; returns the journal every
    conforming stack must reproduce byte-for-byte."""
    stack: List[Any] = []
    journal: List[bytes] = []
    tr = db.create_transaction()

    def pop(n: int = 1):
        nonlocal stack
        got, stack = stack[-n:], stack[:-n]
        return got[::-1]

    def as_bytes(x: Any) -> bytes:
        if isinstance(x, bytes):
            return x
        if x is None:
            return NOT_PRESENT
        return repr(x).encode()

    for ins in stream:
        op = ins[0]
        try:
            if op == "PUSH":
                stack.append(ins[1])
            elif op == "DUP":
                if stack:
                    stack.append(stack[-1])
            elif op == "SWAP":
                if len(stack) >= 2:
                    stack[-1], stack[-2] = stack[-2], stack[-1]
            elif op == "POP":
                if stack:
                    stack.pop()
            elif op == "CONCAT":
                if len(stack) >= 2:
                    a, b = pop(2)
                    stack.append(as_bytes(a) + as_bytes(b))
            elif op == "TUPLE_PACK":
                if stack:
                    (t,) = pop(1)
                    stack.append(fdb_tuple.pack(t if isinstance(t, tuple) else (t,)))
            elif op == "TUPLE_UNPACK":
                if stack and isinstance(stack[-1], bytes):
                    (raw,) = pop(1)
                    try:
                        stack.append(repr(fdb_tuple.unpack(raw)).encode())
                    except Exception:       # noqa: BLE001 — not a tuple key
                        stack.append(b"ERROR: NOT_A_TUPLE")
            elif op == "NEW_TRANSACTION":
                tr = db.create_transaction()
            elif op == "RESET":
                tr.reset()
            elif op == "COMMIT":
                try:
                    await tr.commit()
                    stack.append(b"COMMITTED")
                except error.FDBError as e:
                    stack.append(b"ERROR: " + e.name.encode())
                tr = db.create_transaction()
            elif op == "SET":
                if len(stack) >= 2:
                    v, k = pop(2)
                    tr.set(as_bytes(k), as_bytes(v))
            elif op == "GET":
                if stack:
                    (k,) = pop(1)
                    stack.append(as_bytes(await tr.get(as_bytes(k))))
            elif op == "CLEAR":
                if stack:
                    (k,) = pop(1)
                    tr.clear(as_bytes(k))
            elif op == "CLEAR_RANGE":
                if len(stack) >= 2:
                    e_, b_ = pop(2)
                    tr.clear_range(as_bytes(b_), as_bytes(e_))
            elif op == "GET_RANGE":
                if len(stack) >= 2:
                    e_, b_ = pop(2)
                    rows = await tr.get_range(as_bytes(b_), as_bytes(e_), limit=50)
                    stack.append(fdb_tuple.pack(
                        tuple(x for kv in rows for x in kv)))
            elif op == "ATOMIC_ADD":
                if len(stack) >= 2:
                    from ..core.types import MutationType

                    v, k = pop(2)
                    tr.atomic_op(as_bytes(k), as_bytes(v), MutationType.ADD_VALUE)
            elif op == "LOG_STACK":
                journal.append(fdb_tuple.pack(tuple(as_bytes(x) for x in stack)))
                stack = []
        except error.FDBError as e:
            stack.append(b"ERROR: " + e.name.encode())
            tr = db.create_transaction()
    return journal


async def final_state(db) -> List[Tuple[bytes, bytes]]:
    async def rd(tr):
        return await tr.get_range(b"st/", b"st/\xff", limit=10_000)
    return await db.run(rd)
