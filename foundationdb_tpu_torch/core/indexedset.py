"""IndexedSet: an ordered map with metric sums (order statistics).

Port of ``foundationdb_tpu/core/indexedset.py``.

Re-design of flow/IndexedSet.h (1114 LoC): a balanced search tree where
every node carries a METRIC and every subtree its metric sum, so
"total metric", "metric of everything below k", and "the key where the
running metric crosses m" are O(log n) — the primitives behind the
reference's byte samples and range accounting (StorageMetrics,
KeyRangeMap's metric uses).

Implementation: a treap with DETERMINISTIC priorities (a hash of the
key), so tree shape — and thus iteration cost and any tie-sensitive
query — is identical across runs and processes (the repo's determinism
rule; a random-priority treap would not be). Every operation is
ITERATIVE: a degenerate priority sequence makes the tree a chain, and a
recursive walk would then blow the interpreter's frame limit out of the
storage server's per-mutation sampling path."""
from __future__ import annotations

import zlib
from typing import Iterator, List, Optional, Tuple

from .types import key_after


def _priority(key: bytes) -> int:
    return zlib.crc32(key, 0x9E3779B9)


class _Node:
    __slots__ = ("key", "metric", "prio", "left", "right", "sum", "size")

    def __init__(self, key: bytes, metric: int):
        self.key = key
        self.metric = metric
        self.prio = _priority(key)
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None
        self.sum = metric
        self.size = 1

    def pull(self) -> None:
        s = self.metric
        c = 1
        if self.left is not None:
            s += self.left.sum
            c += self.left.size
        if self.right is not None:
            s += self.right.sum
            c += self.right.size
        self.sum = s
        self.size = c


def _split(n: Optional[_Node], key: bytes) -> Tuple[Optional[_Node], Optional[_Node]]:
    """(everything < key, everything >= key). Iterative spine walk."""
    left_root = right_root = None
    left_tail = right_tail = None
    touched: List[_Node] = []
    while n is not None:
        if n.key < key:
            touched.append(n)
            if left_tail is None:
                left_root = n
            else:
                left_tail.right = n
            left_tail = n
            n = n.right
        else:
            touched.append(n)
            if right_tail is None:
                right_root = n
            else:
                right_tail.left = n
            right_tail = n
            n = n.left
    if left_tail is not None:
        left_tail.right = None
    if right_tail is not None:
        right_tail.left = None
    for node in reversed(touched):
        node.pull()
    return left_root, right_root


def _merge(a: Optional[_Node], b: Optional[_Node]) -> Optional[_Node]:
    """Merge (all keys of a < all keys of b). Iterative spine splice."""
    if a is None:
        return b
    if b is None:
        return a
    root: Optional[_Node] = None
    tail: Optional[_Node] = None
    tail_side = ""
    touched: List[_Node] = []
    while a is not None and b is not None:
        if a.prio >= b.prio:
            nxt = a.right
            node, side = a, "r"
            a = nxt
        else:
            nxt = b.left
            node, side = b, "l"
            b = nxt
        touched.append(node)
        if tail is None:
            root = node
        elif tail_side == "r":
            tail.right = node
        else:
            tail.left = node
        tail, tail_side = node, side
    rest = a if a is not None else b
    if tail_side == "r":
        tail.right = rest
    else:
        tail.left = rest
    for node in reversed(touched):
        node.pull()
    return root


class IndexedSet:
    def __init__(self) -> None:
        self._root: Optional[_Node] = None

    def __len__(self) -> int:
        return self._root.size if self._root is not None else 0

    def total(self) -> int:
        return self._root.sum if self._root is not None else 0

    def get(self, key: bytes) -> Optional[int]:
        n = self._root
        while n is not None:
            if key == n.key:
                return n.metric
            n = n.left if key < n.key else n.right
        return None

    def insert(self, key: bytes, metric: int) -> Optional[int]:
        """Set key's metric (single pass: the old node, if any, is removed
        by the same pair of splits that places the new one); returns the
        previous metric (None if new)."""
        a, rest = _split(self._root, key)
        mid, b = _split(rest, key_after(key))
        self._root = _merge(_merge(a, _Node(key, metric)), b)
        return mid.metric if mid is not None else None

    def erase(self, key: bytes) -> Optional[int]:
        """Remove key; returns its metric (None if absent). A miss costs
        one non-mutating descent, not the split/merge spine surgery —
        erase-of-absent is the common case on the storage sampling path."""
        if self.get(key) is None:
            return None
        a, rest = _split(self._root, key)
        mid, b = _split(rest, key_after(key))
        self._root = _merge(a, b)
        return mid.metric if mid is not None else None

    def erase_range(self, begin: bytes, end: bytes) -> int:
        """Remove every key in [begin, end); returns the erased metric sum."""
        a, rest = _split(self._root, begin)
        mid, b = _split(rest, end)
        self._root = _merge(a, b)
        return mid.sum if mid is not None else 0

    def sum_below(self, key: bytes) -> int:
        """Metric sum of every entry with key < `key` (sumTo)."""
        n = self._root
        acc = 0
        while n is not None:
            if n.key < key:
                acc += n.metric
                if n.left is not None:
                    acc += n.left.sum
                n = n.right
            else:
                n = n.left
        return acc

    def split_key(self) -> Optional[bytes]:
        """The FIRST key (ascending) whose inclusive prefix sum doubles to
        at least the total — the byte-sample median split point
        (StorageMetrics' splitEstimate)."""
        total = self.total()
        if total <= 0 or self._root is None:
            return None
        n = self._root
        acc = 0   # metric strictly left of the current subtree
        best: Optional[bytes] = None
        while n is not None:
            left_sum = n.left.sum if n.left is not None else 0
            inclusive = acc + left_sum + n.metric
            if 2 * inclusive >= total:
                best = n.key
                n = n.left
            else:
                acc += left_sum + n.metric
                n = n.right
        return best

    def items(self) -> Iterator[Tuple[bytes, int]]:
        """Ascending (key, metric) pairs (iterative; no recursion limit)."""
        stack: List[_Node] = []
        n = self._root
        while stack or n is not None:
            while n is not None:
                stack.append(n)
                n = n.left
            n = stack.pop()
            yield n.key, n.metric
            n = n.right
