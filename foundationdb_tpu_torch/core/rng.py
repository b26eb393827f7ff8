"""Deterministic random source.

Port of ``foundationdb_tpu/core/rng.py`` (the same class and streams).

Analog of the reference's seeded generator (flow/DeterministicRandom.h:1-119):
one seeded stream drives every randomized decision in simulation so a failing
run replays exactly from its seed. A separate nondeterministic stream exists
for things that must not perturb simulation (IDs in trace logs, etc.)
(reference: g_random vs g_nondeterministic_random, flow/flow.cpp).
"""
from __future__ import annotations

import random
from typing import List, Sequence, TypeVar

T = TypeVar("T")


class DeterministicRandom:
    def __init__(self, seed: int):
        self._seed = seed
        self._r = random.Random(seed)

    @property
    def seed(self) -> int:
        return self._seed

    def random01(self) -> float:
        return self._r.random()

    def random_int(self, lo: int, hi: int) -> int:
        """Uniform integer in [lo, hi) — half-open like the reference randomInt."""
        assert hi > lo
        return self._r.randrange(lo, hi)

    def random_int64(self, lo: int, hi: int) -> int:
        return self._r.randrange(lo, hi)

    def coinflip(self) -> bool:
        return self._r.random() < 0.5

    def random_unique_id(self) -> int:
        return self._r.getrandbits(64)

    def random_alpha_numeric(self, length: int) -> str:
        alphabet = "abcdefghijklmnopqrstuvwxyz0123456789"
        return "".join(self._r.choice(alphabet) for _ in range(length))

    def random_bytes(self, length: int) -> bytes:
        return self._r.getrandbits(8 * length).to_bytes(length, "big") if length else b""

    def random_choice(self, seq: Sequence[T]) -> T:
        return seq[self.random_int(0, len(seq))]

    def shuffle(self, lst: List[T]) -> None:
        self._r.shuffle(lst)

    def fork(self) -> "DeterministicRandom":
        """Derive an independent deterministic substream."""
        return DeterministicRandom(self._r.getrandbits(63))


# Global streams, installed by the simulator or real-world bootstrap
# (reference: g_random / g_nondeterministic_random).
g_random: DeterministicRandom = DeterministicRandom(0)
g_nondeterministic_random: DeterministicRandom = DeterministicRandom(
    random.SystemRandom().getrandbits(63)
)


def set_global_random(rng: DeterministicRandom) -> None:
    global g_random
    g_random = rng
