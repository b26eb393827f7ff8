"""Replication policy: team selection across failure domains.

Port of ``foundationdb_tpu/server/replication_policy.py``.

Re-design of the reference's policy DSL (fdbrpc/ReplicationPolicy.h:280
PolicyAcross / PolicyAnd over LocalityData) reduced to the composition the
framework actually deploys: choose/validate replica teams spread across
distinct locality values (machine, then datacenter as the outer domain).
Localities flow from each worker's registration (SimProcess machine_id /
dc_id — the sim's LocalityData) through the cluster controller to the
master's data distribution.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

Locality = Tuple[str, str]          # (machine_id, dc_id)


class PolicyAcross:
    """`count` replicas across distinct values of `field` ("machine_id" or
    "dc_id"); falls back to best-effort spread when the pool has fewer
    distinct domains than replicas (the reference's team builder likewise
    degrades rather than stalling on small clusters)."""

    def __init__(self, count: int, field: str = "machine_id"):
        assert field in ("machine_id", "dc_id")
        self.count = count
        self.field = field

    def _value(self, loc: Optional[Locality]) -> str:
        if loc is None:
            return ""
        return loc[0] if self.field == "machine_id" else loc[1]

    def select(
        self,
        candidates: Sequence[str],
        localities: Dict[str, Locality],
    ) -> Optional[List[str]]:
        """Pick `count` addresses, preferring distinct domains; determinate
        given candidate order. None if the pool is too small."""
        if len(candidates) < self.count:
            return None
        chosen: List[str] = []
        used_domains: set = set()
        # pass 1: one per distinct domain
        for a in candidates:
            if len(chosen) == self.count:
                return chosen
            d = self._value(localities.get(a))
            if d not in used_domains:
                chosen.append(a)
                used_domains.add(d)
        # pass 2 (degraded): fill from the remainder
        for a in candidates:
            if len(chosen) == self.count:
                break
            if a not in chosen:
                chosen.append(a)
        return chosen if len(chosen) == self.count else None

    def validate(self, team: Sequence[str], localities: Dict[str, Locality]) -> bool:
        """True iff the team spans min(count, distinct-available) domains."""
        domains = {self._value(localities.get(a)) for a in team}
        all_domains = {self._value(l) for l in localities.values()} or {""}
        need = min(self.count, len(all_domains))
        return len(team) >= self.count and len(domains) >= need
