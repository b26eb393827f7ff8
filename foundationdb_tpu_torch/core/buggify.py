"""Fault-injection coin flips and coverage probes.

Port of ``foundationdb_tpu/core/buggify.py``; off unless enable() is called.

Analog of the reference's BUGGIFY macro (flow/flow.h:65-66) and TEST coverage
probes (220 call sites): per-call-site randomized fault triggers, enabled only
in simulation, each site firing with an independently-chosen probability so a
long simulation eventually exercises every rare branch. Coverage is harvested
per site like flow/coveragetool.
"""
from __future__ import annotations

import inspect
from typing import Dict, Optional, Tuple

from .rng import DeterministicRandom

_enabled = False
_rng: Optional[DeterministicRandom] = None
#: site -> (activated?, fire probability)
_sites: Dict[Tuple[str, int], Tuple[bool, float]] = {}
#: coverage: site/comment -> times condition held
coverage: Dict[Tuple[str, int, str], int] = {}
#: buggify sites that actually FIRED (returned True); NOT cleared by
#: enable(), so a coverage harvest can union firings across many seeds
#: (the flow/coveragetool role for fault-injection sites)
fired: set = set()

SITE_ACTIVATED_PROBABILITY = 0.25
FIRE_PROBABILITY = 0.05


def enable(rng: DeterministicRandom) -> None:
    global _enabled, _rng
    _enabled = True
    _rng = rng
    _sites.clear()


def disable() -> None:
    global _enabled, _rng
    _enabled = False
    _rng = None


def is_enabled() -> bool:
    return _enabled


def buggify() -> bool:
    """True at randomly-activated call sites with small probability.

    Mirrors the reference's two-level scheme: each site is first activated
    with probability P_activate for the whole simulation, then fires per-call
    with probability P_fire (flow/FaultInjection.cpp)."""
    if not _enabled or _rng is None:
        return False
    frame = inspect.currentframe()
    caller = frame.f_back if frame else None
    site = (caller.f_code.co_filename, caller.f_lineno) if caller else ("?", 0)
    if site not in _sites:
        _sites[site] = (_rng.random01() < SITE_ACTIVATED_PROBABILITY, FIRE_PROBABILITY)
    activated, p = _sites[site]
    hit = activated and _rng.random01() < p
    if hit:
        fired.add(site)
    return hit


def test_probe(condition: bool, comment: str) -> bool:
    """Coverage probe: records that a rare branch was reached
    (reference: TEST(condition) macro)."""
    if condition:
        frame = inspect.currentframe()
        caller = frame.f_back if frame else None
        site = (
            caller.f_code.co_filename if caller else "?",
            caller.f_lineno if caller else 0,
            comment,
        )
        coverage[site] = coverage.get(site, 0) + 1
    return condition
