"""chip_smoke.py's warmed-engine pool on the CPU.

The dynamic specs draw their card engines from chip_smoke's EnginePool:
a later spec recruits the engines an earlier one spent, emptied. Here two
dynamic specs recruit CPU engines from one pool, and, as on the card, the
replays of every engine's recorded calls run only after both specs: each
spec equals its oracle twin, every engine's calls and supervisor journal
equal a fresh oracle's replay, and each supervisor's health equals the
twin's. A released engine records nothing more into the run that spent it.
"""
import torch

import chip_smoke as cs
from foundationdb_tpu_torch.ops import fixpoint_cuda as fc
from foundationdb_tpu_torch.ops import host_engine as he
from foundationdb_tpu_torch.testing.specs import make_engine_factory

from torch_sim_world import clean_world

torch.set_num_threads(1)

SPECS = ("DeviceNemesis", "CycleTestAttrition")


def test_pooled_dynamic_specs_equal_their_oracle_twins_after_every_run(monkeypatch):
    failed = []
    monkeypatch.setattr(cs, "check", lambda cond, msg: cond or failed.append(msg))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    clean_world()
    try:
        with cs.EnginePool(he) as pool:
            make = make_engine_factory(device="cpu")
        assert he.make_engine is pool.make          # the pool's patch is gone
        runs = {name: cs.dynamic_spec_run(fc, name, 1, make, pool) for name in SPECS}
        assert pool.reused > 0
        for name, run in runs.items():
            cs.fill_mismatches(run["engines"], cs.engines_mismatches(run.pop("replays")))
            cs.check_dynamic_spec(name, 1, run, cs.oracle_dynamic_spec(name, 1))
    finally:
        clean_world()
    # the card-only checks: the engines' device and the kernel's launches
    assert failed and all(" is on cpu" in m or "fixpoint launches" in m for m in failed), failed


def test_release_takes_off_the_runs_wrappers(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    clean_world()
    try:
        with cs.EnginePool(he) as pool:
            make = make_engine_factory(device="cpu")
        eng = make()
        rec = cs.record_engine(eng)
        eng.clear(5)
        pool.release([eng])
        again = make()
        assert again is eng and "resolve" not in eng.__dict__ and "clear" not in eng.__dict__
        again.clear(7)
        assert rec["calls"] == [("clear", 5)]
        assert (pool.built, pool.reused) == (1, 1)
    finally:
        clean_world()
