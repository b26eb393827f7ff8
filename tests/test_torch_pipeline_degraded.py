"""The port's ResolverPipeline collapses to depth 1 while degraded, as the
JAX package's does.

One stub engine with the columnar pack/dispatch split stands behind both
packages' pipelines. Its `degraded` flag flips mid-stream (a failed-over
ResilientEngine), and a `transport_degraded_fn` toggles (a flapping link).
Phase by phase, the peak of batches dispatched and not yet forced, the
pipeline's `effective_depth` and `degraded`, `suggested_batch_txns` from a
BudgetBatcher, and the verdicts of every batch must equal the JAX
package's. The first submit of a phase is its own phase ("<name>/enter"):
it still dispatches the batch the last phase packed. The budget is wide,
so the batch target depends only on which buckets were observed and on
the collapse, never on wall time.
"""
import pytest

from foundationdb_tpu.pipeline import BudgetBatcher as JaxBatcher
from foundationdb_tpu.pipeline import ResolverPipeline as JaxPipeline
from foundationdb_tpu_torch.pipeline import BudgetBatcher, ResolverPipeline

LADDER = (32, 64, 128)
#: (phase, engine degraded, transport degraded, batches)
PHASES = (("healthy", False, False, 6), ("engine", True, False, 5),
          ("healthy2", False, False, 4), ("transport", False, True, 5),
          ("both", True, True, 3), ("healthy3", False, False, 5))


class StubEngine:
    """Columnar engine whose verdict of txn i at version v is (v + i) % 3;
    it records the peak of dispatched-but-unforced batches per phase."""

    dispatch_mode = "step"

    def __init__(self):
        self.degraded = False
        self.phase = None
        self.outstanding = 0
        self.peaks = {}

    def columnar_pack(self, txns, now, new_oldest):
        n = len(txns)
        bucket = next((t for t in LADDER if t >= n), LADDER[-1])
        return {"n": n, "now": now, "chunk_buckets": [bucket]}

    def columnar_dispatch(self, plan):
        self.outstanding += 1
        self.peaks[self.phase] = max(self.peaks.get(self.phase, 0), self.outstanding)

        def force():
            self.outstanding -= 1
            return [(plan["now"] + i) % 3 for i in range(plan["n"])]

        return force

    def resolve(self, txns, now, new_oldest):
        raise AssertionError("a columnar plan never takes the general router")


def drive(pipeline_cls, batcher_cls, depth):
    eng = StubEngine()
    link = {"degraded": False}
    batcher = batcher_cls(LADDER, budget_ms=1e9)
    pipe = pipeline_cls(eng, depth=depth, batcher=batcher,
                        transport_degraded_fn=lambda: link["degraded"])
    seen, pending, version = [], [], 0
    for name, engine_degraded, link_degraded, n_batches in PHASES:
        eng.degraded, link["degraded"] = engine_degraded, link_degraded
        for k in range(n_batches):
            # the first submit of a phase still dispatches the batch the
            # last phase packed: its peak is the transition's
            eng.phase = name if k else name + "/enter"
            version += 10
            n_txns = (17, 40, 90, 128)[(version // 10 + k) % 4]
            pending.append(pipe.submit([object()] * n_txns, version, max(0, version - 40)))
            seen.append((name, pipe.in_flight, pipe.effective_depth, pipe.degraded,
                         pipe.suggested_batch_txns()))
    eng.phase = "drain"
    verdicts = [pb.result() for pb in pending]
    return seen, eng.peaks, verdicts


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_degraded_collapse_equals_jax(depth):
    seen, peaks, verdicts = drive(ResolverPipeline, BudgetBatcher, depth)
    j_seen, j_peaks, j_verdicts = drive(JaxPipeline, JaxBatcher, depth)
    assert seen == j_seen
    assert peaks == j_peaks
    assert verdicts == j_verdicts
    # the collapse itself: depth batches in flight only while healthy, one
    # while the engine or the link is degraded, and the smallest bucket as
    # the batch target there
    for name, engine_degraded, link_degraded, _ in PHASES:
        assert peaks[name] == (1 if engine_degraded or link_degraded else depth)
    for name, in_flight, eff, degraded, target in seen:
        bad = name in ("engine", "transport", "both")
        assert degraded is bad and eff == (1 if bad else depth)
        assert in_flight <= eff
        if bad:
            assert target == LADDER[0]


def test_degraded_target_tracks_observed_buckets():
    """While healthy the target is the largest observed bucket within the
    budget; once degraded it is the smallest, and it comes back after."""
    seen, _, _ = drive(ResolverPipeline, BudgetBatcher, 3)
    j_seen, _, _ = drive(JaxPipeline, JaxBatcher, 3)
    targets = [(name, target) for name, *_, target in seen]
    assert targets == [(name, target) for name, *_, target in j_seen]
    assert ("healthy3", LADDER[-1]) in targets
    assert all(t == LADDER[0] for name, t in targets if name in ("engine", "transport", "both"))
