"""The port's CUDA fixpoint kernel on the card, against its plain version.

Every test here needs an NVIDIA card and skips without one. The file
imports neither jax nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(--noconftest: tests/conftest.py sets up jax for the rest of the suite.)
All quantities are integers: every comparison is exact.
"""
import random

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.core.types import CommitTransaction, KeyRange
from foundationdb_tpu_torch.ops import conflict_kernel as ck
from foundationdb_tpu_torch.ops import fixpoint_cuda as fc
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine

torch.set_num_threads(1)

CONFIGS = (
    ck.KernelConfig(key_words=2, capacity=512, max_txns=32, max_point_reads=128,
                    max_point_writes=128, max_reads=32, max_writes=32),
    ck.KernelConfig(key_words=4, capacity=4096, max_txns=256, max_point_reads=512,
                    max_point_writes=512, max_reads=64, max_writes=96),
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def synth_batch(rng, cfg, now_rel):
    """Every row class filled, rows grouped by ascending txn."""
    T = cfg.max_txns
    ntx = rng.randrange(2, T + 1)
    rows = {k: [] for k in ("rpk", "rps", "rpt", "rb", "re", "rs", "rt",
                            "wpk", "wpt", "wb", "we", "wt")}

    def key():
        return b"%03d" % rng.randrange(120)

    for t in range(ntx):
        snap = now_rel - rng.randrange(1, 40)
        for _ in range(rng.randrange(0, 4)):
            if len(rows["rpk"]) < cfg.rp:
                rows["rpk"].append(key()); rows["rps"].append(snap); rows["rpt"].append(t)
        if rng.random() < 0.4 and len(rows["rb"]) < cfg.max_reads:
            a, b = sorted([key(), key()])
            rows["rb"].append(a); rows["re"].append(b + b"\x00")
            rows["rs"].append(snap); rows["rt"].append(t)
        for _ in range(rng.randrange(0, 3)):
            if len(rows["wpk"]) < cfg.wp:
                rows["wpk"].append(key()); rows["wpt"].append(t)
        if rng.random() < 0.3 and len(rows["wb"]) < cfg.max_writes:
            a, b = sorted([key(), key()])
            rows["wb"].append(a); rows["we"].append(b + b"\x00"); rows["wt"].append(t)
    t_ok = np.zeros((T,), bool)
    t_ok[:ntx] = True
    for t in rng.sample(range(ntx), k=min(3, ntx)):
        if rng.random() < 0.3:
            t_ok[t] = False
    return ck.build_batch_arrays(
        cfg, rows["rpk"], rows["rps"], rows["rpt"], rows["rb"], rows["re"], rows["rs"],
        rows["rt"], rows["wpk"], rows["wpt"], rows["wb"], rows["we"], rows["wt"],
        t_ok, np.zeros((T,), bool), now_rel, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CONFIGS, ids=["small", "medium"])
def test_kernel_matches_plain(card, cfg):
    """Kernel on the card vs plain version on the CPU, same local_phases
    outputs, on an evolving table."""
    rng = random.Random(17)
    state = ck.initial_state(cfg)
    fc.FIXPOINT.reset_counts()
    n = 24
    for trial in range(n):
        batch = ck.batch_from_numpy(cfg, synth_batch(rng, cfg, 100 + trial), "cpu")
        hist, edges, _ = ck.local_phases(cfg, state, batch)
        want = fc.commit_fixpoint(cfg, batch["t_ok"], hist, edges, batch)
        dbatch = {k: (v.to(card) if isinstance(v, torch.Tensor) else v) for k, v in batch.items()}
        dedges = {k: v.to(card) for k, v in edges.items()}
        got = fc.commit_fixpoint(cfg, dbatch["t_ok"], hist.to(card), dedges, dbatch)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), trial
        assert 1 <= int(fc.FIXPOINT.last_rounds.item()) <= cfg.max_txns + 1
        state, _ = ck.resolve_step(cfg, state, batch)
    assert fc.FIXPOINT.launches == n and fc.FIXPOINT.plain_cuda_calls == 0


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(card):
    cfg = CONFIGS[0]
    batch = ck.batch_from_numpy(cfg, synth_batch(random.Random(3), cfg, 100), card)
    state = ck.initial_state(cfg, device=card)
    hist, edges, _ = ck.local_phases(cfg, state, batch)
    with pytest.raises(ValueError):
        fc.commit_fixpoint_kernel(cfg, batch["t_ok"], hist.to(torch.int64), edges, batch)
    with pytest.raises(ValueError):
        fc.commit_fixpoint_kernel(cfg, batch["t_ok"], hist, dict(edges, ovw=edges["ovw"].t()), batch)
    odd = ck.KernelConfig(key_words=2, capacity=512, max_txns=40, max_reads=32, max_writes=32)
    with pytest.raises(ValueError):
        fc.commit_fixpoint(odd, batch["t_ok"], hist, edges, batch)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(card):
    """resolve() on the card (the default device) vs the CPU engine, long
    keys included, and the kernel carries the card's path."""
    cfg = CONFIGS[1]
    rng = random.Random(5)
    gpu, cpu = TorchConflictEngine(cfg), TorchConflictEngine(cfg, device="cpu")
    assert gpu.device.type == "cuda"
    fc.FIXPOINT.reset_counts()
    now = 100
    for b in range(12):
        now += rng.randrange(10, 60)
        txns = []
        for _ in range(rng.randrange(1, 300)):
            t = CommitTransaction(read_snapshot=max(0, now - rng.randrange(1, 80)))
            for _ in range(rng.randrange(0, 3)):
                k = b"k%04d" % rng.randrange(400)
                if b % 4 == 3 and rng.random() < 0.1:
                    k = b"L/" + k + b"x" * 40
                t.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            for _ in range(rng.randrange(0, 3)):
                k = b"k%04d" % rng.randrange(400)
                t.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            txns.append(t)
        oldest = max(0, now - 100)
        assert [int(v) for v in gpu.resolve(txns, now, oldest)] == \
            [int(v) for v in cpu.resolve(txns, now, oldest)], b
    assert fc.FIXPOINT.launches > 0 and fc.FIXPOINT.plain_cuda_calls == 0
