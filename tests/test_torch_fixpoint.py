"""The port's commit fixpoint: its plain version against the JAX package's
two fixpoints, and the CUDA kernel against the plain version on the card.

The plain version (foundationdb_tpu_torch.ops.conflict_kernel
.commit_fixpoint) must equal both the XLA-form commit_fixpoint and the
Pallas kernel (run on its interpreter, as tests/test_fixpoint_pallas.py
runs it) bit for bit, on batches whose range groups are filled so every
term of the kernel runs. The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict_kernel as jck
from foundationdb_tpu.ops import fixpoint_pallas as fp
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops import fixpoint_cuda as fc
from test_torch_cuda import CONFIGS, DENSE, RAGGED, WIDE, chain_rows, dense_rows, fixpoint_rounds

torch.set_num_threads(1)

CFG = jck.KernelConfig(key_words=2, capacity=512, max_txns=32,
                       max_point_reads=128, max_point_writes=128,
                       max_reads=32, max_writes=32)


def port_cfg(cfg):
    fields = dataclasses.asdict(cfg)
    fields.pop("fixpoint")
    return tck.KernelConfig(**fields)


TCFG = port_cfg(CFG)


def synth_batch(rng, cfg, now_rel):
    """tests/test_fixpoint_pallas.py:36, with the range groups always
    non-empty (at least one range read and one range write)."""
    T = cfg.max_txns
    ntx = rng.randrange(2, T + 1)
    rp_keys, rp_snap, rp_txn = [], [], []
    r_b, r_e, r_s, r_t = [], [], [], []
    wp_keys, wp_txn = [], []
    w_b, w_e, w_t = [], [], []
    for t in range(ntx):
        for _ in range(rng.randrange(0, 4)):
            k = b"%02d" % rng.randrange(24)
            rp_keys.append(k); rp_snap.append(rng.randrange(0, 50)); rp_txn.append(t)
        if rng.random() < 0.4 or t == ntx - 1:
            a, b = sorted([b"%02d" % rng.randrange(24), b"%02d" % rng.randrange(24)])
            r_b.append(a); r_e.append(b + b"\x00")
            r_s.append(rng.randrange(0, 50)); r_t.append(t)
        for _ in range(rng.randrange(0, 3)):
            k = b"%02d" % rng.randrange(24)
            wp_keys.append(k); wp_txn.append(t)
        if rng.random() < 0.3 or t == 0:
            a, b = sorted([b"%02d" % rng.randrange(24), b"%02d" % rng.randrange(24)])
            w_b.append(a); w_e.append(b + b"\x00"); w_t.append(t)
    t_ok = np.zeros((T,), bool)
    t_ok[:ntx] = True
    for t in rng.sample(range(ntx), k=min(3, ntx)):
        if rng.random() < 0.3:
            t_ok[t] = False
    t_old = np.zeros((T,), bool)
    return jck.build_batch_arrays(cfg, rp_keys, rp_snap, rp_txn, r_b, r_e, r_s, r_t,
                                  wp_keys, wp_txn, w_b, w_e, w_t, t_ok, t_old,
                                  now_rel=now_rel, gc_rel=0)


def seeded_batches(n=24, seed=3):
    """(JAX batch, port batch, JAX phases, port phases) on an evolving table."""
    rng = random.Random(seed)
    local = jax.jit(lambda s, b: jck.local_phases(CFG, s, b))
    step = jax.jit(lambda s, b: jck.resolve_step(CFG, s, b))
    state = jck.initial_state(CFG)
    out = []
    for trial in range(n):
        arrays = synth_batch(rng, CFG, 100 + trial)
        jb = {k: jnp.asarray(v) for k, v in arrays.items()}
        tb = tck.batch_from_numpy(TCFG, arrays, "cpu")
        tstate = tck.state_from_numpy(TCFG, {k: np.asarray(v) for k, v in state.items()}, "cpu")
        out.append((jb, tb, local(state, jb), tck.local_phases(TCFG, tstate, tb)))
        state, _ = step(state, jb)
    return out


def test_plain_fixpoint_matches_xla_and_pallas_interpret():
    xla = jax.jit(lambda t, h, e, b: jck.commit_fixpoint(CFG, t, h, e, b))
    pallas = jax.jit(lambda t, h, e, b: fp.commit_fixpoint_pallas(CFG, t, h, e, b,
                                                                  interpret=True))
    mixed = 0
    for trial, (jb, tb, (jh, je, _), (th, te, _)) in enumerate(seeded_batches()):
        assert bool(jb["r_valid"][0]) and bool(jb["w_valid"][0])
        want = np.asarray(xla(jb["t_ok"], jh, je, jb))
        assert np.array_equal(np.asarray(pallas(jb["t_ok"], jh, je, jb)), want), trial
        got = fc.commit_fixpoint(TCFG, tb["t_ok"], th, te, tb)
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), want), trial
        ok = np.asarray(jb["t_ok"])
        mixed += bool(np.any(want)) and bool(np.any(ok & ~want))
    assert fc.FIXPOINT.launches == 0
    assert mixed >= 10          # batches with both commits and aborts


def test_supported_agrees_with_pallas():
    for cfg in (CFG, jck.KernelConfig(), jck.KernelConfig(max_txns=48),
                jck.KernelConfig(capacity=2**30), dataclasses.replace(CFG, max_txns=40)):
        assert fc.supported(port_cfg(cfg)) == fp.supported(cfg), cfg


def test_kernel_refuses_cpu_tensors_and_unsupported_configs():
    """The kernel wrapper never falls back: CPU tensors are the dispatcher's
    business (plain version), and a CUDA request it cannot serve raises."""
    jb, tb, _, (th, te, _) = seeded_batches(n=1)[0]
    with pytest.raises(ValueError):
        fc.commit_fixpoint_kernel(TCFG, tb["t_ok"], th, te, tb)
    odd = dataclasses.replace(TCFG, max_txns=40)
    with pytest.raises(ValueError):
        fc.commit_fixpoint_kernel(odd, tb["t_ok"], th, te, tb)
    assert fc.FIXPOINT.launches == 0


BENCH = tck.KernelConfig(key_words=4, capacity=24576, max_point_reads=8192,
                         max_point_writes=8192, max_reads=256, max_writes=256, max_txns=4096)


@pytest.mark.parametrize("cfg", [TCFG, CONFIGS[1], RAGGED, WIDE, DENSE, BENCH, tck.KernelConfig()],
                         ids=["small", "medium", "ragged", "wide", "dense", "bench", "engine"])
def test_launch_plan(cfg):
    """The kernel's launch plan, computed without a card: a cluster of more
    than one CTA whose slices (multiples of 32 rows) cover every read row
    exactly once, shared memory within a CTA's 227 KB, and lists that hold
    the worst case (every point row valid, every edge word nonzero) between
    shared memory and the global spill."""
    plan = fc.launch_plan(cfg)
    nc = plan["cluster"]
    assert 1 < nc <= 16 and len(plan["slices"]) == nc
    rows = [g for g0, g1 in plan["slices"] for g in range(g0, g1)]
    assert rows == list(range(cfg.r_all))
    assert all(g0 % 32 == 0 for g0, g1 in plan["slices"] if g1 > g0)
    assert plan["rows_per_cta"] % 32 == 0
    assert plan["smem_bytes"] <= fc.SMEM_LIMIT == 232448
    for g0, g1 in plan["slices"]:
        points = max(0, min(g1, cfg.rp) - g0)
        words = (g1 - g0) * cfg.wr_words + max(0, g1 - max(g0, cfg.rp)) * cfg.wp_words
        assert plan["point_cap"] + plan["point_spill_cap"] >= points
        assert plan["entry_cap"] + plan["entry_spill_cap"] >= words
    assert plan["entry_scratch_bytes"] == nc * plan["entry_spill_cap"] * fc.ENTRY_BYTES
    assert plan["point_scratch_bytes"] == nc * plan["point_spill_cap"] * fc.POINT_BYTES
    assert plan["writers_per_cta"] * nc >= cfg.wp
    assert plan["gid_table"] == "global"
    assert plan["gid_table_bytes"] == 8 * (cfg.gid_space + 2)
    assert fc.supported(cfg)


def test_launch_plan_raises_past_a_ctas_shared_memory():
    huge_t = tck.KernelConfig(max_txns=2**21, max_reads=32, max_writes=32)
    with pytest.raises(ValueError):
        fc.launch_plan(huge_t)
    assert not fc.supported(huge_t)


def jax_and_port(arrays):
    """(JAX batch, port batch, JAX phases, port phases) on an empty table."""
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = tck.batch_from_numpy(TCFG, arrays, "cpu")
    jstate = jck.initial_state(CFG)
    tstate = tck.state_from_numpy(TCFG, {k: np.asarray(v) for k, v in jstate.items()}, "cpu")
    return jb, tb, jck.local_phases(CFG, jstate, jb), tck.local_phases(TCFG, tstate, tb)


@pytest.mark.parametrize("case", ["chain_point", "chain_range", "dense"])
def test_worst_cases_plain_matches_xla_and_pallas_interpret(case):
    """The deep chains and the all-dense batch of the card tests, at the
    small width: the port's plain fixpoint equals the JAX package's XLA
    fixpoint and its Pallas kernel (interpret mode) bit for bit, and the
    chain takes one round per link plus one."""
    T = CFG.max_txns
    if case == "dense":
        arrays = dense_rows(jck.build_batch_arrays, CFG, T)
    else:
        arrays = chain_rows(jck.build_batch_arrays, CFG, T, case.split("_")[1])
    jb, tb, (jh, je, _), (th, te, _) = jax_and_port(arrays)
    want = np.asarray(jck.commit_fixpoint(CFG, jb["t_ok"], jh, je, jb))
    pallas = np.asarray(fp.commit_fixpoint_pallas(CFG, jb["t_ok"], jh, je, jb, interpret=True))
    got = fc.commit_fixpoint(TCFG, tb["t_ok"], th, te, tb).numpy()
    assert np.array_equal(pallas, want) and np.array_equal(got, want)
    rounds = fixpoint_rounds(TCFG, tb["t_ok"], th, te, tb)
    if case == "dense":
        assert rounds == 2 and got[0] and not got[1:T].any()
    else:
        assert rounds == T and np.array_equal(got, np.arange(T) % 2 == 0)
