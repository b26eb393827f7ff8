"""The port's chunk scan and the programs' static inputs on the CPU.

  * conflict_kernel.resolve_step_scan over a leading [C] axis equals C
    serial resolve_steps and JAX's resolve_step_scan on the same stacked
    batches (status [C, T], overflow [C], the whole table after), with gc on
    the last chunk;
  * the GC branch is a required host argument of every step function;
  * a program's static inputs (a tensor per batch field, keys as the int32
    bits of their words) round trip every field of build_batch_arrays'
    batch into the step's tensors, from a batch dict and from a pack set.

Every comparison is exact.
"""
import dataclasses
import inspect
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict_kernel as jck
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops import host_engine as the

torch.set_num_threads(1)

SMALL = jck.KernelConfig(key_words=2, capacity=512, max_txns=32,
                         max_point_reads=128, max_point_writes=128,
                         max_reads=32, max_writes=32)


def port_cfg(cfg):
    fields = dataclasses.asdict(cfg)
    fields.pop("fixpoint")
    return tck.KernelConfig(**fields)


def synth_batch(rng, cfg, now_rel, gc_rel):
    """Every row class filled (point and range reads and writes, empty
    reads), snapshots trailing `now` so reads hit history."""
    T = cfg.max_txns
    ntx = rng.randrange(2, T + 1)
    rows = {k: [] for k in ("rpk", "rps", "rpt", "rb", "re", "rs", "rt",
                            "wpk", "wpt", "wb", "we", "wt")}

    def key():
        return b"%02d" % rng.randrange(24)

    for t in range(ntx):
        snap = now_rel - rng.randrange(1, 40)
        for _ in range(rng.randrange(0, 4)):
            if len(rows["rpk"]) < cfg.rp:
                rows["rpk"].append(key()); rows["rps"].append(snap); rows["rpt"].append(t)
        if rng.random() < 0.4 and len(rows["rb"]) < cfg.max_reads:
            a, b = sorted([key(), key()])
            rows["rb"].append(a); rows["re"].append(a if rng.random() < 0.2 else b + b"\x00")
            rows["rs"].append(snap); rows["rt"].append(t)
        for _ in range(rng.randrange(0, 3)):
            if len(rows["wpk"]) < cfg.wp:
                rows["wpk"].append(key()); rows["wpt"].append(t)
        if rng.random() < 0.3 and len(rows["wb"]) < cfg.max_writes:
            a, b = sorted([key(), key()])
            rows["wb"].append(a); rows["we"].append(b + b"\x00"); rows["wt"].append(t)
    t_ok = np.zeros((T,), bool)
    t_ok[:ntx] = True
    t_old = np.zeros((T,), bool)
    for t in rng.sample(range(ntx), k=min(3, ntx)):
        if rng.random() < 0.3:
            t_ok[t], t_old[t] = False, True
    return jck.build_batch_arrays(
        cfg, rows["rpk"], rows["rps"], rows["rpt"], rows["rb"], rows["re"], rows["rs"],
        rows["rt"], rows["wpk"], rows["wpt"], rows["wb"], rows["we"], rows["wt"],
        t_ok, t_old, now_rel=now_rel, gc_rel=gc_rel)


def stacked_chunks(seed, C, gc_last):
    """C batches of one dispatch unit at increasing `now`; only the last
    may carry a GC horizon."""
    rng = random.Random(seed)
    out, now = [], 100
    for c in range(C):
        now += rng.randrange(5, 20)
        gc = now - 45 if (gc_last and c == C - 1) else 0
        out.append(synth_batch(rng, SMALL, now, gc))
    return out


def stack_np(batches):
    return {k: np.stack([np.asarray(b[k]) for b in batches]) for k in batches[0]}


def warm_table():
    """A table with history: a few JAX steps; (JAX state, numpy state)."""
    rng = random.Random(77)
    jstate = jck.initial_state(SMALL)
    step = jax.jit(lambda s, b: jck.resolve_step(SMALL, s, b))
    for i in range(4):
        b = synth_batch(rng, SMALL, 40 + 10 * i, 0)
        jstate, _ = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    np_state = {k: np.asarray(v) for k, v in jstate.items()}
    return jstate, np_state


def eq(a, b):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.astype(np.int64), b.astype(np.int64))


_SCAN = {}


def jax_scan(C):
    if C not in _SCAN:
        _SCAN[C] = jax.jit(lambda s, b: jck.resolve_step_scan(SMALL, s, b))
    return _SCAN[C]


@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("gc_last", [False, True])
def test_scan_equals_serial_steps_and_jax(C, gc_last):
    tcfg = port_cfg(SMALL)
    jstate, np_state = warm_table()
    chunks = stacked_chunks(10 * C + gc_last, C, gc_last)
    stacked = stack_np(chunks)
    jnew, jout = jax_scan(C)(jstate, {k: jnp.asarray(v) for k, v in stacked.items()})

    dev = {k: tck.batch_from_numpy(tcfg, b, "cpu") for k, b in enumerate(chunks)}
    tb = {k: torch.stack([dev[c][k] for c in range(C)]) for k in dev[0]}
    tnew, tout = tck.resolve_step_scan(tcfg, tck.state_from_numpy(tcfg, np_state, "cpu"),
                                       tb, gc_last)
    assert tout["status"].shape == (C, tcfg.max_txns)
    assert eq(tout["status"], jout["status"]) and eq(tout["overflow"], jout["overflow"])
    for k in ("hkeys", "hvers", "n"):
        assert eq(tnew[k], jnew[k]), k
    # C serial resolve_steps on the port
    state = tck.state_from_numpy(tcfg, np_state, "cpu")
    for c in range(C):
        state, out = tck.resolve_step(tcfg, state, dev[c], gc_last and c == C - 1)
        assert eq(out["status"], jout["status"][c]), c
    for k in ("hkeys", "hvers", "n"):
        assert eq(state[k], tnew[k]), k
    if gc_last:
        assert int(stacked["gc"][-1]) > 0


@pytest.mark.parametrize("fn, arg", [("apply_writes_and_gc", "gc_branch"),
                                     ("apply_step", "gc_branch"),
                                     ("resolve_step", "gc_branch"),
                                     ("resolve_step_scan", "gc_last")])
def test_the_gc_branch_is_a_required_host_argument(fn, arg):
    """The step never chooses the GC branch by reading `gc` (a device sync
    on the card): every caller must say it."""
    param = inspect.signature(getattr(tck, fn)).parameters[arg]
    assert param.default is inspect.Parameter.empty


#: the test config, a ladder bucket of a larger one, and a config whose
#: groups all differ in size
BUCKETS = [port_cfg(SMALL),
           tck.KernelConfig(key_words=2, capacity=2048, max_txns=128, max_reads=32,
                            max_writes=32, max_point_reads=256,
                            max_point_writes=256).bucket(64),
           tck.KernelConfig(key_words=4, capacity=1024, max_txns=96, max_reads=40,
                            max_writes=24, max_point_reads=200, max_point_writes=72)]


@pytest.mark.parametrize("which", range(len(BUCKETS)))
def test_program_inputs_round_trip_every_field(which):
    tcfg = BUCKETS[which]
    shapes = the.input_shapes(tcfg)
    assert set(shapes) == set(tck.batch_shapes(tcfg))
    assert set(shapes) == set(the.HOT_FIELDS + the.COLD_FIELDS)
    eng = the.TorchConflictEngine(tcfg, device="cpu")
    prog = eng._program(tcfg, 3)
    rng = random.Random(which)
    batches = []
    for i in range(3):
        if which == 0:
            batches.append(synth_batch(rng, SMALL, 50 + i, i))
        else:
            batches.append(random_arrays(np.random.default_rng(which * 10 + i), tcfg))
    for c, arrays in enumerate(batches):
        prog.load(c, arrays, None)
    assert prog.cold_dirty == [True] * 3
    for c, arrays in enumerate(batches):
        want = tck.batch_from_numpy(tcfg, arrays, "cpu")
        for k, w in prog.batches().items():
            g = w[c]
            assert g.dtype == want[k].dtype and torch.equal(g, want[k]), (c, k)
    # a pack set carries the hot fields alone: the range rows a batch dict
    # left in the slot are zeroed on the way
    pack = the.PackSet(tcfg)
    assert set(pack.tensors) == set(the.HOT_FIELDS)
    for k, view in pack.arrays.items():
        view[...] = batches[2][k]
    prog.load(1, {}, pack)
    assert prog.cold_dirty == [True, False, True]
    want = tck.batch_from_numpy(tcfg, batches[2], "cpu")
    got = prog.batches()
    for k in the.HOT_FIELDS:
        assert torch.equal(got[k][1], want[k]), k
    for k in the.COLD_FIELDS:
        assert not got[k][1].any() and torch.equal(got[k][0], tck.batch_from_numpy(
            tcfg, batches[0], "cpu")[k]), k


def random_arrays(rng, tcfg):
    """Arbitrary bits in every field, all-ones key words included."""
    out = {}
    for name, (shape, dtype) in tck.batch_shapes(tcfg).items():
        if dtype == torch.int64:
            out[name] = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
        elif dtype == torch.bool:
            out[name] = rng.random(size=shape) < 0.5
        else:
            out[name] = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    return out
