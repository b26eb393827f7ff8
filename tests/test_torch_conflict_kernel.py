"""The port's conflict step against the JAX package's, phase by phase.

For the same packed batch and interval table, every function of
foundationdb_tpu_torch.ops.conflict_kernel must return what
foundationdb_tpu.ops.conflict_kernel returns, element for element, padding
rows included (tolerance 0: every quantity is an integer). JAX runs on the
CPU with x64 on (tests/conftest.py), so its integer outputs may come back
int64 where the port holds int32, and its key words are uint32 where the
port holds zero-extended int64: comparisons are on values.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict_kernel as jck
from foundationdb_tpu_torch.core import error as terror
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops import keypack as tkeypack

torch.set_num_threads(1)

SMALL = jck.KernelConfig(key_words=2, capacity=512, max_txns=32,
                         max_point_reads=128, max_point_writes=128,
                         max_reads=32, max_writes=32)
MEDIUM = jck.KernelConfig(key_words=4, capacity=2048, max_txns=64,
                          max_point_reads=256, max_point_writes=256,
                          max_reads=64, max_writes=64)
MODES = ("fused_sort", "bsearch")


def port_cfg(cfg):
    """The port's KernelConfig of a JAX-built one (all fields but the
    fixpoint switch, which the port replaces by device dispatch)."""
    fields = dataclasses.asdict(cfg)
    fields.pop("fixpoint")
    return tck.KernelConfig(**fields)


def jit_fns(cfg):
    return {
        "local": jax.jit(lambda s, b: jck.local_phases(cfg, s, b)),
        "fix": jax.jit(lambda t, h, e, b: jck.commit_fixpoint(cfg, t, h, e, b)),
        "apply": jax.jit(lambda s, b, c, w: jck.apply_writes_and_gc(cfg, s, b, c, w)),
        "step": jax.jit(lambda s, b: jck.resolve_step(cfg, s, b)),
    }


_JIT = {}


def fns(cfg):
    if cfg not in _JIT:
        _JIT[cfg] = jit_fns(cfg)
    return _JIT[cfg]


def key(rng, n_keys, width):
    return (b"%0*d" % (width, rng.randrange(n_keys)))[:width]


def synth_batch(rng, cfg, now_rel, gc_rel, n_keys=24, width=2, empty_reads=True):
    """A packed batch with every row class filled: point reads/writes, range
    reads (some empty), range writes (range clears); snapshots trail `now`
    so history hits occur. Modelled on tests/test_fixpoint_pallas.py:36."""
    T = cfg.max_txns
    ntx = rng.randrange(2, T + 1)
    rp_keys, rp_snap, rp_txn = [], [], []
    r_b, r_e, r_s, r_t = [], [], [], []
    wp_keys, wp_txn = [], []
    w_b, w_e, w_t = [], [], []
    for t in range(ntx):
        snap = now_rel - rng.randrange(1, 40)
        for _ in range(rng.randrange(0, 4)):
            if len(rp_keys) < cfg.rp:
                rp_keys.append(key(rng, n_keys, width)); rp_snap.append(snap); rp_txn.append(t)
        if rng.random() < 0.4 and len(r_b) < cfg.max_reads:
            a, b = sorted([key(rng, n_keys, width), key(rng, n_keys, width)])
            if empty_reads and rng.random() < 0.2:
                b = a                                      # empty read [a, a)
            else:
                b = b + b"\x00"
            r_b.append(a); r_e.append(b); r_s.append(snap); r_t.append(t)
        for _ in range(rng.randrange(0, 3)):
            if len(wp_keys) < cfg.wp:
                wp_keys.append(key(rng, n_keys, width)); wp_txn.append(t)
        if rng.random() < 0.3 and len(w_b) < cfg.max_writes:
            a, b = sorted([key(rng, n_keys, width), key(rng, n_keys, width)])
            w_b.append(a); w_e.append(b + b"\x00"); w_t.append(t)
    t_ok = np.zeros((T,), bool)
    t_ok[:ntx] = True
    for t in rng.sample(range(ntx), k=min(3, ntx)):
        if rng.random() < 0.3:
            t_ok[t] = False
    t_old = np.zeros((T,), bool)
    t_old[:ntx] = ~t_ok[:ntx]
    return jck.build_batch_arrays(cfg, rp_keys, rp_snap, rp_txn, r_b, r_e, r_s, r_t,
                                  wp_keys, wp_txn, w_b, w_e, w_t, t_ok, t_old,
                                  now_rel=now_rel, gc_rel=gc_rel)


def to_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def np_state(jstate):
    return {k: np.asarray(v) for k, v in jstate.items()}


def eq(a, b):
    """Values equal, element for element (port tensor or array vs JAX)."""
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.astype(np.int64), b.astype(np.int64))


def bits_eq(port_words, jax_words):
    """Port int32 bit words vs JAX uint32 bit words: the same 32 bits."""
    return eq(port_words, np.asarray(jax_words).astype(np.uint32).view(np.int32))


def check_local(cfg, tcfg, jstate, batch_np):
    jb = to_jax(batch_np)
    jh, je, jw = fns(cfg)["local"](jstate, jb)
    tstate = tck.state_from_numpy(tcfg, np_state(jstate), "cpu")
    tb = tck.batch_from_numpy(tcfg, batch_np, "cpu")
    th, te, tw = tck.local_phases(tcfg, tstate, tb)
    assert th.dtype == torch.int32 and te["ovw"].dtype == torch.int32
    assert eq(th, jh), "hist_hits"
    assert bits_eq(te["ovw"], je["ovw"]), "ovw"
    assert bits_eq(te["ovrp"], je["ovrp"]), "ovrp"
    assert eq(te["gid_rp"], je["gid_rp"]), "gid_rp"
    assert eq(te["gid_wp"], je["gid_wp"]), "gid_wp"
    for k in ("lo_b", "lo_e", "up_e"):
        assert eq(tw[k], jw[k]), k
    return (jb, jh, je, jw), (tstate, tb, th, te, tw)


def check_state(tstate, jstate):
    assert eq(tstate["hkeys"], jstate["hkeys"]), "hkeys"
    assert eq(tstate["hvers"], jstate["hvers"]), "hvers"
    assert int(tstate["n"]) == int(jstate["n"]), "n"


@pytest.mark.parametrize("mode", MODES)
def test_phases_match_jax_on_a_stream(mode):
    """local_phases, commit_fixpoint and apply_writes_and_gc (gc == 0 and
    gc > 0 batches interleaved) on one evolving table, batch by batch."""
    cfg = dataclasses.replace(SMALL, history_search=mode)
    tcfg = port_cfg(cfg)
    assert tck.resolved_history_search(tcfg) == mode
    rng = random.Random(5 if mode == "bsearch" else 4)
    jstate = jck.initial_state(cfg)
    now = 100
    saw_hit = saw_gc = saw_abort = False
    for trial in range(14):
        now += rng.randrange(5, 20)
        gc = now - rng.randrange(30, 60) if trial % 3 == 2 else 0
        batch_np = synth_batch(rng, cfg, now, gc)
        (jb, jh, je, jw), (tstate, tb, th, te, tw) = check_local(cfg, tcfg, jstate, batch_np)
        jc = fns(cfg)["fix"](jb["t_ok"], jh, je, jb)
        tc = tck.commit_fixpoint(tcfg, tb["t_ok"], th, te, tb)
        assert eq(tc, jc), ("committed", trial)
        jns, jov, jrec = fns(cfg)["apply"](jstate, jb, jc, jw)
        tns, tov, trec = tck.apply_writes_and_gc(tcfg, tstate, tb, tc, tw, gc > 0)
        check_state(tns, jns)
        assert bool(tov) == bool(jov) and int(trec) == int(jrec)
        saw_hit |= bool(np.any(np.asarray(jh) > 0))
        saw_gc |= gc > 0 and int(jrec) > 0
        saw_abort |= bool(np.any(batch_np["t_ok"] & ~np.asarray(jc)))
        jstate = jns
        if gc > 0:
            now -= gc      # versions rebase onto the new horizon
    assert saw_hit and saw_gc and saw_abort


@pytest.mark.parametrize("mode", MODES)
def test_resolve_step_stream_matches_jax(mode):
    """resolve_step over a stream at a medium shape, 16-byte keys: status,
    overflow, n and the whole table after every batch."""
    cfg = dataclasses.replace(MEDIUM, history_search=mode)
    tcfg = port_cfg(cfg)
    rng = random.Random(11)
    jstate = jck.initial_state(cfg)
    tstate = tck.initial_state(tcfg)
    now = 50
    for trial in range(8):
        now += rng.randrange(5, 20)
        gc = now - 45 if trial % 2 else 0
        batch_np = synth_batch(rng, cfg, now, gc, n_keys=200, width=16)
        jstate, jout = fns(cfg)["step"](jstate, to_jax(batch_np))
        tstate, tout = tck.resolve_step(tcfg, tstate, tck.batch_from_numpy(tcfg, batch_np, "cpu"),
                                       gc > 0)
        assert tout["status"].dtype == torch.int32
        assert eq(tout["status"], jout["status"]), trial
        assert bool(tout["overflow"]) == bool(jout["overflow"])
        assert int(tout["n"]) == int(jout["n"])
        check_state(tstate, jstate)
        if gc > 0:
            now -= gc


def full_table(cfg, rng):
    """A table with every one of the H rows valid (n == H): sorted unique
    keys over the 2-word window, row 0 the minimal key b''."""
    H, K = cfg.capacity, cfg.lanes
    keys = sorted({key(rng, 10**8, 8) for _ in range(4 * H)})[:H - 1]
    hkeys = np.zeros((H, K), np.uint32)
    hkeys[1:] = jck.keypack.pack_keys(keys, cfg.key_words)
    hvers = np.asarray([rng.randrange(-1, 60) for _ in range(H)], np.int32)
    return {"hkeys": hkeys, "hvers": hvers, "n": np.int32(H)}


@pytest.mark.parametrize("mode", MODES)
def test_full_table_clamp_sites(mode):
    """n == H: lower bounds of keys past the last row land at H, so the
    _present / eq_wpb2 / lower-bound gathers read row H — JAX clamps it to
    H-1 and so must the port. The apply then overflows, and the dropped
    scatters must leave the same table."""
    cfg = dataclasses.replace(SMALL, history_search=mode)
    tcfg = port_cfg(cfg)
    rng = random.Random(23)
    st = full_table(cfg, rng)
    jstate = {k: jnp.asarray(v) for k, v in st.items()}
    batch_np = synth_batch(rng, cfg, 100, 0, n_keys=10**8, width=8)
    # txn 0 reads and writes a key past every table key (all-0xff bytes
    # sort last) and commits: its write needs rows the full table lacks
    for g in ("rp", "wp"):
        batch_np[g + "b"][0] = jck.keypack.pack_key(b"\xff" * 8, cfg.key_words)
        batch_np[g + "_txn"][0] = 0
        batch_np[g + "_valid"][0] = True
    batch_np["rp_snap"][0] = 10**6
    batch_np["t_ok"][0], batch_np["t_too_old"][0] = True, False
    batch_np["w_valid"][:] = False     # no range clear may shrink the table
    (jb, jh, je, jw), (tstate, tb, th, te, tw) = check_local(cfg, tcfg, jstate, batch_np)
    assert int(np.asarray(jw["lo_b"])[0]) == cfg.capacity
    jc = fns(cfg)["fix"](jb["t_ok"], jh, je, jb)
    tc = tck.commit_fixpoint(tcfg, tb["t_ok"], th, te, tb)
    assert eq(tc, jc)
    jns, jov, _ = fns(cfg)["apply"](jstate, jb, jc, jw)
    tns, tov, _ = tck.apply_writes_and_gc(tcfg, tstate, tb, tc, tw, False)
    assert bool(jov) and bool(tov)
    check_state(tns, jns)


def test_bucket_arithmetic_and_properties():
    for cfg in (SMALL, MEDIUM, jck.KernelConfig(), jck.KernelConfig(max_point_reads=100)):
        tcfg = port_cfg(cfg)
        for prop in ("lanes", "rp", "wp", "r_all", "w_all", "wr_words", "wp_words",
                     "batch_rows", "gid_space", "levels", "run_slots", "run_rows",
                     "run_levels"):
            assert getattr(tcfg, prop) == getattr(cfg, prop), prop
        assert tck.pick_history_search(tcfg) == jck.pick_history_search(cfg)
        for t in range(32, cfg.max_txns, 32):
            jb, tb = cfg.bucket(t), tcfg.bucket(t)
            assert tb == port_cfg(jb), t
        assert tcfg.bucket(cfg.max_txns) is tcfg
        for bad in (0, 31, cfg.max_txns + 32):
            with pytest.raises(ValueError):
                tcfg.bucket(bad)


def test_unported_options_raise():
    with pytest.raises(ValueError):
        tck.resolved_history_structure(port_cfg(dataclasses.replace(SMALL, history_structure="lsm")))
    with pytest.raises(ValueError):
        tck.resolved_history_search(port_cfg(dataclasses.replace(SMALL, history_search="nope")))
    # heat is ported: local_phases adds its witness context
    heat = port_cfg(dataclasses.replace(SMALL, heat_buckets=8))
    _, edges, _ = tck.local_phases(heat, tck.initial_state(heat), tck.batch_from_numpy(
        heat, synth_batch(random.Random(1), SMALL, 10, 0), "cpu"))
    assert {"heat_hhit_p", "heat_hver_p", "heat_hhit_r", "heat_hver_r"} <= edges.keys()


def test_state_and_batch_round_trip():
    """initial_state, state_to/from_numpy and build_batch_arrays agree with
    the JAX package's arrays; the shape tables match state/batch_struct."""
    tcfg = port_cfg(MEDIUM)
    js = np_state(jck.initial_state(MEDIUM, version_rel=7, first_key=b"k"))
    ts = tck.initial_state(tcfg, version_rel=7, first_key=b"k")
    for k in js:
        assert eq(ts[k], js[k]), k
    back = tck.state_to_numpy(ts)
    assert back["hkeys"].dtype == np.uint32 and np.array_equal(back["hkeys"], js["hkeys"])
    for k in (b"", b"k", b"\x00\xff" * 8, b"abcdefghijklmnop"):
        packed = tkeypack.pack_key(k, MEDIUM.key_words)
        assert np.array_equal(packed, jck.keypack.pack_key(k, MEDIUM.key_words))
        assert tkeypack.unpack_key(packed, MEDIUM.key_words) == k
    long = [b"x" * 40, b"y"]
    assert np.array_equal(tkeypack.pack_endpoint_keys(long, MEDIUM.key_words),
                          jck.keypack.pack_endpoint_keys(long, MEDIUM.key_words))
    with pytest.raises(terror.FDBError) as e:
        tkeypack.pack_keys([b"z" * 17], MEDIUM.key_words)
    assert e.value.code == 2102          # key_too_large
    for name, struct in jck.state_struct(MEDIUM).items():
        assert tck.state_shapes(tcfg)[name][0] == struct.shape, name
    for name, struct in jck.batch_struct(MEDIUM).items():
        assert tck.batch_shapes(tcfg)[name][0] == struct.shape, name
    args = ([b"a", b"bb"], [3, 4], [0, 1], [b"c", b"\x00" * 20], [b"d", b"\xff" * 20], [5, 6],
            [0, 1], [b"e"], [1], [b"f"], [b"g" * 17], [1],
            np.ones(MEDIUM.max_txns, bool), np.zeros(MEDIUM.max_txns, bool), 9, 2)
    jb = jck.build_batch_arrays(MEDIUM, *args)
    tb = tck.build_batch_arrays(tcfg, *args)
    assert jb.keys() == tb.keys()
    for k in jb:
        assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k]), k
    dev = tck.batch_from_numpy(tcfg, tb, "cpu")
    assert dev["now"] == 9 and dev["gc"] == 2 and dev["rpb"].dtype == torch.int64
    with pytest.raises(ValueError):
        tck.build_batch_arrays(tcfg, [b"a", b"b"], [1, 1], [1, 0], *args[3:])
