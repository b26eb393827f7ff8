"""Shards in several groups (parallel/exchange.py, sharding.placement)
against the JAX package's 8-device mesh, on the CPU.

  * the grouped programs — make_sharded_step, the chunk scan,
    make_mesh_scan_step with make_mesh_exchange_step, and the long-key
    split steps — equal JAX's shard_map programs over 8 virtual devices
    element for element, in the group layouts 8 x 1, 2 x 4 and (3, 5);
  * ShardedConflictEngine and MeshShardedConflictEngine (overlap serial and
    on) with heat on, in those layouts, equal the JAX engines and the
    oracle across a ladder bucket's boundary and GC, and their heat
    snapshots equal the JAX engines'; the one-group engine keeps today's
    programs;
  * a live reshard split whose slots are grouped mesh engines (tiered, so
    the pre-copy reads each shard's runs across groups) holds to the serial
    oracle and to the oracle-slot group;
  * placement: the default groups, `groups=`, what raises, and the cards'
    default device list.

Inputs are made from seeds. Every comparison is exact (integers and bools).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.core.keyshard import KeyShardMap as JKeyShardMap
from foundationdb_tpu.core.rng import DeterministicRandom
from foundationdb_tpu.ops.conflict_kernel import KernelConfig
from foundationdb_tpu.ops.oracle import OracleConflictEngine
from foundationdb_tpu.parallel import mesh_engine as jme
from foundationdb_tpu.parallel import sharding as jsh
from foundationdb_tpu_torch.core.keyshard import KeyShardMap
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops.host_engine import _Program
from foundationdb_tpu_torch.parallel import exchange
from foundationdb_tpu_torch.parallel import mesh_engine as tme
from foundationdb_tpu_torch.parallel import sharding as tsh

from test_torch_conflict_kernel import eq, port_cfg
from test_torch_mesh import point_batch
from test_torch_reshard import oracle_factory, split_then_merge
from test_torch_sharded import SMALL, assert_tree_eq, random_stream, stacked_inputs, to_port
from torch_sim_world import PORT, clean_world

torch.set_num_threads(1)

N = 8
LAYOUTS = {"8x1": list(range(8)), "2x4": [0] * 4 + [1] * 4, "3+5": [0] * 3 + [1] * 5}
DEVS = ["cpu"] * N


def groups_of(layout):
    return tsh.placement(DEVS, LAYOUTS[layout])


def split(tree, layout):
    """An [N, ...] tree as one [n_g, ...] tree per group."""
    return [{k: v[g.lo:g.hi] for k, v in tree.items()} for g in groups_of(layout)]


def join(parts):
    return exchange.join(parts, "cpu")


def jtree(np_tree):
    return {k: jnp.asarray(v) for k, v in np_tree.items()}


def jmesh():
    return jax.make_mesh((N,), ("shard",), devices=jax.devices()[:N])


# ---------------------------------------------------------------------------
# the grouped programs against JAX's shard_map programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_grouped_step_and_mesh_pair_equal_jax_shard_map(layout):
    jcfg, st_np, b_np = stacked_inputs(90 + len(layout), SMALL, N, heat=4)
    pcfg = port_cfg(jcfg)
    mesh = jmesh()
    gc = bool(b_np["gc"][0] > 0)
    jst, jb = jtree(st_np), jtree(b_np)

    def states():
        return split(to_port(pcfg, st_np), layout)

    batches = split(to_port(pcfg, b_np), layout)
    jnew, jout = jsh.make_sharded_step(jcfg, mesh)(jst, jb)
    pnew, pout = tsh.make_sharded_step(pcfg, DEVS, LAYOUTS[layout])(states(), batches, gc)
    assert len(pnew) == len(groups_of(layout))
    assert_tree_eq(join(pnew), dict(jnew), "grouped state")
    assert_tree_eq({k: v for k, v in pout.items() if k != "merged"},
                   {k: (dict(v) if isinstance(v, dict) else v) for k, v in jout.items()},
                   "grouped out")

    jscan = jax.jit(jsh.make_mesh_scan_step(jcfg, mesh))(jst, jb)
    hists, edges, wposes = tsh.make_mesh_scan_step(pcfg, DEVS, LAYOUTS[layout])(states(),
                                                                               batches)
    assert eq(torch.cat(hists), jscan[0])
    assert_tree_eq(join(edges), dict(jscan[1]), "grouped scan edges")
    assert_tree_eq(join(wposes), dict(jscan[2]), "grouped scan wpos")
    jx_new, jx_out = jax.jit(jsh.make_mesh_exchange_step(jcfg, mesh))(jst, jb, *jscan)
    px_new, px_out = tsh.make_mesh_exchange_step(pcfg, DEVS, LAYOUTS[layout])(
        states(), batches, hists, edges, wposes, gc)
    assert_tree_eq(join(px_new), dict(jx_new), "grouped exchange state")
    for k in ("status", "overflow"):
        assert eq(px_out[k], jx_out[k]), k
    assert_tree_eq(px_out["heat"], dict(jx_out["heat"]), "grouped exchange heat")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_grouped_split_steps_equal_jax_shard_map(layout):
    jcfg, st_np, b_np = stacked_inputs(60 + len(layout), SMALL, N)
    pcfg = port_cfg(jcfg)
    mesh = jmesh()
    gc = bool(b_np["gc"][0] > 0)
    jst, jb = jtree(st_np), jtree(b_np)
    batches = split(to_port(pcfg, b_np), layout)
    jdet, jfix, japp = jsh.make_sharded_split_steps(jcfg, mesh)
    pdet, pfix, papp = tsh.make_sharded_split_steps(pcfg, DEVS, LAYOUTS[layout])
    jh, je, jw = jdet(jst, jb)
    ph, pe, pw = pdet(split(to_port(pcfg, st_np), layout), batches)
    assert eq(torch.cat(ph), jh)
    t_ok = np.broadcast_to(b_np["t_ok"][0], (N,) + b_np["t_ok"][0].shape).copy()
    t_ok[:, ::3] = False                  # the host tier's outer round
    jc = jfix(jnp.asarray(t_ok), jh, je, jb)
    pc = pfix(torch.from_numpy(t_ok), ph, pe, batches)
    assert eq(pc, jc)
    ja_new, ja_ov = japp(jst, jb, jc, jw)
    pa_new, pa_ov = papp(split(to_port(pcfg, st_np), layout), batches, pc, pw, gc)
    assert_tree_eq(join(pa_new), dict(ja_new), "grouped split apply")
    assert eq(pa_ov, ja_ov)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_grouped_chunk_scan_equals_jax_shard_map(layout):
    jcfg, st_np, b0 = stacked_inputs(33 + len(layout), SMALL, N, heat=4)
    _, _, b1 = stacked_inputs(34 + len(layout), SMALL, N, n_warm=0, heat=4)
    b1["now"] = b0["now"] + 10
    b1["gc"] = np.full_like(b1["gc"], 5)
    b0["gc"] = np.zeros_like(b0["gc"])
    bs = {k: np.stack([b0[k], b1[k]], axis=1) for k in b0}      # [S, C, ...]
    pcfg = port_cfg(jcfg)
    jnew, jout = jsh.make_sharded_scan_step(jcfg, jmesh(), 2)(jtree(st_np), jtree(bs))
    pb = {k: torch.stack([to_port(pcfg, b0)[k], to_port(pcfg, b1)[k]], dim=1) for k in b0}
    pnew, pout = tsh.make_sharded_scan_step(pcfg, DEVS, 2, LAYOUTS[layout])(
        split(to_port(pcfg, st_np), layout), split(pb, layout), True)
    assert pout["status"].shape == (N, 2, jcfg.max_txns)
    assert_tree_eq(join(pnew), dict(jnew), "grouped scan state")
    assert_tree_eq(pout, {k: (dict(v) if isinstance(v, dict) else v) for k, v in jout.items()},
                   "grouped scan out")
    with pytest.raises(ValueError, match="3-chunk scan"):
        tsh.make_sharded_scan_step(pcfg, DEVS, 3, LAYOUTS[layout])(
            split(to_port(pcfg, st_np), layout), split(pb, layout), True)


# ---------------------------------------------------------------------------
# the engines against JAX's engines and the oracle
# ---------------------------------------------------------------------------

BIG = KernelConfig(key_words=2, capacity=512, max_reads=128, max_writes=128, max_txns=64)
ENGINE_KW = dict(ladder=[32], scan_sizes=(2,), heat_buckets=16)


def engine_stream():
    """Random batches (ranges straddling shard spans), then point batches
    around the 32-txn bucket (31, 32, 33 txns) and over the 64-txn top
    bucket (100 and 128 txns: 2-chunk scans), with the GC horizon
    advancing: (txns, now, oldest) per batch."""
    out = list(random_stream(1919, 10, txns_per_batch=40))
    rng = DeterministicRandom(2020)
    v = 2000
    for k in (31, 32, 33, 100, 7, 128):
        v += rng.random_int(5, 30)
        out.append((point_batch(rng, v, k), v, max(0, v - 300)))
    return out


_JAX_RUNS = {}


def jax_run(family):
    """The JAX engine's verdicts and heat snapshot over engine_stream, on
    the 8-device mesh (once a module per family)."""
    if family not in _JAX_RUNS:
        sm = JKeyShardMap.uniform(N)
        if family == "sharded":
            eng = jsh.ShardedConflictEngine(BIG, sm, jmesh(), **ENGINE_KW)
        else:
            eng = jme.MeshShardedConflictEngine(BIG, sm, jmesh(), **ENGINE_KW)
        verdicts = [[int(v) for v in eng.resolve(*b)] for b in engine_stream()]
        _JAX_RUNS[family] = (verdicts, eng.heat_snapshot(), dict(eng.perf.bucket_hits))
    return _JAX_RUNS[family]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("family,overlap", [("sharded", None), ("mesh", False), ("mesh", True)])
def test_grouped_engines_equal_jax_and_oracle(family, overlap, layout):
    kw = dict(ENGINE_KW, groups=LAYOUTS[layout])
    if family == "sharded":
        eng = tsh.ShardedConflictEngine(port_cfg(BIG), KeyShardMap.uniform(N), devices=DEVS, **kw)
    else:
        eng = tme.MeshShardedConflictEngine(port_cfg(BIG), KeyShardMap.uniform(N), devices=DEVS,
                                            overlap=overlap, device_time_sample_rate=1.0, **kw)
    eng.warmup()
    assert eng.grouped and len(eng.groups) == len(set(LAYOUTS[layout]))
    assert all(isinstance(p, exchange.GroupedProgram) for p in eng._programs.values())
    compiles = eng.perf.compiles
    want, jheat, jhits = jax_run(family)
    ora = OracleConflictEngine()
    for b, (txns, now, oldest) in enumerate(engine_stream()):
        got = [int(v) for v in eng.resolve(txns, now, oldest)]
        assert got == want[b], b
        assert got == [int(v) for v in ora.resolve(txns, now, oldest)], b
    assert eng.perf.compiles == compiles, "built a program after warmup"
    assert eng.heat_snapshot() == jheat
    assert dict(eng.perf.bucket_hits) == jhits and all(v > 0 for v in jhits.values())
    assert eng.perf.scan_dispatches.get(2, 0) > 0
    if family == "mesh":
        assert eng.loop_stats["blocking_syncs"] == 0 and eng.ring_depth() == 0 or overlap
        assert eng.mesh_stats["timed_exchanges"] > 0
        view = eng.device_view()
        assert [r["group"] for r in view] == LAYOUTS[layout]
        assert [r["shard"] for r in view] == list(range(N))


def test_one_group_keeps_the_stacked_programs():
    """Every shard on one device is one group: the engine builds today's
    _Program (and the mesh engine its scan / exchange pair), its state has
    no group tags and its progcache key is unchanged; the same shards in
    groups build GroupedPrograms under a key that names the layout."""
    one = tsh.ShardedConflictEngine(port_cfg(SMALL), KeyShardMap.uniform(4), devices=["cpu"] * 4,
                                    ladder=(), scan_sizes=(2,))
    one.warmup()
    assert not one.grouped and one.group_state(0) is one.state
    assert all(type(p) is _Program for p in one._programs.values())
    assert "hkeys" in one.state and one._progcache_fingerprint() == "mesh:4/1"
    mesh = tme.MeshShardedConflictEngine(port_cfg(SMALL), KeyShardMap.uniform(4),
                                         devices=["cpu"] * 4, ladder=(), scan_sizes=())
    mesh.warmup()
    assert isinstance(mesh._programs[(32, 1)], tuple) and mesh.perf.compiles == 2
    assert all("group" not in r for r in mesh.device_view())
    two = tsh.ShardedConflictEngine(port_cfg(SMALL), KeyShardMap.uniform(4), devices=["cpu"] * 4,
                                    groups=[0, 0, 1, 1], ladder=(), scan_sizes=(2,))
    assert sorted(two.state) == sorted(f"{k}@{g}" for k in ("hkeys", "hvers", "n")
                                       for g in (0, 1))
    assert two.group_state(1)["hkeys"].shape[0] == 2
    assert two._progcache_fingerprint() == "mesh:4/1:cpu[0:2],cpu[2:4]"
    assert len(two._device_states_for_snapshot()) == 4


# ---------------------------------------------------------------------------
# a live reshard over grouped mesh slots
# ---------------------------------------------------------------------------

def test_split_over_grouped_mesh_slots_holds_to_serial_oracle(tmp_path):
    """The controller's live split with every slot a supervised CPU mesh
    engine of 4 tiered shards in 2 groups: the pre-copy reads the donor's
    runs shard by shard across the groups (run_slice), and every verdict
    equals the serial oracle's and the oracle-slot group's."""
    def factory():
        return oracle_factory(PORT, lambda: tme.MeshShardedConflictEngine(
            tck.KernelConfig(key_words=2, capacity=4096, max_reads=64, max_writes=64,
                             max_txns=32, history_runs=8),
            KeyShardMap.uniform(4), devices=["cpu"] * 4, groups=[0, 0, 1, 1],
            history_structure="tiered", ladder=(), scan_sizes=()))()
    engines = split_then_merge(PORT, tmp_path / "grouped", factory)
    clean_world()
    oracles = split_then_merge(PORT, tmp_path / "oracle")
    assert engines["verdicts"] == oracles["verdicts"]
    assert engines["parity"][1] == 0 and engines["executed"] >= 1


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def test_placement_groups_and_what_raises():
    G = tsh.Group
    cpu, c0, c1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)
    assert tsh.placement(["cpu"] * 3) == [G(cpu, 0, 3)]
    assert tsh.placement([c0, c0, c1, c1, c1]) == [G(c0, 0, 2), G(c1, 2, 5)]
    # runs of one device, not devices: a device may hold two groups
    assert tsh.placement([c0, c1, c0]) == [G(c0, 0, 1), G(c1, 1, 2), G(c0, 2, 3)]
    assert tsh.placement(["cpu"] * 8, LAYOUTS["3+5"]) == [G(cpu, 0, 3), G(cpu, 3, 8)]
    assert [g.n for g in tsh.placement(["cpu"] * 8, LAYOUTS["8x1"])] == [1] * 8
    with pytest.raises(ValueError, match="at least one device"):
        tsh.placement([])
    for bad in ([0, 1, 0], [1, 1, 0], [0, 2, 2], [0, 0]):
        with pytest.raises(ValueError, match="group"):
            tsh.placement(["cpu"] * 3, bad)
    with pytest.raises(ValueError, match="names two devices"):
        tsh.placement([c0, c1], [0, 0])
    with pytest.raises(ValueError, match="group"):
        tsh.ShardedConflictEngine(port_cfg(SMALL), KeyShardMap([b"m"]), devices=["cpu"] * 2,
                                  groups=[0, 2])


def test_default_devices_spread_over_the_cards(monkeypatch):
    """No devices list: with k >= 2 cards N <= k shards go one to a card
    (cards 0..N-1, JAX's devs[:n]), N > k in contiguous blocks (shard s on
    card s*k//N); with one card, or an explicit device, every shard on
    it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)

    def idx(devs):
        return [d.index for d in devs]

    assert idx(tsh.resolve_devices(2)) == [0, 1]
    assert idx(tsh.resolve_devices(4)) == [0, 1, 2, 3]
    assert idx(tsh.resolve_devices(8)) == [0, 0, 1, 1, 2, 2, 3, 3]
    assert idx(tsh.resolve_devices(6)) == [0, 0, 1, 2, 2, 3]
    assert [g.n for g in tsh.placement(tsh.resolve_devices(8))] == [2, 2, 2, 2]
    assert tsh.resolve_devices(3, device="cpu") == [torch.device("cpu")] * 3
    assert tsh.resolve_devices(2, devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tsh.resolve_devices(3) == [torch.device("cuda")] * 3
    with pytest.raises(ValueError, match="3 shards need 3 devices"):
        tsh.resolve_devices(3, devices=["cpu"])
