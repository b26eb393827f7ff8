"""Per-phase device timing for the conflict step at the bench shape.

Port of ``foundationdb_tpu/tools/profile_kernel.py``.

Each candidate piece is timed as ONE program of STEPS iterations (JAX ran
a lax.scan inside one compiled program): on the card one captured CUDA
graph of the same loop (floor_bench.ScanProgram), replayed once warm and
timed over the next replay with CUDA events, so the per-iteration figure
carries no host launch cost. Each body folds a checksum of its outputs
into the carry so no work is dead; the batch index varies per iteration.

Usage: python -m foundationdb_tpu_torch.tools.profile_kernel [--device cpu]
           [--steps N] [variant ...]
Variants: full phases12 phases1only sort fixpoint apply binsearch sortbatch
          (main); fixiters stacked8 (main2); gc4_T4096 gc4_T8192 gc1_T8192
          cuda_T4096 cuda_gc1_T4096 cuda_T8192 (main3)

JAX's fixpoint choice "pallas" (its kernel) / "xla" (its while_loop) is
here "cuda" (the hand kernel, csrc/fixpoint.cu) / "plain" (the plain
torch version): main3's pallas_* variants are the cuda_* ones, and its
gc*_T* variants run the plain fixpoint. The plain fixpoint reads its loop
test on the host every round, so it cannot be captured: its programs run
eagerly and are timed with CUDA events around the same loop (launch cost
included). The `fixpoint` variant also checks the kernel's verdicts
against the plain version's on the same inputs.

On the CPU (`--device cpu`) it runs at a toy size (TOY_CFG, 4 steps) and
prints no ms: a CPU run measures no device time. Every line names the
device.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops import conflict_kernel as ck
from ..ops import fixpoint_cuda

CFG = ck.KernelConfig(
    key_words=4, capacity=24576,
    max_point_reads=8192, max_point_writes=8192,
    max_reads=256, max_writes=256, max_txns=4096,
)
#: the CPU's toy shape
TOY_CFG = ck.KernelConfig(
    key_words=4, capacity=2048,
    max_point_reads=256, max_point_writes=256,
    max_reads=32, max_writes=32, max_txns=128,
)
READS_PER_TXN = 2
WRITES_PER_TXN = 2
POOL = 8192
NB = 8
STEPS = 256
GC_LAG = 4
VARIANTS = ("full", "phases12", "phases1only", "sort", "fixpoint", "apply",
            "binsearch", "sortbatch")
VARIANTS2 = ("fixiters", "stacked8")
SHAPES = (
    ("gc4_T4096", 4096, 4, "plain"),
    ("gc4_T8192", 8192, 4, "plain"),
    ("gc1_T8192", 8192, 1, "plain"),
    ("cuda_T4096", 4096, 4, "cuda"),
    ("cuda_gc1_T4096", 4096, 1, "cuda"),
    ("cuda_T8192", 8192, 4, "cuda"),
)


class Profile:
    """One run's shape, device and results: `ms` {variant: ms per
    iteration} (device ms; empty on the CPU), `info` the other figures
    (checks, iteration counts)."""

    def __init__(self, cfg: ck.KernelConfig, device, steps: int, pool: int = POOL,
                 out=sys.stdout):
        from .sharded_bench import card_line

        self.cfg, self.device, self.steps, self.pool = cfg, device, steps, pool
        self.vpb = cfg.max_txns
        self.card = card_line(device)
        self.ms: Dict[str, float] = {}
        self.info: Dict[str, object] = {}
        self.out = out

    def say(self, s: str) -> None:
        print(s, file=self.out, flush=True)

    def timed_scan(self, name: str, body: Callable, carry: Dict[str, torch.Tensor],
                   graph: bool = True, steps: Optional[int] = None) -> Optional[float]:
        """`steps` iterations of body(carry, i) -> (carry', y) as one
        program: a captured graph (graph=True) or, for a body that reads a
        device value on the host, the eager loop timed with CUDA events.
        Warm run first; prints and returns ms per iteration (None and no
        ms on the CPU)."""
        from .floor_bench import ScanProgram

        steps = steps or self.steps
        on_card = self.device.type == "cuda"
        if graph or not on_card:
            prog = ScanProgram(body, carry, steps)
            prog.run()                          # warm
            ms = prog.run()
        else:
            def loop():
                c = carry
                for i in range(steps):
                    c, _ = body(c, i)
                return c

            loop()                              # warm
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loop()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        if ms is None:
            self.say(f"{name:10s} ran {steps} iterations [{self.card}]")
            return None
        per = ms / steps
        self.ms[name] = per
        self.say(f"{name:10s} {per:8.3f} ms/iter [{self.card}]")
        return per


def _pool(rng: np.random.Generator, K: int, pool: int = POOL) -> np.ndarray:
    keys = np.zeros((pool, K), np.uint32)
    keys[:, :4] = rng.integers(0, 2**32, size=(pool, 4), dtype=np.uint32)
    keys[:, K - 1] = 16
    return keys[np.lexsort([keys[:, c] for c in range(K - 1, -1, -1)])]


def _batch_arrays(cfg: ck.KernelConfig, pool: np.ndarray, r_idx, w_idx) -> Dict[str, np.ndarray]:
    K, T = cfg.lanes, cfg.max_txns
    Rr, Wr = cfg.max_reads, cfg.max_writes
    return {
        "rpb": pool[r_idx].copy(),
        "rp_txn": np.repeat(np.arange(T, dtype=np.int32), READS_PER_TXN),
        "rp_valid": np.ones((cfg.rp,), bool),
        "rb": np.zeros((Rr, K), np.uint32),
        "re": np.zeros((Rr, K), np.uint32),
        "r_snap": np.zeros((Rr,), np.int32),
        "r_txn": np.zeros((Rr,), np.int32),
        "r_valid": np.zeros((Rr,), bool),
        "wpb": pool[w_idx].copy(),
        "wp_txn": np.repeat(np.arange(T, dtype=np.int32), WRITES_PER_TXN),
        "wp_valid": np.ones((cfg.wp,), bool),
        "wb": np.zeros((Wr, K), np.uint32),
        "we": np.zeros((Wr, K), np.uint32),
        "w_txn": np.zeros((Wr,), np.int32),
        "w_valid": np.zeros((Wr,), bool),
        "t_ok": np.ones((T,), bool),
        "t_too_old": np.zeros((T,), bool),
    }


def _to_device(arrays: List[Dict[str, np.ndarray]], device) -> Dict[str, torch.Tensor]:
    """Stack a list of batch dicts on a leading axis, keys widened to int64
    words (the step computes on int64 key words)."""
    out = {}
    for k in arrays[0]:
        a = np.stack([b[k] for b in arrays])
        a = a.astype(np.int64) if k in ck.KEY_FIELDS else a
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def synth(p: Profile, rng: np.random.Generator) -> Dict[str, torch.Tensor]:
    cfg = p.cfg
    pool = _pool(rng, cfg.lanes, p.pool)
    batches = []
    for _ in range(NB):
        r_idx = rng.integers(0, p.pool, size=cfg.rp)
        w_idx = rng.integers(0, p.pool, size=cfg.wp)
        batches.append(_batch_arrays(cfg, pool, r_idx, w_idx))
    return _to_device(batches, p.device)


def versioned(p: Profile, batch: Dict[str, torch.Tensor], now: torch.Tensor) -> Dict:
    """The batch at version `now` (a 0-d int32 tensor): snapshots half a
    batch back, the GC horizon GC_LAG batches back."""
    snap = torch.clamp(now - p.vpb // 2, min=0)
    gc = torch.clamp(now - GC_LAG * p.vpb, min=0)
    return dict(batch, rp_snap=snap.to(torch.int32).expand(p.cfg.rp).clone(),
                now=now.to(torch.int32), gc=gc.to(torch.int32))


def _i32(x: int, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=device)


def steady_state(p: Profile, batches: Dict[str, torch.Tensor], warm_steps: int = 64):
    """Run enough full steps that the table reaches steady occupancy
    (eagerly, the version on the host: each step's GC branch is known)."""
    state = ck.initial_state(p.cfg, device=p.device)
    now = 1
    for i in range(warm_steps):
        b = versioned(p, {k: v[i % NB] for k, v in batches.items()}, _i32(now, p.device))
        gc = max(now - GC_LAG * p.vpb, 0)
        state, _ = ck.resolve_step(p.cfg, state, b, gc > 0)
        now = now + p.vpb - gc
    return state, now, int(state["n"])


def main(variants, device=None, steps: Optional[int] = None, out=sys.stdout) -> Profile:
    from .floor_bench import bench_device

    dev = bench_device(device)
    on_card = dev.type == "cuda"
    p = Profile(CFG if on_card else TOY_CFG, dev, steps or (STEPS if on_card else 4),
                pool=POOL if on_card else 256, out=out)
    cfg = p.cfg
    rng = np.random.default_rng(2026)
    batches = synth(p, rng)
    state, now0, n_steady = steady_state(p, batches)
    p.info["steady_rows"] = n_steady
    p.say(f"steady-state boundary rows: {n_steady} / {cfg.capacity} [{p.card}]")
    # every timed body steps past now0, where GC is on (now0 > GC_LAG batches)
    assert now0 - GC_LAG * p.vpb > 0

    def get_batch(i, now):
        return versioned(p, {k: v[i % NB] for k, v in batches.items()}, now)

    def fresh(st):
        return {k: v.clone() for k, v in st.items()}

    now_t = _i32(now0, dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    if "full" in variants:
        def body(c, i):
            st = {k: c[k] for k in state}
            st, o = ck.resolve_step(cfg, st, get_batch(i, c["now"]), True)
            gc_applied = torch.clamp(c["now"] - GC_LAG * p.vpb, min=0)
            return dict(st, now=(c["now"] + p.vpb - gc_applied).to(torch.int32)), o["n"]
        p.timed_scan("full", body, dict(fresh(state), now=now_t.clone()))

    if "phases12" in variants:
        def body(c, i):
            b = get_batch(i, c["now"])
            hist, edges, wpos = ck.local_phases(cfg, state, b)
            committed = ck._fixpoint(cfg, b["t_ok"], hist, edges, b)
            acc = (c["acc"] + committed.sum() + hist.sum() + wpos["lo_b"][0])
            return {"acc": acc, "now": c["now"] + 7}, acc
        p.timed_scan("phases12", body, {"acc": zero.clone(), "now": now_t.clone()})

    if "phases1only" in variants:
        def body(c, i):
            b = get_batch(i, c["now"])
            hist, edges, wpos = ck.local_phases(cfg, state, b)
            acc = c["acc"] + hist.sum() + edges["gid_rp"].sum() + wpos["lo_b"][0]
            return {"acc": acc, "now": c["now"] + 7}, acc
        p.timed_scan("phases1only", body, {"acc": zero.clone(), "now": now_t.clone()})

    if "sort" in variants:
        H, K = cfg.capacity, cfg.lanes
        hkeys, n = state["hkeys"], state["n"]

        def body(c, i):
            b = get_batch(i, c["now"])
            groups = (
                (b["rpb"], 3, b["rp_valid"]),
                (b["rb"], 3, b["r_valid"]),
                (b["re"], 0, b["r_valid"]),
                (ck._bump(b["rb"]), 0, b["r_valid"]),
                (b["wpb"], 4, b["wp_valid"]),
                (b["wb"], 2, b["w_valid"]),
                (b["we"], 1, b["w_valid"]),
            )
            bkeys = torch.cat([g[0] for g in groups], dim=0)
            bcode = torch.cat([torch.full((g[0].shape[0],), g[1], dtype=torch.int64, device=dev)
                               for g in groups])
            bvalid = torch.cat([g[2] for g in groups])
            keys_all = torch.cat([hkeys, bkeys], dim=0)
            code_all = torch.cat([torch.full((H,), 5, dtype=torch.int64, device=dev), bcode])
            valid_all = torch.cat([torch.arange(H, device=dev) < n, bvalid])
            perm, skeys = ck._sorted_rows(keys_all[None], code_all, valid_all[None])
            acc = c["acc"] + perm[0, 0] + skeys[0, -1, 0]
            return {"acc": acc, "now": c["now"] + 7}, acc
        p.timed_scan("sort", body, {"acc": zero.clone(), "now": now_t.clone()})

    if "fixpoint" in variants:
        b0 = get_batch(0, now_t)
        hist, edges, _wpos = ck.local_phases(cfg, state, b0)
        if on_card:
            # the kernel against its plain version on the same inputs
            got = fixpoint_cuda.commit_fixpoint_kernel(cfg, b0["t_ok"], hist, edges, b0)
            want = fixpoint_cuda.commit_fixpoint_plain(cfg, b0["t_ok"], hist, edges, b0)
            p.info["fixpoint_equal"] = bool(torch.equal(got, want))
            #: kernel launches made only to compare it with its plain version
            p.info["compare_launches"] = 1
            p.info["fixpoint_commits"] = int(got.sum())
            p.say(f"fixpoint   kernel equal to the plain version: {p.info['fixpoint_equal']} "
                  f"({p.info['fixpoint_commits']} commits of {cfg.max_txns}) [{p.card}]")

        def body(c, i):
            b = get_batch(i, c["now"])
            committed = ck._fixpoint(cfg, b["t_ok"], hist, edges, b)
            acc = c["acc"] + committed.sum()
            return {"acc": acc, "now": c["now"] + 7}, acc
        p.timed_scan("fixpoint", body, {"acc": zero.clone(), "now": now_t.clone()})
        if on_card:
            def plain_body(c, i):
                b = get_batch(i, c["now"])
                committed = fixpoint_cuda.commit_fixpoint_plain(cfg, b["t_ok"], hist, edges, b)
                acc = c["acc"] + committed.sum()
                return {"acc": acc, "now": c["now"] + 7}, acc
            p.timed_scan("fixpoint_plain", plain_body, {"acc": zero.clone(), "now": now_t.clone()},
                         graph=False, steps=min(p.steps, 16))

    if "apply" in variants:
        b0 = get_batch(0, now_t)
        hist, edges, wpos = ck.local_phases(cfg, state, b0)
        committed0 = ck._fixpoint(cfg, b0["t_ok"], hist, edges, b0)

        def body(c, i):
            st = {k: c[k] for k in state}
            b = get_batch(i, c["now"])
            st2, _, _ = ck.apply_writes_and_gc(cfg, st, b, committed0, wpos, True)
            return dict(st2, now=c["now"] + 7), st2["n"]
        p.timed_scan("apply", body, dict(fresh(state), now=now_t.clone()))

    if "binsearch" in variants:
        # Alternative to the fused sort: vectorized binary search of all
        # batch endpoint queries into the (already sorted) table.
        H = cfg.capacity
        hkeys, n = state["hkeys"], state["n"]
        LEV = cfg.levels

        def lower_bound(q):  # q: [Q, K] -> [Q]
            lo = torch.zeros((q.shape[0],), dtype=torch.int64, device=dev)
            size = H
            for _ in range(LEV):
                half = size // 2
                mid = lo + half
                row = hkeys[torch.clamp(mid, max=H - 1)]
                lt = (mid < n) & ck._key_less(row, q)
                lo = torch.where(lt, mid + 1, lo)
                size = size - half
            return lo

        def body(c, i):
            b = get_batch(i, c["now"])
            q = torch.cat([b["rpb"], b["rb"], b["re"], ck._bump(b["rb"]),
                           b["wpb"], b["wb"], b["we"]], dim=0)
            acc = c["acc"] + lower_bound(q).sum()
            return {"acc": acc, "now": c["now"] + 7}, acc
        p.timed_scan("binsearch", body, {"acc": zero.clone(), "now": now_t.clone()})

    if "sortbatch" in variants:
        # Sort ONLY the point rows (for gid grouping) — the small-sort half
        # of a search+small-sort redesign.
        def body(c, i):
            b = get_batch(i, c["now"])
            bkeys = torch.cat([b["rpb"], b["wpb"]], dim=0)
            B = bkeys.shape[0]
            valid = torch.cat([b["rp_valid"], b["wp_valid"]])
            code = (torch.arange(B, device=dev) >= cfg.rp).to(torch.int64)
            perm, skeys = ck._sorted_rows(bkeys[None], code, valid[None])
            acc = c["acc"] + perm[0, 0] + skeys[0, -1, 0]
            return {"acc": acc, "now": c["now"] + 7}, acc
        p.timed_scan("sortbatch", body, {"acc": zero.clone(), "now": now_t.clone()})
    return p


def main2(variants, device=None, steps: Optional[int] = None, out=sys.stdout) -> Profile:
    """Second-stage variants: fixpoint iteration counts + sub-sharded step."""
    from .floor_bench import bench_device

    dev = bench_device(device)
    on_card = dev.type == "cuda"
    p = Profile(CFG if on_card else TOY_CFG, dev, steps or (STEPS if on_card else 4),
                pool=POOL if on_card else 256, out=out)
    cfg = p.cfg
    rng = np.random.default_rng(2026)
    batches = synth(p, rng)
    state, now0, _n = steady_state(p, batches)
    now_t = _i32(now0, dev)

    def get_batch(i, now):
        return versioned(p, {k: v[i % NB] for k, v in batches.items()}, now)

    if "fixiters" in variants:
        # How many rounds does the earlier-in-batch fixpoint take at the
        # bench shape? (the plain form's loop, counted on the host)
        iters = []
        for i in range(32):
            b = get_batch(i, now_t + 7 * i)
            hist, edges, _wpos = ck.local_phases(cfg, state, b)
            base = b["t_ok"] & ~(hist > 0)
            bounds = ck._read_group_bounds(cfg, b)
            prev, c = base, base & ~(ck._blocked_txns(cfg, edges, b, base, bounds) > 0)
            it = 0
            while bool(torch.any(c != prev)) and it < cfg.max_txns:
                prev, c = c, base & ~(ck._blocked_txns(cfg, edges, b, c, bounds) > 0)
                it += 1
            iters.append(it)
        iters = np.asarray(iters)
        p.info["fixiters"] = {"mean": float(iters.mean()), "max": int(iters.max()),
                              "min": int(iters.min())}
        p.say(f"fixpoint iterations: mean={iters.mean():.1f} max={iters.max()}"
              f" min={iters.min()} [{p.card}]")

    if "stacked8" in variants:
        # Sub-sharded device rate at the bench shape: 8 pro-rata tables on
        # one card, balanced synthetic routing (keys drawn as permutations
        # so each shard gets exactly Rp/8 rows).
        S = 8
        cfg8 = ck.KernelConfig(
            key_words=4, capacity=4096 if on_card else 512,
            max_point_reads=cfg.rp // S, max_point_writes=cfg.wp // S,
            max_reads=32, max_writes=32, max_txns=cfg.max_txns,
        )
        K, T = cfg8.lanes, cfg8.max_txns
        Rp8, Wp8 = cfg8.rp, cfg8.wp
        pool = _pool(rng, K, p.pool)
        per_shard_pool = p.pool // S
        outs = []
        for _ in range(NB):
            shards = []
            r_perm = rng.permutation(p.pool)
            w_perm = rng.permutation(p.pool)
            r_txn_of = np.repeat(np.arange(T, dtype=np.int32), READS_PER_TXN)
            w_txn_of = np.repeat(np.arange(T, dtype=np.int32), WRITES_PER_TXN)
            for s in range(S):
                rmask = (r_perm // per_shard_pool) == s
                wmask = (w_perm // per_shard_pool) == s
                assert rmask.sum() == Rp8 and wmask.sum() == Wp8
                b = _batch_arrays(cfg8, pool, r_perm[rmask], w_perm[wmask])
                b["rp_txn"], b["wp_txn"] = r_txn_of[rmask], w_txn_of[wmask]
                shards.append(b)
            outs.append({k: np.stack([b[k] for b in shards]) for k in shards[0]})
        stacked = _to_device(outs, dev)

        def versioned8(b, now):
            snap = torch.clamp(now - p.vpb // 2, min=0).to(torch.int32)
            gc = torch.clamp(now - GC_LAG * p.vpb, min=0).to(torch.int32)
            return dict(b, rp_snap=snap.expand(S, Rp8).clone(),
                        now=now.to(torch.int32).expand(S).clone(), gc=gc.expand(S).clone())

        st8 = ck._stack([ck.initial_state(cfg8, device=dev) for _ in range(S)])
        now = 1
        for i in range(2 * GC_LAG):        # eager, until GC is on at every step
            b = versioned8({k: v[i % NB] for k, v in stacked.items()}, _i32(now, dev))
            gc = max(now - GC_LAG * p.vpb, 0)
            st8, _ = ck.resolve_step_stacked(cfg8, st8, b, gc > 0)
            now = now + p.vpb - gc

        def body(c, i):
            st = {k: c[k] for k in st8}
            b = versioned8({k: v[i % NB] for k, v in stacked.items()}, c["now"])
            st, o = ck.resolve_step_stacked(cfg8, st, b, True)
            gc_applied = torch.clamp(c["now"] - GC_LAG * p.vpb, min=0)
            return dict(st, now=(c["now"] + p.vpb - gc_applied).to(torch.int32)), o["n"].sum()

        ms = p.timed_scan("stacked8", body, dict(st8, now=_i32(now, dev)),
                          steps=min(p.steps, 16))
        if ms is not None:
            p.say(f"stacked8 txns/s: {cfg.max_txns / ms * 1e3:,.0f} [{p.card}]")
    return p


def main3(variants, device=None, steps: Optional[int] = None, out=sys.stdout) -> Profile:
    """Candidate bench shapes: GC cadence + batch width + fixpoint sweeps."""
    from .floor_bench import bench_device

    dev = bench_device(device)
    on_card = dev.type == "cuda"
    p = Profile(CFG if on_card else TOY_CFG, dev, steps or (STEPS if on_card else 4),
                pool=POOL if on_card else 256, out=out)
    for name, T, gc_every, fixp in SHAPES:
        if name not in variants:
            continue
        if not on_card:
            T = T // 32
        cfg = dataclasses.replace(p.cfg, max_point_reads=2 * T, max_point_writes=2 * T,
                                  max_txns=T)
        sp = Profile(cfg, dev, p.steps, pool=p.pool, out=out)
        rng = np.random.default_rng(2026)
        pool = _pool(rng, cfg.lanes, p.pool)
        arrays = []
        for _ in range(NB):
            r_idx = rng.integers(0, p.pool, size=cfg.rp)
            w_idx = rng.integers(0, p.pool, size=cfg.wp)
            arrays.append(_batch_arrays(cfg, pool, r_idx, w_idx))
        stacked = _to_device(arrays, dev)
        vpb = T
        fix = (fixpoint_cuda.commit_fixpoint_kernel if fixp == "cuda" and on_card
               else fixpoint_cuda.commit_fixpoint_plain)

        def step(st, i, now_t, gc_branch):
            b = {k: v[i % NB] for k, v in stacked.items()}
            gcv = torch.clamp(now_t - GC_LAG * vpb, min=0) if (i % gc_every) == 0 \
                else torch.zeros_like(now_t)
            b = dict(b, rp_snap=torch.clamp(now_t - vpb // 2, min=0).expand(cfg.rp).clone(),
                     now=now_t, gc=gcv.to(torch.int32))
            hist, edges, wpos = ck.local_phases(cfg, st, b)
            committed = fix(cfg, b["t_ok"], hist, edges, b)
            st, overflow, _ = ck.apply_writes_and_gc(cfg, st, b, committed, wpos, gc_branch)
            return st, (now_t + vpb - gcv).to(torch.int32), overflow

        state = ck.initial_state(cfg, device=dev)
        now = 1
        over = False
        for i in range(64):
            gcv = max(now - GC_LAG * vpb, 0) if i % gc_every == 0 else 0
            state, _, ov = step(state, i, _i32(now, dev), gcv > 0)
            over = over or bool(ov)
            now = now + vpb - gcv
        assert not over, "overflow during warm"

        def body(c, i, _step=step, _every=gc_every):
            st = {k: c[k] for k in state}
            st, now_n, ov = _step(st, i, c["now"], (i % _every) == 0)
            return dict(st, now=now_n), ov

        ms = sp.timed_scan(name, body, dict(state, now=_i32(now, dev)),
                           graph=fixp == "cuda")
        if ms is not None:
            p.ms[name] = ms
            p.say(f"{name} txns/s: {T / ms * 1e3:,.0f} [{sp.card}]")
    return p


def run(args: List[str], device=None, steps: Optional[int] = None,
        out=sys.stdout) -> Profile:
    """The variants `args` (all of main's by default) through main, main2
    or main3, as the JAX entry point chooses."""
    args = list(args) or list(VARIANTS)
    if any(v.startswith(("gc4_", "gc1_", "cuda_")) for v in args):
        return main3(args, device, steps, out)
    if any(v in VARIANTS2 for v in args):
        return main2(args, device, steps, out)
    return main(args, device, steps, out)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("variants", nargs="*")
    a = ap.parse_args()
    run(a.variants, a.device, a.steps)
