"""The yardstick of the commit fixpoint kernel: the least time one H100
could take for one fixpoint over a batch's rows.

A frozen copy of chip_smoke.py's `fixpoint_bound` (the test holds the two
equal at one shape), with the published peaks it is held to. The benchmark
gives it the valid rows its own traffic puts in each chunk and one round,
so the bound reads the same work whatever implements it. Imports nothing
of the program.
"""
from __future__ import annotations

#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and the
#: non-tensor float32 rate, the table's peak for scalar ALU work
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def fixpoint_bound(cfg, batch, hist, edges, rounds: int):
    """The least time the card could take for one fixpoint on these inputs,
    counting what this data needs: t_ok, the history hits and every valid
    flag read once; the txn, gid slot and edge words of the VALID rows only
    (an invalid row's edge words are zero and decide nothing); the output
    written once — over HBM, against the ALU work `rounds` rounds of the
    valid rows need (the word ANDs, the writer masks, the bitmap update)."""
    T, WRW, WPW = cfg.max_txns, cfg.wr_words, cfg.wp_words
    nrp, nrr = int(batch["rp_valid"].sum()), int(batch["r_valid"].sum())
    nwp, nwr = int(batch["wp_valid"].sum()), int(batch["w_valid"].sum())
    in_bytes = (5 * T + cfg.rp + cfg.max_reads + cfg.wp + cfg.max_writes  # t_ok, hist, flags
                + nrp * (8 + 4 * WRW)              # rp_txn, gid_rp, the ovw row
                + nrr * (4 + 4 * (WRW + WPW))      # r_txn, the ovw and ovrp rows
                + nwp * 8 + nwr * 4                # wp_txn, gid_wp; w_txn
                + T + 4)                           # committed, rounds
    ops = rounds * (nrp * (2 + 2 * WRW) + nrr * 2 * (WRW + WPW) + 3 * (nwp + nwr) + 3 * T // 32)
    bytes_ms = in_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ALU_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "input_bytes": in_bytes, "ops": ops}


class Shape:
    """The kernel shape fixpoint_bound reads, from a configuration's
    `engine` caps (KernelConfig's defaults for what they leave out)."""

    def __init__(self, engine: dict):
        self.max_txns = int(engine.get("max_txns", 1 << 12))
        self.max_reads = int(engine.get("max_reads", 1 << 12))
        self.max_writes = int(engine.get("max_writes", 1 << 12))
        rp, wp = int(engine.get("max_point_reads", -1)), int(engine.get("max_point_writes", -1))
        self.rp = rp if rp >= 0 else self.max_reads
        self.wp = wp if wp >= 0 else self.max_writes
        self.wr_words = (self.max_writes + 31) // 32
        self.wp_words = (self.wp + 31) // 32


def batch_bound_ms(shape: Shape, point_reads: int, point_writes: int, range_reads: int = 0,
                   range_writes: int = 0) -> float:
    """The bound of one chunk of these rows, one round."""
    batch = {"rp_valid": _Count(point_reads), "r_valid": _Count(range_reads),
             "wp_valid": _Count(point_writes), "w_valid": _Count(range_writes)}
    return fixpoint_bound(shape, batch, None, None, 1)["bound_ms"]


class _Count:
    """A valid-flag column reduced to its count (fixpoint_bound sums it)."""

    def __init__(self, n: int):
        self.n = n

    def sum(self) -> int:
        return self.n
