// Earlier-in-batch-wins commit fixpoint: one launch runs the whole
// convergence loop of the resolver's intra-batch check (kernel v5).
//
// Replaces the TPU kernel commit_fixpoint_pallas
// (foundationdb_tpu/ops/fixpoint_pallas.py:343, the pallas_call at :336).
// Same function as the plain torch version (conflict_kernel.commit_fixpoint):
//   base  = t_ok & ~(hist_hits > 0)
//   c    <- base & ~blocked(c)   until c stops changing, at most T+1 rounds
// where blocked(c) marks txn t iff one of its valid read rows is hit by a
// committed, strictly earlier write of the same batch:
//   * point read vs point write: same key group (gid) and a smaller txn —
//     the per-gid minimum of committed writer txns;
//   * any read vs a committed RANGE write: ovw[r, w] & maskw[w] != 0;
//   * RANGE read vs a committed POINT write: ovrp[r, w] & maskp[w] != 0.
// maskw / maskp are the committed-writer bitmaps, built each round from c by
// gathers through w_txn / wp_txn.
//
// What bounds it on an H100. The edge words (ovw + ovrp: 0.5 MB at the bench
// width T=4096, Rp=Wp=8192, Rr=Wr=256; 6 MB at the default config's 4096
// rows per group) are nearly all zero: an edge runs only from an earlier
// txn's write to a later txn's overlapping read, and padding rows carry no
// bits. Re-reading all of them every round from one SM is bound by that
// SM's share of L2 bandwidth. So v5:
//   * launches ONE thread-block cluster of `nc` CTAs (one per SM; 16, the
//     largest cluster Hopper takes: faster than 8 at every shape measured,
//     PERF.md). Each CTA owns a contiguous slice of the read rows (point
//     rows, then range rows) and keeps its own copy of c, base, the writer
//     masks and a local blocked bitmap in shared memory;
//   * reads every edge word of its slice once, before the first round,
//     skipping the words of rows that are invalid, and keeps only the
//     nonzero words as (bits, mask word, txn) entries — in shared memory up
//     to the capacity the launch plan gives, the rest in a per-CTA global
//     scratch list sized for the worst case (every word nonzero). The rounds
//     then scan only those entries, plus the list of valid point rows for
//     the gid term. An entry names the txn it blocks, so a round needs no
//     row bookkeeping: a hit is one shared atomicOr into the local bitmap;
//   * merges the local bitmaps into the leader CTA's (rank 0) through
//     distributed shared memory, one remote atomicOr per nonzero word;
//   * keeps the gid table in global memory as 64-bit (round, txn) keys:
//     atomicMin of key(round, txn) makes the newest round win and, within
//     it, the smallest txn, and a reader ignores a slot whose round tag is
//     not the current one. So the table is never reset between rounds.
//     The alternative, the table split over the cluster's shared memory
//     and reached by 64-bit atomicMin and loads through distributed shared
//     memory, gave wrong verdicts on the card, cause not isolated
//     (PERF.md).
// So the first-round scan costs the slice's bytes over nc SMs, and each
// later round costs the entries (a few per valid read row on real batches),
// one gid atomic and one gid read per committed point writer and valid
// point row, two cluster barriers and the mask rebuild (Wr + Wp lookups in
// shared memory per CTA).
//
// A round, in every CTA:
//   (a) masks from c; zero the local blocked bitmap;
//   (b) atomicMin key(round, txn) for the CTA's slice of committed point
//       writers;
//   cluster barrier 1;
//   (c) scan entries and point rows into the local bitmap; OR its nonzero
//       words into the leader's bitmap of this round's parity;
//   cluster barrier 2;
//   (d) read the leader's bitmap, c' = base & ~blocked. Every CTA computes
//       the same c' from the same words, so every CTA takes the same
//       convergence decision without a further barrier.
//
// The stacked entry (commit_fixpoint_stacked_kernel, below) runs the same
// convergence for S key-range sub-shards of one batch in one launch: the
// function of conflict_kernel.commit_fixpoint_stacked, which replaces the
// mesh engine's psum of each round's blocked counts by a sum over the
// sub-shards. The blocked bitmap lies in the txn space, which every
// sub-shard shares, and blocked counts add up across sub-shards, so
// "blocked in any sub-shard" is one OR of bitmaps. So the entry launches K
// clusters, each owning whole sub-shards (K = S where the card holds S
// clusters at once, else ceil(S / K) sub-shards each): inside a cluster
// the CTAs split its sub-shards' read rows and point writers as v5 splits
// one table's, and a CTA holds only its cluster's writer masks, writer txn
// table, row txns and lists in shared memory. So a round's mask rebuild
// costs 32 * (WRW + WPW) lookups per sub-shard the cluster owns, the gid
// atomics stay inside the cluster that owns the sub-shard, and K * nc SMs
// share the first-round compaction. The round inside a cluster is v5's;
// across clusters, once a round, each cluster leader ORs its cluster's
// nonzero blocked words into a global bitmap (L2 atomics), one grid barrier
// follows, and every CTA reads the same words, computes the same c' and
// takes the same convergence decision. The grid barrier needs every CTA
// resident at once: the launch is cooperative (with the cluster
// attribute), which CUDA refuses rather than hangs when the grid does not
// fit, and the wrapper asks cudaOccupancyMaxActiveClusters before it
// plans K and the cluster size (fixpoint_cuda.choose_plan_stacked: one
// cluster per sub-shard at the largest size the card holds S of). base
// folds every sub-shard's history hits (a sum over S). What bounds it on
// an H100 (PERF.md §6): a round costs ~4.8 us at K > 1 against ~3.8 at
// K = 1, so the grid barrier and the L2 exchange add ~1 us; the launch's
// setup and first-round compaction take 55-65% of a traffic batch's time,
// and that part falls as the CTAs per sub-shard grow.

// Layout the caller guarantees (conflict_kernel.build_batch_arrays): valid
// read rows grouped by ascending txn, so "OR over rows naming txn t" is the
// plain version's "OR over t's row window". T % 32 == 0 (warp ballots pack
// 32 txns per word). Group ids lie in [1, G].

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
// Edge words a lane loads per compaction step. Register pressure: at 1024
// threads a thread has at most 64 registers; 16 words spilled, 8 do not
// (the -Xptxas -v report lands in _build/fixpoint.log).
constexpr int kUnroll = 8;
constexpr int kMaxSmem = 232448;    // 227 KB: the most a CTA may use
constexpr int kPortableCluster = 8;

struct Entry {                      // one nonzero edge word of a valid read row
  uint32_t bits;
  int32_t word;                     // index into maskw ++ maskp
  int32_t txn;                      // the read row's txn, in [0, T)
};

struct PointRow {                   // a valid point read row
  int32_t slot;                     // its gid slot, clamped into [0, G+1]
  int32_t txn;
};

// A list that lives in shared memory up to `cap` items and continues in
// global scratch past it.
template <class E>
struct SplitList {
  E* smem;
  E* spill;
  int cap;
  __device__ __forceinline__ E& operator[](int i) const {
    return i < cap ? smem[i] : spill[i - cap];
  }
};

// The bit of c a writer's txn reads, with the JAX gather rule for an
// out-of-range txn (wrap a negative index once, then clamp).
__device__ __forceinline__ int txn_index(int txn, int T) {
  if (txn < 0) txn += T;
  return min(max(txn, 0), T - 1);
}

// Gid-table key: the high word falls as the round grows, the low word is the
// txn biased so that signed order is unsigned order. The all-ones initial
// value carries round 0, which no round matches.
__device__ __forceinline__ unsigned long long gid_key(int round, int txn) {
  return (static_cast<unsigned long long>(0xffffffffu - static_cast<uint32_t>(round)) << 32) |
         (static_cast<uint32_t>(txn) ^ 0x80000000u);
}

// The txn of read row g (point rows, then range rows), or -1 when the row
// is invalid or names no txn of the batch: such a row never blocks
// anything. Both loads go out together; the flag only selects.
__device__ __forceinline__ int read_row_txn(int g, int Rp, int T,
                                            const int32_t* __restrict__ rp_txn,
                                            const bool* __restrict__ rp_valid,
                                            const int32_t* __restrict__ r_txn,
                                            const bool* __restrict__ r_valid) {
  const bool point = g < Rp;
  const int t = point ? rp_txn[g] : r_txn[g - Rp];
  const bool v = point ? rp_valid[g] : r_valid[g - Rp];
  return (v && t >= 0 && t < T) ? t : -1;
}

// Reserve `n` consecutive list slots for a warp: lane 0 bumps the counter,
// every lane gets the base.
__device__ __forceinline__ int warp_reserve(int* counter, int n, int lane) {
  int base = 0;
  if (lane == 0 && n) base = atomicAdd(counter, n);
  return __shfl_sync(0xffffffffu, base, 0);
}

// Append the nonzero words of `nrows` rows of width W (words at `words`,
// row r's txn at row_txn[r], mask index = word_off + column) to `list`.
// Each lane has kUnroll independent coalesced loads in flight per step, skipping
// the words of invalid rows; the loop runs per warp over whole 32-word
// steps, so the ballots are warp-uniform.
__device__ __forceinline__ void compact_words(
    const uint32_t* __restrict__ words, int nrows, int W, const int* row_txn, int word_off,
    SplitList<Entry> list, int* count, int warp, int nwarps, int lane) {
  const int n = nrows * W;
  const uint32_t below = (1u << lane) - 1u;
  const int q32 = 32 / W, r32 = 32 % W;  // a step of 32 words: q32 rows and r32 columns
  for (int f0 = warp * 32 * kUnroll; f0 < n; f0 += nwarps * 32 * kUnroll) {  // warp-uniform
    // Word f0 + k * 32 + lane lies in row r0 + k * q32 (+1 past a column
    // wrap): rows and columns advance without a division, in both passes.
    const int r0 = (f0 + lane) / W, c0 = f0 + lane - r0 * W;
    uint32_t bits[kUnroll];
    {
      int r = r0, cl = c0;
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int f = f0 + k * 32 + lane;
        bits[k] = (f < n && row_txn[r] >= 0) ? words[f] : 0u;
        r += q32;
        cl += r32;
        if (cl >= W) {
          cl -= W;
          ++r;
        }
      }
    }
    int total = 0;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) total += __popc(__ballot_sync(0xffffffffu, bits[k] != 0u));
    int pos = warp_reserve(count, total, lane);
    int r = r0, cl = c0;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const uint32_t hits = __ballot_sync(0xffffffffu, bits[k] != 0u);
      if (bits[k]) list[pos + __popc(hits & below)] = Entry{bits[k], word_off + cl, row_txn[r]};
      pos += __popc(hits);
      r += q32;
      cl += r32;
      if (cl >= W) {
        cl -= W;
        ++r;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) commit_fixpoint_kernel(
    const bool* __restrict__ t_ok, const int32_t* __restrict__ hist_hits,
    const int32_t* __restrict__ rp_txn, const bool* __restrict__ rp_valid,
    const int32_t* __restrict__ gid_rp,
    const int32_t* __restrict__ r_txn, const bool* __restrict__ r_valid,
    const int32_t* __restrict__ wp_txn, const bool* __restrict__ wp_valid,
    const int32_t* __restrict__ gid_wp,
    const int32_t* __restrict__ w_txn, const bool* __restrict__ w_valid,
    const uint32_t* __restrict__ ovw, const uint32_t* __restrict__ ovrp,
    unsigned long long* __restrict__ mn, Entry* __restrict__ entry_spill,
    PointRow* __restrict__ point_spill, bool* __restrict__ committed,
    int32_t* __restrict__ rounds_out,
    int T, int Rp, int Rr, int Wp, int Wr, int WRW, int WPW, int G,
    int rows_per_cta, int point_cap, int entry_cap, int point_spill_cap, int entry_spill_cap) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nc = static_cast<int>(gridDim.x);  // the grid is one cluster

  extern __shared__ uint32_t smem[];
  const int TW = T >> 5;
  const int MW = WRW + WPW;           // writer-mask words
  const int wper = (Wp + nc - 1) / nc;
  int* counts = reinterpret_cast<int*>(smem);    // [0] entries, [1] point rows
  uint32_t* c = smem + 4;             // [TW] committed bitmap
  uint32_t* base = c + TW;            // [TW] t_ok & ~history hit
  uint32_t* blocked = base + TW;      // [TW] this CTA's blocked txns
  uint32_t* lead = blocked + TW;      // [2][TW] the cluster's, by round parity (rank 0's are used)
  uint32_t* masks = lead + 2 * TW;    // [WRW] committed range writes ++ [WPW] committed point writes
  uint32_t* maskp = masks + WRW;
  int* wtx = reinterpret_cast<int*>(masks + MW);  // [32 * MW] each writer's txn index, or -1
  int* wgid = wtx + 32 * MW;          // [wper] this CTA's point writers: gid slot, or -1
  int* wraw = wgid + wper;            // [wper] ... and txn as given (the gid key's low word)
  int* rtx = wraw + wper;             // [rows_per_cta] txn of each read row of the slice, or -1
  const SplitList<PointRow> points{reinterpret_cast<PointRow*>(rtx + rows_per_cta),
                                   point_spill + static_cast<size_t>(rank) * point_spill_cap,
                                   point_cap};
  const SplitList<Entry> entries{reinterpret_cast<Entry*>(points.smem + point_cap),
                                 entry_spill + static_cast<size_t>(rank) * entry_spill_cap,
                                 entry_cap};
  uint32_t* lead0 = cluster.map_shared_rank(lead, 0);  // the leader's bitmaps

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int gmax = G + 1;             // last slot of the [G + 2] table

  // This CTA's read rows [g0, g1) and point writers [w0, w1).
  const int r_all = Rp + Rr;
  const int g0 = min(rank * rows_per_cta, r_all), g1 = min(g0 + rows_per_cta, r_all);
  const int w0 = min(rank * wper, Wp), w1 = min(w0 + wper, Wp);

  // Setup: everything a round reads again lands in shared memory, where it
  // costs no L2 round trip (at 227 KB of shared memory, L1 keeps ~29 KB).
  if (tid < 2) counts[tid] = 0;
  // Every loop that ballots runs over a multiple of 32 indices, so the 32
  // lanes of a warp enter and leave it together (T % 32 == 0 here).
  for (int t = tid; t < T; t += nthr) {
    const uint32_t word = __ballot_sync(0xffffffffu, t_ok[t] && hist_hits[t] <= 0);
    if (lane == 0) {
      base[t >> 5] = word;
      c[t >> 5] = word;
    }
  }
  for (int i = tid; i < 2 * TW; i += nthr) lead[i] = 0u;
  for (int w = tid; w < 32 * WRW; w += nthr)
    wtx[w] = (w < Wr && w_valid[w]) ? txn_index(w_txn[w], T) : -1;
  for (int w = tid; w < 32 * WPW; w += nthr)
    wtx[32 * WRW + w] = (w < Wp && wp_valid[w]) ? txn_index(wp_txn[w], T) : -1;
  for (int j = tid; j < wper; j += nthr) {
    const int w = w0 + j;
    int g = -1, t = 0;
    if (w < w1 && wp_valid[w]) {
      g = gid_wp[w];
      t = wp_txn[w];
      if (g < 0 || g > gmax) g = -1;
    }
    wgid[j] = g;
    wraw[j] = t;
  }
  for (int i = tid; i < rows_per_cta; i += nthr)
    rtx[i] = g0 + i < g1 ? read_row_txn(g0 + i, Rp, T, rp_txn, rp_valid, r_txn, r_valid) : -1;
  __syncthreads();

  // Compaction, once per launch. Point rows of the slice: the valid ones
  // join the point list, and their gid slots start at round 0 (= +inf).
  // The loop runs per warp over whole 32-row steps (warp-uniform ballots).
  {
    const int np = max(min(g1, Rp) - g0, 0);
    for (int i0 = warp * 32; i0 < np; i0 += nwarps * 32) {  // warp-uniform
      const int i = i0 + lane;
      const int tx = i < np ? rtx[i] : -1;
      int slot = 0;
      if (tx >= 0) {
        slot = min(max(gid_rp[g0 + i], 0), gmax);
        mn[slot] = ~0ull;
      }
      const uint32_t keep = __ballot_sync(0xffffffffu, tx >= 0);
      const int pos = warp_reserve(&counts[1], __popc(keep), lane);
      if (tx >= 0) points[pos + __popc(keep & ((1u << lane) - 1u))] = PointRow{slot, tx};
    }
  }
  // Edge words: ovw of every row of the slice, then ovrp of its range rows.
  compact_words(ovw + static_cast<size_t>(g0) * WRW, g1 - g0, WRW, rtx, 0, entries,
                &counts[0], warp, nwarps, lane);
  {
    const int q0 = max(g0, Rp);
    if (q0 < g1)
      compact_words(ovrp + static_cast<size_t>(q0 - Rp) * WPW, g1 - q0, WPW, rtx + (q0 - g0),
                    WRW, entries, &counts[0], warp, nwarps, lane);
  }
  // Memory ordering: the gid slots set above are global stores another CTA
  // will atomicMin; the cluster barrier (release / acquire at cluster scope)
  // orders them first. It also orders the leader's zeroed bitmaps before any
  // remote OR. The lists are read only by the CTA that wrote them, after
  // this barrier's block-wide part.
  cluster.sync();
  const int n_entries = counts[0];
  const int n_points = counts[1];

  int rounds = 0;
  for (;;) {
    ++rounds;
    // (a) writer masks from c (range writers' words, then point writers');
    // zero the local bitmap
    for (int w = tid; w < 32 * MW; w += nthr) {
      const int t = wtx[w];
      const uint32_t word = __ballot_sync(0xffffffffu, t >= 0 && ((c[t >> 5] >> (t & 31)) & 1u));
      if (lane == 0) masks[w >> 5] = word;
    }
    for (int i = tid; i < TW; i += nthr) blocked[i] = 0u;
    __syncthreads();

    // (b) per-gid minimum txn of the committed point writers, tagged with
    // this round (no reset: a slot of an older round reads as +inf)
    for (int j = tid; j < w1 - w0; j += nthr) {
      const int w = w0 + j;
      if (wgid[j] >= 0 && ((maskp[w >> 5] >> (w & 31)) & 1u))
        atomicMin(&mn[wgid[j]], gid_key(rounds, wraw[j]));
    }
    // Cluster barrier 1: every CTA's atomics of this round are done before
    // any CTA reads a slot. A leader-only bitmap: the leader zeroes the
    // bitmap of the NEXT round's parity here, after this barrier — every CTA
    // read it last round before arriving — and before barrier 2, which
    // orders the zeroing before the next round's remote ORs. So a fast CTA
    // never ORs into bits of an older round.
    cluster.sync();
    if (rank == 0)
      for (int i = tid; i < TW; i += nthr) lead[((rounds + 1) & 1) * TW + i] = 0u;

    // (c) the compacted edge words and the valid point rows
    for (int e = tid; e < n_entries; e += nthr) {
      const Entry en = entries[e];
      if (en.bits & masks[en.word]) atomicOr(&blocked[en.txn >> 5], 1u << (en.txn & 31));
    }
    const uint32_t tag = 0xffffffffu - static_cast<uint32_t>(rounds);
    for (int i = tid; i < n_points; i += nthr) {
      const PointRow p = points[i];
      // __ldcg: other CTAs' atomics wrote the slot at L2 this round; a load
      // through L1 could return a line cached in an earlier round
      const unsigned long long v = __ldcg(&mn[p.slot]);
      if (static_cast<uint32_t>(v >> 32) == tag &&
          static_cast<int>(static_cast<uint32_t>(v) ^ 0x80000000u) < p.txn)
        atomicOr(&blocked[p.txn >> 5], 1u << (p.txn & 31));
    }
    __syncthreads();
    uint32_t* lead_now = lead0 + (rounds & 1) * TW;
    for (int i = tid; i < TW; i += nthr)
      if (blocked[i]) atomicOr(&lead_now[i], blocked[i]);
    // Cluster barrier 2: every remote OR of this round is in the leader's
    // bitmap before any CTA reads it.
    cluster.sync();

    // (d) c' = base & ~blocked; stop at the fixpoint or after T+1 rounds
    // (the JAX while_loop: one first round, then at most T more)
    int changed = 0;
    for (int i = tid; i < TW; i += nthr) {
      const uint32_t nw = base[i] & ~lead_now[i];
      changed |= (nw != c[i]);
      c[i] = nw;
    }
    if (!__syncthreads_or(changed) || rounds > T) break;
  }

  if (rank == 0) {
    for (int t = tid; t < T; t += nthr) committed[t] = (c[t >> 5] >> (t & 31)) & 1u;
    if (tid == 0) rounds_out[0] = rounds;
  }
  // No CTA leaves while another may still read the leader's shared memory.
  cluster.sync();
}

// The stacked entry: S sub-shards in one launch of K clusters of nc CTAs
// (see the note at the top). Inputs carry the sub-shard axis first: hist
// [S, T], rp_* / gid_rp [S, Rp], r_* [S, Rr], wp_* / gid_wp [S, Wp], w_*
// [S, Wr], ovw [S, Rp + Rr, WRW], ovrp [S, Rr, WPW]. Cluster k owns the
// sub-shards [k * spc, min((k + 1) * spc, S)). mn is [S * (G + 2)]; wtx_g
// is [S * 32 * MW] global scratch used when wtx_in_smem is 0; gx is the
// [3][TW] cross-cluster bitmap; each spill list has one segment per CTA of
// the grid.
__global__ void __launch_bounds__(kThreads, 1) commit_fixpoint_stacked_kernel(
    const bool* __restrict__ t_ok, const int32_t* __restrict__ hist,
    const int32_t* __restrict__ rp_txn, const bool* __restrict__ rp_valid,
    const int32_t* __restrict__ gid_rp,
    const int32_t* __restrict__ r_txn, const bool* __restrict__ r_valid,
    const int32_t* __restrict__ wp_txn, const bool* __restrict__ wp_valid,
    const int32_t* __restrict__ gid_wp,
    const int32_t* __restrict__ w_txn, const bool* __restrict__ w_valid,
    const uint32_t* __restrict__ ovw, const uint32_t* __restrict__ ovrp,
    unsigned long long* __restrict__ mn, int* __restrict__ wtx_g, uint32_t* __restrict__ gx,
    Entry* __restrict__ entry_spill, PointRow* __restrict__ point_spill,
    bool* __restrict__ committed, int32_t* __restrict__ rounds_out,
    int S, int T, int Rp, int Rr, int Wp, int Wr, int WRW, int WPW, int G, int spc,
    int rows_per_cta, int wper, int point_cap, int entry_cap, int point_spill_cap,
    int entry_spill_cap, int wtx_in_smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nc = static_cast<int>(cluster.num_blocks());
  const int cta = static_cast<int>(blockIdx.x);   // clusters tile the grid in order
  const int K = static_cast<int>(gridDim.x) / nc;
  const int s0 = (cta / nc) * spc;                // this cluster's first sub-shard
  const int ns = min(spc, S - s0);                // ... and how many it owns

  extern __shared__ uint32_t smem[];
  const int TW = T >> 5;
  const int MW = WRW + WPW;           // one sub-shard's writer-mask words
  const int RA = Rp + Rr;             // one sub-shard's read rows
  const int G2 = G + 2;               // one sub-shard's gid-table slots
  int* counts = reinterpret_cast<int*>(smem);    // [0] entries, [1] point rows
  uint32_t* c = smem + 4;             // [TW] committed bitmap
  uint32_t* base = c + TW;            // [TW] t_ok & ~history hit in any sub-shard
  uint32_t* blocked = base + TW;      // [TW] this CTA's blocked txns
  uint32_t* lead = blocked + TW;      // [2][TW] the cluster's, by round parity
  uint32_t* masks = lead + 2 * TW;    // [spc][WRW range ++ WPW point] committed-writer words
  int* wtx_s = reinterpret_cast<int*>(masks + spc * MW);  // [32 * spc * MW] when in smem
  int* wtx = wtx_in_smem ? wtx_s : wtx_g + static_cast<size_t>(s0) * 32 * MW;
  int* wgid = wtx_s + (wtx_in_smem ? 32 * spc * MW : 0);  // [wper] point writers: gid slot, or -1
  int* wraw = wgid + wper;            // [wper] ... and txn as given
  int* rtx = wraw + wper;             // [rows_per_cta] txn of each read row of the slice, or -1
  const SplitList<PointRow> points{reinterpret_cast<PointRow*>(rtx + rows_per_cta),
                                   point_spill + static_cast<size_t>(cta) * point_spill_cap,
                                   point_cap};
  const SplitList<Entry> entries{reinterpret_cast<Entry*>(points.smem + point_cap),
                                 entry_spill + static_cast<size_t>(cta) * entry_spill_cap,
                                 entry_cap};
  uint32_t* lead0 = cluster.map_shared_rank(lead, 0);

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int gmax = G + 1;

  // This CTA's rows [g0, g1) of its cluster's ns * RA rows (row g lies in
  // sub-shard s0 + g / RA), and point writers [w0, w1) of its ns * Wp.
  const int r_all = ns * RA;
  const int g0 = min(rank * rows_per_cta, r_all), g1 = min(g0 + rows_per_cta, r_all);
  const int w0 = min(rank * wper, ns * Wp), w1 = min(w0 + wper, ns * Wp);

  if (tid < 2) counts[tid] = 0;
  for (int t = tid; t < T; t += nthr) {
    uint32_t h = 0u;                  // the sum over ALL sub-shards, int32 wrap as JAX's
    for (int s = 0; s < S; ++s) h += static_cast<uint32_t>(hist[static_cast<size_t>(s) * T + t]);
    const uint32_t word = __ballot_sync(0xffffffffu, t_ok[t] && static_cast<int>(h) <= 0);
    if (lane == 0) {
      base[t >> 5] = word;
      c[t >> 5] = word;
    }
  }
  for (int i = tid; i < 2 * TW; i += nthr) lead[i] = 0u;
  {
    // writer w of the cluster's local sub-shard l: range writers in words
    // [l*MW, l*MW+WRW), point writers in [l*MW+WRW, (l+1)*MW); in global
    // scratch the cluster's CTAs fill disjoint indices of its own segment,
    // ordered before any read by the cluster barrier
    const int n = 32 * ns * MW;
    const int start = wtx_in_smem ? tid : rank * nthr + tid;
    const int step = wtx_in_smem ? nthr : nc * nthr;
    for (int w = start; w < n; w += step) {
      const int l = w / (32 * MW), r = w - l * 32 * MW, s = s0 + l;
      int t = -1;
      if (r < 32 * WRW) {
        if (r < Wr && w_valid[s * Wr + r]) t = txn_index(w_txn[s * Wr + r], T);
      } else {
        const int q = r - 32 * WRW;
        if (q < Wp && wp_valid[s * Wp + q]) t = txn_index(wp_txn[s * Wp + q], T);
      }
      wtx[w] = t;
    }
  }
  for (int j = tid; j < wper; j += nthr) {
    const int w = w0 + j;             // the cluster's point writer w: sub-shard s0 + w / Wp
    int g = -1, t = 0;
    if (w < w1 && wp_valid[s0 * Wp + w]) {
      const int s = s0 + w / Wp;
      g = gid_wp[s0 * Wp + w];
      t = wp_txn[s0 * Wp + w];
      g = (g < 0 || g > gmax) ? -1 : s * G2 + g;
    }
    wgid[j] = g;
    wraw[j] = t;
  }
  for (int i = tid; i < rows_per_cta; i += nthr) {
    int tx = -1;
    if (g0 + i < g1) {
      const int g = g0 + i, s = s0 + g / RA, l = g % RA;
      tx = read_row_txn(l, Rp, T, rp_txn + static_cast<size_t>(s) * Rp,
                        rp_valid + static_cast<size_t>(s) * Rp,
                        r_txn + static_cast<size_t>(s) * Rr, r_valid + static_cast<size_t>(s) * Rr);
    }
    rtx[i] = tx;
  }
  __syncthreads();

  // Compaction: the valid point rows of the slice, their gid slots reset
  // to round 0 (= +inf); the loop is warp-uniform over 32-row steps.
  {
    const int nr = g1 - g0;
    for (int i0 = warp * 32; i0 < nr; i0 += nwarps * 32) {  // warp-uniform
      const int i = i0 + lane;
      int tx = -1, slot = 0;
      if (i < nr) {
        const int g = g0 + i, s = s0 + g / RA, l = g % RA;
        if (l < Rp && rtx[i] >= 0) {
          tx = rtx[i];
          slot = s * G2 + min(max(gid_rp[static_cast<size_t>(s) * Rp + l], 0), gmax);
          mn[slot] = ~0ull;
        }
      }
      const uint32_t keep = __ballot_sync(0xffffffffu, tx >= 0);
      const int pos = warp_reserve(&counts[1], __popc(keep), lane);
      if (tx >= 0) points[pos + __popc(keep & ((1u << lane) - 1u))] = PointRow{slot, tx};
    }
  }
  // Edge words, sub-shard by sub-shard of the slice: ovw of every row,
  // then ovrp of the range rows, each word naming its local sub-shard's
  // mask words.
  if (g0 < g1) {
    for (int l = g0 / RA; l <= (g1 - 1) / RA; ++l) {
      const int s = s0 + l;
      const int a = max(g0, l * RA), b = min(g1, (l + 1) * RA);
      compact_words(ovw + (static_cast<size_t>(s) * RA + (a - l * RA)) * WRW, b - a, WRW,
                    rtx + (a - g0), l * MW, entries, &counts[0], warp, nwarps, lane);
      const int q = max(a, l * RA + Rp);
      if (q < b)
        compact_words(ovrp + (static_cast<size_t>(s) * Rr + (q - l * RA - Rp)) * WPW, b - q,
                      WPW, rtx + (q - g0), l * MW + WRW, entries, &counts[0], warp, nwarps,
                      lane);
    }
  }
  // The cross-cluster bitmaps start at zero: one CTA clears them, and the
  // grid barrier orders that before any cluster's first OR.
  if (K > 1 && cta == 0)
    for (int i = tid; i < 3 * TW; i += nthr) gx[i] = 0u;
  cluster.sync();
  if (K > 1) cg::this_grid().sync();
  const int n_entries = counts[0];
  const int n_points = counts[1];

  int rounds = 0;
  for (;;) {
    ++rounds;
    // (a) the cluster's writer masks from c; zero the local bitmap
    for (int w = tid; w < 32 * ns * MW; w += nthr) {
      const int t = wtx_in_smem ? wtx[w] : __ldcg(&wtx[w]);
      const uint32_t word = __ballot_sync(0xffffffffu, t >= 0 && ((c[t >> 5] >> (t & 31)) & 1u));
      if (lane == 0) masks[w >> 5] = word;
    }
    for (int i = tid; i < TW; i += nthr) blocked[i] = 0u;
    __syncthreads();

    // (b) per-gid minimum txn of the committed point writers (the slots
    // are the cluster's own sub-shards')
    for (int j = tid; j < w1 - w0; j += nthr) {
      if (wgid[j] < 0) continue;
      const int w = w0 + j, l = w / Wp, q = w - l * Wp;
      if ((masks[l * MW + WRW + (q >> 5)] >> (q & 31)) & 1u)
        atomicMin(&mn[wgid[j]], gid_key(rounds, wraw[j]));
    }
    cluster.sync();
    if (rank == 0)
      for (int i = tid; i < TW; i += nthr) lead[((rounds + 1) & 1) * TW + i] = 0u;

    // (c) the compacted edge words and the valid point rows
    for (int e = tid; e < n_entries; e += nthr) {
      const Entry en = entries[e];
      if (en.bits & masks[en.word]) atomicOr(&blocked[en.txn >> 5], 1u << (en.txn & 31));
    }
    const uint32_t tag = 0xffffffffu - static_cast<uint32_t>(rounds);
    for (int i = tid; i < n_points; i += nthr) {
      const PointRow p = points[i];
      const unsigned long long v = __ldcg(&mn[p.slot]);
      if (static_cast<uint32_t>(v >> 32) == tag &&
          static_cast<int>(static_cast<uint32_t>(v) ^ 0x80000000u) < p.txn)
        atomicOr(&blocked[p.txn >> 5], 1u << (p.txn & 31));
    }
    __syncthreads();
    uint32_t* lead_now = lead0 + (rounds & 1) * TW;
    for (int i = tid; i < TW; i += nthr)
      if (blocked[i]) atomicOr(&lead_now[i], blocked[i]);
    cluster.sync();

    // (x) across clusters: each leader ORs its cluster's nonzero words into
    // the round's global bitmap (three, by round mod 3: the one of round
    // r + 1 is cleared in round r, after every CTA passed round r - 1's
    // grid barrier, which follows its last read of that bitmap in round
    // r - 2, and before round r's grid barrier, which precedes any OR of
    // round r + 1 — two would need a second grid barrier a round); then
    // one grid barrier, and every CTA reads the same words
    const uint32_t* src = lead_now;
    if (K > 1) {
      uint32_t* g_now = gx + (rounds % 3) * TW;
      if (rank == 0)
        for (int i = tid; i < TW; i += nthr) {
          const uint32_t v = lead[(rounds & 1) * TW + i];
          if (v) atomicOr(&g_now[i], v);
        }
      if (cta == 0)
        for (int i = tid; i < TW; i += nthr) gx[((rounds + 1) % 3) * TW + i] = 0u;
      cg::this_grid().sync();
      src = g_now;
    }

    // (d) c' = base & ~blocked; stop at the fixpoint or after T+1 rounds.
    // Every CTA of the grid reads the same words, so all take the same
    // decision without a further barrier.
    int changed = 0;
    for (int i = tid; i < TW; i += nthr) {
      const uint32_t nw = base[i] & ~(K > 1 ? __ldcg(&src[i]) : src[i]);
      changed |= (nw != c[i]);
      c[i] = nw;
    }
    if (!__syncthreads_or(changed) || rounds > T) break;
  }

  if (cta == 0) {
    for (int t = tid; t < T; t += nthr) committed[t] = (c[t >> 5] >> (t & 31)) & 1u;
    if (tid == 0) rounds_out[0] = rounds;
  }
  // No CTA leaves while another of its cluster may still read the leader's
  // shared memory.
  cluster.sync();
}

}  // namespace

namespace {

// The launch of `clusters` clusters of `nc` CTAs with `smem_bytes` of
// dynamic shared memory each: sets the kernel's attributes (a cluster above
// the portable 8 CTAs must be allowed first, or the launch is refused) and
// fills `config`. Several clusters launch cooperatively: the grid barrier
// between them needs every CTA resident at once, which a cooperative launch
// guarantees or refuses (cudaErrorCooperativeLaunchTooLarge) — it never
// hangs.
template <class Kernel>
cudaError_t cluster_config(Kernel kernel, int clusters, int nc, int smem_bytes, void* stream,
                           cudaLaunchConfig_t* config, cudaLaunchAttribute* attr) {
  if (smem_bytes > kMaxSmem || nc < 1 || nc > 16 || clusters < 1) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return e;
  if (nc > kPortableCluster) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  *config = {};
  config->gridDim = dim3(clusters * nc, 1, 1);
  config->blockDim = dim3(kThreads, 1, 1);
  config->dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  config->stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
  if (clusters > 1) {
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    config->numAttrs = 2;
  }
  return cudaSuccess;
}

}  // namespace

// How many clusters of `nc` CTAs with `smem_bytes` of shared memory each the
// current card can hold at once (cudaOccupancyMaxActiveClusters), in *out.
// 0 means the launch can never be scheduled: a 16-CTA cluster of 1024-thread
// CTAs needs a GPC with 16 free SMs, which a partitioned or smaller part may
// not have. Returns the cudaError_t of the query.
extern "C" int fdb_fixpoint_active_clusters(int nc, int smem_bytes, int* out) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[2];
  cudaError_t e =
      cluster_config(commit_fixpoint_kernel, 1, nc, smem_bytes, nullptr, &config, attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, commit_fixpoint_kernel, &config));
}

// The same question for the stacked entry: the most clusters one
// cooperative launch of it may hold.
extern "C" int fdb_fixpoint_stacked_active_clusters(int nc, int smem_bytes, int* out) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[2];
  cudaError_t e =
      cluster_config(commit_fixpoint_stacked_kernel, 1, nc, smem_bytes, nullptr, &config, attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, commit_fixpoint_stacked_kernel, &config));
}

// Plain C entry point (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: bools as 1-byte, int32 words holding uint32 bits, the
// gid table as [G+2] 64-bit words, the spill lists as raw scratch. The
// launch plan (fixpoint_cuda.launch_plan) gives the cluster size, the rows
// per CTA, the list capacities and the dynamic shared memory. The kernel
// launches on `stream` as one cluster of `nc` CTAs, does not synchronise and
// allocates nothing. Returns the cudaError_t of the launch (0 on success).
extern "C" int fdb_commit_fixpoint(
    const void* t_ok, const void* hist_hits,
    const void* rp_txn, const void* rp_valid, const void* gid_rp,
    const void* r_txn, const void* r_valid,
    const void* wp_txn, const void* wp_valid, const void* gid_wp,
    const void* w_txn, const void* w_valid,
    const void* ovw, const void* ovrp,
    void* mn, void* entry_spill, void* point_spill, void* committed, void* rounds,
    int T, int Rp, int Rr, int Wp, int Wr, int WRW, int WPW, int G,
    int nc, int rows_per_cta, int point_cap, int entry_cap, int point_spill_cap,
    int entry_spill_cap, int smem_bytes, void* stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[2];
  cudaError_t e =
      cluster_config(commit_fixpoint_kernel, 1, nc, smem_bytes, stream, &config, attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(
      &config, commit_fixpoint_kernel,
      static_cast<const bool*>(t_ok), static_cast<const int32_t*>(hist_hits),
      static_cast<const int32_t*>(rp_txn), static_cast<const bool*>(rp_valid),
      static_cast<const int32_t*>(gid_rp),
      static_cast<const int32_t*>(r_txn), static_cast<const bool*>(r_valid),
      static_cast<const int32_t*>(wp_txn), static_cast<const bool*>(wp_valid),
      static_cast<const int32_t*>(gid_wp),
      static_cast<const int32_t*>(w_txn), static_cast<const bool*>(w_valid),
      static_cast<const uint32_t*>(ovw), static_cast<const uint32_t*>(ovrp),
      static_cast<unsigned long long*>(mn), static_cast<Entry*>(entry_spill),
      static_cast<PointRow*>(point_spill), static_cast<bool*>(committed),
      static_cast<int32_t*>(rounds),
      T, Rp, Rr, Wp, Wr, WRW, WPW, G,
      rows_per_cta, point_cap, entry_cap, point_spill_cap, entry_spill_cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The stacked entry's plain C entry point: as fdb_commit_fixpoint, with the
// sub-shard count S, `clusters` clusters of `nc` CTAs each owning `spc`
// sub-shards, the global wtx scratch and whether wtx lives in shared memory,
// and the cross-cluster bitmap scratch gx ([3][T/32] words) — the launch
// plan's choices (fixpoint_cuda.launch_plan_stacked).
extern "C" int fdb_commit_fixpoint_stacked(
    const void* t_ok, const void* hist,
    const void* rp_txn, const void* rp_valid, const void* gid_rp,
    const void* r_txn, const void* r_valid,
    const void* wp_txn, const void* wp_valid, const void* gid_wp,
    const void* w_txn, const void* w_valid,
    const void* ovw, const void* ovrp,
    void* mn, void* wtx, void* gx, void* entry_spill, void* point_spill, void* committed,
    void* rounds,
    int S, int T, int Rp, int Rr, int Wp, int Wr, int WRW, int WPW, int G,
    int clusters, int nc, int spc, int rows_per_cta, int writers_per_cta, int point_cap,
    int entry_cap, int point_spill_cap, int entry_spill_cap, int wtx_in_smem, int smem_bytes,
    void* stream) {
  if (spc < 1 || clusters != (S + spc - 1) / spc) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[2];
  cudaError_t e = cluster_config(commit_fixpoint_stacked_kernel, clusters, nc, smem_bytes, stream,
                                 &config, attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(
      &config, commit_fixpoint_stacked_kernel,
      static_cast<const bool*>(t_ok), static_cast<const int32_t*>(hist),
      static_cast<const int32_t*>(rp_txn), static_cast<const bool*>(rp_valid),
      static_cast<const int32_t*>(gid_rp),
      static_cast<const int32_t*>(r_txn), static_cast<const bool*>(r_valid),
      static_cast<const int32_t*>(wp_txn), static_cast<const bool*>(wp_valid),
      static_cast<const int32_t*>(gid_wp),
      static_cast<const int32_t*>(w_txn), static_cast<const bool*>(w_valid),
      static_cast<const uint32_t*>(ovw), static_cast<const uint32_t*>(ovrp),
      static_cast<unsigned long long*>(mn), static_cast<int*>(wtx), static_cast<uint32_t*>(gx),
      static_cast<Entry*>(entry_spill), static_cast<PointRow*>(point_spill),
      static_cast<bool*>(committed), static_cast<int32_t*>(rounds),
      S, T, Rp, Rr, Wp, Wr, WRW, WPW, G, spc,
      rows_per_cta, writers_per_cta, point_cap, entry_cap, point_spill_cap, entry_spill_cap,
      wtx_in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
