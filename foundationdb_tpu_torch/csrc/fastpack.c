/* The columnar pack of the port's engine: conflict-wire blocks to the
 * kernel's fixed-shape point-row arrays, on the host.
 *
 * The port's own copy of the columnar passes of
 * foundationdb_tpu/native/fastpack.c: the single-shard pair
 * (conflict_counts, build_point_rows) and the sharded pair
 * (conflict_counts_sharded, build_point_rows_sharded), which route each
 * point row to the key-range shard that owns it. Transactions arrive
 * as concatenated little-endian wire blocks (foundationdb_tpu_torch/core/
 * wire.py: blob + per-txn offsets) and become point rows in one pass, the
 * analog of the reference resolver's C++ walk over its serialized batch
 * request (fdbserver/Resolver.actor.cpp).
 *
 * Built by foundationdb_tpu_torch/native/build.py with the toolchain's cc
 * (cc -O2 -fPIC -shared) at first use and loaded with ctypes. The build
 * raises where no compiler exists: nothing falls back to numpy.
 */
#include <stdint.h>
#include <string.h>

/* Pack one key (len <= 4*key_words) into big-endian uint32 words + length:
 * the layout of ops/keypack.py's pack_keys. */
static inline void pack_one(const uint8_t *k, int64_t len, int64_t key_words,
                            uint32_t *row) {
    int64_t full = len / 4;
    for (int64_t w = 0; w < full; w++) {
        row[w] = ((uint32_t)k[4 * w] << 24) | ((uint32_t)k[4 * w + 1] << 16)
               | ((uint32_t)k[4 * w + 2] << 8) | (uint32_t)k[4 * w + 3];
    }
    for (int64_t w = full; w < key_words; w++) {
        uint32_t v = 0;
        for (int64_t b = 0; b < 4; b++) {
            int64_t idx = 4 * w + b;
            v = (v << 8) | (idx < len ? k[idx] : 0);
        }
        row[w] = v;
    }
    row[key_words] = (uint32_t)len;
}

/* Pass 1: per-txn POINT read/write counts. Returns 0 if every range in
 * every txn is a POINT row of at most max_key_bytes bytes (the columnar
 * precondition), else 1: the caller then takes the general router, which
 * handles ranges, empty reads and the long-key tier. */
int conflict_counts(const uint8_t *blob, const int64_t *offs, int64_t ntxn,
                    int64_t max_key_bytes,
                    int32_t *rp_cnt, int32_t *wp_cnt) {
    for (int64_t t = 0; t < ntxn; t++) {
        const uint8_t *p = blob + offs[t];
        const uint8_t *end = blob + offs[t + 1];
        if (end - p < 8) return 1;
        uint32_t nr, nw;
        memcpy(&nr, p, 4);
        memcpy(&nw, p + 4, 4);
        p += 8;
        for (uint32_t i = 0; i < nr + nw; i++) {
            if (end - p < 4) return 1;
            uint32_t hdr;
            memcpy(&hdr, p, 4);
            p += 4;
            uint32_t kind = hdr >> 30;
            int64_t blen = hdr & 0x3fffffff;
            if (kind != 0 || blen > max_key_bytes) return 1;
            p += blen;
            if (p > end) return 1;
        }
        rp_cnt[t] = (int32_t)nr;
        wp_cnt[t] = (int32_t)nw;
    }
    return 0;
}

/* Pass 2: pack POINT rows of txns [t0, t1) into preallocated padded row
 * arrays (rpb/wpb: rows of key_words+1 uint32; rp_txn/wp_txn: owning txn
 * index relative to t0). skip[t] != 0 (too-old txns) contributes no rows.
 * The caller guarantees capacity (chunking) and pointness (pass 1).
 * out_n[0]/out_n[1] receive the row counts. Rows stay txn-ascending (the
 * step's segment reduces rely on it). */
void build_point_rows(const uint8_t *blob, const int64_t *offs,
                      int64_t t0, int64_t t1, const uint8_t *skip,
                      int64_t key_words,
                      uint32_t *rpb, int32_t *rp_txn,
                      uint32_t *wpb, int32_t *wp_txn,
                      int64_t *out_n) {
    const int64_t stride = key_words + 1;
    int64_t nr_out = 0, nw_out = 0;
    for (int64_t t = t0; t < t1; t++) {
        if (skip[t]) continue;
        const uint8_t *p = blob + offs[t];
        uint32_t nr, nw;
        memcpy(&nr, p, 4);
        memcpy(&nw, p + 4, 4);
        p += 8;
        const int32_t ti = (int32_t)(t - t0);
        for (uint32_t i = 0; i < nr + nw; i++) {
            uint32_t hdr;
            memcpy(&hdr, p, 4);
            p += 4;
            int64_t blen = hdr & 0x3fffffff;
            if (i < nr) {
                pack_one(p, blen, key_words, rpb + nr_out * stride);
                rp_txn[nr_out++] = ti;
            } else {
                pack_one(p, blen, key_words, wpb + nw_out * stride);
                wp_txn[nw_out++] = ti;
            }
            p += blen;
        }
    }
    out_n[0] = nr_out;
    out_n[1] = nw_out;
}

/* ---- the sharded passes ------------------------------------------------
 * Shards are given by their S-1 split keys (the begin keys of shards
 * 1..S-1, ascending), concatenated in `splits` with offsets `soffs`
 * [S]. Shard s owns [split[s-1], split[s]); a point row lands on the one
 * shard whose span holds its key (ops/host_engine.py's KeyShardMap). */

/* Byte-lexicographic compare, shorter key first on a common prefix. */
static inline int key_cmp(const uint8_t *a, int64_t alen,
                          const uint8_t *b, int64_t blen) {
    int64_t m = alen < blen ? alen : blen;
    int c = memcmp(a, b, (size_t)m);
    if (c) return c;
    return (alen > blen) - (alen < blen);
}

/* The shard of key k: the count of split keys <= k (an upper bound by
 * binary search). */
static inline int64_t shard_of(const uint8_t *k, int64_t klen,
                               const uint8_t *splits, const int64_t *soffs,
                               int64_t n_splits) {
    int64_t lo = 0, hi = n_splits;
    while (lo < hi) {
        int64_t mid = (lo + hi) / 2;
        if (key_cmp(splits + soffs[mid], soffs[mid + 1] - soffs[mid], k, klen) <= 0)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

/* Pass 1, sharded: per-(txn, shard) POINT row counts into rp_cnt / wp_cnt
 * [ntxn * S], row-major by txn, which the caller zeroes. Returns 0, or 1
 * where conflict_counts would (the general router takes the batch). */
int conflict_counts_sharded(const uint8_t *blob, const int64_t *offs,
                            int64_t ntxn, int64_t max_key_bytes,
                            const uint8_t *splits, const int64_t *soffs,
                            int64_t n_splits,
                            int32_t *rp_cnt, int32_t *wp_cnt) {
    const int64_t S = n_splits + 1;
    for (int64_t t = 0; t < ntxn; t++) {
        const uint8_t *p = blob + offs[t];
        const uint8_t *end = blob + offs[t + 1];
        if (end - p < 8) return 1;
        uint32_t nr, nw;
        memcpy(&nr, p, 4);
        memcpy(&nw, p + 4, 4);
        p += 8;
        for (uint32_t i = 0; i < nr + nw; i++) {
            if (end - p < 4) return 1;
            uint32_t hdr;
            memcpy(&hdr, p, 4);
            p += 4;
            uint32_t kind = hdr >> 30;
            int64_t blen = hdr & 0x3fffffff;
            if (kind != 0 || blen > max_key_bytes) return 1;
            if (p + blen > end) return 1;
            int64_t s = shard_of(p, blen, splits, soffs, n_splits);
            if (i < nr) rp_cnt[t * S + s]++;
            else        wp_cnt[t * S + s]++;
            p += blen;
        }
    }
    return 0;
}

/* Pass 2, sharded: POINT rows of txns [t0, t1) into S padded regions:
 * shard s's read rows at rpb + s * rp_cap * (key_words+1), its txns at
 * rp_txn + s * rp_cap, and likewise for writes with wp_cap. skip[t] != 0
 * contributes no rows. out_n[2s] / out_n[2s+1] receive shard s's read /
 * write row counts. Rows stay txn-ascending inside each region. */
void build_point_rows_sharded(const uint8_t *blob, const int64_t *offs,
                              int64_t t0, int64_t t1, const uint8_t *skip,
                              int64_t key_words,
                              const uint8_t *splits, const int64_t *soffs,
                              int64_t n_splits,
                              int64_t rp_cap, int64_t wp_cap,
                              uint32_t *rpb, int32_t *rp_txn,
                              uint32_t *wpb, int32_t *wp_txn,
                              int64_t *out_n) {
    const int64_t S = n_splits + 1;
    const int64_t stride = key_words + 1;
    for (int64_t s = 0; s < 2 * S; s++) out_n[s] = 0;
    for (int64_t t = t0; t < t1; t++) {
        if (skip[t]) continue;
        const uint8_t *p = blob + offs[t];
        uint32_t nr, nw;
        memcpy(&nr, p, 4);
        memcpy(&nw, p + 4, 4);
        p += 8;
        const int32_t ti = (int32_t)(t - t0);
        for (uint32_t i = 0; i < nr + nw; i++) {
            uint32_t hdr;
            memcpy(&hdr, p, 4);
            p += 4;
            int64_t blen = hdr & 0x3fffffff;
            int64_t s = shard_of(p, blen, splits, soffs, n_splits);
            if (i < nr) {
                int64_t r = out_n[2 * s]++;
                pack_one(p, blen, key_words, rpb + (s * rp_cap + r) * stride);
                rp_txn[s * rp_cap + r] = ti;
            } else {
                int64_t w = out_n[2 * s + 1]++;
                pack_one(p, blen, key_words, wpb + (s * wp_cap + w) * stride);
                wp_txn[s * wp_cap + w] = ti;
            }
            p += blen;
        }
    }
}
