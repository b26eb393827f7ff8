// Native C++ ConflictSet engine — the CPU-resolver half of the framework's
// runtime (the role fdbserver/SkipList.cpp plays in the reference; here an
// ordered boundary map, which is the skip list's observable state, see
// ops/oracle.py for the shared logical model this must match bit-for-bit).
//
// Exposed through a plain C ABI and loaded via ctypes (native/build.py) —
// pybind11 is not in this environment. Batches arrive in the columnar
// conflict-wire format (core/wire.py conflict_wire): the same bytes the
// client serialized, parsed once here with zero Python-object overhead.
//
//   block  := [u32 n_read][u32 n_write] range*
//   range  := [u32 hdr = len | kind<<30][len bytes]            kind 0: point
//           | [u32 hdr][len bytes][u32 elen][elen bytes]       kind 1: range
//           | [u32 hdr][len bytes]                             kind 2: empty
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

using Key = std::string;

constexpr uint32_t kLenMask = (1u << 30) - 1;
constexpr int64_t kNegInf = INT64_MIN / 2;

enum Status : uint8_t { kConflict = 0, kTooOld = 1, kCommitted = 2 };

// Piecewise-constant map key -> version; first boundary is always "".
// (VersionIntervalMap in ops/oracle.py; the reference skip list's
// observable state, SkipList.cpp:350-:665.)
struct IntervalMap {
  std::map<Key, int64_t> m;

  explicit IntervalMap(int64_t v) { m.emplace(Key(), v); }

  int64_t version_at(const Key& k) const {
    auto it = m.upper_bound(k);
    --it;
    return it->second;
  }

  int64_t version_strictly_below(const Key& k) const {
    auto it = m.lower_bound(k);          // first >= k
    if (it != m.begin()) --it;           // last < k (or the "" boundary)
    return it->second;
  }

  int64_t range_max(const Key& b, const Key& e) const {
    auto lo = m.upper_bound(b);
    --lo;                                // interval containing b
    auto hi = m.lower_bound(e);          // first boundary >= e
    int64_t mx = kNegInf;
    for (auto it = lo; it != hi; ++it)
      if (it->second > mx) mx = it->second;
    return mx;
  }

  void write(const Key& b, const Key& e, int64_t v) {
    if (b >= e) return;
    int64_t v_end = version_at(e);
    auto lo = m.lower_bound(b);
    auto hi = m.lower_bound(e);
    m.erase(lo, hi);
    m[b] = v;
    if (m.find(e) == m.end()) m.emplace(e, v_end);
  }

  // Keep rule from removeBefore (SkipList.cpp:686-698): a boundary
  // survives iff its version or its ORIGINAL predecessor's is >= oldest.
  void gc(int64_t oldest) {
    auto it = m.begin();
    int64_t prev = it->second;
    ++it;
    while (it != m.end()) {
      int64_t cur = it->second;
      if (cur >= oldest || prev >= oldest) {
        ++it;
      } else {
        it = m.erase(it);
      }
      prev = cur;
    }
  }
};

struct Engine {
  IntervalMap map;
  int64_t oldest_version = 0;

  explicit Engine(int64_t v) : map(v) {}
};

struct Range {
  const uint8_t* b;
  uint32_t blen;
  const uint8_t* e;  // nullptr for point (end = begin + '\0') / empty kinds
  uint32_t elen;
  uint8_t kind;      // 0 point, 1 range, 2 empty
};

inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

bool parse_block(const uint8_t* p, const uint8_t* end, std::vector<Range>* reads,
                 std::vector<Range>* writes) {
  if (end - p < 8) return false;
  uint32_t nr = rd32(p), nw = rd32(p + 4);
  p += 8;
  for (uint32_t i = 0; i < nr + nw; ++i) {
    if (end - p < 4) return false;
    uint32_t hdr = rd32(p);
    p += 4;
    Range r;
    r.kind = hdr >> 30;
    r.blen = hdr & kLenMask;
    if ((uint32_t)(end - p) < r.blen) return false;
    r.b = p;
    p += r.blen;
    r.e = nullptr;
    r.elen = 0;
    if (r.kind == 1) {
      if (end - p < 4) return false;
      r.elen = rd32(p);
      p += 4;
      if ((uint32_t)(end - p) < r.elen) return false;
      r.e = p;
      p += r.elen;
    }
    (i < nr ? reads : writes)->push_back(r);
  }
  return true;
}

inline Key key_of(const uint8_t* p, uint32_t n) { return Key((const char*)p, n); }

inline Key end_key(const Range& r) {
  if (r.kind == 1) return key_of(r.e, r.elen);
  Key k = key_of(r.b, r.blen);
  if (r.kind == 0) k.push_back('\0');  // point: [k, k+'\0')
  return k;                            // empty: [k, k)
}

}  // namespace

extern "C" {

void* cse_new(int64_t initial_version) { return new Engine(initial_version); }

void cse_free(void* h) { delete static_cast<Engine*>(h); }

void cse_clear(void* h, int64_t version) {
  auto* e = static_cast<Engine*>(h);
  e->map = IntervalMap(version);
}

int64_t cse_boundary_count(void* h) {
  return (int64_t)static_cast<Engine*>(h)->map.m.size();
}

// Resolve one ordered batch. blob holds n concatenated conflict-wire
// blocks; offs[n+1] delimits them; snaps[n] are read snapshots. Writes one
// status byte per transaction. Returns 0 on success, -1 on a malformed
// block (no state changed in that case).
int cse_resolve(void* h, const uint8_t* blob, const int64_t* offs, int n,
                const int64_t* snaps, int64_t now, int64_t new_oldest,
                uint8_t* out) {
  auto* eng = static_cast<Engine*>(h);

  std::vector<std::vector<Range>> reads(n), writes(n);
  for (int t = 0; t < n; ++t) {
    if (!parse_block(blob + offs[t], blob + offs[t + 1], &reads[t], &writes[t]))
      return -1;
  }

  std::vector<uint8_t> status(n, kCommitted);

  // too-old gate (SkipList.cpp:985): reads below the horizon
  for (int t = 0; t < n; ++t)
    if (snaps[t] < eng->oldest_version && !reads[t].empty()) status[t] = kTooOld;

  // reads vs. history (checkReadConflictRanges:1210)
  for (int t = 0; t < n; ++t) {
    if (status[t] != kCommitted) continue;
    for (const Range& r : reads[t]) {
      Key b = key_of(r.b, r.blen);
      bool hit;
      if (r.kind == 2) {
        hit = eng->map.version_strictly_below(b) > snaps[t];
      } else {
        hit = eng->map.range_max(b, end_key(r)) > snaps[t];
      }
      if (hit) {
        status[t] = kConflict;
        break;
      }
    }
  }

  // intra-batch, submission order, earlier wins
  // (checkIntraBatchConflicts:1133): committed writes accumulate in a
  // boolean interval map; a later read conflicts iff it overlaps any.
  IntervalMap written(0);
  bool any_written = false;
  for (int t = 0; t < n; ++t) {
    if (status[t] != kCommitted) continue;
    if (any_written) {
      bool hit = false;
      for (const Range& r : reads[t]) {
        if (r.kind == 2) continue;  // empty ranges never intra-conflict
        Key b = key_of(r.b, r.blen);
        if (written.range_max(b, end_key(r)) > 0) {
          hit = true;
          break;
        }
      }
      if (hit) {
        status[t] = kConflict;
        continue;
      }
    }
    for (const Range& w : writes[t]) {
      Key b = key_of(w.b, w.blen);
      Key e = end_key(w);
      if (b < e) {
        written.write(b, e, 1);
        any_written = true;
      }
    }
  }

  // apply committed writes at `now` (mergeWriteConflictRanges:1260)
  for (int t = 0; t < n; ++t) {
    if (status[t] != kCommitted) continue;
    for (const Range& w : writes[t])
      eng->map.write(key_of(w.b, w.blen), end_key(w), now);
  }

  // advance the horizon + GC (detectConflicts:1199-1206)
  if (new_oldest > eng->oldest_version) {
    eng->oldest_version = new_oldest;
    eng->map.gc(new_oldest);
  }

  std::memcpy(out, status.data(), n);
  return 0;
}

}  // extern "C"
