// The gather-SpMMs of the static-shape sparse node operand
// (ops/ell_cols.ChunkColsAOp), for Hopper (sm_90a): a chunk pass for W'A and
// a keyless segmented pass for A H'.
//
// It replaces no Pallas kernel.  The JAX package computes these products in
// XLA (smallk_tpu/ops/ell_cols.py, GatheredColsAOp.mm_tn / mm_nt: a gather
// of factor rows, an einsum, a sorted jax.ops.segment_sum).  It was written
// because a measurement on the H100 showed that a hand kernel pays there:
// that formulation in torch ops (torch.segment_reduce) took 63.4 ms for the
// root's A H' at 50,000 x 1,000,000 and k = 2 (chip_smoke.py --cols,
// PERF.md).  Both passes compute
//
//     out[key, :] = sum of val[e] * table[gather[e], :] over the key's entries
//
// with gather[e] >= B (or < 0) the padding sentinel, contributing nothing:
//
//   - seg_chunks (W'A): key = a document slot s of the width.  Its entries
//     are the live ones of chunks [starts[s], starts[s+1]) of L0 entries
//     each, chunk c holding lens[c] live entries at its head.  Every slot
//     of the width is written, a slot with no chunk as zeros.
//   - seg_terms (A H'): key = a term r.  Its entries are [ptr[r], ptr[r+1])
//     of the term-sorted stream (ptr[0] = 0, ascending); no per-entry key
//     is read.  seg_carry, a second launch, finishes the terms that cross a
//     block's range.  Every term is written, one with no entry as zeros.
//
// The live counts (starts[n_slots], ptr[n_out]) are read on the device, so
// a launch's shape depends on the capacities alone and one captured CUDA
// graph serves every node of a width.  Row and transposed output are one
// kernel with the output's strides.
//
// Types (vals, table -> sums): (f32, f32), (bf16, f32), (e4m3, f32) -> f32;
// (f64, f64) -> f64.  bf16 and e4m3 are widened in registers.  k <= 8,
// instantiated at KM = 1, 2, 4, 8 columns with the table's k at run time.
//
// What bounds it on the card: the entry stream and the table's rows.  Each
// live entry reads its gather index and its value once (6 bytes at bf16)
// and one k-wide table row from a random place (8 bytes at k = 2 in f32,
// a 32-byte sector from L1 or L2), against 2k flops: 2k operations per 6
// bytes, far below the ~295 a byte at which the card's tensor cores, or its
// FP32 units, would bind.  So tensor cores do not apply; the design is
// about bytes, sectors and the latency of dependent loads:
//
//   - W'A reads no padding.  A warp takes a contiguous run of slots, cut
//     from the merge path of slots and chunks so that every warp has about
//     as many slots plus chunks as any other, and walks each slot's chunks
//     in chunk order, 128 entries a step, 4 consecutive entries a lane (16
//     bytes of rows, 8 bytes of bf16 values).  A lane loads only its live
//     entries: none when its 4 start at or past its chunk's live length,
//     one by one when they run past it, so no load reads past a chunk's
//     live length.  The entries stream past L1 (ld.global.cs), which keeps
//     L1 for W (400 KB at the sparse hierclust corpus's 50,000 terms and
//     k = 2).  The slot is summed in registers, then by a fixed xor
//     butterfly, and written whole: no head or tail buffers, no zeroed
//     output.  No shared memory: a ring of cp.async copies here (2 or 4
//     steps a warp) and loads issued a step ahead were both slower on the
//     card, since its shared memory is taken from L1 and the warps' own
//     loads are in flight in parallel (PERF.md).
//   - A H' reads no key.  A warp takes a contiguous run of tiles of 32 x VL
//     entries, fed by asynchronous copies: 16-byte cp.async (.cg, past L1)
//     into the warp's ring of 2 tiles in shared memory, so the next tile's
//     entries are in flight while the current one is reduced.  A tile goes
//     in two phases.  First an entry a lane, 32 consecutive a round: a
//     frequent term's entries have ascending slots, so its table rows are
//     read coalesced, and each lane keeps its term and that term's end
//     (ptr[r + 1]), moving on by a galloping search in ptr only when its
//     entry passes that end; the products and terms go to shared memory.
//     Then VL consecutive entries a lane, summed term by term in registers:
//     a lane writes the terms that begin and end in it, and its first and
//     last partials go to one segmented warp scan a tile, with the warp's
//     carry from its tile before in front.  Warps share nothing and never
//     wait for one another.  A term that crosses a warp's run is cut into
//     the head partial of each run it enters and the tail partial of the
//     run where it starts; seg_carry adds them in run order.  The load is
//     balanced whatever the keys (the corpus's most frequent term spans
//     thousands of tiles).
//   - No floating-point atomics: every sum has a fixed order, so two
//     launches, and eager and captured ones, give equal bits.  Blocks are
//     persistent: the grid is the card's SMs times the blocks that fit on
//     one, capped by the capacity, so a launch's shape, and its sums' order,
//     depend on the capacity and the card alone.  A warp finds its first
//     slot or term with all its lanes, 32 places a round.
//   - A table row of an even k at unit column stride is read as pairs
//     (float2 / double2): one 8-byte load a row at k = 2 in f32.

#include <cstring>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStep = 128;       // entries of a warp's step in seg_chunks
constexpr int kRing = 2;         // seg_terms' ring of tiles, a warp
constexpr int kCarryThreads = 128;
constexpr int kNoKey = 0x7fffffff;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// N consecutive values read from shared memory as one vector load (or a
// few 16-byte ones).
template <typename V, int N>
struct alignas(N * sizeof(V) >= 16 ? 16 : N * sizeof(V)) Vec {
  V v[N];
};
template <typename V, int N>
__device__ __forceinline__ Vec<V, N> load_vec(const V* p) {
  return *reinterpret_cast<const Vec<V, N>*>(p);
}

// Streaming loads (evict first, past L1) of a lane's `live` leading
// entries of 4: one vector load when all 4 are live, else one load an
// entry, so that nothing past the live ones is read.
__device__ __forceinline__ void load_rows4(const int* p, int live,
                                           int (&g)[4]) {
  if (live == 4) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
    g[0] = v.x;
    g[1] = v.y;
    g[2] = v.z;
    g[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) g[j] = j < live ? __ldcs(p + j) : -1;
  }
}
template <typename V>
__device__ __forceinline__ V load_one(const V* p) {
  if constexpr (sizeof(V) == 8) {
    return __ldcs(p);
  } else if constexpr (sizeof(V) == 4) {
    return __ldcs(p);
  } else {
    using U = typename std::conditional<sizeof(V) == 2, unsigned short,
                                        unsigned char>::type;
    const U bits = __ldcs(reinterpret_cast<const U*>(p));
    V v;
    memcpy(&v, &bits, sizeof(V));
    return v;
  }
}
template <typename V>
__device__ __forceinline__ void load_vals4(const V* p, int live,
                                           V (&x)[4]) {
  if (live == 4) {
    if constexpr (sizeof(V) == 1) {
      const unsigned u = __ldcs(reinterpret_cast<const unsigned*>(p));
      memcpy(x, &u, 4);
    } else if constexpr (sizeof(V) == 2) {
      const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
      memcpy(x, &u, 8);
    } else {
      const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
      for (int i = 0; i < (int)sizeof(V) / 4; ++i) {
        const uint4 u = __ldcs(q + i);
        memcpy(reinterpret_cast<char*>(x) + 16 * i, &u, 16);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < live) x[j] = load_one(p + j);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An asynchronous 16-byte copy that reads only the first `src_bytes` of
// its source and zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row g of the table, its first k of KM columns (the rest 0).
template <typename T, typename Acc, int KM>
__device__ __forceinline__ void table_row(const T* table, long long g,
                                          long long ld_row, long long ld_col,
                                          int k, bool pairs, Acc (&r)[KM]) {
  const T* row = table + g * ld_row;
  if constexpr (KM % 2 == 0) {
    if (pairs) {
      const auto* p = reinterpret_cast<const typename Pair<T>::type*>(row);
#pragma unroll
      for (int c = 0; c < KM; c += 2) {
        if (c < k) {
          const auto v = __ldg(p + c / 2);
          r[c] = (Acc)v.x;
          r[c + 1] = (Acc)v.y;
        } else {
          r[c] = r[c + 1] = Acc(0);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < KM; ++c)
    r[c] = c < k ? (Acc)__ldg(row + c * ld_col) : Acc(0);
}

template <typename Acc, int KM>
__device__ __forceinline__ void store_row(Acc* out, long long key,
                                          long long out_row,
                                          long long out_col, int k,
                                          const Acc (&v)[KM]) {
  Acc* dst = out + key * out_row;
#pragma unroll
  for (int c = 0; c < KM; ++c)
    if (c < k) dst[c * out_col] = v[c];
}

// ---------------------------------------------------------------------------
// W'A: a slot a warp, its chunks' live entries only.

struct ChunkArgs {
  const int* starts;  // (n_slots + 1) each slot's first chunk, ascending
  const int* lens;    // live entries of each chunk
  const int* rows;    // (chunks << shift) gather indices
  const void* vals;
  int shift;          // log2 of the chunk length L0 (>= 2)
  const void* table;
  long long ld_row, ld_col;
  int B, k;
  bool pairs;
  void* out;
  long long out_row, out_col;
  int n_slots;
};

// The smallest i in [0, n] with pred(i), pred rising from false to true
// and pred(n) taken as true, found by a whole warp: each round its lanes
// test 32 evenly spaced places, so a search over a million places waits on
// 4-5 loads one after another, not 20.
template <typename Pred>
__device__ __forceinline__ int warp_search(int n, Pred pred) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;
  while (lo < hi) {  // warp-uniform
    const int step = (hi - lo + 31) / 32;
    const int p = min(lo + lane * step, hi);
    const unsigned hit = __ballot_sync(kFull, p >= hi || pred(p));
    if (hit == 0u) {
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(hit) - 1;
    hi = min(lo + f * step, hi);
    lo = f == 0 ? lo : lo + (f - 1) * step + 1;
  }
  return lo;
}

template <typename V, typename T, typename Acc, int KM>
__global__ void __launch_bounds__(kThreads) seg_chunks(ChunkArgs a) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = a.n_slots;
  const V* val = static_cast<const V*>(a.vals);
  const T* table = static_cast<const T*>(a.table);
  Acc* out = static_cast<Acc*>(a.out);
  const int shift = a.shift;
  const long long mask = (1LL << shift) - 1;

  // the warp's slots [s0, s1): slot s belongs to the warp whose share of
  // the merge path [0, n + starts[n]) holds s + starts[s]
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  const long long nw = (long long)gridDim.x * kWarps;
  const long long total = n + (long long)__ldcg(a.starts + n);
  const long long d0 = gw * total / nw, d1 = (gw + 1) * total / nw;
  const int s0 = warp_search(
      n, [&](int s) { return s + (long long)__ldcg(a.starts + s) >= d0; });
  const int s1 = warp_search(
      n, [&](int s) { return s + (long long)__ldcg(a.starts + s) >= d1; });

  Acc acc[KM];
  for (int slot = s0; slot < s1; ++slot) {
    const long long c0 = (long long)__ldcg(a.starts + slot) << shift;
    const long long c1 = (long long)__ldcg(a.starts + slot + 1) << shift;
#pragma unroll
    for (int c = 0; c < KM; ++c) acc[c] = Acc(0);
    for (long long pe = c0; pe < c1; pe += kStep) {
      const long long e = pe + 4 * lane;
      const int live =
          e < c1 ? min(max(__ldcg(a.lens + (e >> shift)) - (int)(e & mask), 0),
                       4)
                 : 0;
      if (live > 0) {
        int g[4];
        V xs[4];
        load_rows4(a.rows + e, live, g);
        load_vals4(val + e, live, xs);
        Acc row[4][KM];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < live && g[j] >= 0 && g[j] < a.B) {
            table_row<T, Acc, KM>(table, g[j], a.ld_row, a.ld_col, a.k,
                                  a.pairs, row[j]);
          } else {
#pragma unroll
            for (int c = 0; c < KM; ++c) row[j][c] = Acc(0);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const Acc x = j < live ? (Acc)widen(xs[j]) : Acc(0);
#pragma unroll
          for (int c = 0; c < KM; ++c) acc[c] += x * row[j][c];
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int c = 0; c < KM; ++c)
        acc[c] += __shfl_xor_sync(kFull, acc[c], off);
    Acc mine = acc[0];
#pragma unroll
    for (int c = 1; c < KM; ++c)
      if (lane == c) mine = acc[c];
    if (lane < a.k) out[slot * a.out_row + lane * a.out_col] = mine;
  }
}

// ---------------------------------------------------------------------------
// A H': a warp a contiguous run of tiles of 32 x VL entries.

struct TermArgs {
  const int* ptr;  // (n_out + 1) each term's first entry; ptr[0] = 0
  const int* gather;
  const void* val;
  const void* table;
  long long ld_row, ld_col;
  int B, k;
  bool pairs;
  void* out;
  long long out_row, out_col;
  int n_out;
  void* carries;  // head partials (units, KM), then tail partials (units, KM)
  long long cap;
};

// The largest term r in [lo, n_out) with ptr[r] <= e, given ptr[lo] <= e <
// ptr[n_out]: a galloping search from lo.
__device__ __forceinline__ int term_of(const int* ptr, int lo, int n_out,
                                       long long e) {
  int r = lo, step = 1;
  while (r + step < n_out && __ldg(ptr + r + step) <= e) {
    r += step;
    step <<= 1;
  }
  while (step > 1) {
    step >>= 1;
    if (r + step < n_out && __ldg(ptr + r + step) <= e) r += step;
  }
  return r;
}

// Entries a lane: 8, or 4 where a lane's products would take too many
// registers.
template <typename Acc, int KM>
__host__ __device__ constexpr int term_vl() {
  return KM * (int)sizeof(Acc) <= 16 ? 8 : 4;
}
// A lane's products in shared memory, padded by 16 bytes so that the
// lanes' vector reads fall in different banks.
template <typename Acc, int KM>
__host__ __device__ constexpr int term_row() {
  return term_vl<Acc, KM>() * KM + 16 / (int)sizeof(Acc);
}

// A warp's shared memory: its ring of tiles (gather indices, values) and
// its tile's products.
template <typename V, typename Acc, int KM>
__host__ __device__ constexpr int term_warp_smem() {
  return kRing * 32 * term_vl<Acc, KM>() * (4 + (int)sizeof(V)) +
         32 * term_row<Acc, KM>() * (int)sizeof(Acc);
}

// A unit's (a warp's) contiguous run of tiles and its entries [lo, hi).
struct Range {
  long long lo, hi;
  bool empty;
};
__device__ __forceinline__ Range unit_range(long long u, long long units,
                                            long long n_live, int tile) {
  const long long tiles = (n_live + tile - 1) / tile;
  const long long t0 = u * tiles / units, t1 = (u + 1) * tiles / units;
  return {t0 * tile, min(t1 * tile, n_live), t0 >= t1};
}

template <typename V, typename T, typename Acc, int KM>
__global__ void __launch_bounds__(kThreads) seg_terms(TermArgs a) {
  constexpr int VL = term_vl<Acc, KM>();
  constexpr int WT = 32 * VL;  // a warp's tile
  constexpr int ROW = term_row<Acc, KM>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned char* mine = smem + warp * term_warp_smem<V, Acc, KM>();
  int* g_ring = reinterpret_cast<int*>(mine);
  V* v_ring = reinterpret_cast<V*>(mine + kRing * WT * 4);
  Acc* prods =
      reinterpret_cast<Acc*>(mine + kRing * WT * (4 + (int)sizeof(V)));

  const int n_out = a.n_out;
  const int* ptr = a.ptr;
  const V* val = static_cast<const V*>(a.val);
  const T* table = static_cast<const T*>(a.table);
  Acc* out = static_cast<Acc*>(a.out);
  const long long n_live = min((long long)__ldg(ptr + n_out), a.cap);

  // terms with no entry are zeros; every other term is written once below
  for (long long r = (long long)blockIdx.x * kThreads + tid; r < n_out;
       r += (long long)gridDim.x * kThreads) {
    if (__ldg(ptr + r) == __ldg(ptr + r + 1)) {
      Acc z[KM];
#pragma unroll
      for (int c = 0; c < KM; ++c) z[c] = Acc(0);
      store_row<Acc, KM>(out, r, a.out_row, a.out_col, a.k, z);
    }
  }
  const long long u = (long long)blockIdx.x * kWarps + warp;
  const long long units = (long long)gridDim.x * kWarps;
  const Range ur = unit_range(u, units, n_live, WT);
  if (ur.empty) return;  // warp-uniform; no block barrier follows
  const long long t0 = ur.lo / WT, t1 = (ur.hi + WT - 1) / WT;
  Acc* head = static_cast<Acc*>(a.carries) + u * KM;
  Acc* tail = head + units * KM;

  // copies tile t's live entries into stage st, 16 bytes a copy
  auto issue = [&](long long t, int st) {
    if (t < t1) {
      const long long ts = t * WT;
#pragma unroll
      for (int p = lane; p < WT / 4; p += 32) {
        const long long left = n_live - (ts + 4 * p);
        if (left > 0)
          cp_async16(g_ring + st * WT + 4 * p, a.gather + ts + 4 * p,
                     (int)min(left, 4LL) * 4);
      }
      constexpr int per = 16 / (int)sizeof(V);
#pragma unroll
      for (int p = lane; p < WT / per; p += 32) {
        const long long left = n_live - (ts + per * p);
        if (left > 0)
          cp_async16(v_ring + st * WT + per * p, val + ts + per * p,
                     (int)min(left, (long long)per) * (int)sizeof(V));
      }
    }
    cp_commit();
  };

  // the term open at the unit's start, if it began before it: the only
  // one whose total goes to the unit's head partial
  const int first_term =
      warp_search(n_out, [&](int r) { return __ldg(ptr + r) > ur.lo; }) - 1;
  const int head_term = __ldg(ptr + first_term) < ur.lo ? first_term : -1;
  int hint = first_term;  // a term no later than the tile's first entry's
  Acc carry[KM];          // the partial open at the tile's start
#pragma unroll
  for (int c = 0; c < KM; ++c) carry[c] = Acc(0);
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) issue(t0 + i, i);
  for (long long t = t0; t < t1; ++t) {
    const int st = (int)((t - t0) % kRing);
    issue(t + kRing - 1, (int)((t - t0 + kRing - 1) % kRing));
    cp_wait<kRing - 1>();
    __syncwarp();
    const long long ws = t * WT;
    const long long we = min(ws + WT, ur.hi);
    int* keys = g_ring + st * WT;
    const V* vals = v_ring + st * WT;

    // phase 1, an entry a lane, 32 consecutive a round: the products (the
    // table rows of a frequent term read coalesced) and each entry's term,
    // into shared memory, the term over the entry's gather index
    Acc prod[VL][KM];
#pragma unroll
    for (int j = 0; j < VL; ++j) {
      const int i = 32 * j + lane;
      const int g = keys[i];
      if (ws + i < we && g >= 0 && g < a.B) {
        table_row<T, Acc, KM>(table, g, a.ld_row, a.ld_col, a.k, a.pairs,
                              prod[j]);
        const Acc x = (Acc)widen(vals[i]);
#pragma unroll
        for (int c = 0; c < KM; ++c) prod[j][c] *= x;
      } else {
#pragma unroll
        for (int c = 0; c < KM; ++c) prod[j][c] = Acc(0);
      }
    }
    int key = term_of(ptr, hint, n_out, ws);
    long long nb = __ldg(ptr + key + 1);
#pragma unroll
    for (int j = 0; j < VL; ++j) {
      const int i = 32 * j + lane;
      const long long e = ws + i;
      int kj = kNoKey;
      if (e < we) {
        if (e >= nb) {
          key = term_of(ptr, key + 1, n_out, e);
          nb = __ldg(ptr + key + 1);
        }
        kj = key;
      }
      keys[i] = kj;
      Acc* dst = prods + (i / VL) * ROW + (i % VL) * KM;
#pragma unroll
      for (int c = 0; c < KM; ++c) dst[c] = prod[j][c];
    }
    hint = __shfl_sync(kFull, key, 31);  // the tile's last entry's term
    __syncwarp();

    // phase 2, VL consecutive entries a lane: terms that begin and end in
    // the lane are written here; the lane's first term (`first`, closed or
    // not) and the partial open at its end (xv, with xf set where that term
    // began in the lane or there is none) go to the scan
    const long long ea = ws + lane * VL;
    const long long eb = min(ea + VL, we);
    const Vec<int, VL> ks = load_vec<int, VL>(keys + lane * VL);
    const Vec<Acc, VL * KM> ps = load_vec<Acc, VL * KM>(prods + lane * ROW);
    Acc first[KM], cur[KM], xv[KM];
#pragma unroll
    for (int c = 0; c < KM; ++c) first[c] = cur[c] = xv[c] = Acc(0);
    int rf = ks.v[0], xf = 1;
    bool closed = false, before = false;
    if (ea < eb) {
      // did the first term begin before the lane, and does the last end
      // with it: the neighbouring entries' terms, or ptr at the tile's ends
      before = lane == 0 ? __ldg(ptr + rf) < ea : keys[lane * VL - 1] == rf;
      bool in_first = true;
      int r = rf;
      auto close = [&]() {
        if (in_first) {
#pragma unroll
          for (int c = 0; c < KM; ++c) first[c] = cur[c];
          closed = true;
          in_first = false;
        } else {
          store_row<Acc, KM>(out, r, a.out_row, a.out_col, a.k, cur);
        }
      };
#pragma unroll
      for (int j = 0; j < VL; ++j) {
        if (ea + j < eb) {
          if (ks.v[j] != r) {  // term r ended at the entry before
            close();
            r = ks.v[j];
#pragma unroll
            for (int c = 0; c < KM; ++c) cur[c] = Acc(0);
          }
#pragma unroll
          for (int c = 0; c < KM; ++c) cur[c] += ps.v[j * KM + c];
        }
      }
      const bool ends = eb < we ? keys[lane * VL + VL] != r
                                : __ldg(ptr + r + 1) == eb;
      if (ends) {
        close();  // the lane's last term ends at its last entry
      } else if (in_first) {
#pragma unroll
        for (int c = 0; c < KM; ++c) first[c] = xv[c] = cur[c];
        xf = !before;
      } else {
#pragma unroll
        for (int c = 0; c < KM; ++c) xv[c] = cur[c];
      }
    }

    // segmented inclusive scan of (xv, xf) over the warp, then the tile's
    // carry in front: each lane's carry-in, and the next tile's carry
    Acc sv[KM];
#pragma unroll
    for (int c = 0; c < KM; ++c) sv[c] = xv[c];
    int sf = xf;
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const int of = __shfl_up_sync(kFull, sf, dd);
#pragma unroll
      for (int c = 0; c < KM; ++c) {
        const Acc o = __shfl_up_sync(kFull, sv[c], dd);
        if (lane >= dd && !sf) sv[c] = o + sv[c];
      }
      if (lane >= dd) sf |= of;
    }
    const int ef = __shfl_up_sync(kFull, sf, 1);
    const int f31 = __shfl_sync(kFull, sf, 31);
#pragma unroll
    for (int c = 0; c < KM; ++c) {
      const Acc ev = __shfl_up_sync(kFull, sv[c], 1);
      const Acc s31 = __shfl_sync(kFull, sv[c], 31);
      const Acc cin = lane == 0 ? carry[c] : (ef ? ev : carry[c] + ev);
      if (closed) first[c] = before ? cin + first[c] : first[c];
      carry[c] = f31 ? s31 : carry[c] + s31;
    }
    if (closed) {
      // the lane's first term ends here, with what came before the lane
      if (rf == head_term) {
#pragma unroll
        for (int c = 0; c < KM; ++c) head[c] = first[c];
      } else {
        store_row<Acc, KM>(out, rf, a.out_row, a.out_col, a.k, first);
      }
    }
    __syncwarp();  // the stage is read before it is copied into again
  }
  cp_wait<0>();
  if (lane == 0 && ur.hi < n_live) {
    // the term open at the unit's end: a pass-through unit's head, or the
    // tail of the unit where it began
    const int rk = term_of(ptr, hint, n_out, ur.hi - 1);
    if (__ldg(ptr + rk + 1) > ur.hi) {
      Acc* dst = rk == head_term ? head : tail;
#pragma unroll
      for (int c = 0; c < KM; ++c) dst[c] = carry[c];
    }
  }
}

// A warp a unit of seg_terms: the term that begins in unit u and runs
// past its end gets u's tail partial plus the head partials of the units
// it enters, in unit order.
template <typename Acc, int KM>
__global__ void __launch_bounds__(kCarryThreads) seg_carry(TermArgs a,
                                                           int units,
                                                           int tile) {
  const long long u =
      ((long long)blockIdx.x * kCarryThreads + threadIdx.x) / 32;
  if (u >= units) return;  // warp-uniform
  const int* ptr = a.ptr;
  const long long n_live = min((long long)__ldg(ptr + a.n_out), a.cap);
  const Range ur = unit_range(u, units, n_live, tile);
  if (ur.empty || ur.hi >= n_live) return;
  const int rk =
      warp_search(a.n_out, [&](int r) { return __ldg(ptr + r) >= ur.hi; }) -
      1;
  const long long end = __ldg(ptr + rk + 1);
  if ((threadIdx.x & 31) != 0 || __ldg(ptr + rk) < ur.lo || end <= ur.hi)
    return;
  const Acc* head = static_cast<const Acc*>(a.carries);
  const Acc* tail = head + (long long)units * KM;
  Acc s[KM];
#pragma unroll
  for (int c = 0; c < KM; ++c) s[c] = tail[u * KM + c];
  for (long long j = u + 1; j < units; ++j) {
    const Range rj = unit_range(j, units, n_live, tile);
    if (rj.empty) continue;
#pragma unroll
    for (int c = 0; c < KM; ++c) s[c] += head[j * KM + c];
    if (end <= rj.hi) break;
  }
  store_row<Acc, KM>(static_cast<Acc*>(a.out), rk, a.out_row, a.out_col,
                     a.k, s);
}

// ---------------------------------------------------------------------------
// Launches.

int sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  return sms;
}

// A persistent grid: the SMs times the blocks of `kernel` that fit on one,
// capped by `want`; 0 on an error.
template <typename K>
long long persistent_grid(K kernel, int threads, int smem, int device,
                          long long want) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  const long long fit = (long long)(per_sm > 1 ? per_sm : 1) *
                        sm_count(device);
  return want < fit ? want : fit;
}

template <typename V, typename T, typename Acc, int KM>
int launch_chunks(const ChunkArgs& a, int device, cudaStream_t stream) {
  auto kernel = seg_chunks<V, T, Acc, KM>;
  const long long want = a.n_slots > kWarps
                             ? ((long long)a.n_slots + kWarps - 1) / kWarps
                             : 1;
  const long long grid = persistent_grid(kernel, kThreads, 0, device, want);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename V, typename T, typename Acc, int KM>
int launch_terms(const TermArgs& a, long long carry_cap, int device,
                 cudaStream_t stream) {
  constexpr int smem = kWarps * term_warp_smem<V, Acc, KM>();
  constexpr int tile = 32 * term_vl<Acc, KM>();
  constexpr int block = kThreads / 32 * tile;
  auto kernel = seg_terms<V, T, Acc, KM>;
  const long long want = a.cap > block ? (a.cap + block - 1) / block : 1;
  const long long grid = persistent_grid(kernel, kThreads, smem, device,
                                         want);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long units = grid * kWarps;
  if (2 * units * KM > carry_cap) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seg_carry<Acc, KM><<<(unsigned)((32 * units + kCarryThreads - 1) /
                                  kCarryThreads),
                       kCarryThreads, 0, stream>>>(a, (int)units, tile);
  return (int)cudaGetLastError();
}

template <typename V, typename T, typename Acc>
int chunks_entry(const void* starts, const void* lens, const void* rows,
                 const void* vals, int shift, const void* table, long long ld_row, long long ld_col, int B,
                 int k, int pairs, void* out, long long out_row,
                 long long out_col, int n_slots, void* stream, int device) {
  if (k < 1 || k > 8 || shift < 2 || shift > 20 || B < 0 || n_slots < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const ChunkArgs a{static_cast<const int*>(starts),
                    static_cast<const int*>(lens),
                    static_cast<const int*>(rows), vals, shift, table, ld_row, ld_col, B, k, pairs != 0, out, out_row,
                    out_col, n_slots};
  const cudaStream_t s = (cudaStream_t)stream;
  if (k <= 1) return launch_chunks<V, T, Acc, 1>(a, device, s);
  if (k <= 2) return launch_chunks<V, T, Acc, 2>(a, device, s);
  if (k <= 4) return launch_chunks<V, T, Acc, 4>(a, device, s);
  return launch_chunks<V, T, Acc, 8>(a, device, s);
}

template <typename V, typename T, typename Acc>
int terms_entry(const void* ptr, const void* gather, const void* val,
                const void* table, long long ld_row, long long ld_col, int B,
                int k, int pairs, void* out, long long out_row,
                long long out_col, int n_out, void* carries,
                long long carry_cap, long long cap, void* stream,
                int device) {
  if (k < 1 || k > 8 || B < 0 || n_out < 0 || cap < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const TermArgs a{static_cast<const int*>(ptr),
                   static_cast<const int*>(gather), val, table, ld_row,
                   ld_col, B, k, pairs != 0, out, out_row, out_col, n_out,
                   carries, cap};
  const cudaStream_t s = (cudaStream_t)stream;
  if (k <= 1) return launch_terms<V, T, Acc, 1>(a, carry_cap, device, s);
  if (k <= 2) return launch_terms<V, T, Acc, 2>(a, carry_cap, device, s);
  if (k <= 4) return launch_terms<V, T, Acc, 4>(a, carry_cap, device, s);
  return launch_terms<V, T, Acc, 8>(a, carry_cap, device, s);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 when its launches were accepted.  The name
// gives (vals, table); sums and out are f32, or f64 for the f64 pair.
#define SMALLK_SEG_ENTRIES(PAIR, V, T, ACC)                                   \
  int smallk_seg_chunks_##PAIR(                                               \
      const void* starts, const void* lens, const void* rows,                 \
      const void* vals, int shift, const void* table, long long ld_row,       \
      long long ld_col, int B, int k, int pairs, void* out,                   \
      long long out_row, long long out_col, int n_slots, void* stream,        \
      int device) {                                                           \
    return chunks_entry<V, T, ACC>(starts, lens, rows, vals, shift, table,    \
                                   ld_row, ld_col, B, k, pairs, out, out_row, \
                                   out_col, n_slots, stream, device);         \
  }                                                                           \
  int smallk_seg_terms_##PAIR(                                                \
      const void* ptr, const void* gather, const void* val,                   \
      const void* table, long long ld_row, long long ld_col, int B, int k,    \
      int pairs, void* out, long long out_row, long long out_col, int n_out,  \
      void* carries, long long carry_cap, long long cap, void* stream,        \
      int device) {                                                           \
    return terms_entry<V, T, ACC>(ptr, gather, val, table, ld_row, ld_col, B, \
                                  k, pairs, out, out_row, out_col, n_out,     \
                                  carries, carry_cap, cap, stream, device);   \
  }

SMALLK_SEG_ENTRIES(f32_f32, float, float, float)
SMALLK_SEG_ENTRIES(bf16_f32, __nv_bfloat16, float, float)
SMALLK_SEG_ENTRIES(f8_f32, __nv_fp8_e4m3, float, float)
SMALLK_SEG_ENTRIES(f64_f64, double, double, double)
#undef SMALLK_SEG_ENTRIES

// The most warps a seg_terms launch can have on `device` (2048 threads an
// SM): the carries must hold 2 x this x 8 sums.
int smallk_seg_max_grid(int device) { return 2048 / 32 * sm_count(device); }

const char* smallk_seg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
