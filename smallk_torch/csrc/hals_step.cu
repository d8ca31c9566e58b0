// One whole HALS iteration in one launch, for Hopper (sm_90a): a cluster
// of eight CTAs on neighbouring SMs.
//
// Replaces the TPU kernel smallk_tpu/solvers/hals_pallas.py:_hals_step_kernel
// (called through hals_step_pallas).  In order, as the reference's XLA step
// (smallk_tpu/solvers/hals.py:115-130) and the plain torch version
// (kernels/hals_step.py:hals_step_reference) compute it:
//
//   1. the W column sweep, c = 0..k-1:
//        w = clamp0(W[:,c] + (AH'[:,c] - W HH'[:,c]) / HH'[c,c]),
//        clamp0 = (isnan | < 0) -> 0 (+Inf stays), an all-zero column
//        becomes eps, then w / ||w||_2;
//   2. W'W and W'A;
//   3. the H row sweep, r = 0..k-1:
//        H[r,:] = clamp0(H[r,:] + (W'A[r,:] - W'W[r,:] H) / W'W[r,r]);
//   4. gradH = W'W H - W'A;  5. HH' and AH';  6. gradW = W HH' - AH';
//   7. ok = all(isfinite(gradW)) & all(isfinite(gradH)).
//
// What bounds it on the card: at the flatclust shape (256 x 256, k = 16) a
// step is ~2.1 M multiply-adds (the two A-products) and two reads of A from
// L2 (256 KB each in f32), but it is a chain of 2k dependent rank-1 updates:
// each W column needs a reduction over all m rows (its norm) before the
// next one may use it.  So the step is bound by latency (L2 and DSMEM round
// trips, barriers, reductions) and by the FP64 and f32 -> f64 conversion
// pipes of the SMs that run it, not by HBM bandwidth.  One CTA (the
// previous design) ran all of it on one SM of 132, where converting each
// f32 factor entry to f64 at every use (~2 M conversions, a quarter of the
// FP64 rate) alone takes tens of microseconds.
//
// Precision: the factors and every value the plain version holds as a
// tensor between ops (W, H, W'A and the outputs) are f32, but sums,
// products and the sweep arithmetic run in f64, and the k x k Grams are
// kept in f64.  The step is a chain of cancellations (AH' - W HH',
// W'A - W'W H, W HH' - AH'), so f32 sums taken in two different orders
// disagree by more than the reference's Pallas-vs-XLA tolerances at
// 256 x 256 and above.  With f64 sums the kernel stays within those
// tolerances of the plain version evaluated in f64.
//
// Design: a cluster of kCluster = 8 CTAs (portable), launched with
// cudaLaunchKernelEx.  CTA q owns rows [q mr, (q + 1) mr) of W and AH'
// and columns [q nc, (q + 1) nc) of H and W'A (mr = ceil(m / 8),
// nc = ceil(n / 8)); HH' and W'W are replicated in every CTA.
//   - W sweep: row i of column c depends only on row i of W, so each CTA
//     sweeps its own rows (a thread a row).  The column's (sum of squares,
//     nonzero count) is one reduction over the cluster: each warp's partial
//     goes to its CTA's shared memory, one cluster barrier, and every warp
//     that owns rows reads all 8 x 8 partials through DSMEM and adds them
//     in one fixed order (the slots are double-buffered, so one barrier
//     per column).
//   - W'W: each CTA's partial Gram over its rows (a thread an entry), one
//     cluster barrier, and every CTA adds the 8 partials in rank order.
//   - W'A: each CTA's column slice, on the FP64 tensor cores
//     (mma.sync m8n8k4 f64): 8 x 8 output tiles summed over the rows of A
//     4 at a time, CTA by CTA in a fixed order.  The same barrier makes every
//     CTA's rows of W readable, and the fragments of W are read straight
//     from their owners' shared memory (DSMEM) and widened as they are
//     read; A's slice is read once per warp that needs it, in its own
//     dtype.  (A first version copied the whole W into each CTA in f64 and
//     summed with FP64 FMAs, a thread per column: `chip_smoke.py --k2`
//     showed both products bound by one round trip per row of A and by
//     mostly idle, predicated FMA slots.)
//   - H sweep and gradH: column j depends only on column j of H, W'W and
//     W'A: local to the CTA, a thread a column, no barrier.
//   - HH' and AH': as W'W and W'A, with the roles of rows and columns
//     swapped (H's fragments through DSMEM, A's row slice from global
//     memory); the lane that holds an AH' sum computes its gradW entry.
//   - `ok`: CTA 0 writes 1 before the first barrier after the sweep; a CTA
//     that finds a non-finite gradient writes 0 after it; the barrier
//     orders the two.  A last cluster barrier keeps every CTA's shared
//     memory alive until the others have read it.
//   Every thread of every CTA reaches every cluster barrier: there is no
//   early return.  No atomics: every sum has one fixed order, so every
//   run gives the same bits.  The clamp is written with isnan and <, never
//   fmaxf, and the library is built without --use_fast_math, so division
//   and sqrt are IEEE: HH'[c,c] = 0 gives the same Inf/NaN as the plain
//   version.
//   - kernels/hals_step.py:smem_bytes mirrors `smem_bytes` here, and
//     hals_fits derives the fit from it.
//   - Shared memory above 48 KB is opted into on every launch that needs
//     it, on the launching device (an attribute is per device; no test on
//     one card can show a per-process cache of it going wrong).
//   - TMA staging of A and a pipelined W sweep (the 2k dependent column
//     and row updates, one cluster barrier per W column) are later work.
//
// Built with -DSMALLK_HALS_STAMPS, the kernel also writes clock64() and
// %globaltimer at each phase seam, per CTA, for `chip_smoke.py --k2`
// (smallk_hals_stamps reads them); the default build has no stamps.

#include <cfloat>
#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;      // CTAs of a step (portable cluster size)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;        // 8 x 8 output tiles a warp sums at once
constexpr int kSteps = 8;        // k-steps of 4 whose loads are in flight
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may opt into
constexpr int kSeams = 10;       // phase seams stamped per CTA

// rows / columns of a CTA's slice and their odd shared-memory stride (odd,
// so that reading along either axis is free of bank conflicts)
__host__ __device__ inline int slice(int d) {
  return (d + kCluster - 1) / kCluster;
}
__host__ __device__ inline int stride(int d) { return slice(d) | 1; }

__host__ __device__ inline size_t smem_bytes(int m, int n, int k) {
  const int ms = stride(m), ns = stride(n);
  return sizeof(double) * (4 * (size_t)k * k + 2 * 2 * kWarps) +
         sizeof(float) * (size_t)k * (ms + ns + (ms > ns ? ms : ns));
}

#ifdef SMALLK_HALS_STAMPS
__device__ unsigned long long g_stamps[kCluster * kSeams * 2];
#endif

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// every thread of every CTA of the cluster arrives; the wait sees all
// writes (shared, DSMEM and global) made before the others arrived
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ double widen(float x) { return (double)x; }
__device__ __forceinline__ double widen(__nv_bfloat16 x) {
  return (double)__bfloat162float(x);
}
__device__ __forceinline__ double widen(__nv_fp8_e4m3 x) {
  return (double)static_cast<float>(x);
}
// A read through the read-only cache; e4m3 has no __ldg of its own, so
// its byte is loaded and rewrapped
template <typename T>
__device__ __forceinline__ T ldg(const T* p) { return __ldg(p); }
__device__ __forceinline__ __nv_fp8_e4m3 ldg(const __nv_fp8_e4m3* p) {
  __nv_fp8_e4m3 v;
  v.__x = __ldg(reinterpret_cast<const unsigned char*>(p));
  return v;
}


// d (8 x 8) += a (8 x 4) b (4 x 8) on the FP64 tensor cores.  Lane l holds
// a[l / 4][l % 4], b[l % 4][l / 4] and d[l / 4][2 (l % 4) + {0, 1}].
__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// Output tiles of 8 x 8 in groups of up to kGroup that share one operand
// fragment, dealt to the warps: `tiles` tiles along the group axis, `other`
// along the shared one.  Group g covers tiles [first, first + count) of
// shared index `shared`.
struct Groups {
  int per, count_per_shared, total;
  __device__ Groups(int tiles, int other) {
    const int all = tiles * other;
    per = all / kWarps < 1 ? 1 : (all / kWarps > kGroup ? kGroup : all / kWarps);
    count_per_shared = (tiles + per - 1) / per;
    total = count_per_shared * other;
  }
};

// NaN or negative -> 0; +Inf stays (the plain version's select)
__device__ __forceinline__ float clamp0(float v) {
  return (isnan(v) || v < 0.f) ? 0.f : v;
}

// xor butterfly: every lane ends with the same sum (each level adds the
// same two partials, in either order)
__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Cluster-wide sum of squares (f64) and count of nonzeros of a W column,
// bitwise equal in every thread of every warp that reads them (`reader`,
// uniform across a warp; the others only contribute).  `red` holds
// 2 kWarps doubles; callers alternate two buffers, so one barrier suffices:
// a CTA writes a buffer again only after passing the next call's barrier,
// which every CTA reaches only after reading this call's partials.
__device__ __forceinline__ double column_terms(double ss, int nz, double* red,
                                               bool reader, int& nz_total,
                                               cg::cluster_group& cluster) {
  ss = warp_sum(ss);
  nz = __reduce_add_sync(0xffffffffu, nz);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp] = ss;
    red[kWarps + warp] = (double)nz;
  }
  cluster_sync();
  nz_total = 0;
  if (!reader) return 0.0;
  double sa = 0.0;
  int sb = 0;
  for (int p = lane; p < kCluster * kWarps; p += 32) {
    const double* r = cluster.map_shared_rank(red, p / kWarps);
    sa += r[p % kWarps];
    sb += (int)r[kWarps + p % kWarps];
  }
  nz_total = __reduce_add_sync(0xffffffffu, sb);
  return warp_sum(sa);
}

// The cluster's slicing of the step, as every CTA sees it.
struct Slices {
  int m, n, k, mr, nc, ms, ns, rank;
};

// W'A for G tiles of this CTA's columns: rows [8 rb, 8 rb + 8) of W'A x
// columns [8 (jt0 + t), +8) for t < G, summed over i (the rows of A) 4 at a
// time in two chains (even and odd steps, added at the end), CTA by CTA
// from this one on (so that the eight do not all read one CTA's memory at
// once; a fixed order for each output).  W's fragments are read from their
// owners' shared memory (DSMEM) and widened there, A's from global memory.
// Every load of a batch of kSteps steps is issued before any is used, from a
// valid address even where masked, and every mma runs, on zeros where
// masked: no branch for the compiler to sink a load into.
template <int G, typename TA>
__device__ __forceinline__ void wta_tiles(const TA* __restrict__ A,
                                          const float* Wl, float* WtAl,
                                          const Slices& s, int j0, int nj,
                                          int rb, int jt0,
                                          cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31;
  const int lr = lane >> 2, lc = lane & 3;
  const int r = rb * 8 + lr;  // the row of W'A of a's fragment
  double d[G][2][2];          // [tile][chain][value]
#pragma unroll
  for (int t = 0; t < G; ++t) d[t][0][0] = d[t][0][1] = d[t][1][0] = d[t][1][1] = 0.0;
  for (int qq = 0; qq < kCluster; ++qq) {
    const int q = (s.rank + qq) % kCluster;
    const int miq = max(0, min(s.m, (q + 1) * s.mr) - q * s.mr);
    const float* Wq = cluster.map_shared_rank(Wl, q);
    for (int s0 = 0; s0 < miq; s0 += 4 * kSteps) {
      float a[kSteps];
      TA b[kSteps][G];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int ii = s0 + 4 * u + lc;
        const bool in = ii < miq;
        a[u] = Wq[in && r < s.k ? r * s.ms + ii : 0];
        const size_t arow = (size_t)(q * s.mr + (in ? ii : 0)) * s.n + j0;
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const int j = (jt0 + t) * 8 + lr;
          b[u][t] = ldg(A + (in && j < nj ? arow + j : 0));
        }
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const bool in = s0 + 4 * u + lc < miq;
        const double av = in && r < s.k ? (double)a[u] : 0.0;
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const bool jn = (jt0 + t) * 8 + lr < nj;
          dmma(d[t][u & 1][0], d[t][u & 1][1], av, in && jn ? widen(b[u][t]) : 0.0);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < G; ++t) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int j = (jt0 + t) * 8 + 2 * lc + v;
      if (r < s.k && j < nj) WtAl[r * s.ns + j] = (float)(d[t][0][v] + d[t][1][v]);
    }
  }
}

// AH' for G tiles of this CTA's rows: rows [8 (it0 + t), +8) of A x
// columns [8 cb, 8 cb + 8) of AH', summed over j as wta_tiles sums over i,
// H's fragments read through DSMEM; then gradW = W HH' - AH' and W out by
// the lane that holds each sum.  Returns whether a gradW entry is not
// finite.
template <int G, typename TA>
__device__ __forceinline__ bool aht_tiles(
    const TA* __restrict__ A, const float* Hl, const float* Wl,
    const double* HHt, const Slices& s, int i0, int mi, int cb, int it0,
    float* __restrict__ AHt_out, float* __restrict__ gW,
    float* __restrict__ W_out, cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31;
  const int lr = lane >> 2, lc = lane & 3;
  const int c = cb * 8 + lr;  // the column of AH' of b's fragment
  double d[G][2][2];          // [tile][chain][value]
#pragma unroll
  for (int t = 0; t < G; ++t) d[t][0][0] = d[t][0][1] = d[t][1][0] = d[t][1][1] = 0.0;
  for (int qq = 0; qq < kCluster; ++qq) {
    const int q = (s.rank + qq) % kCluster;
    const int njq = max(0, min(s.n, (q + 1) * s.nc) - q * s.nc);
    const float* Hq = cluster.map_shared_rank(Hl, q);
    for (int s0 = 0; s0 < njq; s0 += 4 * kSteps) {
      TA a[kSteps][G];
      float b[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int jj = s0 + 4 * u + lc;
        const bool in = jj < njq;
        b[u] = Hq[in && c < s.k ? c * s.ns + jj : 0];
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const int i = (it0 + t) * 8 + lr;
          a[u][t] = ldg(A + (in && i < mi ? (size_t)(i0 + i) * s.n + q * s.nc + jj : 0));
        }
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const bool in = s0 + 4 * u + lc < njq;
        const double bv = in && c < s.k ? (double)b[u] : 0.0;
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const bool iin = (it0 + t) * 8 + lr < mi;
          dmma(d[t][u & 1][0], d[t][u & 1][1], in && iin ? widen(a[u][t]) : 0.0, bv);
        }
      }
    }
  }
  bool bad = false;
#pragma unroll
  for (int t = 0; t < G; ++t) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int i = (it0 + t) * 8 + lr;
      const int cc = cb * 8 + 2 * lc + v;
      if (i < mi && cc < s.k) {
        const double aht = d[t][0][v] + d[t][1][v];
        double dot = 0.0;
        for (int l = 0; l < s.k; ++l) dot = fma((double)Wl[l * s.ms + i], HHt[l * s.k + cc], dot);
        const float gw = (float)(dot - aht);
        const size_t o = (size_t)(i0 + i) * s.k + cc;
        AHt_out[o] = (float)aht;
        gW[o] = gw;
        W_out[o] = Wl[cc * s.ms + i];
        bad |= !isfinite(gw);
      }
    }
  }
  return bad;
}

#ifdef SMALLK_HALS_STAMPS
#define STAMP(s)                                                        \
  do {                                                                  \
    __syncthreads();                                                    \
    if (threadIdx.x == 0) {                                             \
      g_stamps[(rank * kSeams + (s)) * 2] = clock64();                  \
      g_stamps[(rank * kSeams + (s)) * 2 + 1] = globaltimer();          \
    }                                                                   \
  } while (0)
#else
#define STAMP(s) \
  do {           \
  } while (0)
#endif

template <typename TA>
__global__ void __launch_bounds__(kThreads)
hals_step_kernel(const TA* __restrict__ A, const float* __restrict__ W0,
                 const float* __restrict__ H0, const float* __restrict__ HHt0,
                 const float* __restrict__ AHt0, float* __restrict__ W_out,
                 float* __restrict__ H_out, float* __restrict__ gW,
                 float* __restrict__ gH, float* __restrict__ HHt_out,
                 float* __restrict__ AHt_out, uint8_t* __restrict__ ok,
                 int m, int n, int k) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int mr = slice(m), nc = slice(n);
  const int ms = stride(m), ns = stride(n);
  const int i0 = rank * mr, j0 = rank * nc;
  const int mi = max(0, min(m, i0 + mr) - i0);  // this CTA's rows of W
  const int nj = max(0, min(n, j0 + nc) - j0);  // this CTA's columns of H

  extern __shared__ __align__(16) double smem[];
  double* HHt = smem;                     // [k][k]  input, then HH' new
  double* WtW = HHt + (size_t)k * k;      // [k][k]
  double* PWtW = WtW + (size_t)k * k;     // [k][k]  this CTA's partial W'W
  double* PHHt = PWtW + (size_t)k * k;    // [k][k]  this CTA's partial HH'
  double* red = PHHt + (size_t)k * k;     // [2][2][kWarps]
  float* Wl = reinterpret_cast<float*>(red + 4 * kWarps);  // [k][ms] W^T
  float* Hl = Wl + (size_t)k * ms;        // [k][ns]
  // AH'^T (input, [k][ms]) until the W sweep ends, then W'A ([k][ns]):
  // no other CTA reads either
  float* AHl = Hl + (size_t)k * ns;
  float* WtAl = AHl;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  STAMP(0);
  if (rank == 0 && tid == 0) *ok = 1;  // ordered before any 0 by barrier A

  // stage this CTA's slices; the slice index runs fastest, so that the
  // transposed shared-memory stores are conflict-free
  for (int idx = tid; idx < k * mi; idx += kThreads) {
    const int c = idx / mi;
    const int i = idx - c * mi;
    Wl[c * ms + i] = W0[(size_t)(i0 + i) * k + c];
    AHl[c * ms + i] = AHt0[(size_t)(i0 + i) * k + c];
  }
  for (int idx = tid; idx < k * nj; idx += kThreads) {
    const int r = idx / nj;
    const int j = idx - r * nj;
    Hl[r * ns + j] = H0[(size_t)r * n + j0 + j];
  }
  for (int idx = tid; idx < k * k; idx += kThreads) HHt[idx] = (double)HHt0[idx];
  __syncthreads();
  STAMP(1);

  // 1. W column sweep over this CTA's rows.  Row i of the update reads row
  // i of W only, and the thread that owns row i is the only one that
  // writes it; the norm is one cluster reduction per column.
  const double eps = (double)FLT_EPSILON;
  const bool owns_rows = warp * 32 < mi;  // uniform across the warp
  for (int c = 0; c < k; ++c) {
    const double hcc = HHt[c * k + c];
    double ss = 0.0;
    int nz = 0;
    for (int i = tid; i < mi; i += kThreads) {
      double dot = 0.0;
      for (int j = 0; j < k; ++j) dot = fma((double)Wl[j * ms + i], HHt[j * k + c], dot);
      const float w = clamp0(
          (float)((double)Wl[c * ms + i] + ((double)AHl[c * ms + i] - dot) / hcc));
      Wl[c * ms + i] = w;
      ss = fma((double)w, (double)w, ss);
      nz += (w != 0.f) ? 1 : 0;
    }
    int nz_total;
    const double ss_total = column_terms(ss, nz, red + 2 * kWarps * (c & 1),
                                         owns_rows, nz_total, cluster);
    const bool all_zero = nz_total == 0;
    const double norm = all_zero ? sqrt((double)m * (eps * eps)) : sqrt(ss_total);
    for (int i = tid; i < mi; i += kThreads) {
      const double w = all_zero ? eps : (double)Wl[c * ms + i];
      Wl[c * ms + i] = (float)(w / norm);
    }
  }
  __syncthreads();
  STAMP(2);

  // 2a. this CTA's partial W'W: a thread per entry, over its rows in order
  for (int o = tid; o < k * k; o += kThreads) {
    const int a = o / k;
    const int b = o - a * k;
    double s = 0.0;
    for (int i = 0; i < mi; ++i) {
      s = fma((double)Wl[a * ms + i], (double)Wl[b * ms + i], s);
    }
    PWtW[o] = s;
  }
  cluster_sync();  // barrier A: every CTA's rows of W and partial W'W

  // 2b. W'W, the partials added in rank order
  for (int o = tid; o < k * k; o += kThreads) {
    double s = 0.0;
    for (int q = 0; q < kCluster; ++q) s += cluster.map_shared_rank(PWtW, q)[o];
    WtW[o] = s;
  }
  STAMP(3);

  // 2c. W'A for this CTA's columns on the FP64 tensor cores: output tiles of
  // 8 rows of W'A x 8 columns (wta_tiles).  A warp takes up to kGroup tiles
  // of one row block, sharing W's fragment.
  {
    const int JT = (nj + 7) / 8;
    const Groups gr(JT, (k + 7) / 8);
    const Slices sl{m, n, k, mr, nc, ms, ns, rank};
    for (int g = warp; g < gr.total; g += kWarps) {
      const int rb = g / gr.count_per_shared;
      const int jt0 = (g - rb * gr.count_per_shared) * gr.per;
      switch (gr.per) {
        case 1: wta_tiles<1>(A, Wl, WtAl, sl, j0, nj, rb, jt0, cluster); break;
        case 2: wta_tiles<2>(A, Wl, WtAl, sl, j0, nj, rb, jt0, cluster); break;
        case 3: wta_tiles<3>(A, Wl, WtAl, sl, j0, nj, rb, jt0, cluster); break;
        default: wta_tiles<4>(A, Wl, WtAl, sl, j0, nj, rb, jt0, cluster);
      }
    }
  }
  __syncthreads();
  STAMP(4);

  // 3. H row sweep over this CTA's columns.  Column j of the update reads
  // column j of H only, so a thread sweeps its columns through all k rows
  // with no barrier.
  for (int j = tid; j < nj; j += kThreads) {
    for (int r = 0; r < k; ++r) {
      double dot = 0.0;
      for (int l = 0; l < k; ++l) dot = fma(WtW[r * k + l], (double)Hl[l * ns + j], dot);
      Hl[r * ns + j] = clamp0((float)((double)Hl[r * ns + j] +
                                      ((double)WtAl[r * ns + j] - dot) / WtW[r * k + r]));
    }
  }
  __syncthreads();
  STAMP(5);

  // 4. gradH = W'W H - W'A, and H out, for this CTA's columns
  bool bad = false;
  for (int idx = tid; idx < k * nj; idx += kThreads) {
    const int r = idx / nj;
    const int j = idx - r * nj;
    double dot = 0.0;
    for (int l = 0; l < k; ++l) dot = fma(WtW[r * k + l], (double)Hl[l * ns + j], dot);
    const float g = (float)(dot - (double)WtAl[r * ns + j]);
    const size_t o = (size_t)r * n + j0 + j;
    gH[o] = g;
    H_out[o] = Hl[r * ns + j];
    bad |= !isfinite(g);
  }

  // 5a. this CTA's partial HH' (the old HH' was last read in the W
  // sweep): a thread per entry, over its columns in order
  for (int o = tid; o < k * k; o += kThreads) {
    const int a = o / k;
    const int b = o - a * k;
    double s = 0.0;
    for (int j = 0; j < nj; ++j) {
      s = fma((double)Hl[a * ns + j], (double)Hl[b * ns + j], s);
    }
    PHHt[o] = s;
  }
  STAMP(6);
  cluster_sync();  // barrier B: every CTA's columns of H and partial HH'

  // 5b. HH', the partials added in rank order
  for (int o = tid; o < k * k; o += kThreads) {
    double s = 0.0;
    for (int q = 0; q < kCluster; ++q) s += cluster.map_shared_rank(PHHt, q)[o];
    HHt[o] = s;
    if (rank == 0) HHt_out[o] = (float)s;
  }
  __syncthreads();
  STAMP(7);

  // 5c + 6. AH' for this CTA's rows on the FP64 tensor cores (aht_tiles),
  // then gradW = W HH' - AH' and W out by the lane that holds each sum.  A
  // warp takes up to kGroup tiles of one column block, sharing H's fragment.
  {
    const int IT = (mi + 7) / 8;
    const Groups gr(IT, (k + 7) / 8);
    const Slices sl{m, n, k, mr, nc, ms, ns, rank};
    for (int g = warp; g < gr.total; g += kWarps) {
      const int cb = g / gr.count_per_shared;
      const int it0 = (g - cb * gr.count_per_shared) * gr.per;
      switch (gr.per) {
        case 1: bad |= aht_tiles<1>(A, Hl, Wl, HHt, sl, i0, mi, cb, it0, AHt_out, gW, W_out, cluster); break;
        case 2: bad |= aht_tiles<2>(A, Hl, Wl, HHt, sl, i0, mi, cb, it0, AHt_out, gW, W_out, cluster); break;
        case 3: bad |= aht_tiles<3>(A, Hl, Wl, HHt, sl, i0, mi, cb, it0, AHt_out, gW, W_out, cluster); break;
        default: bad |= aht_tiles<4>(A, Hl, Wl, HHt, sl, i0, mi, cb, it0, AHt_out, gW, W_out, cluster);
      }
    }
  }
  // this CTA has read all it reads of the others: arrive now, wait at exit
  cluster_arrive();

  if (__syncthreads_or(bad ? 1 : 0) && tid == 0) *ok = 0;
  STAMP(8);
  cluster_wait();  // no CTA leaves while another may still read its memory
  STAMP(9);
}

// cluster barrier and DSMEM latency: one warp per CTA of a cluster times
// `iters` cluster barriers, then `iters` dependent loads from the next
// CTA's shared memory and from its own
__global__ void __launch_bounds__(32)
cluster_probe_kernel(unsigned long long* out, int iters) {
  __shared__ int chain[256];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  for (int i = threadIdx.x; i < 256; i += 32) chain[i] = (i + 1) & 255;
  cluster_sync();
  const long long t0 = clock64();
  const unsigned long long g0 = globaltimer();
  for (int it = 0; it < iters; ++it) cluster_sync();
  const long long t1 = clock64();
  const unsigned long long g1 = globaltimer();
  const volatile int* remote =
      cluster.map_shared_rank(chain, (rank + 1) % cluster.num_blocks());
  int p = 0;
  const long long t2 = clock64();
  for (int it = 0; it < iters; ++it) p = remote[p];
  const long long t3 = clock64();
  const volatile int* local = chain;
  int q = p;
  for (int it = 0; it < iters; ++it) q = local[q];
  const long long t4 = clock64();
  cluster_sync();  // every CTA stays until its neighbour is done reading
  if (rank == 0 && threadIdx.x == 0) {
    out[0] = (unsigned long long)(t1 - t0);
    out[1] = g1 - g0;
    out[2] = (unsigned long long)(t3 - t2);
    out[3] = (unsigned long long)(t4 - t3);
    out[4] = (unsigned long long)q;  // keeps the chains live
  }
}

cudaLaunchAttribute cluster_attr() {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

template <typename TA>
cudaError_t opt_in(size_t smem) {
  // per device, so set on every launch that needs it (it is cheap)
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(hals_step_kernel<TA>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename TA>
int launch(const void* A, const void* W, const void* H, const void* HHt,
           const void* AHt, void* W_out, void* H_out, void* gW, void* gH,
           void* HHt_out, void* AHt_out, void* ok, int m, int n, int k,
           void* stream, int device) {
  if (m < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(m, n, k);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = opt_in<TA>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, hals_step_kernel<TA>, (const TA*)A, (const float*)W,
      (const float*)H, (const float*)HHt, (const float*)AHt, (float*)W_out,
      (float*)H_out, (float*)gW, (float*)gH, (float*)HHt_out,
      (float*)AHt_out, (uint8_t*)ok, m, n, k);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a launch that was accepted.
int smallk_hals_step_f32(const void* A, const void* W, const void* H,
                         const void* HHt, const void* AHt, void* W_out,
                         void* H_out, void* gW, void* gH, void* HHt_out,
                         void* AHt_out, void* ok, int m, int n, int k,
                         void* stream, int device) {
  return launch<float>(A, W, H, HHt, AHt, W_out, H_out, gW, gH, HHt_out,
                       AHt_out, ok, m, n, k, stream, device);
}

int smallk_hals_step_bf16(const void* A, const void* W, const void* H,
                          const void* HHt, const void* AHt, void* W_out,
                          void* H_out, void* gW, void* gH, void* HHt_out,
                          void* AHt_out, void* ok, int m, int n, int k,
                          void* stream, int device) {
  return launch<__nv_bfloat16>(A, W, H, HHt, AHt, W_out, H_out, gW, gH,
                               HHt_out, AHt_out, ok, m, n, k, stream, device);
}

int smallk_hals_step_f8(const void* A, const void* W, const void* H,
                        const void* HHt, const void* AHt, void* W_out,
                        void* H_out, void* gW, void* gH, void* HHt_out,
                        void* AHt_out, void* ok, int m, int n, int k,
                        void* stream, int device) {
  return launch<__nv_fp8_e4m3>(A, W, H, HHt, AHt, W_out, H_out, gW, gH,
                               HHt_out, AHt_out, ok, m, n, k, stream, device);
}

// How many clusters of the f32 kernel at (m, n, k) the device can hold at
// once (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
int smallk_hals_max_active_clusters(int m, int n, int k, int device) {
  const size_t smem = smem_bytes(m, n, k);
  if (m < 1 || n < 1 || k < 1 || smem > kMaxSmem)
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = opt_in<float>(smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr = cluster_attr();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, hals_step_kernel<float>,
                                       &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

// One run of the cluster probe into out (5 unsigned 64-bit values on the
// device: barrier cycles, barrier ns, DSMEM-chain cycles, local-chain
// cycles, a sink), for `iters` of each.
int smallk_cluster_probe(void* out, int iters, void* stream, int device) {
  if (iters < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(32);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_probe_kernel,
                           (unsigned long long*)out, iters);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The phase stamps of the last stamped launch, copied to host memory
// (kCluster x kSeams x (clock64, globaltimer ns)); returns how many values
// were copied, 0 in the default build, or minus a cudaError_t.
int smallk_hals_stamps(void* host, int capacity, int device) {
#ifdef SMALLK_HALS_STAMPS
  const int count = kCluster * kSeams * 2;
  if (capacity < count) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(host, g_stamps, sizeof(unsigned long long) * count);
  return err == cudaSuccess ? count : -(int)err;
#else
  (void)host;
  (void)capacity;
  (void)device;
  return 0;
#endif
}

const char* smallk_hals_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
