// ELL gather-SpMM: one bucket of the bucketed-ELL sparse products, for
// Hopper (sm_90a).
//
// Replaces the TPU probes scripts/tpu_batch29.py:pallas_product and
// pallas_product2 (P1) and scripts/tpu_batch33.py:make_pallas (P2), which
// tried to fuse the bucket product of smallk_tpu/ops/ell.py
// (EllAOp._bucket_product) into one Pallas kernel; the TPU toolchain could
// build neither, so there the product stayed an XLA gather plus einsum.
// For one bucket,
//
//     out[row(r), :] (= or +=) sum over l with idx[r, l] < B of
//                              vals[r, l] * table[idx[r, l], :]
//
// with row(r) = rows[r] (the bucket's major ids: each bucket row goes
// straight to its place in the product, no stacking and no inverse
// permutation) or r when rows is null.  idx == B is the padding sentinel:
// it is skipped, never read, so the table needs no appended zero row.  In
// accumulate mode the bucket row's sum is added to what out holds, which is
// how the minor-blocked families add their per-block partials: in launch
// order, with no atomics, so every run gives the same sum.
//
// Output layouts: row mode writes out (n_out, k); transposed mode writes
// out (k, n_out), bucket row r to column row(r), so that W'A arrives in
// the (k, n) layout its callers use, with no strided copy after it.  Both
// layouts sum in the same order and give the same bits.
//
// Types (vals, table -> out): (f32, f32), (bf16, f32), (e4m3, f32),
// (f32, bf16) -> f32 sums; (f64, f64) -> f64 sums.  bf16 is widened with
// __bfloat162float, e4m3 by the fp8 conversion, both in registers.
//
// What bounds it on the card: a gather.  Every stored entry pulls one
// k-wide table row from a random place, so the product moves nnz * k * 4
// bytes of table rows against 2 nnz k flops: far below the FP units, and
// bound by how fast random rows come from L2 (or HBM when the table does
// not stay there).  Beside the gathered rows, a launch streams idx and
// vals in once and out once: at k = 2 that stream (6 bytes an entry in
// bf16) is the whole bound, the gathered row only 8 bytes.  At k = 2 what
// a launch waits for is latency: the idx stream's (HBM) and then the
// gathered row's (L2), once per batch a lane walks.
//
// Design.  The launch plan (kernels/ell_spmm.launch_plan, passed in as
// ints) sets four numbers: VEC, the table columns a lane loads at once
// (4, 2 or 1: one 16-, 8- or 4-byte load in f32); C, the lanes one entry
// needs (the next power of two of k / VEC, at most 32); W, the lanes of a
// row's sub-warp (32, or 16 or 8 for rows that short, so that a warp holds
// several); S, the warps that share one row (1, or up to 32 for long rows).
//   - G = W / C entries are in flight in a sub-warp at once.  Its lanes
//     read idx and vals W at a time, one entry a lane, coalesced; group
//     gi of C lanes takes entries gi, gi + G, ... of those W and keeps its
//     own chain of fmas in ascending l.  At the end of a pass a fixed
//     __shfl_xor_sync butterfly over the G groups adds the chains.
//   - kLane (C = 1; k = 2 in f32 is VEC = 2): each lane walks its own
//     entries, no __shfl_sync, and loads U = 8 batches of idx and vals (4
//     when its part of a table row is 16 bytes or more) before it gathers
//     their table rows, so U loads of each kind are in flight a lane
//     (walked one batch at a time, the root's AH' took ~1 us a batch;
//     PERF.md).
//   - kGroup (1 < C < W): an entry broadcast to its group of C lanes.  On
//     the sparse hierclust root's products at k = 8 and 16 it took 2.1-5.0x
//     less device time than kWarp's broadcast to the whole warp (PERF.md).
//   - kWarp (C = W = 32, G = 1): one entry at a time broadcast to the warp,
//     a float4 of its table row a lane: the k = 128 design, whose code is
//     kept as it was; its walk is uniform at compile time, so the
//     shuffles need no divergence checks.
//   - A row of more than SPLIT_MIN_L entries takes S warps, interleaved
//     over the row W entries at a time, so that no lane's chain passes
//     MAX_CHAIN entries while S <= 32; the S partial sums add in shared
//     memory in warp order, one thread a column.  A block holds
//     max(256, 32 S) threads: one row from S = 8 up, up to 1024 threads.
//   - Every sum has a fixed order (chain, butterfly, warps), so two
//     launches give the same bits, and both layouts give the same bits;
//     with G = 1 and S = 1 each output entry is one chain of fmas over l in
//     ascending order from 0, as in the k = 128 design.
//   - transposed mode stages a block's rows in shared memory and writes
//     each of the pass's columns as one run over the block's consecutive
//     rows (coalesced when the ids are consecutive, as they are at the
//     flagship; any ids stay correct);
//   - offsets are 64-bit; any k >= 1 is right (columns past a pass take
//     further passes over the row);
//   - shared memory is dynamic and sized by the launch: none in row mode
//     with S = 1; at most 34 KB (f64, S = 32, 128 columns a pass);
//   - one host call launches a list of buckets in order (ell_spmm_many):
//     through the wrapper a launch cost the host ~25 us, which set the
//     root's AH' (189 launches) at 4.4-6.2 ms;
//   - tried on the card and removed (PERF.md): at k = 128, 16 or 8 lanes
//     per row for short rows and L2 cache steering (no gain).
//   - one launch over all of a block's buckets (the root's AH' is 189
//     launches, ~2.2 ms back to back against 1.6 ms of device time),
//     wgmma, TMA and a persistent grid are later work.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;      // threads of a block unless a row needs more
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDesc = 9;  // int64s of a bucket's launch record

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
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


// VEC consecutive table entries at p, widened to the sum's type
template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&t)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    t[0] = v.x; t[1] = v.y; t[2] = v.z; t[3] = v.w;
  } else if constexpr (VEC == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    t[0] = v.x; t[1] = v.y;
  } else {
    t[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load(const double* p, double (&t)[VEC]) {
  if constexpr (VEC == 4) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
    t[0] = a.x; t[1] = a.y; t[2] = b.x; t[3] = b.y;
  } else if constexpr (VEC == 2) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    t[0] = a.x; t[1] = a.y;
  } else {
    t[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&t)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    t[0] = a.x; t[1] = a.y; t[2] = b.x; t[3] = b.y;
  } else if constexpr (VEC == 2) {
    const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    t[0] = a.x; t[1] = a.y;
  } else {
    t[0] = __bfloat162float(__ldg(p));
  }
}

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}

// acc += w * table row j's VEC columns at c, unless j is the sentinel
template <int VEC, typename T, typename Acc>
__device__ __forceinline__ void gather_fma(const T* __restrict__ table,
                                           int j, Acc w, int B, int k, int c,
                                           Acc (&acc)[VEC]) {
  // k % VEC == 0, so a lane's VEC columns are all in or all out
  if ((unsigned)j < (unsigned)B && c < k) {
    Acc t[VEC];
    load<VEC>(table + (long long)j * k + c, t);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = fma_(w, t[v], acc[v]);
  }
}

// How a sub-warp walks its entries (the plan's C and W):
//   kLane  C == 1: each lane its own entry, U batches of loads in flight;
//   kGroup 1 < C < W: groups of C lanes, an entry broadcast to its group;
//   kWarp  C == W == 32: one entry at a time, broadcast to the warp (the
//          k = 128 path, kept as it was, bit for bit).
enum Mode { kLane, kGroup, kWarp };

// SPLIT: S > 1 (launch bounds of 1024 threads; the other kernels keep 256,
// and their registers).
template <typename V, typename T, typename Acc, int VEC, int MODE, bool TRANS,
          bool SPLIT>
__global__ void __launch_bounds__(SPLIT ? kMaxThreads : kBlock)
ell_spmm_kernel(const int* __restrict__ idx, const V* __restrict__ vals,
                const T* __restrict__ table, Acc* __restrict__ out,
                const int* __restrict__ rows, int g, int L, int B, int k,
                int n_out, int accumulate, int C, int W, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // batches of idx/vals a lane of kLane loads before it gathers: U
  // independent table loads in flight a lane, against the latency of the
  // idx stream (HBM) and of the gathered rows (L2)
  constexpr int U = VEC * sizeof(Acc) <= 8 ? 8 : 4;
  // what the mode fixes is fixed at compile time, so that a warp's walk
  // (its start, step and counts) is uniform to the compiler and its
  // shuffles need no divergence check: kWarp has W = C = 32, and every
  // row's walk starts at 0 unless SPLIT
  constexpr bool kW = MODE == kWarp;
  const int Wd = kW ? 32 : W;
  const int pass = kW ? 32 * VEC : C * VEC;  // columns per pass
  const int tpr = SPLIT ? Wd * S : Wd;  // threads of a row
  // rows of the block (kWarp without SPLIT: a warp a row, kBlock threads)
  const int nrb = kW && !SPLIT ? kBlock / 32 : blockDim.x / tpr;
  const int rb = threadIdx.x / tpr;
  const int t = threadIdx.x - rb * tpr;
  const int ws = SPLIT ? t / Wd : 0;  // the row's warp (SPLIT: W == 32)
  const int sub = t - ws * Wd;    // lane in the row's sub-warp
  const int first = kW ? 0 : (threadIdx.x & 31) - sub;  // its first lane
  const int gshift = kW ? 0 : __ffs(W / C) - 1;  // G = W / C in flight
  const int gi = kW ? 0 : sub / C;  // entry group
  const int s = kW ? sub : sub - gi * C;  // lane in the group
  const int r = blockIdx.x * nrb + rb;
  const bool live = r < g;  // no early return: every lane reaches the
                            // shuffles and the barriers
  const long long base = (long long)r * L;
  // shared memory: the split rows' partial sums [warps of the block][pass],
  // then transposed mode's staging tile [pass][nrb + 1]
  Acc* partial = reinterpret_cast<Acc*>(smem_raw);
  Acc* tile = partial + (SPLIT ? (blockDim.x >> 5) * pass : 0);
  const int step = SPLIT ? S * Wd : Wd;

  for (int c0 = 0; c0 < k; c0 += pass) {
    const int c = c0 + s * VEC;
    Acc acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = Acc(0);
    if constexpr (MODE == kLane) {
      for (int l0 = ws * Wd; l0 < L; l0 += U * step) {
        int j[U];
        Acc w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int l = l0 + u * step + sub;
          j[u] = B;
          w[u] = Acc(0);
          if (live && l < L) {
            j[u] = __ldg(idx + base + l);
            w[u] = widen(ldg(vals + base + l));
          }
        }
        Acc tv[U][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          // k % VEC == 0, so a lane's VEC columns are all in or all out
          if ((unsigned)j[u] < (unsigned)B && c < k) {
            load<VEC>(table + (long long)j[u] * k + c, tv[u]);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) tv[u][v] = Acc(0);
          }
        }
        // the chain in ascending l; a sentinel is skipped
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if ((unsigned)j[u] < (unsigned)B) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[v] = fma_(w[u], tv[u][v], acc[v]);
          }
        }
      }
    } else {
      for (int l0 = ws * Wd; l0 < L; l0 += step) {
        const int l = l0 + sub;
        int jl = B;
        Acc vl = Acc(0);
        if (live && l < L) {
          jl = __ldg(idx + base + l);
          vl = widen(ldg(vals + base + l));
        }
        if constexpr (MODE == kWarp) {
          const int cnt = min(32, L - l0);
#pragma unroll 4
          for (int q = 0; q < cnt; ++q) {
            const int j = __shfl_sync(kFull, jl, q);
            const Acc w = __shfl_sync(kFull, vl, q);
            gather_fma<VEC>(table, j, w, B, k, c, acc);
          }
        } else {
          // the same count in every lane of the warp: entries (q << gshift)
          // + gi past the row's end are sentinels
          const int cnt = min(C, (L - l0 + (1 << gshift) - 1) >> gshift);
#pragma unroll 4
          for (int q = 0; q < cnt; ++q) {
            const int src = first + (q << gshift) + gi;
            const int j = __shfl_sync(kFull, jl, src);
            const Acc w = __shfl_sync(kFull, vl, src);
            gather_fma<VEC>(table, j, w, B, k, c, acc);
          }
        }
      }
    }
    // the G groups' chains, in a fixed butterfly (lanes of one sub-warp)
    if constexpr (!kW) {
      for (int off = C; off < W; off <<= 1) {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[v] += __shfl_xor_sync(kFull, acc[v], off);
      }
    }
    const bool writer = ws == 0 && gi == 0;
    if constexpr (SPLIT) {
      // the S warps' sums, added in warp order by the row's first warp
      __syncthreads();  // the previous pass's partials have been read
      if (gi == 0) {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          partial[(threadIdx.x >> 5) * pass + s * VEC + v] = acc[v];
      }
      __syncthreads();
      if (writer) {
        for (int w2 = 1; w2 < S; ++w2) {
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[v] += partial[(rb * S + w2) * pass + s * VEC + v];
        }
      }
    }
    if constexpr (!TRANS) {
      if (live && writer && c < k) {
        Acc* o = out + (long long)(rows == nullptr ? r : rows[r]) * k + c;
#pragma unroll
        for (int v = 0; v < VEC; ++v) o[v] = accumulate ? o[v] + acc[v] : acc[v];
      }
    } else {
      __syncthreads();  // the previous pass's tile has been written out
      if (writer) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) tile[(s * VEC + v) * (nrb + 1) + rb] = acc[v];
      }
      __syncthreads();
      // column c0 + cl of out: the block's rows, consecutive threads on
      // consecutive rows
      const int r0 = blockIdx.x * nrb;
      const int nthr = kW && !SPLIT ? kBlock : (int)blockDim.x;
      for (int e = threadIdx.x; e < pass * nrb; e += nthr) {
        const int cl = e / nrb;
        const int rr = e - cl * nrb;
        const int c2 = c0 + cl;
        const int r2 = r0 + rr;
        if (c2 < k && r2 < g) {
          Acc* o = out + (long long)c2 * n_out + (rows == nullptr ? r2 : rows[r2]);
          const Acc x = tile[cl * (nrb + 1) + rr];
          *o = accumulate ? *o + x : x;
        }
      }
    }
  }
}

struct Launch {
  unsigned grid, block;
  size_t smem;
  cudaStream_t stream;
};

template <typename V, typename T, typename Acc, int VEC, int MODE, bool TRANS,
          bool SPLIT>
void go(const Launch& p, const void* idx, const void* vals, const void* table,
        void* out, const void* rows, int g, int L, int B, int k, int n_out,
        int accumulate, int C, int W, int S) {
  ell_spmm_kernel<V, T, Acc, VEC, MODE, TRANS, SPLIT>
      <<<p.grid, p.block, p.smem, p.stream>>>(
          (const int*)idx, (const V*)vals, (const T*)table, (Acc*)out,
          (const int*)rows, g, L, B, k, n_out, accumulate, C, W, S);
}

template <typename V, typename T, typename Acc, int VEC, int MODE>
void pick(bool trans, bool split, const Launch& p, const void* idx,
          const void* vals, const void* table, void* out, const void* rows,
          int g, int L, int B, int k, int n_out, int accumulate, int C, int W,
          int S) {
#define SMALLK_ELL_GO(TR, SP)                                                 \
  go<V, T, Acc, VEC, MODE, TR, SP>(p, idx, vals, table, out, rows, g, L, B, k, \
                                  n_out, accumulate, C, W, S)
  if (trans) {
    if (split) SMALLK_ELL_GO(true, true); else SMALLK_ELL_GO(true, false);
  } else {
    if (split) SMALLK_ELL_GO(false, true); else SMALLK_ELL_GO(false, false);
  }
#undef SMALLK_ELL_GO
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

// One bucket's launch (the plan checked); a cudaError_t
template <typename V, typename T, typename Acc>
int launch_one(const void* idx, const void* vals, const void* table,
               void* out, const void* rows, int g, int L, int B, int k,
               int n_out, int accumulate, int vec, int C, int W, int S,
               int transposed, cudaStream_t stream) {
  // the plan: vec | k; C, W, S powers of two; C <= W <= 32; S <= 32, and
  // S > 1 only with whole warps
  if (g < 0 || L < 1 || B < 0 || k < 1 || n_out < 0 ||
      (vec != 1 && vec != 2 && vec != 4) || k % vec != 0 || !pow2(C) ||
      !pow2(W) || !pow2(S) || C > W || W > 32 || S > 32 ||
      (S > 1 && W != 32))
    return (int)cudaErrorInvalidValue;
  if (g == 0) return (int)cudaSuccess;
  const int tpr = W * S;
  const int block = tpr > kBlock ? tpr : kBlock;
  const int nrb = block / tpr;
  const int pass = C * vec;
  const size_t smem =
      sizeof(Acc) * ((S > 1 ? (size_t)(block / 32) * pass : 0) +
                     (transposed ? (size_t)pass * (nrb + 1) : 0));
  const Launch p{(unsigned)((g + nrb - 1) / nrb), (unsigned)block, smem,
                 stream};
  const bool tr = transposed != 0, split = S > 1;
  const int mode = C == 1 ? kLane : C == 32 ? kWarp : kGroup;
#define SMALLK_ELL_PICK(VEC, MODE)                                            \
  pick<V, T, Acc, VEC, MODE>(tr, split, p, idx, vals, table, out, rows, g, L, \
                             B, k, n_out, accumulate, C, W, S)
#define SMALLK_ELL_MODES(VEC)                                                 \
  if (mode == kLane) SMALLK_ELL_PICK(VEC, kLane);                             \
  else if (mode == kWarp) SMALLK_ELL_PICK(VEC, kWarp);                        \
  else SMALLK_ELL_PICK(VEC, kGroup)
  if (vec == 4) {
    SMALLK_ELL_MODES(4);
  } else if (vec == 2) {
    SMALLK_ELL_MODES(2);
  } else {
    SMALLK_ELL_MODES(1);
  }
#undef SMALLK_ELL_MODES
#undef SMALLK_ELL_PICK
  return (int)cudaGetLastError();
}

// n buckets into one table and one out, launched in order on one stream:
// desc holds, per bucket, idx, vals and rows (0: none) as addresses, then
// g, L and the plan (vec, C, W, S).  On a failure, *failed is the bucket's
// index and the launches after it are not made.
template <typename V, typename T, typename Acc>
int ell_spmm_many(const long long* desc, int n, const void* table, void* out,
                  int B, int k, int n_out, int accumulate, int transposed,
                  void* stream, int device, int* failed) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + (long long)kDesc * i;
    const int e = launch_one<V, T, Acc>(
        (const void*)d[0], (const void*)d[1], table, out, (const void*)d[2],
        (int)d[3], (int)d[4], B, k, n_out, accumulate, (int)d[5], (int)d[6],
        (int)d[7], (int)d[8], transposed, (cudaStream_t)stream);
    if (e != 0) {
      *failed = i;
      return e;
    }
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 when every launch was accepted.  The name
// gives (vals, table); out is f32, or f64 for the f64 pair.  n_out is
// out's number of output rows (row mode) or columns (transposed mode).
// desc is n records of kDesc int64s (ell_spmm_many above; the wrapper's
// Buckets.descriptors).
#define SMALLK_ELL_ENTRY(NAME, V, T, ACC)                                     \
  int NAME(const long long* desc, int n, const void* table, void* out,       \
           int B, int k, int n_out, int accumulate, int transposed,          \
           void* stream, int device, int* failed) {                          \
    return ell_spmm_many<V, T, ACC>(desc, n, table, out, B, k, n_out,        \
                                    accumulate, transposed, stream, device,  \
                                    failed);                                 \
  }

SMALLK_ELL_ENTRY(smallk_ell_spmm_f32_f32, float, float, float)
SMALLK_ELL_ENTRY(smallk_ell_spmm_bf16_f32, __nv_bfloat16, float, float)
SMALLK_ELL_ENTRY(smallk_ell_spmm_f8_f32, __nv_fp8_e4m3, float, float)
SMALLK_ELL_ENTRY(smallk_ell_spmm_f32_bf16, float, __nv_bfloat16, float)
SMALLK_ELL_ENTRY(smallk_ell_spmm_f64_f64, double, double, double)
#undef SMALLK_ELL_ENTRY

const char* smallk_ell_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
