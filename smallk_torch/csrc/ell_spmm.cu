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
// order, with no atomics, so every run gives the same sum.  Each output
// entry is one chain of fmas over l in ascending order, started from 0, in
// both layouts below: they give the same bits.
//
// Output layouts: row mode writes out (n_out, k); transposed mode writes
// out (k, n_out), bucket row r to column row(r), so that W'A arrives in
// the (k, n) layout its callers use, with no strided copy after it.
//
// Types (vals, table -> out): (f32, f32), (bf16, f32), (f32, bf16) -> f32
// sums; (f64, f64) -> f64 sums.  bf16 is widened with __bfloat162float.
//
// What bounds it on the card: a gather.  Every stored entry pulls one
// k-wide table row (512 bytes at k = 128 in f32) from a random place, so
// the product moves nnz * k * 4 bytes of table rows against 2 nnz k
// flops: far below the FP units, and bound by how fast random rows come
// from L2 (or HBM when the table does not stay there).  Beside the
// gathered rows, a launch streams idx and vals in once and the output out
// once: at the flagship's W'A, 480 MB and 512 MB around a 25.6 MB table.
//
// Design:
//   - a warp per bucket row, each lane VEC = 4 consecutive columns per load
//     (one float4 in f32), so a pass covers 32 * VEC columns; k that is not
//     a multiple of 4, or a table that is not aligned for it, takes the
//     one-column-a-lane path (VEC = 1);
//   - the lanes read idx and vals 32 at a time, one entry a lane, and
//     broadcast each with __shfl_sync; a sentinel is skipped;
//   - transposed mode stages a block's rows in shared memory and writes
//     each of the pass's columns as one run over the block's consecutive
//     rows (coalesced when the ids are consecutive, as they are at the
//     flagship; any ids stay correct);
//   - offsets are 64-bit; any k >= 1 is right (columns past a pass take
//     further passes over the row);
//   - static shared memory only (at most 9.2 KB, f64 transposed), so no
//     opt-in above 48 KB is needed;
//   - the card's sweep (`chip_smoke.py --ell`, PERF.md) tried two more
//     designs and kept neither: 16 or 8 lanes per row for short rows (as
//     fast or slower at every L from 32 to 256) and L2 cache steering
//     (evict-last table loads, streamed idx/vals/out: within 0.5%);
//   - wgmma, TMA and a persistent scheme are later work.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps of a block
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// VEC consecutive table entries at p, widened to the sum's type
template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&t)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    t[0] = v.x; t[1] = v.y; t[2] = v.z; t[3] = v.w;
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

template <typename V, typename T, typename Acc, int VEC, bool TRANS>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const int* __restrict__ idx, const V* __restrict__ vals,
                const T* __restrict__ table, Acc* __restrict__ out,
                const int* __restrict__ rows, int g, int L, int B, int k,
                int n_out, int accumulate) {
  constexpr int PASS = 32 * VEC;  // columns per pass
  // transposed mode's staging tile: [PASS][kWarps + 1]
  __shared__ Acc tile[TRANS ? PASS : 1][TRANS ? kWarps + 1 : 1];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  const bool live = r < g;  // no early return: every thread reaches
                            // transposed mode's barriers
  const long long base = (long long)r * L;

  for (int c0 = 0; c0 < k; c0 += PASS) {
    const int c = c0 + lane * VEC;
    Acc acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = Acc(0);
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int l = l0 + lane;
      int jl = B;
      Acc vl = Acc(0);
      if (live && l < L) {
        jl = __ldg(idx + base + l);
        vl = widen(__ldg(vals + base + l));
      }
      const int cnt = min(32, L - l0);
#pragma unroll 4
      for (int q = 0; q < cnt; ++q) {
        const int j = __shfl_sync(0xffffffffu, jl, q);
        const Acc w = __shfl_sync(0xffffffffu, vl, q);
        // a sentinel (j == B) is padding: skipped, never read; k % VEC ==
        // 0, so a lane's VEC columns are all in or all out
        if ((unsigned)j < (unsigned)B && c < k) {
          Acc t[VEC];
          load<VEC>(table + (long long)j * k + c, t);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] = fma_(w, t[v], acc[v]);
        }
      }
    }
    if constexpr (!TRANS) {
      if (live && c < k) {
        Acc* o = out + (long long)(rows == nullptr ? r : rows[r]) * k + c;
#pragma unroll
        for (int v = 0; v < VEC; ++v) o[v] = accumulate ? o[v] + acc[v] : acc[v];
      }
    } else {
      __syncthreads();  // the previous pass's tile has been written out
#pragma unroll
      for (int v = 0; v < VEC; ++v) tile[lane * VEC + v][warp] = acc[v];
      __syncthreads();
      // column c0 + cl of out: the block's rows, consecutive threads on
      // consecutive rows
      const int r0 = blockIdx.x * kWarps;
      for (int e = threadIdx.x; e < PASS * kWarps; e += kThreads) {
        const int cl = e / kWarps;
        const int rr = e - cl * kWarps;
        const int c2 = c0 + cl;
        const int r2 = r0 + rr;
        if (c2 < k && r2 < g) {
          Acc* o = out + (long long)c2 * n_out + (rows == nullptr ? r2 : rows[r2]);
          *o = accumulate ? *o + tile[cl][rr] : tile[cl][rr];
        }
      }
    }
  }
}

template <typename V, typename T, typename Acc, int VEC>
void launch(bool trans, unsigned grid, cudaStream_t s, const void* idx,
            const void* vals, const void* table, void* out, const void* rows,
            int g, int L, int B, int k, int n_out, int accumulate) {
  if (trans)
    ell_spmm_kernel<V, T, Acc, VEC, true><<<grid, kThreads, 0, s>>>(
        (const int*)idx, (const V*)vals, (const T*)table, (Acc*)out,
        (const int*)rows, g, L, B, k, n_out, accumulate);
  else
    ell_spmm_kernel<V, T, Acc, VEC, false><<<grid, kThreads, 0, s>>>(
        (const int*)idx, (const V*)vals, (const T*)table, (Acc*)out,
        (const int*)rows, g, L, B, k, n_out, accumulate);
}

template <typename V, typename T, typename Acc>
int ell_spmm(const void* idx, const void* vals, const void* table, void* out,
             const void* rows, int g, int L, int B, int k, int n_out,
             int accumulate, int vec, int transposed, void* stream,
             int device) {
  if (g < 0 || L < 1 || B < 0 || k < 1 || n_out < 0 ||
      (vec != 1 && vec != 4) || (vec == 4 && k % 4 != 0))
    return (int)cudaErrorInvalidValue;
  if (g == 0) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((g + kWarps - 1) / kWarps);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4)
    launch<V, T, Acc, 4>(transposed != 0, grid, s, idx, vals, table, out,
                         rows, g, L, B, k, n_out, accumulate);
  else
    launch<V, T, Acc, 1>(transposed != 0, grid, s, idx, vals, table, out,
                         rows, g, L, B, k, n_out, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 when the launch was accepted.  The name
// gives (vals, table); out is f32, or f64 for the f64 pair.  n_out is
// out's number of output rows (row mode) or columns (transposed mode).
#define SMALLK_ELL_ENTRY(NAME, V, T, ACC)                                    \
  int NAME(const void* idx, const void* vals, const void* table, void* out, \
           const void* rows, int g, int L, int B, int k, int n_out,         \
           int accumulate, int vec, int transposed, void* stream,           \
           int device) {                                                    \
    return ell_spmm<V, T, ACC>(idx, vals, table, out, rows, g, L, B, k,     \
                               n_out, accumulate, vec, transposed, stream,  \
                               device);                                     \
  }

SMALLK_ELL_ENTRY(smallk_ell_spmm_f32_f32, float, float, float)
SMALLK_ELL_ENTRY(smallk_ell_spmm_bf16_f32, __nv_bfloat16, float, float)
SMALLK_ELL_ENTRY(smallk_ell_spmm_f32_bf16, float, __nv_bfloat16, float)
SMALLK_ELL_ENTRY(smallk_ell_spmm_f64_f64, double, double, double)
#undef SMALLK_ELL_ENTRY

const char* smallk_ell_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
