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
// Types (vals, table -> out): (f32, f32), (bf16, f32), (f32, bf16) -> f32
// sums; (f64, f64) -> f64 sums.  bf16 is widened with __bfloat162float.
//
// What bounds it on the card: a gather.  Every stored entry pulls one
// k-wide table row (512 bytes at k = 128 in f32) from a random place, so
// the product moves nnz * k * 4 bytes of table rows against 2 nnz k
// flops: far below the FP units, and bound by how fast random rows come
// from L2 or HBM.  The minor-blocked families (ops/ell.py, _DOC_BLOCK) keep
// each launch's table slice small enough to stay in the 50 MB L2.
//
// Design (simple and correct first):
//   - one warp per bucket row; the lanes cover k, 4 consecutive columns a
//     lane (one float4 at k = 128 in f32), so a table row is one coalesced
//     512-byte load; k that is not a multiple of 4, or a table that is not
//     aligned for it, takes the one-column-a-lane path (VEC = 1);
//   - the warp reads idx and vals 32 at a time, one entry a lane, and
//     broadcasts each with __shfl_sync; a sentinel is skipped uniformly
//     across the warp;
//   - offsets are 64-bit; any k >= 1 is right (columns past 128 take
//     further passes over the row);
//   - wgmma, TMA and a cooperative or persistent scheme are later work.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // bucket rows (one warp each) of a block

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
    t[0] = __bfloat162float(p[0]);
  }
}

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename V, typename T, typename Acc, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
ell_spmm_kernel(const int* __restrict__ idx, const V* __restrict__ vals,
                const T* __restrict__ table, Acc* __restrict__ out,
                const int* __restrict__ rows, int g, int L, int B, int k,
                int accumulate) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= g) return;  // uniform across the warp
  const long long base = (long long)r * L;
  const long long orow = (long long)(rows == nullptr ? r : rows[r]) * k;
  for (int c0 = 0; c0 < k; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool mine = c < k;  // k % VEC == 0, so a lane's VEC columns are all in
    Acc acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = Acc(0);
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int l = l0 + lane;
      int jl = B;
      Acc vl = Acc(0);
      if (l < L) {
        jl = idx[base + l];
        vl = widen(vals[base + l]);
      }
      const int cnt = min(32, L - l0);
#pragma unroll 4
      for (int q = 0; q < cnt; ++q) {
        const int j = __shfl_sync(0xffffffffu, jl, q);
        const Acc w = __shfl_sync(0xffffffffu, vl, q);
        // a sentinel (j == B) is padding: uniform across the warp, skipped
        if (mine && (unsigned)j < (unsigned)B) {
          Acc t[VEC];
          load<VEC>(table + (long long)j * k + c, t);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] = fma_(w, t[v], acc[v]);
        }
      }
    }
    if (mine) {
      Acc* o = out + orow + c;
#pragma unroll
      for (int v = 0; v < VEC; ++v) o[v] = accumulate ? o[v] + acc[v] : acc[v];
    }
  }
}

template <typename V, typename T, typename Acc>
int ell_spmm(const void* idx, const void* vals, const void* table, void* out,
             const void* rows, int g, int L, int B, int k, int accumulate,
             int vec, void* stream, int device) {
  if (g < 0 || L < 1 || B < 0 || k < 1 || (vec != 1 && vec != 4) ||
      (vec == 4 && k % 4 != 0))
    return (int)cudaErrorInvalidValue;
  if (g == 0) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((g + kWarps - 1) / kWarps);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4) {
    ell_spmm_kernel<V, T, Acc, 4><<<grid, kWarps * 32, 0, s>>>(
        (const int*)idx, (const V*)vals, (const T*)table, (Acc*)out,
        (const int*)rows, g, L, B, k, accumulate);
  } else {
    ell_spmm_kernel<V, T, Acc, 1><<<grid, kWarps * 32, 0, s>>>(
        (const int*)idx, (const V*)vals, (const T*)table, (Acc*)out,
        (const int*)rows, g, L, B, k, accumulate);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 when the launch was accepted.  The name
// gives (vals, table); out is f32, or f64 for the f64 pair.
int smallk_ell_spmm_f32_f32(const void* idx, const void* vals,
                            const void* table, void* out, const void* rows,
                            int g, int L, int B, int k, int accumulate,
                            int vec, void* stream, int device) {
  return ell_spmm<float, float, float>(idx, vals, table, out, rows, g, L, B,
                                       k, accumulate, vec, stream, device);
}

int smallk_ell_spmm_bf16_f32(const void* idx, const void* vals,
                             const void* table, void* out, const void* rows,
                             int g, int L, int B, int k, int accumulate,
                             int vec, void* stream, int device) {
  return ell_spmm<__nv_bfloat16, float, float>(
      idx, vals, table, out, rows, g, L, B, k, accumulate, vec, stream,
      device);
}

int smallk_ell_spmm_f32_bf16(const void* idx, const void* vals,
                             const void* table, void* out, const void* rows,
                             int g, int L, int B, int k, int accumulate,
                             int vec, void* stream, int device) {
  return ell_spmm<float, __nv_bfloat16, float>(
      idx, vals, table, out, rows, g, L, B, k, accumulate, vec, stream,
      device);
}

int smallk_ell_spmm_f64_f64(const void* idx, const void* vals,
                            const void* table, void* out, const void* rows,
                            int g, int L, int B, int k, int accumulate,
                            int vec, void* stream, int device) {
  return ell_spmm<double, double, double>(idx, vals, table, out, rows, g, L,
                                          B, k, accumulate, vec, stream,
                                          device);
}

const char* smallk_ell_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
