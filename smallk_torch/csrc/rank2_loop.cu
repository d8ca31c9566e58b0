// Rank-2 A-products and the rank-2 iteration loop, for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/tpu_batch60.py:kernel (called through
// pallas_loop), a probe of the rank-2 solve's iteration floor.  It runs,
// ITERS times, on a resident (m, w) slab A and a (2, m) f32 Wt:
//
//     H  = Wt . A            (2, w)    -- wt_a below
//     Wn = H . A^T           (2, m)    -- h_at below
//     Wt = Wn / (max|Wn| + 1)
//
// H = Wt.A and Wn = H.A^T are the two A-products of every rank-2 NMF step
// (W^T A and A H^T with k = 2), so the two products are also exported on
// their own: the port's DenseAOp sends every k = 2 product of an f32 factor
// on an f32, bf16 or e4m3 A here, and the lane-stacked products of a
// best-of-R rank-2 solve (R lanes, 2R factor rows, R <= 8; the JAX
// package's vmap over restarts, smallk_tpu/engines/hierclust.py:238-241)
// too, so that A is read once a product whatever R is.
//
// What bounds it on the card: one product reads A once and does 2 k m w
// flops (k = 2R rows), 1 flop per byte in f32 and 2 in bf16 at k = 2, far
// below the card's ~20 f32 flops per HBM byte up to k = 16.  A product on
// an A larger than the 50 MB L2 (the hierclust root, 12411 x 7984 bf16 =
// 198 MB) is bound by HBM bandwidth.  The loop re-reads an A that stays in
// L2 at P3's probe shapes (12.7 MB at 12411 x 512 bf16), where f32 FMA
// issue and launch latency bound it.
//
// Design (simple first; the source of each number is the wrapper,
// kernels/rank2_loop.py):
//   - A is read in its own dtype (f32, bf16 widened with __bfloat162float,
//     or e4m3 widened by the fp8 conversion in registers) and summed in
//     f32, as P3's preferred_element_type=jnp.float32; there is no f32 copy
//     of A.
//   - Both products are templates on K, the factor rows (2, 4, ..., 16):
//     a thread keeps K sums in registers.  K = 2 is the k = 2 kernel as it
//     was before lanes, op for op.
//   - wt_a: a thread owns one column j and walks the rows of its slab with
//     Wt[:, i] staged in shared memory, so a warp reads a row of A along
//     contiguous j.  The rows are cut into `slabs` slabs, one grid row each,
//     so that a narrow A still fills the card; each slab writes its partial
//     sums and a second launch adds them in slab order (deterministic, no
//     atomics).  With one slab the first launch writes the result.
//   - h_at: a warp owns row i, its lanes stride along the contiguous row,
//     and a shuffle tree adds the 32 partial sums; H is read through the
//     read-only cache: K of its values for each element of A, the whole
//     of H for each row.  Where H's K rows outgrow L1 (K >= 4 on the
//     20,000-wide graph root, 320 KB) every row streams them from L2, and
//     h_at runs at 7-13% of its bound there (PERF.md).
//   - the loop: max|Wn| is reduced in h_at's epilogue, per block and then
//     one atomicMax per block on the float's bits (for values >= 0 the
//     unsigned order of the bits is the float order, and a NaN, whose bits
//     are above +inf's, wins as torch.max lets it); a last small launch
//     scales Wn into Wt with a correctly rounded add and divide.
//   - a persistent cooperative loop, TMA staging of A, several CTAs per
//     column tile, several rows of A a warp at large K and wgmma are
//     later work.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 256;   // threads of a wt_a block: one column each
constexpr int kTile = 256;   // rows of Wt staged per shared-memory tile
constexpr int kWarps = 8;    // rows (one warp each) of an h_at block
constexpr int kFlat = 256;   // threads of the elementwise launches

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// dst[s, r, j] = sum over the rows i of slab s of Wt[r, i] * A[i, j],
// r < K
template <typename T, int K>
__global__ void __launch_bounds__(kCols)
wt_a_kernel(const T* __restrict__ A, const float* __restrict__ Wt,
            float* __restrict__ dst, int m, int w, int rows_per_slab) {
  __shared__ float wt[K][kTile];
  const int j = blockIdx.x * kCols + threadIdx.x;
  const int s = blockIdx.y;
  const int i0 = s * rows_per_slab;
  const int i1 = min(m, i0 + rows_per_slab);
  float acc[K];
#pragma unroll
  for (int r = 0; r < K; ++r) acc[r] = 0.f;
  for (int t0 = i0; t0 < i1; t0 += kTile) {
    const int nt = min(kTile, i1 - t0);
    __syncthreads();  // the previous tile is consumed
    if (threadIdx.x < nt) {
#pragma unroll
      for (int r = 0; r < K; ++r)
        wt[r][threadIdx.x] = Wt[(size_t)r * m + t0 + threadIdx.x];
    }
    __syncthreads();
    if (j < w) {
      const T* a = A + (size_t)t0 * w + j;
#pragma unroll 8
      for (int q = 0; q < nt; ++q) {
        const float v = widen(a[(size_t)q * w]);
#pragma unroll
        for (int r = 0; r < K; ++r) acc[r] = fmaf(wt[r][q], v, acc[r]);
      }
    }
  }
  if (j < w) {
#pragma unroll
    for (int r = 0; r < K; ++r)
      dst[((size_t)s * K + r) * w + j] = acc[r];
  }
}

// out[e] = sum over s, in order, of partial[s, e], e over the (2, w) result
__global__ void slab_sum_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int count,
                                int slabs) {
  const int e = blockIdx.x * kFlat + threadIdx.x;
  if (e >= count) return;
  float acc = 0.f;
  for (int s = 0; s < slabs; ++s) acc += partial[(size_t)s * count + e];
  out[e] = acc;
}

// out[r, i] = sum_j H[r, j] * A[i, j], r < K; with maxbits (the loop,
// K = 2), also the running max over |out| as float bits
template <typename T, int K>
__global__ void __launch_bounds__(kWarps * 32)
h_at_kernel(const T* __restrict__ A, const float* __restrict__ H,
            float* __restrict__ out, unsigned int* __restrict__ maxbits,
            int m, int w) {
  __shared__ unsigned int block_max[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + warp;
  float acc[K];
#pragma unroll
  for (int r = 0; r < K; ++r) acc[r] = 0.f;
  if (i < m) {  // uniform across the warp
    const T* a = A + (size_t)i * w;
    for (int j = lane; j < w; j += 32) {
      const float v = widen(a[j]);
#pragma unroll
      for (int r = 0; r < K; ++r)
        acc[r] = fmaf(__ldg(H + (size_t)r * w + j), v, acc[r]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < K; ++r)
      acc[r] += __shfl_down_sync(0xffffffffu, acc[r], off);
  }
  if (lane == 0 && i < m) {
#pragma unroll
    for (int r = 0; r < K; ++r) out[(size_t)r * m + i] = acc[r];
  }
  if (maxbits == nullptr) return;  // uniform across the block
  if (lane == 0) {
    unsigned int b = 0u;
#pragma unroll
    for (int r = 0; r < K; ++r) b = max(b, __float_as_uint(fabsf(acc[r])));
    block_max[warp] = i < m ? b : 0u;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int b = block_max[0];
    for (int q = 1; q < kWarps; ++q) b = max(b, block_max[q]);
    atomicMax(maxbits, b);
  }
}

// Wt = Wn / (max|Wn| + 1), rounded as the plain version's f32 ops
__global__ void scale_kernel(const float* __restrict__ Wn,
                             float* __restrict__ Wt,
                             const unsigned int* __restrict__ maxbits,
                             int count) {
  const int e = blockIdx.x * kFlat + threadIdx.x;
  if (e >= count) return;
  const float s = __fadd_rn(__uint_as_float(*maxbits), 1.0f);
  Wt[e] = __fdiv_rn(Wn[e], s);
}

int blocks(long long count, int per_block) {
  return (int)((count + per_block - 1) / per_block);
}

template <typename T, int K>
cudaError_t launch_wt_a(const T* A, const float* Wt, float* out,
                        float* partial, int m, int w, int slabs,
                        int rows_per_slab, cudaStream_t stream) {
  float* dst = slabs == 1 ? out : partial;
  const dim3 grid((unsigned)blocks(w, kCols), (unsigned)slabs);
  wt_a_kernel<T, K><<<grid, kCols, 0, stream>>>(A, Wt, dst, m, w,
                                                rows_per_slab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return err;
  slab_sum_kernel<<<blocks((long long)K * w, kFlat), kFlat, 0, stream>>>(
      partial, out, K * w, slabs);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_h_at(const T* A, const float* H, float* out,
                        unsigned int* maxbits, int m, int w,
                        cudaStream_t stream) {
  h_at_kernel<T, K><<<blocks(m, kWarps), kWarps * 32, 0, stream>>>(
      A, H, out, maxbits, m, w);
  return cudaGetLastError();
}

bool bad_shape(int m, int w, int slabs, int rows_per_slab) {
  return m < 1 || w < 1 || slabs < 1 || slabs > 65535 || rows_per_slab < 1 ||
         (long long)slabs * rows_per_slab < m;
}

// The product's launch for k factor rows: K = k, for the even k the
// lane-stacked products take (2, 4, ..., 16); anything else is refused.
#define SMALLK_BY_ROWS(k, CALL)                      \
  switch (k) {                                       \
    case 2: return (int)CALL(2);                     \
    case 4: return (int)CALL(4);                     \
    case 6: return (int)CALL(6);                     \
    case 8: return (int)CALL(8);                     \
    case 10: return (int)CALL(10);                   \
    case 12: return (int)CALL(12);                   \
    case 14: return (int)CALL(14);                   \
    case 16: return (int)CALL(16);                   \
    default: return (int)cudaErrorInvalidValue;      \
  }

template <typename T>
int wt_a(const void* A, const void* Wt, void* out, void* partial, int m,
         int w, int k, int slabs, int rows_per_slab, void* stream,
         int device) {
  if (bad_shape(m, w, slabs, rows_per_slab)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
#define SMALLK_WT_A(K)                                                     \
  launch_wt_a<T, K>((const T*)A, (const float*)Wt, (float*)out,            \
                    (float*)partial, m, w, slabs, rows_per_slab,           \
                    (cudaStream_t)stream)
  SMALLK_BY_ROWS(k, SMALLK_WT_A)
#undef SMALLK_WT_A
}

template <typename T>
int h_at(const void* A, const void* H, void* out, int m, int w, int k,
         void* stream, int device) {
  if (bad_shape(m, w, 1, m)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
#define SMALLK_H_AT(K)                                                     \
  launch_h_at<T, K>((const T*)A, (const float*)H, (float*)out, nullptr, m, \
                    w, (cudaStream_t)stream)
  SMALLK_BY_ROWS(k, SMALLK_H_AT)
#undef SMALLK_H_AT
}

// Wt (2, m) holds the start and is overwritten by the result; H (2, w),
// Wn (2, m), partial (slabs, 2, w) and maxbits (one word) are scratch.
template <typename T>
int loop(const void* A, void* Wt, void* H, void* Wn, void* partial,
         void* maxbits, int m, int w, int iters, int slabs, int rows_per_slab,
         void* stream, int device) {
  if (bad_shape(m, w, slabs, rows_per_slab) || iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const T* a = (const T*)A;
  float* wt = (float*)Wt;
  unsigned int* mx = (unsigned int*)maxbits;
  for (int it = 0; it < iters; ++it) {
    err = cudaMemsetAsync(mx, 0, sizeof(unsigned int), s);
    if (err != cudaSuccess) return (int)err;
    err = launch_wt_a<T, 2>(a, wt, (float*)H, (float*)partial, m, w, slabs,
                            rows_per_slab, s);
    if (err != cudaSuccess) return (int)err;
    err = launch_h_at<T, 2>(a, (const float*)H, (float*)Wn, mx, m, w, s);
    if (err != cudaSuccess) return (int)err;
    scale_kernel<<<blocks(2LL * m, kFlat), kFlat, 0, s>>>(
        (const float*)Wn, wt, mx, 2 * m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 when every launch was accepted.  k is
// the factor's rows (2R for R lanes).
#define SMALLK_RANK2_PRODUCTS(SUFFIX, T)                                      \
  int smallk_wt_a_##SUFFIX(const void* A, const void* Wt, void* out,          \
                           void* partial, int m, int w, int k, int slabs,     \
                           int rows_per_slab, void* stream, int device) {     \
    return wt_a<T>(A, Wt, out, partial, m, w, k, slabs, rows_per_slab,        \
                   stream, device);                                           \
  }                                                                           \
  int smallk_h_at_##SUFFIX(const void* A, const void* H, void* out, int m,    \
                           int w, int k, void* stream, int device) {          \
    return h_at<T>(A, H, out, m, w, k, stream, device);                       \
  }

SMALLK_RANK2_PRODUCTS(f32, float)
SMALLK_RANK2_PRODUCTS(bf16, __nv_bfloat16)
SMALLK_RANK2_PRODUCTS(f8, __nv_fp8_e4m3)

int smallk_rank2_loop_f32(const void* A, void* Wt, void* H, void* Wn,
                          void* partial, void* maxbits, int m, int w,
                          int iters, int slabs, int rows_per_slab,
                          void* stream, int device) {
  return loop<float>(A, Wt, H, Wn, partial, maxbits, m, w, iters, slabs,
                     rows_per_slab, stream, device);
}

int smallk_rank2_loop_bf16(const void* A, void* Wt, void* H, void* Wn,
                           void* partial, void* maxbits, int m, int w,
                           int iters, int slabs, int rows_per_slab,
                           void* stream, int device) {
  return loop<__nv_bfloat16>(A, Wt, H, Wn, partial, maxbits, m, w, iters,
                             slabs, rows_per_slab, stream, device);
}

const char* smallk_rank2_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
