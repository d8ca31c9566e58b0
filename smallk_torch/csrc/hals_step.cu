// One whole HALS iteration in one launch, for Hopper (sm_90a).
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
// each W column needs a block-wide reduction (its norm) before the next one
// may use it.  So the step is bound by latency (L2 round trips, barriers,
// reductions), not by HBM bandwidth or the FP units; and the step it
// replaces, ~300 small torch ops, is bound by the host's dispatch of them.
//
// Precision: the factors and every value the plain version holds as a
// tensor between ops (W, H, W'A and the outputs) are f32, but sums,
// products and the sweep arithmetic run in f64, and the k x k Grams are
// kept in f64.  The step is a chain of cancellations (AH' - W HH',
// W'A - W'W H, W HH' - AH'), so f32 sums taken in two different orders
// disagree by more than the reference's Pallas-vs-XLA tolerances at
// 256 x 256 and above.  With f64 sums the kernel stays within those
// tolerances of the plain version evaluated in f64.  FP64 runs at half the
// FP32 rate on Hopper, which a latency-bound kernel does not notice.
//
// Design:
//   - One CTA of 1024 threads per step.  The parallelism lies inside each
//     rank-1 update (across m or n); several CTAs or a cluster are later
//     work.
//   - Shared memory holds the factor-side state: W^T (k, m) and AH'^T
//     (k, m) in f32, so that the thread that owns row i reads column c
//     without bank conflicts; H and W'A (k, n) in f32; HH' and W'W (k, k)
//     in f64; and the reduction scratch.  kernels/hals_step.py:smem_bytes
//     mirrors `smem_bytes` here, and hals_fits derives the fit from it.
//   - A is read from global memory in its own dtype (f32 or bf16, widened
//     as it is read, as DenseAOp.mm_tn upcasts it).
//   - W sweep: a thread owns rows i, i + 1024, ...  Row i of column c
//     depends only on row i of W, so the only barrier per column is the one
//     inside the block reduction of (sum of squares, count of nonzeros),
//     double-buffered so that one barrier suffices.  The clamp and the
//     all-zero test see w rounded to f32, as the plain version's are.
//   - H sweep: column j of H depends only on column j, so a thread owns
//     columns j and sweeps all k rows with no barrier at all.
//   - W'A: thread (g, j) sums rows g, g + G, ... of column j, 8 rows of
//     W'A at a time in registers; the G partial sums are added in group
//     order, so the result does not depend on scheduling.  AH' and gradW:
//     a warp per row of A, lanes across n, butterfly reductions.  Grams: a
//     warp per entry.  The A loops are unrolled so that several loads from
//     L2 are in flight.  No cuBLAS, no library kernel.
//   - The clamp is written with isnan and <, never fmaxf, and the library
//     is built without --use_fast_math, so division and sqrt are IEEE:
//     HH'[c,c] = 0 gives the same Inf/NaN as the plain version.
//   - wgmma for the A-products, TMA staging of A in shared memory, and
//     several CTAs per step are later work.

#include <cfloat>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kChunk = 8;        // f64 accumulators per thread in A-products
constexpr int kRedDoubles = 128;  // [2 buffers][2 values][32 warps]
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may opt into

__host__ __device__ inline size_t smem_bytes(int m, int n, int k) {
  return sizeof(double) * (2 * (size_t)k * k + kRedDoubles) +
         sizeof(float) * (2 * (size_t)k * m + 2 * (size_t)k * n);
}

__device__ __forceinline__ double load_a(const float* a, size_t i) {
  return (double)a[i];
}
__device__ __forceinline__ double load_a(const __nv_bfloat16* a, size_t i) {
  return (double)__bfloat162float(a[i]);
}

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

// Block-wide sums of (a, b), bitwise equal in every thread.  `red` holds
// 64 doubles; callers alternate two buffers, so one barrier suffices: a
// warp writes a buffer again only after every thread has passed the next
// call's barrier, that is, after every thread has read this call's sums.
__device__ __forceinline__ double2 block_sum2(double a, double b,
                                              double* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  const bool have = lane < (int)(blockDim.x >> 5);
  return make_double2(warp_sum(have ? red[lane] : 0.0),
                      warp_sum(have ? red[32 + lane] : 0.0));
}

template <typename TA>
__global__ void __launch_bounds__(kThreads)
hals_step_kernel(const TA* __restrict__ A, const float* __restrict__ W0,
                 const float* __restrict__ H0, const float* __restrict__ HHt0,
                 const float* __restrict__ AHt0, float* __restrict__ W_out,
                 float* __restrict__ H_out, float* __restrict__ gW,
                 float* __restrict__ gH, float* __restrict__ HHt_out,
                 float* __restrict__ AHt_out, uint8_t* __restrict__ ok,
                 int m, int n, int k) {
  extern __shared__ __align__(16) double smem[];
  double* HHt = smem;                     // [k][k]  input, then HH' new
  double* WtW = HHt + (size_t)k * k;      // [k][k]
  double* red = WtW + (size_t)k * k;      // [2][64]
  float* Wt = reinterpret_cast<float*>(red + kRedDoubles);  // [k][m]  W^T
  float* AHtT = Wt + (size_t)k * m;       // [k][m]  AH'^T (input)
  float* H = AHtT + (size_t)k * m;        // [k][n]
  float* WtA = H + (size_t)k * n;         // [k][n]

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  // stage the inputs; i runs fastest so that the transposed stores are
  // conflict-free
  for (int idx = tid; idx < m * k; idx += nt) {
    const int c = idx / m;
    const int i = idx - c * m;
    Wt[idx] = W0[(size_t)i * k + c];
    AHtT[idx] = AHt0[(size_t)i * k + c];
  }
  for (int idx = tid; idx < k * n; idx += nt) H[idx] = H0[idx];
  for (int idx = tid; idx < k * k; idx += nt) HHt[idx] = (double)HHt0[idx];
  __syncthreads();

  // 1. W column sweep.  Row i of the update reads row i of W only, and the
  // thread that owns row i is the only one that writes it.
  const double eps = (double)FLT_EPSILON;
  for (int c = 0; c < k; ++c) {
    const double hcc = HHt[c * k + c];
    double ss = 0.0;
    double nz = 0.0;
    for (int i = tid; i < m; i += nt) {
      double dot = 0.0;
      for (int j = 0; j < k; ++j) dot = fma((double)Wt[j * m + i], HHt[j * k + c], dot);
      const float w = clamp0(
          (float)((double)Wt[c * m + i] + ((double)AHtT[c * m + i] - dot) / hcc));
      Wt[c * m + i] = w;
      ss = fma((double)w, (double)w, ss);
      nz += (w != 0.f) ? 1.0 : 0.0;
    }
    const double2 tot = block_sum2(ss, nz, red + 64 * (c & 1));
    const bool all_zero = tot.y == 0.0;
    const double norm = all_zero ? sqrt((double)m * (eps * eps)) : sqrt(tot.x);
    for (int i = tid; i < m; i += nt) {
      const double w = all_zero ? eps : (double)Wt[c * m + i];
      Wt[c * m + i] = (float)(w / norm);
    }
  }
  __syncthreads();

  // 2a. W'W: a warp per entry, lanes across m
  for (int o = warp; o < k * k; o += nwarps) {
    const int a = o / k;
    const int b = o - a * k;
    double s = 0.0;
    for (int i = lane; i < m; i += 32) {
      s = fma((double)Wt[a * m + i], (double)Wt[b * m + i], s);
    }
    s = warp_sum(s);
    if (lane == 0) WtW[o] = s;
  }

  // 2b. W'A: thread (g, j) sums rows g, g + G, ... of column j for 8 rows
  // of W'A at a time; G > 1 only when n * G <= nt, so one pass covers all
  // (g, j).  The partial sums are added in group order, one group per
  // barrier.
  {
    const int G = max(1, min(nt / n, m));
    for (int base = 0; base < n * G; base += nt) {
      const int idx = base + tid;
      const bool active = idx < n * G;
      const int g = idx / n;
      const int j = idx - g * n;
      for (int r0 = 0; r0 < k; r0 += kChunk) {
        const int rc = min(kChunk, k - r0);
        double acc[kChunk];
#pragma unroll
        for (int q = 0; q < kChunk; ++q) acc[q] = 0.0;
        if (active) {
#pragma unroll 4
          for (int i = g; i < m; i += G) {
            const double a = load_a(A, (size_t)i * n + j);
#pragma unroll
            for (int q = 0; q < kChunk; ++q) {
              if (q < rc) acc[q] = fma((double)Wt[(r0 + q) * m + i], a, acc[q]);
            }
          }
        }
        for (int gg = 0; gg < G; ++gg) {
          if (active && g == gg) {
#pragma unroll
            for (int q = 0; q < kChunk; ++q) {
              if (q < rc) {
                float* p = &WtA[(r0 + q) * n + j];
                // partial sums travel between groups in f32 only when
                // G > 1; the last group's add rounds once more
                *p = (float)(gg == 0 ? acc[q] : (double)*p + acc[q]);
              }
            }
          }
          __syncthreads();
        }
      }
    }
  }

  // 3. H row sweep.  Column j of the update reads column j of H only, so a
  // thread sweeps its columns through all k rows with no barrier.
  for (int j = tid; j < n; j += nt) {
    for (int r = 0; r < k; ++r) {
      double dot = 0.0;
      for (int l = 0; l < k; ++l) dot = fma(WtW[r * k + l], (double)H[l * n + j], dot);
      H[r * n + j] = clamp0((float)((double)H[r * n + j] +
                                    ((double)WtA[r * n + j] - dot) / WtW[r * k + r]));
    }
  }
  __syncthreads();

  // 4. gradH = W'W H - W'A, and H out
  bool bad = false;
  for (int idx = tid; idx < k * n; idx += nt) {
    const int r = idx / n;
    const int j = idx - r * n;
    double dot = 0.0;
    for (int l = 0; l < k; ++l) dot = fma(WtW[r * k + l], (double)H[l * n + j], dot);
    const float g = (float)(dot - (double)WtA[idx]);
    gH[idx] = g;
    H_out[idx] = H[idx];
    bad |= !isfinite(g);
  }

  // 5a. HH' (the old HH' was last read in the W sweep): a warp per entry
  for (int o = warp; o < k * k; o += nwarps) {
    const int a = o / k;
    const int b = o - a * k;
    double s = 0.0;
    for (int j = lane; j < n; j += 32) {
      s = fma((double)H[a * n + j], (double)H[b * n + j], s);
    }
    s = warp_sum(s);
    if (lane == 0) {
      HHt[o] = s;
      HHt_out[o] = (float)s;
    }
  }
  __syncthreads();

  // 5b + 6. AH' and gradW = W HH' - AH', W out: a warp per row i of A,
  // lanes across n, 8 columns of AH' at a time
  for (int i = warp; i < m; i += nwarps) {
    for (int c0 = 0; c0 < k; c0 += kChunk) {
      const int cc = min(kChunk, k - c0);
      double acc[kChunk];
#pragma unroll
      for (int q = 0; q < kChunk; ++q) acc[q] = 0.0;
#pragma unroll 4
      for (int j = lane; j < n; j += 32) {
        const double a = load_a(A, (size_t)i * n + j);
#pragma unroll
        for (int q = 0; q < kChunk; ++q) {
          if (q < cc) acc[q] = fma(a, (double)H[(c0 + q) * n + j], acc[q]);
        }
      }
      double mine = 0.0;
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        if (q < cc) {  // the same for the whole warp
          const double s = warp_sum(acc[q]);
          if (lane == q) mine = s;
        }
      }
      if (lane < cc) {
        const int c = c0 + lane;
        double dot = 0.0;
        for (int j = 0; j < k; ++j) dot = fma((double)Wt[j * m + i], HHt[j * k + c], dot);
        const float g = (float)(dot - mine);
        const size_t o = (size_t)i * k + c;
        AHt_out[o] = (float)mine;
        gW[o] = g;
        W_out[o] = Wt[c * m + i];
        bad |= !isfinite(g);
      }
    }
  }

  const int any_bad = __syncthreads_or(bad ? 1 : 0);
  if (tid == 0) *ok = any_bad ? 0 : 1;
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

  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    err = cudaFuncSetAttribute(hals_step_kernel<TA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = kMaxSmem;
  }
  hals_step_kernel<TA><<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const TA*)A, (const float*)W, (const float*)H, (const float*)HHt,
      (const float*)AHt, (float*)W_out, (float*)H_out, (float*)gW,
      (float*)gH, (float*)HHt_out, (float*)AHt_out, (uint8_t*)ok, m, n, k);
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

const char* smallk_hals_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
