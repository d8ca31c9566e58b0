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
// best-of-R rank-2 solve (R lanes, K = 2R factor rows, R <= 8; the JAX
// package's vmap over restarts, smallk_tpu/engines/hierclust.py:238-241)
// too, so that A is read once a product whatever R is.
//
// What bounds it on the card: one product reads A once and does 2 K m w
// flops, K/2 flops a byte of A in f32, K in bf16 and 2K in e4m3, against
// the card's ~20 f32 flops (outside the tensor cores) per HBM byte.  So
// every f32 and bf16 product, and e4m3 up to K = 10, is bound by the bytes
// of A; only e4m3 at K >= 12 is bound by f32 FMA.  The design is about
// bytes: A is read once, with wide loads, and the factor is never re-read
// from memory per row of A.
//
// Design (the plan's run-time numbers, slabs and splits, are computed by
// the wrapper, kernels/rank2_loop.py, from (m, w, K, dtype) alone; the
// widths a lane and the rows a block are this build's, Shape below; a plan
// that does not cover A once, or whose splits are not whole steps, is
// refused):
//   - A is read in its own dtype and summed in f32, as P3's
//     preferred_element_type=jnp.float32; there is no f32 copy of A.  A lane
//     loads 16 contiguous bytes of a row (4 f32, 8 bf16, 16 e4m3), or 8 or 4
//     where K is large, so that a warp-load moves 128-512 contiguous bytes;
//     bf16 is widened by shifts and e4m3 by the paired fp8 -> half2
//     conversion, in registers.
//   - The vector rule: the 16-byte loads need 16-byte-aligned rows (A's
//     pointer and its row's bytes both multiples of 16, `vector_path` in the
//     wrapper).  Every hierclust node operand passes it: a bucket width,
//     or an exact width gathered at whole 16-byte rows
//     (engines/hierclust.py row_width).  An A that fails it (a root whose
//     rows are not 16-byte aligned, a sliced view) takes the scalar path
//     of the same kernels and plan: its words are assembled element by
//     element, the same words, so its sums are the vector path's bit for
//     bit.
//   - wt_a: a block of 8 warps owns 32 C columns (C a lane) and a slab of
//     rows; its warps take every 8th row, each lane keeping K x C <= 64
//     sums (C = 16 at K = 2, 8 up to K = 8 (bf16: 6), 4 above; 16 bytes
//     at most).  Wt's columns for the next 128 rows are staged in shared
//     memory by cp.async while the current ones are used (two stages);
//     each lane loads 4 or 8 rows of A before it sums them, a stage's first
//     rows before it waits for the stage.  The 8 warps' sums are added in
//     warp order through shared memory; the slabs' partial sums go to a
//     scratch buffer, and a second launch adds them in slab order.
//   - h_at: a block of 8 warps owns 32 rows of A (4 a warp, so that the
//     4 x K sums stay in registers) and a split of the columns, which it
//     walks in stages of NV steps of 32 V columns (V a lane: a step is one
//     warp-load a row); H's K x 32 V NV stage (16 KB at most) is staged in
//     shared memory by cp.async, two stages, and read by every row of the
//     block, so L2 serves H once a block and not once a row.  Where the
//     registers allow, a lane loads a stage's first step of A before it
//     waits for the stage.  A lane
//     reads its 16 bytes of A contiguous, so its H values are V contiguous
//     columns: their 16-byte groups are swizzled in shared memory so that
//     a warp reads them without bank conflicts.  A lane's sums are added
//     across the warp by a shuffle tree.  The splits of a row block (at
//     most 8) are one thread-block cluster: they add their sums through
//     distributed shared memory, in split order, so h_at is one launch
//     with no scratch.
//   - h_at at K = 2 (the rank-2 step's own product) is built for four
//     blocks an SM, 64 registers a thread, and walks a stage a step at a
//     time: its few sums leave the latency to the SM's many warps.  Above,
//     two blocks an SM, 128 registers, and a stage's steps unrolled.
//   - The plan cuts a product into about one block for each 192 KB of A
//     and no fewer than the card holds at once, so that a large A fills
//     the card in several waves and a small one in a single wave of blocks
//     that are not too short.  No float atomics: the same inputs give the
//     same bits, captured or eager.
//   - the loop: max|Wn| is taken after the final sum (in h_at's epilogue,
//     by the blocks that store Wn), per block and then one atomicMax per
//     block on the float's bits (for values >= 0 the unsigned order of the
//     bits is the float order, and a NaN, whose bits are above +inf's, wins
//     as torch.max lets it); a last small launch scales Wn into Wt with a
//     correctly rounded add and divide.
//   - No tensor cores: the sums must stay f32-accurate (the JAX package
//     computes at Precision.HIGHEST, and W and H are f32), and every f32 and
//     bf16 product is bound by bytes.  A split-bf16 mma path (A exact in
//     bf16, the f32 factor in two or three bf16 parts) could only pay for
//     e4m3 at K >= 12.

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;    // threads of a product block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStageRows = 128;  // rows of Wt a wt_a stage holds
constexpr int kFlat = 256;       // threads of the elementwise launches
constexpr int kMaxSplits = 8;    // h_at's column splits: a portable cluster

constexpr int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}
constexpr int imin(int a, int b) { return a < b ? a : b; }
constexpr int imax(int a, int b) { return a > b ? a : b; }

// The plan's constants for an A of element type T and K factor rows (the
// wrapper's wt_a_plan and h_at_plan compute the same).
template <typename T, int K>
struct Shape {
  static constexpr int kItem = (int)sizeof(T);
  // wt_a: columns a lane (16 bytes at most), 16 at K = 2, 8 up to K = 8
  // (bf16: 6) and 4 above, so that its K x kWtCols sums fit in 128
  // registers with the rows of A in flight; and rows of A a lane loads at
  // once, 8 where its sums are few
  static constexpr int kWtCols = imin(
      16 / kItem, K == 2 ? 16 : K <= 8 && K * kItem <= 12 ? 8 : 4);
  static constexpr int kWtLoadRows = K * kWtCols <= 32 ? 8 : 4;
  // h_at: rows a warp; columns a lane, a warp-load a row: 16 bytes (8
  // above K = 8, for the registers), at most 128 / K (H's columns of a
  // step, K x 32 kHCols floats, <= 16 KB) and at least 4 (a float4 of H);
  // and steps a stage: as many as 16 KB of H's stage holds
  static constexpr int kHRows = 4;
  static constexpr int kHCols =
      imax(4, imin((K <= 8 ? 16 : 8) / kItem, pow2_floor(128 / K)));
  static constexpr int kHSteps = imax(1, pow2_floor(128 / (K * kHCols)));
  static constexpr int kHWords = kHCols * kItem / 4;
  // h_at: blocks an SM the registers must allow (4 at K = 2: 64 registers
  // a thread, a step at a time, the latency hidden by many warps; 2 above:
  // 128 registers and the stage's steps unrolled), and whether a stage's
  // first step of A is loaded before the stage is waited for (where its
  // sums, two steps of A and their widened values take at most 64 of the
  // 128 registers)
  static constexpr int kHBlocks = K == 2 ? 4 : 2;
  // (h_at's steps after a stage's first: unrolled as said above)
  static constexpr int kHUnroll = kHBlocks == 4 ? 1 : imax(1, kHSteps - 1);
  static constexpr bool kHHoist =
      kHBlocks == 2 &&
      kHRows * K + 2 * kHRows * kHWords + (kItem < 4 ? 4 * kHRows : 0) <= 64;
};

template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using type = unsigned int;
};
template <>
struct Bits<__nv_bfloat16> {
  using type = unsigned short;
};
template <>
struct Bits<__nv_fp8_e4m3> {
  using type = unsigned char;
};

// N elements of A at p as N * sizeof(T) / 4 words, in memory order: one
// 16-, 8- or 4-byte load on the vector path (p aligned to it), else element
// by element into the same words (so the sums are the vector path's, bit
// for bit).  Elements from `valid` on are 0 (all of them where valid <= 0),
// and nothing past them is read.
template <typename T, int N>
__device__ __forceinline__ void load_a(unsigned int (&r)[N * sizeof(T) / 4],
                                       const T* p, int valid, bool vec) {
  constexpr int kWords = N * (int)sizeof(T) / 4;
  if (vec && valid >= N) {
    if constexpr (kWords == 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      r[0] = v.x;
      r[1] = v.y;
      r[2] = v.z;
      r[3] = v.w;
    } else if constexpr (kWords == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      r[0] = v.x;
      r[1] = v.y;
    } else {
      r[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    }
    return;
  }
  using B = typename Bits<T>::type;
  constexpr int kPer = 4 / (int)sizeof(T);  // elements a word
  const B* q = reinterpret_cast<const B*>(p);
#pragma unroll
  for (int g = 0; g < kWords; ++g) {
    unsigned int x = 0u;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int n = g * kPer + e;
      if (n < valid)
        x |= (unsigned int)__ldg(q + n) << (8 * (int)sizeof(T) * e);
    }
    r[g] = x;
  }
}

// Four elements, from the word r[0] on, widened exactly to f32.
template <typename T>
__device__ __forceinline__ void widen4(const unsigned int* r, float (&a)[4]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = __uint_as_float(r[e]);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      a[2 * g] = __uint_as_float(r[g] << 16);
      a[2 * g + 1] = __uint_as_float(r[g] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          (__nv_fp8x2_storage_t)((r[0] >> (16 * g)) & 0xffffu), __NV_E4M3);
      a[2 * g] = __half2float(__ushort_as_half(h.x));
      a[2 * g + 1] = __half2float(__ushort_as_half(h.y));
    }
  }
}

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

// Asynchronous copies of 4 and 16 bytes that read the first `src_bytes`
// of the source (0 or all) and zero-fill the rest.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
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

// dst[s, r, j] = sum over the rows i of slab s of Wt[r, i] * A[i, j],
// r < K (s = blockIdx.y; with one slab dst is the result)
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 2)
wt_a_kernel(const T* __restrict__ A, const float* __restrict__ Wt,
            float* __restrict__ dst, int m, int w, int rows_per_slab,
            bool vec) {
  constexpr int C = Shape<T, K>::kWtCols;
  constexpr int kBlockCols = 32 * C;
  constexpr int kWords = C * (int)sizeof(T) / 4;
  constexpr int kWarpRows = kStageRows / kWarps;  // a warp's rows a stage
  constexpr int kLoadRows = Shape<T, K>::kWtLoadRows;
  __shared__ float ws[2][K][kStageRows];
  __shared__ __align__(16) float red[kWarps][kBlockCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kBlockCols + lane * C;  // this lane's columns
  const int s = blockIdx.y;
  const int i0 = s * rows_per_slab;
  const int i1 = min(m, i0 + rows_per_slab);
  const int stages = (i1 - i0 + kStageRows - 1) / kStageRows;

  // Wt[:, r0 : r0 + kStageRows] into stage b, 0 past the slab
  auto stage = [&](int t, int b) {
    const int r0 = i0 + t * kStageRows;
    for (int e = threadIdx.x; e < K * kStageRows; e += kThreads) {
      const int r = e / kStageRows, q = e % kStageRows;
      const bool in = r0 + q < i1;
      cp_async4(&ws[b][r][q], in ? Wt + (size_t)r * m + r0 + q : Wt,
                in ? 4 : 0);
    }
    cp_commit();
  };

  // rows u0 .. u0 + kLoadRows - 1 of a stage (this warp's) into raw
  auto load_rows = [&](unsigned int (&raw)[kLoadRows][kWords], int r0,
                       int u0) {
#pragma unroll
    for (int u = 0; u < kLoadRows; ++u) {
      const int i = r0 + warp + kWarps * (u0 + u);
      load_a<T, C>(raw[u], A + (size_t)min(i, m - 1) * w + j,
                   i < i1 ? w - j : 0, vec);
    }
  };
  float acc[K][C];
#pragma unroll
  for (int r = 0; r < K; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  // the sums of those rows, with stage b's Wt
  auto sum_rows = [&](const unsigned int (&raw)[kLoadRows][kWords], int b,
                      int u0) {
#pragma unroll
    for (int u = 0; u < kLoadRows; ++u) {
      const int q = warp + kWarps * (u0 + u);
      float f[K];
#pragma unroll
      for (int r = 0; r < K; ++r) f[r] = ws[b][r][q];
#pragma unroll
      for (int c = 0; c < C / 4; ++c) {
        float a[4];
        widen4<T>(raw[u] + c * (int)sizeof(T), a);
#pragma unroll
        for (int r = 0; r < K; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][4 * c + e] = fmaf(f[r], a[e], acc[r][4 * c + e]);
      }
    }
  };
  if (stages > 0) stage(0, 0);
  for (int t = 0; t < stages; ++t) {
    const int b = t & 1;
    const int r0 = i0 + t * kStageRows;
    // this warp's rows of the stage (rows past the slab read as 0)
    const int mine = (min(kStageRows, i1 - r0) - warp + kWarps - 1) / kWarps;
    // A does not wait for Wt: the first rows are loaded before the stage
    unsigned int first[kLoadRows][kWords];
    load_rows(first, r0, 0);
    if (t + 1 < stages)
      stage(t + 1, b ^ 1);
    else
      cp_commit();  // an empty group: the wait below counts groups
    cp_wait<1>();
    __syncthreads();  // stage b is in shared memory
    sum_rows(first, b, 0);
#pragma unroll
    for (int u0 = kLoadRows; u0 < kWarpRows; u0 += kLoadRows) {
      if (u0 >= mine) break;  // uniform across the warp
      unsigned int raw[kLoadRows][kWords];
      load_rows(raw, r0, u0);
      sum_rows(raw, b, u0);
    }
    __syncthreads();  // stage b is consumed before stage t + 2 fills it
  }

  // the 8 warps' sums, added in warp order, one factor row at a time
  float* out = dst + (size_t)s * K * w;
#pragma unroll
  for (int r = 0; r < K; ++r) {
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<float4*>(&red[warp][lane * C + c]) = make_float4(
          acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
    __syncthreads();
    for (int e = threadIdx.x; e < kBlockCols; e += kThreads) {
      float v = red[0][e];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) v += red[q][e];
      const int col = blockIdx.x * kBlockCols + e;
      if (col < w) out[(size_t)r * w + col] = v;
    }
    __syncthreads();
  }
}

// Where a tile's 4-column group g sits in a stage row of h_at: a lane's
// V / 4 groups (g = lane V / 4 + c) are XOR-swizzled among themselves, so
// that the 8 lanes of a quarter-warp read 8 different 16-byte bank groups.
template <int V>
__device__ __forceinline__ int slot(int g) {
  return g ^ ((g >> 3) & (V / 4 - 1));
}

// out[r, i] = sum_j H[r, j] * A[i, j], r < K.  Block (x, y) sums the rows
// of row block x over the columns of split y; the splits of a row block
// are one thread-block cluster, and they add their sums through
// distributed shared memory in split order.  With maxbits (the loop), also
// the running max over |out| as float bits.  h16: H's rows are 16-byte
// aligned.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, Shape<T, K>::kHBlocks)
h_at_kernel(const T* __restrict__ A, const float* __restrict__ H,
            float* __restrict__ out, unsigned int* __restrict__ maxbits,
            int m, int w, int cols_per_split, bool vec, bool h16) {
  constexpr int RPT = Shape<T, K>::kHRows;
  constexpr int V = Shape<T, K>::kHCols;
  constexpr int NV = Shape<T, K>::kHSteps;
  constexpr int kTile = 32 * V;       // columns of a step: a warp-load a row
  constexpr int kStage = NV * kTile;  // columns of a stage
  constexpr int kWords = V * (int)sizeof(T) / 4;
  constexpr int kRows = kWarps * RPT;  // rows of a block
  __shared__ __align__(16) float hs[2][K][kStage];
  __shared__ float red[kRows * K];
  __shared__ unsigned int block_max[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = blockIdx.x * kRows + warp * RPT;  // this warp's rows
  const int c0 = blockIdx.y * cols_per_split;
  const int c1 = min(w, c0 + cols_per_split);
  const int stages = (c1 - c0 + kStage - 1) / kStage;

  // H[:, j0 : j0 + kStage] into stage b, 0 past the split; each step's
  // 4-column groups at their swizzled slots
  auto stage = [&](int t, int b) {
    const int j0 = c0 + t * kStage;
    if (h16) {
      for (int e = threadIdx.x; e < K * kStage / 4; e += kThreads) {
        const int r = e / (kStage / 4), g = e % (kStage / 4);
        const int v = g / (kTile / 4);
        const bool in = j0 + 4 * g < c1;
        cp_async16(&hs[b][r][v * kTile + 4 * slot<V>(g % (kTile / 4))],
                   in ? H + (size_t)r * w + j0 + 4 * g : H, in ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < K * kStage; e += kThreads) {
        const int r = e / kStage, q = e % kStage;
        const int v = q / kTile, p = q % kTile;
        const bool in = j0 + q < c1;
        cp_async4(&hs[b][r][v * kTile + 4 * slot<V>(p >> 2) + (p & 3)],
                  in ? H + (size_t)r * w + j0 + q : H, in ? 4 : 0);
      }
    }
    cp_commit();
  };
  // this lane's V columns of step v of stage t, for each of its RPT rows
  auto load_step = [&](unsigned int (&raw)[RPT][kWords], int t, int v) {
    const int j = c0 + t * kStage + v * kTile + lane * V;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int i = i0 + q;
      load_a<T, V>(raw[q], A + (size_t)min(i, m - 1) * w + j,
                   i < m ? c1 - j : 0, vec);
    }
  };
  float acc[RPT][K];
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int r = 0; r < K; ++r) acc[q][r] = 0.f;
  // the sums of step v, with stage b's H
  auto sum_step = [&](const unsigned int (&raw)[RPT][kWords], int b, int v) {
#pragma unroll
    for (int c = 0; c < V / 4; ++c) {
      float a[RPT][4];
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        widen4<T>(raw[q] + c * (int)sizeof(T), a[q]);
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const float4 h = *reinterpret_cast<const float4*>(
            &hs[b][r][v * kTile + 4 * slot<V>(lane * (V / 4) + c)]);
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          float x = acc[q][r];
          x = fmaf(h.x, a[q][0], x);
          x = fmaf(h.y, a[q][1], x);
          x = fmaf(h.z, a[q][2], x);
          x = fmaf(h.w, a[q][3], x);
          acc[q][r] = x;
        }
      }
    }
  };

  if (stages > 0) stage(0, 0);
  for (int t = 0; t < stages; ++t) {
    const int b = t & 1;
    const int left = c1 - (c0 + t * kStage);  // the split's columns left
    // where the registers allow, A does not wait for H: the first step is
    // loaded before the stage
    unsigned int first[RPT][kWords];
    if constexpr (Shape<T, K>::kHHoist) load_step(first, t, 0);
    if (t + 1 < stages)
      stage(t + 1, b ^ 1);
    else
      cp_commit();  // an empty group: the wait below counts groups
    cp_wait<1>();
    __syncthreads();  // stage b is in shared memory
    if constexpr (!Shape<T, K>::kHHoist) load_step(first, t, 0);
    sum_step(first, b, 0);
#pragma unroll(Shape<T, K>::kHUnroll)
    for (int v = 1; v < NV; ++v) {
      if (v * kTile >= left) break;  // uniform across the block
      unsigned int raw[RPT][kWords];
      load_step(raw, t, v);
      sum_step(raw, b, v);
    }
    __syncthreads();  // stage b is consumed before stage t + 2 fills it
  }

  // a butterfly over the warp: every lane ends with the same bits
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int r = 0; r < K; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[q][r] += __shfl_xor_sync(0xffffffffu, acc[q][r], off);
  unsigned int bits = 0u;
  if (gridDim.y == 1) {
    // one split: the lanes store the warp's sums
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int r = 0; r < K; ++r)
        if (lane == ((q * K + r) & 31) && i0 + q < m) {
          out[(size_t)r * m + i0 + q] = acc[q][r];
          bits = max(bits, __float_as_uint(fabsf(acc[q][r])));
        }
  } else {
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int r = 0; r < K; ++r)
        if (lane == ((q * K + r) & 31))
          red[(warp * RPT + q) * K + r] = acc[q][r];
    // each block of the cluster adds a share of the row block's sums over
    // the splits, in split order
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int splits = (int)cluster.num_blocks();
    for (int e = (int)cluster.block_rank() * kThreads + threadIdx.x;
         e < kRows * K; e += splits * kThreads) {
      float v = cluster.map_shared_rank(red, 0)[e];
      for (int s = 1; s < splits; ++s)
        v += cluster.map_shared_rank(red, s)[e];
      const int i = blockIdx.x * kRows + e / K;
      if (i < m) {
        out[(size_t)(e % K) * m + i] = v;
        bits = max(bits, __float_as_uint(fabsf(v)));
      }
    }
    cluster.sync();  // no block leaves while another reads its sums
  }
  if (maxbits == nullptr) return;  // uniform across the block
  bits = __reduce_max_sync(0xffffffffu, bits);
  if (lane == 0) block_max[warp] = bits;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 1; q < kWarps; ++q) bits = max(bits, block_max[q]);
    atomicMax(maxbits, bits);
  }
}

// out[e] = sum over s, in order, of partial[s, e] (wt_a's slabs)
__global__ void __launch_bounds__(kFlat)
split_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                 int count, int splits) {
  const int e = blockIdx.x * kFlat + threadIdx.x;
  if (e >= count) return;
  float acc = partial[e];
  for (int s = 1; s < splits; ++s) acc += partial[(size_t)s * count + e];
  out[e] = acc;
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

// The wrapper's plan: every row and column covered once, no split empty,
// and h_at's splits whole steps of this build's columns.  The plan holds
// only what varies at run time; the widths a lane and the rows a block are
// this build's (Shape), which the grid is computed from.
inline bool wt_a_plan_ok(int m, int w, int slabs, int rows_per_slab) {
  return m >= 1 && w >= 1 && slabs >= 1 && slabs <= 65535 &&
         rows_per_slab >= 1 && (long long)slabs * rows_per_slab >= m &&
         (long long)(slabs - 1) * rows_per_slab < m;
}

template <typename T, int K>
bool h_at_plan_ok(int m, int w, int splits, int cols_per_split) {
  return m >= 1 && w >= 1 && cols_per_split >= 1 &&
         cols_per_split % (32 * Shape<T, K>::kHCols) == 0 && splits >= 1 &&
         splits <= kMaxSplits && (long long)splits * cols_per_split >= w &&
         (long long)(splits - 1) * cols_per_split < w;
}

template <typename T, int K>
cudaError_t launch_wt_a(const T* A, const float* Wt, float* out,
                        float* partial, int m, int w, int slabs,
                        int rows_per_slab, bool vec, cudaStream_t stream) {
  constexpr int kBlockCols = 32 * Shape<T, K>::kWtCols;
  float* dst = slabs == 1 ? out : partial;
  const dim3 grid((unsigned)blocks(w, kBlockCols), (unsigned)slabs);
  wt_a_kernel<T, K><<<grid, kThreads, 0, stream>>>(A, Wt, dst, m, w,
                                                   rows_per_slab, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return err;
  split_sum_kernel<<<blocks((long long)K * w, kFlat), kFlat, 0, stream>>>(
      partial, out, K * w, slabs);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_h_at(const T* A, const float* H, float* out,
                        unsigned int* maxbits, int m, int w, int splits,
                        int cols_per_split, bool vec, cudaStream_t stream) {
  // H's rows are 16-byte aligned where A's are (w a multiple of 4) and H's
  // pointer is
  const bool h16 = vec && (reinterpret_cast<uintptr_t>(H) & 15) == 0;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = (unsigned)splits;  // a row block's splits
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks(m, kWarps * Shape<T, K>::kHRows),
                     (unsigned)splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, h_at_kernel<T, K>, A, H, out,
                                       maxbits, m, w, cols_per_split, vec,
                                       h16);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The product's launch for k factor rows: K = k, for the even k the
// lane-stacked products take (2, 4, ..., 16); anything else is refused.
#define SMALLK_BY_ROWS(k, CALL)                      \
  switch (k) {                                       \
    case 2: return CALL(2);                          \
    case 4: return CALL(4);                          \
    case 6: return CALL(6);                          \
    case 8: return CALL(8);                          \
    case 10: return CALL(10);                        \
    case 12: return CALL(12);                        \
    case 14: return CALL(14);                        \
    case 16: return CALL(16);                        \
    default: return (int)cudaErrorInvalidValue;      \
  }

template <typename T, int K>
int run_wt_a(const void* A, const void* Wt, void* out, void* partial, int m,
             int w, int slabs, int rows_per_slab, bool vec,
             cudaStream_t stream) {
  if (!wt_a_plan_ok(m, w, slabs, rows_per_slab))
    return (int)cudaErrorInvalidValue;
  return (int)launch_wt_a<T, K>((const T*)A, (const float*)Wt, (float*)out,
                                (float*)partial, m, w, slabs, rows_per_slab,
                                vec, stream);
}

template <typename T, int K>
int run_h_at(const void* A, const void* H, void* out, int m, int w,
             int splits, int cols_per_split, bool vec, cudaStream_t stream) {
  if (!h_at_plan_ok<T, K>(m, w, splits, cols_per_split))
    return (int)cudaErrorInvalidValue;
  return (int)launch_h_at<T, K>((const T*)A, (const float*)H, (float*)out,
                                nullptr, m, w, splits, cols_per_split, vec,
                                stream);
}

template <typename T>
int wt_a(const void* A, const void* Wt, void* out, void* partial, int m,
         int w, int k, int slabs, int rows_per_slab, int vec, void* stream,
         int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
#define SMALLK_WT_A(K)                                                   \
  run_wt_a<T, K>(A, Wt, out, partial, m, w, slabs, rows_per_slab,        \
                 vec != 0, (cudaStream_t)stream)
  SMALLK_BY_ROWS(k, SMALLK_WT_A)
#undef SMALLK_WT_A
}

template <typename T>
int h_at(const void* A, const void* H, void* out, int m, int w, int k,
         int splits, int cols_per_split, int vec, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
#define SMALLK_H_AT(K)                                                   \
  run_h_at<T, K>(A, H, out, m, w, splits, cols_per_split, vec != 0,      \
                 (cudaStream_t)stream)
  SMALLK_BY_ROWS(k, SMALLK_H_AT)
#undef SMALLK_H_AT
}

// Wt (2, m) holds the start and is overwritten by the result; H (2, w),
// Wn (2, m), wt_a's partial sums (slabs, 2, w) and maxbits (one word) are
// scratch.
template <typename T>
int loop(const void* A, void* Wt, void* H, void* Wn, void* partial,
         void* maxbits, int m, int w, int iters, int slabs,
         int rows_per_slab, int splits, int cols_per_split, int vec,
         void* stream, int device) {
  if (iters < 0 || !wt_a_plan_ok(m, w, slabs, rows_per_slab) ||
      !h_at_plan_ok<T, 2>(m, w, splits, cols_per_split))
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
                            rows_per_slab, vec != 0, s);
    if (err != cudaSuccess) return (int)err;
    err = launch_h_at<T, 2>(a, (const float*)H, (float*)Wn, mx, m, w,
                            splits, cols_per_split, vec != 0, s);
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
// the factor's rows (2R for R lanes); the plan's numbers are the
// wrapper's (kernels/rank2_loop.py: wt_a_plan, h_at_plan, vector_path).
#define SMALLK_RANK2_PRODUCTS(SUFFIX, T)                                      \
  int smallk_wt_a_##SUFFIX(const void* A, const void* Wt, void* out,          \
                           void* partial, int m, int w, int k, int slabs,     \
                           int rows_per_slab, int vec, void* stream,          \
                           int device) {                                      \
    return wt_a<T>(A, Wt, out, partial, m, w, k, slabs, rows_per_slab, vec,   \
                   stream, device);                                           \
  }                                                                           \
  int smallk_h_at_##SUFFIX(const void* A, const void* H, void* out, int m,    \
                           int w, int k, int splits, int cols_per_split,      \
                           int vec, void* stream, int device) {               \
    return h_at<T>(A, H, out, m, w, k, splits, cols_per_split, vec, stream,   \
                   device);                                                   \
  }

SMALLK_RANK2_PRODUCTS(f32, float)
SMALLK_RANK2_PRODUCTS(bf16, __nv_bfloat16)
SMALLK_RANK2_PRODUCTS(f8, __nv_fp8_e4m3)

#define SMALLK_RANK2_LOOP(SUFFIX, T)                                          \
  int smallk_rank2_loop_##SUFFIX(                                             \
      const void* A, void* Wt, void* H, void* Wn, void* partial,              \
      void* maxbits, int m, int w, int iters, int slabs, int rows_per_slab,   \
      int splits, int cols_per_split, int vec, void* stream, int device) {    \
    return loop<T>(A, Wt, H, Wn, partial, maxbits, m, w, iters, slabs,        \
                   rows_per_slab, splits, cols_per_split, vec, stream,        \
                   device);                                                   \
  }

SMALLK_RANK2_LOOP(f32, float)
SMALLK_RANK2_LOOP(bf16, __nv_bfloat16)

const char* smallk_rank2_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
