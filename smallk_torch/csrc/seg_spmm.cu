// Sorted segmented gather-SpMM: the products of the static-shape sparse node
// operand (ops/ell_cols.ChunkColsAOp), for Hopper (sm_90a).
//
// It replaces no Pallas kernel.  The JAX package computes these products in
// XLA (smallk_tpu/ops/ell_cols.py, GatheredColsAOp.mm_tn / mm_nt: a gather
// of factor rows, an einsum, a sorted jax.ops.segment_sum).  It was written
// because a measurement on the H100 showed that a hand kernel pays there:
// that formulation in torch ops (torch.segment_reduce) took 63.4 ms for the
// root's A H' at 50,000 x 1,000,000 and k = 2, against 0.57 ms through the
// ELL kernel (chip_smoke.py --cols, PERF.md).  For entries e < n_live,
//
//     out[key(e), :] += val[e] * table[gather[e], :]
//
// with key(e) = key[e >> key_shift] ascending in e (W'A keys an entry by
// its chunk's document slot, one key a chunk of 2^key_shift entries; A H'
// by its term, one key an entry, after the node's term sort).  gather[e]
// >= B is the padding sentinel and contributes nothing.  n_live is read
// from device memory, so the launch's shape is fixed by the capacity alone
// and one captured CUDA graph serves every node of a width: a warp whose
// entries lie past n_live returns at once (padding costs a launch, not
// bandwidth).  out is written at the keys the live entries have; the
// wrapper zeroes it first.  Row mode and transposed mode are one kernel
// with the output's strides.
//
// Types (vals, table -> sums): (f32, f32), (bf16, f32), (e4m3, f32) -> f32;
// (f64, f64) -> f64.  bf16 and e4m3 are widened in registers.  k <= 8.
//
// What bounds it on the card: the stream of entries.  Each live entry
// reads its key, its gather index and its value once (10 bytes at bf16
// with a per-entry key) and one k-wide table row from a random place (8
// bytes at k = 2 in f32, mostly from L2), against 2k flops.  So it is bound
// by bytes, far below the FP units.
//
// Design, simple and deterministic first (PERF.md for its times):
//   - Fixed work a warp: tile t holds entries [256 t, 256 t + 256), eight
//     rounds of 32 consecutive entries, one a lane, coalesced loads.  The
//     load is balanced whatever the key distribution: the corpus's most
//     frequent term (in ~92% of the documents) is ~3,500 tiles of one key.
//   - A round's contributions are summed by key with a segmented inclusive
//     scan over the warp (five __shfl_up_sync steps; the keys are sorted,
//     so equal keys are contiguous lanes); a segment still open at lane 31
//     is carried to the next round, and the lane where a segment ends
//     writes it.
//   - No floating-point atomics.  A segment that crosses a tile boundary
//     is cut in two kinds of partials at fixed places: the part at the
//     head of a tile (head[t]) and the part at the tail of the tile where
//     the segment starts (tail[t]).  The second launch (seg_carry) gives
//     each such segment to the warp of its first tile, which adds the
//     following tiles' head partials lane by lane, then by a fixed xor
//     butterfly, to its tail partial.  Every sum has a fixed order, so two
//     runs, and eager and captured launches, give the same bits.
//   - Later work: wider loads of the entry stream, cp.async or TMA
//     pipelines, one launch for both passes.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;               // warps of a block, a tile each
constexpr int kRounds = 8;              // rounds of 32 entries a tile
constexpr long long kTile = 32 * kRounds;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoKey = -1;              // a lane with no live entry
constexpr int kPastEnd = -2;            // the key after the last live entry
constexpr int kNoCarry = -3;            // no segment carried into a round

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
template <typename T>
__device__ __forceinline__ T ldg(const T* p) { return __ldg(p); }
__device__ __forceinline__ __nv_fp8_e4m3 ldg(const __nv_fp8_e4m3* p) {
  __nv_fp8_e4m3 v;
  v.__x = __ldg(reinterpret_cast<const unsigned char*>(p));
  return v;
}

struct Args {
  const int* key;
  int key_shift;
  const int* gather;
  const void* val;
  const void* table;
  long long ld_row, ld_col;  // table's strides (elements)
  int B;                     // table rows; gather >= B is the sentinel
  void* out;
  long long out_row, out_col;  // out's strides (elements)
  int n_out;                   // keys >= n_out are never written
  void* head;                  // (tiles, K) partials at tiles' heads
  void* tail;                  // (tiles, K) partials at tiles' tails
  const long long* n_live;     // device scalar
  long long cap;               // entries the launch covers
};

__device__ __forceinline__ int key_at(const Args& a, long long e) {
  return __ldg(a.key + (e >> a.key_shift));
}

// Pass 1: a warp a tile.  Writes each segment that ends in the tile and
// began in it to out, a segment continuing from the tile before to
// head[tile], and one that begins here and runs into the next tile to
// tail[tile].
template <typename V, typename T, typename Acc, int K>
__global__ void __launch_bounds__(32 * kWarps) seg_tiles(Args a) {
  const long long n_live = min(*a.n_live, a.cap);
  const int lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long ts = tile * kTile;
  if (ts >= n_live) return;  // warp-uniform
  const long long te = min(ts + kTile, n_live);
  const int first = key_at(a, ts);
  const int head_key =
      (ts > 0 && key_at(a, ts - 1) == first) ? first : kNoCarry - 1;
  const V* val = static_cast<const V*>(a.val);
  const T* table = static_cast<const T*>(a.table);
  Acc* out = static_cast<Acc*>(a.out);
  Acc* head = static_cast<Acc*>(a.head) + tile * K;
  Acc* tail = static_cast<Acc*>(a.tail) + tile * K;

  int ckey = kNoCarry;
  Acc carry[K];
#pragma unroll
  for (int c = 0; c < K; ++c) carry[c] = Acc(0);

  for (long long base = ts; base < te; base += 32) {
    const long long e = base + lane;
    const bool live = e < te;
    int k_e = kNoKey, k_next = kPastEnd;
    Acc v[K];
#pragma unroll
    for (int c = 0; c < K; ++c) v[c] = Acc(0);
    if (live) {
      k_e = key_at(a, e);
      if (e + 1 < n_live) k_next = key_at(a, e + 1);
      const int g = __ldg(a.gather + e);
      if (g >= 0 && g < a.B) {
        const Acc x = (Acc)widen(ldg(val + e));
        const T* row = table + (long long)g * a.ld_row;
#pragma unroll
        for (int c = 0; c < K; ++c)
          v[c] = x * (Acc)widen(__ldg(row + c * a.ld_col));
      }
    }
    // segmented inclusive scan over the round's lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int ok = __shfl_up_sync(kFull, k_e, d);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const Acc o = __shfl_up_sync(kFull, v[c], d);
        if (lane >= d && ok == k_e) v[c] += o;
      }
    }
    if (k_e == ckey) {
#pragma unroll
      for (int c = 0; c < K; ++c) v[c] = carry[c] + v[c];
    }
    const bool ends = live && (e + 1 >= te || k_next != k_e);
    if (ends) {
      Acc* dst;
      long long stride;
      if (k_e == head_key) {
        dst = head;
        stride = 1;
      } else if (e + 1 == te && e + 1 < n_live && k_next == k_e) {
        dst = tail;
        stride = 1;
      } else if (k_e >= 0 && k_e < a.n_out) {
        dst = out + (long long)k_e * a.out_row;
        stride = a.out_col;
      } else {
        dst = nullptr;
        stride = 0;
      }
      if (dst != nullptr) {
#pragma unroll
        for (int c = 0; c < K; ++c) dst[c * stride] = v[c];
      }
    }
    // the segment open at lane 31 goes on into the next round
    const int end31 = __shfl_sync(kFull, ends ? 1 : 0, 31);
    ckey = __shfl_sync(kFull, k_e, 31);
#pragma unroll
    for (int c = 0; c < K; ++c) carry[c] = __shfl_sync(kFull, v[c], 31);
    if (end31) ckey = kNoCarry;
  }
}

// Pass 2: a warp a tile.  The warp of the tile where a tile-crossing
// segment begins adds the head partials of the tiles it runs into, in a
// fixed order, to its tail partial and writes the segment's row of out.
template <typename Acc, int K>
__global__ void __launch_bounds__(32 * kWarps) seg_carry(Args a) {
  const long long n_live = min(*a.n_live, a.cap);
  const int lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long ts = tile * kTile;
  if (ts >= n_live) return;
  const long long te = min(ts + kTile, n_live);
  if (te >= n_live) return;
  const int key = key_at(a, te - 1);
  if (key_at(a, te) != key) return;  // the tile's last segment ends in it
  if (ts > 0 && key_at(a, ts) == key && key_at(a, ts - 1) == key)
    return;  // it began in an earlier tile, whose warp writes it
  const Acc* head = static_cast<const Acc*>(a.head);
  Acc s[K];
#pragma unroll
  for (int c = 0; c < K; ++c) s[c] = Acc(0);
  for (long long j0 = tile + 1;; j0 += 32) {
    const long long j = j0 + lane;
    const bool in = j * kTile < n_live && key_at(a, j * kTile) == key;
    if (in) {
#pragma unroll
      for (int c = 0; c < K; ++c) s[c] += head[j * K + c];
    }
    if (__ballot_sync(kFull, !in) != 0u) break;  // the run is contiguous
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < K; ++c) s[c] += __shfl_xor_sync(kFull, s[c], off);
  }
  if (lane == 0 && key >= 0 && key < a.n_out) {
    const Acc* tail = static_cast<const Acc*>(a.tail) + tile * K;
    Acc* out = static_cast<Acc*>(a.out) + (long long)key * a.out_row;
#pragma unroll
    for (int c = 0; c < K; ++c) out[c * a.out_col] = tail[c] + s[c];
  }
}

template <typename V, typename T, typename Acc, int K>
int launch_k(const Args& a, cudaStream_t stream) {
  const long long tiles = (a.cap + kTile - 1) / kTile;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  seg_tiles<V, T, Acc, K><<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seg_carry<Acc, K><<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename V, typename T, typename Acc>
int seg_spmm(const void* key, int key_shift, const void* gather,
             const void* val, const void* table, long long ld_row,
             long long ld_col, int B, int k, void* out, long long out_row,
             long long out_col, int n_out, void* head, void* tail,
             const void* n_live, long long cap, void* stream, int device) {
  if (k < 1 || k > 8 || key_shift < 0 || key_shift > 20 || B < 0 ||
      n_out < 0 || cap < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{static_cast<const int*>(key), key_shift,
               static_cast<const int*>(gather), val, table, ld_row, ld_col,
               B, out, out_row, out_col, n_out, head, tail,
               static_cast<const long long*>(n_live), cap};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return launch_k<V, T, Acc, 1>(a, s);
    case 2: return launch_k<V, T, Acc, 2>(a, s);
    case 3: return launch_k<V, T, Acc, 3>(a, s);
    case 4: return launch_k<V, T, Acc, 4>(a, s);
    case 5: return launch_k<V, T, Acc, 5>(a, s);
    case 6: return launch_k<V, T, Acc, 6>(a, s);
    case 7: return launch_k<V, T, Acc, 7>(a, s);
    default: return launch_k<V, T, Acc, 8>(a, s);
  }
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 when both launches were accepted.  The name
// gives (vals, table); sums and out are f32, or f64 for the f64 pair.  head
// and tail hold (ceil(cap / 256), k) sums each; n_live is an int64 on the
// device.
#define SMALLK_SEG_ENTRY(NAME, V, T, ACC)                                     \
  int NAME(const void* key, int key_shift, const void* gather,               \
           const void* val, const void* table, long long ld_row,             \
           long long ld_col, int B, int k, void* out, long long out_row,     \
           long long out_col, int n_out, void* head, void* tail,             \
           const void* n_live, long long cap, void* stream, int device) {    \
    return seg_spmm<V, T, ACC>(key, key_shift, gather, val, table, ld_row,   \
                               ld_col, B, k, out, out_row, out_col, n_out,   \
                               head, tail, n_live, cap, stream, device);     \
  }

SMALLK_SEG_ENTRY(smallk_seg_spmm_f32_f32, float, float, float)
SMALLK_SEG_ENTRY(smallk_seg_spmm_bf16_f32, __nv_bfloat16, float, float)
SMALLK_SEG_ENTRY(smallk_seg_spmm_f8_f32, __nv_fp8_e4m3, float, float)
SMALLK_SEG_ENTRY(smallk_seg_spmm_f64_f64, double, double, double)
#undef SMALLK_SEG_ENTRY

const char* smallk_seg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
