// flash_attention.cu — blocked online-softmax attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the
// Pallas TPU kernel (`_kernel`) that carries fp32 m/l/acc in VMEM scratch
// across a sequential kv grid axis.
//
// Computes, for q (B,T,H,D) and k, v (B,S,KV,D), all contiguous and of one
// dtype (fp32 or bf16), o (B,T,H,D) in that dtype:
//   o[b,t,h] = sum_j softmax_j(q[b,t,h] . k[b,j,h/G] / sqrt(D)) v[b,j,h/G]
// over the visible keys j, with G = H / KV query heads per kv head (GQA).
// Query t sits at position q_offset + t.  Key j is visible when
//   j < S, j < kv_len[b] (if kv_len is given),
//   j <= q_offset + t (if causal), j > q_offset + t - window (if window > 0).
// A row with no visible key gives 0 (l == 0), as the TPU kernel's `_finish`.
// Scores, the softmax statistics m and l, and the accumulator are fp32.
//
// Bound on this card, at the two serving shapes of llama3.2-1b (bf16):
//   prefill (B,T,H,KV,D) = (8,512,32,8,64), causal: 2*B*H*T^2*D = 8.6 GFLOP
//     (half of 4*B*H*T^2*D) against 2*B*T*(2H+2KV)*D = 41.9 MB of q, k, v
//     and o -- 8.7 us at the bf16 tensor-core peak, 12.5 us at 3.35 TB/s:
//     bound by bytes at the ideal, by operations for this kernel, which
//     uses the fp32 CUDA cores (67 TFLOP/s: 128 us).
//   decode (8,1,32,8,64) against a 576-key cache: B*kv_len*KV*D*2*2 bytes
//     of K/V (9.4 MB at kv_len 576; 2.8 us) and 4*B*H*kv_len*D FLOP --
//     bound by bytes, and in practice by launch latency.
// Design: one block per (q-row tile, kv head, batch row).  The rows of a
// block are (t, g) pairs of the flattened T*G axis, so the G query heads
// that share a kv head sit in one block and each K/V tile is read from
// device memory once per group -- in decode (T = 1, G = 4) one block serves
// all four heads.  A loop over 64-key tiles inside the block takes the
// place of the TPU's sequential kv grid axis: the block stages K and V in
// shared memory (fp32), each warp owns 8 rows, each lane scores two keys of
// the tile against its rows (fp32 dot products over D; the K rows are
// padded to D+1 floats so the lanes' reads fall in distinct banks), a warp
// reduction gives the tile's max and sum for the online-softmax update of
// `_kernel` (lines 89-99), and the probabilities go through shared memory
// to the AV product, where lanes are spread over D.  No score matrix ever
// reaches device memory.  Tiles that the causal, window and kv_len limits
// leave wholly invisible are skipped (the TPU kernel's dead-block skip);
// ragged tails of T and S are masked here, so any T and S are taken.
// No mma/wgmma, TMA or split-KV yet: that is later work.
//
// Build without --use_fast_math (IEEE expf and division):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // (t, g) rows per block
constexpr int kTile = 64;                     // keys per kv tile
constexpr int kKeysPerLane = kTile / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

template <int D>
constexpr size_t smem_floats() {
  // K tile (rows padded to D+1), V tile, the block's q rows, probabilities
  return (size_t)kTile * (D + 1) + (size_t)kTile * D + (size_t)kRows * D +
         (size_t)kRows * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       const int32_t* __restrict__ kv_len, int T_len, int S,
                       int H, int KV, int q_offset, int causal, int window,
                       float scale) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  constexpr int kDPerLane = (D + 31) / 32;
  constexpr int kKStride = D + 1;  // odd: lane j's K row starts in bank j*(D+1)
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                      // [kTile][D+1]
  float* vs = ks + kTile * kKStride;     // [kTile][D]
  float* qs = vs + kTile * D;            // [kRows][D]
  float* ps = qs + kRows * D;            // [kRows][kTile]

  const int G = H / KV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = T_len * G;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // keys any row of this block can see: [kv_begin, kv_end)
  const int row_last = min(row0 + kRows, n_rows) - 1;
  const int qpos_lo = q_offset + row0 / G;
  const int qpos_hi = q_offset + row_last / G;
  int kv_valid = S;
  if (kv_len != nullptr) kv_valid = min(kv_valid, kv_len[b]);
  int kv_end = kv_valid;
  if (causal) kv_end = min(kv_end, qpos_hi + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, qpos_lo - window + 1);

  // stage the block's q rows (row (t, g) is head kvh*G + g at time t)
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int rho = row0 + r;
    float x = 0.0f;
    if (rho < n_rows) {
      const int t = rho / G;
      const int g = rho - t * G;
      x = to_float(q[(((size_t)b * T_len + t) * H + (size_t)kvh * G + g) * D +
                     d]);
    }
    qs[idx] = x;
  }

  const int my_row0 = warp * kRowsPerWarp;  // first block row of this warp
  const bool warp_active = row0 + my_row0 < n_rows;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
  int qpos[kRowsPerWarp];
  bool row_ok[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int rho = row0 + my_row0 + i;
    row_ok[i] = rho < n_rows;
    qpos[i] = q_offset + (row_ok[i] ? rho / G : 0);
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) acc[i][c] = 0.0f;
  }

  const size_t key_stride = (size_t)KV * D;  // between consecutive keys
  const T* kb = k + ((size_t)b * S * KV + kvh) * D;
  const T* vb = v + ((size_t)b * S * KV + kvh) * D;

  for (int k0 = (kv_begin / kTile) * kTile; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int kpos = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (kpos < S) {
        const size_t off = (size_t)kpos * key_stride + d;
        kx = to_float(kb[off]);
        vx = to_float(vb[off]);
      }
      ks[j * kKStride + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();
    if (!warp_active) continue;

    // scores: lane owns keys lane and lane + 32 of the tile
    float s[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) s[i][c] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float kk[kKeysPerLane][4];
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          kk[c][e] = ks[(lane + 32 * c) * kKStride + d + e];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 q4 =
            *reinterpret_cast<const float4*>(&qs[(my_row0 + i) * D + d]);
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) {
          s[i][c] = fmaf(q4.x, kk[c][0], s[i][c]);
          s[i][c] = fmaf(q4.y, kk[c][1], s[i][c]);
          s[i][c] = fmaf(q4.z, kk[c][2], s[i][c]);
          s[i][c] = fmaf(q4.w, kk[c][3], s[i][c]);
        }
      }
    }

    // online-softmax update, one row at a time (warp-uniform branches)
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool ok[kKeysPerLane];
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const int kpos = k0 + lane + 32 * c;
        ok[c] = row_ok[i] && kpos < kv_valid &&
                (!causal || kpos <= qpos[i]) &&
                (window <= 0 || kpos > qpos[i] - window);
        s[i][c] = ok[c] ? s[i][c] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][c]);
      }
      mt = warp_max(mt);
      const float m_new = fmaxf(m[i], mt);
      float p[kKeysPerLane];
      float alpha = 1.0f;
      if (m_new == -INFINITY) {  // nothing visible to this row yet
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) p[c] = 0.0f;
      } else {
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c)
          p[c] = ok[c] ? expf(s[i][c] - m_new) : 0.0f;
        alpha = expf(m[i] - m_new);
      }
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        psum += p[c];
        ps[(my_row0 + i) * kTile + lane + 32 * c] = p[c];
      }
      psum = warp_sum(psum);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();

    // acc += p @ V; keys at or past kv_end have p == 0 in every row
    const int jn = min(kTile, (kv_end - k0 + 3) & ~3);
    for (int j = 0; j < jn; j += 4) {
      float vv[4][kDPerLane];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < kDPerLane; ++c) {
          const int d = lane + 32 * c;
          vv[e][c] = (d < D) ? vs[(j + e) * D + d] : 0.0f;
        }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(&ps[(my_row0 + i) * kTile + j]);
#pragma unroll
        for (int c = 0; c < kDPerLane; ++c) {
          acc[i][c] = fmaf(p4.x, vv[0][c], acc[i][c]);
          acc[i][c] = fmaf(p4.y, vv[1][c], acc[i][c]);
          acc[i][c] = fmaf(p4.z, vv[2][c], acc[i][c]);
          acc[i][c] = fmaf(p4.w, vv[3][c], acc[i][c]);
        }
      }
    }
    __syncwarp();
  }

  if (!warp_active) return;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (!row_ok[i]) continue;
    const int rho = row0 + my_row0 + i;
    const int t = rho / G;
    const int g = rho - t * G;
    const float denom = (l[i] == 0.0f) ? 1.0f : l[i];  // fully masked -> 0
    T* orow = o + (((size_t)b * T_len + t) * H + (size_t)kvh * G + g) * D;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int32_t* kv_len, int B, int T_len, int S, int H, int KV,
           int q_offset, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  static bool attr_set = false;  // the opt-in above 48 KB, once per variant
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const long long n_rows = (long long)T_len * (H / KV);
  const dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), (unsigned)KV,
                  (unsigned)B);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kv_len, T_len, S, H, KV,
      q_offset, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               const int32_t* kv_len, int B, int T_len, int S, int H, int KV,
               int D, int q_offset, int causal, int window, float scale,
               cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, kv_len, B, T_len, S, H, KV, q_offset,
                           causal, window, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, kv_len, B, T_len, S, H, KV, q_offset,
                           causal, window, scale, st);
    case 120:
      return launch<T, 120>(q, k, v, o, kv_len, B, T_len, S, H, KV, q_offset,
                            causal, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, kv_len, B, T_len, S, H, KV, q_offset,
                            causal, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = fp32, 1 = bf16.
// kv_len: (B,) int32 on the device, or null.  window <= 0 means none.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for what the kernel does not take (D outside
// {16, 64, 120, 128}, H not a multiple of KV, a grid too large).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const void* kv_len, int B, int T_len,
                                      int S, int H, int KV, int D, int dtype,
                                      int q_offset, int causal, int window,
                                      float scale, void* stream) {
  if (B < 1 || T_len < 1 || S < 0 || KV < 1 || H < KV || H % KV != 0 ||
      B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  const int32_t* kvl = static_cast<const int32_t*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, kvl, B, T_len, S, H, KV, D, q_offset,
                             causal, window, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, kvl, B, T_len, S, H, KV, D,
                                     q_offset, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
