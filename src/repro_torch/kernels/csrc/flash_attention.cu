// flash_attention.cu — online-softmax GQA attention for Hopper (sm_90a).
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
// Scores (scaled in fp32, never by prescaling q), the softmax statistics m
// and l, and the accumulators are fp32.  Every path works on the flattened
// (t, g) rows of one kv head, so the G query heads that share a kv head
// read each K/V row from device memory once.
//
// The wrapper picks the path by shape (T*G rows per kv head):
//
// 1. flash_tiled_kernel (bf16, T*G > 8: every prefill).  Bound at the
//    serving shapes, causal, bf16:
//      llama3.2-1b (B,T,H,KV,D) = (8,512,32,8,64): 8.6 GFLOP (half of
//        4*B*H*T^2*D) = 8.7 us at the 989 TFLOP/s tensor-core peak, against
//        41.9 MB of q, k, v, o = 12.5 us at 3.35 TB/s: bound by bytes;
//      Jamba (8,512,64,8,128): 34.4 GFLOP = 34.7 us against 151 MB =
//        45.1 us: bound by bytes, operations close behind.
//    Either way the products must run on the tensor cores (the fp32 CUDA
//    cores, 67 TFLOP/s, take 128 us for llama's alone).  Design: a block
//    owns 128 (t, g) rows of one (batch row, kv head), 32 per warp (two
//    16-row mma tiles share every K/V fragment); Q·K^T and P·V are
//    mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with ldmatrix fragments
//    (.trans for V); K/V tiles (64 keys at D <= 64, 32 at D >= 120) stream
//    through a two-stage cp.async ring in shared memory (rows padded by 16
//    bytes, so ldmatrix is free of bank conflicts), the next tile's copy
//    in flight while this tile is multiplied.  The online softmax runs on
//    the fp32 score fragments in registers (base-2 exponent by the SFU, the
//    scale and log2(e) applied to the fp32 scores).  P enters P·V as two
//    bf16 parts, hi = bf16(P) and lo = bf16(P - hi), so ~16 bits of P
//    reach the product: one bf16 P (8 bits, as the reference's chunked
//    path rounds it) misses the reference's tolerance where sharp
//    attention meets large values that cancel.  D = 120 is zero-padded to
//    128 in shared memory.  Tiles that the causal, window and kv_len
//    limits leave invisible to every row are skipped; tiles visible to
//    every row skip the mask.  Row tiles are issued latest first (the
//    causal long ones).  What bounds it (PERF.md): the mma.sync issue and
//    the softmax between the two products, one warp's work in series, 8
//    warps an SM (registers); wgmma, TMA and warp specialisation are the
//    next step.
// 2. flash_attention_kernel (fp32, T*G > 8): the CUDA-core kernel as it
//    was (fp32 FMAs; TF32 would not hold fp32's 2e-4): the parity path.
// 3. Split-KV decode (both dtypes, T*G <= 8: every decode step).  Bound at
//    the decode shapes (kv_len 512..575 over a 576-slot cache): the K/V
//    rows read once, 9.0 MB = 2.7 us for llama, 18.1 MB = 5.4 us for
//    Jamba; the products are G flops a byte.  Design: the key axis is cut
//    into splits (the wrapper's rule: >= 64 keys a split, ~2 blocks an SM,
//    5 splits = 320 blocks at both shapes); grid (splits, KV, B); each
//    block takes one key range of one kv head for all T*G rows, and reads
//    K and V in their storage dtype with 16-byte loads straight into
//    registers: no staging in shared memory, no idle warps.
//    flash_split_mma_kernel (bf16): the T*G rows are rows 0-7 of one
//      m16n8k16 tile; each lane's 16-byte chunks are its mma fragments
//      (the product's depth runs over the dims in a permuted order, the
//      same for q and K), movmatrix turns V's chunks into B fragments,
//      P enters as hi + lo; a warp takes 16 keys at a time.
//    flash_split_kernel (fp32): lanes over 16-byte chunks of a K/V row
//      (8 lanes a row at D = 64), T*G rounded up to a power of two rows
//      held in registers per lane, warp shuffles for the dot products,
//      the next steps' loads in flight while this step computes.
//    Each split writes fp32 partials (m, l, acc[D]) to scratch, and
//    flash_combine_kernel merges them in split order (no atomics: the
//    result is the same bits on every run).  A split that sees no key
//    writes m = -inf, l = 0.  One split writes o itself.
// 4. A sequence-sharded KV cache (ops.attention(kv_seq_shard=True) on a
//    mesh; the TPU reference leaves the distributed softmax to XLA): each
//    rank holds a contiguous key range of the cache.
//    flash_attention_partials runs the split-KV kernel of 3 on the rank's
//    range (q_offset and kv_len shifted by the range's start, so the
//    masks stay global) and writes its splits' fp32 partials, never o.
//    The ranks' partial buffers are all-gathered in rank order, and
//    flash_attention_combine merges every rank's splits in (rank, split)
//    order with flash_combine_kernel.  Bound: the rank's K/V range read
//    once, plus (D + 2) floats a split for each (b, t, h) row written and
//    read back by the merge.
// 5. A decode step whose position lives on the device (the captured decode
//    graph of ServeEngine replays one program at every step):
//    flash_attention_decode takes no q_offset; every kernel of 1-3 then
//    places batch row b's queries at kv_len[b] - T .. kv_len[b] - 1, read
//    in the kernel (the cache is filled to kv_len[b] after this step's T
//    tokens), so the causal and window masks follow each row's position
//    and nothing of it is baked into the launch.  The internal value
//    kOffsetFromKvLen of q_offset asks for that; the host entries refuse
//    it as a q_offset of their own.
//
// Build without --use_fast_math (IEEE division; the fp32 kernel keeps the
// library's expf):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// q_offset's value that asks each kernel for the decode offset on the
// device, kv_len[b] - T (entry 5 above); never a real offset
constexpr int kOffsetFromKvLen = -2147483647 - 1;

// the first query position of batch row b
__device__ __forceinline__ int query_offset(int q_offset,
                                            const int32_t* kv_len, int b,
                                            int T_len) {
  return q_offset == kOffsetFromKvLen ? kv_len[b] - T_len : q_offset;
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
  q_offset = query_offset(q_offset, kv_len, b, T_len);

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


// ---------------------------------------------------------------------------
// PTX helpers for the tensor-core path
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !pred
// (src must still be a valid address: callers pass the tensor's base)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) = hi + lo: hi the pair rounded to bf16, lo the remainder rounded
// to bf16 (x0 in the low half of each word, as mma's A fragments take it)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// 2^x by the SFU's one instruction (relative error < 2^-22; results below
// 2^-126 flush to 0, which no bf16 output can tell from a denormal)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// 1. bf16 tiled path on the tensor cores
// ---------------------------------------------------------------------------

namespace tiled {

// A block owns 128 (t, g) rows, 32 per warp as two 16-row mma tiles (each
// K/V fragment read from shared memory feeds two products), and walks the
// keys in tiles of 64 (32 at D >= 120, which keeps the accumulators of 32
// rows within 255 registers).  The warp's Q fragments are read again from
// shared memory at every tile: holding them in registers measured no
// faster at D = 64 and does not fit at D = 128 (PERF.md).
template <int D>
struct Dims {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static constexpr int WARPS = 4;
  static constexpr int MT = 2;                   // 16-row mma tiles a warp
  static constexpr int kThreads = WARPS * 32;
  static constexpr int BM = WARPS * MT * 16;     // rows per block
  static constexpr int kBN = D >= 120 ? 32 : 64;  // keys per K/V tile
  static constexpr int DP = (D + 15) / 16 * 16;  // padded to the mma depth
  static constexpr int LD = DP + 8;  // shared row stride: +16 bytes a row
  static constexpr int CH = D / 8;   // 16-byte chunks of a device row
  static constexpr int CP = DP / 8;  // 16-byte chunks of a shared row
  static constexpr size_t kSmemBytes =
      (size_t)(BM + 4 * kBN) * LD * sizeof(__nv_bfloat16);  // Q, 2 x (K, V)
};

template <int D>
__global__ void __launch_bounds__(Dims<D>::kThreads)
flash_tiled_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o,
                   const int32_t* __restrict__ kv_len, int T_len, int S,
                   int H, int KV, int q_offset, int causal, int window,
                   float scale_log2) {
  using Dm = Dims<D>;
  constexpr int DP = Dm::DP, LD = Dm::LD, CH = Dm::CH, CP = Dm::CP;
  constexpr int BM = Dm::BM, MT = Dm::MT, NTH = Dm::kThreads;
  constexpr int kBN = Dm::kBN;
  constexpr int NT = kBN / 8;   // 8-key score fragments per row tile
  constexpr int OT = DP / 8;    // 8-dim output fragments
  constexpr int KS = DP / 16;   // mma k-steps of Q·K^T
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BM * LD;         // [2][kBN][LD]
  __nv_bfloat16* vs = ks + 2 * kBN * LD;    // [2][kBN][LD]

  const int G = H / KV;
  const int kvh = blockIdx.x % KV;
  const int b = blockIdx.x / KV;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BM;  // latest tiles first
  const int n_rows = T_len * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wrow = warp * MT * 16;  // the warp's first row in the block
  q_offset = query_offset(q_offset, kv_len, b, T_len);

  // keys any row of this block can see: [kv_begin, kv_end)
  const int row_last = min(row0 + BM, n_rows) - 1;
  const int qpos_lo = q_offset + row0 / G;
  const int qpos_hi = q_offset + row_last / G;
  int kv_valid = S;
  if (kv_len != nullptr) kv_valid = min(kv_valid, kv_len[b]);
  int kv_end = kv_valid;
  if (causal) kv_end = min(kv_end, qpos_hi + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, qpos_lo - window + 1);
  const int k_first = (kv_begin / kBN) * kBN;
  const int n_tiles = kv_end > k_first ? (kv_end - k_first + kBN - 1) / kBN
                                       : 0;

  // the block's q rows; row (t, g) is head kvh*G + g at time t
  for (int idx = tid; idx < BM * CP; idx += NTH) {
    const int r = idx / CP;
    const int c = idx - r * CP;
    const int rho = row0 + r;
    const bool ok = rho < n_rows && c < CH;
    const __nv_bfloat16* src = q;
    if (ok) {
      const int t = rho / G;
      const int g = rho - t * G;
      src = q + (((size_t)b * T_len + t) * H + (size_t)kvh * G + g) * D +
            c * 8;
    }
    cp_async16(smem_u32(qs + r * LD + c * 8), src, ok);
  }

  const size_t key_stride = (size_t)KV * D;  // between consecutive keys
  const size_t kv_base = ((size_t)b * S * KV + kvh) * D;
  // one K/V tile into ring slot `buf`; keys at or past kv_end (invisible to
  // every row) and the pad chunk of D = 120 are zero-filled
  auto load_tile = [&](int kt, int buf) {
    const int k0 = k_first + kt * kBN;
    __nv_bfloat16* kd = ks + buf * kBN * LD;
    __nv_bfloat16* vd = vs + buf * kBN * LD;
    for (int idx = tid; idx < kBN * CP; idx += NTH) {
      const int j = idx / CP;
      const int c = idx - j * CP;
      const bool ok = k0 + j < kv_end && c < CH;
      const size_t off = ok ? kv_base + (size_t)(k0 + j) * key_stride + c * 8
                            : 0;
      cp_async16(smem_u32(kd + j * LD + c * 8), k + off, ok);
      cp_async16(smem_u32(vd + j * LD + c * 8), v + off, ok);
    }
  };

  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();  // group 0: q and the first tile

  // this thread's rows: wrow + mt*16 + h*8 + lane/4 for h in {0, 1}
  int qpos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      qpos[mt][h] = q_offset + (row0 + wrow + mt * 16 + h * 8 + (lane >> 2)) / G;
  float oacc[MT][OT][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mt][j][e] = 0.0f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.0f;
  }
  // lane's ldmatrix address in the warp's q rows (plus mt*16 rows, kk*16)
  const __nv_bfloat16* q_lane = qs + (wrow + (lane & 15)) * LD +
                                (lane >> 4) * 8;

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) load_tile(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: this tile has landed
    __syncthreads();
    const int buf = kt & 1;
    const int k0 = k_first + kt * kBN;
    // S = Q K^T: MT*16 rows x kBN keys per warp, fp32
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.0f;
    const __nv_bfloat16* kt_s = ks + buf * kBN * LD;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(qa[mt], smem_u32(q_lane + mt * 16 * LD + kk * 16));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_u32(kt_s + (np * 16 + (lane >> 4) * 8 +
                                         (lane & 7)) * LD +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(s[mt][2 * np], qa[mt], bk[0], bk[1]);
          mma_bf16_16816(s[mt][2 * np + 1], qa[mt], bk[2], bk[3]);
        }
      }
    }

    // mask the raw scores where some key of the tile is hidden from some
    // row; the scale is applied (in fp32) inside the exponent below
    const bool full = k0 + kBN <= kv_valid &&
                      (!causal || k0 + kBN - 1 <= qpos_lo) &&
                      (window <= 0 || k0 > qpos_hi - window);
    if (!full) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
            const int qp = qpos[mt][e >> 1];
            const bool vis = kpos < kv_valid && (!causal || kpos <= qp) &&
                             (window <= 0 || kpos > qp - window);
            s[mt][j][e] = vis ? s[mt][j][e] : -INFINITY;
          }
    }

    // online softmax on the fp32 scores (a quad of lanes shares a row);
    // m is kept in log2 units: m = max(score) * scale * log2(e)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * h], s[mt][j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
        const float mn = fmaxf(m[mt][h], mx * scale_log2);
        // a row that has seen no visible key yet keeps p = 0 (2^-inf)
        const float base = mn == -INFINITY ? 0.0f : mn;
        const float alpha = exp2_sfu(m[mt][h] - base);
        m[mt][h] = mn;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          s[mt][j][2 * h] =
              exp2_sfu(fmaf(s[mt][j][2 * h], scale_log2, -base));
          s[mt][j][2 * h + 1] =
              exp2_sfu(fmaf(s[mt][j][2 * h + 1], scale_log2, -base));
          sum += s[mt][j][2 * h] + s[mt][j][2 * h + 1];
        }
        l[mt][h] = l[mt][h] * alpha + sum;  // the lane's share; quad sums
#pragma unroll
        for (int j = 0; j < OT; ++j) {
          oacc[mt][j][2 * h] *= alpha;
          oacc[mt][j][2 * h + 1] *= alpha;
        }
      }
    }

    // O += P V with P split into two bf16 parts, P = hi + lo (hi = P
    // rounded to bf16, lo = the rest rounded to bf16): two products per V
    // fragment keep ~16 bits of P, where one bf16 P (8 bits) misses the
    // reference's tolerance on outputs that cancel.  The score fragments
    // are P's A fragments.
    const __nv_bfloat16* vt_s = vs + buf * kBN * LD;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* src = s[mt][2 * kk + (i >> 1)] + 2 * (i & 1);
          split_bf16(src[0], src[1], pa[mt][i], pl[mt][i]);
        }
      }
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_u32(vt_s + (kk * 16 +
                                               ((lane >> 3) & 1) * 8 +
                                               (lane & 7)) * LD +
                                       dp * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(oacc[mt][2 * dp], pa[mt], bv[0], bv[1]);
          mma_bf16_16816(oacc[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
          mma_bf16_16816(oacc[mt][2 * dp], pl[mt], bv[0], bv[1]);
          mma_bf16_16816(oacc[mt][2 * dp + 1], pl[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this slot is read: the next copy may refill it
  }

  // epilogue: o = acc / l (0 for a row with no visible key), staged in the
  // warp's own rows of the q tile, then 16-byte stores
  cp_async_wait<0>();
  __syncthreads();  // no copy into the q tile is still in flight
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[mt][h];
      lt += __shfl_xor_sync(kFullMask, lt, 1);
      lt += __shfl_xor_sync(kFullMask, lt, 2);
      const float inv = lt == 0.0f ? 0.0f : 1.0f / lt;
      const int r = wrow + mt * 16 + h * 8 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < OT; ++j)
        *reinterpret_cast<uint32_t*>(qs + r * LD + j * 8 + (lane & 3) * 2) =
            pack_bf16(oacc[mt][j][2 * h] * inv, oacc[mt][j][2 * h + 1] * inv);
    }
  }
  __syncwarp();
  for (int idx = lane; idx < MT * 16 * CH; idx += 32) {
    const int r = idx / CH;
    const int c = idx - r * CH;
    const int rho = row0 + wrow + r;
    if (rho >= n_rows) continue;
    const int t = rho / G;
    const int g = rho - t * G;
    *reinterpret_cast<uint4*>(
        o + (((size_t)b * T_len + t) * H + (size_t)kvh * G + g) * D + c * 8) =
        *reinterpret_cast<const uint4*>(qs + (wrow + r) * LD + c * 8);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int32_t* kv_len, int B, int T_len, int S, int H, int KV,
           int q_offset, int causal, int window, float scale,
           cudaStream_t stream) {
  using Dm = Dims<D>;
  constexpr size_t bytes = Dm::kSmemBytes;
  static bool attr_set = false;  // the opt-in above 48 KB, once per variant
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tiled_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const long long n_rows = (long long)T_len * (H / KV);
  const long long row_tiles = (n_rows + Dm::BM - 1) / Dm::BM;
  const long long heads = (long long)B * KV;
  if (row_tiles > 65535 || heads > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)heads, (unsigned)row_tiles);
  flash_tiled_kernel<D><<<grid, Dm::kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      kv_len, T_len, S, H, KV, q_offset, causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tiled

// ---------------------------------------------------------------------------
// 3. split-KV path (decode): partials per key range, merged in split order
// ---------------------------------------------------------------------------

namespace split {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 8;  // T*G rows a block holds in registers

// the fp32 kernel's lanes: a K/V row is CH 16-byte chunks of E floats,
// read by LG lanes; a warp step covers KPS keys
template <int D>
struct Geo {
  static constexpr int E = 4;
  static_assert(D % E == 0, "a row must be whole 16-byte chunks");
  static constexpr int CH = D / E;
  static constexpr int LG = CH <= 2 ? 2 : CH <= 4 ? 4 : CH <= 8 ? 8
                          : CH <= 16 ? 16 : 32;
  static_assert(CH <= 32, "a row must fit one warp's 16-byte loads");
  static constexpr int KPS = 32 / LG;
};

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// merge (m2, l2, acc2) into (m, l, acc); m in log2 units
template <int E>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[E],
                                      float m2, float l2,
                                      const float (&acc2)[E]) {
  const float mn = fmaxf(m, m2);
  const float base = mn == -INFINITY ? 0.0f : mn;
  const float a = exp2_sfu(m - base);
  const float c = exp2_sfu(m2 - base);
  l = l * a + l2 * c;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = acc[e] * a + acc2[e] * c;
  m = mn;
}

// each warp's (m, l, acc) for the block's rows, and their merge weights
template <int D, int RP>
struct SplitSmem {
  float acc[kWarps][RP][D];
  float m[kWarps][RP], l[kWarps][RP];
  float w[kWarps][RP];  // each warp's weight in its row's merge
  float M[RP], L[RP];
};

// The warps have written their rows' (m, l, acc) to `sm` (rows < R):
// merge them in warp order and write o (no partials buffer: a single
// split) or this split's partials (m, l, acc[D]; (-inf, 0, 0) for a split
// with no visible key).
template <typename T, int D, int RP>
__device__ __forceinline__ void finish_split(
    SplitSmem<D, RP>& sm, T* __restrict__ o, float* __restrict__ part,
    int R, int G, int T_len, int H, int KV, int b, int kvh, int split,
    int n_splits) {
  __syncthreads();
  if (threadIdx.x < R) {  // each row's warp weights, once
    const int r = threadIdx.x;
    float mx = sm.m[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm.m[w][r]);
    const float base = mx == -INFINITY ? 0.0f : mx;
    float L = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2_sfu(sm.m[w][r] - base);  // 0: no visible key
      sm.w[w][r] = wt;
      L = fmaf(sm.l[w][r], wt, L);
    }
    sm.M[r] = mx;
    sm.L[r] = L;
  }
  __syncthreads();
  const size_t part_rows = (size_t)gridDim.z * KV * n_splits * R;
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaf(sm.acc[w][r][d], sm.w[w][r], a);
    const float L = sm.L[r];
    if (part == nullptr) {  // the whole key range in one split: write o
      const int t = r / G;
      const int g = r - t * G;
      o[(((size_t)b * T_len + t) * H + (size_t)kvh * G + g) * D + d] =
          from_float<T>(L == 0.0f ? 0.0f : a / L);
    } else {
      const size_t prow = (((size_t)b * KV + kvh) * n_splits + split) * R + r;
      part[prow * D + d] = a;
      if (d == 0) {
        float2* ml = reinterpret_cast<float2*>(part + part_rows * D);
        ml[prow] = make_float2(sm.M[r], L);
      }
    }
  }
}

// The fp32 split-KV kernel on the CUDA cores: RP (T*G rounded up to a
// power of two) rows held in registers per lane, lanes over 16-byte chunks
// of a K/V row, warp shuffles for the dot products.
template <int D, int RP>
__global__ void __launch_bounds__(kThreads)
flash_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ part,
                   const int32_t* __restrict__ kv_len, int T_len, int S,
                   int H, int KV, int q_offset, int causal, int window,
                   float scale_log2, int keys_per_split) {
  using Gm = Geo<D>;
  constexpr int E = Gm::E, CH = Gm::CH, LG = Gm::LG, KPS = Gm::KPS;
  constexpr int U = RP >= 8 ? 2 : 4;  // warp steps whose loads fly together
  __shared__ SplitSmem<D, RP> sm;

  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int R = T_len * G;  // <= RP
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LG;  // which key of the warp step
  const int c = lane % LG;    // which 16-byte chunk of the row
  const bool lane_on = c < CH;

  q_offset = query_offset(q_offset, kv_len, b, T_len);
  int kv_valid = S;
  if (kv_len != nullptr) kv_valid = min(kv_valid, kv_len[b]);
  int kv_end = kv_valid;
  if (causal) kv_end = min(kv_end, q_offset + T_len);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_offset - window + 1);
  const long long split0 = (long long)split * keys_per_split;
  const int s_begin = (int)max((long long)kv_begin, split0);
  const int s_end = (int)min((long long)kv_end, split0 + keys_per_split);

  float qf[RP][E];
  int qpos[RP];
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    const int t = r / G;
    const int g = r - t * G;
    qpos[r] = q_offset + t;
    if (r < R && lane_on) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          q + (((size_t)b * T_len + t) * H + (size_t)kvh * G + g) * D +
          c * E));
      unpack(raw, qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qf[r][e] = 0.0f;
    }
  }
  float m[RP], l[RP], acc[RP][E];
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
  }

  const size_t key_stride = (size_t)KV * D;
  const float* kb = k + ((size_t)b * S * KV + kvh) * D + c * E;
  const float* vb = v + ((size_t)b * S * KV + kvh) * D + c * E;
  constexpr int kStep = kWarps * KPS;  // keys one step of the block covers
  // the K and V chunks of U steps from key0 (zeros past the split's end)
  auto load = [&](int key0, uint4 (&kr)[U], uint4 (&vr)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = key0 + u * kStep + grp;
      if (key < s_end && lane_on) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + key * key_stride));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + key * key_stride));
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = kr[u];
      }
    }
  };
  uint4 kr[U], vr[U];
  load(s_begin + warp * KPS, kr, vr);
  for (int key0 = s_begin + warp * KPS; key0 < s_end; key0 += kStep * U) {
    uint4 kn[U], vn[U];
    load(key0 + kStep * U, kn, vn);  // the next U steps fly meanwhile
    float sc[U][RP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = key0 + u * kStep + grp;
      float kf[E];
      unpack(kr[u], kf);
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[r][e], kf[e], d);
#pragma unroll
        for (int off = LG / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(kFullMask, d, off);
        const bool vis = key < s_end && r < R &&
                         (!causal || key <= qpos[r]) &&
                         (window <= 0 || key > qpos[r] - window);
        sc[u][r] = vis ? d * scale_log2 : -INFINITY;
      }
    }
    float vf[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) unpack(vr[u], vf[u]);
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      float mt = sc[0][r];
#pragma unroll
      for (int u = 1; u < U; ++u) mt = fmaxf(mt, sc[u][r]);
      const float mn = fmaxf(m[r], mt);
      const float base = mn == -INFINITY ? 0.0f : mn;
      const float alpha = exp2_sfu(m[r] - base);
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2_sfu(sc[u][r] - base);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, vf[u][e], acc[r][e]);
      }
      m[r] = mn;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
    }
  }

  // merge the warp's lane groups (each saw other keys), then the warps
#pragma unroll
  for (int off = LG; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      float acc2[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc2[e] = __shfl_xor_sync(kFullMask, acc[r][e], off);
      const float m2 = __shfl_xor_sync(kFullMask, m[r], off);
      const float l2 = __shfl_xor_sync(kFullMask, l[r], off);
      merge(m[r], l[r], acc[r], m2, l2, acc2);
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      if (lane_on) {
#pragma unroll
        for (int e = 0; e < E; ++e) sm.acc[warp][r][c * E + e] = acc[r][e];
      }
      if (c == 0) {
        sm.m[warp][r] = m[r];
        sm.l[warp][r] = l[r];
      }
    }
  }
  finish_split<float, D, RP>(sm, o, part, R, G, T_len, H, KV, b, kvh, split,
                         n_splits);
}

// 8x8 b16 transpose across the warp: lane (r, c) of the source holds
// elements (r, 2c), (r, 2c+1); of the result, those of the transpose
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// c += a (16x16 bf16, rows 8-15 zero) * b (16x8 bf16), for the 8 real rows:
// a0 and a2 are the lane's two A registers of rows 0-7
__device__ __forceinline__ void mma_rows8(float (&c)[2], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  float pad0, pad1;  // rows 8-15 of the product, always 0
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %6, %5, %6}, {%7, %8}, {%0, %1, %9, %9};\n"
      : "+f"(c[0]), "+f"(c[1]), "=f"(pad0), "=f"(pad1)
      : "r"(a0), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.0f));
}

// The bf16 split-KV kernel on the tensor cores.  Same grid, key ranges,
// masks and partials as flash_split_kernel; the T*G <= 8 rows are rows 0-7
// of one m16n8k16 tile.  Lane (g, t) = (lane / 4, lane % 4) reads 16-byte
// chunks 4j + t (dims 32j + 8t .. 32j + 8t + 7) of q row g and of K/V rows
// g of each 8-key tile, straight into mma fragments: the product's depth
// runs over the dims in the order (j, t, h, e) -> 32j + 8t + 4h + e, the
// same for Q and K, so no shuffle is needed.  V's chunks are turned into
// the P·V product's B fragments by movmatrix; output tile (j, i) then
// holds dims 32j + 8t + 2i + {0, 1} of row g.  Each warp takes 16 keys at
// a time.  P is split into bf16 hi + lo parts, as on the tiled path.
template <int D>
__global__ void __launch_bounds__(kThreads, 3)  // 3 blocks an SM (<= 168 regs)
flash_split_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ part,
                       const int32_t* __restrict__ kv_len, int T_len, int S,
                       int H, int KV, int q_offset, int causal, int window,
                       float scale_log2, int keys_per_split) {
  constexpr int J = (D + 31) / 32;  // 32-dim groups of a row
  constexpr int CH = D / 8;         // 16-byte chunks of a row
  constexpr int kKeys = 16;         // keys a warp takes at a time
  __shared__ SplitSmem<D, kMaxRows> sm;

  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int R = T_len * G;  // <= kMaxRows
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  q_offset = query_offset(q_offset, kv_len, b, T_len);
  int kv_valid = S;
  if (kv_len != nullptr) kv_valid = min(kv_valid, kv_len[b]);
  int kv_end = kv_valid;
  if (causal) kv_end = min(kv_end, q_offset + T_len);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_offset - window + 1);
  const long long split0 = (long long)split * keys_per_split;
  const int s_begin = (int)max((long long)kv_begin, split0);
  const int s_end = (int)min((long long)kv_end, split0 + keys_per_split);

  // q row g as A fragments: k-step 2j + h takes chunk 4j + t's words
  // (2h, 2h + 1) as its (a0, a2)
  const bool row_on = g < R;
  const int qpos = q_offset + g / G;
  uint4 qx[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = 4 * j + t;
    qx[j] = make_uint4(0u, 0u, 0u, 0u);
    if (row_on && c < CH)
      qx[j] = __ldg(reinterpret_cast<const uint4*>(
          q + (((size_t)b * T_len + g / G) * H + (size_t)kvh * G + g % G) *
                  D + c * 8));
  }
  float oacc[4 * J][2];
#pragma unroll
  for (int i = 0; i < 4 * J; ++i) oacc[i][0] = oacc[i][1] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  const size_t key_stride = (size_t)KV * D;
  const size_t kv_base = ((size_t)b * S * KV + kvh) * D;
  for (int kc = s_begin + warp * kKeys; kc < s_end; kc += kWarps * kKeys) {
    uint4 kx[2][J], vx[2][J];  // rows kc + 8n + g, chunks 4j + t
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int key = kc + 8 * n + g;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = 4 * j + t;
        kx[n][j] = vx[n][j] = make_uint4(0u, 0u, 0u, 0u);
        if (key < s_end && c < CH) {
          const size_t off = kv_base + (size_t)key * key_stride + c * 8;
          kx[n][j] = __ldg(reinterpret_cast<const uint4*>(k + off));
          vx[n][j] = __ldg(reinterpret_cast<const uint4*>(v + off));
        }
      }
    }
    // S = q K^T: row g, keys kc + 8n + 2t + {0, 1}
    float sc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        mma_rows8(sc[n], qx[j].x, qx[j].y, kx[n][j].x, kx[n][j].y);
        mma_rows8(sc[n], qx[j].z, qx[j].w, kx[n][j].z, kx[n][j].w);
      }
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kc + 8 * n + 2 * t + e;
        const bool vis = row_on && key < s_end &&
                         (!causal || key <= qpos) &&
                         (window <= 0 || key > qpos - window);
        sc[n][e] = vis ? sc[n][e] : -INFINITY;
        mx = fmaxf(mx, sc[n][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
    const float mn = fmaxf(m, mx * scale_log2);
    const float base = mn == -INFINITY ? 0.0f : mn;
    const float alpha = exp2_sfu(m - base);
    m = mn;
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[n][e] = exp2_sfu(fmaf(sc[n][e], scale_log2, -base));
        sum += sc[n][e];
      }
    l = l * alpha + sum;  // the lane's share; the quad sums at the end
    uint32_t ph[2], pl[2];  // A fragments (a0, a2) of P: keys 2t, 8 + 2t
    split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_bf16(sc[1][0], sc[1][1], ph[1], pl[1]);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const uint32_t w0[4] = {vx[0][j].x, vx[0][j].y, vx[0][j].z, vx[0][j].w};
      const uint32_t w1[4] = {vx[1][j].x, vx[1][j].y, vx[1][j].z, vx[1][j].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float(&c)[2] = oacc[4 * j + i];
        c[0] *= alpha;
        c[1] *= alpha;
        const uint32_t b0 = movmatrix_trans(w0[i]);
        const uint32_t b1 = movmatrix_trans(w1[i]);
        mma_rows8(c, ph[0], ph[1], b0, b1);
        mma_rows8(c, pl[0], pl[1], b0, b1);
      }
    }
  }

  l += __shfl_xor_sync(kFullMask, l, 1);
  l += __shfl_xor_sync(kFullMask, l, 2);
  if (row_on) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 32 * j + 8 * t + 2 * i;
        if (d < D) {
          sm.acc[warp][g][d] = oacc[4 * j + i][0];
          sm.acc[warp][g][d + 1] = oacc[4 * j + i][1];
        }
      }
    if (t == 0) {
      sm.m[warp][g] = m;
      sm.l[warp][g] = l;
    }
  }
  finish_split<__nv_bfloat16, D, kMaxRows>(sm, o, part, R, G, T_len, H, KV,
                                           b, kvh, split, n_splits);
}

// one warp per output row (b, t, h): merge its splits' partials in split
// order (lanes take the splits' (m, l) in turns for the weights).  The
// partials of n_ranks ranks lie one after another, each rank's as one
// split launch writes them (acc rows, then (m, l) pairs); split s of rank
// p is split p * n_splits + s of the merge.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_combine_kernel(const float* __restrict__ part, T* __restrict__ o,
                     int B, int T_len, int H, int KV, int n_splits,
                     int n_ranks) {
  constexpr int DL = (D + 31) / 32;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * T_len * H) return;
  const int h = (int)(row % H);
  const long long bt = row / H;
  const int t = (int)(bt % T_len);
  const int b = (int)(bt / T_len);
  const int G = H / KV;
  const int kvh = h / G;
  const int R = T_len * G;
  const int r = t * G + (h - kvh * G);
  const size_t part_rows = (size_t)B * KV * n_splits * R;
  const size_t rank_floats = part_rows * (D + 2);
  const size_t prow0 = ((size_t)b * KV + kvh) * n_splits * R + r;
  const int total = n_splits * n_ranks;
  // (m, l) and acc of merged split gs = p * n_splits + s
  auto ml_at = [&](int gs) -> float2 {
    const int p = gs / n_splits;
    const float2* ml = reinterpret_cast<const float2*>(
        part + (size_t)p * rank_floats + part_rows * D);
    return ml[prow0 + (size_t)(gs - p * n_splits) * R];
  };
  auto acc_at = [&](int gs) -> const float* {
    const int p = gs / n_splits;
    return part + (size_t)p * rank_floats +
           (prow0 + (size_t)(gs - p * n_splits) * R) * D;
  };

  float mx = -INFINITY;
  for (int s = lane; s < total; s += 32) mx = fmaxf(mx, ml_at(s).x);
  mx = warp_max(mx);
  const float base = mx == -INFINITY ? 0.0f : mx;
  float L = 0.0f, acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.0f;
  for (int s0 = 0; s0 < total; s0 += 32) {
    float w = 0.0f;  // split s0 + lane's weight; 0 for a split with no key
    if (s0 + lane < total) {
      const float2 p = ml_at(s0 + lane);
      w = exp2_sfu(p.x - base);
      L = fmaf(p.y, w, L);
    }
    const int n = min(32, total - s0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(kFullMask, w, j);
      const float* src = acc_at(s0 + j);
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(src[d], wj, acc[i]);
      }
    }
  }
  L = warp_sum(L);
  T* orow = o + (((size_t)b * T_len + t) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) orow[d] = from_float<T>(L == 0.0f ? 0.0f : acc[i] / L);
  }
}

// the merge of n_ranks * n_splits splits' partials into o
template <typename T, int D>
int launch_combine(const float* part, void* o, int B, int T_len, int H,
                   int KV, int n_splits, int n_ranks, cudaStream_t stream) {
  const long long rows = (long long)B * T_len * H;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  flash_combine_kernel<T, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      part, static_cast<T*>(o), B, T_len, H, KV, n_splits, n_ranks);
  return (int)cudaGetLastError();
}

// the split kernel of a dtype and row count: bf16 on the tensor cores,
// fp32 on the CUDA cores
template <typename T, int D>
int launch_split(const void* q, const void* k, const void* v, void* o,
                 float* part, const int32_t* kv_len, int B, int T_len, int S,
                 int H, int KV, int q_offset, int causal, int window,
                 float scale, int n_splits, int keys_per_split,
                 cudaStream_t stream) {
  const int R = T_len * (H / KV);
  void (*kern)(const T*, const T*, const T*, T*, float*, const int32_t*, int,
               int, int, int, int, int, int, float, int);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    kern = flash_split_mma_kernel<D>;
  } else {
    kern = R <= 1   ? flash_split_kernel<D, 1>
           : R <= 2 ? flash_split_kernel<D, 2>
           : R <= 4 ? flash_split_kernel<D, 4>
                    : flash_split_kernel<D, kMaxRows>;
  }
  const dim3 grid((unsigned)n_splits, (unsigned)KV, (unsigned)B);
  kern<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), part, kv_len, T_len, S,
      H, KV, q_offset, causal, window, scale * kLog2e, keys_per_split);
  return (int)cudaGetLastError();
}

// the split kernel, then (more than one split) the merge; one split
// writes o itself (no partials buffer)
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* part,
           const int32_t* kv_len, int B, int T_len, int S, int H, int KV,
           int q_offset, int causal, int window, float scale, int n_splits,
           int keys_per_split, cudaStream_t st) {
  float* p = n_splits > 1 ? part : nullptr;
  const int err = launch_split<T, D>(q, k, v, o, p, kv_len, B, T_len, S, H,
                                     KV, q_offset, causal, window, scale,
                                     n_splits, keys_per_split, st);
  if (err != 0 || p == nullptr) return err;
  return launch_combine<T, D>(p, o, B, T_len, H, KV, n_splits, 1, st);
}

}  // namespace split

template <typename T>
int dispatch_d(int path, const void* q, const void* k, const void* v,
               void* o, float* part, const int32_t* kv_len, int B, int T_len,
               int S, int H, int KV, int D, int q_offset, int causal,
               int window, float scale, int n_splits, int keys_per_split,
               cudaStream_t st) {
#define FLASH_CASE(DD)                                                        \
  case DD:                                                                    \
    if (path == 1)                                                            \
      return split::launch<T, DD>(q, k, v, o, part, kv_len, B, T_len, S, H,   \
                                  KV, q_offset, causal, window, scale,        \
                                  n_splits, keys_per_split, st);              \
    if (sizeof(T) == 2)                                                       \
      return tiled::launch<DD>(q, k, v, o, kv_len, B, T_len, S, H, KV,        \
                               q_offset, causal, window, scale, st);          \
    return launch<float, DD>(q, k, v, o, kv_len, B, T_len, S, H, KV,          \
                             q_offset, causal, window, scale, st);
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(64)
    FLASH_CASE(120)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// the split-KV entries of a sequence-sharded cache, by dtype and head dim
template <typename T>
int dispatch_partials(const void* q, const void* k, const void* v,
                      float* part, const int32_t* kv_len, int B, int T_len,
                      int S, int H, int KV, int D, int q_offset, int causal,
                      int window, float scale, int n_splits,
                      int keys_per_split, cudaStream_t st) {
  switch (D) {
#define FLASH_CASE(DD)                                                        \
  case DD:                                                                    \
    return split::launch_split<T, DD>(q, k, v, nullptr, part, kv_len, B,      \
                                      T_len, S, H, KV, q_offset, causal,      \
                                      window, scale, n_splits,                \
                                      keys_per_split, st);
    FLASH_CASE(16)
    FLASH_CASE(64)
    FLASH_CASE(120)
    FLASH_CASE(128)
#undef FLASH_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_combine(const float* part, void* o, int B, int T_len, int H,
                     int KV, int D, int n_splits, int n_ranks,
                     cudaStream_t st) {
  switch (D) {
#define FLASH_CASE(DD)                                                        \
  case DD:                                                                    \
    return split::launch_combine<T, DD>(part, o, B, T_len, H, KV, n_splits,   \
                                        n_ranks, st);
    FLASH_CASE(16)
    FLASH_CASE(64)
    FLASH_CASE(120)
    FLASH_CASE(128)
#undef FLASH_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Plain C entry point, bound with ctypes.  dtype: 0 = fp32, 1 = bf16.
// kv_len: (B,) int32 on the device, or null.  window <= 0 means none.
// path 0 (tiled): bf16 on the tensor cores, fp32 on the CUDA cores.
// path 1 (split-KV, T*(H/KV) <= 8): n_splits key ranges of keys_per_split
// keys (n_splits * keys_per_split >= S); with n_splits > 1, `scratch`
// holds B*T*H*n_splits*(D+2) floats (the partials), else it may be null.
// q, k, v, o: 16-byte aligned.  Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for what the kernels
// do not take (D outside {16, 64, 120, 128}, H not a multiple of KV, a
// split plan that does not cover S, a grid too large).
static int launch_entry(const void* q, const void* k, const void* v,
                        void* o, const void* kv_len, int B, int T_len, int S,
                        int H, int KV, int D, int dtype, int q_offset,
                        int causal, int window, float scale, int path,
                        int n_splits, int keys_per_split, void* scratch,
                        void* stream) {
  if (B < 1 || T_len < 1 || S < 0 || KV < 1 || H < KV || H % KV != 0 ||
      B > 65535 || KV > 65535 || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  if (path == 1 &&
      ((long long)T_len * (H / KV) > split::kMaxRows || n_splits < 1 ||
       n_splits > 65535 || keys_per_split < 1 ||
       (long long)n_splits * keys_per_split < S ||
       (n_splits > 1 && scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int32_t* kvl = static_cast<const int32_t*>(kv_len);
  float* part = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(path, q, k, v, o, part, kvl, B, T_len, S, H, KV,
                             D, q_offset, causal, window, scale, n_splits,
                             keys_per_split, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(path, q, k, v, o, part, kvl, B, T_len,
                                     S, H, KV, D, q_offset, causal, window,
                                     scale, n_splits, keys_per_split, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const void* kv_len, int B, int T_len,
                                      int S, int H, int KV, int D, int dtype,
                                      int q_offset, int causal, int window,
                                      float scale, int path, int n_splits,
                                      int keys_per_split, void* scratch,
                                      void* stream) {
  if (q_offset == kOffsetFromKvLen) return (int)cudaErrorInvalidValue;
  return launch_entry(q, k, v, o, kv_len, B, T_len, S, H, KV, D, dtype,
                      q_offset, causal, window, scale, path, n_splits,
                      keys_per_split, scratch, stream);
}

// The decode entry with the position on the device (5 above): as
// flash_attention_launch, but batch row b's queries sit at kv_len[b] - T
// .. kv_len[b] - 1, read in the kernel; kv_len (B,) int32 is required.
// Either path (a decode step of more than 8 (t, g) rows per kv head is
// tiled).
extern "C" int flash_attention_decode(const void* q, const void* k,
                                      const void* v, void* o,
                                      const void* kv_len, int B, int T_len,
                                      int S, int H, int KV, int D, int dtype,
                                      int causal, int window, float scale,
                                      int path, int n_splits,
                                      int keys_per_split, void* scratch,
                                      void* stream) {
  if (kv_len == nullptr) return (int)cudaErrorInvalidValue;
  return launch_entry(q, k, v, o, kv_len, B, T_len, S, H, KV, D, dtype,
                      kOffsetFromKvLen, causal, window, scale, path,
                      n_splits, keys_per_split, scratch, stream);
}

// Partials out (sequence-sharded cache): the split-KV kernel over this
// rank's K/V range of S keys, n_splits ranges of keys_per_split keys, its
// fp32 partials written to the caller's `part`: B*T*H*n_splits*(D+2)
// floats, acc rows ((b*KV + kvh)*n_splits + split)*R + r (R = T*(H/KV),
// r = t*(H/KV) + g) of D floats, then one (m, l) pair per row, m in log2
// units.  q_offset and kv_len are the rank's (shifted by the range's
// start by the caller; q_offset may be negative).  T*(H/KV) <= 8.  Never
// writes o.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int flash_attention_partials(const void* q, const void* k,
                                        const void* v, const void* kv_len,
                                        int B, int T_len, int S, int H,
                                        int KV, int D, int dtype,
                                        int q_offset, int causal, int window,
                                        float scale, int n_splits,
                                        int keys_per_split, void* part,
                                        void* stream) {
  if (B < 1 || T_len < 1 || S < 0 || KV < 1 || H < KV || H % KV != 0 ||
      B > 65535 || KV > 65535 || part == nullptr ||
      q_offset == kOffsetFromKvLen ||
      (long long)T_len * (H / KV) > split::kMaxRows || n_splits < 1 ||
      n_splits > 65535 || keys_per_split < 1 ||
      (long long)n_splits * keys_per_split < S)
    return (int)cudaErrorInvalidValue;
  const int32_t* kvl = static_cast<const int32_t*>(kv_len);
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_partials<float>(q, k, v, p, kvl, B, T_len, S, H, KV, D,
                                    q_offset, causal, window, scale,
                                    n_splits, keys_per_split, st);
  if (dtype == 1)
    return dispatch_partials<__nv_bfloat16>(q, k, v, p, kvl, B, T_len, S, H,
                                            KV, D, q_offset, causal, window,
                                            scale, n_splits, keys_per_split,
                                            st);
  return (int)cudaErrorInvalidValue;
}

// Partials in: n_ranks ranks' partial buffers, one after another in rank
// order, each laid out as flash_attention_partials writes it with n_splits
// splits; merges every rank's splits in (rank, split) order into o
// (B, T, H, D) of dtype (0 = fp32, 1 = bf16).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue.
extern "C" int flash_attention_combine(const void* part, void* o, int B,
                                       int T_len, int H, int KV, int D,
                                       int dtype, int n_splits, int n_ranks,
                                       void* stream) {
  if (B < 1 || T_len < 1 || KV < 1 || H < KV || H % KV != 0 ||
      part == nullptr || o == nullptr || n_splits < 1 || n_ranks < 1 ||
      (long long)T_len * (H / KV) > split::kMaxRows)
    return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_combine<float>(p, o, B, T_len, H, KV, D, n_splits,
                                   n_ranks, st);
  if (dtype == 1)
    return dispatch_combine<__nv_bfloat16>(p, o, B, T_len, H, KV, D,
                                           n_splits, n_ranks, st);
  return (int)cudaErrorInvalidValue;
}
