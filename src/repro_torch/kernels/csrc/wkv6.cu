// wkv6.cu — the RWKV6 (Finch) WKV recurrence, chunked, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/wkv6.py::wkv6, the Pallas TPU kernel
// (`_kernel`) that carries an fp32 (N, N) state in VMEM scratch across a
// sequential chunk grid axis.
//
// Computes, for r, k, v, w (B, T, H, N) of one dtype (fp32 or bf16), the
// bonus u (H, N) fp32 and an incoming state S0 (B, H, N, N) fp32 (or none:
// zeros), the recurrence
//   y_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
// with the semantics of ref.wkv6_chunked_ref: w enters as max(w, 1e-12),
// and a decay between two rows of one chunk is floored at e^-60 (the
// reference clips its log-space difference at -60).  y has the inputs'
// dtype; the state leaves in fp32.
//
// Bound on this card, at the rwkv6-7b prefill shape (B, T, H, N) =
// (8, 512, 64, 64) in bf16: r, k, v, w in and y out are 5 x 33.55 MB, the
// state in and out 2 x 8.39 MB: 184.5 MB, 0.055 ms at 3.35 TB/s.  The
// recurrence's own work, 4*B*T*H*N^2 = 4.3 GFLOP, takes 0.004 ms at the
// bf16 tensor-core peak: bound by bytes.
//
// 1. wkv6_mma_kernel (bf16: the serving path).  The first design (the
//    fp32 kernel below, run on bf16 inputs) took 1.53 ms: every
//    multiply-add read its operands from shared memory (about 64 K
//    warp-wide loads a chunk), one expf per (t, j < t, n) for the
//    intra-chunk decay, 115 KB of shared memory (two blocks an SM, 1.94
//    waves).  This design moves the products onto the tensor cores with
//    their operands in registers, and drops every exp and log:
//    * Sub-chunks of 8 rows, carried through the state.  For each
//      sub-chunk, with pre[t] / suf[j] the products of max(w, 1e-12) over
//      its rows before t / after j, and dec over all its rows:
//        y  = (r * pre) @ S + A @ v,   S' = dec * S + (k * suf)^T @ v,
//        A[t, j] = sum_n r[t,n] k[j,n] prod_{j<s<t} w[s,n] (j < t),
//        A[t, t] = sum_n r[t,n] u[n] k[t,n]  (the bonus).
//      The weight of key j on a row t of a later sub-chunk is thus
//      pre[t] x (the decays of the whole sub-chunks between, carried by
//      S) x suf[j]: a product of factors in (0, 1], so none overflows (the
//      chunk-wide exp(excl) * exp(-incl) does, under strong decay).  All
//      of them, and the (8 x 8) diagonal blocks A, are running products
//      of w in row order: no exp, no log, no special-function unit.  The
//      user's chunk only has to divide T, as in the reference: the result
//      is the same function up to rounding (ref.wkv6_ref).
//    * One block of N/16 warps per (b, h); warp i owns columns
//      [16i, 16i + 16) of the value dimension m.  The state lives in the
//      warp's registers as S^T, the accumulator fragments of
//      mma.sync.m16n8k16 / m16n8k8 (bf16 in, fp32 accumulate), and each
//      step's S^T fragments are also the A operand of y^T = S^T q^T
//      (register-fed, no shared memory).  Per sub-chunk a warp issues,
//      at N = 64: y^T += S^T (r*pre)^T (4 k16 steps), y^T += v^T A^T and
//      S^T += v^T (k*suf) (8 n-tiles, k8), operands by ldmatrix.
//    * Precision: the fp32 operands (S, r*pre, k*suf, A) enter as three
//      bf16 terms each (hi, mid, lo: 24 bits), and the products of terms
//      i, j with i + j < 3 are summed (6 mma for S·q, 3 where the other
//      operand is the exact bf16 v): each operand keeps 24 bits, as in
//      fp32, where two terms (16 bits) would leave 2^-17 of it, above
//      fp32's rounding where |r|, |k|, |v| ~ 100 products cancel; one term
//      fails the bf16 gate there (kernels/wkv6.py:subchunk_model models
//      all of this on the CPU).
//    * Per tile of 32 rows: cp.async stages r, k, w, v (the next tile's
//      copy in flight during this tile's products; v double-buffered);
//      warp i forms sub-chunk i's pre/suf/dec, A (8 j x 4 channel groups a
//      warp, the channel sums by two shuffles) and the bf16 terms into
//      shared memory; then each warp runs the tile's 4 sub-chunks.  53 KB
//      of shared memory at N = 64: four blocks an SM, one wave of 512.
//    What bounds it (measured at the serving shape on an H100 80GB HBM3
//    at 700 W by launch/wkv6_breakdown.py, PERF.md): 0.215 ms, of which
//    the loads, stores and barriers alone take 0.060 (the bytes' bound is
//    0.055), the prep ~0.05 and the products ~0.07, not fully overlapped;
//    128 registers at N = 64.  The next levers: fewer instructions per
//    product (16-row sub-chunks for the products, the off-diagonal block
//    of A on the tensor cores) and overlapping the prep with the products.
//    The state pointers may alias: warp i reads its own columns of the
//    (b, h) slice of S0 before it writes them, and no other warp or block
//    touches them.
// 2. wkv6_fp32_kernel (fp32: the parity path, the first design).  One block
//    of 256 threads per (b, h), the state in shared memory, per chunk: r,
//    k, v and log w staged as fp32, incl/excl by one prefix sum per key
//    channel, A with one warp per row t from IEEE expf of the clipped
//    log-space differences, then y (one thread per (t, m)) and the new
//    state (one per (n, m)) as fp32 dot products.  115,200 bytes of
//    shared memory at C = N = 64.  It keeps fp32's 1e-4 tolerance and is
//    off the serving path.
//
// Build without --use_fast_math: the fp32 kernel's decay path needs IEEE
// expf and logf.
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libwkv6.so wkv6.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// 2. the fp32 kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;

// clip to [-60, 0] as jnp.clip / torch.clamp do, NaN passing through
__device__ __forceinline__ float clip_decay(float x) {
  return x < -60.0f ? -60.0f : (x > 0.0f ? 0.0f : x);
}

template <int N>
constexpr size_t smem_floats(int C) {
  // r, v, excl: [C][N]; k, incl: [C][N+1]; S: [N][N]; A: [C][C]
  return 3 * (size_t)C * N + 2 * (size_t)C * (N + 1) + (size_t)N * N +
         (size_t)C * C;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
wkv6_fp32_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* s_in,
                 float* s_out, float* __restrict__ y, int T_len, int H,
                 int C) {
  constexpr int NP = N + 1;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;            // [C][N]   r, then r * exp(excl)
  float* vs = rs + C * N;      // [C][N]   v
  float* ex = vs + C * N;      // [C][N]   log w, then excl
  float* ks = ex + C * N;      // [C][N+1] k, then k * exp(clip(total - incl))
  float* in = ks + C * NP;     // [C][N+1] incl
  float* S = in + C * NP;      // [N][N]   the carried state
  float* A = S + N * N;        // [C][C]   intra-chunk weights, bonus on the diagonal

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row_stride = (size_t)H * N;  // between consecutive t
  const size_t base = ((size_t)b * T_len * H + h) * N;
  const float* ub = u + (size_t)h * N;

  // the block's slice of the incoming state, read before anything is written
  if (s_in != nullptr) {
    const float* sb = s_in + (size_t)bh * N * N;
    for (int i = tid; i < N * N; i += kThreads) S[i] = sb[i];
  } else {
    for (int i = tid; i < N * N; i += kThreads) S[i] = 0.0f;
  }

  for (int c0 = 0; c0 < T_len; c0 += C) {
    __syncthreads();  // the previous chunk is consumed (and S is staged)

    // 1. stage the chunk's rows
    for (int i = tid; i < C * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      const size_t off = base + (size_t)(c0 + t) * row_stride + n;
      rs[i] = r[off];
      vs[i] = v[off];
      ks[t * NP + n] = k[off];
      const float wf = w[off];
      ex[i] = logf(wf < 1e-12f ? 1e-12f : wf);
    }
    __syncthreads();

    // 2. incl = cumsum(lw), excl = incl - lw: one thread per key channel
    for (int n = tid; n < N; n += kThreads) {
      float acc = 0.0f;
      for (int t = 0; t < C; ++t) {
        const float lw = ex[t * N + n];
        acc += lw;
        in[t * NP + n] = acc;
        ex[t * N + n] = acc - lw;
      }
    }
    __syncthreads();

    // 3. A[t, j < t] from the clipped log-space decay differences, and the
    //    bonus r_t . u . k_t on the diagonal: one warp per row t
    for (int t = warp; t < C; t += kWarps) {
      const float* rt = rs + t * N;
      const float* et = ex + t * N;
      for (int j = lane; j < C; j += 32) {
        float a = 0.0f;
        if (j < t) {
          const float* kj = ks + j * NP;
          const float* ij = in + j * NP;
#pragma unroll 8
          for (int n = 0; n < N; ++n)
            a = fmaf(rt[n] * kj[n], expf(clip_decay(et[n] - ij[n])), a);
        } else if (j == t) {
          const float* kt = ks + t * NP;
#pragma unroll 8
          for (int n = 0; n < N; ++n) a = fmaf(rt[n] * __ldg(ub + n), kt[n], a);
        }
        A[t * C + j] = a;
      }
    }
    __syncthreads();

    // 4. in place: r <- r * exp(excl), k <- k * exp(clip(total - incl))
    const float* tot = in + (C - 1) * NP;
    for (int i = tid; i < C * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      rs[i] *= expf(ex[i]);
      ks[t * NP + n] *= expf(clip_decay(tot[n] - in[t * NP + n]));
    }
    __syncthreads();

    // 5. y = (r * exp(excl)) @ S + A @ v  (A holds the bonus on j == t)
    for (int i = tid; i < C * N; i += kThreads) {
      const int t = i / N;
      const int m = i - t * N;
      const float* qt = rs + t * N;
      float acc = 0.0f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) acc = fmaf(qt[n], S[n * N + m], acc);
      const float* at = A + t * C;
      for (int j = 0; j <= t; ++j) acc = fmaf(at[j], vs[j * N + m], acc);
      y[base + (size_t)(c0 + t) * row_stride + m] = acc;
    }
    __syncthreads();  // every read of S for this chunk's y is done

    // 6. S = exp(total) * S + (decayed k)^T @ v
    for (int i = tid; i < N * N; i += kThreads) {
      const int n = i / N;
      const int m = i - n * N;
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < C; ++j) acc = fmaf(ks[j * NP + n], vs[j * N + m], acc);
      S[i] = expf(tot[n]) * S[i] + acc;
    }
  }
  __syncthreads();

  float* so = s_out + (size_t)bh * N * N;
  for (int i = tid; i < N * N; i += kThreads) so[i] = S[i];
}

// ---------------------------------------------------------------------------
// 1. the bf16 kernel
// ---------------------------------------------------------------------------

constexpr int kSub = 8;                     // rows per sub-chunk
constexpr int kTileRows = 32;               // rows staged per tile
constexpr int kSubs = kTileRows / kSub;     // sub-chunks per tile
constexpr int kParts = 3;                   // bf16 terms per fp32 operand
constexpr float kWMin = 1e-12f;             // the reference's clip of w
constexpr uint32_t kOnes = 0x3f803f80u;    // two bf16 1.0

template <int N>
struct MmaCfg {
  static constexpr int kWarps = N / 16;     // one per 16 columns of m
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kPitch = N + 8;      // bf16 per shared row: ldmatrix
                                            // reads 8 rows conflict-free
  static constexpr int kTile = kTileRows * kPitch;   // bf16 per staged tile
  static constexpr int kNG = N / 4;         // prep channels per lane group
  static constexpr int kCP = kNG < 8 ? kNG : 8;      // ... per pass
  static constexpr int kPasses = kNG / kCP;
  // shared memory, in bytes from the start
  static constexpr int kRaw = 0;                           // r, k, w
  static constexpr int kV = kRaw + 3 * kTile * 2;          // v, two tiles
  static constexpr int kQd = kV + 2 * kTile * 2;           // r*pre, 3 terms
  static constexpr int kKd = kQd + kParts * kTile * 2;     // k*suf, 3 terms
  static constexpr int kAd = kKd + kParts * kTile * 2;     // A, 3 terms
  static constexpr int kDec = kAd + kParts * kTileRows * kSub * 2;
  static constexpr int kYs = kDec + kSubs * N * 4;         // y staging
  static constexpr int kBytes = kYs + kWarps * kSub * 16 * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy, in flight until cp_async_wait_all
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
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

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a (16x8 bf16, row) * b (8x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_1688(float (&c)[4],
                                         const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ uint32_t as_u32(const __nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) as three packed bf16 pairs: t[0] = the pair rounded to bf16,
// t[1] the remainder rounded, t[2] what is left, rounded (x0 in the low
// half of each word, as mma's fragments take it).  t[0] + t[1] + t[2]
// holds 24 bits of each; every subtraction is exact.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& t0,
                                       uint32_t& t1, uint32_t& t2) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  t0 = as_u32(h);
  t1 = as_u32(m);
  t2 = as_u32(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// kCP consecutive bf16 from shared memory (16- or 8-byte aligned) as floats
template <int kCP>
__device__ __forceinline__ void load_row(const bf16* p, float (&out)[kCP]) {
  static_assert(kCP == 8 || kCP == 4, "8 or 4 channels a pass");
  if constexpr (kCP == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&wd[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const uint32_t wd[2] = {q.x, q.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&wd[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

// kCP floats as three bf16 terms into three shared rows (stride `part`)
template <int kCP>
__device__ __forceinline__ void store_split(bf16* p, int part,
                                            const float (&x)[kCP]) {
  uint32_t t[kParts][kCP / 2];
#pragma unroll
  for (int i = 0; i < kCP / 2; ++i)
    split3(x[2 * i], x[2 * i + 1], t[0][i], t[1][i], t[2][i]);
#pragma unroll
  for (int q = 0; q < kParts; ++q) {
    if constexpr (kCP == 8)
      *reinterpret_cast<uint4*>(p + q * part) =
          make_uint4(t[q][0], t[q][1], t[q][2], t[q][3]);
    else
      *reinterpret_cast<uint2*>(p + q * part) = make_uint2(t[q][0], t[q][1]);
  }
}

template <int N>
__global__ void __launch_bounds__(MmaCfg<N>::kThreads, 4)
wkv6_mma_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ w,
                const float* __restrict__ u, const float* s_in,
                float* s_out, bf16* __restrict__ y, int T_len, int H) {
  using Cfg = MmaCfg<N>;
  constexpr int P = Cfg::kPitch;
  constexpr int kTile = Cfg::kTile;
  constexpr int kCP = Cfg::kCP;
  constexpr int NT = N / 8;                 // n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* raw = reinterpret_cast<bf16*>(smem_b + Cfg::kRaw);  // r, k, w tiles
  bf16* vbuf = reinterpret_cast<bf16*>(smem_b + Cfg::kV);
  bf16* qd = reinterpret_cast<bf16*>(smem_b + Cfg::kQd);
  bf16* kd = reinterpret_cast<bf16*>(smem_b + Cfg::kKd);
  bf16* ad = reinterpret_cast<bf16*>(smem_b + Cfg::kAd);    // [3][32][8]
  float* dec = reinterpret_cast<float*>(smem_b + Cfg::kDec);  // [4][N]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                  // mma fragment row group
  const int c = lane & 3;                   // ... and column pair
  const int mw = warp * 16;                 // the warp's columns of m
  const size_t rs = (size_t)H * N;          // between consecutive t
  const size_t base = ((size_t)b * T_len * H + h) * N;
  bf16* ys = reinterpret_cast<bf16*>(smem_b + Cfg::kYs) + warp * kSub * 16;

  // S^T[m][n] as accumulator fragments: st[nt] holds (m = mw + g, mw + g +
  // 8) x (n = 8 nt + 2c, 8 nt + 2c + 1); read before anything is written
  float st[NT][4];
  if (s_in != nullptr) {
    const float* sb = s_in + (size_t)bh * N * N;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n0 = 8 * nt + 2 * c;
      st[nt][0] = sb[n0 * N + mw + g];
      st[nt][1] = sb[(n0 + 1) * N + mw + g];
      st[nt][2] = sb[n0 * N + mw + g + 8];
      st[nt][3] = sb[(n0 + 1) * N + mw + g + 8];
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.0f;
  }

  // stage rows [t0, t0 + 32) of r, k, w and v (v into buffer vb): 16-byte
  // copies, rows past T zero-filled
  auto load_tile = [&](int t0, int vb) {
    constexpr int kCPR = N / 8;             // 16-byte chunks per row
    constexpr int kPer = kTileRows * kCPR;
    for (int i = tid; i < 4 * kPer; i += Cfg::kThreads) {
      const int arr = i / kPer;
      const int rem = i - arr * kPer;
      const int row = rem / kCPR;
      const int cc = rem - row * kCPR;
      bf16* dst = (arr < 3 ? raw + arr * kTile : vbuf + vb * kTile) +
                  row * P + cc * 8;
      const int tg = t0 + row;
      const bf16* x = arr == 0 ? r : arr == 1 ? k : arr == 2 ? w : v;
      if (tg < T_len)
        cp_async16(smem_u32(dst), x + base + (size_t)tg * rs + cc * 8);
      else                                  // past T: r = k = v = 0, w = 1
        *reinterpret_cast<uint4*>(dst) =
            arr == 2 ? make_uint4(kOnes, kOnes, kOnes, kOnes)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  };

  const int n_tiles = (T_len + kTileRows - 1) / kTileRows;
  load_tile(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kTileRows;
    cp_async_wait_all();
    __syncthreads();  // the tile has landed; the last tile's products are done

    // --- prep: warp s forms sub-chunk s.  Lane (j, grp) owns row j of the
    // sub-chunk and channels [grp*N/4, grp*N/4 + N/4), kCP at a time, and
    // runs over the rows s2 in order with two running products: kq = k[j]
    // times the w of the rows after j so far (0 before j), which weighs
    // row s2's r into A[s2][j] and ends as k[j] * suf[j]; and pre[j].
    for (int s = warp; s < kSubs; s += Cfg::kWarps) {
      const int tb = s * kSub;
      if (t0 + tb >= T_len) break;
      const int j = lane >> 2;
      const int grp = lane & 3;
      const bf16* rr = raw + tb * P;
      const bf16* kr = raw + kTile + tb * P;
      const bf16* wr = raw + 2 * kTile + tb * P;
      float a[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) a[i] = 0.0f;
#pragma unroll
      for (int pass = 0; pass < Cfg::kPasses; ++pass) {
        const int n0 = grp * Cfg::kNG + pass * kCP;
        float kj[kCP], kq[kCP], pre[kCP], rj[kCP];
        load_row<kCP>(kr + j * P + n0, kj);
        load_row<kCP>(rr + j * P + n0, rj);
        float bonus = 0.0f;                 // r[j] . u . k[j]
#pragma unroll
        for (int i = 0; i < kCP; ++i) {
          bonus = fmaf(rj[i] * __ldg(u + (size_t)h * N + n0 + i), kj[i],
                       bonus);
          kq[i] = 0.0f;
          pre[i] = 1.0f;
        }
#pragma unroll
        for (int s2 = 0; s2 < kSub; ++s2) {
          float rv[kCP], wv[kCP];
          load_row<kCP>(rr + s2 * P + n0, rv);
          load_row<kCP>(wr + s2 * P + n0, wv);
          const bool eq = s2 == j, lt = s2 < j;
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < kCP; ++i) {
            const float wc = fmaxf(wv[i], kWMin);
            acc = fmaf(rv[i], kq[i], acc);
            kq[i] = eq ? kj[i] : kq[i] * wc;
            pre[i] *= lt ? wc : 1.0f;
          }
          a[s2] += eq ? bonus : acc;
        }
#pragma unroll
        for (int i = 0; i < kCP; ++i) rj[i] *= pre[i];
        store_split<kCP>(qd + (tb + j) * P + n0, kTile, rj);
        store_split<kCP>(kd + (tb + j) * P + n0, kTile, kq);
        if (j == kSub - 1) {                // dec: pre times the last row's w
          float wl[kCP];
          load_row<kCP>(wr + j * P + n0, wl);
#pragma unroll
          for (int i = 0; i < kCP; ++i)
            dec[s * N + n0 + i] = pre[i] * fmaxf(wl[i], kWMin);
        }
      }
      // A[s2][j]: sum the four channel groups; lane (j, grp) stores rows
      // 2 grp and 2 grp + 1 of column j
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        a[i] += __shfl_xor_sync(0xffffffffu, a[i], 1);
        a[i] += __shfl_xor_sync(0xffffffffu, a[i], 2);
      }
#pragma unroll
      for (int i = 0; i < kSub; i += 2) {
        if ((i >> 1) == grp) {
          uint32_t t[kParts][1];
          split3(a[i], a[i + 1], t[0][0], t[1][0], t[2][0]);
#pragma unroll
          for (int q = 0; q < kParts; ++q) {
            const __nv_bfloat162 pr =
                *reinterpret_cast<const __nv_bfloat162*>(&t[q][0]);
            bf16* col = ad + q * kTileRows * kSub + (tb + i) * kSub + j;
            col[0] = pr.x;
            col[kSub] = pr.y;
          }
        }
      }
    }
    __syncthreads();  // the tile's terms are formed; r, k, w are free
    if (it + 1 < n_tiles) load_tile(t0 + kTileRows, (it + 1) & 1);

    // --- the products: each warp runs the tile's sub-chunks in order
    const bf16* vt = vbuf + (it & 1) * kTile;
    for (int s = 0; s < kSubs; ++s) {
      const int tb = s * kSub;
      if (t0 + tb >= T_len) break;
      const int lr = tb + (lane & 7);       // this lane's ldmatrix row
      const int lh = ((lane >> 3) & 1) * 8;  // ... and half
      // v^T (m16 x j8): the A operand of both products with v
      uint32_t va[2];
      ldmatrix_x2_trans(va, smem_u32(vt + lr * P + mw + lh));
      float y0[4] = {0.f, 0.f, 0.f, 0.f};   // hi x hi
      float y1[4] = {0.f, 0.f, 0.f, 0.f};   // the first-order terms
      float y2[4] = {0.f, 0.f, 0.f, 0.f};   // the second-order terms
      // y^T += S^T (r*pre)^T, k16 over n; ldmatrix.x4 brings two k steps
      // of one term of r*pre (x2 one, at N = 16)
      constexpr int kKS = N >= 32 ? 2 : 1;
#pragma unroll
      for (int ks0 = 0; ks0 < N / 16; ks0 += kKS) {
        uint32_t qb[kParts][2 * kKS];
#pragma unroll
        for (int q = 0; q < kParts; ++q) {
          const bf16* src = qd + q * kTile + lr * P + 16 * ks0;
          if constexpr (kKS == 2)
            ldmatrix_x4(qb[q], smem_u32(src + (lane >> 3) * 8));
          else
            ldmatrix_x2(qb[q], smem_u32(src + lh));
        }
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) {
          const int ks = ks0 + kk;
          uint32_t sa[kParts][4];
          split3(st[2 * ks][0], st[2 * ks][1], sa[0][0], sa[1][0], sa[2][0]);
          split3(st[2 * ks][2], st[2 * ks][3], sa[0][1], sa[1][1], sa[2][1]);
          split3(st[2 * ks + 1][0], st[2 * ks + 1][1], sa[0][2], sa[1][2],
                 sa[2][2]);
          split3(st[2 * ks + 1][2], st[2 * ks + 1][3], sa[0][3], sa[1][3],
                 sa[2][3]);
          const uint32_t b0[2] = {qb[0][2 * kk], qb[0][2 * kk + 1]};
          const uint32_t b1[2] = {qb[1][2 * kk], qb[1][2 * kk + 1]};
          const uint32_t b2[2] = {qb[2][2 * kk], qb[2][2 * kk + 1]};
          mma_16816(y0, sa[0], b0);
          mma_16816(y1, sa[0], b1);
          mma_16816(y1, sa[1], b0);
          mma_16816(y2, sa[0], b2);
          mma_16816(y2, sa[2], b0);
          mma_16816(y2, sa[1], b1);
        }
      }
      // y^T += v^T A^T (k8 over j; A's bonus on the diagonal)
      {
        const bf16* at = ad + (tb + g) * kSub + 2 * c;
        mma_1688(y0, va, *reinterpret_cast<const uint32_t*>(at));
        mma_1688(y1, va,
                 *reinterpret_cast<const uint32_t*>(at + kTileRows * kSub));
        mma_1688(y2, va, *reinterpret_cast<const uint32_t*>(
                             at + 2 * kTileRows * kSub));
      }
      // S^T = dec * S^T + v^T (k*suf), k8 over j
      const float* ds = dec + s * N;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 d = *reinterpret_cast<const float2*>(ds + 8 * nt + 2 * c);
        st[nt][0] *= d.x;
        st[nt][1] *= d.y;
        st[nt][2] *= d.x;
        st[nt][3] *= d.y;
      }
      // ldmatrix.x4.trans brings four n-tiles of one term of k*suf (x2
      // two, at N = 16)
      constexpr int kNTs = NT >= 4 ? 4 : 2;
#pragma unroll
      for (int nt = 0; nt < NT; nt += kNTs) {
#pragma unroll
        for (int q = 0; q < kParts; ++q) {
          uint32_t kb[kNTs];
          const bf16* src = kd + q * kTile + lr * P + 8 * nt;
          if constexpr (kNTs == 4)
            ldmatrix_x4_trans(kb, smem_u32(src + (lane >> 3) * 8));
          else
            ldmatrix_x2_trans(kb, smem_u32(src + lh));
#pragma unroll
          for (int i = 0; i < kNTs; ++i) mma_1688(st[nt + i], va, kb[i]);
        }
      }
      // y: (m = g, g + 8) x (t = 2c, 2c + 1) through the warp's staging
      // rows, then 16-byte stores of the rows inside T
      {
        float yv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = y0[i] + (y1[i] + y2[i]);
        ys[(2 * c) * 16 + g] = __float2bfloat16_rn(yv[0]);
        ys[(2 * c + 1) * 16 + g] = __float2bfloat16_rn(yv[1]);
        ys[(2 * c) * 16 + g + 8] = __float2bfloat16_rn(yv[2]);
        ys[(2 * c + 1) * 16 + g + 8] = __float2bfloat16_rn(yv[3]);
        __syncwarp();
        if (lane < 16) {
          const int t = lane >> 1;
          const int half = (lane & 1) * 8;
          const int tg = t0 + tb + t;
          if (tg < T_len)
            *reinterpret_cast<uint4*>(y + base + (size_t)tg * rs + mw + half) =
                *reinterpret_cast<const uint4*>(ys + t * 16 + half);
        }
        __syncwarp();
      }
    }
  }

  float* so = s_out + (size_t)bh * N * N;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n0 = 8 * nt + 2 * c;
    so[n0 * N + mw + g] = st[nt][0];
    so[(n0 + 1) * N + mw + g] = st[nt][1];
    so[n0 * N + mw + g + 8] = st[nt][2];
    so[(n0 + 1) * N + mw + g + 8] = st[nt][3];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int N>
int launch_fp32(const void* r, const void* k, const void* v, const void* w,
                const float* u, const float* s_in, float* s_out, void* y,
                int B, int T_len, int H, int C, cudaStream_t stream) {
  static bool attr_set = false;  // the opt-in above 48 KB, once per variant
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_fp32_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats<N>(kMaxChunk) * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const size_t bytes = smem_floats<N>(C) * sizeof(float);
  wkv6_fp32_kernel<N><<<(unsigned)(B * H), kThreads, bytes, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w), u, s_in,
      s_out, static_cast<float*>(y), T_len, H, C);
  return (int)cudaGetLastError();
}

template <int N>
int launch_mma(const void* r, const void* k, const void* v, const void* w,
               const float* u, const float* s_in, float* s_out, void* y,
               int B, int T_len, int H, cudaStream_t stream) {
  using Cfg = MmaCfg<N>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_mma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg::kBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  wkv6_mma_kernel<N><<<(unsigned)(B * H), Cfg::kThreads, Cfg::kBytes,
                       stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(w), u, s_in,
      s_out, static_cast<bf16*>(y), T_len, H);
  return (int)cudaGetLastError();
}

template <int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s_in, float* s_out, void* y, int B,
           int T_len, int H, int C, int dtype, cudaStream_t st) {
  if (dtype == 0)
    return launch_fp32<N>(r, k, v, w, u, s_in, s_out, y, B, T_len, H, C, st);
  return launch_mma<N>(r, k, v, w, u, s_in, s_out, y, B, T_len, H, st);
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = fp32, 1 = bf16 (of
// r, k, v, w and y; 16-byte aligned).  u: (H, N) fp32.  s_in: (B, H, N, N)
// fp32 or null (zeros); s_out: (B, H, N, N) fp32, which may be s_in
// itself.  Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for what the kernel does not take (N outside
// {16, 32, 64}, a chunk outside [1, 64] or not dividing T, B*H blocks too
// many).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s_in,
                           void* s_out, void* y, int B, int T_len, int H,
                           int N, int C, int dtype, void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || C < 1 || C > kMaxChunk ||
      T_len % C != 0 || (long long)B * H > 0x7fffffffLL ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* uf = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(s_in);
  float* so = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16:
      return launch<16>(r, k, v, w, uf, si, so, y, B, T_len, H, C, dtype, st);
    case 32:
      return launch<32>(r, k, v, w, uf, si, so, y, B, T_len, H, C, dtype, st);
    case 64:
      return launch<64>(r, k, v, w, uf, si, so, y, B, T_len, H, C, dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
