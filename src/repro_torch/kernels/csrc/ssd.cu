// ssd.cu — the Mamba-2 SSD chunked scan (scalar decay per head), for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd, the Pallas TPU kernel
// (`_kernel`) that carries an fp32 (N, P) state in VMEM scratch across a
// sequential chunk grid axis.
//
// Computes, for dt-scaled values x (B, T, H, P), the decay a (B, T, H) in
// x's dtype, Bm and Cm (B, T, H, N) in x's dtype and an incoming state
// S0 (B, H, N, P) fp32 (or none: zeros), the recurrence
//   S_t = a_t S_{t-1} + B_t^T x_t,  y_t = C_t S_t
// in the chunked form of ref.ssd_chunked_ref: for each chunk of C rows,
// with la = log(max(a, 1e-12)), incl = cumsum(la) over the chunk and
// total = incl[C-1],
//   y = exp(incl) * (C @ S) + A @ x,
//   A[t, j] = (C_t . B_j) exp(clip(incl_t - incl_j, -60, 0)) for j <= t, else 0,
//   S' = exp(total) * S + (B * exp(clip(total - incl, -60, 0)))^T @ x.
// y has x's dtype; the state leaves in fp32.  The reference's Pallas
// kernel also clips a at 1 before the log; the plain version does not, and
// this kernel follows the plain version (the model's a = exp(-dt e^A_log)
// never exceeds 1, so the two agree on every input the model makes).
//
// Bm and Cm are read through their strides (N contiguous): Jamba's mixer
// broadcasts one (B, T, N) projection across all H heads (stride 0 on h),
// and the kernel reads it as it is, never materialized per head.
//
// Bound on this card, at the jamba-1.5-large prefill shape (B, T, H, P, N)
// = (8, 512, 128, 128, 16) in bf16 with B and C broadcast: x in and y out
// 2 x 134.2 MB, a 1.0 MB, B and C 2 x 0.13 MB, the state in and out
// 2 x 8.4 MB: 286 MB, 0.085 ms at 3.35 TB/s.  The chunked form's work,
// ~1.7 MFLOP per (b, h, chunk), 14 GFLOP in all, takes 0.014 ms at the bf16
// tensor-core peak, so the bound is bytes.  This first version runs that
// work on the fp32 CUDA cores (0.21 ms at their 67 TFLOP/s peak), so FMA
// throughput and shared-memory loads, not bytes, limit it.
//
// Design: one thread block (256 threads) per (b, h).  A loop over the T/C
// chunks inside the block takes the place of the TPU's sequential chunk
// grid axis, and the fp32 (N, P) state stays in shared memory across it
// (8 KB at N = 16, P = 128).  Per chunk the block stages x (C x P), B and
// C (C x N, rows padded to N + 1 floats) as fp32 and la; warp 0 forms incl
// by a shuffle scan; the block builds the (C, C) matrix A with its upper
// triangle zeroed; then every thread owns 4 adjacent columns p and the
// rows t = rg, rg + RG, ... of y (RG = 1024 / P row groups), and forms its
// y tile from float4 loads of S and x against broadcast loads of C and A,
// so each shared load feeds 4 to 32 FMAs.  After a barrier (every read of
// S for this chunk's y is done) each thread updates its own (n, 4 p) tiles
// of S.  At C = 64, P = 128, N = 16 the block uses 67,076 bytes of dynamic
// shared memory and ptxas gives it 119 registers a thread, so registers,
// not shared memory, hold an SM to two blocks.  No mma/wgmma, TMA or split
// of a (b, h) scan across blocks yet: that is later work.
//
// The state pointers may alias: each block reads its own (b, h) slice of
// S0 into shared memory before any of its threads writes that slice of the
// output, and no other block touches it.  So the caller may pass the same
// tensor (a layer's slice of the serving cache) as input and output.
//
// Build without --use_fast_math: the decay path needs IEEE expf and logf.
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libssd.so ssd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;

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

// clip to [-60, 0] as jnp.clip / torch.clamp do, NaN passing through
__device__ __forceinline__ float clip_decay(float x) {
  return x < -60.0f ? -60.0f : (x > 0.0f ? 0.0f : x);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float s, float4 v) {
  acc[0] = fmaf(s, v.x, acc[0]);
  acc[1] = fmaf(s, v.y, acc[1]);
  acc[2] = fmaf(s, v.z, acc[2]);
  acc[3] = fmaf(s, v.w, acc[3]);
}

// Thread layout of a (rows x P) tile: 4 adjacent columns per thread, P / 4
// threads per row, RG row groups; a thread owns rows rg, rg + RG, ...
template <int P, int N>
struct Tile {
  static constexpr int kTpr = P / 4;
  static constexpr int kRg = kThreads / kTpr;
  static constexpr int kRowsY = (kMaxChunk + kRg - 1) / kRg;  // rows of y
  static constexpr int kRowsS = (N + kRg - 1) / kRg;          // rows of S
  static constexpr int kNp = N + 1;  // padded pitch of the B and C rows
  static_assert(P % 4 == 0 && kThreads % kTpr == 0, "P must divide 1024");
};

// x [C][P], S [N][P] (float4 rows first, 16-byte aligned), B and C
// [C][N+1], A [C][C+1], incl, dec, einc [C], total [1]
constexpr size_t smem_floats(int C, int P, int N) {
  return (size_t)C * P + (size_t)N * P + 2 * (size_t)C * (N + 1) +
         (size_t)C * (C + 1) + 3 * (size_t)C + 1;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ a,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           long long sb_b, long long sb_t, long long sb_h, long long sc_b,
           long long sc_t, long long sc_h, const float* s_in, float* s_out,
           T* __restrict__ y, int T_len, int H, int C) {
  using L = Tile<P, N>;
  constexpr int NP = L::kNp;
  constexpr int RG = L::kRg;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [C][P]   x of the chunk
  float* S = xs + C * P;            // [N][P]   the carried state
  float* bs = S + N * P;            // [C][N+1] B of the chunk
  float* cs = bs + C * NP;          // [C][N+1] C of the chunk
  float* A = cs + C * NP;           // [C][C+1] intra-chunk weights, 0 above the diagonal
  float* incl = A + C * (C + 1);    // [C]      la, then its inclusive cumsum
  float* dec = incl + C;            // [C]      exp(clip(total - incl_j, -60, 0))
  float* einc = dec + C;            // [C]      exp(incl_t)
  float* tot = einc + C;            // [1]      total

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const size_t row = (size_t)H * P;  // between consecutive t in x and y
  const size_t xbase = ((size_t)b * T_len * H + h) * P;
  const size_t abase = (size_t)b * T_len * H + h;
  const T* bb = Bm + b * sb_b + h * sb_h;
  const T* cb = Cm + b * sc_b + h * sc_h;
  const int c4 = (tid % L::kTpr) * 4;  // this thread's first column
  const int rg = tid / L::kTpr;        // this thread's row group

  // the block's slice of the incoming state, read before anything is written
  if (s_in != nullptr) {
    const float* sb = s_in + (size_t)bh * N * P;
    for (int i = tid; i < N * P; i += kThreads) S[i] = sb[i];
  } else {
    for (int i = tid; i < N * P; i += kThreads) S[i] = 0.0f;
  }

  for (int c0 = 0; c0 < T_len; c0 += C) {
    __syncthreads();  // the previous chunk is consumed (and S is staged)

    // 1. stage the chunk's rows as fp32, and la = log(max(a, 1e-12))
    for (int i = tid; i < C * P; i += kThreads) {
      const int t = i / P;
      const int p = i - t * P;
      xs[i] = to_float(x[xbase + (size_t)(c0 + t) * row + p]);
    }
    for (int i = tid; i < C * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      bs[t * NP + n] = to_float(bb[(long long)(c0 + t) * sb_t + n]);
      cs[t * NP + n] = to_float(cb[(long long)(c0 + t) * sc_t + n]);
    }
    for (int t = tid; t < C; t += kThreads) {
      const float av = to_float(a[abase + (size_t)(c0 + t) * H]);
      incl[t] = logf(av < 1e-12f ? 1e-12f : av);
    }
    __syncthreads();

    // 2. incl = cumsum(la) by one warp (entries t and t + 32 per lane),
    //    total = incl[C-1], and the two decay factors
    if (tid < 32) {
      float v0 = tid < C ? incl[tid] : 0.0f;
      float v1 = tid + 32 < C ? incl[tid + 32] : 0.0f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, o);
        if (tid >= o) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      // padded entries are 0, so the last lane's sum is incl[C-1]
      const float total = __shfl_sync(0xffffffffu, v1, 31);
      if (tid < C) {
        incl[tid] = v0;
        einc[tid] = expf(v0);
        dec[tid] = expf(clip_decay(total - v0));
      }
      if (tid + 32 < C) {
        incl[tid + 32] = v1;
        einc[tid + 32] = expf(v1);
        dec[tid + 32] = expf(clip_decay(total - v1));
      }
      if (tid == 0) *tot = total;
    }
    __syncthreads();

    // 3. A[t, j] = (C_t . B_j) exp(clip(incl_t - incl_j, -60, 0)), j <= t
    for (int i = tid; i < C * C; i += kThreads) {
      const int t = i / C;
      const int j = i - t * C;
      float v = 0.0f;
      if (j <= t) {
        const float* ct = cs + t * NP;
        const float* bj = bs + j * NP;
        float d = 0.0f;
#pragma unroll
        for (int n = 0; n < N; ++n) d = fmaf(ct[n], bj[n], d);
        v = d * expf(clip_decay(incl[t] - incl[j]));
      }
      A[t * (C + 1) + j] = v;
    }
    __syncthreads();

    // 4. y[t, c4:c4+4] = exp(incl_t) (C_t @ S) + sum_j A[t, j] x[j] for the
    //    thread's rows t = rg + r * RG
    float acc[L::kRowsY][4];
#pragma unroll
    for (int r = 0; r < L::kRowsY; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float4 s4 = *reinterpret_cast<const float4*>(S + n * P + c4);
#pragma unroll
      for (int r = 0; r < L::kRowsY; ++r) {
        const int t = rg + r * RG;
        if (t < C) fma4(acc[r], cs[t * NP + n], s4);
      }
    }
#pragma unroll
    for (int r = 0; r < L::kRowsY; ++r) {
      const int t = rg + r * RG;
      const float e = t < C ? einc[t] : 0.0f;
      acc[r][0] *= e;
      acc[r][1] *= e;
      acc[r][2] *= e;
      acc[r][3] *= e;
    }
    // the thread's last row below C; A is 0 above the diagonal
    int tmax = rg + (L::kRowsY - 1) * RG;
    tmax = rg >= C ? -1 : (tmax < C - 1 ? tmax : C - 1);
    for (int j = 0; j <= tmax; ++j) {
      const float4 x4 = *reinterpret_cast<const float4*>(xs + j * P + c4);
#pragma unroll
      for (int r = 0; r < L::kRowsY; ++r) {
        const int t = rg + r * RG;
        if (t < C) fma4(acc[r], A[t * (C + 1) + j], x4);
      }
    }
#pragma unroll
    for (int r = 0; r < L::kRowsY; ++r) {
      const int t = rg + r * RG;
      if (t < C) {
        T* yp = y + xbase + (size_t)(c0 + t) * row + c4;
        yp[0] = from_float<T>(acc[r][0]);
        yp[1] = from_float<T>(acc[r][1]);
        yp[2] = from_float<T>(acc[r][2]);
        yp[3] = from_float<T>(acc[r][3]);
      }
    }
    __syncthreads();  // every read of S for this chunk's y is done

    // 5. S = exp(total) S + (B * dec)^T @ x: each thread its rows
    //    n = rg + q * RG of its 4 columns
    float sacc[L::kRowsS][4];
#pragma unroll
    for (int q = 0; q < L::kRowsS; ++q)
      sacc[q][0] = sacc[q][1] = sacc[q][2] = sacc[q][3] = 0.0f;
    if (rg < N) {
      for (int j = 0; j < C; ++j) {
        const float4 x4 = *reinterpret_cast<const float4*>(xs + j * P + c4);
        const float dj = dec[j];
#pragma unroll
        for (int q = 0; q < L::kRowsS; ++q) {
          const int n = rg + q * RG;
          if (n < N) fma4(sacc[q], bs[j * NP + n] * dj, x4);
        }
      }
      const float et = expf(*tot);
#pragma unroll
      for (int q = 0; q < L::kRowsS; ++q) {
        const int n = rg + q * RG;
        if (n < N) {
          float4* sp = reinterpret_cast<float4*>(S + n * P + c4);
          float4 s4 = *sp;
          s4.x = et * s4.x + sacc[q][0];
          s4.y = et * s4.y + sacc[q][1];
          s4.z = et * s4.z + sacc[q][2];
          s4.w = et * s4.w + sacc[q][3];
          *sp = s4;
        }
      }
    }
  }
  __syncthreads();

  float* so = s_out + (size_t)bh * N * P;
  for (int i = tid; i < N * P; i += kThreads) so[i] = S[i];
}

template <typename T, int P, int N>
int launch(const void* x, const void* a, const void* Bm, const void* Cm,
           const long long* sb, const long long* sc, const float* s_in,
           float* s_out, void* y, int B, int T_len, int H, int C,
           cudaStream_t stream) {
  static bool attr_set = false;  // the opt-in above 48 KB, once per variant
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(kMaxChunk, P, N) * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const size_t bytes = smem_floats(C, P, N) * sizeof(float);
  ssd_kernel<T, P, N><<<(unsigned)(B * H), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), sb[0], sb[1],
      sb[2], sc[0], sc[1], sc[2], s_in, s_out, static_cast<T*>(y), T_len, H,
      C);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int dispatch_n(const void* x, const void* a, const void* Bm, const void* Cm,
               const long long* sb, const long long* sc, const float* s_in,
               float* s_out, void* y, int B, int T_len, int H, int N, int C,
               cudaStream_t st) {
  switch (N) {
    case 8:
      return launch<T, P, 8>(x, a, Bm, Cm, sb, sc, s_in, s_out, y, B, T_len,
                             H, C, st);
    case 16:
      return launch<T, P, 16>(x, a, Bm, Cm, sb, sc, s_in, s_out, y, B, T_len,
                              H, C, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_p(const void* x, const void* a, const void* Bm, const void* Cm,
               const long long* sb, const long long* sc, const float* s_in,
               float* s_out, void* y, int B, int T_len, int H, int P, int N,
               int C, cudaStream_t st) {
  switch (P) {
    case 16:
      return dispatch_n<T, 16>(x, a, Bm, Cm, sb, sc, s_in, s_out, y, B, T_len,
                               H, N, C, st);
    case 32:
      return dispatch_n<T, 32>(x, a, Bm, Cm, sb, sc, s_in, s_out, y, B, T_len,
                               H, N, C, st);
    case 128:
      return dispatch_n<T, 128>(x, a, Bm, Cm, sb, sc, s_in, s_out, y, B,
                                T_len, H, N, C, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = fp32, 1 = bf16 (of x,
// a, Bm, Cm and y).  x: (B, T, H, P) and a: (B, T, H) contiguous; Bm, Cm:
// (B, T, H, N) with N contiguous and element strides (b, t, h) given in
// sb_* and sc_* (0 for a dimension broadcast).  s_in: (B, H, N, P) fp32 or
// null (zeros); s_out: (B, H, N, P) fp32, which may be s_in itself.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for what the kernel does not take (P outside
// {16, 32, 128}, N outside {8, 16}, a chunk outside [1, 64] or not dividing
// T, B*H blocks too many).
extern "C" int ssd_launch(const void* x, const void* a, const void* Bm,
                          const void* Cm, long long sb_b, long long sb_t,
                          long long sb_h, long long sc_b, long long sc_t,
                          long long sc_h, const void* s_in, void* s_out,
                          void* y, int B, int T_len, int H, int P, int N,
                          int C, int dtype, void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || C < 1 || C > kMaxChunk ||
      T_len % C != 0 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long sb[3] = {sb_b, sb_t, sb_h};
  const long long sc[3] = {sc_b, sc_t, sc_h};
  const float* si = static_cast<const float*>(s_in);
  float* so = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_p<float>(x, a, Bm, Cm, sb, sc, si, so, y, B, T_len, H, P,
                             N, C, st);
  if (dtype == 1)
    return dispatch_p<__nv_bfloat16>(x, a, Bm, Cm, sb, sc, si, so, y, B,
                                     T_len, H, P, N, C, st);
  return (int)cudaErrorInvalidValue;
}
