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
// tensor-core peak and 0.21 ms at the fp32 CUDA cores' 67 TFLOP/s: bound
// by bytes only where the products run on the tensor cores.
//
// 1. ssd_mma_kernel (bf16: the serving path).  The first design (the fp32
//    kernel below, run on bf16 inputs) took 0.86 ms at the serving shape:
//    every multiply-add read one or two operands from shared memory (about
//    1,700 warp-wide shared loads per warp and chunk against 3,200 FMA
//    instructions), x was staged by 2-byte loads widened to fp32, y left
//    by 2-byte stores, and nothing overlapped the loads.  Cut down on the
//    card (launch/ssd_breakdown.py, fp32 inputs) it spent about half its
//    time in the y products (A @ x and C @ S from shared memory), a sixth
//    in building A, and a second wave of blocks doubled it.  This design:
//    * Four products per chunk on the tensor cores (mma.sync.m16n8k16,
//      bf16 in, fp32 accumulate), in the transposed form, each warp
//      owning 16 columns p of x, y and the state:
//        G = C B^T (the 16-row tiles on and below the diagonal; exact
//        bf16 operands), A = G * exp(clip(incl_t - incl_j, -60, 0)) masked
//        to j <= t (one IEEE expf per entry), stored to shared memory;
//        y^T = diag(exp(incl)) applied to S^T C^T, plus x^T A^T (the
//        lower-triangular 16-column blocks of A only);
//        S^T = exp(total) S^T + x^T (B * dec).
//    * S^T lives in the warp's mma accumulator registers (16 x N: two
//      m16n8 tiles, exactly the A fragment of an m16k16 operand), so it
//      feeds S^T C^T from registers.  No state crosses warps, so the
//      state pointers may alias (each warp reads its own columns of the
//      (b, h) slice of S0 before it writes them; no other warp or block
//      touches them).
//    * Precision: the fp32 operands (S, A, B * dec) enter as three bf16
//      terms each (hi, mid, lo: 24 bits, as fp32); x and C are exact in
//      bf16.  Two terms miss the bf16 gate where |x|, |B|, |C| ~ 100
//      products cancel, one term misses it by many entries
//      (kernels/ssd.py:mma_model models all of this on the CPU).  Each
//      k16 step's products are summed small terms first into a fresh
//      accumulator and added to the running sum on the CUDA cores, and the
//      cumsum of the fp32 logs of a is carried in double: where terms of
//      ~1e6 cancel to ~1e2, a chained accumulator or an fp32 scan moved y
//      by more than the bf16 tolerance from the exact recurrence.
//    * cp.async stages x, B and C as bf16, double-buffered: chunk c + 1
//      loads while chunk c computes; x^T and the product operands come
//      from ldmatrix (.trans for x^T).  Rows past the chunk are staged as
//      x = B = C = 0 and a = 1, so they add nothing.  Warp 0 prefetches
//      the next chunk's a into registers and forms its cumsum, exp(incl),
//      dec and exp(total) by shuffles at the end of the chunk.  Two block
//      barriers a chunk.  y is staged in the warp's own columns of the x
//      tile it has consumed and leaves in 16-byte stores.
//    * One block of 8 warps per (b, h) at P = 128 (P / 16 warps below).
//      A is stored as its 16-row blocks up to the diagonal only (18 KB for
//      three terms), which brings the block to 74.5 KB of shared memory;
//      with 80 registers a thread, three blocks share an SM (1024 blocks:
//      2.59 waves).
//    What bounds it (measured at the serving shape on an H100 80GB HBM3 at
//    700 W, launch/ssd_breakdown.py and chip_smoke.py, PERF.md): ~0.21 ms,
//    2.4x the byte bound.  At two blocks an SM (up to 128 registers) the
//    copies, the scan of a, the barriers and the y stores alone took 0.12
//    ms (1.45x the byte bound: each block keeps one chunk in flight), the
//    prep (C B^T, A, B * dec as bf16 terms) ~0.04 more and the products
//    (~111 mma.sync per warp and chunk, 7.3 M in all) ~0.06 more, adding
//    up nearly in series, 0.23 ms; a third block an SM overlaps them
//    better (-10 %).  Tried and not kept: 64 columns a block (2048
//    blocks; A built twice) 0.32 ms; three chunks staged at once (two
//    blocks an SM), no faster.  The next levers: wgmma with a producer
//    warp (the loads and the prep overlapping the products), or the prep
//    of chunk c + 1 during the products of chunk c.
// 2. ssd_fp32_kernel (fp32: the parity path, the first design).  One block
//    (256 threads) per (b, h), the (N, P) state in shared memory across a
//    loop over the chunks; per chunk x, B, C staged as fp32, incl by a
//    warp shuffle scan, A built with its upper triangle zeroed, then each
//    thread forms 4 adjacent columns of its rows of y from float4 loads,
//    and updates its tiles of the state after a barrier.  It keeps fp32's
//    tolerance and is off the serving path.
//
// Build without --use_fast_math: the decay path needs IEEE expf and logf.
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libssd.so ssd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxChunk = 64;

// clip to [-60, 0] as jnp.clip / torch.clamp do, NaN passing through
__device__ __forceinline__ float clip_decay(float x) {
  return x < -60.0f ? -60.0f : (x > 0.0f ? 0.0f : x);
}

// ---------------------------------------------------------------------------
// 2. the fp32 kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

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

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_fp32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                long long sb_b, long long sb_t, long long sb_h,
                long long sc_b, long long sc_t, long long sc_h,
                const float* s_in, float* s_out, float* __restrict__ y,
                int T_len, int H, int C) {
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
  const float* bb = Bm + b * sb_b + h * sb_h;
  const float* cb = Cm + b * sc_b + h * sc_h;
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

    // 1. stage the chunk's rows, and la = log(max(a, 1e-12))
    for (int i = tid; i < C * P; i += kThreads) {
      const int t = i / P;
      const int p = i - t * P;
      xs[i] = x[xbase + (size_t)(c0 + t) * row + p];
    }
    for (int i = tid; i < C * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      bs[t * NP + n] = bb[(long long)(c0 + t) * sb_t + n];
      cs[t * NP + n] = cb[(long long)(c0 + t) * sc_t + n];
    }
    for (int t = tid; t < C; t += kThreads) {
      const float av = a[abase + (size_t)(c0 + t) * H];
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
      if (t < C)
        *reinterpret_cast<float4*>(y + xbase + (size_t)(c0 + t) * row + c4) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
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

// ---------------------------------------------------------------------------
// 1. the bf16 kernel
// ---------------------------------------------------------------------------

constexpr int kTile = 64;         // rows a chunk is staged in (zero-padded)
constexpr int kStages = 2;        // chunks of x, B and C staged at once
constexpr int kParts = 3;         // bf16 terms per fp32 operand
constexpr int kKN = 16;           // the state dimension, padded to one k16
constexpr int kMaxBlockCols = 128;  // columns of P per block
constexpr int kAP = kTile + 8;    // bf16 per row of the (B*dec)^T tiles
// A holds only its 16-row blocks' columns up to their diagonal: row block
// i (rows 16i .. 16i + 15) has 16(i + 1) columns, stored at a pitch of
// 16(i + 1) + 8 bf16 (ldmatrix reads 8 rows conflict-free), and starts
// 128 i (i + 2) bf16 into a term; a term is 3072 bf16
constexpr int kATerm = 128 * 4 * 6;
__host__ __device__ constexpr int a_pitch(int i) { return 16 * (i + 1) + 8; }
__host__ __device__ constexpr int a_off(int t, int j) {
  return 128 * (t / 16) * (t / 16 + 2) + (t % 16) * a_pitch(t / 16) + j;
}
constexpr int kBCP = kKN + 8;     // bf16 per staged row of B and C
// per chunk: incl as double [64], exp(incl), dec [64] and exp(total) as float
constexpr int kScanBytes = kTile * 8 + (2 * kTile + 4) * 4;
// G = C B^T by 16 x 8 tiles on and below the 16-row diagonal blocks:
// row block i holds column tiles 0 .. 2i + 1, i(i + 1) tiles before it
constexpr int kGTiles = 20;

template <int P>
struct MmaCfg {
  static constexpr int kPB = P < kMaxBlockCols ? P : kMaxBlockCols;
  static constexpr int kWarps = kPB / 16;   // one per 16 columns of P
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kXP = kPB + 8;       // bf16 per staged row of x
  // shared memory, in bytes from the start
  static constexpr int kX = 0;                                 // x, 2 tiles
  static constexpr int kBC = kX + kStages * kTile * kXP * 2;   // B, C
  static constexpr int kA = kBC + kStages * 2 * kTile * kBCP * 2;  // A, 3 terms
  static constexpr int kBd = kA + kParts * kATerm * 2;         // B*dec, 3 terms
  static constexpr int kScan = kBd + kParts * kKN * kAP * 2;   // scan, 2 x
  static constexpr int kBytes = kScan + 2 * kScanBytes;
  static_assert(P % kPB == 0 && kPB % 16 == 0, "P must tile by 16 columns");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy, in flight until cp_async_wait
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's cp.async groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
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

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(const __nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) as three packed bf16 pairs: t[0] = the pair rounded to bf16,
// t[1] the remainder rounded, t[2] what is left, rounded (x0 in the low
// half of each word, as mma's fragments take it).  t[0] + t[1] + t[2]
// holds 24 bits of each; every subtraction is exact.
__device__ __forceinline__ void split3(float x0, float x1,
                                       uint32_t (&t)[kParts]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  t[0] = as_u32(h);
  t[1] = as_u32(m);
  t[2] = as_u32(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

template <int P>
__global__ void __launch_bounds__(MmaCfg<P>::kThreads, 3)
ssd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
               const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
               long long sb_b, long long sb_t, long long sb_h, long long sc_b,
               long long sc_t, long long sc_h, const float* s_in,
               float* s_out, bf16* __restrict__ y, int T_len, int H, int N,
               int C) {
  using Cfg = MmaCfg<P>;
  constexpr int PB = Cfg::kPB;
  constexpr int XP = Cfg::kXP;
  constexpr int kBlocksPerHead = P / PB;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* xbuf = reinterpret_cast<bf16*>(smem_b + Cfg::kX);    // [stage][64][XP]
  // [stage][B, C][64][24]
  bf16* bcbuf = reinterpret_cast<bf16*>(smem_b + Cfg::kBC);
  bf16* at = reinterpret_cast<bf16*>(smem_b + Cfg::kA);      // [3][kATerm]
  bf16* bdt = reinterpret_cast<bf16*>(smem_b + Cfg::kBd);    // [3][n 16][j 72]
  unsigned char* scan = smem_b + Cfg::kScan;  // two chunks' kScanBytes

  const int bh = blockIdx.x / kBlocksPerHead;
  // the block's columns of P start at p0
  const int p0 = (blockIdx.x - bh * kBlocksPerHead) * PB;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                  // mma fragment row group
  const int c = lane & 3;                   // ... and column pair
  const int pw = warp * 16;                 // the warp's columns, in the block
  const size_t row = (size_t)H * P;         // between consecutive t in x, y
  const size_t xbase = ((size_t)b * T_len * H + h) * P + p0;
  const size_t abase = (size_t)b * T_len * H + h;
  const bf16* bb = Bm + b * sb_b + h * sb_h;
  const bf16* cb = Cm + b * sc_b + h * sc_h;
  const int n_chunks = T_len / C;

  // B and C rows are N bf16 wide, padded with zeros to 16: clear both
  // buffers once (the copies below write the first N of each row)
  for (int i = tid; i < kStages * 2 * kTile * kBCP / 8; i += Cfg::kThreads)
    reinterpret_cast<uint4*>(bcbuf)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // S^T[p][n] as accumulator fragments: st[nt] holds (p = pw + g, pw + g +
  // 8) x (n = 8 nt + 2c, 8 nt + 2c + 1); read before anything is written
  float st[2][4];
  {
    const float* sb =
        s_in != nullptr ? s_in + (size_t)bh * N * P + p0 + pw : nullptr;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n0 = 8 * nt + 2 * c;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + (i & 1);
        const int p = g + (i >> 1) * 8;
        st[nt][i] = (sb != nullptr && n < N) ? sb[(size_t)n * P + p] : 0.0f;
      }
    }
  }

  // stage chunk k's rows of x (the block's columns), B and C into stage
  // k % kStages by 16-byte copies; rows past the chunk are zero-filled.
  // One cp.async group per call, empty past the last chunk.
  auto load_chunk = [&](int k) {
    if (k >= n_chunks) {
      cp_async_commit();
      return;
    }
    const int t0 = k * C;
    bf16* xd = xbuf + (k % kStages) * kTile * XP;
    constexpr int kXC = PB / 8;             // 16-byte pieces per row of x
    for (int i = tid; i < kTile * kXC; i += Cfg::kThreads) {
      const int t = i / kXC;
      const int q = i - t * kXC;
      bf16* dst = xd + t * XP + q * 8;
      if (t < C)
        cp_async16(smem_u32(dst), x + xbase + (size_t)(t0 + t) * row + q * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    const int nq = N / 8;                   // 16-byte pieces per row of B, C
    bf16* bd = bcbuf + (k % kStages) * 2 * kTile * kBCP;
    for (int i = tid; i < 2 * kTile * 2; i += Cfg::kThreads) {
      const int arr = i / (2 * kTile);      // 0: B, 1: C
      const int rem = i - arr * 2 * kTile;
      const int t = rem >> 1;
      const int q = rem & 1;
      if (q >= nq) continue;
      bf16* dst = bd + (arr * kTile + t) * kBCP + q * 8;
      if (t < C) {
        const bf16* src = arr == 0 ? bb + (long long)(t0 + t) * sb_t
                                   : cb + (long long)(t0 + t) * sc_t;
        cp_async16(smem_u32(dst), src + q * 8);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  // warp 0: chunk k's a (rows lane and lane + 32; past the chunk a = 1)
  auto load_a = [&](int k, float& a0, float& a1) {
    const size_t o = abase + (size_t)k * C * H;
    a0 = lane < C ? __bfloat162float(a[o + (size_t)lane * H]) : 1.0f;
    a1 = lane + 32 < C ? __bfloat162float(a[o + (size_t)(lane + 32) * H])
                       : 1.0f;
  };
  // warp 0: incl = cumsum(log(max(a, 1e-12))), exp(incl), dec and
  // exp(total) of chunk k into scan buffer k & 1.  The logs are fp32, as
  // the plain version's; their sums are carried in double, so incl, and
  // every decay formed from it, is the exact sum of those logs rounded
  // once (the plain version's fp32 cumsum rounds at every row, and at x
  // ~ 100 an entry of y that cancels to 1e-5 of its terms moves by more
  // than the bf16 tolerance with one ulp of a log)
  auto scan_a = [&](int k, float a0, float a1) {
    double v0 = logf(a0 < 1e-12f ? 1e-12f : a0);
    double v1 = logf(a1 < 1e-12f ? 1e-12f : a1);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u0 = __shfl_up_sync(0xffffffffu, v0, o);
      const double u1 = __shfl_up_sync(0xffffffffu, v1, o);
      if (lane >= o) {
        v0 += u0;
        v1 += u1;
      }
    }
    v1 += __shfl_sync(0xffffffffu, v0, 31);
    // rows past the chunk add log 1 = 0, so the last row's sum is total
    const double total = __shfl_sync(0xffffffffu, v1, 31);
    unsigned char* sb = scan + (k & 1) * kScanBytes;
    double* incl = reinterpret_cast<double*>(sb);
    float* einc = reinterpret_cast<float*>(sb + kTile * 8);
    float* dec = einc + kTile;
    incl[lane] = v0;
    incl[lane + 32] = v1;
    einc[lane] = (float)exp(v0);
    einc[lane + 32] = (float)exp(v1);
    dec[lane] = expf(clip_decay((float)(total - v0)));
    dec[lane + 32] = expf(clip_decay((float)(total - v1)));
    if (lane == 0) dec[kTile] = (float)exp(total);
  };

#pragma unroll
  for (int k = 0; k + 1 < kStages; ++k) load_chunk(k);
  float an0 = 1.0f, an1 = 1.0f;             // warp 0: the next chunk's a
  if (warp == 0) {
    load_a(0, an0, an1);
    scan_a(0, an0, an1);
  }

  for (int k = 0; k < n_chunks; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk k has landed; chunk k - 1 is consumed
    load_chunk(k + kStages - 1);
    if (warp == 0 && k + 1 < n_chunks) load_a(k + 1, an0, an1);
    const bf16* xs = xbuf + (k % kStages) * kTile * XP;
    const bf16* bs = bcbuf + (k % kStages) * 2 * kTile * kBCP;
    const bf16* cs = bs + kTile * kBCP;
    const unsigned char* sb = scan + (k & 1) * kScanBytes;
    const double* incl = reinterpret_cast<const double*>(sb);
    const float* einc = reinterpret_cast<const float*>(sb + kTile * 8);
    const float* dec = einc + kTile;

    // --- A = (C B^T) * exp(clip(incl_t - incl_j, -60, 0)) masked to j <= t,
    // 16 x 8 tiles shared out over the warps, as three bf16 terms into at
    for (int idx = warp; idx < kGTiles; idx += Cfg::kWarps) {
      const int i = idx < 2 ? 0 : idx < 6 ? 1 : idx < 12 ? 2 : 3;
      const int jt = idx - i * (i + 1);
      const int t0 = 16 * i, j0 = 8 * jt;
      if (t0 >= C) continue;
      uint32_t ca[4], bb2[2];
      ldmatrix_x4(ca, smem_u32(cs + (t0 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                        * kBCP + ((lane >> 4) & 1) * 8));
      ldmatrix_x2(bb2, smem_u32(bs + (j0 + (lane & 7)) * kBCP +
                                ((lane >> 3) & 1) * 8));
      float gv[4] = {0.f, 0.f, 0.f, 0.f};
      mma_16816(gv, ca, bb2[0], bb2[1]);
      const int j = j0 + 2 * c;
      const double2 ij = *reinterpret_cast<const double2*>(incl + j);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + g + 8 * half;
        const double it = incl[t];
        const float v0 =
            j <= t ? gv[2 * half] * expf(clip_decay((float)(it - ij.x)))
                   : 0.0f;
        const float v1 =
            j + 1 <= t ? gv[2 * half + 1] * expf(clip_decay((float)(it - ij.y)))
                       : 0.0f;
        uint32_t tv[kParts];
        split3(v0, v1, tv);
#pragma unroll
        for (int q = 0; q < kParts; ++q)
          *reinterpret_cast<uint32_t*>(at + q * kATerm + a_off(t, j)) = tv[q];
      }
    }
    // --- (B * dec)^T [n][j] as three bf16 terms (rows n >= N are 0)
    for (int e = tid; e < kKN * kTile / 2; e += Cfg::kThreads) {
      const int n = e & (kKN - 1);
      const int j = 2 * (e >> 4);
      const float2 d = *reinterpret_cast<const float2*>(dec + j);
      uint32_t tv[kParts];
      split3(__bfloat162float(bs[j * kBCP + n]) * d.x,
             __bfloat162float(bs[(j + 1) * kBCP + n]) * d.y, tv);
#pragma unroll
      for (int q = 0; q < kParts; ++q)
        *reinterpret_cast<uint32_t*>(bdt + (q * kKN + n) * kAP + j) = tv[q];
    }
    __syncthreads();  // A and B * dec are formed

    // --- the warp's products: x^T (16 p x 64 j) as four k16 A fragments
    uint32_t xa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldmatrix_x4_trans(
          xa[ks], smem_u32(xs + (16 * ks + (lane & 7) + ((lane >> 4) & 1) * 8)
                                    * XP + pw + ((lane >> 3) & 1) * 8));
    // S^T as the A fragment of S^T C^T, three bf16 terms
    uint32_t sa[kParts][4];
    {
      uint32_t tv[kParts];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        split3(st[f >> 1][2 * (f & 1)], st[f >> 1][2 * (f & 1) + 1], tv);
#pragma unroll
        for (int q = 0; q < kParts; ++q) sa[q][f] = tv[q];
      }
    }
    // the lane's ldmatrix row and column offsets for B operands
    const int lrow = (lane & 7) + ((lane >> 4) & 1) * 8;
    const int lcol = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int th = 0; th < 2; ++th) {        // rows t of y in halves of 32
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      // y^T = S^T C^T (C^T's fragments: rows t of C, k = n)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int nt = 4 * th + i;
        if (8 * nt >= C) break;
        uint32_t cf[4];
        ldmatrix_x4(cf, smem_u32(cs + (8 * nt + lrow) * kBCP + lcol));
#pragma unroll
        for (int q = kParts - 1; q >= 0; --q) {   // the small terms first
          mma_16816(acc[i], sa[q], cf[0], cf[1]);
          mma_16816(acc[i + 1], sa[q], cf[2], cf[3]);
        }
      }
      // times exp(incl_t), then y^T += x^T A^T over the blocks j <= t
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nt = 4 * th + i;
        if (8 * nt >= C) break;
        const float2 e =
            *reinterpret_cast<const float2*>(einc + 8 * nt + 2 * c);
        acc[i][0] *= e.x;
        acc[i][1] *= e.y;
        acc[i][2] *= e.x;
        acc[i][3] *= e.y;
#pragma unroll
        for (int ks = 0; ks <= nt / 2; ++ks) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = kParts - 1; q >= 0; --q) {
            uint32_t af[2];
            ldmatrix_x2(af, smem_u32(at + q * kATerm +
                                     a_off(8 * nt + (lane & 7), 16 * ks + lcol)));
            mma_16816(d, xa[ks], af[0], af[1]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][r] += d[r];
        }
      }
      // y: (p = g, g + 8) x (t = 2c, 2c + 1) into the warp's own columns of
      // the consumed x tile, then 16-byte stores of the rows of the chunk
      bf16* ys = const_cast<bf16*>(xs);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 8 * (4 * th + i) + 2 * c;
        ys[t * XP + pw + g] = __float2bfloat16_rn(acc[i][0]);
        ys[(t + 1) * XP + pw + g] = __float2bfloat16_rn(acc[i][1]);
        ys[t * XP + pw + g + 8] = __float2bfloat16_rn(acc[i][2]);
        ys[(t + 1) * XP + pw + g + 8] = __float2bfloat16_rn(acc[i][3]);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = lane + 32 * r;
        const int t = 32 * th + (e >> 1);
        const int half = (e & 1) * 8;
        if (t < C)
          *reinterpret_cast<uint4*>(y + xbase + (size_t)(k * C + t) * row +
                                    pw + half) =
              *reinterpret_cast<const uint4*>(ys + t * XP + pw + half);
      }
    }
    // S^T = exp(total) S^T + x^T (B * dec) ((B * dec)'s fragments: rows n)
    const float et = dec[kTile];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[nt][i] *= et;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (16 * ks >= C) break;
      float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int q = kParts - 1; q >= 0; --q) {
        uint32_t bf[4];
        ldmatrix_x4(bf,
                    smem_u32(bdt + (q * kKN + lrow) * kAP + 16 * ks + lcol));
        mma_16816(d[0], xa[ks], bf[0], bf[1]);
        mma_16816(d[1], xa[ks], bf[2], bf[3]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        st[0][r] += d[0][r];
        st[1][r] += d[1][r];
      }
    }
    if (warp == 0 && k + 1 < n_chunks) scan_a(k + 1, an0, an1);
  }

  float* so = s_out + (size_t)bh * N * P + p0 + pw;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int n0 = 8 * nt + 2 * c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + (i & 1);
      if (n < N) so[(size_t)n * P + g + (i >> 1) * 8] = st[nt][i];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int P, int N>
int launch_fp32(const void* x, const void* a, const void* Bm, const void* Cm,
                const long long* sb, const long long* sc, const float* s_in,
                float* s_out, void* y, int B, int T_len, int H, int C,
                cudaStream_t stream) {
  static bool attr_set = false;  // the opt-in above 48 KB, once per variant
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_fp32_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(kMaxChunk, P, N) * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const size_t bytes = smem_floats(C, P, N) * sizeof(float);
  ssd_fp32_kernel<P, N><<<(unsigned)(B * H), kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), sb[0],
      sb[1], sb[2], sc[0], sc[1], sc[2], s_in, s_out, static_cast<float*>(y),
      T_len, H, C);
  return (int)cudaGetLastError();
}

template <int P>
int launch_mma(const void* x, const void* a, const void* Bm, const void* Cm,
               const long long* sb, const long long* sc, const float* s_in,
               float* s_out, void* y, int B, int T_len, int H, int N, int C,
               cudaStream_t stream) {
  using Cfg = MmaCfg<P>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_mma_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg::kBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const long long blocks = (long long)B * H * (P / Cfg::kPB);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_mma_kernel<P><<<(unsigned)blocks, Cfg::kThreads, Cfg::kBytes,
                      stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(a),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), sb[0],
      sb[1], sb[2], sc[0], sc[1], sc[2], s_in, s_out, static_cast<bf16*>(y),
      T_len, H, N, C);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch(const void* x, const void* a, const void* Bm, const void* Cm,
             const long long* sb, const long long* sc, const float* s_in,
             float* s_out, void* y, int B, int T_len, int H, int N, int C,
             int dtype, cudaStream_t st) {
  if (dtype == 1)
    return launch_mma<P>(x, a, Bm, Cm, sb, sc, s_in, s_out, y, B, T_len, H,
                         N, C, st);
  switch (N) {
    case 8:
      return launch_fp32<P, 8>(x, a, Bm, Cm, sb, sc, s_in, s_out, y, B,
                               T_len, H, C, st);
    case 16:
      return launch_fp32<P, 16>(x, a, Bm, Cm, sb, sc, s_in, s_out, y, B,
                                T_len, H, C, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = fp32, 1 = bf16 (of x,
// a, Bm, Cm and y).  x: (B, T, H, P) and a: (B, T, H) contiguous; Bm, Cm:
// (B, T, H, N) with N contiguous and element strides (b, t, h) given in
// sb_* and sc_* (0 for a dimension broadcast).  bf16 x, Bm and Cm are
// copied in 16-byte pieces: their pointers 16-byte aligned and the strides
// of Bm and Cm multiples of 8.  s_in: (B, H, N, P) fp32 or null (zeros);
// s_out: (B, H, N, P) fp32, which may be s_in itself.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for what the kernel does not take (P outside
// {16, 32, 128}, N outside {8, 16}, a chunk outside [1, 64] or not dividing
// T, too many blocks).
extern "C" int ssd_launch(const void* x, const void* a, const void* Bm,
                          const void* Cm, long long sb_b, long long sb_t,
                          long long sb_h, long long sc_b, long long sc_t,
                          long long sc_h, const void* s_in, void* s_out,
                          void* y, int B, int T_len, int H, int P, int N,
                          int C, int dtype, void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || C < 1 || C > kMaxChunk ||
      T_len % C != 0 || (long long)B * H > 0x7fffffffLL ||
      (N != 8 && N != 16) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long sb[3] = {sb_b, sb_t, sb_h};
  const long long sc[3] = {sc_b, sc_t, sc_h};
  const float* si = static_cast<const float*>(s_in);
  float* so = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16:
      return dispatch<16>(x, a, Bm, Cm, sb, sc, si, so, y, B, T_len, H, N, C,
                          dtype, st);
    case 32:
      return dispatch<32>(x, a, Bm, Cm, sb, sc, si, so, y, B, T_len, H, N, C,
                          dtype, st);
    case 128:
      return dispatch<128>(x, a, Bm, Cm, sb, sc, si, so, y, B, T_len, H, N,
                           C, dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
