// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces eight Pallas TPU kernels of pytorch_distributed_training_tpu/ops/
// pallas_attention.py, which are four TPU tilings of one forward and four
// of one backward (the dispatch at flash_attention, lines 1136-1179, picks
// a tiling only by VMEM budget and length):
//   forward   #1 _flash_fwd_single, #2 _flash_fwd_single_nlhd,
//             #4 _flash_fwd_grouped, #6 _flash_fwd        -> flash_fwd_kernel
//   backward  #3 _flash_bwd_nlhd, #5 _flash_bwd_grouped,
//             #7 _flash_bwd_single, #8 _flash_bwd (its dq / dk-dv split)
//                                      -> flash_bwd_dq_kernel, flash_bwd_dkv_kernel
// A block has no VMEM budget to tile around, so one forward and one split
// backward compute the function of all eight, at any length.
//
// Math, copied from the TPU kernels so results agree to summation order:
//   s = (q . k in f32) * scale; key j is live for query i iff j < k_len and
//   (not causal or j <= i + k_len - q_len); masked scores never enter.
//   Forward (the one-tile math of #1/#2/#4, _fwd_tile): m = row max,
//   l = sum exp(s - m), l_safe = l or 1 for a row with no live key;
//   p = exp(s - m) / l_safe rounded to v's dtype; out = p . v accumulated
//   in f32, rounded once; lse = m + log(l_safe) in f32.
//   Backward (_bwd_block): p = exp(s - lse), masked entries an explicit 0;
//   dp = dO . v^T; ds = p * (dp - delta) * scale with delta = rowsum(dO * O)
//   computed by the caller; dq = ds . k, dk = ds^T . q, dv = p^T . dO with
//   ds and p rounded to the input dtype, f32 accumulation across all tiles,
//   rounded once at the end.
//
// Bound on this card.  At GPT-2 124M's training shape (B 8, L 1024, H 12,
// Dh 64, bf16, causal; 50.4 M live (query, key) pairs) the forward's two
// products are 12.9 GFLOP (13.0 us at 989 TF/s) against 50.7 MB of q, k, v,
// out and LSE (15.1 us at 3.35 TB/s): bytes by a hair.  The backward's five
// products (32.2 GFLOP, 32.6 us) outweigh its 88.9 MB (26.5 us): operations.
// What the kernels below actually do is more: the two-pass forward runs 3
// products (19.4 GFLOP) and two exponentials a score (~107 M on 64 x 64
// tiles, ~26 us of the SMs' special-function units); the split backward
// runs 7 products (45 GFLOP) and one exponential a score in each pass.  So
// every bf16 kernel is bound by its products and exponentials, none by
// device memory: each input tile is read from memory once per block and
// reused from shared memory by every warp.
//
// Design of the bf16 kernels (flash_fwd_kernel, flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel):
//   - Products on the tensor cores in registers: mma.sync m16n8k16, bf16 in,
//     f32 accumulate.  Each warp owns 16 rows (queries in the forward and
//     the dq pass, keys in the dk/dv pass) and keeps their operand
//     fragments (q; q and dO; k and v) in registers across its whole loop.
//     The score tile, p, dp, ds and the accumulators (out, dq, dk, dv) live
//     in register fragments; no f32 tile goes through shared memory.  The
//     f32 C fragments of two adjacent n8 tiles are rounded in place into
//     the bf16 A fragment of the next product's k16 step.
//   - Operands come from shared memory through ldmatrix: without .trans for
//     the B of q.k^T, dO.v^T, k.q^T and v.dO^T (a row-major tile is a
//     column-major B), with .trans for v in p.v, k in ds.k, and q and dO in
//     the dk/dv products.  Rows are padded by 16 bytes (144-byte stride),
//     so the eight row addresses of an 8 x 8 matrix hit distinct banks.
//   - Tiles arrive by 16-byte cp.async.cg into a ring of kStages = 2 stages:
//     the next key (or query) tile is in flight while the tensor cores work
//     on this one.  Rows past a length arrive as zeros through the copy's
//     source size, with no branch.  The strided (B, L, H, D) views are read
//     as they are (no copy around the kernel).
//   - The mask is applied only on tiles that need it (the causal diagonal,
//     a ragged last tile); masked scores become -inf, so exp gives an exact
//     0 (a row with no live key keeps m = -1e30, lse = -1e30).  Key tiles
//     past a query tile's causal limit, and query tiles before a key
//     tile's, are skipped (_live_block).  The forward and dq grids launch
//     the heaviest causal query tiles first, the dk/dv grid the heaviest
//     key tiles (the first), so the grid ends on short blocks.
//   - The forward keeps two passes over the key tiles: the first finds the
//     row max and denominator (q.k^T only), the second forms
//     exp(s - m) * (1 / l_safe), rounds it to bf16 and feeds p.v.  One
//     extra product buys the one-tile TPU kernels' rounding of the
//     normalised p and an output accumulator that is never rescaled.
//   - The backward stays split: the dq pass walks key tiles, the dk/dv pass
//     walks query tiles, and each recomputes s and dp (7 products where a
//     fused pass would do 5).  No atomics: every run gives the same bits.
//   Row max and row sum reduce over the 4 threads of a quad; exponentials
//   are exp2f of one fma with the scale folded into log2(e).
//
// The f32 kernels (flash_*_f32_kernel) are the parity path, not a speed
// path, and keep the simple first design: one block of 4 warps per 64-row
// tile, tiles staged with plain 16-byte loads, scalar FMA products with
// scores and accumulators in f32 shared memory.
//
// Only head_dim 64 is instantiated: every model the repo defines at its
// published widths has it.
//
// Interface: plain C, loaded with ctypes (ops/flash_attention.py).  Strides
// are in elements, three per tensor (batch, position, head); the last
// dimension is contiguous and rows start on 16-byte boundaries (the Python
// wrapper checks both).  LSE and delta are (B, H, q_len) f32, contiguous.
// Launches go on the caller's stream; each function returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kD = 64;                  // head dim
constexpr int kTile = 64;               // queries or keys per tile
constexpr int kWarps = 4;               // warps of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kTile / kWarps;   // rows of a tile per warp
constexpr int kLdF = kTile + 4;         // f32 row stride in shared memory
constexpr float kNegInf = -1e30f;       // _NEG_INF of the TPU kernels
constexpr unsigned kFull = 0xffffffffu;

static_assert(kD == kTile, "the warp products assume square 64 tiles");

struct View {
  long long b, l, h;  // element strides of a (B, L, H, D) view
};

struct Dims {
  int heads, q_len, k_len, causal, offset;  // offset = k_len - q_len
  float scale;
};

__device__ __forceinline__ bool live(const Dims& d, int i, int j) {
  return i < d.q_len && j < d.k_len && (!d.causal || j <= i + d.offset);
}

// Number of key tiles a block of `rows` queries starting at q0 needs
// (_live_block).
__device__ __forceinline__ int key_tiles(const Dims& d, int q0, int rows) {
  int n = (d.k_len + kTile - 1) / kTile;
  if (d.causal) {
    const long long last = static_cast<long long>(q0) + rows - 1 + d.offset;
    if (last < 0) return 0;
    n = min(n, static_cast<int>(last / kTile) + 1);
  }
  return n;
}

// First query tile that sees any key of the block starting at k0.
__device__ __forceinline__ int first_query_tile(const Dims& d, int k0) {
  if (!d.causal) return 0;
  const long long need = static_cast<long long>(k0) - (kTile - 1) - d.offset;
  return need <= 0 ? 0 : static_cast<int>((need + kTile - 1) / kTile);
}

// ------------------------------------------------------------- f32 path --

constexpr int kLd32 = kD + 4;           // f32 operand row stride (16 bytes)
constexpr size_t kF32Tile = sizeof(float) * kTile * kLdF;
constexpr size_t kF32Op = sizeof(float) * kTile * kLd32;

// Rows row0..row0+63 of (b, h) into shared memory; rows >= len are zeros.
__device__ void load_tile_f32(float* dst, const float* src, View v, int b,
                              int h, int row0, int len) {
  constexpr int kChunks = kD / 4;
  const float* base = src + b * v.b + h * v.h;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 4;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < len) {
      val = *reinterpret_cast<const uint4*>(
          base + static_cast<long long>(row0 + r) * v.l + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd32 + c) = val;
  }
}

// An f32 tile accumulator out to rows row0.. of (b, h).
__device__ void store_tile_f32(float* dst, View v, int b, int h, int row0,
                               int len, const float* src) {
  float* base = dst + b * v.b + h * v.h;
  for (int e = threadIdx.x; e < kTile * kD; e += kThreads) {
    const int r = e / kD;
    const int c = e % kD;
    if (row0 + r < len) {
      base[static_cast<long long>(row0 + r) * v.l + c] = src[r * kLdF + c];
    }
  }
}

// One warp: C[16 x 64] (stride kLdF) = (C +) A[16 x 64] . B[64 x 64] on the
// CUDA cores, lane t owning columns t and t + 32.  A is row-major with
// stride kLd32; B(k, n) is Bs[k * kLd32 + n], or with kBT Bs[n * kLd32 + k]
// (B given transposed, as a row-major K or Q tile).
template <bool kBT>
__device__ void warp_gemm_f32(const float* A, const float* B, float* C,
                              bool accumulate) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  float acc[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[r][j] = accumulate ? C[r * kLdF + lane + 32 * j] : 0.f;
    }
  }
  for (int k = 0; k < kD; ++k) {
    const float b0 = kBT ? B[lane * kLd32 + k] : B[k * kLd32 + lane];
    const float b1 =
        kBT ? B[(lane + 32) * kLd32 + k] : B[k * kLd32 + lane + 32];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float a = A[r * kLd32 + k];
      acc[r][0] = fmaf(a, b0, acc[r][0]);
      acc[r][1] = fmaf(a, b1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < 2; ++j) C[r * kLdF + lane + 32 * j] = acc[r][j];
  }
  __syncwarp();
}

__device__ __forceinline__ void zero_strip(float* strip) {
  for (int e = threadIdx.x & 31; e < kRows * kLdF; e += 32) strip[e] = 0.f;
}

// In every warp phase below, lane pair (2r, 2r + 1) owns row r of the
// warp's 16-row strip, the even and the odd columns.

__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, View vq, View vk, View vv,
                     View vo, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kTile * kLd32;
  float* vs = ks + kTile * kLd32;
  float* ps = vs + kTile * kLd32;
  float* ss = ps + kTile * kLd32;
  float* os = ss + kTile * kLdF;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int i = q0 + warp * kRows + r;
  const float* qw = qs + warp * kRows * kLd32;
  float* pw = ps + warp * kRows * kLd32;
  float* sw = ss + warp * kRows * kLdF;
  float* ow = os + warp * kRows * kLdF;

  load_tile_f32(qs, q, vq, b, h, q0, d.q_len);
  zero_strip(ow);
  const int n_tiles = key_tiles(d, q0, kTile);

  // Pass 1: the row max m and denominator l over every live key.
  float m = kNegInf, l = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile_f32(ks, k, vk, b, h, k0, d.k_len);
    __syncthreads();
    warp_gemm_f32<true>(qw, ks, sw, false);
    float mx = kNegInf;
    for (int c = half; c < kTile; c += 2) {
      if (live(d, i, k0 + c)) mx = fmaxf(mx, sw[r * kLdF + c] * d.scale);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
    for (int c = half; c < kTile; c += 2) {
      if (live(d, i, k0 + c)) sum += expf(sw[r * kLdF + c] * d.scale - m_new);
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    l = l * expf(m - m_new) + sum;
    m = m_new;
  }
  const float l_safe = l == 0.f ? 1.f : l;
  if (half == 0 && i < d.q_len) {
    lse[(static_cast<long long>(b) * d.heads + h) * d.q_len + i] =
        m + logf(l_safe);
  }

  // Pass 2: out = sum over tiles of p . v with the final m and l.
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile_f32(ks, k, vk, b, h, k0, d.k_len);
    load_tile_f32(vs, v, vv, b, h, k0, d.k_len);
    __syncthreads();
    warp_gemm_f32<true>(qw, ks, sw, false);
    for (int c = half; c < kTile; c += 2) {
      pw[r * kLd32 + c] = live(d, i, k0 + c)
          ? expf(sw[r * kLdF + c] * d.scale - m) / l_safe : 0.f;
    }
    warp_gemm_f32<false>(pw, vs, ow, true);
  }
  __syncthreads();
  store_tile_f32(out, vo, b, h, q0, d.q_len, os);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, View vq, View vk, View vv,
                        View vdo, View vdq, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kTile * kLd32;
  float* ks = dos + kTile * kLd32;
  float* vs = ks + kTile * kLd32;
  float* dss = vs + kTile * kLd32;
  float* ss = dss + kTile * kLd32;
  float* dps = ss + kTile * kLdF;
  float* dqs = dps + kTile * kLdF;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int i = q0 + warp * kRows + r;
  const float* qw = qs + warp * kRows * kLd32;
  const float* dow = dos + warp * kRows * kLd32;
  float* dsw = dss + warp * kRows * kLd32;
  float* sw = ss + warp * kRows * kLdF;
  float* dpw = dps + warp * kRows * kLdF;
  float* dqw = dqs + warp * kRows * kLdF;

  load_tile_f32(qs, q, vq, b, h, q0, d.q_len);
  load_tile_f32(dos, dout, vdo, b, h, q0, d.q_len);
  zero_strip(dqw);
  const long long row = (static_cast<long long>(b) * d.heads + h) * d.q_len;
  const float lse_i = i < d.q_len ? lse[row + i] : 0.f;
  const float delta_i = i < d.q_len ? delta[row + i] : 0.f;
  const int n_tiles = key_tiles(d, q0, kTile);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile_f32(ks, k, vk, b, h, k0, d.k_len);
    load_tile_f32(vs, v, vv, b, h, k0, d.k_len);
    __syncthreads();
    warp_gemm_f32<true>(qw, ks, sw, false);    // s  = q . k^T
    warp_gemm_f32<true>(dow, vs, dpw, false);  // dp = dO . v^T
    for (int c = half; c < kTile; c += 2) {
      float ds = 0.f;
      if (live(d, i, k0 + c)) {
        const float p = expf(sw[r * kLdF + c] * d.scale - lse_i);
        ds = p * (dpw[r * kLdF + c] - delta_i) * d.scale;
      }
      dsw[r * kLd32 + c] = ds;
    }
    warp_gemm_f32<false>(dsw, ks, dqw, true);  // dq += ds . k
  }
  __syncthreads();
  store_tile_f32(dq, vdq, b, h, q0, d.q_len, dqs);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         View vq, View vk, View vv, View vdo, View vdk,
                         View vdv, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kTile * kLd32;
  float* qs = vs + kTile * kLd32;
  float* dos = qs + kTile * kLd32;
  float* ps = dos + kTile * kLd32;
  float* ss = ps + kTile * kLd32;
  float* dps = ss + kTile * kLdF;
  float* dks = dps + kTile * kLdF;
  float* dvs = dks + kTile * kLdF;
  float* lse_s = dvs + kTile * kLdF;
  float* delta_s = lse_s + kTile;

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int j = k0 + warp * kRows + r;  // this lane pair's key
  const float* kw = ks + warp * kRows * kLd32;
  const float* vw = vs + warp * kRows * kLd32;
  float* pw = ps + warp * kRows * kLd32;
  float* sw = ss + warp * kRows * kLdF;
  float* dpw = dps + warp * kRows * kLdF;
  float* dkw = dks + warp * kRows * kLdF;
  float* dvw = dvs + warp * kRows * kLdF;

  load_tile_f32(ks, k, vk, b, h, k0, d.k_len);
  load_tile_f32(vs, v, vv, b, h, k0, d.k_len);
  zero_strip(dkw);
  zero_strip(dvw);
  const long long row = (static_cast<long long>(b) * d.heads + h) * d.q_len;
  const int n_q = (d.q_len + kTile - 1) / kTile;

  for (int t = first_query_tile(d, k0); t < n_q; ++t) {
    const int q0 = t * kTile;
    __syncthreads();
    load_tile_f32(qs, q, vq, b, h, q0, d.q_len);
    load_tile_f32(dos, dout, vdo, b, h, q0, d.q_len);
    if (threadIdx.x < kTile) {
      const int iq = q0 + threadIdx.x;
      lse_s[threadIdx.x] = iq < d.q_len ? lse[row + iq] : 0.f;
      delta_s[threadIdx.x] = iq < d.q_len ? delta[row + iq] : 0.f;
    }
    __syncthreads();
    warp_gemm_f32<true>(kw, qs, sw, false);    // s^T  = k . q^T
    warp_gemm_f32<true>(vw, dos, dpw, false);  // dp^T = v . dO^T
    float dsr[kTile / 2];
#pragma unroll
    for (int u = 0; u < kTile / 2; ++u) {
      const int c = 2 * u + half;
      float p = 0.f, ds = 0.f;
      if (live(d, q0 + c, j)) {
        p = expf(sw[r * kLdF + c] * d.scale - lse_s[c]);
        ds = p * (dpw[r * kLdF + c] - delta_s[c]) * d.scale;
      }
      dsr[u] = ds;
      pw[r * kLd32 + c] = p;
    }
    warp_gemm_f32<false>(pw, dos, dvw, true);  // dv += p^T . dO
#pragma unroll
    for (int u = 0; u < kTile / 2; ++u) pw[r * kLd32 + 2 * u + half] = dsr[u];
    warp_gemm_f32<false>(pw, qs, dkw, true);   // dk += ds^T . q
  }
  __syncthreads();
  store_tile_f32(dk, vdk, b, h, k0, d.k_len, dks);
  store_tile_f32(dv, vdv, b, h, k0, d.k_len, dvs);
}

// ------------------------------------------------------------ bf16 path --

using bf16 = __nv_bfloat16;

constexpr int kLd = kD + 8;         // bf16 row stride in shared memory (144 B)
constexpr int kStages = 2;          // cp.async ring depth
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared in flight; with ok false the source size is 0
// and the 16 bytes arrive as zeros (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// The same for one f32 (LSE and delta rows have no 16-byte alignment).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n groups of this thread's copies are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// Rows row0 .. row0 + kTile - 1 of a (b, h) slice (row stride `stride`)
// into shared memory at stride kLd, in flight; rows >= len arrive as zeros.
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long stride, int row0,
                                                int len) {
  constexpr int kChunks = kTile * (kD / 8);
  static_assert(kChunks % kThreads == 0, "whole 16-byte chunks per thread");
#pragma unroll
  for (int u = 0; u < kChunks / kThreads; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int r = e >> 3, c = (e & 7) * 8;
    const int row = row0 + r;
    const bool ok = row < len;
    cp_async16(dst + r * kLd + c,
               src + static_cast<long long>(ok ? row : 0) * stride + c, ok);
  }
}

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16).
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Fragment layouts (g = lane / 4, t = lane % 4).  A C fragment c[j][e] of a
// warp's 16 x 64 tile holds row g + 8 (e / 2), column 8 j + 2 t + (e % 2).
// Per-lane ldmatrix offsets into a kLd-strided tile:
//   a:  the A fragment (16 rows x k16) of rows 0..15;
//   b:  two n8 B fragments from 16 rows of a row-major tile read as B^T
//       (B(k, n) = tile[n][k], as k in q.k^T);
//   bt: two n8 B fragments from 16 rows of a row-major tile read as B
//       (B(k, n) = tile[k][n], as v in p.v), with .trans.
struct Lane {
  int a, b, bt;
};

__device__ __forceinline__ Lane lane_offsets(int lane) {
  return Lane{(lane & 15) * kLd + (lane >> 4) * 8,
              ((lane & 7) + ((lane >> 4) << 3)) * kLd + ((lane >> 3) & 1) * 8,
              ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLd + (lane >> 4) * 8};
}

// The four k16 A fragments of 16 rows x 64 columns.
__device__ __forceinline__ void load_a(unsigned (&a)[4][4], const bf16* rows,
                                       const Lane& off) {
#pragma unroll
  for (int c = 0; c < 4; ++c) ldsm4(a[c], rows + 16 * c + off.a);
}

// c0, c1 (16 x 16) += a (16 x 64) . rows^T, rows: 16 rows of a tile.
__device__ __forceinline__ void mma_a_bt16(float (&c0)[4], float (&c1)[4],
                                           const unsigned (&a)[4][4],
                                           const bf16* rows, const Lane& off) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    unsigned b[4];
    ldsm4(b, rows + 16 * c + off.b);
    mma16816(c0, a[c], b[0], b[1]);
    mma16816(c1, a[c], b[2], b[3]);
  }
}

// acc (16 x 64) = a (16 x 64) . tile^T, tile: 64 rows.
__device__ __forceinline__ void mma_a_bt(float (&acc)[8][4],
                                         const unsigned (&a)[4][4],
                                         const bf16* tile, const Lane& off) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    mma_a_bt16(acc[2 * p], acc[2 * p + 1], a, tile + 16 * p * kLd, off);
  }
}

// acc (16 x 64) += a (16 x 16) . rows (16 x 64): one k16 step.
__device__ __forceinline__ void mma_a_b16(float (&acc)[8][4],
                                          const unsigned (&a)[4],
                                          const bf16* rows, const Lane& off) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    unsigned b[4];
    ldsm4_t(b, rows + 16 * p + off.bt);
    mma16816(acc[2 * p], a, b[0], b[1]);
    mma16816(acc[2 * p + 1], a, b[2], b[3]);
  }
}

// Two f32 C fragments (columns 16 c .. 16 c + 15) rounded to the bf16 A
// fragment of one k16 step.
__device__ __forceinline__ void to_a(unsigned (&a)[4], const float (&c0)[4],
                                     const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Whether the tile pair (queries q0.., keys k0..) holds an entry outside
// the mask: the ragged last tile of either length, or the causal diagonal.
__device__ __forceinline__ bool need_mask(const Dims& d, int q0, int k0) {
  return q0 + kTile > d.q_len || k0 + kTile > d.k_len ||
         (d.causal && k0 + kTile - 1 > q0 + d.offset);
}

// -inf for every score outside the mask.  The warp's rows start at row0,
// its columns at col0; kKeyRows for the dk/dv pass (rows are keys).
template <bool kKeyRows>
__device__ __forceinline__ void mask_tile(float (&s)[8][4], const Dims& d,
                                          int row0, int col0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + g + ((e >> 1) << 3);
      const int c = col0 + 8 * j + 2 * t + (e & 1);
      if (!(kKeyRows ? live(d, c, r) : live(d, r, c))) s[j][e] = -INFINITY;
    }
  }
}

// A warp's 16 x 64 f32 accumulator to rows row0.. of a (b, h) slice,
// rounded once to bf16, through the warp's own 16 rows of `stage`.
__device__ __forceinline__ void store_rows(bf16* dst, long long stride,
                                           int row0, int len,
                                           const float (&acc)[8][4],
                                           bf16* stage, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<unsigned*>(stage + g * kLd + 8 * j + 2 * t) =
        pack(acc[j][0], acc[j][1]);
    *reinterpret_cast<unsigned*>(stage + (g + 8) * kLd + 8 * j + 2 * t) =
        pack(acc[j][2], acc[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = lane + 32 * u;
    const int r = e >> 3, c = (e & 7) * 8;
    if (row0 + r < len) {
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(row0 + r) *
                                          stride + c) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + c);
    }
  }
}

// Forward: one block of 4 warps per (64-query tile, head, batch row).
// Steps 0 .. n-1 are pass 1 over the key tiles (K only), steps n .. 2n-1
// pass 2 (K and V); the ring streams both passes as one sequence.
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, View vq, View vk, View vv, View vo,
                 Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kTile * kLd;            // kStages K tiles
  bf16* vs = ks + kStages * kTile * kLd;  // kStages V tiles

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp;
  const Lane off = lane_offsets(lane);
  const bf16* kb = k + b * vk.b + h * vk.h;
  const bf16* vb = v + b * vv.b + h * vv.h;
  const int n = key_tiles(d, q0, kTile);
  const int steps = 2 * n;

  auto issue = [&](int s) {
    const int st = s % kStages, k0 = (s < n ? s : s - n) * kTile;
    load_tile_async(ks + st * kTile * kLd, kb, vk.l, k0, d.k_len);
    if (s >= n) {
      load_tile_async(vs + st * kTile * kLd, vb, vv.l, k0, d.k_len);
    }
  };
  load_tile_async(qs, q + b * vq.b + h * vq.h, vq.l, q0, d.q_len);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  const float sl2 = d.scale * kLog2e;
  unsigned qf[4][4];
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }
  // Row stats of rows g and g + 8: max (natural units), this thread's
  // partial denominator, then m * log2(e) and 1 / l_safe for pass 2.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, ml[2], inv[2];
  auto finish_stats = [&]() {
    const long long lrow = (static_cast<long long>(b) * d.heads + h) * d.q_len;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      inv[r] = 1.f / l_safe;
      ml[r] = m[r] * kLog2e;
      const int i = row0 + g + 8 * r;
      if (t == 0 && i < d.q_len) lse[lrow + i] = m[r] + logf(l_safe);
    }
  };

  for (int s = 0; s < steps; ++s) {
    if (s + kStages - 1 < steps) issue(s + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (s == 0) load_a(qf, qs + 16 * warp * kLd, off);
    const bool pass2 = s >= n;
    const int k0 = (pass2 ? s - n : s) * kTile;
    const int st = s % kStages;
    float sc[8][4];
    mma_a_bt(sc, qf, ks + st * kTile * kLd, off);  // raw q.k^T
    if (need_mask(d, q0, k0)) mask_tile<false>(sc, d, row0, k0, lane);
    if (!pass2) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        // max(s) * scale == max(s * scale): the scale is positive.
        const float m_new = fmaxf(m[r], mx * d.scale);
        const float mln = m_new * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sum += exp2f(fmaf(sc[j][2 * r], sl2, -mln)) +
                 exp2f(fmaf(sc[j][2 * r + 1], sl2, -mln));
        }
        l[r] = l[r] * exp2f((m[r] - m_new) * kLog2e) + sum;
        m[r] = m_new;
      }
      if (s == n - 1) finish_stats();
    } else {
      const bf16* vt = vs + st * kTile * kLd;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p0[4], p1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p0[e] = exp2f(fmaf(sc[2 * c][e], sl2, -ml[e >> 1])) * inv[e >> 1];
          p1[e] = exp2f(fmaf(sc[2 * c + 1][e], sl2, -ml[e >> 1])) *
                  inv[e >> 1];
        }
        unsigned a[4];
        to_a(a, p0, p1);
        mma_a_b16(o, a, vt + 16 * c * kLd, off);  // out += p . v
      }
    }
    __syncthreads();
  }
  if (n == 0) finish_stats();  // no live key: lse -1e30, out 0
  cp_async_wait<0>();
  __syncthreads();
  store_rows(out + b * vo.b + h * vo.h, vo.l, row0, d.q_len, o,
             qs + 16 * warp * kLd, lane);
}

// dq pass: one block per (64-query tile, head, batch row), walking the key
// tiles; per tile s = q.k^T, then for each 16-key step dp = dO.v^T, ds and
// dq += ds.k.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    View vq, View vk, View vv, View vdo, View vdq, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kTile * kLd;
  bf16* ks = dos + kTile * kLd;           // kStages K tiles
  bf16* vs = ks + kStages * kTile * kLd;  // kStages V tiles

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int row0 = q0 + 16 * warp;
  const Lane off = lane_offsets(lane);
  const bf16* kb = k + b * vk.b + h * vk.h;
  const bf16* vb = v + b * vv.b + h * vv.h;
  const int n = key_tiles(d, q0, kTile);

  auto issue = [&](int s) {
    const int st = s % kStages;
    load_tile_async(ks + st * kTile * kLd, kb, vk.l, s * kTile, d.k_len);
    load_tile_async(vs + st * kTile * kLd, vb, vv.l, s * kTile, d.k_len);
  };
  load_tile_async(qs, q + b * vq.b + h * vq.h, vq.l, q0, d.q_len);
  load_tile_async(dos, dout + b * vdo.b + h * vdo.h, vdo.l, q0, d.q_len);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) issue(s);
    cp_async_commit();
  }

  // lse * log2(e) and delta of rows g and g + 8 (0 past q_len).
  const long long lrow = (static_cast<long long>(b) * d.heads + h) * d.q_len;
  float ll[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    ll[r] = i < d.q_len ? lse[lrow + i] * kLog2e : 0.f;
    dl[r] = i < d.q_len ? delta[lrow + i] : 0.f;
  }
  const float sl2 = d.scale * kLog2e;
  unsigned qf[4][4], dof[4][4];
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  for (int s = 0; s < n; ++s) {
    if (s + kStages - 1 < n) issue(s + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (s == 0) {
      load_a(qf, qs + 16 * warp * kLd, off);
      load_a(dof, dos + 16 * warp * kLd, off);
    }
    const int k0 = s * kTile, st = s % kStages;
    const bf16* kt = ks + st * kTile * kLd;
    const bf16* vt = vs + st * kTile * kLd;
    float p[8][4];
    mma_a_bt(p, qf, kt, off);  // raw q.k^T
    if (need_mask(d, q0, k0)) mask_tile<false>(p, d, row0, k0, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] = exp2f(fmaf(p[j][e], sl2, -ll[e >> 1]));  // masked: 0
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // keys 16 c .. 16 c + 15
      float dp0[4] = {0.f, 0.f, 0.f, 0.f}, dp1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_a_bt16(dp0, dp1, dof, vt + 16 * c * kLd, off);  // dp = dO.v^T
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp0[e] = p[2 * c][e] * (dp0[e] - dl[e >> 1]) * d.scale;
        dp1[e] = p[2 * c + 1][e] * (dp1[e] - dl[e >> 1]) * d.scale;
      }
      unsigned a[4];
      to_a(a, dp0, dp1);
      mma_a_b16(acc, a, kt + 16 * c * kLd, off);  // dq += ds.k
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
  store_rows(dq + b * vdq.b + h * vdq.h, vdq.l, row0, d.q_len, acc,
             qs + 16 * warp * kLd, lane);
}

// dk/dv pass: one block per (64-key tile, head, batch row), walking the
// query tiles with their LSE and delta; each warp owns 16 keys and computes
// s^T = k.q^T, then for each 16-query step dv += p^T.dO, dp^T = v.dO^T and
// dk += ds^T.q.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, View vq, View vk, View vv,
                     View vdo, View vdk, View vdv, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile * kLd;
  bf16* qs = vs + kTile * kLd;             // kStages Q tiles
  bf16* dos = qs + kStages * kTile * kLd;  // kStages dO tiles
  float* ls = reinterpret_cast<float*>(dos + kStages * kTile * kLd);
  float* dls = ls + kStages * kTile;       // kStages LSE / delta rows

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kTile;  // the first key tiles see most queries
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row0 = k0 + 16 * warp;
  const Lane off = lane_offsets(lane);
  const bf16* qb = q + b * vq.b + h * vq.h;
  const bf16* dob = dout + b * vdo.b + h * vdo.h;
  const long long lrow = (static_cast<long long>(b) * d.heads + h) * d.q_len;
  const int first = first_query_tile(d, k0);
  const int steps = max(0, (d.q_len + kTile - 1) / kTile - first);

  auto issue = [&](int s) {
    const int st = s % kStages, q0 = (first + s) * kTile;
    load_tile_async(qs + st * kTile * kLd, qb, vq.l, q0, d.q_len);
    load_tile_async(dos + st * kTile * kLd, dob, vdo.l, q0, d.q_len);
    for (int e = threadIdx.x; e < 2 * kTile; e += kThreads) {
      const int c = e % kTile, i = q0 + c;
      const bool ok = i < d.q_len;
      const float* src = (e < kTile ? lse : delta) + lrow + (ok ? i : 0);
      cp_async4((e < kTile ? ls : dls) + st * kTile + c, src, ok);
    }
  };
  load_tile_async(ks, k + b * vk.b + h * vk.h, vk.l, k0, d.k_len);
  load_tile_async(vs, v + b * vv.b + h * vv.h, vv.l, k0, d.k_len);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  const float sl2 = d.scale * kLog2e;
  unsigned kf[4][4], vf[4][4];
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }

  for (int s = 0; s < steps; ++s) {
    if (s + kStages - 1 < steps) issue(s + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (s == 0) {
      load_a(kf, ks + 16 * warp * kLd, off);
      load_a(vf, vs + 16 * warp * kLd, off);
    }
    const int q0 = (first + s) * kTile, st = s % kStages;
    const bf16* qt = qs + st * kTile * kLd;
    const bf16* dot = dos + st * kTile * kLd;
    const float* lt = ls + st * kTile;
    const float* dlt = dls + st * kTile;
    float p[8][4];
    mma_a_bt(p, kf, qt, off);  // raw s^T = k.q^T
    if (need_mask(d, q0, k0)) mask_tile<true>(p, d, row0, q0, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        p[j][e] = exp2f(fmaf(p[j][e], sl2, -lt[c] * kLog2e));  // masked: 0
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // queries 16 c .. 16 c + 15
      unsigned a[4];
      to_a(a, p[2 * c], p[2 * c + 1]);
      mma_a_b16(dva, a, dot + 16 * c * kLd, off);  // dv += p^T.dO
      float dp0[4] = {0.f, 0.f, 0.f, 0.f}, dp1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_a_bt16(dp0, dp1, vf, dot + 16 * c * kLd, off);  // dp^T = v.dO^T
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 16 * c + 2 * t + (e & 1);
        dp0[e] = p[2 * c][e] * (dp0[e] - dlt[col]) * d.scale;
        dp1[e] = p[2 * c + 1][e] * (dp1[e] - dlt[col + 8]) * d.scale;
      }
      to_a(a, dp0, dp1);
      mma_a_b16(dka, a, qt + 16 * c * kLd, off);  // dk += ds^T.q
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
  store_rows(dk + b * vdk.b + h * vdk.h, vdk.l, row0, d.k_len, dka,
             ks + 16 * warp * kLd, lane);
  store_rows(dv + b * vdv.b + h * vdv.h, vdv.l, row0, d.k_len, dva,
             vs + 16 * warp * kLd, lane);
}

// ------------------------------------------------------------- launches --

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

Dims make_dims(int heads, int q_len, int k_len, int causal, float scale) {
  return Dims{heads, q_len, k_len, causal, k_len - q_len, scale};
}

View view(const long long* s, int t) { return View{s[3 * t], s[3 * t + 1], s[3 * t + 2]}; }

int tiles(int len, int rows) { return (len + rows - 1) / rows; }

cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* out,
                    void* lse, int batch, const Dims& d, const long long* s,
                    cudaStream_t stream) {
  const size_t smem = 4 * kF32Op + 2 * kF32Tile;
  cudaError_t err = allow_smem(flash_fwd_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles(d.q_len, kTile), d.heads, batch);
  flash_fwd_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), view(s, 0), view(s, 1), view(s, 2),
      view(s, 3), d);
  return cudaGetLastError();
}

cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* out,
                     void* lse, int batch, const Dims& d, const long long* s,
                     cudaStream_t stream) {
  const size_t smem = (kTile * kLd + 2 * kStages * kTile * kLd) *
                      sizeof(bf16);
  cudaError_t err = allow_smem(flash_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(d.heads, batch, tiles(d.q_len, kTile));
  flash_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), view(s, 0), view(s, 1), view(s, 2),
      view(s, 3), d);
  return cudaGetLastError();
}

cudaError_t bwd_dq_f32(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int batch, const Dims& d, const long long* s,
                       cudaStream_t stream) {
  const size_t smem = 5 * kF32Op + 3 * kF32Tile;
  cudaError_t err = allow_smem(flash_bwd_dq_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles(d.q_len, kTile), d.heads, batch);
  flash_bwd_dq_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), view(s, 0), view(s, 1), view(s, 2),
      view(s, 3), view(s, 4), d);
  return cudaGetLastError();
}

cudaError_t bwd_dq_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int batch, const Dims& d,
                        const long long* s, cudaStream_t stream) {
  const size_t smem = (2 * kTile * kLd + 2 * kStages * kTile * kLd) *
                      sizeof(bf16);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(d.heads, batch, tiles(d.q_len, kTile));
  flash_bwd_dq_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), view(s, 0), view(s, 1), view(s, 2),
      view(s, 3), view(s, 4), d);
  return cudaGetLastError();
}

cudaError_t bwd_dkv_f32(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int batch, const Dims& d,
                        const long long* s, cudaStream_t stream) {
  const size_t smem = 5 * kF32Op + 4 * kF32Tile + 2 * kTile * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkv_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles(d.k_len, kTile), d.heads, batch);
  flash_bwd_dkv_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), view(s, 0),
      view(s, 1), view(s, 2), view(s, 3), view(s, 4), view(s, 5), d);
  return cudaGetLastError();
}

cudaError_t bwd_dkv_bf16(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int batch, const Dims& d,
                         const long long* s, cudaStream_t stream) {
  const size_t smem = (2 * kTile * kLd + 2 * kStages * kTile * kLd) *
                          sizeof(bf16) +
                      2 * kStages * kTile * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(d.heads, batch, tiles(d.k_len, kTile));
  flash_bwd_dkv_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), view(s, 0),
      view(s, 1), view(s, 2), view(s, 3), view(s, 4), view(s, 5), d);
  return cudaGetLastError();
}

// Grid limits: the bf16 grids put the tile index on z, the f32 grids the
// heads and batch rows on y and z (at most 65535 each).
bool valid(int dtype, int batch, int heads, int q_len, int k_len,
           int head_dim) {
  return (dtype == 0 || dtype == 1) && head_dim == kD && batch >= 1 &&
         batch <= 65535 && heads >= 1 && heads <= 65535 && q_len >= 1 &&
         k_len >= 1 && tiles(q_len, kTile) <= 65535 &&
         tiles(k_len, kTile) <= 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: (b, l, h) of q, k, v, out.
int pdt_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                  void* out, void* lse, int batch, int heads, int q_len,
                  int k_len, int head_dim, int causal, float scale,
                  const long long* strides, void* stream) {
  if (!valid(dtype, batch, heads, q_len, k_len, head_dim)) {
    return cudaErrorInvalidValue;
  }
  const Dims d = make_dims(heads, q_len, k_len, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_f32(q, k, v, out, lse, batch, d, strides, st);
  return fwd_bf16(q, k, v, out, lse, batch, d, strides, st);
}

// strides: (b, l, h) of q, k, v, dout, dq.
int pdt_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int batch, int heads, int q_len, int k_len,
                     int head_dim, int causal, float scale,
                     const long long* strides, void* stream) {
  if (!valid(dtype, batch, heads, q_len, k_len, head_dim)) {
    return cudaErrorInvalidValue;
  }
  const Dims d = make_dims(heads, q_len, k_len, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return bwd_dq_f32(q, k, v, dout, lse, delta, dq, batch, d, strides, st);
  }
  return bwd_dq_bf16(q, k, v, dout, lse, delta, dq, batch, d, strides, st);
}

// strides: (b, l, h) of q, k, v, dout, dk, dv.
int pdt_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int batch, int heads, int q_len,
                      int k_len, int head_dim, int causal, float scale,
                      const long long* strides, void* stream) {
  if (!valid(dtype, batch, heads, q_len, k_len, head_dim)) {
    return cudaErrorInvalidValue;
  }
  const Dims d = make_dims(heads, q_len, k_len, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return bwd_dkv_f32(q, k, v, dout, lse, delta, dk, dv, batch, d, strides,
                       st);
  }
  return bwd_dkv_bf16(q, k, v, dout, lse, delta, dk, dv, batch, d, strides,
                      st);
}

const char* pdt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
