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
// Dh 64, bf16, causal) the forward's two products are 12.9 GFLOP (13.0 us
// at 989 TF/s) against 50.7 MB of q, k, v, out and LSE (15.1 us at 3.35
// TB/s): bytes by a hair.  The backward's five products (32.2 GFLOP, 32.6
// us) outweigh its 88.9 MB (26.5 us): operations.  So the products belong
// on the tensor cores, and the score matrix must never reach device memory.
//
// Design (a simple first version; speed is later work):
//   - One block of 4 warps per (64-query tile, head, batch row) for the
//     forward and the dq pass, per (64-key tile, head, batch row) for the
//     dk/dv pass.  Each warp owns 16 rows of the tile.  The dq and dk/dv
//     passes each recompute s, p and dp (7 products where a fused pass
//     would do 5) but need no atomics and give the same bits on every run.
//   - Tiles of 64 x 64 are staged in shared memory with 16-byte loads from
//     the strided (B, L, H, D) views (no copies around the kernel); rows
//     past a length load as zeros and are masked.
//   - bf16 products run on the tensor cores through WMMA (16x16x16, f32
//     accumulate); f32 products run as scalar FMAs (f32 is the parity
//     path, not a speed path).  Scores and accumulators live in f32 shared
//     memory between products, so the softmax runs on a known layout.
//   - The forward takes two passes over the key tiles: the first finds the
//     row max and denominator, the second forms the normalised p.  That is
//     one extra q.k^T product, bought to round the normalised p as the
//     one-tile TPU kernels do, and to keep the output accumulator free of
//     per-row rescaling.
//   - Key tiles past a query tile's causal limit, and query tiles before a
//     key tile's, are skipped (_live_block).
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
#include <mma.h>

#include <math.h>
#include <type_traits>

namespace {

constexpr int kD = 64;                  // head dim
constexpr int kTile = 64;               // queries or keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kTile / kWarps;   // rows of a tile per warp
constexpr int kLdF = kTile + 4;         // f32 row stride in shared memory
constexpr float kNegInf = -1e30f;       // _NEG_INF of the TPU kernels
constexpr unsigned kFull = 0xffffffffu;

static_assert(kD == kTile, "the warp products assume square 64 tiles");

// Row stride in shared memory of a tile of T: padded by 16 bytes, which
// keeps WMMA's 32-byte alignment and staggers the banks.
template <typename T>
struct Ld {
  static constexpr int v = kD + 16 / static_cast<int>(sizeof(T));
};

template <typename T>
constexpr size_t tile_bytes() {
  return sizeof(T) * kTile * Ld<T>::v;
}
constexpr size_t kF32Tile = sizeof(float) * kTile * kLdF;

struct View {
  long long b, l, h;  // element strides of a (B, L, H, D) view
};

struct Dims {
  int heads, q_len, k_len, causal, offset;  // offset = k_len - q_len
  float scale;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool live(const Dims& d, int i, int j) {
  return i < d.q_len && j < d.k_len && (!d.causal || j <= i + d.offset);
}

// Number of key tiles a query tile starting at q0 needs (_live_block).
__device__ __forceinline__ int key_tiles(const Dims& d, int q0) {
  int n = (d.k_len + kTile - 1) / kTile;
  if (d.causal) {
    const long long last = static_cast<long long>(q0) + kTile - 1 + d.offset;
    if (last < 0) return 0;
    n = min(n, static_cast<int>(last / kTile) + 1);
  }
  return n;
}

// First query tile that sees any key of the tile starting at k0.
__device__ __forceinline__ int first_query_tile(const Dims& d, int k0) {
  if (!d.causal) return 0;
  const long long need = static_cast<long long>(k0) - (kTile - 1) - d.offset;
  return need <= 0 ? 0 : static_cast<int>((need + kTile - 1) / kTile);
}

// Rows row0..row0+63 of (b, h) into shared memory; rows >= len are zeros.
template <typename T>
__device__ void load_tile(T* dst, const T* src, View v, int b, int h,
                          int row0, int len) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kD / kVec;
  const T* base = src + b * v.b + h * v.h;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < len) {
      val = *reinterpret_cast<const uint4*>(
          base + static_cast<long long>(row0 + r) * v.l + c);
    }
    *reinterpret_cast<uint4*>(dst + r * Ld<T>::v + c) = val;
  }
}

// An f32 tile accumulator out to rows row0.. of (b, h), rounded to T.
template <typename T>
__device__ void store_tile(T* dst, View v, int b, int h, int row0, int len,
                           const float* src) {
  T* base = dst + b * v.b + h * v.h;
  for (int e = threadIdx.x; e < kTile * kD; e += kThreads) {
    const int r = e / kD;
    const int c = e % kD;
    if (row0 + r < len) {
      store(base + static_cast<long long>(row0 + r) * v.l + c,
            src[r * kLdF + c]);
    }
  }
}

// One warp: C[16 x 64] (f32, stride kLdF) = (C +) A[16 x 64] . B[64 x 64].
// A is row-major with stride Ld<T>; B(k, n) is Bs[k * ld + n], or with kBT
// Bs[n * ld + k] (B given transposed, as a row-major K or Q tile).
template <bool kBT>
__device__ void warp_gemm(const __nv_bfloat16* A, const __nv_bfloat16* B,
                          float* C, bool accumulate) {
  using namespace nvcuda;
  constexpr int ld = Ld<__nv_bfloat16>::v;
  using BLayout =
      typename std::conditional<kBT, wmma::col_major, wmma::row_major>::type;
  __syncwarp();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (accumulate) {
      wmma::load_matrix_sync(acc[n], C + n * 16, kLdF, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc[n], 0.f);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        a;
    wmma::load_matrix_sync(a, A + k * 16, ld);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> bf;
      const __nv_bfloat16* bp =
          kBT ? B + n * 16 * ld + k * 16 : B + k * 16 * ld + n * 16;
      wmma::load_matrix_sync(bf, bp, ld);
      wmma::mma_sync(acc[n], a, bf, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::store_matrix_sync(C + n * 16, acc[n], kLdF, wmma::mem_row_major);
  }
  __syncwarp();
}

// The same product in f32 on the CUDA cores: lane t owns columns t, t + 32.
template <bool kBT>
__device__ void warp_gemm(const float* A, const float* B, float* C,
                          bool accumulate) {
  constexpr int ld = Ld<float>::v;
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
    const float b0 = kBT ? B[lane * ld + k] : B[k * ld + lane];
    const float b1 = kBT ? B[(lane + 32) * ld + k] : B[k * ld + lane + 32];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float a = A[r * ld + k];
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, View vq, View vk, View vv, View vo,
                 Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = Ld<T>::v;
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kTile * ld;
  T* vs = ks + kTile * ld;
  T* ps = vs + kTile * ld;
  float* ss = reinterpret_cast<float*>(ps + kTile * ld);
  float* os = ss + kTile * kLdF;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int i = q0 + warp * kRows + r;
  const T* qw = qs + warp * kRows * ld;
  T* pw = ps + warp * kRows * ld;
  float* sw = ss + warp * kRows * kLdF;
  float* ow = os + warp * kRows * kLdF;

  load_tile(qs, q, vq, b, h, q0, d.q_len);
  zero_strip(ow);
  const int n_tiles = key_tiles(d, q0);

  // Pass 1: the row max m and denominator l over every live key.
  float m = kNegInf, l = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile(ks, k, vk, b, h, k0, d.k_len);
    __syncthreads();
    warp_gemm<true>(qw, ks, sw, false);
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

  // Pass 2: out = sum over tiles of round(p) . v with the final m and l.
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile(ks, k, vk, b, h, k0, d.k_len);
    load_tile(vs, v, vv, b, h, k0, d.k_len);
    __syncthreads();
    warp_gemm<true>(qw, ks, sw, false);
    for (int c = half; c < kTile; c += 2) {
      const float p = live(d, i, k0 + c)
          ? expf(sw[r * kLdF + c] * d.scale - m) / l_safe : 0.f;
      store(pw + r * ld + c, p);
    }
    warp_gemm<false>(pw, vs, ow, true);
  }
  __syncthreads();
  store_tile(out, vo, b, h, q0, d.q_len, os);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    View vq, View vk, View vv, View vdo, View vdq, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = Ld<T>::v;
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kTile * ld;
  T* ks = dos + kTile * ld;
  T* vs = ks + kTile * ld;
  T* dss = vs + kTile * ld;
  float* ss = reinterpret_cast<float*>(dss + kTile * ld);
  float* dps = ss + kTile * kLdF;
  float* dqs = dps + kTile * kLdF;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int i = q0 + warp * kRows + r;
  const T* qw = qs + warp * kRows * ld;
  const T* dow = dos + warp * kRows * ld;
  T* dsw = dss + warp * kRows * ld;
  float* sw = ss + warp * kRows * kLdF;
  float* dpw = dps + warp * kRows * kLdF;
  float* dqw = dqs + warp * kRows * kLdF;

  load_tile(qs, q, vq, b, h, q0, d.q_len);
  load_tile(dos, dout, vdo, b, h, q0, d.q_len);
  zero_strip(dqw);
  const long long row = (static_cast<long long>(b) * d.heads + h) * d.q_len;
  const float lse_i = i < d.q_len ? lse[row + i] : 0.f;
  const float delta_i = i < d.q_len ? delta[row + i] : 0.f;
  const int n_tiles = key_tiles(d, q0);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile(ks, k, vk, b, h, k0, d.k_len);
    load_tile(vs, v, vv, b, h, k0, d.k_len);
    __syncthreads();
    warp_gemm<true>(qw, ks, sw, false);    // s  = q . k^T
    warp_gemm<true>(dow, vs, dpw, false);  // dp = dO . v^T
    for (int c = half; c < kTile; c += 2) {
      float ds = 0.f;
      if (live(d, i, k0 + c)) {
        const float p = expf(sw[r * kLdF + c] * d.scale - lse_i);
        ds = p * (dpw[r * kLdF + c] - delta_i) * d.scale;
      }
      store(dsw + r * ld + c, ds);
    }
    warp_gemm<false>(dsw, ks, dqw, true);  // dq += ds . k
  }
  __syncthreads();
  store_tile(dq, vdq, b, h, q0, d.q_len, dqs);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, View vq, View vk, View vv, View vdo,
                     View vdk, View vdv, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = Ld<T>::v;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kTile * ld;
  T* qs = vs + kTile * ld;
  T* dos = qs + kTile * ld;
  T* ps = dos + kTile * ld;
  float* ss = reinterpret_cast<float*>(ps + kTile * ld);
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
  const T* kw = ks + warp * kRows * ld;
  const T* vw = vs + warp * kRows * ld;
  T* pw = ps + warp * kRows * ld;
  float* sw = ss + warp * kRows * kLdF;
  float* dpw = dps + warp * kRows * kLdF;
  float* dkw = dks + warp * kRows * kLdF;
  float* dvw = dvs + warp * kRows * kLdF;

  load_tile(ks, k, vk, b, h, k0, d.k_len);
  load_tile(vs, v, vv, b, h, k0, d.k_len);
  zero_strip(dkw);
  zero_strip(dvw);
  const long long row = (static_cast<long long>(b) * d.heads + h) * d.q_len;
  const int n_q = (d.q_len + kTile - 1) / kTile;

  for (int t = first_query_tile(d, k0); t < n_q; ++t) {
    const int q0 = t * kTile;
    __syncthreads();
    load_tile(qs, q, vq, b, h, q0, d.q_len);
    load_tile(dos, dout, vdo, b, h, q0, d.q_len);
    if (threadIdx.x < kTile) {
      const int iq = q0 + threadIdx.x;
      lse_s[threadIdx.x] = iq < d.q_len ? lse[row + iq] : 0.f;
      delta_s[threadIdx.x] = iq < d.q_len ? delta[row + iq] : 0.f;
    }
    __syncthreads();
    warp_gemm<true>(kw, qs, sw, false);    // s^T  = k . q^T
    warp_gemm<true>(vw, dos, dpw, false);  // dp^T = v . dO^T
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
      store(pw + r * ld + c, p);
    }
    warp_gemm<false>(pw, dos, dvw, true);  // dv += p^T . dO
#pragma unroll
    for (int u = 0; u < kTile / 2; ++u) store(pw + r * ld + 2 * u + half, dsr[u]);
    warp_gemm<false>(pw, qs, dkw, true);   // dk += ds^T . q
  }
  __syncthreads();
  store_tile(dk, vdk, b, h, k0, d.k_len, dks);
  store_tile(dv, vdv, b, h, k0, d.k_len, dvs);
}

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

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int batch, const Dims& d, const long long* s,
                cudaStream_t stream) {
  const size_t smem = 4 * tile_bytes<T>() + 2 * kF32Tile;
  auto kernel = flash_fwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((d.q_len + kTile - 1) / kTile, d.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), view(s, 0), view(s, 1), view(s, 2),
      view(s, 3), d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int batch, const Dims& d, const long long* s,
                   cudaStream_t stream) {
  const size_t smem = 5 * tile_bytes<T>() + 3 * kF32Tile;
  auto kernel = flash_bwd_dq_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((d.q_len + kTile - 1) / kTile, d.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), view(s, 0), view(s, 1), view(s, 2), view(s, 3),
      view(s, 4), d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int batch, const Dims& d,
                    const long long* s, cudaStream_t stream) {
  const size_t smem =
      5 * tile_bytes<T>() + 4 * kF32Tile + 2 * kTile * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((d.k_len + kTile - 1) / kTile, d.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), view(s, 0), view(s, 1),
      view(s, 2), view(s, 3), view(s, 4), view(s, 5), d);
  return cudaGetLastError();
}

bool valid(int dtype, int batch, int heads, int q_len, int k_len,
           int head_dim) {
  return (dtype == 0 || dtype == 1) && head_dim == kD && batch >= 1 &&
         batch <= 65535 && heads >= 1 && heads <= 65535 && q_len >= 1 &&
         k_len >= 1;
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
  if (dtype == 0) return fwd<float>(q, k, v, out, lse, batch, d, strides, st);
  return fwd<__nv_bfloat16>(q, k, v, out, lse, batch, d, strides, st);
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
    return bwd_dq<float>(q, k, v, dout, lse, delta, dq, batch, d, strides, st);
  }
  return bwd_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, batch, d,
                               strides, st);
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
    return bwd_dkv<float>(q, k, v, dout, lse, delta, dk, dv, batch, d,
                          strides, st);
  }
  return bwd_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, batch, d,
                                strides, st);
}

const char* pdt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
