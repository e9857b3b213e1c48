// Decode attention over the contiguous KV cache, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of pytorch_distributed_training_tpu/ops/
// pallas_attention.py:
//   decode_attention        (_decode_kernel)        C == 1
//   decode_attention_multi  (_decode_kernel_multi)  1 <= C <= 8
// with one kernel templated on the storage dtype and the chunk width C (16
// instances).  Query j of batch row b attends cache positions
// 0..index[b]+j; an index >= L (the cache length) is the idle-slot sentinel
// and unmasks the whole row, whose output the caller discards.  A query
// that sees no key (index[b] + j < 0) gets the mean of V over all L
// positions, as the TPU kernel does: there every score is -1e30 and the
// softmax is uniform.  Here such a query takes all L keys with equal
// scores, which gives the same p = 1 / L.
//
// Math, copied from the TPU kernels so results agree to rounding:
//   s = (q . k) in f32, then * scale;  an exact softmax in f32
//   (exp(s - max) / sum over the row); p rounded to V's dtype;
//   out = sum_l p[l] * v[l] in f32, rounded to the output dtype once.
// The softmax is exact, not online: the TPU kernel normalises p before it
// rounds p to V's dtype (`p = jax.nn.softmax(s); p.astype(vh.dtype) @ vh`,
// pallas_attention.py:1212-1215 and 1287-1290), so the row's global max
// and sum must be known before any p is rounded.  The partials of
// unnormalised p that the paged kernel merges (csrc/paged_attention.cu)
// would round a different p.
//
// Bound on this card: bytes.  At the serving shapes (B 8, H 12, L 1024,
// Dh 64, index [0, 5, 100, 511, 1000, 1023, 1024, 300]) a bf16 call must
// read 12.2 MB of visible K/V, 3.65 us at 3.35 TB/s, and does ~4 flops per
// K/V element at C = 1 (~32 at C = 8), far below the ~300 flops a byte
// where the H100 turns compute bound.  One block per (row, head) walking
// its row alone fills 96 blocks for 132 SMs, with 16 KB of a 128 KB K
// prefix in flight, then V after the softmax: 34.4 us at C = 1 and 48.8 us
// at C = 5 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).  This design puts the
// bytes in flight at once:
//
//   - Each (row, head)'s visible keys are split over a thread-block
//     cluster of S <= 8 blocks (the portable cluster size): grid
//     (S x H, B), cluster (S, 1, 1), launched with cudaLaunchKernelEx so
//     that S is a runtime argument.  Each block reads index[b] itself,
//     counts the row's visible keys and takes an equal share in 16-key
//     tiles, so a short row costs its blocks little.  The host picks S
//     from the shapes, the storage width and the SM count alone
//     (ops/decode_attention.py::decode_split: about 4 blocks an SM, S = 8
//     at the serving shapes on 132 SMs, 128 keys a block), never from
//     index (no device sync).  The storage width enters only where a long
//     cache's share must fit a block's shared memory.
//   - The softmax stays exact across the cluster through distributed
//     shared memory, in four cluster barriers and no scratch in device
//     memory: (a) each block writes its keys' scaled scores and its per-
//     query max to its own shared memory; barrier; (b) each block takes
//     the global max M over the ranks and its local sum of exp(s - M);
//     barrier; (c) each block takes the global sum Z in rank order, forms
//     p = round(exp(s - M) / Z) and its partial p . V in f32; barrier;
//     (d) rank r sums a fixed slice of the C x Dh output over the ranks in
//     rank order and stores it; (e) a last barrier before any block exits,
//     so no block leaves while a peer reads its shared memory.  A block
//     with an empty share takes part in every barrier with max -inf, sum
//     0 and output 0.  Within a block, thread t takes keys t, t + 128, ...
//     for every query, and each query's values meet by warp shuffles,
//     then over the warps in warp order; a block reads its peers' values
//     as float4s, all ranks' loads issued before any is used.  Every sum
//     has a fixed order and there are no atomics, so a repeated call gives
//     the same bits.
//   - K and V of a block's share go in flight from the start through one
//     cp.async ring (16-byte copies at the stored width, 8 slots): the
//     share's K tiles fill the slots at once, and each V tile is issued
//     into the slot its K tile frees, so V arrives while the scores and
//     the first barriers run.  A ring that held K and V of a 128-key share
//     at once would take 41-47 KB a block at bf16: at most 5 blocks an SM,
//     in clusters of 8 within a GPC, too few for the 768 blocks of a
//     serving call to be resident at once; at 23-28 KB a block they are.
//     A share longer than the ring (a long cache) refills slots as tiles
//     are used.  Only the share's f32 scores (C x share x 4 bytes) stay for
//     the whole call, so the longest cache grows about S-fold over holding
//     a whole row's C x L scores.
//   - bf16 products run on the tensor cores, keys on the M side:
//     mma.sync m16n8k16 bf16 -> f32, S^T (16 keys x 8 queries) = K tile .
//     q^T with K by ldmatrix and q's fragments (queries padded to 8 with
//     zeros) held in registers, and out^T (16 dims x 8 queries) = V^T . P^T
//     with V by ldmatrix.trans and the rounded p by ldmatrix.  C <= 8
//     fills n = 8.  The warps split a tile's keys for the scores and the
//     head dims for PV, so no warp merge is needed.  f32 storage keeps f32
//     products on the CUDA cores (TF32 would change the numbers) in the
//     same cluster structure: one output path for both dtypes.
//
// Measured with chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W; PERF.md has
// the table): bf16 C = 1, 5 and 8 under SDPA on the same cache.  Left for
// later work: a call is still several times its byte bound.  Its phases
// run in series: index, then the K/V round trip under the whole call's
// load, then four cluster barriers.
//
// Interface: plain C, loaded with ctypes (ops/decode_attention.py), in two
// steps so that a call's host path stays short.  pdt_decode_plan, once per
// launch shape (dtype, C, sizes, strides, scale, S, share, tile), checks
// the sizes, makes the shared-memory layout (and reports its bytes, which
// the wrapper holds against its own count), sets the instance's shared-
// memory limit and checks that a cluster can be resident.  pdt_decode_run
// then takes the plan and the five pointers and makes the one launch on
// the caller's stream, returning cudaGetLastError().  All strides are in
// elements; the last dimension of every operand must be contiguous with
// 16-byte-aligned rows (the Python wrapper checks this).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 8;         // cp.async ring slots (one tile each)
constexpr int kTile = 16;         // keys per share tile and per mma step
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kMaxDh = 128;
constexpr int kQPad = 8;          // queries per mma tile (n = 8)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* index;
  void* out;
  int batch, heads, length, head_dim, cluster;
  int share_keys;  // the most keys one block holds: a multiple of kTile
  int tile_keys;   // keys per ring slot: a multiple of kTile
  float scale;
  long long q_b, q_c, q_h;
  long long k_b, k_h, k_l;
  long long v_b, v_h, v_l;
  long long o_b, o_c, o_h;
  // Shared-memory layout in bytes (make_layout).
  int row_bytes;   // one stored K or V row
  int row_stride;  // its stride in the ring: a 16-byte multiple + 16
  int q_off, q_ld;    // q: bf16 [kQPad][q_ld] or f32 [C][q_ld]
  int sc_off, sc_ld;  // f32 scores, then exp(s - M) (f32: then p) [C][sc_ld]
  int p_off, p_ld;    // bf16 p [kQPad][p_ld] (tensor-core path)
  int part_off;       // f32 partial output [C][head_dim]
  int red_off;        // per-query max and sum [kQPad] each; per warp
                      // [kWarps][kQPad]
  int smem_bytes;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// Round to the storage dtype and back: the TPU kernel casts p to V's dtype
// before the PV product.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared in flight; with ok false the source size is 0
// and the bytes arrive as zeros (src must still be valid).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
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

__device__ __forceinline__ void ldsm2(unsigned& r0, unsigned& r1,
                                      const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
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

// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16).  Fragment
// layout (g = lane / 4, t = lane % 4): c[e] holds row g + 8 (e / 2),
// column 2 t + (e % 2).
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  }
  return x;
}

// A butterfly: every lane ends with the same bits, in a fixed order.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Rank r's per-query values (kQPad floats at `at`, 16-byte aligned) for
// r < kMaxCluster, through distributed shared memory: every load is
// issued before any is used, ranks past the cluster read its last rank,
// and every lane of a warp reads the same address (one request a warp).
template <int C>
__device__ __forceinline__ void load_ranks(cg::cluster_group cluster,
                                           float* at, int S,
                                           float4 (&v)[kMaxCluster][2]) {
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    const float4* src = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(at, min(r, S - 1)));
    v[r][0] = src[0];
    if (C > 4) v[r][1] = src[1];
  }
}

__device__ __forceinline__ float lane_of(const float4 (&v)[2], int j) {
  const float4 x = v[j >> 2];
  const int i = j & 3;
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// The score of the key at position `key` for a query whose last visible
// position is `last`: masked keys are -inf (their p is an explicit 0), and
// a query that sees no key (last < 0) takes every key with score 0.
__device__ __forceinline__ float masked(float s, int key, long long last) {
  if (last < 0) return 0.f;
  return key <= last ? s : -INFINITY;
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Params p) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.cluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x / S;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dh = p.head_dim;

  unsigned char* ring = smem;
  float* sc = reinterpret_cast<float*>(smem + p.sc_off);
  float* part = reinterpret_cast<float*>(smem + p.part_off);
  float* red_max = reinterpret_cast<float*>(smem + p.red_off);
  float* red_sum = red_max + kQPad;

  // q into registers first (its address does not depend on index): 16
  // bytes a thread, at most two, stored to shared memory below.
  const T* qg = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int q_rows = kMma ? kQPad : C;
  const int q_cols = kMma ? (dh + 15) & ~15 : dh;
  const int q_vecs = q_rows * (q_cols / kVec);
  uint4 qv[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = tid + u * kThreads;
    const int j = e / (q_cols / kVec);
    const int d = (e - j * (q_cols / kVec)) * kVec;
    qv[u] = make_uint4(0u, 0u, 0u, 0u);
    if (e < q_vecs && j < C && d < dh) {
      qv[u] = *reinterpret_cast<const uint4*>(qg + j * p.q_c + d);
    }
  }

  // This block's share of the row's visible keys: equal shares of whole
  // 16-key tiles.  With index < 0 the first query sees no key and takes
  // all L of them.
  const long long first = p.index[b];
  const int n_keys = first < 0 ? p.length
                               : static_cast<int>(min(first + C,
                                 static_cast<long long>(p.length)));
  const int per = ((n_keys + kTile - 1) / kTile + S - 1) / S * kTile;
  const int k_begin = min(rank * per, n_keys);
  const int k_end = min(k_begin + per, n_keys);
  const int n_share = k_end - k_begin;
  const int n_pad = (n_share + kTile - 1) & ~(kTile - 1);  // rows staged
  const int nk = (n_pad + p.tile_keys - 1) / p.tile_keys;   // K tiles
  const int slot_bytes = p.tile_keys * p.row_stride;

  // Tile t < nk: K rows of the share from t * tile_keys; t >= nk: V rows
  // from (t - nk) * tile_keys.  Rows past the share are zeros.
  const T* kg = static_cast<const T*>(p.k) + b * p.k_b + h * p.k_h;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_b + h * p.v_h;
  const int chunks = p.row_bytes / 16;
  auto issue = [&](int t) {
    const int which = t >= nk;
    const int base = (t - which * nk) * p.tile_keys;
    const int rows = min(p.tile_keys, n_pad - base);
    unsigned char* dst = ring + (t % kSlots) * slot_bytes;
    const T* src0 = which ? vg : kg;
    const long long ld = which ? p.v_l : p.k_l;
    for (int e = tid; e < rows * chunks; e += kThreads) {
      const int r = e / chunks;
      const int c = e - r * chunks;
      const int key = k_begin + base + r;
      const bool ok = key < k_end;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          src0 + (ok ? key : k_begin) * ld);
      cp_async16(dst + r * p.row_stride + c * 16, src + c * 16, ok);
    }
  };
#pragma unroll 1
  for (int t = 0; t < kSlots; ++t) {
    if (t < 2 * nk) issue(t);
    cp_async_commit();
  }

  // While the copies fly: q to shared memory, and zeros in each ring row's
  // 16 bytes past the stored width (a head dim of 8 mod 16 reads 8 of
  // those columns of K into the last k16 step, against q's zero columns).
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = tid + u * kThreads;
    if (e < q_vecs) {
      const int j = e / (q_cols / kVec);
      const int d = (e - j * (q_cols / kVec)) * kVec;
      *reinterpret_cast<uint4*>(smem + p.q_off +
                                (j * p.q_ld + d) * sizeof(T)) = qv[u];
    }
  }
  if constexpr (kMma) {
    for (int r = tid; r < kSlots * p.tile_keys; r += kThreads) {
      *reinterpret_cast<uint4*>(ring + r * p.row_stride + p.row_bytes) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();

  const int k16 = (dh + 15) >> 4;
  const int g = lane >> 2, tq = lane & 3;
  const int ld = p.row_stride / static_cast<int>(sizeof(T));  // elements
  // q^T as the B operand of the score product, for the whole share.
  unsigned qb[kMaxDh / 16][2];
  if constexpr (kMma) {
    const bf16* qs = reinterpret_cast<const bf16*>(smem + p.q_off) +
                     (lane & 7) * p.q_ld + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int c = 0; c < kMaxDh / 16; ++c) {
      qb[c][0] = qb[c][1] = 0u;
      if (c < k16) ldsm2(qb[c][0], qb[c][1], qs + 16 * c);
    }
  }

  // (a) Scores of the share's keys, scaled and masked, into sc.
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kSlots - 1>();
    __syncthreads();  // tile t landed
    const unsigned char* slot = ring + (t % kSlots) * slot_bytes;
    const int base = t * p.tile_keys;
    const int rows = min(p.tile_keys, n_pad - base);
    if constexpr (kMma) {
      for (int sub = warp; sub * kTile < rows; sub += kWarps) {
        const bf16* ks = reinterpret_cast<const bf16*>(slot) +
                         (sub * kTile + (lane & 15)) * ld + (lane >> 4) * 8;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < kMaxDh / 16; ++c) {
          if (c < k16) {
            unsigned a[4];
            ldsm4(a, ks + 16 * c);
            mma16816(s, a, qb[c][0], qb[c][1]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * tq + (e & 1);
          const int kl = base + sub * kTile + g + 8 * (e >> 1);
          if (j < C) {
            sc[j * p.sc_ld + kl] =
                masked(s[e] * p.scale, k_begin + kl, first + j);
          }
        }
      }
    } else {
      const float* qs = reinterpret_cast<const float*>(smem + p.q_off);
      for (int e = tid; e < rows * C; e += kThreads) {
        const int j = e / rows;
        const int r = e - j * rows;
        const float* kr = reinterpret_cast<const float*>(slot +
                                                         r * p.row_stride);
        const float* qr = qs + j * p.q_ld;
        float a0 = 0.f, a1 = 0.f;
        for (int d = 0; d < dh; d += 8) {
          const float4 k0 = *reinterpret_cast<const float4*>(kr + d);
          const float4 k1 = *reinterpret_cast<const float4*>(kr + d + 4);
          const float4 x0 = *reinterpret_cast<const float4*>(qr + d);
          const float4 x1 = *reinterpret_cast<const float4*>(qr + d + 4);
          a0 = fmaf(x0.x, k0.x, a0);
          a1 = fmaf(x1.x, k1.x, a1);
          a0 = fmaf(x0.y, k0.y, a0);
          a1 = fmaf(x1.y, k1.y, a1);
          a0 = fmaf(x0.z, k0.z, a0);
          a1 = fmaf(x1.z, k1.z, a1);
          a0 = fmaf(x0.w, k0.w, a0);
          a1 = fmaf(x1.w, k1.w, a1);
        }
        const int kl = base + r;
        sc[j * p.sc_ld + kl] =
            masked((a0 + a1) * p.scale, k_begin + kl, first + j);
      }
    }
    if (t + kSlots < 2 * nk) {  // refill tile t's slot
      __syncthreads();
      issue(t + kSlots);
    }
    cp_async_commit();
  }
  __syncthreads();

  // The softmax across the cluster.  Thread tid takes keys tid, tid + 128,
  // ... of the share for every query; each query's values meet through
  // warp shuffles, then over the warps in warp order (wred), then over the
  // ranks through distributed shared memory.
  float* wred = red_sum + kQPad;  // [kWarps][kQPad]
  float m[C];
#pragma unroll
  for (int j = 0; j < C; ++j) m[j] = -INFINITY;
  for (int l = tid; l < n_share; l += kThreads) {
#pragma unroll
    for (int j = 0; j < C; ++j) m[j] = fmaxf(m[j], sc[j * p.sc_ld + l]);
  }
#pragma unroll
  for (int j = 0; j < C; ++j) m[j] = warp_max(m[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) wred[warp * kQPad + j] = m[j];
  }
  __syncthreads();
  if (tid < C) {
    float x = wred[tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x = fmaxf(x, wred[w * kQPad + tid]);
    red_max[tid] = x;
  }
  cluster.sync();  // 1: every rank's max is written

  // (b) The global max M over the ranks (every thread takes it), then
  // this share's sum of exp(s - M), with exp(s - M) kept in place of s.
  float4 rv[kMaxCluster][2];
  load_ranks<C>(cluster, red_max, S, rv);
  float sum[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    m[j] = lane_of(rv[0], j);
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r) {
      if (r < S) m[j] = fmaxf(m[j], lane_of(rv[r], j));
    }
    sum[j] = 0.f;
  }
  for (int l = tid; l < n_share; l += kThreads) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float x = sc[j * p.sc_ld + l];
      const float e = x == -INFINITY ? 0.f : expf(x - m[j]);
      sc[j * p.sc_ld + l] = e;
      sum[j] += e;
    }
  }
#pragma unroll
  for (int j = 0; j < C; ++j) sum[j] = warp_sum(sum[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) wred[warp * kQPad + j] = sum[j];
  }
  __syncthreads();
  if (tid < C) {
    float x = wred[tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x += wred[w * kQPad + tid];
    red_sum[tid] = x;
  }
  cluster.sync();  // 2: every rank's sum is written

  // (c) The global sum Z in rank order, then p = round(exp(s - M) / Z):
  // bf16 into the tensor-core operand (zeros past the share and for
  // queries past C), f32 in place (zeros past the share).
  load_ranks<C>(cluster, red_sum, S, rv);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    sum[j] = lane_of(rv[0], j);
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r) {
      if (r < S) sum[j] += lane_of(rv[r], j);
    }
  }
  for (int l = tid; l < n_pad; l += kThreads) {
#pragma unroll
    for (int j = 0; j < kQPad; ++j) {
      if (j < C) {
        const float pr =
            l < n_share ? round_to(sc[j * p.sc_ld + l] / sum[j],
                                   static_cast<const T*>(nullptr))
                        : 0.f;
        if constexpr (kMma) {
          reinterpret_cast<bf16*>(smem + p.p_off)[j * p.p_ld + l] =
              __float2bfloat16(pr);
        } else {
          sc[j * p.sc_ld + l] = pr;
        }
      } else if constexpr (kMma) {
        reinterpret_cast<bf16*>(smem + p.p_off)[j * p.p_ld + l] =
            __float2bfloat16(0.f);
      }
    }
  }
  __syncthreads();

  // The partial p . V of the share, f32.  Tensor cores: warp w takes the
  // head dims of m-tiles w and w + 4.  CUDA cores: thread tid takes
  // outputs tid, tid + 128, ... of the C x Dh.
  constexpr int kMTiles = kMaxDh / 16 / kWarps;
  constexpr int kOuts = kQPad * kMaxDh / kThreads;
  float o[kMTiles][4];
  float acc[kOuts];
  int p_at[kOuts], v_at[kOuts];  // output tid + 128 i: p row, V column
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    const int e = tid + i * kThreads;
    acc[i] = 0.f;
    p_at[i] = e / dh * p.sc_ld;
    v_at[i] = e % dh;
  }
  for (int t = nk; t < 2 * nk; ++t) {
    cp_async_wait<kSlots - 1>();
    __syncthreads();  // tile t landed
    const unsigned char* slot = ring + (t % kSlots) * slot_bytes;
    const int base = (t - nk) * p.tile_keys;
    const int rows = min(p.tile_keys, n_pad - base);
    if constexpr (kMma) {
      const bf16* ps = reinterpret_cast<const bf16*>(smem + p.p_off) +
                       (lane & 7) * p.p_ld + ((lane >> 3) & 1) * 8 + base;
      const bf16* vs = reinterpret_cast<const bf16*>(slot) +
                       ((lane & 7) + ((lane >> 4) << 3)) * ld +
                       ((lane >> 3) & 1) * 8;
      for (int sub = 0; sub * kTile < rows; ++sub) {
        unsigned pb0, pb1;
        ldsm2(pb0, pb1, ps + sub * kTile);
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) {
          const int mt = warp + kWarps * i;
          if (mt < k16) {
            unsigned a[4];
            ldsm4_t(a, vs + sub * kTile * ld + 16 * mt);
            mma16816(o[i], a, pb0, pb1);
          }
        }
      }
    } else {
      const float* prow = sc + base;
      for (int r = 0; r < rows; ++r) {
        const float* vr = reinterpret_cast<const float*>(slot +
                                                         r * p.row_stride);
#pragma unroll
        for (int i = 0; i < kOuts; ++i) {
          if (tid + i * kThreads < C * dh) {
            acc[i] = fmaf(prow[p_at[i] + r], vr[v_at[i]], acc[i]);
          }
        }
      }
    }
    if (t + kSlots < 2 * nk) {  // refill tile t's slot
      __syncthreads();
      issue(t + kSlots);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  if constexpr (kMma) {
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
      const int mt = warp + kWarps * i;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * mt + g + 8 * (e >> 1);
        const int j = 2 * tq + (e & 1);
        if (mt < k16 && j < C && d < dh) part[j * dh + d] = o[i][e];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kOuts; ++i) {
      const int e = tid + i * kThreads;
      if (e < C * dh) part[e] = acc[i];
    }
  }
  cluster.sync();  // 3: every rank's partial output is written

  // (d) Rank r sums its slice of the C x Dh output over the ranks, in rank
  // order, four elements a thread, and stores it in q's dtype.
  const int total = C * dh;
  const int slice = ((total + S - 1) / S + 3) & ~3;
  const int e_end = min((rank + 1) * slice, total);
  T* og = static_cast<T*>(p.out) + b * p.o_b + h * p.o_h;
  for (int e = rank * slice + 4 * tid; e < e_end; e += 4 * kThreads) {
    float4 x[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      x[r] = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part + e, min(r, S - 1)));
    }
    float4 y = x[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r) {
      if (r < S) {
        y.x += x[r].x;
        y.y += x[r].y;
        y.z += x[r].z;
        y.w += x[r].w;
      }
    }
    const int j = e / dh;
    T* o = og + j * p.o_c + (e - j * dh);
    store(o, y.x);
    store(o + 1, y.y);
    store(o + 2, y.z);
    store(o + 3, y.w);
  }
  cluster.sync();  // 4: no block leaves while a peer reads its memory
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The shared-memory layout of one launch (see Params).  The Python
// wrapper counts the same bytes to pick the split
// (ops/decode_attention.py::_smem_bytes) and raises at a new plan whose
// count differs from this one.
template <typename T, int C>
void make_layout(Params& p) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  p.row_bytes = p.head_dim * static_cast<int>(sizeof(T));
  p.row_stride = round_up(p.row_bytes, 16) + 16;
  int off = kSlots * p.tile_keys * p.row_stride;
  p.q_off = off;
  if (kMma) {
    p.q_ld = round_up(p.head_dim, 16) + 8;
    off += kQPad * p.q_ld * 2;
  } else {
    p.q_ld = p.head_dim + 4;
    off += C * p.q_ld * 4;
  }
  off = round_up(off, 16);
  p.sc_off = off;
  p.sc_ld = p.share_keys + 4;
  off += C * p.sc_ld * 4;
  p.p_off = off;
  p.p_ld = p.share_keys + 8;
  if (kMma) off += kQPad * p.p_ld * 2;
  off = round_up(off, 16);
  p.part_off = off;
  off += C * p.head_dim * 4;
  p.red_off = off;
  off += (2 + kWarps) * kQPad * 4;
  p.smem_bytes = off;
}

// Grid (S x H, B) in clusters of (S, 1, 1), on `stream`.
cudaLaunchConfig_t launch_config(const Params& p, cudaLaunchAttribute* attr,
                                 cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster * p.heads, p.batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The one launch of a call: plan p with its pointers set.
template <typename T, int C>
cudaError_t run(const Params& p, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, &attr, stream);
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, C>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// A plan: the launch's Params without pointers, and its instance.
struct Plan {
  Params p;
  cudaError_t (*run)(const Params&, cudaStream_t);
};

// Lay out the plan's shared memory; once per instantiation and device,
// allow the largest dynamic shared memory; check that a cluster of the
// plan's S blocks with its layout can be resident.
template <typename T, int C>
cudaError_t prepare(Plan& plan) {
  Params& p = plan.p;
  make_layout<T, C>(p);
  if (p.smem_bytes > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = decode_attention_kernel<T, C>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  static bool allowed[kMaxDevices] = {};
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, &attr, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  plan.run = run<T, C>;
  return cudaSuccess;
}

template <typename T>
cudaError_t prepare_chunk(int chunk, Plan& plan) {
#define PDT_CHUNK(c) \
  case c:            \
    return prepare<T, c>(plan);
  switch (chunk) {
    PDT_CHUNK(1) PDT_CHUNK(2) PDT_CHUNK(3) PDT_CHUNK(4)
    PDT_CHUNK(5) PDT_CHUNK(6) PDT_CHUNK(7) PDT_CHUNK(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PDT_CHUNK
}

}  // namespace

extern "C" {

// A plan for launches of one shape, or null with *err set.  dtype: 0 =
// float32, 1 = bfloat16.  chunk: C, 1..8.  cluster: S, 1..8 blocks per
// (row, head); share_keys >= 16 * ceil(ceil(L / 16) / S) and tile_keys,
// both multiples of 16 (ops/decode_attention.py::decode_split).  *smem
// gets the bytes of shared memory a block takes.  A plan is never freed:
// the wrapper keeps one per launch shape for the life of the process.
void* pdt_decode_plan(int dtype, int chunk, int batch, int num_heads,
                      int cache_len, int head_dim, int cluster,
                      int share_keys, int tile_keys, float scale,
                      long long q_b, long long q_c, long long q_h,
                      long long k_b, long long k_h, long long k_l,
                      long long v_b, long long v_h, long long v_l,
                      long long o_b, long long o_c, long long o_h, int* smem,
                      int* err) {
  *smem = 0;
  if (head_dim % 8 != 0 || head_dim < 8 || head_dim > kMaxDh ||
      cache_len < 1 || batch < 1 || batch > 65535 || num_heads < 1 ||
      cluster < 1 || cluster > kMaxCluster ||
      static_cast<long long>(cluster) * num_heads > INT32_MAX ||
      share_keys % kTile != 0 || tile_keys < kTile ||
      tile_keys % kTile != 0 ||
      static_cast<long long>(share_keys) * cluster <
          round_up(cache_len, kTile) ||
      (dtype != 0 && dtype != 1)) {
    *err = cudaErrorInvalidValue;
    return nullptr;
  }
  Plan* plan = new Plan{};
  Params& p = plan->p;
  p.batch = batch;
  p.heads = num_heads;
  p.length = cache_len;
  p.head_dim = head_dim;
  p.cluster = cluster;
  p.share_keys = share_keys;
  p.tile_keys = tile_keys;
  p.scale = scale;
  p.q_b = q_b;
  p.q_c = q_c;
  p.q_h = q_h;
  p.k_b = k_b;
  p.k_h = k_h;
  p.k_l = k_l;
  p.v_b = v_b;
  p.v_h = v_h;
  p.v_l = v_l;
  p.o_b = o_b;
  p.o_c = o_c;
  p.o_h = o_h;
  *err = dtype == 0 ? prepare_chunk<float>(chunk, *plan)
                    : prepare_chunk<bf16>(chunk, *plan);
  *smem = p.smem_bytes;
  if (*err != cudaSuccess) {
    delete plan;
    return nullptr;
  }
  return plan;
}

// The one launch of a call on a plan, on the caller's stream.
int pdt_decode_run(const void* plan, const void* q, const void* k,
                   const void* v, const void* index, void* out,
                   void* stream) {
  const Plan* pl = static_cast<const Plan*>(plan);
  Params p = pl->p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.index = static_cast<const int*>(index);
  p.out = out;
  return pl->run(p, static_cast<cudaStream_t>(stream));
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
