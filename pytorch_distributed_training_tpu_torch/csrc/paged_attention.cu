// Attention over the paged KV block pool, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of pytorch_distributed_training_tpu/ops/
// pallas_attention.py:
//   paged_decode_attention (_paged_decode_kernel)        C == 1
//   _paged_multi_call      (_paged_decode_kernel_multi)  1 <= C <= 64, the
//     kernel behind paged_decode_attention_multi (the speculative verify
//     chunk) and paged_prefill_attention (chunked prefill)
// with one kernel whose chunk width C is a runtime argument.  Query j of
// batch row b sits at logical position index[b] + j and attends keys
// 0..index[b]+j; logical position p of row b lives in physical block
// table[b, p / block_size] at offset p % block_size.  The table arrives
// pre-clamped to real blocks (the idle sentinel entries point at some real
// block whose keys the mask never admits).  An index >= table_width *
// block_size is the idle-row sentinel: it unmasks the whole row, and the
// caller discards that row's output.
//
// Storage kinds (template parameter S): f32 or bf16 K/V in q's dtype, or
// the quantized pool (--serve-kv-dtype): int8 payload, or int4 nibbles
// packed two per byte (low nibble = even column, two's complement), each
// with one bf16 scale per (block, head, position).  Quantized values are
// dequantized when read from shared memory, per element, exactly as
// comm/compress.py's dequantize_kv does (f32(payload) * f32(scale)).
//
// Math, copied from the TPU kernels so results agree to rounding: s = q.k
// in f32, then * scale; masked scores are -1e30 and a masked p is exactly
// 0; an online softmax with an f32 running max m, denominator l and
// accumulator acc.  For native bf16 storage p is rounded to bf16 before
// the PV product (l sums the unrounded p); quantized and f32 tiles keep p
// in f32.  The output is acc / l in q's dtype, and exactly 0 for a query
// with no live key.
//
// Bound on this card: bytes.  At the serving shapes (B 8, H 12, Dh 64,
// blocks of 16, index [0, 5, 100, 511, 1000, 1023, 1024, 300]) a bf16 call
// must read 12.3 MB of visible K/V (3.7 us at 3.35 TB/s; int8 6.4 MB, 1.9
// us) and does ~4 flops per K/V element read at C = 1 (64 at C = 16): far
// below the ~300 flops a byte where the H100 turns compute bound.  The
// PR 2 design walked each row's keys in one block per (head, row), 32 keys
// a step with one tile in flight: 32 dependent steps for the longest rows,
// 76.8 us at C = 1.  This design puts the bytes in flight at once:
//
//   - The key range is split across blocks (flash-decoding).  The grid is
//     (partition, head, row); a partition holds part_keys keys (a multiple
//     of 64, at most 256), and the host picks the number of partitions
//     from the shapes and the SM count alone (ops/paged_attention.py::
//     paged_split: about 4 blocks an SM, 6 partitions of 192 keys at the
//     serving shapes on the H100's 132 SMs), without reading index.  A block whose partition starts past its
//     row's last visible key exits at once.  Each live block writes an f32
//     partial (m, l, unnormalised acc) for its queries to a scratch buffer
//     the wrapper allocates, and paged_combine_kernel merges a row's
//     partials: m = max m_i, l = sum e^(m_i - m) l_i, acc = sum
//     e^(m_i - m) acc_i, every sum in a fixed order, so a repeated call
//     gives the same bits.  For query j it reads only the partitions that
//     hold a key query j sees, so a dead block need not write anything.
//     The combine is a plain second launch on the same stream.  Every call
//     runs both grids, one partition or many: there is one output path.
//   - One block of 4 warps takes every query of a (row, head) partition
//     (C <= 64).  At C <= 16 the 4 warps split each ring stage's keys, 16
//     keys a warp; at C <= 32 two warps per 16-query tile; above, one warp
//     per 16-query tile.  Each warp keeps its own (m, l, acc), and the
//     block merges its warps in shared memory, in warp order, at the end.
//   - K/V stay at their stored width in shared memory: a ring of 3 stages
//     of 64 keys (32 for f32) filled by cp.async (16-byte copies where a
//     stored row is a multiple of 16 bytes, else 8 or 4), every row looked
//     up through the table slice the block keeps in shared memory, rows
//     past the last visible key zero-filled.  All 3 stages are issued at
//     once, so a 192-key partition is one round trip to memory; a longer
//     one refills a stage's slot as soon as the warps are done with it.
//     The bf16 scales of the first stages are loaded with them; a later
//     stage's go into a register when it is issued and into shared memory
//     one stage later.  q is read with 16-byte loads when
//     its rows are aligned, all of a thread's loads before its stores.
//   - bf16 storage runs both products on the tensor cores: mma.sync
//     m16n8k16 bf16 -> f32 with ldmatrix operand loads, q's fragments held
//     in registers for the whole loop, the score tile and the accumulator
//     in register fragments, p rounded to bf16 in place into the PV
//     product's A fragment.  Query rows past C and head dims that are 8 mod
//     16 (e.g. 40) are zeros in shared memory.  f32 and quantized storage
//     keep f32 products on the CUDA cores (a dequantized int8 x bf16-scale
//     value is not a bf16 value), with the warp's state in shared memory
//     and rolled loops over queries (CoreWarp).
//
// Measured with chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W; PERF.md has
// the table): bf16 C = 1 and C = 16 under SDPA on the pre-gathered cache.
// Left for later work: the call is still ~7x its byte bound (one round
// trip for index, table and q before the K/V can be addressed, then the
// K/V trip, the block merge and the combine); int8 at C >= 5 is slower than
// bf16, its CUDA-core products being latency-bound with 4 warps a block;
// C = 64 reads each K/V byte once but walks a partition's keys with one
// warp per 16 queries.
//
// Interface: plain C, loaded with ctypes (ops/paged_attention.py).  All
// strides are in elements of the stored type; K and V share one layout,
// and so do their scales.  Both launches go on the caller's stream and the
// function returns the first cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kSub = 16;          // keys per warp step
constexpr int kQRows = 16;        // queries per warp
constexpr int kMaxChunk = kWarps * kQRows;
constexpr int kMaxDh = 128;
constexpr int kMaxTable = 1024;   // MAX_TABLE_WIDTH of the wrapper
constexpr int kPartAlign = 64;    // part_keys is a multiple of this
constexpr int kPLd = kSub + 4;    // row stride of a warp's p tile (floats)
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

enum Storage { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt4 = 3 };

template <int S>
struct Geometry {
  static constexpr bool kQuant = S == kInt8 || S == kInt4;
  static constexpr bool kMma = S == kBF16;
  static constexpr int kStageKeys = S == kF32 ? 32 : 64;
  static constexpr int kSubTiles = kStageKeys / kSub;
  static constexpr int kBits = S == kF32 ? 32 : S == kBF16 ? 16 : S == kInt8 ? 8 : 4;
};

static_assert(2 * Geometry<kInt8>::kStageKeys == kThreads,
              "one scale of a stage per thread");
static_assert(kPartAlign % Geometry<kBF16>::kStageKeys == 0 &&
              kPartAlign % Geometry<kF32>::kStageKeys == 0,
              "partitions hold whole stages");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const unsigned short* k_scale;  // bf16 bits; null unless quantized
  const unsigned short* v_scale;
  const int* table;
  const int* index;
  void* out;
  float* partials;  // (m, l, acc) per partition
  int batch, heads, chunk, head_dim, block_size, table_width, num_blocks;
  int num_parts, part_keys;
  float scale;
  long long q_b, q_c, q_h;
  long long kv_n, kv_h, kv_l;  // payload strides (K and V alike)
  long long s_n, s_h;          // scale strides; the position stride is 1
  long long t_b;               // table row stride
  long long o_b, o_c, o_h;
  // Shared-memory layout in bytes (make_layout).
  int q_vec;       // q's rows are 16-byte aligned: vector loads
  int row_bytes;   // one stored K or V row
  int row_stride;  // its stride in the ring (16-byte multiple + 16)
  int granule;     // bytes per cp.async
  int q_off, q_ld;  // the q tile and its row stride in elements
  int scale_off;   // kStages x (K, V) x stage keys f32 scales (quantized)
  int p_off;       // per-warp p tiles and alphas (CUDA-core path)
  int ml_off;      // per-warp m and l: kWarps x 16 each
  int acc_off;     // per-warp acc: kWarps x 16 x (kDh + 4)
  int tbl_off;     // the partition's table slice
  int smem_bytes;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float bf16_bits(unsigned short bits) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `bytes` (16, 8 or 4) global -> shared in flight; with ok false the source
// size is 0 and the bytes arrive as zeros (src must still be valid).
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool ok) {
  const unsigned d = smem_addr(dst);
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 8 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n groups of this thread's copies are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
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

// Two f32 C fragments (keys 0-7, 8-15) rounded to the bf16 A fragment of
// one k16 step.
__device__ __forceinline__ void to_a(unsigned (&a)[4], const float (&c0)[4],
                                     const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Eight stored values of a row from column d, dequantized to f32.
template <int S>
__device__ __forceinline__ void load8(const unsigned char* row, int d,
                                      float sc, float (&f)[8]) {
  if constexpr (S == kF32) {
    const float4 a = *reinterpret_cast<const float4*>(row + 4 * d);
    const float4 b = *reinterpret_cast<const float4*>(row + 4 * d + 16);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else if constexpr (S == kInt8) {
    const uint2 x = *reinterpret_cast<const uint2*>(row + d);
    const int8_t* q = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = static_cast<float>(q[e]) * sc;
  } else {
    const unsigned x = *reinterpret_cast<const unsigned*>(row + d / 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lo = (x >> (8 * e)) & 0xF;
      const int hi = (x >> (8 * e + 4)) & 0xF;
      f[2 * e] = static_cast<float>(lo > 7 ? lo - 16 : lo) * sc;
      f[2 * e + 1] = static_cast<float>(hi > 7 ? hi - 16 : hi) * sc;
    }
  }
}

// Columns d and d + 1 of a row (d even), dequantized to f32.
template <int S>
__device__ __forceinline__ float2 load2(const unsigned char* row, int d,
                                        float sc) {
  if constexpr (S == kF32) {
    return *reinterpret_cast<const float2*>(row + 4 * d);
  } else if constexpr (S == kInt8) {
    const char2 x = *reinterpret_cast<const char2*>(row + d);
    return make_float2(static_cast<float>(x.x) * sc,
                       static_cast<float>(x.y) * sc);
  } else {
    const int byte = row[d / 2];
    const int lo = byte & 0xF;
    const int hi = byte >> 4;
    return make_float2(static_cast<float>(lo > 7 ? lo - 16 : lo) * sc,
                       static_cast<float>(hi > 7 ? hi - 16 : hi) * sc);
  }
}

// One warp's 16 queries on the tensor cores (bf16 storage).  Fragment
// layout (g = lane / 4, t = lane % 4): a C fragment c[e] of a 16 x 8 tile
// holds row g + 8 (e / 2), column 2 t + (e % 2).
template <int kDh>
struct MmaWarp {
  static constexpr int kK16 = kDh / 16;
  unsigned qa[kK16][4];
  float o[2 * kK16][4];
  float m[2], l[2];
  float* acc_out;  // the warp's rows of the merge area (on the ring)
  float* m_out;
  float* l_out;

  __device__ __forceinline__ void init(const Params& p,
                                       const unsigned char* q_s, int q0,
                                       int nq, int lane, float* acc_w,
                                       float* m_w, float* l_w) {
    acc_out = acc_w;
    m_out = m_w;
    l_out = l_w;
#pragma unroll
    for (int j = 0; j < 2 * kK16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
    }
    const int k16 = (p.head_dim + 15) >> 4;
    const bf16* qs = reinterpret_cast<const bf16*>(q_s) + q0 * p.q_ld +
                     (lane & 15) * p.q_ld + (lane >> 4) * 8;
#pragma unroll
    for (int c = 0; c < kK16; ++c) {
      qa[c][0] = qa[c][1] = qa[c][2] = qa[c][3] = 0u;
      if (nq > 0 && c < k16) ldsm4(qa[c], qs + 16 * c);
    }
  }

  // Keys kb .. kb + 15: rows `sub * 16` on of the stage's K and V tiles.
  __device__ __forceinline__ void step(const Params& p,
                                       const unsigned char* kst,
                                       const unsigned char* vst, const float*,
                                       int sub, int kb, long long first,
                                       int q0, int, int span, int lane,
                                       float*, float*, const unsigned char*) {
    const int ld = p.row_stride >> 1;
    const bf16* ks = reinterpret_cast<const bf16*>(kst) + sub * kSub * ld;
    const bf16* vs = reinterpret_cast<const bf16*>(vst) + sub * kSub * ld;
    const int off_b = ((lane & 7) + ((lane >> 4) << 3)) * ld +
                      ((lane >> 3) & 1) * 8;
    const int off_bt = ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld +
                       (lane >> 4) * 8;
    const int k16 = (p.head_dim + 15) >> 4;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < kK16; ++c) {
      if (c < k16) {
        unsigned bb[4];
        ldsm4(bb, ks + 16 * c + off_b);
        mma16816(s[0], qa[c], bb[0], bb[1]);
        mma16816(s[1], qa[c], bb[2], bb[3]);
      }
    }
    const int g = lane >> 2, t = lane & 3;
    unsigned live = 0u;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + 8 * n + 2 * t + (e & 1);
        const long long qpos = first + q0 + g + 8 * (e >> 1);
        const bool ok = key < span && key <= qpos;
        s[n][e] = ok ? s[n][e] * p.scale : kNegInf;
        live |= (ok ? 1u : 0u) << (4 * n + e);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = (live >> (4 * n + e)) & 1u
                             ? expf(s[n][e] - m[e >> 1]) : 0.f;
        s[n][e] = pr;
        sum[e >> 1] += pr;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
#pragma unroll
    for (int j = 0; j < 2 * kK16; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    unsigned pa[4];
    to_a(pa, s[0], s[1]);
#pragma unroll
    for (int c = 0; c < kK16; ++c) {
      if (c < k16) {
        unsigned bb[4];
        ldsm4_t(bb, vs + 16 * c + off_bt);
        mma16816(o[2 * c], pa, bb[0], bb[1]);
        mma16816(o[2 * c + 1], pa, bb[2], bb[3]);
      }
    }
  }

  // The warp's state into its rows of the merge area: acc [16][kDh + 4],
  // m [16], l [16].
  __device__ __forceinline__ void to_merge(int lane) {
    float* acc = acc_out;
    float* mm = m_out;
    float* ll = l_out;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
    }
#pragma unroll
    for (int j = 0; j < 2 * kK16; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(acc + g * (kDh + 4) + col) =
          make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(acc + (g + 8) * (kDh + 4) + col) =
          make_float2(o[j][2], o[j][3]);
    }
    if (t == 0) {
      mm[g] = m[0];
      mm[g + 8] = m[1];
      ll[g] = l[0];
      ll[g + 8] = l[1];
    }
  }
};

// One warp's queries on the CUDA cores (f32 and quantized storage), with
// its state in shared memory: acc [16][kDh + 4], m [16], l [16].  The
// loops over queries stay rolled: the kernel's code is fetched cold on
// every call (a serving step evicts it from L2), so its size is time.
//   scores: lane = (key j = lane % 16, g = lane / 16) dots the 8-dim
//     chunks g, g + 2, ... of key j with four queries at a time (one
//     dequantization feeds four queries), the halves' sums joined by a
//     shuffle;
//   softmax: lane = (query i = lane % 16, g) takes 8 of the 16 keys of
//     query i, the two halves joined by one shuffle;
//   PV: lane takes head-dim pairs 2 pd, 2 pd + 1 (pd = lane, lane + 32),
//     dequantizes V of the 16 keys once and updates every query, two
//     queries and two chains of keys at a time.
template <int S, int kDh>
struct CoreWarp {
  float* acc;
  float* m;
  float* l;

  __device__ __forceinline__ void init(const Params&, const unsigned char*,
                                       int, int, int lane, float* acc_w,
                                       float* m_w, float* l_w) {
    acc = acc_w;
    m = m_w;
    l = l_w;
    for (int e = lane; e < kQRows * (kDh + 4); e += 32) acc[e] = 0.f;
    if (lane < kQRows) {
      m[lane] = kNegInf;
      l[lane] = 0.f;
    }
    __syncwarp();
  }

  __device__ __forceinline__ void step(const Params& p,
                                       const unsigned char* kst,
                                       const unsigned char* vst,
                                       const float* scs, int sub, int kb,
                                       long long first, int q0, int nq,
                                       int span, int lane, float* p_s,
                                       float* alpha_s,
                                       const unsigned char* q_s) {
    constexpr bool kQuant = Geometry<S>::kQuant;
    constexpr int kKeys = Geometry<S>::kStageKeys;
    const int j = lane & 15, g = lane >> 4;
    const int dh = p.head_dim;
    const unsigned char* krow = kst + (sub * kSub + j) * p.row_stride;
    const float ksc = kQuant ? scs[sub * kSub + j] : 1.f;
    const float* qs = reinterpret_cast<const float*>(q_s) + q0 * p.q_ld;
    const int key = kb + j;
    for (int i0 = 0; i0 < nq; i0 += 4) {  // the same for every lane
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int d = 8 * g; d < dh; d += 16) {
        float kf[8];
        load8<S>(krow, d, ksc, kf);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (i0 + r < nq) {
            const float* qr = qs + (i0 + r) * p.q_ld + d;
            const float4 a = *reinterpret_cast<const float4*>(qr);
            const float4 b = *reinterpret_cast<const float4*>(qr + 4);
            float x = dot[r];
            x = fmaf(a.x, kf[0], x);
            x = fmaf(a.y, kf[1], x);
            x = fmaf(a.z, kf[2], x);
            x = fmaf(a.w, kf[3], x);
            x = fmaf(b.x, kf[4], x);
            x = fmaf(b.y, kf[5], x);
            x = fmaf(b.z, kf[6], x);
            x = fmaf(b.w, kf[7], x);
            dot[r] = x;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float full = dot[r] + __shfl_xor_sync(kFull, dot[r], 16);
        const int i = i0 + r;
        if (g == 0 && i < nq) {
          const bool ok = key < span && key <= first + q0 + i;
          p_s[i * kPLd + j] = ok ? full * p.scale : kNegInf;
        }
      }
    }
    __syncwarp();
    // Softmax: lane = (query i = lane % 16, g) takes keys 8 g .. 8 g + 7 of
    // query i; the halves meet through one shuffle.
    {
      const int i = lane & 15;
      const bool on = i < nq;
      float* pr = p_s + i * kPLd + 8 * g;
      float sc[8];
      float mx = kNegInf;
      if (on) {
        const float4 a = *reinterpret_cast<const float4*>(pr);
        const float4 b = *reinterpret_cast<const float4*>(pr + 4);
        sc[0] = a.x; sc[1] = a.y; sc[2] = a.z; sc[3] = a.w;
        sc[4] = b.x; sc[5] = b.y; sc[6] = b.z; sc[7] = b.w;
#pragma unroll
        for (int k = 0; k < 8; ++k) mx = fmaxf(mx, sc[k]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
      const float m_old = on ? m[i] : kNegInf;
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      if (on) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          sc[k] = sc[k] == kNegInf ? 0.f : expf(sc[k] - m_new);  // masked: 0
          sum += sc[k];
        }
        *reinterpret_cast<float4*>(pr) = make_float4(sc[0], sc[1], sc[2], sc[3]);
        *reinterpret_cast<float4*>(pr + 4) =
            make_float4(sc[4], sc[5], sc[6], sc[7]);
      }
      sum += __shfl_xor_sync(kFull, sum, 16);
      if (on && g == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[i] = alpha;
        m[i] = m_new;
        l[i] = alpha * l[i] + sum;
      }
    }
    __syncwarp();
    const unsigned char* vbase = vst + sub * kSub * p.row_stride;
    for (int pd = lane; 2 * pd < dh; pd += 32) {
      float2 v[kSub];
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        v[jj] = load2<S>(vbase + jj * p.row_stride, 2 * pd,
                         kQuant ? scs[kKeys + sub * kSub + jj] : 1.f);
      }
      // Two queries an iteration, each over two chains of keys.
      for (int i = 0; i < nq; i += 2) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (i + u < nq) {
            float2* ap = reinterpret_cast<float2*>(
                acc + (i + u) * (kDh + 4) + 2 * pd);
            const float al = alpha_s[i + u];
            const float* pr = p_s + (i + u) * kPLd;
            float2 a0 = *ap, a1 = make_float2(0.f, 0.f);
            a0.x *= al;
            a0.y *= al;
#pragma unroll
            for (int jj = 0; jj < kSub; jj += 4) {
              const float4 pp = *reinterpret_cast<const float4*>(pr + jj);
              a0.x = fmaf(pp.x, v[jj].x, a0.x);
              a0.y = fmaf(pp.x, v[jj].y, a0.y);
              a1.x = fmaf(pp.y, v[jj + 1].x, a1.x);
              a1.y = fmaf(pp.y, v[jj + 1].y, a1.y);
              a0.x = fmaf(pp.z, v[jj + 2].x, a0.x);
              a0.y = fmaf(pp.z, v[jj + 2].y, a0.y);
              a1.x = fmaf(pp.w, v[jj + 3].x, a1.x);
              a1.y = fmaf(pp.w, v[jj + 3].y, a1.y);
            }
            *ap = make_float2(a0.x + a1.x, a0.y + a1.y);
          }
        }
      }
    }
    __syncwarp();  // p_s and alpha_s are rewritten by the next step
  }

  // The state already lies where the block's merge reads it.
  __device__ __forceinline__ void to_merge(int) {}
};

template <int S, int kDh>
struct WarpOf {
  using type = CoreWarp<S, kDh>;
};
template <int kDh>
struct WarpOf<kBF16, kDh> {
  using type = MmaWarp<kDh>;
};

// q (C x Dh of one row and head) into shared memory: bf16 rows padded to a
// multiple of 16 columns for the tensor-core path, f32 otherwise; rows up
// to the next multiple of 16 past C are zeros.  16-byte loads when the
// host found q's rows aligned (q_vec), four at a time before any store: a
// prefill chunk of 64 bf16 queries is one round trip to memory.
template <int S, typename TQ>
__device__ __forceinline__ void load_q(const Params& p, unsigned char* dst,
                                       int b, int h) {
  constexpr bool kMma = Geometry<S>::kMma;
  const TQ* q = static_cast<const TQ*>(p.q) + b * p.q_b + h * p.q_h;
  const int rows = (p.chunk + 15) & ~15;
  const int cols = kMma ? (p.head_dim + 15) & ~15 : p.head_dim;
  const int vec = p.q_vec ? 16 / static_cast<int>(sizeof(TQ)) : 1;
  const int vcols = cols / vec;
  const int total = rows * vcols;
  constexpr int kBatch = 4;
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * kThreads) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int i = e / vcols;
      const int d = (e - i * vcols) * vec;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < total && i < p.chunk && d < p.head_dim) {
        const TQ* src = q + i * p.q_c + d;
        if (vec > 1) {
          raw[u] = *reinterpret_cast<const uint4*>(src);
        } else {
          *reinterpret_cast<TQ*>(&raw[u]) = *src;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= total) continue;
      const int i = e / vcols;
      const int d = (e - i * vcols) * vec;
      const TQ* x = reinterpret_cast<const TQ*>(&raw[u]);
      for (int k = 0; k < vec; ++k) {
        if constexpr (kMma) {
          reinterpret_cast<bf16*>(dst)[i * p.q_ld + d + k] = x[k];
        } else {
          reinterpret_cast<float*>(dst)[i * p.q_ld + d + k] = to_float(x[k]);
        }
      }
    }
  }
}

template <int S, typename TQ, int kDh>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Params p) {
  using Gm = Geometry<S>;
  constexpr int kKeys = Gm::kStageKeys;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* sc_s = reinterpret_cast<float*>(smem + p.scale_off);
  int* tbl = reinterpret_cast<int*>(smem + p.tbl_off);
  const unsigned char* q_s = smem + p.q_off;

  const int part = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bs = p.block_size, dh = p.head_dim, C = p.chunk;
  const int span = p.table_width * bs;
  const int k_begin = part * p.part_keys;
  const int k_stop = min(k_begin + p.part_keys, span);

  // The index, the partition's table slice and q are read together.
  const long long first = p.index[b];
  const int* trow = p.table + b * p.t_b;
  const int t0 = k_begin / bs;
  const int n_tbl = (k_stop - 1) / bs - t0 + 1;
  for (int i = tid; i < n_tbl; i += kThreads) {
    tbl[i] = min(max(trow[t0 + i], 0), p.num_blocks - 1);
  }
  load_q<S, TQ>(p, smem + p.q_off, b, h);
  if constexpr (Gm::kMma) {
    // Zero the ring rows' padding: a head dim of 8 mod 16 reads 8 of
    // these columns into the last k16 step.
    const int per_row = (p.row_stride - p.row_bytes) / 16;
    for (int e = tid; e < kStages * 2 * kKeys * per_row; e += kThreads) {
      const int r = e / per_row;
      *reinterpret_cast<uint4*>(ring + r * p.row_stride + p.row_bytes +
                                (e - r * per_row) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();

  // Keys the block's last query sees, within the table span.
  const int n_keys = static_cast<int>(
      min(static_cast<long long>(span), max(first + C, 0LL)));
  if (k_begin >= n_keys) return;  // the combine reads no partial of it
  const int k_end = min(k_stop, n_keys);
  const int n_st = (k_end - k_begin + kKeys - 1) / kKeys;
  const int stage_bytes = 2 * kKeys * p.row_stride;

  // Stage s: the K rows then the V rows of keys k_begin + s * kKeys ..,
  // at the stored width.
  auto issue = [&](int s) {
    unsigned char* dst = ring + (s % kStages) * stage_bytes;
    const int base = k_begin + s * kKeys;
    const int chunks = p.row_bytes / p.granule;
    for (int e = tid; e < 2 * kKeys * chunks; e += kThreads) {
      const int row = e / chunks;
      const int c = e - row * chunks;
      const int which = row >= kKeys;
      const int pos = base + row - which * kKeys;
      const bool ok = pos < k_end;
      const int pp = ok ? pos : k_begin;
      const int lb = pp / bs;
      const long long elem = tbl[lb - t0] * p.kv_n + h * p.kv_h +
                             (pp - lb * bs) * p.kv_l;
      const unsigned char* src =
          static_cast<const unsigned char*>(which ? p.v : p.k) +
          elem * (Gm::kBits >= 8 ? Gm::kBits / 8 : 1) + c * p.granule;
      cp_async(dst + row * p.row_stride + c * p.granule, src, p.granule, ok);
    }
  };
  // This thread's scale of stage s: K for tid < kKeys, else V.
  auto scale_of = [&](int s) -> float {
    const int which = tid >= kKeys;
    const int pos = k_begin + s * kKeys + tid - which * kKeys;
    if (pos >= k_end) return 0.f;
    const int lb = pos / bs;
    const long long at = tbl[lb - t0] * p.s_n + h * p.s_h + (pos - lb * bs);
    return bf16_bits((which ? p.v_scale : p.k_scale)[at]);
  };

  // The first kStages stages go in flight at once (a partition of up to
  // kStages stages is read in one round trip), with their scales.
#pragma unroll 1
  for (int s = 0; s < kStages; ++s) {
    if (s < n_st) issue(s);
    cp_async_commit();
  }
  float held = 0.f;  // the scales of stage s + 3, loaded in iteration s
  if constexpr (Gm::kQuant) {
    float first_sc[kStages];
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      first_sc[s] = s < n_st ? scale_of(s) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) sc_s[s * 2 * kKeys + tid] = first_sc[s];
  }

  // Warp roles: G warps per 16-query tile, each on its own sub-tiles.
  const int n_qt = (C + kQRows - 1) / kQRows;
  const int G = n_qt == 1 ? 4 : (n_qt == 2 ? 2 : 1);
  const int qt = warp / G, kg = warp - qt * G;
  const int q0 = kQRows * qt;
  const int nq = max(0, min(kQRows, C - q0));
  const long long warp_last = nq > 0 ? first + q0 + nq - 1 : LLONG_MIN;
  float* p_s = reinterpret_cast<float*>(smem + p.p_off) + warp * kQRows * kPLd;
  float* alpha_s = reinterpret_cast<float*>(smem + p.p_off) +
                   kWarps * kQRows * kPLd + warp * kQRows;
  constexpr int kMld = kDh + 4;
  float* m_acc = reinterpret_cast<float*>(smem + p.acc_off);
  float* m_m = reinterpret_cast<float*>(smem + p.ml_off);
  float* m_l = m_m + kWarps * kQRows;
  typename WarpOf<S, kDh>::type w;
  w.init(p, q_s, q0, nq, lane, m_acc + warp * kQRows * kMld,
         m_m + warp * kQRows, m_l + warp * kQRows);

  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<kStages - 1>();
    __syncthreads();  // stage s landed
    const unsigned char* kst = ring + (s % kStages) * stage_bytes;
    const unsigned char* vst = kst + kKeys * p.row_stride;
    const float* scs = sc_s + (s % kStages) * 2 * kKeys;
    for (int sub = kg; sub < Gm::kSubTiles; sub += G) {
      const int kb = k_begin + s * kKeys + sub * kSub;
      if (kb >= k_end || kb > warp_last) continue;  // the same for the warp
      w.step(p, kst, vst, scs, sub, kb, first, q0, nq, span, lane, p_s,
             alpha_s, q_s);
    }
    if (s + kStages < n_st) {  // refill stage s's slot
      __syncthreads();
      issue(s + kStages);
    }
    cp_async_commit();
    if constexpr (Gm::kQuant) {
      // Stage s + 2's scales (loaded in iteration s - 1) into the slot of
      // stage s - 1, read from iteration s + 2 on; then stage s + 3's.
      if (s >= 1 && s + 2 < n_st) {
        sc_s[((s + 2) % kStages) * 2 * kKeys + tid] = held;
      }
      held = s + kStages < n_st ? scale_of(s + kStages) : 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring may become the merge area (tensor cores)
  w.to_merge(lane);
  __syncthreads();

  // Merge the G warps of each query tile in warp order.  First, per
  // query: m = max m_w, the weights e^(m_w - m) (kept in place of m_w),
  // and l; then acc = sum of weighted acc_w, to this partition's
  // partial.
  const long long bh = static_cast<long long>(b) * p.heads + h;
  const long long pidx0 = (bh * p.num_parts + part) * C;
  const long long ml0 =
      static_cast<long long>(p.batch) * p.heads * p.num_parts * C * dh;
  if (tid < C) {
    const int wt = (tid / kQRows) * G, r = tid % kQRows;
    float mm = kNegInf;
    for (int k = 0; k < G; ++k) mm = fmaxf(mm, m_m[(wt + k) * kQRows + r]);
    float l = 0.f;
    for (int k = 0; k < G; ++k) {
      const float wgt = expf(m_m[(wt + k) * kQRows + r] - mm);
      m_m[(wt + k) * kQRows + r] = wgt;
      l += wgt * m_l[(wt + k) * kQRows + r];
    }
    p.partials[ml0 + (pidx0 + tid) * 2] = mm;
    p.partials[ml0 + (pidx0 + tid) * 2 + 1] = l;
  }
  __syncthreads();
  const int rows_per_pass = kThreads / dh;
  const int d = tid % dh;
  if (tid < rows_per_pass * dh) {
#pragma unroll 4
    for (int i = tid / dh; i < C; i += rows_per_pass) {
      const int wt = (i / kQRows) * G, r = i % kQRows;
      float a = 0.f;
      for (int k = 0; k < G; ++k) {
        a = fmaf(m_m[(wt + k) * kQRows + r],
                 m_acc[((wt + k) * kQRows + r) * kMld + d], a);
      }
      p.partials[(pidx0 + i) * dh + d] = a;
    }
  }
}

// Merge each query's partials over the partitions that hold a key the
// query sees (none gives 0).  One warp a query: lanes take the partitions'
// (m, l) for the max and the denominator, then head dims for acc, summed
// over partitions in order; every sum has a fixed order.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  const int C = p.chunk, dh = p.head_dim;
  const long long span = static_cast<long long>(p.table_width) * p.block_size;
  if (i >= C) return;
  const long long first = p.index[b];
  const long long last = min(first + i, span - 1);
  const int n = last < 0 ? 0 : static_cast<int>(last / p.part_keys) + 1;
  const long long row = (static_cast<long long>(b) * p.heads + h) *
                            p.num_parts * C + i;
  const float* ml = p.partials +
                    static_cast<long long>(p.batch) * p.heads * p.num_parts *
                        C * dh + row * 2;
  const float* acc = p.partials + row * dh;
  const long long ml_step = 2LL * C, acc_step = static_cast<long long>(C) * dh;
  float m = kNegInf;
  for (int k = lane; k < n; k += 32) m = fmaxf(m, ml[k * ml_step]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  }
  float l = 0.f;
  for (int k = lane; k < n; k += 32) {
    l += expf(ml[k * ml_step] - m) * ml[k * ml_step + 1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(kFull, l, off);
  float a[kMaxDh / 32] = {};
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float w = expf(ml[k * ml_step] - m);
#pragma unroll
    for (int u = 0; u < kMaxDh / 32; ++u) {
      const int d = lane + 32 * u;
      if (d < dh) a[u] = fmaf(w, acc[k * acc_step + d], a[u]);
    }
  }
  TQ* out = static_cast<TQ*>(p.out) + b * p.o_b + i * p.o_c + h * p.o_h;
  const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
  for (int u = 0; u < kMaxDh / 32; ++u) {
    const int d = lane + 32 * u;
    if (d < dh) store(out + d, a[u] / l_safe);
  }
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The shared-memory layout of one launch (see Params).
template <int S, int kDh>
void make_layout(Params& p) {
  using Gm = Geometry<S>;
  p.row_bytes = p.head_dim * Gm::kBits / 8;
  p.granule = p.row_bytes % 16 == 0 ? 16 : (p.row_bytes % 8 == 0 ? 8 : 4);
  p.row_stride = round_up(p.row_bytes, 16) + 16;
  const int ring = kStages * 2 * Gm::kStageKeys * p.row_stride;
  const int acc = kWarps * kQRows * (kDh + 4) * 4;
  // The tensor-core warps keep acc in registers and merge on the ring.
  int off = round_up(Gm::kMma && acc > ring ? acc : ring, 16);
  p.acc_off = 0;
  p.q_off = off;
  p.q_ld = Gm::kMma ? round_up(p.head_dim, 16) + 8 : p.head_dim + 4;
  off += round_up(round_up(p.chunk, 16) * p.q_ld * (Gm::kMma ? 2 : 4), 16);
  p.scale_off = off;
  if (Gm::kQuant) off += kStages * 2 * Gm::kStageKeys * 4;
  p.p_off = off;
  if (!Gm::kMma) off += kWarps * kQRows * (kPLd + 1) * 4;
  p.ml_off = off;
  off += 2 * kWarps * kQRows * 4;
  if (!Gm::kMma) {
    p.acc_off = off;
    off += acc;
  }
  p.tbl_off = off;
  off += round_up((p.part_keys / p.block_size + 2) * 4, 16);
  p.smem_bytes = off;
}

template <int S, typename TQ, int kDh>
cudaError_t launch(Params p, cudaStream_t stream) {
  make_layout<S, kDh>(p);
  auto kernel = paged_attention_kernel<S, TQ, kDh>;
  // Above 48 KB a block's dynamic shared memory must be allowed first,
  // once per device.
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (p.smem_bytes > 48 * 1024 &&
      (dev >= 64 || p.smem_bytes > allowed[dev])) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem_bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed[dev] = p.smem_bytes;
  }
  const dim3 grid(p.num_parts, p.heads, p.batch);
  kernel<<<grid, kThreads, p.smem_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 cgrid((p.chunk + kWarps - 1) / kWarps, p.heads, p.batch);
  paged_combine_kernel<TQ><<<cgrid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int S, typename TQ>
cudaError_t launch_dh(const Params& p, cudaStream_t stream) {
  return p.head_dim <= 64 ? launch<S, TQ, 64>(p, stream)
                          : launch<S, TQ, kMaxDh>(p, stream);
}

}  // namespace

extern "C" {

// storage: 0 = f32, 1 = bf16, 2 = int8, 3 = int4.  q_dtype: 0 = f32,
// 1 = bf16 (native storage needs q in the storage dtype).  chunk: 1..64.
// num_parts x part_keys covers the table span (part_keys a multiple of
// 64); partials holds batch * heads * num_parts * chunk * (head_dim + 2)
// floats.
int pdt_paged_attention(int storage, int q_dtype, int chunk, const void* q,
                        const void* k, const void* v, const void* k_scale,
                        const void* v_scale, const void* table,
                        const void* index, void* out, void* partials,
                        int batch, int num_heads, int head_dim,
                        int block_size, int table_width, int num_blocks,
                        int num_parts, int part_keys, float scale,
                        long long q_b, long long q_c, long long q_h,
                        long long kv_n, long long kv_h, long long kv_l,
                        long long s_n, long long s_h, long long t_b,
                        long long o_b, long long o_c, long long o_h,
                        void* stream) {
  const long long span = static_cast<long long>(table_width) * block_size;
  if (head_dim % 8 != 0 || head_dim < 8 || head_dim > kMaxDh || chunk < 1 ||
      chunk > kMaxChunk || block_size < 1 || table_width < 1 ||
      table_width > kMaxTable || num_blocks < 1 || batch < 1 ||
      batch > 65535 || num_heads < 1 || num_heads > 65535 ||
      span > INT_MAX / 2 || part_keys < kPartAlign ||
      part_keys % kPartAlign != 0 || num_parts < 1 ||
      static_cast<long long>(num_parts) * part_keys < span ||
      static_cast<long long>(num_parts - 1) * part_keys >= span ||
      partials == nullptr) {
    return cudaErrorInvalidValue;
  }
  const bool quantized = storage == kInt8 || storage == kInt4;
  if (quantized && (k_scale == nullptr || v_scale == nullptr)) {
    return cudaErrorInvalidValue;
  }
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const unsigned short*>(k_scale);
  p.v_scale = static_cast<const unsigned short*>(v_scale);
  p.table = static_cast<const int*>(table);
  p.index = static_cast<const int*>(index);
  p.out = out;
  p.partials = static_cast<float*>(partials);
  p.batch = batch;
  p.heads = num_heads;
  p.chunk = chunk;
  p.head_dim = head_dim;
  p.block_size = block_size;
  p.table_width = table_width;
  p.num_blocks = num_blocks;
  p.num_parts = num_parts;
  p.part_keys = part_keys;
  p.scale = scale;
  p.q_b = q_b;
  p.q_c = q_c;
  p.q_h = q_h;
  p.kv_n = kv_n;
  p.kv_h = kv_h;
  p.kv_l = kv_l;
  p.s_n = s_n;
  p.s_h = s_h;
  p.t_b = t_b;
  p.o_b = o_b;
  p.o_c = o_c;
  p.o_h = o_h;
  const long long q_item = q_dtype == 1 ? 2 : 4;
  p.q_vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
            (q_b * q_item) % 16 == 0 && (q_c * q_item) % 16 == 0 &&
            (q_h * q_item) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (storage == kF32 && q_dtype == 0) return launch_dh<kF32, float>(p, st);
  if (storage == kBF16 && q_dtype == 1) return launch_dh<kBF16, bf16>(p, st);
  if (storage == kInt8 && q_dtype == 0) return launch_dh<kInt8, float>(p, st);
  if (storage == kInt8 && q_dtype == 1) return launch_dh<kInt8, bf16>(p, st);
  if (storage == kInt4 && q_dtype == 0) return launch_dh<kInt4, float>(p, st);
  if (storage == kInt4 && q_dtype == 1) return launch_dh<kInt4, bf16>(p, st);
  return cudaErrorInvalidValue;
}

const char* pdt_paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
