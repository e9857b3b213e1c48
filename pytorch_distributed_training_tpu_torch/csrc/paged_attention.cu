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
// table[b, p / block_size] at offset p % block_size.  The table is read
// here, inside the kernel: it arrives pre-clamped to real blocks (the idle
// sentinel entries point at some real block whose keys the mask never
// admits).  An index >= table_width * block_size is the idle-row sentinel:
// it unmasks the whole row, and the caller discards that row's output.
//
// Storage kinds (template parameter S): f32 or bf16 K/V in q's dtype, or
// the quantized pool (--serve-kv-dtype): int8 payload, or int4 nibbles
// packed two per byte (low nibble = even column, two's complement), each
// with one bf16 scale per (block, head, position).  Quantized tiles are
// dequantized here, per element, exactly as comm/compress.py's
// dequantize_kv does (f32(payload) * f32(scale)), so only the compressed
// bytes and the scales are read from device memory.
//
// Math, copied from the TPU kernels so results agree to rounding: s = q.k
// in f32, then * scale; masked scores are -1e30; an online softmax with an
// f32 running max m, denominator l and accumulator: per key tile
// m_new = max(m, max s), alpha = exp(m - m_new), p = exp(s - m_new) with
// masked p = 0, l = alpha * l + sum p, acc = alpha * acc + p @ V.  For
// native bf16 storage p is rounded to bf16 before the PV product (l sums
// the unrounded p); quantized tiles are f32, so p stays f32.  The output
// is acc / l in q's dtype, and 0 for a query with no live key.
//
// Bound on this card: bytes.  A call must read, for each row, the K/V of
// the blocks its last query sees (at the stored width, plus the scales),
// and does ~4 flops per K/V element it reads: far below the ~300 flops
// per byte where the H100 turns compute bound.  The design keeps every
// K/V byte to one read per query tile: one block of 256 threads per
// (head, row, tile of 16 queries) walks the row's keys in tiles of 32
// (only up to the tile's last visible key: dead blocks are never read),
// loads the tile's K and V rows through the table (whose row it keeps in
// shared memory) into shared memory as f32 (8 elements per load item,
// neighbouring threads on neighbouring addresses), and issues the next
// tile's loads into registers before it computes on the current one, so
// one tile's load latency hides behind the other's arithmetic.  Scores
// take one lane per key and one warp per query; the PV product takes 16
// threads per query, 4 dims each; both read shared memory 16 bytes at a
// time.  Known limits, left for later work: a chunk of C <= 8 leaves most
// of the 256 threads idle outside the loads, B*H*ceil(C/16) blocks (96 at
// C <= 16 at the serving shapes) fill fewer than the 132 SMs (splitting
// the key range across blocks would need a second reduction pass), and
// the products run on the CUDA cores, not the tensor cores.
//
// Interface: plain C, loaded with ctypes (ops/paged_attention.py).  All
// strides are in elements of the stored type; K and V share one layout,
// and so do their scales.  The launch goes on the caller's stream and the
// function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQTile = 16;   // queries per thread block
constexpr int kKTile = 32;   // keys per step: one per lane in the softmax
constexpr int kMaxDh = 128;
constexpr int kMaxTable = 1024;  // table entries per row kept in smem
constexpr int kVec = 8;      // elements per load item
// Load items per thread per step at the widest head dim: K and V rows.
constexpr int kItems = 2 * kKTile * (kMaxDh / kVec) / kThreads;
// PV: 16 threads per query, each owning groups of 4 dims g = t % 16 + 16 j.
constexpr int kGroups = kMaxDh / 64;
// Shared K rows are padded to a multiple of 4 floats that keeps the
// lanes' 16-byte reads of 32 different rows free of bank conflicts.
constexpr int kKStride = kMaxDh + 4;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

enum Storage { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt4 = 3 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const unsigned short* k_scale;  // bf16 bits; null unless quantized
  const unsigned short* v_scale;
  const int* table;
  const int* index;
  void* out;
  int chunk, head_dim, block_size, table_width, num_blocks;
  float scale;
  long long q_b, q_c, q_h;
  long long kv_n, kv_h, kv_l;  // payload strides (K and V alike)
  long long s_n, s_h;          // scale strides; the position stride is 1
  long long t_b;               // table row stride
  long long o_b, o_c, o_h;
};

// One load item: 8 consecutive elements of one K or V row, raw, plus the
// row's raw bf16 scale.  Kept raw in registers until the next step's
// store, so the load is not waited on before the current step's math.
struct Raw {
  uint4 a;
  uint4 b;
  unsigned short sc;
};

__device__ __forceinline__ float bf16_bits_to_float(unsigned short bits) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

template <int S>
__device__ __forceinline__ void fetch(const void* base, long long row,
                                      int col0, Raw& r) {
  if constexpr (S == kF32) {
    const float* p = static_cast<const float*>(base) + row + col0;
    r.a = *reinterpret_cast<const uint4*>(p);
    r.b = *reinterpret_cast<const uint4*>(p + 4);
  } else if constexpr (S == kBF16) {
    const __nv_bfloat16* p =
        static_cast<const __nv_bfloat16*>(base) + row + col0;
    r.a = *reinterpret_cast<const uint4*>(p);
  } else if constexpr (S == kInt8) {
    const int8_t* p = static_cast<const int8_t*>(base) + row + col0;
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    r.a.x = x.x;
    r.a.y = x.y;
  } else {
    const uint8_t* p = static_cast<const uint8_t*>(base) + row + col0 / 2;
    r.a.x = *reinterpret_cast<const uint32_t*>(p);
  }
}

template <int S>
__device__ __forceinline__ void unpack(const Raw& r, float* out) {
  if constexpr (S == kF32) {
    const float* a = reinterpret_cast<const float*>(&r.a);
    const float* b = reinterpret_cast<const float*>(&r.b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[e] = a[e];
      out[4 + e] = b[e];
    }
  } else if constexpr (S == kBF16) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  } else if constexpr (S == kInt8) {
    const float sc = bf16_bits_to_float(r.sc);
    const int8_t* q = reinterpret_cast<const int8_t*>(&r.a);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = static_cast<float>(q[e]) * sc;
  } else {
    const float sc = bf16_bits_to_float(r.sc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int byte = (r.a.x >> (8 * e)) & 0xFF;
      const int lo = byte & 0xF;
      const int hi = byte >> 4;
      out[2 * e] = static_cast<float>(lo > 7 ? lo - 16 : lo) * sc;
      out[2 * e + 1] = static_cast<float>(hi > 7 ? hi - 16 : hi) * sc;
    }
  }
}

// The TPU kernel casts p to V's dtype before the PV product: bf16 for the
// native bf16 pool, f32 (no rounding) for f32 and for dequantized tiles.
template <int S>
__device__ __forceinline__ float round_p(float x) {
  if constexpr (S == kBF16) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Issue the loads of key tile [p0, p0 + kKTile) into registers; ``tbl``
// is the row's block table (already clamped) in shared memory.
template <int S>
__device__ __forceinline__ void fetch_tile(const Params& p, int h,
                                           const int* tbl, int p0,
                                           int n_keys, Raw* raw) {
  const int items_per_row = p.head_dim / kVec;
  const int per_tensor = kKTile * items_per_row;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = threadIdx.x + j * kThreads;
    Raw& r = raw[j];
    r.a = make_uint4(0, 0, 0, 0);
    r.b = make_uint4(0, 0, 0, 0);
    r.sc = 0;
    if (i >= 2 * per_tensor) continue;
    const int which = i / per_tensor;  // 0: K, 1: V
    const int rem = i - which * per_tensor;
    const int row = rem / items_per_row;
    const int pos = p0 + row;
    if (pos >= n_keys) continue;
    const int blk = tbl[pos / p.block_size];
    const int off = pos % p.block_size;
    const int col0 = (rem - row * items_per_row) * kVec;
    const long long base = blk * p.kv_n + h * p.kv_h + off * p.kv_l;
    fetch<S>(which ? p.v : p.k, base, col0, r);
    if constexpr (S == kInt8 || S == kInt4) {
      const unsigned short* sp = which ? p.v_scale : p.k_scale;
      r.sc = sp[blk * p.s_n + h * p.s_h + off];
    }
  }
}

template <int S, typename TQ>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Params p) {
  __shared__ __align__(16) float q_s[kQTile][kMaxDh];
  __shared__ __align__(16) float k_s[kKTile][kKStride];
  __shared__ __align__(16) float v_s[kKTile][kMaxDh];
  __shared__ float p_s[kQTile][kKTile];
  __shared__ float alpha_s[kQTile];
  __shared__ float l_s[kQTile];
  __shared__ int tbl_s[kMaxTable];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.z * kQTile;
  const int nq = min(kQTile, p.chunk - q0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dh = p.head_dim;
  const long long first = p.index[b];
  const long long span =
      static_cast<long long>(p.table_width) * p.block_size;
  // Keys this tile can see: up to its last query's position, within the
  // table span.  Keys past it (dead blocks) are never loaded.
  const long long last = first + q0 + nq - 1;
  const int n_keys = static_cast<int>(min(span, max(last + 1, 0LL)));

  // The row's table entries up to the last visible key, clamped to the
  // real blocks (a guard: the caller passes the table pre-clamped).
  const int* trow = p.table + b * p.t_b;
  const int n_tbl = (n_keys + p.block_size - 1) / p.block_size;
  for (int i = tid; i < n_tbl; i += kThreads) {
    tbl_s[i] = min(max(trow[i], 0), p.num_blocks - 1);
  }

  const TQ* q = static_cast<const TQ*>(p.q);
  for (int i = tid; i < kQTile * dh; i += kThreads) {
    const int qi = i / dh;
    const int d = i - qi * dh;
    q_s[qi][d] = qi < nq
        ? to_float(q[b * p.q_b + (q0 + qi) * p.q_c + h * p.q_h + d])
        : 0.f;
  }

  // Softmax state: warp w owns queries w and w + kWarps (all its lanes
  // hold the same values).  PV: thread t owns query t / 16 and the dim
  // groups g = t % 16 + 16 * j (dims 4g..4g+3) below dh / 4.
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  const int pq = tid >> 4;
  const int pd = tid & 15;
  float4 acc[kGroups];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int items_per_row = dh / kVec;
  const int per_tensor = kKTile * items_per_row;
  Raw raw[kItems];
  __syncthreads();  // tbl_s and q_s
  if (n_keys > 0) fetch_tile<S>(p, h, tbl_s, 0, n_keys, raw);

  for (int p0 = 0; p0 < n_keys; p0 += kKTile) {
    // Store the fetched tile as f32 (dequantized), then start the next
    // tile's loads before computing on this one.
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = tid + j * kThreads;
      if (i < 2 * per_tensor) {
        const int which = i / per_tensor;
        const int rem = i - which * per_tensor;
        const int row = rem / items_per_row;
        const int col0 = (rem - row * items_per_row) * kVec;
        float vals[kVec];
        unpack<S>(raw[j], vals);
        float* dst = which ? &v_s[row][col0] : &k_s[row][col0];
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[e] = vals[e];
      }
    }
    __syncthreads();
    if (p0 + kKTile < n_keys) {
      fetch_tile<S>(p, h, tbl_s, p0 + kKTile, n_keys, raw);
    }

    // Scores and the online-softmax update, one lane per key.
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int qi = warp + s * kWarps;
      if (qi < nq) {  // the same for every lane of the warp
        const int pos = p0 + lane;
        float dot0 = 0.f, dot1 = 0.f;
#pragma unroll 4
        for (int d = 0; d < dh; d += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(&q_s[qi][d]);
          const float4 kv = *reinterpret_cast<const float4*>(&k_s[lane][d]);
          dot0 = fmaf(qv.x, kv.x, dot0);
          dot1 = fmaf(qv.y, kv.y, dot1);
          dot0 = fmaf(qv.z, kv.z, dot0);
          dot1 = fmaf(qv.w, kv.w, dot1);
        }
        const float dot = dot0 + dot1;
        const bool live = pos < n_keys &&
                          static_cast<long long>(pos) <= first + q0 + qi;
        const float sc = live ? dot * p.scale : kNegInf;
        float mt = sc;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
        }
        const float m_new = fmaxf(m_run[s], mt);
        const float alpha = expf(m_run[s] - m_new);
        const float pr = live ? expf(sc - m_new) : 0.f;
        float sum = pr;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(kFull, sum, off);
        }
        l_run[s] = alpha * l_run[s] + sum;
        m_run[s] = m_new;
        p_s[qi][lane] = round_p<S>(pr);
        if (lane == 0) alpha_s[qi] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha * acc + p @ V over this tile's keys.
    if (pq < nq) {
      const float alpha = alpha_s[pq];
      const int nk = min(kKTile, n_keys - p0);
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const int d = 4 * (pd + 16 * j);
        if (d >= dh) continue;
        float4 a = acc[j];
        a.x *= alpha;
        a.y *= alpha;
        a.z *= alpha;
        a.w *= alpha;
#pragma unroll 4
        for (int r = 0; r < nk; ++r) {
          const float pr = p_s[pq][r];
          const float4 vv = *reinterpret_cast<const float4*>(&v_s[r][d]);
          a.x = fmaf(pr, vv.x, a.x);
          a.y = fmaf(pr, vv.y, a.y);
          a.z = fmaf(pr, vv.z, a.z);
          a.w = fmaf(pr, vv.w, a.w);
        }
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int qi = warp + s * kWarps;
      if (qi < nq) l_s[qi] = l_run[s];
    }
  }
  __syncthreads();
  if (pq < nq) {
    const float l = l_s[pq];
    const float l_safe = l == 0.f ? 1.f : l;
    TQ* out = static_cast<TQ*>(p.out) + b * p.o_b + (q0 + pq) * p.o_c +
              h * p.o_h;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int d = 4 * (pd + 16 * j);
      if (d < dh) {
        store(out + d, acc[j].x / l_safe);
        store(out + d + 1, acc[j].y / l_safe);
        store(out + d + 2, acc[j].z / l_safe);
        store(out + d + 3, acc[j].w / l_safe);
      }
    }
  }
}

template <int S, typename TQ>
cudaError_t launch(const Params& p, int batch, int num_heads,
                   cudaStream_t stream) {
  const dim3 grid(num_heads, batch, (p.chunk + kQTile - 1) / kQTile);
  paged_attention_kernel<S, TQ><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// storage: 0 = f32, 1 = bf16, 2 = int8, 3 = int4.  q_dtype: 0 = f32,
// 1 = bf16 (native storage needs q in the storage dtype).  chunk: C >= 1.
int pdt_paged_attention(int storage, int q_dtype, int chunk, const void* q,
                        const void* k, const void* v, const void* k_scale,
                        const void* v_scale, const void* table,
                        const void* index, void* out, int batch,
                        int num_heads, int head_dim, int block_size,
                        int table_width, int num_blocks, float scale,
                        long long q_b, long long q_c, long long q_h,
                        long long kv_n, long long kv_h, long long kv_l,
                        long long s_n, long long s_h, long long t_b,
                        long long o_b, long long o_c, long long o_h,
                        void* stream) {
  if (head_dim % kVec != 0 || head_dim > kMaxDh || chunk < 1 ||
      block_size < 1 || table_width < 1 || table_width > kMaxTable ||
      num_blocks < 1 || batch < 1 || num_heads < 1) {
    return cudaErrorInvalidValue;
  }
  const bool quantized = storage == kInt8 || storage == kInt4;
  if (quantized && (k_scale == nullptr || v_scale == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Params p{q, k, v,
                 static_cast<const unsigned short*>(k_scale),
                 static_cast<const unsigned short*>(v_scale),
                 static_cast<const int*>(table),
                 static_cast<const int*>(index), out,
                 chunk, head_dim, block_size, table_width, num_blocks, scale,
                 q_b, q_c, q_h, kv_n, kv_h, kv_l, s_n, s_h, t_b,
                 o_b, o_c, o_h};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (storage == kF32 && q_dtype == 0) {
    return launch<kF32, float>(p, batch, num_heads, st);
  }
  if (storage == kBF16 && q_dtype == 1) {
    return launch<kBF16, __nv_bfloat16>(p, batch, num_heads, st);
  }
  if (storage == kInt8 && q_dtype == 0) {
    return launch<kInt8, float>(p, batch, num_heads, st);
  }
  if (storage == kInt8 && q_dtype == 1) {
    return launch<kInt8, __nv_bfloat16>(p, batch, num_heads, st);
  }
  if (storage == kInt4 && q_dtype == 0) {
    return launch<kInt4, float>(p, batch, num_heads, st);
  }
  if (storage == kInt4 && q_dtype == 1) {
    return launch<kInt4, __nv_bfloat16>(p, batch, num_heads, st);
  }
  return cudaErrorInvalidValue;
}

const char* pdt_paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
