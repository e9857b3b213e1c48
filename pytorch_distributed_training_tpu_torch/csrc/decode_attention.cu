// Decode attention over the contiguous KV cache, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of pytorch_distributed_training_tpu/ops/
// pallas_attention.py:
//   decode_attention        (_decode_kernel)        C == 1
//   decode_attention_multi  (_decode_kernel_multi) 1 <= C <= 8
// with one kernel templated on the chunk width C.  Query j of batch row b
// attends cache positions 0..index[b]+j (never past the cache length L: an
// index >= L is the idle-slot sentinel and unmasks the whole row).
//
// Math, copied from the TPU kernels so results agree to rounding:
//   s = (q . k) in f32, then * scale;  softmax in f32 (exp(s - max) / sum);
//   p rounded to V's dtype;            out = sum_l p[l] * v[l] in f32,
//   rounded to the output dtype once at the end.
//
// Bound on this card: bytes.  A call reads the visible K/V prefix once
// (sum over rows of min(index[b]+C, L) * H * Dh * 2 tensors) and does
// ~4 flops per K/V element, far below the ~300 flops per byte where the
// H100 turns compute bound.  The design keeps every K/V byte to a single
// read from device memory: one block per (batch row, head) loads q into
// registers, streams the key rows of the visible prefix only (16-byte loads,
// neighbouring threads on neighbouring addresses, kUnroll rows in flight
// per thread), keeps the C x L scores in shared memory for the softmax, then
// streams the value rows once.  Nothing past the prefix is read.  Known
// limit, left for a later change: B*H blocks (96 at the serving shapes)
// fill fewer than the 132 SMs; splitting the key range across blocks would
// need a second reduction pass.
//
// Interface: plain C, loaded with ctypes (ops/decode_attention.py).  All
// strides are in elements; the last dimension of every operand must be
// contiguous with 16-byte-aligned rows (the Python wrapper checks this).
// The launch goes on the caller's stream and the function returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;     // elements per thread per row (16 B of bf16)
constexpr int kUnroll = 4;  // key/value rows in flight per thread
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long q_b, q_c, q_h;
  long long k_b, k_h, k_l;
  long long v_b, v_h, v_l;
  long long o_b, o_c, o_h;
};

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Round to the storage dtype and back: the TPU kernel casts p to V's dtype
// before the PV product.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows 0..n-1 visible to a query whose last visible position is `last`.
__device__ __forceinline__ int visible(long long last, int cache_len) {
  return last >= cache_len - 1 ? cache_len : static_cast<int>(last + 1);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ index,
                        T* __restrict__ out, int cache_len, int head_dim,
                        int group, float scale, Strides s) {
  extern __shared__ float smem[];
  float* probs = smem;                          // [C][cache_len]
  float* partial = smem + C * cache_len;        // [kWarps][C][head_dim]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // A group of `group` threads (a power of two, >= head_dim / kVec) covers
  // one row; a pass over the block covers kThreads / group rows.
  const int sub = tid % group;
  const int row = tid / group;
  const int rows_per_pass = kThreads / group;
  const bool has_cols = sub * kVec < head_dim;
  const int col0 = sub * kVec;

  const long long first = index[b];
  const int n_keys = visible(first + C - 1, cache_len);

  float qr[C][kVec];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (has_cols) {
      load_vec(q + b * s.q_b + j * s.q_c + h * s.q_h + col0, qr[j]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) qr[j][e] = 0.f;
    }
  }

  // Scores.  The trip count is the same for every thread of the block, so
  // the shuffles below always see the full warp.
  const T* kb = k + b * s.k_b + h * s.k_h + col0;
  for (int base = 0; base < n_keys; base += rows_per_pass * kUnroll) {
    float kr[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + u * rows_per_pass + row;
      if (has_cols && l < n_keys) {
        load_vec(kb + l * s.k_l, kr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + u * rows_per_pass + row;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc = fmaf(qr[j][e], kr[u][e], acc);
        for (int off = group >> 1; off > 0; off >>= 1) {
          acc += __shfl_xor_sync(kFull, acc, off);
        }
        if (sub == 0 && l < n_keys) probs[j * cache_len + l] = acc * scale;
      }
    }
  }
  __syncthreads();

  // Softmax per query, one warp each.  Keys past a query's own limit get
  // p = 0, which is what exp(-1e30 - max) gives in the TPU kernel.
  for (int j = warp; j < C; j += kWarps) {
    const int n_j = visible(first + j, cache_len);
    float* pj = probs + j * cache_len;
    float m = -INFINITY;
    for (int l = lane; l < n_j; l += 32) m = fmaxf(m, pj[l]);
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    }
    float sum = 0.f;
    for (int l = lane; l < n_j; l += 32) sum += expf(pj[l] - m);
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(kFull, sum, off);
    }
    for (int l = lane; l < n_keys; l += 32) {
      pj[l] = l < n_j ? round_to(expf(pj[l] - m) / sum, k) : 0.f;
    }
  }
  __syncthreads();

  // out = p @ v, accumulated in f32 per thread, then across the rows of a
  // warp by shuffles, then across warps through shared memory.
  float acc[C][kVec];
#pragma unroll
  for (int j = 0; j < C; ++j) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[j][e] = 0.f;
  }
  const T* vb = v + b * s.v_b + h * s.v_h + col0;
  for (int base = 0; base < n_keys; base += rows_per_pass * kUnroll) {
    float vr[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + u * rows_per_pass + row;
      if (has_cols && l < n_keys) {
        load_vec(vb + l * s.v_l, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + u * rows_per_pass + row;
      if (l < n_keys) {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float p = probs[j * cache_len + l];
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[j][e] = fmaf(p, vr[u][e], acc[j][e]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < C; ++j) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      for (int off = group; off < 32; off <<= 1) {
        acc[j][e] += __shfl_xor_sync(kFull, acc[j][e], off);
      }
    }
  }
  if (lane < group && has_cols) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        partial[(warp * C + j) * head_dim + col0 + e] = acc[j][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < C * head_dim; i += kThreads) {
    const int j = i / head_dim;
    const int d = i % head_dim;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += partial[(w * C + j) * head_dim + d];
    store(out + b * s.o_b + j * s.o_c + h * s.o_h + d, o);
  }
}

template <typename T, int C>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* index, void* out, int batch, int num_heads,
                   int cache_len, int head_dim, float scale, const Strides& s,
                   cudaStream_t stream) {
  int group = 1;
  while (group * kVec < head_dim) group <<= 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(C) * cache_len +
                       static_cast<size_t>(kWarps) * C * head_dim);
  auto kernel = decode_attention_kernel<T, C>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(num_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(index),
      static_cast<T*>(out), cache_len, head_dim, group, scale, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int chunk, const void* q, const void* k, const void* v,
                     const void* index, void* out, int batch, int num_heads,
                     int cache_len, int head_dim, float scale,
                     const Strides& s, cudaStream_t stream) {
#define PDT_CHUNK(c)                                                        \
  case c:                                                                   \
    return launch<T, c>(q, k, v, index, out, batch, num_heads, cache_len,   \
                        head_dim, scale, s, stream);
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

// dtype: 0 = float32, 1 = bfloat16.  chunk: C, 1..8.
int pdt_decode_attention(int dtype, int chunk, const void* q, const void* k,
                         const void* v, const void* index, void* out,
                         int batch, int num_heads, int cache_len,
                         int head_dim, float scale, long long q_b,
                         long long q_c, long long q_h, long long k_b,
                         long long k_h, long long k_l, long long v_b,
                         long long v_h, long long v_l, long long o_b,
                         long long o_c, long long o_h, void* stream) {
  if (head_dim % kVec != 0 || head_dim > 16 * kVec || cache_len < 1) {
    return cudaErrorInvalidValue;
  }
  const Strides s{q_b, q_c, q_h, k_b, k_h, k_l, v_b, v_h, v_l, o_b, o_c, o_h};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(chunk, q, k, v, index, out, batch, num_heads,
                           cache_len, head_dim, scale, s, st);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(chunk, q, k, v, index, out, batch,
                                   num_heads, cache_len, head_dim, scale, s,
                                   st);
  }
  return cudaErrorInvalidValue;
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
