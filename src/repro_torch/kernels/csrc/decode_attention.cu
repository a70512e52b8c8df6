// Flash-decode: one-query GQA attention against a preallocated KV cache,
// split over the cache's sequence axis, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _decode_kernel, pallas_call at :75).  It computes
// the same function: f32 scores of the pre-scaled query against every cache
// row below `length`, an online softmax with f32 running max / sum /
// accumulator, one division by max(l, 1e-37) and one cast to the output
// type.  The TPU kernel walks the whole cache of one (batch, q head) in
// order on one core; here the rows below `length` are cut into splits of
// 128 rows that run in parallel, and a second, small kernel merges their
// partial (m, l, acc) in a fixed order, so results do not depend on the
// schedule.
//
// What bounds it on the H100: bytes.  A step reads each valid K and V row
// once (B * length * KH * D * 2 values) for 4 FLOP per value per q head of
// the group, far below the ridge.  The design reads the cache once: one
// block serves all `group` q heads of its kv head from one read of each
// row, and rows at or past `length` are never touched.  `length` is a host
// integer (the port's KVCache keeps it on the host, so a step needs no
// device-to-host read); the grid is sized from it.
//
// Design of the split kernel (128 threads, one block per (split, kv head,
// batch)): the group's queries are staged pre-scaled in shared memory.  In
// the score pass each thread owns one cache row and reads it with 16-byte
// loads, so a block keeps 128 rows of loads in flight; the block reduces
// the max and the sum of exp per q head through shared memory.  In the
// value pass each thread owns one of the D columns and walks the split's
// rows, reading each V row coalesced across the block.
//
// Interface: plain C, bound with ctypes.  q [B, 1, QH, D]; caches
// [B, S_max, KH, D]; out [B, 1, QH, D]; all contiguous, of one type
// (0 = float32, 1 = bfloat16), 16-byte aligned; D in {16, 32, 64, 128};
// QH / KH in {1, 2, 4, 8}.  Scratch (f32): part_m and part_l
// [B, QH, n_split], part_acc [B, QH, n_split, D] with n_split =
// ceil(length / 128).  Both launches go on the caller's stream; the call
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int CHUNK = 128;  // cache rows per split = threads per block
constexpr int NW = CHUNK / 32;
constexpr float NEG_INF = -2.3819763e38f;  // the TPU kernel's mask value

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of a row as floats: 4 float32 or 8 bfloat16 values.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    out[0] = w.x;
    out[1] = w.y;
    out[2] = w.z;
    out[3] = w.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Block-wide reduction of one value per q head (max or sum), in a fixed
// order: within each warp by shuffles, then over the warps in index order.
template <int G, bool MAX>
__device__ __forceinline__ void block_reduce(float (&x)[G],
                                             float (*red)[NW]) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[g], off);
      x[g] = MAX ? fmaxf(x[g], y) : x[g] + y;
    }
    if (lane == 0) red[g][w] = x[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float r = red[g][0];
#pragma unroll
    for (int i = 1; i < NW; ++i) r = MAX ? fmaxf(r, red[g][i]) : r + red[g][i];
    x[g] = r;
  }
  __syncthreads();  // red is reused by the next reduction
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(CHUNK)
decode_split(const T* __restrict__ q, const T* __restrict__ kc,
             const T* __restrict__ vc, float* __restrict__ part_m,
             float* __restrict__ part_l, float* __restrict__ part_acc,
             int S_max, int KH, int length, int n_split, float scale) {
  __shared__ __align__(16) float Qs[G][D];
  __shared__ float Ps[G][CHUNK];
  __shared__ float red[G][NW];

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int QH = KH * G;
  const int tid = threadIdx.x;
  const int r0 = split * CHUNK;
  const int n_rows = min(CHUNK, length - r0);  // >= 1 by the grid's size

  for (int i = tid; i < G * D; i += CHUNK) {
    const int g = i / D, d = i % D;
    Qs[g][d] = to_f(q[(size_t(b) * QH + kh * G + g) * D + d]) * scale;
  }
  __syncthreads();

  const size_t row = size_t(KH) * D;  // elements between cache rows
  const T* kb = kc + size_t(b) * S_max * row + size_t(kh) * D;
  const T* vb = vc + size_t(b) * S_max * row + size_t(kh) * D;

  // score pass: thread tid owns cache row r0 + tid
  float s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) s[g] = NEG_INF;
  if (tid < n_rows) {
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    const T* kr = kb + size_t(r0 + tid) * row;
    constexpr int N = Vec<T>::N;
#pragma unroll
    for (int d = 0; d < D; d += N) {
      float kv[N];
      Vec<T>::load(kr + d, kv);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < N; ++e) s[g] = fmaf(Qs[g][d + e], kv[e], s[g]);
    }
  }
  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = s[g];
  block_reduce<G, true>(mx, red);
  float ls[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float p = tid < n_rows ? expf(s[g] - mx[g]) : 0.f;
    Ps[g][tid] = p;
    ls[g] = p;
  }
  block_reduce<G, false>(ls, red);  // its barrier also publishes Ps

  // value pass: thread tid owns column tid of every q head of the group
  if (tid < D) {
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    const T* vr = vb + size_t(r0) * row + tid;
#pragma unroll 8
    for (int j = 0; j < n_rows; ++j) {
      const float x = to_f(vr[size_t(j) * row]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(Ps[g][j], x, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const size_t slot = (size_t(b) * QH + kh * G + g) * n_split + split;
      part_acc[slot * D + tid] = acc[g];
      if (tid == 0) {
        part_m[slot] = mx[g];
        part_l[slot] = ls[g];
      }
    }
  }
}

// Merge the splits of one (batch, q head) in split order.
template <typename T>
__global__ void decode_merge(const float* __restrict__ part_m,
                             const float* __restrict__ part_l,
                             const float* __restrict__ part_acc,
                             T* __restrict__ out, int D, int n_split) {
  const size_t bh = blockIdx.x;
  const float* pm = part_m + bh * n_split;
  const float* pl = part_l + bh * n_split;
  float m = NEG_INF;
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, pm[i]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float l = 0.f, acc = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const float w = expf(pm[i] - m);
      l = fmaf(pl[i], w, l);
      acc = fmaf(part_acc[(bh * n_split + i) * D + d], w, acc);
    }
    out[bh * D + d] = from_f<T>(acc / fmaxf(l, 1e-37f));
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* kc, const void* vc, void* out,
           float* part_m, float* part_l, float* part_acc, int B, int S_max,
           int KH, int length, float scale, cudaStream_t stream) {
  const int n_split = (length + CHUNK - 1) / CHUNK;
  decode_split<T, D, G><<<dim3(n_split, KH, B), CHUNK, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), part_m, part_l, part_acc, S_max, KH, length,
      n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge<T><<<B * KH * G, D, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), D, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_g(const void* q, const void* kc, const void* vc, void* out,
             float* pm, float* pl, float* pa, int B, int S_max, int KH,
             int G, int length, float scale, cudaStream_t s) {
  switch (G) {
    case 1:
      return launch<T, D, 1>(q, kc, vc, out, pm, pl, pa, B, S_max, KH, length,
                             scale, s);
    case 2:
      return launch<T, D, 2>(q, kc, vc, out, pm, pl, pa, B, S_max, KH, length,
                             scale, s);
    case 4:
      return launch<T, D, 4>(q, kc, vc, out, pm, pl, pa, B, S_max, KH, length,
                             scale, s);
    case 8:
      return launch<T, D, 8>(q, kc, vc, out, pm, pl, pa, B, S_max, KH, length,
                             scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_d(const void* q, const void* kc, const void* vc, void* out,
             float* pm, float* pl, float* pa, int B, int S_max, int KH, int G,
             int D, int length, float scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_g<T, 16>(q, kc, vc, out, pm, pl, pa, B, S_max, KH, G,
                             length, scale, s);
    case 32:
      return launch_g<T, 32>(q, kc, vc, out, pm, pl, pa, B, S_max, KH, G,
                             length, scale, s);
    case 64:
      return launch_g<T, 64>(q, kc, vc, out, pm, pl, pa, B, S_max, KH, G,
                             length, scale, s);
    case 128:
      return launch_g<T, 128>(q, kc, vc, out, pm, pl, pa, B, S_max, KH, G,
                              length, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The number of splits (and of scratch slots per (batch, q head)).
int da_num_splits(int length) { return (length + CHUNK - 1) / CHUNK; }

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int da_launch(const void* q, const void* kc, const void* vc, void* out,
              float* part_m, float* part_l, float* part_acc, int B, int S_max,
              int QH, int KH, int D, int length, float scale, int dtype,
              void* stream) {
  if (B <= 0 || KH <= 0 || QH % KH != 0 || length < 1 || length > S_max)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = QH / KH;
  if (dtype == 0)
    return launch_d<float>(q, kc, vc, out, part_m, part_l, part_acc, B, S_max,
                           KH, G, D, length, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, kc, vc, out, part_m, part_l, part_acc,
                                   B, S_max, KH, G, D, length, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* da_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
