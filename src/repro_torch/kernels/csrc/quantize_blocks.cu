// Symmetric per-block quantization and its inverse (the approximate
// collective's payload) for sm_90a.
//
// Replaces the Pallas TPU kernels src/repro/kernels/quantize.py::
// quantize_blocks (body _quantize_kernel, pallas_call at :57) and
// dequantize_blocks (body _dequantize_kernel, pallas_call at :77).  Per
// (bm, bn) tile of a row-major [M, N] tensor:
//
//     scale = max(absmax(tile) / qmax, 1e-12)
//     q     = clip(round_half_even(x / scale), -qmax, qmax)      -> int8
//     x'    = q * scale                                           -> out type
//
// with qmax 127 (int8) or 7 (the int4 range, still one int8 per value).
// The arithmetic is the oracle's (repro.kernels.ref::quantize_ref) bit for
// bit: the max is exact whatever its order, both divisions are IEEE
// round-to-nearest (__fdiv_rn: no reciprocal, whatever the build flags),
// rintf rounds half to even as jnp.round and torch.round do, and the scale
// floor is applied after the division.
//
// What bounds it on the H100: bytes.  Quantize must read x once (4 B per
// element in f32, 2 in bf16) and write q (1 B) and one scale per tile;
// dequantize reads q and the scales and writes the output (4 B in f32):
// 5 B per f32 element each way, ~0.53 ms for the largest gradient leaf
// of qwen3-1.7b (w_gate, 352 M elements) at 3.35 TB/s.
//
// Design (the simple first version): one block of up to 512 threads per
// tile.  A tile is 256 x 512 = 131072 elements (512 KB in f32), more than
// an SM's shared memory, so quantize reads its tile twice: a first pass
// reduces |x| to the absmax (each warp walks whole rows, 4 elements a lane
// with one 16-byte load, then warp shuffles and one shared-memory step
// across the warps), a second pass re-reads the tile and writes int8, 4
// values a lane as one 4-byte store so each warp store covers 128
// contiguous bytes.  With ~4 tiles in flight per SM (264 MB over the
// card) the re-read comes back from device memory, not from the 50 MB L2:
// ~9 B per f32 element against the bound's 5.  Keeping the tile on chip
// (a cluster of CTAs holding a quarter tile each, reducing the absmax
// through distributed shared memory) is the next step.  Dequantize walks
// its tile once with the tile's scale read once.  Both fall back to one
// element a lane when bn is not a multiple of 4 or a pointer is not
// 16-byte aligned.
//
// Interface: plain C, bound with ctypes.  quantize: x [M, N] (dtype 0 =
// float32, 1 = bfloat16) -> q int8 [M, N], scales float32 [M/bm, N/bn];
// dequantize: q, scales -> out [M, N] (out_dtype 0 = float32, 1 =
// bfloat16).  All contiguous; bm divides M and bn divides N (the wrapper
// checks).  The launch goes on the caller's stream; each call returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr float kScaleFloor = 1e-12f;

// VEC consecutive elements of x (VEC 4: one 16-byte f32 or 8-byte bf16 load)
template <int VEC>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = p[0];
  }
}
template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}
template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 4) {
    uint2 raw;
    *reinterpret_cast<__nv_bfloat162*>(&raw.x) =
        __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&raw.y) =
        __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

__device__ __forceinline__ int8_t quant(float x, float scale, float qmax) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -qmax), qmax);
  return static_cast<int8_t>(__float2int_rn(r));
}

// The block's max of m (every thread gets it).  blockDim.x is a multiple
// of 32.
__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_max[kMaxThreads / 32];
  __shared__ float result;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < int(blockDim.x >> 5) ? warp_max[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) result = m;
  }
  __syncthreads();
  return result;
}

// One block per tile; each warp walks rows r = warp, warp + n_warps, ...
// of the tile, VEC elements a lane.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
quantize_tiles(const T* __restrict__ x, int8_t* __restrict__ q,
               float* __restrict__ scales, int N, int bm, int bn, int gn,
               float qmax) {
  const int tile = blockIdx.x;
  const int ti = tile / gn, tj = tile - (tile / gn) * gn;
  const size_t base = size_t(ti) * bm * N + size_t(tj) * bn;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  float m = 0.f;
  for (int r = warp; r < bm; r += n_warps) {
    const T* row = x + base + size_t(r) * N;
#pragma unroll 4
    for (int c = lane * VEC; c < bn; c += 32 * VEC) {
      float v[VEC];
      load<VEC>(row + c, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) m = fmaxf(m, fabsf(v[k]));
    }
  }
  const float absmax = block_max(m);
  const float scale = fmaxf(__fdiv_rn(absmax, qmax), kScaleFloor);

  for (int r = warp; r < bm; r += n_warps) {
    const T* row = x + base + size_t(r) * N;
    int8_t* qrow = q + base + size_t(r) * N;
#pragma unroll 4
    for (int c = lane * VEC; c < bn; c += 32 * VEC) {
      float v[VEC];
      load<VEC>(row + c, v);
      if constexpr (VEC == 4) {
        *reinterpret_cast<char4*>(qrow + c) =
            make_char4(quant(v[0], scale, qmax), quant(v[1], scale, qmax),
                       quant(v[2], scale, qmax), quant(v[3], scale, qmax));
      } else {
        qrow[c] = quant(v[0], scale, qmax);
      }
    }
  }
  if (threadIdx.x == 0) scales[tile] = scale;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
dequantize_tiles(const int8_t* __restrict__ q,
                 const float* __restrict__ scales, T* __restrict__ out, int N,
                 int bm, int bn, int gn) {
  const int tile = blockIdx.x;
  const int ti = tile / gn, tj = tile - (tile / gn) * gn;
  const size_t base = size_t(ti) * bm * N + size_t(tj) * bn;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float scale = scales[tile];
  for (int r = warp; r < bm; r += n_warps) {
    const int8_t* qrow = q + base + size_t(r) * N;
    T* orow = out + base + size_t(r) * N;
#pragma unroll 4
    for (int c = lane * VEC; c < bn; c += 32 * VEC) {
      float v[VEC];
      if constexpr (VEC == 4) {
        const char4 b = *reinterpret_cast<const char4*>(qrow + c);
        v[0] = float(b.x) * scale;
        v[1] = float(b.y) * scale;
        v[2] = float(b.z) * scale;
        v[3] = float(b.w) * scale;
      } else {
        v[0] = float(qrow[c]) * scale;
      }
      store<VEC>(orow + c, v);
    }
  }
}

// Threads per block: the tile's VEC-wide columns of one row, rounded up to
// a warp, times rows, capped at kMaxThreads.
int threads_for(int bm, int bn, int vec) {
  const int per_row = (bn / vec + 31) / 32 * 32;
  long long t = static_cast<long long>(per_row) * bm;
  if (t > kMaxThreads) t = kMaxThreads;
  return static_cast<int>(t < 32 ? 32 : t);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool bad_shape(int M, int N, int bm, int bn) {
  return M <= 0 || N <= 0 || bm <= 0 || bn <= 0 || M % bm || N % bn;
}

template <typename T>
int quantize_typed(const void* x, int8_t* q, float* scales, int M, int N,
                   int bm, int bn, float qmax, cudaStream_t s) {
  const int gn = N / bn;
  const long long tiles = static_cast<long long>(M / bm) * gn;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = bn % 4 == 0 && aligned16(x) && aligned16(q);
  const int threads = threads_for(bm, bn, vec ? 4 : 1);
  const T* xt = static_cast<const T*>(x);
  if (vec)
    quantize_tiles<T, 4><<<unsigned(tiles), threads, 0, s>>>(
        xt, q, scales, N, bm, bn, gn, qmax);
  else
    quantize_tiles<T, 1><<<unsigned(tiles), threads, 0, s>>>(
        xt, q, scales, N, bm, bn, gn, qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dequantize_typed(const int8_t* q, const float* scales, void* out, int M,
                     int N, int bm, int bn, cudaStream_t s) {
  const int gn = N / bn;
  const long long tiles = static_cast<long long>(M / bm) * gn;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = bn % 4 == 0 && aligned16(q) && aligned16(out);
  const int threads = threads_for(bm, bn, vec ? 4 : 1);
  T* ot = static_cast<T*>(out);
  if (vec)
    dequantize_tiles<T, 4><<<unsigned(tiles), threads, 0, s>>>(
        q, scales, ot, N, bm, bn, gn);
  else
    dequantize_tiles<T, 1><<<unsigned(tiles), threads, 0, s>>>(
        q, scales, ot, N, bm, bn, gn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int quantize_launch(const void* x, int8_t* q, float* scales, int M, int N,
                    int bm, int bn, float qmax, int dtype, void* stream) {
  if (bad_shape(M, N, bm, bn)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return quantize_typed<float>(x, q, scales, M, N, bm, bn, qmax, s);
  if (dtype == 1)
    return quantize_typed<__nv_bfloat16>(x, q, scales, M, N, bm, bn, qmax, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out_dtype: 0 = float32, 1 = bfloat16.
int dequantize_launch(const int8_t* q, const float* scales, void* out, int M,
                      int N, int bm, int bn, int out_dtype, void* stream) {
  if (bad_shape(M, N, bm, bn)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return dequantize_typed<float>(q, scales, out, M, N, bm, bn, s);
  if (out_dtype == 1)
    return dequantize_typed<__nv_bfloat16>(q, scales, out, M, N, bm, bn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
