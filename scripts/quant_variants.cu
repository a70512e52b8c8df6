// Launch variants of the quantize pair, timed by scripts/quant_variants.py
// to choose the shipped kernels' launches.  Not part of the port: the
// kernels it runs are src/repro_torch/kernels/csrc/quantize_blocks.cu, which
// keeps one launch per kernel (persistent clusters, no prefetch; one
// 16-byte store a lane, four chunks deep, streaming stores, the card's
// grid).  These variants take the contiguous layout only (N == bn), float32
// x and output, 16-byte aligned pointers; their arithmetic is the shipped
// kernels', so each output is bitwise the plain version's.
//
// quantize_variant_launch: persistent 1 launches as many clusters as the
// card holds, each walking tiles; 0 launches one cluster a tile.  prefetch
// 1 has each CTA ask for its share of the cluster's next tile in L2 before
// it loads the current one.
//
// dequantize_variant_launch: qb bytes of q a chunk (4: one float4 store a
// lane; 16: four float4 a lane, each warp store half of every 32 B
// sector), unroll chunks loaded before the first store (1 or 4), streaming
// (evict-first) stores or not, a grid of `blocks` (<= 0: SMs x resident
// blocks) and an order: span 0 is a grid-stride walk, span > 0 has warp w
// of the grid walk chunks [w span, (w + 1) span) alone.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr float kScaleFloor = 1e-12f;
constexpr int kQThreads = 512;
constexpr int kQElems = 32;
constexpr int kQRound = kQThreads * kQElems;
constexpr int kMaxCluster = 8;
constexpr int kDThreads = 256;

__device__ __forceinline__ int8_t quant(float x, float scale, float qmax) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -qmax), qmax);
  return static_cast<int8_t>(__float2int_rn(r));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

__device__ __forceinline__ void prefetch_l2(const void* p, unsigned n) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
               "r"(n)
               : "memory");
}

// Round r of a thread's elements of a share of S floats (past it: 0).
__device__ __forceinline__ void load_round(const float* xs, int r, int S,
                                           float* v) {
#pragma unroll
  for (int k = 0; k < kQElems / 4; ++k) {
    const int e = r * kQRound + (k * kQThreads + int(threadIdx.x)) * 4;
    const float4 a = e < S ? *reinterpret_cast<const float4*>(xs + e)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    v[4 * k] = a.x; v[4 * k + 1] = a.y; v[4 * k + 2] = a.z; v[4 * k + 3] = a.w;
  }
}

// The shipped quantize_cluster on the contiguous layout, with `prefetch`.
__global__ void __launch_bounds__(kQThreads, 2)
quantize_variant(const float* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ scales, int S, int tiles, int prefetch,
                 float qmax) {
  __shared__ float warp_part[kQThreads / 32];
  __shared__ float part[2];
  __shared__ float tile_scale;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int clusters = static_cast<int>(gridDim.x) / n_cta;
  const int n_rounds = (S + kQRound - 1) / kQRound;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int k = 0;
  for (int tile = static_cast<int>(blockIdx.x) / n_cta; tile < tiles;
       tile += clusters, ++k) {
    const size_t base = (size_t(tile) * n_cta + rank) * size_t(S);
    if (prefetch && threadIdx.x == 0 && tile + clusters < tiles)
      prefetch_l2(x + base + size_t(clusters) * n_cta * S,
                  unsigned(S) * sizeof(float));
    float v[kQElems];
    float m = 0.f;
    for (int r = 0; r < n_rounds; ++r) {
      load_round(x + base, r, S, v);
#pragma unroll
      for (int i = 0; i < kQElems; ++i) m = fmaxf(m, fabsf(v[i]));
    }
    m = warp_max(m);
    if (lane == 0) warp_part[warp] = m;
    __syncthreads();
    if (warp == 0) {
      m = warp_max(warp_part[lane % (kQThreads / 32)]);
      if (lane == 0) part[k & 1] = m;
    }
    cluster.sync();
    if (warp == 0) {
      m = warp_max(lane < n_cta ? cluster.map_shared_rank(part, lane)[k & 1]
                                : 0.f);
      if (lane == 0) {
        const float sc = fmaxf(__fdiv_rn(m, qmax), kScaleFloor);
        tile_scale = sc;
        if (rank == 0) scales[tile] = sc;
      }
    }
    __syncthreads();
    const float scale = tile_scale;
    for (int r = n_rounds - 1; r >= 0; --r) {
      if (r != n_rounds - 1) load_round(x + base, r, S, v);
#pragma unroll
      for (int j = 0; j < kQElems / 4; ++j) {
        const int e = r * kQRound + (j * kQThreads + int(threadIdx.x)) * 4;
        if (e < S) {
          uint32_t w = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            w |= uint32_t(uint8_t(quant(v[4 * j + b], scale, qmax)))
                 << (8 * b);
          *reinterpret_cast<uint32_t*>(q + base + e) = w;
        }
      }
    }
  }
  cluster.sync();
}

// a / d, in 32 bits where both fit
__device__ __forceinline__ size_t div_u(size_t a, size_t d) {
  return ((a | d) >> 32) == 0 ? size_t(unsigned(a) / unsigned(d)) : a / d;
}

template <bool STREAM, typename V>
__device__ __forceinline__ void st(V* p, V v) {
  if constexpr (STREAM)
    __stcs(p, v);
  else
    *p = v;
}

template <int QB, int UNROLL, bool STREAM>
__global__ void __launch_bounds__(kDThreads)
dequantize_variant(const int8_t* __restrict__ q,
                   const float* __restrict__ scales, float* __restrict__ out,
                   size_t chunks, size_t tile_chunks, size_t span) {
  size_t width = kDThreads, me = threadIdx.x;
  size_t start = size_t(blockIdx.x) * kDThreads * UNROLL, end = chunks;
  size_t step = size_t(gridDim.x) * kDThreads * UNROLL;
  if (span) {
    width = 32;
    me = threadIdx.x % 32;
    start = (size_t(blockIdx.x) * (kDThreads / 32) + threadIdx.x / 32) * span;
    end = start + span < chunks ? start + span : chunks;
    step = 32 * UNROLL;
  }
  for (size_t c0 = start + me; c0 < end; c0 += step) {
    uint32_t w[UNROLL][QB / 4];
    float sc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t c = c0 + size_t(u) * width;
      if (c < end) {
        if constexpr (QB == 16) {
          const uint4 a = *reinterpret_cast<const uint4*>(q + c * QB);
          w[u][0] = a.x; w[u][1] = a.y; w[u][2] = a.z; w[u][3] = a.w;
        } else {
          w[u][0] = *reinterpret_cast<const uint32_t*>(q + c * QB);
        }
        sc[u] = __ldg(scales + div_u(c, tile_chunks));
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t c = c0 + size_t(u) * width;
      if (c < end) {
        float v[QB];
#pragma unroll
        for (int i = 0; i < QB; ++i)
          v[i] = __fmul_rn(
              float(int(w[u][i >> 2] << (24 - 8 * (i & 3))) >> 24), sc[u]);
#pragma unroll
        for (int j = 0; j < QB / 4; ++j)
          st<STREAM>(reinterpret_cast<float4*>(out + c * QB) + j,
                     make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2],
                                 v[4 * j + 3]));
      }
    }
  }
}

template <int QB, int UNROLL, bool STREAM>
int launch_dequantize(const int8_t* q, const float* scales, float* out,
                      size_t n, size_t tile, int blocks, size_t span,
                      cudaStream_t s) {
  auto kernel = dequantize_variant<QB, UNROLL, STREAM>;
  const size_t chunks = n / QB;
  if (blocks <= 0) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kDThreads, 0);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t need = (chunks + size_t(kDThreads) * UNROLL - 1) /
                        (size_t(kDThreads) * UNROLL);
    blocks = static_cast<int>(
        need < size_t(sms) * per_sm ? need : size_t(sms) * per_sm);
  }
  kernel<<<blocks, kDThreads, 0, s>>>(q, scales, out, chunks, tile / QB, span);
  return static_cast<int>(cudaGetLastError());
}

template <int QB, int UNROLL>
int dequantize_streaming(const int8_t* q, const float* scales, float* out,
                         size_t n, size_t tile, int streaming, int blocks,
                         size_t span, cudaStream_t s) {
  return streaming ? launch_dequantize<QB, UNROLL, true>(q, scales, out, n,
                                                         tile, blocks, span, s)
                   : launch_dequantize<QB, UNROLL, false>(
                         q, scales, out, n, tile, blocks, span, s);
}

bool bad(int M, int N, int bm, int bn, const void* a, const void* b) {
  return M <= 0 || bm <= 0 || N != bn || M % bm || (size_t(bm) * bn) % 16 ||
         (reinterpret_cast<uintptr_t>(a) & 15u) ||
         (reinterpret_cast<uintptr_t>(b) & 15u);
}

}  // namespace

extern "C" {

int quantize_variant_launch(const float* x, int8_t* q, float* scales, int M,
                            int N, int bm, int bn, float qmax, int persistent,
                            int prefetch, void* stream) {
  if (bad(M, N, bm, bn, x, q)) return static_cast<int>(cudaErrorInvalidValue);
  int c = kMaxCluster;
  while (c > 1 && bm % c) c >>= 1;
  const int tiles = M / bm;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(kQThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = tiles;
  if (persistent) {
    int resident = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&resident, quantize_variant, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (resident < clusters) clusters = resident;
  }
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * c));
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, quantize_variant, x, q, scales, bm / c * bn,
                         tiles, prefetch, qmax);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int dequantize_variant_launch(const int8_t* q, const float* scales,
                              float* out, int M, int N, int bm, int bn,
                              int qb, int unroll, int streaming, int blocks,
                              long long span, void* stream) {
  if (bad(M, N, bm, bn, q, out) || span < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = size_t(M) * N, tile = size_t(bm) * bn;
  const size_t sp = static_cast<size_t>(span);
  if (qb == 16 && unroll == 4)
    return dequantize_streaming<16, 4>(q, scales, out, n, tile, streaming,
                                       blocks, sp, s);
  if (qb == 16 && unroll == 1)
    return dequantize_streaming<16, 1>(q, scales, out, n, tile, streaming,
                                       blocks, sp, s);
  if (qb == 4 && unroll == 4)
    return dequantize_streaming<4, 4>(q, scales, out, n, tile, streaming,
                                      blocks, sp, s);
  if (qb == 4 && unroll == 1)
    return dequantize_streaming<4, 1>(q, scales, out, n, tile, streaming,
                                      blocks, sp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* variant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
