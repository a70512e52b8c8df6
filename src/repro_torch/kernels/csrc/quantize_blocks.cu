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
// rintf rounds half to even as jnp.round and torch.round do, the scale
// floor is applied after the division, and x' is one rounded product.
//
// What bounds it on the H100: bytes.  Quantize must read x once (4 B per
// element in f32, 2 in bf16) and write q (1 B) and one scale per tile;
// dequantize reads q and the scales and writes the output: 5 B per f32
// element either way, 0.526 ms for the largest gradient leaf of
// qwen3-1.7b ([688128, 512], 352 M elements) at 3.35 TB/s.
//
// Layouts.  With N == bn a tile is one contiguous span of bm * bn elements:
// the "contiguous" route, which every call of the approximate collective
// takes (its leaves are padded to [rows, 512]).  With N > bn a tile is bm
// rows of bn at a stride of N: the "strided" route.  The two routes are the
// same kernels with an element's offset computed two ways (CONTIG).
//
// quantize_cluster reads each tile once.  A thread-block cluster of C CTAs
// (C = 8 where 8 divides bm, else 4, 2 or 1) takes a tile, CTA r owning
// rows [r bm/C, (r+1) bm/C): 16384 elements of a 256 x 512 tile, 64 KB in
// f32 (32 KB in bf16), held in registers -- 32 elements a thread of 512,
// every load (16 B a lane, a warp reading 512 contiguous bytes) issued
// before the first use.  The CTA reduces |x| to a partial max and
// publishes it in its shared memory; after a cluster barrier one warp
// reads the C partials through distributed shared memory, so every CTA
// derives the same scale (rank 0 writes it); the CTA then rounds from
// registers and writes q (4 int8 a lane in f32, 8 in bf16: a warp writes
// 128 or 256 contiguous bytes).  5 B per f32 element move, the bound's
// count (the kernel's first version, one block per 512 KB tile, read it
// twice from device memory: 9 B).  Two CTAs an SM (<= 64 registers a
// thread) keep one CTA's loads in flight while the other reduces, waits or
// stores, and the clusters are persistent: as many as the card holds, each
// walking tiles (cluster, cluster + clusters, ...), with the partials
// double-buffered so one cluster barrier a tile suffices.  A share larger
// than 16384 elements (a block beyond 256 x 512) is walked in rounds: the
// last stays in registers, the others are read again.
//
// dequantize_stream reads q once and writes the output once, as one flat
// stream.  A chunk is what a lane writes in one 16-byte store: 4 f32 or 8
// bf16 elements, from a 4- or 8-byte load of q; a warp's store covers 512
// contiguous bytes.  A thread loads four chunks and their scales before
// its first store.  A chunk's scale is scales[chunk / (bm bn / chunk)] on
// the contiguous route and comes from its (row, column) on the strided
// one.  The grid is the card's -- SMs x resident blocks, every block on one
// grid-stride front -- so no leaf ends in a part-empty wave and a one-tile
// leaf spreads over the card.  Stores are streaming (evict-first).
//
// What the timed variants taught (scripts/quant_variants.py, NVIDIA H100
// 80GB HBM3 at 700 W; PERF.md has the numbers): a lane's 16 consecutive
// elements written as four float4 (each warp store half of every 32 B
// sector) run at half the rate of one 16-byte store a lane, and the first
// version's dequantize was slow for the same reason (its unrolled loop
// stored four bytes a lane at a 16 B stride); persistent clusters beat one
// cluster a tile; an L2 prefetch of a cluster's next tile slows quantize.
// Staging the next tile in shared memory (cp.async) spilled at two CTAs an
// SM and ran slower still.
//
// Both take one element a lane where a pointer is not 16-byte aligned or
// the tile's width (contiguous: its size) is not a multiple of the vector.
//
// Interface: plain C, bound with ctypes.  quantize: x [M, N] (dtype 0 =
// float32, 1 = bfloat16) -> q int8 [M, N], scales float32 [M/bm, N/bn];
// dequantize: q, scales -> out [M, N] (out_dtype 0 = float32, 1 =
// bfloat16).  All contiguous; bm divides M and bn divides N (the wrapper
// checks).  The launch goes on the caller's stream; each call returns a
// cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr float kScaleFloor = 1e-12f;

__device__ __forceinline__ int8_t quant(float x, float scale, float qmax) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -qmax), qmax);
  return static_cast<int8_t>(__float2int_rn(r));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool bad_shape(int M, int N, int bm, int bn) {
  return M <= 0 || N <= 0 || bm <= 0 || bn <= 0 || M % bm || N % bn;
}

// ---------------------------------------------------------------- quantize

constexpr int kQThreads = 512;                // two CTAs an SM
constexpr int kQElems = 32;                   // a thread's elements a round
constexpr int kQRound = kQThreads * kQElems;  // a CTA's elements a round
constexpr int kMaxCluster = 8;                // the portable cluster size

// VEC consecutive elements as float: one 16-byte load (VEC 4 in f32, 8 in
// bf16) or one element (VEC 1).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    static_assert(VEC == 1, "float32 loads: VEC 4 or 1");
    v[0] = *p;
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the high bits
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    static_assert(VEC == 1, "bfloat16 loads: VEC 8 or 1");
    v[0] = __bfloat162float(*p);
  }
}

// q of VEC consecutive elements: one 4-byte (VEC 4), 8-byte (VEC 8) or
// 1-byte store.
template <int VEC>
__device__ __forceinline__ void store_q(int8_t* p, const float* v,
                                        float scale, float qmax) {
  if constexpr (VEC == 1) {
    *p = quant(v[0], scale, qmax);
  } else {
    uint32_t w[VEC / 4];
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      w[j] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        w[j] |= uint32_t(uint8_t(quant(v[4 * j + b], scale, qmax)))
                << (8 * b);
    }
    if constexpr (VEC == 4)
      *reinterpret_cast<uint32_t*>(p) = w[0];
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// Offset from the share's first element of its e-th element (the share is
// rows of bn at a stride of N; one span where CONTIG).
template <bool CONTIG>
__device__ __forceinline__ size_t share_offset(int e, int N, int bn) {
  if constexpr (CONTIG) {
    return size_t(e);
  } else {
    const int r = e / bn;
    return size_t(r) * N + (e - r * bn);
  }
}

// Round r of a thread's elements: vector k of thread t is the share's
// elements [r kQRound + (k kQThreads + t) VEC, ... + VEC); past the share
// they read as 0 (no effect on the max).
template <typename T, int VEC, bool CONTIG>
__device__ __forceinline__ void load_round(const T* xs, int r, int S, int N,
                                           int bn, float* v) {
#pragma unroll
  for (int k = 0; k < kQElems / VEC; ++k) {
    const int e = r * kQRound + (k * kQThreads + int(threadIdx.x)) * VEC;
    if (e < S) {
      load_vec<VEC>(xs + share_offset<CONTIG>(e, N, bn), v + k * VEC);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[k * VEC + j] = 0.f;
    }
  }
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// The first element of CTA `rank`'s share of `tile`.
__device__ __forceinline__ size_t share_base(int tile, int gn, int n_cta,
                                             int rank, int rows, int N,
                                             int bn) {
  const int ti = tile / gn, tj = tile - ti * gn;
  return (size_t(ti) * n_cta + rank) * rows * size_t(N) + size_t(tj) * bn;
}

// Clusters of C CTAs walk the tiles (tile = cluster, cluster + clusters,
// ...), CTA r owning rows [r rows, (r + 1) rows) of each.
template <typename T, int VEC, bool CONTIG>
__global__ void __launch_bounds__(kQThreads, 2)
quantize_cluster(const T* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ scales, int N, int bn, int gn, int rows,
                 int tiles, float qmax) {
  __shared__ float warp_part[kQThreads / 32];
  __shared__ float part[2];     // this CTA's max |x| of even / odd tiles
  __shared__ float tile_scale;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int clusters = static_cast<int>(gridDim.x) / n_cta;
  const int S = rows * bn;
  const int n_rounds = (S + kQRound - 1) / kQRound;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  int k = 0;
  for (int tile = static_cast<int>(blockIdx.x) / n_cta; tile < tiles;
       tile += clusters, ++k) {
    const size_t base = share_base(tile, gn, n_cta, rank, rows, N, bn);
    const T* xs = x + base;
    int8_t* qs = q + base;

    float v[kQElems];
    float m = 0.f;
    for (int r = 0; r < n_rounds; ++r) {
      load_round<T, VEC, CONTIG>(xs, r, S, N, bn, v);
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
    // every CTA's partial of this tile is published, and every CTA has
    // read the partials of the tile before (part[k & 1] of the tile two
    // back was free to overwrite)
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
      if (r != n_rounds - 1) load_round<T, VEC, CONTIG>(xs, r, S, N, bn, v);
#pragma unroll
      for (int j = 0; j < kQElems / VEC; ++j) {
        const int e = r * kQRound + (j * kQThreads + int(threadIdx.x)) * VEC;
        if (e < S)
          store_q<VEC>(qs + share_offset<CONTIG>(e, N, bn), v + j * VEC,
                       scale, qmax);
      }
    }
  }
  cluster.sync();  // a CTA's partials outlive the cluster's reads of them
}

int cluster_for(int bm) {
  for (int c = kMaxCluster; c > 1; c >>= 1)
    if (bm % c == 0) return c;
  return 1;
}

// As many clusters as the card holds at once (no more than the tiles),
// each walking tiles.
template <typename T, int VEC, bool CONTIG>
cudaError_t launch_quantize(const T* x, int8_t* q, float* scales, int N,
                            int bm, int bn, int gn, long long tiles,
                            float qmax, cudaStream_t s) {
  auto kernel = quantize_cluster<T, VEC, CONTIG>;
  const int c = cluster_for(bm);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(kQThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int resident[kMaxCluster + 1] = {};  // by cluster size
  if (resident[c] <= 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&resident[c], kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (resident[c] <= 0) return cudaErrorInvalidConfiguration;
  }
  const long long clusters = resident[c] < tiles ? resident[c] : tiles;
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * c));
  return cudaLaunchKernelEx(&cfg, kernel, x, q, scales, N, bn, gn, bm / c,
                            static_cast<int>(tiles), qmax);
}

template <typename T>
int quantize_typed(const void* x, int8_t* q, float* scales, int M, int N,
                   int bm, int bn, float qmax, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int gn = N / bn;
  const long long tiles = static_cast<long long>(M / bm) * gn;
  const int c = cluster_for(bm);
  if (tiles * c > INT_MAX ||
      static_cast<long long>(bm / c) * bn > INT_MAX - kQRound)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const bool vec = bn % VEC == 0 && aligned16(x) && aligned16(q);
  const bool contig = N == bn;
  cudaError_t err;
  if (vec)
    err = contig ? launch_quantize<T, VEC, true>(xt, q, scales, N, bm, bn,
                                                 gn, tiles, qmax, s)
                 : launch_quantize<T, VEC, false>(xt, q, scales, N, bm, bn,
                                                  gn, tiles, qmax, s);
  else
    err = contig ? launch_quantize<T, 1, true>(xt, q, scales, N, bm, bn, gn,
                                               tiles, qmax, s)
                 : launch_quantize<T, 1, false>(xt, q, scales, N, bm, bn, gn,
                                                tiles, qmax, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------- dequantize

constexpr int kDThreads = 256;
constexpr int kDUnroll = 4;  // chunks a thread loads before it stores

// a / d, in 32 bits where both fit
__device__ __forceinline__ size_t div_u(size_t a, size_t d) {
  return ((a | d) >> 32) == 0 ? size_t(unsigned(a) / unsigned(d)) : a / d;
}

// q of QB consecutive elements, as 32-bit words (QB 1: the byte in word 0)
template <int QB>
__device__ __forceinline__ void load_q(const int8_t* p, uint32_t* w) {
  if constexpr (QB == 16) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  } else if constexpr (QB == 8) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    w[0] = a.x; w[1] = a.y;
  } else if constexpr (QB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    static_assert(QB == 1, "q chunks: 16, 8, 4 or 1 bytes");
    w[0] = uint8_t(*p);
  }
}

// element i of the chunk, sign-extended
__device__ __forceinline__ float q_at(const uint32_t* w, int i) {
  return float(int(w[i >> 2] << (24 - 8 * (i & 3))) >> 24);
}

// streaming (evict-first) stores of a chunk's QB elements
template <int QB>
__device__ __forceinline__ void store_out(float* p, const float* v) {
  if constexpr (QB == 1) {
    __stcs(p, v[0]);
  } else {
#pragma unroll
    for (int j = 0; j < QB / 4; ++j)
      __stcs(reinterpret_cast<float4*>(p) + j,
             make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]));
  }
}
template <int QB>
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float* v) {
  if constexpr (QB == 1) {
    __stcs(reinterpret_cast<unsigned short*>(p),
           __bfloat16_as_ushort(__float2bfloat16_rn(v[0])));
  } else {
    static_assert(QB % 8 == 0, "bfloat16 stores: 8 or 16 elements a chunk");
    uint32_t w[QB / 2];
#pragma unroll
    for (int i = 0; i < QB / 2; ++i)
      w[i] = uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))) |
             uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])))
                 << 16;
#pragma unroll
    for (int j = 0; j < QB / 8; ++j)
      __stcs(reinterpret_cast<uint4*>(p) + j,
             make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]));
  }
}

// The tile of chunk c, which starts at element i = c QB.
template <bool CONTIG>
__device__ __forceinline__ size_t tile_of(size_t c, size_t i,
                                          size_t tile_chunks, int N, int bm,
                                          int bn, int gn) {
  if constexpr (CONTIG) {
    return div_u(c, tile_chunks);
  } else {
    const size_t row = div_u(i, size_t(N));
    const int col = static_cast<int>(i - row * N);
    return div_u(row, size_t(bm)) * gn + col / bn;
  }
}

// Chunks of QB elements, kDUnroll a step, on a grid-stride walk: every
// resident block on one moving front of the tensor.
template <typename T, int QB, bool CONTIG>
__global__ void __launch_bounds__(kDThreads)
dequantize_stream(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, T* __restrict__ out,
                  size_t chunks, size_t tile_chunks, int N, int bm, int bn,
                  int gn) {
  const size_t step = size_t(gridDim.x) * kDThreads * kDUnroll;
  for (size_t c0 = size_t(blockIdx.x) * kDThreads * kDUnroll + threadIdx.x;
       c0 < chunks; c0 += step) {
    uint32_t w[kDUnroll][(QB + 3) / 4];
    float sc[kDUnroll];
#pragma unroll
    for (int u = 0; u < kDUnroll; ++u) {
      const size_t c = c0 + size_t(u) * kDThreads;
      if (c < chunks) {
        load_q<QB>(q + c * QB, w[u]);
        sc[u] = __ldg(scales +
                      tile_of<CONTIG>(c, c * QB, tile_chunks, N, bm, bn, gn));
      }
    }
#pragma unroll
    for (int u = 0; u < kDUnroll; ++u) {
      const size_t c = c0 + size_t(u) * kDThreads;
      if (c < chunks) {
        float v[QB];
#pragma unroll
        for (int i = 0; i < QB; ++i) v[i] = __fmul_rn(q_at(w[u], i), sc[u]);
        store_out<QB>(out + c * QB, v);
      }
    }
  }
}

// The card's grid: SMs x resident blocks (no more than the chunks need).
template <typename T, int QB, bool CONTIG>
int launch_dequantize(const int8_t* q, const float* scales, T* out, int M,
                      int N, int bm, int bn, cudaStream_t s) {
  auto kernel = dequantize_stream<T, QB, CONTIG>;
  const size_t chunks = size_t(M) * N / QB;
  static int per_sm = 0;
  if (per_sm <= 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kDThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t need = (chunks + size_t(kDThreads) * kDUnroll - 1) /
                      (size_t(kDThreads) * kDUnroll);
  const size_t blocks = need < size_t(sms) * per_sm ? need
                                                    : size_t(sms) * per_sm;
  kernel<<<static_cast<unsigned>(blocks), kDThreads, 0, s>>>(
      q, scales, out, chunks, size_t(bm) * bn / QB, N, bm, bn, N / bn);
  return static_cast<int>(cudaGetLastError());
}

// A chunk is what one lane writes in one 16-byte store: 4 f32 or 8 bf16
// elements (a warp writes 512 contiguous bytes a store).
template <typename T>
int dequantize_typed(const int8_t* q, const float* scales, void* out, int M,
                     int N, int bm, int bn, cudaStream_t s) {
  constexpr int QB = 16 / sizeof(T);
  T* ot = static_cast<T*>(out);
  const bool contig = N == bn;
  const bool vec = aligned16(q) && aligned16(out) &&
                   (contig ? (size_t(bm) * bn) % QB == 0 : bn % QB == 0);
  if (vec)
    return contig ? launch_dequantize<T, QB, true>(q, scales, ot, M, N, bm,
                                                   bn, s)
                  : launch_dequantize<T, QB, false>(q, scales, ot, M, N, bm,
                                                    bn, s);
  return contig ? launch_dequantize<T, 1, true>(q, scales, ot, M, N, bm, bn, s)
                : launch_dequantize<T, 1, false>(q, scales, ot, M, N, bm, bn,
                                                 s);
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
