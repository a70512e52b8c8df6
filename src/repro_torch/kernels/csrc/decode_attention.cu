// Flash-decode: one-query GQA attention against a preallocated KV cache, for
// sm_90a, in one launch with no scratch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _decode_kernel, pallas_call at :75).  It computes
// the same function: f32 scores of the pre-scaled query against every cache
// row below `length`, an online softmax with f32 running max / sum /
// accumulator, one division by max(l, 1e-37) and one cast to the output
// type.  The TPU kernel walks the whole cache of one (batch, q head) in
// order on one core; here the rows below `length` are cut into up to 8
// splits that run in parallel as the blocks of one thread-block cluster,
// and the cluster's blocks merge their partial (m, l, acc) through
// distributed shared memory, in rank order.  Every sum runs in a fixed
// order, so two calls on the same inputs are equal bit for bit.
//
// What bounds it on the H100: bytes.  A step reads each valid K and V row
// once (B * length * KH * D * 2 values) for 4 FLOP per value per q head of
// the group, far below the ridge.  One block serves all `group` q heads of
// its kv head from one read of each row, and rows at or past `length` are
// never touched.  `length` is a host integer (the port's KVCache keeps it on
// the host, so a step needs no device-to-host read); the grid is sized from
// it.  To keep bytes in flight, a block stages a chunk of its K and V rows
// into shared memory with 16-byte cp.async copies, all issued before the
// score pass (K first, so the score pass waits only for K while V lands).
// A chunk holds at most ~48 KB, so four blocks fit on an SM: the serving
// grid (8 batches x 8 kv heads x 8 splits = 512 blocks) is resident on the
// 132 SMs in one wave, with no thin last wave.
//
// Design (128 threads; one cluster of n_split blocks per (kv head, batch)):
// the group's queries are staged pre-scaled in shared memory.  Score pass:
// each thread owns one cache row of the chunk (K rows padded by 16 bytes so
// a quarter warp's 16-byte reads hit distinct banks); the block reduces the
// max and the sum of exp per q head through shared memory in warp order.
// Value pass: each thread owns one 16-byte column group and a residue class
// of the chunk's rows, so a warp reads whole V rows; the partial sums over
// the row classes are added in class order at the end.  Where the column
// groups do not divide the 128 threads (D = 112: 14 groups of bf16, 28 of
// float32), the last NT % NCG threads form no whole class: they load and add
// nothing in the value pass.  Chunks of one split follow each other with
// the running (m, l, acc) rescaled, as in the TPU kernel's grid loop.
//
// Interface: plain C, bound with ctypes.  q [B, 1, QH, D]; caches
// [B, S_max, KH, D]; out [B, 1, QH, D]; all contiguous, of one type
// (0 = float32, 1 = bfloat16), 16-byte aligned; D in {16, 32, 64, 112, 128};
// QH / KH in {1, 2, 4, 8}.  The launch goes on the caller's stream and
// returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
constexpr int MAX_SPLIT = 8;  // blocks per cluster (the portable limit)
constexpr int CHUNK_BYTES = 48 * 1024;
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
  static __device__ __forceinline__ void load(const void* p, float* out) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    out[0] = w.x;
    out[1] = w.y;
    out[2] = w.z;
    out[3] = w.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const void* p, float* out) {
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

// Shared-memory plan of one (T, D, G) instance.
template <typename T, int D, int G>
struct Plan {
  static constexpr int ROW = D * int(sizeof(T));  // bytes of a cache row
  static constexpr int KROW = ROW + 16;           // padded K row
  static constexpr int NCG = ROW / 16;            // 16-byte column groups
  static constexpr int NRC = NT / NCG;            // row classes (value pass)
  static constexpr int NVT = NRC * NCG;           // value-pass threads
  static constexpr int RAW = CHUNK_BYTES / (KROW + ROW);
  static constexpr int CHUNK = RAW >= 256 ? 256 : RAW / 16 * 16;  // rows
  static constexpr int STAGE = CHUNK * (KROW + ROW);  // K then V
  static constexpr int RED = NRC * G * D * 4;  // value-pass partials (f32)
  static constexpr int BUF = STAGE > RED ? STAGE : RED;
  // after the buffer (f32): Q [G][D], P [G][CHUNK], the block reductions
  // [G][NW], and the split's partial result m [G], l [G], acc [G][D]
  static constexpr int SMEM =
      BUF + 4 * (G * D + G * CHUNK + G * NW + 2 * G + G * D);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block-wide reduction of one value per q head (max or sum), in a fixed
// order: within each warp by shuffles, then over the warps in index order.
template <int G, bool MAX>
__device__ __forceinline__ void block_reduce(float (&x)[G], float* red) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[g], off);
      x[g] = MAX ? fmaxf(x[g], y) : x[g] + y;
    }
    if (lane == 0) red[g * NW + w] = x[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float r = red[g * NW];
#pragma unroll
    for (int i = 1; i < NW; ++i)
      r = MAX ? fmaxf(r, red[g * NW + i]) : r + red[g * NW + i];
    x[g] = r;
  }
  __syncthreads();  // red is reused by the next reduction
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(NT)
decode_fused(const T* __restrict__ q, const T* __restrict__ kc,
             const T* __restrict__ vc, T* __restrict__ out, int S_max, int KH,
             int length, int rows_per_split, float scale) {
  using P = Plan<T, D, G>;
  constexpr int N = Vec<T>::N;
  extern __shared__ float4 smem4[];
  uint8_t* buf = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* Ks = buf;                            // [CHUNK][KROW]
  uint8_t* Vs = buf + P::CHUNK * P::KROW;       // [CHUNK][ROW]
  float* red_acc = reinterpret_cast<float*>(buf);  // [NRC][G][D], reuses buf
  float* Qs = reinterpret_cast<float*>(buf + P::BUF);  // [G][D]
  float* Ps = Qs + G * D;                          // [G][CHUNK]
  float* red = Ps + G * P::CHUNK;                  // [G][NW]
  float* part_m = red + G * NW;                    // [G]
  float* part_l = part_m + G;                      // [G]
  float* part_acc = part_l + G;                    // [G][D]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int kh = blockIdx.y, b = blockIdx.z;
  const int QH = KH * G;
  const int tid = threadIdx.x;
  const int r_begin = split * rows_per_split;
  const int r_end = min(length, r_begin + rows_per_split);

  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    Qs[i] = to_f(q[(size_t(b) * QH + kh * G + g) * D + d]) * scale;
  }

  const size_t row = size_t(KH) * D;  // elements between cache rows
  const T* kb = kc + size_t(b) * S_max * row + size_t(kh) * D;
  const T* vb = vc + size_t(b) * S_max * row + size_t(kh) * D;
  const int cg_ = tid % P::NCG, rc = tid / P::NCG;  // value-pass role
  const bool valued = tid < P::NVT;  // in a whole row class

  float m[G], l[G], acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[g][e] = 0.f;
  }

  for (int c0 = r_begin; c0 < r_end; c0 += P::CHUNK) {
    const int nr = min(P::CHUNK, r_end - c0);
    __syncthreads();  // the previous chunk's K, V and P are consumed
    for (int i = tid; i < nr * P::NCG; i += NT) {
      const int r = i / P::NCG, p = i % P::NCG;
      cp_async16(Ks + r * P::KROW + 16 * p,
                 kb + size_t(c0 + r) * row + p * (16 / sizeof(T)));
    }
    cp_async_commit();
    for (int i = tid; i < nr * P::NCG; i += NT) {
      const int r = i / P::NCG, p = i % P::NCG;
      cp_async16(Vs + r * P::ROW + 16 * p,
                 vb + size_t(c0 + r) * row + p * (16 / sizeof(T)));
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's K copies have landed
    __syncthreads();     // everyone's K copies (and Qs)

    // score pass: thread tid owns rows tid, tid + NT, ... of the chunk
    float mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) mx[g] = NEG_INF;
    for (int r = tid; r < nr; r += NT) {
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
      const uint8_t* kr = Ks + r * P::KROW;
#pragma unroll
      for (int p = 0; p < P::NCG; ++p) {
        float kv[N];
        Vec<T>::load(kr + 16 * p, kv);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < N; ++e)
            s[g] = fmaf(Qs[g * D + p * N + e], kv[e], s[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        Ps[g * P::CHUNK + r] = s[g];
        mx[g] = fmaxf(mx[g], s[g]);
      }
    }
    block_reduce<G, true>(mx, red);  // its barriers also publish Ps
    float alpha[G], ls[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_new = fmaxf(m[g], mx[g]);
      alpha[g] = expf(m[g] - m_new);
      m[g] = m_new;
      ls[g] = 0.f;
    }
    for (int r = tid; r < nr; r += NT) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = expf(Ps[g * P::CHUNK + r] - m[g]);
        Ps[g * P::CHUNK + r] = p;
        ls[g] += p;
      }
    }
    block_reduce<G, false>(ls, red);  // its barriers also publish Ps
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l[g] = l[g] * alpha[g] + ls[g];
#pragma unroll
      for (int e = 0; e < N; ++e) acc[g][e] *= alpha[g];
    }
    cp_async_wait<0>();
    __syncthreads();  // everyone's V copies

    // value pass: column group cg_ of rows rc, rc + NRC, ...
    for (int r = valued ? rc : nr; r < nr; r += P::NRC) {
      float vv[N];
      Vec<T>::load(Vs + r * P::ROW + 16 * cg_, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = Ps[g * P::CHUNK + r];
#pragma unroll
        for (int e = 0; e < N; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
      }
    }
  }

  // the split's partial result: acc summed over the row classes in order
  __syncthreads();  // the chunk buffer is free
  if (valued) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < N; ++e)
        red_acc[(rc * G + g) * D + cg_ * N + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    float a = 0.f;
    for (int c = 0; c < P::NRC; ++c) a += red_acc[c * G * D + i];
    part_acc[i] = a;
  }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      part_m[g] = m[g];
      part_l[g] = l[g];
    }
  }
  cluster.sync();  // every split's partial result is in its shared memory

  // the merge, its outputs spread over the cluster's blocks: each output
  // reads every split's partial (all loads issued before the sums) and
  // adds them in rank order (a split past n_split weighs exactly 0)
  for (int i = split * NT + tid; i < G * D; i += n_split * NT) {
    const int g = i / D;
    float pm[MAX_SPLIT], pl[MAX_SPLIT], pa[MAX_SPLIT];
#pragma unroll
    for (int j = 0; j < MAX_SPLIT; ++j) {
      pm[j] = NEG_INF;
      pl[j] = 0.f;
      pa[j] = 0.f;
      if (j < n_split) {
        pm[j] = cluster.map_shared_rank(part_m, j)[g];
        pl[j] = cluster.map_shared_rank(part_l, j)[g];
        pa[j] = cluster.map_shared_rank(part_acc, j)[i];
      }
    }
    float mm = pm[0];
#pragma unroll
    for (int j = 1; j < MAX_SPLIT; ++j) mm = fmaxf(mm, pm[j]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SPLIT; ++j) {
      const float w = expf(pm[j] - mm);
      ll = fmaf(pl[j], w, ll);
      aa = fmaf(pa[j], w, aa);
    }
    out[(size_t(b) * QH + kh * G) * D + i] =
        from_f<T>(aa / fmaxf(ll, 1e-37f));
  }
  cluster.sync();  // the other splits' shared memory outlives the reads
}

// Splits: at most MAX_SPLIT, and no more than the chunks the rows fill.
template <typename T, int D, int G>
int launch(const void* q, const void* kc, const void* vc, void* out, int B,
           int S_max, int KH, int length, float scale, cudaStream_t stream) {
  using P = Plan<T, D, G>;
  const int n_split =
      min(MAX_SPLIT, (length + P::CHUNK - 1) / P::CHUNK);
  const int rows_per_split = (length + n_split - 1) / n_split;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_fused<T, D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, KH, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = n_split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_fused<T, D, G>, static_cast<const T*>(q),
      static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<T*>(out), S_max, KH, length, rows_per_split, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_g(const void* q, const void* kc, const void* vc, void* out, int B,
             int S_max, int KH, int G, int length, float scale,
             cudaStream_t s) {
  switch (G) {
    case 1:
      return launch<T, D, 1>(q, kc, vc, out, B, S_max, KH, length, scale, s);
    case 2:
      return launch<T, D, 2>(q, kc, vc, out, B, S_max, KH, length, scale, s);
    case 4:
      return launch<T, D, 4>(q, kc, vc, out, B, S_max, KH, length, scale, s);
    case 8:
      return launch<T, D, 8>(q, kc, vc, out, B, S_max, KH, length, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_d(const void* q, const void* kc, const void* vc, void* out, int B,
             int S_max, int KH, int G, int D, int length, float scale,
             cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_g<T, 16>(q, kc, vc, out, B, S_max, KH, G, length, scale,
                             s);
    case 32:
      return launch_g<T, 32>(q, kc, vc, out, B, S_max, KH, G, length, scale,
                             s);
    case 64:
      return launch_g<T, 64>(q, kc, vc, out, B, S_max, KH, G, length, scale,
                             s);
    case 112:
      return launch_g<T, 112>(q, kc, vc, out, B, S_max, KH, G, length,
                              scale, s);
    case 128:
      return launch_g<T, 128>(q, kc, vc, out, B, S_max, KH, G, length,
                              scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int da_launch(const void* q, const void* kc, const void* vc, void* out, int B,
              int S_max, int QH, int KH, int D, int length, float scale,
              int dtype, void* stream) {
  if (B <= 0 || KH <= 0 || QH % KH != 0 || length < 1 || length > S_max)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = QH / KH;
  if (dtype == 0)
    return launch_d<float>(q, kc, vc, out, B, S_max, KH, G, D, length, scale,
                           s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, kc, vc, out, B, S_max, KH, G, D, length,
                                   scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* da_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
