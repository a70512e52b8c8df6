// Blockwise (flash) GQA attention for sm_90a, causal or full.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel, pallas_call at :95).  It computes the
// same function: f32 scores of the pre-scaled query against each key, an
// online softmax with f32 running max / sum / accumulator, keys masked at
// k_pos >= Sk and, when causal, where q_pos < k_pos (top-left aligned, as
// the TPU kernel's iota mask), the kv loop stopped at the causal frontier,
// one division by max(l, 1e-37) at the end and one cast to the output type.
// The TPU kernel's (256, 512) blocks and its padding of q/k are TPU
// constraints and are not carried over: here a block owns 64 query rows of
// one (batch, q head) and streams 64-key tiles of kv head qh / group.
//
// What bounds it on the H100: at the serving shape (B=8, S=1024, QH=16,
// KH=8, D=128, bf16) the work is ~34 GFLOP against ~8 MB of inputs and
// outputs, so operations, not bytes.  This first version runs both products
// on the f32 CUDA cores (67 TFLOP/s peak, not the 989 TFLOP/s of the bf16
// tensor cores the bound is stated against): it is simple and exact in f32.
// Moving Q.K^T and P.V onto wgmma is a later step.
//
// Design: 256 threads as a 16x16 grid; thread (ty, tx) owns query rows
// ty + 16 i (i < 4) and, of the 64x64 score tile, key columns tx + 16 j.
// Q (pre-scaled) and one K or V tile at a time live in shared memory as f32,
// rows padded by 4 floats so the float4 reads along D hit distinct banks;
// K and V share one buffer (the score product ends before V is staged).
// Row max and sum reduce over the 16 lanes of a half warp with shuffles.
// P goes through shared memory for the P.V product, where each thread owns
// D/16 output columns per row.  Nothing is carried between blocks.
//
// Interface: plain C, bound with ctypes.  q [B, Sq, QH, D], k/v
// [B, Sk, KH, D], o [B, Sq, QH, D], all contiguous and of one type
// (0 = float32, 1 = bfloat16); D in {16, 32, 64, 128}.  The launch goes on
// the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // keys per tile
constexpr int NT = 256;     // threads per block (16 x 16)
constexpr int PS = BK + 4;  // padded row of the P tile
constexpr float NEG_INF = -2.3819763e38f;  // the TPU kernel's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Q tile, one K-or-V tile (rows padded to D + 4), the P tile
  return sizeof(float) * (size_t(BQ) * (D + 4) + size_t(BK) * (D + 4) +
                          size_t(BQ) * PS);
}

// Output column of the c-th value a thread owns (D/16 per row).  With at
// least 4 per thread they come as float4 groups: 4 tx + 64 g + e, so a
// quarter warp's float4 reads of a V row hit distinct banks.
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (D / 16 >= 4) {
    return 4 * tx + 64 * (c / 4) + (c % 4);
  } else {
    return tx + 16 * c;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int QH,
          int KH, float scale, int causal) {
  constexpr int DS = D + 4;   // padded row of the Q and K/V tiles
  constexpr int NC = D / 16;  // output columns per thread and row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][DS]
  float* KVs = Qs + BQ * DS;                    // [BK][DS]
  float* Ps = KVs + BK * DS;                    // [BQ][PS]

  const int q0 = blockIdx.x * BQ;
  const int qh = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = qh / (QH / KH);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // Q tile, pre-scaled as the TPU kernel does (q.astype(f32) * scale);
  // rows past Sq are zero and never written back.
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int qp = q0 + r;
    float x = 0.f;
    if (qp < Sq) x = to_f(q[((size_t(b) * Sq + qp) * QH + qh) * D + c]) * scale;
    Qs[r * DS + c] = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int hi = causal ? min(q0 + BQ, Sk) : Sk;
  const int n_kv = (hi + BK - 1) / BK;
  const size_t kv_row = size_t(KH) * D;
  const T* kb = k + size_t(b) * Sk * kv_row + size_t(kh) * D;
  const T* vb = v + size_t(b) * Sk * kv_row + size_t(kh) * D;

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's V and P are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int kp = k0 + r;
      KVs[r * DS + c] = kp < Sk ? to_f(kb[size_t(kp) * kv_row + c]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 scores
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * DS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * DS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // mask, then the online softmax per row (16 lanes share a row)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < Sk && (!causal || qp >= kp);
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // scores done with K; P written

    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int kp = k0 + r;
      KVs[r * DS + c] = kp < Sk ? to_f(vb[size_t(kp) * kv_row + c]) : 0.f;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PS + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = &KVs[(kk + u) * DS];
        float vv[NC];
        if constexpr (NC >= 4) {
#pragma unroll
          for (int g = 0; g < NC / 4; ++g) {
            const float4 w =
                *reinterpret_cast<const float4*>(&vrow[4 * tx + 64 * g]);
            vv[4 * g] = w.x;
            vv[4 * g + 1] = w.y;
            vv[4 * g + 2] = w.z;
            vv[4 * g + 3] = w.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c) vv[c] = vrow[out_col<D>(tx, c)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pa[i].x
                        : u == 1 ? pa[i].y
                        : u == 2 ? pa[i].z
                                 : pa[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-37f);
    T* orow = o + ((size_t(b) * Sq + qp) * QH + qh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      orow[out_col<D>(tx, c)] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int QH, int KH, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block's shared memory must be asked for explicitly
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + BQ - 1) / BQ, QH, B);
  flash_fwd<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, QH, KH, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int QH, int KH, int D, float scale, int causal,
             cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Sq, Sk, QH, KH, scale, causal,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Sk, QH, KH, scale, causal,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, QH, KH, scale, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, QH, KH, scale, causal,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int fa_launch(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int QH, int KH, int D, float scale, int causal,
              int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || QH % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, Sq, Sk, QH, KH, D, scale, causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, QH, KH, D, scale,
                                   causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
