// RWKV-6 wkv recurrence (the gated linear scan) for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/linear_scan.py::
// wkv_linear_scan (body _wkv_kernel, pallas_call at :81).  Per (batch, head),
// with a [K, V = K] float32 state S that starts at state0 (zero when none is
// given, the TPU kernel's case):
//
//     y_t[v]   = sum_k r_t[k] * (S[k][v] + u[k] * k_t[k] * v_t[v])
//     S[k][v]  = exp(logw_t[k]) * S[k][v] + k_t[k] * v_t[v]
//
// in float32, in the order of the step-by-step oracle (repro.kernels.ref::
// wkv_ref), then y cast to the inputs' type; the final S is written out.
// The TPU kernel walks the sequence of one (batch, head) in order on one
// core, in chunks whose intra-chunk part is a decay-weighted matmul; here
// the serial loop over t runs inside one block, one step at a time.
//
// What bounds it on the H100: bytes.  At the serving prefill shape (B=8,
// S=1024, H=32, K=64, bf16 r/k/v) it must read r, k, v and logw once and
// write y once (~201 MB) plus the state in and out (8.4 MB): ~0.063 ms at
// 3.35 TB/s, against 4 FLOP per (b, t, h, k, v), 4.3 GFLOP.  A decode step
// (S = 1) only moves the state: 8.4 MB, ~2.5 us.
//
// Design (the simple first version): one block per (batch, head) and one
// thread per value column v.  The thread keeps its column S[:, v] (K
// floats) in registers, which is why K is a template parameter (16, 32,
// 64): the loop over k is unrolled at compile time so the state never
// leaves registers.  At each t the block stages r_t, k_t and
// w_t = expf(logw_t) in shared memory (each thread one k), double-buffered
// so one barrier per step suffices, and each thread loads its next step's
// values into registers before it computes the current one, so the global
// loads of step t+1 overlap step t's arithmetic.  u sits in shared memory
// for the whole run.  The serial dependency is the price: every step is a
// barrier plus a K-long chain of FMAs for y, and at the serving shape the
// grid is B*H = 256 blocks of 64 threads, a thin load for 132 SMs (about
// four warps per SM), so the kernel is latency bound well above its byte
// bound.  The chunked form on the tensor cores, and more threads per
// (batch, head) (k split across warps, y reduced across them), are the
// next steps.
//
// Interface: plain C, bound with ctypes.  r, k, v [B, S, H, K] of one type
// (0 = float32, 1 = bfloat16); logw [B, S, H, K] float32 (<= 0); u [H, K]
// float32; state0 [B, H, K, K] float32 or null (zero); y [B, S, H, K] in
// r's type; state_out [B, H, K, K] float32.  All contiguous; K in
// {16, 32, 64}; S >= 1.  The launch goes on the caller's stream; the call
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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

template <typename T, int K>
__global__ void __launch_bounds__(K)
wkv_scan(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ logw,
         const float* __restrict__ u, const float* __restrict__ state0,
         T* __restrict__ y, float* __restrict__ state_out, int S, int H) {
  __shared__ float sr[2][K], sk[2][K], sw[2][K];
  __shared__ float su[K];

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int i = threadIdx.x;  // this thread's k for staging, v for the state

  // the state's column i: S[kk][i] for every kk, row-major [K][K]
  const size_t sbase = size_t(bh) * K * K;
  float st[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    st[kk] = state0 ? state0[sbase + size_t(kk) * K + i] : 0.f;
  su[i] = u[h * K + i];

  const size_t step = size_t(H) * K;              // elements between t's
  const size_t base = (size_t(b) * S * H + h) * K + i;  // (b, 0, h, i)
  float pr = to_f(r[base]), pk = to_f(k[base]), pv = to_f(v[base]);
  float pw = logw[base];

  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    sr[buf][i] = pr;
    sk[buf][i] = pk;
    sw[buf][i] = expf(pw);
    const float vt = pv;
    // One barrier a step: step t writes buffer t & 1, which no thread
    // reads any more -- its last readers ran step t - 2, before the
    // barrier of step t - 1.
    __syncthreads();
    if (t + 1 < S) {
      const size_t nx = base + size_t(t + 1) * step;
      pr = to_f(r[nx]);
      pk = to_f(k[nx]);
      pv = to_f(v[nx]);
      pw = logw[nx];
    }
    float acc = 0.f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const float kv = sk[buf][kk] * vt;
      acc = fmaf(sr[buf][kk], fmaf(su[kk], kv, st[kk]), acc);
      st[kk] = fmaf(sw[buf][kk], st[kk], kv);
    }
    y[base + size_t(t) * step] = from_f<T>(acc);
  }
#pragma unroll
  for (int kk = 0; kk < K; ++kk) state_out[sbase + size_t(kk) * K + i] = st[kk];
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* state0, void* y, float* state_out,
           int B, int S, int H, cudaStream_t stream) {
  wkv_scan<T, K><<<B * H, K, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, state0, static_cast<T*>(y),
      state_out, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* state0, void* y, float* state_out,
             int B, int S, int H, int K, cudaStream_t s) {
  switch (K) {
    case 16:
      return launch<T, 16>(r, k, v, logw, u, state0, y, state_out, B, S, H,
                           s);
    case 32:
      return launch<T, 32>(r, k, v, logw, u, state0, y, state_out, B, S, H,
                           s);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, state0, y, state_out, B, S, H,
                           s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int wkv_launch(const void* r, const void* k, const void* v, const float* logw,
               const float* u, const float* state0, void* y, float* state_out,
               int B, int S, int H, int K, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_k<float>(r, k, v, logw, u, state0, y, state_out, B, S, H, K,
                           s);
  if (dtype == 1)
    return launch_k<__nv_bfloat16>(r, k, v, logw, u, state0, y, state_out, B,
                                   S, H, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
