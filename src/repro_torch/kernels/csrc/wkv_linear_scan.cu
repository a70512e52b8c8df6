// RWKV-6 wkv recurrence (the gated linear scan) for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/linear_scan.py::
// wkv_linear_scan (body _wkv_kernel, pallas_call at :81).  Per (batch, head),
// with a [K, V = K] float32 state S that starts at state0 (zero when none is
// given, the TPU kernel's case):
//
//     y_t[v]   = sum_k r_t[k] * S[k][v]  +  a_t * v_t[v],
//                a_t = sum_k r_t[k] * u[k] * k_t[k]        (the bonus term)
//     S[k][v]  = exp(logw_t[k]) * S[k][v] + k_t[k] * v_t[v]
//
// in float32 (S_{t-1} in y_t), then y cast to the inputs' type; the final S
// is written out.  The TPU kernel walks the sequence of one (batch, head) in
// order on one core, in chunks whose intra-chunk part is a decay-weighted
// matmul; here the serial loop over t runs inside one block.
//
// What bounds it on the H100.  Bytes: at the serving prefill shape (B=8,
// S=1024, H=32, K=64, bf16 r/k/v) it must read r, k, v and logw once and
// write y once plus the state in and out, 209.7 MB: 0.0626 ms at 3.35 TB/s.
// A decode step (S = 1) moves the state alone, 8.4 MB: 2.5 us.  The exact
// recurrence costs 3 FP32 instructions per (b, t, h, k, v) -- the y
// product, k*v and the state FMA -- 3.2e9 at the prefill shape, 0.096 ms at
// 33.5 T instructions/s: that floor, not the bytes, is what this form can
// reach.
//
// Why not the tensor cores.  The chunked form's decay exp(cum_{t-1}[t,k] -
// cum[s,k]) is per channel k, so inside a chunk it is an einsum over (t, s,
// k), not a matrix product.  Factoring it into one needs exp(-cum) factors,
// which overflow float32 once a chunk's decay passes about -88 (logw is
// bounded above by 0 only) and round the state far coarser than the 1e-4
// of max |S| the port holds the kernel to; TF32 or bf16 products would
// break that limit too.  So this is an exact FFMA scan in float32.
//
// Design.  A block takes one (batch, head) -- or 1/VS of its v columns, VS
// blocks a head -- and a thread owns S[kq*KS .. kq*KS + KS)[v0 .. v0 + NV):
// KQ lanes split k (KS = K/KQ rows each), NV columns a thread, all in
// registers.  The partial y over a lane's k-slice is completed across its
// KQ lanes by a reduce-scatter (NV - 1 shuffles leave each lane one
// column, which it stores); the bonus term is the one scalar a_t a step.
// TC steps are staged at a time in shared memory, double-buffered: r, k
// and w = expf(logw) as float32 (converted once), v of the block's
// columns, and a_t, computed while staging (each 8-element unit's share of
// r*u*k, summed over the row's lanes).  The next chunk's global loads (16 B
// a lane) sit in registers during this chunk's arithmetic, and one barrier
// a chunk replaces the barrier a step.  r, k and w are stored permuted, so
// that a lane reads its k-slice as float4s and the KQ addresses a warp
// reads at once lie side by side in distinct banks: 3*KS/4 LDS.128 a step
// for KS*NV (k, v) pairs, where the first version issued four scalar loads
// per pair.  y goes out a chunk at a time through shared memory in 16-byte
// stores of the inputs' type; state0 comes in and the final state goes out
// as NV-wide vector loads and stores of each owned row (16 bytes at NV =
// 4).  A single step (S = 1, a decode step) takes its own path: the lane's
// k-slice of r, k, logw and u straight from global memory, no staging, no
// barrier and no shared memory, the state's loads first and its stores
// last.  The launch
// constants (Config below: at K = 64, 4 lanes x 4 columns, 64 threads a
// head, 16 steps a chunk) were chosen among the variants of
// scripts/wkv_variants.py, which instantiates this template.
//
// Interface: plain C, bound with ctypes.  r, k, v [B, S, H, K] of one type
// (0 = float32, 1 = bfloat16); logw [B, S, H, K] float32 (<= 0); u [H, K]
// float32; state0 [B, H, K, K] float32 or null (zero); y [B, S, H, K] in
// r's type; state_out [B, H, K, K] float32.  All contiguous and 16-byte
// aligned; K in {16, 32, 64}; S >= 1.  One launch on the caller's stream, no
// scratch; the call returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace wkv {

// 8 consecutive elements of r, k or v: 16 B of bf16, 32 B of float32.
template <typename T> struct Vec8 {
  uint4 raw[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ void load8(Vec8<T>& d, const T* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < int(sizeof(T)) / 2; ++i) d.raw[i] = __ldg(q + i);
}

__device__ __forceinline__ void to_f8(const Vec8<float>& s, float* f) {
  const float* x = reinterpret_cast<const float*>(s.raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = x[e];
}
__device__ __forceinline__ void to_f8(const Vec8<__nv_bfloat16>& s,
                                      float* f) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(s.raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 p = __bfloat1622float2(x[e]);
    f[2 * e] = p.x;
    f[2 * e + 1] = p.y;
  }
}

// 16 bytes of y in its type from float32: 4 float32 or 8 bf16 values.
__device__ __forceinline__ uint4 from_f16B(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 from_f16B(const float* f, __nv_bfloat16) {
  uint4 o;
  uint32_t* w = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
    w[e] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return o;
}

// Geometry of one launch configuration.
template <typename T, int K, int KQ, int NV, int VS, int TC>
struct Geo {
  static constexpr int kHead = K, kLanes = KQ, kCols = NV;
  static constexpr int KS = K / KQ;              // k rows a lane
  static constexpr int VB = K / VS;              // v columns a block
  static constexpr int kThreads = KQ * VB / NV;
  static constexpr int kRowUnits = K / 8;        // 8-element units a row
  static constexpr int kUnits = TC * kRowUnits;  // staged units a chunk
  static constexpr int kUnitIters = kUnits / kThreads;
  static constexpr int kYElems = 16 / sizeof(T);  // y elements a store
  static constexpr int kYUnits = TC * VB / kYElems;
  // one buffer (floats): r, k, w [TC][K] permuted; v, y [TC][VB]; a [TC]
  static constexpr int kR = 0, kK = TC * K, kW = 2 * TC * K;
  static constexpr int kV = 3 * TC * K, kY = kV + TC * VB;
  static constexpr int kA = kY + TC * VB;
  static constexpr int kBuf = kA + TC;
  static constexpr int kSmemBytes = 2 * kBuf * 4;
  static_assert(KS % 4 == 0 && VB % NV == 0 && VB % 8 == 0, "geometry");
  static_assert(kUnits % kThreads == 0, "units a thread");
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
  static_assert(TC % 4 == 0, "float4 rows");
  static_assert((NV == 1 || NV == 2 || NV == 4 || NV == 8) && NV <= KQ,
                "NV");
};

// Where k lands in a permuted row: lane kq's float4 j at j*KQ*4 + kq*4.
template <int KQ, int KS>
__device__ __forceinline__ int perm(int kk) {
  const int kq = kk / KS, i = kk - kq * KS;
  return (i >> 2) * (KQ * 4) + kq * 4 + (i & 3);
}

// NV consecutive floats in 16-byte pieces (8- or 4-byte below NV = 4).
template <int NV> struct VecNV { using type = float4; };
template <> struct VecNV<2> { using type = float2; };
template <> struct VecNV<1> { using type = float; };

template <int NV, bool kGlobal>
__device__ __forceinline__ void load_nv(const float* p, float* x) {
  using V = typename VecNV<NV>::type;
  constexpr int W = sizeof(V) / 4;
#pragma unroll
  for (int i = 0; i < NV / W; ++i) {
    const V* q = reinterpret_cast<const V*>(p) + i;
    const V val = kGlobal ? __ldg(q) : *q;
    const float* f = reinterpret_cast<const float*>(&val);
#pragma unroll
    for (int n = 0; n < W; ++n) x[i * W + n] = f[n];
  }
}

template <int NV>
__device__ __forceinline__ void store_nv(float* p, const float* x) {
  using V = typename VecNV<NV>::type;
  constexpr int W = sizeof(V) / 4;
#pragma unroll
  for (int i = 0; i < NV / W; ++i) {
    V val;
    float* f = reinterpret_cast<float*>(&val);
#pragma unroll
    for (int n = 0; n < W; ++n) f[n] = x[i * W + n];
    reinterpret_cast<V*>(p)[i] = val;
  }
}

// y's partial sums of NV columns (acc) over the KQ lanes of a column
// group, completed in lane kq for column kq % NV: a reduce-scatter over
// the lanes' low bits (NV - 1 shuffles), then a butterfly over the others.
// Per column the sum is ((p0 + p2) + (p1 + p3)) at KQ = 4.
template <int KQ, int NV>
__device__ __forceinline__ float reduce_y(float (&acc)[NV], int kq) {
#pragma unroll
  for (int m = NV; m > 1; m >>= 1) {
    const bool up = kq & (m / 2);
#pragma unroll
    for (int i = 0; i < m / 2; ++i) {
      const float send = up ? acc[i] : acc[i + m / 2];
      const float keep = up ? acc[i + m / 2] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, m / 2);
    }
  }
#pragma unroll
  for (int o = NV; o < KQ; o <<= 1)
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
  return acc[0];
}

// One step of a thread's slice: returns y_t for column kq % NV from
// S_{t-1}, then updates S.  rj(j), kj(j), wj(j) give the float4 j of the
// lane's k-slice of r_t, k_t and w_t; vv the step's v of the thread's NV
// columns, vmine that of column kq % NV, at the bonus scalar a_t.
template <class G, class RF, class KF, class WF>
__device__ __forceinline__ float step(float (&st)[G::KS][G::kCols], RF rj,
                                      KF kj, WF wj, const float* vv,
                                      float vmine, float at, int kq) {
  constexpr int KQ = G::kLanes, NV = G::kCols, KS = G::KS;
  float acc[NV];
#pragma unroll
  for (int n = 0; n < NV; ++n) acc[n] = 0.f;
#pragma unroll
  for (int j = 0; j < KS / 4; ++j) {
    const float4 rr = rj(j);
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      acc[n] = fmaf(rr.x, st[4 * j][n], acc[n]);
      acc[n] = fmaf(rr.y, st[4 * j + 1][n], acc[n]);
      acc[n] = fmaf(rr.z, st[4 * j + 2][n], acc[n]);
      acc[n] = fmaf(rr.w, st[4 * j + 3][n], acc[n]);
    }
  }
  const float ysum = reduce_y<KQ, NV>(acc, kq);
#pragma unroll
  for (int j = 0; j < KS / 4; ++j) {
    const float4 kk = kj(j), ww = wj(j);
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      st[4 * j][n] = fmaf(ww.x, st[4 * j][n], kk.x * vv[n]);
      st[4 * j + 1][n] = fmaf(ww.y, st[4 * j + 1][n], kk.y * vv[n]);
      st[4 * j + 2][n] = fmaf(ww.z, st[4 * j + 2][n], kk.z * vv[n]);
      st[4 * j + 3][n] = fmaf(ww.w, st[4 * j + 3][n], kk.w * vv[n]);
    }
  }
  return fmaf(at, vmine, ysum);
}

// The four float32 values at p (in T), as a float4.
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ float from_f(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f(float x, __nv_bfloat16) {
  return __float2bfloat16_rn(x);
}

template <typename T, int K, int KQ, int NV, int VS, int TC>
__global__ void __launch_bounds__(Geo<T, K, KQ, NV, VS, TC>::kThreads)
wkv_chunk_scan(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u,
               const float* __restrict__ state0, T* __restrict__ y,
               float* __restrict__ state_out, int S, int H) {
  using G = Geo<T, K, KQ, NV, VS, TC>;
  constexpr int KS = G::KS, VB = G::VB, NT = G::kThreads;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / VS, vs = blockIdx.x - bh * VS;
  const int b = bh / H, h = bh - b * H;
  const int kq = tid % KQ, vj = kq & (NV - 1);
  const int v0 = (tid / KQ) * NV;       // in the block's slice of columns
  const int vbase = vs * VB;
  const size_t tstride = static_cast<size_t>(H) * K;
  const size_t row0 = static_cast<size_t>(b) * S * tstride + h * K;  // t = 0

  // -- one step (a decode step): the lane's operands straight from global
  //    memory, no staging and no barrier; the state's loads go out first
  //    and its stores last ---------------------------------------------------------
  if (S == 1) {
    const size_t sbase = static_cast<size_t>(bh) * K * K + vbase + v0;
    float st[KS][NV];
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      if (state0 != nullptr) {
        load_nv<NV, true>(state0 + sbase + (kq * KS + i) * K, st[i]);
      } else {
#pragma unroll
        for (int n = 0; n < NV; ++n) st[i][n] = 0.f;
      }
    }
    const T* rk = r + row0 + kq * KS;
    const T* kk = k + row0 + kq * KS;
    const float* lw = logw + row0 + kq * KS;
    float rr[KS], kv[KS], ww[KS], vv[NV];
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < KS; j += 4) {
      const float4 rq = ld4(rk + j), kx = ld4(kk + j), lq = ld4(lw + j);
      const float4 uq = ld4(u + h * K + kq * KS + j);
      rr[j] = rq.x; rr[j + 1] = rq.y; rr[j + 2] = rq.z; rr[j + 3] = rq.w;
      kv[j] = kx.x; kv[j + 1] = kx.y; kv[j + 2] = kx.z; kv[j + 3] = kx.w;
      ww[j] = expf(lq.x); ww[j + 1] = expf(lq.y);
      ww[j + 2] = expf(lq.z); ww[j + 3] = expf(lq.w);
      a = fmaf(rq.x * uq.x, kx.x, a);
      a = fmaf(rq.y * uq.y, kx.y, a);
      a = fmaf(rq.z * uq.z, kx.z, a);
      a = fmaf(rq.w * uq.w, kx.w, a);
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) vv[n] = ld1(v + row0 + vbase + v0 + n);
    float acc[NV];
#pragma unroll
    for (int n = 0; n < NV; ++n) acc[n] = 0.f;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        acc[n] = fmaf(rr[i], st[i][n], acc[n]);
        st[i][n] = fmaf(ww[i], st[i][n], kv[i] * vv[n]);
      }
    }
#pragma unroll
    for (int o = 1; o < KQ; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    float vmine = vv[0];
#pragma unroll
    for (int n = 1; n < NV; ++n) vmine = vj == n ? vv[n] : vmine;
    y[row0 + vbase + v0 + vj] =
        from_f(fmaf(a, vmine, reduce_y<KQ, NV>(acc, kq)), T());
#pragma unroll
    for (int i = 0; i < KS; ++i)
      store_nv<NV>(state_out + sbase + (kq * KS + i) * K, st[i]);
    return;
  }

  // -- staging: this thread's units are (row, column c8) with c8 fixed ------
  const int c8 = tid % G::kRowUnits;
  const bool my_v = c8 * 8 >= vbase && c8 * 8 < vbase + VB;
  const size_t base = row0 + c8 * 8;
  Vec8<T> pr[G::kUnitIters], pk[G::kUnitIters], pv[G::kUnitIters];
  float4 pw[G::kUnitIters][2];

  auto fetch = [&](int c) {  // chunk c's global loads into registers
#pragma unroll
    for (int it = 0; it < G::kUnitIters; ++it) {
      const int t = c * TC + (tid + it * NT) / G::kRowUnits;
      if (t < S) {
        const size_t at = base + t * tstride;
        load8(pr[it], r + at);
        load8(pk[it], k + at);
        if (my_v) load8(pv[it], v + at);
        pw[it][0] = __ldg(reinterpret_cast<const float4*>(logw + at));
        pw[it][1] = __ldg(reinterpret_cast<const float4*>(logw + at) + 1);
      }
    }
  };
  fetch(0);

  // -- the state in: NV columns of each of the lane's KS rows, in 16-byte
  //    loads (NV >= 4) ---------------------------------------------------------
  const size_t sbase = static_cast<size_t>(bh) * K * K + vbase + v0;
  float st[KS][NV];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    if (state0 != nullptr) {
      load_nv<NV, true>(state0 + sbase + (kq * KS + i) * K, st[i]);
    } else {
#pragma unroll
      for (int n = 0; n < NV; ++n) st[i][n] = 0.f;
    }
  }
  float uu[8];
#pragma unroll
  for (int e = 0; e < 8; e += 4) {
    const float4 q = ld4(u + h * K + c8 * 8 + e);
    uu[e] = q.x; uu[e + 1] = q.y; uu[e + 2] = q.z; uu[e + 3] = q.w;
  }

  auto stage = [&](float* buf) {  // the fetched chunk into a buffer
#pragma unroll
    for (int it = 0; it < G::kUnitIters; ++it) {
      const int row = (tid + it * NT) / G::kRowUnits;
      float rf[8], kf[8], wf[8];
      to_f8(pr[it], rf);
      to_f8(pk[it], kf);
      const float* lw = reinterpret_cast<const float*>(pw[it]);
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        wf[e] = expf(lw[e]);
        a = fmaf(rf[e] * uu[e], kf[e], a);
      }
#pragma unroll
      for (int o = 1; o < G::kRowUnits; o <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, o);
      float* rowp = buf + row * K;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int at = perm<KQ, KS>(c8 * 8 + half * 4);
        const int e = half * 4;
        *reinterpret_cast<float4*>(rowp + G::kR + at) =
            make_float4(rf[e], rf[e + 1], rf[e + 2], rf[e + 3]);
        *reinterpret_cast<float4*>(rowp + G::kK + at) =
            make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
        *reinterpret_cast<float4*>(rowp + G::kW + at) =
            make_float4(wf[e], wf[e + 1], wf[e + 2], wf[e + 3]);
      }
      if (my_v) {
        float vf[8];
        to_f8(pv[it], vf);
        float* vp = buf + G::kV + row * VB + c8 * 8 - vbase;
        *reinterpret_cast<float4*>(vp) = make_float4(vf[0], vf[1], vf[2],
                                                     vf[3]);
        *reinterpret_cast<float4*>(vp + 4) = make_float4(vf[4], vf[5], vf[6],
                                                         vf[7]);
      }
      if (c8 == 0) buf[G::kA + row] = a;
    }
  };

  // one staged step: operands from shared memory, y into the chunk's rows
  auto staged_step = [&](float* buf, int tt) {
    const float* R = buf + G::kR + tt * K + kq * 4;
    const float* Kt = buf + G::kK + tt * K + kq * 4;
    const float* Wt = buf + G::kW + tt * K + kq * 4;
    const float* Vt = buf + G::kV + tt * VB + v0;
    float vv[NV];
    load_nv<NV, false>(Vt, vv);
    buf[G::kY + tt * VB + v0 + vj] = step<G>(
        st,
        [&](int j) { return *reinterpret_cast<const float4*>(R + j * KQ * 4); },
        [&](int j) { return *reinterpret_cast<const float4*>(Kt + j * KQ * 4); },
        [&](int j) { return *reinterpret_cast<const float4*>(Wt + j * KQ * 4); },
        vv, Vt[vj], buf[G::kA + tt], kq);
  };

  const int chunks = (S + TC - 1) / TC;
  stage(smem);
  if (chunks > 1) fetch(1);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    float* buf = smem + (c & 1) * G::kBuf;
    const int steps = min(TC, S - c * TC);
    if (steps == TC) {
#pragma unroll 2
      for (int tt = 0; tt < TC; ++tt) staged_step(buf, tt);
    } else {
      for (int tt = 0; tt < steps; ++tt) staged_step(buf, tt);
    }
    if (c + 1 < chunks) {
      stage(smem + ((c + 1) & 1) * G::kBuf);
      if (c + 2 < chunks) fetch(c + 2);
    }
    __syncthreads();
    // chunk c's y, 16 bytes a store
    for (int i = tid; i < G::kYUnits; i += NT) {
      const int row = i / (VB / G::kYElems);
      const int col = (i - row * (VB / G::kYElems)) * G::kYElems;
      const int t = c * TC + row;
      if (t < S)
        *reinterpret_cast<uint4*>(y + row0 + t * tstride + vbase + col) =
            from_f16B(buf + G::kY + row * VB + col, T());
    }
  }

  // -- the final state, in 16-byte stores (NV >= 4) --------------------------
#pragma unroll
  for (int i = 0; i < KS; ++i)
    store_nv<NV>(state_out + sbase + (kq * KS + i) * K, st[i]);
}

template <typename T, int K, int KQ, int NV, int VS, int TC>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* state0, void* y, float* state_out,
           int B, int S, int H, cudaStream_t stream) {
  using G = Geo<T, K, KQ, NV, VS, TC>;
  auto kern = wkv_chunk_scan<T, K, KQ, NV, VS, TC>;
  if (G::kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<B * H * VS, G::kThreads, S == 1 ? 0 : G::kSmemBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, state0, static_cast<T*>(y),
      state_out, S, H);
  return static_cast<int>(cudaGetLastError());
}

// The shipped launch a head dim: KQ lanes a column, NV columns a thread, VS
// blocks a head, TC steps a chunk.
template <int K> struct Config;
template <> struct Config<16> {
  static constexpr int KQ = 4, NV = 2, VS = 1, TC = 32;
};
template <> struct Config<32> {
  static constexpr int KQ = 4, NV = 4, VS = 1, TC = 32;
};
template <> struct Config<64> {
  static constexpr int KQ = 4, NV = 4, VS = 1, TC = 16;
};

template <typename T, int K>
int launch_shipped(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, const float* state0,
                   void* y, float* state_out, int B, int S, int H,
                   cudaStream_t s) {
  using C = Config<K>;
  return launch<T, K, C::KQ, C::NV, C::VS, C::TC>(r, k, v, logw, u, state0,
                                                  y, state_out, B, S, H, s);
}

template <typename T>
int launch_k(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* state0, void* y, float* state_out,
             int B, int S, int H, int K, cudaStream_t s) {
  switch (K) {
    case 16:
      return launch_shipped<T, 16>(r, k, v, logw, u, state0, y, state_out, B,
                                   S, H, s);
    case 32:
      return launch_shipped<T, 32>(r, k, v, logw, u, state0, y, state_out, B,
                                   S, H, s);
    case 64:
      return launch_shipped<T, 64>(r, k, v, logw, u, state0, y, state_out, B,
                                   S, H, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace wkv

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int wkv_launch(const void* r, const void* k, const void* v, const float* logw,
               const float* u, const float* state0, void* y, float* state_out,
               int B, int S, int H, int K, int dtype, void* stream) {
  using wkv::aligned16;
  if (B <= 0 || S <= 0 || H <= 0 || !aligned16(r) || !aligned16(k) ||
      !aligned16(v) || !aligned16(logw) || !aligned16(u) ||
      !aligned16(state0) || !aligned16(y) || !aligned16(state_out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return wkv::launch_k<float>(r, k, v, logw, u, state0, y, state_out, B, S,
                                H, K, s);
  if (dtype == 1)
    return wkv::launch_k<__nv_bfloat16>(r, k, v, logw, u, state0, y,
                                        state_out, B, S, H, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
