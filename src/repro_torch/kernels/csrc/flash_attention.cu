// Blockwise (flash) GQA attention for sm_90a, causal or full: two routes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel, pallas_call at :95).  Both routes
// compute the same function: f32 scores of the pre-scaled query against
// each key, an online softmax with f32 running max / sum / accumulator,
// keys masked at k_pos >= Sk and, when causal, where q_pos < k_pos
// (top-left aligned, as the TPU kernel's iota mask), the kv loop stopped at
// the causal frontier, one division by max(l, 1e-37) at the end and one
// cast to the output type.  The TPU kernel's (256, 512) blocks and its
// padding of q/k are TPU constraints and are not carried over.
//
// What bounds it on the H100: at the serving shape (B=8, S=1024, QH=16,
// KH=8, D=128, bf16) the work is ~34 GFLOP against ~8 MB of inputs and
// outputs, so operations: the bf16 tensor cores' 989 TFLOP/s.
//
// Route "wgmma" (fa_launch_wgmma: bfloat16, D in {64, 112, 128}).  Both
// products run on the tensor cores.  A block owns 128 query rows of one
// (batch, q head): two consumer warpgroups of 64 rows each share every K/V
// tile.
// Q, K and V tiles come by TMA (4-D tensor maps over [B, S, H, D], one
// 64-column panel per box, 128-byte swizzle) into a two-stage ring of
// 64-key tiles, each stage completed through an mbarrier for K and one for
// V and released through an "empty" mbarrier that every consumer warp
// arrives on; thread 0 refills a stage as soon as both warpgroups are done
// with it.  S = Q K^T is wgmma m64n64k16 with Q and K from shared memory
// (both K-major: the descriptor steps 32 bytes per 16 columns inside the
// swizzle atom).  The scores are masked only on the diagonal tile and the
// Sk edge; the row max reduces over the 4 threads of an accumulator row.
// P = exp2(S * scale * log2 e - m), one FFMA and one ex2.approx, is
// rounded to bf16 in registers, in the accumulator's own layout, which is
// the A-operand layout of the next wgmma, so P never touches shared
// memory; l sums the rounded P, so the weights divided out are the ones
// multiplied in, and O is rescaled only when a row max moved.  O += P V
// is wgmma m64nDk16 with V from shared memory read MN-major through the
// transpose bit.  The grid walks q tiles longest first; a warpgroup stops
// at its own causal frontier.  Rounding P to bf16 is the route's one
// rounding beyond the f32 algorithm.  Two blocks fit on an SM (at most
// 128 registers a thread, ~97 KB of shared memory), so four warpgroups
// take turns on the tensor cores and hide each other's softmax; one block
// per SM with the two products of neighbouring tiles overlapped inside a
// warpgroup ran slower on the H100.  D = 112 runs as a 128-wide tile: the
// tensor maps declare the global inner extent as 112, so the TMA copies
// fill columns 112-127 of the second panel with zeros; those zeros add
// nothing to Q K^T (whose last 16-column step is skipped) or to P V (the
// accumulator's columns 112-127 stay zero), and the store writes 112
// columns.
//
// Route "ffma" (fa_launch: float32 at any D below, bfloat16 at D 16/32):
// both products on the f32 CUDA cores (67 TFLOP/s peak), exact in f32.
// 256 threads as a 16x16 grid; thread (ty, tx) owns query rows ty + 16 i
// (i < 4) and, of the 64x64 score tile, key columns tx + 16 j.  Q
// (pre-scaled) and one K or V tile at a time live in shared memory as f32,
// rows padded by 4 floats so the float4 reads along D hit distinct banks;
// K and V share one buffer (the score product ends before V is staged).
// Row max and sum reduce over the 16 lanes of a half warp with shuffles.
// P goes through shared memory for the P.V product, where each thread owns
// D/16 output columns per row (as float4 groups where D/16 is a multiple of
// 4; at D = 112, 7 single columns tx + 16 c).  Nothing is carried between
// blocks.
//
// Interface: plain C, bound with ctypes.  q [B, Sq, QH, D], k/v
// [B, Sk, KH, D], o [B, Sq, QH, D], all contiguous and of one type
// (fa_launch: float32 at D in {16, 32, 64, 112, 128}, bfloat16 at D in
// {16, 32}; fa_launch_wgmma: bfloat16, D in {64, 112, 128}, 16-byte
// aligned).
// The tensor maps are encoded per call by cuTensorMapEncodeTiled, found
// through the runtime's entry-point query (no link against libcuda).  A
// launch goes on the caller's stream and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

// Whether a thread's D/16 output columns of a row come as float4 groups.
template <int D>
__host__ __device__ constexpr bool vec4_cols() {
  return D / 16 >= 4 && (D / 16) % 4 == 0;
}

// Output column of the c-th value a thread owns (D/16 per row).  As float4
// groups: 4 tx + 64 g + e, so a quarter warp's float4 reads of a V row hit
// distinct banks; otherwise tx + 16 c, consecutive across a half warp.
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (vec4_cols<D>()) {
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
        if constexpr (vec4_cols<D>()) {
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
    case 112:
      return launch<T, 112>(q, k, v, o, B, Sq, Sk, QH, KH, scale, causal,
                            stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, QH, KH, scale, causal,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// -- route "wgmma": bf16, D in {64, 112, 128}, tensor cores fed by TMA -------

namespace hopper {

constexpr int WROWS = 64;          // query rows per consumer warpgroup
constexpr int NWG = 2;             // consumer warpgroups per block
constexpr int BQ = WROWS * NWG;    // query rows per block
constexpr int BK = 64;             // keys per K/V tile
constexpr int NT = 128 * NWG;      // threads per block
constexpr int STAGES = 2;          // K/V tiles in flight
constexpr int PANEL = 64 * 128;    // bytes of one [64 rows][64 cols] bf16 box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One [64 rows][64 cols] box of a 4-D tensor map, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading byte offset (MN-major: between 64-column panels; unused K-major)
// and the stride byte offset (between 8-row groups: 1024 bytes), in 16-byte
// units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

// 2^x by the special function unit (ex2.approx: ~2 ulp; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that writes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A (bf16 pairs) in registers, B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A (bf16 pairs) in registers, B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}


// One block: 128 query rows of one (batch, q head), 256 threads = two
// consumer warpgroups of 64 rows.  The tile is 64 * H columns wide, of which
// the first D hold the head (D = 112 in a 128-wide tile; the rest read as
// zeros).  Shared memory (1024-byte aligned, as the 128-byte swizzle's atoms
// are): Q [NWG][H] panels, K and V [STAGES][H] panels each, then the
// mbarriers.
template <int H, int D>
__global__ void __launch_bounds__(NT, 2)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            __nv_bfloat16* __restrict__ o, int Sq, int Sk, int QH, int KH,
            float scale_log2, int causal) {
  static_assert(D % 16 == 0 && D > 64 * (H - 1) && D <= 64 * H, "tile");
  constexpr int NO = 32 * H;  // output accumulators per thread (64 x 64 H)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + NWG * H * PANEL;
  const uint32_t sV = sK + STAGES * H * PANEL;
  const uint32_t bars = sV + STAGES * H * PANEL;
  auto q_full = [&](int i) { return bars + 8u * i; };
  auto k_full = [&](int s) { return bars + 8u * (NWG + s); };
  auto v_full = [&](int s) { return bars + 8u * (NWG + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (NWG + 2 * STAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;  // within the warpgroup
  const int lane = tid % 32;
  const int qh = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int kh = qh / (QH / KH);

  // kv tiles the warpgroup whose first row is r needs (none without rows)
  auto tiles_for = [&](int r) {
    if (r >= Sq) return 0;
    const int hi = causal ? min(r + WROWS, Sk) : Sk;
    return (hi + BK - 1) / BK;
  };
  const int r0 = q0 + wg * WROWS;
  const int my_tiles = tiles_for(r0);
  const int n_tiles = max(tiles_for(q0), tiles_for(q0 + WROWS));

  auto issue_kv = [&](int t) {
    const int s = t % STAGES;
    mbar_expect_tx(k_full(s), H * PANEL);
    for (int p = 0; p < H; ++p)
      tma_load(sK + (s * H + p) * PANEL, &tk, k_full(s), 64 * p, kh, t * BK,
               b);
    mbar_expect_tx(v_full(s), H * PANEL);
    for (int p = 0; p < H; ++p)
      tma_load(sV + (s * H + p) * PANEL, &tv, v_full(s), 64 * p, kh, t * BK,
               b);
  };

  if (tid == 0) {
    for (int i = 0; i < NWG; ++i) mbar_init(q_full(i), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), NWG * 4);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < NWG; ++i) {
      if (tiles_for(q0 + i * WROWS) == 0) continue;
      mbar_expect_tx(q_full(i), H * PANEL);
      for (int p = 0; p < H; ++p)
        tma_load(sQ + (i * H + p) * PANEL, &tq, q_full(i), 64 * p, qh,
                 q0 + i * WROWS, b);
    }
    for (int t = 0; t < min(STAGES, n_tiles); ++t) issue_kv(t);
  }
  __syncwarp();

  // accumulator fragment of thread (warp, lane): register i holds row
  // 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4)
  // + i % 2 of the warpgroup's 64-row tile
  const int qd = lane % 4;
  const int row0 = r0 + 16 * warp + lane / 4;  // rows row0 and row0 + 8
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  // descriptors of the warpgroup's Q and of stage 0's K and V; a step
  // inside them adds its byte offset / 16 to the start address field
  const uint64_t q_desc = sw128_desc(sQ + wg * H * PANEL, 16, 1024);
  const uint64_t k_desc = sw128_desc(sK, 16, 1024);
  const uint64_t v_desc = sw128_desc(sV, PANEL, 1024);
  if (my_tiles > 0) mbar_wait(q_full(wg), 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t phase = (t / STAGES) & 1;
    if (t < my_tiles) {
      const int k0 = t * BK;
      uint64_t dq = q_desc, dk = k_desc + s * (H * PANEL >> 4);
      // opaque to the compiler: the steps' descriptors are formed here
      // rather than kept live across the loop
      asm volatile("" : "+l"(dq), "+l"(dk));
      float sc[32];
      mbar_wait(k_full(s), phase);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {  // 16 columns of D per step
        // (the zero columns past D are skipped)
        const uint32_t off = ((j / 4) * PANEL + (j % 4) * 32) >> 4;
        wgmma_ss_n64(sc, dq + off, dk + off, j > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // mask (the diagonal tile and the Sk edge only), then the online
      // softmax in log2 units (the scale folded into the exponent's FMA:
      // it is positive, so the row max of the raw scores is the max of the
      // scaled ones); 4 threads share an accumulator row
      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > r0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (edge) {
          const int kp = k0 + 8 * (i / 4) + 2 * qd + (i % 2);
          const int qp = row0 + 8 * ((i / 2) % 2);
          if (kp >= Sk || (causal && kp > qp)) sc[i] = -INFINITY;
        }
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      }
      float alpha[2], mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
        mu[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = ex2(m_run[r] - mu[r]);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
      // P in bf16, packed in pairs: pair j (registers 2j, 2j + 1) lies in
      // row j % 2; pairs 4 kk .. 4 kk + 3 are the A fragment of keys
      // 16 kk .. 16 kk + 15
      uint32_t pa[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int r = j % 2;
        __nv_bfloat162 pb = __floats2bfloat162_rn(
            ex2(fmaf(sc[2 * j], scale_log2, -mu[r])),
            ex2(fmaf(sc[2 * j + 1], scale_log2, -mu[r])));
        const float2 pr = __bfloat1622float2(pb);
        l_run[r] += pr.x + pr.y;
        pa[j] = *reinterpret_cast<uint32_t*>(&pb);
      }
      if (alpha[0] != 1.f || alpha[1] != 1.f) {  // the row max moved
#pragma unroll
        for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i / 2) % 2];
      }

      uint64_t dvs = v_desc + s * (H * PANEL >> 4);
      asm volatile("" : "+l"(dvs));
      mbar_wait(v_full(s), phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // 16 keys per step
        const uint64_t dv = dvs + (kk * 2048 >> 4);
        if constexpr (H == 2)
          wgmma_rs_n128(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                        pa[4 * kk + 3], dv, 1);
        else
          wgmma_rs_n64(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                       pa[4 * kk + 3], dv, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (tid == 0 && t + STAGES < n_tiles) {
      mbar_wait(empty(s), phase);  // both warpgroups are done with tile t
      issue_kv(t + STAGES);
    }
    __syncwarp();
  }
  if (my_tiles == 0) return;

  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    denom[r] = fmaxf(l, 1e-37f);
  }
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {  // 8-column chunks (the first D columns)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      if (qp >= Sq) continue;
      const __nv_bfloat162 w = __floats2bfloat162_rn(
          acc[4 * c + 2 * r] / denom[r], acc[4 * c + 2 * r + 1] / denom[r]);
      *reinterpret_cast<__nv_bfloat162*>(
          o + ((size_t(b) * Sq + qp) * QH + qh) * D + 8 * c + 2 * qd) = w;
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (the library links no libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A contiguous bf16 [B, S, NH, D] tensor as a 4-D map (D innermost) whose
// box is 64 columns of one head over 64 rows, 128-byte swizzled; rows at
// or past S, and columns at or past D (a box that starts below D and ends
// past it), read as zeros.
int encode(CUtensorMap* map, const void* ptr, int B, int S, int NH, int D) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(NH), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(NH) * D * 2,
                                 cuuint64_t(S) * NH * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int H, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int QH, int KH, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, B, Sq, QH, D);
  if (rc == 0) rc = encode(&tk, k, B, Sk, KH, D);
  if (rc == 0) rc = encode(&tv, v, B, Sk, KH, D);
  if (rc != 0) return rc;
  constexpr size_t smem =
      1024 + size_t(NWG + 2 * STAGES) * H * PANEL + 8 * (NWG + 3 * STAGES);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma<H, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(QH, B, (Sq + BQ - 1) / BQ);
  flash_wgmma<H, D><<<grid, NT, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, QH, KH,
      scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

extern "C" {

// The ffma route.  dtype: 0 = float32 (D in {16, 32, 64, 112, 128}),
// 1 = bfloat16 (D in {16, 32}).  Returns a cudaError_t (0 = success).
int fa_launch(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int QH, int KH, int D, float scale, int causal,
              int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || QH % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, Sq, Sk, QH, KH, D, scale, causal, s);
  if (dtype == 1) {  // D 64, 112 and 128 take the wgmma route
    if (D == 16)
      return launch<__nv_bfloat16, 16>(q, k, v, o, B, Sq, Sk, QH, KH, scale,
                                       causal, s);
    if (D == 32)
      return launch<__nv_bfloat16, 32>(q, k, v, o, B, Sq, Sk, QH, KH, scale,
                                       causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wgmma route: bfloat16, D in {64, 112, 128}; q, k, v and o 16-byte
// aligned.  Returns a cudaError_t (0 = success).
int fa_launch_wgmma(const void* q, const void* k, const void* v, void* o,
                    int B, int Sq, int Sk, int QH, int KH, int D, float scale,
                    int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || QH % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return hopper::launch<1, 64>(q, k, v, o, B, Sq, Sk, QH, KH, scale, causal,
                                 s);
  if (D == 112)
    return hopper::launch<2, 112>(q, k, v, o, B, Sq, Sk, QH, KH, scale,
                                  causal, s);
  if (D == 128)
    return hopper::launch<2, 128>(q, k, v, o, B, Sq, Sk, QH, KH, scale,
                                  causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
