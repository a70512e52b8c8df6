// The camera node's fixed-function knob kernel for sm_90a: a 2x2 mean pool,
// an edge-clamped k-tap box blur (vertical, then horizontal) and the knob5
// changed-pixel fraction, on gray planes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/frame_knobs.py::
// frame_knobs (:107; body _knobs_kernel, pallas_call at :114).  Per frame of
// [N, H, W] frames and prev (uint8 or float32, H and W even):
//
//     changed = count(|f - prev| > pixel_delta) * (1/(H*W))      -> f32 [N]
//     pooled  = (((f00 + f01) + f10) + f11) * 0.25                -> [H/2, W/2]
//     v       = (sum over dy ascending of pooled[clamp(y+dy)]) * (1/k)
//     out     = (sum over dx ascending of v[:, clamp(x+dx)])  * (1/k)
//
// with dy, dx in [-(k/2), k - k/2); k <= 1 is no blur.  The arithmetic is
// the plain version's (repro_torch.kernels.frame_knobs.frame_knobs_plain)
// bit for bit: every add and multiply is an explicit __fadd_rn / __fmul_rn,
// so nothing is contracted into an FMA, the taps are added in the same
// order, and the reciprocals 1/k and 1/(H*W) come rounded to float32 from
// the wrapper, which hands the same values to the plain version.  The
// changed count is an integer, exact in any order, so blocks add it into
// one int32 per frame with atomics and a finishing kernel scales it.
//
// What bounds it on the H100: bytes.  Per frame it must read frames and
// prev once and write the pooled output (float32 [25, 1080, 1920]: 2 x
// 8.29 MB in, 2.07 MB out a frame, 466.6 MB, 0.139 ms at 3.35 TB/s; uint8
// 155.5 MB, 0.046 ms); the blur's k taps a value are far below the f32
// rate.  The Pallas kernel took one whole frame per program (8.3 MB at
// 1080p f32); nothing on Hopper holds that, so the design tiles instead:
// one block per 32 x 128 tile of one frame's output stages its pooled tile
// plus a clamped halo of k-1 rows and columns in shared memory (46 x 142
// floats at k = 15, 26 KB) and blurs it there, so each input pixel of the
// tile is read from device memory once and the blur's intermediate never
// leaves the SM.  The halo re-reads neighbouring tiles' pixels (at k = 15
// ~1.6x the frame's pixels), which mostly come back from the 50 MB L2;
// prev is read only for the block's own pixels, no halo.  Inputs are read
// in their own type (a uint8 frame is 1 B a pixel, no cast pass in front).
//
// Interface: plain C, bound with ctypes.  fk_launch(frames, prev, out,
// changed, count, N, H, W, k, inv_k, inv_hw, delta, dtype, stream):
// frames/prev contiguous [N, H, W] (dtype 0 = uint8, 1 = float32), out
// float32 [N, H/2, W/2], changed float32 [N], count int32 [N] scratch.  The
// launches go on the caller's stream; it returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTileH = 32;    // output rows of one block
constexpr int kTileW = 128;   // output columns of one block
constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const uint8_t* p) {
  return static_cast<float>(__ldg(p));
}

// Shared memory of one block: the pooled tile with its halo, then the
// vertically blurred rows (k <= 1: the pooled tile alone).
__host__ __device__ __forceinline__ int smem_floats(int k) {
  const int hw = kTileW + k - 1;
  return (kTileH + k - 1) * hw + (k > 1 ? kTileH * hw : 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
knobs_kernel(const T* __restrict__ frames, const T* __restrict__ prev,
             float* __restrict__ out, int* __restrict__ count, int H, int W,
             int k, float inv_k, float delta) {
  extern __shared__ float smem[];
  const int H2 = H / 2, W2 = W / 2;
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  const int rows = min(kTileH, H2 - r0), cols = min(kTileW, W2 - c0);
  const int pad = k / 2;
  const int hw = kTileW + k - 1;           // row stride of both buffers
  const int need_h = rows + k - 1, need_w = cols + k - 1;
  float* pool = smem;                       // [kTileH + k - 1][hw]
  float* vert = smem + (kTileH + k - 1) * hw;  // [kTileH][hw]
  const size_t plane = static_cast<size_t>(H) * W;
  const T* f = frames + n * plane;
  const T* p = prev + n * plane;

  // 1. the pooled tile and its halo (rows and columns clamped at the
  //    frame's edges), and the changed count over the block's own pixels
  int changed = 0;
  for (int i = threadIdx.x; i < need_h * need_w; i += kThreads) {
    const int sy = i / need_w, sx = i - sy * need_w;
    const int py = r0 - pad + sy, px = c0 - pad + sx;
    const int cy = min(max(py, 0), H2 - 1), cx = min(max(px, 0), W2 - 1);
    const size_t at = static_cast<size_t>(2 * cy) * W + 2 * cx;
    const float a = load(f + at), b = load(f + at + 1);
    const float c = load(f + at + W), d = load(f + at + W + 1);
    pool[sy * hw + sx] =
        __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d), 0.25f);
    if (py >= r0 && py < r0 + rows && px >= c0 && px < c0 + cols) {
      changed += (fabsf(__fsub_rn(a, load(p + at))) > delta)
               + (fabsf(__fsub_rn(b, load(p + at + 1))) > delta)
               + (fabsf(__fsub_rn(c, load(p + at + W))) > delta)
               + (fabsf(__fsub_rn(d, load(p + at + W + 1))) > delta);
    }
  }
  changed = __reduce_add_sync(0xffffffffu, changed);
  if ((threadIdx.x & 31) == 0 && changed) atomicAdd(count + n, changed);
  __syncthreads();

  float* dst = out + static_cast<size_t>(n) * H2 * W2
             + static_cast<size_t>(r0) * W2 + c0;
  if (k <= 1) {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int y = i / cols, x = i - y * cols;
      dst[static_cast<size_t>(y) * W2 + x] = pool[y * hw + x];
    }
    return;
  }
  // 2. vertical taps, ascending dy, over every halo column
  for (int i = threadIdx.x; i < rows * need_w; i += kThreads) {
    const int y = i / need_w, x = i - y * need_w;
    const float* col = pool + y * hw + x;
    float acc = col[0];
    for (int t = 1; t < k; ++t) acc = __fadd_rn(acc, col[t * hw]);
    vert[y * hw + x] = __fmul_rn(acc, inv_k);
  }
  __syncthreads();
  // 3. horizontal taps, ascending dx, one output each
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int y = i / cols, x = i - y * cols;
    const float* row = vert + y * hw + x;
    float acc = row[0];
    for (int t = 1; t < k; ++t) acc = __fadd_rn(acc, row[t]);
    dst[static_cast<size_t>(y) * W2 + x] = __fmul_rn(acc, inv_k);
  }
}

__global__ void finish_kernel(const int* __restrict__ count,
                              float* __restrict__ changed, int N,
                              float inv_hw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) changed[i] = __fmul_rn(__int2float_rn(count[i]), inv_hw);
}

template <typename T>
int launch_typed(const T* frames, const T* prev, float* out, float* changed,
                 int* count, int N, int H, int W, int k, float inv_k,
                 float inv_hw, float delta, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(k);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(knobs_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaMemsetAsync(count, 0, sizeof(int) * N, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W / 2 + kTileW - 1) / kTileW, (H / 2 + kTileH - 1) / kTileH,
                  N);
  knobs_kernel<T><<<grid, kThreads, smem, s>>>(frames, prev, out, count, H, W,
                                               k, inv_k, delta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<<<(N + 255) / 256, 256, 0, s>>>(count, changed, N, inv_hw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fk_smem_bytes(int k) {
  return k < 1 ? -1 : static_cast<int>(sizeof(float) * smem_floats(k));
}

int fk_launch(const void* frames, const void* prev, void* out, void* changed,
              void* count, int N, int H, int W, int k, float inv_k,
              float inv_hw, float delta, int dtype, void* stream) {
  if (N < 0 || N > 65535 || H < 2 || W < 2 || H % 2 || W % 2 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed(static_cast<const uint8_t*>(frames),
                        static_cast<const uint8_t*>(prev),
                        static_cast<float*>(out), static_cast<float*>(changed),
                        static_cast<int*>(count), N, H, W, k, inv_k, inv_hw,
                        delta, s);
  if (dtype == 1)
    return launch_typed(static_cast<const float*>(frames),
                        static_cast<const float*>(prev),
                        static_cast<float*>(out), static_cast<float*>(changed),
                        static_cast<int*>(count), N, H, W, k, inv_k, inv_hw,
                        delta, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
