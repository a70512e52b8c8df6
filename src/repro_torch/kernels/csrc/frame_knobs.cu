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
// bit for bit: every float add and multiply is an explicit __fadd_rn /
// __fmul_rn, so nothing is contracted into an FMA, the taps are added in
// the same order, and the reciprocals 1/k and 1/(H*W) come rounded to
// float32 from the wrapper, which hands the same values to the plain
// version.  A uint8 2x2 sum is an integer below 2^24, which every order
// gives exactly, so it is summed as an integer and converted once; a uint8
// |f - prev| is an integer too, so it is compared with the integer part of
// the threshold four bytes at a time (__vabsdiffu4, __vcmpgtu4).
//
// What bounds it on the H100: bytes.  Per frame it must read frames and
// prev once and write the pooled output (float32 [25, 1080, 1920]: 2 x
// 8.29 MB in, 2.07 MB out a frame, 466.6 MB, 0.139 ms at 3.35 TB/s; uint8
// 155.5 MB, 0.046 ms; the camera path's gray[1:] and gray[:-1] share 24 of
// their 25 planes, 267.5 MB, 0.080 ms); the blur's k taps a value are far
// below the float32 rate.
//
// Design.  One block per (frame, 30 x 120 output tile), the frame fastest
// in the grid: on the camera path plane n is read as frames[n - 1] and as
// prev[n] by blocks that run side by side, so the second read can come
// from L2 (30 x 120 tiles a 1080p frame's 540 x 960 pooled plane exactly).
// A block stages its pooled tile plus the blur's halo of k - 1 rows and
// columns in shared memory, blurs it there and stores the output.  On the
// vector route each thread of a fixed 32 x 8 map takes units of two input
// rows x 16 bytes (16 uint8 or 4 float32 pixels, so 8 or 2 pooled values)
// of frames and, for the tile's own pixels, of prev, with two units' loads
// in flight before the first is used: no division and no clamp a pixel.
// Only the part of the halo inside the frame is loaded; the clamped rows
// and columns outside it are copied in shared memory afterwards (edge
// tiles only).  The scalar route, taken for the whole call where a row or
// a base pointer is not 16-byte aligned, loads one pooled value's four
// pixels a unit the same way.  At the camera node's blur widths (5, 8, 10,
// 15) the passes are register-blocked: the vertical one takes 4 rows of a
// column a thread, the horizontal one 4 adjacent outputs a thread from
// float4 loads, stored as one 16-byte store where rows allow; other widths
// take one output a thread.  Four blocks an SM (registers capped by
// __launch_bounds__) keep one block's loads in flight while another
// blurs.  The per-frame count is finished in the kernel: each block adds
// its count into count[n] and takes a ticket; the block that takes the
// frame's last ticket scales the count into changed[n] and sets count[n]
// and ticket[n] back to 0 for the next call.  One launch a call.  The tile,
// order, depth and occupancy were chosen among scripts/knobs_variants.py's
// variants of this source.
//
// Interface: plain C, bound with ctypes.  fk_launch(frames, prev, out,
// changed, count, ticket, N, H, W, k, inv_k, inv_hw, delta, dtype, route,
// stream): frames/prev contiguous [N, H, W] (dtype 0 = uint8, 1 = float32),
// out float32 [N, H/2, W/2], changed float32 [N]; count and ticket int32
// [>= N], zero before the call and zero again after it; route 1 = vector
// (16-byte aligned rows and pointers), 0 = scalar.  The launch goes on the
// caller's stream; it returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTileH = 30;    // output rows of one block
constexpr int kTileW = 120;   // output columns of one block (a multiple of 8)
constexpr int kLX = 32, kLY = 8;
constexpr int kThreads = kLX * kLY;
constexpr int kSlack = 14;    // span alignment: up to 7 pooled columns a side
constexpr int kBatch = 2;     // staged units a thread loads before using one

// Floats of one staged row: the tile, the halo and the alignment slack.
__host__ __device__ __forceinline__ int row_stride(int k) {
  return (kTileW + k - 1 + kSlack + 3) / 4 * 4;
}

// Shared memory of one block: the pooled tile with its halo, then the
// vertically blurred rows (k <= 1: the pooled tile alone).
__host__ __device__ __forceinline__ int smem_floats(int k) {
  return (kTileH + k - 1 + (k > 1 ? kTileH : 0)) * row_stride(k);
}

__device__ __forceinline__ float pool4(float a, float b, float c, float d) {
  return __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d), 0.25f);
}

__device__ __forceinline__ int over(float a, float p, float delta) {
  return fabsf(__fsub_rn(a, p)) > delta;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(uint8_t x) {
  return static_cast<float>(x);
}

// The integer form of |d| > delta for integer |d| in [0, 255]: |d| > thr,
// with thr = -1 when every pixel counts and 255 when none does.
__device__ __forceinline__ int byte_threshold(float delta) {
  if (delta < 0.f) return -1;
  if (!(delta < 255.f)) return 255;   // also NaN: no comparison holds
  return static_cast<int>(floorf(delta));
}

// One staged unit as loaded: on the vector route 16 bytes of each of the
// two input rows of frames (f0, f1) and, for own pixels, of prev (p0, p1);
// on the scalar route one pooled value's two pixels of each row, as float.
struct Unit {
  uint4 f0, f1, p0, p1;
};

template <typename T, bool kVec>
__device__ __forceinline__ void load_unit(Unit& u, const T* f0, const T* f1,
                                          const T* p0, const T* p1, int x,
                                          bool own) {
  if constexpr (kVec) {
    u.f0 = __ldg(reinterpret_cast<const uint4*>(f0 + 2 * x));
    u.f1 = __ldg(reinterpret_cast<const uint4*>(f1 + 2 * x));
    if (own) {
      u.p0 = __ldg(reinterpret_cast<const uint4*>(p0 + 2 * x));
      u.p1 = __ldg(reinterpret_cast<const uint4*>(p1 + 2 * x));
    }
  } else {
    u.f0.x = __float_as_uint(to_f(__ldg(f0 + 2 * x)));
    u.f0.y = __float_as_uint(to_f(__ldg(f0 + 2 * x + 1)));
    u.f1.x = __float_as_uint(to_f(__ldg(f1 + 2 * x)));
    u.f1.y = __float_as_uint(to_f(__ldg(f1 + 2 * x + 1)));
    if (own) {
      u.p0.x = __float_as_uint(to_f(__ldg(p0 + 2 * x)));
      u.p0.y = __float_as_uint(to_f(__ldg(p0 + 2 * x + 1)));
      u.p1.x = __float_as_uint(to_f(__ldg(p1 + 2 * x)));
      u.p1.y = __float_as_uint(to_f(__ldg(p1 + 2 * x + 1)));
    }
  }
}

// A loaded unit's pooled values into dst and, with `own`, its changed
// count: uint8 16 pixels a row -> 8 pooled values, float32 4 -> 2, the
// scalar route 2 -> 1.
template <typename T, bool kVec>
__device__ __forceinline__ void put_unit(const Unit& u, float* dst, bool own,
                                         int thr, float delta, int& cnt) {
  if constexpr (kVec && sizeof(T) == 1) {
    const uint32_t wa[4] = {u.f0.x, u.f0.y, u.f0.z, u.f0.w};
    const uint32_t wb[4] = {u.f1.x, u.f1.y, u.f1.z, u.f1.w};
    float v[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t s0 = (wa[i] & 0xffu) + ((wa[i] >> 8) & 0xffu) +
                          (wb[i] & 0xffu) + ((wb[i] >> 8) & 0xffu);
      const uint32_t s1 = ((wa[i] >> 16) & 0xffu) + (wa[i] >> 24) +
                          ((wb[i] >> 16) & 0xffu) + (wb[i] >> 24);
      v[2 * i] = __fmul_rn(__uint2float_rn(s0), 0.25f);
      v[2 * i + 1] = __fmul_rn(__uint2float_rn(s1), 0.25f);
    }
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    if (!own) return;
    if (thr < 0) {
      cnt += 32;
      return;
    }
    const uint32_t qa[4] = {u.p0.x, u.p0.y, u.p0.z, u.p0.w};
    const uint32_t qb[4] = {u.p1.x, u.p1.y, u.p1.z, u.p1.w};
    const uint32_t t4 = static_cast<uint32_t>(thr) * 0x01010101u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cnt += (__popc(__vcmpgtu4(__vabsdiffu4(wa[i], qa[i]), t4)) +
              __popc(__vcmpgtu4(__vabsdiffu4(wb[i], qb[i]), t4))) >> 3;
  } else if constexpr (kVec) {
    const float4 a = *reinterpret_cast<const float4*>(&u.f0);
    const float4 b = *reinterpret_cast<const float4*>(&u.f1);
    *reinterpret_cast<float2*>(dst) =
        make_float2(pool4(a.x, a.y, b.x, b.y), pool4(a.z, a.w, b.z, b.w));
    if (!own) return;
    const float4 pa = *reinterpret_cast<const float4*>(&u.p0);
    const float4 pb = *reinterpret_cast<const float4*>(&u.p1);
    cnt += over(a.x, pa.x, delta) + over(a.y, pa.y, delta) +
           over(a.z, pa.z, delta) + over(a.w, pa.w, delta) +
           over(b.x, pb.x, delta) + over(b.y, pb.y, delta) +
           over(b.z, pb.z, delta) + over(b.w, pb.w, delta);
  } else {
    const float a = __uint_as_float(u.f0.x), b = __uint_as_float(u.f0.y);
    const float c = __uint_as_float(u.f1.x), d = __uint_as_float(u.f1.y);
    *dst = pool4(a, b, c, d);
    if (own)
      cnt += over(a, __uint_as_float(u.p0.x), delta) +
             over(b, __uint_as_float(u.p0.y), delta) +
             over(c, __uint_as_float(u.p1.x), delta) +
             over(d, __uint_as_float(u.p1.y), delta);
  }
}

// KT > 1: the blur width as a compile-time constant (register-blocked
// passes); KT == 0: any width k, one output a thread and k loads a tap.
template <typename T, bool kVec, int KT>
__global__ void __launch_bounds__(kThreads, 4)
knobs_tile(const T* __restrict__ frames, const T* __restrict__ prev,
           float* __restrict__ out, float* __restrict__ changed,
           int* __restrict__ count, int* __restrict__ ticket, int H, int W,
           int k, float inv_k, float inv_hw, float delta) {
  // pooled values a staged unit: 16 bytes of pixels on the vector route
  constexpr int P = kVec ? 8 / static_cast<int>(sizeof(T)) : 1;
  extern __shared__ float4 smem4[];
  __shared__ int warp_cnt[kThreads / 32];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = blockIdx.x, tile_x = blockIdx.y, tile_y = blockIdx.z;
  const int H2 = H / 2, W2 = W / 2;
  const int r0 = tile_y * kTileH, c0 = tile_x * kTileW;
  const int rows = min(kTileH, H2 - r0), cols = min(kTileW, W2 - c0);
  const int pad = k / 2;
  // the staged window [y_lo, y_hi) x [x_lo, x_hi) in pooled coordinates
  const int y_lo = r0 - pad, y_hi = r0 + rows + k - 1 - pad;
  const int x_lo = c0 - pad, x_hi = c0 + cols + k - 1 - pad;
  // shared row i of pool holds pooled row y_lo + i and column j pooled
  // column x_org + j (x_org <= x_lo, a multiple of P, as c0 is); row i of
  // vert holds the blurred column sums of output row r0 + i, column j
  // those of pooled column x_lo + j
  const int x_org = c0 - (pad + P - 1) / P * P;
  const int stride = row_stride(k);
  float* pool = smem;
  float* vert = smem + (kTileH + k - 1) * stride;
  const int lane = threadIdx.x % kLX, ty = threadIdx.x / kLX;
  const size_t plane = static_cast<size_t>(H) * W;
  const T* f = frames + n * plane;
  const T* p = prev + n * plane;
  const int thr = byte_threshold(delta);

  // 1. the window's part inside the frame, and the own pixels' count;
  //    each thread walks its units (rows ty + 8i, spans lane + 32j) with
  //    kBatch units' loads in flight before the first is used
  const int ys = max(y_lo, 0), ye = min(y_hi, H2);
  const int xs = max(x_org, 0), xe = min((x_hi + P - 1) / P * P, W2);
  int cnt = 0;
  int y = ys + ty, x = xs + lane * P;
  while (y < ye) {
    Unit u[kBatch];
    int uy[kBatch], ux[kBatch];
    bool ok[kBatch], own[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      uy[i] = y;
      ux[i] = x;
      ok[i] = y < ye && x < xe;
      own[i] = ok[i] && y >= r0 && y < r0 + rows && x >= c0 && x < c0 + cols;
      if (ok[i]) {
        const T* f0 = f + static_cast<size_t>(2 * y) * W;
        const T* p0 = p + static_cast<size_t>(2 * y) * W;
        load_unit<T, kVec>(u[i], f0, f0 + W, p0, p0 + W, x, own[i]);
      }
      x += kLX * P;
      if (x >= xe) {
        x = xs + lane * P;
        y += kLY;
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (ok[i])
        put_unit<T, kVec>(u[i], pool + (uy[i] - y_lo) * stride + ux[i] - x_org,
                          own[i], thr, delta, cnt);
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if (lane == 0) warp_cnt[ty] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) total += warp_cnt[i];
    if (total) atomicAdd(count + n, total);
    __threadfence();
    const int tiles = ((W2 + kTileW - 1) / kTileW) * ((H2 + kTileH - 1) / kTileH);
    if (atomicAdd(ticket + n, 1) == tiles - 1) {   // the frame's last block
      changed[n] = __fmul_rn(__int2float_rn(atomicExch(count + n, 0)),
                             inv_hw);
      atomicExch(ticket + n, 0);
    }
  }

  // 2. edge tiles: the clamped halo, columns first, then whole rows
  if (y_lo < 0 || y_hi > H2 || x_lo < 0 || x_hi > W2) {
    for (int yy = ys + ty; yy < ye; yy += kLY) {
      float* row = pool + (yy - y_lo) * stride - x_org;
      for (int xx = x_lo + lane; xx < x_hi; xx += kLX)
        if (xx < 0 || xx >= W2) row[xx] = row[min(max(xx, 0), W2 - 1)];
    }
    __syncthreads();
    for (int yy = y_lo + ty; yy < y_hi; yy += kLY) {
      if (yy >= 0 && yy < H2) continue;
      float* row = pool + (yy - y_lo) * stride;
      const float* src = pool + (min(max(yy, 0), H2 - 1) - y_lo) * stride;
      for (int j = x_lo - x_org + lane; j < x_hi - x_org; j += kLX)
        row[j] = src[j];
    }
    __syncthreads();
  }

  float* dst = out + static_cast<size_t>(n) * H2 * W2 +
               static_cast<size_t>(r0) * W2 + c0;
  if (k <= 1) {
    for (int yy = ty; yy < rows; yy += kLY)
      for (int xx = lane; xx < cols; xx += kLX)
        dst[static_cast<size_t>(yy) * W2 + xx] =
            pool[yy * stride + c0 + xx - x_org];
    return;
  }
  const int vcols = x_hi - x_lo;       // cols + k - 1
  if constexpr (KT > 1) {
    // 3. vertical taps, ascending dy: a thread takes one column and 4
    //    rows, loading the 3 + KT values they need once
    for (int yg = 4 * ty; yg < rows; yg += 4 * kLY)
      for (int j = lane; j < vcols; j += kLX) {
        const float* col = pool + yg * stride + x_lo - x_org + j;
        float c[4 + KT - 1];
#pragma unroll
        for (int i = 0; i < 4 + KT - 1; ++i)
          c[i] = col[min(i, rows + KT - 2 - yg) * stride];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float acc = c[q];
#pragma unroll
          for (int t = 1; t < KT; ++t) acc = __fadd_rn(acc, c[q + t]);
          if (yg + q < rows)
            vert[(yg + q) * stride + j] = __fmul_rn(acc, inv_k);
        }
      }
    __syncthreads();
    // 4. horizontal taps, ascending dx: a thread takes 4 adjacent outputs
    //    of a row, loading their 3 + KT taps as float4s; one 16-byte
    //    store where the output rows allow it
    constexpr int NL = (4 + KT - 1 + 3) / 4;
    const bool vec_out = W2 % 4 == 0;
    for (int yy = ty; yy < rows; yy += kLY)
      for (int xg = 4 * lane; xg < cols; xg += 4 * kLX) {
        const float4* row =
            reinterpret_cast<const float4*>(vert + yy * stride + xg);
        float c[4 * NL];
#pragma unroll
        for (int i = 0; i < NL; ++i)
          *reinterpret_cast<float4*>(c + 4 * i) = row[i];
        float o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float acc = c[q];
#pragma unroll
          for (int t = 1; t < KT; ++t) acc = __fadd_rn(acc, c[q + t]);
          o[q] = __fmul_rn(acc, inv_k);
        }
        float* orow = dst + static_cast<size_t>(yy) * W2 + xg;
        if (vec_out && xg + 4 <= cols) {
          *reinterpret_cast<float4*>(orow) = make_float4(o[0], o[1], o[2],
                                                         o[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (xg + q < cols) orow[q] = o[q];
        }
      }
  } else {
    // 3. vertical taps, ascending dy, over every column of the window
    for (int yy = ty; yy < rows; yy += kLY)
      for (int j = lane; j < vcols; j += kLX) {
        const float* col = pool + yy * stride + x_lo - x_org + j;
        float acc = col[0];
        for (int t = 1; t < k; ++t) acc = __fadd_rn(acc, col[t * stride]);
        vert[yy * stride + j] = __fmul_rn(acc, inv_k);
      }
    __syncthreads();
    // 4. horizontal taps, ascending dx, one output each
    for (int yy = ty; yy < rows; yy += kLY)
      for (int xx = lane; xx < cols; xx += kLX) {
        const float* row = vert + yy * stride + xx;
        float acc = row[0];
        for (int t = 1; t < k; ++t) acc = __fadd_rn(acc, row[t]);
        dst[static_cast<size_t>(yy) * W2 + xx] = __fmul_rn(acc, inv_k);
      }
  }
}

template <typename T, bool kVec, int KT>
int launch_typed(const T* frames, const T* prev, float* out, float* changed,
                 int* count, int* ticket, int N, int H, int W, int k,
                 float inv_k, float inv_hw, float delta, cudaStream_t s) {
  const int smem = static_cast<int>(sizeof(float)) * smem_floats(k);
  auto kern = knobs_tile<T, kVec, KT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_x = (W / 2 + kTileW - 1) / kTileW;
  const int tiles_y = (H / 2 + kTileH - 1) / kTileH;
  const dim3 grid(N, tiles_x, tiles_y);
  kern<<<grid, kThreads, smem, s>>>(frames, prev, out, changed, count,
                                    ticket, H, W, k, inv_k, inv_hw, delta);
  return static_cast<int>(cudaGetLastError());
}

// The blur widths of the camera node (core/knobs.py BLUR_KERNELS: 5, 8,
// 10, 15) get register-blocked passes; any other width the generic ones.
template <typename T, bool kVec>
int launch_k(const T* f, const T* p, float* o, float* c, int* cn, int* tk,
             int N, int H, int W, int k, float inv_k, float inv_hw,
             float delta, cudaStream_t s) {
  switch (k) {
    case 5:
      return launch_typed<T, kVec, 5>(f, p, o, c, cn, tk, N, H, W, k, inv_k,
                                      inv_hw, delta, s);
    case 8:
      return launch_typed<T, kVec, 8>(f, p, o, c, cn, tk, N, H, W, k, inv_k,
                                      inv_hw, delta, s);
    case 10:
      return launch_typed<T, kVec, 10>(f, p, o, c, cn, tk, N, H, W, k, inv_k,
                                       inv_hw, delta, s);
    case 15:
      return launch_typed<T, kVec, 15>(f, p, o, c, cn, tk, N, H, W, k, inv_k,
                                       inv_hw, delta, s);
    default:
      return launch_typed<T, kVec, 0>(f, p, o, c, cn, tk, N, H, W, k, inv_k,
                                      inv_hw, delta, s);
  }
}

template <typename T>
int launch_route(const void* frames, const void* prev, void* out,
                 void* changed, void* count, void* ticket, int N, int H,
                 int W, int k, float inv_k, float inv_hw, float delta,
                 int route, cudaStream_t s) {
  const T* f = static_cast<const T*>(frames);
  const T* p = static_cast<const T*>(prev);
  float* o = static_cast<float*>(out);
  float* c = static_cast<float*>(changed);
  int* cn = static_cast<int*>(count);
  int* tk = static_cast<int*>(ticket);
  if (route == 0)
    return launch_k<T, false>(f, p, o, c, cn, tk, N, H, W, k, inv_k, inv_hw,
                              delta, s);
  if (route != 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((static_cast<size_t>(W) * sizeof(T)) % 16 ||
      reinterpret_cast<uintptr_t>(frames) % 16 ||
      reinterpret_cast<uintptr_t>(prev) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return launch_k<T, true>(f, p, o, c, cn, tk, N, H, W, k, inv_k, inv_hw,
                           delta, s);
}

}  // namespace

extern "C" {

int fk_smem_bytes(int k) {
  return k < 1 ? -1 : static_cast<int>(sizeof(float)) * smem_floats(k);
}

int fk_launch(const void* frames, const void* prev, void* out, void* changed,
              void* count, void* ticket, int N, int H, int W, int k,
              float inv_k, float inv_hw, float delta, int dtype, int route,
              void* stream) {
  if (N < 0 || H < 2 || W < 2 || H % 2 || W % 2 || k < 1 ||
      (H / 2 + kTileH - 1) / kTileH > 65535 ||
      (W / 2 + kTileW - 1) / kTileW > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_route<uint8_t>(frames, prev, out, changed, count, ticket, N,
                                 H, W, k, inv_k, inv_hw, delta, route, s);
  if (dtype == 1)
    return launch_route<float>(frames, prev, out, changed, count, ticket, N,
                               H, W, k, inv_k, inv_hw, delta, route, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
