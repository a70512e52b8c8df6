// frame_knob_grid: the knob grid of one (resolution, colorspace) group over a
// clip, on an NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel repro/kernels/frame_knobs.py::_grid_kernel /
// _grid_kernel_art (shared body _grid_compute, launched by _grid_call through
// frame_knob_grid).  It computes what _grid_compute computes, per (setting,
// frame): the knob5 changed-pixel fraction against the previous frame, the
// optional knob4 keep mask against the background, the knob2 planes, the
// knob1 bilinear resize, a uint8 round/clip, the knob3 box blur, a uint8
// round/clip, and the six byte-delta proxy features.
//
// What bounds it on this card: the payload it writes and the f32 band
// arithmetic, about equally.  The TPU kernel applies resize and blur as dense
// operator products on the MXU; at 1920x1080 the largest group is ~1e13 f32
// FLOP in that form.  The operators are bands (<= 2 taps per resize row, <= 15
// per blur row), so here every stage is a band stencil: for BGR at full
// resolution with knob4 the clip read once plus the payload written once is
// ~1.7 GB (0.50 ms at 3.35 TB/s) and the separable band passes are ~31 f32
// FLOP per payload byte (0.71 ms at 67 TFLOP/s), just above the card's ridge
// of 20 FLOP per byte.
//
// What the design does about it:
//  * the resized image does not depend on the blur setting, so it is computed
//    once per (knob4 mode, frame) into a u8 scratch (it is integral after its
//    round) and read by every blur setting of that mode;
//  * the blur runs on shared-memory tiles: each block loads one input window
//    (the union of its blur settings' windows) once and walks every blur
//    setting of its knob4 mode over it, vertical then horizontal pass on chip,
//    with each setting's band weights staged in shared memory;
//  * the proxy features read each payload once, with per-block partials and a
//    fixed-order second pass, so results are identical run to run.
//
// Rounding points are those of _grid_compute: vertical then horizontal resize
// with no rounding between, round/clip, vertical then horizontal blur with no
// rounding between, round/clip.  Band sums run in ascending index order in
// f32; rintf rounds half to even like jnp.round; the colorspace arithmetic
// uses __fmul_rn/__fadd_rn so that nvcc cannot contract it into FMAs.  The
// changed fraction and the knob4 mask count integer channel differences and
// divide once in f32, so `changed` is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CS_BGR = 0;
constexpr int CS_GRAY = 1;
constexpr int CS_YUV420 = 2;

constexpr int BLUR_TILE = 32;    // blur output tile: BLUR_TILE x BLUR_TILE
constexpr int THREADS = 256;

}  // namespace

// Mirrored field for field by repro_torch.kernels.frame_knobs._FkgArgs.
struct FkgArgs {
  const uint8_t* frames;       // [F, H, W, 3]
  const uint8_t* prev;         // [F, H, W, 3]
  const uint8_t* bg;           // [H, W, 3], or null: no knob4 settings
  const int32_t* art_enable;   // [F], read only with bg
  const int32_t* block_mode;   // [A] knob4 mode of each artifact block
  const int32_t* block_sets;   // [A, n_per_block] settings of each block
  const int32_t* ry_start;     // [oh]
  const int32_t* ry_len;       // [oh]
  const float* ry_w;           // [oh, ry_k]
  const int32_t* rx_start;     // [ow]
  const int32_t* rx_len;       // [ow]
  const float* rx_w;           // [ow, rx_k]
  const int32_t* by_start;     // [S, oh]
  const int32_t* by_len;       // [S, oh]
  const float* by_w;           // [S, oh, by_k]
  const int32_t* bx_start;     // [S, ow]
  const int32_t* bx_len;       // [S, ow]
  const float* bx_w;           // [S, ow, bx_k]
  const int32_t* ty_lo;        // [A, tiles_y] first input row of each tile
  const int32_t* ty_hi;        // [A, tiles_y] one past its last input row
  const int32_t* tx_lo;        // [A, tiles_x] first input column of a tile
  const int32_t* tx_hi;        // [A, tiles_x] one past its last input column
  const float* log2_table;     // [256]: log2(1 + d)
  uint8_t* mask_raw;           // scratch [F, H, W] (with bg)
  uint8_t* mask;               // scratch [F, H, W] (with bg): dilated mask
  uint8_t* resized;            // scratch [A, F, P, oh, ow]
  int32_t* changed_count;      // scratch [F]
  float* part_log;             // scratch [S*F, feat_blocks, 2]
  int32_t* part_cnt;           // scratch [S*F, feat_blocks, 4]
  uint8_t* payload;            // out [S, F, P, oh, ow]
  float* feats;                // out [S, F, 6]
  float* changed;              // out [S, F]
  int32_t F, H, W, cs, packed_h, oh, ow, P, S, A;
  int32_t ry_k, rx_k, by_k, bx_k;
  int32_t feat_blocks;
  int32_t win_y, win_x;        // blur input window capacity (host-checked)
  int32_t tiles_y, tiles_x;    // blur tiles per column / per row
  int32_t n_per_block;         // blur settings per artifact block
  float pixel_delta, art_thresh;
};

namespace {

__device__ __forceinline__ float round_clip(float x) {
  return fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

__device__ __forceinline__ float luma(float b, float g, float r) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.114f, b), __fmul_rn(0.587f, g)),
                   __fmul_rn(0.299f, r));
}

// knob4 keep decision for pixel (y, x) of frame f under mode 0/1/2.
__device__ __forceinline__ bool keep_pixel(const FkgArgs& a, int f, int y,
                                           int x, int mode) {
  if (mode != 1 && mode != 2) return true;
  const uint8_t* m = a.mask + (long long)f * a.H * a.W;
  const bool here = m[(long long)y * a.W + x];
  if (mode == 1 || !here) return here;
  // contours: the dilated mask minus its cross erosion (true borders)
  const bool up = y > 0 ? m[(long long)(y - 1) * a.W + x] : true;
  const bool down = y < a.H - 1 ? m[(long long)(y + 1) * a.W + x] : true;
  const bool left = x > 0 ? m[(long long)y * a.W + x - 1] : true;
  const bool right = x < a.W - 1 ? m[(long long)y * a.W + x + 1] : true;
  return !(up && down && left && right);
}

// Value of plane p at packed row r, column c (the wire layout of knob2).
__device__ float plane_value(const FkgArgs& a, int f, int p, int r, int c,
                             int mode) {
  int y = r, x = c;
  bool chroma = false, is_v = false;
  if (a.cs == CS_YUV420 && r >= a.H) {
    const int half = a.W / 2;
    chroma = true;
    is_v = c >= half;
    y = 2 * (r - a.H);
    x = 2 * (is_v ? c - half : c);
  }
  float b = 0.0f, g = 0.0f, rr = 0.0f;
  if (keep_pixel(a, f, y, x, mode)) {
    const uint8_t* px = a.frames + (((long long)f * a.H + y) * a.W + x) * 3;
    b = px[0];
    g = px[1];
    rr = px[2];
  }
  if (a.cs == CS_BGR) return p == 0 ? b : (p == 1 ? g : rr);
  const float lum = luma(b, g, rr);
  if (!chroma) return round_clip(lum);
  const float t = is_v ? __fadd_rn(__fmul_rn(0.877f, __fsub_rn(rr, lum)), 128.0f)
                       : __fadd_rn(__fmul_rn(0.492f, __fsub_rn(b, lum)), 128.0f);
  return round_clip(t);
}

// knob5 changed counts per frame, and the raw knob4 mask.
__global__ void k_change_mask(FkgArgs a) {
  const int f = blockIdx.y;
  const long long hw = (long long)a.H * a.W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int changed = 0;
  if (i < hw) {
    const long long o = ((long long)f * hw + i) * 3;
    const uint8_t* px = a.frames + o;
    const uint8_t* pp = a.prev + o;
    const int s = abs(px[0] - pp[0]) + abs(px[1] - pp[1]) + abs(px[2] - pp[2]);
    changed = ((float)s / 3.0f) > a.pixel_delta;
    if (a.bg != nullptr) {
      const uint8_t* pb = a.bg + i * 3;
      const int sb = abs(px[0] - pb[0]) + abs(px[1] - pb[1]) + abs(px[2] - pb[2]);
      a.mask_raw[(long long)f * hw + i] = ((float)sb / 3.0f) > a.art_thresh;
    }
  }
  const int n = __syncthreads_count(changed);
  if (threadIdx.x == 0 && n) atomicAdd(&a.changed_count[f], n);
}

// Cross dilation of the raw knob4 mask (false borders).
__global__ void k_dilate(FkgArgs a) {
  const int f = blockIdx.y;
  const int hw = a.H * a.W;                 // < 2^31 (host-checked)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hw) return;
  const int y = i / a.W, x = i - y * a.W;
  const uint8_t* m = a.mask_raw + (long long)f * hw;
  uint8_t v = m[i];
  if (y > 0) v |= m[i - a.W];
  if (y < a.H - 1) v |= m[i + a.W];
  if (x > 0) v |= m[i - 1];
  if (x < a.W - 1) v |= m[i + 1];
  a.mask[(long long)f * hw + i] = v;
}

// knob4 + knob2 + knob1 once per (artifact block, frame, plane).
__global__ void k_resize(FkgArgs a) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= a.ow || oy >= a.oh) return;
  const int z = blockIdx.z;
  const int p = z % a.P;
  const int f = (z / a.P) % a.F;
  const int blk = z / (a.P * a.F);
  const int mode = a.bg != nullptr ? a.block_mode[blk] * a.art_enable[f] : 0;
  const int y0 = a.ry_start[oy], ny = a.ry_len[oy];
  const int x0 = a.rx_start[ox], nx = a.rx_len[ox];
  const float* wy = a.ry_w + (long long)oy * a.ry_k;
  const float* wx = a.rx_w + (long long)ox * a.rx_k;
  float acc = 0.0f;
  for (int j = 0; j < nx; ++j) {
    float col = 0.0f;                       // vertical pass of column x0 + j
    for (int i = 0; i < ny; ++i)
      col = fmaf(wy[i], plane_value(a, f, p, y0 + i, x0 + j, mode), col);
    acc = fmaf(wx[j], col, acc);            // horizontal pass
  }
  a.resized[(((long long)blk * a.F + f) * a.P + p) * a.oh * a.ow
            + (long long)oy * a.ow + ox] = (uint8_t)round_clip(acc);
}

// knob3 on shared-memory tiles.  One block per (artifact block, frame,
// plane, tile) loads the union of its blur settings' input windows once and
// walks every blur setting of that artifact block over it: vertical pass
// into shared memory, then the horizontal pass into the payload.
__global__ void k_blur(FkgArgs a) {
  extern __shared__ float smem[];
  const int z = blockIdx.z;
  const int p = z % a.P;
  const int f = (z / a.P) % a.F;
  const int blk = z / (a.P * a.F);
  const int r0 = blockIdx.y * BLUR_TILE, c0 = blockIdx.x * BLUR_TILE;
  const int nr = min(BLUR_TILE, a.oh - r0), nc = min(BLUR_TILE, a.ow - c0);
  const int lo_y = a.ty_lo[blk * a.tiles_y + blockIdx.y];
  const int lo_x = a.tx_lo[blk * a.tiles_x + blockIdx.x];
  const int wy = a.ty_hi[blk * a.tiles_y + blockIdx.y] - lo_y;   // <= win_y
  const int wx = a.tx_hi[blk * a.tiles_x + blockIdx.x] - lo_x;   // <= win_x
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;        // 32 x 8
  float* in = smem;                              // [win_y][win_x]
  float* vert = in + a.win_y * a.win_x;          // [BLUR_TILE][win_x]
  float* wv = vert + BLUR_TILE * a.win_x;        // [BLUR_TILE][by_k]
  float* wh = wv + BLUR_TILE * a.by_k;           // [BLUR_TILE][bx_k]
  int* off_v = reinterpret_cast<int*>(wh + BLUR_TILE * a.bx_k);
  int* len_v = off_v + BLUR_TILE;                // taps of each output row
  int* off_h = len_v + BLUR_TILE;
  int* len_h = off_h + BLUR_TILE;                // taps of each output column
  const uint8_t* src = a.resized
      + (((long long)blk * a.F + f) * a.P + p) * a.oh * a.ow;
  for (int y = ty; y < wy; y += 8)
    for (int x = tx; x < wx; x += 32)
      in[y * a.win_x + x] = src[(long long)(lo_y + y) * a.ow + lo_x + x];
  for (int k = 0; k < a.n_per_block; ++k) {
    const int s = a.block_sets[blk * a.n_per_block + k];
    __syncthreads();                 // window loaded; last setting finished
    const float* gy = a.by_w + ((long long)s * a.oh + r0) * a.by_k;
    for (int i = threadIdx.x; i < nr * a.by_k; i += blockDim.x) wv[i] = gy[i];
    const float* gx = a.bx_w + ((long long)s * a.ow + c0) * a.bx_k;
    for (int i = threadIdx.x; i < nc * a.bx_k; i += blockDim.x) wh[i] = gx[i];
    if (threadIdx.x < nr) {
      const long long o = (long long)s * a.oh + r0 + threadIdx.x;
      off_v[threadIdx.x] = a.by_start[o] - lo_y;
      len_v[threadIdx.x] = a.by_len[o];
    } else if (threadIdx.x >= 64 && threadIdx.x - 64 < nc) {
      const int c = threadIdx.x - 64;
      const long long o = (long long)s * a.ow + c0 + c;
      off_h[c] = a.bx_start[o] - lo_x;
      len_h[c] = a.bx_len[o];
    }
    __syncthreads();
    for (int r = ty; r < nr; r += 8) {
      const float* w = wv + r * a.by_k;
      const float* col = in + off_v[r] * a.win_x;
      const int n = len_v[r];
      for (int x = tx; x < wx; x += 32) {
        float acc = 0.0f;
        for (int t = 0; t < n; ++t) acc = fmaf(w[t], col[t * a.win_x + x], acc);
        vert[r * a.win_x + x] = acc;
      }
    }
    __syncthreads();
    if (tx < nc) {
      const float* w = wh + tx * a.bx_k;
      const int b0 = off_h[tx], n = len_h[tx];
      uint8_t* dst = a.payload
          + (((long long)s * a.F + f) * a.P + p) * a.oh * a.ow + c0 + tx;
      for (int r = ty; r < nr; r += 8) {
        const float* row = vert + r * a.win_x + b0;
        float acc = 0.0f;
        for (int t = 0; t < n; ++t) acc = fmaf(w[t], row[t], acc);
        dst[(long long)(r0 + r) * a.ow] = (uint8_t)round_clip(acc);
      }
    }
  }
}

// Per-block partial sums of the six proxy features of one (setting, frame):
// block b takes a fixed run of the payload's P * oh rows.
__global__ void k_feats_partial(FkgArgs a) {
  __shared__ float sl[2][THREADS];
  __shared__ int si[4][THREADS];
  __shared__ float table[256];
  for (int d = threadIdx.x; d < 256; d += blockDim.x) table[d] = a.log2_table[d];
  __syncthreads();
  const int sf = blockIdx.y;
  const int rows = a.P * a.oh;
  const int per = (rows + a.feat_blocks - 1) / a.feat_blocks;
  const int r_beg = blockIdx.x * per;
  const int r_end = min(rows, r_beg + per);
  const uint8_t* pay = a.payload + (long long)sf * rows * a.ow;
  float lx = 0.0f, ly = 0.0f;
  int zx = 0, sx = 0, zy = 0, sy = 0;
  for (int row = r_beg; row < r_end; ++row) {
    const bool down = row % a.oh + 1 < a.oh;   // rows of one plane only
    const uint8_t* line = pay + (long long)row * a.ow;
    for (int c = threadIdx.x; c < a.ow; c += blockDim.x) {
      const int v = line[c];
      if (c + 1 < a.ow) {
        const int d = abs((int)line[c + 1] - v);
        lx += table[d];
        zx += d == 0;
        sx += d <= 2;
      }
      if (down) {
        const int d = abs((int)line[c + a.ow] - v);
        ly += table[d];
        zy += d == 0;
        sy += d <= 2;
      }
    }
  }
  const int t = threadIdx.x;
  sl[0][t] = lx; sl[1][t] = ly;
  si[0][t] = zx; si[1][t] = sx; si[2][t] = zy; si[3][t] = sy;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {   // fixed-order tree
    if (t < h) {
      sl[0][t] += sl[0][t + h]; sl[1][t] += sl[1][t + h];
      si[0][t] += si[0][t + h]; si[1][t] += si[1][t + h];
      si[2][t] += si[2][t + h]; si[3][t] += si[3][t + h];
    }
    __syncthreads();
  }
  if (t == 0) {
    const long long o = (long long)sf * a.feat_blocks + blockIdx.x;
    a.part_log[o * 2 + 0] = sl[0][0];
    a.part_log[o * 2 + 1] = sl[1][0];
    for (int k = 0; k < 4; ++k) a.part_cnt[o * 4 + k] = si[k][0];
  }
}

// Fixed-order sum of the partials; the changed fraction of every row.
__global__ void k_feats_final(FkgArgs a) {
  const int sf = blockIdx.x * blockDim.x + threadIdx.x;
  if (sf >= a.S * a.F) return;
  float lx = 0.0f, ly = 0.0f;
  int zx = 0, sx = 0, zy = 0, sy = 0;
  for (int b = 0; b < a.feat_blocks; ++b) {
    const long long o = (long long)sf * a.feat_blocks + b;
    lx += a.part_log[o * 2 + 0];
    ly += a.part_log[o * 2 + 1];
    zx += a.part_cnt[o * 4 + 0];
    sx += a.part_cnt[o * 4 + 1];
    zy += a.part_cnt[o * 4 + 2];
    sy += a.part_cnt[o * 4 + 3];
  }
  float* out = a.feats + (long long)sf * 6;
  out[0] = lx; out[1] = (float)zx; out[2] = (float)sx;
  out[3] = ly; out[4] = (float)zy; out[5] = (float)sy;
  const int f = sf % a.F;
  a.changed[sf] = (float)a.changed_count[f] / (float)((long long)a.H * a.W);
}

}  // namespace

extern "C" {

// Launches every stage on `stream`; allocates nothing and does not
// synchronise.  Returns cudaGetLastError() after the last launch.
int fkg_launch(const FkgArgs* args, void* stream) {
  const FkgArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long hw = (long long)a.H * a.W;
  cudaError_t err = cudaMemsetAsync(a.changed_count, 0, sizeof(int32_t) * a.F, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 px_grid((unsigned)((hw + THREADS - 1) / THREADS), a.F);
  k_change_mask<<<px_grid, THREADS, 0, st>>>(a);
  if (a.bg != nullptr) k_dilate<<<px_grid, THREADS, 0, st>>>(a);
  const dim3 rs_block(32, 8);
  const dim3 rs_grid((a.ow + 31) / 32, (a.oh + 7) / 8, a.A * a.F * a.P);
  k_resize<<<rs_grid, rs_block, 0, st>>>(a);
  const size_t smem =
      sizeof(float) * ((size_t)(a.win_y + BLUR_TILE) * a.win_x
                       + (size_t)BLUR_TILE * (a.by_k + a.bx_k))
      + sizeof(int) * 4 * BLUR_TILE;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(k_blur, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 bl_grid((a.ow + BLUR_TILE - 1) / BLUR_TILE,
                     (a.oh + BLUR_TILE - 1) / BLUR_TILE, a.A * a.F * a.P);
  k_blur<<<bl_grid, THREADS, smem, st>>>(a);
  k_feats_partial<<<dim3(a.feat_blocks, a.S * a.F), THREADS, 0, st>>>(a);
  k_feats_final<<<(a.S * a.F + 127) / 128, 128, 0, st>>>(a);
  return (int)cudaGetLastError();
}

const char* fkg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
