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
// What bounds it on this card: the f32 band arithmetic.  The TPU kernel
// applies resize and blur as dense operator products on the MXU; here every
// stage is a band stencil.  For BGR at full resolution with knob4 and 32
// frames the payload written is 3.0 GB (0.89 ms at 3.35 TB/s) and the
// separable blur passes are 46.6 G taps (1.39 ms at 67 TFLOP/s, 2 FLOP a
// tap).  The taps stay FFMA: each payload byte must come from the same
// ascending fmaf chain over the plan's band weights as the plain version's,
// which rules out the tensor cores and any running sum.
//
// Three launches (and one memset of the change counts):
//  * fkg_prologue (fkg_prologue_x4 four pixels a thread where the width is a
//    multiple of 4), one block per (frame, 32x64-pixel tile): the integer
//    knob5 change count (block sum, one integer atomic); for a gray or YUV
//    plan the knob2 plane of every pixel (rounded luma, U|V at even
//    pixels); and on frames with knob4 on, the raw mask, its cross dilation
//    and the dilation's cross erosion on a 2-pixel halo in shared memory,
//    written as one keep code per pixel (bit 0: movers keep, bit 1:
//    contours keep).  The main kernel reads one byte per sample for the
//    knob4 decision.
//  * fkg_tile, one block per (artifact block, output tile, frame), all
//    planes: it stages the tile's blur input window in shared memory already
//    resized (keep code -> colorspace -> the bilinear taps of both axes in
//    the plan's order -> round/clip), reading each BGR pixel once per sample
//    for all three planes.  Then it walks every blur setting of its
//    artifact block over that one window: the vertical band pass into a
//    shared buffer, the horizontal band pass into a uint8 tile, the payload
//    stores (16 bytes a thread where the row allows) and the tile's six
//    feature partials from the same uint8 tile, four deltas a word.  Nothing
//    intermediate goes through device memory: no resized scratch, and the
//    payload is never read back.
//  * fkg_final: per (setting, frame), the fixed-order sum of the tiles'
//    partials, and the changed fraction.
//
// Work whose result is known exactly is not done twice.  Blocks whose
// knob4 keeps the same pixels of a frame (every block on a frame with knob4
// disabled: the background and the padding) compute one payload, which the
// first of them stores for all ("mirrors").  A window in which knob4 keeps
// no pixel (the keep codes of the tile's resize window decide it) is
// constant: 0, which blurs to zeros whatever the weights since 0 * w sums
// to 0 exactly, or 128 in YUV's chroma rows, which stays 128 where every
// band's weights sum to 1 (the plan checks it).  That block stores the
// constant without staging or passes.
//
// The tile is TILE_H x TILE_W = 32 x 64 outputs, computed with one more row
// and one more column (33 x 65): the features' dy of a tile's last row and
// dx of its last column need the next row and column, which belong to the
// neighbouring tiles.  The window of the widest blur (15 taps) is then
// 47 x 79 samples, 14.8 KB of float32 a plane: BGR's three planes, the
// vertical pass buffer and two uint8 tiles take ~61 KB, so three blocks (768
// threads) fit an SM, and the register cap that three blocks leave (80 a
// thread) holds the strips below without spills.  64 columns are four
// 16-byte stores a row.
//
// The passes are register-blocked.  Interior rows of a blur width share one
// band shape (K taps, one weight), and the plan marks every (setting, tile)
// whose rows are all interior (GridOperands.vk / hk).  There a thread owns a
// strip of consecutive outputs -- 11 rows of one column (3 strips cover 33)
// in the vertical pass, 13 columns of one row (5 strips cover 65) in the
// horizontal one -- loads the strip's R + K - 1 inputs into registers once
// and runs each output's K taps from them, with K a template argument (5, 8,
// 10, 15).  Tiles at the image edges, whose bands are clipped, take the
// general path with the plan's own per-row weights.  Length-1 weight-1 bands
// (blur 0) are copies: fmaf(1, x, 0) = x and rintf(x) = x for the integral x.
//
// Rounding points are those of _grid_compute: vertical then horizontal resize
// with no rounding between, round/clip, vertical then horizontal blur with no
// rounding between, round/clip.  Band sums run in ascending tap order from
// 0.0f with fmaf; rintf (and cvt.rni.sat, which rounds and saturates in
// one instruction) rounds half to even like jnp.round; the colorspace
// arithmetic uses __fmul_rn/__fadd_rn so that nvcc cannot contract it into
// FMAs.  The change count and the knob4 mask compare integer channel sums
// against the least sum whose float32 mean (sum / 3.0f) passes the
// threshold, so `changed` is exact; the feature sums run in a fixed order,
// so every output is identical from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CS_YUV420 = 2;     // colorspace ids: 0 BGR, 1 gray, 2 YUV 4:2:0

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_H = 32, TILE_W = 64;       // stored outputs of a tile
constexpr int ROWS = TILE_H + 1;              // computed: + the feature row
constexpr int COLS = TILE_W + 1;              //    and the feature column
constexpr int RV = 11;                        // vertical strip: 3 x 11 = 33
constexpr int RH = 13;                        // horizontal strip: 5 x 13 = 65
constexpr int OUT_PITCH = 68;                 // bytes a uint8 tile row: 17
                                              // words, odd, so 32 rows hit
                                              // 32 banks
constexpr int PRO_H = 32, PRO_W = 64;         // prologue tile (pixels)

static_assert(ROWS % RV == 0 && COLS % RH == 0, "strips cover the tile");
static_assert(THREADS == TILE_H * 8 && TILE_W == 8 * 8,
              "features: 8 threads of 8 columns on each stored row");

}  // namespace

// Mirrored field for field by repro_torch.kernels.frame_knobs._FkgArgs.
struct FkgArgs {
  // per call
  const uint8_t* frames;       // [F, H, W, 3]
  const uint8_t* prev;         // [F, H, W, 3]
  const uint8_t* bg;           // [H, W, 3], or null: no knob4 settings
  const int32_t* art_enable;   // [F], or null: every frame enabled
  uint8_t* keep;               // scratch [F, H, W] keep codes (with bg)
  uint8_t* plane;              // scratch [F, packed_h, W] the knob2 plane
                               // of every pixel, as if kept (P == 1)
  int32_t* changed_count;      // scratch [F]
  float* part_log;             // scratch [S, F, tiles, 2]
  int32_t* part_cnt;           // scratch [S, F, tiles, 4]
  uint8_t* payload;            // out [S, F, P, oh, ow]
  float* feats;                // out [S, F, 6]
  float* changed;              // out [S, F]
  // per plan: views into the plan's operand buffer on the card
  const int32_t* block_mode;   // [A] knob4 mode of each artifact block
  const int32_t* block_sets;   // [A, n_per_block] settings of each block
  const int32_t* ry_start;     // [oh] (a shorter band has zero weights)
  const float* ry_w;           // [oh, ry_k]
  const int32_t* rx_start;     // [ow]
  const float* rx_w;           // [ow, rx_k]
  const int32_t* by_start;     // [S, oh]
  const int32_t* by_len;       // [S, oh]
  const float* by_w;           // [S, oh, by_k]
  const int32_t* bx_start;     // [S, ow]
  const int32_t* bx_len;       // [S, ow]
  const float* bx_w;           // [S, ow, bx_k]
  const int32_t* win_y;        // [tiles_y, 2] staged rows [lo, hi)
  const int32_t* win_x;        // [tiles_x, 2] staged columns [lo, hi)
  const int32_t* src_y;        // [tiles_y, 2] packed source rows they read
  const int32_t* src_x;        // [tiles_x, 2] source columns they read
  const int32_t* col_span;     // [S, tiles_x, 2] vertical pass columns
  const int32_t* vk;           // [S, tiles_y] uniform taps, or 0: general
  const float* vw;             // [S, tiles_y] their weight
  const int32_t* hk;           // [S, tiles_x]
  const float* hw;             // [S, tiles_x]
  const int32_t* ident;        // [S] 1: both blur bands are the identity
  const float* log2_table;     // [256]: log2(1 + d)
  int32_t F, H, W, cs, oh, ow, P, S, A, n_per_block;
  int32_t ry_k, rx_k, by_k, bx_k, tiles_y, tiles_x;
  int32_t win_h, win_w;        // staged window capacity (rows, columns)
  int32_t blocks_alike;        // 1: every artifact block has the same blur
                               // settings in the same order
  int32_t unit_bands;          // 1: every band's weights are >= 0 and sum to
                               // 1 within 1e-4 (constant in, constant out)
  int32_t delta_min, art_min;  // set by fkg_launch: the least channel sum s
                               // with s / 3.0f above each threshold
  float pixel_delta, art_thresh;
};

namespace {

// Shared memory of fkg_tile, in bytes from the start of the dynamic buffer.
struct Smem {
  int win_pitch, vert_pitch;
  size_t win, vert, table, red_l, red_c, params, out, total;
};

// One blur setting of a block, as its tile needs it (loaded once a block).
struct SetParams {
  int s, ident, kv, kh;        // setting; identity; uniform taps (0: general)
  float wv, wh;                // the uniform passes' weights
  int vx0, vx1, oy, ox;        // vertical pass columns; first bands' starts
};                             // (window-relative)

__host__ __device__ inline Smem smem_layout(int P, int win_h, int win_w,
                                            int n_per_block) {
  Smem s;
  s.win_pitch = win_w;
  s.vert_pitch = win_w | 1;    // odd: the horizontal strips' rows, 32 banks
  size_t o = 0;
  s.win = o;   o += sizeof(float) * (size_t)P * win_h * win_w;
  s.vert = o;  o += sizeof(float) * (size_t)ROWS * s.vert_pitch;
  s.table = o; o += sizeof(float) * 256;
  s.red_l = o; o += sizeof(float) * (size_t)n_per_block * WARPS * 2;
  s.red_c = o; o += sizeof(int) * (size_t)n_per_block * WARPS * 4;
  s.params = o; o += sizeof(SetParams) * (size_t)n_per_block;
  s.out = o;   o += 2 * ROWS * OUT_PITCH;       // two uint8 tiles
  s.total = o;
  return s;
}

__device__ __forceinline__ float round_clip(float x) {
  return fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

// round_clip and the uint8 conversion in one instruction: round to nearest
// even, saturate to [0, 255].
__device__ __forceinline__ uint8_t to_u8(float x) {
  unsigned short v;
  asm("cvt.rni.sat.u8.f32 %0, %1;" : "=h"(v) : "f"(x));
  return (uint8_t)v;
}

__device__ __forceinline__ float luma(float b, float g, float r) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.114f, b), __fmul_rn(0.587f, g)),
                   __fmul_rn(0.299f, r));
}

// The P plane values at packed row y, column x of frame f (the wire layout
// of knob2: YUV's U|V rows below its Y rows), after the knob4 decision: a
// dropped pixel is black, so its luma is 0 and its chroma 128.  BGR reads
// the pixel's three bytes; gray and YUV read the plane the prologue wrote.
// The value is loaded whatever the keep code says, so that its load does
// not wait for the keep code's.
template <int P>
__device__ __forceinline__ void source_values(const FkgArgs& a, int f, int y,
                                              int x, int keep_bit,
                                              float (&v)[P]) {
  if constexpr (P == 3) {
    const long long pix = ((long long)f * a.H + y) * a.W + x;
    const uint8_t* px = a.frames + pix * 3;
    const int pb = px[0], pg = px[1], pr = px[2];
    const bool keep = keep_bit == 0 || (a.keep[pix] & keep_bit);
    v[0] = keep ? (float)pb : 0.0f;
    v[1] = keep ? (float)pg : 0.0f;
    v[2] = keep ? (float)pr : 0.0f;
  } else {
    const bool chroma = a.cs == CS_YUV420 && y >= a.H;
    const int packed_h = a.cs == CS_YUV420 ? a.H + a.H / 2 : a.H;
    const float pv = a.plane[((long long)f * packed_h + y) * a.W + x];
    bool keep = true;
    if (keep_bit != 0) {
      int sy = y, sx = x;
      if (chroma) {
        const int half = a.W / 2;
        sy = 2 * (y - a.H);
        sx = 2 * (x >= half ? x - half : x);
      }
      keep = a.keep[((long long)f * a.H + sy) * a.W + sx] & keep_bit;
    }
    v[0] = keep ? pv : (chroma ? 128.0f : 0.0f);
  }
}

// Stage the tile's blur window, resized, into shared memory: every sample
// through knob4 -> knob2 -> knob1 (vertical then horizontal taps, in the
// band's order) -> round/clip.  KY/KX are the plan's resize tap widths (1 at
// full resolution, 2 bilinear; the wrapper refuses wider bands): a band
// shorter than its width is padded with zero weights, and fmaf(0, v, acc) =
// acc for the finite v >= 0 here, so the padding changes no bit; its index
// is clamped into the input.  Each lane keeps its columns' bands in
// registers across the rows it stages.  Returns whether this thread staged
// a nonzero sample.
template <int P, int KY, int KX>
__device__ __forceinline__ bool stage_window(const FkgArgs& a, int f,
                                             int keep_bit, int lo_y, int wy,
                                             int lo_x, int wx, float* win,
                                             int wp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int packed_h = a.cs == CS_YUV420 ? a.H + a.H / 2 : a.H;
  bool nz = false;
  for (int x = lane; x < wx; x += 32) {
    const int c = lo_x + x;
    int xs[KX];
    float wxc[KX];
#pragma unroll
    for (int j = 0; j < KX; ++j) {
      xs[j] = min(a.rx_start[c] + j, a.W - 1);
      wxc[j] = a.rx_w[(long long)c * KX + j];
    }
#pragma unroll 2
    for (int y = warp; y < wy; y += WARPS) {
      const int r = lo_y + y;
      float acc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = 0.0f;
#pragma unroll
      for (int j = 0; j < KX; ++j) {
        float col[P];
#pragma unroll
        for (int p = 0; p < P; ++p) col[p] = 0.0f;
#pragma unroll
        for (int i = 0; i < KY; ++i) {
          float v[P];
          source_values<P>(a, f, min(a.ry_start[r] + i, packed_h - 1), xs[j],
                           keep_bit, v);
          const float w = a.ry_w[(long long)r * KY + i];
#pragma unroll
          for (int p = 0; p < P; ++p) col[p] = fmaf(w, v[p], col[p]);
        }
#pragma unroll
        for (int p = 0; p < P; ++p) acc[p] = fmaf(wxc[j], col[p], acc[p]);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float v = round_clip(acc[p]);
        nz |= v != 0.0f;
        win[(p * a.win_h + y) * wp + x] = v;
      }
    }
  }
  return nz;
}

// Vertical pass, interior tile: a thread owns RV rows of one column.
template <int K>
__device__ __forceinline__ void vertical_uniform(const float* win, int wp,
                                                 float* vert, int vp, int oy,
                                                 int vx0, int vx1, float w) {
  const int ncol = vx1 - vx0;
  for (int t = threadIdx.x; t < (ROWS / RV) * ncol; t += THREADS) {
    const int sv = t / ncol;
    const int col = vx0 + t - sv * ncol;
    const float* src = win + (oy + sv * RV) * wp + col;
    float in[RV + K - 1];
#pragma unroll
    for (int i = 0; i < RV + K - 1; ++i) in[i] = src[i * wp];
    float* dst = vert + sv * RV * vp + col;
#pragma unroll
    for (int j = 0; j < RV; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) acc = fmaf(w, in[j + i], acc);
      dst[j * vp] = acc;
    }
  }
}

// Vertical pass, any band: one output at a time with the plan's weights.
__device__ void vertical_general(const FkgArgs& a, int s, int r0, int lo_y,
                                 int nrc, const float* win, int wp,
                                 float* vert, int vp, int vx0, int vx1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrc; r += WARPS) {
    const long long o = (long long)s * a.oh + r0 + r;
    const int off = a.by_start[o] - lo_y, n = a.by_len[o];
    const float* w = a.by_w + o * a.by_k;
    for (int col = vx0 + lane; col < vx1; col += 32) {
      float acc = 0.0f;
      for (int t = 0; t < n; ++t)
        acc = fmaf(w[t], win[(off + t) * wp + col], acc);
      vert[r * vp + col] = acc;
    }
  }
}

// Horizontal pass, interior tile: a thread owns RH columns of one row
// (neighbouring lanes take neighbouring rows: an odd pitch, no conflicts).
template <int K>
__device__ __forceinline__ void horizontal_uniform(const float* vert, int vp,
                                                   uint8_t* ob, int ox,
                                                   int nrc, float w) {
  for (int t = threadIdx.x; t < (COLS / RH) * nrc; t += THREADS) {
    const int q = t / nrc;
    const int r = t - q * nrc;
    const float* src = vert + r * vp + ox + q * RH;
    float in[RH + K - 1];
#pragma unroll
    for (int i = 0; i < RH + K - 1; ++i) in[i] = src[i];
    uint8_t* dst = ob + r * OUT_PITCH + q * RH;
#pragma unroll
    for (int j = 0; j < RH; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) acc = fmaf(w, in[j + i], acc);
      dst[j] = to_u8(acc);
    }
  }
}

// Horizontal pass, any band.
__device__ void horizontal_general(const FkgArgs& a, int s, int c0, int lo_x,
                                   int nrc, int ncc, const float* vert,
                                   int vp, uint8_t* ob) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrc; r += WARPS) {
    for (int c = lane; c < ncc; c += 32) {
      const long long o = (long long)s * a.ow + c0 + c;
      const int off = a.bx_start[o] - lo_x, n = a.bx_len[o];
      const float* w = a.bx_w + o * a.bx_k;
      const float* src = vert + r * vp + off;
      float acc = 0.0f;
      for (int t = 0; t < n; ++t) acc = fmaf(w[t], src[t], acc);
      ob[r * OUT_PITCH + c] = to_u8(acc);
    }
  }
}

// Sum of the absolute channel differences of two BGR pixels.
__device__ __forceinline__ int channel_sad(const uint8_t* p, const uint8_t* q) {
  return abs(p[0] - q[0]) + abs(p[1] - q[1]) + abs(p[2] - q[2]);
}

// The prologue's work on one pixel (y, x) of frame f, inside the image:
// returns whether it changed (knob5), and for a gray or YUV plan writes its
// knob2 plane values: the rounded luma, and at even (y, x) its U and V.
__device__ __forceinline__ int pixel_pass(const FkgArgs& a, long long frame,
                                          int f, int y, int x) {
  const long long o = (frame + (long long)y * a.W + x) * 3;
  const uint8_t* px = a.frames + o;
  if (a.plane != nullptr) {
    const float b = px[0], g = px[1], r = px[2];
    const float lum = luma(b, g, r);
    const int packed_h = a.cs == CS_YUV420 ? a.H + a.H / 2 : a.H;
    uint8_t* pl = a.plane + (long long)f * packed_h * a.W;
    pl[(long long)y * a.W + x] = (uint8_t)round_clip(lum);
    if (a.cs == CS_YUV420 && !(y & 1) && !(x & 1)) {
      uint8_t* uv = pl + (long long)(a.H + y / 2) * a.W;
      uv[x / 2] = (uint8_t)round_clip(
          __fadd_rn(__fmul_rn(0.492f, __fsub_rn(b, lum)), 128.0f));
      uv[a.W / 2 + x / 2] = (uint8_t)round_clip(
          __fadd_rn(__fmul_rn(0.877f, __fsub_rn(r, lum)), 128.0f));
    }
  }
  return channel_sad(px, a.prev + o) >= a.delta_min;
}

// knob5 change counts, the gray or YUV plane of a one-plane plan, and with
// knob4 the keep code of every pixel.  The
// channel-mean tests ((float)sum / 3.0f > threshold) are integer compares
// against the least sum that passes them (delta_min, art_min).
__global__ void __launch_bounds__(THREADS) fkg_prologue(FkgArgs a) {
  __shared__ uint8_t raw[PRO_H + 4][PRO_W + 4];    // 2-pixel halo
  __shared__ uint8_t dil[PRO_H + 2][PRO_W + 2];    // 1-pixel halo
  __shared__ int warp_cnt[WARPS];
  const int f = blockIdx.z;
  const int y0 = blockIdx.y * PRO_H, x0 = blockIdx.x * PRO_W;
  const long long frame = (long long)f * a.H * a.W;
  int cnt = 0;
  // keep codes only where a block reads them: knob4 on this frame
  if (a.bg == nullptr || (a.art_enable != nullptr && a.art_enable[f] == 0)) {
    for (int i = threadIdx.x; i < PRO_H * PRO_W; i += THREADS) {
      const int y = y0 + i / PRO_W, x = x0 + i % PRO_W;
      if (y < a.H && x < a.W) cnt += pixel_pass(a, frame, f, y, x);
    }
  } else {
    // one pass over the tile and its halo: the raw mask everywhere (false
    // outside the image, so the dilation ignores it), the change count on
    // the tile's own pixels
    for (int i = threadIdx.x; i < (PRO_H + 4) * (PRO_W + 4); i += THREADS) {
      const int yy = i / (PRO_W + 4), xx = i % (PRO_W + 4);
      const int y = y0 - 2 + yy, x = x0 - 2 + xx;
      uint8_t m = 0;
      if (y >= 0 && y < a.H && x >= 0 && x < a.W) {
        const long long p = (long long)y * a.W + x;
        const uint8_t* px = a.frames + (frame + p) * 3;
        m = channel_sad(px, a.bg + p * 3) >= a.art_min;
        if (yy >= 2 && yy < PRO_H + 2 && xx >= 2 && xx < PRO_W + 2)
          cnt += pixel_pass(a, frame, f, y, x);
      }
      raw[yy][xx] = m;
    }
    __syncthreads();
    // cross dilation; outside the image true, so the erosion counts it set
    for (int i = threadIdx.x; i < (PRO_H + 2) * (PRO_W + 2); i += THREADS) {
      const int yy = i / (PRO_W + 2), xx = i % (PRO_W + 2);
      const int y = y0 - 1 + yy, x = x0 - 1 + xx;
      uint8_t d = 1;
      if (y >= 0 && y < a.H && x >= 0 && x < a.W)
        d = raw[yy + 1][xx + 1] | raw[yy][xx + 1] | raw[yy + 2][xx + 1]
            | raw[yy + 1][xx] | raw[yy + 1][xx + 2];
      dil[yy][xx] = d;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < PRO_H * PRO_W; i += THREADS) {
      const int yy = i / PRO_W, xx = i % PRO_W;
      const int y = y0 + yy, x = x0 + xx;
      if (y < a.H && x < a.W) {
        const int d = dil[yy + 1][xx + 1];
        const int er = d & dil[yy][xx + 1] & dil[yy + 2][xx + 1]
                       & dil[yy + 1][xx] & dil[yy + 1][xx + 2];
        a.keep[frame + (long long)y * a.W + x] = (uint8_t)(d | ((d & !er) << 1));
      }
    }
  }
  cnt = (int)__reduce_add_sync(0xffffffffu, (unsigned)cnt);
  if ((threadIdx.x & 31) == 0) warp_cnt[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int w = 0; w < WARPS; ++w) n += warp_cnt[w];
    if (n) atomicAdd(&a.changed_count[f], n);
  }
}

// Four horizontally adjacent BGR pixels (their first one's byte offset a
// multiple of 4) as three words.
__device__ __forceinline__ void load_px4(const uint8_t* p, uint32_t (&w)[3]) {
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
  w[0] = q[0];
  w[1] = q[1];
  w[2] = q[2];
}

// The channel sums of |p - q| of four pixels held as three words each.
__device__ __forceinline__ void sad_px4(const uint32_t (&p)[3],
                                        const uint32_t (&q)[3], int (&s)[4]) {
  const uint32_t d0 = __vabsdiffu4(p[0], q[0]);
  const uint32_t d1 = __vabsdiffu4(p[1], q[1]);
  const uint32_t d2 = __vabsdiffu4(p[2], q[2]);
  s[0] = (int)__dp4a(d0, 0x00010101u, 0u);
  s[1] = (int)__dp4a(d0, 0x01000000u, __dp4a(d1, 0x00000101u, 0u));
  s[2] = (int)__dp4a(d1, 0x01010000u, __dp4a(d2, 0x00000001u, 0u));
  s[3] = (int)__dp4a(d2, 0x01010100u, 0u);
}

// Byte i of three words, as a float.
__device__ __forceinline__ float byte_of(const uint32_t (&w)[3], int i) {
  return (float)((w[i >> 2] >> (8 * (i & 3))) & 0xffu);
}

// pixel_pass on the four pixels (y, x..x+3), x % 4 == 0.
__device__ __forceinline__ int pixel_pass4(const FkgArgs& a, long long frame,
                                           int f, int y, int x) {
  const long long p = frame + (long long)y * a.W + x;
  uint32_t fw[3], pw[3];
  load_px4(a.frames + p * 3, fw);
  load_px4(a.prev + p * 3, pw);
  int s[4];
  sad_px4(fw, pw, s);
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) cnt += s[k] >= a.delta_min;
  if (a.plane != nullptr) {
    const int packed_h = a.cs == CS_YUV420 ? a.H + a.H / 2 : a.H;
    uint8_t* pl = a.plane + (long long)f * packed_h * a.W;
    float lum[4];
    uint32_t lw = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lum[k] = luma(byte_of(fw, 3 * k), byte_of(fw, 3 * k + 1),
                    byte_of(fw, 3 * k + 2));
      lw |= (uint32_t)round_clip(lum[k]) << (8 * k);
    }
    *reinterpret_cast<uint32_t*>(pl + (long long)y * a.W + x) = lw;
    if (a.cs == CS_YUV420 && !(y & 1)) {
      // pixels x and x + 2 are the even ones: two U and two V bytes
      uint8_t* uv = pl + (long long)(a.H + y / 2) * a.W + x / 2;
      uint32_t u = 0, v = 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float b = byte_of(fw, 6 * k), r = byte_of(fw, 6 * k + 2);
        const float l = lum[2 * k];
        u |= (uint32_t)round_clip(
                 __fadd_rn(__fmul_rn(0.492f, __fsub_rn(b, l)), 128.0f)) << (8 * k);
        v |= (uint32_t)round_clip(
                 __fadd_rn(__fmul_rn(0.877f, __fsub_rn(r, l)), 128.0f)) << (8 * k);
      }
      *reinterpret_cast<uint16_t*>(uv) = (uint16_t)u;
      *reinterpret_cast<uint16_t*>(uv + a.W / 2) = (uint16_t)v;
    }
  }
  return cnt;
}

// fkg_prologue four pixels a thread, for widths that are a multiple of 4
// with 4-aligned frames: word loads, the channel sums by vabsdiff4/dp4a, and
// the mask, its dilation and erosion as words of four pixels (byte k of a
// word is pixel k; a neighbour column is a funnel shift of two words).
// Same outputs as fkg_prologue.
constexpr int PRO_G = PRO_W / 4 + 2;           // words: pixels x0-4 .. x0+67

__global__ void __launch_bounds__(THREADS) fkg_prologue_x4(FkgArgs a) {
  __shared__ uint32_t raw[PRO_H + 4][PRO_G];   // rows y0-2 .. y0+33
  __shared__ uint32_t dil[PRO_H + 2][PRO_G];   // rows y0-1 .. y0+32
  __shared__ int warp_cnt[WARPS];
  const int f = blockIdx.z;
  const int y0 = blockIdx.y * PRO_H, x0 = blockIdx.x * PRO_W;
  const long long frame = (long long)f * a.H * a.W;
  int cnt = 0;
  for (int g = threadIdx.x; g < PRO_H * (PRO_W / 4); g += THREADS) {
    const int y = y0 + g / (PRO_W / 4), x = x0 + 4 * (g % (PRO_W / 4));
    if (y < a.H && x < a.W) cnt += pixel_pass4(a, frame, f, y, x);
  }
  if (a.bg != nullptr && (a.art_enable == nullptr || a.art_enable[f] != 0)) {
    for (int g = threadIdx.x; g < (PRO_H + 4) * PRO_G; g += THREADS) {
      const int yy = g / PRO_G, gx = g % PRO_G;
      const int y = y0 - 2 + yy, x = x0 - 4 + 4 * gx;
      uint32_t m = 0;                  // outside the image: false
      if (y >= 0 && y < a.H && x >= 0 && x < a.W) {
        const long long p = (long long)y * a.W + x;
        uint32_t fw[3], bw[3];
        load_px4(a.frames + (frame + p) * 3, fw);
        load_px4(a.bg + p * 3, bw);
        int s[4];
        sad_px4(fw, bw, s);
#pragma unroll
        for (int k = 0; k < 4; ++k) m |= (uint32_t)(s[k] >= a.art_min) << (8 * k);
      }
      raw[yy][gx] = m;
    }
    __syncthreads();
    for (int g = threadIdx.x; g < (PRO_H + 2) * PRO_G; g += THREADS) {
      const int yy = g / PRO_G, gx = g % PRO_G;
      const int y = y0 - 1 + yy, x = x0 - 4 + 4 * gx;
      uint32_t d = 0x01010101u;        // outside the image: true
      if (y >= 0 && y < a.H && x >= 0 && x < a.W) {
        const uint32_t c = raw[yy + 1][gx];
        const uint32_t l = gx > 0 ? raw[yy + 1][gx - 1] : 0u;
        const uint32_t r = gx < PRO_G - 1 ? raw[yy + 1][gx + 1] : 0u;
        d = c | raw[yy][gx] | raw[yy + 2][gx] | __funnelshift_l(l, c, 8)
            | __funnelshift_r(c, r, 8);
      }
      dil[yy][gx] = d;
    }
    __syncthreads();
    for (int g = threadIdx.x; g < PRO_H * (PRO_W / 4); g += THREADS) {
      const int yy = g / (PRO_W / 4), gx = 1 + g % (PRO_W / 4);
      const int y = y0 + yy, x = x0 - 4 + 4 * gx;
      if (y < a.H && x < a.W) {
        const uint32_t c = dil[yy + 1][gx];
        const uint32_t er = c & dil[yy][gx] & dil[yy + 2][gx]
            & __funnelshift_l(dil[yy + 1][gx - 1], c, 8)
            & __funnelshift_r(c, dil[yy + 1][gx + 1], 8);
        *reinterpret_cast<uint32_t*>(a.keep + frame + (long long)y * a.W + x) =
            c | ((c & ~er) << 1);
      }
    }
  }
  cnt = (int)__reduce_add_sync(0xffffffffu, (unsigned)cnt);
  if ((threadIdx.x & 31) == 0) warp_cnt[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int w = 0; w < WARPS; ++w) n += warp_cnt[w];
    if (n) atomicAdd(&a.changed_count[f], n);
  }
}

// 0xff in each of the first n bytes of a word (n <= 0: none, n >= 4: all).
__device__ __forceinline__ uint32_t prefix_mask(int n) {
  return n >= 4 ? 0xffffffffu : (n <= 0 ? 0u : (1u << (8 * n)) - 1u);
}

// The keep bit of artifact block b on a frame whose knob4 enable is `en`.
__device__ __forceinline__ int keep_bit_of(const FkgArgs& a, int b, int en) {
  if (a.bg == nullptr) return 0;
  const int mode = a.block_mode[b] * en;
  return mode == 1 ? 1 : (mode == 2 ? 2 : 0);
}

// The payload tile of setting s, plane p: rows r0.., columns c0...
__device__ __forceinline__ uint8_t* payload_tile(const FkgArgs& a, int s,
                                                 int f, int p, int r0,
                                                 int c0) {
  return a.payload + ((((long long)s * a.F + f) * a.P + p) * a.oh + r0) * a.ow
         + c0;
}

// Store the nr x nc uint8 tile `ob` (or, with ob null, the value `fill`
// everywhere): 16 bytes a thread where every row is 16-aligned.
__device__ __forceinline__ void store_tile(const FkgArgs& a, const uint8_t* ob,
                                           uint8_t* dst, int nr, int nc,
                                           int fill = 0) {
  if ((a.ow & 15) == 0) {
    const int q_row = nc >> 4;
    const uint32_t fw = (uint32_t)fill * 0x01010101u;
    for (int t = threadIdx.x; t < nr * q_row; t += THREADS) {
      const int r = t / q_row, q = t - r * q_row;
      uint4 v = make_uint4(fw, fw, fw, fw);
      if (ob != nullptr) {
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(ob + r * OUT_PITCH + q * 16);
        v = make_uint4(src[0], src[1], src[2], src[3]);
      }
      *reinterpret_cast<uint4*>(dst + (long long)r * a.ow + q * 16) = v;
    }
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < nr; r += WARPS)
      for (int c = lane; c < nc; c += 32)
        dst[(long long)r * a.ow + c] =
            ob != nullptr ? ob[r * OUT_PITCH + c] : (uint8_t)fill;
  }
}

// Whether frame f keeps any pixel (keep code & keep_bit) in source rows
// [sy0, sy1) and columns [sx0, sx1): 16-byte loads of the keep codes where
// every row is 16-aligned (the columns rounded out, which can only find
// more), else bytes.  This thread's share; the caller ORs the block's.
__device__ bool any_kept(const FkgArgs& a, int f, int keep_bit, int sy0,
                         int sy1, int sx0, int sx1) {
  const uint8_t* k = a.keep + (long long)f * a.H * a.W;
  bool any = false;
  if ((a.W & 15) == 0) {
    const int q0 = sx0 >> 4, nq = ((sx1 + 15) >> 4) - q0;
    const uint32_t bits = (uint32_t)keep_bit * 0x01010101u;
    for (int i = threadIdx.x; i < (sy1 - sy0) * nq; i += THREADS) {
      const int y = sy0 + i / nq, q = q0 + i % nq;
      const uint4 v = *reinterpret_cast<const uint4*>(
          k + (long long)y * a.W + 16 * q);
      any |= ((v.x | v.y | v.z | v.w) & bits) != 0;
    }
  } else {
    const int nx = sx1 - sx0;
    for (int i = threadIdx.x; i < (sy1 - sy0) * nx; i += THREADS)
      any |= (k[(long long)(sy0 + i / nx) * a.W + sx0 + i % nx] & keep_bit) != 0;
  }
  return any;
}

// Valid feature deltas of thread tid's 8 columns of a tile with nr x nc
// stored outputs at (r0, c0): a prefix of them, (dx, dy).
__device__ __forceinline__ int2 valid_deltas(const FkgArgs& a, int r0, int c0,
                                             int nr, int nc) {
  const int fr = threadIdx.x >> 3, fc8 = (threadIdx.x & 7) * 8;
  if (fr >= nr) return make_int2(0, 0);
  return make_int2(min(8, max(0, min(nc, a.ow - c0 - 1) - fc8)),
                   r0 + fr + 1 < a.oh ? min(8, max(0, nc - fc8)) : 0);
}

// One (artifact block, output tile, frame), every plane and every blur
// setting of the block.
template <int P>
__global__ void __launch_bounds__(THREADS, 3) fkg_tile(FkgArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(P, a.win_h, a.win_w, a.n_per_block);
  float* win = reinterpret_cast<float*>(smem + L.win);
  float* vert = reinterpret_cast<float*>(smem + L.vert);
  float* table = reinterpret_cast<float*>(smem + L.table);
  float* red_l = reinterpret_cast<float*>(smem + L.red_l);
  int* red_c = reinterpret_cast<int*>(smem + L.red_c);
  uint8_t* outb = smem + L.out;
  const int wp = L.win_pitch, vp = L.vert_pitch;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int blk = blockIdx.x % a.A, tile = blockIdx.x / a.A;
  const int f = blockIdx.y;
  // Blocks that keep the same pixels of this frame compute the same
  // payload (a frame with knob4 disabled is every block's mode 0): the
  // first of them computes it and stores it for all ("mirrors").
  const int en = a.art_enable != nullptr ? a.art_enable[f] : 1;
  const int keep_bit = keep_bit_of(a, blk, en);
  unsigned mirrors = 1u << blk;
  if (a.blocks_alike) {
    for (int b = 0; b < a.A; ++b) {
      if (b == blk || keep_bit_of(a, b, en) != keep_bit) continue;
      if (b < blk) return;
      mirrors |= 1u << b;
    }
  }
  const int ty = tile / a.tiles_x, tx = tile - ty * a.tiles_x;
  const int r0 = ty * TILE_H, c0 = tx * TILE_W;
  const int nr = min(TILE_H, a.oh - r0), nc = min(TILE_W, a.ow - c0);
  const int nrc = min(ROWS, a.oh - r0), ncc = min(COLS, a.ow - c0);
  const int lo_y = a.win_y[2 * ty], wy = a.win_y[2 * ty + 1] - lo_y;
  const int lo_x = a.win_x[2 * tx], wx = a.win_x[2 * tx + 1] - lo_x;
  for (int i = tid; i < 256; i += THREADS) table[i] = a.log2_table[i];
  SetParams* params = reinterpret_cast<SetParams*>(smem + L.params);
  if (tid < a.n_per_block) {
    SetParams q;
    q.s = a.block_sets[blk * a.n_per_block + tid];
    q.ident = a.ident[q.s];
    q.kv = a.vk[q.s * a.tiles_y + ty];
    q.kh = a.hk[q.s * a.tiles_x + tx];
    q.wv = a.vw[q.s * a.tiles_y + ty];
    q.wh = a.hw[q.s * a.tiles_x + tx];
    q.vx0 = a.col_span[2 * (q.s * a.tiles_x + tx)] - lo_x;
    q.vx1 = a.col_span[2 * (q.s * a.tiles_x + tx) + 1] - lo_x;
    q.oy = a.by_start[(long long)q.s * a.oh + r0] - lo_y;
    q.ox = a.bx_start[(long long)q.s * a.ow + c0] - lo_x;
    params[tid] = q;
  }
  __syncthreads();

  // A window in which knob4 keeps no pixel is constant: 0 in luma, gray and
  // BGR rows, 128 in chroma rows.  An all-zero window blurs to zeros whatever
  // the weights (0 * w sums to 0 exactly); an all-128 window blurs to 128
  // where every band's weights are non-negative and sum to 1 within 1e-4
  // (unit_bands): each of the <= 2 x 15 + 2 x 2 fmaf steps errs by at most
  // 2^-24 relative, so the sum stays within 0.1 of 128 and rounds to it.
  // The keep codes of the tile's resize window (src_y, src_x) decide it
  // before any staging; a window across the Y/UV seam is staged.
  bool live = true;
  int fill = 0;                        // the constant of a window not live
  if (keep_bit != 0) {
    int sy0 = a.src_y[2 * ty], sy1 = a.src_y[2 * ty + 1];
    int sx0 = a.src_x[2 * tx], sx1 = a.src_x[2 * tx + 1];
    bool test = sy1 <= a.H;
    if (P == 1 && !test && sy0 >= a.H && a.unit_bands) {
      // chroma rows: packed row r, column x read source pixel
      // (2 (r - H), 2 x) for U and (2 (r - H), 2 (x - W/2)) for V
      test = true;
      fill = 128;
      const int half = a.W / 2;
      sy0 = 2 * (sy0 - a.H);
      sy1 = 2 * (sy1 - 1 - a.H) + 1;
      if (sx1 <= half) {
        sx0 = 2 * sx0;
        sx1 = 2 * (sx1 - 1) + 1;
      } else if (sx0 >= half) {
        sx0 = 2 * (sx0 - half);
        sx1 = 2 * (sx1 - 1 - half) + 1;
      } else {
        sx0 = 0;
        sx1 = a.W;
      }
    }
    if (test)
      live = __syncthreads_or(any_kept(a, f, keep_bit, sy0, sy1, sx0, sx1));
  }
  if (live) {
    // the blur's input window, resized: knob4 -> knob2 -> knob1 -> round/clip
    bool nz;
    if (a.ry_k == 1)
      nz = a.rx_k == 1
          ? stage_window<P, 1, 1>(a, f, keep_bit, lo_y, wy, lo_x, wx, win, wp)
          : stage_window<P, 1, 2>(a, f, keep_bit, lo_y, wy, lo_x, wx, win, wp);
    else
      nz = a.rx_k == 1
          ? stage_window<P, 2, 1>(a, f, keep_bit, lo_y, wy, lo_x, wx, win, wp)
          : stage_window<P, 2, 2>(a, f, keep_bit, lo_y, wy, lo_x, wx, win, wp);
    live = __syncthreads_or(nz);
    fill = 0;
  }

  // Features: thread (tid / 8, tid % 8) takes 8 columns of one stored row,
  // as two words of the uint8 tile.  Byte masks select the deltas inside
  // the image and the tile (dx up to the next column, dy up to the next row
  // of the same plane: the extra column and row computed above); a masked
  // delta is 0, which adds log2(1) = 0 to the log sums and is not counted.

  // Every blur setting over the one window.  Two uint8 tiles alternate, so
  // one barrier between a pass and the stores that read it suffices: a
  // tile is written again two iterations later, after the next barrier.
  int it = 0;
  for (int k = 0; k < a.n_per_block; ++k) {
    const SetParams q = params[k];
    const int s = q.s;
    float fl[2] = {0.0f, 0.0f};
    int fc[4] = {0, 0, 0, 0};
    if (!live) {
      for (int p = 0; p < P; ++p)
        for (unsigned m = mirrors; m; m &= m - 1)
          store_tile(a, nullptr,
                     payload_tile(a, a.block_sets[(__ffs(m) - 1) * a.n_per_block + k],
                                  f, p, r0, c0), nr, nc, fill);
      const int2 nv = valid_deltas(a, r0, c0, nr, nc);
      fc[0] = fc[1] = P * nv.x;
      fc[2] = fc[3] = P * nv.y;
    } else {
      const bool ident = q.ident != 0;
      const int kv = q.kv, kh = q.kh, vx0 = q.vx0, vx1 = q.vx1;
      const int oy = q.oy, ox = q.ox;
      const float wv = q.wv, wh = q.wh;
      for (int p = 0; p < P; ++p, ++it) {
        const float* wn = win + p * a.win_h * wp;
        uint8_t* ob = outb + (it & 1) * ROWS * OUT_PITCH;
        if (ident) {
          const int dy = r0 - lo_y, dx = c0 - lo_x;
          for (int r = warp; r < nrc; r += WARPS)
            for (int c = lane; c < ncc; c += 32)
              ob[r * OUT_PITCH + c] = (uint8_t)wn[(dy + r) * wp + dx + c];
        } else {
          switch (kv) {
            case 5: vertical_uniform<5>(wn, wp, vert, vp, oy, vx0, vx1, wv); break;
            case 8: vertical_uniform<8>(wn, wp, vert, vp, oy, vx0, vx1, wv); break;
            case 10: vertical_uniform<10>(wn, wp, vert, vp, oy, vx0, vx1, wv); break;
            case 15: vertical_uniform<15>(wn, wp, vert, vp, oy, vx0, vx1, wv); break;
            default:
              vertical_general(a, s, r0, lo_y, nrc, wn, wp, vert, vp, vx0, vx1);
          }
          __syncthreads();
          switch (kh) {
            case 5: horizontal_uniform<5>(vert, vp, ob, ox, nrc, wh); break;
            case 8: horizontal_uniform<8>(vert, vp, ob, ox, nrc, wh); break;
            case 10: horizontal_uniform<10>(vert, vp, ob, ox, nrc, wh); break;
            case 15: horizontal_uniform<15>(vert, vp, ob, ox, nrc, wh); break;
            default:
              horizontal_general(a, s, c0, lo_x, nrc, ncc, vert, vp, ob);
          }
        }
        __syncthreads();
        for (unsigned m = mirrors; m; m &= m - 1)
          store_tile(a, ob,
                     payload_tile(a, a.block_sets[(__ffs(m) - 1) * a.n_per_block + k],
                                  f, p, r0, c0), nr, nc);
        const int2 nv = valid_deltas(a, r0, c0, nr, nc);
        if (nv.x | nv.y) {
          const uint8_t* row = ob + (tid >> 3) * OUT_PITCH + (tid & 7) * 8;
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(row);
          const uint32_t a1 = *reinterpret_cast<const uint32_t*>(row + 4);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(row + 8);
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row + OUT_PITCH);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + OUT_PITCH + 4);
          const uint32_t m[4] = {prefix_mask(nv.x), prefix_mask(nv.x - 4),
                                 prefix_mask(nv.y), prefix_mask(nv.y - 4)};
          const uint32_t d[4] = {
              __vabsdiffu4(a0, __byte_perm(a0, a1, 0x4321)) & m[0],
              __vabsdiffu4(a1, __byte_perm(a1, a2, 0x4321)) & m[1],
              __vabsdiffu4(a0, b0) & m[2], __vabsdiffu4(a1, b1) & m[3]};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const uint32_t ones = m[w] & 0x01010101u;
            fc[(w >> 1) * 2 + 0] += __dp4a(__vseteq4(d[w], 0u) & ones, 0x01010101u, 0u);
            fc[(w >> 1) * 2 + 1] += __dp4a(__vsetleu4(d[w], 0x02020202u) & ones,
                                           0x01010101u, 0u);
#pragma unroll
            for (int i = 0; i < 4; ++i) fl[w >> 1] += table[(d[w] >> (8 * i)) & 0xffu];
          }
        }
      }
    }
    // this setting's partials: a fixed-order warp tree, one slot a warp
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      fl[0] += __shfl_down_sync(0xffffffffu, fl[0], o);
      fl[1] += __shfl_down_sync(0xffffffffu, fl[1], o);
#pragma unroll
      for (int i = 0; i < 4; ++i) fc[i] += __shfl_down_sync(0xffffffffu, fc[i], o);
    }
    if (lane == 0) {
      red_l[(k * WARPS + warp) * 2 + 0] = fl[0];
      red_l[(k * WARPS + warp) * 2 + 1] = fl[1];
#pragma unroll
      for (int i = 0; i < 4; ++i) red_c[(k * WARPS + warp) * 4 + i] = fc[i];
    }
  }
  __syncthreads();
  if (tid < a.n_per_block) {
    const int k = tid;
    float l0 = 0.0f, l1 = 0.0f;
    int c[4] = {0, 0, 0, 0};
    for (int w = 0; w < WARPS; ++w) {
      l0 += red_l[(k * WARPS + w) * 2 + 0];
      l1 += red_l[(k * WARPS + w) * 2 + 1];
      for (int i = 0; i < 4; ++i) c[i] += red_c[(k * WARPS + w) * 4 + i];
    }
    for (unsigned m = mirrors; m; m &= m - 1) {
      const int s = a.block_sets[(__ffs(m) - 1) * a.n_per_block + k];
      const long long o = ((long long)s * a.F + f) * a.tiles_y * a.tiles_x + tile;
      a.part_log[o * 2 + 0] = l0;
      a.part_log[o * 2 + 1] = l1;
      for (int i = 0; i < 4; ++i) a.part_cnt[o * 4 + i] = c[i];
    }
  }
}

// Fixed-order sum of the tiles' partials (one warp per (setting, frame));
// the changed fraction of every row.
__global__ void __launch_bounds__(THREADS) fkg_final(FkgArgs a) {
  const int sf = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (sf >= a.S * a.F) return;
  const int n = a.tiles_y * a.tiles_x;
  float l0 = 0.0f, l1 = 0.0f;
  int c[4] = {0, 0, 0, 0};
  for (int t = lane; t < n; t += 32) {
    const long long o = (long long)sf * n + t;
    l0 += a.part_log[o * 2 + 0];
    l1 += a.part_log[o * 2 + 1];
    for (int i = 0; i < 4; ++i) c[i] += a.part_cnt[o * 4 + i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    l0 += __shfl_down_sync(0xffffffffu, l0, o);
    l1 += __shfl_down_sync(0xffffffffu, l1, o);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += __shfl_down_sync(0xffffffffu, c[i], o);
  }
  if (lane == 0) {
    float* out = a.feats + (long long)sf * 6;
    out[0] = l0; out[1] = (float)c[0]; out[2] = (float)c[1];
    out[3] = l1; out[4] = (float)c[2]; out[5] = (float)c[3];
    const int f = sf % a.F;
    a.changed[sf] = (float)a.changed_count[f] / (float)((long long)a.H * a.W);
  }
}

template <int P>
cudaError_t launch_tile(const FkgArgs& a, cudaStream_t st) {
  const size_t smem = smem_layout(P, a.win_h, a.win_w, a.n_per_block).total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fkg_tile<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)(a.A * a.tiles_y * a.tiles_x), (unsigned)a.F);
  fkg_tile<P><<<grid, THREADS, smem, st>>>(a);
  return cudaSuccess;
}

// The least channel sum s (of three uint8 differences, at most 765) with
// (float)s / 3.0f > thresh, computed in IEEE float32 as on the card; 766
// when none passes.
int least_sum_above(float thresh) {
  int s = 0;
  while (s <= 765 && !((float)s / 3.0f > thresh)) ++s;
  return s;
}

}  // namespace

extern "C" {

// Shared memory fkg_tile asks for, in bytes, for a plan's window capacity.
int fkg_smem_bytes(int P, int win_h, int win_w, int n_per_block) {
  return (int)smem_layout(P, win_h, win_w, n_per_block).total;
}

// Launches every stage on `stream`; allocates nothing and does not
// synchronise.  Returns cudaGetLastError() after the last launch.
int fkg_launch(const FkgArgs* args, void* stream) {
  FkgArgs a = *args;
  a.delta_min = least_sum_above(a.pixel_delta);
  a.art_min = least_sum_above(a.art_thresh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(a.changed_count, 0, sizeof(int32_t) * a.F, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 pro_grid((a.W + PRO_W - 1) / PRO_W, (a.H + PRO_H - 1) / PRO_H, a.F);
  const uintptr_t align = (uintptr_t)a.frames | (uintptr_t)a.prev
                          | (uintptr_t)a.bg | (uintptr_t)a.keep
                          | (uintptr_t)a.plane;
  if (a.W % 4 == 0 && align % 4 == 0)
    fkg_prologue_x4<<<pro_grid, THREADS, 0, st>>>(a);
  else
    fkg_prologue<<<pro_grid, THREADS, 0, st>>>(a);
  err = a.P == 3 ? launch_tile<3>(a, st) : launch_tile<1>(a, st);
  if (err != cudaSuccess) return (int)err;
  fkg_final<<<(a.S * a.F + WARPS - 1) / WARPS, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

const char* fkg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
