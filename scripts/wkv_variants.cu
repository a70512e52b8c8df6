// Launch variants of the wkv scan, timed by scripts/wkv_variants.py to
// choose the shipped kernel's launch.  Not part of the port: it instantiates
// src/repro_torch/kernels/csrc/wkv_linear_scan.cu's own kernel template
// (wkv::wkv_chunk_scan, included below) at head dim 64 with other launch
// constants than the shipped wkv::Config<64>: KQ lanes a column, NV columns
// a thread, VS blocks a (batch, head), TC steps staged a chunk.  Each
// variant does the shipped kernel's arithmetic in its own order of y's
// partial sums.

#include "../src/repro_torch/kernels/csrc/wkv_linear_scan.cu"

// (KQ, NV, VS, TC); threads a block KQ * 64 / (VS * NV).  A decode step
// (S = 1) takes the kernel's unstaged path, where TC plays no part.
#define WKV_VARIANTS(X)                                                     \
  X(4, 4, 1, 16) X(4, 4, 1, 32) X(4, 4, 2, 16) X(8, 4, 1, 16)               \
  X(8, 4, 1, 32) X(2, 2, 1, 32) X(8, 8, 1, 8) X(8, 8, 1, 16)                \
  X(8, 8, 1, 32) X(8, 8, 2, 16) X(4, 2, 1, 32) X(16, 8, 1, 32)

#define WKV_NAME(KQ, NV, VS, TC) #KQ " " #NV " " #VS " " #TC ";"
#define WKV_CASE(KQ_, NV_, VS_, TC_)                                       \
  if (kq == KQ_ && nv == NV_ && vs == VS_ && tc == TC_)                    \
    return dtype == 0                                                      \
               ? wkv::launch<float, 64, KQ_, NV_, VS_, TC_>(               \
                     r, k, v, logw, u, state0, y, state_out, B, S, H, st)  \
               : wkv::launch<__nv_bfloat16, 64, KQ_, NV_, VS_, TC_>(       \
                     r, k, v, logw, u, state0, y, state_out, B, S, H, st);

extern "C" {

// "KQ NV VS TC;" for every variant built
const char* wkv_variant_list() { return WKV_VARIANTS(WKV_NAME); }

// K = 64 only; dtype 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
int wkv_variant_launch(const void* r, const void* k, const void* v,
                       const float* logw, const float* u,
                       const float* state0, void* y, float* state_out, int B,
                       int S, int H, int dtype, int kq, int nv, int vs,
                       int tc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  WKV_VARIANTS(WKV_CASE)
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
