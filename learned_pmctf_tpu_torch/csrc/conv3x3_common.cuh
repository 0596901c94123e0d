// Shared pieces of the conv3x3 variants (Hopper, sm_90a): the launch
// arguments, the fused f32 epilogue and the conversions of the bf16
// instance, cp.async helpers and the staging of an activation tile with
// its zero halo into shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv3x3 {

enum Act { kNone = 0, kLeaky = 1, kTanh = 2 };
enum Variant {
  kAuto = 0, kDirect = 1, kHead = 2, kMmaSync = 3, kWgmma = 4,
  // the bf16 instance (bf16 x, residual and y; f32 bias and arithmetic)
  kDirectBf16 = 5, kHeadBf16 = 6, kWgmmaBf16 = 7
};

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB: the most one block can ask for

// NCHW; x, res and y are float, or __nv_bfloat16 for the bf16 variants;
// `w` is in the layout of the variant that is launched; b is f32.
struct Args {
  const void* x;
  const void* w;
  const float* b;
  const void* res;  // may be null
  void* y;
  int N, C, H, W, O, act;
  cudaStream_t stream;
};

cudaError_t launch_direct(const Args& a);
cudaError_t launch_head(const Args& a);
cudaError_t launch_mma_sync(const Args& a);
cudaError_t launch_wgmma(const Args& a);
cudaError_t launch_direct_bf16(const Args& a);
cudaError_t launch_head_bf16(const Args& a);
cudaError_t launch_wgmma_bf16(const Args& a);
// Output channels after padding to a width the tensor-core variants have
// (0: none).
int tc_padded_o(int O);
// Whether x, the residual and y all lie on 16-byte multiples.
inline bool aligned16(const Args& a) {
  return (reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.res) |
          reinterpret_cast<uintptr_t>(a.y)) % 16 == 0;
}
// Whether the wgmma variant takes the shape (`aligned`: see aligned16).
bool wgmma_takes(int C, int O, int W, bool aligned);
bool wgmma_bf16_takes(int C, int O, int W, bool aligned);

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Loads and stores of the element types: the arithmetic is f32 in every
// variant, the bf16 instance rounds once, to nearest even, on the store.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kLeaky) return v >= 0.f ? v : 0.2f * v;
  if (act == kTanh) return tanhf(v);
  return v;
}

// f32 -> TF32 (10 mantissa bits), to nearest with ties away from zero:
// what cvt.rna.tf32.f32 gives for finite values, in two integer
// operations at full rate (cvt.rna.tf32.f32 itself measured slower).
// The split of an activation v is big = to_tf32(v), small =
// to_tf32(v - big); ops/conv3x3.py:tf32_split splits the weights the same
// way.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies. `bytes` of the source are read
// (0 or the full size here), the rest of the destination is zero-filled:
// that is the 'same' padding and the ragged edge.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage CC channels (c0 .. c0+CC-1) of the (ROWS x (TW+2)) input window
// whose first interior pixel is (y0, x0) and whose first row is y0-1.
// Layout: dst[cc][row][col], row stride STRIDE, channel stride PLANE; the
// TW interior columns start at col 4 (16-byte aligned), the halo columns
// are 3 and 4+TW. `xn` is the image's first channel. With `vec` the
// interior goes 16 bytes a copy (needs W % 4 == 0 and a 16-byte aligned
// x), else 4 bytes a copy. CC and TW/4 are powers of two: the index
// split is shifts and masks.
template <int CC, int ROWS, int TW, int STRIDE, int PLANE>
__device__ __forceinline__ void stage_acts(float* dst, const float* xn, int c0,
                                           int C, int y0, int x0, int H, int W,
                                           bool vec, int tid) {
  constexpr int VPR = TW / 4;
  static_assert((VPR & (VPR - 1)) == 0 && (CC & (CC - 1)) == 0, "powers of two");
  const size_t plane = (size_t)H * W;
  for (int i = tid; i < CC * ROWS * VPR; i += kThreads) {
    const int v = i % VPR;
    const int cc = (i / VPR) % CC;
    const int r = i / (VPR * CC);
    const int gy = y0 - 1 + r;
    const int gx = x0 + 4 * v;
    const int c = c0 + cc;
    const bool row_ok = c < C && gy >= 0 && gy < H;
    float* d = dst + cc * PLANE + r * STRIDE + 4 + 4 * v;
    const float* s = xn + (row_ok ? (size_t)c * plane + (size_t)gy * W : 0);
    if (vec) {
      const bool ok = row_ok && gx < W;
      cp_async16(d, ok ? s + gx : xn, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && gx + e < W;
        cp_async4(d + e, ok ? s + gx + e : xn, ok ? 4 : 0);
      }
    }
  }
  for (int i = tid; i < CC * ROWS * 2; i += kThreads) {
    const int side = i & 1;
    const int cc = (i >> 1) % CC;
    const int r = i / (2 * CC);
    const int gy = y0 - 1 + r;
    const int gx = side ? x0 + TW : x0 - 1;
    const int c = c0 + cc;
    const bool ok = c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
    float* d = dst + cc * PLANE + r * STRIDE + (side ? 4 + TW : 3);
    cp_async4(d, ok ? xn + (size_t)c * plane + (size_t)gy * W + gx : xn, ok ? 4 : 0);
  }
}

// A persistent block's walk over (image, tile row, tile column).
struct TileWalk {
  int tiles_x, tiles_y, total;
  __host__ __device__ TileWalk(int N, int H, int W, int TH, int TW)
      : tiles_x((W + TW - 1) / TW), tiles_y((H + TH - 1) / TH),
        total(N * tiles_x * tiles_y) {}
  __device__ __forceinline__ void decode(int tile, int& n, int& ty, int& tx) const {
    tx = tile % tiles_x;
    const int r = tile / tiles_x;
    ty = r % tiles_y;
    n = r / tiles_y;
  }
};

}  // namespace conv3x3
