// conv3x3, variant "head_o1": one output channel (Hopper, sm_90a).
//
// Replaces the TPU kernel learned_pmctf_tpu/ops/pallas_conv.py:conv3x3_hcw
// for O = 1 (the 64->1 output conv of PostProcess). Same function as the
// other variants: y = act(conv3x3(x, w) + b [+ residual]), NCHW, f32.
//
// What bounds it: bytes. It reads C input planes and writes one, and does
// 18 operations for every 4 bytes it reads, far under the card's ratio of
// f32 rate to memory rate: the 3.35 TB/s of HBM3 bound it, not the f32
// cores.
//
// Design: every thread works for the one output channel, none is idle.
// - a 256-thread block owns a tile of 8 rows x 128 pixels and is
//   persistent (grid = SM count); a thread keeps 4 pixels of one column
//   in registers, a warp's lanes are 32 adjacent columns: shared-memory
//   reads are conflict-free and each value read serves up to 3 rows;
// - input channels are walked 8 at a time through a three-stage ring in
//   shared memory, filled by cp.async (16 bytes a copy, zero-fill for the
//   'same' padding and the ragged edge) two chunks ahead of the FMAs, and
//   on across tile boundaries: that keeps about 87 KB in flight on each
//   SM, which is what the memory system needs to run at its rate;
// - the 9 C weights sit in shared memory for the block's life and are
//   read as broadcasts, three 16-byte loads a channel;
// - bias, residual and activation are fused; outputs are coalesced rows.
// Deterministic: a fixed summation order (chunk, channel, row, kx).
//
// "head_bf16" is the kernel for the bf16 instance (bf16 x, residual and y;
// f32 weights, the bf16 ones upcast exactly; f32 arithmetic in the same
// order; one rounding on the store). It reads half the bytes, 0.086 ms at
// luma 1x64x1152x1920 (3.35 TB/s, H100 SXM at 700 W). Its ring holds the
// raw bf16 inputs, filled by cp.async like the f32 one, and the FMAs
// convert where they read shared memory (bf16 to f32 is a 16-bit shift).
// A bf16 stage is half an f32 one, so the ring has four stages of 8
// channels, 92 KB, and two blocks share an SM: six stages in flight, about
// 138 KB on each SM. A window row is 18 copies of 8 pixels: the 8 left of
// the tile (the last of them is the left halo), the 128 of the tile, and
// the 8 right of it (the first is the right halo).

#include "conv3x3_common.cuh"

namespace conv3x3 {
namespace {

constexpr int kTW = 128;
constexpr int kTH = 8;
constexpr int kCC = 8;
constexpr int kPix = 4;                // rows a thread owns
constexpr int kRows = kTH + 2;
constexpr int kMaxC = 2048;            // weights: 48 bytes a channel

// The ring of the element type T that a stage holds.
template <typename T>
struct Ring;
template <>
struct Ring<float> {
  static constexpr int kStride = kTW + 8;  // 3 unused, halo, 128, halo, 3 unused
  static constexpr int kCol = 3;           // column of pixel -1 of the tile
  static constexpr int kStages = 3;
  static constexpr int kBlocks = 1;        // blocks an SM
};
template <>
struct Ring<__nv_bfloat16> {
  static constexpr int kStride = kTW + 16;  // 8 left of the tile, 128, 8 right
  static constexpr int kCol = 7;
  static constexpr int kStages = 4;
  static constexpr int kBlocks = 2;
};

// Stage CC channels of the ROWS x STRIDE bf16 window whose first interior
// pixel is (y0, x0) and whose first row is y0-1: copy v of a row holds
// pixels x0 - 8 + 8 v (16 bytes), zero-filled where they lie outside the
// image. With `vec` (W % 8 == 0 and x on 16 bytes) a copy is all inside or
// all outside; else the elements are loaded one by one, synchronously.
template <int CC, int ROWS, int STRIDE, int PLANE>
__device__ __forceinline__ void stage_acts_bf16(__nv_bfloat16* dst, const __nv_bfloat16* xn,
                                                int c0, int C, int y0, int x0, int H,
                                                int W, bool vec, int tid) {
  constexpr int VPR = STRIDE / 8;
  const size_t plane = (size_t)H * W;
  if (vec) {
    for (int i = tid; i < CC * ROWS * VPR; i += kThreads) {
      const int v = i % VPR;
      const int cc = (i / VPR) % CC;
      const int r = i / (VPR * CC);
      const int gy = y0 - 1 + r;
      const int gx = x0 - 8 + 8 * v;
      const int c = c0 + cc;
      const bool ok = c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(dst + cc * PLANE + r * STRIDE + 8 * v,
                 ok ? xn + (size_t)c * plane + (size_t)gy * W + gx : xn, ok ? 16 : 0);
    }
    return;
  }
  for (int i = tid; i < CC * ROWS * STRIDE; i += kThreads) {
    const int k = i % STRIDE;
    const int cc = (i / STRIDE) % CC;
    const int r = i / (STRIDE * CC);
    const int gy = y0 - 1 + r;
    const int gx = x0 - 8 + k;
    const int c = c0 + cc;
    const bool ok = c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
    dst[cc * PLANE + r * STRIDE + k] =
        ok ? xn[(size_t)c * plane + (size_t)gy * W + gx] : __float2bfloat16_rn(0.f);
  }
}

// T: float or __nv_bfloat16 for x, res and y; the weights are f32
template <typename T>
__global__ void __launch_bounds__(kThreads, Ring<T>::kBlocks)
conv3x3_head_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, const T* __restrict__ res,
                    T* __restrict__ y, int N, int C, int H, int W, int act,
                    int vec) {
  using R = Ring<T>;
  constexpr int kStride = R::kStride;
  constexpr int kPlane = kRows * kStride;
  constexpr int kStageElems = kCC * kPlane;
  constexpr int kStages = R::kStages;
  static_assert(kStageElems * sizeof(T) % 16 == 0, "weights on 16 bytes");
  extern __shared__ __align__(16) float smem_f[];
  T* smem = reinterpret_cast<T*>(smem_f);
  float* w_s = reinterpret_cast<float*>(smem + kStages * kStageElems);  // [channel][12]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = (warp & 3) * 32 + lane;
  const int row0 = (warp >> 2) * kPix;

  const TileWalk walk(N, H, W, kTH, kTW);
  const int nchunks = (C + kCC - 1) / kCC;
  const int my_tiles =
      blockIdx.x < walk.total ? (walk.total - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int steps = my_tiles * nchunks;
  const size_t plane = (size_t)H * W;

  for (int i = tid; i < nchunks * kCC * 12; i += kThreads) {
    const int c = i / 12, k = i % 12;
    w_s[i] = (c < C && k < 9) ? w[c * 9 + k] : 0.f;
  }

  int p_tile = blockIdx.x, p_chunk = 0, p_stage = 0;
  auto stage_next = [&]() {
    int n, ty, tx;
    walk.decode(p_tile, n, ty, tx);
    if constexpr (sizeof(T) == 4)
      stage_acts<kCC, kRows, kTW, kStride, kPlane>(
          smem + p_stage * kStageElems, x + (size_t)n * C * plane, p_chunk * kCC,
          C, ty * kTH, tx * kTW, H, W, vec != 0, tid);
    else
      stage_acts_bf16<kCC, kRows, kStride, kPlane>(
          smem + p_stage * kStageElems, x + (size_t)n * C * plane, p_chunk * kCC,
          C, ty * kTH, tx * kTW, H, W, vec != 0, tid);
    if (++p_chunk == nchunks) {
      p_chunk = 0;
      p_tile += gridDim.x;
    }
    if (++p_stage == kStages) p_stage = 0;
  };

  float acc[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) acc[p] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) stage_next();
    cp_async_commit();
  }

  int c_tile = blockIdx.x, c_chunk = 0, c_stage = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s has landed (and, at s = 0, the weights)
    if (s + kStages - 1 < steps) stage_next();
    cp_async_commit();

    const T* A = smem + c_stage * kStageElems + row0 * kStride + R::kCol + col;
    const float4* wq = reinterpret_cast<const float4*>(w_s + c_chunk * kCC * 12);
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) {
      const float4 w0 = wq[cc * 3], w1 = wq[cc * 3 + 1], w2 = wq[cc * 3 + 2];
      const float wv[9] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x};
#pragma unroll
      for (int r = 0; r < kPix + 2; ++r) {
        const T* p = A + cc * kPlane + r * kStride;
        const float v[3] = {to_float(p[0]), to_float(p[1]), to_float(p[2])};
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int q = r - ky;  // the output row this input row feeds at tap ky
          if (q >= 0 && q < kPix) {
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
              acc[q] = fmaf(v[kx], wv[ky * 3 + kx], acc[q]);
          }
        }
      }
    }
    if (++c_stage == kStages) c_stage = 0;

    if (++c_chunk == nchunks) {
      int n, ty, tx;
      walk.decode(c_tile, n, ty, tx);
      const int gx = tx * kTW + col;
      const float bias = b[0];
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        const int gy = ty * kTH + row0 + p;
        if (gx < W && gy < H) {
          const size_t o = (size_t)n * plane + (size_t)gy * W + gx;
          float v = acc[p] + bias;
          if (res != nullptr) v += to_float(res[o]);
          y[o] = from_float<T>(activate(v, act));
        }
        acc[p] = 0.f;
      }
      c_chunk = 0;
      c_tile += gridDim.x;
    }
  }
  cp_async_wait<0>();
}

template <typename T>
cudaError_t launch_head_t(const Args& a) {
  if (a.O != 1 || a.C > kMaxC) return cudaErrorInvalidValue;
  constexpr int kStageBytes = kCC * kRows * Ring<T>::kStride * (int)sizeof(T);
  const int nchunks = (a.C + kCC - 1) / kCC;
  const int smem = Ring<T>::kStages * kStageBytes + nchunks * kCC * 12 * 4;
  auto kernel = conv3x3_head_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // persistent: as many blocks as fit on the SMs (the weights grow with C)
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int slots = sm_count() * (per_sm < Ring<T>::kBlocks ? per_sm : Ring<T>::kBlocks);
  const TileWalk walk(a.N, a.H, a.W, kTH, kTW);
  const int grid = walk.total < slots ? walk.total : slots;
  // a copy is 16 bytes: 4 f32 or 8 bf16 pixels
  const int vec = a.W % (16 / (int)sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.w), a.b,
      static_cast<const T*>(a.res), static_cast<T*>(a.y), a.N, a.C, a.H, a.W, a.act, vec);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_head(const Args& a) { return launch_head_t<float>(a); }
cudaError_t launch_head_bf16(const Args& a) { return launch_head_t<__nv_bfloat16>(a); }

}  // namespace conv3x3
