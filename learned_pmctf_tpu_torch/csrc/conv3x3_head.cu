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

#include "conv3x3_common.cuh"

namespace conv3x3 {
namespace {

constexpr int kTW = 128;
constexpr int kTH = 8;
constexpr int kCC = 8;
constexpr int kPix = 4;                // rows a thread owns
constexpr int kStride = kTW + 8;       // 3 unused, halo, 128, halo, 3 unused
constexpr int kRows = kTH + 2;
constexpr int kPlane = kRows * kStride;
constexpr int kStageFloats = kCC * kPlane;
constexpr int kStages = 3;
constexpr int kMaxC = 2048;            // weights: 48 bytes a channel

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_head_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ res,
                    float* __restrict__ y, int N, int C, int H, int W, int act,
                    int vec) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem + kStages * kStageFloats;  // [channel][12]: 9 taps, 3 unused

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
    stage_acts<kCC, kRows, kTW, kStride, kPlane>(
        smem + p_stage * kStageFloats, x + (size_t)n * C * plane, p_chunk * kCC,
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

    const float* A = smem + c_stage * kStageFloats + row0 * kStride + 3 + col;
    const float4* wq = reinterpret_cast<const float4*>(w_s + c_chunk * kCC * 12);
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) {
      const float4 w0 = wq[cc * 3], w1 = wq[cc * 3 + 1], w2 = wq[cc * 3 + 2];
      const float wv[9] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x};
#pragma unroll
      for (int r = 0; r < kPix + 2; ++r) {
        const float* p = A + cc * kPlane + r * kStride;
        const float v[3] = {p[0], p[1], p[2]};
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
          if (res != nullptr) v += res[o];
          y[o] = activate(v, act);
        }
        acc[p] = 0.f;
      }
      c_chunk = 0;
      c_tile += gridDim.x;
    }
  }
  cp_async_wait<0>();
}

}  // namespace

cudaError_t launch_head(const Args& a) {
  if (a.O != 1 || a.C > kMaxC) return cudaErrorInvalidValue;
  const int nchunks = (a.C + kCC - 1) / kCC;
  const int smem = (kStages * kStageFloats + nchunks * kCC * 12) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const TileWalk walk(a.N, a.H, a.W, kTH, kTW);
  const int grid = walk.total < sm_count() ? walk.total : sm_count();
  const int vec = a.W % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  conv3x3_head_kernel<<<grid, kThreads, smem, a.stream>>>(
      a.x, a.w, a.b, a.res, a.y, a.N, a.C, a.H, a.W, a.act, vec);
  return cudaGetLastError();
}

}  // namespace conv3x3
