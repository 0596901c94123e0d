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
// "head_bf16" is the same kernel for the bf16 instance (bf16 x, residual
// and y; f32 weights, bias and arithmetic; one rounding on the store). Its
// inputs are half the bytes, but cp.async cannot convert, so a stage is
// filled by plain 16-byte loads (8 pixels) converted to f32 into the same
// window layout; the ring then only overlaps one warp's loads with
// another's FMAs.

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

// stage_acts for bf16 inputs: the same f32 window (interior at column 4,
// halo columns 3 and 4+TW), filled by plain loads and converted. `vec`:
// 16 bytes (8 pixels) a load, which needs W % 8 == 0 and an x on 16 bytes.
template <int CC, int ROWS, int TW, int STRIDE, int PLANE>
__device__ __forceinline__ void stage_acts_bf16(float* dst, const __nv_bfloat16* xn,
                                                int c0, int C, int y0, int x0, int H,
                                                int W, bool vec, int tid) {
  constexpr int VPR = TW / 8;
  static_assert((VPR & (VPR - 1)) == 0 && (CC & (CC - 1)) == 0, "powers of two");
  const size_t plane = (size_t)H * W;
  for (int i = tid; i < CC * ROWS * VPR; i += kThreads) {
    const int v = i % VPR;
    const int cc = (i / VPR) % CC;
    const int r = i / (VPR * CC);
    const int gy = y0 - 1 + r;
    const int gx = x0 + 8 * v;
    const int c = c0 + cc;
    const bool row_ok = c < C && gy >= 0 && gy < H;
    const __nv_bfloat16* s = xn + (row_ok ? (size_t)c * plane + (size_t)gy * W : 0);
    float f[8];
    if (vec) {
      if (row_ok && gx < W) {
        const uint4 q = *reinterpret_cast<const uint4*>(s + gx);
        const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 p =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[e]));
          f[2 * e] = p.x;
          f[2 * e + 1] = p.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f[e] = (row_ok && gx + e < W) ? __bfloat162float(s[gx + e]) : 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + cc * PLANE + r * STRIDE + 4 + 8 * v);
    d[0] = make_float4(f[0], f[1], f[2], f[3]);
    d[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  for (int i = tid; i < CC * ROWS * 2; i += kThreads) {
    const int side = i & 1;
    const int cc = (i >> 1) % CC;
    const int r = i / (2 * CC);
    const int gy = y0 - 1 + r;
    const int gx = side ? x0 + TW : x0 - 1;
    const int c = c0 + cc;
    const bool ok = c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
    dst[cc * PLANE + r * STRIDE + (side ? 4 + TW : 3)] =
        ok ? __bfloat162float(xn[(size_t)c * plane + (size_t)gy * W + gx]) : 0.f;
  }
}

// T: float (cp.async staging) or __nv_bfloat16 (stage_acts_bf16) for x,
// res and y; the weights are f32
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_head_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, const T* __restrict__ res,
                    T* __restrict__ y, int N, int C, int H, int W, int act,
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
    if constexpr (sizeof(T) == 4)
      stage_acts<kCC, kRows, kTW, kStride, kPlane>(
          smem + p_stage * kStageFloats, x + (size_t)n * C * plane, p_chunk * kCC,
          C, ty * kTH, tx * kTW, H, W, vec != 0, tid);
    else
      stage_acts_bf16<kCC, kRows, kTW, kStride, kPlane>(
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
  const int nchunks = (a.C + kCC - 1) / kCC;
  const int smem = (kStages * kStageFloats + nchunks * kCC * 12) * 4;
  auto kernel = conv3x3_head_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const TileWalk walk(a.N, a.H, a.W, kTH, kTW);
  const int grid = walk.total < sm_count() ? walk.total : sm_count();
  // a vector load is 16 bytes: 4 f32 or 8 bf16 pixels
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
