// conv3x3, tensor-core variant "mma_sync_3xtf32" (Hopper, sm_90a).
//
// Replaces the TPU kernel learned_pmctf_tpu/ops/pallas_conv.py:conv3x3_hcw
// for C % 8 == 0 and O % 8 == 0, O <= 128, at any width: the shapes that
// conv3x3_wgmma.cu does not take (W % 4 != 0, unaligned tensors). Same
// function as the other variants:
//   y = act(conv3x3(x, w) + b [+ residual]), NCHW, f32 in and out.
//
// What bounds it: operations on the tensor cores. The conv is an implicit
// GEMM, M = pixels, N = output channels, K = 9 C. One TF32 product keeps
// 10 mantissa bits and would break f32 parity, so each f32 operand is
// split in two TF32 numbers, big = tf32(v) and small = tf32(v - big), and
// every K step runs three products into one f32 accumulator, in the
// fixed order big*big, big*small, small*big (small*small is below f32
// rounding). That is 3 x 2 M N K operations at the TF32 rate (495 TFLOP/s
// dense on an H100 SXM at 700 W), against 2 M N K at the 67 TFLOP/s of
// the f32 cores: the tensor-core bound is 2.5x lower. mma.sync reaches
// about half of the TF32 rate on this card; wgmma is the way to the rest.
//
// Design:
// - the product is mma.sync.m16n8k8 (TF32, both operands from
//   registers). A warp owns 64 pixels of one image row x NT*8 output
//   channels: 4 x NT accumulator tiles (128 registers at NT = 8);
// - a 256-thread block owns a tile of MW rows x 64 pixels and is
//   persistent: grid = SM count, each block walks tiles blockIdx.x,
//   += gridDim.x, and its copy ring runs on across tile boundaries;
// - K is walked as (chunk of 8 input channels, tap). A ring stage holds
//   one chunk: the (MW+2) x 66 activation window with its zero halo, f32,
//   and the chunk's packed weights. Stages are filled by cp.async (16
//   bytes a copy, zero-fill for padding and ragged edges) while the
//   previous stages are multiplied; the nine taps are shifted reads of
//   the one window;
// - activations are split in registers after the fragment load
//   (round to TF32, subtract, round again): no extra shared memory.
//   The channel planes of a stage lie 24 banks apart, so the 8 pixels x 4
//   channels a fragment load touches fall on 32 different banks;
// - weights are split and packed once by the wrapper (ops/conv3x3.py:
//   pack_weights, layout "mma_sync") in the order the B fragments want:
//   [chunk][tap][n-tile][lane][big k, big k+4, small k, small k+4], one
//   16-byte load a lane per n-tile. Both parts of all weights (295 KB at
//   64x64) do not fit a block's 227 KB, so they stream through the ring
//   chunk by chunk; they stay in L2;
// - bias, residual and activation are fused into the f32 epilogue, which
//   writes 32-byte runs of pixels per channel.
// Deterministic: a fixed order of mma products, no atomics.

#include "conv3x3_common.cuh"

namespace conv3x3 {
namespace {

constexpr int kTW = 64;      // tile width in pixels: one warp's M
constexpr int kStride = 72;  // window row: 3 unused, halo, 64, halo, 3 unused
constexpr int kCC = 8;       // input channels a stage: the depth of one mma

constexpr int plane_floats(int rows) {
  int p = rows * kStride;
  while (p % 32 != 8 && p % 32 != 24) p += 8;
  return p;
}

template <int NT, int NW>
struct Cfg {
  static constexpr int MW = 8 / NW;         // warps along M = tile rows
  static constexpr int OP = NT * NW * 8;    // output channels, padded
  static constexpr int ROWS = MW + 2;
  static constexpr int PLANE = plane_floats(ROWS);
  static constexpr int A_FLOATS = kCC * PLANE;
  static constexpr int B_FLOATS = 9 * OP * 16;  // 9 taps x 8 k x OP x 2 parts
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int STAGES = 3 * STAGE_FLOATS * 4 <= kMaxSmem ? 3 : 2;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
  static_assert(SMEM_BYTES <= kMaxSmem, "ring does not fit");
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT, int NW>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_mma_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                   const float* __restrict__ b, const float* __restrict__ res,
                   float* __restrict__ y, int N, int C, int H, int W, int O,
                   int act, int vec) {
  using K = Cfg<NT, NW>;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / NW;  // tile row of this warp
  const int wn = warp % NW;  // which NT*8 output channels
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // fragment k / column pair

  const TileWalk walk(N, H, W, K::MW, kTW);
  const int nchunks = C / kCC;
  const int my_tiles =
      blockIdx.x < walk.total ? (walk.total - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int steps = my_tiles * nchunks;
  const size_t plane = (size_t)H * W;

  // the producer's position: the next (tile, chunk) to stage
  int p_tile = blockIdx.x, p_chunk = 0, p_stage = 0;
  auto stage_next = [&]() {
    int n, ty, tx;
    walk.decode(p_tile, n, ty, tx);
    float* st = smem + p_stage * K::STAGE_FLOATS;
    stage_acts<kCC, K::ROWS, kTW, kStride, K::PLANE>(
        st, x + (size_t)n * C * plane, p_chunk * kCC, C, ty * K::MW, tx * kTW,
        H, W, vec != 0, tid);
    const float* src = wp + (size_t)p_chunk * K::B_FLOATS;
    float* dst = st + K::A_FLOATS;
    for (int i = tid; i < K::B_FLOATS / 4; i += kThreads)
      cp_async16(dst + 4 * i, src + 4 * i, 16);
    if (++p_chunk == nchunks) {
      p_chunk = 0;
      p_tile += gridDim.x;
    }
    if (++p_stage == K::STAGES) p_stage = 0;
  };

  float acc[4][NT][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  for (int s = 0; s < K::STAGES - 1; ++s) {
    if (s < steps) stage_next();
    cp_async_commit();
  }

  int c_tile = blockIdx.x, c_chunk = 0, c_stage = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<K::STAGES - 2>();
    __syncthreads();  // stage s has landed; stage s-1 is free for the producer
    if (s + K::STAGES - 1 < steps) stage_next();
    cp_async_commit();

    const float* st = smem + c_stage * K::STAGE_FLOATS;
    const float* A = st + t * K::PLANE + wm * kStride + g + 3;
    const float4* B = reinterpret_cast<const float4*>(st + K::A_FLOATS) + wn * NT * 32 + lane;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * kStride + tap % 3;
      uint32_t big[4][4], sml[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float* p = A + off + m * 16;
        const float v[4] = {p[0], p[8], p[4 * K::PLANE], p[4 * K::PLANE + 8]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          big[m][e] = to_tf32(v[e]);
          sml[m][e] = to_tf32(v[e] - __uint_as_float(big[m][e]));
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 bv = B[(tap * (K::OP / 8) + j) * 32];
        const uint32_t bb0 = __float_as_uint(bv.x), bb1 = __float_as_uint(bv.y);
        const uint32_t bs0 = __float_as_uint(bv.z), bs1 = __float_as_uint(bv.w);
#pragma unroll
        for (int m = 0; m < 4; ++m) mma_tf32(acc[m][j], big[m], bb0, bb1);
#pragma unroll
        for (int m = 0; m < 4; ++m) mma_tf32(acc[m][j], big[m], bs0, bs1);
#pragma unroll
        for (int m = 0; m < 4; ++m) mma_tf32(acc[m][j], sml[m], bb0, bb1);
      }
    }
    if (++c_stage == K::STAGES) c_stage = 0;

    if (++c_chunk == nchunks) {  // the tile is done: epilogue from registers
      int n, ty, tx;
      walk.decode(c_tile, n, ty, tx);
      const int gy = ty * K::MW + wm;
      if (gy < H) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int oc = (wn * NT + j) * 8 + 2 * t + e;
            if (oc < O) {
              const float bias = b[oc];
              const size_t row = ((size_t)n * O + oc) * plane + (size_t)gy * W;
#pragma unroll
              for (int m = 0; m < 4; ++m) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int gx = tx * kTW + m * 16 + g + 8 * h;
                  if (gx < W) {
                    float v = acc[m][j][2 * h + e] + bias;
                    if (res != nullptr) v += res[row + gx];
                    y[row + gx] = activate(v, act);
                  }
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
      c_chunk = 0;
      c_tile += gridDim.x;
    }
  }
  cp_async_wait<0>();
}

template <int NT, int NW>
cudaError_t launch_cfg(const Args& a) {
  using K = Cfg<NT, NW>;
  auto kernel = conv3x3_mma_kernel<NT, NW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const TileWalk walk(a.N, a.H, a.W, K::MW, kTW);
  const int grid = walk.total < sm_count() ? walk.total : sm_count();
  const int vec = a.W % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  kernel<<<grid, kThreads, K::SMEM_BYTES, a.stream>>>(
      a.x, a.w, a.b, a.res, a.y, a.N, a.C, a.H, a.W, a.O, a.act, vec);
  return cudaGetLastError();
}

}  // namespace

int tc_padded_o(int O) {
  if (O <= 0 || O % 8 != 0) return 0;
  if (O <= 64) return 64;
  if (O <= 112) return 112;
  if (O <= 128) return 128;
  return 0;
}

cudaError_t launch_mma_sync(const Args& a) {
  if (a.C % kCC != 0) return cudaErrorInvalidValue;
  switch (tc_padded_o(a.O)) {
    case 64: return launch_cfg<8, 1>(a);
    case 112: return launch_cfg<7, 2>(a);
    case 128: return launch_cfg<8, 2>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace conv3x3
