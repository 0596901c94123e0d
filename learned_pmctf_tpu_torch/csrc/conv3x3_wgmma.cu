// conv3x3, tensor-core variant "wgmma_3xtf32" (Hopper, sm_90a).
//
// Replaces the TPU kernel learned_pmctf_tpu/ops/pallas_conv.py:conv3x3_hcw
// for C % 8 == 0, O % 8 == 0, O <= 128 and W % 4 == 0: the 64->64 convs of
// PostProcess, and the 112->112 and 128->128 convs of the four-step
// priors' residual blocks (models/layers.py:ContextResidual, f32 without a
// gradient: LeakyReLU fused into the first conv, bias and skip into the
// second). Same function as the other variants:
//   y = act(conv3x3(x, w) + b [+ residual]), NCHW, f32 in and out.
//
// What bounds it: operations on the tensor cores, three TF32 products a K
// step (see conv3x3_mma.cu for the split and why it keeps f32 parity):
// 3 x 2 M N K operations at 495 TFLOP/s (H100 SXM, 700 W). Only wgmma
// reaches that rate; mma.sync stops at about half.
//
// Design:
// - implicit GEMM, M = pixels, N = the output channels (padded to 64, 112
//   or 128), K = 9 C walked as (chunk of 8 channels, tap): wgmma.m64nNk8
//   TF32 with A, the pixels, from registers and B, the weights, from
//   shared memory. wgmma reads TF32 operands from shared memory K-major
//   only; NCHW activations are pixel-major, so they go through registers,
//   where the split costs no shared memory. The weights are packed
//   K-major by the wrapper (ops/conv3x3.py: pack_weights, layout
//   "wgmma": [chunk][tap][part][k half][8 outputs][output][4 k], the
//   core-matrix order of an unswizzled shared-memory descriptor): once
//   and cached for PostProcess and the trainers, for each call by one
//   launch of conv3x3_pack.cu for the priors, whose 282 weights a pWave
//   call would pin 0.48 GiB of packs in two coders;
// - a block is two consumer warpgroups and one producer warpgroup (which
//   gives its registers to the consumers: setmaxnreg 40 / 232), persistent
//   over tiles of 8 rows x 64 pixels (grid = SM count). A warpgroup owns 4
//   rows: four 64-pixel M tiles, 128 accumulator registers a thread. Above
//   64 outputs (the priors' 112 and 128) the tile is 2 rows, one M tile a
//   warpgroup, and the sums are split by chunk (see Accuracy): 56 or 64
//   accumulators and as many f32 totals a thread;
// - the producer thread fills a ring (three stages at 64 outputs, two
//   above) with TMA: one 3-D box a stage for the activation window of 8
//   channels (out-of-bounds elements arrive as zeros: the 'same' padding
//   and the ragged edge for free) and one bulk copy for the chunk's packed
//   weights (36 KB at 64 outputs), both reported to the stage's mbarrier.
//   The ring runs on across tile boundaries. Both parts of all weights
//   (295 KB at 64x64) do not fit a block's 227 KB, so they stream with the
//   activations and stay in L2;
// - the window starts 4 pixels left of the tile, because TMA wants the
//   innermost start on a 16-byte multiple; its rows are 76 floats, which
//   puts its channel planes 24 (10 rows) or 8 (6 rows) banks apart, so a
//   fragment load (8 pixels x 4 channels) is conflict-free. The nine taps
//   are shifted reads of the one window. The fragment of the next (tap,
//   M tile) is loaded and split while the wgmmas of the current one run;
// - bias, residual and activation are fused into the f32 epilogue, which
//   transposes each M tile through shared memory: the fragment layout
//   would write 32-byte runs, the buffer gives whole rows of a channel.
// Deterministic: a fixed order of wgmma products, no atomics.
//
// Accuracy: the split is exact to 2^-22 of each operand, but the tensor
// cores add into the f32 accumulator with truncation. Over the 3 x 9 C / 8
// accumulations of a conv the error against float64 comes to 3.0e-5 at
// C = 64 and 5.5e-5 at C = 128 for unit-scale outputs (NVIDIA H100 80GB
// HBM3; an f32 conv errs by 7e-6 to 9e-6 there, one TF32 product by over
// 1e-3). At 64 outputs mma.sync gives the same bits. Above 64 outputs the
// outputs feed the priors' quantizers, where an error flips roundings
// against an f32 conv's: there each chunk of 8 channels (27 products a
// tile) starts a fresh accumulator (wgmma's scale-d 0), which is added to
// an f32 total in registers once the chunk's products are done, so the
// truncation acts on a chunk's partial sum and not on the running total.

#include "conv3x3_hopper.cuh"

namespace conv3x3 {
namespace {

constexpr int kTW = 64;
constexpr int kCC = 8;
// The window a stage holds starts 4 pixels left of the tile: TMA wants the
// innermost start coordinate on a 16-byte multiple. 4 + 64 + 4 columns
// would put the channel planes of the 10-row window 16 banks apart; 76
// puts them 24 apart (8 apart for the 6-row window).
constexpr int kBoxW = 76;
constexpr int kCol0 = 3;  // column of pixel -1 of the tile: the left halo
constexpr int kConsumers = 256;
constexpr int kBlock = kConsumers + 128;  // two consumer warpgroups, one producer
constexpr int kEPitch = 68;  // epilogue buffer: [64 outputs][64 pixels], padded
constexpr int kEBytes = 64 * kEPitch * 4;  // one a consumer warpgroup
constexpr int kBarBytes = 64;              // the ring's mbarriers

// NOUT: output channels as the weights are packed (64, 112 or 128)
template <int NOUT>
struct Cfg {
  static constexpr int MT = NOUT <= 64 ? 4 : 1;  // M tiles (rows) a warpgroup
  static constexpr int NACC = NOUT / 2;          // accumulator registers an M tile
  static constexpr bool BY_CHUNK = NOUT > 64;    // f32 totals of the chunks' sums
  static constexpr int TH = 2 * MT;
  // the window's rows: 4 would put the channel planes 16 banks apart, so
  // a 2-row tile loads 6 (the last two unread)
  static constexpr int ROWS = TH + 2 < 6 ? 6 : TH + 2;
  static constexpr int PLANE = kBoxW * ROWS;
  static constexpr int A_BYTES = kCC * PLANE * 4;
  static constexpr int B_BYTES = 9 * NOUT * 16 * 4;
  static constexpr int TAP_BYTES = B_BYTES / 9;  // big tile, then small tile
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = NOUT <= 64 ? 3 : 2;
  static constexpr int GROUPS = 9 * MT;  // (tap, M tile) a chunk
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + kBarBytes + 2 * kEBytes + 128;
  // Shared-memory descriptor of a K-major, unswizzled NOUT x 8 TF32 tile:
  // core matrices of 8 outputs x 16 bytes; the next 4 k lie LBO bytes on,
  // the next 8 outputs SBO bytes on.
  static constexpr uint32_t LBO = (NOUT / 8) * 128;
  static constexpr uint32_t SBO = 128;
  static_assert(PLANE % 32 == 8 || PLANE % 32 == 24, "fragment loads hit 32 banks");
  static_assert(A_BYTES % 128 == 0 && STAGE_BYTES % 128 == 0, "TMA alignment");
  static_assert(SMEM_BYTES <= kMaxSmem, "ring does not fit");
};


template <int NOUT>
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(Cfg<NOUT>::LBO >> 4) << 16) |
         ((uint64_t)(Cfg<NOUT>::SBO >> 4) << 32);
}

#define D8(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 pixels x NOUT outputs, NOUT / 2 registers a thread) = d * (acc != 0)
// + a (64 x 8, from registers) * B (8 x NOUT, from shared memory)
template <int NOUT>
__device__ __forceinline__ void wgmma_k8(float (&d)[NOUT / 2], const uint32_t (&a)[4],
                                         uint64_t desc, int acc);

template <>
__device__ __forceinline__ void wgmma_k8<64>(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_k8<112>(float (&d)[56], const uint32_t (&a)[4],
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_k8<128>(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

#undef D8

// The 64 pixels x 8 channels fragment of one M tile at one tap, split in
// its big and small parts.
template <int PLANE>
struct Frag {
  uint32_t big[4], sml[4];
  __device__ __forceinline__ void load(const float* q) {
    const float v[4] = {q[0], q[8], q[4 * PLANE], q[4 * PLANE + 8]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      big[e] = to_tf32(v[e]);
      sml[e] = to_tf32(v[e] - __uint_as_float(big[e]));
    }
  }
};

template <int NOUT>
__global__ void __launch_bounds__(kBlock, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const float* __restrict__ wp, const float* __restrict__ b,
                     const float* __restrict__ res, float* __restrict__ y, int N,
                     int C, int H, int W, int O, int act) {
  using K = Cfg<NOUT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K::STAGES * K::STAGE_BYTES);
  uint64_t* empty = full + K::STAGES;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < K::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const TileWalk walk(N, H, W, K::TH, kTW);
  const int nchunks = C / kCC;
  const int my_tiles =
      blockIdx.x < walk.total ? (walk.total - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int steps = my_tiles * nchunks;

  if (tid >= kConsumers) {
    // ---- producer warpgroup: hands its registers to the consumers, then
    // one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != kConsumers) return;
    int tile = blockIdx.x, chunk = 0, stage = 0;
    uint32_t phase = 0;
    for (int s = 0; s < steps; ++s) {
      mbar_wait(&empty[stage], phase ^ 1);  // passes at once on a fresh barrier
      int n, ty, tx;
      walk.decode(tile, n, ty, tx);
      uint8_t* st = smem + stage * K::STAGE_BYTES;
      mbar_expect_tx(&full[stage], K::STAGE_BYTES);
      tma_load_window(st, &xmap, &full[stage], tx * kTW - 4, ty * K::TH - 1,
                      n * C + chunk * kCC);
      bulk_load(st + K::A_BYTES, wp + (size_t)chunk * (K::B_BYTES / 4), K::B_BYTES,
                &full[stage]);
      if (++chunk == nchunks) {
        chunk = 0;
        tile += gridDim.x;
      }
      if (++stage == K::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: two warpgroups, MT rows of the tile each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int w4 = (tid >> 5) & 3;  // warp in the warpgroup: 16 pixels of an M tile
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t plane = (size_t)H * W;

  float acc[K::MT][K::NACC];
  // the tile's f32 totals of the chunks' sums (BY_CHUNK), else unused
  float total[K::BY_CHUNK ? K::MT : 1][K::BY_CHUNK ? K::NACC : 1];
#pragma unroll
  for (int m = 0; m < K::MT; ++m)
#pragma unroll
    for (int i = 0; i < K::NACC; ++i) acc[m][i] = 0.f;
  if constexpr (K::BY_CHUNK) {
#pragma unroll
    for (int m = 0; m < K::MT; ++m)
#pragma unroll
      for (int i = 0; i < K::NACC; ++i) total[m][i] = 0.f;
  }

  int tile = blockIdx.x, chunk = 0, stage = 0;
  uint32_t phase = 0;
  for (int s = 0; s < steps; ++s) {
    mbar_wait(&full[stage], phase);
    const uint8_t* st = smem + stage * K::STAGE_BYTES;
    // pixel p of window row r sits at column p + 4; tap (ky, kx) reads
    // row r + ky, column p + 3 + kx
    const float* A = reinterpret_cast<const float*>(st) + t * K::PLANE +
                     (K::MT * wg) * kBoxW + 16 * w4 + g + kCol0;
    const uint64_t desc = b_descriptor<NOUT>(smem_u32(st + K::A_BYTES));
    constexpr uint64_t kTapStep = K::TAP_BYTES >> 4, kPartStep = K::TAP_BYTES >> 5;

    // GROUPS groups, (tap, M tile), on three fragment buffers: while the
    // wgmmas of groups i-1 and i are queued, the fragment of group i+1 is
    // loaded and split into the buffer group i-2 has finished with. A
    // group is three products into one M tile's accumulators, in the
    // fixed order big*big, big*small, small*big. BY_CHUNK: an M tile's
    // first product of the chunk (tap 0) starts its accumulators afresh.
    Frag<K::PLANE> f[3];
    f[0].load(A);
#pragma unroll
    for (int i = 0; i < K::GROUPS; ++i) {
      const uint64_t d = desc + (i / K::MT) * kTapStep;
      wgmma_fence();
      wgmma_k8<NOUT>(acc[i % K::MT], f[i % 3].big, d, !(K::BY_CHUNK && i < K::MT));
      wgmma_k8<NOUT>(acc[i % K::MT], f[i % 3].big, d + kPartStep, 1);
      wgmma_k8<NOUT>(acc[i % K::MT], f[i % 3].sml, d, 1);
      wgmma_commit();
      if (i + 1 < K::GROUPS) {
        wgmma_wait<2>();  // group i-2 is done with the buffer loaded next
        const int tap = (i + 1) / K::MT, m = (i + 1) % K::MT;
        f[(i + 1) % 3].load(A + (tap / 3 + m) * kBoxW + tap % 3);
      }
    }
    wgmma_wait<0>();
    mbar_arrive(&empty[stage]);
    if constexpr (K::BY_CHUNK) {
#pragma unroll
      for (int m = 0; m < K::MT; ++m)
#pragma unroll
        for (int i = 0; i < K::NACC; ++i) total[m][i] += acc[m][i];
    }
    if (++stage == K::STAGES) {
      stage = 0;
      phase ^= 1;
    }

    if (++chunk == nchunks) {
      // The tile is done. Epilogue, one M tile (image row) and 64 outputs
      // at a time: the accumulators go through a padded buffer in shared
      // memory, so that the residual is read and the output written as
      // whole 256-byte rows of a channel, 16 bytes a lane. The residual of
      // the next pass is asked for before that pass goes through the
      // buffer; stores are not waited for.
      int n, ty, tx;
      walk.decode(tile, n, ty, tx);
      float* ebuf = reinterpret_cast<float*>(smem + K::STAGES * K::STAGE_BYTES + kBarBytes) +
                    wg * (kEBytes / 4);
      const int wtid = tid & 127;
      const int gx = tx * kTW + 4 * (wtid & 15);
      constexpr int HALVES = (NOUT + 63) / 64;
      constexpr int PASSES = K::MT * HALVES;  // pass p: M tile p / HALVES, half p % HALVES
      // a lane's 8 outputs of a pass: channel 64 half + (k * 128 + wtid) / 16,
      // 4 pixels at gx
      auto channel = [&](int p, int k) { return 64 * (p % HALVES) + ((k * 128 + wtid) >> 4); };
      auto row = [&](int p) { return ty * K::TH + K::MT * wg + p / HALVES; };
      auto offset = [&](int p, int k) {
        return ((size_t)n * O + channel(p, k)) * plane + (size_t)row(p) * W + gx;
      };
      auto inside = [&](int p, int k) { return row(p) < H && channel(p, k) < O && gx < W; };
      float4 r[8];
      auto fetch = [&](int p) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (inside(p, k)) r[k] = *reinterpret_cast<const float4*>(res + offset(p, k));
      };
      if (res != nullptr) fetch(0);
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int m = p / HALVES, half = p % HALVES;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (64 * half + 8 * j < NOUT) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = 4 * (8 * half + j) + 2 * h + e;
                float v;
                if constexpr (K::BY_CHUNK)
                  v = total[m][r];
                else
                  v = acc[m][r];
                ebuf[(8 * j + 2 * t + e) * kEPitch + 16 * w4 + g + 8 * h] = v;
              }
          }
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (inside(p, k)) {
            const int oc = channel(p, k);
            float4 v = *reinterpret_cast<const float4*>(ebuf + (oc & 63) * kEPitch +
                                                        4 * (wtid & 15));
            const float bias = b[oc];
            v.x += bias, v.y += bias, v.z += bias, v.w += bias;
            if (res != nullptr) {
              const float4 q = r[k];
              v.x += q.x, v.y += q.y, v.z += q.z, v.w += q.w;
            }
            v.x = activate(v.x, act), v.y = activate(v.y, act);
            v.z = activate(v.z, act), v.w = activate(v.w, act);
            *reinterpret_cast<float4*>(y + offset(p, k)) = v;
          }
        }
        if (res != nullptr && p + 1 < PASSES) fetch(p + 1);
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
#pragma unroll
      for (int m = 0; m < K::MT; ++m)
#pragma unroll
        for (int i = 0; i < K::NACC; ++i) {
          if constexpr (K::BY_CHUNK)
            total[m][i] = 0.f;
          else
            acc[m][i] = 0.f;
        }
      chunk = 0;
      tile += gridDim.x;
    }
  }
}

template <int NOUT>
cudaError_t launch_cfg(const Args& a, const CUtensorMap& xmap) {
  using K = Cfg<NOUT>;
  auto kernel = conv3x3_wgmma_kernel<NOUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const TileWalk walk(a.N, a.H, a.W, K::TH, kTW);
  const int grid = walk.total < sm_count() ? walk.total : sm_count();
  kernel<<<grid, kBlock, K::SMEM_BYTES, a.stream>>>(
      xmap, static_cast<const float*>(a.w), a.b, static_cast<const float*>(a.res),
      static_cast<float*>(a.y), a.N, a.C, a.H, a.W, a.O, a.act);
  return cudaGetLastError();
}

// x as (W, H, N*C), innermost first; a box is the window of one chunk
template <int NOUT>
cudaError_t launch_for(const Args& a, EncodeTiled encode) {
  CUtensorMap xmap;
  const cuuint64_t dims[3] = {(cuuint64_t)a.W, (cuuint64_t)a.H, (cuuint64_t)a.N * a.C};
  const cuuint64_t strides[2] = {(cuuint64_t)a.W * 4, (cuuint64_t)a.H * a.W * 4};
  const cuuint32_t box[3] = {kBoxW, Cfg<NOUT>::ROWS, kCC};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(a.x), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return launch_cfg<NOUT>(a, xmap);
}

}  // namespace

bool wgmma_takes(int C, int O, int W, bool aligned) {
  return C % kCC == 0 && tc_padded_o(O) != 0 && W % 4 == 0 && aligned;
}

cudaError_t launch_wgmma(const Args& a) {
  if (!wgmma_takes(a.C, a.O, a.W, aligned16(a))) return cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  switch (tc_padded_o(a.O)) {
    case 64: return launch_for<64>(a, encode);
    case 112: return launch_for<112>(a, encode);
    case 128: return launch_for<128>(a, encode);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace conv3x3
