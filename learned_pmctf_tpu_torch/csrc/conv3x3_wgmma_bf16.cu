// conv3x3, tensor-core variant "wgmma_bf16" (Hopper, sm_90a).
//
// Replaces the TPU kernel learned_pmctf_tpu/ops/pallas_conv.py:conv3x3_hcw
// in its bf16 instance (act_bf16's operands: bf16 x, weights and residual,
// f32 bias, f32 accumulation and epilogue, one round-to-nearest-even to a
// bf16 y) for C % 16 == 0, O <= 64 (O % 8 == 0), W % 8 == 0 and tensors on
// 16 bytes: the 64->64 convs of PostProcess.
//
// What bounds it: bytes. A luma 64->64 conv (1x64x1152x1920) reads and
// writes 0.57 GB, 0.169 ms at 3.35 TB/s, 0.254 ms with a residual (H100
// SXM, 700 W); its 163 GFLOP take 0.165 ms at the dense bf16 rate of 989
// TFLOP/s. Bytes and products are at par, so both have to stream: no
// operand may make a detour through registers or be fetched twice from
// device memory, and the tensor cores may not wait for the epilogue.
//
// Design, part by part:
// - implicit GEMM in the transposed form: M = the 64 output channels, N =
//   pixels, K = 9 C walked as (chunk of 16 channels, tap), one
//   wgmma.m64n128k16 a (chunk, tap) and consumer warpgroup. A, the
//   weights, is K-major; B, the activations, is pixel-major as NCHW
//   stores it, which wgmma reads from shared memory with its transpose
//   bit. Neither operand passes through registers; nine products into one
//   accumulator run between two waits. (The other form, M = pixels, reads
//   the 64-pixel A tile once for 64 outputs; this one reads 2 KB of
//   weights for 128 pixels, and its accumulator holds one output
//   channel's pixels in pairs, which is the store's order.)
// - weights resident: all 9 x 64 x 64 bf16 weights (73.7 KB, packed by
//   ops/conv3x3.py:pack_weights_bf16 as [chunk][tap][k half][8 outputs]
//   [output][8 k], the core matrices of an unswizzled K-major descriptor)
//   arrive once by one bulk copy and stay for the block's life. Above 64
//   input channels the block loads 64 channels' weights at a time, once a
//   tile and group: that shape is off the main path.
// - a tap shifts the window by one pixel, 2 bytes, and a descriptor
//   starts on 16 bytes. So a stage holds three windows of (64 pixels, 16
//   channels, 6 rows), one per kx, starting at x-1, x, x+1, each laid out
//   as TMA's 128-byte swizzle lays out a box of a tensor map in (W, C, H,
//   N) order: [row][channel][64 pixels], one 128-byte line a (row,
//   channel), 8 channels a swizzle atom. The B tile of tap (ky, kx) for a
//   warpgroup's two rows is then a descriptor offset of whole rows into
//   window kx: the next 64 pixels (LBO) are the next row, the next 8
//   channels (SBO) the next atom. TMA never completes a box whose
//   innermost start is off a 16-byte multiple (tried on the card: the
//   wait traps), so it brings the window at x and, unswizzled, the 8
//   pixels on either side of it; three producer warps then write the two
//   shifted windows, one line a thread, 16 bytes from two neighbours by a
//   funnel shift. Out-of-bounds elements arrive as zeros: the 'same'
//   padding and the ragged edges for free.
// - a block is one producer warpgroup (one thread issues every copy,
//   three warps shift; it hands registers to the consumers) and two
//   consumer warpgroups, persistent over tiles of 4 rows x 64 pixels
//   (grid = SM count); each consumer warpgroup owns two rows: 64 outputs
//   x 128 pixels, 64 accumulator registers a thread, twice: a three-stage
//   ring of windows runs on across tile boundaries, and a tile's products
//   go to one accumulator set while the epilogue reads the other.
// - the epilogue runs beside the next tile's products: a tile's epilogue
//   runs in four parts (a row and 32 pixels each), one after each of the
//   first, second ... chunks of the next tile's products has been issued,
//   so each part overlaps products in flight. It adds bias and residual,
//   applies the activation, rounds once and stores each output channel's
//   pixel pairs straight from the accumulators (4 bytes a lane, 16
//   contiguous bytes a quad). The residual arrives ahead of it: the
//   producer brings each (warpgroup, row) of it, a (64 pixels, 64
//   outputs) box, into a buffer of its own by TMA once the previous tile's
//   part has read it. (Writing the tile to shared memory for a TMA store,
//   after the tile's products had drained, measured no faster on the card.)
// Deterministic: a fixed order of wgmma products, no atomics.
//
// Shared memory: 3 stages x 39 KB (three windows and two halos) + 72 KB of
// weights + 32 KB of residual rows + barriers and alignment = SMEM_BYTES
// below (227 KB at most).

#include "conv3x3_hopper.cuh"

namespace conv3x3 {
namespace {

constexpr int kTW = 64;   // pixels of a tile row: one 128-byte line
constexpr int kTH = 4;    // rows of a tile: two a consumer warpgroup
constexpr int kCC = 16;   // channels of a chunk: one k16 product a tap
constexpr int kRows = kTH + 2;
constexpr int kLine = kTW * 2;
constexpr int kLines = kRows * kCC;              // (row, channel) lines of a window
constexpr int kCopyBytes = kLines * kLine;       // one kx window: 12 KB
constexpr int kHaloBytes = kLines * 16;          // 8 pixels a line, unswizzled
constexpr int kStageBytes = 3 * kCopyBytes + 2 * kHaloBytes;
constexpr int kStages = 3;
constexpr int kGroupC = 64;                      // channels of resident weights
constexpr int kChunksPerGroup = kGroupC / kCC;
constexpr int kTapBytes = 64 * kCC * 2;          // one (chunk, tap) A tile
constexpr int kWBytes = kChunksPerGroup * 9 * kTapBytes;
constexpr int kResRow = 64 * kLine;              // a residual row: 64 outputs x 64 pixels
constexpr int kConsumers = 256;
constexpr int kShifters = kLines;                // producer threads 32 .. 127
constexpr int kBlock = kConsumers + 128;
// setmaxnreg moves registers within the block's launch allocation: 168 a
// thread at 384 threads (65536 / 384, down to a multiple of 8)
constexpr int kProducerRegs = 64, kConsumerRegs = 216;
constexpr int kWOff = kStages * kStageBytes;     // the ring first
constexpr int kResOff = kWOff + kWBytes;
constexpr int kBarOff = kResOff + 4 * kResRow;
constexpr int kBars = 3 * kStages + 10;
constexpr int SMEM_BYTES = kBarOff + 8 * kBars + 1024;  // + alignment to 1024
static_assert(kShifters == 96, "three producer warps shift, one line a thread");
static_assert(kStageBytes % 1024 == 0 && kCopyBytes % 1024 == 0 && kResOff % 1024 == 0,
              "128-byte swizzle atoms lie on 1024 bytes");
static_assert(SMEM_BYTES <= kMaxSmem, "weights, ring and residual rows do not fit");
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <= kBlock * 168,
              "the consumers' registers come from the producer's");

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Wait for the phase of this parity to complete, the loop inside one asm
// statement. A C++ loop around try_wait (conv3x3_hopper.cuh: mbar_wait),
// run while products are in flight, makes ptxas serialize every wgmma
// (C7518). A copy that never lands traps instead of spinning for ever.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE_%=;\n"
      "add.u32 n, n, 1;\n"
      "setp.gt.u32 p, n, 16777216;\n"
      "@p trap;\n"
      "bra WAIT_%=;\n"
      "DONE_%=:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A: a K-major, unswizzled 64 x 16 tile; core matrices of 8 outputs x 16
// bytes, the next 8 k 1024 bytes on (LBO), the next 8 outputs 128 (SBO).
__device__ __forceinline__ uint64_t a_descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// B: a pixel-major 16 x 128 tile in 128-byte swizzle atoms of 8 channels x
// 64 pixels; the next 64 pixels (the next row) kCC lines on (LBO), the next
// 8 channels one atom on (SBO).
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((kCC * kLine) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define D8(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 outputs x 128 pixels) = A (64 x 16, K-major) * B (16 x 128,
// pixel-major: imm-trans-b 1) [+ d, unless `accumulate` is 0]
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef D8

struct Shared {
  uint8_t* smem;
  uint64_t* raw;     // [kStages]: a stage's copies have landed
  uint64_t* full;    // [kStages]: ... and its shifted windows are written
  uint64_t* empty;   // [kStages]: both consumer warpgroups are done with it
  uint64_t* wfull;   // the resident weights have landed
  uint64_t* wempty;  // ... and are read (above 64 channels)
  uint64_t* rfull;   // [2 warpgroup + row]: a residual row has landed
  uint64_t* rfree;   // [2 warpgroup + row]: ... and the epilogue has read it
};

struct Problem {
  TileWalk walk;
  __nv_bfloat16* y;
  int H, W, O, has_res, nchunks;
  bool regroup;  // weights reloaded a tile and group
};

// What a consumer warpgroup carries from tile to tile.
struct Consumer {
  int wg, q, g, t;
  float bias[2];
  uint64_t a_desc0, b_desc0;
  int stage, held, wloads;
  uint32_t phase;
  int prev_tile, prev_k;  // the tile whose epilogue is pending, its ordinal
};

// A 4-byte store under a predicate: a branch around it, in code that runs
// while wgmma products are in flight, would make ptxas serialize them.
__device__ __forceinline__ void store_if(bool ok, void* p, uint32_t v) {
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %2, 0;\n"
      "@q st.global.b32 [%0], %1;\n"
      "}\n" ::"l"(p),
      "r"(v), "r"((int)ok)
      : "memory");
}

// Part PART of the epilogue of tile `tile` (the k-th of the block) from the
// accumulators `a`: row PART / 2 of the warpgroup's two, pixels 32 (PART %
// 2) .. +31. a[4 j + 2 h + e] is output 16 q + g + 8 h at pixel 8 j + 2 t +
// e of the warpgroup's 128 (row j / 8).
template <int ACT, int PART>
__device__ __forceinline__ void epilogue_part(const float (&a)[64], int tile, int k,
                                              const Consumer& c, const Shared& s,
                                              const Problem& pb) {
  constexpr int kRow = PART >> 1, kJ0 = 4 * PART;  // j of the part: kJ0 .. kJ0 + 3
  int n, ty, tx;
  pb.walk.decode(tile, n, ty, tx);
  const int buf = 2 * c.wg + kRow;
  uint32_t r[4][2];
  if (pb.has_res) {
    wait_phase(&s.rfull[buf], k & 1);
    const uint8_t* rrow = s.smem + kResOff + buf * kResRow;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 16 * c.q + c.g + 8 * h;  // o % 8 == g: the line's swizzle
        r[i][h] = *reinterpret_cast<const uint32_t*>(
            rrow + o * kLine + ((((kJ0 + i) & 7) ^ c.g) << 4) + 4 * c.t);
      }
    if (PART & 1) mbar_arrive(&s.rfree[buf]);  // the row is read
  }
  wgmma_wait<1>();  // after the wait loop, before the reads: else ptxas serializes
  const int gy = ty * kTH + 2 * c.wg + kRow;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = 16 * c.q + c.g + 8 * h;
    __nv_bfloat16* yrow = pb.y + (((size_t)n * pb.O + o) * pb.H + gy) * pb.W + tx * kTW;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = kJ0 + i;
      const int x = 8 * (j & 7) + 2 * c.t;
      float v0 = a[4 * j + 2 * h] + c.bias[h];
      float v1 = a[4 * j + 2 * h + 1] + c.bias[h];
      if (pb.has_res) {
        v0 += __uint_as_float(r[i][h] << 16);
        v1 += __uint_as_float(r[i][h] & 0xffff0000u);
      }
      const __nv_bfloat162 out =
          __floats2bfloat162_rn(activate(v0, ACT), activate(v1, ACT));
      store_if(o < pb.O && gy < pb.H && tx * kTW + x < pb.W, yrow + x,
               *reinterpret_cast<const uint32_t*>(&out));
    }
  }
}

// The parts of the pending epilogue that follow the products of chunk
// `chunk`: part p after chunk p * nchunks / 4, so that the four spread
// over the tile.
template <int ACT>
__device__ __forceinline__ void epilogue_after(const float (&a)[64], int chunk,
                                               const Consumer& c, const Shared& s,
                                               const Problem& pb) {
  if (0 == chunk) epilogue_part<ACT, 0>(a, c.prev_tile, c.prev_k, c, s, pb);
  if (pb.nchunks / 4 == chunk) epilogue_part<ACT, 1>(a, c.prev_tile, c.prev_k, c, s, pb);
  if (2 * pb.nchunks / 4 == chunk) epilogue_part<ACT, 2>(a, c.prev_tile, c.prev_k, c, s, pb);
  if (3 * pb.nchunks / 4 == chunk) epilogue_part<ACT, 3>(a, c.prev_tile, c.prev_k, c, s, pb);
}

// One tile's products into acc[CUR], with the pending epilogue of the
// previous tile (acc[1 - CUR]) spread between them; the last tile of the
// block drains and writes its own epilogue.
template <int ACT, int CUR>
__device__ __forceinline__ void consume_tile(float (&acc)[2][64], int tile, int k, bool last,
                                             Consumer& c, const Shared& s, const Problem& pb) {
  for (int chunk = 0; chunk < pb.nchunks; ++chunk) {
    if (chunk % kChunksPerGroup == 0 && (pb.regroup || (k == 0 && chunk == 0))) {
      wait_phase(s.wfull, c.wloads & 1);
      ++c.wloads;
    }
    wait_phase(&s.full[c.stage], c.phase);
    const uint64_t a_chunk =
        c.a_desc0 + (uint64_t)(((chunk % kChunksPerGroup) * 9 * kTapBytes) >> 4);
    const uint64_t b_stage = c.b_desc0 + (uint64_t)((c.stage * kStageBytes) >> 4);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      wgmma_m64n128k16(acc[CUR], a_chunk + (uint64_t)((tap * kTapBytes) >> 4),
                       b_stage + (uint64_t)((kx * kCopyBytes + ky * kCC * kLine) >> 4),
                       chunk != 0 || tap != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the products before these (this tile's or the last's) are done
    if (c.held >= 0) mbar_arrive(&s.empty[c.held]);
    c.held = c.stage;
    if (++c.stage == kStages) {
      c.stage = 0;
      c.phase ^= 1;
    }
    if (pb.regroup &&
        (chunk % kChunksPerGroup == kChunksPerGroup - 1 || chunk + 1 == pb.nchunks)) {
      wgmma_wait<0>();  // the group's weights are read
      mbar_arrive(&s.empty[c.held]);
      c.held = -1;
      mbar_arrive(s.wempty);
    }
    if (k > 0) epilogue_after<ACT>(acc[1 - CUR], chunk, c, s, pb);
  }
  c.prev_tile = tile;
  c.prev_k = k;
  if (last) {
    wgmma_wait<0>();
    if (c.held >= 0) mbar_arrive(&s.empty[c.held]);
    c.held = -1;
    epilogue_part<ACT, 0>(acc[CUR], tile, k, c, s, pb);
    epilogue_part<ACT, 1>(acc[CUR], tile, k, c, s, pb);
    epilogue_part<ACT, 2>(acc[CUR], tile, k, c, s, pb);
    epilogue_part<ACT, 3>(acc[CUR], tile, k, c, s, pb);
  }
}

// ACT: the activation (Act), fixed at compile time: a branch on it, or in
// tanhf, inside the epilogue would serialize the products in flight
template <int ACT>
__global__ void __launch_bounds__(kBlock, 1)
conv3x3_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap hmap,
                          const __grid_constant__ CUtensorMap rmap,
                          const uint8_t* __restrict__ wp, const float* __restrict__ b,
                          __nv_bfloat16* __restrict__ y, int has_res, int N, int C, int H,
                          int W, int O) {
  extern __shared__ uint8_t smem_raw[];
  Shared s;
  s.smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  s.raw = reinterpret_cast<uint64_t*>(s.smem + kBarOff);
  s.full = s.raw + kStages;
  s.empty = s.full + kStages;
  s.wfull = s.empty + kStages;
  s.wempty = s.wfull + 1;
  s.rfull = s.wempty + 1;
  s.rfree = s.rfull + 4;
  uint8_t* const smem = s.smem;
  uint8_t* const wsm = smem + kWOff;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.raw[i], 1);
      mbar_init(&s.full[i], kShifters);
      mbar_init(&s.empty[i], kConsumers);
    }
    mbar_init(s.wfull, 1);
    mbar_init(s.wempty, kConsumers);
    for (int i = 0; i < 4; ++i) {
      mbar_init(&s.rfull[i], 1);
      mbar_init(&s.rfree[i], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const Problem pb{TileWalk(N, H, W, kTH, kTW), y, H, W, O, has_res, C / kCC,
                   C > kGroupC};
  const int my_tiles = blockIdx.x < pb.walk.total
                           ? (pb.walk.total - blockIdx.x + gridDim.x - 1) / gridDim.x
                           : 0;
  const int steps = my_tiles * pb.nchunks;

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int ptid = tid - kConsumers;
    if (ptid >= 32) {
      // ---- three warps write windows kx = 0 and 2 from window 1 and the
      // halos: thread `line` shifts one (row, channel) line by a pixel ----
      const int line = ptid - 32;
      const int swz = line & 7;
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < steps; ++i) {
        uint8_t* st = smem + stage * kStageBytes;
        wait_phase(&s.raw[stage], phase);
        uint4 v[10];  // pixels -8 .. 71 of the line, 8 a vector
        v[0] = *reinterpret_cast<const uint4*>(st + 3 * kCopyBytes + line * 16);
        v[9] = *reinterpret_cast<const uint4*>(st + 3 * kCopyBytes + kHaloBytes + line * 16);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j + 1] = *reinterpret_cast<const uint4*>(st + kCopyBytes + line * kLine +
                                                     ((j ^ swz) << 4));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint4 a = v[j], c = v[j + 1], d = v[j + 2];
          // window 0 starts a pixel left: (previous high half, this low half)
          const uint4 left = make_uint4(
              __funnelshift_l(a.w, c.x, 16), __funnelshift_l(c.x, c.y, 16),
              __funnelshift_l(c.y, c.z, 16), __funnelshift_l(c.z, c.w, 16));
          // window 2 starts a pixel right
          const uint4 right = make_uint4(
              __funnelshift_r(c.x, c.y, 16), __funnelshift_r(c.y, c.z, 16),
              __funnelshift_r(c.z, c.w, 16), __funnelshift_r(c.w, d.x, 16));
          const int off = line * kLine + ((j ^ swz) << 4);
          *reinterpret_cast<uint4*>(st + off) = left;
          *reinterpret_cast<uint4*>(st + 2 * kCopyBytes + off) = right;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma
        mbar_arrive(&s.full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      return;
    }
    // ---- one thread issues the weight, window and residual copies ----
    if (ptid != 0) return;
    // residual row `row` of tile `tile` (the k-th) into both warpgroups'
    // buffers, once the epilogue of tile k - 1 has read them
    auto load_res = [&](int tile, int k, int row) {
      int n, ty, tx;
      pb.walk.decode(tile, n, ty, tx);
      for (int w = 0; w < 2; ++w) {
        const int buf = 2 * w + row;
        wait_phase(&s.rfree[buf], (k & 1) ^ 1);  // passes at once on a fresh barrier
        mbar_expect_tx(&s.rfull[buf], kResRow);
        tma_load_4d(smem + kResOff + buf * kResRow, &rmap, &s.rfull[buf], tx * kTW, 0,
                    ty * kTH + 2 * w + row, n);
      }
    };
    int tile = blockIdx.x, k = 0, chunk = 0, stage = 0, wloads = 0;
    uint32_t phase = 0;
    for (int i = 0; i < steps; ++i) {
      if (chunk % kChunksPerGroup == 0 && (pb.regroup || i == 0)) {
        if (wloads > 0) wait_phase(s.wempty, (wloads - 1) & 1);
        const int c0 = chunk * kCC;
        const int group_c = C - c0 < kGroupC ? C - c0 : kGroupC;
        const uint32_t bytes = (uint32_t)group_c * 9 * 64 * 2;
        mbar_expect_tx(s.wfull, bytes);
        bulk_load(wsm, wp + (size_t)c0 * 9 * 64 * 2, bytes, s.wfull);
        ++wloads;
      }
      int n, ty, tx;
      pb.walk.decode(tile, n, ty, tx);
      uint8_t* st = smem + stage * kStageBytes;
      const int x0 = tx * kTW, c0 = chunk * kCC, y0 = ty * kTH - 1;
      wait_phase(&s.empty[stage], phase ^ 1);  // passes at once on a fresh barrier
      mbar_expect_tx(&s.raw[stage], kCopyBytes + 2 * kHaloBytes);
      tma_load_4d(st + kCopyBytes, &xmap, &s.raw[stage], x0, c0, y0, n);
      tma_load_4d(st + 3 * kCopyBytes, &hmap, &s.raw[stage], x0 - 8, c0, y0, n);
      tma_load_4d(st + 3 * kCopyBytes + kHaloBytes, &hmap, &s.raw[stage], x0 + kTW, c0, y0, n);
      // a tile's epilogue runs during the next tile: its residual row 0 is
      // asked for once its windows are, row 1 a stage into the next tile
      if (has_res) {
        if (chunk + 1 == pb.nchunks) load_res(tile, k, 0);
        if (k > 0 && chunk == (pb.nchunks > 1 ? 1 : 0)) load_res(tile - gridDim.x, k - 1, 1);
      }
      if (++chunk == pb.nchunks) {
        chunk = 0;
        tile += gridDim.x;
        ++k;
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (has_res && my_tiles > 0) load_res(tile - gridDim.x, my_tiles - 1, 1);
    return;
  }

  // ---- consumers: warpgroup wg computes rows 2 wg, 2 wg + 1 of each tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  Consumer c;
  c.wg = tid >> 7;
  c.q = (tid & 127) >> 5;  // warp of the warpgroup: outputs 16 q .. 16 q + 15
  c.g = (tid & 31) >> 2;
  c.t = tid & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = 16 * c.q + c.g + 8 * h;
    c.bias[h] = o < O ? b[o] : 0.f;
  }
  c.a_desc0 = a_descriptor(smem_u32(wsm));
  c.b_desc0 = b_descriptor(smem_u32(smem) + 2 * c.wg * kCC * kLine);
  c.stage = 0;
  c.held = -1;
  c.wloads = 0;
  c.phase = 0;
  c.prev_tile = 0;
  c.prev_k = 0;

  float acc[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
  for (int k = 0; k < my_tiles; k += 2) {
    const int tile = blockIdx.x + k * gridDim.x;
    consume_tile<ACT, 0>(acc, tile, k, k + 1 == my_tiles, c, s, pb);
    if (k + 1 < my_tiles)
      consume_tile<ACT, 1>(acc, tile + gridDim.x, k + 1, k + 2 == my_tiles, c, s, pb);
  }
}

// A tensor map over an NCHW bf16 tensor in (W, C, H, N) order, innermost
// first: boxes of 64 pixels with the 128-byte swizzle, or of 8 unswizzled.
bool encode_nchw(EncodeTiled encode, CUtensorMap* map, const void* p, int N, int C, int H,
                 int W, cuuint32_t box_w, cuuint32_t box_c, cuuint32_t box_h) {
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)C, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)H * W * 2, (cuuint64_t)W * 2,
                                 (cuuint64_t)C * H * W * 2};
  const cuuint32_t box[4] = {box_w, box_c, box_h, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_w == kTW ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// W % 8: TMA wants the rows' stride, W bf16, on a 16-byte multiple
bool wgmma_bf16_takes(int C, int O, int W, bool aligned) {
  return C % kCC == 0 && tc_padded_o(O) == 64 && W % 8 == 0 && aligned;
}

cudaError_t launch_wgmma_bf16(const Args& a) {
  if (!wgmma_bf16_takes(a.C, a.O, a.W, aligned16(a))) return cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap, hmap, rmap;
  if (!encode_nchw(encode, &xmap, a.x, a.N, a.C, a.H, a.W, kTW, kCC, kRows) ||
      !encode_nchw(encode, &hmap, a.x, a.N, a.C, a.H, a.W, 8, kCC, kRows) ||
      !encode_nchw(encode, &rmap, a.res != nullptr ? a.res : a.y, a.N, a.O, a.H, a.W, kTW,
                   64, 1))
    return cudaErrorInvalidValue;
  auto kernel = a.act == kLeaky  ? conv3x3_wgmma_bf16_kernel<kLeaky>
                : a.act == kTanh ? conv3x3_wgmma_bf16_kernel<kTanh>
                                 : conv3x3_wgmma_bf16_kernel<kNone>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const TileWalk walk(a.N, a.H, a.W, kTH, kTW);
  const int grid = walk.total < sm_count() ? walk.total : sm_count();
  kernel<<<grid, kBlock, SMEM_BYTES, a.stream>>>(
      xmap, hmap, rmap, static_cast<const uint8_t*>(a.w), a.b,
      static_cast<__nv_bfloat16*>(a.y), a.res != nullptr, a.N, a.C, a.H, a.W, a.O);
  return cudaGetLastError();
}

}  // namespace conv3x3
