// Fused 3x3 'same' convolution for Hopper (sm_90a), NCHW: the C
// interface, the choice of variant, and the variants "direct_f32" and
// "direct_bf16".
//
// Replaces the TPU kernel learned_pmctf_tpu/ops/pallas_conv.py:conv3x3_hcw
// (Pallas, (N,H,C,W) layout). Computes the same function on NCHW:
//   y = act(conv3x3(x, w) + b [+ residual])
// with stride 1, zero 'same' padding, OIHW weights (cross-correlation),
// act in {none, LeakyReLU(0.2), tanh}, all in f32. Any N, C, H, W, O.
//
// conv3x3_pick chooses from the shape, first match:
// - O == 1: "head_o1" (conv3x3_head.cu), bound by bytes;
// - C % 8 == 0, O % 8 == 0, O <= 128: bound by operations on the tensor
//   cores; "wgmma_3xtf32" (conv3x3_wgmma.cu) where W % 4 == 0 and the
//   tensors lie on 16 bytes, else "mma_sync_3xtf32" (conv3x3_mma.cu), at
//   about half the rate;
// - everything else (C = 1, odd channel counts): "direct_f32": at C = 1,
//   O <= 64 on rows of a 16-byte multiple with the tensors on 16 bytes
//   the kernel of conv3x3_direct_c1.cu, bound by its writes; on the other
//   shapes the kernel below.
//
// The bf16 instance (conv3x3_bf16: bf16 x, residual and y, f32 bias; the
// Pallas kernel with act_bf16's operands) chooses the same way among
// - O == 1: "head_bf16" (conv3x3_head.cu);
// - C % 16 == 0, O % 8 == 0, O <= 64, W % 8 == 0, aligned: "wgmma_bf16"
//   (conv3x3_wgmma_bf16.cu), bf16 products on the tensor cores with the
//   weights resident in shared memory;
// - everything else: "direct_bf16", direct_f32's two kernels reading and
//   writing bf16 and computing in f32 (a product of two bf16 values is
//   exact in f32, so it computes what the TPU kernel does up to summation
//   order).
//
// direct_f32's general kernel. What bounds it: at C = 1 (the 1->64 input
// conv of PostProcess where its rows are unaligned) bytes, 64 output
// planes written for one read; at wide C the f32 CUDA-core FMA rate (67
// TFLOP/s, H100 SXM at 700 W), which is why the wide shapes have left it
// for the tensor cores. Both kernels sum in the same order, so a shape
// gets the same bits from either.
//
// Design (direct conv, no im2col in device memory):
// - a block owns a TH x 32 tile of output pixels for OCB output channels
//   of one image; 256 threads. Each thread accumulates 8 pixels of one
//   column (8 consecutive rows) x 8 output channels in registers with
//   FFMA. A warp's 32 lanes are 32 adjacent columns and share their 8
//   output channels: input reads from shared memory are conflict-free,
//   every weight read is a broadcast, and residual reads and output
//   writes are coalesced rows;
// - input channels are walked in chunks of CC: each chunk stages the
//   (TH+2) x 34 input tile with its zero halo and the chunk's weights in
//   shared memory. The wrapper passes the weights as (C, 3, 3, O), so a
//   chunk's weights are one contiguous run;
// - registers are capped at 128 a thread so two blocks share an SM and
//   one block's staging overlaps the other's FMAs;
// - bias, residual and activation are fused into the epilogue.
// The summation order is fixed (chunk, channel, kx, ky), so the output
// is deterministic run to run; no atomics.

#include "conv3x3_common.cuh"

namespace conv3x3 {
namespace {

constexpr int kPix = 8;  // output pixels per thread (one column, adjacent rows)
constexpr int kOc = 8;   // output channels per thread
constexpr int kTW = 32;  // tile width: one column per lane

// T: float, or __nv_bfloat16 for x, res and y (the weights are f32)
template <int OCB, int CC, typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ wt,
               const float* __restrict__ b, const T* __restrict__ res,
               T* __restrict__ y, int C, int H, int W, int O, int act) {
  constexpr int NOG = OCB / kOc;            // oc groups per block
  constexpr int NPG = kThreads / NOG;       // threads per oc group
  constexpr int TH = (NPG / kTW) * kPix;    // tile rows
  constexpr int IH = TH + 2;
  constexpr int IW = kTW + 2;
  static_assert(NPG % kTW == 0, "an oc group is whole warps");

  __shared__ float in_s[CC][IH][IW];
  __shared__ __align__(16) float w_s[CC][9][OCB];

  const int tid = threadIdx.x;
  const int og = tid / NPG;                 // uniform within a warp
  const int pg = tid % NPG;
  const int col = pg % kTW;                 // = lane
  const int row0 = (pg / kTW) * kPix;

  const int tiles_x = (W + kTW - 1) / kTW;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int oc0 = blockIdx.y * OCB;
  const int n = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const T* xn = x + (size_t)n * C * plane;

  float acc[kPix][kOc];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int o = 0; o < kOc; ++o) acc[p][o] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();
    for (int i = tid; i < CC * IH * IW; i += kThreads) {
      const int cc = i / (IH * IW);
      const int r = (i / IW) % IH;
      const int q = i % IW;
      const int gy = y0 + r - 1;
      const int gx = x0 + q - 1;
      float v = 0.f;
      if (c0 + cc < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_float(xn[(size_t)(c0 + cc) * plane + (size_t)gy * W + gx]);
      in_s[cc][r][q] = v;
    }
    for (int i = tid; i < CC * 9 * OCB; i += kThreads) {
      const int oc = i % OCB;
      const int k = (i / OCB) % 9;
      const int cc = i / (OCB * 9);
      float v = 0.f;
      if (oc0 + oc < O && c0 + cc < C)
        v = wt[((size_t)(c0 + cc) * 9 + k) * O + oc0 + oc];
      w_s[cc][k][oc] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int cc = 0; cc < CC; ++cc) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float v[kPix + 2];
#pragma unroll
        for (int j = 0; j < kPix + 2; ++j) v[j] = in_s[cc][row0 + j][col + kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float4 wa =
              *reinterpret_cast<const float4*>(&w_s[cc][ky * 3 + kx][og * kOc]);
          const float4 wb =
              *reinterpret_cast<const float4*>(&w_s[cc][ky * 3 + kx][og * kOc + 4]);
          const float wv[kOc] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int p = 0; p < kPix; ++p)
#pragma unroll
            for (int o = 0; o < kOc; ++o)
              acc[p][o] = fmaf(v[p + ky], wv[o], acc[p][o]);
        }
      }
    }
  }

  const int gx = x0 + col;
  if (gx >= W) return;
#pragma unroll
  for (int o = 0; o < kOc; ++o) {
    const int oc = oc0 + og * kOc + o;
    if (oc >= O) continue;
    const float bias = b[oc];
    const size_t base = ((size_t)n * O + oc) * plane + gx;
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int gy = y0 + row0 + p;
      if (gy >= H) continue;
      float val = acc[p][o] + bias;
      if (res != nullptr) val += to_float(res[base + (size_t)gy * W]);
      y[base + (size_t)gy * W] = from_float<T>(activate(val, act));
    }
  }
}

template <int OCB, int CC, typename T>
cudaError_t launch(const Args& a) {
  constexpr int TH = (kThreads / (OCB / kOc) / kTW) * kPix;
  const int tiles = ((a.W + kTW - 1) / kTW) * ((a.H + TH - 1) / TH);
  dim3 grid(tiles, (a.O + OCB - 1) / OCB, a.N);
  conv3x3_kernel<OCB, CC, T><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.w), a.b,
      static_cast<const T*>(a.res), static_cast<T*>(a.y), a.C, a.H, a.W, a.O, a.act);
  return cudaGetLastError();
}

// a.w: the f32 weights as (C, 3, 3, O), i.e. OIHW permuted to (1, 2, 3, 0)
template <typename T>
cudaError_t launch_direct_t(const Args& a) {
  if (direct_c1_takes(a.C, a.O, a.W, sizeof(T), aligned16(a)))  // bound by writes
    return sizeof(T) == 4 ? launch_direct_c1(a) : launch_direct_c1_bf16(a);
  if (a.N > 65535 || (a.O + 7) / 8 > 65535) return cudaErrorInvalidValue;
  if (a.O <= 8)  // narrow heads: one oc group, 64x32 tiles
    return launch<8, 4, T>(a);
  if (a.C == 1)  // input convs (1->64) on unaligned rows: no idle channels in a chunk
    return launch<64, 1, T>(a);
  return launch<64, 8, T>(a);  // 8x32 tiles x 64 output channels
}

}  // namespace

cudaError_t launch_direct(const Args& a) { return launch_direct_t<float>(a); }
cudaError_t launch_direct_bf16(const Args& a) { return launch_direct_t<__nv_bfloat16>(a); }

}  // namespace conv3x3

// Whether a variant takes the shape (`aligned`: x, the residual and y lie
// on 16-byte multiples).
extern "C" int conv3x3_takes(int variant, int C, int O, int W, int aligned) {
  switch (variant) {
    case conv3x3::kDirect: return 1;
    case conv3x3::kHead: return O == 1 && C <= 2048;
    case conv3x3::kMmaSync: return C % 8 == 0 && conv3x3::tc_padded_o(O) != 0;
    case conv3x3::kWgmma: return conv3x3::wgmma_takes(C, O, W, aligned != 0);
    case conv3x3::kDirectBf16: return 1;
    case conv3x3::kHeadBf16: return O == 1 && C <= 2048;
    case conv3x3::kWgmmaBf16: return conv3x3::wgmma_bf16_takes(C, O, W, aligned != 0);
    default: return 0;
  }
}

// The variant (conv3x3::Variant) that conv3x3_f32 takes for this shape
// when it is asked for kAuto.
extern "C" int conv3x3_pick(int C, int O, int W, int aligned) {
  using namespace conv3x3;
  const int order[] = {kHead, kWgmma, kMmaSync, kDirect};
  for (int v : order)
    if (conv3x3_takes(v, C, O, W, aligned)) return v;
  return kDirect;
}

// The same for the bf16 instance.
extern "C" int conv3x3_pick_bf16(int C, int O, int W, int aligned) {
  using namespace conv3x3;
  const int order[] = {kHeadBf16, kWgmmaBf16, kDirectBf16};
  for (int v : order)
    if (conv3x3_takes(v, C, O, W, aligned)) return v;
  return kDirectBf16;
}

// Output channels of the packed weights a tensor-core variant reads (0 if
// O has no such variant).
extern "C" int conv3x3_padded_o(int O) { return conv3x3::tc_padded_o(O); }

namespace {

int launch_variant(const conv3x3::Args& a, int variant, bool bf16) {
  using namespace conv3x3;
  if (a.N <= 0 || a.C <= 0 || a.H <= 0 || a.W <= 0 || a.O <= 0 || a.act < 0 || a.act > 2)
    return (int)cudaErrorInvalidValue;
  if (variant == kAuto)
    variant = bf16 ? conv3x3_pick_bf16(a.C, a.O, a.W, aligned16(a))
                   : conv3x3_pick(a.C, a.O, a.W, aligned16(a));
  if ((variant >= kDirectBf16) != bf16) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kDirect: return (int)launch_direct(a);
    case kHead: return (int)launch_head(a);
    case kMmaSync: return (int)launch_mma_sync(a);
    case kWgmma: return (int)launch_wgmma(a);
    case kDirectBf16: return (int)launch_direct_bf16(a);
    case kHeadBf16: return (int)launch_head_bf16(a);
    case kWgmmaBf16: return (int)launch_wgmma_bf16(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// w: the weights in the layout of the variant that runs (ops/conv3x3.py
// packs them). variant 0 takes conv3x3_pick's choice; another value
// forces that variant, for measurements, and fails on a shape it does not
// take. Returns the cudaError_t of the launch.
extern "C" int conv3x3_f32(const float* x, const void* w, const float* b,
                           const float* res, float* y, int N, int C, int H,
                           int W, int O, int act, int variant, void* stream) {
  const conv3x3::Args a{x, w, b, res, y, N, C, H, W, O, act,
                        reinterpret_cast<cudaStream_t>(stream)};
  return launch_variant(a, variant, false);
}

// The bf16 instance: x, res and y bf16, b f32, w in the variant's layout
// (bf16 for wgmma_bf16, f32 for the others); variants 5-7 or 0.
extern "C" int conv3x3_bf16(const __nv_bfloat16* x, const void* w, const float* b,
                            const __nv_bfloat16* res, __nv_bfloat16* y, int N, int C,
                            int H, int W, int O, int act, int variant, void* stream) {
  const conv3x3::Args a{x, w, b, res, y, N, C, H, W, O, act,
                        reinterpret_cast<cudaStream_t>(stream)};
  return launch_variant(a, variant, true);
}
