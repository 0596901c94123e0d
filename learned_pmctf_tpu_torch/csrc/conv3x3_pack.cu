// conv3x3: the tensor-core variants' weight pack, on the device.
//
// Replaces no TPU kernel: the Pallas kernel read its weights as they
// were. The tensor-core variants read each weight split in two TF32
// numbers and laid out for their B tiles (ops/conv3x3.py:pack_weights).
// PostProcess and the trainers pack a weight once and keep the pack on
// the tensor; the four-step priors hold 282 weights of 112 and 128
// channels a pWave call on the kernel, whose packs would pin 0.48 GiB in
// two coders, so their residual blocks pack each weight anew for the
// call, into a tensor the wrapper frees after the launches. This kernel
// does that in one launch, bit for bit as pack_weights(w, "wgmma"): the
// same tf32_split (big = v rounded to 10 mantissa bits, ties away from
// zero; small = v - big rounded the same way) and the same order.
//
// What bounds it: bytes, 3 a weight read for every 8 written: a
// 112->112 conv's 451.6 KB in, 903.2 KB out, about 0.4 us at 3.35 TB/s
// (H100 SXM), so launch latency. One thread an element of the pack,
// written in order (coalesced); the reads are gathers of a tensor that
// stays in L2.

#include "conv3x3_common.cuh"

namespace conv3x3 {
namespace {

// out: 2 * 9 * C * (8 NT) floats in the "wgmma" layout, [chunk][tap]
// [part][k half][n-tile][g][t]. `O` outputs are read; from O up to 8 NT
// they are zero.
__global__ void pack_kernel(const float* __restrict__ w, float* __restrict__ out, int O,
                            int C, int NT) {
  const int total = 2 * 9 * C * 8 * NT;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    int r = i;
    const int t = r % 4;
    r /= 4;
    const int g = r % 8;
    r /= 8;
    const int nt = r % NT;
    r /= NT;
    const int kh = r % 2;
    r /= 2;
    const int part = r % 2;
    r /= 2;
    const int tap = r % 9, chunk = r / 9;
    const int o = 8 * nt + g, c = 8 * chunk + 4 * kh + t;
    float v = 0.f;
    if (o < O) {
      const float a = w[((size_t)o * C + c) * 9 + tap];
      const float big = __uint_as_float(to_tf32(a));
      v = part == 0 ? big : __uint_as_float(to_tf32(a - big));
    }
    out[i] = v;
  }
}

// w: (O, C, 3, 3) f32, contiguous, packed for o_pad outputs into out.
cudaError_t pack(const float* w, float* out, int O, int C, int o_pad, cudaStream_t stream) {
  const int total = 2 * 9 * C * o_pad;
  const int threads = 256;
  pack_kernel<<<(total + threads - 1) / threads, threads, 0, stream>>>(w, out, O, C,
                                                                      o_pad / 8);
  return cudaGetLastError();
}

}  // namespace
}  // namespace conv3x3

extern "C" int conv3x3_padded_o(int O);
extern "C" int conv3x3_f32(const float* x, const void* w, const float* b, const float* res,
                           float* y, int N, int C, int H, int W, int O, int act, int variant,
                           void* stream);

// The four-step priors' residual block in one call from the host:
// t = LeakyReLU(conv3x3(x, w1) + b1), y = (conv3x3(t, w2) + b2) + x, x, t
// and y (N, C, H, W), w1 and w2 (C, C, 3, 3), on wgmma_3xtf32 alone: both
// weights are packed into `packs` (2 x 2 * 9 * C * conv3x3_padded_o(C)
// floats) for this call; four launches on `stream`, in order. Returns
// cudaErrorInvalidValue, launching nothing, where wgmma_3xtf32 does not
// take the shape or the pointers, else the cudaError_t of the first
// launch that fails.
extern "C" int conv3x3_residual_block_f32(const float* x, const float* w1, const float* b1,
                                          const float* w2, const float* b2, float* packs,
                                          float* t, float* y, int N, int C, int H, int W,
                                          void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(t) |
                         reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  if (N <= 0 || C <= 0 || H <= 0 || !conv3x3::wgmma_takes(C, C, W, aligned))
    return (int)cudaErrorInvalidValue;
  const auto s = reinterpret_cast<cudaStream_t>(stream);
  const int o_pad = conv3x3_padded_o(C);
  float* pack2 = packs + (size_t)2 * 9 * C * o_pad;
  int rc = (int)conv3x3::pack(w1, packs, C, C, o_pad, s);
  if (rc == 0) rc = (int)conv3x3::pack(w2, pack2, C, C, o_pad, s);
  if (rc == 0)
    rc = conv3x3_f32(x, packs, b1, nullptr, t, N, C, H, W, C, conv3x3::kLeaky,
                     conv3x3::kWgmma, stream);
  if (rc == 0)
    rc = conv3x3_f32(t, pack2, b2, x, y, N, C, H, W, C, conv3x3::kNone, conv3x3::kWgmma,
                     stream);
  return rc;
}
