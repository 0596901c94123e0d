// conv3x3, the one-input-channel kernel of "direct_f32" and "direct_bf16"
// (Hopper, sm_90a).
//
// Replaces the TPU kernel learned_pmctf_tpu/ops/pallas_conv.py:conv3x3_hcw
// for C = 1 and O <= 64 (the 1->64 input conv of PostProcess, and in
// training the input gradient of its 64->1 output conv), on NCHW rows of a
// 16-byte multiple with x, the residual and y on 16 bytes. The other
// shapes of the direct variants keep the general kernel of conv3x3.cu;
// launch_direct_t there chooses by shape.
//
// What bounds it: writes. It reads one input plane and writes O output
// planes: at luma (1x1x1152x1920 -> 64) 566 MB in f32, 283 MB in bf16,
// 0.169 and 0.085 ms at 3.35 TB/s (H100 SXM, 700 W); the input is 1/64 of
// that, and its 9 FMAs an output take a quarter of the write time on the
// f32 cores.
//
// Design, against what held the general kernel back at C = 1 (one narrow
// store an element, 64 a thread a tile, so that store instructions and
// not bytes set its pace; weights fetched again for every tile; every
// tile's loads, compute and stores one after the other):
// - the writes are whole rows of 16-byte vectors. A tile is TH = 2 rows of
//   TW pixels, 512 bytes a row (128 f32 or 256 bf16), for all O outputs; a
//   thread computes one 16-byte vector of a row (4 f32 or 8 bf16 pixels)
//   for 16 of the outputs and stores each straight from registers
//   (st.global.cs.v4: a warp writes 512 contiguous bytes, marked to leave
//   the L2 first, as nothing here reads the output again). The shared
//   memory stays small, so two blocks share an SM and one's products
//   overlap the other's stores. (Stores of shared-memory boxes by TMA
//   measured no faster on the card: PERF.md §6.);
// - persistent: the blocks walk the tiles (image, tile row, tile column)
//   with stride gridDim.x, the 9 x O weights and the bias in shared memory
//   once a block, not once a tile;
// - the next tile's input window, (TH + 2) rows of TW pixels and a 16-byte
//   vector on either side, comes in by cp.async (16 bytes a copy,
//   zero-filled outside the image: the 'same' padding) while the current
//   tile computes; a second window buffer holds it. (TMA loads cannot
//   start a box at the halo's odd pixel.)
// Arithmetic, the same bits as the general kernel: each output starts
// from 0.f and takes the nine products by fmaf, kx outer and ky inner,
// the zero-padded taps included; then the bias, then the residual, then
// the activation, all in f32; the bf16 instance rounds once on the store.

#include <atomic>

#include "conv3x3_common.cuh"

namespace conv3x3 {
namespace {

constexpr int kTH = 2;                          // tile rows
constexpr int kVPR = 32;                        // 16-byte vectors a tile row
constexpr int kBlock = 256;
constexpr int kBlocksPerSm = 2;
constexpr int kGroupWarps = kTH * kVPR / 32;    // warps that cover a tile
constexpr int kGroups = kBlock / 32 / kGroupWarps;  // output groups: o = g, g + 4, ...

template <typename T>
struct C1 {
  static constexpr int kVec = 16 / sizeof(T);      // pixels a 16-byte vector
  static constexpr int kTW = kVPR * kVec;          // a row of the tile: 512 bytes
  static constexpr int kStride = kTW + 2 * kVec;   // a window row: a vector each side
  static constexpr int kWinElems = (kTH + 2) * kStride;
  static constexpr int kCopies = (kTH + 2) * (kStride / kVec);
  // shared memory: two windows, the weights and the bias
  static constexpr int smem_bytes(int O) { return 2 * kWinElems * (int)sizeof(T) + O * 13 * 4; }
};

// launches of the kernel, f32 [0] and bf16 [1], counted where it launches
std::atomic<long long> c1_launches[2];

// 16 bytes of T as kVec floats, and back (rounded once for bf16)
__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the bits shifted up
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // one cvt.rn.bf16x2.f32: each half rounded as __float2bfloat16_rn rounds
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The input window of the tile whose first pixel is (y0, x0) of the
// image's plane `xn`: window row r is image row y0 - 1 + r, element j of a
// row is pixel x0 - kVec + j. Copy v of a row is 16 bytes, all inside the
// image or all outside it (W and x0 are multiples of kVec): zero-filled
// outside.
template <typename T>
__device__ __forceinline__ void stage_window(T* dst, const T* xn, int y0, int x0, int H, int W,
                                             int tid) {
  using K = C1<T>;
  constexpr int kPerRow = K::kStride / K::kVec;
  for (int i = tid; i < K::kCopies; i += kBlock) {
    const int r = i / kPerRow, v = i % kPerRow;
    const int gy = y0 - 1 + r, gx = x0 - K::kVec + K::kVec * v;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async16(dst + r * K::kStride + K::kVec * v, ok ? xn + (size_t)gy * W + gx : xn,
               ok ? 16 : 0);
  }
}

template <typename T, int ACT, bool RES>
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
conv3x3_direct_c1_kernel(const T* __restrict__ x,
                         const float* __restrict__ wt, const float* __restrict__ b,
                         const T* __restrict__ res, T* __restrict__ y, int N, int H, int W,
                         int O) {
  using K = C1<T>;
  constexpr int kVec = K::kVec;
  extern __shared__ __align__(16) uint8_t smem[];
  T* win = reinterpret_cast<T*>(smem);
  float* w_s = reinterpret_cast<float*>(win + 2 * K::kWinElems);  // [o][12]
  float* b_s = w_s + O * 12;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int vi = (warp % kGroupWarps) * 32 + lane;
  const int row = vi / kVPR;             // of the tile
  const int q = vi % kVPR;               // the vector of the row: pixels kVec q ..
  const int og = warp / kGroupWarps;     // outputs og, og + kGroups, ...

  const TileWalk walk(N, H, W, kTH, K::kTW);
  const int my_tiles =
      blockIdx.x < walk.total ? (walk.total - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const size_t plane = (size_t)H * W;

  for (int i = tid; i < O * 12; i += kBlock) {
    const int o = i / 12, k = i % 12;
    w_s[i] = k < 9 ? wt[k * O + o] : 0.f;  // wt: (1, 3, 3, O)
  }
  for (int i = tid; i < O; i += kBlock) b_s[i] = b[i];

  auto stage = [&](int tile, int buf) {
    int n, ty, tx;
    walk.decode(tile, n, ty, tx);
    stage_window<T>(win + buf * K::kWinElems, x + (size_t)n * plane, ty * kTH, tx * K::kTW, H,
                    W, tid);
  };
  if (my_tiles > 0) stage(blockIdx.x, 0);
  cp_async_commit();

  for (int k = 0; k < my_tiles; ++k) {
    const int tile = blockIdx.x + k * gridDim.x;
    cp_async_wait<0>();  // this thread's copies of window k
    __syncthreads();  // window k complete; every thread is done with window k - 1
    if (k + 1 < my_tiles) stage(tile + gridDim.x, (k + 1) & 1);
    cp_async_commit();

    // the thread's inputs: rows row .. row + 2 of the window, pixels
    // kVec q - 1 .. kVec q + kVec of the tile
    float v[3][kVec + 2];
    const T* wk = win + (k & 1) * K::kWinElems;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const T* p = wk + (row + r) * K::kStride + kVec * (q + 1);
      float mid[kVec];
      unpack(*reinterpret_cast<const uint4*>(p), mid);
      v[r][0] = to_float(p[-1]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[r][j + 1] = mid[j];
      v[r][kVec + 1] = to_float(p[kVec]);
    }
    // opaque to the compiler: it would unpack the bf16 window again for
    // every output channel rather than keep the floats in registers
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int j = 0; j < kVec + 2; ++j) asm volatile("" : "+f"(v[r][j]));

    int n, ty, tx;
    walk.decode(tile, n, ty, tx);
    const int gy = ty * kTH + row, gx = tx * K::kTW + kVec * q;
    const bool inside = gy < H && gx < W;  // the whole vector, or none of it
    const size_t at = (size_t)n * O * plane + (size_t)gy * W + gx;  // output 0's pixel

#pragma unroll 2
    for (int o = og; o < O; o += kGroups) {
      const float4* wq = reinterpret_cast<const float4*>(w_s + o * 12);
      const float4 w0 = wq[0], w1 = wq[1], w2 = wq[2];
      const float wv[9] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x};
      float acc[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            acc[j] = fmaf(v[ky][j + kx], wv[ky * 3 + kx], acc[j]);
      float rv[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) rv[j] = 0.f;
      if (RES && inside)
        unpack(__ldg(reinterpret_cast<const uint4*>(res + at + (size_t)o * plane)), rv);
      const float bias = b_s[o];
      float out[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float val = acc[j] + bias;
        if (RES) val += rv[j];
        out[j] = activate(val, ACT);
      }
      if (inside) __stcs(reinterpret_cast<uint4*>(y + at + (size_t)o * plane), pack(out));
    }
  }
}

template <typename T, int ACT, bool RES>
cudaError_t launch_c1_kernel(const Args& a) {
  using K = C1<T>;
  auto kernel = conv3x3_direct_c1_kernel<T, ACT, RES>;
  // persistent: as many blocks as fit on the SMs, worked out once an
  // instance at the most shared memory (O = 64), under the 48 KB that
  // needs no opt-in
  static_assert(K::smem_bytes(64) <= 48 * 1024, "");
  static const int per_sm = [&] {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kBlock, K::smem_bytes(64))
                   == cudaSuccess ? n : 0;
  }();
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const TileWalk walk(a.N, a.H, a.W, kTH, K::kTW);
  const int slots = sm_count() * per_sm;
  const int grid = walk.total < slots ? walk.total : slots;
  kernel<<<grid, kBlock, K::smem_bytes(a.O), a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.w), a.b,
      static_cast<const T*>(a.res), static_cast<T*>(a.y), a.N, a.H, a.W, a.O);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) c1_launches[sizeof(T) == 2].fetch_add(1);
  return err;
}

template <typename T>
cudaError_t launch_c1(const Args& a) {
  if (!direct_c1_takes(a.C, a.O, a.W, sizeof(T), aligned16(a))) return cudaErrorInvalidValue;
  const bool res = a.res != nullptr;
  switch (a.act) {
    case kLeaky: return res ? launch_c1_kernel<T, kLeaky, true>(a)
                            : launch_c1_kernel<T, kLeaky, false>(a);
    case kTanh: return res ? launch_c1_kernel<T, kTanh, true>(a)
                           : launch_c1_kernel<T, kTanh, false>(a);
    default: return res ? launch_c1_kernel<T, kNone, true>(a)
                        : launch_c1_kernel<T, kNone, false>(a);
  }
}

}  // namespace

cudaError_t launch_direct_c1(const Args& a) { return launch_c1<float>(a); }
cudaError_t launch_direct_c1_bf16(const Args& a) { return launch_c1<__nv_bfloat16>(a); }

}  // namespace conv3x3

// The launches of the C = 1 kernel (bf16: of its bf16 instance), counted
// where it launches: they tell which of the direct variants' two kernels
// ran. `reset` sets the count to 0 once it is read.
extern "C" long long conv3x3_direct_c1_launches(int bf16, int reset) {
  std::atomic<long long>& n = conv3x3::c1_launches[bf16 != 0];
  return reset ? n.exchange(0) : n.load();
}
