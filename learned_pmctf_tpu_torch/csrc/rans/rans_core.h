// 64-bit rANS range coder core.
//
// Clean-room implementation of the standard rans64 construction
// (F. Giesen's public-domain formulation): 64-bit state, 32-bit word
// renormalization, encoder runs backwards over buffered symbols.
// Byte-format compatible with the reference coder
// (ref: pMCTF/cpp/rans/rans.cpp) including the 4-bit bypass escape
// for out-of-range symbols, so golden-stream tests can compare.
#pragma once

#include <cassert>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace pmctf {

using RansState = uint64_t;

// Lower bound of the normalized interval: states live in [kRansL, kRansL*2^32).
constexpr uint64_t kRansL = 1ull << 31;

constexpr int kPrecision = 16;                    // probability scale bits
constexpr uint16_t kBypassPrecision = 4;          // raw bits per bypass chunk
constexpr uint16_t kMaxBypassVal = (1 << kBypassPrecision) - 1;

inline void rans_enc_init(RansState* r) { *r = kRansL; }

// Encode a symbol occupying [start, start+freq) of the 2^precision scale.
inline void rans_enc_put(RansState* r, uint32_t** pptr, uint32_t start,
                         uint32_t freq, uint32_t precision) {
  uint64_t x = *r;
  uint64_t x_max = ((kRansL >> precision) << 32) * freq;
  if (x >= x_max) {
    *pptr -= 1;
    **pptr = static_cast<uint32_t>(x);
    x >>= 32;
  }
  *r = ((x / freq) << precision) + (x % freq) + start;
}

// Encode nbits raw bits (bypass mode): freq = 2^(precision - nbits).
inline void rans_enc_put_bits(RansState* r, uint32_t** pptr, uint32_t val,
                              uint32_t nbits) {
  assert(nbits <= 16);
  assert(val < (1u << nbits));
  uint64_t x = *r;
  uint32_t freq = 1 << (16 - nbits);
  uint64_t x_max = ((kRansL >> 16) << 32) * freq;
  if (x >= x_max) {
    *pptr -= 1;
    **pptr = static_cast<uint32_t>(x);
    x >>= 32;
  }
  *r = (x << nbits) | val;
}

inline void rans_enc_flush(RansState* r, uint32_t** pptr) {
  uint64_t x = *r;
  *pptr -= 2;
  (*pptr)[0] = static_cast<uint32_t>(x >> 0);
  (*pptr)[1] = static_cast<uint32_t>(x >> 32);
}

inline void rans_dec_init(RansState* r, uint32_t** pptr) {
  uint64_t x = static_cast<uint64_t>((*pptr)[0]) << 0;
  x |= static_cast<uint64_t>((*pptr)[1]) << 32;
  *pptr += 2;
  *r = x;
}

inline uint32_t rans_dec_get(RansState* r, uint32_t precision) {
  return static_cast<uint32_t>(*r & ((1u << precision) - 1));
}

inline void rans_dec_advance(RansState* r, uint32_t** pptr, uint32_t start,
                             uint32_t freq, uint32_t precision) {
  uint64_t mask = (1ull << precision) - 1;
  uint64_t x = *r;
  x = freq * (x >> precision) + (x & mask) - start;
  if (x < kRansL) {
    x = (x << 32) | **pptr;
    *pptr += 1;
  }
  *r = x;
}

inline uint32_t rans_dec_get_bits(RansState* r, uint32_t** pptr,
                                  uint32_t n_bits) {
  uint64_t x = *r;
  uint32_t val = static_cast<uint32_t>(x & ((1u << n_bits) - 1));
  x = x >> n_bits;
  if (x < kRansL) {
    x = (x << 32) | **pptr;
    *pptr += 1;
  }
  *r = x;
  return val;
}

}  // namespace pmctf
