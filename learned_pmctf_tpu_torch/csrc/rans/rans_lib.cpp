// Host-side entropy coding backend for learned_pmctf_tpu_torch, a copy of
// the JAX package's csrc/rans_lib.cpp (the two packages share no file).
//
// Exposes a plain C API (consumed from Python via ctypes) providing:
//   * a buffering rANS encoder with out-of-range bypass escapes,
//   * a multi-substream splitter writing the 1-byte-flag + per-stream-length
//     container (byte-compatible with ref: pMCTF/cpp/py_rans/py_rans.cpp:89-118),
//   * a matching multi-substream decoder with per-stream worker threads,
//   * PMF -> quantized-CDF conversion (ref: pMCTF/cpp/ops/ops.cpp:24-82).
//
// Threading model (a redesign of the reference's worker-queue
// encoder): encode_with_indexes() buffers cheap per-part task copies;
// flush() launches one std::thread per substream that replays its queue and
// flushes; get_stream() joins. This lets the host overlap rANS work with
// the next device computation without mutex/cv traffic per call.

#include "rans_core.h"

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdio>
#include <numeric>
#include <thread>

namespace pmctf {

struct RansSymbol {
  uint16_t start;
  uint16_t range;
  bool bypass;
};

// CDF table view: `cdf_num` rows of `stride` int32 entries; row i holds a
// monotone CDF of length cdfs_sizes[i] ending at 2^16.
struct CdfView {
  std::vector<int32_t> data;
  std::vector<int32_t> sizes;
  std::vector<int32_t> offsets;
  int stride = 0;
};

class StreamEncoder {
 public:
  void encode(const int16_t* symbols, const int16_t* indexes, int n,
              const CdfView& cdfs) {
    syms_.reserve(syms_.size() + static_cast<size_t>(n) * 3 / 2);
    for (int i = 0; i < n; ++i) {
      const int32_t cdf_idx = indexes[i];
      if (cdf_idx < 0) continue;
      const int32_t* cdf = cdfs.data.data() + cdf_idx * cdfs.stride;
      const int32_t max_value = cdfs.sizes[cdf_idx] - 2;
      int32_t value = symbols[i] - cdfs.offsets[cdf_idx];

      uint32_t raw_val = 0;
      if (value < 0) {
        raw_val = -2 * value - 1;
        value = max_value;
      } else if (value >= max_value) {
        raw_val = 2 * (value - max_value);
        value = max_value;
      }

      syms_.push_back({static_cast<uint16_t>(cdf[value]),
                       static_cast<uint16_t>(cdf[value + 1] - cdf[value]),
                       false});

      if (value == max_value) {
        // escape: emit chunk count then the raw value, 4 bits at a time
        int32_t n_bypass = 0;
        while ((raw_val >> (n_bypass * kBypassPrecision)) != 0) ++n_bypass;

        int32_t cnt = n_bypass;
        while (cnt >= kMaxBypassVal) {
          syms_.push_back({kMaxBypassVal, kMaxBypassVal + 1, true});
          cnt -= kMaxBypassVal;
        }
        syms_.push_back({static_cast<uint16_t>(cnt),
                         static_cast<uint16_t>(cnt + 1), true});
        for (int32_t j = 0; j < n_bypass; ++j) {
          const uint32_t chunk = (raw_val >> (j * kBypassPrecision)) & kMaxBypassVal;
          syms_.push_back({static_cast<uint16_t>(chunk),
                           static_cast<uint16_t>(chunk + 1), true});
        }
      }
    }
  }

  void flush() {
    RansState rans;
    rans_enc_init(&rans);
    std::vector<uint32_t> out(syms_.size() + 2);
    uint32_t* ptr = out.data() + out.size();
    for (auto it = syms_.rbegin(); it != syms_.rend(); ++it) {
      if (!it->bypass) {
        rans_enc_put(&rans, &ptr, it->start, it->range, kPrecision);
      } else {
        rans_enc_put_bits(&rans, &ptr, it->start, kBypassPrecision);
      }
    }
    rans_enc_flush(&rans, &ptr);
    const size_t nbytes =
        static_cast<size_t>(out.data() + out.size() - ptr) * sizeof(uint32_t);
    stream_.resize(nbytes);
    std::memcpy(stream_.data(), ptr, nbytes);
    syms_.clear();
  }

  const std::vector<uint8_t>& stream() const { return stream_; }
  void reset() {
    syms_.clear();
    stream_.clear();
  }

 private:
  std::vector<RansSymbol> syms_;
  std::vector<uint8_t> stream_;
};

class StreamDecoder {
 public:
  void set_stream(std::vector<uint8_t> data) {
    stream_ = std::move(data);
    // pad so that the u32 reads past the logical end stay in-bounds
    stream_.resize((stream_.size() + 3) / 4 * 4 + 8, 0);
    ptr_ = reinterpret_cast<uint32_t*>(stream_.data());
    rans_dec_init(&rans_, &ptr_);
  }

  void decode(const int16_t* indexes, int n, const CdfView& cdfs,
              int16_t* out) {
    for (int i = 0; i < n; ++i) {
      const int32_t cdf_idx = indexes[i];
      if (cdf_idx < 0) {
        out[i] = 0;
        continue;
      }
      const int32_t offset = cdfs.offsets[cdf_idx];
      const int32_t* cdf = cdfs.data.data() + cdf_idx * cdfs.stride;
      const int32_t size = cdfs.sizes[cdf_idx];
      const int32_t max_value = size - 2;
      const uint32_t cum = rans_dec_get(&rans_, kPrecision);

      // monotone CDF (entries in [0, 2^16], int32-positive): binary search
      // for the first entry > cum, containing bucket is one before it.
      const int32_t* end = cdf + size;
      const int32_t* it = std::upper_bound(cdf, end, static_cast<int32_t>(cum));
      int32_t s = static_cast<int32_t>(it - cdf) - 1;
      rans_dec_advance(&rans_, &ptr_, cdf[s], cdf[s + 1] - cdf[s], kPrecision);

      int32_t value = s;
      if (value == max_value) {
        uint32_t val = rans_dec_get_bits(&rans_, &ptr_, kBypassPrecision);
        uint32_t n_bypass = val;
        while (val == kMaxBypassVal) {
          val = rans_dec_get_bits(&rans_, &ptr_, kBypassPrecision);
          n_bypass += val;
        }
        uint32_t raw_val = 0;
        for (uint32_t j = 0; j < n_bypass; ++j) {
          val = rans_dec_get_bits(&rans_, &ptr_, kBypassPrecision);
          raw_val |= val << (j * kBypassPrecision);
        }
        value = raw_val >> 1;
        if (raw_val & 1) {
          value = -value - 1;
        } else {
          value += max_value;
        }
      }
      out[i] = static_cast<int16_t>(value + offset);
    }
  }

 private:
  RansState rans_ = 0;
  uint32_t* ptr_ = nullptr;
  std::vector<uint8_t> stream_;
};

static CdfView make_cdf_view(const int32_t* cdfs, int cdf_num, int stride,
                             const int32_t* sizes, const int32_t* offsets) {
  CdfView v;
  v.stride = stride;
  v.data.assign(cdfs, cdfs + static_cast<size_t>(cdf_num) * stride);
  v.sizes.assign(sizes, sizes + cdf_num);
  v.offsets.assign(offsets, offsets + cdf_num);
  return v;
}

// ---- multi-substream encoder -------------------------------------------

struct EncodeTask {
  std::vector<int16_t> symbols;
  std::vector<int16_t> indexes;
  std::shared_ptr<CdfView> cdfs;
};

class MultiEncoder {
 public:
  MultiEncoder(bool async_flush, int parts)
      : async_(async_flush || parts > 1), parts_(std::max(parts, 1)) {
    encoders_.resize(parts_);
    tasks_.resize(parts_);
  }

  ~MultiEncoder() { join(); }

  void encode_with_indexes(const int16_t* symbols, const int16_t* indexes,
                           int n, const int32_t* cdfs, int cdf_num, int stride,
                           const int32_t* sizes, const int32_t* offsets) {
    auto view = std::make_shared<CdfView>(
        make_cdf_view(cdfs, cdf_num, stride, sizes, offsets));
    const int each = n / parts_;
    for (int p = 0; p < parts_; ++p) {
      const int begin = p * each;
      const int count = (p == parts_ - 1) ? (n - begin) : each;
      EncodeTask t;
      t.symbols.assign(symbols + begin, symbols + begin + count);
      t.indexes.assign(indexes + begin, indexes + begin + count);
      t.cdfs = view;
      tasks_[p].push_back(std::move(t));
    }
  }

  void flush() {
    join();
    workers_.reserve(parts_);
    for (int p = 0; p < parts_; ++p) {
      auto work = [this, p]() {
        for (const auto& t : tasks_[p]) {
          encoders_[p].encode(t.symbols.data(), t.indexes.data(),
                              static_cast<int>(t.symbols.size()), *t.cdfs);
        }
        tasks_[p].clear();
        encoders_[p].flush();
      };
      if (async_) {
        workers_.emplace_back(work);
      } else {
        work();
      }
    }
  }

  // Assembled container: flag byte + (parts-1) stream sizes + streams.
  std::vector<uint8_t> get_stream() {
    join();
    int maximum = 0;
    size_t total = 0;
    for (int p = 0; p < parts_; ++p) {
      const int nbytes = static_cast<int>(encoders_[p].stream().size());
      if (p < parts_ - 1 && nbytes > maximum) maximum = nbytes;
      total += nbytes;
    }
    const int per_header = maximum > 65535 ? 4 : 2;
    size_t overhead = 1;
    if (parts_ > 1) overhead += static_cast<size_t>(parts_ - 1) * per_header;

    std::vector<uint8_t> out(total + overhead);
    out[0] = static_cast<uint8_t>(((parts_ - 1) << 4) + (per_header == 2 ? 1 : 0));
    for (int p = 0; p < parts_ - 1; ++p) {
      const auto& s = encoders_[p].stream();
      if (per_header == 2) {
        const uint16_t sz = static_cast<uint16_t>(s.size());
        std::memcpy(out.data() + 1 + 2 * p, &sz, 2);
      } else {
        const uint32_t sz = static_cast<uint32_t>(s.size());
        std::memcpy(out.data() + 1 + 4 * p, &sz, 4);
      }
    }
    size_t off = overhead;
    for (int p = 0; p < parts_; ++p) {
      const auto& s = encoders_[p].stream();
      std::memcpy(out.data() + off, s.data(), s.size());
      off += s.size();
    }
    return out;
  }

  void reset() {
    join();
    for (auto& e : encoders_) e.reset();
    for (auto& t : tasks_) t.clear();
    cached_.clear();
    cached_valid_ = false;
  }

  // Assemble once, then serve size + bytes from the cache.
  int stream_size() {
    if (!cached_valid_) {
      cached_ = get_stream();
      cached_valid_ = true;
    }
    return static_cast<int>(cached_.size());
  }

  void copy_stream(uint8_t* out) {
    if (!cached_valid_) {
      cached_ = get_stream();
      cached_valid_ = true;
    }
    std::memcpy(out, cached_.data(), cached_.size());
  }

 private:
  void join() {
    for (auto& w : workers_)
      if (w.joinable()) w.join();
    workers_.clear();
  }

  bool async_;
  int parts_;
  std::vector<StreamEncoder> encoders_;
  std::vector<std::vector<EncodeTask>> tasks_;
  std::vector<std::thread> workers_;
  std::vector<uint8_t> cached_;
  bool cached_valid_ = false;
};

class MultiDecoder {
 public:
  explicit MultiDecoder(int parts) : parts_(std::max(parts, 1)) {
    decoders_.resize(parts_);
  }

  void set_stream(const uint8_t* data, int size) {
    const uint8_t flag = data[0];
    const int n_streams = (flag >> 4) + 1;
    // The container flag byte self-describes its substream count: adopt it,
    // so a decoder constructed with a different parts default cannot
    // silently mis-partition decode_stream calls (the per-call symbol split
    // must match the encoder's exactly).
    parts_ = n_streams;
    decoders_.assign(n_streams, StreamDecoder());
    const int per_header = (flag & 0x0f) == 1 ? 2 : 4;
    std::vector<uint32_t> sizes;
    int offset = 1;
    int total = 0;
    for (int i = 0; i < n_streams - 1; ++i) {
      uint32_t sz = 0;
      std::memcpy(&sz, data + offset, per_header);
      offset += per_header;
      sizes.push_back(sz);
      total += sz;
    }
    sizes.push_back(size - offset - total);
    for (int i = 0; i < n_streams; ++i) {
      decoders_[i].set_stream(
          std::vector<uint8_t>(data + offset, data + offset + sizes[i]));
      offset += sizes[i];
    }
  }

  void decode_stream(const int16_t* indexes, int n, const int32_t* cdfs,
                     int cdf_num, int stride, const int32_t* sizes,
                     const int32_t* offsets, int16_t* out) {
    const CdfView view = make_cdf_view(cdfs, cdf_num, stride, sizes, offsets);
    const int each = n / parts_;
    std::vector<std::thread> threads;
    for (int p = 0; p < parts_; ++p) {
      const int begin = p * each;
      const int count = (p == parts_ - 1) ? (n - begin) : each;
      if (parts_ == 1) {
        decoders_[p].decode(indexes + begin, count, view, out + begin);
      } else {
        threads.emplace_back([this, p, indexes, begin, count, &view, out]() {
          decoders_[p].decode(indexes + begin, count, view, out + begin);
        });
      }
    }
    for (auto& t : threads) t.join();
  }

 private:
  int parts_;
  std::vector<StreamDecoder> decoders_;
};

}  // namespace pmctf

// ---------------- C API ----------------------------------------------------

extern "C" {

void* pmctf_encoder_create(int multithread, int stream_part) {
  return new pmctf::MultiEncoder(multithread != 0, stream_part);
}
void pmctf_encoder_destroy(void* h) {
  delete static_cast<pmctf::MultiEncoder*>(h);
}
void pmctf_encoder_encode_with_indexes(void* h, const int16_t* symbols,
                                       const int16_t* indexes, int n,
                                       const int32_t* cdfs, int cdf_num,
                                       int stride, const int32_t* sizes,
                                       const int32_t* offsets) {
  static_cast<pmctf::MultiEncoder*>(h)->encode_with_indexes(
      symbols, indexes, n, cdfs, cdf_num, stride, sizes, offsets);
}
void pmctf_encoder_flush(void* h) {
  static_cast<pmctf::MultiEncoder*>(h)->flush();
}
int pmctf_encoder_stream_size(void* h) {
  return static_cast<pmctf::MultiEncoder*>(h)->stream_size();
}
void pmctf_encoder_get_stream(void* h, uint8_t* out) {
  static_cast<pmctf::MultiEncoder*>(h)->copy_stream(out);
}
void pmctf_encoder_reset(void* h) {
  static_cast<pmctf::MultiEncoder*>(h)->reset();
}

void* pmctf_decoder_create(int stream_part) {
  return new pmctf::MultiDecoder(stream_part);
}
void pmctf_decoder_destroy(void* h) {
  delete static_cast<pmctf::MultiDecoder*>(h);
}
void pmctf_decoder_set_stream(void* h, const uint8_t* data, int size) {
  static_cast<pmctf::MultiDecoder*>(h)->set_stream(data, size);
}
void pmctf_decoder_decode_stream(void* h, const int16_t* indexes, int n,
                                 const int32_t* cdfs, int cdf_num, int stride,
                                 const int32_t* sizes, const int32_t* offsets,
                                 int16_t* out) {
  static_cast<pmctf::MultiDecoder*>(h)->decode_stream(
      indexes, n, cdfs, cdf_num, stride, sizes, offsets, out);
}

// PMF -> integer CDF summing to 2^precision with all-positive frequencies.
// Steals mass from the lowest-frequency symbol to fix zero-width buckets.
// Numerics match ref: pMCTF/cpp/ops/ops.cpp:24-82 so CDF tables (and thus
// bitstreams) are identical given identical PMFs.
int pmctf_pmf_to_quantized_cdf(const float* pmf, int n, int precision,
                               uint32_t* cdf /* size n+1 */) {
  cdf[0] = 0;
  for (int i = 0; i < n; ++i) {
    cdf[i + 1] = static_cast<uint32_t>(
        std::round(pmf[i] * (1 << precision)) + 0.5);
  }
  uint32_t total = 0;
  for (int i = 0; i <= n; ++i) total += cdf[i];
  if (total == 0) return -1;
  for (int i = 0; i <= n; ++i) {
    cdf[i] = static_cast<uint32_t>(
        ((1ull << precision) * static_cast<uint64_t>(cdf[i])) / total);
  }
  for (int i = 1; i <= n; ++i) cdf[i] += cdf[i - 1];
  cdf[n] = 1u << precision;

  for (int i = 0; i < n; ++i) {
    if (cdf[i] == cdf[i + 1]) {
      uint32_t best_freq = ~0u;
      int best_steal = -1;
      for (int j = 0; j < n; ++j) {
        const uint32_t freq = cdf[j + 1] - cdf[j];
        if (freq > 1 && freq < best_freq) {
          best_freq = freq;
          best_steal = j;
        }
      }
      if (best_steal < 0) return -2;
      if (best_steal < i) {
        for (int j = best_steal + 1; j <= i; ++j) cdf[j]--;
      } else {
        for (int j = i + 1; j <= best_steal; ++j) cdf[j]++;
      }
    }
  }

  if (cdf[0] != 0 || cdf[n] != (1u << precision)) return -3;
  for (int i = 0; i < n; ++i) {
    if (cdf[i + 1] <= cdf[i]) return -4;
  }
  return 0;
}

}  // extern "C"
