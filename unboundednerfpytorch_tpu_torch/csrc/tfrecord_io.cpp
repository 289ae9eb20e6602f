// TFRecord framing with masked-crc32c validation, on the host.
//
// The port's copy of the JAX package's native/tfrecord_io.cpp: built with
// the host's C++ compiler into build/host/ at first use and loaded with
// ctypes by unboundednerfpytorch_tpu_torch/data/tfrecord.py. Python's
// per-byte table CRC runs at some 5 MB/s; this slicing-by-8 one at 1-2 GB/s.
//
// Record layout (TFRecord spec):
//   u64 little-endian payload length
//   u32 masked crc32c of the length bytes
//   payload
//   u32 masked crc32c of the payload
//
// tfr_split_records returns the number of records found, writing each
// payload's (offset, length) into the caller's arrays. Each fault has a code
// of its own, so that the caller raises the Python framing's error:
// -1 a truncated header, -4 a truncated payload, -3 a length crc mismatch,
// -5 a payload crc mismatch (the crcs only when verify_crc != 0), -2 more
// records than max_records.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;  // Castagnoli, reflected
constexpr uint32_t kMaskDelta = 0xA282EAD8u;

struct Crc8Tables {
  uint32_t t[8][256];
  Crc8Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int j = 1; j < 8; ++j)
        t[j][i] = (t[j - 1][i] >> 8) ^ t[0][t[j - 1][i] & 0xFF];
  }
};

const Crc8Tables& tables() {
  static const Crc8Tables kTables;
  return kTables;
}

uint32_t crc32c(const uint8_t* data, size_t len) {
  const Crc8Tables& tb = tables();
  uint32_t crc = 0xFFFFFFFFu;
  // slicing-by-8 over aligned middle
  while (len >= 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    word ^= crc;  // little-endian host assumed (x86/arm64)
    crc = tb.t[7][word & 0xFF] ^ tb.t[6][(word >> 8) & 0xFF] ^
          tb.t[5][(word >> 16) & 0xFF] ^ tb.t[4][(word >> 24) & 0xFF] ^
          tb.t[3][(word >> 32) & 0xFF] ^ tb.t[2][(word >> 40) & 0xFF] ^
          tb.t[1][(word >> 48) & 0xFF] ^ tb.t[0][(word >> 56) & 0xFF];
    data += 8;
    len -= 8;
  }
  while (len--) crc = tb.t[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked_crc(const uint8_t* data, size_t len) {
  uint32_t crc = crc32c(data, len);
  return ((crc >> 15) | (crc << 17)) + kMaskDelta;
}

uint64_t load_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian host
}

uint32_t load_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

}  // namespace

extern "C" long long tfr_split_records(
    const uint8_t* buf, size_t len, uint64_t* offsets, uint64_t* lengths,
    size_t max_records, int verify_crc) {
  size_t pos = 0, n = 0;
  while (pos < len) {
    if (pos + 12 > len) return -1;
    uint64_t rec_len = load_u64(buf + pos);
    if (verify_crc && masked_crc(buf + pos, 8) != load_u32(buf + pos + 8))
      return -3;
    size_t start = pos + 12;
    // subtraction form: `start + rec_len + 4 > len` wraps for huge corrupt
    // rec_len (e.g. 2^64-8) and would pass, then the payload crc reads out
    // of bounds. start <= len already holds (pos + 12 check above).
    if (rec_len > len - start || len - start - rec_len < 4) return -4;
    if (verify_crc &&
        masked_crc(buf + start, rec_len) != load_u32(buf + start + rec_len))
      return -5;
    if (n >= max_records) return -2;
    offsets[n] = start;
    lengths[n] = rec_len;
    ++n;
    pos = start + rec_len + 4;
  }
  return static_cast<long long>(n);
}
