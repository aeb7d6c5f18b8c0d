// CRC32C (Castagnoli) with TFRecord's mask, for the port's record reader
// and writer. Host code, not a GPU kernel: g++ builds it into a shared
// library with a plain C interface, bound with ctypes
// (tensor2robot_tpu_torch/ops/_build.py, build_host).
//
// The same function as tensor2robot_tpu/data/_native/native_data.cc's
// table loop, computed eight bytes a step ("slicing-by-8"): table k holds
// the CRC of a byte followed by k zero bytes, so eight lookups fold eight
// input bytes at once. The byte-at-a-time loop finishes the tail.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

// Built at load time: ctypes calls drop the GIL, so a lazily built table
// would race between reader threads.
struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    const uint32_t poly = 0x82F63B78u;  // reflected Castagnoli
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k) {
        crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
      }
      t[0][i] = crc;
    }
    for (int k = 1; k < 8; ++k) {
      for (uint32_t i = 0; i < 256; ++i) {
        t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
      }
    }
  }
};
const CrcTables g_crc{};

uint32_t crc32c(const uint8_t* data, size_t len) {
  uint32_t crc = 0xFFFFFFFFu;
  const uint32_t (*t)[256] = g_crc.t;
  while (len >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data, 4);  // little-endian hosts only (x86/ARM)
    std::memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^
          t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
          t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
          t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  while (len--) {
    crc = t[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  }
  return crc ^ 0xFFFFFFFFu;
}

}  // namespace

extern "C" {

uint32_t t2r_crc32c(const uint8_t* data, uint64_t len) {
  return crc32c(data, static_cast<size_t>(len));
}

uint32_t t2r_masked_crc32c(const uint8_t* data, uint64_t len) {
  const uint32_t crc = crc32c(data, static_cast<size_t>(len));
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

}  // extern "C"
