// TFRecord reader/writer with CRC32C integrity checks, and the action codec.
//
// The torch port's own copy of bridgelang_tpu/native/src/tfrecord.cc (the
// same C interface and bytes): record framing for the native episode store
// without TensorFlow, streamed to Python through ctypes.
//
// TFRecord framing (the public format):
//   uint64 length | uint32 masked_crc32c(length) | bytes data | uint32 masked_crc32c(data)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <sys/types.h>
#include <vector>

namespace {

// --- CRC32C (Castagnoli), software table implementation ---
uint32_t crc32c_table[8][256];
bool crc32c_initialized = false;

void crc32c_init() {
  if (crc32c_initialized) return;
  const uint32_t poly = 0x82f63b78u;  // reflected CRC-32C polynomial
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int j = 0; j < 8; j++) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    crc32c_table[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = crc32c_table[0][i];
    for (int s = 1; s < 8; s++) {
      crc = crc32c_table[0][crc & 0xff] ^ (crc >> 8);
      crc32c_table[s][i] = crc;
    }
  }
  crc32c_initialized = true;
}

uint32_t crc32c(const uint8_t* data, size_t n, uint32_t crc = 0) {
  crc32c_init();
  crc = ~crc;
  // slice-by-8
  while (n >= 8) {
    crc ^= static_cast<uint32_t>(data[0]) | (static_cast<uint32_t>(data[1]) << 8) |
           (static_cast<uint32_t>(data[2]) << 16) | (static_cast<uint32_t>(data[3]) << 24);
    uint32_t hi = static_cast<uint32_t>(data[4]) | (static_cast<uint32_t>(data[5]) << 8) |
                  (static_cast<uint32_t>(data[6]) << 16) | (static_cast<uint32_t>(data[7]) << 24);
    crc = crc32c_table[7][crc & 0xff] ^ crc32c_table[6][(crc >> 8) & 0xff] ^
          crc32c_table[5][(crc >> 16) & 0xff] ^ crc32c_table[4][crc >> 24] ^
          crc32c_table[3][hi & 0xff] ^ crc32c_table[2][(hi >> 8) & 0xff] ^
          crc32c_table[1][(hi >> 16) & 0xff] ^ crc32c_table[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) crc = crc32c_table[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
  return ~crc;
}

uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

struct Reader {
  FILE* f = nullptr;
  std::vector<uint8_t> buf;
  bool check_crc = true;
};

struct Writer {
  FILE* f = nullptr;
};

}  // namespace

extern "C" {

// --- checksum utility ---
uint32_t blx_crc32c(const uint8_t* data, uint64_t n) { return crc32c(data, n); }

// --- reader ---
void* blx_reader_open(const char* path, int check_crc) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Reader();
  r->f = f;
  r->check_crc = check_crc != 0;
  return r;
}

// Returns 1 on success (record data/length in *out/*out_len, valid until the
// next call), 0 on clean EOF, -1 on corruption/IO error.
int blx_reader_next(void* handle, const uint8_t** out, int64_t* out_len) {
  auto* r = static_cast<Reader*>(handle);
  uint8_t header[12];
  size_t got = fread(header, 1, 12, r->f);
  if (got == 0) return 0;  // EOF
  if (got != 12) return -1;
  uint64_t len;
  uint32_t len_crc;
  memcpy(&len, header, 8);
  memcpy(&len_crc, header + 8, 4);
  if (r->check_crc && masked_crc(header, 8) != len_crc) return -1;
  if (len > (1ull << 34)) return -1;  // sanity: 16 GB record cap
  r->buf.resize(len + 4);
  if (fread(r->buf.data(), 1, len + 4, r->f) != len + 4) return -1;
  if (r->check_crc) {
    uint32_t data_crc;
    memcpy(&data_crc, r->buf.data() + len, 4);
    if (masked_crc(r->buf.data(), len) != data_crc) return -1;
  }
  *out = r->buf.data();
  *out_len = static_cast<int64_t>(len);
  return 1;
}

// Position the reader at byte `offset` (the start of a record); 0 on success.
int blx_reader_seek(void* handle, int64_t offset) {
  auto* r = static_cast<Reader*>(handle);
  return fseeko(r->f, static_cast<off_t>(offset), SEEK_SET) == 0 ? 0 : -1;
}

void blx_reader_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (r->f) fclose(r->f);
  delete r;
}

// Count records + verify integrity; returns count or -1 on corruption.
int64_t blx_count_records(const char* path, int check_crc) {
  void* h = blx_reader_open(path, check_crc);
  if (!h) return -1;
  int64_t count = 0, len = 0;
  const uint8_t* data;
  int status;
  while ((status = blx_reader_next(h, &data, &len)) > 0) count++;
  blx_reader_close(h);
  return status < 0 ? -1 : count;
}

// --- writer ---
void* blx_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  return w;
}

int blx_writer_write(void* handle, const uint8_t* data, uint64_t len) {
  auto* w = static_cast<Writer*>(handle);
  uint8_t header[12];
  memcpy(header, &len, 8);
  uint32_t len_crc = masked_crc(header, 8);
  memcpy(header + 8, &len_crc, 4);
  uint32_t data_crc = masked_crc(data, len);
  if (fwrite(header, 1, 12, w->f) != 12) return -1;
  if (fwrite(data, 1, len, w->f) != len) return -1;
  if (fwrite(&data_crc, 1, 4, w->f) != 4) return -1;
  return 0;
}

void blx_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  if (w->f) fclose(w->f);
  delete w;
}

// --- action codec: uniform 256-bin tokenization (serving hot path) ---
// token_id = vocab_size - digitize(clip(a, -1, 1), linspace(-1, 1, n_bins))
void blx_actions_to_tokens(const float* actions, int64_t n, int32_t n_bins,
                           int32_t vocab_size, int32_t* out) {
  const double lo = -1.0, hi = 1.0;
  const double width = (hi - lo) / (n_bins - 1);
  for (int64_t i = 0; i < n; i++) {
    double a = actions[i];
    if (a < lo) a = lo;
    if (a > hi) a = hi;
    // np.digitize(right=false): index of first edge > a, edges inclusive of lo
    int32_t idx = static_cast<int32_t>((a - lo) / width) + 1;
    if (a >= hi) idx = n_bins;
    if (idx > n_bins) idx = n_bins;
    out[i] = vocab_size - idx;
  }
}

void blx_tokens_to_actions(const int32_t* tokens, int64_t n, int32_t n_bins,
                           int32_t vocab_size, float* out) {
  const double lo = -1.0, hi = 1.0;
  const double width = (hi - lo) / (n_bins - 1);
  for (int64_t i = 0; i < n; i++) {
    int32_t disc = vocab_size - tokens[i] - 1;
    if (disc < 0) disc = 0;
    if (disc > n_bins - 2) disc = n_bins - 2;
    // bin centers midway between consecutive edges
    out[i] = static_cast<float>(lo + width * disc + width / 2.0);
  }
}

}  // extern "C"
