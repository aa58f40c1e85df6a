// GIF image-data decoding for the OCR-VQA conversion (preprocessing/
// download.py): the palette indices of a GIF frame as Pillow's GIF decoder
// (Pillow 12.1, GifDecode.c) gives them. native/image.py parses the file's
// blocks (screen, palettes, extensions, the first image descriptor) and
// hands this the frame's LZW stream; it lays the frame on the canvas and
// maps the indices through the palette as Pillow's convert("RGB") does.
//
// LZW as GIF writes it: codes packed LSB first, `min_code_size` (1-11) from
// the stream's first byte, clear = 1 << min_code_size, end = clear + 1,
// codes starting one bit wider than min_code_size and growing by a bit each
// time the table's next free entry reaches 1 << width, up to 12 bits. A full
// table (4096 entries) adds nothing more until the next clear code, which
// resets the width and the table. Interlaced frames arrive in four passes
// (rows 0, 8, 16, ...; 4, 12, ...; 2, 6, ...; 1, 3, ...) and are written
// back in display order.
//
// C interface (ctypes):
//   int64_t blx_gif_lzw(data, n, min_code_size, width, height, interlace, out)
//     data: the frame's data sub-blocks joined (their length bytes dropped);
//     out: [height, width] uint8 indices, rows in display order. Returns the
//     number of pixels decoded: all of them, or fewer where an end code
//     comes first (the rest of `out` is left as it was). -1: a code the
//     table does not hold yet; -2: min_code_size outside 1-11; -3: the
//     stream ends before the end code and before the frame is full.

#include <cstdint>

namespace {

constexpr int kMaxBits = 12;
constexpr int kTable = 1 << kMaxBits;

class Pixels {
 public:
  Pixels(uint8_t* out, int width, int height, bool interlace)
      : out_(out), width_(width), height_(height), interlace_(interlace) {}

  bool full() const { return row_ >= height_; }
  int64_t count() const { return count_; }

  void put(uint8_t v) {
    if (full()) return;
    out_[(int64_t)row_ * width_ + col_] = v;
    ++count_;
    if (++col_ < width_) return;
    col_ = 0;
    next_row();
  }

 private:
  void next_row() {
    if (!interlace_) {
      ++row_;
      return;
    }
    static const int start[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
    row_ += step[pass_];
    while (row_ >= height_ && pass_ < 3) {
      ++pass_;
      row_ = start[pass_];
    }
  }

  uint8_t* out_;
  int width_, height_;
  bool interlace_;
  int row_ = 0, col_ = 0, pass_ = 0;
  int64_t count_ = 0;
};

}  // namespace

extern "C" int64_t blx_gif_lzw(const uint8_t* data, int64_t n, int min_code_size, int width, int height,
                               int interlace, uint8_t* out) {
  if (min_code_size < 1 || min_code_size > kMaxBits - 1) return -2;
  Pixels px(out, width, height, interlace != 0);
  if (width <= 0 || height <= 0) return 0;
  static thread_local uint16_t prefix[kTable];
  static thread_local uint8_t suffix[kTable], first[kTable], stack[kTable];
  const int clear = 1 << min_code_size, end = clear + 1;
  for (int c = 0; c < clear; ++c) {
    prefix[c] = 0;
    suffix[c] = first[c] = (uint8_t)c;
  }
  int bits = min_code_size + 1, next = clear + 2, prev = -1;
  uint32_t acc = 0;
  int have = 0;
  int64_t pos = 0;
  while (!px.full()) {
    while (have < bits) {
      if (pos >= n) return -3;
      acc |= (uint32_t)data[pos++] << have;
      have += 8;
    }
    const int code = (int)(acc & ((1u << bits) - 1));
    acc >>= bits;
    have -= bits;
    if (code == clear) {
      bits = min_code_size + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if (code == end) break;
    if (prev < 0) {  // the first code after a clear: a single index
      if (code >= clear) return -1;
      px.put((uint8_t)code);
      prev = code;
      continue;
    }
    if (code > next || (code == next && next >= kTable)) return -1;
    // The string of `code` (of `prev` plus its first index when code == next), pushed reversed.
    int sp = 0, c = code;
    if (code == next) {
      stack[sp++] = first[prev];
      c = prev;
    }
    while (c >= clear) {
      stack[sp++] = suffix[c];
      c = prefix[c];
    }
    stack[sp++] = (uint8_t)c;
    if (next < kTable) {
      prefix[next] = (uint16_t)prev;
      suffix[next] = (uint8_t)c;
      first[next] = first[prev];
      ++next;
      if (next == (1 << bits) && bits < kMaxBits) ++bits;
    }
    while (sp > 0) px.put(stack[--sp]);
    prev = code;
  }
  return px.count();
}
