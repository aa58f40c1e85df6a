// Baseline JPEG encoding for the OCR-VQA conversion (preprocessing/
// download.py): the bytes Pillow 12.1 writes for an RGB image with
// Image.save(path, "JPEG") and no options, which is libjpeg-turbo (API 6.2)
// with Pillow's defaults: quality 75 (the standard tables scaled by 50 %,
// kept within 1-255), 4:2:0 (luma 2x2, chroma 1x1), the accurate integer
// forward DCT (JDCT_ISLOW), the standard Huffman tables, no optimization, no
// restart interval. Every step is integer arithmetic, so the stream is
// reproduced exactly:
//   * markers in libjpeg's order: SOI, the JFIF APP0 (version 1.01, density
//     1:1, unit 0), a COM marker when a comment is given (Pillow writes the
//     image's `comment` right after the file header), DQT 0 and 1, SOF0,
//     DHT DC 0, AC 0, DC 1, AC 1, SOS, the entropy-coded data, EOI;
//   * jccolor.c's fixed-point RGB -> YCbCr (16 fractional bits, the Cb and
//     Cr offsets rounded down by ONE_HALF - 1);
//   * the edges as jcprepct.c and jcsample.c pad them: the last column and
//     row replicated out to the blocks (luma) or to twice the blocks
//     (chroma, before downsampling), the last downsampled row to the MCU;
//   * jcsample.c's h2v2 downsampling: the mean of each 2x2 square with a
//     bias of 1, 2, 1, 2, ... along the row;
//   * jfdctint.c's forward DCT (13-bit constants, 2 pass bits) on samples
//     minus 128, and jcdctmgr.c's quantization: round(x / (8 q)) with halves
//     away from zero, which libjpeg-turbo's reciprocal multiply reproduces
//     for every 16-bit x;
//   * jccoefct.c's dummy blocks where an MCU runs past the luma blocks:
//     zero AC and the DC of the block before them;
//   * jchuff.c's coding: DC differences per component, AC runs with ZRL and
//     EOB, 0xFF stuffed with 0x00, the last byte padded with one bits.
//
// C interface (ctypes):
//   int64_t blx_jpeg_encode(rgb, height, width, comment, comment_len, out, cap)
//     rgb: [height, width, 3] uint8. Returns the JPEG's length in `out`, or
//     -1 on bad arguments (an empty image, a comment over 65533 bytes), -2
//     when `cap` bytes are not enough.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kNatural[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                          12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                          35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                          58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// JPEG Annex K.1 and K.3, natural order.
const uint8_t kStdLuminance[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChrominance[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
    99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
const uint8_t kDcLuminanceBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrominanceBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLuminanceBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125};
const uint8_t kAcLuminanceVals[162] = {
    1,   2,   3,   0,   4,   17,  5,   18,  33,  49,  65,  6,   19,  81,  97,  7,   34,  113, 20,  50,  129,
    145, 161, 8,   35,  66,  177, 193, 21,  82,  209, 240, 36,  51,  98,  114, 130, 9,   10,  22,  23,  24,
    25,  26,  37,  38,  39,  40,  41,  42,  52,  53,  54,  55,  56,  57,  58,  67,  68,  69,  70,  71,  72,
    73,  74,  83,  84,  85,  86,  87,  88,  89,  90,  99,  100, 101, 102, 103, 104, 105, 106, 115, 116, 117,
    118, 119, 120, 121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151, 152, 153,
    154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195,
    196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218, 225, 226, 227, 228, 229,
    230, 231, 232, 233, 234, 241, 242, 243, 244, 245, 246, 247, 248, 249, 250};
const uint8_t kAcChrominanceBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119};
const uint8_t kAcChrominanceVals[162] = {
    0,   1,   2,   3,   17,  4,   5,   33,  49,  6,   18,  65,  81,  7,   97,  113, 19,  34,  50,  129, 8,
    20,  66,  145, 161, 177, 193, 9,   35,  51,  82,  240, 21,  98,  114, 209, 10,  22,  36,  52,  225, 37,
    241, 23,  24,  25,  26,  38,  39,  40,  41,  42,  53,  54,  55,  56,  57,  58,  67,  68,  69,  70,  71,
    72,  73,  74,  83,  84,  85,  86,  87,  88,  89,  90,  99,  100, 101, 102, 103, 104, 105, 106, 115, 116,
    117, 118, 119, 120, 121, 122, 130, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151,
    152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186,
    194, 195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218, 226, 227, 228,
    229, 230, 231, 232, 233, 234, 242, 243, 244, 245, 246, 247, 248, 249, 250};

constexpr int kQuality = 75;

// jcparam.c jpeg_quality_scaling + jpeg_add_quant_table (force_baseline).
void scaled_table(const uint8_t* base, uint16_t* out) {
  const int scale = kQuality < 50 ? 5000 / kQuality : 200 - kQuality * 2;
  for (int i = 0; i < 64; ++i) {
    long v = ((long)base[i] * scale + 50L) / 100L;
    out[i] = (uint16_t)(v < 1 ? 1 : (v > 255 ? 255 : v));
  }
}

struct Huffman {
  uint16_t code[256];
  uint8_t size[256];
};

// Canonical codes from the (bits, vals) lists (jchuff.c jpeg_make_c_derived_tbl).
Huffman make_huffman(const uint8_t* bits, const uint8_t* vals) {
  Huffman h;
  std::memset(h.size, 0, sizeof(h.size));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
      h.code[vals[k]] = (uint16_t)code;
      h.size[vals[k]] = (uint8_t)len;
    }
    code <<= 1;
  }
  return h;
}

class Output {
 public:
  Output(uint8_t* out, int64_t cap) : out_(out), cap_(cap) {}
  bool ok() const { return ok_; }
  int64_t size() const { return n_; }

  void byte(int b) {
    if (n_ >= cap_) {
      ok_ = false;
      return;
    }
    out_[n_++] = (uint8_t)b;
  }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xFF);
  }
  void marker(int m) {
    byte(0xFF);
    byte(m);
  }

  // Entropy-coded bits, MSB first; a 0xFF byte is followed by a stuffed 0x00.
  void bits(uint32_t value, int len) {
    acc_ = (acc_ << len) | (value & ((1u << len) - 1));
    have_ += len;
    while (have_ >= 8) {
      const int b = (int)((acc_ >> (have_ - 8)) & 0xFF);
      byte(b);
      if (b == 0xFF) byte(0);
      have_ -= 8;
    }
    acc_ &= (1u << have_) - 1;
  }
  void flush_bits() {  // pad the partial byte with ones (jchuff.c flush_bits)
    if (have_ > 0) bits(0x7F, 8 - have_);
    acc_ = 0;
  }

 private:
  uint8_t* out_;
  int64_t cap_, n_ = 0;
  bool ok_ = true;
  uint64_t acc_ = 0;
  int have_ = 0;
};

// jccolor.c rgb_ycc_convert's tables.
constexpr int kScaleBits = 16;
constexpr int32_t kHalf = 1 << (kScaleBits - 1);
constexpr int32_t kCbCrOffset = 128 << kScaleBits;
constexpr int32_t fix(double x) { return (int32_t)(x * (1L << kScaleBits) + 0.5); }

void rgb_to_ycc(const uint8_t* rgb, int64_t n, uint8_t* y, uint8_t* cb, uint8_t* cr) {
  static int32_t tab[8][256];
  static bool ready = false;
  if (!ready) {
    for (int i = 0; i < 256; ++i) {
      tab[0][i] = fix(0.29900) * i;
      tab[1][i] = fix(0.58700) * i;
      tab[2][i] = fix(0.11400) * i + kHalf;
      tab[3][i] = -fix(0.16874) * i;
      tab[4][i] = -fix(0.33126) * i;
      tab[5][i] = fix(0.50000) * i + kCbCrOffset + kHalf - 1;  // B -> Cb and R -> Cr
      tab[6][i] = -fix(0.41869) * i;
      tab[7][i] = -fix(0.08131) * i;
    }
    ready = true;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    y[i] = (uint8_t)((tab[0][r] + tab[1][g] + tab[2][b]) >> kScaleBits);
    cb[i] = (uint8_t)((tab[3][r] + tab[4][g] + tab[5][b]) >> kScaleBits);
    cr[i] = (uint8_t)((tab[5][r] + tab[6][g] + tab[7][b]) >> kScaleBits);
  }
}

// jfdctint.c jpeg_fdct_islow: in place, outputs scaled up by 8.
constexpr int kConstBits = 13, kPass1Bits = 2;
inline int32_t descale(int64_t x, int n) { return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n); }

void fdct_islow(int32_t* d) {
  const int64_t c0298 = 2446, c0390 = 3196, c0541 = 4433, c0765 = 6270, c0899 = 7373, c1175 = 9633,
                c1501 = 12299, c1847 = 15137, c1961 = 16069, c2053 = 16819, c2562 = 20995, c3072 = 25172;
  for (int pass = 0; pass < 2; ++pass) {
    const int stride = pass == 0 ? 1 : 8, step = pass == 0 ? 8 : 1;
    const int even_shift = pass == 0 ? 0 : kPass1Bits;  // pass 1 shifts left, pass 2 descales
    const int odd_shift = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
    for (int line = 0; line < 8; ++line) {
      int32_t* p = d + line * step;
      const int64_t tmp0 = p[0] + p[7 * stride], tmp7 = p[0] - p[7 * stride];
      const int64_t tmp1 = p[stride] + p[6 * stride], tmp6 = p[stride] - p[6 * stride];
      const int64_t tmp2 = p[2 * stride] + p[5 * stride], tmp5 = p[2 * stride] - p[5 * stride];
      const int64_t tmp3 = p[3 * stride] + p[4 * stride], tmp4 = p[3 * stride] - p[4 * stride];
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        p[0] = (int32_t)((tmp10 + tmp11) << kPass1Bits);
        p[4 * stride] = (int32_t)((tmp10 - tmp11) << kPass1Bits);
      } else {
        p[0] = descale(tmp10 + tmp11, even_shift);
        p[4 * stride] = descale(tmp10 - tmp11, even_shift);
      }
      int64_t z1 = (tmp12 + tmp13) * c0541;
      p[2 * stride] = descale(z1 + tmp13 * c0765, odd_shift);
      p[6 * stride] = descale(z1 - tmp12 * c1847, odd_shift);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int64_t z5 = (z3 + z4) * c1175;
      const int64_t t4 = tmp4 * c0298, t5 = tmp5 * c2053, t6 = tmp6 * c3072, t7 = tmp7 * c1501;
      z1 *= -c0899;
      z2 *= -c2562;
      z3 = z3 * -c1961 + z5;
      z4 = z4 * -c0390 + z5;
      p[7 * stride] = descale(t4 + z1 + z3, odd_shift);
      p[5 * stride] = descale(t5 + z2 + z4, odd_shift);
      p[3 * stride] = descale(t6 + z2 + z3, odd_shift);
      p[stride] = descale(t7 + z1 + z4, odd_shift);
    }
  }
}

// One 8x8 block of `plane` (row stride `stride`) at (row, col): level shift,
// forward DCT, quantization by 8 q (natural order).
void block_coefficients(const uint8_t* plane, int stride, int row, int col, const uint16_t* q, int32_t* coef) {
  int32_t d[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) d[r * 8 + c] = (int32_t)plane[(int64_t)(row + r) * stride + col + c] - 128;
  fdct_islow(d);
  for (int i = 0; i < 64; ++i) {
    const int32_t div = (int32_t)q[i] << 3;
    const int32_t t = d[i] < 0 ? -d[i] : d[i];
    const int32_t v = (t + (div >> 1)) / div;
    coef[i] = d[i] < 0 ? -v : v;
  }
}

int nbits(int v) {
  int n = 0;
  for (; v; v >>= 1) ++n;
  return n;
}

void encode_block(const int32_t* coef, int32_t& last_dc, const Huffman& dc, const Huffman& ac, Output& out) {
  int diff = coef[0] - last_dc;
  last_dc = coef[0];
  int mag = diff < 0 ? -diff : diff, n = nbits(mag);
  out.bits(dc.code[n], dc.size[n]);
  if (n) out.bits((uint32_t)(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = coef[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    for (; run > 15; run -= 16) out.bits(ac.code[0xF0], ac.size[0xF0]);
    mag = v < 0 ? -v : v;
    n = nbits(mag);
    const int sym = (run << 4) + n;
    out.bits(ac.code[sym], ac.size[sym]);
    out.bits((uint32_t)(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run > 0) out.bits(ac.code[0], ac.size[0]);
}

void write_dht(Output& out, int klass_id, const uint8_t* bits, const uint8_t* vals) {
  int count = 0;
  for (int i = 0; i < 16; ++i) count += bits[i];
  out.marker(0xC4);
  out.word(2 + 1 + 16 + count);
  out.byte(klass_id);
  for (int i = 0; i < 16; ++i) out.byte(bits[i]);
  for (int i = 0; i < count; ++i) out.byte(vals[i]);
}

}  // namespace

extern "C" int64_t blx_jpeg_encode(const uint8_t* rgb, int height, int width, const uint8_t* comment,
                                   int64_t comment_len, uint8_t* dst, int64_t cap) {
  if (height <= 0 || width <= 0 || height > 65535 || width > 65535 || comment_len < 0 || comment_len > 65533)
    return -1;
  uint16_t qtab[2][64];
  scaled_table(kStdLuminance, qtab[0]);
  scaled_table(kStdChrominance, qtab[1]);
  Output out(dst, cap);

  // Headers.
  out.marker(0xD8);
  static const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  out.marker(0xE0);
  out.word(16);
  for (uint8_t b : jfif) out.byte(b);
  if (comment_len > 0) {
    out.marker(0xFE);
    out.word((int)(2 + comment_len));
    for (int64_t i = 0; i < comment_len; ++i) out.byte(comment[i]);
  }
  for (int t = 0; t < 2; ++t) {
    out.marker(0xDB);
    out.word(67);
    out.byte(t);
    for (int i = 0; i < 64; ++i) out.byte(qtab[t][kNatural[i]]);
  }
  out.marker(0xC0);
  out.word(17);
  out.byte(8);
  out.word(height);
  out.word(width);
  out.byte(3);
  const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  for (uint8_t b : comps) out.byte(b);
  write_dht(out, 0x00, kDcLuminanceBits, kDcVals);
  write_dht(out, 0x10, kAcLuminanceBits, kAcLuminanceVals);
  write_dht(out, 0x01, kDcChrominanceBits, kDcVals);
  write_dht(out, 0x11, kAcChrominanceBits, kAcChrominanceVals);
  out.marker(0xDA);
  out.word(12);
  const uint8_t scan[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  for (uint8_t b : scan) out.byte(b);

  // Planes, padded as libjpeg pads them.
  const int yw = (width + 7) / 8, yh = (height + 7) / 8;  // luma blocks
  const int cw = (width + 15) / 16, ch = (height + 15) / 16;  // chroma blocks = MCUs
  const int py_w = yw * 8, py_h = ch * 16;  // luma plane (rows out to the MCU)
  const int pc_w = cw * 16;  // full-resolution chroma row before downsampling
  const int dc_w = cw * 8, dc_h = ch * 8;  // downsampled chroma
  const int64_t npix = (int64_t)height * width;
  std::vector<uint8_t> y(npix), cb(npix), cr(npix);
  rgb_to_ycc(rgb, npix, y.data(), cb.data(), cr.data());

  std::vector<uint8_t> luma((int64_t)py_w * py_h);
  for (int r = 0; r < py_h; ++r) {
    const uint8_t* src = y.data() + (int64_t)(r < height ? r : height - 1) * width;
    uint8_t* row = luma.data() + (int64_t)r * py_w;
    std::memcpy(row, src, width);
    std::memset(row + width, src[width - 1], py_w - width);
  }
  std::vector<uint8_t> chroma[2];
  const int down_rows = (height + 1) / 2;  // downsampled rows with image data
  std::vector<uint8_t> full((int64_t)pc_w * 2);
  for (int c = 0; c < 2; ++c) {
    const uint8_t* plane = c == 0 ? cb.data() : cr.data();
    chroma[c].assign((int64_t)dc_w * dc_h, 0);
    for (int r = 0; r < dc_h; ++r) {
      uint8_t* o = chroma[c].data() + (int64_t)r * dc_w;
      if (r >= down_rows) {  // the last downsampled row, out to the MCU
        std::memcpy(o, o - dc_w, dc_w);
        continue;
      }
      for (int k = 0; k < 2; ++k) {  // the row pair, the last image row repeated past the bottom
        const int src_row = 2 * r + k < height ? 2 * r + k : height - 1;
        const uint8_t* src = plane + (int64_t)src_row * width;
        uint8_t* f = full.data() + (int64_t)k * pc_w;
        std::memcpy(f, src, width);
        std::memset(f + width, src[width - 1], pc_w - width);
      }
      int bias = 1;
      for (int x = 0; x < dc_w; ++x) {
        o[x] = (uint8_t)((full[2 * x] + full[2 * x + 1] + full[pc_w + 2 * x] + full[pc_w + 2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }

  // MCUs: 2x2 luma blocks, then Cb, then Cr.
  const Huffman dc0 = make_huffman(kDcLuminanceBits, kDcVals), ac0 = make_huffman(kAcLuminanceBits, kAcLuminanceVals);
  const Huffman dc1 = make_huffman(kDcChrominanceBits, kDcVals),
                ac1 = make_huffman(kAcChrominanceBits, kAcChrominanceVals);
  int32_t last_dc[3] = {0, 0, 0};
  int32_t coef[4][64], ccoef[64];
  for (int my = 0; my < ch; ++my) {
    for (int mx = 0; mx < cw; ++mx) {
      for (int b = 0; b < 4; ++b) {
        const int by = 2 * my + b / 2, bx = 2 * mx + b % 2;
        if (by >= yh) {  // a dummy row: the DC of the last block of the row above, in this MCU
          std::memset(coef[b], 0, sizeof(coef[b]));
          coef[b][0] = coef[1][0];
        } else if (bx >= yw) {  // a dummy column: the DC of the block to its left
          std::memset(coef[b], 0, sizeof(coef[b]));
          coef[b][0] = coef[b - 1][0];
        } else {
          block_coefficients(luma.data(), py_w, by * 8, bx * 8, qtab[0], coef[b]);
        }
        encode_block(coef[b], last_dc[0], dc0, ac0, out);
      }
      for (int c = 0; c < 2; ++c) {
        block_coefficients(chroma[c].data(), dc_w, my * 8, mx * 8, qtab[1], ccoef);
        encode_block(ccoef, last_dc[1 + c], dc1, ac1, out);
      }
    }
  }
  out.flush_bits();
  out.marker(0xD9);
  return out.ok() ? out.size() : -2;
}
