// JPEG decoding, PNG row unfiltering and PIL's bicubic resize for the data
// pipelines, without libjpeg, libpng or PIL: what
// tf.io.decode_image(x, expand_animations=False) gives on the frames of RLDS
// datasets, and what PIL's Image.open(p).convert("RGB").resize(size) gives
// on the images of VLM pretraining, bit for bit.
//
// TensorFlow decodes JPEG through libjpeg-turbo with its defaults for
// decode_image: the fast integer IDCT (JDCT_IFAST, jidctfst.c), "fancy"
// (triangle) upsampling of subsampled chroma (jdsample.c: h2v1, h2v2 and
// h1v2; the box filter where libjpeg-turbo falls back to it), and the
// fixed-point YCbCr->RGB tables of jdcolor.c. This file follows those
// routines' integer arithmetic; libjpeg-turbo's SIMD versions of them are
// built to give the same bytes, and where the two part ways (out-of-range
// IDCT output on corrupt data) the saturating SIMD clamp is the one kept.
// PIL (and tf.io.decode_jpeg(dct_method="INTEGER_ACCURATE")) decode with
// the accurate integer IDCT instead (JDCT_ISLOW, jidctint.c), selected per
// call; everything else is shared.
//
// Supported: baseline and extended sequential Huffman (SOF0, SOF1) and
// progressive Huffman (SOF2) JPEGs, 8-bit samples, 1 or 3 components,
// integer sampling ratios, restart intervals. Arithmetic coding, 12-bit
// samples, lossless, hierarchical, CMYK and RGB (Adobe transform 0) files
// fail with a message naming the marker; so does a corrupt or cut stream.
//
// C interface (ctypes):
//   int blx_jpeg_decode(data, n, out, out_cap, hwc[3], accurate, err, err_len)
//     out == NULL (or too small): parse the header only, fill hwc, return 1;
//     else decode into out ([h, w, c] uint8) with the fast (accurate == 0)
//     or the accurate integer IDCT, return 0; -1 on error.
//   int blx_png_unfilter(raw, raw_len, height, rowbytes, bpp, out)
//     PNG filter types 0-4 undone row by row; 0, or -1 on a bad stream.
//   int blx_resize_bicubic_pil(in, h, w, c, out, out_h, out_w)
//     PIL's ImagingResample with its BICUBIC filter on [h, w, c] uint8 into
//     [out_h, out_w, c]; 0, or -1 on bad sizes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct DecodeError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError{msg}; }

// zigzag index -> natural (row-major) index; 16 extra entries absorb a
// run past coefficient 63 in a corrupt block, as libjpeg's table does.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jddctmgr.c: the AAN scale factors (natural order, scaled by 2^14) that
// fold into the dequantization multipliers of the fast IDCT.
const int16_t kAanScales[64] = {
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,  22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270,
    21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,  19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315,
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,  12873, 17855, 16819, 15137, 12873, 10114, 6967,  3552,
    8867,  12299, 11585, 10426, 8867,  6967,  4799,  2446,  4520,  6270,  5906,  5315,  4520,  3552,  2446,  1247};

struct Huffman {
  bool present = false;
  uint8_t counts[17] = {0};
  uint8_t symbols[256] = {0};
  int32_t mincode[17] = {0}, maxcode[18] = {0}, valptr[17] = {0};
  uint8_t look_len[256] = {0}, look_sym[256] = {0};  // 8-bit lookahead

  void build() {
    int code = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
      valptr[len] = k;
      mincode[len] = code;
      code += counts[len];
      k += counts[len];
      if (code >= (1 << len)) fail("corrupt JPEG: bad Huffman table (DHT)");  // no all-ones code
      maxcode[len] = counts[len] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look_len, 0, sizeof(look_len));
    code = 0;
    k = 0;
    for (int len = 1; len <= 8; len++, code <<= 1) {
      for (int i = 0; i < counts[len]; i++, k++, code++) {
        int look = code << (8 - len);
        for (int c = 0; c < (1 << (8 - len)); c++) {
          look_len[look + c] = static_cast<uint8_t>(len);
          look_sym[look + c] = symbols[k];
        }
      }
    }
  }
};

// Entropy-coded bits: 0xFF00 stuffing removed; a marker or the end of the
// data feeds zero bits, and reading any of them is an error (a cut stream).
struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t acc = 0;
  int n = 0;      // bits in acc
  int fake = 0;   // zero bits fed past a marker or the end (the low end of acc)
  bool at_marker = false;

  void fill() {
    while (n <= 56) {
      uint32_t byte = 0;
      if (!at_marker && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;
          if (q < end && *q == 0x00) {
            p = q + 1;
          } else {
            at_marker = true;  // p stays on the marker's 0xFF
            byte = 0;
            fake += 8;
          }
        } else {
          p++;
        }
      } else {
        fake += 8;
      }
      acc = (acc << 8) | byte;
      n += 8;
    }
  }

  void consume(int k) {
    n -= k;
    if (n < fake) fail(p >= end ? "truncated JPEG: the entropy-coded data ends early"
                                : "corrupt JPEG: the entropy-coded data ends early (premature marker)");
  }

  int bits(int k) {
    if (k == 0) return 0;
    if (n < k) fill();
    int v = static_cast<int>((acc >> (n - k)) & ((1u << k) - 1));
    consume(k);
    return v;
  }

  int decode(const Huffman& h) {
    if (n < 16) fill();
    int look = static_cast<int>((acc >> (n - 8)) & 0xFF);
    int len = h.look_len[look];
    if (len) {
      consume(len);
      return h.look_sym[look];
    }
    for (len = 9; len <= 16; len++) {
      int code = static_cast<int>((acc >> (n - len)) & ((1u << len) - 1));
      if (code <= h.maxcode[len]) {
        consume(len);
        return h.symbols[h.valptr[len] + code - h.mincode[len]];
      }
    }
    fail("corrupt JPEG: bad Huffman code");
  }

  // Drop the bits left in the byte-aligned buffer and move to the next
  // marker, skipping stray bytes as libjpeg does; returns the marker code.
  int next_marker() {
    acc = 0;
    n = fake = 0;
    at_marker = false;
    while (p < end) {
      if (*p == 0xFF) {
        const uint8_t* q = p + 1;
        while (q < end && *q == 0xFF) q++;
        if (q >= end) break;
        if (*q != 0x00) {
          p = q + 1;
          return *q;
        }
        p = q + 1;
      } else {
        p++;
      }
    }
    fail("truncated JPEG: no marker after the entropy-coded data");
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;                 // Huffman table selectors of the current scan
  int bw = 0, bh = 0;                 // blocks stored (the MCU grid)
  int ni_bw = 0, ni_bh = 0;           // blocks of a non-interleaved scan
  int dw = 0, dh = 0;                 // downsampled width and height in samples
  bool latched = false;
  int16_t mult[64] = {0};             // fast-IDCT dequantization multipliers (natural order)
  int16_t quant[64] = {0};            // accurate-IDCT multipliers: the quantization table (natural order)
  std::vector<int16_t> coef;          // bw * bh blocks of 64 coefficients (natural order)
  int dc_pred = 0;
};

struct Jpeg {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false, saw_sof = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int max_h = 1, max_v = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  uint16_t qt[4][64];                 // natural order
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];
  int eobrun = 0;

  Jpeg(const uint8_t* d, size_t n) : data(d), end(d + n), p(d) {}

  int u8() {
    if (p >= end) fail("truncated JPEG: the headers end early");
    return *p++;
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  static std::string marker_name(int m) {
    char buf[64];
    std::snprintf(buf, sizeof(buf), "marker 0xFF%02X", m);
    return buf;
  }

  int read_marker() {
    // Markers between segments: any 0xFF fill bytes, then the code.
    int c = u8();
    if (c != 0xFF) {
      // libjpeg skips garbage before a marker with a warning; stray bytes here
      // mean a corrupt stream.
      fail("corrupt JPEG: expected a marker, found byte " + std::to_string(c));
    }
    do c = u8();
    while (c == 0xFF);
    return c;
  }

  void skip_segment() {
    int len = u16();
    if (len < 2 || p + (len - 2) > end) fail("truncated JPEG: a segment runs past the end");
    p += len - 2;
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("corrupt JPEG: bad quantization table (DQT)");
      for (int i = 0; i < 64; i++) qt[tq][kNatural[i]] = static_cast<uint16_t>(pq ? u16() : u8());
      qt_present[tq] = true;
      len -= 1 + 64 * (pq + 1);
    }
    if (len != 0) fail("corrupt JPEG: bad DQT length");
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 0) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: bad Huffman table (DHT)");
      Huffman& h = tc ? ac[th] : dc[th];
      int total = 0;
      h.counts[0] = 0;
      for (int i = 1; i <= 16; i++) total += (h.counts[i] = static_cast<uint8_t>(u8()));
      if (total > 256 || total > len - 17) fail("corrupt JPEG: bad Huffman table (DHT)");
      for (int i = 0; i < total; i++) h.symbols[i] = static_cast<uint8_t>(u8());
      h.build();
      h.present = true;
      len -= 17 + total;
    }
    if (len != 0) fail("corrupt JPEG: bad DHT length");
  }

  void read_sof(int marker) {
    int len = u16();
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8)
      fail("unsupported JPEG: " + std::to_string(precision) + "-bit samples (" + marker_name(marker) + ")");
    if (ncomp == 4) fail("unsupported JPEG: 4 components (CMYK/YCCK) in " + marker_name(marker));
    if (ncomp != 1 && ncomp != 3)
      fail("unsupported JPEG: " + std::to_string(ncomp) + " components in " + marker_name(marker));
    if (len != 8 + 3 * ncomp) fail("corrupt JPEG: bad SOF length");
    if (height == 0) fail("unsupported JPEG: height 0 (DNL marker) in " + marker_name(marker));
    if (width == 0) fail("corrupt JPEG: width 0");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("corrupt JPEG: bad sampling factors or table");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    mcux = (width + 8 * max_h - 1) / (8 * max_h);
    mcuy = (height + 8 * max_v - 1) / (8 * max_v);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (max_h % c.h || max_v % c.v)
        fail("unsupported JPEG: fractional sampling ratio (" + marker_name(marker) + ")");
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + max_h - 1) / max_h);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + max_v - 1) / max_v);
      c.ni_bw = (c.dw + 7) / 8;
      c.ni_bh = (c.dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
    }
    saw_sof = true;
  }

  int channels() const { return ncomp; }

  // Parse up to the frame header (or, with `full`, decode every scan).
  void run(bool full) {
    if (end - data < 3 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG stream (no SOI marker)");
    p = data + 2;
    bool allocated = false;
    for (;;) {
      int m = read_marker();
      if (m == 0xD8) fail("corrupt JPEG: a second SOI marker");
      if (m == 0xD9) {
        if (!full) fail("corrupt JPEG: EOI before the frame header");
        return;
      }
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          if (saw_sof) fail("corrupt JPEG: a second frame header");
          progressive = (m == 0xC2);
          read_sof(m);
          if (!full) {
            check_color();
            return;
          }
          check_color();
          break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7:
          fail("unsupported JPEG: lossless or hierarchical coding (" + marker_name(m) + ")");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          fail("unsupported JPEG: arithmetic coding (" + marker_name(m) + ")");
        case 0xCC:
          fail("unsupported JPEG: arithmetic coding conditioning table (" + marker_name(m) + ")");
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD: {
          int len = u16();
          if (len != 4) fail("corrupt JPEG: bad DRI length");
          restart_interval = u16();
          break;
        }
        case 0xDC:
          fail("unsupported JPEG: DNL marker (" + marker_name(m) + ")");
        case 0xDA: {
          if (!saw_sof) fail("corrupt JPEG: scan before the frame header");
          if (!allocated) {
            for (int i = 0; i < ncomp; i++)
              comp[i].coef.assign(static_cast<size_t>(comp[i].bw) * comp[i].bh * 64, 0);
            allocated = true;
          }
          read_scan();
          break;
        }
        case 0xE0:
          read_app0();
          break;
        case 0xEE:
          read_app14();
          break;
        default:
          if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || (m >= 0xF0 && m <= 0xFD)) {
            skip_segment();
          } else if (m >= 0xD0 && m <= 0xD7) {
            fail("corrupt JPEG: restart marker outside a scan");
          } else {
            fail("corrupt JPEG: unexpected " + marker_name(m));
          }
      }
    }
  }

  void read_app0() {
    int len = u16();
    if (len < 2 || p + (len - 2) > end) fail("truncated JPEG: a segment runs past the end");
    if (len >= 7 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
    p += len - 2;
  }

  void read_app14() {
    int len = u16();
    if (len < 2 || p + (len - 2) > end) fail("truncated JPEG: a segment runs past the end");
    if (len >= 14 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    p += len - 2;
  }

  // libjpeg's guess of the colour space of a 3-component file (jdapimin.c).
  void check_color() {
    if (ncomp != 3) return;
    if (jfif) return;
    if (adobe) {
      if (adobe_transform == 0) fail("unsupported JPEG: RGB colour (Adobe APP14 marker 0xFFEE, transform 0)");
      return;
    }
    if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66)
      fail("unsupported JPEG: RGB colour (component ids 'R', 'G', 'B')");
    if (comp[0].id == 114 && comp[1].id == 103 && comp[2].id == 98)
      fail("unsupported JPEG: big-gamut YCC colour (component ids 'r', 'g', 'b')");
  }

  void latch(Component& c) {
    if (c.latched) return;
    if (!qt_present[c.tq]) fail("corrupt JPEG: a component's quantization table is missing");
    for (int i = 0; i < 64; i++) {
      // DESCALE(quantval * aanscale, CONST_BITS - IFAST_SCALE_BITS) = 14 - 2
      int32_t x = static_cast<int32_t>(qt[c.tq][i]) * kAanScales[i];
      c.mult[i] = static_cast<int16_t>((x + (1 << 11)) >> 12);
      c.quant[i] = static_cast<int16_t>(qt[c.tq][i]);  // ISLOW_MULT_TYPE is a short
    }
    c.latched = true;
  }

  void read_scan() {
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail("corrupt JPEG: bad SOS header");
    Component* sc[4];
    for (int i = 0; i < ns; i++) {
      int cid = u8(), tables = u8();
      int k = -1;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == cid) k = j;
      if (k < 0) fail("corrupt JPEG: a scan names an unknown component");
      sc[i] = &comp[k];
      sc[i]->td = tables >> 4;
      sc[i]->ta = tables & 15;
      if (sc[i]->td > 3 || sc[i]->ta > 3) fail("corrupt JPEG: bad Huffman table selector");
    }
    int ss = u8(), se = u8(), ahal = u8();
    int ah = ahal >> 4, al = ahal & 15;
    if (progressive) {
      bool bad = ss > 63 || se < ss || se > 63 || ah > 13 || al > 13;
      if (ss == 0 && se != 0) bad = true;
      if (ss != 0 && ns != 1) bad = true;
      if (bad) fail("corrupt JPEG: bad progression parameters");
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      // libjpeg only warns here; the values do not change sequential decoding
    }
    for (int i = 0; i < ns; i++) {
      latch(*sc[i]);
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss != 0;
      if (need_dc && !dc[sc[i]->td].present) fail("corrupt JPEG: a scan's DC Huffman table is missing");
      if (need_ac && !ac[sc[i]->ta].present) fail("corrupt JPEG: a scan's AC Huffman table is missing");
      sc[i]->dc_pred = 0;
    }
    eobrun = 0;

    BitReader br;
    br.p = p;
    br.end = end;
    const bool interleaved = ns > 1;
    const int units_x = interleaved ? mcux : sc[0]->ni_bw;
    const int units_y = interleaved ? mcuy : sc[0]->ni_bh;
    const int64_t total = static_cast<int64_t>(units_x) * units_y;
    int restarts_left = restart_interval, next_rst = 0;
    for (int64_t u = 0; u < total; u++) {
      if (restart_interval) {
        if (restarts_left == 0) {
          int m = br.next_marker();
          if (m != 0xD0 + next_rst) fail("corrupt JPEG: expected restart marker RST" + std::to_string(next_rst) +
                                         ", found " + marker_name(m));
          next_rst = (next_rst + 1) & 7;
          restarts_left = restart_interval;
          for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
          eobrun = 0;
        }
        restarts_left--;
      }
      const int ux = static_cast<int>(u % units_x), uy = static_cast<int>(u / units_x);
      if (interleaved) {
        for (int i = 0; i < ns; i++) {
          Component& c = *sc[i];
          for (int by = 0; by < c.v; by++)
            for (int bx = 0; bx < c.h; bx++) {
              int16_t* blk = &c.coef[(static_cast<size_t>(uy * c.v + by) * c.bw + ux * c.h + bx) * 64];
              decode_block(br, c, blk, ss, se, ah, al);
            }
        }
      } else {
        Component& c = *sc[0];
        int16_t* blk = &c.coef[(static_cast<size_t>(uy) * c.bw + ux) * 64];
        decode_block(br, c, blk, ss, se, ah, al);
      }
    }
    // The scan's end: on to the next marker (leave p on its 0xFF).
    br.next_marker();
    p = br.p - 2;
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk, int ss, int se, int ah, int al) {
    if (!progressive) {
      int s = br.decode(dc[c.td]);
      if (s) {
        if (s > 16) fail("corrupt JPEG: bad DC coefficient size");
        s = extend(br.bits(s), s);
      }
      c.dc_pred += s;
      blk[0] = static_cast<int16_t>(c.dc_pred);
      const Huffman& h = ac[c.ta];
      for (int k = 1; k < 64; k++) {
        int rs = br.decode(h);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans
      if (ah == 0) {
        int s = br.decode(dc[c.td]);
        if (s) {
          if (s > 16) fail("corrupt JPEG: bad DC coefficient size");
          s = extend(br.bits(s), s);
        }
        c.dc_pred += s;
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.dc_pred) << al);
      } else if (br.bits(1)) {
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      }
      return;
    }
    const Huffman& h = ac[c.ta];
    if (ah == 0) {  // AC first pass
      if (eobrun > 0) {
        eobrun--;
        return;
      }
      for (int k = ss; k <= se; k++) {
        int rs = br.decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(extend(br.bits(s), s)) << al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          eobrun--;
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bits(1) ? p1 : m1;  // a size other than 1 is corrupt; libjpeg decodes it the same way
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* t = &blk[kNatural[k]];
          if (*t != 0) {
            if (br.bits(1) && (*t & p1) == 0) *t = static_cast<int16_t>(*t >= 0 ? *t + p1 : *t + m1);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* t = &blk[kNatural[k]];
        if (*t != 0 && br.bits(1) && (*t & p1) == 0) *t = static_cast<int16_t>(*t >= 0 ? *t + p1 : *t + m1);
      }
      eobrun--;
    }
  }
};

// jidctfst.c (JDCT_IFAST): the AAN IDCT with 8-bit constants, products
// descaled by truncation, PASS1_BITS = 2 carried in the multipliers.
constexpr int kFix1_082 = 277, kFix1_414 = 362, kFix1_847 = 473, kFix2_613 = 669;
inline int mul8(int v, int c) { return (v * c) >> 8; }
inline uint8_t clamp_idct(int x) {  // IDESCALE(x, PASS1_BITS + 3), recentred, saturated
  x = (x >> 5) + 128;
  return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

void idct_ifast(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int col = 0; col < 8; col++) {
    const int16_t* ip = in + col;
    const int16_t* qp = q + col;
    int* wp = ws + col;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = ip[0] * qp[0];
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int tmp0 = ip[0] * qp[0], tmp1 = ip[16] * qp[16], tmp2 = ip[32] * qp[32], tmp3 = ip[48] * qp[48];
    int tmp10 = tmp0 + tmp2, tmp11 = tmp0 - tmp2;
    int tmp13 = tmp1 + tmp3;
    int tmp12 = mul8(tmp1 - tmp3, kFix1_414) - tmp13;
    tmp0 = tmp10 + tmp13;
    tmp3 = tmp10 - tmp13;
    tmp1 = tmp11 + tmp12;
    tmp2 = tmp11 - tmp12;
    int tmp4 = ip[8] * qp[8], tmp5 = ip[24] * qp[24], tmp6 = ip[40] * qp[40], tmp7 = ip[56] * qp[56];
    int z13 = tmp6 + tmp5, z10 = tmp6 - tmp5, z11 = tmp4 + tmp7, z12 = tmp4 - tmp7;
    tmp7 = z11 + z13;
    tmp11 = mul8(z11 - z13, kFix1_414);
    int z5 = mul8(z10 + z12, kFix1_847);
    tmp10 = mul8(z12, kFix1_082) - z5;
    tmp12 = mul8(z10, -kFix2_613) + z5;
    tmp6 = tmp12 - tmp7;
    tmp5 = tmp11 - tmp6;
    tmp4 = tmp10 + tmp5;
    wp[0] = tmp0 + tmp7;
    wp[56] = tmp0 - tmp7;
    wp[8] = tmp1 + tmp6;
    wp[48] = tmp1 - tmp6;
    wp[16] = tmp2 + tmp5;
    wp[40] = tmp2 - tmp5;
    wp[32] = tmp3 + tmp4;
    wp[24] = tmp3 - tmp4;
  }
  for (int row = 0; row < 8; row++) {
    const int* w = ws + 8 * row;
    uint8_t* op = out + static_cast<size_t>(row) * stride;
    int tmp10 = w[0] + w[4], tmp11 = w[0] - w[4];
    int tmp13 = w[2] + w[6];
    int tmp12 = mul8(w[2] - w[6], kFix1_414) - tmp13;
    int tmp0 = tmp10 + tmp13, tmp3 = tmp10 - tmp13, tmp1 = tmp11 + tmp12, tmp2 = tmp11 - tmp12;
    int z13 = w[5] + w[3], z10 = w[5] - w[3], z11 = w[1] + w[7], z12 = w[1] - w[7];
    int tmp7 = z11 + z13;
    tmp11 = mul8(z11 - z13, kFix1_414);
    int z5 = mul8(z10 + z12, kFix1_847);
    tmp10 = mul8(z12, kFix1_082) - z5;
    tmp12 = mul8(z10, -kFix2_613) + z5;
    int tmp6 = tmp12 - tmp7, tmp5 = tmp11 - tmp6, tmp4 = tmp10 + tmp5;
    op[0] = clamp_idct(tmp0 + tmp7);
    op[7] = clamp_idct(tmp0 - tmp7);
    op[1] = clamp_idct(tmp1 + tmp6);
    op[6] = clamp_idct(tmp1 - tmp6);
    op[2] = clamp_idct(tmp2 + tmp5);
    op[5] = clamp_idct(tmp2 - tmp5);
    op[4] = clamp_idct(tmp3 + tmp4);
    op[3] = clamp_idct(tmp3 - tmp4);
  }
}

// jidctint.c (JDCT_ISLOW): the LL&M IDCT with 13-bit constants, products
// rounded (DESCALE) after each pass, PASS1_BITS = 2 kept between them.
constexpr int64_t kF0_298 = 2446, kF0_390 = 3196, kF0_541 = 4433, kF0_765 = 6270, kF0_899 = 7373,
                  kF1_175 = 9633, kF1_501 = 12299, kF1_847 = 15137, kF1_961 = 16069, kF2_053 = 16819,
                  kF2_562 = 20995, kF3_072 = 25172;
constexpr int kConstBits = 13, kPass1Bits = 2;
inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }
inline uint8_t clamp_islow(int64_t x) {  // DESCALE(x, CONST_BITS + PASS1_BITS + 3), recentred, saturated
  x = descale(x, kConstBits + kPass1Bits + 3) + 128;
  return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

// One 1-D pass of jidctint.c on in[0], in[s], ..., in[7 s] (already
// dequantized): the even part from 0, 2, 4, 6, the odd part from 1, 3, 5, 7.
struct IslowOut {
  int64_t tmp10, tmp11, tmp12, tmp13, tmp0, tmp1, tmp2, tmp3;
};
inline IslowOut islow_1d(int64_t c0, int64_t c1, int64_t c2, int64_t c3, int64_t c4, int64_t c5, int64_t c6,
                         int64_t c7) {
  int64_t z1 = (c2 + c6) * kF0_541;
  int64_t tmp2 = z1 + c6 * -kF1_847;
  int64_t tmp3 = z1 + c2 * kF0_765;
  int64_t tmp0 = (c0 + c4) * (int64_t{1} << kConstBits);
  int64_t tmp1 = (c0 - c4) * (int64_t{1} << kConstBits);
  IslowOut o;
  o.tmp10 = tmp0 + tmp3;
  o.tmp13 = tmp0 - tmp3;
  o.tmp11 = tmp1 + tmp2;
  o.tmp12 = tmp1 - tmp2;
  tmp0 = c7;
  tmp1 = c5;
  tmp2 = c3;
  tmp3 = c1;
  z1 = tmp0 + tmp3;
  int64_t z2 = tmp1 + tmp2, z3 = tmp0 + tmp2, z4 = tmp1 + tmp3;
  int64_t z5 = (z3 + z4) * kF1_175;
  tmp0 *= kF0_298;
  tmp1 *= kF2_053;
  tmp2 *= kF3_072;
  tmp3 *= kF1_501;
  z1 *= -kF0_899;
  z2 *= -kF2_562;
  z3 *= -kF1_961;
  z4 *= -kF0_390;
  z3 += z5;
  z4 += z5;
  o.tmp0 = tmp0 + z1 + z3;
  o.tmp1 = tmp1 + z2 + z4;
  o.tmp2 = tmp2 + z2 + z3;
  o.tmp3 = tmp3 + z1 + z4;
  return o;
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int col = 0; col < 8; col++) {
    const int16_t* ip = in + col;
    const int16_t* qp = q + col;
    int* wp = ws + col;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t d[8];
    for (int r = 0; r < 8; r++) d[r] = static_cast<int64_t>(ip[8 * r]) * qp[8 * r];
    IslowOut o = islow_1d(d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7]);
    const int n = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(o.tmp10 + o.tmp3, n));
    wp[56] = static_cast<int>(descale(o.tmp10 - o.tmp3, n));
    wp[8] = static_cast<int>(descale(o.tmp11 + o.tmp2, n));
    wp[48] = static_cast<int>(descale(o.tmp11 - o.tmp2, n));
    wp[16] = static_cast<int>(descale(o.tmp12 + o.tmp1, n));
    wp[40] = static_cast<int>(descale(o.tmp12 - o.tmp1, n));
    wp[24] = static_cast<int>(descale(o.tmp13 + o.tmp0, n));
    wp[32] = static_cast<int>(descale(o.tmp13 - o.tmp0, n));
  }
  for (int row = 0; row < 8; row++) {
    const int* w = ws + 8 * row;
    uint8_t* op = out + static_cast<size_t>(row) * stride;
    // A row of zero AC terms takes DESCALE(w[0], PASS1_BITS + 3): the same
    // value the full pass gives, so no special case is needed.
    IslowOut o = islow_1d(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7]);
    op[0] = clamp_islow(o.tmp10 + o.tmp3);
    op[7] = clamp_islow(o.tmp10 - o.tmp3);
    op[1] = clamp_islow(o.tmp11 + o.tmp2);
    op[6] = clamp_islow(o.tmp11 - o.tmp2);
    op[2] = clamp_islow(o.tmp12 + o.tmp1);
    op[5] = clamp_islow(o.tmp12 - o.tmp1);
    op[3] = clamp_islow(o.tmp13 + o.tmp0);
    op[4] = clamp_islow(o.tmp13 - o.tmp0);
  }
}

// One component's samples at full resolution: IDCT of every block, then
// jdsample.c's upsampler for its ratio. Rows and columns past the
// downsampled size repeat the last real one (jdmainct.c's context rows).
std::vector<uint8_t> component_plane(const Component& c, int max_h, int max_v, int width, int height,
                                     bool accurate) {
  const int pw = c.bw * 8, ph = c.bh * 8;
  std::vector<uint8_t> plane(static_cast<size_t>(pw) * ph);
  for (int by = 0; by < c.bh; by++)
    for (int bx = 0; bx < c.bw; bx++) {
      const int16_t* blk = &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64];
      uint8_t* dst = &plane[static_cast<size_t>(by) * 8 * pw + bx * 8];
      if (accurate)
        idct_islow(blk, c.quant, dst, pw);
      else
        idct_ifast(blk, c.mult, dst, pw);
    }
  const int hx = max_h / c.h, vx = max_v / c.v;
  if (hx == 1 && vx == 1) {
    std::vector<uint8_t> out(static_cast<size_t>(width) * height);
    for (int y = 0; y < height; y++) std::memcpy(&out[static_cast<size_t>(y) * width], &plane[static_cast<size_t>(y) * pw], width);
    return out;
  }
  const int dw = c.dw, dh = c.dh;
  const int ow = dw * hx;  // output columns before the crop to `width`
  std::vector<uint8_t> out(static_cast<size_t>(width) * height);
  std::vector<uint8_t> row(ow + 2);
  auto in_row = [&](int r) -> const uint8_t* {
    r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
    return &plane[static_cast<size_t>(r) * pw];
  };
  auto emit = [&](int y, const uint8_t* src) {
    if (y < height) std::memcpy(&out[static_cast<size_t>(y) * width], src, width);
  };
  if (hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int r = 0; r < dh && r < height; r++) {
      const uint8_t* in = in_row(r);
      uint8_t* o = row.data();
      int v = in[0];
      *o++ = static_cast<uint8_t>(v);
      *o++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        v = in[x] * 3;
        *o++ = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
        *o++ = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
      }
      v = in[dw - 1];
      *o++ = static_cast<uint8_t>((v * 3 + in[dw - 2] + 1) >> 2);
      *o++ = static_cast<uint8_t>(v);
      emit(r, row.data());
    }
    return out;
  }
  if (hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy_upsample
    for (int r = 0; r < dh && 2 * r < height; r++) {
      for (int half = 0; half < 2; half++) {
        const uint8_t* in0 = in_row(r);
        const uint8_t* in1 = in_row(half == 0 ? r - 1 : r + 1);
        uint8_t* o = row.data();
        int this_sum = in0[0] * 3 + in1[0], next_sum = in0[1] * 3 + in1[1], last_sum;
        *o++ = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 2; x < dw; x++) {
          next_sum = in0[x] * 3 + in1[x];
          *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
        emit(2 * r + half, row.data());
      }
    }
    return out;
  }
  if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample (libjpeg-turbo 2.0+)
    for (int r = 0; r < dh && 2 * r < height; r++) {
      for (int half = 0; half < 2; half++) {
        const uint8_t* in0 = in_row(r);
        const uint8_t* in1 = in_row(half == 0 ? r - 1 : r + 1);
        const int bias = half == 0 ? 1 : 2;
        for (int x = 0; x < dw; x++) row[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
        emit(2 * r + half, row.data());
      }
    }
    return out;
  }
  // int_upsample / h2v1_upsample / h2v2_upsample: replicate each sample.
  for (int r = 0; r < dh && r * vx < height; r++) {
    const uint8_t* in = in_row(r);
    for (int x = 0; x < dw; x++)
      for (int k = 0; k < hx; k++) row[x * hx + k] = in[x];
    for (int k = 0; k < vx; k++) emit(r * vx + k, row.data());
  }
  return out;
}

// jdcolor.c build_ycc_rgb_table: SCALEBITS 16, ONE_HALF rounding.
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    auto fix = [](double x) { return static_cast<int32_t>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      int x = i - 128;
      cr_r[i] = (fix(1.40200) * x + 32768) >> 16;
      cb_b[i] = (fix(1.77200) * x + 32768) >> 16;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + 32768;
    }
  }
};

void decode_jpeg(const uint8_t* data, size_t n, uint8_t* out, bool accurate) {
  Jpeg j(data, n);
  j.run(true);
  for (int i = 0; i < j.ncomp; i++)
    if (!j.comp[i].latched) fail("truncated JPEG: a component has no scan");
  const int w = j.width, h = j.height;
  if (j.ncomp == 1) {
    std::vector<uint8_t> y = component_plane(j.comp[0], j.max_h, j.max_v, w, h, accurate);
    std::memcpy(out, y.data(), y.size());
    return;
  }
  std::vector<uint8_t> planes[3];
  for (int i = 0; i < 3; i++) planes[i] = component_plane(j.comp[i], j.max_h, j.max_v, w, h, accurate);
  static const YccTables t;  // built once, thread-safely (decodes may run in parallel threads)
  auto lim = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  const size_t npx = static_cast<size_t>(w) * h;
  const uint8_t *Y = planes[0].data(), *Cb = planes[1].data(), *Cr = planes[2].data();
  for (size_t i = 0; i < npx; i++) {
    int y = Y[i], cb = Cb[i], cr = Cr[i];
    out[3 * i] = lim(y + t.cr_r[cr]);
    out[3 * i + 1] = lim(y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
    out[3 * i + 2] = lim(y + t.cb_b[cb]);
  }
}

// PIL's libImaging/Resample.c for 8-bit bands with the BICUBIC filter
// (a = -0.5, support 2 scaled by the downscale factor): coefficients in
// double, normalised, rounded to fixed point with PRECISION_BITS = 22; the
// horizontal pass first, into an 8-bit image of only the rows the vertical
// pass reads; each sum starts at half a unit and is clipped by clip8.
constexpr int kPrecisionBits = 32 - 8 - 2;

double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

inline uint8_t clip8(int in) {  // PIL's lookup table: 128 zeros, 0..255, 128 times 255
  int v = in >> kPrecisionBits;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// precompute_coeffs + normalize_coeffs_8bpc: for each output index its first
// input index, its tap count, and ksize fixed-point taps.
int resample_coeffs(int in_size, float in0, float in1, int out_size, std::vector<int>& bounds,
                    std::vector<int32_t>& kk) {
  double scale = static_cast<double>(in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  std::vector<double> k(static_cast<size_t>(out_size) * ksize, 0.0);
  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0, ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* kp = &k[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; x++) {
      double w = bicubic_filter((x + xmin - center + 0.5) * ss);
      kp[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++)
      if (ww != 0.0) kp[x] /= ww;
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  kk.resize(k.size());
  for (size_t i = 0; i < k.size(); i++)
    kk[i] = static_cast<int32_t>(k[i] < 0 ? -0.5 + k[i] * (1 << kPrecisionBits) : 0.5 + k[i] * (1 << kPrecisionBits));
  return ksize;
}

void set_error(char* err, int err_len, const std::string& msg) {
  if (err && err_len > 0) {
    std::snprintf(err, static_cast<size_t>(err_len), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

int blx_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_cap, int32_t* hwc, int32_t accurate,
                    char* err, int err_len) {
  try {
    Jpeg header(data, static_cast<size_t>(n));
    header.run(false);
    hwc[0] = header.height;
    hwc[1] = header.width;
    hwc[2] = header.channels();
    const int64_t need = static_cast<int64_t>(hwc[0]) * hwc[1] * hwc[2];
    if (out == nullptr || out_cap < need) return 1;
    decode_jpeg(data, static_cast<size_t>(n), out, accurate != 0);
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, err_len, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, err_len, "JPEG too large to decode (out of memory)");
  }
  return -1;
}

// PNG: `raw` holds `height` rows of 1 filter byte + `rowbytes` bytes;
// `bpp` is the filter's byte distance (bytes per complete pixel, at least 1).
int blx_png_unfilter(const uint8_t* raw, int64_t raw_len, int32_t height, int64_t rowbytes, int32_t bpp,
                     uint8_t* out) {
  if (raw_len != static_cast<int64_t>(height) * (rowbytes + 1) || bpp < 1) return -1;
  const uint8_t* prev = nullptr;
  for (int32_t y = 0; y < height; y++) {
    const uint8_t* in = raw + static_cast<int64_t>(y) * (rowbytes + 1);
    const int filter = in[0];
    in++;
    uint8_t* o = out + static_cast<int64_t>(y) * rowbytes;
    switch (filter) {
      case 0:
        std::memcpy(o, in, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; i++) o[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; i++) o[i] = static_cast<uint8_t>(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? o[i - bpp] : 0, b = prev ? prev[i] : 0;
          o[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? o[i - bpp] : 0, b = prev ? prev[i] : 0, c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          int p = a + b - c, pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return -1;
    }
    prev = o;
  }
  return 0;
}

// PIL's ImagingResampleInner: a pass runs only where its size changes.
int blx_resize_bicubic_pil(const uint8_t* in, int32_t h, int32_t w, int32_t c, uint8_t* out, int32_t out_h,
                           int32_t out_w) {
  if (h < 1 || w < 1 || c < 1 || out_h < 1 || out_w < 1) return -1;
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  const int ksh = resample_coeffs(w, 0.0f, static_cast<float>(w), out_w, bh, kh);
  const int ksv = resample_coeffs(h, 0.0f, static_cast<float>(h), out_h, bv, kv);
  const bool need_h = out_w != w, need_v = out_h != h;
  const int y_first = bv[0], y_last = bv[(out_h - 1) * 2] + bv[(out_h - 1) * 2 + 1];
  const uint8_t* src = in;
  int src_h = h, src_w = w, row0 = 0;
  std::vector<uint8_t> tmp;
  if (need_h) {
    const int th = need_v ? y_last - y_first : h;
    row0 = need_v ? y_first : 0;
    tmp.resize(static_cast<size_t>(th) * out_w * c);
    for (int y = 0; y < th; y++) {
      const uint8_t* srow = in + (static_cast<size_t>(y) + row0) * w * c;
      uint8_t* drow = &tmp[static_cast<size_t>(y) * out_w * c];
      for (int xx = 0; xx < out_w; xx++) {
        const int xmin = bh[xx * 2], xmax = bh[xx * 2 + 1];
        const int32_t* k = &kh[static_cast<size_t>(xx) * ksh];
        for (int ch = 0; ch < c; ch++) {
          int ss = 1 << (kPrecisionBits - 1);
          for (int x = 0; x < xmax; x++) ss += srow[(x + xmin) * c + ch] * k[x];
          drow[xx * c + ch] = clip8(ss);
        }
      }
    }
    src = tmp.data();
    src_h = th;
    src_w = out_w;
  }
  if (!need_v) {
    std::memcpy(out, src, static_cast<size_t>(src_h) * src_w * c);
    return 0;
  }
  const int shift = need_h ? y_first : 0;  // the vertical bounds index the rows the horizontal pass kept
  for (int yy = 0; yy < out_h; yy++) {
    const int ymin = bv[yy * 2] - shift, ymax = bv[yy * 2 + 1];
    const int32_t* k = &kv[static_cast<size_t>(yy) * ksv];
    uint8_t* drow = out + static_cast<size_t>(yy) * src_w * c;
    for (int xx = 0; xx < src_w * c; xx++) {
      int ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; y++) ss += src[(static_cast<size_t>(y) + ymin) * src_w * c + xx] * k[y];
      drow[xx] = clip8(ss);
    }
  }
  return 0;
}

}  // extern "C"
