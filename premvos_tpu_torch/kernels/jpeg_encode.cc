// JPEG encoder for the port's synthetic-data writers: host code, built with
// the host C++ compiler and bound by ctypes (premvos_tpu_torch/io_compat/jpeg.py).
//
// It writes the bytes that Pillow's `Image.fromarray(rgb).save(f, "JPEG",
// quality=q)` writes for an RGB uint8 image. Pillow runs libjpeg-turbo (3.1)
// with its defaults, so this follows the same steps:
//   * markers (jcmarker.c): SOI; APP0 "JFIF" 1.01, density unit 0, density
//     1x1, no thumbnail; DQT of table 0, then DQT of table 1; SOF0 (8-bit,
//     component ids 1/2/3, sampling 2x2/1x1/1x1, quant tables 0/1/1); DHT
//     DC0, AC0, DC1, AC1 each in a marker of its own; SOS (Ss 0, Se 63,
//     Ah/Al 0); the entropy-coded data; EOI;
//   * jcparam.c's tables: the standard luminance and chrominance tables
//     scaled by jpeg_quality_scaling (5000/q below 50, 200 - 2q from 50),
//     each value (v·s + 50) / 100 clamped to 1..255 (force_baseline);
//   * jccolor.c's rgb_ycc_convert in 16-bit fixed point (SCALEBITS 16);
//   * jcsample.c's h2v2_downsample for Cb and Cr: (a + b + c + d + bias) >> 2
//     with the bias 1, 2, 1, 2, ... along a row, the right edge replicated
//     (expand_right_edge), the bottom edge replicated to the iMCU's height
//     (jcprepct.c): in effect every plane is read with its row and column
//     clamped to the image;
//   * jfdctint.c's jpeg_fdct_islow on samples - 128, and jcdctmgr.c's
//     quantisation by quantval << 3 through compute_reciprocal's
//     reciprocal, correction and shift, with the 16-bit DCTELEM of
//     libjpeg-turbo's SIMD build (its x86 SIMD code gives the same values);
//   * jccoefct.c's compress_data: a 4:2:0 MCU whose luminance blocks reach
//     past the image's blocks is filled with dummy blocks, AC zero and the
//     DC copied from the block before it in the MCU (the row above's last
//     block for a dummy bottom row);
//   * jchuff.c with the standard tables of jstdhuff.c: a DC difference per
//     component, ZRL and EOB, 0xFF stuffed with 0x00, the last byte padded
//     with 1-bits.
//
// C interface: premvos_jpeg_encode_bound gives a size the file never
// exceeds; premvos_jpeg_encode writes the file and returns its length, or
// -1 with a message in err.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kMaxDimension = 65500;  // JPEG_MAX_DIMENSION

// Zigzag position → natural (row-major) position.
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ITU T.81 Annex K, tables K.1 and K.2, in natural order (jcparam.c).
const int kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// ITU T.81 Annex K.3 (jstdhuff.c): code counts by length 1..16, then values.
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Failure {
  std::string msg;
};

// A Huffman table as jchuff.c's jpeg_make_c_derived_tbl derives it: code
// and length of each symbol.
struct Huff {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  uint16_t code[256];
  uint8_t size[256];

  Huff(const uint8_t* b, const uint8_t* v, int n) : bits(b), vals(v), nvals(n) {
    memset(size, 0, sizeof(size));
    uint32_t c = 0;
    int p = 0;
    for (int len = 1; len <= 16; len++) {
      for (int i = 0; i < bits[len - 1]; i++, p++) {
        code[vals[p]] = (uint16_t)c++;
        size[vals[p]] = (uint8_t)len;
      }
      c <<= 1;
    }
  }
};

// jcdctmgr.c's divisors for the ISLOW DCT: compute_reciprocal of
// quantval << 3 with a 16-bit DCTELEM.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return Divisor{fq, c, r};
}

// jcparam.c's jpeg_add_quant_table at jpeg_quality_scaling(quality), with
// force_baseline: natural order.
void quant_table(const int* base, int quality, int* out) {
  long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long v = (base[i] * scale + 50) / 100;
    out[i] = (int)(v < 1 ? 1 : v > 255 ? 255 : v);
  }
}

// jfdctint.c's jpeg_fdct_islow (CONST_BITS 13, PASS1_BITS 2): in place,
// the output scaled up by 8.
const int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270,
              F_0_899 = 7373, F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137,
              F_1_961 = 16069, F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

void fdct_islow(int32_t* d) {
  const int cb = 13, p1 = 2;
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8, next = pass == 0 ? 8 : 1;
    const int odd_shift = pass == 0 ? cb - p1 : cb + p1;
    int32_t* p = d;
    for (int ctr = 0; ctr < 8; ctr++, p += next) {
      int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int32_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int32_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        p[0] = (tmp10 + tmp11) * (1 << p1);
        p[4 * step] = (tmp10 - tmp11) * (1 << p1);
      } else {
        p[0] = descale(tmp10 + tmp11, p1);
        p[4 * step] = descale(tmp10 - tmp11, p1);
      }
      int32_t z1 = (tmp12 + tmp13) * F_0_541;
      p[2 * step] = descale(z1 + tmp13 * F_0_765, odd_shift);
      p[6 * step] = descale(z1 - tmp12 * F_1_847, odd_shift);

      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * F_1_175;
      tmp4 *= F_0_298;
      tmp5 *= F_2_053;
      tmp6 *= F_3_072;
      tmp7 *= F_1_501;
      z1 *= -F_0_899;
      z2 *= -F_2_562;
      z3 = z3 * -F_1_961 + z5;
      z4 = z4 * -F_0_390 + z5;
      p[7 * step] = descale(tmp4 + z1 + z3, odd_shift);
      p[5 * step] = descale(tmp5 + z2 + z4, odd_shift);
      p[3 * step] = descale(tmp6 + z2 + z3, odd_shift);
      p[step] = descale(tmp7 + z1 + z4, odd_shift);
    }
  }
}

// The bytes of the file, with jchuff.c's bit buffer: codes packed MSB
// first, each 0xFF byte of entropy-coded data followed by 0x00.
class Writer {
 public:
  Writer(uint8_t* out, int64_t cap) : out_(out), cap_(cap) {}

  void byte(int b) {
    if (n_ >= cap_) throw Failure{"output larger than its bound"};
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
  void bits(uint32_t value, int n) {  // n <= 16
    acc_ = (acc_ << n) | (value & ((1u << n) - 1));
    nacc_ += n;
    while (nacc_ >= 8) {
      nacc_ -= 8;
      int b = (int)((acc_ >> nacc_) & 0xFF);
      byte(b);
      if (b == 0xFF) byte(0);
    }
  }
  void flush() {  // the partial byte filled with ones
    if (nacc_ > 0) bits(0x7F, 8 - nacc_);
    acc_ = 0;
    nacc_ = 0;
  }
  int64_t size() const { return n_; }

 private:
  uint8_t* out_;
  int64_t cap_, n_ = 0;
  uint64_t acc_ = 0;
  int nacc_ = 0;
};

int nbits(int v) { return v == 0 ? 0 : 32 - __builtin_clz((uint32_t)v); }

// One quantised block (natural order) through jchuff.c's encode_one_block.
void encode_block(Writer& w, const int16_t* coef, int* last_dc, const Huff& dc, const Huff& ac) {
  int diff = coef[0] - *last_dc;
  *last_dc = coef[0];
  int mag = diff < 0 ? -diff : diff, n = nbits(mag);
  w.bits(dc.code[n], dc.size[n]);
  if (n) w.bits(diff < 0 ? ~mag : mag, n);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int v = coef[kNatural[k]];
    if (v == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    mag = v < 0 ? -v : v;
    n = nbits(mag);
    int sym = (run << 4) | n;
    w.bits(ac.code[sym], ac.size[sym]);
    w.bits(v < 0 ? ~mag : mag, n);
    run = 0;
  }
  if (run > 0) w.bits(ac.code[0], ac.size[0]);
}

// One 8x8 block of `plane` (stride `stride`, at row y, column x): level
// shift, DCT, quantisation (forward_DCT in jcdctmgr.c).
void forward_block(const uint8_t* plane, int stride, int y, int x, const Divisor* div,
                   int16_t* coef) {
  int32_t ws[64];
  for (int r = 0; r < 8; r++) {
    const uint8_t* row = plane + (int64_t)(y + r) * stride + x;
    for (int c = 0; c < 8; c++) ws[r * 8 + c] = (int32_t)row[c] - 128;
  }
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    int32_t t = ws[i];
    uint32_t a = (uint32_t)(t < 0 ? -t : t);
    int32_t q = (int32_t)(((a + div[i].corr) * div[i].recip) >> div[i].shift);
    coef[i] = (int16_t)(t < 0 ? -q : q);
  }
}

void write_dqt(Writer& w, int index, const int* table) {
  w.marker(0xDB);
  w.word(67);
  w.byte(index);
  for (int k = 0; k < 64; k++) w.byte(table[kNatural[k]]);
}

void write_dht(Writer& w, int index, const Huff& h) {
  w.marker(0xC4);
  w.word(2 + 1 + 16 + h.nvals);
  w.byte(index);
  for (int i = 0; i < 16; i++) w.byte(h.bits[i]);
  for (int i = 0; i < h.nvals; i++) w.byte(h.vals[i]);
}

int64_t encode(const uint8_t* rgb, int height, int width, int quality, uint8_t* out,
               int64_t cap) {
  if (height < 1 || width < 1 || height > kMaxDimension || width > kMaxDimension)
    throw Failure{"image size " + std::to_string(height) + "x" + std::to_string(width) +
                  " outside 1..65500"};
  if (quality < 1 || quality > 100)
    throw Failure{"quality " + std::to_string(quality) + " outside 1..100"};
  const int h = height, w = width;

  // Colour conversion (jccolor.c rgb_ycc_convert).
  const int32_t kHalf = 1 << 15, kCenter = 128 << 16;
#define FIX(x) ((int32_t)((x) * (1L << 16) + 0.5))
  std::vector<uint8_t> ycc[3];
  for (auto& p : ycc) p.resize((size_t)h * w);
  for (int64_t i = 0; i < (int64_t)h * w; i++) {
    int32_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    ycc[0][i] = (uint8_t)((FIX(0.29900) * r + FIX(0.58700) * g + FIX(0.11400) * b + kHalf) >> 16);
    ycc[1][i] = (uint8_t)((-FIX(0.16874) * r - FIX(0.33126) * g + FIX(0.50000) * b + kCenter +
                           kHalf - 1) >> 16);
    ycc[2][i] = (uint8_t)((FIX(0.50000) * r - FIX(0.41869) * g - FIX(0.08131) * b + kCenter +
                           kHalf - 1) >> 16);
  }
#undef FIX

  // Planes at their block-padded sizes, edges replicated (jcprepct.c,
  // jcsample.c): luma ceil(h/8)·8 × ceil(w/8)·8 (fullsize_downsample),
  // chroma ceil(h/16)·8 × ceil(w/16)·8 (h2v2_downsample).
  const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  const int lbw = (w + 7) / 8, lbh = (h + 7) / 8;
  const int lw = lbw * 8, lh = lbh * 8, cw = mcux * 8, ch = mcuy * 8;
  std::vector<uint8_t> luma((size_t)lh * lw), chroma[2];
  for (int y = 0; y < lh; y++) {
    const uint8_t* src = &ycc[0][(size_t)(y < h ? y : h - 1) * w];
    uint8_t* dst = &luma[(size_t)y * lw];
    memcpy(dst, src, w);
    memset(dst + w, src[w - 1], lw - w);
  }
  const int crows = (h + 1) / 2;  // downsampled rows from real rows
  for (int ci = 0; ci < 2; ci++) {
    const uint8_t* p = ycc[ci + 1].data();
    chroma[ci].resize((size_t)ch * cw);
    for (int y = 0; y < ch; y++) {
      uint8_t* dst = &chroma[ci][(size_t)y * cw];
      if (y >= crows) {
        memcpy(dst, &chroma[ci][(size_t)(crows - 1) * cw], cw);
        continue;
      }
      const uint8_t* r0 = p + (size_t)(2 * y) * w;
      const uint8_t* r1 = p + (size_t)(2 * y + 1 < h ? 2 * y + 1 : h - 1) * w;
      for (int x = 0; x < cw; x++) {
        int x0 = 2 * x < w ? 2 * x : w - 1, x1 = 2 * x + 1 < w ? 2 * x + 1 : w - 1;
        dst[x] = (uint8_t)((r0[x0] + r0[x1] + r1[x0] + r1[x1] + 1 + (x & 1)) >> 2);
      }
    }
  }

  int qt[2][64];
  quant_table(kLumQuant, quality, qt[0]);
  quant_table(kChromQuant, quality, qt[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) div[t][i] = reciprocal((uint32_t)qt[t][i] << 3);
  const Huff dc_lum(kDcLumBits, kDcVals, 12), ac_lum(kAcLumBits, kAcLumVals, 162);
  const Huff dc_chrom(kDcChromBits, kDcVals, 12), ac_chrom(kAcChromBits, kAcChromVals, 162);

  Writer wr(out, cap);
  wr.marker(0xD8);
  wr.marker(0xE0);  // JFIF APP0
  wr.word(16);
  for (char c : {'J', 'F', 'I', 'F', '\0'}) wr.byte(c);
  wr.byte(1);
  wr.byte(1);
  wr.byte(0);
  wr.word(1);
  wr.word(1);
  wr.byte(0);
  wr.byte(0);
  write_dqt(wr, 0, qt[0]);
  write_dqt(wr, 1, qt[1]);
  wr.marker(0xC0);
  wr.word(17);
  wr.byte(8);
  wr.word(h);
  wr.word(w);
  wr.byte(3);
  const int comp[3][3] = {{1, 0x22, 0}, {2, 0x11, 1}, {3, 0x11, 1}};
  for (const auto& c : comp) {
    wr.byte(c[0]);
    wr.byte(c[1]);
    wr.byte(c[2]);
  }
  write_dht(wr, 0x00, dc_lum);
  write_dht(wr, 0x10, ac_lum);
  write_dht(wr, 0x01, dc_chrom);
  write_dht(wr, 0x11, ac_chrom);
  wr.marker(0xDA);
  wr.word(12);
  wr.byte(3);
  for (int c = 0; c < 3; c++) {
    wr.byte(c + 1);
    wr.byte(c == 0 ? 0x00 : 0x11);
  }
  wr.byte(0);
  wr.byte(63);
  wr.byte(0);

  int last_dc[3] = {0, 0, 0};
  int16_t blocks[6][64];
  for (int my = 0; my < mcuy; my++) {
    for (int mx = 0; mx < mcux; mx++) {
      // compress_data: the four luma blocks, then Cb and Cr.
      for (int yi = 0; yi < 2; yi++) {
        int by = 2 * my + yi;
        for (int xi = 0; xi < 2; xi++) {
          int bx = 2 * mx + xi, bn = 2 * yi + xi;
          if (by >= lbh) {  // a dummy row at the bottom
            memset(blocks[bn], 0, sizeof(blocks[bn]));
            blocks[bn][0] = blocks[2 * yi - 1][0];
          } else if (bx >= lbw) {  // a dummy block at the right
            memset(blocks[bn], 0, sizeof(blocks[bn]));
            blocks[bn][0] = blocks[bn - 1][0];
          } else {
            forward_block(luma.data(), lw, by * 8, bx * 8, div[0], blocks[bn]);
          }
        }
      }
      forward_block(chroma[0].data(), cw, my * 8, mx * 8, div[1], blocks[4]);
      forward_block(chroma[1].data(), cw, my * 8, mx * 8, div[1], blocks[5]);
      for (int bn = 0; bn < 4; bn++) encode_block(wr, blocks[bn], &last_dc[0], dc_lum, ac_lum);
      encode_block(wr, blocks[4], &last_dc[1], dc_chrom, ac_chrom);
      encode_block(wr, blocks[5], &last_dc[2], dc_chrom, ac_chrom);
    }
  }
  wr.flush();
  wr.marker(0xD9);
  return wr.size();
}

int64_t report(const Failure& f, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", f.msg.c_str());
  return -1;
}

}  // namespace

extern "C" {

// Bytes that the file of a height × width image never exceeds: at most
// 22 + 63·26 bits a block, doubled for byte stuffing, six blocks an MCU,
// and the markers.
int64_t premvos_jpeg_encode_bound(int height, int width) {
  int64_t mcus = (int64_t)((height + 15) / 16) * ((width + 15) / 16);
  return mcus * 6 * 416 + 1024;
}

// rgb holds height × width × 3 bytes (row-major RGB); out holds cap bytes.
// Returns the file's length, or -1 with a message in err.
int64_t premvos_jpeg_encode(const uint8_t* rgb, int height, int width, int quality,
                            uint8_t* out, int64_t cap, char* err, int errlen) {
  try {
    return encode(rgb, height, width, quality, out, cap);
  } catch (const Failure& f) {
    return report(f, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Failure{"out of memory"}, err, errlen);
  }
}

}  // extern "C"
