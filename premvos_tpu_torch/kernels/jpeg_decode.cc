// JPEG decoder for the port's frame readers: host code, built with the host
// C++ compiler and bound by ctypes (premvos_tpu_torch/io_compat/jpeg.py).
//
// It returns what Pillow's `Image.open(p).convert("RGB")` returns, bit for
// bit. Pillow runs libjpeg-turbo with its defaults, so this follows the same
// arithmetic:
//   * Huffman-coded baseline, extended sequential and progressive JPEG,
//     8-bit samples, 1 (gray), 3 or 4 components, any integral sampling
//     factors, restart intervals;
//   * dequantisation and the ISLOW integer IDCT of jidctint.c (CONST_BITS
//     13, PASS1_BITS 2), its output clamped to 0..255 as the SIMD version
//     does;
//   * fancy (triangle) upsampling of jdsample.c for h2v1, h2v2 and h1v2
//     (box replication for h2v1 and h2v2 at downsampled widths of 2 or
//     less, and for other integral factors), with the edge rows and
//     columns replicated as libjpeg's context rows are;
//   * jdcolor.c's fixed-point YCbCr → RGB tables (SCALEBITS 16) with range
//     limiting; an RGB-coded file (Adobe transform 0, or component ids
//     'R', 'G', 'B') is copied; gray is replicated into R, G and B;
//   * four components as libjpeg reads them: CMYK (no Adobe marker, or
//     Adobe transform 0) as it is, YCCK (any other Adobe transform) through
//     jdcolor.c's ycck_cmyk_convert; then Pillow's own steps: its "CMYK;I"
//     raw mode inverts every sample (Adobe's polarity, assumed for every
//     CMYK JPEG), and its convert("RGB") takes
//     R = clip(nk - (c·nk + 128 + ((c·nk + 128) >> 8)) >> 8), nk = 255 - k.
// Arithmetic coding, 12-bit samples, lossless and hierarchical JPEG, and a
// progressive file whose scans leave coefficients 0-9 unrefined (libjpeg
// would smooth its blocks) are refused with a message naming the feature.
//
// C interface: premvos_jpeg_info reads the header (height, width,
// components); premvos_jpeg_decode writes height × width × 3 bytes of RGB.
// Both return 0, or 1 with a message in err.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // Overrun guard, as libjpeg's jpeg_natural_order: a corrupt run past
    // 63 writes coefficient 63.
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Failure {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Failure{msg}; }

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int maxcode[18];
  int valoffset[18];
  // Codes of up to kLook bits: (length << 8) | symbol, 0 if longer.
  static const int kLook = 9;
  uint16_t look[1 << kLook];

  void build(const uint8_t bits[17], const uint8_t* v, int nvals) {
    memcpy(vals, v, nvals);
    memset(look, 0, sizeof(look));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = k - code;
        for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
          if (l <= kLook) {
            int shift = kLook - l;
            for (int f = 0; f < (1 << shift); ++f)
              look[(code << shift) | f] = (uint16_t)((l << 8) | vals[k]);
          }
        }
        maxcode[l] = code - 1;
        if (code - 1 >= (1 << l)) fail("corrupt Huffman table");
      } else {
        maxcode[l] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;  // stops a corrupt code's search
    defined = true;
  }
};

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;          // blocks allocated (MCU-padded)
  int dw = 0, dh = 0;          // downsampled width and height in samples
  int qlatched = -1;           // quant table copy taken at its first scan
  uint16_t q[64];
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  int coef_bits[64];
  int dc_pred = 0;
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : d_(data), n_(n) {}

  void header();             // up to the first SOS
  void decode(uint8_t* out); // after header(): the scans, then the RGB image

  int width = 0, height = 0, ncomp = 0;

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  bool progressive_ = false;
  bool have_frame_ = false;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  bool qdefined_[4] = {false, false, false, false};
  uint16_t qt_[4][64];
  Huffman dc_[4], ac_[4];
  Component comp_[4];
  // Scan state.
  int ns_ = 0, sidx_[4], ss_ = 0, se_ = 0, ah_ = 0, al_ = 0;
  int eobrun_ = 0;
  // Bit reader.
  uint64_t acc_ = 0;
  int nbits_ = 0;
  bool marker_hit_ = false;

  uint8_t byte() {
    if (pos_ >= n_) fail("truncated file");
    return d_[pos_++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker();
  size_t segment_end();
  void read_sof(int marker);
  void read_dqt();
  void read_dht();
  void read_sos();
  void read_app(int marker);
  void skip_segment();

  void fill();
  int bits(int n) {
    if (n == 0) return 0;
    if (nbits_ < n) fill();
    nbits_ -= n;
    return (int)((acc_ >> nbits_) & ((1u << n) - 1));
  }
  int bit() { return bits(1); }
  int huff(const Huffman& t);
  static int extend(int x, int s) { return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x; }
  void reset_bits() {
    acc_ = 0;
    nbits_ = 0;
  }
  void restart();
  void decode_scan();
  void decode_block(Component& c, int16_t* blk);
  void finish(uint8_t* out);
};

int Decoder::next_marker() {
  // Skip to the next 0xFF xx with xx neither 0x00 (stuffing) nor 0xFF (fill);
  // -1 at the end of the data.
  while (true) {
    if (pos_ + 1 >= n_) return -1;
    if (d_[pos_] == 0xFF) {
      size_t p = pos_ + 1;
      while (p < n_ && d_[p] == 0xFF) ++p;
      if (p >= n_) fail("truncated file");
      if (d_[p] != 0x00) {
        pos_ = p + 1;
        return d_[p];
      }
      pos_ = p + 1;
    } else {
      ++pos_;
    }
  }
}

// The end of the marker segment whose length field is at pos_.
size_t Decoder::segment_end() {
  size_t start = pos_;
  int len = word();
  if (len < 2) fail("corrupt marker segment length");
  if (start + len > n_) fail("truncated file");
  return start + len;
}

void Decoder::skip_segment() { pos_ = segment_end(); }

void Decoder::read_app(int marker) {
  size_t end = segment_end();
  const uint8_t* p = d_ + pos_;
  size_t dlen = end - pos_;
  if (marker == 0xE0 && dlen >= 14 && memcmp(p, "JFIF\0", 5) == 0) saw_jfif_ = true;
  if (marker == 0xEE && dlen >= 12 && memcmp(p, "Adobe", 5) == 0) {
    saw_adobe_ = true;
    adobe_transform_ = p[11];
  }
  pos_ = end;
}

void Decoder::read_dqt() {
  size_t end = segment_end();
  while (pos_ < end) {
    int pq_tq = byte();
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (tq > 3) fail("corrupt DQT segment: table id above 3");
    for (int k = 0; k < 64; ++k) qt_[tq][kNatural[k]] = (uint16_t)(pq ? word() : byte());
    qdefined_[tq] = true;
  }
  if (pos_ != end) fail("corrupt DQT segment length");
}

void Decoder::read_dht() {
  size_t end = segment_end();
  while (pos_ < end) {
    int tc_th = byte();
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) fail("corrupt DHT segment: table class or id");
    uint8_t counts[17] = {0};
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += counts[l] = byte();
    if (total > 256) fail("corrupt DHT segment: more than 256 codes");
    uint8_t vals[256];
    for (int i = 0; i < total; ++i) vals[i] = byte();
    (tc ? ac_[th] : dc_[th]).build(counts, vals, total);
  }
  if (pos_ != end) fail("corrupt DHT segment length");
}

void Decoder::read_sof(int marker) {
  if (have_frame_) fail("more than one frame header");
  int len = word();
  int precision = byte();
  height = word();
  width = word();
  ncomp = byte();
  if (len != 8 + 3 * ncomp) fail("corrupt frame header length");
  if (precision == 12) fail("12-bit samples are not supported (8-bit only)");
  if (precision != 8) fail("only 8-bit samples are supported, not " + std::to_string(precision) + "-bit");
  if (height == 0) fail("a DNL marker (height 0 in the frame header) is not supported");
  if (width == 0) fail("image width 0");
  if (ncomp != 1 && ncomp != 3 && ncomp != 4) fail(std::to_string(ncomp) + "-component JPEG is not supported");
  progressive_ = marker == 0xC2;
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp_[i];
    c.id = byte();
    int hv = byte();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.tq = byte();
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("corrupt sampling factors");
    if (c.tq > 3) fail("corrupt quantization table id");
    hmax_ = c.h > hmax_ ? c.h : hmax_;
    vmax_ = c.v > vmax_ ? c.v : vmax_;
  }
  mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
  mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp_[i];
    if (hmax_ % c.h || vmax_ % c.v)
      fail("fractional sampling factors are not supported");
    c.dw = (int)(((long)width * c.h + hmax_ - 1) / hmax_);
    c.dh = (int)(((long)height * c.v + vmax_ - 1) / vmax_);
    c.bw = mcux_ * c.h;
    c.bh = mcuy_ * c.v;
    c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
  }
  have_frame_ = true;
}

void Decoder::read_sos() {
  if (!have_frame_) fail("scan before the frame header");
  int len = word();
  ns_ = byte();
  if (ns_ < 1 || ns_ > 4 || len != 6 + 2 * ns_) fail("corrupt scan header");
  for (int i = 0; i < ns_; ++i) {
    int cs = byte(), t = byte();
    int k = 0;
    while (k < ncomp && comp_[k].id != cs) ++k;
    if (k == ncomp) fail("scan names an unknown component");
    sidx_[i] = k;
    comp_[k].td = t >> 4;
    comp_[k].ta = t & 15;
    if (comp_[k].td > 3 || comp_[k].ta > 3) fail("corrupt scan header: table id");
  }
  ss_ = byte();
  se_ = byte();
  int a = byte();
  ah_ = a >> 4;
  al_ = a & 15;
  if (progressive_) {
    if (ss_ > se_ || se_ > 63 || (ss_ == 0 && se_ != 0) || (ss_ > 0 && ns_ != 1) || al_ > 13)
      fail("corrupt progressive scan parameters");
  } else if (ss_ != 0 || se_ != 63 || ah_ != 0 || al_ != 0) {
    fail("corrupt sequential scan parameters");
  }
  int blocks = 0;
  for (int i = 0; i < ns_; ++i) blocks += comp_[sidx_[i]].h * comp_[sidx_[i]].v;
  if (ns_ > 1 && blocks > 10) fail("corrupt scan: more than 10 blocks in an MCU");
}

void Decoder::header() {
  if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
  pos_ = 2;
  while (true) {
    int m = next_marker();
    if (m < 0) fail("truncated file: no image data");
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      read_sof(m);
    } else if (m == 0xC3) {
      fail("lossless JPEG is not supported");
    } else if (m == 0xC5 || m == 0xC6 || m == 0xC7) {
      fail("hierarchical (differential) JPEG is not supported");
    } else if ((m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF) || m == 0xCC) {
      fail("arithmetic coding is not supported (Huffman-coded JPEG only)");
    } else if (m == 0xC4) {
      read_dht();
    } else if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xDD) {
      int len = word();
      if (len != 4) fail("corrupt DRI segment");
      restart_interval_ = word();
    } else if (m == 0xDA) {
      if (!have_frame_) fail("scan before the frame header");
      pos_ -= 2;  // decode() reads the scan header again
      return;
    } else if (m >= 0xE0 && m <= 0xEF) {
      read_app(m);
    } else if (m == 0xD9) {
      fail("no image data before EOI");
    } else if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      // Stray markers without a segment: skipped, as libjpeg does.
    } else if (m == 0xDC) {
      fail("a DNL marker is not supported");
    } else {
      skip_segment();  // COM, DHP, EXP, JPGn, ...
    }
  }
}

void Decoder::fill() {
  while (nbits_ <= 56) {
    int b = 0;
    if (!marker_hit_) {
      // Scan data that runs to the end of the file: Pillow raises "image
      // file is truncated" where libjpeg asks it for more.
      if (pos_ >= n_) fail("truncated file: the scan data runs to its end");
      if (d_[pos_] == 0xFF) {
        size_t p = pos_ + 1;
        while (p < n_ && d_[p] == 0xFF) ++p;  // fill bytes before a marker
        if (p >= n_) fail("truncated file: the scan data runs to its end");
        if (d_[p] == 0x00) {
          b = 0xFF;
          pos_ = p + 1;
        } else {
          marker_hit_ = true;  // leave the marker unread; feed zeros
          pos_ = p - 1;
        }
      } else {
        b = d_[pos_++];
      }
    }
    acc_ = (acc_ << 8) | (uint64_t)b;
    nbits_ += 8;
  }
}

int Decoder::huff(const Huffman& t) {
  if (!t.defined) fail("scan uses an undefined Huffman table");
  if (nbits_ < 16) fill();
  int look = (int)((acc_ >> (nbits_ - Huffman::kLook)) & ((1 << Huffman::kLook) - 1));
  int e = t.look[look];
  if (e) {
    nbits_ -= e >> 8;
    return e & 0xFF;
  }
  int l = Huffman::kLook + 1;
  int code = (int)((acc_ >> (nbits_ - l)) & ((1 << l) - 1));
  while (code > t.maxcode[l]) {
    ++l;
    if (l > 16) fail("corrupt Huffman code");
    code = (int)((acc_ >> (nbits_ - l)) & ((1 << l) - 1));
  }
  nbits_ -= l;
  return t.vals[code + t.valoffset[l]];
}

void Decoder::restart() {
  reset_bits();
  if (!marker_hit_) {
    // Skip what is left of the interval's entropy bytes up to the marker.
    while (true) {
      if (pos_ + 1 >= n_) fail("truncated file: missing restart marker");
      if (d_[pos_] == 0xFF && d_[pos_ + 1] != 0x00 && d_[pos_ + 1] != 0xFF) break;
      ++pos_;
    }
  }
  if (pos_ + 1 < n_ && d_[pos_] == 0xFF && d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7) {
    pos_ += 2;
  } else {
    fail("corrupt data: restart marker expected");
  }
  marker_hit_ = false;
  for (int i = 0; i < ncomp; ++i) comp_[i].dc_pred = 0;
  eobrun_ = 0;
}

void Decoder::decode_block(Component& c, int16_t* blk) {
  if (!progressive_) {
    const Huffman& dc = dc_[c.td];
    const Huffman& ac = ac_[c.ta];
    int s = huff(dc);
    if (s > 11) fail("corrupt DC coefficient");
    int diff = s ? extend(bits(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = (int16_t)c.dc_pred;
    for (int k = 1; k < 64; ++k) {
      int rs = huff(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        int v = extend(bits(s), s);
        blk[kNatural[k]] = (int16_t)v;
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return;
  }
  if (ss_ == 0) {  // DC scans
    if (ah_ == 0) {
      int s = huff(dc_[c.td]);
      if (s > 11) fail("corrupt DC coefficient");
      int diff = s ? extend(bits(s), s) : 0;
      c.dc_pred += diff;
      blk[0] = (int16_t)(c.dc_pred * (1 << al_));
    } else if (bit()) {
      blk[0] = (int16_t)(blk[0] | (1 << al_));
    }
    return;
  }
  const Huffman& ac = ac_[c.ta];
  if (ah_ == 0) {  // AC first pass
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    for (int k = ss_; k <= se_; ++k) {
      int rs = huff(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(bits(s), s);
        blk[kNatural[k]] = (int16_t)(v * (1 << al_));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += bits(r);
        --eobrun_;
        break;
      }
    }
    return;
  }
  // AC refinement.
  int p1 = 1 << al_, m1 = -1 * (1 << al_);
  int k = ss_;
  if (eobrun_ == 0) {
    for (; k <= se_; ++k) {
      int rs = huff(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        if (s != 1) fail("corrupt AC refinement");
        s = bit() ? p1 : m1;
      } else if (r != 15) {
        eobrun_ = 1 << r;
        if (r) eobrun_ += bits(r);
        break;
      }
      do {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (bit() && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se_);
      if (s) blk[kNatural[k]] = (int16_t)s;
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se_; ++k) {
      int16_t* coef = blk + kNatural[k];
      if (*coef != 0 && bit() && (*coef & p1) == 0)
        *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    --eobrun_;
  }
}

void Decoder::decode_scan() {
  for (int i = 0; i < ns_; ++i) {
    Component& c = comp_[sidx_[i]];
    if (c.qlatched < 0) {
      if (!qdefined_[c.tq]) fail("scan uses an undefined quantization table");
      memcpy(c.q, qt_[c.tq], sizeof(c.q));
      c.qlatched = c.tq;
    }
    if (progressive_) {
      for (int k = ss_; k <= se_; ++k) {
        if (ah_ != 0 && c.coef_bits[k] != ah_) fail("corrupt progressive scan sequence");
        c.coef_bits[k] = al_;
      }
    }
    c.dc_pred = 0;
  }
  reset_bits();
  marker_hit_ = false;
  eobrun_ = 0;
  int togo = restart_interval_;
  auto mcu_start = [&]() {
    if (restart_interval_) {
      if (togo == 0) {
        restart();
        togo = restart_interval_;
      }
      --togo;
    }
  };
  if (ns_ == 1) {
    Component& c = comp_[sidx_[0]];
    int bx = (c.dw + 7) / 8, by = (c.dh + 7) / 8;
    for (int y = 0; y < by; ++y)
      for (int x = 0; x < bx; ++x) {
        mcu_start();
        decode_block(c, &c.coef[((size_t)y * c.bw + x) * 64]);
      }
  } else {
    for (int my = 0; my < mcuy_; ++my)
      for (int mx = 0; mx < mcux_; ++mx) {
        mcu_start();
        for (int i = 0; i < ns_; ++i) {
          Component& c = comp_[sidx_[i]];
          for (int v = 0; v < c.v; ++v)
            for (int h = 0; h < c.h; ++h) {
              size_t bx = (size_t)mx * c.h + h, by = (size_t)my * c.v + v;
              decode_block(c, &c.coef[(by * c.bw + bx) * 64]);
            }
        }
      }
  }
  // Past the scan's entropy data, to its closing marker.
  reset_bits();
  while (true) {
    if (pos_ + 1 >= n_) return;  // no marker after the scan: decode() refuses the file
    if (d_[pos_] == 0xFF && d_[pos_ + 1] != 0x00 && d_[pos_ + 1] != 0xFF &&
        !(d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7))
      break;
    ++pos_;
  }
}

// jidctint.c's jpeg_idct_islow on one block of dequantised coefficients.
#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

inline uint8_t clamp_sample(int64_t v) {
  v += 128;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      // AC terms all zero: the column is its DC term (the same value the
      // full pass gives).
      int dc = (int)((int64_t)ip[0] * qp[0] * (1 << PASS1_BITS));
      for (int k = 0; k < 64; k += 8) wp[k] = dc;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = (int64_t)ip[16] * qp[16];
    z3 = (int64_t)ip[48] * qp[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    tmp0 = (z2 + z3) * (1 << CONST_BITS);
    tmp1 = (z2 - z3) * (1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    wp[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
    wp[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
    wp[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
    wp[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
    wp[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
    wp[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
    wp[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
    wp[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = clamp_sample(DESCALE((int64_t)wp[0], PASS1_BITS + 3));
      memset(op, v, 8);
      continue;
    }
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = wp[2];
    z3 = wp[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
    tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS + PASS1_BITS + 3;
    op[0] = clamp_sample(DESCALE(tmp10 + tmp3, n));
    op[7] = clamp_sample(DESCALE(tmp10 - tmp3, n));
    op[1] = clamp_sample(DESCALE(tmp11 + tmp2, n));
    op[6] = clamp_sample(DESCALE(tmp11 - tmp2, n));
    op[2] = clamp_sample(DESCALE(tmp12 + tmp1, n));
    op[5] = clamp_sample(DESCALE(tmp12 - tmp1, n));
    op[3] = clamp_sample(DESCALE(tmp13 + tmp0, n));
    op[4] = clamp_sample(DESCALE(tmp13 - tmp0, n));
  }
}

// One component's samples [dh, dw] → the full image [height, width].
void upsample(const uint8_t* in, int stride, int dw, int dh, int rh, int rv, int width,
              int height, uint8_t* out) {
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < height; ++y) memcpy(out + (size_t)y * width, in + (size_t)y * stride, width);
    return;
  }
  std::vector<uint8_t> row((size_t)dw * rh + 2);
  if (rh == 2 && rv == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < height; ++y) {
      const uint8_t* ip = in + (size_t)y * stride;
      uint8_t* op = out + (size_t)y * width;
      for (int j = 0; j < width; ++j) {
        int i = j >> 1;
        int v3 = ip[i] * 3;
        if (j & 1)
          op[j] = (uint8_t)(i == dw - 1 ? ip[i] : (v3 + ip[i + 1] + 2) >> 2);
        else
          op[j] = (uint8_t)(i == 0 ? ip[i] : (v3 + ip[i - 1] + 1) >> 2);
      }
    }
    return;
  }
  if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; ++y) {
      int i = y >> 1;
      int nb = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t* p0 = in + (size_t)i * stride;
      const uint8_t* p1 = in + (size_t)nb * stride;
      uint8_t* op = out + (size_t)y * width;
      for (int x = 0; x < width; ++x) op[x] = (uint8_t)((p0[x] * 3 + p1[x] + bias) >> 2);
    }
    return;
  }
  if (rh == 2 && rv == 2 && dw > 2) {  // h2v2_fancy_upsample
    std::vector<int> cs(dw);
    for (int y = 0; y < height; ++y) {
      int i = y >> 1;
      int nb = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
      const uint8_t* p0 = in + (size_t)i * stride;
      const uint8_t* p1 = in + (size_t)nb * stride;
      for (int x = 0; x < dw; ++x) cs[x] = p0[x] * 3 + p1[x];
      uint8_t* op = out + (size_t)y * width;
      for (int j = 0; j < width; ++j) {
        int k = j >> 1;
        if (j & 1)
          op[j] = (uint8_t)(k == dw - 1 ? (cs[k] * 4 + 7) >> 4 : (cs[k] * 3 + cs[k + 1] + 7) >> 4);
        else
          op[j] = (uint8_t)(k == 0 ? (cs[k] * 4 + 8) >> 4 : (cs[k] * 3 + cs[k - 1] + 8) >> 4);
      }
    }
    return;
  }
  // Box replication (int_upsample, and h2v1 / h2v2 at dw <= 2).
  for (int y = 0; y < height; ++y) {
    const uint8_t* ip = in + (size_t)(y / rv) * stride;
    uint8_t* op = out + (size_t)y * width;
    for (int x = 0; x < width; ++x) op[x] = ip[x / rh];
  }
}

uint8_t limit(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// jdcolor.c build_ycc_rgb_table: fixed point with SCALEBITS 16.
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
  int g(int cb, int cr) const { return (int)((cb_g[cb] + cr_g[cr]) >> 16); }
};

// Four components → RGB as Pillow gives them: libjpeg's CMYK (YCCK first
// through ycck_cmyk_convert), inverted by Pillow's "CMYK;I" raw mode, then
// Pillow's cmyk2rgb.
void cmyk_to_rgb(const std::vector<uint8_t>* planes, size_t npix, bool ycck, uint8_t* out) {
  const YccTables t;
  for (size_t p = 0; p < npix; ++p) {
    int cmy[3] = {planes[0][p], planes[1][p], planes[2][p]};
    if (ycck) {
      int y = cmy[0], cb = cmy[1], cr = cmy[2];
      cmy[0] = limit(255 - (y + t.cr_r[cr]));
      cmy[1] = limit(255 - (y + t.g(cb, cr)));
      cmy[2] = limit(255 - (y + t.cb_b[cb]));
    }
    int nk = planes[3][p];  // 255 - the inverted K
    for (int c = 0; c < 3; ++c) {
      int v = (255 - cmy[c]) * nk + 128;
      out[3 * p + c] = limit(nk - (((v >> 8) + v) >> 8));
    }
  }
}

void Decoder::finish(uint8_t* out) {
  if (progressive_) {
    // libjpeg smooths the blocks (jdcoefct.c, smoothing_ok) when every
    // component's DC is known and some coefficient 1-9 is not fully refined.
    bool dc_known = true, unrefined = false;
    for (int i = 0; i < ncomp; ++i) {
      if (comp_[i].coef_bits[0] < 0) dc_known = false;
      for (int k = 1; k <= 9; ++k)
        if (comp_[i].coef_bits[k] != 0) unrefined = true;
    }
    if (dc_known && unrefined)
      fail("a progressive JPEG whose scans leave low-frequency coefficients unrefined "
           "(libjpeg's block smoothing) is not supported");
  }
  std::vector<uint8_t> planes[4];
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp_[i];
    if (c.qlatched < 0) {
      if (!qdefined_[c.tq]) fail("component has no quantization table");
      memcpy(c.q, qt_[c.tq], sizeof(c.q));
    }
    int bx = (c.dw + 7) / 8, by = (c.dh + 7) / 8;
    int stride = bx * 8;
    std::vector<uint8_t> samples((size_t)stride * by * 8);
    for (int y = 0; y < by; ++y)
      for (int x = 0; x < bx; ++x)
        idct_islow(&c.coef[((size_t)y * c.bw + x) * 64], c.q,
                   &samples[(size_t)y * 8 * stride + x * 8], stride);
    planes[i].resize((size_t)width * height);
    upsample(samples.data(), stride, c.dw, c.dh, hmax_ / c.h, vmax_ / c.v, width, height,
             planes[i].data());
  }
  size_t npix = (size_t)width * height;
  if (ncomp == 1) {
    for (size_t p = 0; p < npix; ++p) out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = planes[0][p];
    return;
  }
  if (ncomp == 4) {
    cmyk_to_rgb(planes, npix, saw_adobe_ && adobe_transform_ != 0, out);
    return;
  }
  bool rgb;
  if (saw_jfif_) {
    rgb = false;
  } else if (saw_adobe_) {
    rgb = adobe_transform_ == 0;
  } else {
    rgb = comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
  }
  if (rgb) {
    for (size_t p = 0; p < npix; ++p) {
      out[3 * p] = planes[0][p];
      out[3 * p + 1] = planes[1][p];
      out[3 * p + 2] = planes[2][p];
    }
    return;
  }
  const YccTables t;
  for (size_t p = 0; p < npix; ++p) {
    int y = planes[0][p], cb = planes[1][p], cr = planes[2][p];
    out[3 * p] = limit(y + t.cr_r[cr]);
    out[3 * p + 1] = limit(y + t.g(cb, cr));
    out[3 * p + 2] = limit(y + t.cb_b[cb]);
  }
}

void Decoder::decode(uint8_t* out) {
  while (true) {
    int m = next_marker();
    if (m == 0xDA) {
      read_sos();
      decode_scan();
    } else if (m == 0xD9) {
      break;
    } else if (m < 0) {
      fail("truncated file: it ends before its EOI marker");
    } else if (m == 0xC4) {
      read_dht();
    } else if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xDD) {
      int len = word();
      if (len != 4) fail("corrupt DRI segment");
      restart_interval_ = word();
    } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      fail("more than one frame header");
    } else if (m == 0xCC) {
      fail("arithmetic coding is not supported (Huffman-coded JPEG only)");
    } else if (m == 0xDC) {
      fail("a DNL marker is not supported");
    } else if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
    } else {
      skip_segment();
    }
  }
  finish(out);
}

int report(const Failure& f, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", f.msg.c_str());
  return 1;
}

}  // namespace

extern "C" {

// Header only: hwc = {height, width, components}.
int premvos_jpeg_info(const uint8_t* data, int64_t n, int* hwc, char* err, int errlen) {
  try {
    Decoder dec(data, (size_t)n);
    dec.header();
    hwc[0] = dec.height;
    hwc[1] = dec.width;
    hwc[2] = dec.ncomp;
    return 0;
  } catch (const Failure& f) {
    return report(f, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Failure{"out of memory"}, err, errlen);
  }
}

// The whole image as RGB: out holds height * width * 3 bytes (from info).
int premvos_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_len,
                        char* err, int errlen) {
  try {
    Decoder dec(data, (size_t)n);
    dec.header();
    if ((int64_t)dec.height * dec.width * 3 != out_len) throw Failure{"output size mismatch"};
    dec.decode(out);
    return 0;
  } catch (const Failure& f) {
    return report(f, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Failure{"out of memory"}, err, errlen);
  }
}

}  // extern "C"
