// JPEG decoder for the port's frame readers: host code, built with the host
// C++ compiler and bound by ctypes (premvos_tpu_torch/io_compat/jpeg.py).
//
// It returns what Pillow's `Image.open(p).convert("RGB")` returns, bit for
// bit. Pillow runs libjpeg-turbo (3.1) with its defaults, so this follows
// the same arithmetic:
//   * baseline, extended sequential and progressive JPEG, Huffman-coded or
//     arithmetic-coded (SOF0-2, SOF9-10: jdhuff.c, jdphuff.c and jdarith.c's
//     QM-coder with its DAC conditioning, statistics reset at each restart),
//     8-bit samples, 1 (gray), 3 or 4 components, any integral sampling
//     factors, restart intervals;
//   * dequantisation and the ISLOW integer IDCT of jidctint.c (CONST_BITS
//     13, PASS1_BITS 2) as libjpeg-turbo's x86 SIMD version computes it:
//     16-bit dequantisation and sums, saturated passes, its output clamped
//     to 0..255;
//   * jdcoefct.c's block smoothing (libjpeg-turbo >= 2.1) of a progressive
//     file whose scans leave one of coefficients 1-9 unrefined: estimates
//     from the 5x5 neighbourhood of DC values, the DC itself too when no
//     coefficient 1-9 is known;
//   * lossless JPEG (SOF3, Huffman-coded, 8-bit): jdlhuff.c's differences,
//     jdlossls.c's predictors 1-7 and point transform, jddiffct.c's restart
//     and row handling; no color conversion (libjpeg refuses it there);
//   * fancy (triangle) upsampling of jdsample.c for h2v1, h2v2 and h1v2
//     (box replication for h2v1 and h2v2 at downsampled widths of 2 or
//     less, for other integral factors, and for every factor of a lossless
//     file), with the edge rows and columns replicated as libjpeg's context
//     rows are;
//   * jdcolor.c's fixed-point YCbCr → RGB tables (SCALEBITS 16) with range
//     limiting; an RGB-coded file (Adobe transform 0, or component ids
//     'R', 'G', 'B') is copied; gray is replicated into R, G and B;
//   * four components as libjpeg reads them: CMYK (no Adobe marker, or
//     Adobe transform 0) as it is, YCCK (any other Adobe transform) through
//     jdcolor.c's ycck_cmyk_convert; then Pillow's own steps: its "CMYK;I"
//     raw mode inverts every sample (Adobe's polarity, assumed for every
//     CMYK JPEG), and its convert("RGB") takes
//     R = clip(nk - (c·nk + 128 + ((c·nk + 128) >> 8)) >> 8), nk = 255 - k;
//   * a file that ends before its EOI marker is read where Pillow reads it
//     (at its default read block, 64 KiB): a single-scan file whose scan
//     decodes without libjpeg asking for a byte past the end. The Huffman
//     bit reader refills where jdhuff.c does: on its fast path, taken with
//     512 bytes a block in hand of what Pillow has handed libjpeg, six
//     bytes at 16 bits or fewer; on its slow path to 57 bits when the next
//     request needs more. The arithmetic decoder reads a byte when it needs
//     one. Any other such file is refused as truncated, as Pillow refuses it;
//   * damaged restart markers as jdmarker.c's read_restart_marker and
//     jpeg_resync_to_restart (Pillow keeps libjpeg's default) resync: a
//     marker dropped, doubled, renumbered or preceded by garbage;
//   * scan data that ends early at a marker: the MCU in which the bits run
//     out decoded with zero bits, the rest of the restart interval left
//     undecoded (insufficient_data in jdhuff.c, jdphuff.c, jdlhuff.c; the
//     arithmetic decoder reads zeros instead), and a progressive file's
//     smoothing past the last good iMCU row done with the coefficient bits
//     from before the cut scan (jdcoefct.c).
// 12-bit samples, arithmetic-coded lossless JPEG (libjpeg-turbo does not
// decode it), hierarchical JPEG (nor this) and an arithmetic-coded scan
// that crosses one of Pillow's 64 KiB blocks (libjpeg cannot wait for the
// next one) are refused with a message naming the feature.
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

// ITU T.81 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS. Entry 113 is the fixed 0.5 estimate
// (T.851) for sign and refinement bits.
#define V(qe, nlps, nmps, sw) (((int32_t)(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const int32_t kQe[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

struct Failure {
  std::string msg;
};

// Pillow hands libjpeg a file kPillowBlock bytes at a time (its
// ImageFile.MAXBLOCK) and reads more only when libjpeg asks for a byte it
// has not been given: libjpeg then "suspends", and retries the MCU it was
// decoding once the next block is in. Suspend unwinds such an MCU.
const size_t kPillowBlock = 65536;
struct Suspend {};

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
  int bw = 0, bh = 0;          // blocks (samples in a lossless file) allocated, MCU-padded
  int dw = 0, dh = 0;          // downsampled width and height in samples
  int qlatched = -1;           // quant table copy taken at its first scan
  uint16_t q[64];
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  std::vector<int32_t> diff;   // lossless: bw * bh differences
  std::vector<uint16_t> undiff;  // lossless: dw * dh reconstructed samples
  int coef_bits[64];
  int prev_bits[64];           // jdphuff.c: coef_bits before its latest scan
  int dc_pred = 0;
  int dc_context = 0;          // arithmetic DC conditioning (F.1.4.4.1.2)
  bool first_row = true;       // lossless: the row predictor is the 1-D one
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n)
      : d_(data), n_(n), chunk_end_(n < kPillowBlock ? n : kPillowBlock) {}

  void header();             // up to the first SOS
  void decode(uint8_t* out); // after header(): the scans, then the RGB image

  int width = 0, height = 0, ncomp = 0;

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  size_t chunk_end_;           // the end of the blocks Pillow has handed libjpeg
  bool suspendable_ = false;   // a sequential Huffman MCU that libjpeg would retry
  bool progressive_ = false, arithmetic_ = false, lossless_ = false;
  bool have_frame_ = false;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  bool qdefined_[4] = {false, false, false, false};
  uint16_t qt_[4][64];
  Huffman dc_[4], ac_[4];
  Component comp_[4];
  // Arithmetic conditioning (DAC) and statistics areas.
  uint8_t dac_l_[16], dac_u_[16], dac_k_[16];
  uint8_t dc_stats_[16][64], ac_stats_[16][256];
  uint8_t fixed_bin_ = 113;
  int64_t areg_c_ = 0, areg_a_ = 0;  // the C and A registers
  int ct_ = 0;               // bit shift counter
  // Scan state.
  int ns_ = 0, sidx_[4], ss_ = 0, se_ = 0, ah_ = 0, al_ = 0;
  int eobrun_ = 0;
  // Bit reader.
  uint64_t acc_ = 0;
  int nbits_ = 0;
  bool marker_hit_ = false;    // libjpeg's unread_marker: pos_ is at its 0xFF
  bool insufficient_ = false;  // jdhuff.c's insufficient_data: the MCUs are skipped
  int next_restart_ = 0;       // the n of the RSTn the next restart expects
  int scans_ = 0;              // scans started (libjpeg's input_scan_number)
  int last_good_ = 0;          // the last iMCU row begun with data in hand
  bool fast_ = false;          // jdhuff.c's fast path decodes this MCU
  bool fast_marker_ = false;   // and met a marker: libjpeg redoes the MCU

  void need(size_t end) {
    while (end > chunk_end_ && chunk_end_ < n_)
      chunk_end_ = n_ - chunk_end_ < kPillowBlock ? n_ : chunk_end_ + kPillowBlock;
  }
  void more();
  // jdarith.c get_byte cannot suspend: a byte past the blocks Pillow has
  // handed libjpeg ends the decode (Pillow: "broken data stream").
  void arith_need(size_t end) {
    if (end <= chunk_end_) return;
    if (chunk_end_ >= n_) fail("truncated file: the scan data runs to its end");
    fail("an arithmetic-coded scan across a 64 KiB block of the file is not supported "
         "(libjpeg's arithmetic decoder cannot wait for Pillow's next block)");
  }
  int arith_byte() {
    arith_need(pos_ + 1);
    return d_[pos_++];
  }
  uint8_t byte() {
    if (pos_ >= n_) fail("truncated file");
    need(pos_ + 1);
    return d_[pos_++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker();
  bool seek_marker();
  size_t segment_end();
  void read_sof(int marker);
  void read_dqt();
  void read_dht();
  void read_dac();
  void read_sos();
  void read_app(int marker);
  void skip_segment();
  bool table_marker(int m);

  void fill(int n);
  void fill_fast();
  // Fast: jdhuff.c's fast path (the refills of FILL_BIT_BUFFER_FAST).
  template <bool Fast = false>
  int bits(int n) {
    if (n == 0) return 0;
    if (Fast) {
      if (nbits_ <= 16) fill_fast();
    } else if (nbits_ < n) {
      fill(n);
    }
    nbits_ -= n;
    return (int)((acc_ >> nbits_) & ((1u << n) - 1));
  }
  int bit() { return bits(1); }
  template <bool Fast = false>
  int huff(const Huffman& t);
  static int extend(int x, int s) { return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x; }
  void reset_bits() {
    acc_ = 0;
    nbits_ = 0;
  }
  void reset_arith() {
    areg_c_ = 0;
    areg_a_ = 0;
    ct_ = -16;  // read two bytes into C first
  }
  int arith_decode(uint8_t* st);
  void restart();
  void start_scan();
  void decode_scan();
  void decode_mcu(int mx, int my);
  void decode_block(Component& c, int16_t* blk);
  template <bool Fast>
  void sequential_block(Component& c, int16_t* blk);
  void arith_block(Component& c, int16_t* blk);
  void decode_lossless_scan();
  void undifference_row(Component& c, int row);
  bool smoothing_ok() const;
  void smooth_block(const Component& c, int bx, int by, int16_t* ws) const;
  void finish(uint8_t* out);
};

// jdmarker.c next_marker from pos_: skips what is not a marker (FF 00
// pairs too) and leaves pos_ at the last 0xFF before the marker's code, the
// marker unread; false at the end of the data.
bool Decoder::seek_marker() {
  while (true) {
    if (pos_ + 1 >= n_) return false;
    if (d_[pos_] == 0xFF) {
      size_t p = pos_ + 1;
      while (p < n_ && d_[p] == 0xFF) ++p;
      if (p >= n_) return false;
      if (d_[p] != 0x00) {
        pos_ = p - 1;
        return true;
      }
      pos_ = p + 1;
    } else {
      ++pos_;
    }
  }
}

// The next marker's code, read (-1 at the end of the data).
int Decoder::next_marker() {
  if (!seek_marker()) return -1;
  const int m = d_[pos_ + 1];
  pos_ += 2;
  need(pos_);
  return m;
}

// The end of the marker segment whose length field is at pos_.
size_t Decoder::segment_end() {
  size_t start = pos_;
  int len = word();
  if (len < 2) fail("corrupt marker segment length");
  if (start + len > n_) fail("truncated file");
  need(start + len);
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

// jdmarker.c get_dac: DC tables take L (low nibble) and U, AC tables Kx.
void Decoder::read_dac() {
  size_t end = segment_end();
  while (pos_ < end) {
    int index = byte(), val = byte();
    if (index >= 32) fail("corrupt DAC segment: table index");
    if (index >= 16) {
      dac_k_[index - 16] = (uint8_t)val;
    } else {
      dac_l_[index] = (uint8_t)(val & 15);
      dac_u_[index] = (uint8_t)(val >> 4);
      if (dac_l_[index] > dac_u_[index]) fail("corrupt DAC segment: L above U");
    }
  }
  if (pos_ != end) fail("corrupt DAC segment length");
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
  progressive_ = marker == 0xC2 || marker == 0xCA;
  arithmetic_ = marker >= 0xC9;
  lossless_ = marker == 0xC3;
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
  // A lossless file's data unit is one sample, a DCT file's an 8×8 block.
  const int unit = lossless_ ? 1 : 8;
  mcux_ = (width + unit * hmax_ - 1) / (unit * hmax_);
  mcuy_ = (height + unit * vmax_ - 1) / (unit * vmax_);
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp_[i];
    if (hmax_ % c.h || vmax_ % c.v)
      fail("fractional sampling factors are not supported");
    c.dw = (int)(((long)width * c.h + hmax_ - 1) / hmax_);
    c.dh = (int)(((long)height * c.v + vmax_ - 1) / vmax_);
    c.bw = mcux_ * c.h;
    c.bh = mcuy_ * c.v;
    if (lossless_) {
      c.diff = std::vector<int32_t>((size_t)c.bw * c.bh);
      c.undiff = std::vector<uint16_t>((size_t)c.dw * c.dh);
    } else {
      c.coef = std::vector<int16_t>((size_t)c.bw * c.bh * 64);
    }
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
  }
  have_frame_ = true;
}

void Decoder::read_sos() {
  if (!have_frame_) fail("scan before the frame header");
  int len = word();
  ns_ = byte();
  if (ns_ < 1 || ns_ > 4 || len != 6 + 2 * ns_) fail("corrupt scan header");
  // Huffman scans name tables 0-3, arithmetic ones conditioning tables 0-15.
  const int max_table = arithmetic_ ? 15 : 3;
  for (int i = 0; i < ns_; ++i) {
    int cs = byte(), t = byte();
    int k = 0;
    while (k < ncomp && comp_[k].id != cs) ++k;
    if (k == ncomp) fail("scan names an unknown component");
    sidx_[i] = k;
    comp_[k].td = t >> 4;
    comp_[k].ta = t & 15;
    if (comp_[k].td > max_table || comp_[k].ta > max_table) fail("corrupt scan header: table id");
  }
  ss_ = byte();
  se_ = byte();
  int a = byte();
  ah_ = a >> 4;
  al_ = a & 15;
  if (lossless_) {
    // Ss is the predictor, Al the point transform (jdlossls.c).
    if (ss_ < 1 || ss_ > 7 || ah_ != 0 || al_ >= 8) fail("corrupt lossless scan parameters");
  } else if (progressive_) {
    if (ss_ > se_ || se_ > 63 || (ss_ == 0 && se_ != 0) || (ss_ > 0 && ns_ != 1) || al_ > 13)
      fail("corrupt progressive scan parameters");
  } else if (ss_ != 0 || se_ != 63 || ah_ != 0 || al_ != 0) {
    fail("corrupt sequential scan parameters");
  }
  int blocks = 0;
  for (int i = 0; i < ns_; ++i) blocks += comp_[sidx_[i]].h * comp_[sidx_[i]].v;
  if (ns_ > 1 && blocks > 10) fail("corrupt scan: more than 10 blocks in an MCU");
}

// The table and restart markers that may come before any scan; true if `m`
// was one of them.
bool Decoder::table_marker(int m) {
  if (m == 0xC4) {
    read_dht();
  } else if (m == 0xDB) {
    read_dqt();
  } else if (m == 0xCC) {
    read_dac();
  } else if (m == 0xDD) {
    int len = word();
    if (len != 4) fail("corrupt DRI segment");
    restart_interval_ = word();
  } else {
    return false;
  }
  return true;
}

void Decoder::header() {
  if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
  pos_ = 2;
  for (int t = 0; t < 16; ++t) {  // jdmarker.c get_soi's defaults
    dac_l_[t] = 0;
    dac_u_[t] = 1;
    dac_k_[t] = 5;
  }
  while (true) {
    int m = next_marker();
    if (m < 0) fail("truncated file: no image data");
    if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 || m == 0xCA) {
      read_sof(m);
    } else if (m == 0xCB) {
      fail("arithmetic-coded lossless JPEG is not supported (libjpeg does not decode it)");
    } else if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD || m == 0xCE || m == 0xCF) {
      fail("hierarchical (differential) JPEG is not supported");
    } else if (table_marker(m)) {
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

// The bit reader wants the byte at chunk_end_: past the end of the file
// Pillow raises "image file is truncated"; in a sequential Huffman MCU
// libjpeg suspends and retries the MCU with the next block.
void Decoder::more() {
  if (chunk_end_ >= n_) fail("truncated file: the scan data runs to its end");
  if (suspendable_) throw Suspend{};
  need(chunk_end_ + 1);
}

// jdhuff.c jpeg_fill_bit_buffer for a request of n bits: whole bytes until
// 57 bits are buffered, or up to a marker, which is left unread. Past a
// marker, a request for more bits than are left sets insufficient_data and
// fills the buffer with zeros (libjpeg's "premature end of data segment");
// jdhuff.c, jdphuff.c and jdlhuff.c then decode no later MCU of the
// restart interval.
void Decoder::fill(int n) {
  while (!marker_hit_ && nbits_ <= 56) {
    if (pos_ >= chunk_end_) more();
    int b = d_[pos_];
    if (b == 0xFF) {
      size_t p = pos_ + 1;
      while (true) {  // fill bytes before a marker
        if (p >= chunk_end_) more();
        if (d_[p] != 0xFF) break;
        ++p;
      }
      if (d_[p] != 0x00) {
        marker_hit_ = true;
        pos_ = p - 1;
        break;
      }
      pos_ = p + 1;
    } else {
      ++pos_;
    }
    acc_ = (acc_ << 8) | (uint64_t)b;
    nbits_ += 8;
  }
  if (marker_hit_ && n > nbits_) {
    insufficient_ = true;
    acc_ <<= 57 - nbits_;
    nbits_ = 57;
  }
}

// jdhuff.c FILL_BIT_BUFFER_FAST (64-bit): six bytes; a marker is read as
// zeros without passing it, and the MCU is then decoded again on the slow
// path. The fast path runs only with 512 bytes a block in hand.
void Decoder::fill_fast() {
  if (pos_ + 13 > n_) fail("corrupt data: the scan runs past the end of the file");
  for (int i = 0; i < 6; ++i) {
    int c0 = d_[pos_++], c1 = d_[pos_];
    acc_ = (acc_ << 8) | (uint64_t)c0;
    nbits_ += 8;
    if (c0 == 0xFF) {
      ++pos_;
      if (c1 != 0) {
        fast_marker_ = true;
        pos_ -= 2;
        acc_ &= ~(uint64_t)0xFF;
      }
    }
  }
}

// jdhuff.h HUFF_DECODE. On jdhuff.c's slow path (and jdphuff.c's, and
// jdlhuff.c's): refill below 8 bits, look the code up, and for a code
// longer than 8 bits (jpeg_huff_decode) refill below 9 bits, then at each
// bit once the buffer is empty. On the fast path (HUFF_DECODE_FAST): refill
// at 16 bits or fewer. Where the refills fall decides whether a file that
// ends early is read. With 16 bits or more buffered no refill can fall
// inside the code.
template <bool Fast>
int Decoder::huff(const Huffman& t) {
  if (!t.defined) fail("scan uses an undefined Huffman table");
  const int k = Huffman::kLook;
  if (Fast) {
    if (nbits_ <= 16) fill_fast();
  } else if (nbits_ < 16) {
    if (nbits_ < 8) fill(0);  // 57 bits or more, unless it met a marker
    if (nbits_ < 8) {
      // Fewer than 8 bits before a marker: jpeg_huff_decode bit by bit.
      int l = 1, code = bit();
      while (code > t.maxcode[l]) {
        code = (code << 1) | bit();
        if (++l > 16) return 0;  // a bad code: libjpeg warns and takes 0
      }
      return t.vals[(code + t.valoffset[l]) & 0xFF];
    }
    if (nbits_ < 16) {
      int look = nbits_ >= k ? (int)((acc_ >> (nbits_ - k)) & ((1 << k) - 1))
                             : (int)((acc_ << (k - nbits_)) & ((1 << k) - 1));
      int e = t.look[look];
      if (e && (e >> 8) <= nbits_) {
        nbits_ -= e >> 8;
        return e & 0xFF;
      }
      int l = k, code = bits(k);
      while (code > t.maxcode[l]) {
        code = (code << 1) | bit();
        if (++l > 16) return 0;
      }
      return t.vals[(code + t.valoffset[l]) & 0xFF];
    }
  }
  int e = t.look[(acc_ >> (nbits_ - k)) & ((1 << k) - 1)];
  if (e) {
    nbits_ -= e >> 8;
    return e & 0xFF;
  }
  int l = k + 1;
  int code = (int)((acc_ >> (nbits_ - l)) & ((1 << l) - 1));
  while (code > t.maxcode[l]) {
    if (++l > 16) {  // 17 bits read, as jpeg_huff_decode reads them
      nbits_ -= 16;
      bits<Fast>(1);
      return 0;
    }
    code = (int)((acc_ >> (nbits_ - l)) & ((1 << l) - 1));
  }
  nbits_ -= l;
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

// jdarith.c arith_decode: one binary decision with the statistics bin *st.
int Decoder::arith_decode(uint8_t* st) {
  // Renormalization and data input (T.81 D.2.6).
  while (areg_a_ < 0x8000) {
    if (--ct_ < 0) {
      int data = 0;
      if (!marker_hit_) {
        data = arith_byte();
        if (data == 0xFF) {
          do data = arith_byte();
          while (data == 0xFF);
          if (data == 0) {
            data = 0xFF;  // a stuffed zero byte
          } else {
            // A marker: in arithmetic coding the data may end there, and
            // zeros follow until the scan is decoded.
            marker_hit_ = true;
            pos_ -= 2;
            data = 0;
          }
        }
      }
      areg_c_ = (areg_c_ << 8) | data;
      if ((ct_ += 8) < 0)
        if (++ct_ == 0) areg_a_ = 0x8000;  // two initial bytes read
    }
    areg_a_ <<= 1;
  }
  int sv = *st;
  int32_t qe = kQe[sv & 0x7F];
  int nl = qe & 0xFF;
  int nm = (qe >> 8) & 0xFF;
  qe >>= 16;
  // Decoding and probability estimation (D.2.4, D.2.5).
  int64_t temp = areg_a_ - qe;
  areg_a_ = temp;
  temp <<= ct_;
  if (areg_c_ >= temp) {
    areg_c_ -= temp;
    // Conditional LPS exchange.
    if (areg_a_ < qe) {
      areg_a_ = qe;
      *st = (uint8_t)((sv & 0x80) ^ nm);
    } else {
      areg_a_ = qe;
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    }
  } else if (areg_a_ < 0x8000) {
    // Conditional MPS exchange.
    if (areg_a_ < qe) {
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    } else {
      *st = (uint8_t)((sv & 0x80) ^ nm);
    }
  }
  return sv >> 7;
}

// jdmarker.c read_restart_marker and jpeg_resync_to_restart, which Pillow
// keeps as libjpeg's default: the expected RSTn is read; any other marker
// is discarded (an RSTn too far from the expected one), passed over to the
// next marker and judged again (a marker below SOF0, or RST(n-1), RST(n-2)),
// or left unread (any other marker, or RST(n+1), RST(n+2)): the coming
// interval then reads as a segment without data. Then the scan's
// predictions, statistics and insufficient_data start again (the flag only
// with no marker left unread).
void Decoder::restart() {
  reset_bits();
  if (!marker_hit_) {
    if (!seek_marker()) fail("truncated file: missing restart marker");
    marker_hit_ = true;
  }
  const int desired = next_restart_;
  while (true) {
    const int m = d_[pos_ + 1];
    int action;
    if (m < 0xC0)
      action = 2;
    else if (m < 0xD0 || m > 0xD7)
      action = 3;
    else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7))
      action = 3;
    else if (m == 0xD0 + ((desired + 7) & 7) || m == 0xD0 + ((desired + 6) & 7))
      action = 2;
    else
      action = 1;
    if (action == 3) break;
    pos_ += 2;
    marker_hit_ = false;
    if (action == 1) break;
    if (!seek_marker()) fail("truncated file: missing restart marker");
    marker_hit_ = true;
  }
  const size_t read_to = marker_hit_ ? pos_ + 2 : pos_;
  if (arithmetic_) arith_need(read_to);
  need(read_to);
  next_restart_ = (next_restart_ + 1) & 7;
  if (!marker_hit_) insufficient_ = false;
  for (int i = 0; i < ncomp; ++i) comp_[i].dc_pred = 0;
  eobrun_ = 0;
  if (arithmetic_) {
    // jdarith.c process_restart: the scan's statistics start again.
    for (int i = 0; i < ns_; ++i) {
      Component& c = comp_[sidx_[i]];
      if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
        memset(dc_stats_[c.td], 0, sizeof(dc_stats_[c.td]));
        c.dc_context = 0;
      }
      if (!progressive_ || ss_) memset(ac_stats_[c.ta], 0, sizeof(ac_stats_[c.ta]));
    }
    reset_arith();
  }
  if (lossless_) {
    for (int i = 0; i < ns_; ++i) comp_[sidx_[i]].first_row = true;
  }
}

template <bool Fast>
void Decoder::sequential_block(Component& c, int16_t* blk) {
  const Huffman& dc = dc_[c.td];
  const Huffman& ac = ac_[c.ta];
  int s = huff<Fast>(dc);
  if (s > 11) fail("corrupt DC coefficient");
  int diff = s ? extend(bits<Fast>(s), s) : 0;
  c.dc_pred += diff;
  blk[0] = (int16_t)c.dc_pred;
  for (int k = 1; k < 64; ++k) {
    int rs = huff<Fast>(ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      int v = extend(bits<Fast>(s), s);
      blk[kNatural[k]] = (int16_t)v;
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

void Decoder::decode_block(Component& c, int16_t* blk) {
  if (arithmetic_) {
    arith_block(c, blk);
    return;
  }
  if (!progressive_) {
    if (fast_)
      sequential_block<true>(c, blk);
    else
      sequential_block<false>(c, blk);
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
        // A size other than 1 is corrupt: libjpeg warns and reads on.
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

// jdarith.c's decode_mcu (sequential) and decode_mcu_{DC,AC}_{first,refine}
// (progressive) on one block. ct_ == -1 marks a corrupt scan whose other
// blocks libjpeg leaves as they are.
void Decoder::arith_block(Component& c, int16_t* blk) {
  const bool dc_scan = !progressive_ || ss_ == 0;
  if (progressive_ && ss_ == 0 && ah_ != 0) {  // DC refinement: the next bit
    if (arith_decode(&fixed_bin_)) blk[0] = (int16_t)(blk[0] | (1 << al_));
    return;
  }
  if (ct_ == -1) return;
  if (dc_scan) {
    // F.2.4.1: the DC difference, conditioned on the previous one.
    uint8_t* stats = dc_stats_[c.td];
    uint8_t* st = stats + c.dc_context;
    if (arith_decode(st) == 0) {
      c.dc_context = 0;
    } else {
      int sign = arith_decode(st + 1);
      st += 2 + sign;
      int m = arith_decode(st);
      if (m != 0) {
        st = stats + 20;  // X1
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ct_ = -1;  // magnitude overflow
            return;
          }
          st += 1;
        }
      }
      if (m < (int)((1L << dac_l_[c.td]) >> 1))
        c.dc_context = 0;
      else if (m > (int)((1L << dac_u_[c.td]) >> 1))
        c.dc_context = 12 + sign * 4;
      else
        c.dc_context = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      c.dc_pred = (c.dc_pred + v) & 0xffff;
    }
    blk[0] = (int16_t)(progressive_ ? (int16_t)c.dc_pred * (1 << al_) : c.dc_pred);
    if (progressive_) return;
  }
  uint8_t* stats = ac_stats_[c.ta];
  const int k0 = progressive_ ? ss_ : 1, k1 = progressive_ ? se_ : 63;
  if (progressive_ && ah_ != 0) {
    // AC refinement (G.1.3.3): EOBx is the last coefficient already nonzero.
    int p1 = 1 << al_, m1 = -1 * (1 << al_);
    int kex = se_;
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = ss_; k <= se_; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;  // EOB
      while (true) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (arith_decode(st + 2)) *coef = (int16_t)(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (arith_decode(st + 1)) {
          *coef = (int16_t)(arith_decode(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se_) {
          ct_ = -1;  // spectral overflow
          return;
        }
      }
    }
    return;
  }
  // F.2.4.2: the AC coefficients, sequential or a progressive first pass.
  for (int k = k0; k <= k1; ++k) {
    uint8_t* st = stats + 3 * (k - 1);
    if (arith_decode(st)) break;  // EOB
    while (arith_decode(st + 1) == 0) {
      st += 3;
      if (++k > k1) {
        ct_ = -1;  // spectral overflow
        return;
      }
    }
    int sign = arith_decode(&fixed_bin_);
    st += 2;
    int m = arith_decode(st);
    if (m != 0 && arith_decode(st)) {
      m <<= 1;
      st = stats + (k <= dac_k_[c.ta] ? 189 : 217);
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ct_ = -1;  // magnitude overflow
          return;
        }
        st += 1;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    blk[kNatural[k]] = (int16_t)(progressive_ ? (int)((unsigned)v << al_) : v);
  }
}

// A scan's start: quantization tables latched, the progression recorded,
// predictions and statistics reset (jdinput.c, jdphuff.c and jdarith.c
// start_pass).
void Decoder::start_scan() {
  ++scans_;
  for (int i = 0; i < ns_; ++i) {
    Component& c = comp_[sidx_[i]];
    if (!lossless_ && c.qlatched < 0) {
      if (!qdefined_[c.tq]) fail("scan uses an undefined quantization table");
      memcpy(c.q, qt_[c.tq], sizeof(c.q));
      c.qlatched = c.tq;
    }
    if (progressive_) {
      for (int k = ss_ < 1 ? ss_ : 1; k <= (se_ > 9 ? se_ : 9); ++k)
        c.prev_bits[k] = scans_ > 1 ? c.coef_bits[k] : 0;
      for (int k = ss_; k <= se_; ++k) {
        if (ah_ != 0 && c.coef_bits[k] != ah_) fail("corrupt progressive scan sequence");
        c.coef_bits[k] = al_;
      }
    }
    c.dc_pred = 0;
    c.first_row = true;
    if (arithmetic_) {
      if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
        memset(dc_stats_[c.td], 0, sizeof(dc_stats_[c.td]));
        c.dc_context = 0;
      }
      if (!progressive_ || ss_) memset(ac_stats_[c.ta], 0, sizeof(ac_stats_[c.ta]));
    }
  }
  reset_bits();
  reset_arith();
  marker_hit_ = insufficient_ = false;
  next_restart_ = 0;
  eobrun_ = 0;
}

void Decoder::decode_mcu(int mx, int my) {
  if (ns_ == 1) {
    Component& c = comp_[sidx_[0]];
    decode_block(c, &c.coef[((size_t)my * c.bw + mx) * 64]);
    return;
  }
  for (int i = 0; i < ns_; ++i) {
    Component& c = comp_[sidx_[i]];
    for (int v = 0; v < c.v; ++v)
      for (int h = 0; h < c.h; ++h) {
        size_t bx = (size_t)mx * c.h + h, by = (size_t)my * c.v + v;
        decode_block(c, &c.coef[(by * c.bw + bx) * 64]);
      }
  }
}

void Decoder::decode_scan() {
  start_scan();
  if (lossless_) {
    decode_lossless_scan();
  } else {
    const Component& c0 = comp_[sidx_[0]];
    const int mcus_x = ns_ == 1 ? (c0.dw + 7) / 8 : mcux_;
    const int mcus_y = ns_ == 1 ? (c0.dh + 7) / 8 : mcuy_;
    size_t blocks = 0;
    for (int i = 0; i < ns_; ++i) blocks += ns_ == 1 ? 1 : comp_[sidx_[i]].h * comp_[sidx_[i]].v;
    // jdhuff.c decode_mcu (sequential Huffman) takes its fast path without
    // restart intervals, before any marker, with 512 bytes a block left of
    // what Pillow has handed it; it suspends and retries an MCU whose slow
    // path runs past that, and retries a fast MCU that met a marker on the
    // slow path. The refills differ, and so whether a cut file is read.
    const bool huffman_sequential = !arithmetic_ && !progressive_;
    int togo = restart_interval_;
    for (int my = 0; my < mcus_y; ++my)
      for (int mx = 0; mx < mcus_x; ++mx) {
        const size_t pos = pos_;
        const uint64_t acc = acc_;
        const int nbits = nbits_, saved_togo = togo, next_restart = next_restart_;
        const bool hit = marker_hit_, insufficient = insufficient_;
        int preds[4];
        for (int i = 0; i < ns_; ++i) preds[i] = comp_[sidx_[i]].dc_pred;
        auto retry = [&]() {
          pos_ = pos;
          acc_ = acc;
          nbits_ = nbits;
          togo = saved_togo;
          marker_hit_ = hit;
          insufficient_ = insufficient;
          next_restart_ = next_restart;
          fast_marker_ = false;
          for (int i = 0; i < ns_; ++i) comp_[sidx_[i]].dc_pred = preds[i];
        };
        // jdcoefct.c consume_data: the smoothing of a later iMCU row takes
        // the coefficient bits from before this scan.
        if (!insufficient_) last_good_ = ns_ == 1 ? my / c0.v : my;
        suspendable_ = huffman_sequential;
        while (true) {
          try {
            if (restart_interval_) {
              if (togo == 0) {
                restart();
                togo = restart_interval_;
              }
              --togo;
            }
            // Out of data: the MCU keeps its coefficients, the predictions
            // do not move (arithmetic coding reads zeros instead).
            if (insufficient_) break;
            fast_ = huffman_sequential && !restart_interval_ && !marker_hit_ &&
                    chunk_end_ >= pos_ + 512 * blocks;
            decode_mcu(mx, my);
            if (fast_marker_) {
              retry();
              fast_ = false;
              decode_mcu(mx, my);
            }
            break;
          } catch (const Suspend&) {
            retry();
            fast_ = false;
            need(chunk_end_ + 1);
          }
        }
        suspendable_ = fast_ = false;
      }
  }
  // Past the scan's entropy data, to its closing marker.
  reset_bits();
  while (true) {
    if (pos_ + 1 >= n_) return;  // no marker after the scan: decode() decides
    if (d_[pos_] == 0xFF && d_[pos_ + 1] != 0x00 && d_[pos_ + 1] != 0xFF &&
        !(d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7))
      break;
    ++pos_;
  }
}

// jdlhuff.c, jddiffct.c: a lossless scan's differences MCU row by MCU row,
// each iMCU row undifferenced once its MCU rows are read. A restart (only
// at an MCU row's start) sets every component of the scan back to the
// first-row predictor, which the next row it undifferences uses.
void Decoder::decode_lossless_scan() {
  const bool interleaved = ns_ > 1;
  const Component& c0 = comp_[sidx_[0]];
  const int mcus_per_row = interleaved ? mcux_ : c0.dw;
  if (restart_interval_ % mcus_per_row)
    fail("corrupt lossless restart interval (not a whole number of MCU rows)");
  const int restart_rows = restart_interval_ / mcus_per_row;
  int rows_to_go = restart_rows;
  for (int imcu = 0; imcu < mcuy_; ++imcu) {
    const int mcu_rows = interleaved ? 1 : (imcu < mcuy_ - 1 ? c0.v : c0.dh - imcu * c0.v);
    for (int y = 0; y < mcu_rows; ++y) {
      if (restart_interval_) {
        if (rows_to_go == 0) {
          restart();
          rows_to_go = restart_rows;
        }
      }
      if (insufficient_) {
        // jdlhuff.c decode_mcus out of data: the row's differences are
        // zeros and the predictors start again, as after a restart.
        for (int i = 0; i < ns_; ++i) comp_[sidx_[i]].first_row = true;
        if (restart_interval_) --rows_to_go;
        continue;
      }
      for (int mx = 0; mx < mcus_per_row; ++mx) {
        for (int i = 0; i < ns_; ++i) {
          Component& c = comp_[sidx_[i]];
          const int nv = interleaved ? c.v : 1, nh = interleaved ? c.h : 1;
          const int row0 = interleaved ? imcu * c.v : imcu * c.v + y;
          for (int v = 0; v < nv; ++v)
            for (int h = 0; h < nh; ++h) {
              int s = huff(dc_[c.td]);
              int diff = 0;
              if (s == 16) {
                diff = 32768;
              } else if (s > 16) {
                fail("corrupt lossless difference");
              } else if (s) {
                diff = extend(bits(s), s);
              }
              c.diff[(size_t)(row0 + v) * c.bw + (size_t)mx * nh + h] = diff;
            }
        }
      }
      if (restart_interval_) --rows_to_go;
    }
    for (int i = 0; i < ns_; ++i) {
      Component& c = comp_[sidx_[i]];
      int end = (imcu + 1) * c.v < c.dh ? (imcu + 1) * c.v : c.dh;
      for (int row = imcu * c.v; row < end; ++row) undifference_row(c, row);
    }
  }
}

// jdlossls.c: one row of samples from its differences, modulo 2^16.
void Decoder::undifference_row(Component& c, int row) {
  const int32_t* diff = &c.diff[(size_t)row * c.bw];
  uint16_t* out = &c.undiff[(size_t)row * c.dw];
  if (c.first_row) {
    // The first row of the scan or of a restart interval: 2^(P - Pt - 1)
    // then the sample to the left.
    int ra = (diff[0] + (1 << (8 - al_ - 1))) & 0xFFFF;
    out[0] = (uint16_t)ra;
    for (int x = 1; x < c.dw; ++x) out[x] = (uint16_t)(ra = (diff[x] + ra) & 0xFFFF);
    c.first_row = false;
    return;
  }
  const uint16_t* prev = out - c.dw;
  int ra = (diff[0] + prev[0]) & 0xFFFF;  // column 0: the sample above
  out[0] = (uint16_t)ra;
  for (int x = 1; x < c.dw; ++x) {
    int64_t rb = prev[x], rc = prev[x - 1], pred;
    switch (ss_) {
      case 1: pred = ra; break;
      case 2: pred = rb; break;
      case 3: pred = rc; break;
      case 4: pred = ra + rb - rc; break;
      case 5: pred = ra + ((rb - rc) >> 1); break;
      case 6: pred = rb + ((ra - rc) >> 1); break;
      default: pred = (ra + rb) >> 1; break;
    }
    out[x] = (uint16_t)(ra = (int)((diff[x] + pred) & 0xFFFF));
  }
}

// jidctint.c's jpeg_idct_islow on one block, as libjpeg-turbo's x86 SIMD
// version (jidctint-avx2.asm, jidctint-sse2.asm), which Pillow runs,
// computes it: coefficients dequantised in 16 bits (vpmullw keeps the low
// half), the sums the SIMD code forms in 16 bits (in0 ± in4, in1 + in5,
// in3 + in7 in its reordering) wrapped there, the products exact in 32
// bits, the first pass's results saturated to 16 bits and the second's to
// -128..127 before the +128. A block whose rows 1-7 are all zero takes the
// SIMD code's shortcut: row 0 dequantised and shifted left by PASS1_BITS in
// 16 bits. On coefficients of ordinary data no step overflows and this is
// the C version's arithmetic; a corrupt scan's coefficients reach the
// wraps and the saturations.
#define CONST_BITS 13
#define PASS1_BITS 2
const int64_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270,
              F_0_899 = 7373, F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137,
              F_1_961 = 16069, F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int16_t wrap16(int64_t v) { return (int16_t)(uint16_t)(uint64_t)v; }
inline int16_t sat16(int64_t v) { return (int16_t)(v < -32768 ? -32768 : v > 32767 ? 32767 : v); }

// One 1-D pass over x[0..7] (stride `step`): the eight sums before the
// descale, each wrapped to 32 bits as the SIMD code's paddd/psubd leave it.
inline void idct_pass(const int16_t* x, int step, int32_t* o) {
  const int64_t z2 = x[2 * step], z3 = x[6 * step];
  const int64_t tmp3 = z2 * (F_0_541 + F_0_765) + z3 * F_0_541;
  const int64_t tmp2 = z2 * F_0_541 + z3 * (F_0_541 - F_1_847);
  const int64_t tmp0 = (int64_t)wrap16(x[0] + x[4 * step]) * (1 << CONST_BITS);
  const int64_t tmp1 = (int64_t)wrap16(x[0] - x[4 * step]) * (1 << CONST_BITS);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                tmp12 = tmp1 - tmp2;
  const int64_t t0 = x[7 * step], t1 = x[5 * step], t2 = x[3 * step], t3 = x[step];
  const int64_t s3 = wrap16(t0 + t2), s4 = wrap16(t1 + t3);
  const int64_t z3o = s3 * (F_1_175 - F_1_961) + s4 * F_1_175;
  const int64_t z4o = s3 * F_1_175 + s4 * (F_1_175 - F_0_390);
  const int64_t o0 = t0 * (F_0_298 - F_0_899) + t3 * -F_0_899 + z3o;
  const int64_t o3 = t0 * -F_0_899 + t3 * (F_1_501 - F_0_899) + z4o;
  const int64_t o1 = t1 * (F_2_053 - F_2_562) + t2 * -F_2_562 + z4o;
  const int64_t o2 = t1 * -F_2_562 + t2 * (F_3_072 - F_2_562) + z3o;
  const int64_t r[8] = {tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
                        tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3};
  for (int i = 0; i < 8; ++i) o[i] = (int32_t)(uint32_t)(uint64_t)r[i];
}

inline int32_t descale32(int32_t v, int n) {
  return (int32_t)((uint32_t)v + (1u << (n - 1))) >> n;
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int16_t ws[64];
  bool rows_zero = true;
  for (int k = 8; k < 64 && rows_zero; ++k) rows_zero = in[k] == 0;
  if (rows_zero) {
    for (int c = 0; c < 8; ++c) {
      const int16_t v = wrap16((int64_t)wrap16((int64_t)in[c] * q[c]) << PASS1_BITS);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
    }
  } else {
    int16_t deq[64];
    for (int k = 0; k < 64; ++k) deq[k] = wrap16((int64_t)in[k] * q[k]);
    int32_t o[8];
    for (int c = 0; c < 8; ++c) {
      idct_pass(deq + c, 8, o);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = sat16(descale32(o[r], CONST_BITS - PASS1_BITS));
    }
  }
  int32_t o[8];
  for (int r = 0; r < 8; ++r) {
    idct_pass(ws + 8 * r, 1, o);
    uint8_t* op = out + (size_t)r * stride;
    for (int c = 0; c < 8; ++c) {
      const int32_t v = descale32(o[c], CONST_BITS + PASS1_BITS + 3);
      op[c] = (uint8_t)((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
    }
  }
}

// Box replication (jdsample.c int_upsample, h2v1_upsample, h2v2_upsample):
// what a lossless file gets, whose DCT scaled size of 1 turns fancy
// upsampling off.
void box_upsample(const uint8_t* in, int stride, int rh, int rv, int width, int height,
                  uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* ip = in + (size_t)(y / rv) * stride;
    uint8_t* op = out + (size_t)y * width;
    for (int x = 0; x < width; ++x) op[x] = ip[x / rh];
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

// jdcoefct.c smoothing_ok: every component's quantization table latched,
// with nonzero entries at the DC and coefficients 1-9, its DC at least
// partly known, and some coefficient 1-9 of some component not fully
// refined.
const int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};  // zigzag 0-9, natural order

bool Decoder::smoothing_ok() const {
  bool useful = false;
  for (int i = 0; i < ncomp; ++i) {
    const Component& c = comp_[i];
    if (c.qlatched < 0) return false;
    for (int k = 0; k < 10; ++k)
      if (c.q[kSmoothPos[k]] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo >= 2.1) on block (bx,
// by) of `c`: coefficients 1-9 that are still zero and not known exactly
// are estimated from the 5×5 neighbourhood of DC values (DC01-DC25, row by
// row; edges replicated), and the DC too where no coefficient 1-9 is known
// at all. The rows follow libjpeg's iMCU-row arithmetic, quirks included.
void Decoder::smooth_block(const Component& c, int bx, int by, int16_t* ws) const {
  const int wib = (c.dw + 7) / 8, hib = (c.dh + 7) / 8;
  const int v = c.v, total = mcuy_;
  const int imcu = by / v, block_row = by % v;
  int block_rows = v;
  if (imcu == total - 1) {
    block_rows = hib % v;
    if (block_rows == 0) block_rows = v;
  }
  const long ibr = (long)imcu * block_rows + block_row, ibrs = (long)block_rows * total;
  int rows[5];
  rows[2] = by;
  rows[1] = ibr > 0 ? by - 1 : by;
  rows[0] = ibr > 1 ? by - 2 : rows[1];
  rows[3] = ibr < ibrs - 1 ? by + 1 : by;
  rows[4] = ibr < ibrs - 2 ? by + 2 : rows[3];
  int dc[26];  // dc[1..25] as libjpeg's DC01..DC25
  for (int r = 0; r < 5; ++r)
    for (int d = 0; d < 5; ++d) {
      int x = bx + d - 2;
      x = x < 0 ? 0 : x > wib - 1 ? wib - 1 : x;
      dc[1 + 5 * r + d] = c.coef[((size_t)rows[r] * c.bw + x) * 64];
    }
  // A row past the last one read with data in hand: the bits from before
  // the component's latest scan (jdcoefct.c, last_good_iMCU_row).
  int prev[10];
  for (int k = 1; k < 10; ++k) prev[k] = scans_ > 1 ? c.prev_bits[k] : -1;
  const int* cb = imcu > last_good_ ? prev : c.coef_bits;
  const bool change_dc = cb[1] == -1 && cb[2] == -1 && cb[3] == -1 && cb[4] == -1 &&
                         cb[5] == -1 && cb[6] == -1 && cb[7] == -1 && cb[8] == -1 &&
                         cb[9] == -1;
  const int64_t q00 = c.q[0];
  auto estimate = [&](int k, int64_t weighted) {
    const int al = cb[k], pos = kSmoothPos[k];
    if (al == 0 || ws[pos] != 0) return;
    const int64_t qk = c.q[pos], num = q00 * weighted;
    int pred = (int)(((qk << 7) + (num >= 0 ? num : -num)) / (qk << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    ws[pos] = (int16_t)(num >= 0 ? pred : -pred);
  };
  const int* D = dc;
  if (change_dc) {
    estimate(1, -D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10] -
                    3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] -
                    13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25]);
    estimate(2, -D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] + 38 * D[8] +
                    13 * D[9] - D[10] + D[16] - 13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] +
                    D[21] + 3 * D[22] + 3 * D[23] + 3 * D[24] + D[25]);
    estimate(3, D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] - 5 * D[14] +
                    2 * D[17] + 7 * D[18] + 2 * D[19] + D[23]);
    estimate(4, -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25]);
    estimate(5, 2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] + 7 * D[14] +
                    D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19]);
    estimate(6, D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]);
    estimate(7, D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]);
    estimate(8, D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]);
    estimate(9, D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]);
    // The DC: a weighted mean (the weights sum to 256) of the 25 DC values.
    const int64_t num =
        q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] + 6 * D[7] +
               42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] + 42 * D[12] + 152 * D[13] +
               42 * D[14] - 8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] -
               6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25]);
    const int pred = (int)(((q00 << 7) + (num >= 0 ? num : -num)) / (q00 << 8));
    ws[0] = (int16_t)(num >= 0 ? pred : -pred);
  } else {
    estimate(1, -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]);
    estimate(2, -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]);
    estimate(3, -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]);
    estimate(4, D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24] + D[4] -
                    D[6] + 10 * D[7] - 10 * D[9]);
    estimate(5, -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]);
  }
}

void Decoder::finish(uint8_t* out) {
  const bool smooth = progressive_ && smoothing_ok();
  std::vector<uint8_t> planes[4];
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp_[i];
    std::vector<uint8_t> samples;
    int stride;
    if (lossless_) {
      // The reconstructed samples shifted back by the point transform.
      stride = c.dw;
      samples.resize(c.undiff.size());
      for (size_t p = 0; p < samples.size(); ++p) samples[p] = (uint8_t)(c.undiff[p] << al_);
    } else {
      if (c.qlatched < 0) {
        if (!qdefined_[c.tq]) fail("component has no quantization table");
        memcpy(c.q, qt_[c.tq], sizeof(c.q));
      }
      int bx = (c.dw + 7) / 8, by = (c.dh + 7) / 8;
      stride = bx * 8;
      samples.resize((size_t)stride * by * 8);
      int16_t ws[64];
      for (int y = 0; y < by; ++y)
        for (int x = 0; x < bx; ++x) {
          const int16_t* blk = &c.coef[((size_t)y * c.bw + x) * 64];
          if (smooth) {
            memcpy(ws, blk, sizeof(ws));
            smooth_block(c, x, y, ws);
            blk = ws;
          }
          idct_islow(blk, c.q, &samples[(size_t)y * 8 * stride + x * 8], stride);
        }
    }
    planes[i].resize((size_t)width * height);
    if (lossless_)
      box_upsample(samples.data(), stride, hmax_ / c.h, vmax_ / c.v, width, height,
                   planes[i].data());
    else
      upsample(samples.data(), stride, c.dw, c.dh, hmax_ / c.h, vmax_ / c.v, width, height,
               planes[i].data());
  }
  size_t npix = (size_t)width * height;
  if (ncomp == 1) {
    for (size_t p = 0; p < npix; ++p) out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = planes[0][p];
    return;
  }
  if (ncomp == 4) {
    bool ycck = saw_adobe_ && adobe_transform_ != 0;
    if (lossless_ && ycck) fail("a lossless YCCK JPEG is not supported (libjpeg converts no color in lossless mode)");
    cmyk_to_rgb(planes, npix, ycck, out);
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
  if (lossless_) fail("a lossless YCbCr JPEG is not supported (libjpeg converts no color in lossless mode)");
  const YccTables t;
  for (size_t p = 0; p < npix; ++p) {
    int y = planes[0][p], cb = planes[1][p], cr = planes[2][p];
    out[3 * p] = limit(y + t.cr_r[cr]);
    out[3 * p + 1] = limit(y + t.g(cb, cr));
    out[3 * p + 2] = limit(y + t.cb_b[cb]);
  }
}

void Decoder::decode(uint8_t* out) {
  // A single-scan file (sequential, every component in its first scan) is
  // read by libjpeg in its output pass, which needs nothing after that scan:
  // Pillow ignores what jpeg_finish_decompress then meets, even the end of
  // the file. Any other file is read to its EOI marker first.
  bool first_scan_read = false, multi_scan = false;
  try {
    while (true) {
      int m = next_marker();
      if (m == 0xDA) {
        read_sos();
        if (!first_scan_read) {
          multi_scan = progressive_ || ns_ < ncomp;
          decode_scan();
          first_scan_read = true;
        } else if (multi_scan) {
          decode_scan();
        }
      } else if (m == 0xD9) {
        break;
      } else if (m < 0) {
        fail("truncated file: it ends before its EOI marker");
      } else if (table_marker(m)) {
      } else if (m >= 0xC0 && m <= 0xCF && m != 0xC8) {
        fail("more than one frame header");
      } else if (m == 0xDC) {
        fail("a DNL marker is not supported");
      } else if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      } else {
        skip_segment();
      }
    }
  } catch (const Failure& f) {
    if (!first_scan_read || multi_scan || f.msg.compare(0, 9, "truncated") != 0) throw;
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
