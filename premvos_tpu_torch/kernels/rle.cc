// COCO RLE mask codec: the port's copy of native/rle/rle.cc, host code
// bound by ctypes (premvos_tpu_torch/io_compat/rle_native.py), built by
// premvos_tpu_torch/kernels/__init__.py::build_host at first use.
//
// pycocotools' format: column-major runs starting with background, packed
// as base-32 ascii with the counts after the first two delta-encoded against
// the count two back. The numpy codec (io_compat/rle.py) is the oracle; the
// tests hold the two byte for byte.

#include <cstdint>
#include <cstring>

extern "C" {

// Binary [h, w] row-major mask → column-major run lengths.
// counts_out must hold at least h*w + 1 entries. Returns the run count.
int rle_encode_counts(const uint8_t* mask, int h, int w, int64_t* counts_out) {
  int n = 0;
  int64_t run = 0;
  uint8_t cur = 0;  // runs always start with background
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) {
      uint8_t v = mask[(int64_t)y * w + x] ? 1 : 0;
      if (v == cur) {
        ++run;
      } else {
        counts_out[n++] = run;
        cur = v;
        run = 1;
      }
    }
  }
  counts_out[n++] = run;
  return n;
}

// Column-major run lengths → binary [h, w] row-major mask.
// Returns 0 on success, -1 if counts do not sum to h*w.
int rle_decode_mask(const int64_t* counts, int n, int h, int w,
                    uint8_t* mask_out) {
  int64_t total = 0;
  for (int i = 0; i < n; ++i) total += counts[i];
  if (total != (int64_t)h * w) return -1;
  int64_t pos = 0;  // column-major linear position
  for (int i = 0; i < n; ++i) {
    uint8_t v = i & 1;
    for (int64_t k = 0; k < counts[i]; ++k, ++pos) {
      int64_t y = pos % h, x = pos / h;
      mask_out[y * w + x] = v;
    }
  }
  return 0;
}

// Run lengths → compressed ascii string (COCO format: 5 bits/char offset 48,
// 0x20 continuation, counts after the first two delta-encoded vs two back).
// out must hold ~13 chars per count. Returns the string length.
int rle_counts_to_string(const int64_t* counts, int n, char* out) {
  int p = 0;
  for (int i = 0; i < n; ++i) {
    int64_t x = counts[i];
    if (i > 2) x -= counts[i - 2];
    bool more = true;
    while (more) {
      int c = (int)(x & 0x1f);
      x >>= 5;  // arithmetic shift on signed
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      out[p++] = (char)(c + 48);
    }
  }
  return p;
}

// Compressed ascii string → run lengths. counts_out must hold len entries.
// Returns the run count, or -1 on a truncated string.
int rle_string_to_counts(const char* s, int len, int64_t* counts_out) {
  int n = 0;
  int i = 0;
  while (i < len) {
    int64_t x = 0;
    int k = 0;
    while (true) {
      if (i >= len) return -1;
      int c = s[i] - 48;
      x |= (int64_t)(c & 0x1f) << (5 * k);
      ++i;
      ++k;
      if (!(c & 0x20)) {
        if (c & 0x10) x |= ~(int64_t)0 << (5 * k);  // sign-extend
        break;
      }
    }
    if (n > 2) x += counts_out[n - 2];
    counts_out[n++] = x;
  }
  return n;
}

// Dense-pair IoU between two run-length masks without materializing pixels.
// Walks both run lists in lockstep over the column-major axis.
double rle_iou(const int64_t* ca, int na, const int64_t* cb, int nb) {
  int64_t ia = 0, ib = 0;        // run indices
  int64_t ra = ca[0], rb = cb[0];  // remaining in current run
  int64_t inter = 0, uni = 0;
  while (ia < na && ib < nb) {
    while (ra == 0 && ia + 1 < na) ra = ca[++ia];
    while (rb == 0 && ib + 1 < nb) rb = cb[++ib];
    if (ra == 0 && rb == 0) break;
    int64_t step = ra < rb ? ra : rb;
    if (step == 0) step = ra > rb ? ra : rb;  // one side exhausted
    bool va = ia & 1, vb = ib & 1;
    if (va && vb) inter += step;
    if (va || vb) uni += step;
    ra -= (ra >= step) ? step : ra;
    rb -= (rb >= step) ? step : rb;
    if (ra == 0 && ia + 1 >= na && rb == 0 && ib + 1 >= nb) break;
  }
  return uni ? (double)inter / (double)uni : 0.0;
}

}  // extern "C"
