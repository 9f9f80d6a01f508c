/* A small JPEG writer over libjpeg, for scripts/make_jpeg_codings_fixtures.py.

     jpeg_codings_encoder IN.raw OUT.jpg WIDTH HEIGHT COMPONENTS [key=value ...]

   IN.raw holds HEIGHT x WIDTH x COMPONENTS bytes (1: gray, 3: RGB). Keys:
     quality=N        quantisation quality (jpeg_set_quality, baseline tables)
     arith=1          arithmetic coding (SOF9, or SOF10 when progressive)
     progressive=1    jpeg_simple_progression's scan script
     lossless=P,T     lossless JPEG (SOF3) at predictor P, point transform T;
                      needs a build with -DWITH_LOSSLESS linked against
                      libjpeg-turbo 3, whose jpeg_enable_lossless the 2.x
                      header does not declare
     sampling=HxV,..  each component's sampling factors (2x2,1x1,1x1: 4:2:0)
     restart=N        a restart marker every N MCUs
     restart_rows=N   a restart marker every N MCU rows
     dac=L,U,K        the arithmetic conditioning of every table (DAC)
   Exits 0, or 1 with a message on stderr. */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

#ifdef WITH_LOSSLESS
extern void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value,
                                 int point_transform);
#endif

static int fail(const char *msg) {
  fprintf(stderr, "jpeg_codings_encoder: %s\n", msg);
  return 1;
}

int main(int argc, char **argv) {
  if (argc < 6) return fail("usage: IN.raw OUT.jpg WIDTH HEIGHT COMPONENTS [key=value ...]");
  int width = atoi(argv[3]), height = atoi(argv[4]), ncomp = atoi(argv[5]);
  if (width <= 0 || height <= 0 || (ncomp != 1 && ncomp != 3)) return fail("bad image size");
  size_t nbytes = (size_t)width * height * ncomp;
  unsigned char *pixels = malloc(nbytes);
  FILE *in = fopen(argv[1], "rb");
  if (!pixels || !in || fread(pixels, 1, nbytes, in) != nbytes) return fail("cannot read IN.raw");
  fclose(in);

  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  FILE *out = fopen(argv[2], "wb");
  if (!out) return fail("cannot write OUT.jpg");
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = ncomp;
  cinfo.in_color_space = ncomp == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);

  for (int i = 6; i < argc; ++i) {
    char *eq = strchr(argv[i], '=');
    if (!eq) return fail("arguments after COMPONENTS are key=value");
    *eq = 0;
    const char *key = argv[i], *val = eq + 1;
    if (!strcmp(key, "quality")) {
      jpeg_set_quality(&cinfo, atoi(val), TRUE);
    } else if (!strcmp(key, "arith")) {
      cinfo.arith_code = atoi(val) != 0;
    } else if (!strcmp(key, "progressive")) {
      if (atoi(val)) jpeg_simple_progression(&cinfo);
    } else if (!strcmp(key, "lossless")) {
#ifdef WITH_LOSSLESS
      int psv, pt;
      if (sscanf(val, "%d,%d", &psv, &pt) != 2) return fail("lossless=P,T");
      jpeg_enable_lossless(&cinfo, psv, pt);
#else
      return fail("lossless needs a build with -DWITH_LOSSLESS");
#endif
    } else if (!strcmp(key, "sampling")) {
      const char *p = val;
      for (int c = 0; c < ncomp; ++c) {
        int h, v, n;
        if (sscanf(p, "%dx%d%n", &h, &v, &n) != 2) return fail("sampling=HxV,HxV,...");
        cinfo.comp_info[c].h_samp_factor = h;
        cinfo.comp_info[c].v_samp_factor = v;
        p += n;
        if (*p == ',') ++p;
      }
    } else if (!strcmp(key, "restart")) {
      cinfo.restart_interval = atoi(val);
    } else if (!strcmp(key, "restart_rows")) {
      cinfo.restart_in_rows = atoi(val);
    } else if (!strcmp(key, "dac")) {
      int l, u, k;
      if (sscanf(val, "%d,%d,%d", &l, &u, &k) != 3) return fail("dac=L,U,K");
      for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
        cinfo.arith_dc_L[t] = (UINT8)l;
        cinfo.arith_dc_U[t] = (UINT8)u;
        cinfo.arith_ac_K[t] = (UINT8)k;
      }
    } else {
      return fail("unknown key");
    }
  }

  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = pixels + (size_t)cinfo.next_scanline * width * ncomp;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  free(pixels);
  return 0;
}
