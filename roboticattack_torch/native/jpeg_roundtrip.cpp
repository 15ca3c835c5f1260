// JPEG round trip of an RGB frame, as TensorFlow's tf.image.encode_jpeg
// followed by tf.io.decode_image does it: encode with jpeg_set_defaults and
// quality 95 (4:2:0 chroma, baseline Huffman tables), decode with the fast
// integer IDCT (JDCT_IFAST) and fancy upsampling into RGB. The LIBERO eval
// frames go through it (eval/processing.py libero_frame).
//
// Built by roboticattack_torch/eval/jpeg.py with g++ against the headers in
// native/include and Pillow's bundled libjpeg.

#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>

#include <jpeglib.h>  // must follow <cstdio>/<cstddef> (uses FILE/size_t)

namespace {

struct ErrorManager {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<ErrorManager*>(cinfo->err)->jump, 1);
}

// RGB [h, w, 3] -> a JPEG in *buf (malloc'd by libjpeg, freed by the caller).
int encode(const uint8_t* rgb, int h, int w, int quality, unsigned char** buf,
           unsigned long* len) {
  jpeg_compress_struct cinfo;
  ErrorManager err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  if (setjmp(err.jump)) {
    jpeg_destroy_compress(&cinfo);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, buf, len);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) + static_cast<size_t>(cinfo.next_scanline) * w * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return 0;
}

// A JPEG of an [h, w] frame -> RGB [h, w, 3] in out.
int decode(const unsigned char* jpg, unsigned long len, int h, int w, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  ErrorManager err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(jpg), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.dct_method = JDCT_IFAST;
  cinfo.out_color_space = JCS_RGB;
  cinfo.do_fancy_upsampling = TRUE;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != w || static_cast<int>(cinfo.output_height) != h ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

// rgb and out: [h, w, 3] uint8, C order (they may not alias). Returns the
// size of the intermediate JPEG in bytes, or -1 on a libjpeg error.
long jpeg_roundtrip_rgb(const uint8_t* rgb, int h, int w, int quality, uint8_t* out) {
  unsigned char* buf = nullptr;
  unsigned long len = 0;
  long rc = encode(rgb, h, w, quality, &buf, &len);
  if (rc == 0) rc = decode(buf, len, h, w, out) == 0 ? static_cast<long>(len) : -1;
  free(buf);
  return rc;
}

}  // extern "C"
