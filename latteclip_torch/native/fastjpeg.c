/* _fastjpeg: fused JPEG decode + crop + resize for the train input path.
 *
 * The train-time RandomResizedCrop only needs a ~224px crop of the image, so
 * full-resolution decode + PIL bicubic resize (the host-side bottleneck
 * measured on few-core hosts) is wasted work. This module:
 *   1. decodes with libjpeg's DCT scaling (1/1..1/8) chosen so the crop
 *      region is still >= the output size (no information loss below the
 *      target resolution);
 *   2. crops the requested box (given in original-image coordinates);
 *   3. bilinearly resizes to the square output.
 *
 * Train-augmentation-only by design: eval keeps the PIL bicubic pipeline for
 * exact torchvision parity (see latteclip_tpu/data/transforms.py).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <jpeglib.h>
#include <setjmp.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
  struct jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
} fj_error_mgr;

static void fj_error_exit(j_common_ptr cinfo) {
  fj_error_mgr *err = (fj_error_mgr *)cinfo->err;
  longjmp(err->setjmp_buffer, 1);
}

/* bilinear sample from src (h x w x 3, row stride = w*3) at fractional
 * coordinates; clamped to the image */
static inline void bilinear(const uint8_t *src, int h, int w, double fy,
                            double fx, uint8_t *out) {
  if (fy < 0) fy = 0;
  if (fx < 0) fx = 0;
  if (fy > h - 1) fy = h - 1;
  if (fx > w - 1) fx = w - 1;
  int y0 = (int)fy, x0 = (int)fx;
  int y1 = y0 + 1 < h ? y0 + 1 : y0;
  int x1 = x0 + 1 < w ? x0 + 1 : x0;
  double wy = fy - y0, wx = fx - x0;
  for (int c = 0; c < 3; c++) {
    double top = src[(y0 * w + x0) * 3 + c] * (1 - wx) +
                 src[(y0 * w + x1) * 3 + c] * wx;
    double bot = src[(y1 * w + x0) * 3 + c] * (1 - wx) +
                 src[(y1 * w + x1) * 3 + c] * wx;
    double v = top * (1 - wy) + bot * wy;
    out[c] = (uint8_t)(v + 0.5);
  }
}

/* decode_crop_resize(jpeg_bytes, x, y, cw, ch, out_size) -> bytes
 * (x, y, cw, ch) is the crop box in original-image pixel coordinates. */
static PyObject *decode_crop_resize(PyObject *self, PyObject *args) {
  Py_buffer buf;
  int cx, cy, cw, ch, out_size;
  if (!PyArg_ParseTuple(args, "y*iiiii", &buf, &cx, &cy, &cw, &ch, &out_size))
    return NULL;

  struct jpeg_decompress_struct cinfo;
  fj_error_mgr jerr;
  /* volatile: live across setjmp/longjmp — without it the error path's
   * free(pixels) may read a register-cached (indeterminate) value (C11
   * 7.13.2.1p2) */
  uint8_t *volatile pixels = NULL;
  PyObject *volatile result = NULL;

  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = fj_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    free(pixels);
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "libjpeg decode failed");
    return NULL;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, (const unsigned char *)buf.buf, (unsigned long)buf.len);
  jpeg_read_header(&cinfo, TRUE);

  /* pick the largest DCT downscale that keeps the crop >= out_size */
  int denom = 1;
  while (denom < 8 && (cw / (denom * 2) >= out_size) &&
         (ch / (denom * 2) >= out_size))
    denom *= 2;
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  int w = cinfo.output_width, h = cinfo.output_height;
  pixels = (uint8_t *)malloc((size_t)w * h * 3);
  if (!pixels) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    PyBuffer_Release(&buf);
    return PyErr_NoMemory();
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pixels + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  double full_w = (double)cinfo.image_width, full_h = (double)cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  PyBuffer_Release(&buf);

  /* map the original-coordinate crop box into the scaled image */
  double sx = w / full_w, sy = h / full_h;
  double bx = cx * sx, by = cy * sy, bw = cw * sx, bh = ch * sy;

  result = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)out_size * out_size * 3);
  if (!result) {
    free(pixels);
    return NULL;
  }
  uint8_t *out = (uint8_t *)PyBytes_AS_STRING(result);

  /* PIL-convention sampling grid: center of output pixel i maps to
   * box_start + (i + 0.5) * box_extent / out_size - 0.5 */
  for (int oy = 0; oy < out_size; oy++) {
    double fy = by + (oy + 0.5) * bh / out_size - 0.5;
    for (int ox = 0; ox < out_size; ox++) {
      double fx = bx + (ox + 0.5) * bw / out_size - 0.5;
      bilinear(pixels, h, w, fy, fx, out + ((size_t)oy * out_size + ox) * 3);
    }
  }
  free(pixels);
  return result;
}

/* probe(jpeg_bytes) -> (width, height) without full decode */
static PyObject *probe(PyObject *self, PyObject *args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return NULL;
  struct jpeg_decompress_struct cinfo;
  fj_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = fj_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "libjpeg header parse failed");
    return NULL;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, (const unsigned char *)buf.buf, (unsigned long)buf.len);
  jpeg_read_header(&cinfo, TRUE);
  int w = cinfo.image_width, h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  PyBuffer_Release(&buf);
  return Py_BuildValue("(ii)", w, h);
}

static PyMethodDef methods[] = {
    {"decode_crop_resize", decode_crop_resize, METH_VARARGS,
     "decode_crop_resize(jpeg_bytes, x, y, cw, ch, out_size) -> rgb bytes"},
    {"probe", probe, METH_VARARGS, "probe(jpeg_bytes) -> (width, height)"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_fastjpeg",
                                       NULL, -1, methods};

PyMODINIT_FUNC PyInit__fastjpeg(void) { return PyModule_Create(&moduledef); }
