// Native JPEG decode and fused decode->preprocess of the port's host data
// pipeline (diffvit_tpu_torch/data/native_decode.py binds it with ctypes).
//
// Decodes baseline/progressive JPEG with libjpeg using JDCT_ISLOW — the
// method Pillow uses — into RGB, so the decoded pixels equal
// PIL.Image.open(...).convert("RGB")'s (tests/test_torch_native_decode.py),
// then hands them to the bit-exact-Pillow resample/crop/normalize of
// preproc.cpp without touching Python objects.  One C call stands for PIL's
// decode plus the eval transform (data/imagenet.build_transform) per image;
// the batch entries loop with OpenMP and hold no Python lock.
//
// The library is linked against the libjpeg that Pillow itself loads, and
// compiled against the ABI-62 headers in include/ (ops/kernels/build.py).
//
// Exposed C ABI (ctypes):
//   jpeg_shape(buf, len, &h, &w)            -> 0 ok / <0 error
//   jpeg_decode_rgb(buf, len, dst_u8_hwc)   -> 0 ok / <0 error
//   jpeg_decode_preprocess(buf, len, dst_f32_chw, resize_to, crop,
//                          mean, std)       -> 0 ok / <0 error
//   jpeg_decode_preprocess_fast(...)        -> same, DCT-scaled decode
//                                              (non-bit-exact fast mode)
//   jpeg_decode_preprocess_u8(buf, len, dst_u8_chw, resize_to, crop, fast)
//   jpeg_decode_preprocess_batch(bufs, lens, n, dst, resize_to, crop,
//                                mean, std, status, fast)
//   jpeg_decode_preprocess_batch_u8(bufs, lens, n, dst, resize_to, crop,
//                                   status, fast)

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <vector>

#include <jpeglib.h>

// preproc.cpp's entry points (both files are linked into one library)
extern "C" void preprocess_rgb(const uint8_t* src, int sh, int sw,
                               float* dst, int resize_to, int crop,
                               const float* mean, const float* std_);
extern "C" void preprocess_rgb_u8(const uint8_t* src, int sh, int sw,
                                  uint8_t* dst, int resize_to, int crop);

namespace {

struct ErrMgr {
    jpeg_error_mgr pub;
    std::jmp_buf jb;
};

void on_error(j_common_ptr cinfo) {
    ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
    std::longjmp(err->jb, 1);
}

// The memory source.  libjpeg's jpeg_mem_src meets the end of the data
// before the last scanline with a warning and pads the image with grey;
// PIL refuses such a file ("image file is truncated", unless
// ImageFile.LOAD_TRUNCATED_IMAGES is set).  This source makes it an error,
// so that the caller falls back to PIL, which then does what PIL does.
// After the last scanline a missing EOI marker is supplied, as
// jpeg_mem_src supplies it.
const JOCTET kEoi[2] = {0xFF, JPEG_EOI};

void src_noop(j_decompress_ptr) {}

boolean src_fill(j_decompress_ptr cinfo) {
    if (cinfo->output_height == 0
            || cinfo->output_scanline < cinfo->output_height)
        on_error(reinterpret_cast<j_common_ptr>(cinfo));
    cinfo->src->next_input_byte = kEoi;
    cinfo->src->bytes_in_buffer = 2;
    return TRUE;
}

void src_skip(j_decompress_ptr cinfo, long num_bytes) {
    if (num_bytes <= 0) return;
    jpeg_source_mgr* src = cinfo->src;
    if (static_cast<size_t>(num_bytes) > src->bytes_in_buffer) {
        src_fill(cinfo);
        return;
    }
    src->next_input_byte += num_bytes;
    src->bytes_in_buffer -= num_bytes;
}

// RAII decompress context with PIL-matching settings
struct Decoder {
    jpeg_decompress_struct cinfo;
    ErrMgr err;
    jpeg_source_mgr src;
    bool live = false;

    bool start(const uint8_t* buf, unsigned long len) {
        cinfo.err = jpeg_std_error(&err.pub);
        err.pub.error_exit = on_error;
        if (setjmp(err.jb)) return false;
        jpeg_create_decompress(&cinfo);
        live = true;
        src.next_input_byte = buf;
        src.bytes_in_buffer = len;
        src.init_source = src_noop;
        src.fill_input_buffer = src_fill;
        src.skip_input_data = src_skip;
        src.resync_to_restart = jpeg_resync_to_restart;
        src.term_source = src_noop;
        cinfo.src = &src;
        jpeg_read_header(&cinfo, TRUE);
        cinfo.out_color_space = JCS_RGB;      // PIL converts to RGB
        cinfo.dct_method = JDCT_ISLOW;        // PIL default
        return true;
    }

    ~Decoder() {
        if (live) jpeg_destroy_decompress(&cinfo);
    }
};

int decode_into(const uint8_t* buf, unsigned long len,
                std::vector<uint8_t>* owned, uint8_t* ext,
                int* out_h, int* out_w, int min_side = 0) {
    Decoder d;
    if (!d.start(buf, len)) return -1;
    if (setjmp(d.err.jb)) return -2;
    if (min_side > 0) {
        // DCT-domain scaled decode (libjpeg scale_num/scale_denom, M/8):
        // pick the smallest M whose output short side still covers the
        // resample target, so the IDCT runs on MxM sub-blocks and the
        // color/upsampling passes touch ~(M/8)^2 of the pixels.  NOT
        // bit-exact vs a full decode + resample (the resampler sees
        // different source pixels) — callers opt in via fast mode.
        // (JDCT_IFAST + do_fancy_upsampling=FALSE were measured: +14%
        // throughput on the synthetic fixture but clean-vs-fast corr drops
        // 0.998->0.995 on smooth content — not worth the accuracy risk;
        // scaled ISLOW decode keeps eval-grade pixels.)
        const int src_min = d.cinfo.image_height < d.cinfo.image_width
                                ? d.cinfo.image_height
                                : d.cinfo.image_width;
        int m = (8 * min_side + src_min - 1) / src_min;  // ceil
        if (m < 1) m = 1;
        if (m > 8) m = 8;  // never upscale past the full-resolution decode
        d.cinfo.scale_num = m;
        d.cinfo.scale_denom = 8;
    }
    jpeg_start_decompress(&d.cinfo);
    const int w = d.cinfo.output_width;
    const int h = d.cinfo.output_height;
    if (d.cinfo.output_components != 3) {
        // grayscale etc.: expand during row copy
    }
    uint8_t* dst = ext;
    if (owned) {
        owned->resize(static_cast<size_t>(h) * w * 3);
        dst = owned->data();
    }
    std::vector<uint8_t> rowbuf;
    const int comps = d.cinfo.output_components;
    if (comps != 3) rowbuf.resize(static_cast<size_t>(w) * comps);
    while (d.cinfo.output_scanline < d.cinfo.output_height) {
        const int y = d.cinfo.output_scanline;
        uint8_t* row = comps == 3
            ? dst + static_cast<size_t>(y) * w * 3 : rowbuf.data();
        JSAMPROW rows[1] = {row};
        jpeg_read_scanlines(&d.cinfo, rows, 1);
        if (comps == 1) {  // grayscale -> RGB, PIL convert("RGB") semantics
            uint8_t* out = dst + static_cast<size_t>(y) * w * 3;
            for (int x = 0; x < w; x++) {
                out[x * 3] = out[x * 3 + 1] = out[x * 3 + 2] = row[x];
            }
        }
    }
    jpeg_finish_decompress(&d.cinfo);
    *out_h = h;
    *out_w = w;
    return 0;
}

}  // namespace

extern "C" {

int jpeg_shape(const uint8_t* buf, unsigned long len, int* h, int* w) {
    Decoder d;
    if (!d.start(buf, len)) return -1;
    *h = d.cinfo.image_height;
    *w = d.cinfo.image_width;
    return 0;
}

int jpeg_decode_rgb(const uint8_t* buf, unsigned long len, uint8_t* dst) {
    int h, w;
    return decode_into(buf, len, nullptr, dst, &h, &w);
}

int jpeg_decode_preprocess(const uint8_t* buf, unsigned long len, float* dst,
                           int resize_to, int crop, const float* mean,
                           const float* std_) {
    std::vector<uint8_t> rgb;
    int h, w;
    int rc = decode_into(buf, len, &rgb, nullptr, &h, &w);
    if (rc) return rc;
    preprocess_rgb(rgb.data(), h, w, dst, resize_to, crop, mean, std_);
    return 0;
}

// Fast mode: DCT-domain scaled decode near the resample target, then the
// same bit-exact-Pillow resample/crop/normalize.  Several-fold cheaper on
// large JPEGs; pixels differ slightly from the exact mode because the
// resampler consumes the scaled decode's output.
int jpeg_decode_preprocess_fast(const uint8_t* buf, unsigned long len,
                                float* dst, int resize_to, int crop,
                                const float* mean, const float* std_) {
    std::vector<uint8_t> rgb;
    int h, w;
    int rc = decode_into(buf, len, &rgb, nullptr, &h, &w, resize_to);
    if (rc) return rc;
    preprocess_rgb(rgb.data(), h, w, dst, resize_to, crop, mean, std_);
    return 0;
}

// u8 wire-format variant: resize + crop only, CHW uint8 output (the device
// does the normalize — 4x less H2D traffic, bit-identical model input).
int jpeg_decode_preprocess_u8(const uint8_t* buf, unsigned long len,
                              uint8_t* dst, int resize_to, int crop,
                              int fast) {
    std::vector<uint8_t> rgb;
    int h, w;
    int rc = decode_into(buf, len, &rgb, nullptr, &h, &w,
                         fast ? resize_to : 0);
    if (rc) return rc;
    preprocess_rgb_u8(rgb.data(), h, w, dst, resize_to, crop);
    return 0;
}

void jpeg_decode_preprocess_batch_u8(const uint8_t** bufs,
                                     const unsigned long* lens, int n,
                                     uint8_t* dst, int resize_to, int crop,
                                     int* status, int fast) {
#pragma omp parallel for schedule(dynamic)
    for (int i = 0; i < n; i++) {
        uint8_t* out = dst + static_cast<size_t>(i) * 3 * crop * crop;
        status[i] = jpeg_decode_preprocess_u8(bufs[i], lens[i], out,
                                              resize_to, crop, fast);
    }
}

void jpeg_decode_preprocess_batch(const uint8_t** bufs,
                                  const unsigned long* lens, int n,
                                  float* dst, int resize_to, int crop,
                                  const float* mean, const float* std_,
                                  int* status, int fast) {
#pragma omp parallel for schedule(dynamic)
    for (int i = 0; i < n; i++) {
        float* out = dst + static_cast<size_t>(i) * 3 * crop * crop;
        status[i] = fast
            ? jpeg_decode_preprocess_fast(bufs[i], lens[i], out, resize_to,
                                          crop, mean, std_)
            : jpeg_decode_preprocess(bufs[i], lens[i], out, resize_to, crop,
                                     mean, std_);
    }
}

}  // extern "C"
