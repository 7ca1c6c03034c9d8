// Native image preprocessing of the port's host data pipeline
// (diffvit_tpu_torch/data/native_preproc.py and native_decode.py bind it).
//
// Replicates Pillow's 8-bit convolution resampling (bicubic, a = -0.5)
// bit-exactly — the same two-pass horizontal/vertical fixed-point scheme
// with PRECISION_BITS = 32-8-2 coefficient quantization and per-pass uint8
// rounding — followed by center crop and CHW float normalization.  Exact
// PIL parity matters because preprocessing differences move ImageNet top-1
// by tenths of a percent.
//
// Exposed C ABI (ctypes):
//   preprocess_rgb(src, sh, sw, dst, resize_to, crop, mean, std)
//     src: uint8 HWC (sh, sw, 3) decoded RGB
//     dst: float32 CHW (3, crop, crop)
//     resize_to: shorter-side target before crop (e.g. 256 for crop 224)
//   preprocess_rgb_u8(src, sh, sw, dst, resize_to, crop): the uint8 crop
//   preprocess_batch(...): OpenMP-parallel loop over images.
//   apply_code_lut(src, lut, dst, n_images, hw): uint8 -> int8 input codes

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;

// PIL's bicubic filter, a = -0.5 (support 2.0)
static double bicubic_filter(double x) {
    constexpr double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

static inline uint8_t clip8(int in) {
    if (in >= (1 << (PRECISION_BITS + 8))) return 255;
    if (in <= 0) return 0;
    return static_cast<uint8_t>(in >> PRECISION_BITS);
}

// PIL precompute_coeffs: per-output-pixel input window + int32 coefficients
struct Coeffs {
    int ksize;
    std::vector<int> bounds;   // (xmin, xcount) pairs
    std::vector<int> kk;       // ksize coeffs per output pixel
};

static Coeffs precompute_coeffs(int in_size, int out_size) {
    const double support_base = 2.0;  // bicubic
    double scale = static_cast<double>(in_size) / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = support_base * filterscale;
    int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

    Coeffs c;
    c.ksize = ksize;
    c.bounds.resize(out_size * 2);
    c.kk.resize(out_size * ksize);
    std::vector<double> w(ksize);

    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        int x = 0;
        for (; x < xmax; x++) {
            double wv = bicubic_filter((x + xmin - center + 0.5) * ss);
            w[x] = wv;
            ww += wv;
        }
        for (x = 0; x < xmax; x++) w[x] /= ww;
        for (; x < ksize; x++) w[x] = 0.0;
        for (x = 0; x < ksize; x++) {
            // PIL rounds coefficients half-away-from-zero
            double v = w[x] * (1 << PRECISION_BITS);
            c.kk[xx * ksize + x] =
                static_cast<int>(v < 0 ? v - 0.5 : v + 0.5);
        }
        c.bounds[xx * 2 + 0] = xmin;
        c.bounds[xx * 2 + 1] = xmax;
    }
    return c;
}

// Resample along the LEADING axis of a (lead, rest) u8 matrix.  The tap
// loop is hoisted outside a contiguous inner loop accumulating into an
// int32 row buffer, which the compiler vectorizes (u8 widen, scalar
// coefficient broadcast, 32-bit MAC) — the per-output-element tap-gather
// form runs at scalar speed.  Arithmetic is identical to PIL's: same
// per-tap int32 sums, same clip8 rounding.
static void resample_lead(const uint8_t* src, int lead_in, int rest,
                          uint8_t* dst, int lead_out, const Coeffs& c,
                          std::vector<int32_t>* accbuf) {
    accbuf->resize(rest);
    int32_t* acc = accbuf->data();
    for (int oo = 0; oo < lead_out; oo++) {
        const int omin = c.bounds[oo * 2 + 0];
        const int ocnt = c.bounds[oo * 2 + 1];
        const int* k = &c.kk[oo * c.ksize];
        for (int i = 0; i < rest; i++) acc[i] = 1 << (PRECISION_BITS - 1);
        for (int t = 0; t < ocnt; t++) {
            const uint8_t* row = src + static_cast<size_t>(omin + t) * rest;
            const int32_t w = k[t];
            for (int i = 0; i < rest; i++) acc[i] += row[i] * w;
        }
        uint8_t* orow = dst + static_cast<size_t>(oo) * rest;
        for (int i = 0; i < rest; i++) orow[i] = clip8(acc[i]);
    }
}

// (h, w, 3) u8 -> (w, h, 3) u8 pixel transpose
static void transpose_px(const uint8_t* src, int h, int w, uint8_t* dst) {
    for (int y = 0; y < h; y++) {
        const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
        for (int x = 0; x < w; x++) {
            uint8_t* o = dst + (static_cast<size_t>(x) * h + y) * 3;
            o[0] = row[x * 3 + 0];
            o[1] = row[x * 3 + 1];
            o[2] = row[x * 3 + 2];
        }
    }
}

// Horizontal pass: (h, in_w, 3) u8 -> (h, out_w, 3) u8.  Runs as a
// leading-axis resample on the transposed image so the inner loops are
// contiguous/vectorizable; the two transposes move bytes only — the sums
// and rounding are exactly PIL's horizontal pass.
static void resample_h(const uint8_t* src, int h, int in_w,
                       uint8_t* dst, int out_w, const Coeffs& c) {
    std::vector<uint8_t> tsrc(static_cast<size_t>(in_w) * h * 3);
    std::vector<uint8_t> tdst(static_cast<size_t>(out_w) * h * 3);
    std::vector<int32_t> acc;
    transpose_px(src, h, in_w, tsrc.data());
    resample_lead(tsrc.data(), in_w, h * 3, tdst.data(), out_w, c, &acc);
    transpose_px(tdst.data(), out_w, h, dst);
}

// Vertical pass: (in_h, w, 3) u8 -> (out_h, w, 3) u8
static void resample_v(const uint8_t* src, int in_h, int w,
                       uint8_t* dst, int out_h, const Coeffs& c) {
    std::vector<int32_t> acc;
    resample_lead(src, in_h, w * 3, dst, out_h, c, &acc);
}

// Python-round semantics (half to even) — torchvision's CenterCrop offsets
// go through Python round(), which is banker's rounding; lround would put
// the crop window off by one on exact .5.  (Resize's LONG side does NOT
// round: torchvision functional.resize truncates, see resize_for_crop.)
static long round_half_even(double v) {
    double f = std::floor(v);
    double diff = v - f;
    if (diff > 0.5) return static_cast<long>(f) + 1;
    if (diff < 0.5) return static_cast<long>(f);
    long lf = static_cast<long>(f);
    return (lf % 2 == 0) ? lf : lf + 1;
}

}  // namespace

namespace {

// Shared resize-to-shorter-side + center-crop-offset stage.  `cur` points
// at the resized HWC u8 image (possibly `src` itself, possibly one of the
// holder vectors — the holders MUST outlive the use of `cur`).
struct ResizedView {
    const uint8_t* cur;
    int cur_w, left, top;
    std::vector<uint8_t> tmp_h, tmp_v;  // storage backing `cur`
};

static void resize_for_crop(const uint8_t* src, int sh, int sw,
                            int resize_to, int crop, ResizedView* rv) {
    // torchvision Resize(int) geometry: shorter side -> resize_to, long
    // side TRUNCATED (int(size * long / short), functional.resize) — NOT
    // rounded; a 1px difference here moves the crop window.
    int ow, oh;
    if (sw <= sh) {
        ow = resize_to;
        oh = std::max(1L, static_cast<long>(
            static_cast<double>(resize_to) * sh / sw));
    } else {
        oh = resize_to;
        ow = std::max(1L, static_cast<long>(
            static_cast<double>(resize_to) * sw / sh));
    }

    const uint8_t* cur = src;
    int cur_h = sh, cur_w = sw;
    if (ow != sw) {
        Coeffs cx = precompute_coeffs(sw, ow);
        rv->tmp_h.resize(static_cast<size_t>(sh) * ow * 3);
        resample_h(cur, sh, sw, rv->tmp_h.data(), ow, cx);
        cur = rv->tmp_h.data();
        cur_w = ow;
    }
    if (oh != sh) {
        Coeffs cy = precompute_coeffs(sh, oh);
        rv->tmp_v.resize(static_cast<size_t>(oh) * cur_w * 3);
        resample_v(cur, sh, cur_w, rv->tmp_v.data(), oh, cy);
        cur = rv->tmp_v.data();
        cur_h = oh;
    }

    // torchvision CenterCrop rounding
    int left = static_cast<int>(round_half_even((cur_w - crop) / 2.0));
    int top = static_cast<int>(round_half_even((cur_h - crop) / 2.0));
    if (left < 0) left = 0;
    if (top < 0) top = 0;
    rv->cur = cur;
    rv->cur_w = cur_w;
    rv->left = left;
    rv->top = top;
}

}  // namespace

extern "C" {

// Resize shorter side to `resize_to` (PIL torchvision Resize(int) semantics),
// center-crop `crop`, normalize to CHW float32.
void preprocess_rgb(const uint8_t* src, int sh, int sw, float* dst,
                    int resize_to, int crop, const float* mean,
                    const float* std_) {
    ResizedView rv;
    resize_for_crop(src, sh, sw, resize_to, crop, &rv);
    const uint8_t* cur = rv.cur;
    const int cur_w = rv.cur_w, left = rv.left, top = rv.top;

    // same op order as the numpy path (x/255 - mean)/std for bit parity.
    // The uint8 domain has 256 values per channel: precompute the exact
    // result once per channel and gather — two f32 divides per PIXEL
    // (~2 ms/img, the old inner loop) become 768 divides per IMAGE.
    float lut[3][256];
    for (int b = 0; b < 3; b++)
        for (int v = 0; v < 256; v++)
            lut[b][v] = (v / 255.0f - mean[b]) / std_[b];
    for (int b = 0; b < 3; b++) {
        const float* lb = lut[b];
        float* out = dst + static_cast<size_t>(b) * crop * crop;
        for (int y = 0; y < crop; y++) {
            const uint8_t* row =
                cur + (static_cast<size_t>(top + y) * cur_w + left) * 3 + b;
            for (int x = 0; x < crop; x++)
                out[y * crop + x] = lb[row[x * 3]];
        }
    }
}

// Same resize + center-crop, but emit the CHW *uint8* crop — the natural
// wire format for host->device transfer (4x fewer bytes than f32; the
// device applies the identical (x/255 - mean)/std in f32, so the model
// input is bit-identical — data/imagenet.py device_normalize).
void preprocess_rgb_u8(const uint8_t* src, int sh, int sw, uint8_t* dst,
                       int resize_to, int crop) {
    ResizedView rv;
    resize_for_crop(src, sh, sw, resize_to, crop, &rv);
    for (int b = 0; b < 3; b++) {
        uint8_t* out = dst + static_cast<size_t>(b) * crop * crop;
        for (int y = 0; y < crop; y++) {
            const uint8_t* row = rv.cur
                + (static_cast<size_t>(rv.top + y) * rv.cur_w + rv.left) * 3
                + b;
            for (int x = 0; x < crop; x++)
                out[y * crop + x] = row[x * 3];
        }
    }
}

// Apply the input-code LUT (data/imagenet.input_code_lut: uint8 pixel ->
// int8 qact_input code, per channel) to an NCHW uint8 batch.  One
// memory-speed pass in place of numpy's fancy indexing.  `lut` is (3, 256)
// int8.
void apply_code_lut(const uint8_t* src, const int8_t* lut, int8_t* dst,
                    long n_images, long hw) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n_images * 3; i++) {
        const int8_t* lb = lut + (i % 3) * 256;
        const uint8_t* s = src + i * hw;
        int8_t* d = dst + i * hw;
        for (long j = 0; j < hw; j++) d[j] = lb[s[j]];
    }
}

void preprocess_batch(const uint8_t** srcs, const int* shs, const int* sws,
                      int n, float* dst, int resize_to, int crop,
                      const float* mean, const float* std_) {
#pragma omp parallel for schedule(dynamic)
    for (int i = 0; i < n; i++) {
        preprocess_rgb(srcs[i], shs[i], sws[i],
                       dst + static_cast<size_t>(i) * 3 * crop * crop,
                       resize_to, crop, mean, std_);
    }
}

}  // extern "C"
