// Copied from swat_tpu/data/native/decoder.cpp; the port keeps its own copy, permanently.
// Native host-side image loader: JPEG decode (libjpeg) + PIL-compatible
// bicubic resampling + the two preprocess layouts the framework feeds the
// TPU with, multithreaded without the GIL.
//
// Replaces the PIL thread pools in swat_tpu_torch/data/transforms.py for the two
// batch operations on the hot host path (SURVEY.md §2.4 item 4 "PIL /
// torchvision image decode ... replaced by host decode"):
//   * train canvases: aspect-preserving resize (longest side -> canvas)
//     into the top-left of a fixed uint8 canvas (transforms.train_canvas)
//   * eval pixels: resize shorter side to n_px + center crop
//     (transforms.eval_preprocess, pre-normalization)
//
// Dimension rounding uses std::nearbyint (ties-to-even under the default
// FE_TONEAREST mode) to match Python's round() in transforms.py exactly.
//
// Resampling matches PIL's convolution resampler: bicubic kernel
// (Catmull-Rom, a = -0.5, support 2.0) with the filter widened by the
// downscale factor (antialias), per-axis separable passes, coefficients
// normalized per output pixel.  PIL uses fixed-point arithmetic; this uses
// float accumulation, so outputs can differ by ±1 LSB (tested).
//
// Non-JPEG inputs and exotic JPEG color spaces report status=1 and the
// Python wrapper falls back to PIL for those images.
//
// Build: make -C swat_tpu_torch/data/native libswatdecoder.so

#include <algorithm>
#include <atomic>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <functional>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(err->jb, 1);
}

// Decode a JPEG file into an RGB buffer. Returns true on success.
bool decode_jpeg(const char* path, std::vector<uint8_t>* pixels,
                 int* width, int* height) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        fclose(f);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        fclose(f);
        return false;
    }
    cinfo.out_color_space = JCS_RGB;  // libjpeg converts gray/YCbCr
    jpeg_start_decompress(&cinfo);
    if (cinfo.output_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        fclose(f);
        return false;
    }
    *width = cinfo.output_width;
    *height = cinfo.output_height;
    pixels->resize(size_t(*width) * *height * 3);
    JSAMPROW row;
    while (cinfo.output_scanline < cinfo.output_height) {
        row = pixels->data() + size_t(cinfo.output_scanline) * *width * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return true;
}

// PIL bicubic kernel (ImagingResampleBicubic): a = -0.5, support 2.0.
inline double bicubic(double x) {
    constexpr double a = -0.5;
    x = std::fabs(x);
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

constexpr double kSupport = 2.0;

// Precompute per-output-pixel taps for one axis, PIL-style
// (ImagingPrecomputeCoeffs): filterscale = max(in/out, 1), window
// [center - support*fs, center + support*fs), weights normalized.
struct AxisCoeffs {
    std::vector<int> xmin, xsize;
    std::vector<double> weights;  // flattened, kmax per output pixel
    int kmax = 0;
};

AxisCoeffs precompute(int in_size, int out_size) {
    AxisCoeffs c;
    double scale = double(in_size) / out_size;
    double fs = std::max(scale, 1.0);
    double support = kSupport * fs;
    c.kmax = int(std::ceil(support)) * 2 + 1;
    c.xmin.resize(out_size);
    c.xsize.resize(out_size);
    c.weights.assign(size_t(out_size) * c.kmax, 0.0);
    for (int xx = 0; xx < out_size; ++xx) {
        double center = (xx + 0.5) * scale;
        int xmin = int(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = int(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        double* w = &c.weights[size_t(xx) * c.kmax];
        double total = 0.0;
        for (int x = xmin; x < xmax; ++x) {
            double ww = bicubic((x - center + 0.5) / fs);
            w[x - xmin] = ww;
            total += ww;
        }
        if (total != 0.0)
            for (int x = 0; x < xmax - xmin; ++x) w[x] /= total;
        c.xmin[xx] = xmin;
        c.xsize[xx] = xmax - xmin;
    }
    return c;
}

inline uint8_t clip8(double v) {
    if (v < 0.0) return 0;
    if (v > 255.0) return 255;
    return uint8_t(v + 0.5);
}

// Separable resize RGB uint8 [h,w] -> [nh,nw] (horizontal then vertical).
// PIL's two-pass ImagingResample stores the horizontal pass as a UINT8
// image, so bicubic overshoot is clipped+rounded between passes — doing
// the same here is what keeps outputs within ±1 LSB of PIL.
void resize_bicubic(const uint8_t* src, int h, int w,
                    uint8_t* dst, int nh, int nw) {
    AxisCoeffs cx = precompute(w, nw);
    AxisCoeffs cy = precompute(h, nh);
    std::vector<float> tmp(size_t(h) * nw * 3);
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = src + size_t(y) * w * 3;
        float* out = tmp.data() + size_t(y) * nw * 3;
        for (int xx = 0; xx < nw; ++xx) {
            const double* wgt = &cx.weights[size_t(xx) * cx.kmax];
            int x0 = cx.xmin[xx], n = cx.xsize[xx];
            double r = 0, g = 0, b = 0;
            for (int k = 0; k < n; ++k) {
                const uint8_t* p = row + size_t(x0 + k) * 3;
                r += wgt[k] * p[0];
                g += wgt[k] * p[1];
                b += wgt[k] * p[2];
            }
            // clip+round like PIL's uint8 intermediate image
            out[xx * 3 + 0] = float(clip8(r));
            out[xx * 3 + 1] = float(clip8(g));
            out[xx * 3 + 2] = float(clip8(b));
        }
    }
    for (int yy = 0; yy < nh; ++yy) {
        const double* wgt = &cy.weights[size_t(yy) * cy.kmax];
        int y0 = cy.xmin[yy], n = cy.xsize[yy];
        uint8_t* out = dst + size_t(yy) * nw * 3;
        for (int xx = 0; xx < nw; ++xx) {
            double r = 0, g = 0, b = 0;
            for (int k = 0; k < n; ++k) {
                const float* p =
                    tmp.data() + (size_t(y0 + k) * nw + xx) * 3;
                r += wgt[k] * p[0];
                g += wgt[k] * p[1];
                b += wgt[k] * p[2];
            }
            out[xx * 3 + 0] = clip8(r);
            out[xx * 3 + 1] = clip8(g);
            out[xx * 3 + 2] = clip8(b);
        }
    }
}

void parallel_for(long n, long threads, const std::function<void(long)>& fn) {
    if (threads <= 1) {
        for (long i = 0; i < n; ++i) fn(i);
        return;
    }
    std::atomic<long> next(0);
    auto worker = [&] {
        for (;;) {
            long i = next.fetch_add(1);
            if (i >= n) return;
            fn(i);
        }
    };
    std::vector<std::thread> pool;
    long t = std::min(threads, n);
    pool.reserve(t);
    for (long i = 0; i < t; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Train canvases (transforms.train_canvas): decode, resize longest side to
// `canvas` (aspect preserved, bicubic), paste top-left of a zeroed
// [canvas, canvas, 3] uint8 canvas; valid_hw[i*2+{0,1}] = (nh, nw).
// status[i]: 0 ok, 1 fallback needed. Returns count of failures.
long dec_canvas_batch(const char** paths, long n, long canvas,
                      uint8_t* out, int32_t* valid_hw, int32_t* status,
                      long threads) {
    std::atomic<long> failures(0);
    parallel_for(n, threads, [&](long i) {
        std::vector<uint8_t> px;
        int w = 0, h = 0;
        uint8_t* dst = out + size_t(i) * canvas * canvas * 3;
        std::memset(dst, 0, size_t(canvas) * canvas * 3);
        if (!decode_jpeg(paths[i], &px, &w, &h)) {
            status[i] = 1;
            valid_hw[i * 2] = valid_hw[i * 2 + 1] = 0;
            failures.fetch_add(1);
            return;
        }
        int nw, nh;
        if (w >= h) {
            nw = int(canvas);
            nh = std::max(1, int(std::nearbyint(double(h) * canvas / w)));
        } else {
            nh = int(canvas);
            nw = std::max(1, int(std::nearbyint(double(w) * canvas / h)));
        }
        std::vector<uint8_t> resized(size_t(nh) * nw * 3);
        resize_bicubic(px.data(), h, w, resized.data(), nh, nw);
        for (int y = 0; y < nh; ++y)
            std::memcpy(dst + size_t(y) * canvas * 3,
                        resized.data() + size_t(y) * nw * 3,
                        size_t(nw) * 3);
        valid_hw[i * 2] = nh;
        valid_hw[i * 2 + 1] = nw;
        status[i] = 0;
    });
    return failures.load();
}

// Eval pixels (transforms.eval_preprocess pre-normalize): decode, resize
// shorter side to n_px (bicubic), center-crop n_px x n_px.
long dec_eval_batch(const char** paths, long n, long n_px, uint8_t* out,
                    int32_t* status, long threads) {
    std::atomic<long> failures(0);
    parallel_for(n, threads, [&](long i) {
        std::vector<uint8_t> px;
        int w = 0, h = 0;
        uint8_t* dst = out + size_t(i) * n_px * n_px * 3;
        if (!decode_jpeg(paths[i], &px, &w, &h)) {
            status[i] = 1;
            std::memset(dst, 0, size_t(n_px) * n_px * 3);
            failures.fetch_add(1);
            return;
        }
        int nw, nh;  // torchvision truncates the long side (int(), not
                     // round) — keeps parity with transforms.eval_preprocess
        if (w < h) {
            nw = int(n_px);
            nh = std::max(int(n_px), int(double(h) * n_px / w));
        } else {
            nw = std::max(int(n_px), int(double(w) * n_px / h));
            nh = int(n_px);
        }
        std::vector<uint8_t> resized(size_t(nh) * nw * 3);
        resize_bicubic(px.data(), h, w, resized.data(), nh, nw);
        // torchvision F.center_crop: int(round(d / 2.0)) with python's
        // round-half-even — llrint under the default FP rounding mode
        // matches; plain integer /2 floors and shifts d%4==3 crops
        int left = int(std::llrint((nw - int(n_px)) / 2.0));
        int top = int(std::llrint((nh - int(n_px)) / 2.0));
        for (int y = 0; y < int(n_px); ++y)
            std::memcpy(dst + size_t(y) * n_px * 3,
                        resized.data() +
                            (size_t(top + y) * nw + left) * 3,
                        size_t(n_px) * 3);
        status[i] = 0;
    });
    return failures.load();
}

}  // extern "C"
