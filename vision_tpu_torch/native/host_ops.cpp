// Host-side image filters of vision_tpu_torch: the separable box blur and
// the erosion (min filter) of the reference's image layer
// (src/visp/image.cpp:358-419, 509-535), with the arithmetic of the JAX
// package's vision_tpu/native/host_ops.cpp (the same results bit for bit)
// in loops that walk memory in order. Bound with ctypes by
// vision_tpu_torch/native/__init__.py, which builds this file with g++ at
// its first use.

#include <algorithm>
#include <cstddef>
#include <vector>

extern "C" {

// separable sliding-window box blur over edge-replicated signal. Each
// channel of each row (horizontal) and each column (vertical) keeps one
// running sum, updated as the reference's loop does; the loops walk memory
// in order, the vertical pass a whole row of sums at a time.
void visp_box_blur(const float* src, float* dst, int h, int w, int c, int radius) {
    size_t stride = (size_t)w * c;
    std::vector<double> tmp((size_t)h * stride), sum(stride);
    double weight = 1.0 / (2 * radius + 1);
    // horizontal
    for (int y = 0; y < h; ++y) {
        const float* row = src + (size_t)y * stride;
        double* trow = tmp.data() + (size_t)y * stride;
        for (int ch = 0; ch < c; ++ch) {
            double s = radius * row[ch];
            for (int x = 0; x <= radius; ++x) s += row[(size_t)std::min(x, w - 1) * c + ch];
            sum[ch] = s;
            trow[ch] = s * weight;
        }
        for (int x = 1; x < w; ++x) {
            const float* right = row + (size_t)std::min(x + radius, w - 1) * c;
            const float* left = row + (size_t)std::max(std::min(x - radius - 1, w - 1), 0) * c;
            for (int ch = 0; ch < c; ++ch) {
                sum[ch] += right[ch] - left[ch];
                trow[(size_t)x * c + ch] = sum[ch] * weight;
            }
        }
    }
    // vertical
    for (size_t i = 0; i < stride; ++i) {
        double s = radius * tmp[i];
        for (int y = 0; y <= radius; ++y) s += tmp[(size_t)std::min(y, h - 1) * stride + i];
        sum[i] = s;
        dst[i] = float(s * weight);
    }
    for (int y = 1; y < h; ++y) {
        const double* bottom = tmp.data() + (size_t)std::min(y + radius, h - 1) * stride;
        const double* top = tmp.data() + (size_t)std::max(std::min(y - radius - 1, h - 1), 0) * stride;
        float* drow = dst + (size_t)y * stride;
        for (size_t i = 0; i < stride; ++i) {
            sum[i] += bottom[i] - top[i];
            drow[i] = float(sum[i] * weight);
        }
    }
}

// min-filter with replicate border (single channel). Both passes take the
// minimum over the window one offset at a time across a whole row, so the
// inner loops run over contiguous memory.
void visp_erosion_f32(const float* src, float* dst, int h, int w, int radius) {
    std::vector<float> tmp((size_t)h * w);
    for (int y = 0; y < h; ++y) {  // horizontal pass
        const float* row = src + (size_t)y * w;
        float* t = tmp.data() + (size_t)y * w;
        std::copy(row, row + w, t);
        for (int dx = -radius; dx <= radius; ++dx) {
            int lo = std::min(std::max(0, -dx), w), hi = std::max(std::min(w, w - dx), lo);
            for (int x = 0; x < lo; ++x) t[x] = std::min(t[x], row[std::max(0, std::min(x + dx, w - 1))]);
            for (int x = lo; x < hi; ++x) t[x] = std::min(t[x], row[x + dx]);
            for (int x = hi; x < w; ++x) t[x] = std::min(t[x], row[std::max(0, std::min(x + dx, w - 1))]);
        }
    }
    for (int y = 0; y < h; ++y) {  // vertical pass
        float* d = dst + (size_t)y * w;
        std::copy(tmp.data() + (size_t)y * w, tmp.data() + (size_t)(y + 1) * w, d);
        for (int dy = -radius; dy <= radius; ++dy) {
            const float* r = tmp.data() + (size_t)std::max(0, std::min(y + dy, h - 1)) * w;
            for (int x = 0; x < w; ++x) d[x] = std::min(d[x], r[x]);
        }
    }
}

}  // extern "C"
