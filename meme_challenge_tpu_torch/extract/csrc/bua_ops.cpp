// Native host ops for the feature-extraction layer of the PyTorch port.
//
// A copy of native/bua_ops.cpp (the JAX package's host ops); the code below
// the includes is unchanged. It is a plain C ABI consumed through ctypes,
// implementing
//
//   - greedy NMS (detectron2 box semantics: no +1 on width/height),
//     used per-class with IoU 0.3 by the extractor
//     (reference utils/extract_utils.py:68-80),
//   - ROIAlign forward (bilinear, aligned & legacy modes, detectron2
//     semantics),
//   - ROIPool forward (max pooling, the ROI_BOX_HEAD.POOLER_TYPE used by
//     the gt-bbox extraction config).
//
// Build: meme_challenge_tpu_torch/extract/native.py runs
// g++ -O3 -shared -fPIC -std=c++17 at first use, into build/bua_ops/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Greedy non-max suppression.
// boxes: [n, 4] (x1, y1, x2, y2), scores: [n].
// keep_out: caller-allocated [n] int32; returns number of kept indices,
// in descending-score order.
int nms_f32(const float* boxes, const float* scores, int n,
            float iou_threshold, int* keep_out) {
    std::vector<int> order(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
        return scores[a] > scores[b];
    });

    std::vector<float> areas(n);
    for (int i = 0; i < n; ++i) {
        const float* b = boxes + 4 * i;
        areas[i] = std::max(0.f, b[2] - b[0]) * std::max(0.f, b[3] - b[1]);
    }

    std::vector<char> suppressed(n, 0);
    int num_kept = 0;
    for (int oi = 0; oi < n; ++oi) {
        int i = order[oi];
        if (suppressed[i]) continue;
        keep_out[num_kept++] = i;
        const float* bi = boxes + 4 * i;
        for (int oj = oi + 1; oj < n; ++oj) {
            int j = order[oj];
            if (suppressed[j]) continue;
            const float* bj = boxes + 4 * j;
            float xx1 = std::max(bi[0], bj[0]);
            float yy1 = std::max(bi[1], bj[1]);
            float xx2 = std::min(bi[2], bj[2]);
            float yy2 = std::min(bi[3], bj[3]);
            float w = std::max(0.f, xx2 - xx1);
            float h = std::max(0.f, yy2 - yy1);
            float inter = w * h;
            float iou = inter / (areas[i] + areas[j] - inter);
            if (iou > iou_threshold) suppressed[j] = 1;
        }
    }
    return num_kept;
}

static inline float bilinear(const float* data, int H, int W, float y,
                             float x) {
    if (y < -1.0f || y > H || x < -1.0f || x > W) return 0.f;
    y = std::max(y, 0.f);
    x = std::max(x, 0.f);
    int y0 = (int)y, x0 = (int)x;
    int y1, x1;
    if (y0 >= H - 1) { y1 = y0 = H - 1; y = (float)y0; } else { y1 = y0 + 1; }
    if (x0 >= W - 1) { x1 = x0 = W - 1; x = (float)x0; } else { x1 = x0 + 1; }
    float ly = y - y0, lx = x - x0;
    float hy = 1.f - ly, hx = 1.f - lx;
    return hy * hx * data[y0 * W + x0] + hy * lx * data[y0 * W + x1]
         + ly * hx * data[y1 * W + x0] + ly * lx * data[y1 * W + x1];
}

// ROIAlign forward over one feature map [C, H, W].
// rois: [r, 4] (x1, y1, x2, y2) in image coordinates.
// out: [r, C, ph, pw]. sampling_ratio <= 0 -> adaptive ceil(roi/bin).
// aligned: detectron2 "aligned" mode (pixel-center -0.5 offset).
void roi_align_f32(const float* feat, int C, int H, int W,
                   const float* rois, int r, float spatial_scale,
                   int ph, int pw, int sampling_ratio, int aligned,
                   float* out) {
    float offset = aligned ? 0.5f : 0.0f;
    for (int ri = 0; ri < r; ++ri) {
        const float* roi = rois + 4 * ri;
        float x1 = roi[0] * spatial_scale - offset;
        float y1 = roi[1] * spatial_scale - offset;
        float x2 = roi[2] * spatial_scale - offset;
        float y2 = roi[3] * spatial_scale - offset;
        float roi_w = x2 - x1;
        float roi_h = y2 - y1;
        if (!aligned) {  // legacy: clamp to min size 1
            roi_w = std::max(roi_w, 1.f);
            roi_h = std::max(roi_h, 1.f);
        }
        float bin_h = roi_h / ph;
        float bin_w = roi_w / pw;
        int grid_h = sampling_ratio > 0 ? sampling_ratio
                                        : (int)std::ceil(roi_h / ph);
        int grid_w = sampling_ratio > 0 ? sampling_ratio
                                        : (int)std::ceil(roi_w / pw);
        grid_h = std::max(grid_h, 1);
        grid_w = std::max(grid_w, 1);
        float count = (float)(grid_h * grid_w);
        for (int c = 0; c < C; ++c) {
            const float* plane = feat + (size_t)c * H * W;
            float* dst = out + (((size_t)ri * C + c) * ph) * pw;
            for (int py = 0; py < ph; ++py) {
                for (int px = 0; px < pw; ++px) {
                    float acc = 0.f;
                    for (int iy = 0; iy < grid_h; ++iy) {
                        float y = y1 + py * bin_h
                                + (iy + 0.5f) * bin_h / grid_h;
                        for (int ix = 0; ix < grid_w; ++ix) {
                            float x = x1 + px * bin_w
                                    + (ix + 0.5f) * bin_w / grid_w;
                            acc += bilinear(plane, H, W, y, x);
                        }
                    }
                    dst[py * pw + px] = acc / count;
                }
            }
        }
    }
}

// ROIPool (max) forward over one feature map [C, H, W] — Caffe semantics
// (quantized bins, +1 in size). out: [r, C, ph, pw].
void roi_pool_f32(const float* feat, int C, int H, int W,
                  const float* rois, int r, float spatial_scale,
                  int ph, int pw, float* out) {
    for (int ri = 0; ri < r; ++ri) {
        const float* roi = rois + 4 * ri;
        int x1 = (int)std::round(roi[0] * spatial_scale);
        int y1 = (int)std::round(roi[1] * spatial_scale);
        int x2 = (int)std::round(roi[2] * spatial_scale);
        int y2 = (int)std::round(roi[3] * spatial_scale);
        int roi_w = std::max(x2 - x1 + 1, 1);
        int roi_h = std::max(y2 - y1 + 1, 1);
        float bin_h = (float)roi_h / ph;
        float bin_w = (float)roi_w / pw;
        for (int c = 0; c < C; ++c) {
            const float* plane = feat + (size_t)c * H * W;
            float* dst = out + (((size_t)ri * C + c) * ph) * pw;
            for (int py = 0; py < ph; ++py) {
                int hs = std::min(std::max(y1 + (int)std::floor(py * bin_h),
                                           0), H);
                int he = std::min(std::max(
                    y1 + (int)std::ceil((py + 1) * bin_h), 0), H);
                for (int px = 0; px < pw; ++px) {
                    int ws = std::min(std::max(
                        x1 + (int)std::floor(px * bin_w), 0), W);
                    int we = std::min(std::max(
                        x1 + (int)std::ceil((px + 1) * bin_w), 0), W);
                    float best = (hs >= he || ws >= we) ? 0.f : -3.4e38f;
                    for (int y = hs; y < he; ++y)
                        for (int x = ws; x < we; ++x)
                            best = std::max(best, plane[y * W + x]);
                    dst[py * pw + px] = best;
                }
            }
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Multi-class max-conf NMS: the extraction box-selection hot loop
// (reference utils/extract_utils.py:68-74) in ONE call. Proposals are
// class-agnostic, so the pairwise-IoU matrix is computed once and shared by
// all C-1 foreground classes; per class we run the exact greedy NMS above
// (stable descending sort, suppress at IoU > threshold) and fold kept
// scores into a per-box running max. Replaces C-1 ctypes round trips.
extern "C"
void nms_max_conf_f32(const float* boxes, const float* cls_prob, int n,
                      int num_classes, float iou_threshold,
                      float* max_conf_out) {
    if (n <= 0) return;
    std::vector<float> iou((size_t)n * n, 0.f);
    std::vector<float> areas(n);
    for (int i = 0; i < n; ++i) {
        const float* b = boxes + 4 * i;
        areas[i] = std::max(0.f, b[2] - b[0]) * std::max(0.f, b[3] - b[1]);
    }
    for (int i = 0; i < n; ++i) {
        const float* bi = boxes + 4 * i;
        for (int j = i + 1; j < n; ++j) {
            const float* bj = boxes + 4 * j;
            float xx1 = std::max(bi[0], bj[0]);
            float yy1 = std::max(bi[1], bj[1]);
            float xx2 = std::min(bi[2], bj[2]);
            float yy2 = std::min(bi[3], bj[3]);
            float w = std::max(0.f, xx2 - xx1);
            float h = std::max(0.f, yy2 - yy1);
            float inter = w * h;
            float v = inter / (areas[i] + areas[j] - inter);
            iou[(size_t)i * n + j] = v;
            iou[(size_t)j * n + i] = v;
        }
    }
    for (int i = 0; i < n; ++i) max_conf_out[i] = 0.f;
    std::vector<int> order(n);
    std::vector<char> suppressed(n);
    std::vector<float> scores(n);
    for (int c = 1; c < num_classes; ++c) {          // col 0 = background
        for (int i = 0; i < n; ++i)
            scores[i] = cls_prob[(size_t)i * num_classes + c];
        for (int i = 0; i < n; ++i) order[i] = i;
        std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
            return scores[a] > scores[b];
        });
        std::fill(suppressed.begin(), suppressed.end(), 0);
        for (int oi = 0; oi < n; ++oi) {
            int i = order[oi];
            if (suppressed[i]) continue;
            max_conf_out[i] = std::max(max_conf_out[i], scores[i]);
            const float* row = iou.data() + (size_t)i * n;
            for (int oj = oi + 1; oj < n; ++oj) {
                int j = order[oj];
                if (!suppressed[j] && row[j] > iou_threshold)
                    suppressed[j] = 1;
            }
        }
    }
}
