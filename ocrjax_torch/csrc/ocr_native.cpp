// Native host library of ocrjax_torch: a copy of ocrjax's
// native/ocr_native.cpp, built by ocrjax_torch/postprocess/native_boxes.py.
//
// The classic DB box extraction on the host (union-find connected
// components, per-component convex hull, rotating-calipers min-area rect,
// the DB unclip rule grow-by-A*ratio/P), the oracle of the device's
// extract_boxes; and the host path's hot loops: the Bayer 4-bit pack and
// the fused canvas decode (polarity, 601 luma, resize, padding, chroma
// fraction). Exposed through a plain C ABI consumed with ctypes.
//
// Build: g++ -O3 -fPIC -std=c++17 -Wall -shared -pthread, done at first use
// into ocrjax_torch/_build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define OCR_X86 1
#endif

namespace {

struct Pt {
  float x, y;
};

// ---------------------------------------------------------------------------
// Union-find
// ---------------------------------------------------------------------------
struct DSU {
  std::vector<int32_t> parent;
  explicit DSU(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];
      a = parent[a];
    }
    return a;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
  }
};

// ---------------------------------------------------------------------------
// Convex hull (Andrew monotone chain) — points must be sorted (x, then y)
// ---------------------------------------------------------------------------
float cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

std::vector<Pt> convex_hull(std::vector<Pt> pts) {
  size_t n = pts.size();
  if (n <= 2) return pts;
  std::sort(pts.begin(), pts.end(), [](const Pt& a, const Pt& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  std::vector<Pt> hull(2 * n);
  size_t k = 0;
  for (size_t i = 0; i < n; ++i) {  // lower
    while (k >= 2 && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  for (size_t i = n - 1, t = k + 1; i-- > 0;) {  // upper
    while (k >= t && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  hull.resize(k > 1 ? k - 1 : k);
  return hull;
}

// ---------------------------------------------------------------------------
// Rotating calipers min-area rect over a convex hull.
// Returns 4 corners (TL-ish order fixed by caller) via out[8].
// ---------------------------------------------------------------------------
void min_area_rect(const std::vector<Pt>& hull, float* out /*8 floats*/,
                   float* w_out, float* h_out) {
  size_t n = hull.size();
  if (n == 0) {
    std::memset(out, 0, 8 * sizeof(float));
    *w_out = *h_out = 0;
    return;
  }
  if (n == 1) {
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = hull[0].x;
      out[2 * i + 1] = hull[0].y;
    }
    *w_out = *h_out = 0;
    return;
  }
  float best_area = 1e30f;
  float bx[4] = {0, 0, 0, 0}, by[4] = {0, 0, 0, 0};
  float bw = 0, bh = 0;
  for (size_t i = 0; i < n; ++i) {
    const Pt& a = hull[i];
    const Pt& b = hull[(i + 1) % n];
    float ex = b.x - a.x, ey = b.y - a.y;
    float len = std::sqrt(ex * ex + ey * ey);
    if (len < 1e-9f) continue;
    ex /= len;
    ey /= len;
    // project all points on edge dir (u) and normal (v)
    float umin = 1e30f, umax = -1e30f, vmin = 1e30f, vmax = -1e30f;
    for (const Pt& p : hull) {
      float u = p.x * ex + p.y * ey;
      float v = -p.x * ey + p.y * ex;
      umin = std::min(umin, u);
      umax = std::max(umax, u);
      vmin = std::min(vmin, v);
      vmax = std::max(vmax, v);
    }
    float area = (umax - umin) * (vmax - vmin);
    if (area < best_area) {
      best_area = area;
      const float us[4] = {umin, umax, umax, umin};
      const float vs[4] = {vmin, vmin, vmax, vmax};
      for (int k = 0; k < 4; ++k) {
        bx[k] = us[k] * ex - vs[k] * ey;
        by[k] = us[k] * ey + vs[k] * ex;
      }
      bw = umax - umin;
      bh = vmax - vmin;
    }
  }
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = bx[k];
    out[2 * k + 1] = by[k];
  }
  *w_out = bw;
  *h_out = bh;
}

void order_quad(float* q /*8 floats, in-place*/) {
  // TL = min sum, BR = max sum, TR = max (x-y), BL = min (x-y)
  float sx[4], dx[4];
  for (int i = 0; i < 4; ++i) {
    sx[i] = q[2 * i] + q[2 * i + 1];
    dx[i] = q[2 * i] - q[2 * i + 1];
  }
  int tl = 0, br = 0, tr = 0, bl = 0;
  for (int i = 1; i < 4; ++i) {
    if (sx[i] < sx[tl]) tl = i;
    if (sx[i] > sx[br]) br = i;
    if (dx[i] > dx[tr]) tr = i;
    if (dx[i] < dx[bl]) bl = i;
  }
  float o[8];
  const int idx[4] = {tl, tr, br, bl};
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = q[2 * idx[i]];
    o[2 * i + 1] = q[2 * idx[i] + 1];
  }
  std::memcpy(q, o, sizeof(o));
}

}  // namespace

extern "C" {

// Two-pass union-find connected components (8-connectivity).
// bitmap: H*W uint8 (0/1). labels_out: H*W int32, -1 = background,
// else compact component id (raster order of first pixel).
// Returns the number of components.
int32_t occ_label(const uint8_t* bitmap, int32_t H, int32_t W,
                  int32_t* labels_out) {
  const int64_t n = static_cast<int64_t>(H) * W;
  DSU dsu(n);
  for (int32_t y = 0; y < H; ++y) {
    for (int32_t x = 0; x < W; ++x) {
      const int64_t i = static_cast<int64_t>(y) * W + x;
      if (!bitmap[i]) continue;
      if (x > 0 && bitmap[i - 1]) dsu.unite(i, i - 1);
      if (y > 0) {
        const int64_t up = i - W;
        if (bitmap[up]) dsu.unite(i, up);
        if (x > 0 && bitmap[up - 1]) dsu.unite(i, up - 1);
        if (x + 1 < W && bitmap[up + 1]) dsu.unite(i, up + 1);
      }
    }
  }
  std::vector<int32_t> compact(n, -1);
  int32_t next_id = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!bitmap[i]) {
      labels_out[i] = -1;
      continue;
    }
    int32_t root = dsu.find(static_cast<int32_t>(i));
    if (compact[root] < 0) compact[root] = next_id++;
    labels_out[i] = compact[root];
  }
  return next_id;
}

// Classic DB box extraction. Writes up to max_out boxes
// (TL,TR,BR,BL × (x,y) = 8 floats each) and scores; returns count.
int32_t occ_extract_boxes(const float* prob, int32_t H, int32_t W,
                          float thresh, float box_thresh, float unclip_ratio,
                          float min_box_size, int32_t max_out,
                          float* boxes_out, float* scores_out) {
  const int64_t n = static_cast<int64_t>(H) * W;
  std::vector<uint8_t> bitmap(n);
  for (int64_t i = 0; i < n; ++i) bitmap[i] = prob[i] > thresh ? 1 : 0;
  std::vector<int32_t> labels(n);
  const int32_t n_comp = occ_label(bitmap.data(), H, W, labels.data());
  if (n_comp == 0) return 0;

  std::vector<std::vector<Pt>> pts(n_comp);
  std::vector<double> score_sum(n_comp, 0.0);
  std::vector<int64_t> count(n_comp, 0);
  for (int32_t y = 0; y < H; ++y) {
    for (int32_t x = 0; x < W; ++x) {
      const int32_t l = labels[static_cast<int64_t>(y) * W + x];
      if (l < 0) continue;
      pts[l].push_back({static_cast<float>(x), static_cast<float>(y)});
      score_sum[l] += prob[static_cast<int64_t>(y) * W + x];
      count[l]++;
    }
  }

  int32_t n_out = 0;
  for (int32_t c = 0; c < n_comp && n_out < max_out; ++c) {
    const float score =
        static_cast<float>(score_sum[c] / std::max<int64_t>(count[c], 1));
    if (score < box_thresh) continue;
    std::vector<Pt> hull = convex_hull(pts[c]);
    float quad[8], bw, bh;
    min_area_rect(hull, quad, &bw, &bh);
    // +1: pixel centers → inclusive pixel extent
    bw += 1.0f;
    bh += 1.0f;
    if (std::min(bw, bh) < min_box_size) continue;
    // unclip: grow the rect by delta = A*r/P along both axes
    const float area = bw * bh;
    const float perim = 2.0f * (bw + bh);
    const float delta = area * unclip_ratio / std::max(perim, 1e-6f);
    // grow each corner away from the centroid along the rect axes
    float cx = 0, cy = 0;
    for (int k = 0; k < 4; ++k) {
      cx += quad[2 * k];
      cy += quad[2 * k + 1];
    }
    cx *= 0.25f;
    cy *= 0.25f;
    // rect axes from corners 0->1 (u) and 0->3 (v)
    float ux = quad[2] - quad[0], uy = quad[3] - quad[1];
    float vx = quad[6] - quad[0], vy = quad[7] - quad[1];
    const float ul = std::sqrt(ux * ux + uy * uy);
    const float vl = std::sqrt(vx * vx + vy * vy);
    if (ul > 1e-6f) {
      ux /= ul;
      uy /= ul;
    }
    if (vl > 1e-6f) {
      vx /= vl;
      vy /= vl;
    }
    for (int k = 0; k < 4; ++k) {
      float px = quad[2 * k] - cx, py = quad[2 * k + 1] - cy;
      const float su = (px * ux + py * uy) >= 0 ? 1.0f : -1.0f;
      const float sv = (px * vx + py * vy) >= 0 ? 1.0f : -1.0f;
      quad[2 * k] += delta * (su * ux + sv * vx);
      quad[2 * k + 1] += delta * (su * uy + sv * vy);
    }
    order_quad(quad);
    for (int k = 0; k < 4; ++k) {
      quad[2 * k] = std::min(std::max(quad[2 * k], 0.0f),
                             static_cast<float>(W - 1));
      quad[2 * k + 1] = std::min(std::max(quad[2 * k + 1], 0.0f),
                                 static_cast<float>(H - 1));
    }
    std::memcpy(boxes_out + 8 * n_out, quad, sizeof(quad));
    scores_out[n_out] = score;
    ++n_out;
  }
  return n_out;
}

// ---------------------------------------------------------------------------
// Bayer-dithered 4-bit link packing (host side of preprocess.pack_nibbles).
//
// q(g, b) = floor(g/17 + (2b+1)/32) = (32g + 34b + 17) / 544 in exact
// integer arithmetic (the numerator is odd, so the value is never an exact
// integer and the float and integer forms agree for every (g, b)). A
// 16-entry LUT per dither phase, rows split over threads.
// ---------------------------------------------------------------------------
static const uint8_t kBayer4[4][4] = {
    {0, 8, 2, 10}, {12, 4, 14, 6}, {3, 11, 1, 9}, {15, 7, 13, 5}};

void occ_pack_nibbles(const uint8_t* gray, int64_t n_rows, int64_t W,
                      uint8_t* out) {
  // gray: (n_rows, W) row-major, W even and divisible by 4 in practice
  // (det canvases); out: (n_rows, W/2). Rows are phase-indexed by absolute
  // row number (callers pass whole images, H % 4 == 0 keeps phases aligned
  // across stacked images).
  static uint8_t lut[16][256];
  static bool lut_init = false;
  if (!lut_init) {
    for (int b = 0; b < 16; ++b)
      for (int g = 0; g < 256; ++g)
        lut[b][g] = static_cast<uint8_t>((32 * g + 34 * b + 17) / 544);
    lut_init = true;
  }
  const int64_t half = W / 2;
  auto do_rows = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      const uint8_t* brow = kBayer4[r & 3];
      const uint8_t* src = gray + r * W;
      uint8_t* dst = out + r * half;
      const uint8_t* L0 = lut[brow[0]];
      const uint8_t* L1 = lut[brow[1]];
      const uint8_t* L2 = lut[brow[2]];
      const uint8_t* L3 = lut[brow[3]];
      int64_t c = 0, o = 0;
      for (; c + 4 <= W; c += 4, o += 2) {
        dst[o] = static_cast<uint8_t>((L0[src[c]] << 4) | L1[src[c + 1]]);
        dst[o + 1] =
            static_cast<uint8_t>((L2[src[c + 2]] << 4) | L3[src[c + 3]]);
      }
      for (; c + 2 <= W; c += 2, ++o)  // W % 4 == 2 tail
        dst[o] = static_cast<uint8_t>((lut[brow[c & 3]][src[c]] << 4) |
                                      lut[brow[(c + 1) & 3]][src[c + 1]]);
    }
  };
  const int64_t kMinRowsPerThread = 512;
  int64_t n_threads =
      std::min<int64_t>(std::thread::hardware_concurrency() | 1,
                        (n_rows + kMinRowsPerThread - 1) / kMinRowsPerThread);
  if (n_threads <= 1) {
    do_rows(0, n_rows);
    return;
  }
  std::vector<std::thread> workers;
  const int64_t per = (n_rows + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t r0 = t * per;
    if (r0 >= n_rows) break;
    workers.emplace_back(do_rows, r0, std::min(r0 + per, n_rows));
  }
  for (auto& w : workers) w.join();
}

// ---------------------------------------------------------------------------
// SIMD RGB→luma. Bit-exact with the scalar fixed-point formula
// ((9798 R + 19235 G + 3735 B + 16384) >> 15): the SSSE3 path deinterleaves
// 16 RGB pixels (48 B) with pshufb masks, widens to 16-bit, and evaluates
// the identical integer expression with _mm_madd_epi16 pairs
// (9798·R + 19235·G) + (3735·B + 16384·1) in 32-bit before the >>15 —
// same arithmetic, same rounding, every input. Runtime-dispatched
// (__builtin_cpu_supports) so the baseline build stays SSE2-safe; the
// scalar loop in occ_decode_canvas remains the fallback and the tail.
// Its time on the card's host is in PERF.md (chip_smoke.py phase 17).
// ---------------------------------------------------------------------------
#ifdef OCR_X86
__attribute__((target("ssse3")))
static void luma_rows_ssse3(const uint8_t* p, uint8_t* dst, int64_t n,
                            bool invert) {
  // pshufb deinterleave masks for 16 px across three 16-B loads
  const __m128i mr0 = _mm_setr_epi8(0, 3, 6, 9, 12, 15, -1, -1, -1, -1, -1,
                                    -1, -1, -1, -1, -1);
  const __m128i mr1 = _mm_setr_epi8(-1, -1, -1, -1, -1, -1, 2, 5, 8, 11, 14,
                                    -1, -1, -1, -1, -1);
  const __m128i mr2 = _mm_setr_epi8(-1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
                                    -1, 1, 4, 7, 10, 13);
  const __m128i mg0 = _mm_setr_epi8(1, 4, 7, 10, 13, -1, -1, -1, -1, -1, -1,
                                    -1, -1, -1, -1, -1);
  const __m128i mg1 = _mm_setr_epi8(-1, -1, -1, -1, -1, 0, 3, 6, 9, 12, 15,
                                    -1, -1, -1, -1, -1);
  const __m128i mg2 = _mm_setr_epi8(-1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
                                    -1, 2, 5, 8, 11, 14);
  const __m128i mb0 = _mm_setr_epi8(2, 5, 8, 11, 14, -1, -1, -1, -1, -1, -1,
                                    -1, -1, -1, -1, -1);
  const __m128i mb1 = _mm_setr_epi8(-1, -1, -1, -1, -1, 1, 4, 7, 10, 13, -1,
                                    -1, -1, -1, -1, -1);
  const __m128i mb2 = _mm_setr_epi8(-1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
                                    0, 3, 6, 9, 12, 15);
  const __m128i wrg = _mm_set1_epi32((19235 << 16) | 9798);
  const __m128i wb1 = _mm_set1_epi32((16384 << 16) | 3735);
  const __m128i ones = _mm_set1_epi8(1);
  const __m128i inv = _mm_set1_epi8(static_cast<char>(0xFF));
  const __m128i zero = _mm_setzero_si128();
  int64_t i = 0;
  for (; i + 16 <= n; i += 16, p += 48) {
    __m128i v0 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
    __m128i v1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 16));
    __m128i v2 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 32));
    if (invert) {
      v0 = _mm_xor_si128(v0, inv);
      v1 = _mm_xor_si128(v1, inv);
      v2 = _mm_xor_si128(v2, inv);
    }
    const __m128i r = _mm_or_si128(
        _mm_or_si128(_mm_shuffle_epi8(v0, mr0), _mm_shuffle_epi8(v1, mr1)),
        _mm_shuffle_epi8(v2, mr2));
    const __m128i g = _mm_or_si128(
        _mm_or_si128(_mm_shuffle_epi8(v0, mg0), _mm_shuffle_epi8(v1, mg1)),
        _mm_shuffle_epi8(v2, mg2));
    const __m128i b = _mm_or_si128(
        _mm_or_si128(_mm_shuffle_epi8(v0, mb0), _mm_shuffle_epi8(v1, mb1)),
        _mm_shuffle_epi8(v2, mb2));
    const __m128i rg_lo = _mm_unpacklo_epi8(r, g);   // r0 g0 r1 g1 … bytes
    const __m128i rg_hi = _mm_unpackhi_epi8(r, g);
    const __m128i b1_lo = _mm_unpacklo_epi8(b, ones);  // b0 1 b1 1 … bytes
    const __m128i b1_hi = _mm_unpackhi_epi8(b, ones);
    __m128i q[4];
    const __m128i pairs[4][2] = {{rg_lo, b1_lo}, {rg_lo, b1_lo},
                                 {rg_hi, b1_hi}, {rg_hi, b1_hi}};
    for (int k = 0; k < 4; ++k) {
      const __m128i rg16 = (k & 1)
          ? _mm_unpackhi_epi8(pairs[k][0], zero)   // 16-bit r g r g (4 px)
          : _mm_unpacklo_epi8(pairs[k][0], zero);
      const __m128i b116 = (k & 1)
          ? _mm_unpackhi_epi8(pairs[k][1], zero)   // 16-bit b 1 b 1 (4 px)
          : _mm_unpacklo_epi8(pairs[k][1], zero);
      q[k] = _mm_srli_epi32(
          _mm_add_epi32(_mm_madd_epi16(rg16, wrg),
                        _mm_madd_epi16(b116, wb1)), 15);
    }
    const __m128i y16a = _mm_packs_epi32(q[0], q[1]);
    const __m128i y16b = _mm_packs_epi32(q[2], q[3]);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + i),
                     _mm_packus_epi16(y16a, y16b));
  }
  for (; i < n; ++i, p += 3) {  // scalar tail, same formula
    const int32_t r = invert ? 255 - p[0] : p[0];
    const int32_t g = invert ? 255 - p[1] : p[1];
    const int32_t b = invert ? 255 - p[2] : p[2];
    dst[i] = static_cast<uint8_t>(
        (9798 * r + 19235 * g + 3735 * b + 16384) >> 15);
  }
}

static bool has_ssse3() {
  static const bool ok = __builtin_cpu_supports("ssse3");
  return ok;
}
#endif  // OCR_X86

// ---------------------------------------------------------------------------
// Fused host decode of the detection canvas (the host_decode hot path).
//
// RGB/gray (h, w, c) u8 → 601-luma canvas (S, S) u8 with the aspect-
// preserving long-side resize to S (never upscaled), replicate padding,
// polarity canonicalization (config.auto_invert — median subsampled luma
// below 128 ⇒ light-on-dark ⇒ invert; the LOWER median of an even
// sample count, where is_inverted's np.median averages the two middles), and the color-reroute chroma
// fraction, all in ~2 streaming passes, in place of the chain
// asarray-copy → is_inverted → resize(RGB) → canvas pad → luma
// (+ color_fraction). The numpy twin is preprocess.decode_canvas_luma_first.
//
// Luma matches cv2 RGB2GRAY bit-exactly ((9798 R + 19235 G + 3735 B +
// 16384) >> 15, cv2 5.0's shift-15 fixed point). Resize is luma-first bilinear: luma(bilinear(RGB)) and
// bilinear(luma(RGB)) agree up to ±1 rounding because both maps are
// linear; the no-resize case (page already canvas-sized, the bench and
// most gates) is bit-exact vs the cv2 path.
// ---------------------------------------------------------------------------
void occ_decode_canvas(const uint8_t* img, int64_t h, int64_t w, int64_t c,
                       int64_t S, int32_t auto_invert, int32_t chroma_thresh,
                       uint8_t* out /* (S, S) */,
                       int64_t* meta /* [nh, nw, inverted, chroma, samples] */
                       ) {
  // --- pass 0: stride-4 subsample → luma-sum histogram (median) + chroma
  int64_t hist[766] = {0};
  int64_t n_samp = 0, n_chroma = 0;
  for (int64_t y = 0; y < h; y += 4) {
    const uint8_t* row = img + y * w * c;
    for (int64_t x = 0; x < w; x += 4) {
      const uint8_t* p = row + x * c;
      if (c == 3) {
        const int32_t r = p[0], g = p[1], b = p[2];
        hist[r + g + b]++;
        const int32_t mx = std::max(r, std::max(g, b));
        const int32_t mn = std::min(r, std::min(g, b));
        if (mx - mn > chroma_thresh) ++n_chroma;
      } else {
        hist[3 * p[0]]++;
      }
      ++n_samp;
    }
  }
  int64_t half = (n_samp + 1) / 2, acc = 0;
  int32_t median_sum = 765;
  for (int32_t v = 0; v < 766; ++v) {
    acc += hist[v];
    if (acc >= half) {
      median_sum = v;
      break;
    }
  }
  // mean-channel median < 128  ⇔  channel-sum median < 384
  const bool invert = auto_invert && median_sum < 384;

  // --- pass 1: full-res luma (+ inversion) --------------------------------
  // No-resize case (page already canvas-sized — the bench and most serving
  // inputs): luma lands DIRECTLY in the out canvas at row stride S, so the
  // scratch alloc+memset and the pass-2 row copies vanish (a
  // zero-initializing std::vector would be a third pass over the image).
  const double scale = std::min(static_cast<double>(S) / std::max(h, w), 1.0);
  const int64_t nh = std::max<int64_t>(1, llround(h * scale));
  const int64_t nw = std::max<int64_t>(1, llround(w * scale));
  const bool same_size = (nh == h && nw == w);
  std::unique_ptr<uint8_t[]> scratch;
  uint8_t* lbuf = out;           // same_size: rows at stride S
  int64_t lstride = S;
  if (!same_size) {
    scratch.reset(new uint8_t[static_cast<size_t>(h) * w]);  // uninitialized
    lbuf = scratch.get();
    lstride = w;
  }
  auto do_luma = [&](int64_t r0, int64_t r1) {
    for (int64_t y = r0; y < r1; ++y) {
      uint8_t* dst = lbuf + y * lstride;
      if (c == 3) {
        const uint8_t* p = img + y * w * 3;
#ifdef OCR_X86
        if (has_ssse3()) {
          luma_rows_ssse3(p, dst, w, invert);
          continue;
        }
#endif
        if (invert) {
          for (int64_t x = 0; x < w; ++x, p += 3)
            // channel-wise inversion BEFORE the fixed-point luma, matching
            // load_image(255 - rgb) -> cv2 luma bit-exactly (255 - luma(rgb)
            // differs by one rounding step on ~1e-4 of pixels)
            dst[x] = static_cast<uint8_t>(
                (9798 * (255 - p[0]) + 19235 * (255 - p[1]) +
                 3735 * (255 - p[2]) + 16384) >> 15);
        } else {
          for (int64_t x = 0; x < w; ++x, p += 3)
            dst[x] = static_cast<uint8_t>(
                (9798 * p[0] + 19235 * p[1] + 3735 * p[2] + 16384) >> 15);
        }
      } else {
        const uint8_t* p = img + y * w;
        if (invert) {
          for (int64_t x = 0; x < w; ++x)
            dst[x] = static_cast<uint8_t>(255 - p[x]);
        } else {
          std::memcpy(dst, p, static_cast<size_t>(w));
        }
      }
    }
  };
  const int64_t kMinRows = (1 << 20) / std::max<int64_t>(w, 1);
  int64_t n_threads = std::min<int64_t>(
      std::thread::hardware_concurrency() | 1,
      (h + kMinRows - 1) / std::max<int64_t>(kMinRows, 1));
  if (n_threads <= 1) {
    do_luma(0, h);
  } else {
    std::vector<std::thread> workers;
    const int64_t per = (h + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; ++t) {
      const int64_t r0 = t * per;
      if (r0 >= h) break;
      workers.emplace_back(do_luma, r0, std::min(r0 + per, h));
    }
    for (auto& wk : workers) wk.join();
  }

  // --- pass 2: resize into the canvas + replicate pad ---------------------
  if (same_size) {
    // luma already wrote the canvas rows in place
  } else {
    const uint8_t* luma = scratch.get();
    // bilinear, cv2 INTER_LINEAR pixel-center convention
    std::vector<int32_t> xi(nw);
    std::vector<float> xw(nw);
    const double ix = static_cast<double>(w) / nw;
    for (int64_t x = 0; x < nw; ++x) {
      double fx = (x + 0.5) * ix - 0.5;
      if (fx < 0) fx = 0;
      if (fx > w - 1) fx = w - 1;
      const int32_t x0 = static_cast<int32_t>(fx);
      xi[x] = std::min<int32_t>(x0, static_cast<int32_t>(w) - 2);
      if (w == 1) xi[x] = 0;
      xw[x] = static_cast<float>(fx - xi[x]);
    }
    const double iy = static_cast<double>(h) / nh;
    for (int64_t y = 0; y < nh; ++y) {
      double fy = (y + 0.5) * iy - 0.5;
      if (fy < 0) fy = 0;
      if (fy > h - 1) fy = h - 1;
      int32_t y0 = static_cast<int32_t>(fy);
      if (h > 1) y0 = std::min<int32_t>(y0, static_cast<int32_t>(h) - 2);
      const float wy = (h > 1) ? static_cast<float>(fy - y0) : 0.0f;
      const uint8_t* r0 = luma + static_cast<int64_t>(y0) * w;
      const uint8_t* r1 = (h > 1) ? r0 + w : r0;
      uint8_t* dst = out + y * S;
      for (int64_t x = 0; x < nw; ++x) {
        const int32_t x0 = xi[x];
        const int32_t x1 = (w > 1) ? x0 + 1 : x0;
        const float wx = xw[x];
        const float top = r0[x0] + wx * (r0[x1] - r0[x0]);
        const float bot = r1[x0] + wx * (r1[x1] - r1[x0]);
        dst[x] = static_cast<uint8_t>(top + wy * (bot - top) + 0.5f);
      }
    }
  }
  for (int64_t y = 0; y < nh; ++y) {  // replicate right edge
    uint8_t* row = out + y * S;
    std::memset(row + nw, row[nw - 1], static_cast<size_t>(S - nw));
  }
  for (int64_t y = nh; y < S; ++y)  // replicate bottom rows
    std::memcpy(out + y * S, out + (nh - 1) * S, static_cast<size_t>(S));

  meta[0] = nh;
  meta[1] = nw;
  meta[2] = invert ? 1 : 0;
  meta[3] = n_chroma;
  meta[4] = n_samp;
}

}  // extern "C"
