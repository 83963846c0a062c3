// Sliding-histogram disk rank-equalize: the hot loop of histeq=local
// (harness/histeq.py equalize_local; reference utils/eval_metrics.py:332-339,
// skimage.filters.rank.equalize over disk(55)). A copy of the JAX package's
// evreal_tpu/native/histeq.cpp, built and loaded by native/__init__.py.
//
// Semantics (bit-identical to harness/histeq.py rank_equalize_plain): for
// each pixel, rank = count of footprint neighbors inside the image with
// value <= center (center included), pop = count of footprint positions
// inside the image, out = uint8(floor(rank * 255 / pop)).
//
// Algorithm: per output row, maintain a 256-bin histogram (plus a 16-bin
// coarse level for O(16) rank queries) of the disk window and slide it one
// column at a time: the cells entering/leaving are the disk's boundary
// columns, ~2*(2r+1) updates per pixel instead of re-scanning the ~pi*r^2
// footprint (~240 operations a pixel at r = 55).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" int evreal_rank_equalize(const uint8_t* img, int64_t h, int64_t w,
                                    int64_t radius, uint8_t* out) {
  const int r = static_cast<int>(radius);
  if (h <= 0 || w <= 0 || r <= 0 || !img || !out) return 1;

  // span[dy+r]: max |dx| with dx^2 + dy^2 <= r^2 (exact integer sqrt)
  std::vector<int> span(2 * r + 1);
  for (int dy = -r; dy <= r; ++dy) {
    int rem = r * r - dy * dy;
    int s = 0;
    while ((s + 1) * (s + 1) <= rem) ++s;
    span[dy + r] = s;
  }

  std::vector<int> hist(256), coarse(16);
  for (int64_t y = 0; y < h; ++y) {
    std::fill(hist.begin(), hist.end(), 0);
    std::fill(coarse.begin(), coarse.end(), 0);
    int64_t pop = 0;
    const int y0 = static_cast<int>(std::max<int64_t>(0, y - r));
    const int y1 = static_cast<int>(std::min<int64_t>(h - 1, y + r));

    // build the window centered at x = 0: columns [-s, s] clipped to image
    for (int yy = y0; yy <= y1; ++yy) {
      const int s = span[yy - static_cast<int>(y) + r];
      const uint8_t* row = img + static_cast<int64_t>(yy) * w;
      const int xmax = std::min<int>(static_cast<int>(w) - 1, s);
      for (int xx = 0; xx <= xmax; ++xx) {
        ++hist[row[xx]];
        ++coarse[row[xx] >> 4];
        ++pop;
      }
    }

    for (int64_t x = 0; x < w; ++x) {
      const uint8_t cv = img[y * w + x];
      int rank = 0;
      const int cb = cv >> 4;
      for (int b = 0; b < cb; ++b) rank += coarse[b];
      for (int v = cb << 4; v <= cv; ++v) rank += hist[v];
      // exact integer floor(rank * 255 / pop) — matches the float64 path:
      // both operands are exact, and a float64 quotient cannot cross an
      // integer boundary unless the exact quotient is that integer
      out[y * w + x] =
          static_cast<uint8_t>(static_cast<int64_t>(rank) * 255 / pop);

      if (x + 1 < w) {
        for (int yy = y0; yy <= y1; ++yy) {
          const int s = span[yy - static_cast<int>(y) + r];
          const uint8_t* row = img + static_cast<int64_t>(yy) * w;
          const int xl = static_cast<int>(x) - s;      // column leaving
          if (xl >= 0) {
            --hist[row[xl]];
            --coarse[row[xl] >> 4];
            --pop;
          }
          const int xe = static_cast<int>(x) + 1 + s;  // column entering
          if (xe < w) {
            ++hist[row[xe]];
            ++coarse[row[xe] >> 4];
            ++pop;
          }
        }
      }
    }
  }
  return 0;
}
