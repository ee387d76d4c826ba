// Native geometry engine: scanline rasterization + marching squares.
//
// Host-side hot spots of the geo data plane for production-size scenes
// (10k×10k rasters, shapefile masks with 10^4-10^5 vertices): the Python
// fallbacks in geo/rasterize.py and geo/contours.py are row-loop bound; these
// implementations are edge-table scanline fills and a single-pass cell sweep.
// Bound via ctypes from the same libbstnative.so as the TIFF codec.
//
// Semantics match the Python fallbacks exactly (tested against each other):
//   - rasterize: GDAL center rule — pixel (r, c) burns when its center
//     (c+0.5, r+0.5) is inside by even-odd counting, half-open edge spans.
//   - marching squares: case table with level interpolation, saddle cells
//     disambiguated by cell mean (skimage default).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// pts: flattened (x, y) doubles for all rings, in PIXEL space.
// ring_sizes[n_rings]: vertex counts. OR-burns into out (h*w uint8).
int bst_rasterize(const double* pts, const int32_t* ring_sizes, int n_rings,
                  int height, int width, uint8_t* out) {
  // gather edges
  struct Edge { double x0, y0, x1, y1; };
  std::vector<Edge> edges;
  size_t base = 0;
  for (int r = 0; r < n_rings; r++) {
    int n = ring_sizes[r];
    for (int i = 0; i < n; i++) {
      int j = (i + 1) % n;
      double x0 = pts[(base + i) * 2], y0 = pts[(base + i) * 2 + 1];
      double x1 = pts[(base + j) * 2], y1 = pts[(base + j) * 2 + 1];
      if (y0 == y1 && x0 == x1) continue;
      edges.push_back({x0, y0, x1, y1});
    }
    base += n;
  }
  if (edges.empty()) return 0;

  // Active-edge-table sweep: bucket each edge at its first active row, keep a
  // live set while sweeping, lazily evicting expired edges — O(E + R + X)
  // instead of O(R·E) for production-size masks.
  double ymin_all = 1e300, ymax_all = -1e300;
  for (auto& e : edges) {
    ymin_all = std::min(ymin_all, std::min(e.y0, e.y1));
    ymax_all = std::max(ymax_all, std::max(e.y0, e.y1));
  }
  int r0 = std::max(0, (int)std::floor(ymin_all - 0.5));
  int r1 = std::min(height - 1, (int)std::ceil(ymax_all));
  if (r1 < r0) return 0;

  std::vector<std::vector<int>> starts(r1 - r0 + 1);
  for (int i = 0; i < (int)edges.size(); i++) {
    double lo = std::min(edges[i].y0, edges[i].y1);
    // first row whose center y = row + 0.5 satisfies lo <= y
    int first = std::max(r0, (int)std::ceil(lo - 0.5));
    if (first <= r1) starts[first - r0].push_back(i);
  }

  std::vector<int> active;
  std::vector<double> xs;
  for (int row = r0; row <= r1; row++) {
    double y = row + 0.5;
    for (int i : starts[row - r0]) active.push_back(i);
    xs.clear();
    size_t keep = 0;
    for (size_t a = 0; a < active.size(); a++) {
      const Edge& e = edges[active[a]];
      double lo = std::min(e.y0, e.y1), hi = std::max(e.y0, e.y1);
      if (y >= hi) continue;  // expired — evict
      active[keep++] = active[a];
      if (y < lo) continue;  // not yet active at this center (sub-row edge)
      double t = (y - e.y0) / (e.y1 - e.y0);
      xs.push_back(e.x0 + t * (e.x1 - e.x0));
    }
    active.resize(keep);
    if (xs.empty()) continue;
    std::sort(xs.begin(), xs.end());
    // even-odd fill between crossing pairs: centers c+0.5 in [xs[i], xs[i+1])
    uint8_t* row_out = out + (size_t)row * width;
    for (size_t i = 0; i + 1 < xs.size(); i += 2) {
      int c0 = (int)std::ceil(xs[i] - 0.5);
      int c1 = (int)std::ceil(xs[i + 1] - 0.5);  // exclusive
      c0 = std::max(c0, 0);
      c1 = std::min(c1, width);
      for (int c = c0; c < c1; c++) row_out[c] = 1;
    }
  }
  return 0;
}

// Marching squares at `level` over an h×w float image. Writes up to max_segs
// segments as (r0, c0, r1, c1) doubles. Returns the number of segments, or
// -(needed) when max_segs is too small (caller retries with a bigger buffer).
int bst_marching_squares(const float* img, int h, int w, double level,
                         double* out, int max_segs) {
  int count = 0;
  auto emit = [&](double r0, double c0, double r1, double c1) {
    if (count < max_segs) {
      out[count * 4] = r0;
      out[count * 4 + 1] = c0;
      out[count * 4 + 2] = r1;
      out[count * 4 + 3] = c1;
    }
    count++;
  };
  auto interp = [&](double v0, double v1) {
    return v1 == v0 ? 0.5 : (level - v0) / (v1 - v0);
  };
  for (int r = 0; r + 1 < h; r++) {
    const float* row0 = img + (size_t)r * w;
    const float* row1 = img + (size_t)(r + 1) * w;
    for (int c = 0; c + 1 < w; c++) {
      double tl = row0[c], tr = row0[c + 1], bl = row1[c], br = row1[c + 1];
      int k = (tl > level ? 8 : 0) | (tr > level ? 4 : 0) | (br > level ? 2 : 0) | (bl > level ? 1 : 0);
      if (k == 0 || k == 15) continue;
      double top_r = r, top_c = c + interp(tl, tr);
      double bot_r = r + 1, bot_c = c + interp(bl, br);
      double lef_r = r + interp(tl, bl), lef_c = c;
      double rig_r = r + interp(tr, br), rig_c = c + 1;
      switch (k) {
        case 1: emit(lef_r, lef_c, bot_r, bot_c); break;
        case 2: emit(bot_r, bot_c, rig_r, rig_c); break;
        case 3: emit(lef_r, lef_c, rig_r, rig_c); break;
        case 4: emit(rig_r, rig_c, top_r, top_c); break;
        case 5:
          if ((tl + tr + bl + br) / 4.0 > level) {
            emit(rig_r, rig_c, bot_r, bot_c);
            emit(lef_r, lef_c, top_r, top_c);
          } else {
            emit(lef_r, lef_c, bot_r, bot_c);
            emit(rig_r, rig_c, top_r, top_c);
          }
          break;
        case 6: emit(bot_r, bot_c, top_r, top_c); break;
        case 7: emit(lef_r, lef_c, top_r, top_c); break;
        case 8: emit(top_r, top_c, lef_r, lef_c); break;
        case 9: emit(top_r, top_c, bot_r, bot_c); break;
        case 10:
          if ((tl + tr + bl + br) / 4.0 > level) {
            emit(top_r, top_c, rig_r, rig_c);
            emit(bot_r, bot_c, lef_r, lef_c);
          } else {
            emit(top_r, top_c, lef_r, lef_c);
            emit(bot_r, bot_c, rig_r, rig_c);
          }
          break;
        case 11: emit(top_r, top_c, rig_r, rig_c); break;
        case 12: emit(rig_r, rig_c, lef_r, lef_c); break;
        case 13: emit(rig_r, rig_c, bot_r, bot_c); break;
        case 14: emit(bot_r, bot_c, lef_r, lef_c); break;
      }
    }
  }
  return count <= max_segs ? count : -count;
}

}  // extern "C"
