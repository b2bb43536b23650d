// Marker-based watershed (priority-flood) for instance splitting.
//
// The binary U-Net merges touching cells into one component (the measured
// NS=453 splitting ops on seq 01 — docs/RESULTS.md); watershed on the
// negated distance transform with interior markers is the classic fix.
// Neither skimage nor scipy provides watershed in this environment, so it
// lives in the native library next to the CTC measures: a textbook
// priority-flood — pop the lowest-elevation labeled frontier pixel, claim
// unlabeled neighbors inside the mask, push them at max(elev, their own).
//
// C ABI, consumed via ctypes from unetseg_tpu_torch/post/watershed.py, which
// builds it with g++ into unetseg_tpu_torch/build/native/ (a copy of
// unetseg_tpu/native/watershed.cpp).

#include <cstdint>
#include <queue>
#include <vector>

namespace {

struct Node {
  float elevation;
  int64_t order;  // FIFO tie-break for equal elevations (stable fronts)
  int32_t idx;
};

struct Cmp {
  bool operator()(const Node& a, const Node& b) const {
    if (a.elevation != b.elevation) return a.elevation > b.elevation;
    return a.order > b.order;
  }
};

}  // namespace

extern "C" {

// elevation: (h*w) float32 — flood ascends this (pass -distance to split at
// ridges of the distance transform).
// mask: (h*w) uint8 — only pixels with mask != 0 are claimable.
// labels: (h*w) uint16 in/out — nonzero entries are the markers; on return
// every masked pixel connected to a marker carries a marker's label.
// connectivity: 4 or 8.
int watershed(const float* elevation, const uint8_t* mask, uint16_t* labels,
              int64_t h, int64_t w, int connectivity) {
  const int64_t n = h * w;
  std::priority_queue<Node, std::vector<Node>, Cmp> pq;
  std::vector<uint8_t> queued(n, 0);
  int64_t order = 0;

  const int dx8[] = {-1, 1, 0, 0, -1, -1, 1, 1};
  const int dy8[] = {0, 0, -1, 1, -1, 1, -1, 1};
  const int n_nb = connectivity == 8 ? 8 : 4;

  for (int64_t i = 0; i < n; ++i) {
    if (labels[i] && mask[i]) {
      pq.push({elevation[i], order++, int32_t(i)});
      queued[i] = 1;
    }
  }

  while (!pq.empty()) {
    Node nd = pq.top();
    pq.pop();
    const int64_t i = nd.idx;
    const uint16_t lab = labels[i];
    const int64_t y = i / w, x = i % w;
    for (int k = 0; k < n_nb; ++k) {
      const int64_t ny = y + dy8[k], nx = x + dx8[k];
      if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
      const int64_t j = ny * w + nx;
      if (!mask[j] || labels[j] || queued[j]) continue;
      labels[j] = lab;
      queued[j] = 1;
      pq.push({elevation[j] > nd.elevation ? elevation[j] : nd.elevation,
               order++, int32_t(j)});
    }
  }
  return 0;
}

}  // extern "C"
