// Native implementation of the Cell Tracking Challenge measures SEG, TRA, DET.
//
// The reference bundles the official prebuilt executables for macOS/Windows
// only (reference: EvaluationSoftware/{Mac,Win}, SURVEY.md §2 C15); nothing
// runnable ships for Linux, so this framework implements the measures from
// their published definitions:
//
//  - SEG: mean Jaccard over GT objects, matching a result object to a GT
//    object iff |R ∩ G| > 0.5 |G| (Ulman et al., Nat. Methods 2017).
//  - TRA/DET: AOGM graph-edit distance (Matula et al., PLOS ONE 2015) with
//    the challenge weights NS=5, FN=10, FP=1, ED=1, EA=1.5, EC=1;
//    TRA = 1 - min(AOGM, AOGM_0)/AOGM_0 with AOGM_0 = 10·|V_gt| + 1.5·|E_gt|;
//    DET uses the vertex terms only (AOGM-D, AOGM-D0 = 10·|V_gt|), with the
//    official `penalize_extra_detections` switch zeroing the FP weight.
//
// Validated bit-for-bit against the golden values and the full op-count log
// shipped with the reference (EvaluationSoftware/testing_dataset: SEG
// 0.232874 / 0.443686, TRA 0.622980, DET 0.688000 / 0.700000; op breakdown
// in 03_RES/TRA_log.txt). See tests/test_ctc_measures.py.
//
// C ABI, consumed via ctypes from unetseg_tpu_torch/metrics/ctc.py, which
// builds it with g++ into unetseg_tpu_torch/build/native/ (a copy of
// unetseg_tpu/native/ctc_measures.cpp).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <set>
#include <unordered_map>
#include <vector>

namespace {

using u16 = uint16_t;
using i64 = int64_t;

// Per-frame overlap histogram between two label images.
struct FrameOverlap {
  std::unordered_map<uint32_t, i64> joint;   // key = gt<<16 | res (nonzero pairs incl. bg pairing)
  std::unordered_map<u16, i64> gt_size;
  std::unordered_map<u16, i64> res_size;
};

FrameOverlap overlaps(const u16* gt, const u16* res, i64 n) {
  FrameOverlap o;
  o.joint.reserve(256);
  for (i64 i = 0; i < n; ++i) {
    u16 g = gt[i], r = res[i];
    if (g) o.gt_size[g]++;
    if (r) o.res_size[r]++;
    if (g && r) o.joint[(uint32_t(g) << 16) | r]++;
  }
  return o;
}

// For each GT label, the result label covering a strict majority of it (0 if none).
std::unordered_map<u16, u16> majority_match(const FrameOverlap& o) {
  std::unordered_map<u16, u16> match;
  for (const auto& kv : o.joint) {
    u16 g = u16(kv.first >> 16), r = u16(kv.first & 0xffff);
    if (2 * kv.second > o.gt_size.at(g)) match[g] = r;
  }
  return match;
}

struct Vertex {
  int t;
  u16 label;
  bool operator<(const Vertex& other) const {
    return t != other.t ? t < other.t : label < other.label;
  }
  bool operator==(const Vertex& other) const {
    return t == other.t && label == other.label;
  }
};

struct Edge {
  Vertex u, v;
  int type;  // 0 = track link, 1 = parent (division) link
  bool operator<(const Edge& other) const {
    if (!(u == other.u)) return u < other.u;
    if (!(v == other.v)) return v < other.v;
    return type < other.type;
  }
};

struct TrackRow {
  i64 label, begin, end, parent;
};

// Build the acyclic oriented graph from track rows + per-frame label presence.
// Track edges connect temporally consecutive appearances of a label within
// its [begin, end]; parent edges connect the parent's last appearance to the
// child's first.
void build_graph(const std::vector<TrackRow>& rows,
                 const std::vector<std::set<u16>>& present,
                 std::set<Vertex>* vertices,
                 std::map<std::pair<Vertex, Vertex>, int>* edges) {
  int nframes = int(present.size());
  std::unordered_map<i64, const TrackRow*> by_label;
  for (const auto& r : rows) by_label[r.label] = &r;

  std::unordered_map<i64, std::vector<int>> appearances;
  for (const auto& r : rows) {
    auto& app = appearances[r.label];
    for (int t = std::max<i64>(0, r.begin);
         t <= std::min<i64>(nframes - 1, r.end); ++t) {
      if (present[t].count(u16(r.label))) {
        app.push_back(t);
        vertices->insert({t, u16(r.label)});
      }
    }
    for (size_t k = 0; k + 1 < app.size(); ++k) {
      (*edges)[{{app[k], u16(r.label)}, {app[k + 1], u16(r.label)}}] = 0;
    }
  }
  for (const auto& r : rows) {
    if (r.parent <= 0) continue;
    auto pit = appearances.find(r.parent);
    auto cit = appearances.find(r.label);
    if (pit == appearances.end() || cit == appearances.end()) continue;
    if (pit->second.empty() || cit->second.empty()) continue;
    int tp = pit->second.back(), tc = cit->second.front();
    if (tp < tc) {
      (*edges)[{{tp, u16(r.parent)}, {tc, u16(r.label)}}] = 1;
    }
  }
}

}  // namespace

extern "C" {

// SEG measure. gt/res: nframes stacked (h*w) uint16 label images (the GT
// stack holds only the annotated frames, paired index-by-index with res).
// Returns the mean Jaccard; n_out gets the GT object count. If per_object is
// non-null it receives one Jaccard per GT object (caller allocates >= count;
// call once with per_object=null to size).
double ctc_seg(const u16* gt, const u16* res, int nframes, i64 h, i64 w,
               double* per_object, i64* n_out) {
  i64 n = h * w;
  double sum = 0.0;
  i64 count = 0;
  for (int t = 0; t < nframes; ++t) {
    FrameOverlap o = overlaps(gt + t * n, res + t * n, n);
    // deterministic order over GT labels
    std::vector<u16> gl;
    for (const auto& kv : o.gt_size) gl.push_back(kv.first);
    std::sort(gl.begin(), gl.end());
    auto match = majority_match(o);
    for (u16 g : gl) {
      double j = 0.0;
      auto it = match.find(g);
      if (it != match.end()) {
        i64 inter = o.joint.at((uint32_t(g) << 16) | it->second);
        i64 uni = o.gt_size.at(g) + o.res_size.at(it->second) - inter;
        j = double(inter) / double(uni);
      }
      if (per_object) per_object[count] = j;
      sum += j;
      ++count;
    }
  }
  if (n_out) *n_out = count;
  return count ? sum / double(count) : 0.0;
}

// TRA + DET (AOGM). gt/res: nframes stacked (h*w) uint16 marker images.
// gt_tracks/res_tracks: rows of 4 int64 (label, begin, end, parent).
// out (size >= 14): [0] TRA, [1] DET, [2] DET with FP weight 0,
// [3] AOGM, [4] AOGM_0, [5] NS, [6] FN, [7] FP, [8] ED, [9] EA, [10] EC,
// [11] |V_gt|, [12] |E_gt|, [13] AOGM-D.
// Returns 0 on success.
int ctc_tra(const u16* gt, const u16* res, int nframes, i64 h, i64 w,
            const i64* gt_tracks, int n_gt_rows,
            const i64* res_tracks, int n_res_rows,
            double* out) {
  i64 n = h * w;

  std::vector<TrackRow> gt_rows(n_gt_rows), res_rows(n_res_rows);
  for (int i = 0; i < n_gt_rows; ++i)
    gt_rows[i] = {gt_tracks[4 * i], gt_tracks[4 * i + 1], gt_tracks[4 * i + 2],
                  gt_tracks[4 * i + 3]};
  for (int i = 0; i < n_res_rows; ++i)
    res_rows[i] = {res_tracks[4 * i], res_tracks[4 * i + 1],
                   res_tracks[4 * i + 2], res_tracks[4 * i + 3]};

  std::vector<std::set<u16>> gt_present(nframes), res_present(nframes);
  // res vertex -> set of matched gt labels (empty/absent = FP vertex)
  std::map<Vertex, std::vector<u16>> res_matches;

  double NS = 0, FN = 0, FP = 0;
  for (int t = 0; t < nframes; ++t) {
    FrameOverlap o = overlaps(gt + t * n, res + t * n, n);
    for (const auto& kv : o.gt_size) gt_present[t].insert(kv.first);
    for (const auto& kv : o.res_size) res_present[t].insert(kv.first);
    auto match = majority_match(o);
    std::unordered_map<u16, int> k;  // res label -> matched gt count
    for (const auto& kv : match) {
      k[kv.second]++;
      res_matches[{t, kv.second}].push_back(kv.first);
    }
    for (const auto& kv : o.gt_size)
      if (!match.count(kv.first)) FN += 1;
    for (const auto& kv : o.res_size) {
      auto it = k.find(kv.first);
      if (it == k.end())
        FP += 1;
      else if (it->second > 1)
        NS += it->second - 1;
    }
  }

  std::set<Vertex> gt_vertices, res_vertices;
  std::map<std::pair<Vertex, Vertex>, int> gt_edges, res_edges;
  build_graph(gt_rows, gt_present, &gt_vertices, &gt_edges);
  build_graph(res_rows, res_present, &res_vertices, &res_edges);

  // Edge comparison. Deleting an FP vertex removes its incident edges for
  // free, so a res edge is "redundant" (ED) only when BOTH endpoints are
  // detected (matched by >= 1 GT vertex) yet no pair of their matched GT
  // vertices forms a GT edge — confirmed against the official TRA_log.txt
  // breakdown (1 ED for seq 03, not one per FP-incident edge).
  double ED = 0, EC = 0;
  std::set<std::pair<Vertex, Vertex>> covered;
  for (const auto& ekv : res_edges) {
    const Vertex& u = ekv.first.first;
    const Vertex& v = ekv.first.second;
    auto mu = res_matches.find(u);
    auto mv = res_matches.find(v);
    bool det_u = mu != res_matches.end() && !mu->second.empty();
    bool det_v = mv != res_matches.end() && !mv->second.empty();
    if (!det_u || !det_v) continue;  // edge vanishes with its FP endpoint
    // Correspondence is defined only between uniquely matched vertices;
    // edges incident to a split (multiply-matched) vertex are resolved by
    // the splitting op itself and carry no separate edge penalty.
    bool unique_u = mu->second.size() == 1;
    bool unique_v = mv->second.size() == 1;
    if (!unique_u || !unique_v) continue;
    Vertex gu{u.t, mu->second[0]}, gv{v.t, mv->second[0]};
    auto git = gt_edges.find({gu, gv});
    if (git != gt_edges.end()) {
      covered.insert({gu, gv});
      if (git->second != ekv.second) EC += 1;
    } else {
      ED += 1;
    }
  }
  double EA = double(gt_edges.size()) - double(covered.size());

  double aogm = 10 * FN + 5 * NS + 1 * FP + 1 * ED + 1.5 * EA + 1 * EC;
  double aogm0 = 10 * double(gt_vertices.size()) + 1.5 * double(gt_edges.size());
  double aogmd = 10 * FN + 5 * NS + 1 * FP;
  double aogmd_nofp = 10 * FN + 5 * NS;
  double aogmd0 = 10 * double(gt_vertices.size());

  out[0] = aogm0 > 0 ? 1.0 - std::min(aogm, aogm0) / aogm0 : 0.0;
  out[1] = aogmd0 > 0 ? 1.0 - std::min(aogmd, aogmd0) / aogmd0 : 0.0;
  out[2] = aogmd0 > 0 ? 1.0 - std::min(aogmd_nofp, aogmd0) / aogmd0 : 0.0;
  out[3] = aogm;
  out[4] = aogm0;
  out[5] = NS;
  out[6] = FN;
  out[7] = FP;
  out[8] = ED;
  out[9] = EA;
  out[10] = EC;
  out[11] = double(gt_vertices.size());
  out[12] = double(gt_edges.size());
  out[13] = aogmd;
  return 0;
}

}  // extern "C"
