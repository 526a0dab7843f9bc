// The tiled engine's panel plan (host code, C++17, one thread).
//
// Builds the fields of ops/tiled_pairwise.PanelPlan that the numpy plan
// builds with sorts, in two walks, each called twice: once to count, so
// that the caller allocates every output at its exact size, once to fill.
//
// Segments (ks_plan_segments): over the colors of degree >= 2 of the color
// CSR, a segment starts at each color's start and wherever member / panel
// changes.  The members of a color must be ascending (equal ids allowed);
// the caller sorts a CSR that is not, and calls again.
//
// Entries (ks_plan_entries): kept color k owns the segments
// [first_k, first_k + t_k), first_k the sum of t over the colors before k.
// Each pair (a, b) of them, a <= b, in np.triu_indices(t_k) order, is one
// entry of the panel pair key panel[a] * n_panels + panel[b]; a diagonal
// pair (a, a) counts only where segment a holds two members or more.
// Entries are laid out by key, then by t ascending, then by color, then in
// triu order: the order in which the numpy plan's stable sort by key leaves
// its per-t lists.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Pass 1.  offsets[n_colors + 1] rise from 0 to the number of postings;
// members are int32 sample ids.  With seg_start null it only counts: returns
// the number of segments and writes the number of kept colors to *n_kept.
// Otherwise it also writes, per segment, seg_start (into members),
// seg_count, seg_color (the kept color's index among kept colors) and
// seg_panel, and per kept color col_t, its number of segments.  Returns -1
// if a member is below the one before it inside a kept color, -2 if a
// member lies outside [0, n).
int64_t ks_plan_segments(const int64_t* offsets, int64_t n_colors,
                         const int32_t* members, int64_t n, int64_t panel,
                         int64_t* seg_start, int64_t* seg_count,
                         int64_t* seg_color, int32_t* seg_panel,
                         int32_t* col_t, int64_t* n_kept) {
  const bool fill = seg_start != nullptr;
  int64_t s = 0, k = 0;
  for (int64_t c = 0; c < n_colors; ++c) {
    const int64_t lo = offsets[c], hi = offsets[c + 1];
    if (hi - lo < 2) continue;
    const int64_t first = s;
    int32_t prev = members[lo];
    if (prev < 0 || prev >= n) return -2;
    // members below `end` stay in the segment's panel: one division a
    // segment, not one a member
    int64_t pan = prev / panel, end = (pan + 1) * panel, start = lo;
    for (int64_t i = lo + 1; i <= hi; ++i) {
      int64_t p = -1;
      if (i < hi) {
        const int32_t m = members[i];
        if (m < prev) return -1;
        if (m >= n) return -2;
        prev = m;
        if (m < end) continue;
        p = m / panel;
        end = (p + 1) * panel;
      }
      if (fill) {
        seg_start[s] = start;
        seg_count[s] = i - start;
        seg_color[s] = k;
        seg_panel[s] = static_cast<int32_t>(pan);
      }
      ++s;
      start = i;
      pan = p;
    }
    if (fill) col_t[k] = static_cast<int32_t>(s - first);
    ++k;
  }
  *n_kept = k;
  return s;
}

// Pass 2, over pass 1's col_t[n_kept], seg_count and seg_panel.  With
// ent_sega null it adds each entry to key_count[n_panels * n_panels], which
// the caller zeroes, and returns the number of entries.  Otherwise
// key_count holds those counts, and the entries' segment pairs are written
// to ent_sega and ent_segb in the order above; returns the number written.
int64_t ks_plan_entries(const int32_t* col_t, int64_t n_kept,
                        const int64_t* seg_count, const int32_t* seg_panel,
                        int64_t n_panels, int64_t* key_count,
                        int64_t* ent_sega, int64_t* ent_segb) {
  std::vector<int64_t> first(n_kept);
  int64_t total_segs = 0;
  int32_t max_t = 0;
  for (int64_t k = 0; k < n_kept; ++k) {
    first[k] = total_segs;
    total_segs += col_t[k];
    max_t = std::max(max_t, col_t[k]);
  }
  auto entries = [&](int64_t k, auto&& emit) {
    const int64_t f = first[k], t = col_t[k];
    for (int64_t a = f; a < f + t; ++a) {
      const int64_t row = int64_t(seg_panel[a]) * n_panels;
      if (seg_count[a] >= 2) emit(row + seg_panel[a], a, a);
      for (int64_t b = a + 1; b < f + t; ++b) emit(row + seg_panel[b], a, b);
    }
  };
  int64_t total = 0;
  if (ent_sega == nullptr) {
    for (int64_t k = 0; k < n_kept; ++k)
      entries(k, [&](int64_t key, int64_t, int64_t) {
        ++key_count[key];
        ++total;
      });
    return total;
  }
  // the kept colors in a stable counting sort by t
  std::vector<int64_t> by_t(size_t(max_t) + 2, 0);
  for (int64_t k = 0; k < n_kept; ++k) ++by_t[col_t[k] + 1];
  for (int32_t t = 0; t <= max_t; ++t) by_t[t + 1] += by_t[t];
  std::vector<int64_t> order(n_kept);
  for (int64_t k = 0; k < n_kept; ++k) order[by_t[col_t[k]]++] = k;
  std::vector<int64_t> cursor(n_panels * n_panels);
  for (int64_t key = 0, at = 0; key < n_panels * n_panels; ++key) {
    cursor[key] = at;
    at += key_count[key];
  }
  for (const int64_t k : order)
    entries(k, [&](int64_t key, int64_t a, int64_t b) {
      const int64_t at = cursor[key]++;
      ent_sega[at] = a;
      ent_segb[at] = b;
      ++total;
    });
  return total;
}

}  // extern "C"
