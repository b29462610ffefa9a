// Native ingest library of chromegcn_tpu_torch: a host C++ library, built
// by native_bridge.py with g++ at first use and loaded with ctypes. Its own
// copy of chromegcn_tpu/native/chromegcn_native.cc; both functions are the
// same code, so the two libraries give the same results bit for bit.
//
// - hic_topk: streams Juicer "RAWobserved" contact dumps (bin1\tbin2\tval,
//   up to ~126M lines per chromosome — reference: data/7create_graph_new.py:73),
//   applies KR/VC/SQRTVC normalization (val / (norm[bin1/res] * norm[bin2/res]),
//   reference: data/7create_graph_new.py:80-84) and keeps the top-k contacts
//   among peak-window bins with a bounded min-heap — replacing the
//   reference's sort-everything-in-python approach (get_top_contact_locs,
//   data/7create_graph_new.py:93-104) and the external `sort -r -k3 -n`
//   (reference: data/extras/sort_hic.py:36).
// - intersect_fraction: interval intersection with bedtools' -f fractional
//   overlap semantics (reference shells out: data/3create_windows_with_peaks.py:43).
//
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <unordered_set>
#include <vector>

extern "C" {

struct Contact {
  int64_t bin1;
  int64_t bin2;
  double val;
};

struct ContactCmp {
  bool operator()(const Contact& a, const Contact& b) const {
    return a.val > b.val;  // min-heap on val
  }
};

// Parse an integer starting at *p; advances *p past the number.
static inline int64_t parse_ll(const char** p) {
  const char* s = *p;
  while (*s == ' ' || *s == '\t') s++;
  bool neg = false;
  if (*s == '-') { neg = true; s++; }
  int64_t v = 0;
  while (*s >= '0' && *s <= '9') v = v * 10 + (*s++ - '0');
  *p = s;
  return neg ? -v : v;
}

// Streams `path`, returns number of kept contacts (<= k), or -1 on error.
// norm may be null (no normalization). bins must be sorted ascending.
// Zero/NaN norm entries mean "discard" (reference maps them to +inf:
// data/7create_graph_new.py:62-63).
// min_dist_bp: genomic-distance floor applied DURING streaming, before
// top-k selection — the old graph builder's min_distance_threshold
// (reference: data/7create_graph_old.py:166 `abs(pos1-pos2) >=`; the
// "min1000" in its artifact names). 0 disables. max_dist_bp: optional
// ceiling (this framework's extension, <=0 disables) — also pre-top-k so
// a capped graph selects its k best among qualifying contacts.
// upsample_grid: when > 1, each streamed contact (b1, b2, v) at a coarse
// resolution expands on the fly to the grid x grid fine-resolution contacts
// (b1 + i*resolution_bp, b2 + j*resolution_bp, v), i,j in [0, grid) — the
// K562 5kb -> 1kb flow (reference: data/extras/upsample_hic.py:25-45)
// WITHOUT materializing the 25x intermediate dump the reference writes.
// Filters (distance, bin membership, normalization) apply to the expanded
// fine-grid contacts, identical to streaming a pre-upsampled file.
int64_t hic_topk(const char* path, const double* norm, int64_t norm_len,
                 int64_t resolution_bp, int64_t min_dist_bp,
                 int64_t max_dist_bp, const int64_t* bins, int64_t n_bins,
                 int64_t k, int64_t* out_bin1, int64_t* out_bin2,
                 double* out_val, int64_t upsample_grid) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  if (upsample_grid < 1) upsample_grid = 1;

  std::unordered_set<int64_t> bin_set(bins, bins + n_bins);
  std::priority_queue<Contact, std::vector<Contact>, ContactCmp> heap;

  auto consider = [&](int64_t b1, int64_t b2, double v) {
    int64_t dist = b1 > b2 ? b1 - b2 : b2 - b1;
    if (dist < min_dist_bp) return;
    if (max_dist_bp > 0 && dist > max_dist_bp) return;
    if (b1 == b2 || !bin_set.count(b1) || !bin_set.count(b2)) return;
    if (norm) {
      int64_t i1 = b1 / resolution_bp;
      int64_t i2 = b2 / resolution_bp;
      if (i1 >= norm_len || i2 >= norm_len) return;
      double n1 = norm[i1], n2 = norm[i2];
      if (n1 == 0.0 || n2 == 0.0 || std::isnan(n1) || std::isnan(n2)) {
        return;  // norm==inf in the reference -> val==0, never top-k
      }
      v = v / (n1 * n2);
    }
    if (static_cast<int64_t>(heap.size()) < k) {
      heap.push({b1, b2, v});
    } else if (!heap.empty() && v > heap.top().val) {
      heap.pop();
      heap.push({b1, b2, v});
    }
  };

  // Parse one NUL-terminated line and maybe push it onto the heap.
  auto handle = [&](const char* line) {
    const char* q = line;
    int64_t b1 = parse_ll(&q);
    int64_t b2 = parse_ll(&q);
    while (*q == ' ' || *q == '\t') q++;
    double v = strtod(q, nullptr);
    if (upsample_grid == 1) {
      consider(b1, b2, v);
      return;
    }
    for (int64_t i = 0; i < upsample_grid; ++i) {
      for (int64_t j = 0; j < upsample_grid; ++j) {
        consider(b1 + i * resolution_bp, b2 + j * resolution_bp, v);
      }
    }
  };

  // Chunked reader. A line may span ANY number of chunk boundaries: every
  // newline-less tail is appended to `carry` and parsing only happens once
  // a '\n' (or EOF) is seen. (A previous revision parsed carry + chunk as a
  // complete line whenever carry was non-empty, truncating lines that
  // crossed more than one boundary.)
  char buf[1 << 16];
  std::vector<char> carry;
  while (true) {
    size_t got = fread(buf, 1, sizeof(buf), f);
    if (got == 0) break;
    char* p = buf;
    char* end = buf + got;
    while (p < end) {
      char* nl = static_cast<char*>(memchr(p, '\n', end - p));
      if (!nl) {
        carry.insert(carry.end(), p, end);  // line continues in next chunk
        break;
      }
      if (!carry.empty()) {
        carry.insert(carry.end(), p, nl);
        carry.push_back('\0');
        handle(carry.data());
        carry.clear();
      } else {
        *nl = '\0';  // NUL-terminate in place (buf is writable)
        handle(p);
      }
      p = nl + 1;
    }
  }
  if (!carry.empty()) {  // final line without trailing newline
    carry.push_back('\0');
    handle(carry.data());
  }
  fclose(f);

  int64_t count = static_cast<int64_t>(heap.size());
  // emit ascending by value; caller sorts/uses as needed
  for (int64_t i = count - 1; i >= 0; --i) {
    const Contact& c = heap.top();
    out_bin1[i] = c.bin1;
    out_bin2[i] = c.bin2;
    out_val[i] = c.val;
    heap.pop();
  }
  return count;
}

// Window x peak intersection with fractional-overlap threshold on the
// window (bedtools intersect -f semantics). Both interval lists are
// (start, end) half-open. peaks need not be sorted; windows must be sorted
// by start. Writes up to max_out (window_idx, peak_idx) pairs; returns the
// number of pairs found (which may exceed max_out — caller re-allocates).
int64_t intersect_fraction(const int64_t* win_start, const int64_t* win_end,
                           int64_t n_win, const int64_t* peak_start,
                           const int64_t* peak_end, int64_t n_peaks,
                           double min_frac, int64_t* out_win, int64_t* out_peak,
                           int64_t max_out) {
  // sort peak order by start (indices)
  std::vector<int64_t> order(n_peaks);
  for (int64_t i = 0; i < n_peaks; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return peak_start[a] < peak_start[b];
  });

  std::vector<int64_t> sorted_starts(n_peaks);
  int64_t max_len = 0;
  for (int64_t i = 0; i < n_peaks; ++i) {
    sorted_starts[i] = peak_start[order[i]];
    max_len = std::max(max_len, peak_end[order[i]] - peak_start[order[i]]);
  }

  int64_t count = 0;
  for (int64_t w = 0; w < n_win; ++w) {
    int64_t ws = win_start[w], we = win_end[w];
    double need = min_frac * static_cast<double>(we - ws);
    // candidate peaks: start in [ws - max_len, we)
    int64_t from = std::lower_bound(sorted_starts.begin(), sorted_starts.end(),
                                    ws - max_len) -
                   sorted_starts.begin();
    for (int64_t pi = from; pi < n_peaks; ++pi) {
      int64_t p = order[pi];
      if (peak_start[p] >= we) break;
      int64_t ov = std::min(we, peak_end[p]) - std::max(ws, peak_start[p]);
      if (ov > 0 && static_cast<double>(ov) >= need) {
        if (count < max_out) {
          out_win[count] = w;
          out_peak[count] = p;
        }
        ++count;
      }
    }
  }
  return count;
}

}  // extern "C"
