// Native ETL core: padded-adjacency builder + random-walk generator.
//
// The reference delegates all native work to third-party libs (SURVEY.md
// §2.2: "the reference contains ZERO first-party native code"); here the
// host-side graph construction — the one genuinely CPU-bound stage of the
// pipeline (Reddit-scale: ~10^8 directed edges through dedupe / bucket /
// subsample / pad) — is first-party C++ compiled at install time and loaded
// through ctypes (tpu_sage/native/__init__.py), with the vectorized numpy
// implementation as a portable fallback.
//
// Semantics match tpu_sage.graph.graph_data.build_padded_adjacency exactly
// except for RNG streams (subsampling draws differ; both are uniform without
// replacement — tests assert distributional equivalence, not bit equality).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// edges: (E, 2) int64 directed; out_adj: (n_nodes, max_degree) int32
// (pre-filled by caller or filled here with self ids); out_deg: (n_nodes,)
// int32. symmetrize: add reversed edges. Returns 0 on success.
int build_padded_adjacency(
    const int64_t* edges, int64_t n_edges, int64_t n_nodes,
    int32_t max_degree, int32_t symmetrize, uint64_t seed,
    int32_t* out_adj, int32_t* out_deg) {
  if (n_nodes <= 0 || max_degree <= 0) return 1;

  // Collect directed edges (optionally symmetrized), drop self-loops kept
  // out by callers; dedupe via sort+unique.
  std::vector<std::pair<int64_t, int64_t>> es;
  es.reserve(static_cast<size_t>(n_edges) * (symmetrize ? 2 : 1));
  for (int64_t i = 0; i < n_edges; ++i) {
    int64_t s = edges[2 * i], d = edges[2 * i + 1];
    if (s < 0 || s >= n_nodes || d < 0 || d >= n_nodes) return 2;
    es.emplace_back(s, d);
    if (symmetrize) es.emplace_back(d, s);
  }
  std::sort(es.begin(), es.end());
  es.erase(std::unique(es.begin(), es.end()), es.end());

  // Self-id padding baseline.
  for (int64_t v = 0; v < n_nodes; ++v) {
    for (int32_t j = 0; j < max_degree; ++j)
      out_adj[v * max_degree + j] = static_cast<int32_t>(v);
    out_deg[v] = 0;
  }

  std::mt19937_64 rng(seed);
  size_t i = 0;
  std::vector<int32_t> bucket;
  bucket.reserve(1024);
  while (i < es.size()) {
    int64_t v = es[i].first;
    bucket.clear();
    while (i < es.size() && es[i].first == v) {
      bucket.push_back(static_cast<int32_t>(es[i].second));
      ++i;
    }
    int32_t deg = static_cast<int32_t>(bucket.size());
    if (deg > max_degree) {
      // uniform subsample without replacement: partial Fisher-Yates
      for (int32_t j = 0; j < max_degree; ++j) {
        std::uniform_int_distribution<int32_t> pick(j, deg - 1);
        std::swap(bucket[j], bucket[pick(rng)]);
      }
      deg = max_degree;
    }
    std::memcpy(out_adj + v * max_degree, bucket.data(),
                sizeof(int32_t) * deg);
    out_deg[v] = deg;
  }
  return 0;
}

// Random-walk corpus: for each start node, `n_walks` walks of `walk_len`
// hops over the padded table; out: (n_starts, n_walks, walk_len+1) int32
// including the start. Degree-0 nodes self-loop (column 0 == self id).
int random_walks(
    const int32_t* adj, const int32_t* degrees, int64_t n_nodes,
    int32_t max_degree, const int64_t* starts, int64_t n_starts,
    int32_t n_walks, int32_t walk_len, uint64_t seed, int32_t* out) {
  if (walk_len < 0 || n_walks <= 0) return 1;
  std::mt19937_64 rng(seed);
  int64_t stride = static_cast<int64_t>(n_walks) * (walk_len + 1);
  for (int64_t s = 0; s < n_starts; ++s) {
    int64_t v0 = starts[s];
    if (v0 < 0 || v0 >= n_nodes) return 2;
    for (int32_t w = 0; w < n_walks; ++w) {
      int32_t* row = out + s * stride + static_cast<int64_t>(w) * (walk_len + 1);
      int32_t cur = static_cast<int32_t>(v0);
      row[0] = cur;
      for (int32_t t = 1; t <= walk_len; ++t) {
        int32_t deg = degrees[cur];
        int32_t col = 0;
        if (deg > 1) {
          std::uniform_int_distribution<int32_t> pick(0, deg - 1);
          col = pick(rng);
        }
        cur = adj[static_cast<int64_t>(cur) * max_degree + col];
        row[t] = cur;
      }
    }
  }
  return 0;
}

}  // extern "C"
