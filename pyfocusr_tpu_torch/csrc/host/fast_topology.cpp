// Native mesh topology: the PyTorch port's copy of
// native/fast_topology.cpp (same C ABI and code), built by
// pyfocusr_tpu_torch/native.py and called by pyfocusr_tpu_torch.mesh.
// build_topology and multires._aggregate_once.
//
// The numpy implementation is fully vectorized but still pays several
// O(3F log 3F) passes (sort/unique/argsort/accumulate) in separate
// allocations; at 240k-vertex meshes (2.9M directed edge slots) that is
// seconds of host time, and topology
// construction sits on the multiresolution critical path.  This single
// C++ pass does sort + dedup + edge-faces + ELL fill + overflow +
// connected components in ~100 ms.
//
// Contract mirrors mesh.build_topology exactly (same edge ordering: unique
// undirected edges sorted by (a, b); same ELL slot order: for vertex v,
// neighbors b of edges (v, b) in edge order, then neighbors a of edges
// (a, v) in edge order; same first-two edge_faces; degree-capped spill to
// an overflow list, returned sorted by source with stable per-source edge
// order).  The numpy path of build_topology_plain is its plain version.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Pass 1: sorted unique undirected edges + per-edge first-two incident
// faces.  Caller allocates edges_out[3F*2], edge_faces_out[3F*2].
// Returns E (number of unique edges), or -1 on bad input.
int64_t topo_edges(const int64_t* tris, int64_t n_faces, int64_t n_points,
                   int32_t* edges_out, int32_t* edge_faces_out,
                   int64_t* true_max_degree_out) {
  const int64_t m = 3 * n_faces;
  // Tie-break by numpy's RAW position (slot-major: all edge-01 rows in
  // face order, then edge-12, then edge-20) so edge_faces picks the same
  // first-two incidences as the numpy stable argsort.
  struct Rec { uint64_t key; int64_t pos; int32_t face; };
  std::vector<Rec> recs(m);
  for (int64_t f = 0; f < n_faces; ++f) {
    const int64_t a = tris[3 * f], b = tris[3 * f + 1], c = tris[3 * f + 2];
    if (a < 0 || b < 0 || c < 0 || a >= n_points || b >= n_points ||
        c >= n_points)
      return -1;
    const int64_t pairs[3][2] = {{a, b}, {b, c}, {c, a}};
    for (int e = 0; e < 3; ++e) {
      int64_t lo = pairs[e][0], hi = pairs[e][1];
      if (lo > hi) std::swap(lo, hi);
      recs[3 * f + e] = {static_cast<uint64_t>(lo) * n_points +
                             static_cast<uint64_t>(hi),
                         e * n_faces + f, static_cast<int32_t>(f)};
    }
  }
  std::sort(recs.begin(), recs.end(), [](const Rec& x, const Rec& y) {
    return x.key < y.key || (x.key == y.key && x.pos < y.pos);
  });
  std::vector<int64_t> degree(n_points, 0);
  int64_t n_edges = 0;
  for (int64_t i = 0; i < m;) {
    const uint64_t k = recs[i].key;
    const int32_t a = static_cast<int32_t>(k / n_points);
    const int32_t b = static_cast<int32_t>(k % n_points);
    edges_out[2 * n_edges] = a;
    edges_out[2 * n_edges + 1] = b;
    edge_faces_out[2 * n_edges] = recs[i].face;
    edge_faces_out[2 * n_edges + 1] =
        (i + 1 < m && recs[i + 1].key == k) ? recs[i + 1].face : -1;
    // bincount over [edges; reversed] semantics: self-edges count twice.
    degree[a] += 1;
    degree[b] += 1;
    ++n_edges;
    while (i < m && recs[i].key == k) ++i;
  }
  int64_t true_max = 1;
  for (int64_t v = 0; v < n_points; ++v)
    if (degree[v] > true_max) true_max = degree[v];
  *true_max_degree_out = true_max;
  return n_edges;
}

// Pass 2: ELL fill + overflow + connected components from the pass-1 edge
// list.  neighbors_out[n_points*max_deg] must be pre-filled with self
// indices, mask_out zeroed; overflow bound = 2*E rows.
// Returns the overflow count.
int64_t topo_fill(const int32_t* edges, int64_t n_edges, int64_t n_points,
                  int64_t max_deg, int32_t* neighbors_out, float* mask_out,
                  int32_t* overflow_out, int32_t* labels_out,
                  int64_t* n_components_out) {
  std::vector<int64_t> slot(n_points, 0);
  struct Spill { int32_t src, dst; };
  std::vector<Spill> spill;
  auto add = [&](int32_t s, int32_t d) {
    if (slot[s] < max_deg) {
      neighbors_out[s * max_deg + slot[s]] = d;
      mask_out[s * max_deg + slot[s]] = 1.0f;
      ++slot[s];
    } else {
      spill.push_back({s, d});  // stable_sort preserves insertion order
    }
  };
  // numpy order: directed = [edges; edges reversed], stable-sorted by src.
  // Per source v that is: dst b of (v, b) edges in edge order, then dst a
  // of (a, v) edges in edge order — two passes reproduce it exactly.
  for (int64_t e = 0; e < n_edges; ++e) add(edges[2 * e], edges[2 * e + 1]);
  for (int64_t e = 0; e < n_edges; ++e) add(edges[2 * e + 1], edges[2 * e]);
  // Overflow sorted by (src, insertion order) to match numpy's
  // stable-sort-by-src directed ordering.
  std::stable_sort(spill.begin(), spill.end(),
                   [](const Spill& x, const Spill& y) { return x.src < y.src; });
  for (size_t i = 0; i < spill.size(); ++i) {
    overflow_out[2 * i] = spill[i].src;
    overflow_out[2 * i + 1] = spill[i].dst;
  }

  // Connected components: union-find with path halving.
  std::vector<int32_t> parent(n_points);
  for (int64_t v = 0; v < n_points; ++v) parent[v] = static_cast<int32_t>(v);
  auto find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  for (int64_t e = 0; e < n_edges; ++e) {
    int32_t ra = find(edges[2 * e]), rb = find(edges[2 * e + 1]);
    if (ra == rb) continue;
    // Union by MIN id: every component's root becomes its smallest vertex,
    // matching the numpy min-label propagation, so the final renumbering
    // (ascending root id) reproduces numpy's labels exactly.
    if (ra < rb) parent[rb] = ra; else parent[ra] = rb;
  }
  std::vector<int32_t> root(n_points);
  for (int64_t v = 0; v < n_points; ++v) root[v] = find(static_cast<int32_t>(v));
  std::vector<int32_t> uniq(root.begin(), root.end());
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  for (int64_t v = 0; v < n_points; ++v) {
    labels_out[v] = static_cast<int32_t>(
        std::lower_bound(uniq.begin(), uniq.end(), root[v]) - uniq.begin());
  }
  *n_components_out = static_cast<int64_t>(uniq.size());
  return static_cast<int64_t>(spill.size());
}

}  // extern "C"

extern "C" {

// Greedy maximal independent set in priority order — identical to Luby
// rounds with the same static priorities (both produce the
// lexicographically-first MIS): a vertex becomes a seed iff no
// higher-priority neighbor already did.  One O(V + E) pass over a CSR
// adjacency built in place, replacing the multiresolution decimator's
// numpy Luby loop (~1.3 s per 240k aggregation round -> ~10 ms).
//
// u/v: the E unique undirected edges; order: vertices sorted by ascending
// priority (the decimator passes argsort of its random permutation);
// state_out[n]: 1 = seed, -1 = blocked (no zeros remain — isolated
// vertices become seeds, matching the numpy leftover rule).
int64_t mis_greedy(const int64_t* u, const int64_t* v, int64_t n_edges,
                   int64_t n_points, const int64_t* order,
                   int8_t* state_out) {
  if (n_edges < 0 || n_points <= 0) return -1;
  std::vector<int64_t> off(n_points + 1, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    if (u[e] < 0 || u[e] >= n_points || v[e] < 0 || v[e] >= n_points)
      return -1;
    ++off[u[e] + 1];
    ++off[v[e] + 1];
  }
  for (int64_t i = 0; i < n_points; ++i) off[i + 1] += off[i];
  std::vector<int64_t> adj(static_cast<size_t>(2 * n_edges));
  std::vector<int64_t> cur(off.begin(), off.end() - 1);
  for (int64_t e = 0; e < n_edges; ++e) {
    adj[cur[u[e]]++] = v[e];
    adj[cur[v[e]]++] = u[e];
  }
  std::memset(state_out, 0, static_cast<size_t>(n_points));
  for (int64_t i = 0; i < n_points; ++i) {
    const int64_t w = order[i];
    if (w < 0 || w >= n_points) return -1;
    if (state_out[w] != 0) continue;
    state_out[w] = 1;
    for (int64_t k = off[w]; k < off[w + 1]; ++k) {
      if (state_out[adj[k]] == 0) state_out[adj[k]] = -1;
    }
  }
  return 0;
}

}  // extern "C"
