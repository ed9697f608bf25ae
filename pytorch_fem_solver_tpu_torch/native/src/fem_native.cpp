// Native host-side kernels for construction-time structure building.
//
// The framework's host/device split (see docs/architecture.md) puts every
// dynamic-shape computation — mesh topology, DOF dedup, sparse-layout
// construction — on the host, once per mesh/basis. Those builders are
// dominated by argsort/unique over int64 keys (NumPy: comparison sorts,
// multiple passes). This translation unit provides the two primitives they
// share, as a plain C ABI consumed via ctypes (no pybind11 dependency):
//
//   fem_sort_unique   : stable radix argsort + unique/inverse/counts in one
//                       pass over 64-bit keys (LSD, 8x8-bit, skips passes
//                       whose byte is constant).
//   fem_unique_edges  : triangle-mesh edge dedup + occurrence grouping (the
//                       front half of mesh/topology.build_tri_topology).
//
// The Python callers keep a pure-NumPy fallback with identical outputs
// (tests assert exact equality), so the native library is a transparent
// accelerator, not a correctness dependency.
//
// Reference equivalent: none — the reference is pure Python/torch
// (SURVEY.md §2 "Native components: NONE"); its torch.unique-based setup
// (reference torch_fem/mesh/abstract_mesh.py:76-255) is the workload
// these kernels speed up.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Stable LSD radix argsort of 64-bit keys.
// order must hold n entries; filled with the stable ascending permutation.
// (key, index) pairs move together through the passes — all memory access is
// streaming — and all 8 histograms are taken in one initial sweep; passes
// whose byte is constant across the data are skipped entirely.
void fem_radix_argsort(const int64_t* keys, int64_t n, int64_t* order) {
  if (n <= 0) return;
  struct KV {
    uint64_t k;
    int64_t i;
  };
  std::vector<KV> a(n), b(n);

  // One sweep: biased copy (negative keys sort correctly) + all histograms.
  int64_t hist[8][256];
  std::memset(hist, 0, sizeof(hist));
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t k = static_cast<uint64_t>(keys[i]) ^ (1ull << 63);
    a[i] = {k, i};
    for (int p = 0; p < 8; ++p) ++hist[p][(k >> (p * 8)) & 0xff];
  }

  KV* src = a.data();
  KV* dst = b.data();
  for (int pass = 0; pass < 8; ++pass) {
    int64_t* h = hist[pass];
    // constant byte -> pass is the identity permutation
    bool constant = false;
    for (int v = 0; v < 256; ++v)
      if (h[v] == n) {
        constant = true;
        break;
      }
    if (constant) continue;

    int64_t sum = 0;
    int64_t offs[256];
    for (int v = 0; v < 256; ++v) {
      offs[v] = sum;
      sum += h[v];
    }
    const int shift = pass * 8;
    for (int64_t i = 0; i < n; ++i)
      dst[offs[(src[i].k >> shift) & 0xff]++] = src[i];
    KV* s = src;
    src = dst;
    dst = s;
  }
  for (int64_t i = 0; i < n; ++i) order[i] = src[i].i;
}

// Radix argsort + unique decomposition of 64-bit keys.
//   order   (n)  : stable ascending argsort of keys
//   uniq    (<=n): unique key values, ascending
//   inverse (n)  : unique id of each original position
//   counts  (<=n): occurrences per unique key
// Returns the number of unique keys.
int64_t fem_sort_unique(const int64_t* keys, int64_t n, int64_t* order,
                        int64_t* uniq, int64_t* inverse, int64_t* counts) {
  if (n <= 0) return 0;
  fem_radix_argsort(keys, n, order);

  int64_t nu = 0;
  int64_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = keys[order[i]];
    if (i == 0 || k != prev) {
      uniq[nu] = k;
      counts[nu] = 0;
      ++nu;
      prev = k;
    }
    ++counts[nu - 1];
    inverse[order[i]] = nu - 1;
  }
  return nu;
}

// Unique undirected edges of a triangle mesh.
//   cells (T, 3) vertex ids; edges are the local pairs (0,1), (1,2), (0,2)
//   in that order (matching TRI_EDGE_PERMUTATIONS).
// Outputs (caller allocates 3T upper bounds):
//   edges   (<=3T, 2): unique (min, max) pairs, lexicographically ascending
//   inverse (3T)     : edge id per flattened (cell, local-edge) occurrence
//   counts  (<=3T)   : triangles sharing each edge
//   order   (3T)     : stable ascending argsort of the encoded edge keys
//                      (occurrences of one edge are consecutive)
// Returns the edge count E, or -1 if an edge is shared by >2 triangles.
int64_t fem_unique_edges(const int64_t* cells, int64_t T, int64_t n_vertices,
                         int64_t* edges, int64_t* inverse, int64_t* counts,
                         int64_t* order) {
  const int64_t n = 3 * T;
  if (n <= 0) return 0;
  static const int LO[3] = {0, 1, 0};
  static const int HI[3] = {1, 2, 2};

  std::vector<int64_t> keys(n);
  for (int64_t t = 0; t < T; ++t) {
    const int64_t* tri = cells + 3 * t;
    for (int e = 0; e < 3; ++e) {
      int64_t a = tri[LO[e]], b = tri[HI[e]];
      if (a > b) { int64_t s = a; a = b; b = s; }
      keys[3 * t + e] = a * n_vertices + b;
    }
  }

  std::vector<int64_t> uniq(n);
  const int64_t E =
      fem_sort_unique(keys.data(), n, order, uniq.data(), inverse, counts);
  for (int64_t e = 0; e < E; ++e) {
    if (counts[e] > 2) return -1;
    edges[2 * e] = uniq[e] / n_vertices;
    edges[2 * e + 1] = uniq[e] % n_vertices;
  }
  return E;
}


// Fused entry expansion + block-pair dedup for the hybrid BSR structure
// build (ops/bsr.py:build_bsr_structure). Replaces a ~12-pass NumPy chain
// (repeat/tile expansion, masks, compressions, key arithmetic, radix
// dedup) with one streaming expansion pass + one KV radix sort + one
// rank-scatter walk — the structure build is bandwidth-bound on the
// single-core build host (see docs/performance.md).
//
// Inputs:
//   dofs     (T * n_loc)  global DOF ids per cell (row-major)
//   new_id   (n_dofs)     permuted interior id per global DOF, -1 Dirichlet
//   T, n_loc, block, nb   (nb = padded block-row count; keys < nb*nb)
// Outputs (caller-allocated):
//   rank_all (T*n_loc*n_loc) ascending-unique-block index per flat entry
//                            in ORIGINAL entry order; -1 where either DOF
//                            is Dirichlet (entry dropped)
//   in_block (T*n_loc*n_loc) (r % block) * block + (c % block); 0 dropped
//   bkeys    (<= T*n_loc*n_loc) ascending unique block keys brow*nb + bcol
// Returns the number of unique block keys.
int64_t fem_bsr_pair_ranks(const int64_t* dofs, int64_t T, int64_t n_loc,
                           const int64_t* new_id, int64_t block, int64_t nb,
                           int64_t* rank_all, int64_t* in_block,
                           int64_t* bkeys, int64_t* rank_sym,
                           int64_t* in_block_sym) {
  const int64_t n_entries = T * n_loc * n_loc;
  if (n_entries <= 0) return 0;

  struct KV {
    uint64_t k;
    int64_t i;
  };
  std::vector<KV> a;
  a.reserve(n_entries);

  // pass 1: expand entries, map to permuted ids, keep interior pairs
  std::vector<int64_t> rid(n_loc);
  for (int64_t t = 0; t < T; ++t) {
    const int64_t* cell = dofs + t * n_loc;
    for (int64_t i = 0; i < n_loc; ++i) rid[i] = new_id[cell[i]];
    int64_t* rk = rank_all + t * n_loc * n_loc;
    int64_t* ib = in_block + t * n_loc * n_loc;
    for (int64_t i = 0; i < n_loc; ++i) {
      const int64_t r = rid[i];
      for (int64_t j = 0; j < n_loc; ++j) {
        const int64_t c = rid[j];
        const int64_t f = i * n_loc + j;
        if (r >= 0 && c >= 0) {
          ib[f] = (r % block) * block + (c % block);
          rk[f] = 0;  // provisional: filled by the rank walk below
          a.push_back(
              {static_cast<uint64_t>((r / block) * nb + (c / block)),
               t * n_loc * n_loc + f});
        } else {
          ib[f] = 0;
          rk[f] = -1;
        }
      }
    }
  }

  const int64_t n = static_cast<int64_t>(a.size());
  int64_t nu = 0;
  // n == 0 (every entry Dirichlet-dropped): pass 1 set rank_all = -1
  // everywhere and the sym emission below handles gi/gj < 0, so only the
  // sort + rank walk are skipped
  if (n > 0) {
  std::vector<KV> b(n);

  // LSD radix over the key bytes, skipping constant bytes (keys < nb*nb)
  int64_t hist[8][256];
  std::memset(hist, 0, sizeof(hist));
  for (int64_t i = 0; i < n; ++i)
    for (int p = 0; p < 8; ++p) ++hist[p][(a[i].k >> (p * 8)) & 0xff];

  KV* src = a.data();
  KV* dst = b.data();
  for (int pass = 0; pass < 8; ++pass) {
    int64_t* h = hist[pass];
    bool constant = false;
    for (int v = 0; v < 256; ++v)
      if (h[v] == n) {
        constant = true;
        break;
      }
    if (constant) continue;
    int64_t sum = 0;
    int64_t offs[256];
    for (int v = 0; v < 256; ++v) {
      offs[v] = sum;
      sum += h[v];
    }
    const int shift = pass * 8;
    for (int64_t i = 0; i < n; ++i)
      dst[offs[(src[i].k >> shift) & 0xff]++] = src[i];
    KV* s = src;
    src = dst;
    dst = s;
  }

  // rank walk: unique keys ascending; scatter each entry's rank back to
  // its original flat position
  uint64_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t k = src[i].k;
    if (i == 0 || k != prev) {
      bkeys[nu] = static_cast<int64_t>(k);
      ++nu;
      prev = k;
    }
    rank_all[src[i].i] = nu - 1;
  }
  }

  // symmetric canonical-pair tables (np.triu_indices order): the canonical
  // (row <= col) representative of each unordered pair is one of the
  // original entries, so its rank is a rank_all lookup; emitted here so
  // the Python side needs only one blk_id composition pass
  const int64_t P = n_loc * (n_loc + 1) / 2;
  for (int64_t t = 0; t < T; ++t) {
    const int64_t* cell = dofs + t * n_loc;
    for (int64_t i = 0; i < n_loc; ++i) rid[i] = new_id[cell[i]];
    const int64_t* rk = rank_all + t * n_loc * n_loc;
    int64_t* rs = rank_sym + t * P;
    int64_t* ibs = in_block_sym + t * P;
    int64_t k = 0;
    for (int64_t i = 0; i < n_loc; ++i) {
      for (int64_t j = i; j < n_loc; ++j, ++k) {
        const int64_t gi = rid[i];
        const int64_t gj = rid[j];
        if (gi >= 0 && gj >= 0) {
          const int64_t lo = gi <= gj ? gi : gj;
          const int64_t hi = gi <= gj ? gj : gi;
          rs[k] = gi <= gj ? rk[i * n_loc + j] : rk[j * n_loc + i];
          ibs[k] = (lo % block) * block + (hi % block);
        } else {
          rs[k] = -1;
          ibs[k] = 0;
        }
      }
    }
  }
  return nu;
}


// Streaming face/edge key emission for tetrahedral topology
// (mesh/topology.py:build_tet_topology). Replaces per-row NumPy sorts of
// (4T, 3) / (6T, 2) index arrays (lexsort-class cost on the build host)
// with inline 3-element sorting networks in one pass over the cells.
//   face_codes (4T): (a*n_v + b)*n_v + c with a <= b <= c, face order
//                    (0,1,2), (0,1,3), (0,2,3), (1,2,3)
//   edge_codes (6T): a*n_v + b with a <= b, edge order
//                    (0,1), (1,2), (0,2), (0,3), (1,3), (2,3)
void fem_tet_face_edge_keys(const int64_t* tets, int64_t T, int64_t n_v,
                            int64_t* face_codes, int64_t* edge_codes) {
  static const int F[4][3] = {{0, 1, 2}, {0, 1, 3}, {0, 2, 3}, {1, 2, 3}};
  static const int E[6][2] = {{0, 1}, {1, 2}, {0, 2}, {0, 3}, {1, 3}, {2, 3}};
  for (int64_t t = 0; t < T; ++t) {
    const int64_t* v = tets + 4 * t;
    for (int f = 0; f < 4; ++f) {
      int64_t a = v[F[f][0]], b = v[F[f][1]], c = v[F[f][2]];
      if (a > b) { int64_t s = a; a = b; b = s; }
      if (b > c) { int64_t s = b; b = c; c = s; }
      if (a > b) { int64_t s = a; a = b; b = s; }
      face_codes[4 * t + f] = (a * n_v + b) * n_v + c;
    }
    for (int e = 0; e < 6; ++e) {
      int64_t a = v[E[e][0]], b = v[E[e][1]];
      if (a > b) { int64_t s = a; a = b; b = s; }
      edge_codes[6 * t + e] = a * n_v + b;
    }
  }
}

}  // extern "C"
