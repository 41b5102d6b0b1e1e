// Isosurface extraction via marching tetrahedra.
//
// Native replacement for the reference's third-party PyMCubes dependency
// (used only by mesh extraction, the reference's model/neus_renderer.py:28-36).
// A copy of copenerf_tpu/mesher/csrc/marching.cpp: the same grid gives the
// same vertices and triangles in both packages.
// Each grid cell splits into 6 tetrahedra; surface crossings are linearly
// interpolated on tet edges. Vertices are welded by their (endpoint, endpoint)
// edge key so shared vertices are emitted once, like mcubes' edge indexing.
//
// Parallelism: z-slabs across std::thread workers with per-thread buffers,
// merged + welded in a final pass.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct TriRecord {
  // Each triangle vertex lies on an edge between two grid nodes.
  int64_t edge_a[3];
  int64_t edge_b[3];
  float t[3];  // interpolation parameter along (a -> b)
};

// Canonical 6-tet decomposition of a unit cube sharing the main diagonal 0-7
// (corner indices 0..7, corner c = (x + (c&1), y + ((c>>1)&1), z + ((c>>2)&1))).
const int kTets07[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

inline void emit_tet(const int64_t node[4], const float val[4], float iso,
                     std::vector<TriRecord>* out) {
  int inside = 0;
  bool in[4];
  for (int i = 0; i < 4; ++i) {
    in[i] = val[i] < iso;
    inside += in[i];
  }
  if (inside == 0 || inside == 4) return;

  // Collect crossing edges (i inside, j outside).
  int64_t ea[4], eb[4];
  float tt[4];
  int n = 0;
  for (int i = 0; i < 4; ++i) {
    for (int j = i + 1; j < 4; ++j) {
      if (in[i] != in[j]) {
        float denom = val[j] - val[i];
        float t = denom != 0.0f ? (iso - val[i]) / denom : 0.5f;
        // Canonicalize edge orientation by node id.
        if (node[i] < node[j]) {
          ea[n] = node[i];
          eb[n] = node[j];
          tt[n] = t;
        } else {
          ea[n] = node[j];
          eb[n] = node[i];
          tt[n] = 1.0f - t;
        }
        ++n;
      }
    }
  }
  if (n == 3) {
    TriRecord r;
    for (int k = 0; k < 3; ++k) {
      r.edge_a[k] = ea[k];
      r.edge_b[k] = eb[k];
      r.t[k] = tt[k];
    }
    out->push_back(r);
  } else if (n == 4) {
    // Quad: split into two triangles (0,1,2) and (2,1,3) — edge collection
    // order for the 2-in/2-out case yields a consistent strip.
    TriRecord r1, r2;
    int idx1[3] = {0, 1, 2};
    int idx2[3] = {2, 1, 3};
    for (int k = 0; k < 3; ++k) {
      r1.edge_a[k] = ea[idx1[k]];
      r1.edge_b[k] = eb[idx1[k]];
      r1.t[k] = tt[idx1[k]];
      r2.edge_a[k] = ea[idx2[k]];
      r2.edge_b[k] = eb[idx2[k]];
      r2.t[k] = tt[idx2[k]];
    }
    out->push_back(r1);
    out->push_back(r2);
  }
}

void worker(const float* grid, int nx, int ny, int nz, float iso, int z0,
            int z1, std::vector<TriRecord>* out) {
  auto node_id = [&](int x, int y, int z) -> int64_t {
    return (int64_t)x * ny * nz + (int64_t)y * nz + z;
  };
  for (int z = z0; z < z1; ++z) {
    for (int y = 0; y + 1 < ny; ++y) {
      for (int x = 0; x + 1 < nx; ++x) {
        int64_t nid[8];
        float val[8];
        bool any_in = false, any_out = false;
        for (int c = 0; c < 8; ++c) {
          int cx = x + (c & 1), cy = y + ((c >> 1) & 1), cz = z + (c >> 2);
          nid[c] = node_id(cx, cy, cz);
          val[c] = grid[nid[c]];
          (val[c] < iso ? any_in : any_out) = true;
        }
        if (!any_in || !any_out) continue;
        for (int t = 0; t < 6; ++t) {
          int64_t tn[4];
          float tv[4];
          for (int k = 0; k < 4; ++k) {
            tn[k] = nid[kTets07[t][k]];
            tv[k] = val[kTets07[t][k]];
          }
          emit_tet(tn, tv, iso, out);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

struct MeshResult {
  int64_t n_verts;
  int64_t n_tris;
  float* verts;   // (n_verts, 3)
  int64_t* tris;  // (n_tris, 3)
};

// grid: (nx, ny, nz) row-major float32 scalar field.
MeshResult* extract_isosurface(const float* grid, int nx, int ny, int nz,
                               float iso, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  int slabs = nz - 1;
  if (n_threads > slabs) n_threads = slabs > 0 ? slabs : 1;

  std::vector<std::vector<TriRecord>> bufs(n_threads);
  std::vector<std::thread> threads;
  for (int i = 0; i < n_threads; ++i) {
    int z0 = (int)((int64_t)slabs * i / n_threads);
    int z1 = (int)((int64_t)slabs * (i + 1) / n_threads);
    threads.emplace_back(worker, grid, nx, ny, nz, iso, z0, z1, &bufs[i]);
  }
  for (auto& t : threads) t.join();

  int64_t n_tris = 0;
  for (auto& b : bufs) n_tris += (int64_t)b.size();

  // Weld vertices by canonical edge key.
  struct KeyHash {
    size_t operator()(const std::pair<int64_t, int64_t>& k) const {
      return std::hash<int64_t>()(k.first * 1000003 + k.second);
    }
  };
  std::unordered_map<std::pair<int64_t, int64_t>, int64_t, KeyHash> vmap;
  vmap.reserve((size_t)n_tris * 2);

  std::vector<float> verts;
  verts.reserve((size_t)n_tris * 3);
  int64_t* tris = (int64_t*)malloc(sizeof(int64_t) * 3 * (size_t)n_tris);
  int64_t tri_i = 0;

  for (auto& b : bufs) {
    for (auto& r : b) {
      for (int k = 0; k < 3; ++k) {
        auto key = std::make_pair(r.edge_a[k], r.edge_b[k]);
        auto it = vmap.find(key);
        int64_t vid;
        if (it == vmap.end()) {
          vid = (int64_t)(verts.size() / 3);
          vmap.emplace(key, vid);
          // Decode node ids back to grid coords; nz is the fastest axis.
          // (node = x*ny*nz + y*nz + z)
          // positions interpolated between the two endpoints.
          // Using doubles isn't needed; coords are exact small ints.
          // a:
          // recompute from the packed ids
          auto decode = [&](int64_t id, float* xyz) {
            xyz[2] = (float)(id % nz);
            id /= nz;
            xyz[1] = (float)(id % ny);
            xyz[0] = (float)(id / ny);
          };
          float pa[3], pb[3];
          decode(r.edge_a[k], pa);
          decode(r.edge_b[k], pb);
          for (int d = 0; d < 3; ++d)
            verts.push_back(pa[d] + r.t[k] * (pb[d] - pa[d]));
        } else {
          vid = it->second;
        }
        tris[tri_i * 3 + k] = vid;
      }
      ++tri_i;
    }
  }

  MeshResult* res = (MeshResult*)malloc(sizeof(MeshResult));
  res->n_tris = n_tris;
  res->n_verts = (int64_t)(verts.size() / 3);
  res->verts = (float*)malloc(sizeof(float) * verts.size());
  memcpy(res->verts, verts.data(), sizeof(float) * verts.size());
  res->tris = tris;
  return res;
}

void free_mesh(MeshResult* m) {
  if (!m) return;
  free(m->verts);
  free(m->tris);
  free(m);
}

}  // extern "C"
