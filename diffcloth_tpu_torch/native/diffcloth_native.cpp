// Native host components of diffcloth_tpu_torch: fast mesh IO and host-side
// scene preprocessing, the host-side equivalents of the reference's C++
// mesh plumbing (MeshFileHandler::loadOBJFile / per-frame OBJ export
// Simulation.cpp:4195; createBendingConstraints Simulation.cpp:2096-2131;
// the point-point connection table used for self-collision adjacency
// exclusion, Simulation.cpp:319).  The port's own copy of the JAX
// package's native/diffcloth_native.cpp.
//
// Exposed as a plain C ABI consumed via ctypes (diffcloth_tpu_torch/native/).
// No third-party dependencies.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <utility>
#include <vector>

extern "C" {

void dc_free(void *p) { std::free(p); }

// ---------------------------------------------------------------------------
// OBJ IO

// Parse 'v x y z' and 'f a b c [d]' (1-based, optional /vt/vn suffixes;
// quads fan-triangulated).  Returns 0 on success.
int dc_load_obj(const char *path, double **verts_out, int64_t *nv,
                int32_t **tris_out, int64_t *nt) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (std::fread(&buf[0], 1, size, f) != (size_t)size) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);

  std::vector<double> verts;
  std::vector<int32_t> tris;
  verts.reserve(4096);
  tris.reserve(8192);

  const char *p = buf.c_str();
  const char *end = p + buf.size();
  while (p < end) {
    const char *line_end = static_cast<const char *>(
        std::memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    if (p[0] == 'v' && p[1] == ' ') {
      char *q = const_cast<char *>(p) + 2;
      double x = std::strtod(q, &q);
      double y = std::strtod(q, &q);
      double z = std::strtod(q, &q);
      verts.push_back(x);
      verts.push_back(y);
      verts.push_back(z);
    } else if (p[0] == 'f' && p[1] == ' ') {
      int32_t idx[8];
      int k = 0;
      const char *q = p + 2;
      while (q < line_end && k < 8) {
        while (q < line_end && *q == ' ') q++;
        if (q >= line_end || *q == '\r') break;
        char *qq;
        long v = std::strtol(q, &qq, 10);
        if (qq == q) break;
        idx[k++] = (int32_t)(v - 1);
        q = qq;
        while (q < line_end && *q != ' ') q++;  // skip /vt/vn
      }
      for (int i = 1; i + 1 < k; i++) {  // fan triangulation
        tris.push_back(idx[0]);
        tris.push_back(idx[i]);
        tris.push_back(idx[i + 1]);
      }
    }
    p = line_end + 1;
  }

  *nv = (int64_t)(verts.size() / 3);
  *nt = (int64_t)(tris.size() / 3);
  *verts_out = (double *)std::malloc(verts.size() * sizeof(double));
  *tris_out = (int32_t *)std::malloc(tris.size() * sizeof(int32_t));
  if ((verts.size() && !*verts_out) || (tris.size() && !*tris_out)) return -3;
  std::memcpy(*verts_out, verts.data(), verts.size() * sizeof(double));
  std::memcpy(*tris_out, tris.data(), tris.size() * sizeof(int32_t));
  return 0;
}

// Write an OBJ frame.  Returns 0 on success.
int dc_save_obj(const char *path, const double *verts, int64_t nv,
                const int32_t *tris, int64_t nt) {
  FILE *f = std::fopen(path, "wb");
  if (!f) return -1;
  std::string out;
  out.reserve((size_t)(nv * 40 + nt * 24));
  char line[128];
  for (int64_t i = 0; i < nv; i++) {
    int len = std::snprintf(line, sizeof(line), "v %.8f %.8f %.8f\n",
                            verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]);
    out.append(line, len);
  }
  for (int64_t i = 0; i < nt; i++) {
    int len = std::snprintf(line, sizeof(line), "f %d %d %d\n",
                            tris[3 * i] + 1, tris[3 * i + 1] + 1,
                            tris[3 * i + 2] + 1);
    out.append(line, len);
  }
  size_t written = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return written == out.size() ? 0 : -2;
}

// ---------------------------------------------------------------------------
// scene preprocessing

// Shared-edge (hinge) extraction.  Output rows [vmin, vmax, other0, other1]
// in sorted (vmin,vmax) key order — bit-identical ordering to the std::map
// iteration in the reference createBendingConstraints
// (Simulation.cpp:2096-2131) and to the Python fallback.
int dc_extract_bending_pairs(const int32_t *tris, int64_t nt,
                             int32_t **quads_out, int64_t *nq) {
  std::map<std::pair<int32_t, int32_t>, std::vector<int32_t>> edges;
  for (int64_t t = 0; t < nt; t++) {
    const int32_t *v = tris + 3 * t;
    for (int a = 0; a < 3; a++) {
      for (int b = a + 1; b < 3; b++) {
        int32_t v1 = v[a], v2 = v[b], other = v[3 - a - b];
        if (v1 > v2) std::swap(v1, v2);
        edges[{v1, v2}].push_back(other);
      }
    }
  }
  std::vector<int32_t> quads;
  for (auto &kv : edges) {
    if (kv.second.size() == 2) {
      quads.push_back(kv.first.first);
      quads.push_back(kv.first.second);
      quads.push_back(kv.second[0]);
      quads.push_back(kv.second[1]);
    } else if (kv.second.size() > 2) {
      return -1;  // non-manifold edge
    }
  }
  *nq = (int64_t)(quads.size() / 4);
  *quads_out = (int32_t *)std::malloc(quads.size() * sizeof(int32_t));
  if (quads.size() && !*quads_out) return -3;
  std::memcpy(*quads_out, quads.data(), quads.size() * sizeof(int32_t));
  return 0;
}

// Point-point connection table (1-ring + shared-triangle pairs), used to
// exclude mesh-adjacent pairs from self-collision candidates
// (reference pointpointConnectionTable, Simulation.cpp:319).
// `table` is caller-allocated n*n uint8, zeroed here.
int dc_conn_table(const int32_t *tris, int64_t nt, int64_t n,
                  uint8_t *table) {
  std::memset(table, 0, (size_t)(n * n));
  for (int64_t i = 0; i < n; i++) table[i * n + i] = 1;
  for (int64_t t = 0; t < nt; t++) {
    const int32_t *v = tris + 3 * t;
    for (int a = 0; a < 3; a++) {
      for (int b = 0; b < 3; b++) {
        if (v[a] < n && v[b] < n) {
          table[(int64_t)v[a] * n + v[b]] = 1;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
