// pathtracerap_tpu_torch native host runtime.
//
// The port's copy of the JAX package's host library, in C++ where the
// reference's host layer was (PathTracerAP/Scene.cpp,
// PathTracerAP/Renderer.cpp:15-63):
//
//   * OBJ mesh import  — replaces the Assimp import path
//     (Scene.cpp:226-291): positions/normals scaled by BASE_MODEL_SCALE,
//     corner-level vertex dedup, pre-triangulated faces only.
//   * Uniform-grid acceleration-structure build — replaces the scalar
//     triple-loop voxel stamping (Scene.cpp:293-396) with a two-pass
//     counting-sort CSR build (O(T * overlapped voxels), cache-friendly).
//   * BMP writer — byte-compatible with the hand-rolled writer
//     (Renderer.cpp:15-63) in parity mode, standards-compliant otherwise.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (pathtracerap_tpu_torch/native.py, which builds it with g++ at first
// use).  It runs on the host only; the device path is PyTorch and the
// CUDA kernels of csrc/.
//
// Semantics are kept bit-identical to the pure-Python implementations in
// pathtracerap_tpu_torch/io/obj.py, scene/grid.py and io/bmp.py, so either
// backend can serve as the oracle for the other (tests/test_torch_native.py).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------- OBJ loader

struct ObjData {
  std::vector<float> positions;  // V*3, already scaled
  std::vector<float> normals;    // V*3, already scaled (reference quirk:
                                 // normals scale too, Scene.cpp:255-262)
  std::vector<float> uvs;        // V*2
  std::vector<int32_t> tris;     // T*3
  float bbox_min[3], bbox_max[3];
  std::string error;
};

// Matches the Python loader's float32 pipeline: parse as double, narrow to
// float, then multiply by float(scale) in float32 arithmetic.
inline float scaled(double raw, float scale) {
  return static_cast<float>(raw) * scale;
}

struct Corner {
  int vi, ti, ni;
  bool has_vt;
};

bool parse_corner(const char* tok, size_t nv, size_t nvt, size_t nvn, Corner* c) {
  char* end = nullptr;
  long vi = std::strtol(tok, &end, 10);
  if (end == tok) return false;
  c->vi = vi > 0 ? static_cast<int>(vi - 1) : static_cast<int>(nv + vi);
  c->ti = 0;
  c->ni = -1;
  c->has_vt = false;
  if (*end == '/') {
    const char* p = end + 1;
    if (*p != '/' && *p != '\0' && !std::isspace(static_cast<unsigned char>(*p))) {
      long t = std::strtol(p, &end, 10);
      c->ti = t > 0 ? static_cast<int>(t - 1) : static_cast<int>(nvt + t);
      c->has_vt = true;
      p = end;
    }
    if (*p == '/') {
      ++p;
      if (*p != '\0' && !std::isspace(static_cast<unsigned char>(*p))) {
        long n = std::strtol(p, &end, 10);
        c->ni = n > 0 ? static_cast<int>(n - 1) : static_cast<int>(nvn + n);
      }
    }
  }
  return true;
}

ObjData* obj_load(const char* path, float scale) {
  auto* out = new ObjData();
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    out->error = std::string("cannot open ") + path;
    return out;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && std::fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    out->error = std::string("short read on ") + path;
    return out;
  }
  std::fclose(f);

  std::vector<double> raw_v, raw_vn, raw_vt;  // flattened 3/3/2-wide
  // Corner dedup keyed by the literal face token, matching the Python
  // loader's `corner_map[token]` (io/obj.py) so vertex order is identical.
  std::unordered_map<std::string, int32_t> corner_map;
  corner_map.reserve(1 << 12);

  const char* p = buf.c_str();
  const char* bufend = p + buf.size();
  char line[4096];
  while (p < bufend) {
    const char* nl = static_cast<const char*>(std::memchr(p, '\n', bufend - p));
    size_t len = nl ? static_cast<size_t>(nl - p) : static_cast<size_t>(bufend - p);
    if (len >= sizeof(line)) len = sizeof(line) - 1;
    std::memcpy(line, p, len);
    line[len] = '\0';
    p = nl ? nl + 1 : bufend;

    char* s = line;
    while (*s == ' ' || *s == '\t' || *s == '\r') ++s;
    if (*s == '\0' || *s == '#') continue;

    if (s[0] == 'v' && (s[1] == ' ' || s[1] == '\t')) {
      char* e;
      double x = std::strtod(s + 1, &e), y = std::strtod(e, &e),
             z = std::strtod(e, &e);
      raw_v.push_back(x); raw_v.push_back(y); raw_v.push_back(z);
    } else if (s[0] == 'v' && s[1] == 'n' && (s[2] == ' ' || s[2] == '\t')) {
      char* e;
      double x = std::strtod(s + 2, &e), y = std::strtod(e, &e),
             z = std::strtod(e, &e);
      raw_vn.push_back(x); raw_vn.push_back(y); raw_vn.push_back(z);
    } else if (s[0] == 'v' && s[1] == 't' && (s[2] == ' ' || s[2] == '\t')) {
      char* e;
      double u = std::strtod(s + 2, &e), v = std::strtod(e, &e);
      raw_vt.push_back(u); raw_vt.push_back(v);
    } else if (s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
      // Split face tokens; reject non-triangles like the reference's
      // assert(face.mNumIndices == 3) (Scene.cpp:281).
      int32_t idx[4];
      int ntok = 0;
      char* tok = s + 1;
      while (*tok) {
        while (*tok == ' ' || *tok == '\t' || *tok == '\r') ++tok;
        if (*tok == '\0') break;
        char* tend = tok;
        while (*tend && *tend != ' ' && *tend != '\t' && *tend != '\r') ++tend;
        std::string token(tok, tend);
        if (ntok >= 3) {
          out->error = std::string(path) +
                       ": face with >3 corners; only pre-triangulated OBJs "
                       "are supported";
          return out;
        }
        auto it = corner_map.find(token);
        if (it != corner_map.end()) {
          idx[ntok++] = it->second;
        } else {
          Corner c;
          if (!parse_corner(token.c_str(), raw_v.size() / 3, raw_vt.size() / 2,
                            raw_vn.size() / 3, &c)) {
            out->error = std::string(path) + ": bad face token '" + token + "'";
            return out;
          }
          int32_t vid = static_cast<int32_t>(out->positions.size() / 3);
          for (int k = 0; k < 3; ++k)
            out->positions.push_back(scaled(raw_v[3 * c.vi + k], scale));
          if (c.ni >= 0)
            for (int k = 0; k < 3; ++k)
              out->normals.push_back(scaled(raw_vn[3 * c.ni + k], scale));
          else
            for (int k = 0; k < 3; ++k) out->normals.push_back(0.0f);
          if (!raw_vt.empty() && c.has_vt) {
            out->uvs.push_back(static_cast<float>(raw_vt[2 * c.ti]));
            out->uvs.push_back(static_cast<float>(raw_vt[2 * c.ti + 1]));
          } else {
            out->uvs.push_back(0.0f);
            out->uvs.push_back(0.0f);
          }
          corner_map.emplace(std::move(token), vid);
          idx[ntok++] = vid;
        }
        tok = tend;
      }
      if (ntok != 3) {
        out->error = std::string(path) + ": face with " + std::to_string(ntok) +
                     " corners; only pre-triangulated OBJs are supported";
        return out;
      }
      out->tris.push_back(idx[0]);
      out->tris.push_back(idx[1]);
      out->tris.push_back(idx[2]);
    }
    // everything else (mtllib, usemtl, o, g, s, ...) is ignored
  }

  size_t nv = out->positions.size() / 3;
  if (nv == 0) {
    out->error = std::string(path) + ": no vertices";
    return out;
  }
  for (int k = 0; k < 3; ++k) {
    out->bbox_min[k] = out->positions[k];
    out->bbox_max[k] = out->positions[k];
  }
  for (size_t i = 1; i < nv; ++i)
    for (int k = 0; k < 3; ++k) {
      float v = out->positions[3 * i + k];
      if (v < out->bbox_min[k]) out->bbox_min[k] = v;
      if (v > out->bbox_max[k]) out->bbox_max[k] = v;
    }
  return out;
}

// ------------------------------------------------------- uniform-grid build

struct GridData {
  float voxel_width[3];
  std::vector<int32_t> starts;   // NV
  std::vector<int32_t> counts;   // NV
  std::vector<int32_t> indices;  // P (global tri ids, ascending per voxel)
};

// Two-pass counting-sort CSR build.  Pass 1 counts entries per voxel; pass 2
// appends triangle ids in triangle order, which yields ascending-tri order
// inside each bucket — identical to the reference's insertion order
// (Scene.cpp:349-375) and to the Python builder's stable lexsort.
GridData* grid_build(const float* tv, int64_t n_tris, const float* bbmin,
                     const float* bbmax, int gx, int gy, int gz,
                     int tri_index_base) {
  auto* g = new GridData();
  const int64_t nvox = static_cast<int64_t>(gx) * gy * gz;
  g->starts.assign(static_cast<size_t>(nvox), 0);
  g->counts.assign(static_cast<size_t>(nvox), 0);

  float dims[3] = {static_cast<float>(gx), static_cast<float>(gy),
                   static_cast<float>(gz)};
  float sw[3];
  for (int k = 0; k < 3; ++k) {
    g->voxel_width[k] = (bbmax[k] - bbmin[k]) / dims[k];
    sw[k] = g->voxel_width[k] > 0.0f ? g->voxel_width[k] : 1e-30f;
  }
  if (n_tris == 0) return g;

  // Per-triangle voxel ranges (lo/hi per axis), computed once, reused by
  // both passes.  floor(|bbmin - t|/w) with clamping — Scene.cpp:300-315.
  std::vector<int32_t> lo(static_cast<size_t>(n_tris) * 3);
  std::vector<int32_t> hi(static_cast<size_t>(n_tris) * 3);
  const int32_t gdim[3] = {gx, gy, gz};
  for (int64_t t = 0; t < n_tris; ++t) {
    const float* v = tv + 9 * t;
    for (int k = 0; k < 3; ++k) {
      float tmin = v[k], tmax = v[k];
      if (v[3 + k] < tmin) tmin = v[3 + k];
      if (v[3 + k] > tmax) tmax = v[3 + k];
      if (v[6 + k] < tmin) tmin = v[6 + k];
      if (v[6 + k] > tmax) tmax = v[6 + k];
      int64_t l = static_cast<int64_t>(std::floor(std::fabs(bbmin[k] - tmin) / sw[k]));
      int64_t h = static_cast<int64_t>(std::floor(std::fabs(bbmin[k] - tmax) / sw[k]));
      if (l < 0) l = 0;
      if (l > gdim[k] - 1) l = gdim[k] - 1;
      if (h < 0) h = 0;
      if (h > gdim[k] - 1) h = gdim[k] - 1;
      lo[3 * t + k] = static_cast<int32_t>(l);
      hi[3 * t + k] = static_cast<int32_t>(h);
    }
  }

  // Pass 1: counts.
  for (int64_t t = 0; t < n_tris; ++t) {
    for (int32_t z = lo[3 * t + 2]; z <= hi[3 * t + 2]; ++z)
      for (int32_t y = lo[3 * t + 1]; y <= hi[3 * t + 1]; ++y) {
        int64_t row = static_cast<int64_t>(z) * gx * gy +
                      static_cast<int64_t>(y) * gx;
        for (int32_t x = lo[3 * t]; x <= hi[3 * t]; ++x)
          ++g->counts[static_cast<size_t>(row + x)];
      }
  }
  int64_t total = 0;
  for (int64_t v = 0; v < nvox; ++v) {
    g->starts[static_cast<size_t>(v)] = static_cast<int32_t>(total);
    total += g->counts[static_cast<size_t>(v)];
  }
  g->indices.assign(static_cast<size_t>(total), 0);

  // Pass 2: fill, triangle-major so buckets stay tri-ascending.
  std::vector<int32_t> cursor(g->starts);
  for (int64_t t = 0; t < n_tris; ++t) {
    int32_t gid = static_cast<int32_t>(t) + tri_index_base;
    for (int32_t z = lo[3 * t + 2]; z <= hi[3 * t + 2]; ++z)
      for (int32_t y = lo[3 * t + 1]; y <= hi[3 * t + 1]; ++y) {
        int64_t row = static_cast<int64_t>(z) * gx * gy +
                      static_cast<int64_t>(y) * gx;
        for (int32_t x = lo[3 * t]; x <= hi[3 * t]; ++x)
          g->indices[static_cast<size_t>(
              cursor[static_cast<size_t>(row + x)]++)] = gid;
      }
  }
  return g;
}

// ----------------------------------------------------------------- BMP write

int write_bmp(const char* path, const uint8_t* img, int w, int h, int parity) {
  const int pad = parity ? 0 : ((-3 * w) % 4 + 4) % 4;
  const uint32_t image_size = static_cast<uint32_t>((3 * w + pad) * h);
  const uint32_t file_size = 54 + image_size;
  uint8_t header[54] = {0};
  header[0] = 'B';
  header[1] = 'M';
  std::memcpy(header + 2, &file_size, 4);
  uint32_t off = 54, ih = 40;
  std::memcpy(header + 10, &off, 4);
  std::memcpy(header + 14, &ih, 4);
  int32_t ww = w, hh = h;
  std::memcpy(header + 18, &ww, 4);
  std::memcpy(header + 22, &hh, 4);
  uint16_t planes = 1, bpp = 24;
  std::memcpy(header + 26, &planes, 2);
  std::memcpy(header + 28, &bpp, 2);
  std::memcpy(header + 34, &image_size, 4);

  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  if (std::fwrite(header, 1, 54, f) != 54) { std::fclose(f); return 2; }
  if (parity) {
    // Reference quirk: (R,G,B) channel order, rows unpadded
    // (Renderer.cpp:50 writes color.x, color.y, color.z directly).
    if (std::fwrite(img, 1, static_cast<size_t>(3) * w * h, f) !=
        static_cast<size_t>(3) * w * h) { std::fclose(f); return 2; }
  } else {
    std::vector<uint8_t> row(static_cast<size_t>(3 * w + pad), 0);
    for (int y = 0; y < h; ++y) {
      const uint8_t* src = img + static_cast<size_t>(3) * w * y;
      for (int x = 0; x < w; ++x) {  // RGB -> BGR
        row[3 * x] = src[3 * x + 2];
        row[3 * x + 1] = src[3 * x + 1];
        row[3 * x + 2] = src[3 * x];
      }
      if (std::fwrite(row.data(), 1, row.size(), f) != row.size()) {
        std::fclose(f);
        return 2;
      }
    }
  }
  std::fclose(f);
  return 0;
}

}  // namespace

// --------------------------------------------------------------------- C ABI

extern "C" {

void* ptap_obj_load(const char* path, float scale) {
  return obj_load(path, scale);
}

// Returns NULL on success, otherwise a pointer to an error string owned by
// the handle (valid until ptap_obj_free).
const char* ptap_obj_error(void* h) {
  auto* o = static_cast<ObjData*>(h);
  return o->error.empty() ? nullptr : o->error.c_str();
}

void ptap_obj_sizes(void* h, int64_t* n_verts, int64_t* n_tris) {
  auto* o = static_cast<ObjData*>(h);
  *n_verts = static_cast<int64_t>(o->positions.size() / 3);
  *n_tris = static_cast<int64_t>(o->tris.size() / 3);
}

void ptap_obj_copy(void* h, float* pos, float* nrm, float* uv, int32_t* tris,
                   float* bbmin, float* bbmax) {
  auto* o = static_cast<ObjData*>(h);
  std::memcpy(pos, o->positions.data(), o->positions.size() * sizeof(float));
  std::memcpy(nrm, o->normals.data(), o->normals.size() * sizeof(float));
  std::memcpy(uv, o->uvs.data(), o->uvs.size() * sizeof(float));
  std::memcpy(tris, o->tris.data(), o->tris.size() * sizeof(int32_t));
  std::memcpy(bbmin, o->bbox_min, 3 * sizeof(float));
  std::memcpy(bbmax, o->bbox_max, 3 * sizeof(float));
}

void ptap_obj_free(void* h) { delete static_cast<ObjData*>(h); }

void* ptap_grid_build(const float* tri_verts, int64_t n_tris,
                      const float* bbmin, const float* bbmax, int gx, int gy,
                      int gz, int tri_index_base) {
  return grid_build(tri_verts, n_tris, bbmin, bbmax, gx, gy, gz,
                    tri_index_base);
}

int64_t ptap_grid_nindices(void* h) {
  return static_cast<int64_t>(static_cast<GridData*>(h)->indices.size());
}

void ptap_grid_copy(void* h, int32_t* starts, int32_t* counts,
                    int32_t* indices, float* voxel_width) {
  auto* g = static_cast<GridData*>(h);
  std::memcpy(starts, g->starts.data(), g->starts.size() * sizeof(int32_t));
  std::memcpy(counts, g->counts.data(), g->counts.size() * sizeof(int32_t));
  if (!g->indices.empty())
    std::memcpy(indices, g->indices.data(),
                g->indices.size() * sizeof(int32_t));
  std::memcpy(voxel_width, g->voxel_width, 3 * sizeof(float));
}

void ptap_grid_free(void* h) { delete static_cast<GridData*>(h); }

int ptap_write_bmp(const char* path, const uint8_t* img, int w, int h,
                   int parity) {
  return write_bmp(path, img, w, h, parity);
}

}  // extern "C"
