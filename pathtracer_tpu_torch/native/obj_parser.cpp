// Native OBJ tokenizer/triangulator (ctypes; io/obj.py fast path).
//
// Mirrors the Python reference loop in io/obj.py::read_obj exactly
// (which itself mirrors the reference loader, TriangleMesh.cpp:240-469):
// v (+optional 3-channel vertex color), vt, vn, f with all index forms
// (a, a/b, a//c, a/b/c, negative relative), fan triangulation with
// showEdges on real polygon borders, usemtl group mapping in
// first-appearance order, mtllib (last wins).  The Python line loop
// measures ~100k tris/s; this walks the buffer with strtof/strtol at
// C speed so office-scale (23.7M tris, ~1.5 GB) loads in seconds —
// the reference holds the same contract with its C++ fscanf loop.
//
// Handle API: pt_obj_parse -> opaque*, pt_obj_sizes, pt_obj_fetch,
// pt_obj_names/pt_obj_mtllib (pointers into handle-owned storage),
// pt_obj_free.

#include <cctype>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ObjData {
  std::vector<float> verts;   // 3*nv
  std::vector<float> vcols;   // 3*ncol (appended only for 6-float v lines)
  std::vector<float> uvs;     // 2*nuv
  std::vector<float> norms;   // 3*nn
  std::vector<int32_t> vtx, uvi, ni;  // 3*ntri
  std::vector<int32_t> grp;           // ntri
  std::vector<uint8_t> show;          // 3*ntri
  std::string names;                  // '\n'-joined group names, id order
  std::string mtllib;
  long ngroups = 0;
};

inline int32_t resolve_idx(long i, long n) {
  // OBJ 1-based / negative-relative -> 0-based (TriangleMesh.cpp:333)
  return (int32_t)(i < 0 ? n + i : i - 1);
}

struct Corner {
  long v;
  long u;   // LONG_MIN = absent
  long n;   // LONG_MIN = absent
};

const long ABSENT = LONG_MIN;

// parse one face corner starting at p (first char is '-' or digit);
// advances p past the corner
inline Corner parse_corner(const char*& p, const char* eol) {
  Corner c{0, ABSENT, ABSENT};
  char* q;
  c.v = strtol(p, &q, 10);
  p = q;
  if (p < eol && *p == '/') {
    ++p;
    if (p < eol && (*p == '-' || (*p >= '0' && *p <= '9'))) {
      c.u = strtol(p, &q, 10);
      p = q;
    }
    if (p < eol && *p == '/') {
      ++p;
      if (p < eol && (*p == '-' || (*p >= '0' && *p <= '9'))) {
        c.n = strtol(p, &q, 10);
        p = q;
      }
    }
  }
  return c;
}

inline std::string trimmed(const char* s, const char* e) {
  while (s < e && (unsigned char)*s <= ' ') ++s;
  while (e > s && (unsigned char)e[-1] <= ' ') --e;
  return std::string(s, e - s);
}

}  // namespace

extern "C" {

void* pt_obj_parse(const char* buf, long nbytes) {
  ObjData* d = new ObjData();
  std::unordered_map<std::string, int32_t> group_ids;
  int32_t cur_group = -1;
  const char* p = buf;
  const char* end = buf + nbytes;
  std::vector<Corner> cs;
  cs.reserve(8);

  while (p < end) {
    const char* eol = (const char*)memchr(p, '\n', end - p);
    if (!eol) eol = end;
    const char* line_end = eol;
    while (line_end > p && (line_end[-1] == '\r' || line_end[-1] == ' ' ||
                            line_end[-1] == '\t'))
      --line_end;
    long len = line_end - p;

    if (len >= 2 && p[0] == 'v' && p[1] == ' ') {
      // up to 6 floats; 3 = position, 6 = position + vertex color
      const char* q = p + 2;
      float vals[6];
      int k = 0;
      while (k < 6 && q < line_end) {
        char* r;
        float f = strtof(q, &r);
        if (r == q) break;  // no progress: stop (malformed tail)
        vals[k++] = f;
        q = r;
      }
      if (k >= 3) {
        d->verts.push_back(vals[0]);
        d->verts.push_back(vals[1]);
        d->verts.push_back(vals[2]);
        if (k == 6) {
          for (int j = 3; j < 6; ++j) {
            float c = vals[j];
            c = c < 0.f ? 0.f : (c > 1.f ? 1.f : c);
            d->vcols.push_back(c);
          }
        }
      }
    } else if (len >= 2 && p[0] == 'v' && p[1] == 'n') {
      const char* q = p + 2;
      float vals[3] = {0.f, 0.f, 0.f};
      int k = 0;
      while (k < 3 && q < line_end) {
        char* r;
        float f = strtof(q, &r);
        if (r == q) break;
        vals[k++] = f;
        q = r;
      }
      if (k >= 3) {
        d->norms.push_back(vals[0]);
        d->norms.push_back(vals[1]);
        d->norms.push_back(vals[2]);
      }
    } else if (len >= 2 && p[0] == 'v' && p[1] == 't') {
      const char* q = p + 2;
      float vals[2] = {0.f, 0.f};
      int k = 0;
      while (k < 2 && q < line_end) {
        char* r;
        float f = strtof(q, &r);
        if (r == q) break;
        vals[k++] = f;
        q = r;
      }
      if (k >= 2) {
        d->uvs.push_back(vals[0]);
        d->uvs.push_back(vals[1]);
      }
    } else if (len >= 2 && p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      cs.clear();
      const char* q = p + 1;
      while (q < line_end) {
        if (*q == '-' || (*q >= '0' && *q <= '9'))
          cs.push_back(parse_corner(q, line_end));
        else
          ++q;
      }
      if (cs.size() >= 3) {
        long nv = (long)d->verts.size() / 3;
        long nu = (long)d->uvs.size() / 2;
        long nn = (long)d->norms.size() / 3;
        size_t m = cs.size();
        for (size_t k = 1; k + 1 < m; ++k) {
          d->vtx.push_back(resolve_idx(cs[0].v, nv));
          d->vtx.push_back(resolve_idx(cs[k].v, nv));
          d->vtx.push_back(resolve_idx(cs[k + 1].v, nv));
          d->uvi.push_back(cs[0].u == ABSENT ? -1 : resolve_idx(cs[0].u, nu));
          d->uvi.push_back(cs[k].u == ABSENT ? -1 : resolve_idx(cs[k].u, nu));
          d->uvi.push_back(cs[k + 1].u == ABSENT ? -1
                                                 : resolve_idx(cs[k + 1].u, nu));
          d->ni.push_back(cs[0].n == ABSENT ? -1 : resolve_idx(cs[0].n, nn));
          d->ni.push_back(cs[k].n == ABSENT ? -1 : resolve_idx(cs[k].n, nn));
          d->ni.push_back(cs[k + 1].n == ABSENT ? -1
                                                : resolve_idx(cs[k + 1].n, nn));
          d->grp.push_back(cur_group);
          // showEdges marks real polygon borders (TriangleMesh.cpp:322,396)
          d->show.push_back(k == 1 ? 1 : 0);
          d->show.push_back(1);
          d->show.push_back(k + 2 == m ? 1 : 0);
        }
      }
    } else if (len >= 6 && memcmp(p, "usemtl", 6) == 0) {
      std::string name = trimmed(p + 6, line_end);
      auto it = group_ids.find(name);
      if (it == group_ids.end()) {
        int32_t id = (int32_t)group_ids.size();
        group_ids.emplace(name, id);
        if (!d->names.empty()) d->names.push_back('\n');
        d->names += name;
        cur_group = id;
      } else {
        cur_group = it->second;
      }
    } else if (len >= 6 && memcmp(p, "mtllib", 6) == 0) {
      d->mtllib = trimmed(p + 6, line_end);
    }
    p = eol + 1;
  }
  d->ngroups = (long)group_ids.size();
  return d;
}

void pt_obj_sizes(void* h, long* sizes) {
  ObjData* d = (ObjData*)h;
  sizes[0] = (long)d->verts.size() / 3;
  sizes[1] = (long)d->vcols.size() / 3;
  sizes[2] = (long)d->uvs.size() / 2;
  sizes[3] = (long)d->norms.size() / 3;
  sizes[4] = (long)d->grp.size();
  sizes[5] = (long)d->names.size();
  sizes[6] = (long)d->mtllib.size();
  sizes[7] = d->ngroups;
}

void pt_obj_fetch(void* h, float* verts, float* vcols, float* uvs,
                  float* norms, int32_t* vtx, int32_t* uvi, int32_t* ni,
                  int32_t* grp, uint8_t* show, char* names, char* mtllib) {
  ObjData* d = (ObjData*)h;
  if (!d->verts.empty()) memcpy(verts, d->verts.data(),
                                d->verts.size() * sizeof(float));
  if (!d->vcols.empty()) memcpy(vcols, d->vcols.data(),
                                d->vcols.size() * sizeof(float));
  if (!d->uvs.empty()) memcpy(uvs, d->uvs.data(),
                              d->uvs.size() * sizeof(float));
  if (!d->norms.empty()) memcpy(norms, d->norms.data(),
                                d->norms.size() * sizeof(float));
  if (!d->vtx.empty()) {
    memcpy(vtx, d->vtx.data(), d->vtx.size() * sizeof(int32_t));
    memcpy(uvi, d->uvi.data(), d->uvi.size() * sizeof(int32_t));
    memcpy(ni, d->ni.data(), d->ni.size() * sizeof(int32_t));
    memcpy(grp, d->grp.data(), d->grp.size() * sizeof(int32_t));
    memcpy(show, d->show.data(), d->show.size() * sizeof(uint8_t));
  }
  if (!d->names.empty()) memcpy(names, d->names.data(), d->names.size());
  if (!d->mtllib.empty()) memcpy(mtllib, d->mtllib.data(),
                                 d->mtllib.size());
}

void pt_obj_free(void* h) { delete (ObjData*)h; }

}  // extern "C"
