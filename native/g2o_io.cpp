// Native g2o tokenizer/writer for slam_tpu.
//
// Counterpart of the reference's C++ ingestion layer
// (DCS-ceres/include/g2o_util.h:23-89, which uses
// boost::split + lexical_cast per line).  This implementation reads the whole
// file once and parses numbers in place with strtod -- ~50-100x faster than a
// per-line Python loop and several times faster than the Boost tokenizer, so
// M10000-class files ingest in milliseconds.  Exposed through a minimal C ABI
// consumed via ctypes (slam_tpu/io/native.py); no pybind11 dependency.
//
// Record layouts written into caller-provided buffers:
//   SE2 vertex: [id, x, y, theta]                                  (4 doubles)
//   SE2 edge:   [a, b, dx, dy, dth, I11, I12, I13, I22, I23, I33]  (11 doubles)
//   SE3 vertex: [id, x, y, z, qx, qy, qz, qw]                      (8 doubles)
//   SE3 edge:   [a, b, x, y, z, qx, qy, qz, qw, info[21]]          (30 doubles)

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct FileBuf {
  char* data = nullptr;
  size_t size = 0;
  bool ok = false;
};

FileBuf read_all(const char* path) {
  FileBuf fb;
  FILE* f = std::fopen(path, "rb");
  if (!f) return fb;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz < 0) {
    std::fclose(f);
    return fb;
  }
  fb.data = static_cast<char*>(std::malloc(sz + 1));
  if (!fb.data) {
    std::fclose(f);
    return fb;
  }
  fb.size = std::fread(fb.data, 1, sz, f);
  fb.data[fb.size] = '\0';
  std::fclose(f);
  fb.ok = true;
  return fb;
}

inline bool starts_with(const char* p, const char* tag, size_t len) {
  return std::strncmp(p, tag, len) == 0;
}

// Parse `count` doubles starting at *p; advances *p.  Returns parsed count.
inline int parse_doubles(const char** p, double* out, int count) {
  int i = 0;
  const char* cur = *p;
  for (; i < count; ++i) {
    char* end = nullptr;
    double v = std::strtod(cur, &end);
    if (end == cur) break;
    out[i] = v;
    cur = end;
  }
  *p = cur;
  return i;
}

struct Tag {
  const char* text;
  size_t len;
  int kind;  // 0: v2, 1: e2, 2: v3, 3: e3
};

// Order matters: longer/more-specific tags first (VERTEX_SE3:QUAT before
// VERTEX_SE2 is not a prefix clash, but VERTEX2 vs VERTEX_SE2 differ).
const Tag kTags[] = {
    {"VERTEX_SE3:QUAT", 15, 2},
    {"EDGE_SE3:QUAT", 13, 3},
    {"VERTEX_SE2", 10, 0},
    {"EDGE_SE2", 8, 1},
    {"VERTEX2", 7, 0},
    {"EDGE2", 5, 1},
};

const int kFields[4] = {4, 11, 8, 30};

template <typename OnRecord>
void scan(const FileBuf& fb, OnRecord on_record) {
  const char* p = fb.data;
  const char* end = fb.data + fb.size;
  while (p < end) {
    // Tag match at line start.
    int kind = -1;
    for (const Tag& t : kTags) {
      if (starts_with(p, t.text, t.len)) {
        kind = t.kind;
        p += t.len;
        break;
      }
    }
    if (kind >= 0) {
      double vals[30];
      int got = parse_doubles(&p, vals, kFields[kind]);
      if (got == kFields[kind]) on_record(kind, vals);
    }
    // Skip to next line.
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', end - p));
    p = nl ? nl + 1 : end;
  }
}

}  // namespace

extern "C" {

// First pass: record counts per kind (v2, e2, v3, e3).  Returns 0 on success.
int slam_g2o_count(const char* path, long long* counts) {
  FileBuf fb = read_all(path);
  if (!fb.ok) return 1;
  long long c[4] = {0, 0, 0, 0};
  scan(fb, [&](int kind, const double*) { c[kind]++; });
  std::free(fb.data);
  for (int i = 0; i < 4; ++i) counts[i] = c[i];
  return 0;
}

// Second pass: fill caller-allocated buffers (row-major, layouts above).
// Any pointer may be null if the corresponding count is 0.
int slam_g2o_parse(const char* path, double* v2, double* e2, double* v3,
                   double* e3) {
  FileBuf fb = read_all(path);
  if (!fb.ok) return 1;
  double* out[4] = {v2, e2, v3, e3};
  long long idx[4] = {0, 0, 0, 0};
  scan(fb, [&](int kind, const double* vals) {
    if (!out[kind]) return;
    std::memcpy(out[kind] + idx[kind] * kFields[kind], vals,
                kFields[kind] * sizeof(double));
    idx[kind]++;
  });
  std::free(fb.data);
  return 0;
}

// Fast writer for the reference's node format: "index p0 p1 ... pD-1" per
// line (g2o_util.h:93-102).  Returns 0 on success.
int slam_write_nodes(const char* path, const double* poses, long long n,
                     int dim) {
  FILE* f = std::fopen(path, "w");
  if (!f) return 1;
  std::vector<char> buf(1 << 20);
  std::setvbuf(f, buf.data(), _IOFBF, buf.size());
  for (long long i = 0; i < n; ++i) {
    std::fprintf(f, "%lld", i);
    for (int j = 0; j < dim; ++j)
      std::fprintf(f, " %.17g", poses[i * dim + j]);
    std::fputc('\n', f);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
