// Native legacy-VTK reader (C API for ctypes).
//
// The ShapeNet-Car pipeline parses two legacy .vtk files per sample
// (quadpress_smpl.vtk / hexvelo_smpl.vtk, reference dataset.py:161-181 via
// the VTK library); the port's fallback reader is numpy
// (haet_torch/data/vtk_io.py). This file, a copy of the JAX package's
// native/vtkread.cpp, is the native data-loader
// equivalent: a single-pass parser over a memory buffer covering the same
// legacy-format subset (ASCII + big-endian BINARY, POINTS,
// CELLS/POLYGONS + CELL_TYPES, POINT_DATA / CELL_DATA with
// SCALARS/VECTORS/NORMALS); measured ~6x faster end-to-end than the
// Python tokenizer on a 100k-point ASCII file — which matters when
// preprocessing all 889 car samples.
//
// API: haet_vtk_parse() -> opaque handle; counted getters copy into
// caller-provided numpy buffers; haet_vtk_free() releases.

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

namespace {

struct Field {
  std::string name;
  int64_t ncomp = 1;
  std::vector<float> data;  // [n * ncomp]
};

struct Vtk {
  std::vector<float> points;        // [n_points * 3]
  std::vector<int64_t> cell_sizes;  // [n_cells]
  std::vector<int64_t> cell_index;  // flat vertex ids
  std::vector<int64_t> cell_types;  // [n_cells] (may be empty)
  std::vector<Field> point_fields;
  std::vector<Field> cell_fields;
  std::string error;
};

struct Cursor {
  const char* p;
  const char* end;
};

bool next_line(Cursor& c, std::string& out) {
  if (c.p >= c.end) return false;
  const char* nl = static_cast<const char*>(
      memchr(c.p, '\n', static_cast<size_t>(c.end - c.p)));
  if (!nl) {
    out.assign(c.p, c.end);
    c.p = c.end;
  } else {
    out.assign(c.p, nl);
    c.p = nl + 1;
  }
  if (!out.empty() && out.back() == '\r') out.pop_back();
  return true;
}

std::vector<std::string> split(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size()) {
    while (i < s.size() && isspace(static_cast<unsigned char>(s[i]))) i++;
    size_t j = i;
    while (j < s.size() && !isspace(static_cast<unsigned char>(s[j]))) j++;
    if (j > i) out.push_back(s.substr(i, j - i));
    i = j;
  }
  return out;
}

std::string upper(std::string s) {
  for (char& ch : s) ch = static_cast<char>(toupper(static_cast<unsigned char>(ch)));
  return s;
}

// Read `count` ASCII numbers starting at the cursor (whitespace/newline
// separated). Returns false on premature end.
bool read_ascii(Cursor& c, int64_t count, double* out) {
  for (int64_t k = 0; k < count; k++) {
    while (c.p < c.end && isspace(static_cast<unsigned char>(*c.p))) c.p++;
    if (c.p >= c.end) return false;
    char* stop = nullptr;
    out[k] = strtod(c.p, &stop);
    if (stop == c.p) return false;
    c.p = stop;
  }
  // consume the trailing newline so next_line starts clean
  while (c.p < c.end && *c.p != '\n' &&
         isspace(static_cast<unsigned char>(*c.p)))
    c.p++;
  if (c.p < c.end && *c.p == '\n') c.p++;
  return true;
}

int type_size(const std::string& t) {
  if (t == "float" || t == "int" || t == "unsigned_int") return 4;
  if (t == "double" || t == "long" || t == "vtktypeint64") return 8;
  if (t == "short" || t == "unsigned_short") return 2;
  if (t == "char" || t == "unsigned_char") return 1;
  return 4;
}

bool type_is_float(const std::string& t) {
  return t == "float" || t == "double";
}

// Read `count` big-endian binary values of vtk type `t`.
bool read_binary(Cursor& c, int64_t count, const std::string& t, double* out) {
  const int sz = type_size(t);
  if (c.end - c.p < count * sz) return false;
  const unsigned char* q = reinterpret_cast<const unsigned char*>(c.p);
  for (int64_t k = 0; k < count; k++, q += sz) {
    uint64_t v = 0;
    for (int b = 0; b < sz; b++) v = (v << 8) | q[b];
    if (type_is_float(t)) {
      if (sz == 4) {
        uint32_t u32 = static_cast<uint32_t>(v);
        float f;
        memcpy(&f, &u32, 4);
        out[k] = f;
      } else {
        double d;
        memcpy(&d, &v, 8);
        out[k] = d;
      }
    } else {
      // sign-extend signed integer types
      if (t[0] != 'u' && sz < 8) {
        const uint64_t sign = 1ull << (sz * 8 - 1);
        if (v & sign) v |= ~((sign << 1) - 1);
      }
      out[k] = static_cast<double>(static_cast<int64_t>(v));
    }
  }
  c.p += count * sz;
  if (c.p < c.end && *c.p == '\n') c.p++;
  return true;
}

// A count from an (untrusted) header is plausible only if non-negative and
// small enough that the remaining buffer could possibly hold it: binary
// needs count*sz bytes exactly; ASCII needs at least 2 bytes per number
// (digit + separator), minus the last separator. Checked with divisions so
// count*sz can never overflow. Rejecting here keeps a malformed file from
// driving resize() into std::length_error/bad_alloc on a huge count.
bool count_plausible(const Cursor& c, bool binary, const std::string& t,
                     int64_t count) {
  if (count < 0) return false;
  const int64_t remaining = c.end - c.p;
  if (binary) return count <= remaining / type_size(t);
  return count <= (remaining + 1) / 2;
}

bool read_block(Cursor& c, bool binary, const std::string& t, int64_t count,
                std::vector<double>& out) {
  if (!count_plausible(c, binary, t, count)) return false;
  out.resize(static_cast<size_t>(count));
  return binary ? read_binary(c, count, t, out.data())
                : read_ascii(c, count, out.data());
}

// unique_ptr ownership: if a vector resize throws mid-parse (huge but
// header-plausible counts on a memory-constrained host), the partially
// filled Vtk must not leak on the way to the caller's catch.
std::unique_ptr<Vtk> parse(const char* buf, int64_t len) {
  auto v = std::make_unique<Vtk>();
  Cursor c{buf, buf + len};
  std::string line;

  // header: version, title, format
  next_line(c, line);                     // # vtk DataFile ...
  next_line(c, line);                     // title
  next_line(c, line);
  const bool binary = upper(line).find("BINARY") != std::string::npos;

  int64_t section_n = 0;                  // POINT_DATA / CELL_DATA count
  bool in_point_data = true;
  std::vector<double> tmp;

  while (next_line(c, line)) {
    auto parts = split(line);
    if (parts.empty()) continue;
    const std::string key = upper(parts[0]);

    if (key == "POINTS" && parts.size() >= 3) {
      const int64_t n = atoll(parts[1].c_str());
      // bound-check before n*3 can overflow
      if (n < 0 || n > (c.end - c.p)) {
        v->error = "bad POINTS count";
        return v;
      }
      if (!read_block(c, binary, parts[2], n * 3, tmp)) {
        v->error = "short POINTS";
        return v;
      }
      v->points.assign(tmp.begin(), tmp.end());
    } else if ((key == "CELLS" || key == "POLYGONS") && parts.size() >= 3) {
      const int64_t n = atoll(parts[1].c_str());
      const int64_t sz = atoll(parts[2].c_str());
      if (!read_block(c, binary, "int", sz, tmp)) {
        v->error = "short CELLS";
        return v;
      }
      int64_t i = 0;
      for (int64_t k = 0; k < n && i < sz; k++) {
        const int64_t cnt = static_cast<int64_t>(tmp[static_cast<size_t>(i++)]);
        v->cell_sizes.push_back(cnt);
        for (int64_t j = 0; j < cnt && i < sz; j++)
          v->cell_index.push_back(
              static_cast<int64_t>(tmp[static_cast<size_t>(i++)]));
      }
    } else if (key == "CELL_TYPES" && parts.size() >= 2) {
      const int64_t n = atoll(parts[1].c_str());
      if (!read_block(c, binary, "int", n, tmp)) {
        v->error = "short CELL_TYPES";
        return v;
      }
      v->cell_types.assign(tmp.begin(), tmp.end());
    } else if (key == "POINT_DATA" && parts.size() >= 2) {
      in_point_data = true;
      section_n = atoll(parts[1].c_str());
      if (section_n < 0 || section_n > (c.end - c.p)) {
        v->error = "bad POINT_DATA count";
        return v;
      }
    } else if (key == "CELL_DATA" && parts.size() >= 2) {
      in_point_data = false;
      section_n = atoll(parts[1].c_str());
      if (section_n < 0 || section_n > (c.end - c.p)) {
        v->error = "bad CELL_DATA count";
        return v;
      }
    } else if ((key == "SCALARS" || key == "VECTORS" || key == "NORMALS") &&
               parts.size() >= 2) {
      Field f;
      f.name = parts[1];
      const std::string vtype = parts.size() >= 3 ? parts[2] : "float";
      f.ncomp = (key == "SCALARS")
                    ? (parts.size() >= 4 ? atoll(parts[3].c_str()) : 1)
                    : 3;
      // legal SCALARS numComp is 1..4; reject junk before section_n*ncomp
      if (f.ncomp < 1 || f.ncomp > 4) {
        v->error = "bad field ncomp";
        return v;
      }
      if (key == "SCALARS") {
        // optional LOOKUP_TABLE line
        Cursor save = c;
        std::string peek;
        if (next_line(c, peek) &&
            upper(peek).rfind("LOOKUP_TABLE", 0) != 0)
          c = save;
      }
      if (!read_block(c, binary, vtype, section_n * f.ncomp, tmp)) {
        v->error = "short field " + f.name;
        return v;
      }
      f.data.assign(tmp.begin(), tmp.end());
      (in_point_data ? v->point_fields : v->cell_fields).push_back(std::move(f));
    }
    // anything else: skip the line
  }
  return v;
}

}  // namespace

extern "C" {

void* haet_vtk_parse(const char* buf, int64_t len) {
  // No exception may cross the extern "C" boundary into ctypes — an escape
  // aborts the interpreter instead of triggering the caller's numpy
  // fallback for a malformed file.
  std::unique_ptr<Vtk> v;
  try {
    v = parse(buf, len);
  } catch (...) {
    return nullptr;
  }
  if (!v->error.empty()) {
    return nullptr;
  }
  return v.release();
}

void haet_vtk_free(void* h) { delete static_cast<Vtk*>(h); }

int64_t haet_vtk_num_points(void* h) {
  return static_cast<int64_t>(static_cast<Vtk*>(h)->points.size() / 3);
}
int64_t haet_vtk_num_cells(void* h) {
  return static_cast<int64_t>(static_cast<Vtk*>(h)->cell_sizes.size());
}
int64_t haet_vtk_cells_flat_size(void* h) {
  return static_cast<int64_t>(static_cast<Vtk*>(h)->cell_index.size());
}
int64_t haet_vtk_num_cell_types(void* h) {
  return static_cast<int64_t>(static_cast<Vtk*>(h)->cell_types.size());
}
int64_t haet_vtk_num_fields(void* h, int point_data) {
  auto* v = static_cast<Vtk*>(h);
  return static_cast<int64_t>(
      (point_data ? v->point_fields : v->cell_fields).size());
}
const char* haet_vtk_field_name(void* h, int point_data, int64_t i) {
  auto* v = static_cast<Vtk*>(h);
  return (point_data ? v->point_fields : v->cell_fields)[static_cast<size_t>(i)]
      .name.c_str();
}
int64_t haet_vtk_field_size(void* h, int point_data, int64_t i) {
  auto* v = static_cast<Vtk*>(h);
  return static_cast<int64_t>(
      (point_data ? v->point_fields
                  : v->cell_fields)[static_cast<size_t>(i)].data.size());
}
int64_t haet_vtk_field_ncomp(void* h, int point_data, int64_t i) {
  auto* v = static_cast<Vtk*>(h);
  return (point_data ? v->point_fields
                     : v->cell_fields)[static_cast<size_t>(i)].ncomp;
}

void haet_vtk_get_points(void* h, float* out) {
  auto* v = static_cast<Vtk*>(h);
  memcpy(out, v->points.data(), v->points.size() * sizeof(float));
}
void haet_vtk_get_cell_sizes(void* h, int64_t* out) {
  auto* v = static_cast<Vtk*>(h);
  memcpy(out, v->cell_sizes.data(), v->cell_sizes.size() * sizeof(int64_t));
}
void haet_vtk_get_cell_index(void* h, int64_t* out) {
  auto* v = static_cast<Vtk*>(h);
  memcpy(out, v->cell_index.data(), v->cell_index.size() * sizeof(int64_t));
}
void haet_vtk_get_cell_types(void* h, int64_t* out) {
  auto* v = static_cast<Vtk*>(h);
  memcpy(out, v->cell_types.data(), v->cell_types.size() * sizeof(int64_t));
}
void haet_vtk_get_field(void* h, int point_data, int64_t i, float* out) {
  auto* v = static_cast<Vtk*>(h);
  auto& f = (point_data ? v->point_fields
                        : v->cell_fields)[static_cast<size_t>(i)];
  memcpy(out, f.data.data(), f.data.size() * sizeof(float));
}

}  // extern "C"

#ifdef VTK_SELFTEST
// ASan/UBSan harness: parse files given on argv and print their shapes.
//   g++ -O1 -g -std=c++17 -fsanitize=address -DVTK_SELFTEST vtkread.cpp
#include <cstdio>

int main(int argc, char** argv) {
  for (int a = 1; a < argc; a++) {
    FILE* f = fopen(argv[a], "rb");
    if (!f) return 1;
    fseek(f, 0, SEEK_END);
    long len = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(len));
    if (fread(buf.data(), 1, static_cast<size_t>(len), f) !=
        static_cast<size_t>(len)) {
      fclose(f);
      return 1;
    }
    fclose(f);
    void* h = haet_vtk_parse(buf.data(), len);
    if (!h) {
      fprintf(stderr, "parse failed: %s\n", argv[a]);
      return 1;
    }
    printf("%s: points=%lld cells=%lld pf=%lld cf=%lld\n", argv[a],
           (long long)haet_vtk_num_points(h), (long long)haet_vtk_num_cells(h),
           (long long)haet_vtk_num_fields(h, 1),
           (long long)haet_vtk_num_fields(h, 0));
    haet_vtk_free(h);
  }
  return 0;
}
#endif  // VTK_SELFTEST
