// Native point-cloud loaders: fast TXT and PLY parsing.
//
// Capability parity with the reference's C++ loaders
// (/root/reference/src/utilities.hpp:113-235: tinyply PLY reading and the
// first-line-count TXT format), exposed through a C ABI consumed via
// ctypes (fgoicp/native/loader.py).  The Python fallback
// (io/loader.py, io/ply.py) stays authoritative for exotic files; this
// path exists because np.loadtxt-style parsing is ~30x slower than a
// tight strtof loop on bunny-scale TXT clouds.
//
// Build: fgoicp/native/build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
// (vector/string power the PLY header parser below)

namespace {

// Read a whole file into a string; returns false on failure.
bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(&(*out)[0], 1, static_cast<size_t>(size), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(size);
}

}  // namespace

extern "C" {

// Parse a TXT cloud: first line = count, then "x y z [extra...]" rows.
// Returns a malloc'd float array of 3*count (caller frees via
// fgoicp_free) and writes the count; returns nullptr on parse failure.
float* fgoicp_load_txt(const char* path, int64_t* n_out) {
  *n_out = 0;
  std::string buf;
  if (!read_file(path, &buf)) return nullptr;
  const char* p = buf.c_str();
  char* end = nullptr;
  long long total = std::strtoll(p, &end, 10);
  // Bound the declared count by what the file can physically hold (a row
  // is at least "0 0 0\n" = 6 bytes): a huge attacker-controlled count
  // would otherwise wrap the size_t allocation below and the row-writing
  // loop would overflow the small buffer before parsing runs dry.
  if (end == p || total <= 0 ||
      static_cast<unsigned long long>(total) > buf.size() / 6)
    return nullptr;
  p = end;
  // Skip to the end of the header line (ignore trailing tokens on it).
  while (*p && *p != '\n') ++p;

  float* data = static_cast<float*>(std::malloc(sizeof(float) * 3 * total));
  if (!data) return nullptr;
  long long row = 0;
  while (row < total) {
    for (int c = 0; c < 3; ++c) {
      float v = std::strtof(p, &end);
      if (end == p) {  // no more numbers
        std::free(data);
        return nullptr;
      }
      data[row * 3 + c] = v;
      p = end;
    }
    // Skip the rest of the row (the reference ignores extra columns).
    while (*p && *p != '\n') ++p;
    ++row;
  }
  *n_out = total;
  return data;
}

void fgoicp_free(float* ptr) { std::free(ptr); }

namespace {

struct Prop {
  std::string name;
  int size;       // bytes (binary)
  bool is_double;
  bool is_float;
};

// Returns nullptr for anything exotic (list props before/on vertex,
// unknown types) — the Python parser handles those.
float* load_ply_impl(const std::string& buf, int64_t* n_out) {
  size_t pos = 0;
  auto next_line = [&](std::string* line) -> bool {
    if (pos >= buf.size()) return false;
    size_t end = buf.find('\n', pos);
    if (end == std::string::npos) end = buf.size();
    *line = buf.substr(pos, end - pos);
    if (!line->empty() && line->back() == '\r') line->pop_back();
    pos = end + 1;
    return true;
  };
  std::string line;
  if (!next_line(&line) || line != "ply") return nullptr;

  static const struct { const char* n; int s; } kTypes[] = {
      {"char", 1}, {"int8", 1}, {"uchar", 1}, {"uint8", 1},
      {"short", 2}, {"int16", 2}, {"ushort", 2}, {"uint16", 2},
      {"int", 4}, {"int32", 4}, {"uint", 4}, {"uint32", 4},
      {"float", 4}, {"float32", 4}, {"double", 8}, {"float64", 8}};
  auto type_size = [&](const std::string& t) -> int {
    for (auto& k : kTypes) if (t == k.n) return k.s;
    return -1;
  };

  bool binary = false, ascii = false;
  // Elements in file order: (name, count, props, has_list)
  struct Elem { std::string name; long long count; std::vector<Prop> props;
                bool has_list = false; };
  std::vector<Elem> elems;
  while (next_line(&line)) {
    if (line.rfind("comment", 0) == 0 || line.rfind("obj_info", 0) == 0)
      continue;
    if (line == "end_header") break;
    char a[64] = {0}, b[64] = {0}, c[64] = {0}, d[64] = {0};
    if (std::sscanf(line.c_str(), "%63s %63s %63s %63s", a, b, c, d) < 1)
      return nullptr;
    std::string kw = a;
    if (kw == "format") {
      if (std::string(b) == "ascii") ascii = true;
      else if (std::string(b) == "binary_little_endian") binary = true;
      else return nullptr;  // big-endian -> Python path
    } else if (kw == "element") {
      Elem e; e.name = b; e.count = std::strtoll(c, nullptr, 10);
      elems.push_back(e);
    } else if (kw == "property") {
      if (elems.empty()) return nullptr;
      if (std::string(b) == "list") { elems.back().has_list = true; continue; }
      int sz = type_size(b);
      if (sz < 0) return nullptr;
      Prop p{d[0] ? std::string(c) : std::string(c), sz,
             std::string(b) == "double" || std::string(b) == "float64",
             std::string(b) == "float" || std::string(b) == "float32"};
      elems.back().props.push_back(p);
    } else {
      return nullptr;
    }
  }
  if (!(binary || ascii)) return nullptr;

  // Bound every declared element count by the file size (each row takes
  // at least one byte in either encoding) BEFORE any allocation or
  // stride*count arithmetic: a huge count wraps the multiplications and
  // turns the row loops into heap overflows on a small buffer.
  for (const auto& e : elems) {
    if (e.count < 0 ||
        static_cast<unsigned long long>(e.count) > buf.size())
      return nullptr;
  }

  for (auto& e : elems) {
    if (e.name == "vertex") {
      if (e.has_list) return nullptr;
      int ix = -1, iy = -1, iz = -1;
      long long stride = 0, offx = 0, offy = 0, offz = 0;
      for (size_t i = 0; i < e.props.size(); ++i) {
        const Prop& pr = e.props[i];
        if (pr.name == "x") { ix = (int)i; offx = stride; }
        if (pr.name == "y") { iy = (int)i; offy = stride; }
        if (pr.name == "z") { iz = (int)i; offz = stride; }
        stride += pr.size;
      }
      if (ix < 0 || iy < 0 || iz < 0) return nullptr;
      // All three coordinates must be float or double AND the same type:
      // the binary path memcpys with one width/encoding for all of them,
      // so a mixed x:float/y:double (or integer y) file would silently
      // return corrupted coordinates.  Punt to the Python parser instead.
      const Prop &px = e.props[ix], &py = e.props[iy], &pz = e.props[iz];
      for (const Prop* pr : {&px, &py, &pz})
        if (!(pr->is_double || pr->is_float)) return nullptr;
      if (py.is_double != px.is_double || pz.is_double != px.is_double)
        return nullptr;
      float* data =
          static_cast<float*>(std::malloc(sizeof(float) * 3 * e.count));
      if (!data) return nullptr;
      if (binary) {
        if (pos + stride * e.count > buf.size()) { std::free(data); return nullptr; }
        const char* base = buf.data() + pos;
        bool dbl = e.props[ix].is_double;
        for (long long r = 0; r < e.count; ++r) {
          const char* row = base + r * stride;
          if (dbl) {
            double vx, vy, vz;
            std::memcpy(&vx, row + offx, 8);
            std::memcpy(&vy, row + offy, 8);
            std::memcpy(&vz, row + offz, 8);
            data[r * 3 + 0] = (float)vx;
            data[r * 3 + 1] = (float)vy;
            data[r * 3 + 2] = (float)vz;
          } else {
            std::memcpy(&data[r * 3 + 0], row + offx, 4);
            std::memcpy(&data[r * 3 + 1], row + offy, 4);
            std::memcpy(&data[r * 3 + 2], row + offz, 4);
          }
        }
      } else {
        const char* p = buf.c_str() + pos;
        char* end = nullptr;
        int np = (int)e.props.size();
        for (long long r = 0; r < e.count; ++r) {
          for (int cix = 0; cix < np; ++cix) {
            float v = std::strtof(p, &end);
            if (end == p) { std::free(data); return nullptr; }
            p = end;
            if (cix == ix) data[r * 3 + 0] = v;
            if (cix == iy) data[r * 3 + 1] = v;
            if (cix == iz) data[r * 3 + 2] = v;
          }
        }
      }
      *n_out = e.count;
      return data;
    }
    // Skip a non-vertex element.
    if (e.has_list) return nullptr;  // variable rows -> Python path
    long long stride = 0;
    for (auto& pr : e.props) stride += pr.size;
    if (binary) {
      pos += (size_t)(stride * e.count);
      if (pos > buf.size()) return nullptr;
    } else {
      for (long long r = 0; r < e.count; ++r) {
        size_t nl = buf.find('\n', pos);
        if (nl == std::string::npos) return nullptr;
        pos = nl + 1;
      }
    }
  }
  return nullptr;  // no vertex element
}

}  // namespace

// Parse a PLY cloud (ascii / binary_little_endian, scalar vertex props).
// Returns nullptr for unsupported variants (caller falls back to Python).
float* fgoicp_load_ply(const char* path, int64_t* n_out) {
  *n_out = 0;
  std::string buf;
  if (!read_file(path, &buf)) return nullptr;
  return load_ply_impl(buf, n_out);
}

// ABI version so the Python side can detect stale builds.
int32_t fgoicp_native_abi() { return 2; }

}  // extern "C"
