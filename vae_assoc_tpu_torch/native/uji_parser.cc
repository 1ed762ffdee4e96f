// Native UJI Pen Characters v2 parser: the host side of the data loader.
//
// Parsing the UJI text format into padded point arrays is the only work of
// the input path that scales with the dataset on the host (data/uji.py
// documents the format). This C++ parser is a drop-in for the Python one
// in data/uji.py (bit-identical outputs, including the uniform
// endpoint-preserving subsample and the y-flip) and is loaded with ctypes,
// with no pybind11. native/__init__.py builds it at first use:
//   g++ -O3 -shared -fPIC -std=c++17 uji_parser.cc -o libuji_parser.so
//
// C ABI: uji_parse_file() mallocs one result struct; uji_parse_free()
// releases it. Errors come back in .error instead of exceptions.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

extern "C" {

typedef struct {
  int32_t n_samples;
  int32_t max_points;
  float* points;     // [n_samples, max_points, 2], padded with last point
  int32_t* lengths;  // [n_samples]
  char* names;       // newline-joined per-sample character names
  int64_t names_len;
  char* error;       // non-null on failure (struct otherwise empty)
} UjiParse;

static UjiParse* fail(UjiParse* r, const std::string& msg) {
  r->error = strdup(msg.c_str());
  return r;
}

// Python twin parity helpers. data/uji.py parses with anchored regexes and
// silently IGNORES any line that does not match — the native parser must
// accept/reject and produce bit-identical results on exactly the same
// inputs (fuzz-tested: tests/test_torch_data.py differential fuzz).

static inline bool is_linews(char c) { return c == ' ' || c == '\t'; }

// str.splitlines separators that can appear in a byte stream read as text:
// \n \r \v \f \x1c \x1d \x1e (with \r\n fused like Python).
static inline bool is_linebreak(char c) {
  return c == '\n' || c == '\r' || c == '\v' || c == '\f' || c == '\x1c' ||
         c == '\x1d' || c == '\x1e';
}

// np.float64(token) acceptance: strict strtod over the WHOLE token, minus
// C99 extensions Python's float() rejects (hex floats, "nan(chars)").
static bool parse_f64_like_python(const std::string& tok, double* out) {
  if (tok.empty()) return false;
  for (char c : tok) {
    if (c == 'x' || c == 'X' || c == '(') return false;
  }
  char* end = nullptr;
  double v = strtod(tok.c_str(), &end);
  if (end != tok.c_str() + tok.size()) return false;
  *out = v;
  return true;
}

UjiParse* uji_parse_file(const char* path, int32_t max_points) {
  UjiParse* r = (UjiParse*)calloc(1, sizeof(UjiParse));
  r->max_points = max_points;
  std::ifstream in(path, std::ios::binary);
  if (!in) return fail(r, std::string("cannot open ") + path);
  std::ostringstream buf;
  buf << in.rdbuf();
  const std::string text = buf.str();

  struct Sample {
    std::string name;
    std::vector<float> xy;  // concatenated strokes, interleaved x,y
  };
  std::vector<Sample> samples;
  bool have_word = false;
  Sample cur;

  size_t pos = 0;
  while (pos <= text.size()) {
    // next logical line (str.splitlines semantics)
    size_t eol = pos;
    while (eol < text.size() && !is_linebreak(text[eol])) ++eol;
    const std::string line = text.substr(pos, eol - pos);
    if (eol >= text.size()) {
      pos = text.size() + 1;  // final line (or empty tail) consumed
      if (line.empty()) break;
    } else {
      pos = eol + 1;
      if (text[eol] == '\r' && pos < text.size() && text[pos] == '\n') ++pos;
    }

    size_t p = line.find_first_not_of(" \t");
    if (p == std::string::npos) continue;
    if (line.compare(p, 2, "//") == 0) continue;

    // ^\s*WORD\s+(\S+) — a nameless WORD line matches nothing and is
    // ignored WITHOUT flushing the current sample, like the Python twin.
    if (line.compare(p, 4, "WORD") == 0) {
      size_t q = p + 4;
      if (q < line.size() && is_linews(line[q])) {
        size_t s = line.find_first_not_of(" \t", q);
        if (s != std::string::npos) {
          if (have_word && !cur.xy.empty()) samples.push_back(cur);
          cur = Sample();
          size_t e = line.find_first_of(" \t", s);
          cur.name = line.substr(s, e == std::string::npos ? e : e - s);
          have_word = true;
        }
      }
      continue;
    }

    // ^\s*POINTS\s+(\d+)\s*#\s*(.*)$ — any shape mismatch → line ignored.
    if (line.compare(p, 6, "POINTS") == 0) {
      size_t q = p + 6;
      if (q >= line.size() || !is_linews(line[q])) continue;
      while (q < line.size() && is_linews(line[q])) ++q;
      size_t d0 = q;
      while (q < line.size() && line[q] >= '0' && line[q] <= '9') ++q;
      if (q == d0) continue;  // no digits
      std::string digits = line.substr(d0, q - d0);
      while (q < line.size() && is_linews(line[q])) ++q;
      if (q >= line.size() || line[q] != '#') continue;
      ++q;
      // values: whitespace-split tokens after '#', each np.float64-valid
      std::vector<float> vals;
      unsigned long long count = 0;
      while (q < line.size()) {
        while (q < line.size() && is_linews(line[q])) ++q;
        if (q >= line.size()) break;
        size_t t0 = q;
        while (q < line.size() && !is_linews(line[q])) ++q;
        double v;
        if (!parse_f64_like_python(line.substr(t0, q - t0), &v)) {
          return fail(r, "could not convert POINTS value to float: " +
                             line.substr(t0, q - t0));
        }
        vals.push_back((float)v);
        ++count;
      }
      // n for the error message, sans leading zeros (Python prints int(n))
      size_t z = digits.find_first_not_of('0');
      std::string nstr = (z == std::string::npos) ? "0" : digits.substr(z);
      bool match = false;
      if (nstr.size() <= 18) {
        unsigned long long n = strtoull(nstr.c_str(), nullptr, 10);
        match = (count == 2 * n);
      }  // >18 digits can never equal a line's token count
      if (!match) {
        std::ostringstream msg;
        msg << "POINTS header says " << nstr << " points but line has "
            << count << " values";
        return fail(r, msg.str());
      }
      cur.xy.insert(cur.xy.end(), vals.begin(), vals.end());
      continue;
    }
    // NUMSTROKES and anything else: ignored, as in the Python parser.
  }
  if (have_word && !cur.xy.empty()) samples.push_back(cur);
  // Zero samples (e.g. comments-only file) is a VALID empty result, exactly
  // as the Python parser returns [] — not an error. The ctypes wrapper
  // short-circuits n_samples == 0 without touching the data pointers.

  int32_t n = (int32_t)samples.size();
  r->n_samples = n;
  r->points = (float*)calloc((size_t)n * max_points * 2, sizeof(float));
  r->lengths = (int32_t*)malloc(n * sizeof(int32_t));

  std::string names;
  for (int32_t i = 0; i < n; ++i) {
    const Sample& s = samples[i];
    long npts = (long)(s.xy.size() / 2);
    std::vector<float> poly;
    poly.reserve((size_t)max_points * 2);
    if (npts > max_points) {
      // numpy.linspace(0, npts-1, max_points).round() — round-half-to-even
      // to match numpy exactly.
      for (int32_t k = 0; k < max_points; ++k) {
        double t = (double)k * (double)(npts - 1) / (double)(max_points - 1);
        long idx = (long)std::nearbyint(t);
        poly.push_back(s.xy[2 * idx]);
        poly.push_back(s.xy[2 * idx + 1]);
      }
      npts = max_points;
    } else {
      poly.assign(s.xy.begin(), s.xy.end());
    }
    float* out = r->points + (size_t)i * max_points * 2;
    for (long k = 0; k < npts; ++k) {
      out[2 * k] = poly[2 * k];
      out[2 * k + 1] = -poly[2 * k + 1];  // y-flip (tablet y grows downward)
    }
    for (long k = npts; k < max_points; ++k) {  // pad with the last point
      out[2 * k] = out[2 * (npts - 1)];
      out[2 * k + 1] = out[2 * (npts - 1) + 1];
    }
    r->lengths[i] = (int32_t)npts;
    if (i) names += '\n';
    names += s.name;
  }
  r->names = strdup(names.c_str());
  r->names_len = (int64_t)names.size();
  return r;
}

void uji_parse_free(UjiParse* r) {
  if (!r) return;
  free(r->points);
  free(r->lengths);
  free(r->names);
  free(r->error);
  free(r);
}

}  // extern "C"
