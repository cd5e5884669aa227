// Fast ETH/UCY annotation parser, host code of the port (a copy of the JAX
// package's mmtraj/native/fastparse.cpp with the same C interface).
//
// A single-pass scanner over a read() buffer with an exact fast-path decimal
// parser (one correctly-rounded division; bit-identical to strtod), exposed
// to Python via ctypes (mmtraj_torch/data/native.py) with the NumPy parser
// (mmtraj_torch/data/parser.py) as the documented fallback.  Output is the
// (R, 4) row layout [frame, ped, x, y] the rest of the pipeline consumes.
//
// Build: mmtraj_torch/native/build.py (g++ -O3 -shared -fPIC).

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Read whole file into a NUL-terminated buffer.  Returns nullptr on error.
char* read_file(const char* path, long* size_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(std::malloc(size + 1));
  if (!buf) {
    std::fclose(f);
    return nullptr;
  }
  long got = static_cast<long>(std::fread(buf, 1, size, f));
  std::fclose(f);
  buf[got] = '\0';
  *size_out = got;
  return buf;
}

// Fast decimal parser for the common annotation format: [-]ddd[.ddd].
// Falls back to strtod for exponents/inf/nan/hex.  Returns true and advances
// *pp past the number (and trailing separators) on success.
inline bool parse_number(char** pp, double* out) {
  char* p = *pp;
  bool neg = false;
  if (*p == '-') {
    neg = true;
    ++p;
  } else if (*p == '+') {
    ++p;
  }
  if (!((*p >= '0' && *p <= '9') || *p == '.')) return false;
  // Accumulate all digits (integer + fraction) into one mantissa.  If the
  // mantissa stays < 2^53 and the fraction has <= 15 digits, then
  // mantissa / 10^fdig is ONE correctly-rounded double division of two
  // exactly-representable doubles — bit-identical to strtod.
  unsigned long long mant = 0;
  int digits = 0;
  while (*p >= '0' && *p <= '9') {
    if (digits >= 15) goto slow;  // risk of inexact mantissa: strtod
    mant = mant * 10 + static_cast<unsigned>(*p - '0');
    ++p;
    ++digits;
  }
  {
    int fdig = 0;
    if (*p == '.') {
      ++p;
      while (*p >= '0' && *p <= '9') {
        if (digits >= 15) goto slow;
        mant = mant * 10 + static_cast<unsigned>(*p - '0');
        ++p;
        ++digits;
        ++fdig;
      }
    }
    if (*p == 'e' || *p == 'E') goto slow;  // exponent: strtod handles it
    if (digits == 0) goto slow;  // bare '.'/'-.' etc: strtod rejects them
    static const double kPow10[16] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,
                                      1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
                                      1e12, 1e13, 1e14, 1e15};
    double v = static_cast<double>(mant) / kPow10[fdig];
    *out = neg ? -v : v;
    *pp = p;
    return true;
  }
slow: {
  char* next = nullptr;
  double sv = std::strtod(*pp, &next);
  if (next == *pp) return false;
  *out = sv;
  *pp = next;
  return true;
}
}

// Parse every whitespace-separated number in the buffer, tracking line
// structure: each non-empty, non-comment line must yield >= min_cols numbers;
// the first 4 are kept.  A number with junk glued directly to it (e.g. the
// ".3" in "1.2.3") keeps the parsed prefix and ends that line's scan — the
// same token-level rule as the NumPy fallback (parser._read_tolerant), so
// the two paths stay interchangeable on messy files.  Returns rows parsed,
// or -(line_number + 1) on a malformed line (offset keeps line 1 distinct
// from the callers' -1 I/O sentinel).
long parse_buffer(char* buf, double* out, long max_rows, int min_cols) {
  long rows = 0;
  long line_no = 0;
  char* p = buf;
  while (*p) {
    ++line_no;
    // Find end of line.
    char* eol = std::strchr(p, '\n');
    char* line_end = eol ? eol : p + std::strlen(p);
    char saved = *line_end;
    *line_end = '\0';

    // Skip leading whitespace; allow blank lines and '#'/'%' comments.
    char* q = p;
    while (*q == ' ' || *q == '\t' || *q == '\r') ++q;
    if (*q != '\0' && *q != '#' && *q != '%') {
      double vals[4] = {0, 0, 0, 0};
      int col = 0;
      char* cur = q;
      while (*cur) {
        double v;
        if (!parse_number(&cur, &v)) break;  // no more numbers on this line
        if (col < 4) vals[col] = v;
        ++col;
        if (*cur && *cur != ' ' && *cur != '\t' && *cur != '\r' && *cur != ',')
          break;  // glued junk: keep the parsed prefix, stop this line
        while (*cur == ' ' || *cur == '\t' || *cur == '\r' || *cur == ',') ++cur;
      }
      if (col < min_cols) {
        *line_end = saved;
        return -(line_no + 1);
      }
      if (rows < max_rows) {
        double* r = out + rows * 4;
        r[0] = vals[0];
        r[1] = vals[1];
        r[2] = vals[2];
        r[3] = vals[3];
      }
      ++rows;
    }

    *line_end = saved;
    if (!eol) break;
    p = eol + 1;
  }
  return rows;
}

}  // namespace

extern "C" {

// Count data rows (cheap upper bound: newline count + 1).  Returns -1 on I/O
// error.  Callers allocate count*4 doubles and call mmtraj_parse.
long mmtraj_count_rows(const char* path) {
  long size = 0;
  char* buf = read_file(path, &size);
  if (!buf) return -1;
  long lines = 1;
  for (long i = 0; i < size; ++i)
    if (buf[i] == '\n') ++lines;
  std::free(buf);
  return lines;
}

// Parse the file into out[max_rows * 4].  Returns rows parsed (<= max_rows
// used), -1 on I/O error, or -(line_no + 1) for a malformed line.
long mmtraj_parse(const char* path, double* out, long max_rows, int min_cols) {
  long size = 0;
  char* buf = read_file(path, &size);
  if (!buf) return -1;
  long rows = parse_buffer(buf, out, max_rows, min_cols);
  std::free(buf);
  return rows;
}

}  // extern "C"
