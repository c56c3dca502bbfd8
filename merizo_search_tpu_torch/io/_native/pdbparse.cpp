// Native CA-record PDB parser for the createdb/search path (the port's copy).
//
// Semantics mirror io/pdb.py::read_ca's numpy path exactly (itself a parity
// port of the reference's programs/Foldclass/utils.py:42-72 read_pdb): plain
// ATOM records, atom-name columns 12..15 == " CA ", chain character at
// column 21, coordinates in columns 30..53, residue name columns 17..19
// mapped to one-letter (unknown -> 'X'). Lines are treated as space-padded
// to 80 columns, truncated records included (missing fields read as 0.0 /
// 'X'). No altloc handling, no model split.
//
// The numpy reader builds a line matrix per file; this scan reads the bytes
// once. It is bound with ctypes, and the call releases the GIL, so
// createdb's parser thread pool scales across cores.

#include <cstdint>
#include <cstring>

namespace {

// residue three-letter -> one-letter map, exact copy of
// utils/residues.py::THREE_TO_ONE (unknown -> 'X')
struct Map3 {
  const char* three;
  char one;
};
constexpr Map3 kMap[] = {
    {"ALA", 'A'}, {"CYS", 'C'}, {"ASP", 'D'}, {"GLU", 'E'}, {"PHE", 'F'},
    {"GLY", 'G'}, {"HIS", 'H'}, {"ILE", 'I'}, {"LYS", 'K'}, {"LEU", 'L'},
    {"MET", 'M'}, {"ASN", 'N'}, {"PRO", 'P'}, {"GLN", 'Q'}, {"ARG", 'R'},
    {"SER", 'S'}, {"THR", 'T'}, {"VAL", 'V'}, {"TRP", 'W'}, {"TYR", 'Y'},
    {"UNK", 'X'}, {"ASH", 'D'}, {"GLH", 'E'}, {"HID", 'H'}, {"HIE", 'H'},
    {"HIP", 'H'}, {"HSD", 'H'}, {"HSE", 'H'}, {"LYN", 'K'},
};

inline char map_resn(const char* p) {
  // p points at line column 17 (3 chars, space padded); python strips both
  // sides before the dict lookup
  char t[4] = {' ', ' ', ' ', 0};
  int n = 0;
  for (int i = 0; i < 3; i++) {
    char c = p[i];
    if (c != ' ') t[n++] = c;
    else if (n) break;  // trailing space ends the token
  }
  t[n] = 0;
  for (const auto& m : kMap)
    if (t[0] == m.three[0] && t[1] == m.three[1] && t[2] == m.three[2] &&
        n == 3)
      return m.one;
  return 'X';
}

// parse a fixed-width (8-col) float field: optional spaces, sign, digits,
// dot, digits — matches numpy's float() on the stripped slice; returns 0.0
// for an all-space field (numpy path: empty string -> 0.0)
inline double parse_f8(const char* p, int width) {
  int i = 0;
  while (i < width && p[i] == ' ') i++;
  if (i == width) return 0.0;
  bool neg = false;
  if (p[i] == '-') { neg = true; i++; }
  else if (p[i] == '+') { i++; }
  double v = 0.0;
  for (; i < width && p[i] >= '0' && p[i] <= '9'; i++)
    v = v * 10.0 + (p[i] - '0');
  if (i < width && p[i] == '.') {
    i++;
    double scale = 0.1;
    for (; i < width && p[i] >= '0' && p[i] <= '9'; i++, scale *= 0.1)
      v += (p[i] - '0') * scale;
  }
  return neg ? -v : v;
}

}  // namespace

extern "C" {

// Scan `buf[0:len)` for CA records of `chain`. Writes up to `cap` residues
// into coords [cap*3] f32 and seq [cap] chars. Returns the number of CA
// records found (may exceed cap — caller must check; only cap are written).
int parse_ca(const char* buf, int64_t len, char chain, float* coords,
             char* seq, int cap) {
  int count = 0;
  int64_t pos = 0;
  while (pos < len) {
    // find end of line
    const char* nl = static_cast<const char*>(
        memchr(buf + pos, '\n', static_cast<size_t>(len - pos)));
    int64_t ll = nl ? (nl - (buf + pos)) : (len - pos);
    const char* line = buf + pos;
    pos += ll + 1;
    if (ll > 0 && line[ll - 1] == '\r') ll--;  // splitlines() semantics
    // the numpy path space-pads every line to 80 columns before slicing
    // fixed fields (missing float fields parse as 0.0) — replicate that
    // for truncated records instead of dropping them, so both parsers
    // yield identical residue sets on malformed files
    char padded[80];
    if (ll < 54) {
      if (ll < 4) continue;  // cannot hold "ATOM"
      memcpy(padded, line, static_cast<size_t>(ll));
      memset(padded + ll, ' ', sizeof(padded) - static_cast<size_t>(ll));
      line = padded;
    }
    if (!(line[0] == 'A' && line[1] == 'T' && line[2] == 'O' &&
          line[3] == 'M'))
      continue;
    if (!(line[12] == ' ' && line[13] == 'C' && line[14] == 'A' &&
          line[15] == ' '))
      continue;
    if (line[21] != chain) continue;
    if (count < cap) {
      coords[count * 3 + 0] = static_cast<float>(parse_f8(line + 30, 8));
      coords[count * 3 + 1] = static_cast<float>(parse_f8(line + 38, 8));
      coords[count * 3 + 2] = static_cast<float>(parse_f8(line + 46, 8));
      seq[count] = map_resn(line + 17);
    }
    count++;
  }
  return count;
}

}  // extern "C"
