// Native CPU backend: quantity codecs + the sequential capacity-fit kernel.
//
// This is the framework's compiled "CPU reference path" — the same role the
// reference's Go binary plays (a compiled sequential implementation of the
// per-node loop at src/KubeAPI/ClusterCapacity.go:105-140), exposed through a
// C ABI for ctypes.  Semantics notes:
//
//  * Go-style arithmetic: uint64 compare/divide for CPU, two's-complement
//    wrap-around int64 subtraction for memory (computed via unsigned casts —
//    signed overflow is UB in C++), truncating division (C++ native).
//  * kcc_cpu_to_milli mirrors convertCPUToMilis (ClusterCapacity.go:301-319):
//    Go Atoi acceptance (sign + ASCII digits, int64 range), failure -> 0,
//    uint64 wrap on the x1000.
//  * kcc_to_bytes mirrors bytefmt.ToBytes (bytes.go:75-105): trim + upper,
//    split at first (ASCII) letter, all-base-2 suffix table with the GI/TI
//    gap, value <= 0 or no suffix -> error, int64 truncation with the
//    amd64 out-of-range convention (INT64_MIN), underscore digit
//    separators accepted between digits (Go 1.13+/Python float()).
//    The whitespace trim is Go's exact TrimSpace set (Unicode
//    White_Space, UTF-8 aware — go_space_len below), matching the Python
//    codec's _GO_SPACE_CHARS.  Divergences (documented, same as the
//    Python codec): inf/nan/hex spellings are rejected; only ASCII
//    letters split the suffix.
//  * kcc_fit_arrays / kcc_sweep: mode 0 = reference (conditional pod-cap
//    overwrite, may go negative), mode 1 = strict (3-way min, clamp at 0,
//    healthy mask).  A zero divisor reached behind a positive headroom
//    returns an error code exactly where the reference would panic.
//
// The sweep is parallelized over scenarios with std::thread — the native
// analog of the TPU kernel's vmap axis — so CPU-vs-TPU comparisons are fair.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <locale.h>
#include <string>
#include <thread>
#include <vector>

extern "C" {

static const uint64_t KIB = 1024ull;
static const uint64_t MIB = KIB * 1024;
static const uint64_t GIB = MIB * 1024;
static const uint64_t TIB = GIB * 1024;

// Go strconv.Atoi acceptance: optional sign, 1+ ASCII digits, int64 range.
// Returns 1 on success.
static int go_atoi(const char* s, size_t len, int64_t* out) {
  if (len == 0) return 0;
  size_t i = 0;
  int neg = 0;
  if (s[0] == '+' || s[0] == '-') {
    neg = s[0] == '-';
    i = 1;
  }
  if (i == len) return 0;
  uint64_t acc = 0;
  const uint64_t limit = neg ? 0x8000000000000000ull : 0x7fffffffffffffffull;
  for (; i < len; i++) {
    if (s[i] < '0' || s[i] > '9') return 0;
    uint64_t d = (uint64_t)(s[i] - '0');
    if (acc > (limit - d) / 10) return 0;  // overflow -> range error
    acc = acc * 10 + d;
  }
  // Negate in unsigned space: acc may be 2^63 (INT64_MIN's magnitude) and
  // signed negation of INT64_MIN would be UB.
  *out = neg ? (int64_t)(0ull - acc) : (int64_t)acc;
  return 1;
}

// convertCPUToMilis semantics; returns the uint64 bit pattern.  Length is
// explicit so embedded NUL bytes parse exactly like the Python codec
// (which would reject the full string) instead of silently truncating.
uint64_t kcc_cpu_to_milli_n(const char* cpu, int64_t len_in) {
  size_t len = (size_t)len_in;
  int has_m = len > 0 && cpu[len - 1] == 'm';
  if (has_m) len--;
  int64_t v;
  if (!go_atoi(cpu, len, &v)) return 0;
  uint64_t u = (uint64_t)v;
  if (!has_m) u *= 1000ull;  // wraps mod 2^64 like Go
  return u;
}


// bytefmt.ToBytes semantics; returns 0 and stores into *out on success,
// -1 on the reference's invalid-byte-quantity error.
// Byte length of one Go-White_Space rune at s[i..e) in UTF-8, else 0 —
// the exact set Go's strings.TrimSpace trims (unicode.IsSpace ==
// White_Space: ASCII \t\n\v\f\r space, U+0085, U+00A0, U+1680,
// U+2000-200A, U+2028, U+2029, U+202F, U+205F, U+3000).  C isspace()
// was wrong in both directions: it misses every non-ASCII space and the
// multi-byte checks below can never false-match mid-rune (space runes
// start with 0xC2/0xE1/0xE2/0xE3, never a continuation byte).
static size_t go_space_len(const std::string& s, size_t i, size_t e) {
  unsigned char c0 = (unsigned char)s[i];
  if (c0 == 0x09 || c0 == 0x0a || c0 == 0x0b || c0 == 0x0c ||
      c0 == 0x0d || c0 == 0x20)
    return 1;
  if (i + 1 < e && c0 == 0xC2) {
    unsigned char c1 = (unsigned char)s[i + 1];
    if (c1 == 0x85 || c1 == 0xA0) return 2;  // U+0085, U+00A0
  }
  if (i + 2 < e) {
    unsigned char c1 = (unsigned char)s[i + 1];
    unsigned char c2 = (unsigned char)s[i + 2];
    if (c0 == 0xE1 && c1 == 0x9A && c2 == 0x80) return 3;  // U+1680
    if (c0 == 0xE2 && c1 == 0x80 &&
        ((c2 >= 0x80 && c2 <= 0x8A) ||  // U+2000-200A
         c2 == 0xA8 || c2 == 0xA9 ||    // U+2028, U+2029
         c2 == 0xAF))                   // U+202F
      return 3;
    if (c0 == 0xE2 && c1 == 0x81 && c2 == 0x9F) return 3;  // U+205F
    if (c0 == 0xE3 && c1 == 0x80 && c2 == 0x80) return 3;  // U+3000
  }
  return 0;
}

int kcc_to_bytes_n(const char* s_in, int64_t len_in, int64_t* out) {
  std::string s(s_in, (size_t)len_in);
  // Go strings.TrimSpace (White_Space runes, UTF-8 aware) + ToUpper.
  size_t b = 0, e = s.size();
  for (size_t l; b < e && (l = go_space_len(s, b, e)) > 0;) b += l;
  for (bool more = true; more && e > b;) {
    more = false;
    for (size_t l = 1; l <= 3 && l <= e - b; l++) {
      if (go_space_len(s, e - l, e) == l) {
        e -= l;
        more = true;
        break;
      }
    }
  }
  s = s.substr(b, e - b);
  for (auto& c : s) c = (char)toupper((unsigned char)c);

  size_t li = std::string::npos;
  for (size_t i = 0; i < s.size(); i++) {
    if (isalpha((unsigned char)s[i])) {
      li = i;
      break;
    }
  }
  if (li == std::string::npos) return -1;

  std::string num = s.substr(0, li), suffix = s.substr(li);
  if (num.empty()) return -1;
  // Underscore digit separators: both Go ParseFloat and Python float()
  // accept them, but only BETWEEN digits ("1_5" ok, "_1"/"1_"/"1_.5"
  // rejected).  Validate, then strip for strtod (which knows nothing of
  // them).  Everything else strtod might creatively accept (whitespace,
  // inf/nan/hex — the suffix split already took the first letter) is
  // rejected by the char filter.
  std::string cleaned;
  cleaned.reserve(num.size());
  for (size_t i = 0; i < num.size(); i++) {
    char c = num[i];
    if (c == '_') {
      if (i == 0 || i + 1 >= num.size() ||
          !isdigit((unsigned char)num[i - 1]) ||
          !isdigit((unsigned char)num[i + 1]))
        return -1;
      continue;  // valid separator: drop it
    }
    if (!(isdigit((unsigned char)c) || c == '.' || c == '+' || c == '-'))
      return -1;
    cleaned.push_back(c);
  }
  // Locale-independent parse: the embedding process may have called
  // setlocale (GUI toolkits do), and strtod honors LC_NUMERIC's decimal
  // point — Go/Python semantics never do.
  static locale_t c_loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  char* endp = nullptr;
  double v = c_loc != (locale_t)0
                 ? strtod_l(cleaned.c_str(), &endp, c_loc)
                 : strtod(cleaned.c_str(), &endp);
  if (endp != cleaned.c_str() + cleaned.size()) return -1;
  // Overflow-to-infinity is Go's ErrRange -> the reference's error path.
  if (!std::isfinite(v)) return -1;
  if (!(v > 0)) return -1;  // <= 0 (or NaN) -> error (bytes.go:87-89)

  uint64_t mult;
  if (suffix == "T" || suffix == "TB" || suffix == "TIB") mult = TIB;
  else if (suffix == "G" || suffix == "GB" || suffix == "GIB") mult = GIB;
  else if (suffix == "M" || suffix == "MB" || suffix == "MIB" || suffix == "MI") mult = MIB;
  else if (suffix == "K" || suffix == "KB" || suffix == "KIB" || suffix == "KI") mult = KIB;
  else if (suffix == "B") mult = 1;
  else return -1;

  double scaled = v * (double)mult;
  // Go int64(float64) out of range: amd64/arm64 produce INT64_MIN.
  if (!(scaled < 9.223372036854775807e18) || scaled < -9.223372036854775808e18)
    *out = INT64_MIN;
  else
    *out = (int64_t)scaled;
  return 0;
}


// One node's fit, Go semantics.  Returns 0 ok, -1 divide-by-zero "panic".
static int fit_one(int64_t alloc_cpu, int64_t alloc_mem, int64_t alloc_pods,
                   int64_t used_cpu, int64_t used_mem, int64_t pods_count,
                   uint8_t healthy, int64_t cpu_req, int64_t mem_req,
                   int mode, int64_t* out) {
  uint64_t ac = (uint64_t)alloc_cpu, uc = (uint64_t)used_cpu;
  uint64_t cr = (uint64_t)cpu_req;
  int64_t cpu_fit;
  if (ac <= uc) {
    cpu_fit = 0;
  } else {
    if (cr == 0) return -1;  // ClusterCapacity.go:123 panic
    cpu_fit = (int64_t)((ac - uc) / cr);
  }
  int64_t mem_fit;
  if (alloc_mem <= used_mem) {
    mem_fit = 0;
  } else {
    if (mem_req == 0) return -1;  // :129 panic
    // Wrap-around subtraction via unsigned cast; C++ '/' truncates like
    // Go.  INT64_MIN / -1 is UB in C++ (SIGFPE on x86-64) but defined in
    // Go (wraps to INT64_MIN); negate through unsigned space instead.
    int64_t head = (int64_t)((uint64_t)alloc_mem - (uint64_t)used_mem);
    mem_fit = mem_req == -1 ? (int64_t)(0ull - (uint64_t)head)
                            : head / mem_req;
  }
  int64_t fit = cpu_fit <= mem_fit ? cpu_fit : mem_fit;  // findMin :159-164
  // Subtractions wrap through unsigned space: Go wraps, C++ signed
  // overflow is UB.
  if (mode == 0) {  // reference: conditional overwrite (:134-136)
    if (fit >= alloc_pods)
      fit = (int64_t)((uint64_t)alloc_pods - (uint64_t)pods_count);
  } else {  // strict: 3-way min, clamp, health mask
    int64_t slots = (int64_t)((uint64_t)alloc_pods - (uint64_t)pods_count);
    if (slots < 0) slots = 0;
    if (fit > slots) fit = slots;
    if (fit < 0) fit = 0;
    if (!healthy) fit = 0;
  }
  *out = fit;
  return 0;
}

// Sequential per-node fits for one scenario.  healthy may be NULL (all 1).
int kcc_fit_arrays(int64_t n, const int64_t* alloc_cpu,
                   const int64_t* alloc_mem, const int64_t* alloc_pods,
                   const int64_t* used_cpu, const int64_t* used_mem,
                   const int64_t* pods_count, const uint8_t* healthy,
                   int64_t cpu_req, int64_t mem_req, int mode,
                   int64_t* fits_out) {
  for (int64_t i = 0; i < n; i++) {
    if (fit_one(alloc_cpu[i], alloc_mem[i], alloc_pods[i], used_cpu[i],
                used_mem[i], pods_count[i], healthy ? healthy[i] : 1,
                cpu_req, mem_req, mode, &fits_out[i]) != 0)
      return -1;
  }
  return 0;
}

// Multi-threaded scenario sweep: totals[s] = sum_n fit(n, s).
// Returns 0 ok, -1 if any scenario hit a zero divisor.
int kcc_sweep(int64_t n, int64_t s, const int64_t* alloc_cpu,
              const int64_t* alloc_mem, const int64_t* alloc_pods,
              const int64_t* used_cpu, const int64_t* used_mem,
              const int64_t* pods_count, const uint8_t* healthy,
              const int64_t* cpu_reqs, const int64_t* mem_reqs, int mode,
              int n_threads, int64_t* totals_out) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  if ((int64_t)n_threads > s) n_threads = (int)(s > 0 ? s : 1);

  std::vector<int> errs((size_t)n_threads, 0);
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      for (int64_t j = t; j < s; j += n_threads) {
        int64_t total = 0, fit = 0;
        for (int64_t i = 0; i < n; i++) {
          if (fit_one(alloc_cpu[i], alloc_mem[i], alloc_pods[i], used_cpu[i],
                      used_mem[i], pods_count[i], healthy ? healthy[i] : 1,
                      cpu_reqs[j], mem_reqs[j], mode, &fit) != 0) {
            errs[(size_t)t] = 1;
            return;
          }
          // Running sum wraps like Go's int accumulator, not UB.
          total = (int64_t)((uint64_t)total + (uint64_t)fit);
        }
        totals_out[j] = total;
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int e : errs)
    if (e) return -1;
  return 0;
}

}  // extern "C"
