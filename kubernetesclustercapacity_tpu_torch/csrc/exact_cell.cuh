// The exact int64 sweep's per-node and per-cell functions, shared by the
// kernels that run its cells: sweep_exact.cu (the totals) and
// sweep_spread.cu (the totals summed by topology domain).  The rule they
// compute is set out at the top of sweep_exact.cu.
//
// Without __CUDACC__ they compile as host C++, so a machine without the
// CUDA toolkit can hold them against the plain version.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define KCCAP_HD __host__ __device__ __forceinline__
#else
#define KCCAP_HD inline
#endif

namespace kccap_exact {

using u64 = unsigned long long;
using i64 = long long;

// Wrapping int64 arithmetic, through unsigned (C++ leaves signed overflow
// undefined; torch, XLA and Go wrap).
KCCAP_HD i64 wadd(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) + static_cast<u64>(b));
}
KCCAP_HD i64 wsub(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) - static_cast<u64>(b));
}
KCCAP_HD i64 wmul(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) * static_cast<u64>(b));
}

// One staged node: the terms every cell of the node shares.
struct alignas(16) Node {
  u64 hc;     // alloc_cpu - used_cpu, 0 where alloc_cpu <=u used_cpu
  i64 hm;     // alloc_mem - used_mem (wrapped), 0 where alloc_mem <= used_mem
  i64 e0;     // reference: ap; strict: max(ap - pc, 0)
  i64 e1;     // reference: ap - pc (wrapped); strict: 0
  i64 count;  // the node's multiplicity, 1 without counts
};

template <bool STRICT>
KCCAP_HD Node stage_node(i64 ac, i64 am, i64 ap, i64 uc, i64 um, i64 pc,
                         i64 count) {
  Node r;
  const u64 uac = static_cast<u64>(ac), uuc = static_cast<u64>(uc);
  r.hc = uac <= uuc ? 0ull : uac - uuc;
  r.hm = am <= um ? 0 : wsub(am, um);
  const i64 apc = wsub(ap, pc);
  if constexpr (STRICT) {
    r.e0 = apc > 0 ? apc : 0;
    r.e1 = 0;
  } else {
    r.e0 = ap;
    r.e1 = apc;
  }
  r.count = count;
  return r;
}

// One scenario's divisors: a request of 0 divides by 1.
struct Divisors {
  u64 cpu;
  i64 mem;
};

KCCAP_HD Divisors stage_divisors(i64 cr, i64 mr) {
  return {cr == 0 ? 1ull : static_cast<u64>(cr), mr == 0 ? 1 : mr};
}

// The fit of one cell after the mode epilogue (the mask and the count are
// the caller's).
template <bool STRICT>
KCCAP_HD i64 cell_fit(const Node& r, const Divisors& d) {
  const i64 cpu = static_cast<i64>(r.hc / d.cpu);
  // C's "/" truncates as Go's does; of all quotients only INT64_MIN / -1
  // overflows, and Go's is the wrapping negation, INT64_MIN.
  const i64 mem = d.mem == -1 ? wsub(0, r.hm) : r.hm / d.mem;
  i64 f = cpu < mem ? cpu : mem;
  if constexpr (STRICT) {
    f = f < r.e0 ? f : r.e0;
    f = f > 0 ? f : 0;
  } else {
    f = f >= r.e0 ? r.e1 : f;
  }
  return f;
}

}  // namespace kccap_exact
