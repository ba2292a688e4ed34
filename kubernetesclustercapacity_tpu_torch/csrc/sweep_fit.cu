// Fused capacity-sweep kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel kubernetesclustercapacity_tpu/ops/pallas_fit.py::
// _make_sweep_kernel (row math in _fit_row, _fit_row_rcp, _rcp_div and
// _epilogue).  It computes the same function, not the same tiles: for each
// scenario s, totals[s] = sum over nodes n of
//
//     fit   = min((ac - uc) / cr, (am - um) / mr)      0 where alloc <= used
//     fit   = reference: fit >= ap ? ap - pc : fit      (may be negative)
//             strict:    max(min(fit, max(ap - pc, 0)), 0)
//     fit  *= mask[n]   (0/1, optional)
//     fit  *= counts[n] (node-shape group multiplicity, optional)
//
// with memory in KiB and every value int32 (the host proves the inputs
// eligible first: fused_fit.fast_sweep_eligible).  The rcp variants replace
// both divides by floor(min(hc * (1/cr), hm * (1/mr))) in f32 plus one
// combined +-1 integer fixup; that is exact only under
// fused_fit.rcp_division_eligible, with correctly rounded f32 steps and the
// reciprocals from fused_fit.scenario_reciprocals (f64 divide, then f32) —
// hence __int2float_rn / __fmul_rn here and no fast-math or FTZ flags in
// the build.  int32 arithmetic wraps (through uint32), as it does in XLA and
// in the plain PyTorch version.
//
// What bounds it on the H100: instruction issue.  The function needs 5-7
// operations per (scenario, node) cell once per-node terms are hoisted
// (two quotients, a min, the epilogue, the count multiply, the
// accumulate), and this kernel issues several times that: it recomputes
// the headrooms per cell, the rcp variants add float converts and the
// fixup, and the others' two int32 divides are multi-instruction software
// routines.  Against that, the node columns are a few hundred KB, so at
// 10k nodes x 1k scenarios the bytes take well under a microsecond and the
// operations microseconds.  The design keeps every cell's operands in
// registers or broadcast shared memory and never writes the [S, N] fit
// matrix:
//
// * one thread owns one scenario: cr, mr (and the reciprocals) live in
//   registers for the whole block;
// * blockIdx.x walks blocks of kThreads scenarios, blockIdx.y walks node
//   chunks sized by the wrapper so the grid fills every SM several times;
// * a block stages its chunk's node columns through shared memory, kTile
//   nodes at a time; all threads read the same node at once (a broadcast,
//   no bank conflicts);
// * each thread accumulates its total in an int64 register and ends with
//   one atomicAdd into totals[s] (zeroed by the wrapper).  The sums are
//   integers, so their order cannot change the result.
//
// Wider per-thread tiles, 16-byte loads and persistent blocks are left for
// later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // scenarios per block
constexpr int kTile = 256;     // nodes staged in shared memory per step

struct Params {
  const int32_t* __restrict__ ac;
  const int32_t* __restrict__ am;
  const int32_t* __restrict__ ap;
  const int32_t* __restrict__ uc;
  const int32_t* __restrict__ um;
  const int32_t* __restrict__ pc;
  const int32_t* __restrict__ mask;
  const int32_t* __restrict__ counts;
  const int32_t* __restrict__ cr;
  const int32_t* __restrict__ mr;
  const float* __restrict__ crr;
  const float* __restrict__ mrr;
  long long* __restrict__ totals;
  long long n;
  int s;
  long long chunk;
};

// Wrapping int32 arithmetic (two's complement, like XLA and torch).
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

// _fit_row: the int32 divide.  C's "/" truncates, and agrees with "//"
// because the dividend is >= 0 wherever the quotient is used.
__device__ __forceinline__ int32_t fit_div(int32_t ac, int32_t am, int32_t uc,
                                           int32_t um, int32_t cr,
                                           int32_t mr) {
  const int32_t cpu_fit = ac <= uc ? 0 : wsub(ac, uc) / cr;
  const int32_t mem_fit = am <= um ? 0 : wsub(am, um) / mr;
  return min(cpu_fit, mem_fit);
}

// _fit_row_rcp: one floor of the f32 min and ONE combined fixup.
__device__ __forceinline__ int32_t fit_rcp(int32_t ac, int32_t am, int32_t uc,
                                           int32_t um, int32_t cr, int32_t mr,
                                           float crr, float mrr) {
  const int32_t hc = max(wsub(ac, uc), 0);
  const int32_t hm = max(wsub(am, um), 0);
  const float est = fminf(__fmul_rn(__int2float_rn(hc), crr),
                          __fmul_rn(__int2float_rn(hm), mrr));
  const int32_t f = static_cast<int32_t>(floorf(est));
  const int32_t r1 = wsub(hc, wmul(f, cr));
  const int32_t r2 = wsub(hm, wmul(f, mr));
  const int32_t up = (r1 >= cr) & (r2 >= mr);
  const int32_t down = (r1 < 0) | (r2 < 0);
  return wsub(wadd(f, up), down);
}

// _epilogue: reference Q1 overwrite, or the strict clamp.
template <bool STRICT>
__device__ __forceinline__ int32_t epilogue(int32_t fit, int32_t ap,
                                            int32_t pc) {
  if constexpr (STRICT) {
    const int32_t slots = max(wsub(ap, pc), 0);
    return max(min(fit, slots), 0);
  } else {
    return fit >= ap ? wsub(ap, pc) : fit;
  }
}

template <bool RCP, bool STRICT, bool MASK, bool COUNTS>
__global__ void __launch_bounds__(kThreads) sweep_fit_kernel(const Params p) {
  constexpr int kMaskCol = 6;
  constexpr int kCountCol = MASK ? 7 : 6;
  constexpr int kCols = 6 + (MASK ? 1 : 0) + (COUNTS ? 1 : 0);
  __shared__ int32_t tile[kCols][kTile];

  const int sidx = blockIdx.x * kThreads + threadIdx.x;
  const bool active = sidx < p.s;
  int32_t cr = 1, mr = 1;
  float crr = 1.0f, mrr = 1.0f;
  if (active) {
    cr = p.cr[sidx];
    mr = p.mr[sidx];
    if constexpr (RCP) {
      crr = p.crr[sidx];
      mrr = p.mrr[sidx];
    }
  }

  const long long begin = static_cast<long long>(blockIdx.y) * p.chunk;
  const long long end = min(begin + p.chunk, p.n);
  long long acc = 0;
  for (long long base = begin; base < end; base += kTile) {
    const int len = static_cast<int>(min(static_cast<long long>(kTile),
                                         end - base));
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const long long g = base + i;
      tile[0][i] = p.ac[g];
      tile[1][i] = p.am[g];
      tile[2][i] = p.ap[g];
      tile[3][i] = p.uc[g];
      tile[4][i] = p.um[g];
      tile[5][i] = p.pc[g];
      if constexpr (MASK) tile[kMaskCol][i] = p.mask[g];
      if constexpr (COUNTS) tile[kCountCol][i] = p.counts[g];
    }
    __syncthreads();
    if (active) {
      for (int i = 0; i < len; ++i) {
        int32_t fit;
        if constexpr (RCP) {
          fit = fit_rcp(tile[0][i], tile[1][i], tile[3][i], tile[4][i], cr,
                        mr, crr, mrr);
        } else {
          fit = fit_div(tile[0][i], tile[1][i], tile[3][i], tile[4][i], cr,
                        mr);
        }
        fit = epilogue<STRICT>(fit, tile[2][i], tile[5][i]);
        if constexpr (MASK) fit = wmul(fit, tile[kMaskCol][i]);
        if constexpr (COUNTS) fit = wmul(fit, tile[kCountCol][i]);
        acc += fit;
      }
    }
  }
  if (active && acc != 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p.totals + sidx),
              static_cast<unsigned long long>(acc));
  }
}

template <bool RCP, bool STRICT, bool MASK, bool COUNTS>
void launch(const Params& p, dim3 grid, cudaStream_t stream) {
  sweep_fit_kernel<RCP, STRICT, MASK, COUNTS><<<grid, kThreads, 0, stream>>>(p);
}

}  // namespace

// Launches one sweep on `stream`, on the calling thread's current device
// (the one that holds the pointers).  Null mask / counts select the
// variants without them; null reciprocals select the int32-divide
// variants.  `totals` must be zeroed.  Returns the cudaError_t of the
// launch (0 on success); it never synchronises.
extern "C" int kccap_sweep_fit(
    const int32_t* ac, const int32_t* am, const int32_t* ap,
    const int32_t* uc, const int32_t* um, const int32_t* pc,
    const int32_t* mask, const int32_t* counts,
    const int32_t* cr, const int32_t* mr,
    const float* crr, const float* mrr,
    long long* totals,
    long long n, int s, long long chunk, int strict, void* stream) {
  if (n <= 0 || s <= 0 || chunk <= 0 || (crr == nullptr) != (mrr == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = (n + chunk - 1) / chunk;
  if (chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{ac, am, ap, uc, um, pc, mask, counts, cr, mr,
                 crr, mrr, totals, n, s, chunk};
  const dim3 grid((s + kThreads - 1) / kThreads,
                  static_cast<unsigned>(chunks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int variant = ((crr != nullptr) << 3) | ((strict != 0) << 2) |
                      ((mask != nullptr) << 1) | (counts != nullptr);
  switch (variant) {
#define KCCAP_CASE(V)                                                   \
  case V:                                                               \
    launch<((V) & 8) != 0, ((V) & 4) != 0, ((V) & 2) != 0, ((V) & 1) != 0>( \
        p, grid, st);                                                   \
    break;
    KCCAP_CASE(0) KCCAP_CASE(1) KCCAP_CASE(2) KCCAP_CASE(3)
    KCCAP_CASE(4) KCCAP_CASE(5) KCCAP_CASE(6) KCCAP_CASE(7)
    KCCAP_CASE(8) KCCAP_CASE(9) KCCAP_CASE(10) KCCAP_CASE(11)
    KCCAP_CASE(12) KCCAP_CASE(13) KCCAP_CASE(14) KCCAP_CASE(15)
#undef KCCAP_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
