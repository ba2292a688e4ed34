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
// eligible first: fused_fit.fast_sweep_eligible).  int32 arithmetic wraps
// (through uint32), as it does in XLA and in the plain PyTorch version.
// Every variant divides the clamped headrooms hc = max(ac - uc, 0) and
// hm = max(am - um, 0): where alloc <= used the quotient of 0 is the
// select's 0, and elsewhere C's truncating "/" equals the floored "//".
//
// The rcp variants, exact under fused_fit.rcp_division_eligible (quotients
// <= 2^20, divisors <= 2^29) with the reciprocals from
// fused_fit.scenario_reciprocals (f64 divide, then f32), take one estimate
// m = min(RN(hcf * crr), RN(hmf * mrr)), hcf = RN(hc) and hmf = RN(hm)
// staged per node.  Each product lies within 3 * 2^-24 * (2^20 + 1) < 0.19
// of its real quotient, so m lies within 0.19 of min(hc / cr, hm / mr)
// (min is 1-Lipschitz), and as floor(min) = min(floor), RN(m) is the fit M
// or M + 1.  RN(m) < 2^22, so the bits of m + 0x1.8p23 minus 0x4B400000 are
// RN(m) as an int32, with no conversion instruction.  RN(m) = M + 1 exactly
// when hc - RN(m) * cr or hm - RN(m) * mr is negative, so the sign of their
// OR is the whole fixup.  (The JAX kernel floors m and fixes up on both
// sides; under the same proof both give M.)  True rems lie in (-cr, hc] and
// (-mr, hm], so the wrapping int32 products give them exactly.  The steps
// stay __fmul_rn / __fadd_rn, and the build keeps -fmad=false and no
// fast-math or FTZ flags: a contracted FMA would round once, not twice.
//
// What bounds it on the H100: instruction issue, with the ALU pipe (16
// lanes per SM sub-partition, half the FP32 pipe's) close behind.  The
// per-cell loop of the rcp/reference form issues about 15 instructions per
// cell (cuobjdump -sass; chip_smoke.py prints the counts): two FMULs, an
// FMNMX, the magic add (FADD) and its subtraction, two IMADs for the rems,
// their OR, the sign fixup (LEA.HI), the epilogue's compare and select, the
// sign-extended int64 accumulate and one shared load.  About 7 of them are
// ALU instructions (5 in the strict form, whose fits are >= 0 and add
// without a sign extension), and none is an I2F, F2I or FRND: every
// conversion runs once per node per block, at staging.  Besides the cells,
// a launch pays a fixed time (the scenario loads, the staging, and the
// launch itself) that a sweep whose nodes are all masked out measures.  The
// node columns are a few hundred KB, so at 10k nodes x 1k scenarios the
// bytes take well under a microsecond.  The design keeps every cell's
// operands in registers or broadcast shared memory and never writes the
// [S, N] fit matrix:
//
// * a thread owns kSpt scenarios, their requests (and reciprocals) in
//   registers for the whole block, so one shared load of a node serves
//   kSpt cells; blockIdx.x walks blocks of kThreads * kSpt scenarios,
//   blockIdx.y walks node chunks sized by the wrapper (node_chunk) so the
//   grid fills every SM several times;
// * a block stages its chunk into shared memory as one 16-byte-aligned
//   record per node of the terms every cell of that node shares: the two
//   headrooms, their floats (rcp), the epilogue's terms (strict: the free
//   slots max(ap - pc, 0); reference: ap and ap - pc) and the count.  All
//   threads read the same record at once (a broadcast);
// * a node whose mask or count is 0 adds 0 to every total in every variant,
//   so the staging leaves it out: a warp ballot compacts the live nodes,
//   and the tail of a chunk, or a tile with no live node, stages nothing;
// * each thread accumulates its totals in int64 registers and ends with
//   one atomicAdd each into totals[s] (zeroed by the wrapper).  The sums
//   are integers, so their order cannot change the result.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// kThreads and kSpt are fused_fit.THREADS_PER_BLOCK and SCENARIOS_PER_THREAD.
constexpr int kThreads = 128;          // threads per block
constexpr int kSpt = 2;                // scenarios per thread
constexpr int kMaxRecords = 1024;      // node records staged per tile at most
constexpr int kSmemBytes = 48 * 1024;  // shared memory without an opt-in

// RN(m) for 0 <= m < 2^22: the low bits of m + 0x1.8p23 (see the header).
constexpr float kMagic = 12582912.0f;       // 0x1.8p23
constexpr int32_t kMagicBits = 0x4B400000;  // its bit pattern

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

// One staged node: hc, hm, then hcf, hmf (rcp), then the epilogue's terms
// (strict: slots; reference: ap, ap - pc), then the count, padded to whole
// 16-byte words.
template <bool RCP, bool STRICT, bool COUNTS>
struct Record {
  static constexpr int kEpi = RCP ? 4 : 2;
  static constexpr int kCount = kEpi + (STRICT ? 1 : 2);
  static constexpr int kWords = (kCount + (COUNTS ? 1 : 0) + 3) / 4 * 4;
  static constexpr int kVecs = kWords / 4;
  static constexpr int kCap = kSmemBytes / 16 / kVecs < kMaxRecords
                                  ? kSmemBytes / 16 / kVecs
                                  : kMaxRecords;
  static_assert(kCap >= kThreads, "a staging round must fit one tile");
};

template <bool RCP, bool STRICT, bool COUNTS>
__global__ void __launch_bounds__(kThreads) sweep_fit_kernel(const Params p) {
  using Rec = Record<RCP, STRICT, COUNTS>;
  __shared__ int4 tile[Rec::kCap * Rec::kVecs];
  __shared__ int next;  // records claimed since the block started

  // This thread's scenarios: requests (negated for rcp, so that a rem is
  // one IMAD) and reciprocals.
  int sidx[kSpt];
  int32_t cr[kSpt], mr[kSpt];
  float crr[kSpt], mrr[kSpt];
  long long acc[kSpt];
#pragma unroll
  for (int k = 0; k < kSpt; ++k) {
    sidx[k] = blockIdx.x * (kThreads * kSpt) + k * kThreads + threadIdx.x;
    const bool valid = sidx[k] < p.s;
    cr[k] = valid ? p.cr[sidx[k]] : 1;
    mr[k] = valid ? p.mr[sidx[k]] : 1;
    if constexpr (RCP) {
      cr[k] = -cr[k];
      mr[k] = -mr[k];
    }
    crr[k] = mrr[k] = 0.0f;  // an invalid scenario computes 0 and is dropped
    if constexpr (RCP) {
      if (valid) {
        crr[k] = p.crr[sidx[k]];
        mrr[k] = p.mrr[sidx[k]];
      }
    }
    acc[k] = 0;
  }

  if (threadIdx.x == 0) next = 0;
  __syncthreads();

  const unsigned lane = threadIdx.x & 31u;
  const long long begin = static_cast<long long>(blockIdx.y) * p.chunk;
  const long long end = min(begin + p.chunk, p.n);
  int total = 0, start = 0;  // records staged in all, and before this tile
  for (long long g0 = begin; g0 < end; g0 += kThreads) {
    // Stage the live nodes of [g0, g0 + kThreads), compacted.  The columns
    // load beside the mask and counts (one round trip, not two).
    const long long g = g0 + threadIdx.x;
    const bool in = g < end;
    int32_t w[Rec::kWords] = {};
    bool live = in;
    if (in) {
      w[0] = max(wsub(p.ac[g], p.uc[g]), 0);
      w[1] = max(wsub(p.am[g], p.um[g]), 0);
      const int32_t ap = p.ap[g], pc = p.pc[g];
      if constexpr (STRICT) {
        w[Rec::kEpi] = max(wsub(ap, pc), 0);
      } else {
        w[Rec::kEpi] = ap;
        w[Rec::kEpi + 1] = wsub(ap, pc);
      }
      if (p.mask != nullptr) live = p.mask[g] != 0;
      if constexpr (COUNTS) {
        w[Rec::kCount] = p.counts[g];
        live = live && w[Rec::kCount] != 0;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    int base = 0;
    if (lane == 0 && ballot != 0) base = atomicAdd(&next, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (live) {
      if constexpr (RCP) {
        w[2] = __float_as_int(__int2float_rn(w[0]));
        w[3] = __float_as_int(__int2float_rn(w[1]));
      }
      const int at = base - start + __popc(ballot & ((1u << lane) - 1u));
      int4* dst = tile + at * Rec::kVecs;
#pragma unroll
      for (int v = 0; v < Rec::kVecs; ++v) {
        dst[v] = make_int4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
      }
    }
    total += __syncthreads_count(live);  // also publishes the records
    const int filled = total - start;
    if (filled <= Rec::kCap - kThreads && g0 + kThreads < end) continue;

    // Every cell of the staged records.
#pragma unroll 2
    for (int i = 0; i < filled; ++i) {
      int32_t w[Rec::kWords];
      const int4* src = tile + i * Rec::kVecs;
#pragma unroll
      for (int v = 0; v < Rec::kVecs; ++v) {
        const int4 x = src[v];
        w[4 * v] = x.x;
        w[4 * v + 1] = x.y;
        w[4 * v + 2] = x.z;
        w[4 * v + 3] = x.w;
      }
#pragma unroll
      for (int k = 0; k < kSpt; ++k) {
        int32_t f;
        if constexpr (RCP) {
          const float m = fminf(__fmul_rn(__int_as_float(w[2]), crr[k]),
                                __fmul_rn(__int_as_float(w[3]), mrr[k]));
          f = wsub(__float_as_int(__fadd_rn(m, kMagic)), kMagicBits);
          const int32_t rems =
              wadd(w[0], wmul(f, cr[k])) | wadd(w[1], wmul(f, mr[k]));
          f = wsub(f, rems < 0);
        } else {
          f = min(w[0] / cr[k], w[1] / mr[k]);
        }
        // Epilogue on the staged terms.  Strict: f >= 0 and the slots are
        // >= 0, so the outer max(., 0) is void.
        if constexpr (STRICT) {
          f = min(f, w[Rec::kEpi]);
        } else {
          f = f >= w[Rec::kEpi] ? w[Rec::kEpi + 1] : f;
        }
        if constexpr (COUNTS) f = wmul(f, w[Rec::kCount]);
        if constexpr (STRICT && !COUNTS) {
          acc[k] += static_cast<uint32_t>(f);  // f >= 0: no sign to extend
        } else {
          acc[k] += f;
        }
      }
    }
    __syncthreads();  // the tile has been read
    start = total;
  }
#pragma unroll
  for (int k = 0; k < kSpt; ++k) {
    if (sidx[k] < p.s && acc[k] != 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(p.totals + sidx[k]),
                static_cast<unsigned long long>(acc[k]));
    }
  }
}

template <bool RCP, bool STRICT, bool COUNTS>
void launch(const Params& p, dim3 grid, cudaStream_t stream) {
  sweep_fit_kernel<RCP, STRICT, COUNTS><<<grid, kThreads, 0, stream>>>(p);
}

}  // namespace

// Launches one sweep on `stream`, on the calling thread's current device
// (the one that holds the pointers).  Null mask / counts select the
// variants without them; null reciprocals select the int32-divide
// variants.  The mask is 0/1: the kernel stages the nodes whose mask (and
// count) is not 0 and leaves out the others.  `totals` must be zeroed.
// Returns the cudaError_t of the launch (0 on success); it never
// synchronises.
extern "C" int kccap_sweep_fit(
    const int32_t* ac, const int32_t* am, const int32_t* ap,
    const int32_t* uc, const int32_t* um, const int32_t* pc,
    const int32_t* mask, const int32_t* counts,
    const int32_t* cr, const int32_t* mr,
    const float* crr, const float* mrr,
    long long* totals,
    long long n, int s, long long chunk, int strict, void* stream) {
  if (n <= 0 || s <= 0 || chunk <= 0 || chunk > INT32_MAX ||
      (crr == nullptr) != (mrr == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = (n + chunk - 1) / chunk;
  if (chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{ac, am, ap, uc, um, pc, mask, counts, cr, mr,
                 crr, mrr, totals, n, s, chunk};
  const dim3 grid((s + kThreads * kSpt - 1) / (kThreads * kSpt),
                  static_cast<unsigned>(chunks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The mask is read only while staging, so it selects no variant.
  const int variant = ((crr != nullptr) << 2) | ((strict != 0) << 1) |
                      (counts != nullptr);
  switch (variant) {
#define KCCAP_CASE(V)                                                   \
  case V:                                                               \
    launch<((V) & 4) != 0, ((V) & 2) != 0, ((V) & 1) != 0>(p, grid, st); \
    break;
    KCCAP_CASE(0) KCCAP_CASE(1) KCCAP_CASE(2) KCCAP_CASE(3)
    KCCAP_CASE(4) KCCAP_CASE(5) KCCAP_CASE(6) KCCAP_CASE(7)
#undef KCCAP_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
