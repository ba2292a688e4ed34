// Fused R-resource capacity-sweep kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel kubernetesclustercapacity_tpu/ops/pallas_multi.py::
// _make_multi_kernel (row math from pallas_fit.py's _rcp_div and _epilogue).
// It computes the same function, not the same tiles: for each scenario s,
// totals[s] = sum over nodes n of
//
//     fit_r = req[r][s] > 0 ? (alloc[r][n] <= used[r][n] ? 0
//                              : (alloc[r][n] - used[r][n]) / req[r][s])
//                           : INT32_MAX                  (row r inactive)
//     fit   = min over r of fit_r
//     fit   = reference: fit >= ap ? ap - pc : fit      (may be negative)
//             strict:    max(min(fit, max(ap - pc, 0)), 0)
//     fit  *= mask[n]   (0/1, optional)
//
// with every resource row pre-divided by its power-of-1024 scale and every
// value int32 (the host proves the inputs eligible first:
// fused_multi.fast_multi_eligible).  A scenario whose rows are all inactive
// keeps fit = INT32_MAX into the epilogue, which gives ap - pc (reference)
// or the free slots (strict), as on the TPU.  int32 arithmetic wraps
// (through uint32), as in XLA and in the plain PyTorch version.  Every
// variant divides the clamped headroom h = max(alloc - used, 0): where
// alloc <= used, h = 0 gives quotient 0, the select's 0, and where
// alloc > used, C's truncating "/" equals the floored "//".
//
// Two kernels compute it.  For 1 <= R <= 8 (every configuration the CLI
// and BASELINE config 4 send) sweep_multi_kernel_r<R, ...> holds a
// scenario's requests in registers; larger R runs sweep_multi_kernel<...>,
// which streams the rows and stages them in passes past 1533 rows.
//
// The reciprocal (rcp) variants, exact under fused_multi.rcp_multi_eligible
// (every quotient <= 2^20, every divisor <= 2^29) with reciprocals of
// max(req, 1) from fused_fit.scenario_reciprocals:
//
// * sweep_multi_kernel_r takes ONE estimate per cell and one combined fixup
//   over the rows.  Each row's est_r = RN(hf_r * rc_r) lies within
//   3 * 2^-24 * (2^20 + 1) < 0.19 of its real quotient x_r = h_r / q_r
//   (hf_r = RN(h_r), rc_r = RN(1 / q_r) and the product each round once), so
//   m = min_r est_r lies within 0.19 of min_r x_r (min is 1-Lipschitz).  As
//   floor(min) = min(floor), the fit is M = floor(min_r x_r), and
//   RN(m) is M or M + 1.  RN(m) < 2^22, so adding 0x1.8p23 puts it in the
//   mantissa's low bits and the float's bits minus 0x4B400000 are RN(m) as
//   an int32: no conversion instruction.  The fixup: f = M + 1 exactly when
//   some active row's rem_r = h_r - f * q_r is negative, so one OR of the
//   rems and one sign test give M.  (The JAX kernel floors and fixes up each
//   row on both sides; under the same proof both give M.)  True rems lie in
//   (-q_r, h_r] with q_r <= 2^29, so the wrapping int32 products give them
//   exactly.  An inactive row holds q_r = 0 (its rem is h_r >= 0) and a NaN
//   reciprocal (its estimate is NaN, which fminf ignores); a scenario with
//   no active row gives row 0 a reciprocal of 0, so m = 0, and subtracts a
//   bias that turns RN(0) into INT32_MAX.  The two steps
//   stay __fmul_rn / __fadd_rn, and the build keeps -fmad=false and no
//   fast-math or FTZ flags: a contracted FMA would round once, not twice.
// * sweep_multi_kernel keeps _rcp_div per row (one floor, one fixup on both
//   sides).
//
// What bounds it on the H100: instruction issue, with the ALU pipe (16
// lanes per SM sub-partition, half the FP32 pipe's) close behind.  The
// per-cell loop of sweep_multi_kernel_r<4> in the rcp/strict form issues
// about 21 instructions per cell (cuobjdump -sass; chip_smoke.py prints the
// counts): per row an FMUL, an FMNMX and an IMAD for the rem; then the
// magic add (FADD) and its subtraction, the OR of the rems (LOP3), the sign
// fixup (LEA.HI), the strict min, the accumulate and 1.5 shared loads.  Of
// those about 8 are ALU instructions, and none is an I2F, F2I or FRND:
// every conversion runs once per node per block, at staging.  Besides the
// cells, a launch pays a fixed time (the scenario loads, the staging, and
// the launch itself) that a sweep whose nodes are all masked out measures.
// The node operands are (2R + 3) int32 columns, a few hundred KB at 10k
// nodes, so the bytes take well under a microsecond.  The design keeps every
// cell's operands in registers or broadcast shared memory and never writes
// a per-cell value to device memory:
//
// * a thread owns kSpt scenarios and holds each one's requests (and
//   reciprocals) in registers for the whole block, so one shared load of a
//   node serves kSpt cells; blockIdx.x walks blocks of kThreads * kSpt
//   scenarios, blockIdx.y walks node chunks sized by the wrapper
//   (fused_fit.node_chunk) so the grid fills every SM several times;
// * a block stages its chunk into shared memory as one 16-byte-aligned
//   record per node of the terms every cell of that node shares: the R
//   headrooms h_r, their floats (rcp), and the epilogue's terms (strict:
//   the free slots max(ap - pc, 0); reference: ap and ap - pc).  All
//   threads read the same record at once (a broadcast, 16 bytes per load);
// * a node whose mask is 0 adds 0 to every total in every variant, so the
//   staging leaves it out: a warp ballot compacts the live nodes, and the
//   tail of a chunk, or a tile with no live node, stages nothing;
// * each thread accumulates its totals in int64 registers and ends with
//   one atomicAdd each into totals[s] (zeroed by the wrapper).  Integer
//   sums do not depend on their order, so neither does the compaction.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// kThreads and kSpt are fused_fit.THREADS_PER_BLOCK and SCENARIOS_PER_THREAD.
constexpr int kThreads = 128;          // threads per block
constexpr int kSpt = 2;                // scenarios per thread (R <= 8)
constexpr int kBatch = 8;              // nodes per register batch (runtime R)
constexpr int kMaxTile = 256;          // nodes staged per step (runtime R)
constexpr int kMaxStaticR = 8;         // largest R with requests in registers
constexpr int kMaxRecords = 512;       // node records staged per tile at most
constexpr int kSmemBytes = 48 * 1024;  // shared memory without an opt-in

// RN(m) for 0 <= m < 2^22: the low bits of m + 0x1.8p23 (see the header).
constexpr float kMagic = 12582912.0f;            // 0x1.8p23
constexpr int32_t kMagicBits = 0x4B400000;       // its bit pattern

struct Params {
  const int32_t* __restrict__ alloc;  // [r, n], row-scaled
  const int32_t* __restrict__ used;   // [r, n], row-scaled
  const int32_t* __restrict__ ap;     // [n]
  const int32_t* __restrict__ pc;     // [n]
  const int32_t* __restrict__ mask;   // [n] or null
  const int32_t* __restrict__ reqs;   // [r, s], row-scaled
  const float* __restrict__ rcps;     // [r, s] or null
  long long* __restrict__ totals;     // [s]
  long long n;
  int s;
  int r;
  long long chunk;
  int tile;       // nodes staged per step, a multiple of kBatch (runtime R)
  int pass_rows;  // resource rows staged per pass (runtime R)
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

// _rcp_div for h >= 0, d > 0, rc = f32(1/d): one estimate, one fixup.
__device__ __forceinline__ int32_t rcp_div(int32_t h, int32_t d, float rc) {
  const int32_t q =
      static_cast<int32_t>(floorf(__fmul_rn(__int2float_rn(h), rc)));
  const int32_t rem = wsub(h, wmul(q, d));
  return wsub(wadd(q, rem >= d), rem < 0);
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

// --- 1 <= R <= 8: requests in registers, one estimate per cell -----------

// One staged node: h[R], then hf[R] (rcp), then the epilogue's terms
// (strict: slots; reference: ap, ap - pc), padded to whole 16-byte words.
template <int R, bool RCP, bool STRICT>
struct Record {
  static constexpr int kTerms = R * (RCP ? 2 : 1);
  static constexpr int kWords = (kTerms + (STRICT ? 1 : 2) + 3) / 4 * 4;
  static constexpr int kVecs = kWords / 4;
  // Records per tile: kMaxRecords, or fewer if they would pass 48 KB.
  static constexpr int kCap = kSmemBytes / 16 / kVecs < kMaxRecords
                                  ? kSmemBytes / 16 / kVecs
                                  : kMaxRecords;
  static_assert(kCap >= kThreads, "a staging round must fit one tile");
};

template <int R, bool RCP, bool STRICT>
__global__ void __launch_bounds__(kThreads)
    sweep_multi_kernel_r(const Params p) {
  using Rec = Record<R, RCP, STRICT>;
  __shared__ int4 tile[Rec::kCap * Rec::kVecs];
  __shared__ int next;  // records claimed since the block started

  // This thread's scenarios: requests (rcp: negated, so that a rem is one
  // IMAD, and 0 where inactive; divide: 1 where inactive, so that every
  // row divides and the divisor's reciprocal is shared by the unrolled
  // nodes), reciprocals, the active rows, and the bias that turns the
  // magic sum into f.
  int sidx[kSpt];
  int32_t q[kSpt][R];
  float rc[kSpt][R];
  unsigned active[kSpt];
  int32_t bias[kSpt];
  long long acc[kSpt];
#pragma unroll
  for (int k = 0; k < kSpt; ++k) {
    sidx[k] = blockIdx.x * (kThreads * kSpt) + k * kThreads + threadIdx.x;
    const bool valid = sidx[k] < p.s;
    active[k] = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long at = static_cast<long long>(r) * p.s + sidx[k];
      const int32_t v = valid ? p.reqs[at] : 0;
      // Inactive rcp row: 0, so its rem is h >= 0, never negative.
      q[k][r] = v > 0 ? (RCP ? -v : v) : (RCP ? 0 : 1);
      active[k] |= static_cast<unsigned>(v > 0) << r;
      if constexpr (RCP) {
        rc[k][r] = v > 0 ? p.rcps[at] : __int_as_float(0x7fffffff);  // NaN
      }
    }
    bias[k] = kMagicBits;
    if constexpr (RCP) {
      if (active[k] == 0) {
        // No active row: row 0's estimate becomes 0 (the others are NaN),
        // and this bias turns RN(0)'s magic sum into INT32_MAX.
        rc[k][0] = 0.0f;
        bias[k] = wsub(kMagicBits, INT32_MAX);
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
    // Stage the live nodes of [g0, g0 + kThreads), compacted.
    // The columns load beside the mask (one round trip, not two).
    const long long g = g0 + threadIdx.x;
    const bool in = g < end;
    int32_t w[Rec::kWords] = {};
    if (in) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const long long at = static_cast<long long>(r) * p.n + g;
        w[r] = max(wsub(p.alloc[at], p.used[at]), 0);
      }
      const int32_t ap = p.ap[g], pc = p.pc[g];
      if constexpr (STRICT) {
        w[Rec::kTerms] = max(wsub(ap, pc), 0);
      } else {
        w[Rec::kTerms] = ap;
        w[Rec::kTerms + 1] = wsub(ap, pc);
      }
    }
    const bool live = in && (p.mask == nullptr || p.mask[g] != 0);
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    int base = 0;
    if (lane == 0 && ballot != 0) base = atomicAdd(&next, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (live) {
      if constexpr (RCP) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          w[R + r] = __float_as_int(__int2float_rn(w[r]));
        }
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
          float m = __fmul_rn(__int_as_float(w[R]), rc[k][0]);
#pragma unroll
          for (int r = 1; r < R; ++r) {
            m = fminf(m, __fmul_rn(__int_as_float(w[R + r]), rc[k][r]));
          }
          f = wsub(__float_as_int(__fadd_rn(m, kMagic)), bias[k]);
          int32_t rems = 0;  // the OR of the rems: negative iff f = M + 1
#pragma unroll
          for (int r = 0; r < R; ++r) rems |= wadd(w[r], wmul(f, q[k][r]));
          f = wsub(f, rems < 0);
        } else {
          f = INT32_MAX;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int32_t quo = w[r] / q[k][r];
            if ((active[k] >> r) & 1u) f = min(f, quo);
          }
        }
        // Epilogue on the staged terms.  Strict: f >= 0 and the slots are
        // >= 0, so the outer max(., 0) is void.
        if constexpr (STRICT) {
          f = min(f, w[Rec::kTerms]);
          acc[k] += static_cast<uint32_t>(f);  // f >= 0: no sign to extend
        } else {
          acc[k] += f >= w[Rec::kTerms] ? w[Rec::kTerms + 1] : f;
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

template <int R>
void launch_r(const Params& p, bool rcp, bool strict, unsigned chunks,
              cudaStream_t st) {
  const dim3 grid((p.s + kThreads * kSpt - 1) / (kThreads * kSpt), chunks);
  if (rcp) {
    if (strict) {
      sweep_multi_kernel_r<R, true, true><<<grid, kThreads, 0, st>>>(p);
    } else {
      sweep_multi_kernel_r<R, true, false><<<grid, kThreads, 0, st>>>(p);
    }
  } else {
    if (strict) {
      sweep_multi_kernel_r<R, false, true><<<grid, kThreads, 0, st>>>(p);
    } else {
      sweep_multi_kernel_r<R, false, false><<<grid, kThreads, 0, st>>>(p);
    }
  }
}

// --- R > 8: rows streamed from global memory, staged in passes ------------
//
// One thread per scenario; a block stages its chunk `tile` nodes at a time
// as the R headrooms, ap, pc and the mask (the tail as zero nodes, which add
// 0), and a thread takes kBatch nodes at a time with their running mins in
// registers, loading its request (and reciprocal) once per row per batch and
// skipping inactive rows.  Past the R at which even kBatch nodes of every row
// do not fit 48 KB, the tile is one batch and its rows are staged in passes
// of `pass_rows`, the batch's running mins staying in registers.

template <bool RCP, bool STRICT, bool MASK>
__global__ void __launch_bounds__(kThreads) sweep_multi_kernel(const Params p) {
  extern __shared__ int32_t smem[];
  const int tile = p.tile;
  int32_t* head = smem;                          // [pass_rows][tile] headrooms
  int32_t* ap_t = smem + p.pass_rows * tile;     // [tile]
  int32_t* pc_t = ap_t + tile;                   // [tile]
  int32_t* mk_t = pc_t + tile;                   // [tile], MASK only

  const int sidx = blockIdx.x * kThreads + threadIdx.x;
  const bool active = sidx < p.s;

  const long long begin = static_cast<long long>(blockIdx.y) * p.chunk;
  const long long end = min(begin + p.chunk, p.n);
  long long acc = 0;
  for (long long base = begin; base < end; base += tile) {
    const int len = static_cast<int>(min(static_cast<long long>(tile),
                                         end - base));
    const int staged = (len + kBatch - 1) / kBatch * kBatch;  // <= tile
    for (int i = 0; i < staged; i += kBatch) {
      int32_t fit[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) fit[j] = INT32_MAX;
      for (int k0 = 0; k0 < p.r; k0 += p.pass_rows) {
        const int rows = min(p.pass_rows, p.r - k0);
        // Stage rows [k0, k0 + rows) of the tile.  With one pass this runs
        // once per tile; with several the tile is one batch (i is 0), so
        // it runs once per pass.  i and k0 are uniform over the block.
        if (i == 0) {
          __syncthreads();  // the previous rows have been consumed
          for (int t = threadIdx.x; t < tile; t += kThreads) {
            const bool in = t < len;
            const long long g = base + t;
            for (int k = 0; k < rows; ++k) {
              const long long at = static_cast<long long>(k0 + k) * p.n + g;
              head[k * tile + t] =
                  in ? max(wsub(p.alloc[at], p.used[at]), 0) : 0;
            }
            if (k0 == 0) {
              ap_t[t] = in ? p.ap[g] : 0;
              pc_t[t] = in ? p.pc[g] : 0;
              if constexpr (MASK) mk_t[t] = in ? p.mask[g] : 0;
            }
          }
          __syncthreads();
        }
        if (!active) continue;
        for (int k = 0; k < rows; ++k) {
          const long long at = static_cast<long long>(k0 + k) * p.s + sidx;
          const int32_t q = p.reqs[at];
          if (q <= 0) continue;  // inactive: INT32_MAX leaves the min as is
          float rc = 1.0f;
          if constexpr (RCP) rc = p.rcps[at];
          const int32_t* hk = head + k * tile + i;
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int32_t v = RCP ? rcp_div(hk[j], q, rc) : hk[j] / q;
            fit[j] = min(fit[j], v);
          }
        }
      }
      if (!active) continue;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        int32_t f = epilogue<STRICT>(fit[j], ap_t[i + j], pc_t[i + j]);
        if constexpr (MASK) f = wmul(f, mk_t[i + j]);
        acc += f;
      }
    }
  }
  if (active && acc != 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p.totals + sidx),
              static_cast<unsigned long long>(acc));
  }
}

template <bool RCP, bool STRICT, bool MASK>
void launch(const Params& p, dim3 grid, size_t smem, cudaStream_t stream) {
  sweep_multi_kernel<RCP, STRICT, MASK><<<grid, kThreads, smem, stream>>>(p);
}

}  // namespace

// Launches one R-resource sweep on `stream`, on the calling thread's
// current device (the one that holds the pointers).  A null mask selects
// the variants without it; null reciprocals the int32-divide variants.
// The mask is 0/1 (the register kernel stages the nodes whose mask is not
// 0 and leaves out the others).  `totals` must be zeroed.  Every r >= 1
// runs.  Returns the cudaError_t of the launch (0 on success); never
// synchronises.
extern "C" int kccap_sweep_multi(
    const int32_t* alloc, const int32_t* used, const int32_t* ap,
    const int32_t* pc, const int32_t* mask, const int32_t* reqs,
    const float* rcps, long long* totals,
    long long n, int s, int r, long long chunk, int strict, void* stream) {
  if (n <= 0 || s <= 0 || r <= 0 || chunk <= 0 || chunk > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = (n + chunk - 1) / chunk;
  if (chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p{alloc, used, ap, pc, mask, reqs, rcps, totals,
           n, s, r, chunk, 0, 0};
  if (r <= kMaxStaticR) {
    const bool rcp = rcps != nullptr;
    const unsigned ch = static_cast<unsigned>(chunks);
    switch (r) {
      case 1: launch_r<1>(p, rcp, strict != 0, ch, st); break;
      case 2: launch_r<2>(p, rcp, strict != 0, ch, st); break;
      case 3: launch_r<3>(p, rcp, strict != 0, ch, st); break;
      case 4: launch_r<4>(p, rcp, strict != 0, ch, st); break;
      case 5: launch_r<5>(p, rcp, strict != 0, ch, st); break;
      case 6: launch_r<6>(p, rcp, strict != 0, ch, st); break;
      case 7: launch_r<7>(p, rcp, strict != 0, ch, st); break;
      default: launch_r<8>(p, rcp, strict != 0, ch, st); break;
    }
    return static_cast<int>(cudaGetLastError());
  }
  // Shared words: pass_rows headroom rows plus ap, pc (and the mask), each
  // `tile` nodes long.  Stage every row when kBatch nodes of them fit;
  // otherwise one batch of nodes and as many rows per pass as fit.
  const long long words = kSmemBytes / sizeof(int32_t);
  const int extra = 2 + (mask != nullptr ? 1 : 0);
  long long tile = words / (static_cast<long long>(r) + extra) / kBatch * kBatch;
  int pass_rows = r;
  if (tile < kBatch) {
    tile = kBatch;
    pass_rows = static_cast<int>(words / kBatch) - extra;
  }
  if (tile > kMaxTile) tile = kMaxTile;
  const size_t smem =
      static_cast<size_t>(pass_rows + extra) * tile * sizeof(int32_t);
  p.tile = static_cast<int>(tile);
  p.pass_rows = pass_rows;
  const dim3 grid((s + kThreads - 1) / kThreads,
                  static_cast<unsigned>(chunks));
  const int variant = ((rcps != nullptr) << 2) | ((strict != 0) << 1) |
                      (mask != nullptr);
  switch (variant) {
#define KCCAP_CASE(V)                                                   \
  case V:                                                               \
    launch<((V) & 4) != 0, ((V) & 2) != 0, ((V) & 1) != 0>(p, grid, smem, \
                                                           st);         \
    break;
    KCCAP_CASE(0) KCCAP_CASE(1) KCCAP_CASE(2) KCCAP_CASE(3)
    KCCAP_CASE(4) KCCAP_CASE(5) KCCAP_CASE(6) KCCAP_CASE(7)
#undef KCCAP_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
