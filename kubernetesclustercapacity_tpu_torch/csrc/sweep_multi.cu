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
// or the free slots (strict), as on the TPU.  The rcp variants replace each
// row's divide by _rcp_div: floor(h * (1/req)) in f32 plus ONE fixup round
// per row, h = max(alloc - used, 0).  That is exact only under
// fused_multi.rcp_multi_eligible, with correctly rounded f32 steps and
// reciprocals of max(req, 1) from fused_fit.scenario_reciprocals — hence
// __int2float_rn / __fmul_rn here and no fast-math or FTZ flags in the
// build.  The fixup is per row, not B1's combined one: B2 takes the min
// after each row's quotient is exact.  int32 arithmetic wraps (through
// uint32), as in XLA and in the plain PyTorch version.
//
// Both variants divide the clamped headroom h: where alloc <= used, h = 0
// gives quotient 0, which is the select's 0, and where alloc > used, h is
// alloc - used > 0, so C's truncating "/" equals the floored "//".
//
// What bounds it on the H100: instruction issue.  The function needs
// 2a - 1 operations per (scenario, node) cell for a scenario with a active
// rows (a quotients, a - 1 mins), the epilogue and the accumulate; the
// node operands are (2R + 3) int32 columns, a few hundred KB at 10k nodes,
// so the bytes take well under a microsecond.  The design keeps every
// cell's operands in registers or broadcast shared memory and never writes
// a per-cell value to device memory:
//
// * one thread owns one scenario; blockIdx.x walks blocks of kThreads
//   scenarios, blockIdx.y walks node chunks sized by the wrapper so the
//   grid fills every SM several times;
// * a block stages its chunk through shared memory, `tile` nodes at a
//   time, as the per-node terms the cells share: the R headrooms
//   max(alloc - used, 0), ap, pc and the mask.  All threads read the same
//   node at once (a broadcast, no bank conflicts).  The tile shrinks with
//   R so that it fits 48 KB; the tail of a chunk is staged as zero nodes,
//   which add 0 to every total in every variant.  Past the R at which even
//   kBatch nodes of every row do not fit, the tile is one batch and its
//   rows are staged in passes of `pass_rows`, the batch's running mins
//   staying in registers between passes, so every R >= 1 runs;
// * a thread takes kBatch nodes at a time with their running mins in
//   registers, and walks the rows once per batch: one load of its request
//   (and reciprocal) per row serves kBatch cells, and an inactive row is
//   skipped;
// * each thread accumulates its total in an int64 register and ends with
//   one atomicAdd into totals[s] (zeroed by the wrapper).  Integer sums do
//   not depend on their order.
//
// Requests held in registers for a static R, 16-byte loads and persistent
// blocks are left for later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;          // scenarios per block
constexpr int kBatch = 8;              // nodes per register batch
constexpr int kMaxTile = 256;          // nodes staged per step at most
constexpr int kSmemBytes = 48 * 1024;  // shared memory without an opt-in

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
  int tile;       // nodes staged per step, a multiple of kBatch
  int pass_rows;  // resource rows staged per pass: r, or fewer if tile == kBatch
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
// `totals` must be zeroed.  Every r >= 1 runs.  Returns the cudaError_t of
// the launch (0 on success); never synchronises.
extern "C" int kccap_sweep_multi(
    const int32_t* alloc, const int32_t* used, const int32_t* ap,
    const int32_t* pc, const int32_t* mask, const int32_t* reqs,
    const float* rcps, long long* totals,
    long long n, int s, int r, long long chunk, int strict, void* stream) {
  if (n <= 0 || s <= 0 || r <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = (n + chunk - 1) / chunk;
  if (chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
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
  const Params p{alloc, used, ap, pc, mask, reqs, rcps, totals,
                 n, s, r, chunk, static_cast<int>(tile), pass_rows};
  const dim3 grid((s + kThreads - 1) / kThreads,
                  static_cast<unsigned>(chunks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
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
