// The exact int64 capacity sweep for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package runs this program as XLA's int64
// elementwise ops (kubernetesclustercapacity_tpu/ops/fit.py::sweep_grid and
// sweep_grid_grouped), and the port ran it as PyTorch's generic int64
// kernels (ops/fit.py::_sweep, kept as the plain version): some 227 launches
// for a sweep of 1,000 scenarios, each over [S_chunk, N] int64 temporaries.
// It is the route of every 2-resource sweep that the int32 kernel
// (sweep_fit.cu) cannot prove exact: memory not in whole KiB (requests
// written "512M"), values past int32, a zero request, or kernel="exact".
// For each scenario s it computes totals[s] = sum over nodes n of
// fit[s, n] * counts[n], bit for bit what ops/fit.py::fit_per_node gives:
//
//     cpu = alloc_cpu <=u used_cpu ? 0 : (alloc_cpu - used_cpu) /u max1(cr)
//           (Go uint64 on the int64 bit patterns)
//     mem = alloc_mem <= used_mem ? 0 : (alloc_mem - used_mem) / max1(mr)
//           (Go int64: the subtraction wraps, the quotient truncates, and
//           INT64_MIN / -1 is INT64_MIN)
//     fit = min(cpu, mem), compared as signed int64 (a cpu quotient past
//           INT64_MAX reads negative and wins)
//     fit = reference: fit >= ap ? ap - pc : fit      (may be negative)
//           strict:    max(min(fit, max(ap - pc, 0)), 0), 0 where !healthy
//     fit = 0 where !mask[n]
//     totals[s] += fit * counts[n]                    (all sums mod 2^64)
//
// max1(x) is x, or 1 where x is 0.  A headroom is staged as 0 wherever
// alloc <= used, and 0 divided by anything is 0, so the staged headroom
// carries its compare with it.
//
// What bounds it on the H100: the two 64-bit divisions of every cell.  The
// card has no integer divider; nvcc expands each "/" of a 64-bit integer
// into a software routine (a float reciprocal estimate, refined with
// 64-bit multiply-highs and corrected), so a cell issues about 86
// instructions (cuobjdump -sass: 688 in a loop over four records of two
// scenarios each) where B1's rcp form issues 15 (chip_smoke.py prints the
// counts).  The bytes are nothing: six int64 node columns, two bool
// columns and two int64 request rows, each read once.  The design is B1's
// (sweep_fit.cu), and never writes the [S, N] fits:
//
// * a thread owns kSpt scenarios, their divisors in registers for the whole
//   block; blockIdx.x walks blocks of kThreads * kSpt scenarios, blockIdx.y
//   node chunks sized by the wrapper (ops/fit.py::node_chunk);
// * a block stages its chunk into shared memory as one record per node of
//   the terms every cell of that node shares (both headrooms, the
//   epilogue's terms and the count), which all threads then read at once;
// * a node that is masked, unhealthy under strict, or of count 0 adds 0 to
//   every total, so a warp ballot leaves it out of the records;
// * each thread accumulates its totals in unsigned 64-bit registers and
//   adds each into totals[s] (zeroed by the wrapper) with one atomicAdd:
//   the sums wrap mod 2^64, so any order gives the same bits.
//
// A division by a per-scenario constant could be a multiply-high by a
// magic number computed once per scenario (ROADMAP D6); this kernel
// divides natively, which is exact by definition and needs no proof.
//
// The per-node and per-cell functions live in exact_cell.cuh, which
// sweep_spread.cu shares.  Without __CUDACC__ only they are defined, so
// host C++ can include this file and hold them against the plain version
// on a machine without the CUDA toolkit.

#include "exact_cell.cuh"

#if defined(__CUDACC__)

namespace {

using kccap_exact::Divisors;
using kccap_exact::i64;
using kccap_exact::Node;
using kccap_exact::u64;

// kThreads and kSpt are ops/fit.py's THREADS_PER_BLOCK and
// SCENARIOS_PER_THREAD, so its node_chunk sizes this grid too.
constexpr int kThreads = 128;  // threads per block
constexpr int kSpt = 2;        // scenarios per thread
constexpr int kCap = 512;      // node records staged at most (24 KiB)
static_assert(kCap >= 2 * kThreads, "a staging round must fit one tile");

struct Params {
  const i64* __restrict__ ac;
  const i64* __restrict__ am;
  const i64* __restrict__ ap;
  const i64* __restrict__ uc;
  const i64* __restrict__ um;
  const i64* __restrict__ pc;
  const unsigned char* __restrict__ healthy;
  const unsigned char* __restrict__ mask;
  const i64* __restrict__ counts;
  const i64* __restrict__ cr;
  const i64* __restrict__ mr;
  u64* __restrict__ totals;
  i64 n;
  int s;
  i64 chunk;
};

template <bool STRICT>
__global__ void __launch_bounds__(kThreads) sweep_exact_kernel(const Params p) {
  __shared__ Node tile[kCap];
  __shared__ int next;  // records claimed since the block started

  int sidx[kSpt];
  Divisors div[kSpt];
  u64 acc[kSpt];
#pragma unroll
  for (int k = 0; k < kSpt; ++k) {
    sidx[k] = blockIdx.x * (kThreads * kSpt) + k * kThreads + threadIdx.x;
    const bool valid = sidx[k] < p.s;
    div[k] = kccap_exact::stage_divisors(valid ? p.cr[sidx[k]] : 1,
                                         valid ? p.mr[sidx[k]] : 1);
    acc[k] = 0;
  }

  if (threadIdx.x == 0) next = 0;
  __syncthreads();

  const unsigned lane = threadIdx.x & 31u;
  const i64 begin = static_cast<i64>(blockIdx.y) * p.chunk;
  const i64 end = min(begin + p.chunk, p.n);
  int total = 0, start = 0;  // records staged in all, and before this tile
  for (i64 g0 = begin; g0 < end; g0 += kThreads) {
    // Stage the live nodes of [g0, g0 + kThreads), compacted.
    const i64 g = g0 + threadIdx.x;
    const bool in = g < end;
    Node rec{};
    bool live = in;
    if (in) {
      rec = kccap_exact::stage_node<STRICT>(
          p.ac[g], p.am[g], p.ap[g], p.uc[g], p.um[g], p.pc[g],
          p.counts != nullptr ? p.counts[g] : 1);
      if (p.mask != nullptr) live = p.mask[g] != 0;
      if constexpr (STRICT) live = live && p.healthy[g] != 0;
      live = live && rec.count != 0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    int base = 0;
    if (lane == 0 && ballot != 0) base = atomicAdd(&next, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (live) {
      tile[base - start + __popc(ballot & ((1u << lane) - 1u))] = rec;
    }
    total += __syncthreads_count(live);  // also publishes the records
    const int filled = total - start;
    if (filled <= kCap - kThreads && g0 + kThreads < end) continue;

    // Every cell of the staged records.
    for (int i = 0; i < filled; ++i) {
      const Node r = tile[i];
#pragma unroll
      for (int k = 0; k < kSpt; ++k) {
        acc[k] += static_cast<u64>(
            kccap_exact::wmul(kccap_exact::cell_fit<STRICT>(r, div[k]),
                              r.count));
      }
    }
    __syncthreads();  // the tile has been read
    start = total;
  }
#pragma unroll
  for (int k = 0; k < kSpt; ++k) {
    if (sidx[k] < p.s && acc[k] != 0) atomicAdd(p.totals + sidx[k], acc[k]);
  }
}

}  // namespace

// Launches one exact sweep on `stream`, on the calling thread's current
// device (the one that holds the pointers).  The six node columns, the
// counts and the requests are int64; `healthy` and `mask` are bool (one
// byte each).  A null mask or null counts leaves them out; `healthy` is
// read under strict only.  `totals` must be zeroed.  Returns the
// cudaError_t of the launch (0 on success); it never synchronises.
extern "C" int kccap_sweep_exact(
    const long long* ac, const long long* am, const long long* ap,
    const long long* uc, const long long* um, const long long* pc,
    const unsigned char* healthy, const unsigned char* mask,
    const long long* counts, const long long* cr, const long long* mr,
    unsigned long long* totals, long long n, int s, long long chunk,
    int strict, void* stream) {
  if (n <= 0 || s <= 0 || chunk <= 0 || chunk > INT32_MAX ||
      healthy == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = (n + chunk - 1) / chunk;
  if (chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{ac, am, ap, uc, um, pc, healthy, mask, counts,
                 cr, mr, totals, n, s, chunk};
  const dim3 grid((s + kThreads * kSpt - 1) / (kThreads * kSpt),
                  static_cast<unsigned>(chunks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (strict != 0) {
    sweep_exact_kernel<true><<<grid, kThreads, 0, st>>>(p);
  } else {
    sweep_exact_kernel<false><<<grid, kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
