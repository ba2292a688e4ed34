// The strict zone-spread sweep for Hopper (sm_90a): the exact int64
// sweep's strict fits summed by topology domain, and the skew clamp, on
// the card.
//
// Replaces no TPU kernel.  The JAX package runs the grid topology spread
// as XLA's int64 elementwise ops over the per-node fits[S, N], and the
// port ran it as PyTorch's generic kernels (ops/fit.py::_sweep with
// per-node fits, an index_add_ into [S, Z+1], then min, minimum, + and
// sum; ops/fit.py::_spread_plain, kept as the plain version): some 230
// launches for 1,000 scenarios, and a [S, N] int64 matrix.  Each generic
// kernel family a process touches first loads its module's image into
// host memory, about 400 MiB for that program.  For each scenario s:
//
//     c[s, z]   = sum over nodes n with zone[n] = z of fit[s, n]
//                 (z = 1..Z, all sums mod 2^64)
//     floor[s]  = min over z of c[s, z]                (signed)
//     totals[s] = sum over z of min(c[s, z], floor[s] + max_skew)
//                 (the + and the sum wrap, as in int64 torch)
//
// fit is the strict cell of exact_cell.cuh (sweep_exact.cu's rule), 0
// where the node is masked out or unhealthy.  A node whose zone is 0
// (in no domain), or outside 1..Z, adds to no c[s, z].
//
// The design is sweep_exact_kernel's, and it never writes the [S, N]
// fits:
//
// * a thread owns kSpt scenarios, their divisors in registers; blockIdx.x
//   walks blocks of scenarios, blockIdx.y node chunks (ops/_build.py's
//   node_chunk);
// * a block stages its chunk into shared memory as one record per node;
//   a node that is masked, unhealthy or in no domain adds 0 to every sum,
//   so the warp ballot leaves it out;
// * the records of a staging round are bucketed by zone: each record's
//   zone is counted in shared memory as it is staged, zone_bases turns
//   the counts into each zone's first slot, and a counting sort writes
//   the records' indices in zone order;
// * each thread walks the zones' segments with one register accumulator
//   per scenario (segment_sums) and adds each segment's sum into
//   sums[z][s] with one atomicAdd.  No accumulator is chosen by a zone id
//   known only at run time, so nothing spills to local memory; the sums
//   wrap mod 2^64, so any order gives the same bits;
// * a second kernel, one thread per scenario, applies the clamp
//   (spread_total) and writes the totals.
//
// The output is one zeroed int64 buffer of Z + 1 rows of S: row 0 the
// totals, row z zone z's sums.  Zones are capped at kZoneCap
// (ops/fit.py's SPREAD_ZONE_CAP); a key with more domains (such as
// kubernetes.io/hostname) takes the plain version.
//
// Without __CUDACC__ only the per-node, per-cell, bucketing and clamp
// functions are defined, so host C++ can include this file and hold them
// against the plain version on a machine without the CUDA toolkit.

#include "exact_cell.cuh"

#if defined(__CUDACC__)
#define KCCAP_UNROLL _Pragma("unroll")
#else
#define KCCAP_UNROLL
#endif

namespace kccap_spread {

using kccap_exact::Divisors;
using kccap_exact::i64;
using kccap_exact::Node;
using kccap_exact::u64;

// Zones summed at most: ops/fit.py's SPREAD_ZONE_CAP.
constexpr int kZoneCap = 16;

// A counting sort's bucket offsets: zone z's records take the slots
// [base[z], base[z + 1]) for z = 1..zones; cursor[z] starts at base[z].
// Leaves count zeroed for the next round.  Slot 0 of each array is unused
// (zone 0 is never staged).
KCCAP_HD void zone_bases(int* count, int zones, int* base, int* cursor) {
  int at = 0;
  for (int z = 1; z <= zones; ++z) {
    base[z] = at;
    cursor[z] = at;
    at += count[z];
    count[z] = 0;
  }
  base[zones + 1] = at;
}

// Adds the strict fits of the records order[lo..hi) of tile, all of one
// zone, into acc[k] for each of the SPT scenarios of d.
template <int SPT>
KCCAP_HD void segment_sums(const Node* tile, const unsigned short* order,
                           int lo, int hi, const Divisors (&d)[SPT],
                           u64 (&acc)[SPT]) {
  for (int i = lo; i < hi; ++i) {
    const Node r = tile[order[i]];
    KCCAP_UNROLL
    for (int k = 0; k < SPT; ++k) {
      acc[k] += static_cast<u64>(kccap_exact::cell_fit<true>(r, d[k]));
    }
  }
}

// One scenario's total from its zone sums sums[0], sums[stride], ...
// (zones of them): each zone takes at most the smallest sum plus
// max_skew, compared as signed int64, and the takes are summed.
KCCAP_HD i64 spread_total(const u64* sums, i64 stride, int zones,
                          i64 max_skew) {
  i64 floor = static_cast<i64>(sums[0]);
  for (int z = 1; z < zones; ++z) {
    const i64 c = static_cast<i64>(sums[z * stride]);
    floor = c < floor ? c : floor;
  }
  const i64 cap = kccap_exact::wadd(floor, max_skew);
  u64 total = 0;
  for (int z = 0; z < zones; ++z) {
    const i64 c = static_cast<i64>(sums[z * stride]);
    total += static_cast<u64>(c < cap ? c : cap);
  }
  return static_cast<i64>(total);
}

}  // namespace kccap_spread

#if defined(__CUDACC__)

namespace {

using kccap_exact::Divisors;
using kccap_exact::i64;
using kccap_exact::Node;
using kccap_exact::u64;
using kccap_spread::kZoneCap;

// kThreads and kSpt are ops/_build.py's THREADS_PER_BLOCK and
// SCENARIOS_PER_THREAD, so its node_chunk sizes this grid too.
constexpr int kThreads = 128;  // threads per block
constexpr int kSpt = 2;        // scenarios per thread
constexpr int kCap = 512;      // node records staged at most (24 KiB)
static_assert(kCap >= 2 * kThreads, "a staging round must fit one tile");
static_assert(kCap <= 65536, "record indices are 16-bit");
static_assert(kZoneCap <= 255, "zones are staged as bytes");

struct Params {
  const i64* __restrict__ ac;
  const i64* __restrict__ am;
  const i64* __restrict__ ap;
  const i64* __restrict__ uc;
  const i64* __restrict__ um;
  const i64* __restrict__ pc;
  const unsigned char* __restrict__ healthy;
  const unsigned char* __restrict__ mask;
  const i64* __restrict__ zone;
  const i64* __restrict__ cr;
  const i64* __restrict__ mr;
  u64* __restrict__ out;  // [zones + 1][s]: the totals, then each zone's sums
  i64 n;
  int s;
  int zones;
  i64 chunk;
};

__global__ void __launch_bounds__(kThreads) sweep_spread_kernel(const Params p) {
  __shared__ Node tile[kCap];
  __shared__ unsigned short order[kCap];  // tile indices in zone order
  __shared__ unsigned char zone_of[kCap];
  __shared__ int count[kZoneCap + 2];   // records of each zone this round
  __shared__ int base[kZoneCap + 2];    // each zone's first slot in order
  __shared__ int cursor[kZoneCap + 2];  // the counting sort's next slots
  __shared__ int next;  // records claimed since the block started

  int sidx[kSpt];
  Divisors div[kSpt];
#pragma unroll
  for (int k = 0; k < kSpt; ++k) {
    sidx[k] = blockIdx.x * (kThreads * kSpt) + k * kThreads + threadIdx.x;
    const bool valid = sidx[k] < p.s;
    div[k] = kccap_exact::stage_divisors(valid ? p.cr[sidx[k]] : 1,
                                         valid ? p.mr[sidx[k]] : 1);
  }

  if (threadIdx.x == 0) next = 0;
  if (threadIdx.x < kZoneCap + 2) count[threadIdx.x] = 0;
  __syncthreads();

  const unsigned lane = threadIdx.x & 31u;
  const i64 begin = static_cast<i64>(blockIdx.y) * p.chunk;
  const i64 end = min(begin + p.chunk, p.n);
  int total = 0, start = 0;  // records staged in all, and before this tile
  for (i64 g0 = begin; g0 < end; g0 += kThreads) {
    // Stage the live nodes of [g0, g0 + kThreads), compacted, and count
    // each one's zone.
    const i64 g = g0 + threadIdx.x;
    Node rec{};
    i64 z = 0;
    bool live = g < end;
    if (live) {
      rec = kccap_exact::stage_node<true>(p.ac[g], p.am[g], p.ap[g],
                                          p.uc[g], p.um[g], p.pc[g], 1);
      z = p.zone[g];
      live = z >= 1 && z <= p.zones && p.healthy[g] != 0 &&
             (p.mask == nullptr || p.mask[g] != 0);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    int at = 0;
    if (lane == 0 && ballot != 0) at = atomicAdd(&next, __popc(ballot));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (live) {
      const int slot = at - start + __popc(ballot & ((1u << lane) - 1u));
      tile[slot] = rec;
      zone_of[slot] = static_cast<unsigned char>(z);
      atomicAdd(&count[z], 1);
    }
    total += __syncthreads_count(live);  // also publishes the records
    const int filled = total - start;
    if (filled <= kCap - kThreads && g0 + kThreads < end) continue;

    // Bucket the staged records by zone.
    if (threadIdx.x == 0) kccap_spread::zone_bases(count, p.zones, base, cursor);
    __syncthreads();
    for (int i = threadIdx.x; i < filled; i += kThreads) {
      order[atomicAdd(&cursor[zone_of[i]], 1)] = static_cast<unsigned short>(i);
    }
    __syncthreads();

    // Every cell of the staged records, one zone's segment at a time.
    for (int zz = 1; zz <= p.zones; ++zz) {
      const int lo = base[zz], hi = base[zz + 1];
      if (lo == hi) continue;
      u64 acc[kSpt] = {};
      kccap_spread::segment_sums<kSpt>(tile, order, lo, hi, div, acc);
#pragma unroll
      for (int k = 0; k < kSpt; ++k) {
        if (sidx[k] < p.s && acc[k] != 0) {
          atomicAdd(p.out + static_cast<i64>(zz) * p.s + sidx[k], acc[k]);
        }
      }
    }
    __syncthreads();  // the tile, the order and the bases have been read
    start = total;
  }
}

// The clamp: one thread per scenario reads its zone sums (rows 1..zones)
// and writes its total into row 0.
__global__ void __launch_bounds__(kThreads) sweep_spread_clamp(
    u64* __restrict__ out, int s, int zones, i64 max_skew) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j < s) {
    out[j] = static_cast<u64>(
        kccap_spread::spread_total(out + s + j, s, zones, max_skew));
  }
}

}  // namespace

// Launches one strict zone-spread sweep on `stream`, on the calling
// thread's current device (the one that holds the pointers): the sweep,
// then the clamp.  The six node columns, the zones and the requests are
// int64; `healthy` and `mask` are bool (one byte each); a null mask
// leaves it out.  `out` holds (zones + 1) * s int64 and must be zeroed;
// its first s are the totals.  Returns the cudaError_t of the launches (0
// on success); it never synchronises.
extern "C" int kccap_sweep_spread(
    const long long* ac, const long long* am, const long long* ap,
    const long long* uc, const long long* um, const long long* pc,
    const unsigned char* healthy, const unsigned char* mask,
    const long long* zone, const long long* cr, const long long* mr,
    unsigned long long* out, long long n, int s, int zones,
    long long max_skew, long long chunk, int strict, void* stream) {
  if (n <= 0 || s <= 0 || chunk <= 0 || chunk > INT32_MAX || strict == 0 ||
      zones < 1 || zones > kZoneCap || healthy == nullptr ||
      zone == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = (n + chunk - 1) / chunk;
  if (chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{ac, am, ap, uc, um, pc, healthy, mask, zone,
                 cr, mr, out, n, s, zones, chunk};
  const dim3 grid((s + kThreads * kSpt - 1) / (kThreads * kSpt),
                  static_cast<unsigned>(chunks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sweep_spread_kernel<<<grid, kThreads, 0, st>>>(p);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) {
    return static_cast<int>(rc);
  }
  sweep_spread_clamp<<<(s + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      out, s, zones, max_skew);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
