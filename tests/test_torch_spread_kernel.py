"""The zone-spread kernel's host twins, on the CPU.

``csrc/sweep_spread.cu``'s bucketing (``zone_bases``), its per-zone
segment walk (``segment_sums``) and its clamp (``spread_total``), with
the exact sweep's per-cell functions they call, compiled as host C++
with ``g++`` behind a loop that stages nodes in chunks and rounds as the
kernel's blocks do.  They are held against numpy (the zone sums and the
clamp over ``fit_per_node``'s strict fits) and against the kernel's plain
version, ``ops/fit.py::_spread_plain``, on ``tests/exact_edges.py``'s
hostile columns and requests.  On the CPU ``sweep_spread`` and
``topology_spread_grid`` take the plain version and count it.
Tolerance: none, every result is an integer.
"""

import ctypes
import shutil
import subprocess

import exact_edges
import numpy as np
import pytest
import torch

from kubernetesclustercapacity_tpu_torch import (
    CapacityModel,
    PodSpec,
    random_scenario_grid,
    snapshot_from_fixture,
    synthetic_fixture,
)
from kubernetesclustercapacity_tpu_torch.ops import _build
from kubernetesclustercapacity_tpu_torch.ops import fit as t_fit

_HOST_HARNESS = r"""
#include <vector>

#include "SWEEP_SPREAD_CU"

using namespace kccap_exact;
using namespace kccap_spread;

// The kernel's blocks on the host, one scenario at a time: the nodes in
// chunks of `chunk`, each staged in rounds of at most `cap` live records,
// bucketed by zone and walked one zone's segment at a time; then the
// clamp.  `out` holds (zones + 1) * s zeros; row 0 gets the totals.
extern "C" void kccap_spread_host(
    const i64* ac, const i64* am, const i64* ap, const i64* uc,
    const i64* um, const i64* pc, const unsigned char* healthy,
    const unsigned char* mask, const i64* zone, const i64* cr,
    const i64* mr, i64 n, i64 s, int zones, i64 max_skew, i64 chunk,
    int cap, u64* out) {
  std::vector<Node> tile(cap);
  std::vector<unsigned short> order(cap);
  std::vector<unsigned char> zone_of(cap);
  int count[kZoneCap + 2] = {};
  int base[kZoneCap + 2] = {};
  int cursor[kZoneCap + 2] = {};
  for (i64 j = 0; j < s; ++j) {
    const Divisors d[1] = {stage_divisors(cr[j], mr[j])};
    for (i64 b = 0; b < n; b += chunk) {
      const i64 e = b + chunk < n ? b + chunk : n;
      int filled = 0;
      for (i64 g = b; g < e; ++g) {
        const i64 z = zone[g];
        if (z >= 1 && z <= zones && healthy[g] != 0 &&
            (mask == nullptr || mask[g] != 0)) {
          tile[filled] = stage_node<true>(ac[g], am[g], ap[g], uc[g], um[g],
                                          pc[g], 1);
          zone_of[filled] = static_cast<unsigned char>(z);
          ++count[z];
          ++filled;
        }
        if (filled < cap && g + 1 < e) continue;
        zone_bases(count, zones, base, cursor);
        // The card's order within a zone is any; here it is reversed.
        for (int i = filled - 1; i >= 0; --i) {
          order[cursor[zone_of[i]]++] = static_cast<unsigned short>(i);
        }
        for (int zz = 1; zz <= zones; ++zz) {
          u64 acc[1] = {0};
          segment_sums<1>(tile.data(), order.data(), base[zz], base[zz + 1],
                          d, acc);
          out[zz * s + j] += acc[0];
        }
        filled = 0;
      }
    }
  }
  for (i64 j = 0; j < s; ++j) {
    out[j] = static_cast<u64>(spread_total(out + s + j, s, zones, max_skew));
  }
}
"""


@pytest.fixture(scope="module")
def host_spread(tmp_path_factory):
    """``csrc/sweep_spread.cu``'s host-side functions compiled with
    ``g++`` (no CUDA toolkit needed), behind the block loop above."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the spread kernel's functions")
    tmp = tmp_path_factory.mktemp("sweep_spread_host")
    src = tmp / "harness.cc"
    src.write_text(_HOST_HARNESS.replace(
        "SWEEP_SPREAD_CU", str(_build.CSRC / "sweep_spread.cu")))
    lib = tmp / "libharness.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror", "-shared",
         "-fPIC", "-o", str(lib), str(src)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    fn = ctypes.CDLL(str(lib)).kccap_spread_host
    fn.argtypes = (ctypes.c_void_p,) * 11 + (
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)
    fn.restype = None
    return fn


def _ptr(a):
    return None if a is None else a.ctypes.data


def _case(variant, n, s, n_zones, empty_zone, seed):
    cols, cpu, mem, reps, mask, _ = exact_edges.case(variant, n, s, seed)
    member = exact_edges.zones(n, n_zones, seed + 4, empty_zone=empty_zone)
    return cols, cpu, mem, reps, mask, member


def numpy_spread(fits, member, n_zones, max_skew):
    """The zone sums and the clamp over ``fits[S, N]`` in numpy int64
    (its sums and adds wrap)."""
    c = np.stack([fits[:, member == z].sum(axis=1, dtype=np.int64)
                  for z in range(1, n_zones + 1)], axis=1)
    cap = c.min(axis=1) + np.int64(max_skew)
    return np.minimum(c, cap[:, None]).sum(axis=1, dtype=np.int64)


def _plain(cols, cpu, mem, reps, mask, member, n_zones, max_skew):
    return t_fit._spread_plain(
        [torch.from_numpy(np.ascontiguousarray(c)) for c in cols],
        torch.from_numpy(cpu), torch.from_numpy(mem), torch.from_numpy(reps),
        torch.from_numpy(member), n_zones, max_skew,
        None if mask is None else torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("n,s,chunk,cap", [
    (257, 12, 257, 512),   # one chunk, one round
    (257, 12, 38, 8),      # the cell's chunk of 38, rounds of 8
    (1, 3, 16, 512),       # one node
    (600, 5, 100, 256),    # several chunks of several zones each
])
@pytest.mark.parametrize("max_skew", exact_edges.SKEWS)
@pytest.mark.parametrize("n_zones,empty_zone", [
    (1, False), (3, False), (3, True), (t_fit.SPREAD_ZONE_CAP, False),
    (t_fit.SPREAD_ZONE_CAP, True)])
@pytest.mark.parametrize("variant", ["flat", "masked", "every-masked"])
def test_spread_kernel_functions_as_host_code_match_numpy_and_plain(
        host_spread, variant, n_zones, empty_zone, max_skew, n, s, chunk,
        cap):
    cols, cpu, mem, reps, mask, member = _case(variant, n, s, n_zones,
                                               empty_zone, n + s + n_zones)
    out = np.zeros((n_zones + 1) * s, np.uint64)
    # Every array handed over by address is held by a name for the call.
    cells = [np.ascontiguousarray(c) for c in cols[:6]]
    healthy = cols[6].astype(np.uint8)
    mask8 = None if mask is None else mask.astype(np.uint8)
    host_spread(*(_ptr(c) for c in cells), _ptr(healthy), _ptr(mask8),
                _ptr(member), _ptr(cpu), _ptr(mem), n, s, n_zones, max_skew,
                chunk, cap, _ptr(out))
    fits = t_fit.fit_per_node(
        *[torch.from_numpy(np.ascontiguousarray(c)) for c in cols],
        torch.from_numpy(cpu)[:, None], torch.from_numpy(mem)[:, None],
        mode="strict",
        node_mask=None if mask is None else torch.from_numpy(mask)).numpy()
    sums = out.view(np.int64).reshape(n_zones + 1, s)
    for z in range(1, n_zones + 1):
        np.testing.assert_array_equal(
            sums[z], fits[:, member == z].sum(axis=1, dtype=np.int64))
    want = numpy_spread(fits, member, n_zones, max_skew)
    np.testing.assert_array_equal(sums[0], want)
    np.testing.assert_array_equal(
        sums[0], _plain(cols, cpu, mem, reps, mask, member, n_zones,
                        max_skew))


def test_the_clamp_wraps_as_int64_torch_does(host_spread):
    """A domain sum near INT64_MAX plus ``max_skew`` 2^62 wraps negative,
    so every domain takes the wrapped cap, as ``floor + max_skew`` does in
    int64 torch: one node a zone, each with every resource free and a
    request of 1, so each fit is the node's free pod slots."""
    big = 2**62 + 5
    free = np.full(2, 2**63 - 1, np.int64)
    zero = np.zeros(2, np.int64)
    cols = [free, free, np.array([big, big + 1], np.int64), zero, zero,
            zero, np.ones(2, bool)]
    cpu, mem = np.ones(1, np.int64), np.ones(1, np.int64)
    member = np.array([1, 2], np.int64)
    out = np.zeros(3, np.uint64)
    healthy = cols[6].astype(np.uint8)
    host_spread(*(_ptr(c) for c in cols[:6]), _ptr(healthy), None,
                _ptr(member), _ptr(cpu), _ptr(mem), 2, 1, 2, 2**62, 2, 512,
                _ptr(out))
    cap = np.array([big], np.int64) + np.int64(2**62)  # wraps below zero
    assert cap[0] < 0
    want = cap + cap  # the sum wraps too
    np.testing.assert_array_equal(out.view(np.int64)[:1], want)
    np.testing.assert_array_equal(
        out.view(np.int64)[:1],
        _plain(cols, cpu, mem, np.ones(1, np.int64), None, member, 2,
               2**62))


def test_the_zone_cap_matches_the_kernel_source():
    """``SPREAD_ZONE_CAP`` routes what the kernel's ``kZoneCap`` holds."""
    text = (_build.CSRC / "sweep_spread.cu").read_text()
    assert f"constexpr int kZoneCap = {t_fit.SPREAD_ZONE_CAP};" in text


@pytest.mark.parametrize("n_zones", [1, 3, t_fit.SPREAD_ZONE_CAP,
                                     t_fit.SPREAD_ZONE_CAP + 1])
def test_sweep_spread_on_the_cpu_runs_the_plain_version(n_zones):
    cols, cpu, mem, reps, mask, member = _case("masked", 300, 20, n_zones,
                                               False, 5)
    t = [torch.from_numpy(np.ascontiguousarray(c)) for c in cols]
    launches, plain = t_fit.SPREAD_LAUNCHES, t_fit.SPREAD_PLAIN_CALLS
    got = t_fit.sweep_spread(*t, torch.from_numpy(cpu), torch.from_numpy(mem),
                             torch.from_numpy(reps), torch.from_numpy(member),
                             n_zones, 1, node_mask=torch.from_numpy(mask))
    assert (t_fit.SPREAD_LAUNCHES, t_fit.SPREAD_PLAIN_CALLS) == \
        (launches, plain + 1)
    np.testing.assert_array_equal(
        got.numpy(), _plain(cols, cpu, mem, reps, mask, member, n_zones, 1))


def test_topology_spread_grid_on_the_cpu_counts_one_plain_call():
    fx = synthetic_fixture(90, seed=6, taint_frac=0.1, topology=(3, 1))
    snap = snapshot_from_fixture(fx, semantics="strict")
    model = CapacityModel(snap, mode="strict", fixture=fx, device="cpu")
    grid = random_scenario_grid(50, seed=7)
    launches, plain = t_fit.SPREAD_LAUNCHES, t_fit.SPREAD_PLAIN_CALLS
    totals, sched = model.topology_spread_grid(grid, topology_key="zone")
    assert (t_fit.SPREAD_LAUNCHES, t_fit.SPREAD_PLAIN_CALLS) == \
        (launches, plain + 1)
    one = model.topology_spread(PodSpec(
        cpu_request_milli=int(grid.cpu_request_milli[17]),
        mem_request_bytes=int(grid.mem_request_bytes[17])),
        topology_key="zone")
    assert int(totals[17]) == one.total
    np.testing.assert_array_equal(sched, totals >= grid.replicas)
