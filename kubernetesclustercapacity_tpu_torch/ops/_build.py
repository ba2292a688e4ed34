"""The seam of the port's CUDA kernels: builds them with ``nvcc``, loads
them with ctypes, checks their operands, binds and launches them.

Each ``csrc/<name>.cu`` compiles on first use into
``kubernetesclustercapacity_tpu_torch/_build/lib<name>-<hash>.so``, a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  The hash covers the sources and the flags, so an edited
source rebuilds and an unchanged one loads the library already built.
Nothing is downloaded: only the sources in the package are compiled.

The flags target ``sm_90a`` (H100) and deliberately leave out
``--use_fast_math``, ``-ftz=true`` and FMA contraction: the fused sweep
kernel's reciprocal-division proof needs correctly rounded f32 steps.
``-Xptxas -v`` writes each kernel's register and shared-memory use into a
``.ptxas.txt`` report beside the library.

Every C entry ``kccap_<name>`` takes its operand pointers, the int64
totals it adds into, then ``n``, ``s``, any further int and then int64
scalars, the nodes per block (:func:`node_chunk`), ``strict`` and the
stream; :func:`bind` is the one place that calls one.  The wrappers
above (``fused_fit.sweep_fused``, ``fused_multi.sweep_multi`` and the
exact and zone-spread sweeps in ``fit``) keep their own launch counters
(:func:`count`).  A ``csrc/*.cuh`` header holds code that several
kernels share.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "bind", "build", "check_operands",
           "count", "library", "node_chunk", "ptxas_report"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: Threads per block of the CUDA kernels (``kThreads`` in the sources), and
#: the scenarios each thread owns (``kSpt``): a block covers
#: ``SCENARIOS_PER_BLOCK`` scenarios.  B2 above 8 resource rows takes one
#: scenario per thread; its grid is sized in its C entry.
THREADS_PER_BLOCK = 128
SCENARIOS_PER_THREAD = 2
SCENARIOS_PER_BLOCK = THREADS_PER_BLOCK * SCENARIOS_PER_THREAD
#: Blocks the kernels aim for on each SM, and the fewest nodes a block
#: takes (so a block's staging is worth its launch); measured choices, see
#: PERF.md.  At 10,000 nodes a block takes 76, so the minimum acts only on
#: small node counts, such as the grouped sweep's 48 groups.
BLOCKS_PER_SM = 4
MIN_NODES_PER_BLOCK = 16

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA toolkit is "
        "needed to build the port's kernels"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path.  Raises with nvcc's output on failure."""
    digest = _digest(name)
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    (BUILD_DIR / f"{name}-{digest}.ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def ptxas_report(name: str) -> str:
    """``-Xptxas -v`` output of the build of ``csrc/<name>.cu``."""
    build(name)
    return (BUILD_DIR / f"{name}-{_digest(name)}.ptxas.txt").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib


def node_chunk(n: int, s: int, sm_count: int) -> int:
    """Nodes per block along the CUDA kernels' grid's y axis: enough
    blocks to give every SM ``BLOCKS_PER_SM`` of them, no block under
    ``MIN_NODES_PER_BLOCK`` nodes, and at most 65535 chunks."""
    scenario_blocks = -(-s // SCENARIOS_PER_BLOCK)
    want_chunks = max(1, -(-BLOCKS_PER_SM * sm_count // scenario_blocks))
    chunk = max(MIN_NODES_PER_BLOCK, -(-n // want_chunks))
    return max(chunk, -(-n // 65535))


#: Guards the launch counters of the kernels' wrappers: the service's
#: handler threads dispatch concurrently, and ``+=`` on a module global is
#: not atomic.
_COUNT_LOCK = threading.Lock()


def count(counters: dict, name: str) -> None:
    """Add one to the counter ``name`` of a module's ``globals()``."""
    # kccap: lint-ok[device-purity] the launch counter: one uncontended lock per launch, never per step
    with _COUNT_LOCK:
        counters[name] += 1


def check_operands(spec, kernel: str) -> torch.device:
    """Raise on an operand the kernel cannot take; return the operands'
    device.  ``spec`` lists ``(tensor, dtype, shape)`` (a None tensor is an
    optional operand left out); each must be on the first one's device,
    of its dtype and shape, and contiguous.  ``kernel`` names the kernel
    in the messages."""
    device = spec[0][0].device
    for t, dtype, shape in spec:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(
                f"{kernel} operands span devices ({t.device} vs {device})"
            )
        if t.dtype != dtype:
            raise TypeError(f"{kernel} operand is {t.dtype}, want {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{kernel} operand has shape {tuple(t.shape)}, want {shape}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{kernel} operands must be contiguous")
    return device


def _entry(name: str, argtypes: tuple):
    """``kccap_<name>`` of the built library, declared on first use
    (without ``argtypes`` ctypes would pass each pointer as a 32-bit
    int)."""
    fn = getattr(library(name), f"kccap_{name}")
    if fn.argtypes != argtypes:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def bind(name: str, operands: tuple, n: int, s: int, strict: bool,
         extra: tuple = (), extra64: tuple = (), rows: int = 1):
    """The kernel of ``csrc/<name>.cu`` bound to its operands, on CUDA
    tensors: ``(totals, launch)``.

    ``operands`` are the tensors before the totals in the C entry's order
    (None for an optional one left out), ``n`` and ``s`` the node and
    scenario counts, ``extra`` the int scalars and ``extra64`` the int64
    scalars the entry takes after them.  ``totals`` is a zeroed int64
    ``[rows * S]`` on the operands' device, ``rows`` above 1 for a kernel
    that keeps partial sums beside its totals (the first ``S``); each
    ``launch()`` makes one launch on the current stream that adds the
    sweep's totals into it, raises on a non-zero launch code (the
    kernels allocate nothing, and nothing falls back) and returns True.
    Where N or S is 0 there is nothing to launch, and ``launch()``
    returns False."""
    device = operands[0].device
    totals = torch.zeros(rows * s, dtype=torch.int64, device=device)
    if n == 0 or s == 0:
        return totals, lambda: False
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    args = (*(None if t is None else t.data_ptr() for t in operands),
            totals.data_ptr(), n, s, *extra, *extra64,
            node_chunk(n, s, sms), int(bool(strict)))
    argtypes = ((ctypes.c_void_p,) * (len(operands) + 1)
                + (ctypes.c_longlong, ctypes.c_int)
                + (ctypes.c_int,) * len(extra)
                + (ctypes.c_longlong,) * len(extra64)
                + (ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p))
    # kccap: lint-ok[device-purity] cached build: nvcc runs once per process, at first use, never per launch
    fn = _entry(name, argtypes)

    def launch() -> bool:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"{name} kernel launch failed: CUDA error {rc}"
            )
        return True

    return totals, launch
