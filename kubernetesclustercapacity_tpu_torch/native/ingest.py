"""Loader for the native columnar pod walk (``ingest.cc``).

Counterpart of ``kubernetesclustercapacity_tpu/native/ingest.py``.  The
CPython extension builds on first use with ``g++`` (the same mtime-keyed,
atomic-rename scheme as the capacity library, into the package's
``_build/``) and imports through
:class:`importlib.machinery.ExtensionFileLoader`: no pybind11 or
setuptools, only ``Python.h`` from the running interpreter.

The walk returns ``None`` for anything not JSON-shaped; callers then run
the pure-Python loop, so errors are identical with or without the
extension.  ``KCC_DISABLE_NATIVE_INGEST=1`` turns it off outright (the
parity tests pin native == pure on randomized fixtures with it).
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import sysconfig
import threading

from kubernetesclustercapacity_tpu_torch.native import _build_util

__all__ = [
    "available",
    "walk_reference",
    "walk_strict",
    "NativeIngestUnavailable",
]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ingest.cc")
_LOCK = threading.Lock()
_MOD = None
_BUILD_ERROR: str | None = None


class NativeIngestUnavailable(RuntimeError):
    pass


def _so_name() -> str:
    """ABI-tagged extension filename (e.g. ``_kccap_ingest.cpython-312-
    x86_64-linux-gnu.so``): a checkout shared across interpreter versions
    never dlopens an extension built against another version's
    ``Python.h``."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return f"_kccap_ingest{suffix}"


def _build() -> str:
    try:
        return _build_util.build_so(
            _SRC,
            _so_name(),
            compile_args=(f"-I{sysconfig.get_paths()['include']}",),
        )
    except RuntimeError as e:
        raise NativeIngestUnavailable(
            f"native ingest build failed: {e}"
        ) from e


def _import_so(so_path: str):
    loader = importlib.machinery.ExtensionFileLoader("_kccap_ingest", so_path)
    spec = importlib.util.spec_from_loader("_kccap_ingest", loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


def _load():
    global _MOD, _BUILD_ERROR
    with _LOCK:
        if _MOD is not None:
            return _MOD
        if _BUILD_ERROR is not None:
            raise NativeIngestUnavailable(_BUILD_ERROR)
        try:
            so_path = _build()
            try:
                _MOD = _import_so(so_path)
            except ImportError:
                # A cached object that no longer loads: rebuild once from
                # scratch.  If it cannot even be removed (read-only dir),
                # the retried import fails again and lands below.
                try:
                    os.unlink(so_path)
                except OSError:
                    pass
                try:
                    _MOD = _import_so(_build())
                except ImportError as e:
                    raise NativeIngestUnavailable(
                        f"native ingest load failed: {e}"
                    ) from e
        except NativeIngestUnavailable as e:
            _BUILD_ERROR = str(e)
            raise
        except OSError as e:  # any loader-side filesystem surprise
            _BUILD_ERROR = f"native ingest unavailable: {e}"
            raise NativeIngestUnavailable(_BUILD_ERROR) from e
        return _MOD


def available() -> bool:
    if os.environ.get("KCC_DISABLE_NATIVE_INGEST"):
        return False
    try:
        _load()
        return True
    except NativeIngestUnavailable:
        return False


def walk_reference(pods, excluded_phases):
    """Native reference-mode pod walk; ``None`` means fall back."""
    return _load().walk_reference(pods, excluded_phases)


def walk_strict(pods, index, terminated, extended):
    """Native strict-mode pod walk; ``None`` means fall back."""
    return _load().walk_strict(pods, index, terminated, extended)
