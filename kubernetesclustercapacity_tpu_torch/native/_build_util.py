"""On-demand ``g++`` build of the native components.

Both native loaders (the ctypes capacity library and the ingest CPython
extension) build their shared object the same way: into the package's
git-ignored ``_build/`` directory, keyed on source mtime, through a temp
file and an atomic rename so that concurrent processes never dlopen a
half-written object.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

__all__ = ["BUILD_DIR", "build_so"]

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)


def build_so(
    src: str,
    out_name: str,
    *,
    compile_args: tuple[str, ...] = (),
    link_args: tuple[str, ...] = (),
) -> str:
    """Build ``src`` into ``_build/<out_name>`` iff missing or stale.

    Returns the shared object's path; raises :class:`RuntimeError` with
    the compiler's stderr on failure.
    """
    # Everything that touches the filesystem sits inside the try: a
    # read-only checkout (PermissionError from makedirs/mkstemp) must
    # surface as the RuntimeError the loaders turn into "unavailable".
    tmp = None
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        so_path = os.path.join(BUILD_DIR, out_name)
        if (
            os.path.exists(so_path)
            and os.path.getmtime(so_path) >= os.path.getmtime(src)
        ):
            return so_path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [
            "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
            *compile_args, "-o", tmp, src, *link_args,
        ]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, so_path)
    except (OSError, subprocess.CalledProcessError) as e:
        if tmp is not None and os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
        raise RuntimeError(getattr(e, "stderr", "") or str(e)) from e
    return so_path
