"""nvcc build and ctypes loading of the port's CUDA sources.

Every kernel of the port is one ``.cu`` file under its package's ``csrc/``
with a plain C entry point.  It is compiled with ``nvcc`` for ``sm_90a``
into a shared library at its first launch, never at import.  Libraries land
in ``build/repro_torch_kernels/`` at the repository root (override with
``REPRO_TORCH_BUILD_DIR``), named by the source's stem and a hash of the
source and the flags, so an edited source rebuilds.  :func:`build` starts
one ``nvcc`` per source that is not built yet, all at once, and waits for
them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[Path, ctypes.CDLL] = {}


def build_dir() -> Path:
    """Where the shared libraries are built (created on demand)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/ -> repository root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def library_path(source: Path) -> Path:
    """The shared library's path for ``source`` and the flags."""
    digest = hashlib.sha256(
        Path(source).read_bytes() + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return build_dir() / f"lib{Path(source).stem}_{digest}.so"


def build(*sources: Path) -> list[Path]:
    """Compile every source whose library is not built yet, one ``nvcc``
    each, all running at once; returns the libraries' paths in order.  The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``<library>.log``.  A library is written
    under a temporary name and renamed into place, so concurrent builds
    never load a half-written file."""
    outs = [library_path(s) for s in sources]
    jobs = []
    try:
        for src, out in zip(sources, outs):
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((src, out, tmp, proc))
        failed = []
        for src, out, tmp, proc in jobs:
            log = proc.communicate()[0]
            Path(str(out) + ".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) building "
                              f"{src}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return outs


def load(source: Path, signatures: dict[str, list]) -> ctypes.CDLL:
    """Build ``source`` if needed and load its library, once per process;
    declares each C entry point of ``signatures`` (name -> argtypes) as
    returning a CUDA error code (``int``)."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)[0]))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return lib
