"""Build the port's CUDA kernels with nvcc, at first use.

Each kernel source under ``csrc/`` is compiled for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The library lands
in ``build/torch_kernels/`` beside the package (listed in ``.gitignore``),
named by a hash of its source and of the shared headers (``csrc/*.cuh``), so
an edited source or header is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]


class Built(NamedTuple):
    path: Path
    seconds: float   # 0.0 when an existing build was reused
    log: str         # nvcc's output (ptxas registers, shared memory, spills),
    #                  also kept beside the library as lib<name>-<hash>.log


_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.access(os.path.join(cand, "bin", "nvcc"), os.X_OK):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH):"
                           " the port's CUDA kernels cannot be built")
    return found


def source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu`` and every header under ``csrc/`` (a
    source may include any of them), in a fixed order."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source and
    headers exists. Raises with nvcc's output when the compile fails."""
    src = CSRC_DIR / f"{name}.cu"
    digest = source_digest(name)
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return Built(out, 0.0, log_path.read_text() if log_path.exists()
                     else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a private name, then rename: a concurrent process never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} (rc {proc.returncode}):"
                               f"\n{proc.stdout}\n{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return Built(out, time.perf_counter() - t0, log_path.read_text())


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name).path))
    return lib
