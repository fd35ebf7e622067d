"""Build the port's CUDA kernels with nvcc, at first use.

Each kernel source under ``csrc/`` is compiled for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. A source that
defines ``DSST_PARTS n`` is compiled as n units at once (``-DDSST_PART=k``,
one nvcc process each; the source decides what each unit instantiates),
then linked: the build takes as long as its slowest unit. The library lands
in ``build/torch_kernels/`` beside the package (listed in ``.gitignore``),
named by a hash of its source and of the shared headers (``csrc/*.cuh``), so
an edited source or header is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported.
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v"]


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


def source_parts(src: Path) -> int:
    """The units ``src`` compiles as (its ``#define DSST_PARTS n``; 1)."""
    m = re.search(r"^#define DSST_PARTS (\d+)$", src.read_text(), re.M)
    return int(m.group(1)) if m else 1


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source and
    headers exists: its units at once, then one link. Raises with nvcc's
    output when a compile or the link fails."""
    src = CSRC_DIR / f"{name}.cu"
    digest = source_digest(name)
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return Built(out, 0.0, log_path.read_text() if log_path.exists()
                     else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    # compile in a private directory and rename the library into place: a
    # concurrent process never sees a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"part{k}.o")
                for k in range(source_parts(src))]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", f"-DDSST_PART={k}", "-o", obj,
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for k, obj in enumerate(objs)]
        logs = [p.communicate()[0] for p in procs]
        for k, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} unit {k} (rc "
                                   f"{p.returncode}):\n{text}")
        lib = os.path.join(tmp, out.name)
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", lib,
                               *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"linking {src} failed (rc {proc.returncode})"
                               f":\n{proc.stdout}\n{proc.stderr}")
        log_path.write_text("".join(logs) + proc.stdout + proc.stderr)
        os.replace(lib, out)
    return Built(out, time.perf_counter() - t0, log_path.read_text())


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name).path))
    return lib
