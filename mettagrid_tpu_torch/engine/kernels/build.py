"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``engine/csrc/<name>.cu`` source has a plain C interface. It is compiled
for Hopper (sm_90a) into ``build/mettagrid_tpu_torch/<name>-<hash>.so`` at the
root of the checkout, keyed by a hash of the source, the shared headers
(``engine/csrc/*.cuh``) and the flags, at first use. Nothing here runs when
the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "mettagrid_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = (
    "obs_tail_static_v2", "obs_tail_dynobj_v2", "obs_tail_dyn_v2", "obs_tail_static_v1", "obs_tail_v1",
    "window_slices", "compact_rows",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and Path(cuda_home, "bin", "nvcc").exists():
        return str(Path(cuda_home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=KERNELS) -> dict:
    """Compile every named kernel that is not built yet, one nvcc process per
    source, all started together. Returns {name: (seconds, compiler log)};
    an already-built kernel reports (0.0, "")."""
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, target)
    report = {name: (0.0, "") for name in names}
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, target)
        report[name] = (time.perf_counter() - t0, log)
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
