"""Build the port's CUDA C++ kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, on its own, into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) under
``densematchingbenchmark_tpu_torch/_build/``, named by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags: a changed source is
rebuilt at first use, an unchanged one is loaded as built. ``build()`` starts one nvcc per source, all at once.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("conv3d_kernel", "packed_conv3d_kernel", "upsample_argmin_kernel")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                           "the CUDA kernels are built on a machine with "
                           "the CUDA toolkit")
    return path


def library_path(name):
    """The library's path, named by a hash of its source, the headers in
    ``csrc/`` and the flags."""
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES):
    """Compile every library of ``names`` not built yet, one nvcc process
    per source, all started together. Returns {name: nvcc output} (ptxas
    register and shared-memory report) for the ones it compiled."""
    jobs = []
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, proc, tmp, out))
        logs = {}
        for name, proc, tmp, out in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, out)
            logs[name] = log
        return logs
    finally:
        for _, proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def load(name, signatures):
    """ctypes handle of library ``name`` (built first if needed), with
    ``signatures`` = {function: (argtypes, restype)} declared on it."""
    if name not in _loaded:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return _loaded[name]


def check_launch(err, what):
    """Raise if a launch returned a nonzero CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def current_stream():
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
