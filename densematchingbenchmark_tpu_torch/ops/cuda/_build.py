"""Build the port's CUDA C++ kernels with nvcc, and its host library with
g++, and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, on its own, into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) under
``densematchingbenchmark_tpu_torch/_build/``, named by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags: a changed source is
rebuilt at first use, an unchanged one is loaded as built. The host
library ``csrc/dmb_native.cpp`` (the data pipeline's decoders,
densematchingbenchmark_tpu_torch/native) is built the same way by g++,
named by a hash of its source and flags. Each build writes a temporary
file and renames it into place, so processes that build at once do not
collide. ``build()`` starts one compiler per source, all at once.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("conv3d_kernel", "packed_conv3d_kernel", "packed_conv3d_v2_kernel",
           "upsample_argmin_kernel")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the host route: C++ sources built by g++, no CUDA
HOST_SOURCES = ("dmb_native",)
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_loaded = {}
_lock = threading.Lock()   # threads that load a library at once


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


def _gxx():
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH; the port's host library "
                           "(csrc/dmb_native.cpp) is built with g++")
    return found


def _source(name):
    """(source path, the files its hash covers, flags) of library
    ``name``."""
    if name in HOST_SOURCES:
        src = CSRC / f"{name}.cpp"
        return src, [src], HOST_FLAGS
    src = CSRC / f"{name}.cu"
    return src, [src, *sorted(CSRC.glob("*.cuh"))], NVCC_FLAGS


def library_path(name):
    """The library's path, named by a hash of its source (with the headers
    in ``csrc/`` for a CUDA source) and the flags."""
    _, files, flags = _source(name)
    src = b"".join(p.read_bytes() for p in files)
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES + HOST_SOURCES):
    """Compile every library of ``names`` not built yet, one compiler
    process per source (nvcc, or g++ for a host source), all started
    together. Returns {name: compiler output} (ptxas's register and
    shared-memory report for a CUDA source) for the ones it compiled; a
    failed build raises with the compiler's output."""
    jobs = []
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            src, _, flags = _source(name)
            compiler = _gxx() if name in HOST_SOURCES else _nvcc()
            cmd = [compiler, *flags, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, proc, tmp, out, src))
        logs = {}
        for name, proc, tmp, out, src in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{os.path.basename(proc.args[0])} "
                                   f"failed for {src.name}:\n{log}")
            os.replace(tmp, out)
            logs[name] = log
        return logs
    finally:
        for _, proc, _, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def load(name, signatures):
    """ctypes handle of library ``name`` (built first if needed), with
    ``signatures`` = {function: (argtypes, restype)} declared on it."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
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


def current_stream(device):
    """The current CUDA stream of ``device`` (a CUDA torch.device; an index
    of None is the current device) as a pointer for a launch, read without
    making a Stream object (which costs a launch several microseconds).
    A launch passes its operand's device and runs under
    ``torch.cuda.device`` of it: a kernel runs on the current device,
    whatever stream it is given."""
    import torch
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))
