"""Build and load the CUDA kernels of ``kernels/csrc``.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, into ``build/repro_torch/<hash>/`` at the root of the checkout
(``REPRO_TORCH_BUILD_DIR`` overrides it), keyed by a hash of the sources and
flags, so an unchanged tree reuses its library.

Nothing here runs at import: the CPU tests import every module of the
package and this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# C entry points and their argument types (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits).
SIGNATURES = {
    "cache_probe_launch": [_P, _P, _P, _L, _I, _I, _I, _P, _P],
    "gather_elems_launch": [_P, _P, _P, _L, _L, _I, _P, _P],
    "gather_lines_launch": [_P, _P, _L, _L, _I, _P, _P],
    "probe_allocate_scratch_words": [_L, _L, _I],
    "probe_allocate_launch": (
        [_P] * 10 + [_L, _L] + [_I] * 7 + [_P, _P, _L, _P]),
    "paged_attention_workspace_floats": [_I] * 5,
    "paged_attention_launch": [_P] * 5 + [_I] * 7 + [_F, _I] + [_P] * 4,
    "flash_attention_launch": (
        [_P] * 3 + [_I] * 8 + [_L, _F, _I, _P, _P, _P]),
    "flash_attention_tc_launch": (
        [_P] * 3 + [_I] * 8 + [_L, _F, _P, _P, _P]),
    "flash_attention_bwd_workspace_floats": [_I] * 8 + [_L, _I],
    "flash_attention_bwd_launch": (
        [_P] * 6 + [_I] * 8 + [_L, _F, _I] + [_P] * 5),
    "flash_attention_bwd_tc_launch": (
        [_P] * 6 + [_I] * 8 + [_L, _F] + [_P] * 5),
    "sq_enqueue_launch": [_P] * 15 + [_I] * 6 + [_P, _I, _P, _I, _P, _P],
    "wfq_drain_launch": [_P] * 4 + [_I] * 5 + [_L, _I, _L, _L, _P, _P, _P],
}
# entry points that return something other than a CUDA status (int)
RESTYPES = {"paged_attention_workspace_floats": _L,
            "probe_allocate_scratch_words": _L,
            "flash_attention_bwd_workspace_floats": _L}

_lock = threading.Lock()
_lib = None
build_log = ""


class LaunchCount:
    """Launches of one kernel wrapper: the wrapper adds one where it
    launches its kernel, and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0

    def __repr__(self) -> str:
        return f"LaunchCount({self.name!r}, n={self.n})"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> pathlib.Path:
    base = os.environ.get("REPRO_TORCH_BUILD_DIR")
    root = pathlib.Path(base) if base else REPO_ROOT / "build" / "repro_torch"
    return root / _digest()


def build() -> pathlib.Path:
    """Compile (if needed) and return the path of the shared library."""
    global build_log
    out_dir = build_dir()
    lib_path = out_dir / "libbam_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=out_dir.parent, prefix=".tmp-"))
    srcs = sources()
    objs = [tmp / (s.stem + ".o") for s in srcs]
    procs = [subprocess.Popen(
        [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(s),
         "-o", str(o)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for s, o in zip(srcs, objs)]
    logs, failed = [], []
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        logs.append(f"== {s.name}\n{out}")
        if p.returncode != 0:
            failed.append(s.name)
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / lib_path.name),
         *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    build_log = "\n".join(logs)
    (tmp / "build.log").write_text(build_log)
    try:
        os.replace(tmp, out_dir)
    except OSError:                 # another process finished first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _lib = handle
        return _lib


def check_tensor(kernel: str, name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's C entry assumes of its pointers."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous {dtype} "
                         f"tensor of shape {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def check(status: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (its ``cudaGetLastError``)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def stream_ptr(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device.  Read
    through the accessor PyTorch's own generated kernel launchers use: the
    public ``torch.cuda.current_stream(...).cuda_stream`` builds a Stream
    object first, about 5 us a call on the H100's host against 0.15 us."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)
