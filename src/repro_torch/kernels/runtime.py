"""Device rule and kernel build for the port.

Counterpart of ``repro/kernels/runtime.py``: where the JAX package
resolves Pallas' ``interpret=`` flag per backend, the port decides by the
tensor's device. A tensor on the CPU takes a kernel's plain PyTorch
version; a CUDA tensor launches the hand-written kernel or raises.

Kernels are CUDA C++ sources under ``repro_torch/csrc``. Each source is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library with a
plain C interface, loaded with :mod:`ctypes`. The libraries live in the
build directory (``<checkout>/build/kernels`` unless
:func:`set_build_dir` chose another: serve's ``--compile-cache-dir``)
keyed by a hash of the sources and flags, and are built at first use, so
a restart pointed at a filled directory loads each library found there
and runs ``nvcc`` only for a source whose hash is new. Each build is one
compile for the armed
:class:`~repro_torch.analysis.sanitize.CompileCounter` (``nvcc:<source>``).
A missing ``nvcc``, a failed build or an unwritable directory raises:
nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import torch

from repro_torch.analysis.sanitize import record_compile

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
# <checkout>/build/kernels (src/repro_torch/kernels -> checkout root)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOADED_FROM: Dict[str, Path] = {}
_LOCK = threading.Lock()
_build_dir = BUILD_DIR


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` means CUDA. Asking for CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether the call runs the kernel (all tensors on one CUDA device)
    or the plain version (all on the CPU). Mixed placement raises."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors must share one device, got {devs}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin); the port's kernels are "
        "built from source at first use and have no fallback")


def _headers() -> Sequence[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def build_dir() -> Path:
    """The directory the kernel libraries are built into and loaded
    from."""
    return _build_dir


def set_build_dir(path: Union[str, Path]) -> Path:
    """Build and load the kernel libraries in ``path`` from now on
    (created if missing). Libraries already loaded stay loaded. An
    unwritable directory raises."""
    global _build_dir
    p = Path(path).resolve()
    p.mkdir(parents=True, exist_ok=True)
    if not os.access(p, os.W_OK | os.X_OK):
        raise PermissionError(f"kernel build directory {p} is not "
                              "writable")
    with _LOCK:
        _build_dir = p
    return p


def loaded_libraries() -> Dict[str, str]:
    """Source name -> the path each loaded library came from."""
    return {name: str(path) for name, path in sorted(_LOADED_FROM.items())}


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives: keyed by a hash of
    the source, the shared headers and the compiler flags."""
    h = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *_headers()]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _build_dir / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source unless its library exists already;
    returns ``(process, temporary output, final path)`` or ``None``. The
    output goes to a temporary name and is renamed on success, so a
    concurrent or interrupted build never leaves a partial library."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    record_compile(f"nvcc:{name}")
    return proc, tmp, out


def _finish_build(name: str, proc: subprocess.Popen, tmp: str,
                  out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Optional[Sequence[str]] = None) -> None:
    """Build every kernel source (or ``names``), one ``nvcc`` per source,
    all started together."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu")) \
        if names is None else list(names)
    with _LOCK:
        started = [(n, _start_build(n)) for n in names]
        try:
            for n, job in started:
                if job is not None:
                    _finish_build(n, *job)
        finally:
            for _, job in started:
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        path = library_path(name)
        lib = ctypes.CDLL(str(path))
        _LOADED_FROM[name] = path
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its launch's
    ``cudaGetLastError()``)."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The current PyTorch stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
