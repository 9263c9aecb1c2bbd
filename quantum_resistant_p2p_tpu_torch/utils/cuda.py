"""Build, load and call the port's CUDA kernels (``csrc/*.cu``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain ``extern "C"`` interface, and loaded
with ``ctypes``.  Libraries go to ``build/torch_kernels/`` at the root of
the checkout (listed in ``.gitignore``), named by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built at import: the first launch of a kernel builds its
library, and :func:`build` compiles several sources in parallel up front.

Every C entry point returns a ``cudaError_t``; :func:`check` raises on any
value but 0.  A missing ``nvcc`` or a failed build raises too: there is no
path that quietly runs something else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_initialised: set[tuple[str, int]] = set()  # (library, device index)


_count_lock = threading.Lock()
_thread = threading.local()


def count_launch(wrapper, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` to a kernel wrapper's launch counter.  Locked: the
    serving queues launch from a pool of device threads, and ``+=`` on an
    attribute is a read, an add and a write that another thread may
    interleave.  Each thread also keeps its own tally
    (:func:`thread_launches`)."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + n)
    tally = _thread.__dict__.setdefault("tally", {})
    key = (id(wrapper), attr)
    tally[key] = tally.get(key, 0) + n


def thread_launches(wrapper, attr: str = "launches") -> int:
    """The launches of ``wrapper`` counted on the calling thread: what one
    caller launched while other threads launch the same kernel."""
    return _thread.__dict__.get("tally", {}).get((id(wrapper), attr), 0)


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False")
    return dev


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the .cu and every shared header
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...]) -> dict[str, float]:
    """Compile the named sources that are not built yet, all ``nvcc``
    processes at once.  Returns the wall seconds per source built; the
    ptxas report (registers, shared memory, spills) is kept beside each
    library as ``<lib>.ptxas.txt``."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        library_path(n).with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each C entry point to its ``argtypes`` (all return
    an int ``cudaError_t``).
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.qrp_error_string.argtypes = [ctypes.c_int]
            lib.qrp_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def device_library(name: str, signatures: dict[str, list], device: torch.device,
                   init) -> ctypes.CDLL:
    """:func:`library`, with ``init(lib)`` run once for each device.

    ``init`` fills the library's ``__constant__`` tables and returns a
    ``cudaError_t``; constant memory is per device, so it runs the first
    time each device is seen.  Call inside ``torch.cuda.device(device)``.
    """
    lib = library(name, signatures)
    with _lock:
        if (name, device.index) not in _initialised:
            check(lib, init(lib), f"{name} constant upload")
            _initialised.add((name, device.index))
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.qrp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current stream on ``t``'s device, for a launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


def expect_cuda(t: torch.Tensor, dtype: torch.dtype, what: str) -> torch.Tensor:
    """A kernel's input check: a CUDA tensor of ``dtype``, made contiguous."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: kernel input must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: kernel input must be {dtype}, got {t.dtype}")
    return t.contiguous()
