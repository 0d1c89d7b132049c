"""Build the CUDA kernels of ``csrc/`` and load them through ctypes.

The sources are compiled once per content by ``nvcc`` into one shared
library under ``build/kernels/`` at the root of the checkout (the user's
cache for an installed package, see :func:`build_dir`), named by a
hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads the cached library. Every entry point has a plain C
interface (pointers, sizes and the stream as plain arguments), so the
build includes no PyTorch header and takes seconds.

Nothing here runs at import: :func:`library` builds and loads on first
use. The kernel wrappers launch through :func:`launch`, one idiom for all.
A failed build or launch raises; nothing falls back.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch


def build_dir(root: Path) -> Path:
    """Where the library goes, given the directory that holds the package:
    ``build/kernels/`` there when it is a checkout (it holds the project's
    ``pyproject.toml``); for an installed package, the user's cache
    (``$XDG_CACHE_HOME`` or ``~/.cache``), never site-packages' parent."""
    if (root / "pyproject.toml").is_file():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "pointnet12_tpu_torch" / "kernels"


CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = build_dir(Path(__file__).resolve().parents[2])
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every pointer and the stream as c_void_p, or ctypes
# would pass them as 32-bit ints and cut them.
_SIGNATURES = {
    "pn12_fps": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "pn12_ballquery": (
        _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _I, _I, _I, _P,
    ),
    "pn12_three_nn": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "pn12_segment_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "pn12_dense_bn_stats": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "pn12_grid_prep": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P),
    "pn12_ballquery_grid": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _I, _I,
        _P,
    ),
    "pn12_fused_sa_dense": (
        _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, ctypes.c_float, _P,
    ),
    "pn12_fused_sa_grid": (
        _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        ctypes.c_float, _P,
    ),
}


class KernelBuildError(RuntimeError):
    pass


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise KernelBuildError("nvcc not found on PATH or under CUDA_HOME")


def _run_all(cmds) -> str:
    """Run the commands side by side; raise with the first failure's output,
    else return their outputs joined. Every process is waited for."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    try:
        logs = [proc.communicate(timeout=600)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
            )
    return "".join(logs)


def build() -> tuple:
    """Compile the sources if no library of their hash exists yet: one
    ``nvcc -c`` per source, all started together, then one link.

    Returns ``(path, seconds, log)``: ``seconds`` is 0.0 and ``log`` empty
    when the cached library was reused; otherwise ``log`` holds nvcc's
    output, which includes ptxas's register and shared-memory report.
    """
    out = BUILD_DIR / f"libpn12_kernels_{_digest()}.so"
    if out.exists():
        return out, 0.0, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # objects in a private directory and the library under a private name,
    # then a rename: a concurrent build in another process never sees a
    # half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{p.stem}.o" for p in sorted(CSRC.glob("*.cu"))]
        log = _run_all([
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(CSRC / f"{o.stem}.cu")]
            for o in objs
        ])
        tmp = Path(tmpdir) / out.name
        log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    return out, time.perf_counter() - t0, log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use in this process."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pn12_error_string.argtypes = (ctypes.c_int,)
    lib.pn12_error_string.restype = ctypes.c_char_p
    return lib


def check_tensor(kernel: str, name: str, t, dtype, shape, device=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` whose
    shape matches ``shape`` (``None`` matches any size) on ``device``."""
    if not t.is_cuda or (device is not None and t.device != device):
        raise ValueError(
            f"{kernel}: {name} must be a CUDA tensor"
            + (f" on {device}" if device is not None else "")
            + f", got one on {t.device}"
        )
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(
            f"{kernel}: {name} must have shape {shape}, got {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    return tuple(t.shape)


def launch(name: str, device: torch.device, *args) -> None:
    """Call the entry point ``pn12_<name>`` with ``args`` and the current
    stream of ``device`` (a CUDA device with its index, as a CUDA tensor's
    ``.device`` is), and raise if it returns a CUDA error code.

    The least host work that the launch path's breakdown on the card
    allows (PERF.md): the raw stream handle from PyTorch's C API, as Triton
    and Inductor take it, where ``torch.cuda.current_stream()`` builds a
    ``Stream`` object; the device switched only when it is not the current
    one, where ``torch.cuda.device`` switched and restored it every call."""
    fn = getattr(library(), "pn12_" + name)
    index = device.index
    if torch._C._cuda_getDevice() == index:
        code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if code != 0:
        msg = library().pn12_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")
