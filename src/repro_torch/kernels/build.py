"""Build the CUDA sources under ``csrc/`` with nvcc and load them via ctypes.

Each kernel is one ``.cu`` file with a plain C entry point (no PyTorch
headers, so a build takes seconds). The first wrapper call compiles every
source at once — one ``nvcc`` process per file, all started together —
into ``build/kernels/`` at the repository root, named by a hash of the
source and flags so an edited source rebuilds. ``-Xptxas -v`` reports
(registers, shared memory, spills) are kept beside each library and
returned by :func:`build_all`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {
    "gather_planned_rows": CSRC / "gather_planned_rows.cu",
    "idl_locations": CSRC / "idl_locations.cu",
    "insert_planned": CSRC / "insert_planned.cu",
    "probe_planned_bits": CSRC / "probe_planned_bits.cu",
    "window_min": CSRC / "window_min.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin``, ``PATH``, or the
    toolkit's default install); raises if there is none."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> dict[str, str]:
    """Compile every kernel source not built yet, all in parallel.

    Returns ``{name: nvcc output}`` (the ``-Xptxas -v`` report) for every
    kernel; raises ``RuntimeError`` with the compiler output if one fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    running = []
    for name, src in SOURCES.items():
        so = _target(name)
        if so.exists():
            continue
        compiler = compiler or nvcc()
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, so))
    failed = []
    for name, proc, tmp, so in running:
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _target(name).with_suffix(".log").read_text()
            for name in SOURCES}


def check_operands(kernel: str, **tensors) -> None:
    """Raise unless every operand is a contiguous int32 tensor on one CUDA
    device — the only layout the C entry points take."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{kernel}: operands must share one CUDA device, "
                         f"got {sorted(map(str, devices))}")
    for name, t in tensors.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous int32, "
                             f"got {t.dtype} (contiguous={t.is_contiguous()})")


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _target(name).exists():
                build_all()
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib


def launch(name: str, argtypes: list, device: torch.device, *args,
           entry: str | None = None) -> None:
    """Call the C entry point ``entry`` (default ``name``, the function of
    the same name) of kernel ``name``'s library, typed as ``argtypes`` ->
    ``int``, with ``args`` and the current stream of ``device``; raise if it
    returns a CUDA error.

    The typed entry point is resolved once and kept, and the device context
    is entered only when ``device`` is not the current one: the wrapper's
    host cost is paid on every launch of a small kernel.
    """
    entry = entry or name
    fn = _entries.get(entry)
    if fn is None:
        fn = getattr(library(name), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[entry] = fn
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry}: launch failed with CUDA error {err}")


_entries: dict = {}
