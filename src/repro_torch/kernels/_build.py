"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object, all
sources at once, and the objects are linked into one shared library with
a plain C interface that ``ctypes`` loads. No source includes PyTorch's
headers, which keeps the build short. The library is built once per
process, at first use, into ``build/repro_torch/`` at the root of the
checkout (a ``kernels.build`` span, kept for the life of the process, from
which ``build_seconds`` is read); a failed build raises with nvcc's
messages. ``build`` takes another source directory (an earlier commit's,
to compare two builds in one process), and the wrappers launch that build
inside ``use``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from repro_torch import spans

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libreprotorch_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points and their argument types. Pointers and the stream are
# c_void_p: a bare Python int would be passed as a 32-bit int.
SIGNATURES = {
    "digc_topk_launch": [_P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _P],
    "mrconv_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float
    ptxas: dict  # source file name -> nvcc's -Xptxas -v report


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda; the "
        "CUDA kernels build only on a host with the CUDA toolkit"
    )


def _compile(nvcc: str, csrc: Path, tmp: Path) -> tuple[list[Path], dict]:
    """Compile every source in parallel; return objects and reports."""
    sources = sorted(csrc.glob("*.cu"))
    procs = []
    try:
        for src in sources:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )))
        reports, failed = {}, []
        for src, _, proc in procs:
            out, err = proc.communicate()
            reports[src.name] = (out + err).strip()
            if proc.returncode:
                failed.append(f"--- {src.name} (exit {proc.returncode})\n{err}")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return [obj for _, obj, _ in procs], reports


@functools.cache
def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> KernelLibrary:
    """Build (once per process and directory) and load the kernel library
    of the sources in ``csrc``."""
    nvcc = nvcc_path()
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = spans.now()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs, reports = _compile(nvcc, csrc, Path(tmp))
        so_tmp = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(so_tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if link.returncode:
            raise KernelBuildError(f"nvcc link failed:\n{link.stderr}")
        path = build_dir / LIB_NAME
        # Atomic: a process that loaded an earlier build keeps its copy.
        os.replace(so_tmp, path)
    t1 = spans.now()
    if spans.RECORDER.enabled:
        spans.RECORDER.add("kernels.build", t0, t1, keep=True)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib=lib, path=path, build_seconds=(t1 - t0) / 1e9,
                         ptxas=reports)


_active: list[KernelLibrary] = []  # innermost ``use`` last


def load() -> KernelLibrary:
    """The library the wrappers launch: the innermost ``use``'s, else this
    checkout's sources, built once per process."""
    return _active[-1] if _active else build()


@contextlib.contextmanager
def use(library: KernelLibrary):
    """Launch ``library``'s kernels (from ``build``) inside the block."""
    _active.append(library)
    try:
        yield library
    finally:
        _active.pop()


def check_operand(name: str, t, *, dtype, ndim: int, device) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous tensor of
    ``dtype`` and rank ``ndim`` on ``device``, small enough for the
    kernels' 32-bit sizes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= 2**31:
        raise ValueError(f"{name} has {t.numel()} elements; the kernels "
                         "take fewer than 2**31")


def check_launch(code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = load().lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code} "
                           f"({msg})")
