"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources go into two shared libraries with a plain C interface that
``ctypes`` loads (``LIBRARIES``): the ViG kernels (DIGC, MRConv) and the
routed MoE experts, so that a process serving an LM builds only the
latter. Each of a library's sources is compiled by ``nvcc`` for
``sm_90a`` into an object, all at once, and the objects are linked. No
source includes PyTorch's headers, which keeps the build short. A library
is built once per process, at first use, into ``build/repro_torch/`` at
the root of the checkout (a ``kernels.build`` span, kept for the life of
the process, from which ``build_seconds`` is read); a failed build raises
with nvcc's messages. ``build`` takes another source directory (an
earlier commit's, to compare two builds in one process), and the wrappers
launch that build inside ``use``.
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
MOE_LIB_NAME = "libreprotorch_moe.so"
# Each library's sources; a source <stem>.cu exports <stem>_launch.
LIBRARIES = {LIB_NAME: ("digc_topk.cu", "mrconv.cu"),
             MOE_LIB_NAME: ("moe_experts.cu",)}
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
    "moe_experts_launch": [_P] * 11 + [_I] * 7 + [_P],
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


def _compile(nvcc: str, sources: list[Path], tmp: Path) -> tuple[list[Path], dict]:
    """Compile the sources in parallel; return objects and reports."""
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
def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR,
          name: str = LIB_NAME) -> KernelLibrary:
    """Build (once per process, directory and library) and load the
    library ``name`` of the sources in ``csrc``."""
    nvcc = nvcc_path()
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = spans.now()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs, reports = _compile(nvcc, [csrc / src for src in LIBRARIES[name]],
                                 Path(tmp))
        so_tmp = Path(tmp) / name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(so_tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if link.returncode:
            raise KernelBuildError(f"nvcc link failed:\n{link.stderr}")
        path = build_dir / name
        # Atomic: a process that loaded an earlier build keeps its copy.
        os.replace(so_tmp, path)
    t1 = spans.now()
    if spans.RECORDER.enabled:
        spans.RECORDER.add("kernels.build", t0, t1, keep=True)
    lib = ctypes.CDLL(str(path))
    for src in LIBRARIES[name]:
        entry = Path(src).stem + "_launch"
        fn = getattr(lib, entry)
        fn.argtypes = SIGNATURES[entry]
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib=lib, path=path, build_seconds=(t1 - t0) / 1e9,
                         ptxas=reports)


_active: list[KernelLibrary] = []  # innermost ``use`` last


def load(name: str = LIB_NAME) -> KernelLibrary:
    """The library ``name`` the wrappers launch: the innermost ``use``'s of
    that name, else this checkout's sources, built once per process."""
    for library in reversed(_active):
        if library.path.name == name:
            return library
    return build(name=name)


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


def check_launch(code: int, what: str, name: str = LIB_NAME) -> None:
    """Raise if a launch function of library ``name`` returned a CUDA
    error."""
    if code != 0:
        msg = load(name).lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code} "
                           f"({msg})")
