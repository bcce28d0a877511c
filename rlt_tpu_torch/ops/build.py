"""Build and load the port's CUDA kernels.

Every `rlt_tpu_torch/csrc/*.cu` source is compiled by `nvcc` for Hopper
(`sm_90a`) at the first kernel launch, one `nvcc` per source, all started
together, and linked into one shared library with a plain C interface that
is loaded through `ctypes`. The `*.cuh` headers there are included by the
sources, not compiled on their own. The library lands in
`build/rlt_tpu_torch/<hash of the sources, the headers and the flags>/` at
the repository root, so an edited source or header builds anew and an
unchanged tree loads at once.
Nothing here runs when the module is imported: the CPU tests import every
module of the port on machines with no `nvcc`.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "rlt_tpu_torch"
# -fno-gnu-unique: a static local of a template or inline launcher (the
# persistent grids' resident-block counts) stays the library's own; as a
# GNU-unique symbol it would be shared with every other build of the same
# sources loaded in the process (scripts/bench_*.py load several)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xcompiler", "-fno-gnu-unique", "-Xptxas", "-v")
LIB_NAME = "librlt_kernels.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the port's "
                       "CUDA kernels are built at first launch and need it")


def _sources(csrc: Path = CSRC) -> list[Path]:
    """The translation units: one object file each."""
    return sorted(csrc.glob("*.cu"))


def source_hash(csrc: Path = CSRC) -> str:
    """Hash of every source and header under `csrc` and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The shared library built from the sources of `csrc` (this package's,
    or another tree's to compare with), loaded once per process."""

    def __init__(self, csrc: Path = CSRC):
        self.csrc = csrc
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.build_seconds: float | None = None  # None: loaded from cache
        self.path: Path | None = None

    def _build(self, out_dir: Path) -> Path:
        nvcc = _nvcc()
        tmp = out_dir.with_name(out_dir.name + f".tmp{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        t0 = time.perf_counter()
        procs = []
        for src in _sources(self.csrc):
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objs, log, failed = [], [], []
        for src, obj, proc in procs:
            out, err = proc.communicate()
            log.append(f"== {src.name}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name}:\n{err}")
            objs.append(str(obj))
        (tmp / "ptxas.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("\n".join(failed))
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *objs, "-o", str(tmp / LIB_NAME)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        self.build_seconds = time.perf_counter() - t0
        try:
            tmp.rename(out_dir)
        except OSError:  # another process finished the same build first
            shutil.rmtree(tmp, ignore_errors=True)
        return out_dir / LIB_NAME

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                out_dir = BUILD_ROOT / source_hash(self.csrc)
                lib_path = out_dir / LIB_NAME
                if not lib_path.exists():
                    lib_path = self._build(out_dir)
                self._lib = ctypes.CDLL(str(lib_path))
                self._lib.rlt_cuda_error_string.argtypes = [ctypes.c_int]
                self._lib.rlt_cuda_error_string.restype = ctypes.c_char_p
                self.path = lib_path
            return self._lib

    def ptxas_log(self) -> str:
        """What `-Xptxas -v` said of each kernel (registers, shared memory,
        spills) when the library was built."""
        self.get()
        log = self.path.parent / "ptxas.log"
        return log.read_text() if log.exists() else ""


LIBRARY = KernelLibrary()


class Kernel:
    """One C launcher of the library, with a count of its launches.

    `launches` rises by one each time the launcher started its kernel
    without error, and nowhere else but at a CUDA graph's replay, which
    adds the launches its capture made (`rlt_tpu_torch/utils/graphs.py`)."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = LIBRARY.get()
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        code = self._fn(*args)
        if code != 0:
            msg = LIBRARY.get().rlt_cuda_error_string(code).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {code}: {msg}")
        self.launches += 1


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, as the C launchers take it:
    its raw handle, read without building a `torch.cuda.Stream` object at
    every launch."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))


def ptr(tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(tensor.data_ptr())


# ---------------------------------------------------------------------------
# dtype rules the wrappers share: a float32 kernel and its bf16 instance are
# two kernels, each counted on its own, and neither takes the other's dtype
# ---------------------------------------------------------------------------

def refuse_bf16(name: str, tensors: dict) -> None:
    """Raise if any tensor is bf16: `name` is the float32 op."""
    import torch

    for tname, t in tensors.items():
        if t.dtype == torch.bfloat16:
            raise TypeError(f"{name} takes no bf16 ({tname}): bf16 goes to "
                            f"{name}_bf16, its own kernel")


def require_bf16(name: str, tensors: dict) -> None:
    """Raise unless every tensor is bf16: `name` is a bf16 instance."""
    import torch

    for tname, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} takes bf16, got {t.dtype} for {tname}")


def widen(t):
    """A bf16 tensor in float32 (exactly); any other as it is. The plain
    versions compute on bf16 inputs from their widened values."""
    import torch

    return t.float() if t.dtype == torch.bfloat16 else t

