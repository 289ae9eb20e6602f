"""Build and load the port's hand-written CUDA kernels.

Each source under ``unboundednerfpytorch_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface and
loaded with ``ctypes`` (tensors are passed as ``data_ptr()`` integers, the
stream as ``torch.cuda.current_stream().cuda_stream``). No source includes
PyTorch's headers, so a build takes seconds instead of the minutes that
``torch.utils.cpp_extension.load`` needs, and every run rebuilds cheaply.

Builds go to ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), at first use, one ``nvcc`` per source, all started
together. A library's file name carries a hash of its source and flags, so
an edited source is never served by a stale build.

Host code (``HOST_SOURCES``: the TFRecord framing) is built the same way by
the host's C++ compiler into ``build/host/`` (:func:`load_host`).

``LAUNCHES`` counts kernel launches by wrapper name. Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
SOURCES = {
    "tv": CSRC_DIR / "tv.cu",
    "march": CSRC_DIR / "march.cu",
    "gather_probe": CSRC_DIR / "gather_probe.cu",
    "ub360": CSRC_DIR / "ub360.cu",
    "adam": CSRC_DIR / "adam.cu",
}
HOST_BUILD_DIR = PACKAGE_DIR.parent / "build" / "host"
HOST_SOURCES = {"tfrecord_io": CSRC_DIR / "tfrecord_io.cpp"}
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

# every kernel wrapper by name (the key it counts its launches under;
# masked_adam's launches with a per-element lr count as masked_adam_per_lr,
# tv_add_grad's with halo planes as tv_add_grad_halo)
KERNELS = ("tv_add_grad", "tv_add_grad_halo", "march_forward", "march_backward", "cumdist_thres",
           "gather_rows", "gather_tile_rows", "gather_rows_loop", "gather_tile_rows_loop",
           "box_gather8", "box_sum", "masked_adam", "masked_adam_per_lr")
LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> pathlib.Path:
    src = SOURCES[name]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=None, ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile the named sources (default: all) that have no current build,
    in parallel. Returns ``{name: compiler output}`` for those compiled;
    raises with the compiler's output if any compile fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS]
        if ptxas_verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name].name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.error_string.restype = ctypes.c_char_p
            lib.error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def host_compiler() -> str | None:
    """The host's C++ compiler (``$CXX``, else ``g++`` or ``c++`` on the
    path), None where there is none."""
    return shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")


def load_host(name: str) -> ctypes.CDLL:
    """The host library ``name`` of ``HOST_SOURCES``, built at first use
    (its file name carries a hash of its source and flags). Raises where
    there is no compiler or the build fails."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = HOST_SOURCES[name]
        digest = hashlib.sha256(src.read_bytes() + " ".join(HOST_FLAGS).encode()).hexdigest()[:12]
        out = HOST_BUILD_DIR / f"lib{name}_{digest}.so"
        if not out.exists():
            cxx = host_compiler()
            if cxx is None:
                raise RuntimeError(f"no host C++ compiler to build {src.name} (set CXX)")
            HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed for {src.name}:\n{proc.stdout}")
            os.replace(tmp, out)
        lib = _LIBS[name] = ctypes.CDLL(str(out))
        return lib
