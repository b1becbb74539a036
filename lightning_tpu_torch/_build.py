"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source (``crypto/csrc/`` for verify and sign, ``routing/csrc/``
for routing) compiles to its own shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``), at first use, into the package's ``_build/``
directory (listed in .gitignore).  All sources compile at once, one nvcc
process each.  Nothing here runs at import time: this module is imported
on machines with no CUDA toolkit, where only the plain versions run.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CRYPTO_CSRC = os.path.join(_PKG, "crypto", "csrc")      # verify and sign
ROUTING_CSRC = os.path.join(_PKG, "routing", "csrc")    # routing
BUILD_DIR = os.path.join(_PKG, "_build")
# kernel library -> (source directory, source file, the headers of that
# directory it includes): a library rebuilds when its source or one of
# its own headers is newer than it
_SECP = ("secp256k1.cuh",)
_ROUTING = ("routing.cuh", "cluster.cuh")
KERNELS = {
    "verify_prep": (CRYPTO_CSRC, "verify_prep.cu", _SECP),
    "build_tables": (CRYPTO_CSRC, "build_tables.cu", _SECP),
    "glv_scan": (CRYPTO_CSRC, "glv_scan.cu", _SECP),
    "glv_scan2": (CRYPTO_CSRC, "glv_scan2.cu", _SECP),
    "dual_mul_v2": (CRYPTO_CSRC, "dual_mul_v2.cu", _SECP),
    "dual_mul_planes": (CRYPTO_CSRC, "dual_mul_planes.cu", _SECP),
    "fixed_base": (CRYPTO_CSRC, "fixed_base.cu", _SECP),
    "ecdsa_sign": (CRYPTO_CSRC, "ecdsa_sign.cu", _SECP),
    "route_sweep": (ROUTING_CSRC, "route_sweep.cu", _ROUTING),
    "mcf_ssp": (ROUTING_CSRC, "mcf_ssp.cu", _ROUTING),
}
SOURCES = {name: src for name, (_, src, _) in KERNELS.items()}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not os.path.exists(out):
        return True
    d, src, headers = KERNELS[name]
    srcs = [os.path.join(d, f) for f in (src, *headers)]
    return os.path.getmtime(out) < max(os.path.getmtime(s) for s in srcs)


def source_path(name: str) -> str:
    d, src, _ = KERNELS[name]
    return os.path.join(d, src)


def _report_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.ptxas.txt")


def nvcc_all(jobs: dict) -> dict:
    """Compile {key: (source file, include directory, library path)}
    with ``NVCC_FLAGS``, one nvcc process each, all at once; returns
    {key: ptxas report (registers, shared memory, spills), a line a
    kernel}.  Raises if any compile fails."""
    exe = nvcc()
    procs = {key: subprocess.Popen(
        [exe, *NVCC_FLAGS, "-I", inc, "-o", out, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, (src, inc, out) in jobs.items()}
    reports, failed = {}, []
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{key}:\n{out}")
            continue
        reports[key] = "\n".join(ln.strip() for ln in out.splitlines()
                                 if "registers" in ln or "spill" in ln)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def build_all() -> dict[str, str]:
    """Compile every stale kernel library, all nvcc processes at once,
    and return the ptxas report of every kernel, whether built by this
    call or before; ptxas names shared memory ("smem") only where a
    kernel uses some.  Raises if any compile fails."""
    with _lock:
        todo = [n for n in SOURCES if _stale(n)]
        if todo:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = {n: _lib_path(n) + f".{os.getpid()}.tmp" for n in todo}
            got = nvcc_all({n: (source_path(n), KERNELS[n][0], tmp[n])
                            for n in todo})
            for name, report in got.items():
                with open(_report_path(name), "w") as f:
                    f.write(report)
                os.replace(tmp[name], _lib_path(name))
        reports = {}
        for name in SOURCES:
            with open(_report_path(name)) as f:
                reports[name] = f.read()
        return reports


def sass(path: str) -> dict[str, list[str]] | None:
    """{kernel function: its SASS instructions} of a built library, as
    ``cuobjdump -sass`` lists them (a line with an address comment
    each); None where the toolkit has no cuobjdump."""
    exe = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    if not os.path.exists(exe):
        return None
    out = subprocess.run([exe, "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    fns: dict[str, list[str]] = {}
    fn = None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = fns.setdefault(m.group(1), [])
        elif fn is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S",
                                         line):
            fn.append(line)
    return fns


def sass_calls(fns: dict[str, list[str]]) -> dict[str, list[int]]:
    """{kernel: [CALL instructions, IMAD.HI and IMAD.WIDE instructions]}
    of ``sass``'s listing: a call of a subroutine, such as the int64
    division routine, is a CALL; a division by a constant becomes
    multiply-high instructions."""
    return {fn: [sum(bool(re.search(r"\bCALL\b", x)) for x in ins),
                 sum(bool(re.search(r"IMAD\.(HI|WIDE)", x)) for x in ins)]
            for fn, ins in fns.items()}


def c_launch(lib: ctypes.CDLL, name: str, n_ptr: int, n_int: int):
    """``<name>_launch`` of a kernel library, typed as every launcher of
    this package is: n_ptr buffers, n_int ints, the stream; returns a
    CUDA error code."""
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    got = _libs.get(name)
    if got is None:
        build_all()
        with _lock:
            got = _libs.get(name)
            if got is None:
                got = _libs[name] = ctypes.CDLL(_lib_path(name))
    return got
