"""Build and load the hand-written CUDA kernels of ``diffvit_tpu_torch/csrc``.

Two libraries: the served kernels (``csrc/*.cu``, entries ``ENTRIES``) and
the probes (``csrc/probes/*.cu``, built with ``-I csrc`` so that they
include the served kernels' ``.cuh``; entries ``PROBE_ENTRIES``).  At first
use ``nvcc`` compiles every source of a library for ``sm_90a`` (Hopper),
one process per source, all started together, and links the objects into
one shared library with a plain C interface in ``csrc/build/``, under a
name keyed by a hash of its sources, the headers they may include and the
flags; later calls and later processes reuse it.  The library is written
under a temporary name and renamed into place, so a process never loads a
half-written one.  The library is loaded with ``ctypes``: each C
entry takes device pointers, ints and the CUDA stream, launches on that
stream, and returns ``cudaGetLastError()``, which :func:`check` turns into
an exception.

``-fmad=false`` keeps nvcc from contracting ``a*b + c`` into one fused
multiply-add: the plain PyTorch versions round the product and the sum
separately, and the kernels' int8 codes must match theirs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry -> argtypes (pointers and the stream as c_void_p, ints as c_int,
# element strides as c_longlong)
ENTRIES = {
    "dvt_qkv_attention": (_P,) * 6 + (_I,) * 19 + (_P,),
    "dvt_attention_block": (_P,) * 10 + (_I,) * 18 + (_P,),
    "dvt_int_attention": (_P,) * 3 + (_I,) * 6 + (_L,) * 7 + (_I,) * 4
    + (_P,),
    "dvt_qkv_gemm_footprint": (_I,) * 4 + (_P,) * 3,
    "dvt_attention_core_footprint": (_I,) * 5 + (_P,) * 4,
    "dvt_int_linear": (_P,) * 4 + (_I,) * 10 + (_P,),
    "dvt_int_linear_footprint": (_I,) * 5 + (_P,) * 3,
    "dvt_int_mlp": (_P,) * 12 + (_I,) * 18 + (_P,),
    "dvt_int_mlp_footprint": (_I,) * 5 + (_P,) * 3,
    "dvt_int_mlp_block": (_P,) * 12 + (_I,) * 16 + (_P,),
    "dvt_int_mlp_block_footprint": (_I,) * 5 + (_P,) * 3,
    "dvt_swin_attention": (_P,) * 5 + (_I,) * 7 + (_L,) * 7 + (_I,) * 3
    + (_P,),
    "dvt_swin_attention_footprint": (_I,) * 4 + (_P,) * 4,
    "dvt_resident_codes": (_P,) * 14 + (_I,) * 16 + (_P,),
    "dvt_resident_footprint": (_I,) * 2 + (_P,) * 4,
}
# the probes of ``diffvit_tpu_torch/probes`` (csrc/probes/*.cu)
PROBE_ENTRIES = {
    "dvt_probe_producer": (_P,) * 5 + (_I,) * 5 + (_P,),
    "dvt_probe_consumer": (_P,) * 4 + (_I,) * 5 + (_P,),
    "dvt_probe_paired": (_P,) * 8 + (_I,) * 6 + (_P,),
    "dvt_probe_overlap": (_P,) * 5 + (_I,) * 5 + (_P,),
    "dvt_probe_overlap_mlp": (_P,) * 10 + (_I,) * 4 + (_P,),
    "dvt_probe_overlap_mlp_fc1_occupancy": (_I, _P, _P, _P),
    "dvt_probe_pingpong_occupancy": (_I, _P, _P, _P),
    "dvt_probe_tile_sum": (_P,) * 3 + (_L,) + (_P,),
    "dvt_probe_qkv_attention_nv": (_P,) * 6 + (_I,) * 5 + (_P,),
}


@dataclasses.dataclass(frozen=True)
class Library:
    """One shared library: its sources (``src_dir/*.cu``, which may include
    the shared ``csrc/*.cuh``), extra nvcc flags and its C entries."""
    stem: str
    src_dir: Path
    flags: tuple
    entries: dict


LIBRARIES = {
    "kernels": Library("libdvt_kernels", CSRC, (), ENTRIES),
    "probes": Library("libdvt_probes", CSRC / "probes", ("-I", str(CSRC)),
                      PROBE_ENTRIES),
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    home_nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
        / "bin" / "nvcc"
    if nvcc is None and home_nvcc.exists():
        nvcc = str(home_nvcc)
    if nvcc is None:
        raise RuntimeError(
            "building the diffvit_tpu_torch CUDA kernels needs nvcc (the CUDA "
            f"toolkit), and no nvcc is on PATH or at {home_nvcc}")
    return nvcc


def library_path(kind: str = "kernels") -> Path:
    """Where the build of library ``kind`` ("kernels" or "probes") for the
    current sources lives."""
    lib = LIBRARIES[kind]
    h = hashlib.sha256(" ".join(NVCC_FLAGS + (lib.stem,)).encode())
    for p in sorted(lib.src_dir.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{lib.stem}_{h.hexdigest()[:16]}.so"


def build(kind: str = "kernels") -> tuple[Path, float]:
    """Compile library ``kind`` unless the build for these sources exists.
    Returns the library path and the seconds spent compiling (0.0 when the
    build was already there)."""
    lib = LIBRARIES[kind]
    out = library_path(kind)
    if out.exists():
        return out, 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    flags = NVCC_FLAGS + lib.flags
    objs, jobs = [], []
    for src in sorted(lib.src_dir.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *flags, "-c", str(src), "-o", str(obj)]
        objs.append(obj)
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    # wait for every compile before raising, so that none is left running
    done = [(cmd, proc.communicate()[0], proc.returncode)
            for cmd, proc in jobs]
    for cmd, output, returncode in done:
        _check_run(cmd, returncode, output)
    cmd = [nvcc, *flags, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _check_run(cmd, proc.returncode, proc.stdout + proc.stderr)
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


def _check_run(cmd, returncode, output):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n"
                           f"{' '.join(cmd)}\n{output}")


@functools.lru_cache(maxsize=None)
def load_library(kind: str = "kernels") -> ctypes.CDLL:
    """Build library ``kind`` if needed, load it once per process, and
    declare every entry."""
    path, _ = build(kind)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in LIBRARIES[kind].entries.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.dvt_error_string.argtypes = [ctypes.c_int]
    lib.dvt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str, kind: str = "kernels") -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry of library
    ``kind``."""
    if err != 0:
        msg = load_library(kind).dvt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")
