"""Build and load the hand-written CUDA kernels of ``diffvit_tpu_torch/csrc``
and the host library of the native JPEG pipeline.

Three libraries: the served kernels (``csrc/*.cu``, entries ``ENTRIES``),
the probes (``csrc/probes/*.cu``, built with ``-I csrc`` so that they
include the served kernels' ``.cuh``; entries ``PROBE_ENTRIES``) and the
host library (``csrc/host/*.cpp``, entries ``HOST_ENTRIES``).  At first
use ``nvcc`` compiles every source of a CUDA library for ``sm_90a``
(Hopper), one process per source, all started together, and links the
objects into one shared library with a plain C interface in
``csrc/build/``, under a name keyed by a hash of its sources, the headers
they may include and the flags; later calls and later processes reuse it.
The library is written under a temporary name and renamed into place, so a
process never loads a half-written one.  The library is loaded with
``ctypes``: each C entry takes device pointers, ints and the CUDA stream,
launches on that stream, and returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.

The host library is C++ for the CPU (the JPEG decode, the Pillow-exact
resampler and the input-code table of ``data/native_decode.py``), built by
one ``g++`` with OpenMP and linked against the libjpeg that PIL's decoder
itself loads (:func:`pil_libjpeg`), through the ABI-62 headers kept in
``csrc/host/include``: the decoder then runs the very library PIL decodes
with.  Its name is keyed, besides, by that library's path and by the CPU
(``-march=native`` compiles for the CPU it runs on), and it is renamed into
place as the CUDA libraries are.  A missing ``g++`` or libjpeg raises
``FileNotFoundError`` naming it; a failed compile raises
:class:`HostBuildError` with the compiler's output.

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
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
HOST = CSRC / "host"
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry -> argtypes (pointers and the stream as c_void_p, ints as c_int,
# element strides as c_longlong)
ENTRIES = {
    "dvt_qkv_attention": (_P,) * 6 + (_I,) * 19 + (_P,),
    "dvt_attention_block": (_P,) * 10 + (_I,) * 25 + (_P,),
    "dvt_int_attention": (_P,) * 3 + (_I,) * 6 + (_L,) * 7 + (_I,) * 4
    + (_P,),
    "dvt_qkv_gemm_footprint": (_I,) * 4 + (_P,) * 3,
    "dvt_block_proj_footprint": (_I,) * 4 + (_P,) * 4,
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
    "dvt_resident_footprint": (_I,) * 3 + (_P,) * 4,
}
# the probes of ``diffvit_tpu_torch/probes`` (csrc/probes/*.cu)
PROBE_ENTRIES = {
    "dvt_probe_producer": (_P,) * 5 + (_I,) * 8 + (_P,),
    "dvt_probe_consumer": (_P,) * 4 + (_I,) * 9 + (_P,),
    "dvt_probe_paired": (_P,) * 8 + (_I,) * 11 + (_P,),
    "dvt_probe_overlap": (_P,) * 5 + (_I,) * 11 + (_P,),
    "dvt_probe_overlap_footprint": (_I,) * 2 + (_P,) * 4,
    "dvt_probe_overlap_mlp": (_P,) * 10 + (_I,) * 18 + (_P,),
    "dvt_probe_overlap_mlp_fc1_occupancy": (_I,) * 5 + (_P,) * 4,
    "dvt_probe_pingpong_occupancy": (_I,) * 5 + (_P,) * 4,
    "dvt_probe_tile_sum": (_P,) * 4 + (_L,) * 2 + (_I,) * 4 + (_P,),
    "dvt_probe_qkv_attention_nv": (_P,) * 6 + (_I,) * 15 + (_P,),
    "dvt_probe_linear_core_footprint": (_I,) * 4 + (_P,) * 4,
}

_U8, _F32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
_I8, _I32 = ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int)
_UL = ctypes.c_ulong
# the host library (csrc/host/*.cpp): the C ABI of the JAX package's native
# library; the entries in HOST_VOID return nothing, the others an int
HOST_ENTRIES = {
    "jpeg_shape": (_U8, _UL, _I32, _I32),
    "jpeg_decode_rgb": (_U8, _UL, _U8),
    "jpeg_decode_preprocess": (_U8, _UL, _F32, _I, _I, _F32, _F32),
    "jpeg_decode_preprocess_fast": (_U8, _UL, _F32, _I, _I, _F32, _F32),
    "jpeg_decode_preprocess_u8": (_U8, _UL, _U8, _I, _I, _I),
    "jpeg_decode_preprocess_batch": (
        ctypes.POINTER(_U8), ctypes.POINTER(_UL), _I, _F32, _I, _I, _F32,
        _F32, _I32, _I),
    "jpeg_decode_preprocess_batch_u8": (
        ctypes.POINTER(_U8), ctypes.POINTER(_UL), _I, _U8, _I, _I, _I32, _I),
    "preprocess_rgb": (_U8, _I, _I, _F32, _I, _I, _F32, _F32),
    "preprocess_rgb_u8": (_U8, _I, _I, _U8, _I, _I),
    "preprocess_batch": (ctypes.POINTER(_U8), _I32, _I32, _I, _F32, _I, _I,
                         _F32, _F32),
    "apply_code_lut": (_U8, _I8, _I8, ctypes.c_long, ctypes.c_long),
}
HOST_VOID = {"jpeg_decode_preprocess_batch", "jpeg_decode_preprocess_batch_u8",
             "preprocess_rgb", "preprocess_rgb_u8", "preprocess_batch",
             "apply_code_lut"}


@dataclasses.dataclass(frozen=True)
class Library:
    """One shared library: its sources (``src_dir/*.cu``, which may include
    the shared ``csrc/*.cuh`` and ``src_dir/*.cuh``; for the host library
    ``src_dir/*.cpp``), extra compiler flags and its C entries."""
    stem: str
    src_dir: Path
    flags: tuple
    entries: dict
    host: bool = False  # g++ for the CPU, linked with libjpeg


LIBRARIES = {
    "kernels": Library("libdvt_kernels", CSRC, (), ENTRIES),
    "probes": Library("libdvt_probes", CSRC / "probes", ("-I", str(CSRC)),
                      PROBE_ENTRIES),
    "host": Library("libdvt_host", HOST, ("-I", str(HOST / "include")),
                    HOST_ENTRIES, host=True),
}


class HostBuildError(subprocess.CalledProcessError):
    """``g++`` failed on the host library; the message carries its
    output (a missing header or library is named there)."""

    def __str__(self):
        return f"{super().__str__()}\n{' '.join(self.cmd)}\n{self.output}"


@functools.lru_cache(maxsize=None)
def pil_libjpeg() -> Path:
    """The libjpeg that PIL's decoder (``PIL._imaging``) loads, as the
    dynamic loader resolves it (``ldd``): Pillow's wheels bundle their own
    copy under ``pillow.libs``.  Raises ``FileNotFoundError`` where it
    links none, or one of another ABI than the headers' (62)."""
    import PIL._imaging as imaging

    out = subprocess.run(["ldd", imaging.__file__], capture_output=True,
                         text=True, check=True).stdout
    m = re.search(r"^\s*libjpeg\S*\s+=>\s+(/\S+)", out, re.M)
    if m is None:
        raise FileNotFoundError(
            f"the host library links the libjpeg that PIL decodes with, and "
            f"PIL's decoder {imaging.__file__} links none:\n{out}")
    path = Path(m.group(1)).resolve()
    if ".so.62" not in path.name:
        raise FileNotFoundError(
            f"PIL's libjpeg {path} is not of ABI 62, the ABI of the headers "
            f"in {HOST / 'include'}")
    return path


def _cpu() -> str:
    """The CPU's model and instruction set as Linux reports them: the
    host library is compiled with -march=native for them."""
    lines = Path("/proc/cpuinfo").read_text().splitlines()
    return "\n".join(dict.fromkeys(
        ln for ln in lines if ln.startswith(("model name", "flags"))))


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
    """Where the build of library ``kind`` ("kernels", "probes" or "host")
    for the current sources lives."""
    lib = LIBRARIES[kind]
    if lib.host:
        h = hashlib.sha256(" ".join(HOST_FLAGS + (lib.stem,)).encode())
        h.update(f"{pil_libjpeg()}\n{_cpu()}".encode())
        sources = sorted(HOST.glob("*.cpp")) + sorted(HOST.glob("include/*"))
    else:
        h = hashlib.sha256(" ".join(NVCC_FLAGS + (lib.stem,)).encode())
        sources = sorted(lib.src_dir.glob("*.cu")) + sorted(
            {*CSRC.glob("*.cuh"), *lib.src_dir.glob("*.cuh")})
    for p in sources:
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
    if lib.host:
        return out, _build_host(lib, out)
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


def _build_host(lib: Library, out: Path) -> float:
    """One ``g++`` over ``csrc/host/*.cpp`` into ``out`` (through a
    temporary name); returns its seconds."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("building the diffvit_tpu_torch host library "
                                "needs g++, and no g++ is on PATH")
    jpeg = pil_libjpeg()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *HOST_FLAGS, *lib.flags, "-o", str(tmp),
           *map(str, sorted(lib.src_dir.glob("*.cpp"))), str(jpeg),
           f"-Wl,-rpath,{jpeg.parent}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise HostBuildError(proc.returncode, cmd, proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return time.perf_counter() - t0


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
        fn.restype = None if name in HOST_VOID else ctypes.c_int
    if not LIBRARIES[kind].host:
        lib.dvt_error_string.argtypes = [ctypes.c_int]
        lib.dvt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str, kind: str = "kernels") -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry of library
    ``kind``."""
    if err != 0:
        msg = load_library(kind).dvt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")
