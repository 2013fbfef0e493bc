"""Build and load the port's CUDA kernels.

``csrc/*.cu`` are compiled with ``nvcc`` for Hopper (``sm_90a``), one
process per source, all started together, and linked into one shared
library with a plain C interface under ``build/torch_kernels/`` at the
repository root, at first use, and loaded with ``ctypes`` (a few seconds
to build, where ``torch.utils.cpp_extension.load`` takes minutes).
Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

# must match csrc/sweep.cu, csrc/warp.cu and csrc/xf.cu (K1 and K7 take
# core.constants.MAX_CHANNELS scalar channels).  K1's, K3's and K7's level
# tables hold every level a scene can have: cell widths are 1 << level
# over int32 corners, so at most 31 levels (0..30).
MAX_LEVELS = 32
MAX_COLOR_COMPONENTS = 4  # K2a / K2b: rgba or rgb
MAX_TEXELS = 128
MAX_SLABS = 256  # K3, K7: the slabs of one chunk

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: each multiply and add rounds on its own, like the plain
# torch versions the kernels are checked against
NVCC_FLAGS = ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lib = None
_build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"libowx_kernels_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> pathlib.Path:
    """Compile ``csrc/*.cu`` (skipped when the library for these sources
    and flags exists, unless ``force``).  Returns the library path; the
    compiler's output, with ``-Xptxas -v``'s register and shared-memory
    report, is kept for ``build_log()``."""
    global _build_log
    out = _library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    tmp = os.path.join(tmpdir, out.name)
    log = []

    def finish(cmd, proc):
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        return proc.returncode

    try:
        # one nvcc per source, all started together, then one link
        jobs = []
        for src in _sources():
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o",
                   os.path.join(tmpdir, src.stem + ".o"), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        rcs = [finish(cmd, proc) for cmd, proc in jobs]
        if not any(rcs):
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                   *[os.path.join(tmpdir, s.stem + ".o")
                     for s in _sources()]]
            rcs.append(finish(cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        _build_log = "\n".join(log)
        if any(rcs):
            raise RuntimeError(f"nvcc failed ({rcs}):\n{_build_log}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


def build_log() -> str:
    """nvcc's output from this process's last build ('' if none)."""
    return _build_log


def load():
    """The kernel library (built on first use), with argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.owx_sweep_chunk.argtypes = [vp, ci, vp, ci, vp, ci, vp]
        lib.owx_sweep_chunk.restype = ci
        lib.owx_sweep_shape.argtypes = [vp, ci, ci, vp]
        lib.owx_sweep_shape.restype = ci
        lib.owx_activity_chunk.argtypes = [vp, ci, vp, ci, vp, ci, vp]
        lib.owx_activity_chunk.restype = ci
        ll = ctypes.c_longlong
        lib.owx_warp_pass1.argtypes = [vp, ll, ll, vp, vp, vp, ci, ci, ci,
                                       ci, ci, vp]
        lib.owx_warp_pass1.restype = ci
        lib.owx_warp_pass2.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                       vp]
        lib.owx_warp_pass2.restype = ci
        cf = ctypes.c_float
        pv, pi = ctypes.POINTER(vp), ctypes.POINTER(ci)
        lib.owx_classify_field.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                           ci, cf, cf, cf, vp]
        lib.owx_classify_field.restype = ci
        lib.owx_composite_mids.argtypes = [pv, pv, pi, ci, vp, vp, vp, vp,
                                           vp, vp, ci, ci, ci, ci, cf, cf,
                                           cf, vp]
        lib.owx_composite_mids.restype = ci
        lib.owx_xf_classify.argtypes = [vp, vp, vp, ll, ci, vp]
        lib.owx_xf_classify.restype = ci
        lib.owx_xresample_levels.argtypes = [pv, pv, pv, pi, pi, ci, ci, ci,
                                             ci, vp]
        lib.owx_xresample_levels.restype = ci
        lib.owx_error_string.argtypes = [ci]
        lib.owx_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_levels(name: str, n_levels: int, least: int = 1) -> None:
    """Raise ValueError unless kernel ``name`` takes ``n_levels`` levels
    (``least``..``MAX_LEVELS``)."""
    if not least <= n_levels <= MAX_LEVELS:
        raise ValueError(f"{n_levels} levels; {name} takes "
                         f"{least}..{MAX_LEVELS} (MAX_LEVELS)")


def error_string(err: int) -> str:
    return load().owx_error_string(int(err)).decode()


def check_tensor(name, t, dev, shape, dtype=torch.float32):
    """Raise ValueError unless ``t`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``dev``: what a launcher may hand a kernel."""
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: need contiguous {dtype} on {dev}, got {t.dtype} on "
            f"{t.device} contiguous={t.is_contiguous()}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")


def stream_arg(dev) -> ctypes.c_void_p:
    """The current CUDA stream of ``dev``, as a launch argument (its raw
    handle, read without making a ``torch.cuda.Stream``: a few
    microseconds less a launch)."""
    dev = torch.device(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))


def launch(entry: str, name: str, *args):
    """Call the library's ``entry`` with ``args``; raise RuntimeError
    naming kernel ``name`` if it returns an error."""
    err = getattr(load(), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {error_string(err)} "
                           f"({err})")
