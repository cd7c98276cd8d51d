"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` (and the headers they include) are compiled with ``nvcc``, one
process a source at once, and linked into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), loaded with
``ctypes``, at a process's first kernel launch. The library goes to
``_build/`` beside the package (listed in ``.gitignore``) under a name that
holds a digest of ``csrc/`` and the flags: a process that finds the library
of the same sources there (another command of the same checkout, a spawned
rank) loads it and compiles nothing. A failed build raises with nvcc's
output.
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

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / f for f in ("mix_attention.cu", "equi_update.cu", "block_fused.cu",
                                            "probe_tiles.cu"))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# kernel launches per wrapper, since the process started or reset_launches();
# a serving kernel's launches on bfloat16 operands count under its name + "_bf16",
# equi_update's with a 1-wide dist (dist_gbf=False) under "equi_update_dd1"
LAUNCHES = {**{f"{k}{v}": 0 for k in ("mix_attention", "equi_update", "equi_update_dd1",
                                      "block_fused") for v in ("", "_bf16")},
            **{f"probe_t{i}": 0 for i in range(1, 15)}}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # pointers, sizes, then the launch plan (ints and their count) and the stream
    # (the last size: 1 for the bfloat16 operands, 0 for float32)
    "dstt_mix_attention": [_P] * 9 + [_I] * 10 + [_P, _I, _P],
    "dstt_equi_update": [_P] * 16 + [_I] * 7 + [_F, _P, _I, _P],
    # the blocks an SM the card gives a kernel at these sizes: sizes, out
    "dstt_mix_attention_occupancy": [_I] * 7 + [_P],
    "dstt_equi_update_occupancy": [_I] * 6 + [_P],
    "dstt_block_fused": [_P, _I, _P, _I, _P, _I, _F, _P],
    # the Mosaic probes (csrc/probe_tiles.cu):
    # pointers, then sizes, (t5: the launch plan,) then the stream
    **{f"dstt_probe_t{i}": [_P] * 2 + [_I] + [_P] for i in (1, 2, 3, 6, 11, 12)},
    **{f"dstt_probe_t{i}": [_P] * 2 + [_I] * 2 + [_P] for i in (4, 8, 10)},
    "dstt_probe_t9": [_P] * 3 + [_I] + [_P],
    **{f"dstt_probe_t{i}": [_P] * 3 + [_I] * 3 + [_P] for i in (7, 13, 14)},
    "dstt_probe_t5": [_P] * 3 + [_I] * 3 + [_P, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of this process's build (register use per kernel)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    """The library built from ``csrc/`` as it is: its name holds a digest
    of every file there (sources and headers) and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted((_PKG / "csrc").iterdir()):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"libdstt_kernels.{digest.hexdigest()[:16]}.so"


def build() -> ctypes.CDLL:
    """Load the library of ``csrc/*.cu`` (first call in the process),
    compiling it unless ``_build/`` holds it already."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if target.exists():
            _lib = _open(target)
            return _lib
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = BUILD_DIR / f"{target.name}.{os.getpid()}.tmp"
        # one nvcc a source, all at once, then one link
        objs = [BUILD_DIR / f"{src.stem}.{os.getpid()}.o" for src in SOURCES]
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        cmds = [[_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(SOURCES, objs)]
        try:
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True) for cmd in cmds]
            outputs = [proc.communicate() for proc in procs]  # every one ends before a raise
            for cmd, proc, (_, err) in zip(cmds, procs, outputs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
                )
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        os.replace(tmp, target)
        build_log = "".join(out + err for out, err in outputs)
        _lib = _open(target)
        return _lib


def _open(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def check_inputs(name: str, tensors: dict, shapes: dict,
                 dtypes=torch.float32) -> torch.device:
    """Every tensor of its dtype (``dtypes``: one for all, or a dict with
    one for each), contiguous, on one device (CPU or CUDA), with the
    expected shape. Returns that device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devices))}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {device}; takes cpu or cuda tensors")
    for key, t in tensors.items():
        dtype = dtypes[key] if isinstance(dtypes, dict) else dtypes
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shapes[key])}")
        if device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
    return device
