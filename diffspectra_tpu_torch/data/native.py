"""The host batch packer (port of ``diffspectra_tpu/data/native.py``):
``pack_batch`` calls ``native/packer.cc`` through ctypes, ``pack_batch_numpy``
is its plain version.

The packer is built on first use with the host C++ compiler (``$CXX``, else
``g++``) into ``diffspectra_tpu_torch/_build/libdstt_packer.so``, from the
source alone (the JAX package's ``native/libdiffspectra_native.so`` is never
loaded). A failed build or an ABI version other than 1 raises: there is no
quiet fall back to numpy.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(ROOT, "native", "packer.cc")
BUILD_DIR = os.path.join(ROOT, "diffspectra_tpu_torch", "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libdstt_packer.so")
ABI_VERSION = 1

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile ``native/packer.cc`` into ``LIB_PATH`` unless a build newer
    than the source is there; returns the path. A compiler error raises."""
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.tmp{os.getpid()}"  # renamed into place whole
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared",
           "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the packer failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        version = lib.packer_abi_version()
        if version != ABI_VERSION:
            raise RuntimeError(f"{LIB_PATH}: packer ABI {version}, this module speaks "
                               f"{ABI_VERSION}")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.pack_batch.argtypes = [
            i64p, f32p, i64p, i64p, i64p, f32p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            f32p, f32p, f32p, f32p, f32p, f32p, f32p,
        ]
        lib.pack_batch.restype = None
        _lib = lib
    return _lib


def pack_batch_numpy(atom_type, pos, edge_type, fc, num_atom, spectra=None,
                     atom_types: int = 5, include_aromatic: bool = False,
                     use_normalize: bool = True) -> Dict[str, np.ndarray]:
    """The packer in numpy: one-hot atom types and the [exists; order / 3;
    (aromatic)] edge tensor, both masked; node and edge masks (diagonal
    zeroed); positions and charges zeroed past each molecule's atoms;
    log10(x + 1) spectra with ``use_normalize``."""
    B, N = atom_type.shape
    node_mask = (np.arange(N)[None, :] < num_atom[:, None]).astype(np.float32)
    edge_mask = node_mask[:, :, None] * node_mask[:, None, :]
    edge_mask *= 1.0 - np.eye(N, dtype=np.float32)[None]
    atom_one_hot = (atom_type[..., None] == np.arange(atom_types)).astype(np.float32)
    bond = np.where(edge_type == 4, 0.0, edge_type).astype(np.float32) / 3.0
    feats = [bond]
    if include_aromatic:
        feats.append((edge_type == 4).astype(np.float32))
    edge_feat = np.stack(feats, axis=-1) * edge_mask[..., None]
    exist = (edge_feat.sum(-1, keepdims=True) != 0).astype(np.float32)
    out = dict(
        atom_one_hot=atom_one_hot * node_mask[..., None],
        edge_one_hot=np.concatenate([exist, edge_feat], axis=-1),
        positions=pos.astype(np.float32) * node_mask[..., None],
        formal_charges=(fc.astype(np.float32) * node_mask)[..., None],
        atom_mask=node_mask,
        edge_mask=edge_mask,
    )
    if spectra is not None:
        spec = spectra.astype(np.float32)
        out["spectra"] = np.log10(spec + 1.0) if use_normalize else spec
    return out


def pack_batch(atom_type, pos, edge_type, fc, num_atom, spectra=None,
               atom_types: int = 5, include_aromatic: bool = False,
               use_normalize: bool = True) -> Dict[str, np.ndarray]:
    """``pack_batch_numpy``'s outputs from ``native/packer.cc``."""
    lib = load_library()
    B, N = atom_type.shape
    C = 3 if include_aromatic else 2
    spec_in = (np.ascontiguousarray(spectra, np.float32) if spectra is not None
               else np.zeros((B, 0), np.float32))
    out = dict(
        atom_one_hot=np.empty((B, N, atom_types), np.float32),
        edge_one_hot=np.empty((B, N, N, C), np.float32),
        atom_mask=np.empty((B, N), np.float32),
        edge_mask=np.empty((B, N, N), np.float32),
        positions=np.empty((B, N, 3), np.float32),
        formal_charges=np.empty((B, N, 1), np.float32),
    )
    spec_out = np.empty_like(spec_in)
    lib.pack_batch(
        np.ascontiguousarray(atom_type, np.int64), np.ascontiguousarray(pos, np.float32),
        np.ascontiguousarray(edge_type, np.int64), np.ascontiguousarray(fc, np.int64),
        np.ascontiguousarray(num_atom, np.int64), spec_in,
        B, N, atom_types, int(include_aromatic), int(use_normalize), spec_in.shape[1],
        out["atom_one_hot"], out["edge_one_hot"], out["atom_mask"], out["edge_mask"],
        out["positions"], out["formal_charges"], spec_out,
    )
    if spectra is not None:
        out["spectra"] = spec_out
    return out
