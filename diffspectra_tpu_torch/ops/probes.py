"""The Mosaic probes of ``tools/diag_mosaic_bisect.py`` as hand-written CUDA
kernels (``csrc/probe_tiles.cu``), each with its plain PyTorch version.

The JAX tool bisects which Pallas/Mosaic feature a TPU compile refuses: one
small ``pallas_call`` a feature. Wrapper ``tN`` replaces that tool's probe
``tN``, at its shapes, float32 unless marked (``PROBES[name].replaces``
gives the line):

- ``t1`` (:47) ``x * 2`` on [256, 256]; ``t2`` (:55) on [29, 29];
- ``t3`` (:63) ``x + 1`` on [8, 29, 29, 64]; ``t4`` (:71) the same over a
  grid of 8 steps; ``t11`` (:136) ``x * 2`` on [2, 29, 29, 14, 18]; t1,
  t3, t4, t6 and t11 share one kernel, its operation a template
  parameter, that cuts each step (all but t4: the whole array) into
  chunks of one thread block, which their C entries size; t2 and t9 share
  another, a float a thread, any size;
- ``t5`` (:85) ``x @ w``, [841, 64] @ [64, 252], one thread block a
  32 x 64 output tile (``product_plan``);
- ``t6`` (:94) ``tanh(x)`` on [256, 256];
- ``t7`` (:102) ``x @ w``, bf16 [841, 64] @ [64, 256], float32 result, on
  the tensor cores (``mma.sync``), one thread block a 64 x 32 output tile,
  its operands by ``cp.async`` and ``ldmatrix``, which its C entry sizes;
- ``t8`` (:111) softmax over the last axis of [29, 29], a warp a row
  held in registers;
- ``t9`` (:119) ``where(m > 0, x, -1e10)`` on [29, 29], x and the mask
  both loaded before the select;
- ``t10`` (:128) [841, 252] reshaped to [29, 29, 14, 18], summed over the
  last axis, 56 sums a thread block staged through shared memory;
- ``t12`` (:144) ``scratch = 2x; out = scratch + 1`` on [256, 256], staged
  through shared memory as the TPU probe staged it through VMEM, 2 float4
  a thread;
- ``t13`` (:158) ``q @ k.T``, [29, 252] x 2 -> [29, 29], a warp an
  output, its depth split over the lanes in float4;
- ``t14`` (:168) ``(q[:, None, :] * k[None, :, :]).sum(-1)``, [29, 64] x 2
  -> [29, 29], on t13's kernel with half a warp an output.

Each wrapper takes CPU tensors to its plain version ``tN_reference`` and
CUDA tensors to its kernel; it raises on any other device, and on a shape,
dtype or layout that is not the probe's. ``LAUNCHES["probe_tN"]`` counts
the kernel's launches. None of the probes lies on a serving path.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from . import _lib
from ._row_tile import cdiv

TOOL = "tools/diag_mosaic_bisect.py"
MASKED = -1e10  # t9's large negative, finite


def t1_reference(x):
    return x * 2.0


def t3_reference(x):
    return x + 1.0


# the same functions at other shapes (t4: over the grid)
t2_reference = t11_reference = t1_reference
t4_reference = t3_reference


def t5_reference(x, w):
    return x @ w


def t6_reference(x):
    """tanh in float64, rounded to the input's dtype: a card host's float32
    ``torch.tanh`` once read 5.15e-05 off at one element (x = 3.357214212,
    where float64 and the kernel agree to 3e-08), so the float32 CPU path
    is not a reference for a 1e-6 tolerance."""
    return torch.tanh(x.double()).to(x.dtype)


def t7_reference(x, w):
    """bf16 inputs taken to float32, a float32 product."""
    return x.float() @ w.float()


def t8_reference(x):
    return torch.softmax(x, dim=-1)


def t9_reference(x, m):
    return torch.where(m > 0, x, torch.full_like(x, MASKED))


def t10_reference(x):
    return x.reshape(29, 29, 14, 18).sum(-1)


def t12_reference(x):
    scratch = x * 2.0
    return scratch + 1.0


def t13_reference(q, k):
    return q @ k.T


def t14_reference(q, k):
    return (q[:, None, :] * k[None, :, :]).sum(-1)


# t5: a block's output tile (a warp owns 16 x 32 outputs, a thread 4 x 4),
# and the operands' depth in shared memory in chunks (K <= 64, zeros past K)
PRODUCT_ROWS, PRODUCT_COLS = 32, 64
PRODUCT_CHUNK, PRODUCT_CHUNKS = 32, 2


@dataclass(frozen=True)
class ProductPlan:
    """t5's launch (``csrc/probe_tiles.cu`` recomputes and checks it):
    ``grid`` blocks of ``threads``, each an output tile of ``rows`` x
    ``cols`` with its rows of x and slab of w in ``smem`` bytes of shared
    memory, in PRODUCT_CHUNKS depth chunks of PRODUCT_CHUNK (x rows padded
    by 4 floats)."""

    m: int
    n: int
    grid: int
    rows, cols = PRODUCT_ROWS, PRODUCT_COLS
    threads = PRODUCT_ROWS * PRODUCT_COLS // 16
    smem = 4 * PRODUCT_CHUNKS * (PRODUCT_ROWS * (PRODUCT_CHUNK + 4) + PRODUCT_CHUNK * PRODUCT_COLS)

    def ints(self) -> tuple:
        return (self.rows, self.cols, self.threads, self.grid, self.smem)

    def tiles(self) -> list:
        """(first row, rows, first column, columns) of each block's
        outputs, by block index."""
        col_tiles = cdiv(self.n, self.cols)
        out = []
        for x in range(self.grid):
            r0, c0 = x // col_tiles * self.rows, x % col_tiles * self.cols
            out.append((r0, min(self.rows, self.m - r0), c0, min(self.cols, self.n - c0)))
        return out


def product_plan(m: int, n: int, k: int) -> ProductPlan:
    depth = PRODUCT_CHUNK * PRODUCT_CHUNKS
    if k > depth:
        raise ValueError(f"t5: the kernel takes a depth up to {depth}, got {k}")
    return ProductPlan(m, n, cdiv(m, PRODUCT_ROWS) * cdiv(n, PRODUCT_COLS))


@functools.cache
def _launch_args(name: str) -> tuple:
    """Probe ``name``'s launch sizes, then its launch plan's ints (a ctypes
    array) and their count where it has a plan: made once, since a probe's
    shapes are fixed."""
    probe = PROBES[name]
    sizes = probe.sizes(probe.out_shape, *probe.inputs.values())
    if probe.plan is None:
        return sizes
    ints = probe.plan(*sizes).ints()
    return (*sizes, (ctypes.c_int * len(ints))(*ints), len(ints))


def _run(name: str, reference: Callable, inputs: dict) -> torch.Tensor:
    """Check ``inputs`` against probe ``name``; CPU: ``reference``; CUDA:
    the kernel ``dstt_probe_<name>`` with the pointers of the inputs and the
    output, then ``_launch_args``."""
    probe = PROBES[name]
    device = _lib.check_inputs(name, inputs, probe.inputs, probe.dtype)
    if device.type == "cpu":
        return reference(*inputs.values())
    lib = _lib.build()
    out = torch.empty(probe.out_shape, device=device, dtype=torch.float32)
    rc = getattr(lib, f"dstt_probe_{name}")(
        *(t.data_ptr() for t in inputs.values()), out.data_ptr(), *_launch_args(name),
        _lib.stream_handle(device))
    _lib.check_rc(f"probe {name}", rc)
    _lib.LAUNCHES[f"probe_{name}"] += 1
    return out


def t1(x):
    return _run("t1", t1_reference, dict(x=x))


def t2(x):
    return _run("t2", t2_reference, dict(x=x))


def t3(x):
    return _run("t3", t3_reference, dict(x=x))


def t4(x):
    return _run("t4", t4_reference, dict(x=x))


def t5(x, w):
    return _run("t5", t5_reference, dict(x=x, w=w))


def t6(x):
    return _run("t6", t6_reference, dict(x=x))


def t7(x, w):
    return _run("t7", t7_reference, dict(x=x, w=w))


def t8(x):
    return _run("t8", t8_reference, dict(x=x))


def t9(x, m):
    return _run("t9", t9_reference, dict(x=x, m=m))


def t10(x):
    return _run("t10", t10_reference, dict(x=x))


def t11(x):
    return _run("t11", t11_reference, dict(x=x))


def t12(x):
    return _run("t12", t12_reference, dict(x=x))


def t13(q, k):
    return _run("t13", t13_reference, dict(q=q, k=k))


def t14(q, k):
    return _run("t14", t14_reference, dict(q=q, k=k))


# A launcher's sizes, from the output's shape and the inputs' shapes.
def _elements(out, *_):
    return (math.prod(out),)


def _grid(out, _):  # grid steps, elements a step
    return (out[0], math.prod(out[1:]))


def _rows(out, _):  # rows, row length
    return out


def _segments(out, x):  # sums, terms a sum
    return (math.prod(out), math.prod(x) // math.prod(out))


def _product(out, a, _):  # [m, depth] times [depth, n] or [n, depth]^T: m, n, depth
    return (*out, a[1])


@dataclass(frozen=True)
class Probe:
    """One probe: its wrapper and plain version, its inputs (name -> shape,
    all of ``dtype``), its output shape, its launcher's sizes from those
    shapes, the tool's line it replaces, the operations it needs, the
    largest |kernel - plain| it may show, and its launch plan from those
    sizes where the launcher takes one."""

    wrapper: Callable
    reference: Callable
    inputs: dict
    out_shape: tuple
    sizes: Callable
    line: int
    flops: int
    atol: float
    dtype: torch.dtype = torch.float32
    plan: Optional[Callable] = None

    @property
    def replaces(self) -> str:
        return f"{TOOL}:{self.line}"

    @property
    def nbytes(self) -> int:
        """Each input read once, the float32 output written once."""
        size = torch.tensor([], dtype=self.dtype).element_size()
        return size * sum(map(math.prod, self.inputs.values())) + 4 * math.prod(self.out_shape)


_SQUARE, _PAIR, _GRID = (256, 256), (29, 29), (8, 29, 29, 64)
_E0 = (2, 29, 29, 14, 18)

# Tolerances: copies, masks and +1/x2 are exact; tanh and the softmax
# 1e-6 (a few ulp of values up to 1); the 18-wide sums of t10 and the
# 64-deep sums of t14 1e-5; the 64- and 252-deep products of unit normals
# (t5, t13) and the bf16 product (t7) 1e-4, since their sums run in
# another order.
PROBES = {
    "t1": Probe(t1, t1_reference, dict(x=_SQUARE), _SQUARE, _elements, 47,
                math.prod(_SQUARE), 0.0),
    "t2": Probe(t2, t2_reference, dict(x=_PAIR), _PAIR, _elements, 55, math.prod(_PAIR), 0.0),
    "t3": Probe(t3, t3_reference, dict(x=_GRID), _GRID, _elements, 63, math.prod(_GRID), 0.0),
    "t4": Probe(t4, t4_reference, dict(x=_GRID), _GRID, _grid, 71, math.prod(_GRID), 0.0),
    "t5": Probe(t5, t5_reference, dict(x=(841, 64), w=(64, 252)), (841, 252), _product, 85,
                2 * 841 * 64 * 252, 1e-4, plan=product_plan),
    "t6": Probe(t6, t6_reference, dict(x=_SQUARE), _SQUARE, _elements, 94,
                math.prod(_SQUARE), 1e-6),
    "t7": Probe(t7, t7_reference, dict(x=(841, 64), w=(64, 256)), (841, 256), _product, 102,
                2 * 841 * 64 * 256, 1e-4, dtype=torch.bfloat16),
    # the row max, the subtraction, exp, the row sum and the division
    "t8": Probe(t8, t8_reference, dict(x=_PAIR), _PAIR, _rows, 111, 5 * math.prod(_PAIR), 1e-6),
    "t9": Probe(t9, t9_reference, dict(x=_PAIR, m=_PAIR), _PAIR, _elements, 119,
                math.prod(_PAIR), 0.0),
    "t10": Probe(t10, t10_reference, dict(x=(841, 252)), (29, 29, 14), _segments, 128,
                 841 * 252, 1e-5),
    "t11": Probe(t11, t11_reference, dict(x=_E0), _E0, _elements, 136, math.prod(_E0), 0.0),
    "t12": Probe(t12, t12_reference, dict(x=_SQUARE), _SQUARE, _elements, 144,
                 2 * math.prod(_SQUARE), 0.0),
    "t13": Probe(t13, t13_reference, dict(q=(29, 252), k=(29, 252)), _PAIR, _product, 158,
                 2 * 29 * 29 * 252, 1e-4),
    "t14": Probe(t14, t14_reference, dict(q=(29, 64), k=(29, 64)), _PAIR, _product, 168,
                 2 * 29 * 29 * 64, 1e-5),
}
