"""Time the row-tile kernels with the launch plan's tile height and with
each height forced, on the card.

``csrc/equi_update.cu`` and ``csrc/mix_attention.cu`` take tiles of 64 or
of 32 pair rows, whichever their plan (``ops/_row_tile.py``) finds cheaper
at the shapes. Each variant here is those two sources with the plan given
one height, built with nvcc into ``_build/row_tiles/``; the wrappers then
run it with the Python plan given the same height. At each shape (B=10,
N=17..29 and B=80, N=21, 29, flagship widths, ragged graphs) it prints each
kernel's device time a call (profiler, 50 calls, warm L2) and its largest
error against the plain version, twice over, variants in turn ("not
measured" where the profiler dropped kernel events three windows running).

    python -m diffspectra_tpu_torch.tools.row_tiles
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..ops import _lib, _row_tile
from ..ops import equi_update as equi
from ..ops import mix_attention as attn

SHAPES = ((10, 17), (10, 21), (10, 25), (10, 29), (80, 21), (80, 29))
VARIANTS = {"plan": (64, 32), "only64": (64,), "only32": (32,)}
PLAN_LOOP = "for (int tr : {64, 32})"


def build_variant(name: str, file: str, edits: tuple, sources: tuple,
                  entries: tuple) -> ctypes.CDLL:
    """``csrc/`` copied into ``_build/<name>`` with each ``(old, new)`` of
    ``edits`` applied to ``file``, ``sources`` of it built with nvcc into
    one library and loaded, its C entries whose names start with one of
    ``entries`` typed."""
    out = _lib.BUILD_DIR / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_lib._PKG / "csrc", out)
    text = (out / file).read_text()
    for old, new in edits:
        assert old in text, f"{file} no longer holds {old!r}: update this tool"
        text = text.replace(old, new)
    (out / file).write_text(text)
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(out / "lib.so"), *(str(out / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out / "lib.so"))
    for fn, types in _lib._ARGTYPES.items():
        if fn.startswith(entries):
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def device_ms(fn, iters: int = 50, tries: int = 3):
    """Device time a call of the CUDA kernels ``fn`` launches (profiler);
    a window in which some kernel events did not arrive is taken again,
    and None (not measured) comes after ``tries`` such windows."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        if kernels and min(e.count for e in kernels) >= iters:
            return sum(e.device_time_total for e in kernels) / iters / 1e3
    return None


def cases(B: int, N: int, gen: torch.Generator, dev) -> dict:
    """Seeded flagship-width inputs of both kernels for B graphs of
    N, then 1..N atoms, padded to N."""
    n_nodes = [N] + torch.randint(1, N + 1, (B - 1,), generator=gen).tolist()
    node = (torch.arange(N)[None] < torch.tensor(n_nodes)[:, None]).float()
    mask = (node[:, :, None] * node[:, None, :] * (1.0 - torch.eye(N))).to(dev)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    bits = lambda *s: (torch.rand(*s, generator=gen) > 0.5).float().to(dev)
    de, dh = 64, 256
    equi_args = (r(B, N, dh), r(B, N, dh), r(B, N, N, de), r(B, N, N, de), r(B, N, N, 3),
                 bits(B, N, N, 2), mask, r(de, dh, scale=de**-0.5), r(de, dh, scale=de**-0.5),
                 r(dh, scale=0.1), r(B, dh, scale=0.1), r(B, dh, scale=0.1),
                 r(dh, dh, scale=dh**-0.5), r(dh, scale=0.1), r(dh, 3, scale=dh**-0.5))
    attn_args = (r(B, N, 14, 18), r(B, N, 14, 18), r(B, N, 16, 16), r(B, N, N, de),
                 r(de, 252, scale=de**-0.5), r(de, dh, scale=de**-0.5), bits(B, N, N, 2), mask)
    return {"equi_update": (equi.equi_update, equi.equi_update_reference, equi_args, {}),
            "mix_attention": (attn.mix_attention, attn.mix_attention_reference, attn_args,
                              {"set_inf": True})}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("row_tiles: CUDA is not available; this tool runs on the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    libs = {name: build_variant(f"row_tiles/{name}", "row_tile.cuh",
                                ((PLAN_LOOP, "for (int tr : {%s})" % ", ".join(map(str, heights))),),
                                ("equi_update.cu", "mix_attention.cu"),
                                ("dstt_equi_update", "dstt_mix_attention"))
            for name, heights in VARIANTS.items()}
    gen = torch.Generator().manual_seed(0)
    inputs = {shape: cases(*shape, gen, dev) for shape in SHAPES}
    saved = _lib._lib, _row_tile.TILE_ROWS
    try:
        for round_ in range(2):
            for name, lib in libs.items():
                _lib._lib, _row_tile.TILE_ROWS = lib, VARIANTS[name]
                for (B, N), kernels in inputs.items():
                    parts = []
                    for kname, (kernel, plain, args, kw) in kernels.items():
                        got, want = kernel(*args, **kw), plain(*args, **kw)
                        err = (got - want).abs().max().item()
                        plan = (equi.launch_plan(B, N, 64, 64, 256) if kname == "equi_update"
                                else attn.launch_plan(B, N, 64, 252, 256, 16))
                        ms = device_ms(lambda: kernel(*args, **kw))
                        parts.append(f"{kname} {'not measured' if ms is None else f'{ms:.4f} ms'} "
                                     f"({plan.grid} tiles of {plan.tile_rows}, err {err:.2e})")
                    print(f"round {round_} {name:6s} B={B} N={N}: " + "; ".join(parts), flush=True)
    finally:
        _lib._lib, _row_tile.TILE_ROWS = saved
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
