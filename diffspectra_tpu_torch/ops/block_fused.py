"""The whole pair-grid chain of one ``EquivariantMixBlock``: the CUDA kernel
``csrc/block_fused.cu`` and its plain PyTorch version.

Port of ``diffspectra_tpu/ops/pallas_block.py`` (``block_fused``), with the
JAX layout and argument order at the public functions (flagship widths in
brackets): h ``[B, N, Dh=256]``, q, k ``[B, N, E*sc=252]``, v
``[B, N, H*C=256]``, edge_in ``[B, N, N, De=64]``, d2 ``[B, N, N, 1]``,
normed_diff ``[B, N, N, 3]``, adj ``[B, N, N, A=n_extra]``, edge_mask
``[B, N, N]``, node_mask ``[B, N, 1]``, node_mods4 ``[B, 4, Dh]`` (gate_msa,
shift_mlp, scale_mlp, gate_mlp), edge_mods6 ``[B, 6, De]`` (shift_msa,
scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp), eq_ss ``[B, 2, Dh]``
(shift, scale), gbf_ss ``[B, 1, 2]`` (scale, shift), then the weights ->
``(h_out [B, N, Dh], edge_out [B, N, N, De], agg [B, N, 3])``, all float32
but q, k and v, which are float32 or bfloat16 (the JAX DMT in bfloat16
passes them so; it passes the weights raw, in float32). Either way the math
is float32, as the Pallas kernel casts every operand to float32.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _lib
from .equi_update import equi_update_reference
from .mix_attention import mix_attention_reference

_WEIGHTS = ("gbf_means", "gbf_stds", "emb_kd", "emb_ke", "emb_b", "w0a", "w1a", "n2e_k",
            "n2e_b", "fn1_k", "fn1_b", "fn2_k", "fn2_b", "fe1_k", "fe1_b", "fe2_k", "fe2_b",
            "w_hi", "w_hj", "w_e", "w_d", "eq_bias", "eq_k0", "eq_b0", "eq_k1")
_DATA = ("h", "q", "k", "v", "edge_in", "d2", "normed_diff", "adj", "edge_mask", "node_mask",
         "node_mods4", "edge_mods6", "eq_ss", "gbf_ss")
DTYPES = (torch.float32, torch.bfloat16)  # of q, k and v


# The kernel's tiles (csrc/block_fused.cu keeps the same numbers)
PAIR_ROWS = 64  # pairs of a stage A / B tile
NODE_ROWS = 32  # rows of a node tile, at most; 16 at least
_WIDE, _NARROW = 128, 64  # output columns of a pass
_RING, _RING_NARROW = 3 * 8 * _WIDE, 3 * 8 * _NARROW  # a weight's ring: 3 chunks of 8 rows
_MAX_GATE = 4
SMS = 132  # H100 SXM
MAX_SMEM = 232448  # shared memory a block may use, bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _ld(width: int) -> int:
    """Row stride of a shared-memory tile: 16-byte rows plus 4 floats."""
    return (width + 3) // 4 * 4 + 4


@dataclass(frozen=True)
class LaunchPlan:
    """The five launches of one ``block_fused`` call, in stream order:
    stage A (``attn_stage``) and stage B (``pair_stage``) take one block per
    tile of ``rows_per_tile`` rows of one molecule (``tiles`` a molecule);
    N1-N3 (``node_in_stage``, ``node_out_stage``, ``node_proj_stage``) take
    ``node_tiles`` tiles of 16-31 rows over all B N rows, times their
    column tiles. ``smem_*`` are bytes of dynamic shared memory a block."""

    batch: int
    n: int
    rows_per_tile: int
    tiles: int
    node_tiles: int
    grid_a: int
    smem_a: int
    grid_n1: int
    smem_n1: int
    grid_n2: int
    smem_n2: int
    grid_n3: int
    smem_n3: int
    grid_b: int
    smem_b: int

    def ints(self) -> tuple:
        """The plan as ``dstt_block_fused`` takes it."""
        return (self.rows_per_tile, self.tiles, self.node_tiles, self.grid_a, self.smem_a,
                self.grid_n1, self.smem_n1, self.grid_n2, self.smem_n2, self.grid_n3,
                self.smem_n3, self.grid_b, self.smem_b)

    def launches(self) -> dict:
        """Blocks and shared-memory bytes of each launch, in stream order."""
        return {"attn_stage": (self.grid_a, self.smem_a),
                "node_in_stage": (self.grid_n1, self.smem_n1),
                "node_out_stage": (self.grid_n2, self.smem_n2),
                "node_proj_stage": (self.grid_n3, self.smem_n3),
                "pair_stage": (self.grid_b, self.smem_b)}

    def pair_tiles(self) -> list:
        """(molecule, first row, rows) of each stage A / B block, by block index."""
        out = []
        for x in range(self.batch * self.tiles):
            b, t = divmod(x, self.tiles)
            i0 = t * self.rows_per_tile
            out.append((b, i0, min(self.rows_per_tile, self.n - i0)))
        return out

    def node_rows(self) -> list:
        """[r0, r1) of each node tile over the B N rows."""
        m = self.batch * self.n
        return [(t * m // self.node_tiles, (t + 1) * m // self.node_tiles)
                for t in range(self.node_tiles)]


def launch_plan(batch: int, n: int, dh: int, de: int, ec: int, hc: int, heads: int,
                rn: int, re: int) -> LaunchPlan:
    """The kernel's launches at these shapes. R = 64 // N rows a tile (the
    most whose pairs fit a 64-pair tile), or 2 when that leaves SMs idle;
    node tiles: B N // 16 of them, rows split evenly."""
    r = min(n, max(1, PAIR_ROWS // n))
    if batch * _cdiv(n, r) < SMS and r > 2:
        r = 2
    tiles = _cdiv(n, r)
    node_tiles = max(1, batch * n // 16)
    lde = _ld(de)
    return LaunchPlan(
        batch=batch, n=n, rows_per_tile=r, tiles=tiles, node_tiles=node_tiles,
        grid_a=batch * tiles,
        smem_a=4 * (PAIR_ROWS * lde + max(2 * PAIR_ROWS * lde, PAIR_ROWS * _ld(max(ec, hc)))
                    + PAIR_ROWS * heads + _RING),
        grid_n1=node_tiles * (_cdiv(rn, _WIDE) + _cdiv(de, _WIDE)),
        smem_n1=4 * (NODE_ROWS * _ld(dh) + _RING),
        grid_n2=node_tiles * _cdiv(dh, _NARROW),
        smem_n2=4 * (NODE_ROWS * _ld(rn) + _RING_NARROW),
        grid_n3=node_tiles * 2 * _cdiv(dh, _WIDE),
        smem_n3=4 * (NODE_ROWS * _ld(dh) + _RING),
        grid_b=batch * tiles,
        smem_b=4 * (2 * PAIR_ROWS * lde + PAIR_ROWS * max(_ld(re), _ld(dh))
                    + PAIR_ROWS * (_MAX_GATE + 1) + _RING),
    )


def _ln(x, eps: float = 1e-6):
    """LayerNorm without affine, two passes as in the JAX reference."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def _gauss(x, mean, std):
    pi = 3.14159  # the reference's value, kept for parity
    a = (2 * pi) ** 0.5
    return torch.exp(-0.5 * ((x - mean) / std) ** 2) / (a * std)


def block_fused_reference(
    h, q, k, v, edge_in, d2, normed_diff, adj, edge_mask, node_mask,
    node_mods4, edge_mods6, eq_ss, gbf_ss,
    gbf_means, gbf_stds, emb_kd, emb_ke, emb_b, w0a, w1a, n2e_k, n2e_b,
    fn1_k, fn1_b, fn2_k, fn2_b, fe1_k, fe1_b, fe2_k, fe2_b,
    w_hi, w_hj, w_e, w_d, eq_bias, eq_k0, eq_b0, eq_k1,
    *, set_inf: bool = True, n_heads: int, n_extra: int, out_ch: int, eps_ln: float = 1e-6,
):
    """Plain PyTorch version, the math of the JAX kernel body: float32 from
    q, k and v of either dtype."""
    q, k, v = q.float(), k.float(), v.float()
    B, N, _ = h.shape
    n_sub = n_heads - n_extra
    sub_c = n_heads * out_ch // n_sub
    scale_t, shift_t = gbf_ss[:, 0, 0, None, None, None], gbf_ss[:, 0, 1, None, None, None]
    x = d2 * (scale_t + 1.0) + shift_t
    dist_gbf = torch.cat([x, _gauss(x, gbf_means, gbf_stds.abs() + 1e-5)], dim=-1)

    em = edge_mods6[:, :, None, None, :]  # [B, 6, 1, 1, De]
    e_attr = dist_gbf @ emb_kd + edge_in @ emb_ke + emb_b
    e_mod = _ln(e_attr, eps_ln) * (1.0 + em[:, 1]) + em[:, 0]
    attn = mix_attention_reference(
        q.reshape(B, N, n_sub, sub_c), k.reshape(B, N, n_sub, sub_c),
        v.reshape(B, N, n_heads, out_ch), e_mod, w0a, w1a, adj, edge_mask, set_inf=set_inf,
    )
    p = attn @ n2e_k
    h_edge = p[:, :, None, :] + p[:, None, :, :] + n2e_b

    nm = node_mods4[:, :, None, :]  # [B, 4, 1, Dh]
    h1 = h + nm[:, 0] * attn
    h1 = (_ln(h1, eps_ln) * (1.0 + nm[:, 2]) + nm[:, 1]) * node_mask
    ffn = F.silu(h1 @ fn1_k + fn1_b) @ fn2_k + fn2_b
    h_out = (h1 + nm[:, 3] * ffn) * node_mask

    e_res = edge_in + em[:, 2] * h_edge
    e_res = _ln(e_res, eps_ln) * (1.0 + em[:, 4]) + em[:, 3]
    edge_out = e_res + em[:, 5] * (F.silu(e_res @ fe1_k + fe1_b) @ fe2_k + fe2_b)

    agg = equi_update_reference(
        h_out @ w_hi, h_out @ w_hj, edge_out, dist_gbf, normed_diff, adj, edge_mask,
        w_e, w_d, eq_bias, eq_ss[:, 0], eq_ss[:, 1], eq_k0, eq_b0, eq_k1, eps_ln=eps_ln,
    )
    return h_out, edge_out, agg


def block_fused(*args, set_inf: bool = True, n_heads: int, n_extra: int, out_ch: int,
                eps_ln: float = 1e-6):
    """CPU tensors: the plain version. CUDA tensors: the kernel (five
    launches, counted as one call). Arguments as ``block_fused_reference``."""
    if len(args) != len(_DATA) + len(_WEIGHTS):
        raise TypeError(f"block_fused takes {len(_DATA) + len(_WEIGHTS)} tensors, got {len(args)}")
    named = dict(zip(_DATA + _WEIGHTS, args))
    B, N, dh = named["h"].shape
    de = named["edge_in"].shape[-1]
    n_sub = n_heads - n_extra
    if n_sub < 1:
        raise ValueError(f"block_fused: {n_heads} heads with {n_extra} adjacency heads")
    ec, hc = n_sub * (n_heads * out_ch // n_sub), n_heads * out_ch
    rn, re = named["fn1_k"].shape[-1], named["fe1_k"].shape[-1]
    dt = named["q"].dtype
    if dt not in DTYPES:
        raise TypeError(f"block_fused: q is {dt}, takes one of {DTYPES}")
    dtypes = {key: dt if key in ("q", "k", "v") else torch.float32 for key in named}
    device = _lib.check_inputs("block_fused", named, dict(
        h=(B, N, dh), q=(B, N, ec), k=(B, N, ec), v=(B, N, hc), edge_in=(B, N, N, de),
        d2=(B, N, N, 1), normed_diff=(B, N, N, 3), adj=(B, N, N, n_extra),
        edge_mask=(B, N, N), node_mask=(B, N, 1), node_mods4=(B, 4, dh),
        edge_mods6=(B, 6, de), eq_ss=(B, 2, dh), gbf_ss=(B, 1, 2),
        gbf_means=(de - 1,), gbf_stds=(de - 1,), emb_kd=(de, de), emb_ke=(de, de),
        emb_b=(de,), w0a=(de, ec), w1a=(de, hc), n2e_k=(hc, de), n2e_b=(de,),
        fn1_k=(dh, rn), fn1_b=(rn,), fn2_k=(rn, dh), fn2_b=(dh,), fe1_k=(de, re),
        fe1_b=(re,), fe2_k=(re, de), fe2_b=(de,), w_hi=(dh, dh), w_hj=(dh, dh),
        w_e=(de, dh), w_d=(de, dh), eq_bias=(dh,), eq_k0=(dh, dh), eq_b0=(dh,),
        eq_k1=(dh, 1 + n_extra),
    ), dtypes)
    kw = dict(set_inf=set_inf, n_heads=n_heads, n_extra=n_extra, out_ch=out_ch, eps_ln=eps_ln)
    if device.type == "cpu":
        return block_fused_reference(*args, **kw)
    if N > 32 or dh % 32 or dh > 1024 or hc != dh or n_extra > 3:
        raise ValueError(f"block_fused kernel: takes N <= 32, Dh = H*C a multiple of 32 up to "
                         f"1024 and A <= 3, got N={N}, Dh={dh}, H*C={hc}, A={n_extra}")
    plan = launch_plan(B, N, dh, de, ec, hc, n_heads, rn, re)
    smem = max(bytes_ for _, bytes_ in plan.launches().values())
    if smem > MAX_SMEM:
        raise ValueError(f"block_fused kernel: a launch needs {smem} bytes of shared memory at "
                         f"Dh={dh}, De={de}, over the card's {MAX_SMEM}")
    lib = _lib.build()
    empty = lambda *shape: torch.empty(shape, device=device, dtype=torch.float32)
    outs = (empty(B, N, dh), empty(B, N, N, de), empty(B, N, 3))
    # attn, h1, mid, p, node_i, node_j: passed from one launch to the next
    scratch = (empty(B, N, hc), empty(B, N, dh), empty(B, N, rn), empty(B, N, de),
               empty(B, N, dh), empty(B, N, dh))
    bufs = (ctypes.c_void_p * (len(args) + 9))(*(t.data_ptr() for t in (*args, *outs, *scratch)))
    bf16 = dt == torch.bfloat16
    dims = (ctypes.c_int * 13)(B, N, dh, de, n_sub, ec // n_sub, n_heads, out_ch, n_extra,
                               rn, re, int(set_inf), int(bf16))
    ints = (ctypes.c_int * 13)(*plan.ints())
    rc = lib.dstt_block_fused(bufs, len(bufs), dims, len(dims), ints, len(ints), eps_ln,
                              _lib.stream_handle(device))
    _lib.check_rc("block_fused", rc)
    _lib.LAUNCHES["block_fused_bf16" if bf16 else "block_fused"] += 1
    return outs
