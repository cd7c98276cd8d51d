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
``(h_out [B, N, Dh], edge_out [B, N, N, De], agg [B, N, 3])``, all float32.
"""

from __future__ import annotations

import ctypes

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
    """Plain PyTorch version, the same math as the JAX kernel body."""
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
    """CPU tensors: the plain version. CUDA tensors: the kernel (two
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
    ))
    kw = dict(set_inf=set_inf, n_heads=n_heads, n_extra=n_extra, out_ch=out_ch, eps_ln=eps_ln)
    if device.type == "cpu":
        return block_fused_reference(*args, **kw)
    if N > 32 or dh % 32 or dh > 1024 or hc != dh or n_extra > 3:
        raise ValueError(f"block_fused kernel: takes N <= 32, Dh = H*C a multiple of 32 up to "
                         f"1024 and A <= 3, got N={N}, Dh={dh}, H*C={hc}, A={n_extra}")
    lib = _lib.build()
    empty = lambda *shape: torch.empty(shape, device=device, dtype=torch.float32)
    outs = (empty(B, N, dh), empty(B, N, N, de), empty(B, N, 3))
    scratch = (empty(B, N, de), empty(B, N, dh), empty(B, N, dh))  # p, node_i, node_j
    bufs = (ctypes.c_void_p * (len(args) + 6))(*(t.data_ptr() for t in (*args, *outs, *scratch)))
    dims = (ctypes.c_int * 12)(B, N, dh, de, n_sub, ec // n_sub, n_heads, out_ch, n_extra,
                               rn, re, int(set_inf))
    rc = lib.dstt_block_fused(bufs, len(bufs), dims, len(dims), eps_ln,
                              _lib.stream_handle(device))
    _lib.check_rc("block_fused", rc)
    _lib.LAUNCHES["block_fused"] += 1
    return outs
