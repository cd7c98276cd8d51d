"""Dense graph-transformer layers (port of ``diffspectra_tpu/models/layers.py``).

Parameters keep flax's names and layouts (a Dense ``kernel`` is
``[in, out]``), so a flax parameter path maps one to one onto a
``state_dict`` key (see ``warm_state.params_from_flax``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mix_attention import MASK_INF, NEG_ADJ, mix_attention


def empty_param(*shape):
    return nn.Parameter(torch.empty(*shape))


def keep_casts(module: nn.Module, *names: str) -> None:
    """Hold the named float32 parameters of ``module`` also in
    ``module.dtype``, as non-persistent buffers that every
    ``load_state_dict`` (and ``refresh_casts``) makes anew, for the
    forwards without gradients (``cast_param``): they read the copy instead
    of casting each call. In float32 there is no copy."""
    if module.dtype == torch.float32:
        return
    module._cast_names = names
    for name in names:
        module.register_buffer(name + "_cast", None, persistent=False)
    module.register_load_state_dict_post_hook(lambda mod, _keys=None: refresh_casts(mod))


def refresh_casts(model: nn.Module) -> None:
    """Make every ``keep_casts`` copy of ``model`` anew from its parameters:
    after they change other than through ``load_state_dict``."""
    for mod in model.modules():
        for name in getattr(mod, "_cast_names", ()):
            p = getattr(mod, name)
            setattr(mod, name + "_cast", None if p is None else p.detach().to(mod.dtype))


def cast_param(module: nn.Module, name: str):
    """``module.<name>`` in ``module.dtype``: the parameter itself in
    float32; with gradients enabled a cast of the live parameter, as flax's
    ``Dense(dtype=...)`` casts on every call, so the gradient reaches it;
    without, the copy that ``keep_casts`` made at the last load or
    ``refresh_casts`` (the train step refreshes it after each update)."""
    p = getattr(module, name)
    if module.dtype == torch.float32 or p is None:
        return p
    if torch.is_grad_enabled():
        return p.to(module.dtype)
    return getattr(module, name + "_cast")


def seeded_generator(seed, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; None for a
    seed of None (no dropout)."""
    if seed is None:
        return None
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return generator


def dropout(x, p: float, generator):
    """flax ``nn.Dropout(p)`` outside deterministic mode: each element kept
    with probability ``1 - p`` and scaled by ``1 / (1 - p)``, the mask drawn
    from ``generator``; ``generator=None`` or ``p == 0`` is the identity."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=dtype)``: ``x @ kernel + bias`` with ``kernel
    [in, out]``, input and parameters cast to ``dtype``. The product and the
    bias add are two ops, each rounded to ``dtype`` as flax rounds them
    (``F.linear`` rounds once, and differs from flax in bfloat16).
    ``forward_f32`` is the same layer where only a cast to float32 reads its
    output, as XLA compiles it: the product rounded to ``dtype``, the bias
    added in float32. These roundings, with ``layer_norm``'s ``dtype`` and
    ``modulate``'s float32 branch, hold the DMT to JAX's: rounding every op
    instead, the bfloat16 DMT of ``tests/test_torch_bf16.py`` moves from JAX
    by 0.51 (narrow, per-op path, no self-conditioning) and 0.57 (full
    width, edge_pred) of JAX's own bfloat16-against-float32 gap, over the
    bound of 0.5 (with them: 4e-5 and 0.38); rounding ``forward_f32``'s
    bias add alone moves the narrow block path from 0.003 to 0.42.
    Parameters start empty; they are always loaded with
    ``load_state_dict``, which also makes their copies in ``dtype``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = empty_param(in_features, features)
        self.bias = empty_param(features) if use_bias else None
        keep_casts(self, "kernel", "bias")

    def forward(self, x):
        y = x.to(self.dtype) @ cast_param(self, "kernel")
        return y if self.bias is None else y + cast_param(self, "bias")

    def forward_f32(self, x):
        y = (x.to(self.dtype) @ cast_param(self, "kernel")).float()
        return y if self.bias is None else y + cast_param(self, "bias").float()


def product(equation: str, *operands, dtype: torch.dtype) -> torch.Tensor:
    """``torch.einsum`` summed in float32 and rounded once to ``dtype``, as
    XLA's dot of ``dtype`` operands."""
    if dtype == torch.float32:
        return torch.einsum(equation, *operands)
    return torch.einsum(equation, *(x.float() for x in operands)).to(dtype)


def layer_norm(x, eps: float = 1e-6, dtype: torch.dtype = None):
    """flax ``nn.LayerNorm(use_bias=False, use_scale=False)``, eps 1e-6, its
    output in ``dtype`` (default: x's). A bfloat16 output takes flax's
    statistics, in float32 (mean and mean of squares), from x as given (a
    float32 x is a bfloat16 value that XLA left unrounded), and is rounded
    once."""
    dtype = x.dtype if dtype is None else dtype
    if dtype != torch.bfloat16:
        return F.layer_norm(x, x.shape[-1:], eps=eps)
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(torch.bfloat16)


def modulate(x, shift, scale):
    """adaLN modulation. A bfloat16 x: each op rounds to bfloat16, as XLA
    rounds it. A float32 x with bfloat16 shift and scale: ``1 + scale`` in
    float32, as XLA leaves it unrounded where only float32 math reads it."""
    if x.dtype == torch.float32:
        shift, scale = shift.float(), scale.float()
    return x * (1 + scale) + shift


def silu(x):
    """flax ``nn.silu``, ``x * sigmoid(x)``. For a bfloat16 input, XLA's
    expansion of the sigmoid, ``1 / (1 + exp(-x))``, with each op rounded
    to bfloat16 as XLA rounds it."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.reciprocal(1 + torch.exp(-x))


def _bf16(value: float) -> float:
    """``value`` rounded to bfloat16, as XLA holds a constant of a bfloat16 op."""
    return float(torch.tensor(value).to(torch.bfloat16))


GELU_C, GELU_S = _bf16(0.044715), _bf16(math.sqrt(2.0 / math.pi))


def gelu(x):
    """flax ``nn.gelu``, whose default is the tanh approximation,
    ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))``. For a
    bfloat16 input, XLA's expansion: the constants in bfloat16, each op
    rounded to bfloat16 as XLA rounds it."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    inner = (x + x * x * x * GELU_C) * GELU_S
    return x * ((torch.tanh(inner) + 1) * 0.5)


class LearnedSinusoidalPosEmb(nn.Module):
    """``[B] -> [B, dim + 1]`` = [x, sin(2 pi x w), cos(2 pi x w)]."""

    def __init__(self, dim: int = 16):
        super().__init__()
        self.weights = empty_param(dim // 2)

    def forward(self, x):
        x = x[:, None]
        freqs = x * self.weights[None, :] * 2 * math.pi
        return torch.cat([x, torch.sin(freqs), torch.cos(freqs)], dim=-1)


def _gaussian(x, mean, std):
    pi = 3.14159  # the reference's value, kept for parity
    a = (2 * pi) ** 0.5
    return torch.exp(-0.5 * ((x - mean) / std) ** 2) / (a * std)


class GaussianLayer(nn.Module):
    """Gaussian basis of squared distances ``[B, N, N, 1] -> [B, N, N, K]``
    = [x, gauss(x; means, stds)], without time conditioning (``time_dim``
    is taken and unused, as the JAX layer's)."""

    def __init__(self, K: int, time_dim=None):
        super().__init__()
        self.means = empty_param(K - 1)
        self.stds = empty_param(K - 1)

    def forward(self, x, time_emb=None):
        std = self.stds.abs() + 1e-5
        return torch.cat([x, _gaussian(x, self.means, std)], dim=-1)

    def export_params(self, time_emb):
        """``(means, stds, scale [B], shift [B])`` for the whole-block
        kernel: zero scale and shift, which leave its input as it is."""
        zeros = time_emb.new_zeros(time_emb.shape[0], dtype=torch.float32)
        return self.means, self.stds, zeros, zeros


class CondGaussianLayer(nn.Module):
    """Gaussian basis of squared distances ``[B, N, N, 1] -> [B, N, N, K]``
    with a time-conditioned scale and shift of the input; ``time_mlp``
    output column 0 is the scale, column 1 the shift. Without a
    ``time_dim`` (the DMT's ``cond_time=False``) it has no ``time_mlp`` and
    leaves the input as it is, as the JAX layer does without a time
    embedding."""

    def __init__(self, K: int, time_dim=None):
        super().__init__()
        self.means = empty_param(K - 1)
        self.stds = empty_param(K - 1)
        self.time_mlp = None if time_dim is None else Dense(time_dim, 2)

    def forward(self, x, time_emb=None):
        if self.time_mlp is not None:
            _, _, scale, shift = self.export_params(time_emb)
            x = x * (scale[:, None, None, None] + 1) + shift[:, None, None, None]
        std = self.stds.abs() + 1e-5
        return torch.cat([x, _gaussian(x, self.means, std)], dim=-1)

    def export_params(self, time_emb):
        """``(means, stds, scale [B], shift [B])`` for the whole-block
        kernel, which applies the basis on the pair grid itself."""
        ss = self.time_mlp(F.silu(time_emb))
        return self.means, self.stds, ss[:, 0], ss[:, 1]


GBF_LAYERS = {"GaussianLayer": GaussianLayer, "CondGaussianLayer": CondGaussianLayer}


class CoorsNorm(nn.Module):
    """Unit-length coordinate vectors times a learned scale. The
    double-where keeps exactly-zero vectors (the diagonal) at 0."""

    def __init__(self, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.scale = empty_param(1)

    def forward(self, coors):
        sq = (coors * coors).sum(dim=-1, keepdim=True)
        is_zero = sq <= self.eps * self.eps
        norm = torch.sqrt(torch.where(is_zero, torch.ones_like(sq), sq))
        normed = torch.where(is_zero, torch.zeros_like(coors), coors / norm.clamp_min(self.eps))
        return normed * self.scale


class DenseTransMixLayer(nn.Module):
    """Dense masked multi-head attention with edge-gated logits and values
    and ``extra_heads`` raw adjacency heads. ``x [B, N, D]``, ``edge_attr
    [B, N, N, De]``, ``extra_heads [B, N, N, n]``, ``edge_mask [B, N, N]`` ->
    ``[B, N, H*C]``. The learned logits are scaled by ``1/sqrt(out_channels)``.
    In eval mode with ``kernel`` (the JAX layer's ``use_pallas``) the
    pair-grid part is the ``mix_attention`` kernel; in training mode, or
    without ``kernel``, it is the JAX module's XLA branch
    (``_attention_train``, under autograd in training mode, with dropout on
    the attention weights). In ``dtype``: the q/k/v projections, and the
    edge and gate operands."""

    def __init__(self, x_channels: int, out_channels: int, edge_dim: int,
                 extra_heads: int = 2, heads: int = 4, set_inf: bool = False,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 kernel: bool = True):
        super().__init__()
        self.kernel = kernel
        self.heads, self.extra_heads, self.out_channels = heads, extra_heads, out_channels
        self.set_inf, self.dropout, self.dtype = set_inf, dropout, dtype
        n_sub = heads - extra_heads
        self.sub_c = heads * out_channels // n_sub
        self.lin_query = Dense(x_channels, n_sub * self.sub_c, dtype=dtype)
        self.lin_key = Dense(x_channels, n_sub * self.sub_c, dtype=dtype)
        self.lin_value = Dense(x_channels, heads * out_channels, dtype=dtype)
        self.lin_edge0_kernel = empty_param(edge_dim, n_sub * self.sub_c)
        self.lin_edge1_kernel = empty_param(edge_dim, heads * out_channels)
        keep_casts(self, "lin_edge0_kernel", "lin_edge1_kernel")
        self.eval()  # deterministic until train(), as the JAX module's default

    def forward(self, x, edge_attr, extra_heads, edge_mask, generator=None):
        n_cur = extra_heads.shape[-1]
        if n_cur != self.extra_heads:
            extra_heads = extra_heads.repeat_interleave(self.extra_heads // n_cur, dim=-1)
        B, N, _ = x.shape
        n_sub = self.heads - self.extra_heads
        q = self.lin_query(x).reshape(B, N, n_sub, self.sub_c)
        k = self.lin_key(x).reshape(B, N, n_sub, self.sub_c)
        v = self.lin_value(x).reshape(B, N, self.heads, self.out_channels)
        if self.training or not self.kernel:
            return self._attention_train(q, k, v, edge_attr, extra_heads, edge_mask, generator)
        return mix_attention(
            q, k, v, edge_attr.to(self.dtype),
            cast_param(self, "lin_edge0_kernel"), cast_param(self, "lin_edge1_kernel"),
            extra_heads, edge_mask, set_inf=self.set_inf,
        )

    def _attention_train(self, q, k, v, edge_attr, extra_heads, edge_mask, generator):
        """The JAX module's branch without its kernel
        (``diffspectra_tpu/models/layers.py:245-270``; dropout only with a
        ``generator``): the two gate
        products and their tanh in ``dtype``, the learned logits in float32
        over ``sqrt(out_channels)``, the adjacency logits, the masked softmax
        over j (float32, then ``dtype``), dropout on the weights, and the
        weighted sum of ``v * e1``. The two three-way einsums go pairwise
        as ``jnp.einsum`` orders them at every shape: ``q_i * k_j`` (then
        ``e0``) and ``e1 * alpha`` (then ``v``), each pairwise product in
        ``dtype``; each sum is float32 and its result rounded to ``dtype``,
        as XLA's dot."""
        B, N, n_sub, sub_c = q.shape
        H, C = self.heads, self.out_channels
        dt = self.dtype
        e = edge_attr.to(dt)
        e0 = torch.tanh(e @ cast_param(self, "lin_edge0_kernel")).reshape(B, N, N, n_sub, sub_c)
        e1 = torch.tanh(e @ cast_param(self, "lin_edge1_kernel")).reshape(B, N, N, H, C)
        qk = q[:, :, None] * k[:, None]
        learned = (qk.float() * e0.float()).sum(-1).to(dt).float() / math.sqrt(C)
        extra = extra_heads.float()
        if self.set_inf:
            extra = torch.where(extra == 0.0, torch.full_like(extra, NEG_ADJ), extra)
        alpha = torch.cat([extra, learned], dim=-1)
        alpha = torch.where(edge_mask[..., None] > 0, alpha, torch.full_like(alpha, MASK_INF))
        alpha = dropout(torch.softmax(alpha, dim=2).to(dt), self.dropout, generator)
        out = ((e1 * alpha[..., None]).float() * v.float()[:, None]).sum(2)
        return out.to(dt).reshape(B, N, H * C).float()

    def export_for_block(self, x):
        """The node-level ``q, k [B, N, E*sc]``, ``v [B, N, H*C]`` (in
        ``dtype``) and the raw float32 edge-gate kernels, for the whole-block
        kernel."""
        return (self.lin_query(x), self.lin_key(x), self.lin_value(x),
                self.lin_edge0_kernel, self.lin_edge1_kernel)


class DenseEdgeGateTransLayer(nn.Module):
    """Dense masked multi-head attention whose logits and values are gated
    by tanh-transformed edge features (CDGS's global attention): ``x [B, N,
    D]``, ``edge_attr [B, N, N, D]``, ``edge_mask [B, N, N]`` -> ``[B, N,
    heads * out_channels]`` (float32). q, k and v have biases, the two edge
    gates none. The logits ``sum_c q_i k_j tanh(e0_ij)`` are float32 over
    ``sqrt(out_channels)``, the padding ``MASK_INF``, the softmax over j;
    dropout (with a ``generator``) falls on the weights, and ``out_i =
    sum_j alpha_ij v_j tanh(e1_ij)``. In ``dtype``: the projections, the
    gates and both weighted sums."""

    def __init__(self, x_channels: int, out_channels: int, heads: int = 1, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.dropout, self.dtype = dropout, dtype
        width = heads * out_channels
        self.lin_query = Dense(x_channels, width, dtype=dtype)
        self.lin_key = Dense(x_channels, width, dtype=dtype)
        self.lin_value = Dense(x_channels, width, dtype=dtype)
        self.lin_edge0 = Dense(x_channels, width, use_bias=False, dtype=dtype)
        self.lin_edge1 = Dense(x_channels, width, use_bias=False, dtype=dtype)

    def forward(self, x, edge_attr, edge_mask, generator=None):
        B, N, _ = x.shape
        H, C, dt = self.heads, self.out_channels, self.dtype
        q = self.lin_query(x).reshape(B, N, H, C)
        k = self.lin_key(x).reshape(B, N, H, C)
        v = self.lin_value(x).reshape(B, N, H, C)
        e0 = torch.tanh(self.lin_edge0(edge_attr)).reshape(B, N, N, H, C)
        e1 = torch.tanh(self.lin_edge1(edge_attr)).reshape(B, N, N, H, C)
        # q_i * k_j first, then the gate, as jnp.einsum orders the three
        qk = q[:, :, None] * k[:, None]
        logits = product("bijhc,bijhc->bijh", qk, e0, dtype=dt).float() * (1.0 / math.sqrt(C))
        logits = torch.where(edge_mask[..., None] > 0, logits, torch.full_like(logits, MASK_INF))
        alpha = dropout(torch.softmax(logits, dim=2).to(dt), self.dropout, generator)
        # the gate times the weight first, then the value
        out = product("bijhc,bjhc->bihc", e1 * alpha[..., None], v, dtype=dt)
        return out.reshape(B, N, H * C).float()


def sinusoidal_timestep_embedding(timesteps, embedding_dim: int, max_positions: int = 10000):
    """The transformer's sinusoidal embedding ``[B] -> [B, embedding_dim]``
    (CDGS's time embedding): frequencies ``exp(-i log(max_positions) /
    (half - 1))``, sin then cos, a zero column after them when the width is
    odd. Float32."""
    half = embedding_dim // 2
    scale = math.log(max_positions) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=timesteps.device) * -scale)
    emb = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb
