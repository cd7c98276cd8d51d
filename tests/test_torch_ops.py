"""The plain PyTorch versions of the two kernels against their JAX references
(``mix_attention_reference``, ``equi_update_reference``), at small shapes and
at the flagship shape (B=2, N=29), float32, on a ragged masked batch.
Tolerance atol 2e-5, as ``tests/test_pallas_attention.py`` holds the JAX
kernel to its reference. Also: the wrappers' checks, and the masking traps
(-1e30 padding, -1e10 zero adjacency, finite rows).

The kernels themselves run on the card only; ``chip_smoke.py`` holds them
against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffspectra_tpu.ops.pallas_attention import mix_attention_reference as jax_attn
from diffspectra_tpu.ops.pallas_equi_update import equi_update_reference as jax_equi
from diffspectra_tpu_torch.api import resolve_device
from diffspectra_tpu_torch.ops import LAUNCHES
from diffspectra_tpu_torch.ops.equi_update import equi_update
from diffspectra_tpu_torch.ops.mix_attention import mix_attention, mix_attention_reference

torch.set_num_threads(2)

ATOL = 2e-5


def _masks(rng, B, N):
    n_nodes = rng.integers(1, N + 1, size=B)
    n_nodes[0] = N
    nm = (np.arange(N)[None] < n_nodes[:, None]).astype(np.float32)
    em = nm[:, :, None] * nm[:, None, :] * (1.0 - np.eye(N, dtype=np.float32))
    return em


def _attn_inputs(seed, B, N, de, n_sub, sub_c, heads, out_ch, n_extra):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    extra = (rng.random((B, N, N, n_extra)) > 0.5).astype(np.float32)
    return (f(B, N, n_sub, sub_c), f(B, N, n_sub, sub_c), f(B, N, heads, out_ch),
            f(B, N, N, de), f(de, n_sub * sub_c, scale=de**-0.5),
            f(de, heads * out_ch, scale=de**-0.5), extra, _masks(rng, B, N))


def _equi_inputs(seed, B, N, de, dd, dh, n_adj):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    adj = (rng.random((B, N, N, n_adj)) > 0.5).astype(np.float32)
    return (f(B, N, dh), f(B, N, dh), f(B, N, N, de), f(B, N, N, dd), f(B, N, N, 3),
            adj, _masks(rng, B, N), f(de, dh, scale=de**-0.5), f(dd, dh, scale=dd**-0.5),
            f(dh, scale=0.1), f(B, dh, scale=0.1), f(B, dh, scale=0.1),
            f(dh, dh, scale=dh**-0.5), f(dh, scale=0.1), f(dh, 1 + n_adj, scale=dh**-0.5))


ATTN_SHAPES = {
    "small": (3, 6, 16, 3, 8, 4, 6, 1),
    "flagship": (2, 29, 64, 14, 18, 16, 16, 2),  # B, N, De, E, sc, H, C, X
}
EQUI_SHAPES = {
    "small": (3, 6, 8, 8, 32, 2),
    "flagship": (2, 29, 64, 64, 256, 2),  # B, N, De, Dd, Dh, A
}


@pytest.mark.parametrize("set_inf", [True, False])
@pytest.mark.parametrize("shape", sorted(ATTN_SHAPES))
def test_mix_attention_plain_matches_jax_reference(shape, set_inf):
    args = _attn_inputs(0, *ATTN_SHAPES[shape])
    want = np.asarray(jax_attn(*map(jnp.asarray, args), set_inf=set_inf))
    before = LAUNCHES["mix_attention"]
    got = mix_attention(*map(torch.from_numpy, args), set_inf=set_inf).numpy()
    assert LAUNCHES["mix_attention"] == before  # CPU tensors: no kernel launch
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", sorted(EQUI_SHAPES))
def test_equi_update_plain_matches_jax_reference(shape):
    args = _equi_inputs(1, *EQUI_SHAPES[shape])
    want = np.asarray(jax_equi(*map(jnp.asarray, args)))
    before = LAUNCHES["equi_update"]
    got = equi_update(*map(torch.from_numpy, args)).numpy()
    assert LAUNCHES["equi_update"] == before
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_attention_masks_stay_finite():
    """Padding is -1e30 and a zero adjacency entry -1e10, both finite: a
    fully padded row and a row whose adjacency heads are all zero give
    finite outputs, equal to the JAX reference."""
    args = list(_attn_inputs(2, *ATTN_SHAPES["small"]))
    args[6] = np.zeros_like(args[6])  # every adjacency entry 0 -> -1e10
    args[7][1] = 0.0  # graph 1 entirely padding -> -1e30 everywhere
    want = np.asarray(jax_attn(*map(jnp.asarray, args), set_inf=True))
    got = mix_attention_reference(*map(torch.from_numpy, args), set_inf=True).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_attention_logit_scale_is_sqrt_out_channels():
    """The learned logits are divided by sqrt(out_channels), not
    sqrt(sub_channels): a learned-head-only softmax over two neighbours
    follows sigmoid(delta / sqrt(C))."""
    B, N, de, n_sub, sub_c, heads, out_ch = 1, 3, 1, 1, 2, 1, 4
    q = torch.zeros(B, N, n_sub, sub_c)
    q[0, 0, 0] = 1.0
    k = torch.zeros(B, N, n_sub, sub_c)
    k[0, 1, 0, 0], k[0, 2, 0, 0] = 3.0, 1.0
    edge = torch.full((B, N, N, de), 50.0)  # tanh -> 1
    w0 = torch.ones(de, n_sub * sub_c)
    w1 = torch.ones(de, heads * out_ch)
    v = torch.zeros(B, N, heads, out_ch)
    v[0, 1], v[0, 2] = 1.0, 0.0
    em = torch.ones(B, N, N) - torch.eye(N)
    out = mix_attention_reference(q, k, v, edge, w0, w1, torch.zeros(B, N, N, 0), em)
    want = torch.sigmoid(torch.tensor((3.0 - 1.0) / out_ch**0.5))
    torch.testing.assert_close(out[0, 0, 0], want, rtol=0, atol=1e-6)


def test_wrappers_check_their_inputs():
    args = [torch.from_numpy(a) for a in _attn_inputs(3, *ATTN_SHAPES["small"])]
    with pytest.raises(TypeError):
        mix_attention(*[a.double() for a in args])
    with pytest.raises(ValueError):  # a device that is neither CPU nor CUDA
        mix_attention(*[a.to("meta") for a in args])
    with pytest.raises(ValueError):  # wrong shape
        mix_attention(*args[:3], args[3][:, :, :-1], *args[4:])
    eargs = [torch.from_numpy(a) for a in _equi_inputs(3, *EQUI_SHAPES["small"])]
    with pytest.raises(TypeError):
        equi_update(*eargs[:-1], eargs[-1].double())
    with pytest.raises(ValueError):
        equi_update(*eargs[:-1], eargs[-1][:, :2])


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
