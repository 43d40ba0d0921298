"""The port's conv/GRU building blocks against the JAX package (CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cyclevae_tpu.models import layers as jl
from cyclevae_tpu_torch.models import layers as tl

torch.set_num_threads(1)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.tensor(np.asarray(tree))


@pytest.mark.parametrize("in_dim,k,layers", [(6, 3, 2), (5, 3, 1), (4, 5, 2), (54, 3, 2)])
def test_dilconv_effective_matches_jax(in_dim, k, layers):
    params = jl.init_dilconv(jax.random.PRNGKey(3), in_dim, k, layers)
    rng = np.random.default_rng(0)
    # nonzero biases exercise the bias composition
    params["b"] = [jnp.asarray(rng.normal(size=b.shape).astype(np.float32))
                   for b in params["b"]]
    w_j, b_j = jl.dilconv_effective(params, k)
    w_t, b_t = tl.dilconv_effective(_to_torch(params), k)
    # float32 sums of a few products each, composed in another order
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-6)


@pytest.mark.parametrize("rec", [1, 3, 9])
def test_window_gather_matches_jax(rec):
    x = np.random.default_rng(1).normal(size=(2, 11, 4)).astype(np.float32)
    want = np.asarray(jl.window_gather(jnp.asarray(x), rec))
    got = tl.window_gather(torch.tensor(x), rec).numpy()
    np.testing.assert_array_equal(got, want)   # a copy: exact


def test_window_gather_rejects_even_field():
    with pytest.raises(ValueError):
        tl.window_gather(torch.zeros(1, 4, 2), 4)


def test_dilconv_apply_matches_torch_conv1d():
    """The reference's stacked Conv1d (gru_vae.py:36-66), built in torch."""
    in_dim, k, layers = 6, 3, 2
    torch.manual_seed(0)
    rec = k ** layers
    convs = [torch.nn.Conv1d(in_dim, in_dim * k, k, padding=(rec - 1) // 2),
             torch.nn.Conv1d(in_dim * k, in_dim * k * k, k, dilation=k)]
    x = torch.randn(2, in_dim, 17)
    with torch.no_grad():
        y = convs[1](convs[0](x)).transpose(1, 2)
        params = {"w": [c.weight.detach() for c in convs],
                  "b": [c.bias.detach() for c in convs]}
        got = tl.dilconv_apply(params, x.transpose(1, 2), k)
    # the same tolerance as tests/test_layers.py's oracle
    np.testing.assert_allclose(got.numpy(), y.numpy(), atol=2e-5, rtol=1e-4)


def test_init_shapes_and_xavier_bounds():
    gen = torch.Generator().manual_seed(0)
    stack = tl.init_gru_stack(gen, 10, 16, 2)
    assert stack[0]["w_ih"].shape == (48, 10)
    assert stack[1]["w_ih"].shape == (48, 16)
    assert stack[0]["w_hh"].shape == (48, 16)
    conv = tl.init_dilconv(gen, 54, 3, 2)
    assert [w.shape for w in conv["w"]] == [(162, 54, 3), (486, 162, 3)]
    dense = tl.init_dense(gen, 16, 4)
    bound = np.sqrt(6.0 / (16 + 4))
    assert dense["w"].abs().max() <= bound and dense["w"].std() > bound / 4
    w_eff, b_eff = tl.dilconv_effective(conv, 3)
    assert w_eff.shape == (486, 486) and b_eff.shape == (486,)
