"""The port's TransformerLM against the flax model under the same weights.

A 2-layer, d_model 128, 4-head, vocab 256, seq 64 model in fp32.  Weights
come from the flax init and cross over through ``params_from_flax``; tokens
are drawn with numpy.  Tolerances are stated per check: fp32 throughout, so
differences are summation order (1e-5 relative on activations, looser on
gradients that sum over the batch and the sequence).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.models.convert import params_from_flax

SIZES = dict(vocab_size=256, num_layers=2, num_heads=4, d_model=128,
             d_ff=512, max_seq_len=64)


def _flax_model(impl):
    cfg = JT.TransformerConfig(dtype=jnp.float32, attention_impl=impl,
                               flash_interpret=impl == "flash", **SIZES)
    return JT.TransformerLM(cfg)


@pytest.fixture(scope="module")
def flax_params():
    model = _flax_model("dense")
    tokens = jnp.zeros((1, 64), jnp.int32)
    variables = model.init(jax.random.PRNGKey(0), tokens)
    return jax.tree_util.tree_map(np.asarray,
                                  flax.core.meta.unbox(variables))


@pytest.fixture(scope="module")
def tokens():
    return np.random.RandomState(0).randint(0, 256, (2, 64)).astype(
        np.int32)


def _torch_model(params, impl):
    cfg = TT.TransformerConfig(dtype=torch.float32, attention_impl=impl,
                               **SIZES)
    model = TT.TransformerLM(cfg)
    model.load_state_dict(params_from_flax(params))
    return model


class TestParamsFromFlax:
    def test_names_shapes_and_transpose(self, flax_params):
        sd = params_from_flax(flax_params)
        model = TT.TransformerLM(TT.TransformerConfig(
            dtype=torch.float32, **SIZES))
        assert set(sd) == set(model.state_dict())
        for name, t in model.state_dict().items():
            assert tuple(sd[name].shape) == tuple(t.shape), name
        kernel = flax_params["params"]["layer_1"]["attn"]["qkv"]["kernel"]
        np.testing.assert_array_equal(
            sd["layers.1.attn.qkv.weight"].numpy(), kernel.T)

    def test_param_count_at_full_width(self):
        """The bench's transformer: 870.9M parameters (bench.py:2839-2852)."""
        with torch.device("meta"):
            model = TT.TransformerLM(TT.TransformerConfig(
                vocab_size=32_000, num_layers=16, num_heads=16,
                d_model=2048, d_ff=8192, max_seq_len=1024))
        n = sum(p.numel() for p in model.parameters())
        assert round(n / 1e6, 1) == 870.9


class TestPieces:
    def test_rotary_is_interleaved(self):
        x = np.random.RandomState(1).randn(2, 8, 3, 16).astype(np.float32)
        pos = np.arange(8)
        want = JT.rotary_embedding(jnp.asarray(x), jnp.asarray(pos))
        got = TT.rotary_embedding(torch.from_numpy(x), torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)

    def test_rotary_bf16_angles_in_fp32(self):
        x = np.random.RandomState(2).randn(1, 300, 1, 8).astype(np.float32)
        pos = np.arange(300)
        want = JT.rotary_embedding(jnp.asarray(x).astype(jnp.bfloat16),
                                   jnp.asarray(pos))
        got = TT.rotary_embedding(torch.from_numpy(x).to(torch.bfloat16),
                                  torch.from_numpy(pos))
        assert got.dtype == torch.bfloat16
        # one bf16 rounding of the rotated values
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-2, atol=1e-2)

    def test_rmsnorm(self):
        x = np.random.RandomState(3).randn(4, 32).astype(np.float32) * 3
        scale = np.random.RandomState(4).rand(32).astype(np.float32)
        want = JT.RMSNorm().apply({"params": {"scale": scale}},
                                  jnp.asarray(x))
        norm = TT.RMSNorm(32)
        norm.scale.data = torch.from_numpy(scale)
        np.testing.assert_allclose(norm(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(want), rtol=1e-6, atol=1e-6)

    def test_gelu_is_tanh_approximation(self):
        x = np.linspace(-6, 6, 101).astype(np.float32)
        want = flax.linen.gelu(jnp.asarray(x))
        got = torch.nn.functional.gelu(torch.from_numpy(x),
                                       approximate="tanh")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["dense", "flash"])
class TestTransformerParity:
    def test_logits(self, flax_params, tokens, impl):
        want = _flax_model(impl).apply(flax_params, jnp.asarray(tokens))
        got = _torch_model(flax_params, impl)(
            torch.from_numpy(tokens).long())
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)

    def test_loss_and_grads(self, flax_params, tokens, impl):
        model_j = _flax_model(impl)
        loss_j, grads_j = jax.value_and_grad(JT.lm_loss)(
            flax_params, model_j, jnp.asarray(tokens))
        model = _torch_model(flax_params, impl)
        loss = TT.lm_loss(model, torch.from_numpy(tokens).long())
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                                   rtol=1e-5)
        want = params_from_flax(jax.tree_util.tree_map(np.asarray, grads_j))
        for name, p in model.named_parameters():
            ref = want[name].numpy()
            np.testing.assert_allclose(
                p.grad.numpy(), ref, rtol=1e-3,
                atol=1e-4 * float(np.abs(ref).max()), err_msg=name)


def test_logits_bf16_follow_flax_promotion(flax_params, tokens):
    """bf16 compute: the tied head multiplies bf16 activations by the bf16
    embedding (flax Embed.attend's promotion), so logits come out bf16.
    Each side rounds to bf16 at its own places, so the agreement is
    measured against the largest logit: 2e-2 (one bf16 step is 2^-8)."""
    cfg_j = JT.TransformerConfig(dtype=jnp.bfloat16, **SIZES)
    want = np.asarray(JT.TransformerLM(cfg_j).apply(
        flax_params, jnp.asarray(tokens)), np.float32)
    model = TT.TransformerLM(TT.TransformerConfig(dtype=torch.bfloat16,
                                                  **SIZES))
    model.load_state_dict(params_from_flax(flax_params))
    got = model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.bfloat16
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err
