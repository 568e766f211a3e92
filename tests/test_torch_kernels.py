"""The port's kernels (horovod_tpu_torch.ops.kernels) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On the CPU each wrapper takes its plain PyTorch version, so these tests pin
the plain versions' semantics to the Pallas kernels'.  The CUDA kernels are
held against the plain versions by ``tests/test_torch_gpu.py`` on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_kernels as PK
from horovod_tpu_torch.ops import kernels as K


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _jnp_dtype(dt):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
            torch.float16: jnp.float16}[dt]


def _np(t):
    return t.detach().float().numpy()


class TestFusedScale:
    @pytest.mark.parametrize("shape", [(300,), (4, 64), (1000,), (3, 77),
                                       (5, 130), (7, 13, 11), (1,)])
    @pytest.mark.parametrize("factor", [2.5, 1.7, 0.0])
    def test_matches_pallas_f32(self, shape, factor):
        x = _rand(0, *shape)
        want = PK.fused_scale(jnp.asarray(x), factor, interpret=True)
        got = K.fused_scale(torch.from_numpy(x), factor)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        # the same single fp32 multiply: equal bits
        np.testing.assert_array_equal(_np(got), np.asarray(want))

    @pytest.mark.parametrize("shape", [(4, 64), (130,), (3, 77)])
    @pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float16])
    def test_matches_pallas_cast(self, shape, out_dtype):
        x = _rand(1, *shape)
        want = PK.fused_scale(jnp.asarray(x), 0.3,
                              out_dtype=_jnp_dtype(out_dtype),
                              interpret=True)
        got = K.fused_scale(torch.from_numpy(x), 0.3, out_dtype)
        assert got.dtype == out_dtype and tuple(got.shape) == shape
        # both round the same fp32 product to nearest even
        np.testing.assert_array_equal(_np(got),
                                      np.asarray(want, np.float32))

    def test_bf16_input_to_f32(self):
        x = _rand(2, 257)
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        want = PK.fused_scale(xj, 0.25, out_dtype=jnp.float32,
                              interpret=True)
        got = K.fused_scale(torch.from_numpy(x).to(torch.bfloat16), 0.25,
                            torch.float32)
        np.testing.assert_array_equal(_np(got), np.asarray(want))

    def test_out_in_place(self):
        x = torch.from_numpy(_rand(3, 99))
        ref = x * 0.5
        y = K.fused_scale(x, 0.5, out=x)
        assert y.data_ptr() == x.data_ptr()
        torch.testing.assert_close(x, ref, rtol=0, atol=0)


def _qkv(seed, shape, n=3):
    return [_rand(seed + i, *shape) for i in range(n)]


class TestFlashPlainVersusPallas:
    """Tolerances are the JAX tests' own: 2e-5 forward, 1e-4 gradients in
    fp32 (the plain version's one-pass softmax against the kernel's
    blocked online softmax)."""

    @pytest.mark.parametrize("causal,bq,bk", [
        (False, 16, 16), (True, 16, 16), (True, 16, 32), (True, 32, 16)])
    def test_forward_out_and_lse(self, causal, bq, bk):
        q, k, v = _qkv(10, (2, 64, 2, 16))
        scale = 16 ** -0.5
        out_j, lse_j = PK._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, scale, bq, bk,
                                     interpret=True)
        out, lse = K.flash_fwd(*map(torch.from_numpy, (q, k, v)), causal,
                               scale)
        np.testing.assert_allclose(_np(out), np.asarray(out_j), rtol=2e-5,
                                   atol=2e-5)
        # the Pallas lse carries an 8-sublane replication axis: row 0
        assert tuple(lse.shape) == (4, 64)
        np.testing.assert_allclose(_np(lse), np.asarray(lse_j)[:, 0, :],
                                   rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("causal,bq,bk", [
        (False, 8, 8), (True, 8, 8), (True, 16, 8), (True, 8, 16)])
    def test_backward_dq_dk_dv(self, causal, bq, bk):
        q, k, v, g = _qkv(20, (2, 32, 2, 8), n=4)
        scale = 8 ** -0.5
        jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
        out_j, lse_j = PK._flash_fwd(jq, jk, jv, causal, scale, bq, bk,
                                     interpret=True)
        dq_j, dk_j, dv_j = PK._flash_bwd(jq, jk, jv, out_j, lse_j, jg,
                                         causal, scale, bq, bk,
                                         interpret=True)
        tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
        out = torch.from_numpy(np.array(out_j))
        lse = torch.from_numpy(np.asarray(lse_j)[:, 0, :].copy())
        delta = K.flash_delta(out, tg)
        dq = K.flash_bwd_dq(tq, tk, tv, tg, lse, delta, causal, scale)
        dk, dv = K.flash_bwd_dkv(tq, tk, tv, tg, lse, delta, causal, scale)
        for got, want, name in ((dq, dq_j, "dq"), (dk, dk_j, "dk"),
                                (dv, dv_j, "dv")):
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-4, atol=1e-4, err_msg=name)

    @pytest.mark.parametrize("causal", [False, True])
    def test_autograd_matches_jax_grad(self, causal):
        q, k, v = _qkv(30, (1, 32, 2, 8))

        def loss_j(q, k, v):
            return jnp.sum(PK.flash_attention(q, k, v, causal=causal,
                                              block_q=8, block_k=8,
                                              interpret=True) ** 2)

        grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = K.flash_attention(*ts, causal=causal, block_q=8, block_k=8)
        (out ** 2).sum().backward()
        for t, want, name in zip(ts, grads_j, "qkv"):
            np.testing.assert_allclose(_np(t.grad), np.asarray(want),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"d{name}")

    @pytest.mark.parametrize("t", [24, 30, 48, 136, 64])
    def test_off_grid_sequences(self, t):
        """The dispatch rule: 24/48/64 tile, 30 and 136 compute reference
        attention — same numbers either way."""
        q, k, v = _qkv(40, (2, t, 2, 16))
        want = PK.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                  block_q=32, block_k=32, interpret=True)
        got = K.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=True, block_q=32, block_k=32)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)

    def test_bf16_forward_close_to_pallas(self):
        q, k, v = _qkv(50, (1, 48, 2, 16))
        jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
        tx = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
        out_j, _ = PK._flash_fwd(*jx, True, 0.25, 16, 16, interpret=True)
        out, _ = K.flash_fwd(*tx, True, 0.25)
        assert out.dtype == torch.bfloat16
        # one bf16 rounding of O on each side, summed in another order
        np.testing.assert_allclose(_np(out), np.asarray(out_j, np.float32),
                                   rtol=2e-2, atol=2e-2)


class TestFitFlashBlock:
    @pytest.mark.parametrize("t", [8, 24, 30, 48, 64, 100, 128, 136, 256,
                                   384, 640, 1024, 1280, 2048])
    @pytest.mark.parametrize("requested", [32, 128, 512])
    def test_matches_jax(self, t, requested):
        assert K.fit_flash_block(t, requested) == \
            PK.fit_flash_block(t, requested)


class TestLaunchCounters:
    def test_cpu_calls_do_not_count(self):
        K.reset_launch_counts()
        x = torch.ones(5)
        K.fused_scale(x, 2.0)
        q = torch.ones(1, 8, 1, 64)
        K.flash_fwd(q, q, q, True, 0.125)
        assert K.launch_counts() == {name: 0 for name in K.WRAPPERS}
