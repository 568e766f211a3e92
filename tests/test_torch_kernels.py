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

    @pytest.mark.parametrize("shape", [(300,), (3, 77), (1,)])
    def test_float64_through_f32(self, shape):
        """float64, which the card's kernel does not take, goes through
        fp32 in both packages (JAX's needs its x64 mode to keep float64 at
        all): the same fp32 product, widened back, so equal bits, in place
        too."""
        x = np.random.RandomState(4).randn(*shape)
        with jax.enable_x64(True):
            want = np.asarray(PK.fused_scale(jnp.asarray(x), 0.3,
                                             interpret=True))
        assert want.dtype == np.float64
        got = K.fused_scale(torch.from_numpy(x), 0.3)
        assert got.dtype == torch.float64 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)
        xt = torch.from_numpy(x.copy())
        assert K.fused_scale(xt, 0.3, out=xt) is xt
        np.testing.assert_array_equal(xt.numpy(), want)

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
        """The backward as the autograd glue runs it: dQ with ``out=``,
        which also returns delta = rowsum(dO∘O) (on a card the dQ kernel
        computes it), then dK/dV from that delta, against ``_flash_bwd``,
        which computes delta in its own jnp pass.  delta itself is
        ``flash_delta``'s, bit for bit."""
        got, want, delta, plain_delta = self._backward(causal, bq, bk,
                                                       fold=True)
        assert torch.equal(delta, plain_delta)
        for got, ref, name in zip(got, want, ("dq", "dk", "dv")):
            np.testing.assert_allclose(_np(got), np.asarray(ref),
                                       rtol=1e-4, atol=1e-4, err_msg=name)

    @pytest.mark.parametrize("causal,bq,bk", [
        (False, 8, 8), (True, 8, 8), (True, 16, 8), (True, 8, 16)])
    def test_backward_from_given_delta(self, causal, bq, bk):
        """dQ from a delta the caller passes (the sp ring's later steps),
        which it returns as it was given, at the same cases."""
        got, want, delta, plain_delta = self._backward(causal, bq, bk,
                                                       fold=False)
        assert delta is plain_delta
        for got, ref, name in zip(got, want, ("dq", "dk", "dv")):
            np.testing.assert_allclose(_np(got), np.asarray(ref),
                                       rtol=1e-4, atol=1e-4, err_msg=name)

    @staticmethod
    def _backward(causal, bq, bk, fold):
        """((dq, dk, dv), ``_flash_bwd``'s, the delta dQ returned,
        ``flash_delta``'s)."""
        q, k, v, g = _qkv(20, (2, 32, 2, 8), n=4)
        scale = 8 ** -0.5
        jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
        out_j, lse_j = PK._flash_fwd(jq, jk, jv, causal, scale, bq, bk,
                                     interpret=True)
        want = PK._flash_bwd(jq, jk, jv, out_j, lse_j, jg, causal, scale,
                             bq, bk, interpret=True)
        tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
        out = torch.from_numpy(np.array(out_j))
        lse = torch.from_numpy(np.asarray(lse_j)[:, 0, :].copy())
        plain_delta = K.flash_delta(out, tg)
        if fold:
            dq, delta = K.flash_bwd_dq(tq, tk, tv, tg, lse, None, causal,
                                       scale, out=out)
        else:
            dq, delta = K.flash_bwd_dq(tq, tk, tv, tg, lse, plain_delta,
                                       causal, scale)
        dk, dv = K.flash_bwd_dkv(tq, tk, tv, tg, lse, delta, causal, scale)
        return (dq, dk, dv), want, delta, plain_delta

    def test_backward_takes_delta_or_out(self):
        q = torch.zeros(1, 8, 1, 8)
        rows = torch.zeros(1, 8)
        for delta, out in ((None, None), (rows, q)):
            with pytest.raises(ValueError, match="delta"):
                K.flash_bwd_dq(q, q, q, q, rows, delta, True, 0.5, out=out)

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


class TestOffKernelRoute:
    """What a card computes for attention inputs the flash kernels do not
    take (fp32 here; a head_dim outside 64/128 alike): the dispatch reads
    :func:`flash_kernels_take` and takes reference attention or the plain
    ring.  The rule is made to refuse on the CPU, so that the route runs
    here, and its output and q/k/v gradients are held against the JAX
    ``flash_attention`` in interpret mode at the JAX tests' fp32
    tolerances (2e-5 output, 1e-4 gradients: one-pass softmax against the
    Pallas kernels' blocked online softmax)."""

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("entry", ["flash_attention", "ring_attention"])
    def test_matches_jax_flash(self, monkeypatch, entry, causal):
        from horovod_tpu_torch.parallel import ring_attention as TR

        calls = []

        def refuse(*xs):
            calls.append(xs[0].dtype)
            return False

        monkeypatch.setattr(K, "flash_kernels_take", refuse)
        monkeypatch.setattr(TR, "flash_kernels_take", refuse)
        monkeypatch.setattr(TR.FC, "ring_flash_attention", None)
        q, k, v, g = _qkv(60, (2, 32, 2, 16), n=4)

        def loss_j(q, k, v):
            out = PK.flash_attention(q, k, v, causal=causal, block_q=16,
                                     block_k=16, interpret=True)
            return jnp.sum(out * jnp.asarray(g)), out

        (_, out_j), grads_j = jax.value_and_grad(
            loss_j, argnums=(0, 1, 2), has_aux=True)(
                *map(jnp.asarray, (q, k, v)))
        fn = K.flash_attention if entry == "flash_attention" else \
            TR.ring_attention
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = fn(*ts, causal=causal, block_q=16, block_k=16)
        assert calls == [torch.float32]
        np.testing.assert_allclose(_np(out), np.asarray(out_j), rtol=2e-5,
                                   atol=2e-5)
        (out * torch.from_numpy(g)).sum().backward()
        for t, want, name in zip(ts, grads_j, "qkv"):
            np.testing.assert_allclose(_np(t.grad), np.asarray(want),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"d{name}")


class TestFitFlashBlock:
    @pytest.mark.parametrize("t", [8, 24, 30, 48, 64, 100, 128, 136, 256,
                                   384, 640, 1024, 1280, 2048])
    @pytest.mark.parametrize("requested", [32, 128, 512])
    def test_matches_jax(self, t, requested):
        assert K.fit_flash_block(t, requested) == \
            PK.fit_flash_block(t, requested)


def _cbr_setup(n=4, h=6, w=6, cin=128, c=128, seed=0):
    """The JAX tests' inputs (tests/test_pallas_kernels.py:172-183)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(n, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, c) * 0.05).astype(np.float32)
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = (rng.randn(c) * 0.1).astype(np.float32)
    mean = (rng.randn(c) * 0.1).astype(np.float32)
    var = (rng.rand(c) + 0.5).astype(np.float32)
    cot = rng.randn(n, h, w, c).astype(np.float32)
    return a, k, gamma, beta, mean, var, cot


def _cbr_bwd_inputs(setup, jdtype):
    """(db, b, a, w, gamma, beta, scale_eff) as jnp arrays, with b the
    JAX segment's own forward output in ``jdtype``."""
    a, k, gamma, beta, mean, var, cot = setup
    aj = jnp.asarray(a).astype(jdtype)
    b = PK.fused_conv_bn_relu(aj, jnp.asarray(k), jnp.asarray(gamma),
                              jnp.asarray(beta), jnp.asarray(mean),
                              jnp.asarray(var), interpret=True)
    s = jnp.asarray(gamma) / jnp.sqrt(jnp.asarray(var) + 1e-5)
    return (jnp.asarray(cot).astype(jdtype), b, aj, jnp.asarray(k),
            jnp.asarray(gamma), jnp.asarray(beta), s)


def _to_torch(args, dtype):
    """The same inputs as torch tensors: activations in ``dtype``."""
    db, b, a, *rest = (torch.from_numpy(np.array(x, np.float32))
                       for x in args)
    return (db.to(dtype), b.to(dtype), a.to(dtype), *rest)


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


CBR_NAMES = ("da", "dw", "dgamma", "dbeta")


class TestFusedConvBnReluBwd:
    """The port's kernel 5 on the CPU (its plain version) against the
    Pallas kernel in interpret mode and against ``_cbr_bwd_reference``."""

    @pytest.mark.parametrize("shape", [dict(), dict(n=3, h=10, w=10)],
                             ids=["n4h6w6", "n3h10w10"])
    def test_f32_matches_pallas_and_reference(self, shape):
        """fp32: the JAX tests' 2e-4 (tests/test_pallas_kernels.py:218,238)
        against both; fp32 convs in another summation order."""
        args = _cbr_bwd_inputs(_cbr_setup(**shape), jnp.float32)
        pallas = PK.fused_conv_bn_relu_bwd(*args, interpret=True)
        ref = PK._cbr_bwd_reference(*args)
        got = K.fused_conv_bn_relu_bwd(*_to_torch(args, torch.float32))
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
        for want in (pallas, ref):
            for name, g, w in zip(CBR_NAMES, got, want):
                assert tuple(g.shape) == w.shape, name
                np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-4,
                                           atol=2e-4, err_msg=name)

    @pytest.mark.parametrize("shape", [dict(), dict(n=3, h=10, w=10)],
                             ids=["n4h6w6", "n3h10w10"])
    def test_bf16_against_both_jax_functions(self, shape):
        """bf16 activations.  The port rounds W to bf16 for da (as the
        reference does, and the forward conv) and keeps dW in fp32 from
        the bf16 products (as the Pallas kernel does).  Read normwise, the
        port sits within 1e-2 of each (one bf16 step is 2^-8 relative; the
        measured readings are ~2e-3 for the output that rounds
        differently and ~1e-6 or 0 for the one that agrees), and within
        1e-5 of the one that rounds like it: dW and the channel sums of
        the Pallas kernel, da of the reference to one bf16 step."""
        args = _cbr_bwd_inputs(_cbr_setup(**shape), jnp.bfloat16)
        pallas = PK.fused_conv_bn_relu_bwd(*args, interpret=True)
        ref = PK._cbr_bwd_reference(*args)
        got = K.fused_conv_bn_relu_bwd(*_to_torch(args, torch.bfloat16))
        assert got[0].dtype == torch.bfloat16
        assert got[1].dtype == torch.float32
        for want in (pallas, ref):
            for name, g, w in zip(CBR_NAMES, got, want):
                assert _normwise(_np(g), w) <= 1e-2, name
        for name in ("dw", "dgamma", "dbeta"):
            i = CBR_NAMES.index(name)
            assert _normwise(_np(got[i]), pallas[i]) <= 1e-5, name
        np.testing.assert_allclose(_np(got[0]),
                                   np.asarray(ref[0], np.float32),
                                   rtol=2 ** -7, atol=2 ** -7 * float(
                                       np.abs(np.asarray(ref[0],
                                                         np.float32)).max()))

    @pytest.mark.parametrize("shape", [dict(), dict(n=3, h=10, w=10)],
                             ids=["n4h6w6", "n3h10w10"])
    def test_f16_matches_pallas(self, shape):
        """fp16 activations, which the card's kernel does not take, compute
        the plain version there as here: dW and the channel sums in fp32
        from the fp16 operands, as the Pallas kernel, normwise within
        1e-5 of it (measured ~2e-7, a summation order); da rounded once to
        fp16, within one fp16 step of the Pallas kernel's (2^-10 relative,
        plus 2^-10 of the largest entry for sums that cancel), since the
        port rounds W to fp16 for da and the Pallas kernel keeps it fp32."""
        args = _cbr_bwd_inputs(_cbr_setup(**shape), jnp.float16)
        pallas = PK.fused_conv_bn_relu_bwd(*args, interpret=True)
        got = K.fused_conv_bn_relu_bwd(*_to_torch(args, torch.float16))
        assert got[0].dtype == torch.float16
        assert all(g.dtype == torch.float32 for g in got[1:])
        for name, g, w in zip(CBR_NAMES, got, pallas):
            assert tuple(g.shape) == w.shape, name
        for name in ("dw", "dgamma", "dbeta"):
            i = CBR_NAMES.index(name)
            assert _normwise(_np(got[i]), pallas[i]) <= 1e-5, name
        want = np.asarray(pallas[0], np.float32)
        np.testing.assert_allclose(_np(got[0]), want, rtol=2 ** -10,
                                   atol=2 ** -10 * float(np.abs(want).max()))

    def test_channel_64_takes_the_unfused_path(self):
        """Outside the rule (c % 128) the JAX wrapper computes its
        reference, and so does the port (``cbr_bwd_unfused``), on any
        device.  fp32 at the JAX tests' 2e-4."""
        setup = _cbr_setup(cin=64, c=64)
        args = _cbr_bwd_inputs(setup, jnp.float32)
        tt = _to_torch(args, torch.float32)
        assert not K.cbr_fusable(*tt[:4])
        want = PK.fused_conv_bn_relu_bwd(*args, interpret=True)
        got = K.fused_conv_bn_relu_bwd(*tt)
        for name, g, w in zip(CBR_NAMES, got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-4,
                                       atol=2e-4, err_msg=name)

    def test_channel_64_bf16_rounds_like_the_reference(self):
        """In bf16 the unfused path rounds da and dW to bf16 as the
        reference's conv vjp does: each within one bf16 step (2^-7
        relative, plus 2^-7 of the largest entry for sums that cancel) of
        ``_cbr_bwd_reference``; the fp32 channel sums to 1e-5."""
        args = _cbr_bwd_inputs(_cbr_setup(cin=64, c=64), jnp.bfloat16)
        want = PK._cbr_bwd_reference(*args)
        got = K.fused_conv_bn_relu_bwd(*_to_torch(args, torch.bfloat16))
        assert got[0].dtype == torch.bfloat16
        assert got[1].dtype == torch.float32
        for name, g, w in zip(CBR_NAMES, got, want):
            w = np.asarray(w, np.float32)
            tol = 2 ** -7 if name in ("da", "dw") else 1e-5
            np.testing.assert_allclose(_np(g), w, rtol=tol,
                                       atol=tol * float(np.abs(w).max()),
                                       err_msg=name)
        # dW is bf16-valued on this path (the kernel's path keeps fp32)
        dw = _np(got[1])
        np.testing.assert_array_equal(
            dw, torch.from_numpy(dw).to(torch.bfloat16).float().numpy())

    @pytest.mark.parametrize("beta0", [0.25, -0.25])
    def test_gamma_zero_channel_pins_dgamma(self, beta0):
        """gamma = 0 makes the channel's output relu(beta), from which the
        normalised activation cannot be rebuilt: dgamma is pinned to 0
        (not NaN) in both packages, while dbeta is the active lanes' sum
        (beta > 0) or 0 (beta < 0)."""
        setup = list(_cbr_setup())
        setup[2] = setup[2].copy()
        setup[3] = setup[3].copy()
        setup[2][5], setup[3][5] = 0.0, beta0
        args = _cbr_bwd_inputs(setup, jnp.float32)
        want = PK.fused_conv_bn_relu_bwd(*args, interpret=True)
        got = K.fused_conv_bn_relu_bwd(*_to_torch(args, torch.float32))
        assert float(got[2][5]) == 0.0 == float(want[2][5])
        expect = setup[6][..., 5].sum() if beta0 > 0 else 0.0
        np.testing.assert_allclose(float(got[3][5]), expect, rtol=1e-5,
                                   atol=1e-4)
        for name, g, w in zip(CBR_NAMES, got, want):
            assert np.isfinite(_np(g)).all(), name
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-4,
                                       atol=2e-4, err_msg=name)

    @pytest.mark.parametrize("shape,fusable", [
        ((4, 6, 6, 128, 128), True), ((4, 6, 6, 64, 128), False),
        ((4, 6, 6, 128, 64), False), ((2, 7, 7, 512, 512), False),
        ((2, 14, 14, 256, 256), True), ((2, 14, 14, 256, 384), False),
        ((2, 14, 14, 128, 384), True), ((2, 7, 7, 256, 512), False)])
    def test_dispatch_rule_matches_jax(self, shape, fusable):
        """cbr_fusable is the JAX rule by shape (pallas_kernels.py:610-613):
        dW 9·cin·c·4 bytes ≤ 2.4 MB, channels multiples of 128."""
        n, h, w, cin, c = shape
        a = torch.empty(n, h, w, cin)
        d = torch.empty(n, h, w, c)
        assert K.cbr_fusable(d, d, a, torch.empty(3, 3, cin, c)) is fusable
        assert K.cbr_fusable(d, d, a, torch.empty(1, 1, cin, c)) is False
        assert K.cbr_fusable(d[:, :-1], d, a,
                             torch.empty(3, 3, cin, c)) is False


class TestFusedConvBnReluAutograd:
    """``fused_conv_bn_relu`` through torch.autograd against jax.grad of
    the JAX function (interpret mode), fp32 at the JAX tests' 2e-4."""

    def test_grads_match_jax(self):
        a, k, gamma, beta, mean, var, cot = _cbr_setup()

        def loss_j(*xs):
            out = PK.fused_conv_bn_relu(*xs, interpret=True)
            return (out.astype(jnp.float32) * jnp.asarray(cot)).sum()

        ins = (a, k, gamma, beta, mean, var)
        out_j = PK.fused_conv_bn_relu(*map(jnp.asarray, ins), interpret=True)
        grads_j = jax.grad(loss_j, argnums=tuple(range(6)))(
            *map(jnp.asarray, ins))
        ts = [torch.from_numpy(x.copy()).requires_grad_() for x in ins]
        out = K.fused_conv_bn_relu(*ts)
        np.testing.assert_allclose(_np(out), np.asarray(out_j), rtol=2e-5,
                                   atol=2e-5)
        (out * torch.from_numpy(cot)).sum().backward()
        for t, want, name in zip(ts, grads_j, ("da", "dw", "dgamma", "dbeta",
                                               "dmean", "dvar")):
            np.testing.assert_allclose(_np(t.grad), np.asarray(want),
                                       rtol=2e-4, atol=2e-4, err_msg=name)
        assert not ts[4].grad.any() and not ts[5].grad.any()

    def test_output_is_nhwc_in_the_input_dtype(self):
        a, k, gamma, beta, mean, var, _ = _cbr_setup(n=2)
        out = K.fused_conv_bn_relu(torch.from_numpy(a).to(torch.bfloat16),
                                   *map(torch.from_numpy,
                                        (k, gamma, beta, mean, var)))
        assert out.dtype == torch.bfloat16 and tuple(out.shape) == a.shape
        assert out.is_contiguous()


class TestLaunchCounters:
    def test_cpu_calls_do_not_count(self):
        K.reset_launch_counts()
        x = torch.ones(5)
        K.fused_scale(x, 2.0)
        q = torch.ones(1, 8, 1, 64)
        K.flash_fwd(q, q, q, True, 0.125)
        a = torch.ones(1, 4, 4, 128)
        v = torch.ones(128)
        K.fused_conv_bn_relu_bwd(a, a, a, torch.ones(3, 3, 128, 128), v, v, v)
        K.pallas_matmul(torch.ones(8, 128), torch.ones(128, 128))
        assert K.launch_counts() == {name: 0 for name in K.WRAPPERS}


class TestPallasMatmul:
    """pallas_matmul's plain version against the Pallas kernel in
    interpret mode, at TestPallasMatmul's shapes and tolerances
    (tests/test_pallas_kernels.py)."""

    def test_tile_contract_shapes(self):
        x, w = _rand(0, 16, 128), _rand(1, 128, 256)
        want = PK.pallas_matmul(jnp.asarray(x), jnp.asarray(w),
                                interpret=True)
        got = K.pallas_matmul(torch.from_numpy(x), torch.from_numpy(w))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)

    def test_off_contract_falls_back(self):
        x, w = _rand(2, 7, 33), _rand(3, 33, 19)
        assert not K.mm_fits(7, 33, 19)
        want = PK.pallas_matmul(jnp.asarray(x), jnp.asarray(w),
                                interpret=True)
        got = K.pallas_matmul(torch.from_numpy(x), torch.from_numpy(w))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("out_dtype", [None, torch.float32])
    def test_bf16_accumulates_fp32(self, out_dtype):
        """bf16 operands, fp32 sums, one rounding to the output dtype: the
        JAX test's 0.05 against the fp32 product, and within one bf16 step
        (2^-8 relative) of the Pallas kernel, whose fp32 sums run in
        another order."""
        x, w = _rand(4, 8, 128), _rand(5, 128, 128)
        xj, wj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w))
        want = PK.pallas_matmul(xj, wj, out_dtype=_jnp_dtype(out_dtype)
                                if out_dtype else None, interpret=True)
        got = K.pallas_matmul(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(w).bfloat16(), out_dtype)
        assert got.dtype == (out_dtype or torch.bfloat16)
        ref = np.asarray(xj, np.float32) @ np.asarray(wj, np.float32)
        np.testing.assert_allclose(_np(got), ref, rtol=0.05, atol=0.05)
        tol = 1e-5 if out_dtype else 2 ** -8
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol * np.abs(ref).max())

    @pytest.mark.parametrize("mkn", [(8, 128, 128), (16, 128, 256),
                                     (24, 384, 640), (7, 128, 128),
                                     (8, 120, 128), (8, 128, 100),
                                     (1024, 256, 512), (0, 128, 128),
                                     (520, 1280, 384), (4, 128, 128)])
    def test_dispatch_rule_matches_jax(self, mkn):
        """The rule by shape alone, as pallas_kernels.py derives it from
        _fit_mm_block."""
        m, k, n = mkn
        want = (PK._fit_mm_block(m, (512, 256, 128, 64, 32, 16, 8))
                is not None and PK._fit_mm_block(n, (512, 256, 128))
                is not None and k % 128 == 0)
        assert K.mm_fits(m, k, n) == want

    @pytest.mark.parametrize("mkn", [(16, 128, 256), (7, 33, 19)])
    @pytest.mark.parametrize("transposed_w", [False, True])
    def test_autograd_matches_jax_grad(self, mkn, transposed_w):
        """dX and dW through the autograd glue against jax.grad of the JAX
        function; with ``transposed_w`` the kernel operand is the
        transposed view of an (n, k) weight, whose gradient comes back
        row-major in the weight's own layout."""
        m, k, n = mkn
        x, w, g = _rand(6, m, k), _rand(7, k, n), _rand(8, m, n)

        def loss(x, w):
            return jnp.sum(PK.pallas_matmul(x, w) * jnp.asarray(g))

        dx_j, dw_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                    jnp.asarray(w))
        xt = torch.from_numpy(x).requires_grad_()
        if transposed_w:
            weight = torch.from_numpy(w.T.copy()).requires_grad_()
            wt = weight.t()
        else:
            weight = wt = torch.from_numpy(w).requires_grad_()
        (K.pallas_matmul(xt, wt) * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(_np(xt.grad), np.asarray(dx_j),
                                   rtol=1e-5, atol=1e-5)
        dw = weight.grad.t() if transposed_w else weight.grad
        assert weight.grad.is_contiguous()
        np.testing.assert_allclose(_np(dw), np.asarray(dw_j), rtol=1e-5,
                                   atol=1e-5)

    def test_bf16_gradients_keep_operand_dtypes(self):
        """A bf16 product of an fp32 parameter cast to bf16: dX is bf16,
        and the parameter's gradient arrives in fp32 through the cast, as
        autograd of a cfg.dtype product gives them."""
        x = torch.from_numpy(_rand(9, 8, 128)).bfloat16().requires_grad_()
        weight = torch.from_numpy(_rand(10, 256, 128)).requires_grad_()
        y = K.pallas_matmul(x, weight.bfloat16().t())
        assert y.dtype == torch.bfloat16
        y.float().sum().backward()
        assert x.grad.dtype == torch.bfloat16
        assert weight.grad.dtype == torch.float32
        want = torch.ones(256, 8) @ x.detach().float()
        np.testing.assert_allclose(_np(weight.grad), _np(want), rtol=1e-2,
                                   atol=1e-2)

    def test_shape_validation(self):
        with pytest.raises(ValueError, match="pallas_matmul"):
            K.pallas_matmul(torch.ones(8, 128), torch.ones(64, 128))
        with pytest.raises(ValueError, match="pallas_matmul"):
            K.pallas_matmul(torch.ones(2, 8, 128), torch.ones(128, 128))

    @pytest.mark.parametrize("mode,want", [("on", True), ("off", False),
                                           ("auto", False)])
    def test_resolve_modes(self, mode, want):
        """"auto" is off in the port (the rings lost to the unfused
        collectives on H100s), as the JAX package's auto is off without a
        TPU."""
        from horovod_tpu_torch.ops import fused_collectives as FC

        assert FC.resolve_fused_collectives(mode) is want
        assert PK.resolve_fused_collectives(mode) is want

    def test_resolve_rejects_unknown(self, monkeypatch):
        from horovod_tpu_torch.ops import fused_collectives as FC

        with pytest.raises(ValueError, match="fused_collectives"):
            FC.resolve_fused_collectives("maybe")
        monkeypatch.setenv("HOROVOD_FUSED_COLLECTIVES", "maybe")
        with pytest.raises(ValueError, match="fused_collectives"):
            FC.resolve_fused_collectives()
