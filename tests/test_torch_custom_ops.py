"""The port's kernels as dispatcher operators (``torch.ops.hvd_torch``).

1. Every launch in ``ops/kernels.py`` is an op of one namespace with a
   fake (meta) implementation, and ``torch.library.opcheck`` passes for
   each on the CPU, where its kernel is the plain version.
2. Each op called directly on the CPU against its JAX function (the
   Pallas kernel in interpret mode, as ``tests/test_torch_kernels.py``
   runs it), with that file's tolerances.
3. The fakes give the kernels' shapes and dtypes to tracing; a real meta
   tensor is refused as any non-CUDA tensor is.
4. What sees the ops now: autograd glue runs exactly the ops it ran as
   kernels, the remat tiers' checkpoint recomputes the flash forward (no
   tier saves it, as JAX's ``dots_saveable`` saves no ``pallas_call``),
   and ``torch.export`` keeps attention as the op.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from horovod_tpu.ops import pallas_kernels as PK
from horovod_tpu_torch.ops import kernels as K

OPS = torch.ops.hvd_torch


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


# -- 1. every kernel an op, each opcheck'ed ---------------------------------

def test_every_launch_is_an_op_with_a_fake():
    """The namespace holds exactly the ops whose CUDA kernels the wrappers
    launch, each with a fake implementation registered."""
    from torch._library.simple_registry import singleton

    names = {n for n in dir(OPS) if isinstance(getattr(OPS, n),
                                               torch._ops.OpOverloadPacket)}
    assert names == set(K.CUDA_KERNELS) == {
        "fused_scale", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
        "cbr_bwd", "pallas_matmul", "pallas_matmul_out"}
    for name in names:
        assert singleton.find(f"hvd_torch::{name}").fake_impl.kernel \
            is not None, name


def _flash_case(seed, shape=(1, 16, 2, 8), pos=False):
    q, k, v, do = (_t(_rand(seed + i, *shape)) for i in range(4))
    t = shape[1]
    qpos = kpos = None
    if pos:
        qpos = torch.arange(t, dtype=torch.int32) + t
        kpos = torch.arange(t, dtype=torch.int32)
    o, lse = OPS.flash_fwd(q, k, v, True, 0.3, qpos, kpos)
    return q, k, v, do, o, lse, qpos, kpos


def _opcheck_cases():
    q, k, v, do, o, lse, _, _ = _flash_case(0)
    pq, pk, pv, pdo, po, plse, qpos, kpos = _flash_case(4, pos=True)
    delta = K.flash_delta(o, do)
    bf = torch.bfloat16
    cbr = [_t(_rand(i, *s)) for i, s in enumerate(
        [(1, 4, 4, 128)] * 3 + [(3, 3, 128, 128)] + [(128,)] * 3)]
    return [
        ("fused_scale", (torch.zeros(5), _t(_rand(0, 5)), 0.5)),
        ("fused_scale", (_t(_rand(1, 5)), None, 2.0)),
        ("fused_scale", (torch.zeros(6, dtype=bf), _t(_rand(2, 6)), 0.25)),
        ("flash_fwd", (q, k, v, True, 0.3)),
        ("flash_fwd", (q, k, v, False, 0.3)),
        ("flash_fwd", (pq, pk, pv, True, 0.3, qpos, kpos)),
        ("flash_bwd_dq", (q, k, v, do, lse, None, True, 0.3, None, None,
                          o)),
        ("flash_bwd_dq", (q, k, v, do, lse, delta, True, 0.3)),
        ("flash_bwd_dq", (pq, pk, pv, pdo, plse, K.flash_delta(po, pdo),
                          True, 0.3, qpos, kpos)),
        ("flash_bwd_dkv", (q, k, v, do, lse, delta, True, 0.3)),
        ("flash_bwd_dkv", (pq, pk, pv, pdo, plse, K.flash_delta(po, pdo),
                           True, 0.3, qpos, kpos)),
        ("cbr_bwd", tuple(cbr)),
        ("pallas_matmul", (_t(_rand(5, 8, 128)), _t(_rand(6, 128, 128)),
                           torch.float32)),
        ("pallas_matmul", (_t(_rand(7, 8, 128), bf), _t(_rand(8, 128, 128),
                                                         bf), bf)),
        ("pallas_matmul_out", (_t(_rand(9, 8, 128)), _t(_rand(10, 128, 256)),
                               torch.zeros(8, 256))),
    ]


@pytest.mark.parametrize("case", range(len(_opcheck_cases())))
def test_opcheck(case):
    """Schema, autograd registration, the fake against the CPU kernel and
    AOT dispatch, for every op at small seeded shapes."""
    name, args = _opcheck_cases()[case]
    result = torch.library.opcheck(getattr(OPS, name), args)
    assert set(result.values()) == {"SUCCESS"}, (name, result)


# -- 2. each op against its JAX function ------------------------------------

class TestOpsAgainstJax:
    """The ops called directly, as a package's AOT executable calls them,
    against ``horovod_tpu/ops/pallas_kernels.py`` in interpret mode."""

    @pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
    def test_fused_scale(self, out_dtype):
        """The same fp32 product, rounded once: equal bits, out of place
        and in place."""
        x = _rand(0, 7, 130)
        jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
        want = np.asarray(PK.fused_scale(jnp.asarray(x), 0.3, out_dtype=jdt,
                                         interpret=True), np.float32)
        out = torch.empty(x.shape, dtype=out_dtype)
        assert OPS.fused_scale(out, torch.from_numpy(x), 0.3) is None
        np.testing.assert_array_equal(_np(out), want)
        if out_dtype == torch.float32:
            inplace = torch.from_numpy(x.copy())
            OPS.fused_scale(inplace, None, 0.3)
            np.testing.assert_array_equal(inplace.numpy(), want)

    @pytest.mark.parametrize("causal", [False, True])
    def test_flash_fwd(self, causal):
        """2e-5 on O and lse (the JAX tests' forward limit)."""
        q, k, v = (_rand(10 + i, 2, 64, 2, 16) for i in range(3))
        scale = 16 ** -0.5
        out_j, lse_j = PK._flash_fwd(*map(jnp.asarray, (q, k, v)), causal,
                                     scale, 16, 16, interpret=True)
        out, lse = OPS.flash_fwd(*map(torch.from_numpy, (q, k, v)), causal,
                                 scale)
        np.testing.assert_allclose(_np(out), np.asarray(out_j), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(_np(lse), np.asarray(lse_j)[:, 0, :],
                                   rtol=2e-5, atol=2e-5)

    def test_flash_fwd_positions(self):
        """The global-positions variant: the query block sits one block
        after the keys' (the sp ring's later hop), 2e-5."""
        q, k, v = (_rand(20 + i, 1, 32, 2, 16) for i in range(3))
        qpos, kpos = np.arange(32, 64, dtype=np.int32), \
            np.arange(32, dtype=np.int32) * 2
        scale = 16 ** -0.5
        out_j, lse_j = PK._flash_fwd(*map(jnp.asarray, (q, k, v)), True,
                                     scale, 16, 16, True,
                                     jnp.asarray(qpos), jnp.asarray(kpos))
        out, lse = OPS.flash_fwd(*map(torch.from_numpy, (q, k, v)), True,
                                 scale, torch.from_numpy(qpos),
                                 torch.from_numpy(kpos))
        np.testing.assert_allclose(_np(out), np.asarray(out_j), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(_np(lse), np.asarray(lse_j)[:, 0, :],
                                   rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("fold", [True, False], ids=["from_o",
                                                         "given_delta"])
    def test_flash_backward(self, causal, fold):
        """dQ (delta from O, or given) then dK/dV against ``_flash_bwd``:
        1e-4 (the JAX tests' gradient limit); a computed delta equals
        ``flash_delta``'s bits, a given one is not returned again."""
        q, k, v, g = (_rand(30 + i, 2, 32, 2, 8) for i in range(4))
        scale = 8 ** -0.5
        jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
        out_j, lse_j = PK._flash_fwd(jq, jk, jv, causal, scale, 8, 8,
                                     interpret=True)
        want = PK._flash_bwd(jq, jk, jv, out_j, lse_j, jg, causal, scale,
                             8, 8, interpret=True)
        tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
        out = torch.from_numpy(np.array(out_j))
        lse = torch.from_numpy(np.asarray(lse_j)[:, 0, :].copy())
        delta = K.flash_delta(out, tg)
        if fold:
            dq, got_delta = OPS.flash_bwd_dq(tq, tk, tv, tg, lse, None,
                                             causal, scale, None, None, out)
            assert torch.equal(got_delta, delta)
        else:
            dq, got_delta = OPS.flash_bwd_dq(tq, tk, tv, tg, lse, delta,
                                             causal, scale)
            assert got_delta.shape == (0,)
        dk, dv = OPS.flash_bwd_dkv(tq, tk, tv, tg, lse, delta, causal,
                                   scale)
        for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
            np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-4,
                                       atol=1e-4, err_msg=name)

    def test_cbr_bwd(self):
        """fp32 against the Pallas kernel, 2e-4 (tests/
        test_pallas_kernels.py's limit)."""
        rng = np.random.RandomState(0)
        a = rng.randn(3, 6, 6, 128).astype(np.float32)
        w = (rng.randn(3, 3, 128, 128) * 0.05).astype(np.float32)
        gamma = (rng.rand(128) + 0.5).astype(np.float32)
        beta, mean = (rng.randn(2, 128) * 0.1).astype(np.float32)
        var = (rng.rand(128) + 0.5).astype(np.float32)
        db = rng.randn(3, 6, 6, 128).astype(np.float32)
        b = PK.fused_conv_bn_relu(*map(jnp.asarray, (a, w, gamma, beta, mean,
                                                     var)), interpret=True)
        s = gamma / np.sqrt(var + 1e-5)
        args = (db, np.asarray(b), a, w, gamma, beta, s)
        want = PK.fused_conv_bn_relu_bwd(*map(jnp.asarray, args),
                                         interpret=True)
        got = OPS.cbr_bwd(*map(_t, args))
        for name, g_, w_ in zip(("da", "dw", "dgamma", "dbeta"), got, want):
            assert tuple(g_.shape) == w_.shape and g_.is_contiguous(), name
            np.testing.assert_allclose(_np(g_), np.asarray(w_), rtol=2e-4,
                                       atol=2e-4, err_msg=name)

    @pytest.mark.parametrize("mkn", [(16, 128, 256), (8, 128, 128)])
    def test_pallas_matmul(self, mkn):
        """fp32 at 1e-5 (TestPallasMatmul's limit), returned and into
        ``out``."""
        m, k, n = mkn
        x, w = _rand(40, m, k), _rand(41, k, n)
        want = np.asarray(PK.pallas_matmul(jnp.asarray(x), jnp.asarray(w),
                                           interpret=True))
        got = OPS.pallas_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                torch.float32)
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
        out = torch.zeros(m, n)
        OPS.pallas_matmul_out(torch.from_numpy(x), torch.from_numpy(w), out)
        assert torch.equal(out, got)

    def test_pallas_matmul_bf16(self):
        """bf16 operands, fp32 sums, one rounding: within one bf16 step of
        the Pallas kernel (TestPallasMatmul's limit)."""
        x, w = _rand(42, 8, 128), _rand(43, 128, 128)
        xj, wj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w))
        want = np.asarray(PK.pallas_matmul(xj, wj, interpret=True),
                          np.float32)
        got = OPS.pallas_matmul(_t(x, torch.bfloat16), _t(w, torch.bfloat16),
                                torch.bfloat16)
        assert got.dtype == torch.bfloat16
        ref = np.asarray(xj, np.float32) @ np.asarray(wj, np.float32)
        np.testing.assert_allclose(_np(got), want, rtol=2 ** -8,
                                   atol=2 ** -8 * np.abs(ref).max())


# -- 3. the fakes ---------------------------------------------------------

def test_fakes_give_the_kernels_shapes():
    """Under a fake mode each op returns the CUDA kernel's shapes and
    dtypes (bf16 (b, t, h, d) flash inputs, an empty delta when one is
    given, dW fp32 HWIO); nothing runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    bf = torch.bfloat16
    with FakeTensorMode():
        q = torch.empty(2, 64, 4, 128, dtype=bf)
        rows = torch.empty(8, 64)
        o, lse = OPS.flash_fwd(q, q, q, True, 0.1)
        assert o.shape == q.shape and o.dtype == bf
        assert lse.shape == (8, 64) and lse.dtype == torch.float32
        dq, delta = OPS.flash_bwd_dq(q, q, q, q, rows, None, True, 0.1,
                                     None, None, q)
        assert dq.shape == q.shape and delta.shape == (8, 64)
        assert OPS.flash_bwd_dq(q, q, q, q, rows, rows, True,
                                0.1)[1].shape == (0,)
        dk, dv = OPS.flash_bwd_dkv(q, q, q, q, rows, rows, True, 0.1)
        assert dk.shape == dv.shape == q.shape
        a = torch.empty(2, 7, 9, 128, dtype=bf)
        vec = torch.empty(256)
        da, dw, dg, dbeta = OPS.cbr_bwd(torch.empty(2, 7, 9, 256, dtype=bf),
                                        torch.empty(2, 7, 9, 256, dtype=bf),
                                        a, torch.empty(3, 3, 128, 256), vec,
                                        vec, vec)
        assert da.shape == a.shape and da.dtype == bf
        assert dw.shape == (3, 3, 128, 256) and dw.dtype == torch.float32
        assert dg.shape == dbeta.shape == (256,)
        y = OPS.pallas_matmul(torch.empty(24, 128, dtype=bf),
                              torch.empty(128, 384, dtype=bf), torch.float32)
        assert y.shape == (24, 384) and y.dtype == torch.float32


def test_a_real_meta_tensor_is_refused():
    """A meta tensor is no card: the op raises as the launcher does for
    any non-CUDA tensor, and never runs a plain version."""
    q = torch.empty(1, 64, 2, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        OPS.flash_fwd(q, q, q, True, 0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.pallas_matmul(torch.empty(8, 128, device="meta",
                                    dtype=torch.bfloat16),
                        torch.empty(128, 128, device="meta",
                                    dtype=torch.bfloat16))


# -- 4. what sees the ops -------------------------------------------------

class _OpLog(TorchDispatchMode):
    """Records every ``hvd_torch`` op that reaches the dispatcher."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "hvd_torch":
            self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_autograd_glue_runs_the_ops():
    """Flash attention forward and backward: one forward, one dQ (delta
    from O), one dK/dV; the fused conv segment's backward: one
    ``cbr_bwd``; a linear layer through ``pallas_matmul``: three
    products.  The same launches the kernels made as bare calls."""
    q, k, v = (_t(_rand(50 + i, 1, 32, 2, 64)).requires_grad_()
               for i in range(3))
    with _OpLog() as log:
        K.flash_attention(q, k, v, causal=True).sum().backward()
    assert log.ops == ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]
    a = _t(_rand(60, 2, 6, 6, 128)).requires_grad_()
    w = _t(_rand(61, 3, 3, 128, 128), torch.float32).mul(0.05) \
        .requires_grad_()
    vecs = [(_t(_rand(62 + i, 128)).abs() + 0.5).requires_grad_()
            for i in range(4)]
    with _OpLog() as log:
        K.fused_conv_bn_relu(a, w, *vecs).sum().backward()
    assert log.ops == ["cbr_bwd"]
    x = _t(_rand(70, 128, 128)).requires_grad_()
    wt = _t(_rand(71, 128, 256)).requires_grad_()
    with _OpLog() as log:
        K.pallas_matmul(x, wt).sum().backward()
    assert log.ops == ["pallas_matmul"] * 3


@pytest.mark.parametrize("tier", ["none", "dots", "full", "offload"])
def test_remat_tiers_recompute_the_flash_forward(monkeypatch, tier):
    """A 2-layer LM step under each tier: the flash forward op runs once a
    layer without remat and twice under every tier that rematerializes
    (phase 18's 32 a step at 16 layers): ``dots`` sees the op and
    recomputes it, as JAX's ``dots_saveable`` saves no ``pallas_call``;
    the backward ops once a layer always."""
    from horovod_tpu_torch.models import transformer as TT

    cfg = TT.TransformerConfig(vocab_size=64, num_layers=2, num_heads=2,
                               d_model=128, d_ff=256, max_seq_len=32,
                               dtype=torch.float32, attention_impl="flash",
                               remat_policy=tier)
    model = TT.TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 64, (2, 33),
                           generator=torch.Generator().manual_seed(1))
    calls = []
    plain = K.flash_fwd_plain
    monkeypatch.setattr(K, "flash_fwd_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    with _OpLog() as log:
        TT.lm_loss(model, tokens).backward()
    fwd = 2 if tier == "none" else 4
    assert log.ops.count("flash_fwd") == len(calls) == fwd
    assert log.ops.count("flash_bwd_dq") == log.ops.count(
        "flash_bwd_dkv") == 2


def test_export_keeps_attention_as_the_op():
    """``torch.export`` of the flash LM's forward holds one
    ``hvd_torch.flash_fwd`` a layer and no ``scaled_dot_product_attention``
    (the AOT executable's attention stays the hand-written kernel)."""
    from horovod_tpu_torch.models import transformer as TT

    cfg = TT.TransformerConfig(vocab_size=64, num_layers=3, num_heads=2,
                               d_model=128, d_ff=256, max_seq_len=32,
                               dtype=torch.float32, attention_impl="flash")
    model = TT.TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ep = torch.export.export(model, (torch.zeros(2, 16,
                                                     dtype=torch.long),))
    text = str(ep.graph)
    assert text.count("hvd_torch.flash_fwd") == 3
    assert "scaled_dot_product" not in text
