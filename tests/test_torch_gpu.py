"""Each CUDA kernel of horovod_tpu_torch against its plain PyTorch version,
on the card.  Marked ``gpu``; without CUDA every test skips.  Run on a GPU
machine with::

    python -m pytest -m gpu tests/test_torch_gpu.py

With two or more cards, ``TestNcclWorld`` also runs the exchange and the
training step over NCCL, one process per card, and with four
``fused_tp_apply`` at tp = 4, the sp ring at sp = 4 and the sharded
exchange, the eager plane and the hook-fired exchange at a world of 4
(run those alone on four cards: ``-k "test_tp_over_nccl or
test_sp_over_nccl or test_zero_over_nccl or test_eager_over_nccl or
test_overlap_over_nccl or test_moe_over_nccl"``); ``test_hvdrun_over_nccl``
starts its world of 4 through ``python -m horovod_tpu_torch.runner -np
4``; ``test_moe_over_nccl``
also runs the MoE LM over an ep group of four and a sharded checkpoint
saved at world 4 and restored at 2.  ``test_sync_bn_over_nccl`` starts
its world the torchrun way (a process group made before ``hvd.init()``)
and holds SyncBatchNorm against BatchNorm on the concatenated batch.
``test_adasum_over_nccl`` lays its worlds out as nodes (4 x 1, 2 x 2 and
3 x 1, ``spawn_world(layout=...)``) and ``test_sparse_over_nccl`` runs
the row-sparse exchange at a world of 4; run them alone on four cards:
``-k "test_adasum_over_nccl or test_sparse_over_nccl"``.
``test_hierarchy_over_nccl`` runs the two-level exchange on four cards
laid out 2 x 2, the 870.9M LM among it: ``-s -k
test_hierarchy_over_nccl`` alone on four cards.
Imports torch, numpy, the port and ``chip_smoke``'s inputs and tolerances
only.
"""

import json
import math
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu_torch.ops import kernels as K

from torch_port_workers import ADASUM_LM_STEPS, EAGER_CASES, \
    EAGER_CHECKS, EXCHANGE_CASES, OVERLAP_CASES, OVERLAP_THRESHOLDS, \
    SPARSE_ROWS, assert_adam_close, check_eager_reduction, check_exchange, \
    check_overlap, exchange_inputs, hier_leaves, join_step_inputs, \
    sparse_inputs, spawn_world, zero_inputs


#: fused_scale.cu's batch: U = 4 16-byte vectors for each of a block's 256
#: threads
SCALE_BATCH_VECTORS = 4 * 256
SCALE_DTYPES = [(a, b) for a in (torch.float32, torch.bfloat16, torch.float16)
                for b in (torch.float32, torch.bfloat16, torch.float16)]
#: (dtype pair, bytes past a 16-byte boundary) that a view can have
SCALE_SHIFTS = [(d, shift) for d in SCALE_DTYPES for shift in (2, 8)
                if shift % torch.empty((), dtype=d[0]).element_size() == 0]
#: kernel 5's 128-row tiles and 64-row steps: batch 1 with an image of one
#: step, tiles that cross several small images, cin != c both ways
CBR_EDGES = [(1, 8, 8, 128, 128), (2, 3, 5, 256, 128), (4, 3, 3, 128, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu "
                    "tests/test_torch_gpu.py` on the GPU machine")
    return torch.device("cuda")


@pytest.mark.gpu
class TestOnCard:
    @pytest.mark.parametrize("n", [1, 7, 1000, 1 << 20, (1 << 20) + 3])
    @pytest.mark.parametrize("dtypes", [
        (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
        (torch.float32, torch.float16), (torch.bfloat16, torch.float32),
        (torch.float16, torch.float16)])
    def test_fused_scale(self, cuda, n, dtypes):
        src, dst = dtypes
        x = torch.randn(n, device=cuda).to(src)
        before = K.fused_scale.launches
        got = K.fused_scale(x, 0.37, dst)
        assert K.fused_scale.launches == before + 1
        want = K.fused_scale_plain(x, 0.37, dst)
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    @pytest.mark.parametrize("n", [7, 1000, (1 << 20) + 3])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
    def test_fused_scale_in_place(self, cuda, n, dtype):
        """The exchange scales each bucket in place (out=x)."""
        x = torch.randn(n, device=cuda).to(dtype)
        want = K.fused_scale_plain(x, 0.37, dtype)
        got = K.fused_scale(x, 0.37, out=x)
        assert got.data_ptr() == x.data_ptr()
        torch.testing.assert_close(x, want, rtol=0, atol=0)

    def test_fused_scale_misaligned(self, cuda):
        """Views 4 bytes past a 16-byte boundary go through aligned
        copies; in place the result still lands in the view."""
        base = torch.randn(1001, device=cuda)
        want = K.fused_scale_plain(base[1:], 0.37, torch.float32)
        torch.testing.assert_close(K.fused_scale(base[1:], 0.37), want,
                                   rtol=0, atol=0)
        view = base[1:]
        K.fused_scale(view, 0.37, out=view)
        torch.testing.assert_close(view, want, rtol=0, atol=0)

    @pytest.mark.parametrize("dtypes", SCALE_DTYPES,
                             ids=lambda d: f"{str(d[0])[6:]}-{str(d[1])[6:]}")
    def test_fused_scale_lengths(self, cuda, dtypes):
        """Every dtype pair at the lengths where the kernel's paths meet,
        out of place and (same dtype) in place, bit-exact: 0, 1 and 3
        values, a batch of U 16-byte vectors for each thread of one and of
        two blocks and one vector and one value either side, and 64 MiB +
        4 bytes."""
        src, dst = dtypes
        vec = 16 // torch.empty((), dtype=src).element_size()
        batch = vec * SCALE_BATCH_VECTORS
        lengths = [0, 1, 3, batch - vec, batch - 1, batch, batch + 1,
                   batch + vec, 2 * batch - 1, 2 * batch + 1,
                   (64 * 2 ** 20 + 4) // torch.empty(
                       (), dtype=src).element_size()]
        gen = torch.Generator(device=cuda).manual_seed(12)
        for n in lengths:
            x = torch.randn(n, generator=gen, device=cuda).to(src)
            want = K.fused_scale_plain(x, 0.37, dst)
            torch.testing.assert_close(K.fused_scale(x, 0.37, dst), want,
                                       rtol=0, atol=0)
            if src == dst:
                K.fused_scale(x, 0.37, out=x)
                torch.testing.assert_close(x, want, rtol=0, atol=0)

    @pytest.mark.parametrize("dtypes,shift", SCALE_SHIFTS,
                             ids=lambda v: v if isinstance(v, int) else
                             f"{str(v[0])[6:]}-{str(v[1])[6:]}")
    def test_fused_scale_misaligned_views(self, cuda, dtypes, shift):
        """An input view 2 or 8 bytes past a 16-byte boundary (2 only for
        a 2-byte input) and an output view as far off as its dtype allows,
        out of place and, with one dtype, in place: bit-exact with the
        plain version."""
        src, dst = dtypes
        size = torch.empty((), dtype=src).element_size()
        n, off = 5003, shift // size
        base = torch.randn(n + off, device=cuda).to(src)
        x = base[off:]
        assert x.data_ptr() % 16 == shift
        want = K.fused_scale_plain(x, 0.37, dst)
        torch.testing.assert_close(K.fused_scale(x, 0.37, dst), want,
                                   rtol=0, atol=0)
        out_base = torch.empty(n + shift // torch.empty(
            (), dtype=dst).element_size(), dtype=dst, device=cuda)
        out = out_base[out_base.numel() - n:]
        K.fused_scale(x, 0.37, dst, out=out)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
        if src == dst:
            K.fused_scale(x, 0.37, out=x)
            torch.testing.assert_close(x, want, rtol=0, atol=0)

    def test_fused_scale_float64_takes_the_plain_path(self, cuda):
        """float64 on the card: the plain version (through fp32), in place
        too, and no launch; the low-level launcher still refuses it."""
        x = torch.randn(1000, device=cuda, dtype=torch.float64)
        want = K.fused_scale_plain(x, 0.37, torch.float64)
        before = K.fused_scale.launches
        torch.testing.assert_close(K.fused_scale(x, 0.37), want, rtol=0,
                                   atol=0)
        assert K.fused_scale(x, 0.37, out=x) is x
        torch.testing.assert_close(x, want, rtol=0, atol=0)
        assert K.fused_scale.launches == before
        with pytest.raises(TypeError, match="fused_scale"):
            K._launch_fused_scale(x, 0.37, torch.float64, None)

    @pytest.mark.parametrize("shape,causal", [
        ((2, 128, 2, 64), True), ((2, 128, 2, 128), False),
        ((1, 200, 3, 128), True), ((1, 24, 2, 64), True),
        ((6, 1024, 16, 128), True), *chip_smoke.FLASH_EDGES,
        *chip_smoke.BWD_EDGES])
    def test_flash(self, cuda, shape, causal):
        """Forward, dQ (computing delta from O) and dK/dV against their
        plain versions, one launch each.  bf16 outputs: one rounding (up to
        one ulp, 2^-7 relative), fp32 sums in another order, and bf16 P and
        dS that may round one ulp apart; each output is held normwise
        (1e-2) and elementwise to 2e-2 of its own size plus 1e-1 of its
        rms, so small entries are not judged against the largest one; lse
        (fp32, log domain) to 1e-3 absolute; delta within 2e-5 of each
        row's sum of magnitudes.  As chip_smoke.py's flash check."""
        gen = torch.Generator(device=cuda).manual_seed(0)
        q, k, v, do = (torch.randn(shape, generator=gen, device=cuda)
                       .to(torch.bfloat16) for _ in range(4))
        before = K.launch_counts()
        results = chip_smoke.flash_outputs(torch, q, k, v, do, causal,
                                           shape[-1] ** -0.5)
        after = K.launch_counts()
        assert {n: after[n] - before[n] for n in after
                if after[n] != before[n]} == \
            dict.fromkeys(chip_smoke.FLASH_KERNELS, 1)
        for name, outputs in results.items():
            for label, got, want in outputs:
                for key, val, lim in chip_smoke.flash_readings(
                        torch, label, got, want):
                    assert val <= lim, (name, label, key, val, lim)

    @pytest.mark.parametrize("shape", [(6, 1024, 16, 128), (2, 200, 3, 64),
                                       (1, 24, 2, 128),
                                       *[s for s, _ in chip_smoke.BWD_EDGES
                                         if s[1] % 2 == 0]],
                             ids=lambda s: "x".join(map(str, s)))
    @pytest.mark.parametrize("pair", "abcd")
    def test_flash_positions(self, cuda, shape, pair):
        """The global-positions variant against its plain version for the
        sp ring's position pairs (chip_smoke.pos_pairs), the backward from
        the plain forward's O and lse; pair (d), every row masked, must
        give O = 0, lse = the sentinel and zero gradients exactly."""
        gen = torch.Generator(device=cuda).manual_seed(1)
        q, k, v, do = (torch.randn(shape, generator=gen, device=cuda)
                       .to(torch.bfloat16) for _ in range(4))
        qpos, kpos = chip_smoke.pos_pairs(torch, shape[1])[pair]
        before = K.launch_counts()
        results = chip_smoke.flash_outputs(torch, q, k, v, do, True,
                                           shape[-1] ** -0.5, qpos, kpos)
        after = K.launch_counts()
        assert {n: after[n] - before[n] for n in after if after[n] != before[n]} \
            == dict.fromkeys(chip_smoke.SP_KERNELS, 1)
        sentinel = float(torch.tensor(K.NEG_INF, dtype=torch.float32))
        for name, outputs in results.items():
            for label, got, want in outputs:
                if label != "delta":
                    assert got.dtype == want.dtype
                    assert got.shape == want.shape
                if pair == "d" and label != "delta":
                    exact = sentinel if label == "lse" else 0.0
                    assert bool((got.float() == exact).all()), (name, label)
                    continue
                for key, val, lim in chip_smoke.flash_readings(
                        torch, label, got, want):
                    assert val <= lim, (name, label, key, val, lim)

    def test_flash_positions_never_plain(self, cuda, monkeypatch):
        """A CUDA tensor with positions launches the variant and never its
        plain version."""
        def boom(*a, **k):
            raise AssertionError("a plain version ran for a CUDA tensor")

        for name in ("flash_fwd_plain", "flash_bwd_dq_plain",
                     "flash_bwd_dkv_plain"):
            monkeypatch.setattr(K, name, boom)
        q = torch.randn(1, 128, 2, 64, device=cuda).to(torch.bfloat16)
        pos = torch.arange(128, device=cuda)
        o, lse = K.flash_fwd(q, q, q, True, 0.125, pos, pos)
        _, delta = K.flash_bwd_dq(q, q, q, q, lse, None, True, 0.125, pos,
                                  pos, out=o)
        K.flash_bwd_dkv(q, q, q, q, lse, delta, True, 0.125, pos, pos)
        torch.cuda.synchronize()
        with pytest.raises(ValueError, match="positions"):
            K.flash_fwd(q, q, q, True, 0.125, pos.cpu(), pos.cpu())

    def test_sp1_ring_equals_flash(self, cuda):
        """The sp ring on a group of one, causal, bf16: output and gradients
        equal flash_attention's bit for bit (the positions variant at
        arange adds exact zeros; one partial merges into the sentinel
        exactly), through the positions kernels only."""
        from horovod_tpu_torch.parallel.ring_attention import ring_attention

        gen = torch.Generator(device=cuda).manual_seed(2)
        q, k, v, g = (torch.randn(2, 512, 4, 128, generator=gen, device=cuda)
                      .to(torch.bfloat16) for _ in range(4))
        results = []
        for fn in (lambda a, b, c: ring_attention(a, b, c, causal=True),
                   lambda a, b, c: K.flash_attention(a, b, c, causal=True)):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            K.reset_launch_counts()
            out = fn(*leaves)
            out.backward(g)
            results.append(([out.detach()] + [x.grad for x in leaves],
                            {n: c for n, c in K.launch_counts().items() if c}))
        (ring, ring_counts), (flash, flash_counts) = results
        assert ring_counts == dict.fromkeys(chip_smoke.SP_KERNELS, 1)
        assert flash_counts == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                "flash_bwd_dkv": 1}
        for a, b in zip(ring, flash):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("knob", ["HOROVOD_FUSED_COLLECTIVES",
                                      "HOROVOD_SP_FUSED_RING"])
    def test_sp_ring_ignores_off_knobs(self, cuda, monkeypatch, knob):
        """The tensor-parallel rings' knob, and the JAX package's sp one,
        set to off leave a fitting CUDA shard on the positions kernels."""
        from horovod_tpu_torch.parallel.ring_attention import ring_attention

        monkeypatch.setenv(knob, "off")
        q = torch.randn(1, 256, 2, 128, device=cuda).to(torch.bfloat16)
        q.requires_grad_()
        K.reset_launch_counts()
        ring_attention(q, q, q, causal=True).backward(torch.ones_like(q))
        assert {n: c for n, c in K.launch_counts().items() if c} == \
            dict.fromkeys(chip_smoke.SP_KERNELS, 1)

    def test_flash_rejects_other_head_dims(self, cuda):
        q = torch.zeros(1, 64, 1, 96, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            K.flash_fwd(q, q, q, True, 0.1)

    @pytest.mark.parametrize("shape", [
        (128, 28, 28, 128, 128), (128, 14, 14, 256, 256),
        (3, 10, 10, 128, 128), (2, 7, 9, 256, 128), (1, 5, 3, 128, 256),
        *CBR_EDGES])
    def test_conv_bn_relu_bwd(self, cuda, shape):
        """The kernel against its plain version at the ResNet-50 segments'
        shapes (batch 128), ragged ones and the tile's edges, as
        chip_smoke.py holds it."""
        args = chip_smoke.cbr_inputs(torch, shape, seed=3)
        before = K.fused_conv_bn_relu_bwd.launches
        got = K.fused_conv_bn_relu_bwd(*args)
        assert K.fused_conv_bn_relu_bwd.launches == before + 1
        want = K.fused_conv_bn_relu_bwd_plain(*args)
        torch.cuda.synchronize()
        assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
        for name, g, w in zip(("da", "dW", "dgamma", "dbeta"), got, want):
            assert g.shape == w.shape, name
            for key, val, lim in chip_smoke.cbr_agreement(torch, name, g, w):
                assert val <= lim, (name, key, val, lim)

    @pytest.mark.parametrize("shape", [(128, 14, 14, 256, 256),
                                       (2, 7, 9, 256, 128)])
    def test_conv_bn_relu_bwd_deterministic(self, cuda, shape):
        """Two calls on the same inputs give the same bits: every sum runs
        in a fixed order, with no atomics."""
        args = chip_smoke.cbr_inputs(torch, shape, seed=4)
        first = K.fused_conv_bn_relu_bwd(*args)
        second = K.fused_conv_bn_relu_bwd(*args)
        for name, g1, g2 in zip(("da", "dW", "dgamma", "dbeta"), first,
                                second):
            assert torch.equal(g1, g2), name

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
    def test_conv_bn_relu_bwd_off_kernel_dtype(self, cuda, monkeypatch,
                                              dtype):
        """A fusable segment in fp32 or fp16 on the card computes the plain
        version (no launch) and gives exactly its outputs.  TF32 is off
        for the fp32 convolutions, so they run in full fp32, and cuDNN
        picks deterministic algorithms, so the two calls agree bit for
        bit."""
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
        args = chip_smoke.cbr_inputs(torch, (2, 7, 9, 128, 128), seed=5)
        args = tuple(x.to(dtype) if i < 3 else x for i, x in enumerate(args))
        before = K.fused_conv_bn_relu_bwd.launches
        got = K.fused_conv_bn_relu_bwd(*args)
        assert K.fused_conv_bn_relu_bwd.launches == before
        want = K.fused_conv_bn_relu_bwd_plain(*args)
        assert got[0].dtype == dtype and got[1].dtype == torch.float32
        for name, g, w in zip(("da", "dW", "dgamma", "dbeta"), got, want):
            assert torch.equal(g, w), name

    def test_conv_bn_relu_bwd_launcher_rejects_fp32(self, cuda):
        """The low-level launcher still refuses fp32 activations."""
        a = torch.zeros(1, 4, 4, 128, device=cuda)
        w = torch.zeros(3, 3, 128, 128, device=cuda)
        v = torch.ones(128, device=cuda)
        with pytest.raises(TypeError, match="bfloat16"):
            K._launch_cbr_bwd(a, a, a, w, v, v, v)

    @pytest.mark.parametrize("mkn", [*chip_smoke.MM_MAIN.values(),
                                     *chip_smoke.MM_RAGGED],
                             ids=lambda mkn: "x".join(map(str, mkn)))
    @pytest.mark.parametrize("layout", chip_smoke.MM_LAYOUTS)
    @pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
    def test_matmul(self, cuda, mkn, layout, out_dtype):
        """The kernel against its plain version in the three layouts of a
        linear layer (forward, dX, dW), as chip_smoke.py holds it."""
        x, w = chip_smoke.mm_operands(torch, mkn, layout, seed=5)
        before = K.pallas_matmul.launches
        got = K.pallas_matmul(x, w, out_dtype)
        fits = K.mm_fits(x.shape[0], x.shape[1], w.shape[1])
        assert K.pallas_matmul.launches == before + int(fits)
        want = K.pallas_matmul_plain(x, w, out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == want.shape
        for key, val, lim in chip_smoke.mm_agreement(torch, got, want):
            assert val <= lim, (key, val, lim)

    @pytest.mark.parametrize("a_t", [0, 1])
    @pytest.mark.parametrize("b_t", [0, 1])
    def test_matmul_library_ragged_k_and_n(self, cuda, a_t, b_t):
        """hvd_matmul called through the library at a K and an N that the
        dispatch rule never sends, (m, k, n) = (136, 136, 24): the tensor
        maps' zero fill past K (136 = 2 x 64 + 8) and past N (24 < one
        64-column box) must add nothing.  fp32 output, as the matmul check
        holds it."""
        from horovod_tpu_torch.ops.build import load_library

        m, k, n = 136, 136, 24
        gen = torch.Generator(device=cuda).manual_seed(7)
        x = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
        w = torch.randn(k, n, generator=gen, device=cuda).bfloat16()
        a = x.t().contiguous() if a_t else x
        b = w.t().contiguous() if b_t else w
        got = torch.full((m, n), float("nan"), device=cuda)
        rc = load_library().hvd_matmul(
            a.data_ptr(), b.data_ptr(), got.data_ptr(), m, n, k, a_t, b_t, 1,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert rc == 0
        want = K.pallas_matmul_plain(x, w, torch.float32)
        for key, val, lim in chip_smoke.mm_agreement(torch, got, want):
            assert val <= lim, (key, val, lim)

    @pytest.mark.parametrize("layout", chip_smoke.MM_LAYOUTS)
    def test_matmul_operand_16_bytes_into_storage(self, cuda, layout):
        """An operand whose data starts 16 bytes (not 128) into its
        storage: the tensor map's base needs 16-byte alignment only."""
        x, w = chip_smoke.mm_operands(torch, (256, 384, 512), layout, seed=8)
        store = torch.empty(x.numel() + 8, dtype=x.dtype, device=cuda)
        shifted = store[8:].view(x.t().shape if layout == "dw" else x.shape)
        shifted.copy_(x.t() if layout == "dw" else x)
        x16 = shifted.t() if layout == "dw" else shifted
        assert x16.data_ptr() % 128 == (store.data_ptr() + 16) % 128 != 0
        before = K.pallas_matmul.launches
        got = K.pallas_matmul(x16, w, torch.float32)
        assert K.pallas_matmul.launches == before + 1
        want = K.pallas_matmul_plain(x, w, torch.float32)
        torch.cuda.synchronize()
        for key, val, lim in chip_smoke.mm_agreement(torch, got, want):
            assert val <= lim, (key, val, lim)

    @pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv", "pallas_matmul"])
    def test_tma_kernels_launch_from_a_fresh_thread(self, cuda, kernel):
        """The TMA kernels encode their tensor maps on the calling thread,
        which needs the CUDA context current there; a thread that has made
        no CUDA runtime call yet (as an autograd worker may be) has none."""
        import threading

        gen = torch.Generator(device=cuda).manual_seed(9)
        if kernel.startswith("flash"):
            q, k, v, do = (torch.randn((1, 256, 2, 128), generator=gen,
                                       device=cuda).bfloat16()
                           for _ in range(4))
            scale = 128 ** -0.5
            o, lse = K.flash_fwd_plain(q, k, v, True, scale)
            delta = K.flash_delta(o, do)
            args = (q, k, v, do, lse, delta, True, scale)
            run, want = {
                "flash_fwd": (lambda: K.flash_fwd(q, k, v, True, scale)[0], o),
                "flash_bwd_dq": (lambda: K.flash_bwd_dq(*args)[0],
                                 K.flash_bwd_dq_plain(*args)),
                "flash_bwd_dkv": (lambda: K.flash_bwd_dkv(*args)[0],
                                  K.flash_bwd_dkv_plain(*args)[0])}[kernel]
        else:
            x = torch.randn(256, 512, generator=gen, device=cuda).bfloat16()
            w = torch.randn(512, 384, generator=gen, device=cuda).bfloat16()

            def run():
                return K.pallas_matmul(x, w)

            want = K.pallas_matmul_plain(x, w, torch.bfloat16)
        out = {}

        def worker():
            try:
                out["got"] = run()
                torch.cuda.synchronize()
            except Exception as e:  # reported below, on the test's thread
                out["error"] = e

        thread = threading.Thread(target=worker)
        thread.start()
        thread.join()
        assert "error" not in out, out.get("error")
        readings = chip_smoke.flash_agreement(torch, out["got"], want, False) \
            if kernel.startswith("flash") else \
            chip_smoke.mm_agreement(torch, out["got"], want)
        for key, val, lim in readings:
            assert val <= lim, (key, val, lim)

    def test_matmul_rejects_fp32(self, cuda):
        """The kernel takes bf16 only, so fp32 operands on the card take
        the plain product (fp32, as torch.matmul at full fp32 precision):
        no launch, and exactly the plain version's result."""
        gen = torch.Generator(device=cuda).manual_seed(10)
        x = torch.randn(8, 128, generator=gen, device=cuda)
        w = torch.randn(128, 128, generator=gen, device=cuda)
        before = K.pallas_matmul.launches
        got = K.pallas_matmul(x, w)
        assert K.pallas_matmul.launches == before
        assert torch.equal(got, K.pallas_matmul_plain(x, w, torch.float32))

    @pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                         (torch.bfloat16, 96)])
    @pytest.mark.parametrize("entry", ["flash_attention", "ring_attention"])
    def test_attention_off_kernel_inputs(self, cuda, dtype, d, entry):
        """fp32, or a head_dim the kernels lack, through both attention
        entries on the card: the plain path, no launch, and the output and
        gradients of reference attention (the plain ring at sp = 1 is the
        same fp32 softmax: normwise 1e-5 for fp32; one bf16 rounding of
        each output, 1e-2, for bf16)."""
        from horovod_tpu_torch.parallel.ring_attention import (
            reference_attention,
            ring_attention,
        )

        gen = torch.Generator(device=cuda).manual_seed(11)
        q, k, v, g = (torch.randn(2, 128, 2, d, generator=gen, device=cuda)
                      .to(dtype) for _ in range(4))
        fn = K.flash_attention if entry == "flash_attention" else \
            ring_attention
        results = []
        for f in (fn, reference_attention):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            K.reset_launch_counts()
            out = f(*leaves, causal=True)
            out.backward(g)
            assert not any(K.launch_counts().values())
            results.append([out.detach()] + [x.grad for x in leaves])
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        for got, want in zip(*results):
            rel = (got.float() - want.float()).norm() / want.float().norm()
            assert float(rel) <= tol

    def test_matmul_autograd(self, cuda):
        """dX and dW of a bf16 x @ weightᵀ through the kernel against
        autograd of F.linear on the same bf16 operands: one bf16 rounding
        of fp32 sums taken in another order, normwise 5e-3."""
        gen = torch.Generator(device=cuda).manual_seed(6)
        x = torch.randn(256, 384, device=cuda, generator=gen).bfloat16()
        weight = torch.randn(512, 384, device=cuda, generator=gen) / 20
        dy = torch.randn(256, 512, device=cuda, generator=gen).bfloat16()
        grads = []
        for use_kernel in (True, False):
            xg = x.clone().requires_grad_()
            wg = weight.clone().requires_grad_()
            before = K.pallas_matmul.launches
            y = K.pallas_matmul(xg, wg.bfloat16().t()) if use_kernel else \
                torch.nn.functional.linear(xg, wg.bfloat16())
            y.backward(dy)
            assert K.pallas_matmul.launches - before == (3 if use_kernel
                                                          else 0)
            assert wg.grad.is_contiguous()
            grads.append((y.detach(), xg.grad, wg.grad))
        for got, want in zip(*grads):
            rel = (got.float() - want.float()).norm() / want.float().norm()
            assert float(rel) <= 5e-3

    def test_moe_step_on_card(self, cuda):
        """The MoE LM in bf16 with flash attention (head_dim 64) through
        the hook path on a world of one: each flash kernel once a layer a
        step, fused_scale twice a bucket, every bucket from its hook, the
        loss finite and falling."""
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models.moe import MoEConfig, MoETransformerLM

        from torch_port_workers import moe_lm_loss

        hvd.init()
        try:
            cfg = MoEConfig(vocab_size=256, num_layers=4, num_heads=2,
                            d_model=128, d_ff=512, max_seq_len=128,
                            dtype=torch.bfloat16, attention_impl="flash",
                            num_experts=8)
            model = MoETransformerLM(cfg, device=cuda,
                                     generator=torch.Generator(
                                         device=cuda).manual_seed(0))
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(model.parameters(), lr=1e-3),
                gradient_predivide_factor=2.0)
            step = hvd.DistributedTrainStep(moe_lm_loss, opt)
            model, opt = step.init(model)
            batch = step.shard_batch(torch.randint(
                0, 256, (8, 129), generator=torch.Generator().manual_seed(0)))
            K.reset_launch_counts()
            losses = []
            for _ in range(3):
                model, opt, loss = step(model, opt, batch)
                losses.append(float(loss))
                assert [src for _, src in opt.launches] == \
                    ["hook"] * len(opt._buckets)
            counts = K.launch_counts()
            assert all(counts[k] == 4 * 3 for k in chip_smoke.FLASH_KERNELS)
            assert counts["fused_scale"] == 2 * len(opt._buckets) * 3
            assert np.isfinite(losses).all() and losses[-1] < losses[0]
        finally:
            hvd.shutdown()

    def test_moe_routing_on_card_equals_cpu(self, cuda):
        """The fp32 router on the card (TF32 off whatever the process
        sets) routes every token as the CPU does, except a token whose two
        best scores lie within 1e-5 of each other."""
        from horovod_tpu_torch.parallel import expert as E

        gen = torch.Generator().manual_seed(3)
        x = torch.randn(4096, 1024, generator=gen).bfloat16()
        gate = torch.randn(1024, 8, generator=gen) * 0.02
        keep = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            scores = E.router_scores(x.to(cuda), gate.to(cuda)).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = keep
        want = E.router_scores(x, gate)
        top2 = want.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-5
        got_idx = E.top1_routing(scores, 640)[0]
        want_idx = E.top1_routing(want, 640)[0]
        assert torch.equal(got_idx[clear], want_idx[clear])
        assert float((scores - want).abs().max()) <= 1e-4

    def test_expert_chunk_mlp_on_card(self, cuda):
        """expert_chunk_mlp through kernel 6 (two launches an expert)
        against the batched-einsum expert body, under kernel 6's bf16
        limits (chip_smoke.MM_BF16_TOL)."""
        from horovod_tpu_torch.models.moe import _expert_mlp
        from horovod_tpu_torch.ops.fused_collectives import expert_chunk_mlp

        gen = torch.Generator(device=cuda).manual_seed(7)
        chunk = torch.randn(4, 640, 256, device=cuda,
                            generator=gen).bfloat16()
        w1 = (torch.randn(4, 256, 1024, device=cuda, generator=gen)
              / 32).bfloat16()
        w2 = (torch.randn(4, 1024, 256, device=cuda, generator=gen)
              / 64).bfloat16()
        before = K.pallas_matmul.launches
        got = expert_chunk_mlp(chunk, w1, w2)
        assert K.pallas_matmul.launches - before == 8
        readings = chip_smoke.mm_agreement(torch, got,
                                           _expert_mlp(chunk, w1, w2))
        assert all(val <= lim for _, val, lim in readings), readings

    def test_codec_on_card_equals_cpu(self, cuda):
        """The int8 and fp8 codec, with and without segments, with error
        feedback, on the card (an NCCL world of one) bit for bit equal to
        the CPU (gloo); bitwise_and/or, which sum bits over NCCL's SUM,
        equal too."""
        card = spawn_world("run_codec", world=1, device="cuda",
                           timeout=300)[0]
        cpu = spawn_world("run_codec", world=1, device="cpu")[0]
        assert card.keys() == cpu.keys()
        for key, want in cpu.items():
            got = card[key]
            for g, w in zip(*((got, want) if isinstance(want, tuple)
                              else ((got,), (want,)))):
                np.testing.assert_array_equal(g, w, err_msg=str(key))

    def test_eager_on_card_takes_nccl_and_fused_scale(self, cuda):
        """An eager allreduce of a CUDA tensor runs NCCL and its two
        fused_scale passes and touches no host gather; a CPU tensor takes
        the host plane; HOROVOD_TPU_OPERATIONS=HOST sends a CUDA tensor
        through the host.  Values are exact at a world of one (scales 0.5
        and 2.0); poll on an in-flight handle returns without waiting, and
        True after synchronize."""
        out = spawn_world("run_eager_card", world=1, device="cuda",
                          timeout=300)[0]
        print(out)
        card, cpu, host = out["card"], out["cpu"], out["card_host"]
        assert card == {"plane": "XLA", "host": [], "nccl": ["cuda"],
                        "fused_scale": 2, "exact": True, "device": "cuda"}
        assert cpu["plane"] == "HOST" and cpu["nccl"] == [] and \
            cpu["host"] == ["cpu"] and cpu["exact"]
        assert host["plane"] == "HOST" and host["nccl"] == [] and \
            host["fused_scale"] == 0 and host["exact"] and \
            host["device"] == "cuda"
        assert isinstance(out["poll_in_flight"], bool)
        assert out["big_exact"] and out["poll_done"]

    def test_hook_path_on_card_equals_step_time(self, cuda):
        """The hook-fired exchange on the card (side stream, fused_scale,
        NCCL) equals distributed_gradients on the same gradients bit for
        bit, in every overlap case, on the MLP and the small transformer
        (bf16 compute); join_step on one rank with data is the identity."""
        out = spawn_world("run_overlap", world=1, device="cuda",
                          timeout=300)[0]
        for name in OVERLAP_THRESHOLDS:
            for case in OVERLAP_CASES:
                check_overlap(out[(name, case)], name, case)
        for k, v in join_step_inputs(0).items():
            np.testing.assert_array_equal(out["join_step"][k], v)

    def test_overlap_timing_on_card(self, cuda):
        """chip_smoke.py's one-card paths at full width (the 870.9M model
        through flash and through fused_tp_apply, ResNet-50 with
        fused_bwd), each timed with the hook-fired exchange and with the
        step-time one (distributed_gradients after backward) in turns,
        hooks first: the median step ms of 8 steps after two, four turns a
        mode, printed with the card's name and power limit.  Every
        reading is a finite positive time; their order is measured, not
        asserted."""
        import json
        import subprocess

        out = spawn_world("run_overlap_bench", world=1, device="cuda",
                          args=(8, 8), timeout=900)[0]
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
        print(json.dumps(out))
        for path in ("transformer", "tp", "resnet"):
            for mode in ("hooks", "step_time"):
                assert len(out[path][mode]) == 4
                assert all(0 < ms < 1e4 for ms in out[path][mode])

    def test_resnet_fused_matches_unfused(self, cuda):
        """A narrow bf16 ResNet (two stride-1 blocks at 128 filters, on the
        kernel's rule) under the same weights: the fused segment's
        gradients against autograd of the unfused one.  The two differ in
        where bf16 rounds inside the segment (dy, da), so loss within 1e-2
        relative and all gradients within 5e-2 relative L2, as
        chip_smoke.py's full-width check; mean/var of the fused segment are
        0 by design and left out."""
        from horovod_tpu_torch.models.resnet import (
            ResNet,
            resnet_loss,
            unfused_state_dict,
        )

        gen = torch.Generator(device=cuda).manual_seed(0)
        batch = {"x": torch.rand(8, 64, 64, 3, generator=gen, device=cuda),
                 "y": torch.randint(0, 10, (8,), generator=gen, device=cuda)}
        models = {fused: ResNet([2, 1], num_classes=10, num_filters=128,
                                dtype=torch.bfloat16, space_to_depth=True,
                                fused_bwd=fused, device=cuda,
                                generator=torch.Generator(
                                    device=cuda).manual_seed(1))
                  for fused in (True, False)}
        models[False].load_state_dict(unfused_state_dict(
            models[True].state_dict()))
        losses, grads = {}, {}
        for fused, model in models.items():
            before = K.fused_conv_bn_relu_bwd.launches
            loss = resnet_loss(model, batch)
            loss.backward()
            assert K.fused_conv_bn_relu_bwd.launches - before == \
                (2 if fused else 0)
            losses[fused] = float(loss.detach())
            named = {n: p.grad.float() for n, p in model.named_parameters()}
            grads[fused] = unfused_state_dict(named) if fused else named
        zero_by_design = set(unfused_state_dict({
            n: None for n, _ in models[True].named_parameters()
            if n.endswith(("FusedConvBnRelu3x3_0.mean",
                           "FusedConvBnRelu3x3_0.var"))}))
        assert len(zero_by_design) == 4
        for n in zero_by_design:
            assert not grads[True][n].any()
        assert abs(losses[True] - losses[False]) <= 1e-2 * abs(losses[False])
        names = [n for n in grads[False] if n not in zero_by_design]
        assert set(names) | zero_by_design == set(grads[True])
        diff = sum(float((grads[True][n] - grads[False][n]).pow(2).sum())
                   for n in names)
        ref = sum(float(grads[False][n].pow(2).sum()) for n in names)
        assert math.sqrt(diff / ref) <= 5e-2

    def test_prefetch_pinned_side_stream(self, cuda):
        """A PrefetchIterator on one card: the delivered tensors equal the
        host batches, on the runtime's card, copied from pinned staging
        buffers on a stream other than the consumer's, each carrying its
        copy's event."""
        out = spawn_world("run_prefetch_card", world=1, device="cuda")[0]
        assert out["batches"] == 5 and out["equal"]
        assert out["devices"] == {out["device"]} == {"cuda:0"}
        assert out["copy"] != out["consumer"]
        assert out["pinned"] and out["events"]

    def test_sync_bn_equals_batchnorm(self, cuda):
        """SyncBatchNorm at a world of one against BatchNorm(train=True),
        bf16 channels-last: the forward bit for bit, the gradients within
        chip_smoke.SYNC_BN_TOL normwise; one all-reduce each way."""
        out = spawn_world("run_sync_bn_parity_card", world=1,
                          device="cuda")[0]
        print(json.dumps(out))
        assert {"y", "mean", "var"} <= set(out["exact"])
        assert max(out["rel"].values()) <= chip_smoke.SYNC_BN_TOL
        assert (out["allreduce_fwd"], out["allreduce_bwd"]) == (1, 1)


@pytest.fixture
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    return 4 if n >= 4 else 2


@pytest.mark.gpu
class TestNcclWorld:
    def test_exchange(self, cards):
        """grouped_allreduce (scale passes on the card), allgather,
        broadcast and the broadcasts over NCCL, against the numpy oracle
        the gloo tests use."""
        outs = spawn_world("run_exchange", world=cards, device="cuda")
        for out in outs:
            for i, case in enumerate(EXCHANGE_CASES):
                check_exchange(out[i], case, world=cards)
            np.testing.assert_array_equal(
                out["allgather"],
                np.concatenate([exchange_inputs(r)[0]
                                for r in range(cards)]))
            np.testing.assert_array_equal(out["broadcast"],
                                          exchange_inputs(1)[1])
            np.testing.assert_array_equal(out["broadcast_variables"][0],
                                          exchange_inputs(0)[0])
            assert out["broadcast_object"] == {"rank": 1}

    def test_train_ranks_stay_identical(self, cards):
        """Different initial draws per rank: init broadcasts rank 0's, and
        after three bf16 flash steps every rank holds the same bits and
        the loss fell."""
        outs = spawn_world("run_train", world=cards, args=(3, 0, True),
                           device="cuda", timeout=300)
        losses0, params0 = outs[0]
        assert losses0[-1] < losses0[0]
        for losses, params in outs[1:]:
            assert losses == losses0
            for k in params0:
                np.testing.assert_array_equal(params[k], params0[k],
                                              err_msg=k)

    def test_tp_over_nccl(self, cards):
        """fused_tp_apply at tp = 4 over NCCL against tp = 1 on the same
        bf16 weights (normwise 1e-2: the two sum the row-parallel partials
        in another order and round them to bf16 at other places), and both
        ring ops fused against unfused on every rank (the same per-tile
        kernel products; the unfused pair sums the partials in bf16 inside
        NCCL, the ring in fp32: normwise 1e-2).  Run alone on four cards."""
        if cards < 4:
            pytest.skip("needs four CUDA cards")
        outs = spawn_world("run_tp_nccl", world=4, device="cuda",
                           timeout=300)

        def rel(got, want):
            return float(np.linalg.norm(got - want) / np.linalg.norm(want))

        for rank, out in enumerate(outs):
            readings = [rel(out["logits_tp"], out["logits_1"])] + \
                [rel(out[True][n], out[False][n]) for n in ("rs", "ag")] + \
                [rel(g, w) for g, w in zip(out[True]["grads"],
                                           out[False]["grads"])]
            print(f"rank {rank}: normwise logits tp=4 vs tp=1, rs, ag, "
                  f"dx, dw, dxs fused vs unfused: {readings}")
            # 4 boundary ops a layer, each one kernel launch per ring hop
            assert out["launches"] == 2 * 4 * 4, rank
            assert all(r <= 1e-2 for r in readings), (rank, readings)

    def test_sp_over_nccl(self, cards):
        """The sp ring at sp = 4 over NCCL, both layouts, causal: each rank's
        output and q/k/v gradients against flash_attention on the whole
        sequence (normwise 1e-2: bf16 partials merged in fp32 against one
        pass), finite, through the positions kernels (contiguous skips 6 of
        16 launches, zigzag none: per rank rank + 1 and 4 forward
        launches); then 3 SGD steps of the ring TransformerLM under
        ``plan="sp=4"`` against the same model trained alone on the whole
        sequence through flash (losses 5e-3 relative, parameter updates
        2e-2 normwise).  Run alone on four cards."""
        if cards < 4:
            pytest.skip("needs four CUDA cards")
        outs = spawn_world("run_sp_nccl", world=4, device="cuda",
                           timeout=600)
        for rank, out in enumerate(outs):
            print(f"rank {rank}: {out}")
            for layout, r in out["attention"].items():
                assert r["finite"], (rank, layout)
                assert all(x <= 1e-2 for x in r["normwise"]), (rank, layout,
                                                               r)
                want = rank + 1 if layout == "contiguous" else 4
                assert r["launches"]["flash_fwd_pos"] == want, (rank, r)
                assert r["launches"]["flash_fwd"] == 0
            for layout, r in out["train"].items():
                rel = [abs(a - b) / abs(b) for a, b in
                       zip(r["losses"], r["ref_losses"])]
                assert max(rel) <= 5e-3, (rank, layout, r)
                assert r["updates_normwise"] <= 2e-2, (rank, layout, r)

    def test_zero_over_nccl(self, cards):
        """The sharded exchange at a world of 4 over NCCL: reducescatter,
        alltoall and the bitwise pair against numpy; the small transformer
        trained sharded against the replicated run (losses 1e-5 relative,
        parameters as assert_adam_close states: the CPU limits), and each
        rank's AdamW state exactly its shard's, a quarter of the
        replicated bytes plus padding.  Run alone on four cards."""
        if cards < 4:
            pytest.skip("needs four CUDA cards")
        outs = spawn_world("run_zero_nccl", world=4, device="cuda",
                           timeout=300)
        inp = zero_inputs(4)
        total = inp["rs"].sum(axis=0)
        for rank, out in enumerate(outs):
            np.testing.assert_array_equal(out["rs"],
                                          total[rank * 3:(rank + 1) * 3])
            np.testing.assert_array_equal(out["a2a"], np.concatenate(
                [inp["a2a"][j][:, rank * 3:(rank + 1) * 3]
                 for j in range(4)], axis=2))
            np.testing.assert_array_equal(
                out["and"], np.bitwise_and.reduce(inp["bits64"], axis=0))
            np.testing.assert_array_equal(
                out["or"], np.bitwise_or.reduce(inp["bits32"], axis=0))
            dense, sharded = out[False], out[True]
            print(f"rank {rank}: losses replicated {dense['losses']}, "
                  f"sharded {sharded['losses']}; state bytes "
                  f"{dense['state_bytes']} -> {sharded['state_bytes']}")
            np.testing.assert_allclose(sharded["losses"], dense["losses"],
                                       rtol=1e-5)
            assert sharded["losses"][-1] < sharded["losses"][0]
            for k, v in sharded["params"].items():
                assert_adam_close(v, dense["params"][k], k)
            padded = sum(out["padded"])
            assert 0 <= padded - out["n_params"] < 4 * len(out["padded"])
            assert dense["state_bytes"] == 2 * 4 * out["n_params"]
            assert sharded["state_bytes"] * 4 == 2 * 4 * padded
        for out in outs[1:]:
            assert out[True]["losses"] == outs[0][True]["losses"]
            for k, v in out[True]["params"].items():
                np.testing.assert_array_equal(v, outs[0][True]["params"][k])

    def test_eager_over_nccl(self, cards):
        """The eager plane over NCCL with CUDA tensors, against the numpy
        oracles of the gloo tests: every reduction on both planes, the
        variable allgather, splits, join with uneven batches (Average over
        the whole world), the join and mismatch errors on every rank."""
        outs = spawn_world("run_eager", world=cards, device="cuda",
                           timeout=300)
        for plane in ("XLA", "HOST"):
            for i in range(len(EAGER_CASES)):
                check_eager_reduction(outs, cards, plane, i)
        for check in EAGER_CHECKS.values():
            check(outs, cards)

    def test_overlap_over_nccl(self, cards):
        """At a world of 4 over NCCL: the hook path equals the step-time
        exchange bit for bit in every overlap case (the small transformer
        in bf16 and the MLP); join_step against numpy (1e-6); and the step
        of a wider LM timed with each exchange, printed.  Run alone on
        four cards."""
        if cards < 4:
            pytest.skip("needs four CUDA cards")
        outs = spawn_world("run_overlap_nccl", world=4, device="cuda",
                           timeout=600)
        ins = [join_step_inputs(r) for r in range(4)]
        for rank, out in enumerate(outs):
            for name in OVERLAP_THRESHOLDS:
                for case in OVERLAP_CASES:
                    check_overlap(out[(name, case)], name, case)
            for k in ins[0]:
                want = sum(ins[r][k] for r in range(4) if r != 1) / 3
                np.testing.assert_allclose(out["join_step"][k], want,
                                           rtol=1e-6, atol=1e-6)
            print(f"rank {rank}: step ms (median of 10, two runs each) "
                  f"{out['timing_ms']}")

    def test_sync_bn_over_nccl(self, cards):
        """A world started the torchrun way (a process group made before
        ``hvd.init()``, torchrun's ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``, no
        ``HOROVOD_*``): each rank on ``cuda:<local_rank>``, and
        SyncBatchNorm over NCCL equal to BatchNorm on the concatenated
        batch (tests/test_torch_sync_bn.py's limits), one all-reduce each
        way, and at a world of 4 over a group of two ranks too."""
        from horovod_tpu_torch.models.resnet import BatchNorm

        from torch_port_workers import SYNC_BN_SHAPE, sync_bn_inputs

        outs = spawn_world("run_sync_bn", world=cards, device="cuda",
                           launch={"local_world_size": cards}, timeout=300)
        inp = sync_bn_inputs(cards)
        b = SYNC_BN_SHAPE[0]

        def concat(lo, hi):
            bn = BatchNorm(inp["scale"].size)
            bn.load_state_dict({k: torch.from_numpy(inp[k].copy()) for k in
                                ("scale", "bias", "mean", "var")})
            x = torch.from_numpy(inp["x"][lo * b:hi * b].copy()) \
                .requires_grad_()
            y = bn(x, train=True)
            (y * torch.from_numpy(inp["g"][lo * b:hi * b])).sum().backward()
            return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                    "dscale": bn.scale.grad.numpy(),
                    "dbias": bn.bias.grad.numpy(),
                    "var": bn.var.detach().numpy()}

        def close(got, want, grad=False):
            atol = 1e-5 * float(np.abs(want).max()) if grad else 1e-6
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)

        want = concat(0, cards)
        for rank, o in enumerate(outs):
            assert o["device"] == f"cuda:{o['local_rank']}" == \
                f"cuda:{rank}"
            assert o["calls"] == (1, 1) and o["calls_running"] == 0
            close(o["var"], want["var"])
        close(np.concatenate([o["y"] for o in outs]), want["y"])
        close(np.concatenate([o["dx"] for o in outs]), want["dx"], True)
        for k in ("dscale", "dbias"):
            close(sum(o[k] for o in outs), want[k], True)
        if cards == 4:
            for lo in (0, 2):
                pair = concat(lo, lo + 2)
                got = [outs[r]["pair"] for r in (lo, lo + 1)]
                close(np.concatenate([o["y"] for o in got]), pair["y"])
                close(np.concatenate([o["dx"] for o in got]), pair["dx"],
                      True)

    def test_moe_over_nccl(self, cards, tmp_path):
        """At a world of 4 over NCCL: the fp32 MoE LM over an ep group of
        four against each rank's local mode on the same two rows (loss and
        the world's summed gradients, 2e-4 normwise, JAX's ep limit), the
        fused ring against the all_to_alls (1e-5); and a dp = 4 ZeRO state
        saved at world 4 and restored at shard_count 2 on ranks 0 and 1,
        equal to the numpy reshard.  Run alone on four cards."""
        if cards < 4:
            pytest.skip("needs four CUDA cards")
        outs = spawn_world("run_moe_nccl", world=4, args=(str(tmp_path),),
                           device="cuda", timeout=300)

        def rel(a, b):
            num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
            return math.sqrt(num / sum(float((b[k] ** 2).sum()) for k in b))

        for out in outs:
            (l_loc, g_loc), (l_ep, g_ep), (l_f, g_f) = (
                out[k] for k in ("local", "ep", "ep_fused"))
            assert abs(l_ep - l_loc) <= 2e-4 * abs(l_loc)
            assert rel(g_ep, g_loc) <= 2e-4
            assert abs(l_f - l_ep) <= 1e-5 * abs(l_ep)
            assert rel(g_f, g_ep) <= 1e-5
        for r in (0, 1):
            for key, padded, shard in outs[r]["groups2"]:
                for n in ("exp_avg", "exp_avg_sq"):
                    full = np.concatenate(
                        [o["saved"]["state"][key][n] for o in outs])
                    full = np.concatenate(
                        [full, np.zeros(max(0, padded - full.size),
                                        full.dtype)])[:padded]
                    np.testing.assert_array_equal(
                        outs[r]["restored"]["state"][key][n],
                        full[r * shard:(r + 1) * shard])

    def test_hvdrun_over_nccl(self, cards, tmp_path):
        """``python -m horovod_tpu_torch.runner -np 4`` on one host: four
        distinct cards, each rank on ``cuda:<local_rank>``; three bf16
        flash steps of run_train's LM with every rank holding the same
        bits and the losses of test_train_ranks_stay_identical's spawned
        world; and a rank that exits 3 while the others wait in
        ``hvd.init()`` makes the launcher return 3 and ends them.  Run
        alone on four cards."""
        import os
        import pickle
        import subprocess
        import sys
        import time
        from pathlib import Path

        if cards < 4:
            pytest.skip("needs four CUDA cards")
        root = Path(__file__).resolve().parents[1]
        env = dict(os.environ,
                   PYTHONPATH=f"{root}{os.pathsep}{root / 'tests'}")

        def hvdrun(fn, out):
            out.mkdir()
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
                 "4", sys.executable, str(root / "tests" /
                                          "torch_port_workers.py"),
                 fn, str(out), "3", "cuda"],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=300)
            return proc, time.monotonic() - t0

        proc, _ = hvdrun("run_launch", tmp_path / "train")
        assert proc.returncode == 0, proc.stderr[-4000:]
        outs = [pickle.loads((tmp_path / "train" / f"rank.{r}.pkl")
                             .read_bytes()) for r in range(4)]
        assert [o["device"] for o in outs] == \
            [f"cuda:{o['local_rank']}" for o in outs] == \
            [f"cuda:{r}" for r in range(4)]
        assert len({o["card"] for o in outs}) == 4
        assert [(o["rank"], o["size"], o["local_size"], o["cross_size"])
                for o in outs] == [(r, 4, 4, 1) for r in range(4)]
        assert all(o["env"]["HOROVOD_CONTROLLER"] == "gloo" for o in outs)
        want = spawn_world("run_train", world=4, args=(3, 0, True),
                           device="cuda", timeout=300)
        for out, (losses, params) in zip(outs, want):
            assert out["losses"] == losses == want[0][0]
            for k in params:
                np.testing.assert_array_equal(out["params"][k], params[k],
                                              err_msg=k)
                np.testing.assert_array_equal(out["params"][k],
                                              outs[0]["params"][k],
                                              err_msg=k)
        assert want[0][0][-1] < want[0][0][0]

        proc, seconds = hvdrun("fail_fast", tmp_path / "fail")
        print(f"fail-fast: launcher rc {proc.returncode} in {seconds:.1f} s")
        assert proc.returncode == 3, proc.stderr[-4000:]
        pid = int((tmp_path / "fail" / "rank.0.pid").read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)

    @pytest.mark.parametrize("layout", [(4, 1), (2, 2), (3, 1)],
                             ids=lambda lay: f"{lay[0]}x{lay[1]}")
    def test_adasum_over_nccl(self, cards, layout):
        """Adasum over the layout on NCCL (recursive doubling across 4 and
        2 nodes, the gathered tree across 3, the average within a node of
        2): the grouped reduction and the seeded fp32 LM trained 3 steps by
        DistributedAdasumOptimizer(AdamW) and by op=Adasum on the hook
        path.  Every rank holds the same bits, and each result matches the
        same world on gloo within the CPU tests' limits (rtol 1e-4 for the
        fp32 reduction, 1e-5 for the losses, ``assert_adam_close`` for the
        parameters; the bf16 tensor within 4 bf16 steps of its largest
        entry).  Run alone on four cards."""
        if cards < 4:
            pytest.skip("needs four CUDA cards")
        world = layout[0] * layout[1]
        card = spawn_world("run_adasum_card", world=world, device="cuda",
                           layout=layout, timeout=300)
        gloo = spawn_world("run_adasum_card", world=world, device="cpu",
                           layout=layout, timeout=300)
        for rank, out in enumerate(card):
            for j, (got, want) in enumerate(zip(out["grouped"],
                                                gloo[rank]["grouped"])):
                if j == 2:
                    err = np.abs(got - want).max()
                    assert err <= 4 * 2.0 ** -8 * np.abs(want).max(), \
                        (rank, err)
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-4,
                                               atol=1e-6)
            for path in ("delta", "hook"):
                got, want = out[path], gloo[rank][path]
                print(f"{layout} rank {rank} {path}: losses card "
                      f"{got['losses']}, gloo {want['losses']}")
                np.testing.assert_allclose(got["losses"], want["losses"],
                                           rtol=1e-5)
                assert got["losses"][-1] < got["losses"][0]
                for k, v in got["params"].items():
                    assert_adam_close(v, want["params"][k], k,
                                      steps=ADASUM_LM_STEPS)
        for out in card[1:]:
            for path in ("delta", "hook"):
                assert out[path]["losses"] == card[0][path]["losses"]
                for k, v in out[path]["params"].items():
                    np.testing.assert_array_equal(
                        v, card[0][path]["params"][k], err_msg=k)
            for a, b in zip(out["grouped"], card[0]["grouped"]):
                np.testing.assert_array_equal(a, b)

    def test_sparse_over_nccl(self, cards):
        """The row-sparse exchange at a world of 4 over NCCL:
        sparse_allreduce equals the dense reduction (its fill slots
        dropped), the optimizer's and the step's sparse_params equal the
        dense exchange, and every rank holds the same bits.  Run alone on
        four cards."""
        if cards < 4:
            pytest.skip("needs four CUDA cards")
        outs = spawn_world("run_sparse", world=4, device="cuda",
                           timeout=240)
        dense = np.zeros((SPARSE_ROWS, 3), np.float64)
        for r in range(4):
            inp = sparse_inputs(r)
            for v, i in zip(inp["values"][:-1], inp["indices"][:-1]):
                dense[i] += v
        for rank, out in enumerate(outs):
            np.testing.assert_allclose(out[("allreduce", "Sum")], dense,
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(out[("allreduce", "Average")],
                                       dense / 4, rtol=1e-5, atol=1e-6)
            for bound in (4, 16):
                for path in ("hook", "step_time"):
                    got = out[("opt", bound, path)]
                    for k, v in out[("opt", None, path)].items():
                        np.testing.assert_allclose(got[k], v, rtol=1e-5,
                                                   atol=1e-6)
            for k, v in out[("step", None)]["params"].items():
                np.testing.assert_allclose(out[("step", 8)]["params"][k], v,
                                           rtol=1e-5, atol=1e-6)
        for out in outs[1:]:
            for key, val in out.items():
                for a, b in zip(_leaves(val), _leaves(outs[0][key])):
                    np.testing.assert_array_equal(a, b, err_msg=str(key))


    def test_hierarchy_over_nccl(self, cards):
        """The two-level exchange on four cards laid out 2 x 2 nodes: (i)
        tree_reducescatter -> tree_allgather of seeded fp32 leaves and a
        bf16 one against the numpy sum of the inputs as sent and the flat
        exchange (fp32 rtol 1e-6, atol 1e-6; bf16 within 4 bf16 steps of
        its largest entry), and against the same world on gloo; (ii) the
        870.9M TransformerLM, 5 steps two_level and flat: losses within
        1e-5 relative, every rank's parameters rank 0's, each rank's AdamW
        state a quarter of the padded buffer, both step times printed
        beside the card's name and power limit; (iii) the small fp32 LM
        with int8, error feedback and reduction="adasum" two_level,
        against the gloo twin (losses 1e-5, parameters as
        assert_adam_close states) and the same bits on every card.  Every
        reading is printed before any is checked.  Run alone on four
        cards."""
        if cards < 4:
            pytest.skip("needs four CUDA cards")
        card = spawn_world("run_hier_nccl", world=4, args=(True,),
                           device="cuda", layout=(2, 2), timeout=900)
        gloo = spawn_world("run_hier_nccl", world=4, device="cpu",
                           layout=(2, 2), timeout=300)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        for rank, out in enumerate(card):
            two, flat = out["full"]["two_level"], out["full"]["flat"]
            ms = {h: 1e3 * sorted(r["times"][1:])[len(r["times"][1:]) // 2]
                  for h, r in out["full"].items()}
            rel = [abs(a - b) / abs(b) for a, b in zip(two["losses"],
                                                       flat["losses"])]
            print(f"rank {rank} 870.9M LM 2x2 [{smi[rank]}]: step "
                  f"two_level {ms['two_level']:.1f} ms, flat "
                  f"{ms['flat']:.1f} ms (median of steps 2-5; all "
                  f"{[round(t * 1e3, 1) for t in two['times']]} / "
                  f"{[round(t * 1e3, 1) for t in flat['times']]}); losses "
                  f"{two['losses']} / {flat['losses']}, rel "
                  f"{[f'{x:.2e}' for x in rel]}; peak "
                  f"{two['peak'] / 2**30:.2f} / {flat['peak'] / 2**30:.2f}"
                  f" GiB; state {two['state_bytes']} B of {two['padded']} "
                  f"values; same as rank 0: {two['same']}, {flat['same']}")
            print(f"rank {rank} int8+EF+adasum LM: card "
                  f"{out['lm']['losses']}, gloo {gloo[rank]['lm']['losses']}")
        inp = hier_leaves(4)
        exact = [inp[k].sum(0) for k in "abc"] + [torch.from_numpy(
            inp["b"]).to(torch.bfloat16).float().numpy().sum(0)]
        for rank, out in enumerate(card):
            assert out["index"] == [0, 2, 1, 3][rank]
            for j, want in enumerate(exact):
                for got in (out["tree"][j], out["flat"][j],
                            gloo[rank]["tree"][j]):
                    if j == 3:
                        err = np.abs(got - want).max()
                        assert err <= 4 * 2.0 ** -8 * np.abs(want).max(), \
                            (rank, err)
                    else:
                        np.testing.assert_allclose(got, want, rtol=1e-6,
                                                   atol=1e-6)
            lm, twin = out["lm"], gloo[rank]["lm"]
            assert lm["mode"] == twin["mode"] == "two_level"
            np.testing.assert_allclose(lm["losses"], twin["losses"],
                                       rtol=1e-5)
            assert lm["losses"][-1] < lm["losses"][0]
            for k, v in lm["params"].items():
                assert_adam_close(v, twin["params"][k], k,
                                  steps=ADASUM_LM_STEPS)
                np.testing.assert_array_equal(
                    v, card[0]["lm"]["params"][k], err_msg=k)
            two, flat = out["full"]["two_level"], out["full"]["flat"]
            assert (two["mode"], flat["mode"]) == ("two_level", "flat")
            assert two["index"] == out["index"]
            np.testing.assert_allclose(two["losses"], flat["losses"],
                                       rtol=1e-5)
            assert two["losses"][-1] < two["losses"][0]
            for r in (two, flat):
                assert r["same"], rank
                assert r["state_bytes"] * 4 == 2 * 4 * r["padded"]
        assert all(out["full"]["two_level"]["losses"] ==
                   card[0]["full"]["two_level"]["losses"] for out in card)

    def test_model_parallel_over_nccl(self, cards):
        """tp and fsdp in the step's plan on four cards: the 870.9M
        TransformerLM at full width (bf16 compute, flash, AdamW which the
        step wraps, 6 sequences a rank of one global batch) under ``dp=4``,
        ``tp=4``, ``dp=2,tp=2``, ``fsdp=4`` and ``fsdp=2,tp=2``, three steps
        each.  Every plan's losses within 1e-2 normwise of ``dp=4``'s; each
        rank's resident parameter bytes at most the replicated bytes over
        the plan's tp·fsdp extent plus the leaves the plan leaves whole;
        each flash kernel 16 launches a step, at h/tp heads under tp;
        ``dp=2,tp=2`` and ``fsdp=2,tp=2`` draw the model from the seed with
        the plan's tp group, and each rank holds tp_shard of the model
        drawn at full width; step times, peak memory, the AdamW state's
        bytes and the launch counts printed beside the card's name and
        power limit before anything is checked.  Run alone on four
        cards."""
        if cards < 4:
            pytest.skip("needs four CUDA cards")
        card = spawn_world("run_mp_nccl", world=4, device="cuda",
                           timeout=900)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        for rank, out in enumerate(card):
            for plan, r in out.items():
                ms = 1e3 * sorted(r["times"][1:])[len(r["times"][1:]) // 2]
                print(f"rank {rank} 870.9M LM {plan} [{smi[rank]}]: mode "
                      f"{r['mode']}, step {ms:.1f} ms (median of steps 2-3; "
                      f"all {[round(t * 1e3, 1) for t in r['times']]}), "
                      f"losses {r['losses']}, peak {r['peak'] / 2**30:.2f} "
                      f"GiB, resident {r['resident']} B of {r['full']} "
                      f"(whole leaves {r['whole']} B), AdamW state "
                      f"{r['state_bytes']} B, launches {r['launches']}, "
                      f"drawn with its tp group and equal to the full "
                      f"draw's shard: {r['seeded']}")
        for rank, out in enumerate(card):
            ref = np.asarray(out["dp=4"]["losses"])
            for plan, r in out.items():
                assert r["mode"] == "pjit", plan
                got = np.asarray(r["losses"])
                assert np.linalg.norm(got - ref) <= 1e-2 * np.linalg.norm(
                    ref), (rank, plan)
                assert r["resident"] <= r["full"] / r["extent"] + \
                    r["whole"], (rank, plan)
                assert r["seeded"] is (True if plan in (
                    "dp=2,tp=2", "fsdp=2,tp=2") else None), (rank, plan)
                flash = {k: r["launches"].get(k, 0) for k in
                         ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
                assert flash == dict.fromkeys(flash, 16 * len(r["losses"])), \
                    (rank, plan, r["launches"])
            assert out["dp=4"]["losses"][-1] < out["dp=4"]["losses"][0]


def _leaves(x) -> list:
    """The arrays and numbers of a nested dict/list result, in order."""
    if isinstance(x, dict):
        return [v for k in sorted(x, key=str) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _leaves(item)]
    return [np.asarray(x)]
