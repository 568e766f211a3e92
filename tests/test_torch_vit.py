"""The port's ViT (``horovod_tpu_torch/models/vit.py``) against the JAX
package's ``VisionTransformer`` at ``bench.py``'s CPU size (32 px, patch
16, 2 layers, d 128, 4 heads; ``bench.py:868-870``) on converted weights,
fp32, dense attention on the CPU: the forward, one step of
``DistributedTrainStep`` on a world of one and on a gloo world of 2 under
``dp=2`` and ``tp=2`` (``run_vit`` in ``tests/torch_port_workers.py``),
against JAX's step on as many CPU devices.  Tolerances: logits and the
loss at rtol 1e-5 / atol 1e-5; parameters after the step at atol 1e-5,
as :func:`~torch_port_workers.assert_adam_close` states, and the logits
after it likewise (:func:`_after_close`).
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.models import vit as JV
from horovod_tpu.parallel import plan as JP
from horovod_tpu_torch.models import vit as TV
from horovod_tpu_torch.models.convert import params_from_flax, tp_shard

from torch_port_workers import (
    VIT_CPU,
    VIT_LR,
    assert_adam_close,
    spawn_world,
    vit_batch,
    vit_step,
)

RTOL = ATOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray,
                                  flax.core.meta.unbox(jax.device_get(tree)))


@pytest.fixture(scope="module")
def jax_vit():
    cfg = JV.ViTConfig(dtype=jnp.float32, **VIT_CPU)
    model = JV.VisionTransformer(cfg)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 32, 32, 3), jnp.float32))
    return model, variables


@pytest.fixture(scope="module")
def port_sd(jax_vit):
    return params_from_flax(_np(jax_vit[1]))


@pytest.fixture(scope="module")
def jax_steps(jax_vit):
    """One optax.adamw(3e-4) step of JAX's pjit step (bench.py's ViT
    loss) under each plan on a mesh of as many CPU devices: (loss, logits
    before and after, trained parameters as a port state_dict)."""
    model, variables = jax_vit
    old = os.environ.get("HOROVOD_COMPILE_CACHE")
    os.environ["HOROVOD_COMPILE_CACHE"] = "0"
    jhvd.init()
    try:
        batch = {k: jnp.asarray(v) for k, v in vit_batch().items()}
        batch["y"] = batch["y"].astype(jnp.int32)

        def loss_fn(params, b):
            logits = model.apply(params, b["x"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, b["y"]).mean()

        out = {}
        for plan, world in (("dp=1", 1), ("dp=2", 2), ("tp=2", 2)):
            mesh = JP.ShardingPlan.from_string(plan).resolve(world) \
                .build_mesh(devices=jax.devices("cpu")[:world])
            step = jhvd.DistributedTrainStep(loss_fn, optax.adamw(VIT_LR),
                                             mesh=mesh, plan=plan,
                                             mode="pjit", donate=False)
            with mesh:
                params, opt_state = step.init(variables)
                before = np.asarray(model.apply(params, batch["x"]))
                params, opt_state, loss = step(params, opt_state,
                                               step.shard_batch(batch))
                after = np.asarray(model.apply(params, batch["x"]))
            out[plan] = (float(loss), before, after,
                         params_from_flax(_np(params)))
        return out
    finally:
        jhvd.shutdown()
        if old is None:
            del os.environ["HOROVOD_COMPILE_CACHE"]
        else:
            os.environ["HOROVOD_COMPILE_CACHE"] = old


@pytest.fixture(scope="module")
def world2(port_sd):
    return spawn_world("run_vit", world=2, args=(port_sd,), timeout=180)


@pytest.fixture()
def hvd_one():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _after_close(got, want):
    """Logits after a step at rtol 1e-5 / atol 1e-5, except at most 0.1%
    of them, which stay within 1e-4: AdamW's first step is lr times the
    sign of each gradient element, scaled by its size against eps, so an
    element whose gradient is near eps carries the last-bit difference of
    the two programs' gradients into the logits."""
    diff = np.abs(got.astype(np.float64) - want)
    off = diff > ATOL + RTOL * np.abs(want)
    assert off.mean() <= 1e-3 and diff.max() <= 1e-4, float(diff.max())


def _check_params(got: dict, want: dict, tp: int = 1, index: int = 0):
    for k, v in got.items():
        w = tp_shard(k, want[k], tp, index).numpy()
        assert v.shape == w.shape, k
        assert_adam_close(v, w, k, steps=1, lr=VIT_LR, atol=ATOL)


class TestModel:
    def test_names_and_shapes_match_flax(self, jax_vit, port_sd):
        """Every flax leaf lands on a port parameter of the same size:
        the patch kernel HWIO as OIHW, the head kernel transposed."""
        model = TV.VisionTransformer(TV.ViTConfig(dtype=torch.float32,
                                                  **VIT_CPU))
        ours = dict(model.named_parameters())
        assert set(ours) == set(port_sd)
        for k, v in port_sd.items():
            assert tuple(ours[k].shape) == tuple(v.shape), k
        flax_kernel = _np(jax_vit[1])["params"]["patch_embed"]["kernel"]
        np.testing.assert_array_equal(
            port_sd["patch_embed.weight"].numpy(),
            flax_kernel.transpose(3, 2, 0, 1))

    @pytest.mark.parametrize("impl", ["dense", "flash"])
    def test_forward_matches_jax(self, jax_vit, port_sd, impl):
        """Logits of the same images on the converted weights; on the CPU
        ``flash`` takes the kernels' plain versions (4 patches: one tile),
        which equal dense attention at fp32 tolerance."""
        model, variables = jax_vit
        x = vit_batch()["x"]
        want = np.asarray(model.apply(variables, jnp.asarray(x)))
        port = TV.VisionTransformer(TV.ViTConfig(
            dtype=torch.float32, attention_impl=impl, **VIT_CPU))
        port.load_state_dict(port_sd)
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32 and got.shape == (4, 1000)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    def test_bidirectional(self, port_sd):
        """No causal mask: the first patch's output moves when the last
        patch's pixels do."""
        port = TV.VisionTransformer(TV.ViTConfig(dtype=torch.float32,
                                                 **VIT_CPU))
        port.load_state_dict(port_sd)
        x = torch.from_numpy(vit_batch()["x"])
        seen = {}

        def keep(mod, args, out):
            seen.setdefault("h", []).append(out)

        handle = port.layers[-1].register_forward_hook(keep)
        with torch.no_grad():
            port(x)
            y = x.clone()
            y[:, 16:, 16:] += 1.0
            port(y)
        handle.remove()
        a, b = seen["h"]
        assert not torch.allclose(a[:, 0], b[:, 0])

    def test_presets_match_jax(self):
        """ViT-S/16 and ViT-B/16: the JAX presets' configuration and
        parameter count (the port's built on the meta device)."""
        for jfn, tfn in ((JV.ViT_S16, TV.ViT_S16), (JV.ViT_B16, TV.ViT_B16)):
            jm, tm = jfn(), tfn(device="meta")
            for field in ("image_size", "patch_size", "num_classes",
                          "num_layers", "num_heads", "d_model", "d_ff"):
                assert getattr(jm.cfg, field) == getattr(tm.cfg, field)
            shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                    jnp.zeros((1, 224, 224, 3)))
            n_jax = sum(int(np.prod(x.shape))
                        for x in jax.tree_util.tree_leaves(shapes))
            assert sum(p.numel() for p in tm.parameters()) == n_jax
        assert TV.ViT_B16(device="meta").cfg.num_patches == 196

    def test_image_size_must_tile(self):
        with pytest.raises(ValueError, match="not a multiple"):
            TV.ViTConfig(image_size=30).num_patches


class TestStep:
    def test_one_step_on_a_world_of_one(self, hvd_one, jax_steps, port_sd):
        """DistributedTrainStep (pjit, no plan) one AdamW step against
        JAX's step: loss, logits before and after, and parameters."""
        loss, before, after, params = jax_steps["dp=1"]
        rec = vit_step(hvd_one, port_sd)
        assert rec["mode"] == "pjit"
        np.testing.assert_allclose(rec["before"], before, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(rec["losses"][0], loss, rtol=RTOL,
                                   atol=ATOL)
        _after_close(rec["after"], after)
        _check_params(rec["params"], params)

    @pytest.mark.parametrize("plan", ["dp=2", "tp=2"])
    def test_gloo_world_of_two(self, world2, jax_steps, plan):
        """``dp=2`` splits the 4 images; ``tp=2`` shards each block's heads
        and feed-forward over both ranks, which see the same images.
        Both land on JAX's step under the same plan."""
        loss, _, after, params = jax_steps[plan]
        for rank, out in enumerate(world2):
            rec = out[plan]
            assert rec["mode"] == "pjit"
            np.testing.assert_allclose(rec["losses"][0], loss, rtol=RTOL,
                                       atol=ATOL)
            _after_close(rec["after"], after)
            tp = 2 if plan == "tp=2" else 1
            assert rec["tp_index"] == (rank if tp == 2 else 0)
            _check_params(rec["params"], params, tp, rec["tp_index"])
