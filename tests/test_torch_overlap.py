"""The hook-fired replicated exchange (``optim/optimizer.py``
``_DistributedOptimizer``) against ``distributed_gradients`` applied to the
same gradients, bit for bit, at worlds 1 (this process), 2 and 4 (spawned
gloo worlds), on tests/test_optimizer.py's MLP (one bucket a parameter,
whose hooks fire out of plan order) and the small TransformerLM (tied
embedding, a few buckets); ``join_step`` against JAX's at a world of 4;
``DistributedGradientTape`` against JAX's in one process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from torch_port_workers import (
    OVERLAP_CASES,
    OVERLAP_THRESHOLDS,
    check_overlap,
    join_step_inputs,
    mlp_batch,
    mlp_loss,
    mlp_params,
    overlap_case,
    spawn_world,
)

CASES = [(name, case) for name in OVERLAP_THRESHOLDS
         for case in OVERLAP_CASES]


@pytest.fixture
def hvd_torch():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.fixture(scope="module", params=[2, 4])
def overlap_world(request):
    return request.param, spawn_world("run_overlap", world=request.param,
                                      timeout=240)


class TestWorldOfOne:
    @pytest.mark.parametrize("name,case", CASES)
    def test_equals_distributed_gradients(self, hvd_torch, name, case):
        check_overlap(overlap_case(hvd_torch, name, case), name, case)

    def test_hooks_fire_out_of_plan_order(self, hvd_torch):
        """The MLP's hooks fire w2 and b2 before w1 (plan: w2, w1, b2, b1),
        so b2's bucket completes before w1's; it launches only after."""
        res = overlap_case(hvd_torch, "mlp", "plain")
        assert res["fired_buckets"] != sorted(res["fired_buckets"])
        assert [ids for ids, _ in res["launches"]] == res["buckets"]

    def test_second_backward_before_step_raises(self, hvd_torch):
        """The reference's error for gradients computed twice before
        step(); zero_grad() starts a new exchange."""
        model = torch.nn.ParameterDict({
            k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in mlp_params().items()})
        opt = hvd_torch.DistributedOptimizer(torch.optim.SGD(
            model.parameters(), lr=0.1))
        x, y = mlp_batch(8)
        batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
        mlp_loss(model, batch).backward()
        with pytest.raises(RuntimeError, match="backward_passes_per_step"):
            mlp_loss(model, batch).backward()
        opt.zero_grad()
        mlp_loss(model, batch).backward()
        opt.step()
        assert all(src == "hook" for _, src in opt.launches)

    def test_rewrapped_parameters_exchange_once(self, hvd_torch,
                                                monkeypatch):
        """Wrapping the same parameters again: only the newer wrapper's
        hooks exchange."""
        from horovod_tpu_torch.optim import optimizer as TO

        model = torch.nn.ParameterDict({
            k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in mlp_params().items()})
        old = hvd_torch.DistributedOptimizer(torch.optim.SGD(
            model.parameters(), lr=0.1))
        new = hvd_torch.DistributedOptimizer(torch.optim.SGD(
            model.parameters(), lr=0.1))
        calls = []
        real = TO.C.grouped_allreduce
        monkeypatch.setattr(TO.C, "grouped_allreduce", lambda xs, **k: (
            calls.append(len(xs)), real(xs, **k))[1])
        x, y = mlp_batch(8)
        mlp_loss(model, {"x": torch.from_numpy(x),
                         "y": torch.from_numpy(y)}).backward()
        assert old.launches == [] and len(new.launches) == len(calls) == 1

    def test_sharded_path_registers_no_hook(self, hvd_torch):
        model = torch.nn.ParameterDict({
            k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in mlp_params().items()})
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-2),
            shard_optimizer_states=True)
        assert opt._buckets == []
        assert not any(getattr(p, "_post_accumulate_grad_hooks", None)
                       for p in model.values())

    def test_gradient_tape_matches_jax(self, hvd_torch):
        """DistributedGradientTape in one process: the MLP's gradients
        through the eager plane against JAX's tape on jax.grad (fp32, two
        autodiffs: 1e-6)."""
        import horovod_tpu as jhvd

        params = mlp_params()
        x, y = mlp_batch(16)

        def jloss(p, batch):
            h = jnp.tanh(batch["x"] @ p["w1"] + p["b1"])
            return jnp.mean((h @ p["w2"] + p["b2"] - batch["y"]) ** 2)

        def tgrad(p, batch):
            ps = {k: v.requires_grad_() for k, v in p.items()}
            gs = torch.autograd.grad(mlp_loss(ps, batch), list(ps.values()))
            return dict(zip(ps, gs))

        jhvd.init()
        try:
            want = jhvd.DistributedGradientTape(jax.grad(jloss)).gradient(
                {k: jnp.asarray(v) for k, v in params.items()},
                {"x": jnp.asarray(x), "y": jnp.asarray(y)})
            want = {k: np.asarray(v) for k, v in want.items()}
        finally:
            jhvd.shutdown()
        got = hvd_torch.DistributedGradientTape(tgrad)(
            {k: torch.from_numpy(v.copy()) for k, v in params.items()},
            {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


class TestGlooWorlds:
    @pytest.mark.parametrize("name,case", CASES)
    def test_equals_distributed_gradients(self, overlap_world, name, case):
        _, outs = overlap_world
        for out in outs:
            check_overlap(out[(name, case)], name, case)

    def test_join_step_matches_jax(self, overlap_world):
        """join_step with rank 1 out of data against JAX's join_step under
        shard_map on as many of the 8 CPU devices (1e-6), at worlds of 2
        and 4."""
        world, outs = overlap_world
        from horovod_tpu.optim.train_step import join_step

        ins = [join_step_inputs(r) for r in range(world)]
        mesh = Mesh(np.array(jax.devices()[:world]), ("i",))
        stacked = {k: jnp.concatenate([jnp.asarray(i[k])[None]
                                       for i in ins]) for k in ins[0]}
        flags = jnp.asarray([r != 1 for r in range(world)])

        def body(g, has):
            return join_step({k: v[0] for k, v in g.items()}, has[0],
                             axis="i")

        want = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P("i"), P("i")), out_specs=P(),
            check_vma=False))(stacked, flags)
        for out in outs:
            for k, v in want.items():
                np.testing.assert_allclose(out["join_step"][k],
                                           np.asarray(v), rtol=1e-6,
                                           atol=1e-6, err_msg=k)
