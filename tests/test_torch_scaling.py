"""The port's scaling model against the JAX package's
(``horovod_tpu/utils/scaling.py``): the same wire bytes, payloads,
overlap and hierarchy resolution, and efficiencies on the same inputs and
link rates, equal exactly.  Unset, the port's link rates are the resolved
hardware model's (the H100's published figures), where JAX's are v5e
constants."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.utils import scaling as J
from horovod_tpu_torch.analysis import cost_model as TCM
from horovod_tpu_torch.utils import scaling as T

ARTIFACT = {"overlap_fraction": 0.4, "resnet_overlap_fraction": 0.7,
            "exchange_hierarchy": "two_level"}
RATES = dict(link_bytes_per_s=450e9, dcn_bytes_per_s=50e9)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 64])
def test_allreduce_wire_bytes(n):
    assert T.allreduce_wire_bytes(3.48e9, n) == \
        J.allreduce_wire_bytes(3.48e9, n)


@pytest.mark.parametrize("n,hier,n_ici", [
    (8, "flat", None), (16, "flat", 8), (16, "two_level", 8),
    (64, "two_level", 4), (8, "flat", 1)])
def test_exchange_wire_bytes(n, hier, n_ici):
    assert dataclasses.asdict(T.exchange_wire_bytes(1e9, n, hier, n_ici)) \
        == dataclasses.asdict(J.exchange_wire_bytes(1e9, n, hier, n_ici))


def test_exchange_errors():
    for mod in (J, T):
        with pytest.raises(ValueError, match="needs n_ici"):
            mod.exchange_wire_bytes(1e9, 8, "two_level")
        with pytest.raises(ValueError, match="not divisible"):
            mod.exchange_wire_bytes(1e9, 8, "flat", n_ici=3)


def test_step_payload_bytes():
    """A module's parameters (fp32 and bf16) against the same shapes as a
    JAX pytree."""
    model = torch.nn.Sequential(torch.nn.Linear(7, 5),
                                torch.nn.Linear(5, 3).to(torch.bfloat16))
    tree = {f"p{i}": jnp.zeros(tuple(p.shape), jnp.float32
                               if p.dtype == torch.float32 else jnp.bfloat16)
            for i, p in enumerate(model.parameters())}
    assert T.step_payload_bytes(model) == J.step_payload_bytes(tree)
    assert T.step_payload_bytes(list(model.parameters())) == \
        J.step_payload_bytes(tree)


@pytest.mark.parametrize("prefix", ["", "resnet_", "vit_"])
def test_artifact_readers(tmp_path, prefix):
    path = tmp_path / "BENCH.json"
    path.write_text(json.dumps(ARTIFACT) + "\n")
    for art in (ARTIFACT, str(path)):
        assert T.overlap_fraction_from_artifact(art, prefix) == \
            J.overlap_fraction_from_artifact(art, prefix)
        assert T.hierarchy_from_artifact(art, prefix) == \
            J.hierarchy_from_artifact(art, prefix)
    for explicit in (None, 0.25):
        for art in (None, ARTIFACT):
            assert T.resolve_overlap_fraction(explicit, art, prefix) == \
                J.resolve_overlap_fraction(explicit, art, prefix)
    for explicit in (None, "flat"):
        for art in (None, ARTIFACT):
            assert T.resolve_exchange_hierarchy(explicit, art, prefix) == \
                J.resolve_exchange_hierarchy(explicit, art, prefix)
    for mod in (J, T):
        with pytest.raises(ValueError, match="flat|two_level"):
            mod.resolve_exchange_hierarchy("ring")


@pytest.mark.parametrize("kw", [
    {}, dict(overlap_fraction=0.5), dict(artifact=ARTIFACT, n_ici=8),
    dict(hierarchy="two_level", n_ici=4, wire_bits_dcn=16),
    dict(artifact=ARTIFACT, artifact_prefix="resnet_", n_ici=8)],
    ids=["worst", "overlap", "artifact", "two_level", "prefix"])
def test_efficiency(kw):
    for n in (8, 16, 64):
        assert dataclasses.asdict(T.scaling_efficiency(
            0.146, 3.48e9, n, **RATES, **kw)) == dataclasses.asdict(
                J.scaling_efficiency(0.146, 3.48e9, n, **RATES, **kw))
    assert [dataclasses.asdict(p) for p in T.efficiency_curve(
        0.146, 3.48e9, **RATES, **kw)] == \
        [dataclasses.asdict(p) for p in J.efficiency_curve(
            0.146, 3.48e9, **RATES, **kw)]


def test_rates_default_to_the_hardware_model(monkeypatch):
    """No TPU constant: unset rates are the resolved model's (the H100's,
    or a preset the knob names)."""
    assert not any(name.startswith("V5E") for name in dir(T))
    monkeypatch.delenv("HOROVOD_CALIBRATION_PATH", raising=False)
    monkeypatch.delenv("HOROVOD_HW_PRESET", raising=False)
    got = T.scaling_efficiency(0.146, 3.48e9, 16, n_ici=8)
    want = J.scaling_efficiency(
        0.146, 3.48e9, 16, n_ici=8,
        link_bytes_per_s=TCM.H100.ici_bytes_per_s,
        dcn_bytes_per_s=TCM.H100.dcn_bytes_per_s)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    monkeypatch.setenv("HOROVOD_HW_PRESET", "cpu-twin")
    assert T.scaling_efficiency(0.146, 3.48e9, 16).comm_time_s == \
        np.float64(2 * 15 / 16 * 3.48e9 / TCM.CPU_TWIN.ici_bytes_per_s)
