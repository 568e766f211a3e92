"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, it refuses to start without CUDA unless asked for the CPU, and a
kernel wrapper given a non-CPU tensor launches its kernel and never its
plain version."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from horovod_tpu_torch.ops import kernels as K

#: the matmul's plain version before fake_card replaces it: it is also what
#: a shape outside the dispatch rule computes on any device
PLAIN_MM = K.pallas_matmul_plain
#: the plain versions that the dispatch takes on a card for dtypes the
#: kernels refuse, before fake_card replaces them
PLAIN_SCALE = K.fused_scale_plain
PLAIN_CBR = K.fused_conv_bn_relu_bwd_plain
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _port_files():
    return sorted((ROOT / "horovod_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py", ROOT / "tp_bench.py", ROOT / "sp_bench.py",
         ROOT / "scale_bench.py", ROOT / "ep_bench.py"]


def test_port_files_cover_the_sp_slice():
    """The import checks below cover the sequence-parallel slice's modules."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"horovod_tpu_torch/parallel/plan.py",
            "horovod_tpu_torch/parallel/ulysses.py",
            "horovod_tpu_torch/parallel/ring_attention.py",
            "sp_bench.py"} <= names


def test_port_files_cover_the_zero_slice():
    """The import checks below cover the sharded exchange's modules."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"horovod_tpu_torch/runtime/topology.py",
            "horovod_tpu_torch/ops/collectives.py",
            "horovod_tpu_torch/optim/optimizer.py"} <= names


def test_port_files_cover_the_eager_slice():
    """The import checks below cover the eager plane's and the hook-fired
    exchange's modules."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"horovod_tpu_torch/ops/eager.py",
            "horovod_tpu_torch/ops/op_manager.py",
            "horovod_tpu_torch/ops/adasum.py",
            "horovod_tpu_torch/ops/bucketing.py",
            "horovod_tpu_torch/functions.py",
            "horovod_tpu_torch/optim/train_step.py"} <= names


def test_port_files_cover_the_moe_slice():
    """The import checks below cover the checkpoint plane's and the MoE
    slice's modules."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"horovod_tpu_torch/checkpoint.py",
            "horovod_tpu_torch/parallel/expert.py",
            "horovod_tpu_torch/models/moe.py",
            "horovod_tpu_torch/models/__init__.py",
            "horovod_tpu_torch/ops/fused_collectives.py",
            "ep_bench.py"} <= names


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    """Every import statement, top-level or inside a function."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_no_forbidden_module_loaded():
    """A fresh interpreter that imports the port, every module of it, and
    chip_smoke's imports has no JAX or horovod_tpu module loaded."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "horovod_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import torch.nn.functional\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        f"    if m.split('.')[0] in {FORBIDDEN!r})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_init_without_cuda_raises(monkeypatch):
    import horovod_tpu_torch as hvd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        hvd.init()
    assert not hvd.is_initialized()


def test_chip_smoke_refuses_without_cuda():
    """No card: exit non-zero and print no result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_tp_bench_refuses_without_cards():
    """Fewer cards than asked for: exit non-zero before starting a rank."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "tp_bench.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "needs 4 CUDA cards" in out.stderr and out.stdout == ""


def test_sp_bench_refuses_without_cards():
    """Fewer cards than asked for: exit non-zero before starting a rank."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "sp_bench.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "needs 4 CUDA cards" in out.stderr and out.stdout == ""


def test_scale_bench_refuses_without_a_card():
    """No card: exit non-zero before building anything."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "scale_bench.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "needs a CUDA card" in out.stderr and out.stdout == ""


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the package, the script fails."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


class _FakeLib:
    """Records each C entry called (and its arguments), returns success."""

    def __init__(self):
        self.calls = []
        self.args = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            self.args.append(args)
            return 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """Non-CPU (meta) tensors reach the launch path with a recording
    library; every plain version raises if it is reached."""
    lib = _FakeLib()
    monkeypatch.setattr(K, "_cuda_library", lambda x: (lib, 0))

    def boom(*a, **k):
        raise AssertionError("a plain version ran for a device tensor")

    for name in ("fused_scale_plain", "flash_fwd_plain",
                 "flash_bwd_dq_plain", "flash_bwd_dkv_plain",
                 "fused_conv_bn_relu_bwd_plain", "pallas_matmul_plain"):
        monkeypatch.setattr(K, name, boom)
    K.reset_launch_counts()
    yield lib
    K.reset_launch_counts()


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


def test_device_tensors_launch_kernels(fake_card):
    x = _meta(1000, dtype=torch.float32)
    assert K.fused_scale(x, 0.5, torch.bfloat16).dtype == torch.bfloat16
    q = _meta(2, 128, 4, 128)
    rows = _meta(8, 128, dtype=torch.float32)
    o, lse = K.flash_fwd(q, q, q, True, 0.1)
    assert o.shape == q.shape and lse.shape == (8, 128)
    K.flash_bwd_dq(q, q, q, q, rows, rows, True, 0.1)
    K.flash_bwd_dkv(q, q, q, q, rows, rows, True, 0.1)
    a = _meta(2, 7, 9, 128)
    vec = _meta(256, dtype=torch.float32)
    db = _meta(2, 7, 9, 256)
    da, dw, dgamma, dbeta = K.fused_conv_bn_relu_bwd(
        db, db, a, _meta(3, 3, 128, 256, dtype=torch.float32), vec, vec, vec)
    assert da.shape == a.shape and da.dtype == torch.bfloat16
    assert dw.shape == (3, 3, 128, 256) and dw.dtype == torch.float32
    assert dgamma.shape == dbeta.shape == (256,)
    y = K.pallas_matmul(_meta(24, 128), _meta(128, 384), torch.float32)
    assert y.shape == (24, 384) and y.dtype == torch.float32
    pos = torch.empty(128, device="meta", dtype=torch.int64)
    K.flash_fwd(q, q, q, True, 0.1, pos, pos)
    K.flash_bwd_dq(q, q, q, q, rows, rows, True, 0.1, pos, pos)
    K.flash_bwd_dkv(q, q, q, q, rows, rows, True, 0.1, pos, pos)
    assert fake_card.calls == ["hvd_fused_scale", "hvd_flash_fwd",
                               "hvd_flash_bwd_dq", "hvd_flash_bwd_dkv",
                               "hvd_cbr_bwd", "hvd_matmul", "hvd_flash_fwd",
                               "hvd_flash_bwd_dq", "hvd_flash_bwd_dkv"]
    assert K.launch_counts() == {name: 1 for name in K.WRAPPERS}


def test_device_positions_launch_the_variant(fake_card):
    """A device tensor with positions launches the positions variant (both
    pointers set), counts it apart from the kernel without positions, and
    never reaches a plain version; without positions both pointers are
    null."""
    q = _meta(1, 64, 2, 64)
    rows = _meta(2, 64, dtype=torch.float32)
    pos = torch.empty(64, device="meta", dtype=torch.int32)
    K.flash_fwd(q, q, q, True, 0.1)
    K.flash_fwd(q, q, q, True, 0.1, pos, pos)
    K.flash_bwd_dq(q, q, q, q, rows, rows, True, 0.1, pos, pos)
    K.flash_bwd_dkv(q, q, q, q, rows, rows, True, 0.1, pos, pos)
    assert [a[5:7] for a in fake_card.args[:2]] == [(None, None),
                                                    (pos.data_ptr(),) * 2]
    assert fake_card.args[2][7] is not None and \
        fake_card.args[3][8] is not None
    counts = K.launch_counts()
    assert (counts["flash_fwd"], counts["flash_fwd_pos"],
            counts["flash_bwd_dq_pos"], counts["flash_bwd_dkv_pos"],
            counts["flash_bwd_dq"]) == (1, 1, 1, 1, 0)
    with pytest.raises(ValueError, match="positions"):
        K.flash_fwd(q, q, q, True, 0.1, pos[:32], pos[:32])


def test_sp_ring_of_one_on_device_launches_the_variant(fake_card):
    """The sp ring on a group of one, causal, forward and backward: one
    launch of each positions kernel and none of the others."""
    from horovod_tpu_torch.ops import fused_collectives as FC

    q = _meta(1, 64, 2, 64).requires_grad_()
    out = FC.ring_flash_attention(q, q, q, causal=True)
    out.backward(_meta(1, 64, 2, 64))
    assert fake_card.calls == ["hvd_flash_fwd", "hvd_flash_bwd_dq",
                               "hvd_flash_bwd_dkv"]
    assert {k: v for k, v in K.launch_counts().items() if v} == {
        "flash_fwd_pos": 1, "flash_bwd_dq_pos": 1, "flash_bwd_dkv_pos": 1}


def test_autograd_on_device_uses_kernels(fake_card):
    q = _meta(1, 64, 2, 64).requires_grad_()
    out = K.flash_attention(q, q, q, causal=True)
    out.backward(_meta(1, 64, 2, 64))
    assert fake_card.calls == ["hvd_flash_fwd", "hvd_flash_bwd_dq",
                               "hvd_flash_bwd_dkv"]


#: hvd_flash_bwd_dq's arguments: (q, k, v, dout, lse, delta, dq, qpos, kpos,
#: out, b, t, h, d, scale, causal, stream); hvd_flash_bwd_dkv's have dk, dv
#: where dq is, so its qpos comes one later
DQ_QPOS, DQ_OUT, DKV_QPOS = 7, 9, 8


@pytest.mark.parametrize("entry", ["flash_attention", "ring_attention"])
def test_backward_folds_delta_into_dq(fake_card, entry):
    """The backward on a device tensor: dQ launches first and is handed O,
    so that its kernel computes delta; dK/dV follows; nothing else runs
    (no eager delta pass reaches a kernel, and each launch counts once).
    The ring passes its positions to both."""
    from horovod_tpu_torch.parallel.ring_attention import ring_attention

    fn = K.flash_attention if entry == "flash_attention" else ring_attention
    q = _meta(1, 64, 2, 64).requires_grad_()
    fn(q, q, q, causal=True).backward(_meta(1, 64, 2, 64))
    assert fake_card.calls == ["hvd_flash_fwd", "hvd_flash_bwd_dq",
                               "hvd_flash_bwd_dkv"]
    dq_args, dkv_args = fake_card.args[1:]
    assert dq_args[DQ_OUT] is not None
    pos = entry == "ring_attention"
    assert (dq_args[DQ_QPOS] is not None) is pos
    assert (dkv_args[DKV_QPOS] is not None) is pos
    assert sum(K.launch_counts().values()) == 3


def test_dq_with_out_returns_a_delta_buffer(fake_card):
    """``out=`` gives dQ's kernel O and a fresh (b*h, t) fp32 buffer to
    write delta into, which comes back for dK/dV; a given delta passes no
    O pointer and comes back as it was."""
    q = _meta(2, 64, 4, 128)
    rows = _meta(8, 64, dtype=torch.float32)
    dq, delta = K.flash_bwd_dq(q, q, q, q, rows, None, True, 0.1, out=q)
    assert dq.shape == q.shape and dq.dtype == torch.bfloat16
    assert delta.shape == (8, 64) and delta.dtype == torch.float32
    assert delta.device == q.device and delta is not rows
    assert fake_card.args[0][DQ_OUT] is not None
    _, same = K.flash_bwd_dq(q, q, q, q, rows, rows, True, 0.1)
    assert same is rows and fake_card.args[1][DQ_OUT] is None
    with pytest.raises(ValueError, match="delta"):
        K.flash_bwd_dq(q, q, q, q, rows, rows, True, 0.1, out=q)
    with pytest.raises(TypeError, match="bfloat16"):
        K.flash_bwd_dq(q, q, q, q, rows, None, True, 0.1, out=q.float())
    assert K.flash_bwd_dq.launches == 2


def test_conv_bn_relu_autograd_on_device_uses_kernel(fake_card):
    """The fused segment's backward, inside the dispatch rule on a device
    tensor, launches the kernel and never reaches the plain version."""
    a = _meta(2, 6, 6, 128).requires_grad_()
    w = _meta(3, 3, 128, 128, dtype=torch.float32).requires_grad_()
    vecs = [_meta(128, dtype=torch.float32).requires_grad_()
            for _ in range(4)]
    out = K.fused_conv_bn_relu(a, w, *vecs)
    assert out.shape == (2, 6, 6, 128) and out.dtype == torch.bfloat16
    out.backward(_meta(2, 6, 6, 128))
    assert fake_card.calls == ["hvd_cbr_bwd"]
    assert K.fused_conv_bn_relu_bwd.launches == 1
    assert w.grad.shape == w.shape and a.grad.shape == a.shape


def test_conv_bn_relu_outside_the_rule_launches_nothing(fake_card):
    """A 64-channel segment is outside the dispatch rule: on a device
    tensor it computes the unfused backward, as the JAX package does,
    and neither launches the kernel nor counts."""
    a = _meta(2, 6, 6, 64)
    vec = _meta(64, dtype=torch.float32)
    da, dw, _, _ = K.fused_conv_bn_relu_bwd(
        a, a, a, _meta(3, 3, 64, 64, dtype=torch.float32), vec, vec, vec)
    assert da.shape == a.shape and dw.shape == (3, 3, 64, 64)
    assert fake_card.calls == []
    assert K.fused_conv_bn_relu_bwd.launches == 0


@pytest.fixture
def plain_runs(fake_card, monkeypatch):
    """fake_card, with ``fused_scale_plain`` and
    ``fused_conv_bn_relu_bwd_plain`` recording each call (its name and its
    tensor arguments' dtypes) and computing as before; every other plain
    version still raises."""
    runs = []

    def recording(name, fn):
        def run(*args, **kwargs):
            runs.append((name, tuple(a.dtype for a in args
                                     if isinstance(a, torch.Tensor))))
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(K, "fused_scale_plain",
                        recording("fused_scale_plain", PLAIN_SCALE))
    monkeypatch.setattr(K, "fused_conv_bn_relu_bwd_plain",
                        recording("fused_conv_bn_relu_bwd_plain", PLAIN_CBR))
    return runs


def _cbr_meta(dtype, cin=128, c=128):
    a = _meta(1, 4, 4, cin, dtype=dtype)
    db = _meta(1, 4, 4, c, dtype=dtype)
    vec = _meta(c, dtype=torch.float32)
    return db, db, a, _meta(3, 3, cin, c, dtype=torch.float32), vec, vec, vec


def test_conv_bn_relu_device_fp32_refused(plain_runs, fake_card):
    """The kernel refuses fp32 activations, so a fusable fp32 segment on a
    card computes the plain version (as the JAX package's Pallas kernel
    computes fp32): da in fp32, dW fp32, no launch and no count."""
    da, dw, dgamma, dbeta = K.fused_conv_bn_relu_bwd(
        *_cbr_meta(torch.float32))
    assert da.dtype == dw.dtype == dgamma.dtype == torch.float32
    assert da.shape == (1, 4, 4, 128) and dw.shape == (3, 3, 128, 128)
    assert plain_runs == [("fused_conv_bn_relu_bwd_plain",
                           (torch.float32,) * 7)]
    assert fake_card.calls == [] and K.fused_conv_bn_relu_bwd.launches == 0


def test_conv_bn_relu_device_fp16_takes_the_plain_path(plain_runs,
                                                       fake_card):
    """fp16 activations, cin != c: the plain version, da rounded to fp16
    and dW in fp32, no launch and no count."""
    da, dw, _, _ = K.fused_conv_bn_relu_bwd(
        *_cbr_meta(torch.float16, cin=256, c=128))
    assert da.dtype == torch.float16 and da.shape == (1, 4, 4, 256)
    assert dw.dtype == torch.float32 and dw.shape == (3, 3, 256, 128)
    assert plain_runs == [("fused_conv_bn_relu_bwd_plain",
                           (torch.float16,) * 3 + (torch.float32,) * 4)]
    assert fake_card.calls == [] and K.fused_conv_bn_relu_bwd.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_conv_bn_relu_autograd_off_kernel_dtype(plain_runs, fake_card,
                                                dtype):
    """The fused segment's backward in fp32 or fp16 on a card: the plain
    version once, with the segment's dtypes, nothing launched."""
    a = _meta(2, 6, 6, 128, dtype=dtype).requires_grad_()
    w = _meta(3, 3, 128, 128, dtype=torch.float32).requires_grad_()
    vecs = [_meta(128, dtype=torch.float32).requires_grad_()
            for _ in range(4)]
    out = K.fused_conv_bn_relu(a, w, *vecs)
    out.backward(_meta(2, 6, 6, 128, dtype=dtype))
    assert [name for name, _ in plain_runs] == [
        "fused_conv_bn_relu_bwd_plain"]
    assert plain_runs[0][1][:3] == (dtype,) * 3
    assert a.grad.dtype == dtype and w.grad.dtype == torch.float32
    assert fake_card.calls == [] and K.fused_conv_bn_relu_bwd.launches == 0


def test_conv_bn_relu_launcher_still_refuses(fake_card):
    """The low-level launcher raises on fp32 activations and calls
    nothing: the routing is the dispatch's, not a fallback."""
    with pytest.raises(TypeError, match="bfloat16"):
        K._launch_cbr_bwd(*_cbr_meta(torch.float32))
    assert fake_card.calls == []


@pytest.mark.parametrize("shape,dtype,err", [
    ((1, 64, 2, 96), torch.bfloat16, ValueError),     # head_dim 96
    ((1, 64, 2, 64), torch.float32, TypeError),       # fp32 inputs
])
def test_device_flash_raises_on_unsupported(fake_card, shape, dtype, err):
    q = _meta(*shape, dtype=dtype)
    with pytest.raises(err):
        K.flash_fwd(q, q, q, True, 0.1)
    assert fake_card.calls == []


def test_fused_scale_device_dtype_refused(plain_runs, fake_card):
    """The kernel refuses float64, so a float64 tensor on a card computes
    the plain version (through fp32, as the JAX package's fused_scale
    does), in place when asked; no launch, no count."""
    x = _meta(4, dtype=torch.float64)
    assert K.fused_scale(x, 2.0).dtype == torch.float64
    assert K.fused_scale(x, 2.0, out=x) is x
    y = K.fused_scale(x, 2.0, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert plain_runs == [("fused_scale_plain", (torch.float64,))] * 3
    assert fake_card.calls == [] and K.fused_scale.launches == 0


def test_exchange_scale_of_a_float64_bucket(plain_runs, fake_card):
    """The exchange's scale pass over a float64 bucket on a card (in
    place) and its wire cast to fp16 take the plain version; an fp32
    bucket still launches the kernel."""
    from horovod_tpu_torch.ops import collectives as TC

    x = _meta(1000, dtype=torch.float64)
    assert TC._scale(x, 0.5) is x
    assert TC._scale(x, 1.0, torch.float16).dtype == torch.float16
    assert plain_runs == [("fused_scale_plain", (torch.float64,))] * 2
    assert fake_card.calls == [] and K.fused_scale.launches == 0
    TC._scale(_meta(1000, dtype=torch.float32), 0.5)
    assert fake_card.calls == ["hvd_fused_scale"]
    assert K.fused_scale.launches == 1


def test_fused_scale_launcher_still_refuses(fake_card):
    """The low-level launcher raises on float64 and calls nothing."""
    x = _meta(4, dtype=torch.float64)
    with pytest.raises(TypeError, match="fused_scale"):
        K._launch_fused_scale(x, 2.0, torch.float64, None)
    assert fake_card.calls == []


def test_matmul_autograd_on_device_uses_kernel(fake_card):
    """A linear layer's three products run the kernel on a device tensor,
    each operand read in place: the forward reads the weight transposed,
    dX the weight as it is, dW dy transposed; (m, n, k, a_t, b_t, fp32)."""
    x = _meta(384, 128).requires_grad_()
    weight = _meta(256, 128, dtype=torch.float32).requires_grad_()
    y = K.pallas_matmul(x, weight.bfloat16().t())
    assert y.shape == (384, 256) and y.dtype == torch.bfloat16
    y.backward(_meta(384, 256))
    assert fake_card.calls == ["hvd_matmul"] * 3
    assert [a[3:9] for a in fake_card.args] == [
        (384, 256, 128, 0, 1, 0), (384, 128, 256, 0, 0, 0),
        (256, 128, 384, 1, 0, 0)]
    assert K.pallas_matmul.launches == 3
    assert x.grad.shape == x.shape and x.grad.dtype == torch.bfloat16
    assert weight.grad.shape == weight.shape
    assert weight.grad.dtype == torch.float32


def test_matmul_device_fp32_refused(fake_card, monkeypatch):
    """fp32 operands inside the shape rule: the kernel refuses them, so the
    dispatch computes the plain product on the card, as the JAX package's
    pallas_matmul computes fp32; no launch, no count."""
    monkeypatch.setattr(K, "pallas_matmul_plain", PLAIN_MM)
    y = K.pallas_matmul(_meta(8, 128, dtype=torch.float32),
                        _meta(128, 128, dtype=torch.float32))
    assert y.shape == (8, 128) and y.dtype == torch.float32
    assert fake_card.calls == [] and K.pallas_matmul.launches == 0


@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float16)],
    ids=["fp32", "mixed", "fp16-out"])
def test_matmul_off_kernel_dtypes_take_the_plain_path(fake_card, monkeypatch,
                                                      dtypes):
    """Every operand or result dtype the kernel does not take: the plain
    product, nothing launched.  The backward's products take dy in the
    operands' dtype, so under bf16 operands they are the kernel's."""
    monkeypatch.setattr(K, "pallas_matmul_plain", PLAIN_MM)
    xd, wd, out_dtype = dtypes
    x = _meta(128, 128, dtype=xd).requires_grad_()
    w = _meta(128, 256, dtype=wd).requires_grad_()
    y = K.pallas_matmul(x, w, out_dtype)
    assert y.shape == (128, 256) and y.dtype == out_dtype
    assert fake_card.calls == [] and K.pallas_matmul.launches == 0
    y.backward(_meta(128, 256, dtype=out_dtype))
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    backward = 2 if wd == torch.bfloat16 else 0
    assert fake_card.calls == ["hvd_matmul"] * backward
    assert K.pallas_matmul.launches == backward


@pytest.mark.parametrize("shape,dtype", [
    ((1, 64, 2, 64), torch.float32), ((1, 64, 2, 96), torch.bfloat16),
    ((1, 64, 2, 16), torch.float32)], ids=["fp32", "d96", "fp32-d16"])
@pytest.mark.parametrize("entry", ["flash_attention", "ring_attention"])
def test_attention_off_kernel_inputs_take_the_plain_path(fake_card, shape,
                                                         dtype, entry):
    """fp32 or a head_dim the flash kernels lack, through both attention
    entries, forward and backward: the plain path (reference attention or
    the plain ring), as the JAX package computes them; nothing launched,
    nothing counted, no fused ring built."""
    from horovod_tpu_torch.ops import fused_collectives as FC
    from horovod_tpu_torch.parallel.ring_attention import ring_attention

    fn = K.flash_attention if entry == "flash_attention" else ring_attention
    rings = FC.ring_flash_attention.launches
    q = _meta(*shape, dtype=dtype).requires_grad_()
    out = fn(q, q, q, causal=True)
    assert out.shape == q.shape and out.dtype == dtype
    out.backward(_meta(*shape, dtype=dtype))
    assert q.grad.shape == q.shape
    assert fake_card.calls == []
    assert not any(K.launch_counts().values())
    assert FC.ring_flash_attention.launches == rings


@pytest.mark.parametrize("entry", ["flash_attention", "ring_attention"])
def test_attention_kernel_inputs_still_launch(fake_card, entry):
    """bf16 at head_dim 64 and 128 through both entries: the kernels, one
    launch each, as counted."""
    from horovod_tpu_torch.parallel.ring_attention import ring_attention

    fn = K.flash_attention if entry == "flash_attention" else ring_attention
    for d in K.FLASH_HEAD_DIMS:
        q = _meta(1, 64, 2, d).requires_grad_()
        fn(q, q, q, causal=True).backward(_meta(1, 64, 2, d))
    assert fake_card.calls == ["hvd_flash_fwd", "hvd_flash_bwd_dq",
                               "hvd_flash_bwd_dkv"] * 2
    counts = {k: v for k, v in K.launch_counts().items() if v}
    want = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    if entry == "ring_attention":
        want = tuple(f"{n}_pos" for n in want)
    assert counts == dict.fromkeys(want, 2)


@pytest.mark.parametrize("shape,dtype,want", [
    ((1, 64, 2, 64), torch.bfloat16, True),
    ((1, 64, 2, 128), torch.bfloat16, True),
    ((1, 64, 2, 96), torch.bfloat16, False),
    ((1, 64, 2, 64), torch.float32, False),
    ((1, 64, 2, 128), torch.float16, False)])
def test_flash_kernels_take_reads_dtype_and_head_dim(shape, dtype, want):
    """The rule by dtype and shape on a card; on the CPU the plain
    versions take everything."""
    assert K.flash_kernels_take(_meta(*shape, dtype=dtype)) is want
    assert K.flash_kernels_take(torch.zeros(shape, dtype=dtype)) is True


def test_matmul_outside_the_rule_launches_nothing(fake_card, monkeypatch):
    """m % 8 != 0: the plain product on any device, as the JAX package's
    jnp.dot fallback; no launch, no count."""
    monkeypatch.setattr(K, "pallas_matmul_plain", PLAIN_MM)
    y = K.pallas_matmul(_meta(7, 128), _meta(128, 128))
    assert y.shape == (7, 128) and y.dtype == torch.bfloat16
    assert fake_card.calls == [] and K.pallas_matmul.launches == 0


def test_ring_ops_of_one_rank_launch_the_kernel(fake_card):
    """A tp group of one is the bare kernel, forward and backward."""
    from horovod_tpu_torch.ops import fused_collectives as FC

    x = _meta(128, 128).requires_grad_()
    w = _meta(128, 256).requires_grad_()
    FC.matmul_reducescatter(x, w).backward(_meta(128, 256))
    FC.allgather_matmul(x, w)
    assert fake_card.calls == ["hvd_matmul"] * 4
    assert FC.matmul_reducescatter.launches == 0


def test_expert_chunk_mlp_on_device_launches_the_kernel(fake_card):
    """expert_chunk_mlp on device bf16 tensors on the tiling contract: two
    kernel-6 launches an expert, none of the plain product."""
    from horovod_tpu_torch.ops import fused_collectives as FC

    y = FC.expert_chunk_mlp(_meta(2, 128, 128), _meta(2, 128, 256),
                            _meta(2, 256, 128))
    assert y.shape == (2, 128, 128) and y.dtype == torch.bfloat16
    assert fake_card.calls == ["hvd_matmul"] * 4
    assert K.pallas_matmul.launches == 4


def test_launcher_refuses_non_cuda_tensors():
    """Without the fake card, a meta tensor reaches the real launcher,
    which raises instead of falling back."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.fused_scale(_meta(4, dtype=torch.float32), 2.0)
