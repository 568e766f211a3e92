#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build the CUDA kernels from ``horovod_tpu_torch/ops/csrc`` (seconds
   printed, with the compiler's register and spill report);
2. hold each kernel against its plain PyTorch version at the shapes the
   training path gives it: ``fused_scale`` on a 64 MiB fp32 bucket, an odd
   length and a bf16 cast; flash forward, dQ and dK/dV at
   b6 h16 t1024 d128 bf16, causal (plus small off-grid shapes);
3. time each kernel with CUDA events beside its bound (the larger of
   bytes over 3.35 TB/s and products over 989 TFLOP/s), its plain version
   and, where one exists, a single PyTorch call computing the same function;
4. train the 870.9M TransformerLM (16 layers, d_model 2048, 16 heads,
   seq 1024, batch 6) through the five-line recipe on a world of one:
   ``init`` (NCCL), ``DistributedOptimizer(AdamW(3e-4, weight_decay=1e-4),
   gradient_predivide_factor=2.0)``, ``broadcast_variables``, a few steps on
   a fixed batch (the loss must fall; every kernel's launch count must
   grow), the same weights under dense attention for comparison, and a
   rank-0 checkpoint round trip;
5. print the card's name and power limit, the kernels' JSON line, and last
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.  Needs one card.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
SEED = 0
FULL = dict(batch=6, seq=1024, heads=16, head_dim=128, layers=16,
            d_model=2048, vocab=32_000)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float,
             peak_flops: float = PEAK_BF16_FLOPS) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from horovod_tpu_torch.ops import build

    lib_path = build.build()
    build.load_library()
    log(f"build: {build.build_seconds:.1f} s -> {lib_path.name}")
    report = lib_path.with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line.lower():
                log("  ptxas: " + line.strip())


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# Flash tolerances.  O, dQ, dK and dV are bf16: each output is rounded once
# (up to one ulp, 2^-7 relative, where the two versions' fp32 sums round
# differently), summed in another order, and built from bf16 P and dS whose
# roundings may differ by one ulp, which moves a small entry by several of
# its own ulps.  Two conditions:
#  * normwise, ||got - want|| / ||want|| <= FLASH_NORM_TOL;
#  * elementwise, |got - want| <= FLASH_RTOL |want| + FLASH_ATOL rms(want),
#    so a small entry is held to its own size and not to the largest one.
# lse is fp32 in the log domain: its absolute error is the relative error
# of the row's softmax sum, held to LSE_ATOL.
FLASH_NORM_TOL = 1e-2
FLASH_RTOL = 2e-2
FLASH_ATOL = 1e-1
LSE_ATOL = 1e-3


def flash_agreement(torch, got, want, is_lse: bool) -> tuple:
    """(reading, limit) pairs for one flash output against its plain
    version; the output agrees when every reading is within its limit."""
    diff = (got.float() - want.float()).abs()
    if is_lse:
        return [("max_abs", float(diff.max()), LSE_ATOL)]
    w = want.float()
    rms = float(w.pow(2).mean().sqrt())
    return [("norm_rel", float(diff.norm() / w.norm()), FLASH_NORM_TOL),
            ("elem_ratio", float((diff / (FLASH_RTOL * w.abs()
                                          + FLASH_ATOL * rms)).max()), 1.0)]


def phase_check(torch):
    """Each kernel against its plain version; returns per-kernel errors."""
    from horovod_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {}

    # fused_scale: the same fp32 product and round-to-nearest-even cast in
    # both versions, so tolerance 0, out of place and in place (the
    # exchange scales each bucket in place)
    f32, bf16 = torch.float32, torch.bfloat16
    n_bucket = 64 * 1024 * 1024 // 4
    cases = [("64MiB f32", n_bucket, 0.5, f32, f32, False),
             ("64MiB f32 in place", n_bucket, 0.5, f32, f32, True),
             ("odd f32", 1_000_003, 1.7, f32, f32, False),
             ("64MiB f32->bf16", n_bucket, 0.5, f32, bf16, False),
             ("odd bf16->f32", 999_999, 0.25, bf16, f32, False),
             ("odd bf16 in place", 999_999, 0.25, bf16, bf16, True)]
    worst = 0.0
    for name, n, f, in_dtype, out_dtype, in_place in cases:
        x = torch.randn(n, generator=gen, device=dev).to(in_dtype)
        want = K.fused_scale_plain(x, f, out_dtype)
        got = K.fused_scale(x, f, out_dtype, out=x if in_place else None)
        torch.cuda.synchronize()
        if in_place and got.data_ptr() != x.data_ptr():
            raise AssertionError(f"fused_scale {name} did not write x")
        err = max_err(torch, got, want)
        log(f"check fused_scale {name}: max_abs_err {err:.3e} (tol 0)")
        if not err == 0.0:
            raise AssertionError(f"fused_scale {name} disagrees with plain")
        worst = max(worst, err)
    errs["fused_scale"] = worst

    # flash at the main path's shapes, then small off-grid ones
    b, t, h, d = FULL["batch"], FULL["seq"], FULL["heads"], FULL["head_dim"]
    shapes = [((b, t, h, d), True, True), ((2, 256, 4, 128), False, False),
              ((2, 200, 3, 64), True, False), ((1, 24, 2, 64), True, False)]
    for shape, causal, main in shapes:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        scale = shape[-1] ** -0.5
        o, lse = K.flash_fwd(q, k, v, causal, scale)
        o_ref, lse_ref = K.flash_fwd_plain(q, k, v, causal, scale)
        delta = K.flash_delta(o_ref, do)
        dq = K.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal, scale)
        dq_ref = K.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal,
                                      scale)
        dk, dv = K.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal, scale)
        dk_ref, dv_ref = K.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta,
                                               causal, scale)
        torch.cuda.synchronize()
        results = {"flash_fwd": [("O", o, o_ref), ("lse", lse, lse_ref)],
                   "flash_bwd_dq": [("dQ", dq, dq_ref)],
                   "flash_bwd_dkv": [("dK", dk, dk_ref), ("dV", dv, dv_ref)]}
        failed = []
        for name, outputs in results.items():
            for label, got, want in outputs:
                readings = flash_agreement(torch, got, want, label == "lse")
                err = max_err(torch, got, want)
                log(f"check {name} {label} {shape} causal={causal}: "
                    f"max_abs_err {err:.3e} (largest entry "
                    f"{float(want.float().abs().max()):.3e}); " + ", ".join(
                        f"{key} {val:.3e} (tol {lim:.0e})"
                        for key, val, lim in readings))
                if not all(val <= lim for _, val, lim in readings):
                    failed.append(f"{name} {label}")
                if main:
                    errs[name] = max(errs.get(name, 0.0), err)
        if failed:
            raise AssertionError(f"{failed} disagree with plain at {shape}")
    return errs


def phase_time(torch):
    """Kernel, plain and library times at the main path's shapes."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    out = {}

    n = 64 * 1024 * 1024 // 4
    x = torch.randn(n, generator=gen, device=dev)
    ms = cuda_ms(torch, lambda: K.fused_scale(x, 0.5))
    plain = cuda_ms(torch, lambda: K.fused_scale_plain(x, 0.5, x.dtype))
    lib = cuda_ms(torch, lambda: x.float().mul(0.5).to(x.dtype))
    bms, by = bound_ms(2 * 4 * n, n, PEAK_FP32_FLOPS)
    out["fused_scale"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=bms, bound_by=by)
    del x

    b, t, h, d = FULL["batch"], FULL["seq"], FULL["heads"], FULL["head_dim"]
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = K.flash_fwd(q, k, v, True, scale)
    delta = K.flash_delta(o, do)
    tile = b * t * h * d * 2                     # one bf16 (b, t, h, d)
    rows = b * h * t * 4                         # one fp32 (b*h, t)
    prod = 2 * b * h * t * t * d / 2             # one causal t x t x d product
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    fwd = dict(ms=cuda_ms(torch, lambda: K.flash_fwd(q, k, v, True, scale)),
               plain_ms=cuda_ms(torch, lambda: K.flash_fwd_plain(
                   q, k, v, True, scale), iters=5),
               library_ms=cuda_ms(torch, sdpa_fwd))
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(4 * tile + rows, 2 * prod)
    dq = dict(ms=cuda_ms(torch, lambda: K.flash_bwd_dq(
        q, k, v, do, lse, delta, True, scale)),
        plain_ms=cuda_ms(torch, lambda: K.flash_bwd_dq_plain(
            q, k, v, do, lse, delta, True, scale), iters=5),
        library_ms=None)
    dq["bound_ms"], dq["bound_by"] = bound_ms(5 * tile + 2 * rows, 3 * prod)
    dkv = dict(ms=cuda_ms(torch, lambda: K.flash_bwd_dkv(
        q, k, v, do, lse, delta, True, scale)),
        plain_ms=cuda_ms(torch, lambda: K.flash_bwd_dkv_plain(
            q, k, v, do, lse, delta, True, scale), iters=5),
        library_ms=None)
    dkv["bound_ms"], dkv["bound_by"] = bound_ms(6 * tile + 2 * rows,
                                                4 * prod)
    out.update(flash_fwd=fwd, flash_bwd_dq=dq, flash_bwd_dkv=dkv)

    # SDPA's backward computes dQ, dK and dV in one call: no single
    # PyTorch call matches dQ or dK/dV alone, so it is printed as a total
    qg, kg, vg = (a.detach().requires_grad_() for a in (qt, kt, vt))

    def sdpa_fwd_bwd():
        y = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(y, (qg, kg, vg), do.transpose(1, 2))

    def ours_fwd_bwd():
        oo, ll = K.flash_fwd(q, k, v, True, scale)
        dd = K.flash_delta(oo, do)
        K.flash_bwd_dq(q, k, v, do, ll, dd, True, scale)
        K.flash_bwd_dkv(q, k, v, do, ll, dd, True, scale)

    log(f"time flash fwd+bwd at b{b} h{h} t{t} d{d}: kernels "
        f"{cuda_ms(torch, ours_fwd_bwd):.4f} ms, "
        f"scaled_dot_product_attention {cuda_ms(torch, sdpa_fwd_bwd):.4f} ms")
    for name, r in out.items():
        log(f"time {name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']}, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']})")
    return out


def _category(name: str) -> str:
    lowered = name.lower()
    for key, cat in (("flash_", "flash kernels"), ("scale_", "fused_scale"),
                     ("nccl", "nccl"), ("gemm", "matmul"), ("xmma", "matmul"),
                     ("nvjet", "matmul"), ("cutlass", "matmul"),
                     ("adam", "optimizer"), ("multi_tensor", "optimizer"),
                     ("cat", "pack/unpack"), ("copy", "copy/cast"),
                     ("memcpy", "copy/cast"),
                     ("reduce", "reductions")):
        if key in lowered:
            return cat
    return "other elementwise"


def profile_step(torch, run) -> None:
    """One more training step under torch.profiler: device time by kernel
    and by category, and the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        # device rows only; annotations such as "Optimizer.step#AdamW.step"
        # carry the device time of the kernels under them and would count
        # twice (kernel names may hold "#" too: "{lambda()#1}")
        if us > 0 and not re.fullmatch(r"[\w.]+#[\w.]+", e.key) and \
                str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    log(f"profile: step wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f} %), idle {100 - 100 * busy / wall_ms:.1f} %")
    cats: dict = {}
    for ms, _, key in rows:
        cats[_category(key)] = cats.get(_category(key), 0.0) + ms
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"profile: {cat:18s} {ms:8.2f} ms ({100 * ms / busy:.1f} %)")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"profile:   {ms:8.2f} ms x{count:<4d} {key[:90]}")


def phase_train(torch):
    """The five-line recipe at full width; returns the launch counts."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )
    from horovod_tpu_torch.ops import kernels as K

    hvd.init()
    dev = hvd.device()
    log(f"init: rank {hvd.rank()} of {hvd.size()} on {dev}")
    cfg = TransformerConfig(vocab_size=FULL["vocab"],
                            num_layers=FULL["layers"],
                            num_heads=FULL["heads"],
                            d_model=FULL["d_model"],
                            d_ff=4 * FULL["d_model"],
                            max_seq_len=FULL["seq"], dtype=torch.bfloat16,
                            attention_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = TransformerLM(cfg, device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {n_params / 1e6:.1f}M params, {cfg.num_layers}L/"
        f"{cfg.d_model}d/{cfg.num_heads}h, seq {FULL['seq']}, "
        f"batch {FULL['batch']}, attention {cfg.attention_impl}")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        gradient_predivide_factor=2.0)

    def loss_fn(m, batch):
        return lm_loss(m, batch)

    step = hvd.DistributedTrainStep(loss_fn, opt)
    tokens = torch.randint(0, cfg.vocab_size,
                           (FULL["batch"], FULL["seq"] + 1),
                           generator=torch.Generator().manual_seed(SEED))

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    model, opt = step.init(model)
    batch = step.shard_batch(tokens)
    losses, times = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))           # synchronises
        times.append(time.perf_counter() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"train: losses {losses}")
    log(f"train: launches on the main path {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens_per_step = FULL["batch"] * FULL["seq"]
    log(f"train: step {steady * 1e3:.1f} ms (median of steps 2-5; first "
        f"{times[0] * 1e3:.1f} ms), {tokens_per_step / steady:.0f} tokens/s, "
        f"peak memory {peak / 2**30:.2f} GiB")

    profile_step(torch, lambda: float(step(model, opt, batch)[2]))

    # the same weights under dense attention: loss and gradients in bf16.
    # Tolerance: the two differ only inside attention (online vs one-pass
    # softmax, bf16 rounding of P and dS), 1e-2 relative on the loss and
    # 5e-2 relative L2 over all gradients.
    grads = {}
    for impl in ("flash", "dense"):
        cfg.attention_impl = impl
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        grads[impl] = (float(loss.detach()), torch.cat(
            [p.grad.float().reshape(-1) for p in model.parameters()]))
    cfg.attention_impl = "flash"
    (lf, gf), (ld, gd) = grads["flash"], grads["dense"]
    loss_rel = abs(lf - ld) / abs(ld)
    grad_rel = float((gf - gd).norm() / gd.norm())
    log(f"parity flash vs dense: loss {lf:.6f} vs {ld:.6f} (rel "
        f"{loss_rel:.3e}, tol 1e-2), grads rel L2 {grad_rel:.3e} (tol 5e-2)")
    if not (loss_rel <= 1e-2 and grad_rel <= 5e-2):
        raise AssertionError("flash and dense training paths disagree")
    del grads, gf, gd
    model.zero_grad(set_to_none=True)

    # rank-0 checkpoint round trip
    ckpt_dir = tempfile.mkdtemp(prefix="hvd_torch_ckpt_")
    try:
        ckpt = hvd.checkpoint.Checkpointer(ckpt_dir)
        state = {"model": model.state_dict(), "opt": opt.state_dict(),
                 "step": 5}
        t0 = time.perf_counter()
        ckpt.save(5, state)
        restored = ckpt.restore(map_location=dev)
        log(f"checkpoint: save+restore {time.perf_counter() - t0:.1f} s, "
            f"latest step {ckpt.latest_step()}")
        for name, ten in state["model"].items():
            if not torch.equal(restored["model"][name], ten):
                raise AssertionError(f"checkpoint changed {name}")
        for pid, st in state["opt"]["state"].items():
            for key, val in st.items():
                if not torch.equal(restored["opt"]["state"][pid][key].to(
                        val.device), val):
                    raise AssertionError(f"checkpoint changed opt {pid}/{key}")
        if restored["step"] != 5:
            raise AssertionError("checkpoint changed the step")
        del restored
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    hvd.shutdown()
    return counts, dict(step_ms=steady * 1e3,
                        tokens_per_s=tokens_per_step / steady,
                        peak_gib=peak / 2**30, losses=losses)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    phase_build()
    errs = phase_check(torch)
    timing = phase_time(torch)
    torch.cuda.empty_cache()
    counts, train = phase_train(torch)

    sources = {"fused_scale": ("horovod_tpu_torch/ops/csrc/fused_scale.cu",
                               "horovod_tpu/ops/pallas_kernels.py:55"),
               "flash_fwd": ("horovod_tpu_torch/ops/csrc/flash_attention.cu",
                             "horovod_tpu/ops/pallas_kernels.py:84"),
               "flash_bwd_dq": ("horovod_tpu_torch/ops/csrc/flash_attention.cu",
                                "horovod_tpu/ops/pallas_kernels.py:213"),
               "flash_bwd_dkv": ("horovod_tpu_torch/ops/csrc/flash_attention.cu",
                                 "horovod_tpu/ops/pallas_kernels.py:269")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = timing[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": errs[name], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(f"train summary: {json.dumps(train)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
