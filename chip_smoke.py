#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``swat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each: the card; the CUDA kernels' build; the packed-head
attention forward and backward kernels against their plain PyTorch versions
at the main path's shapes, and their timings; the same for the heads-first
forward and backward kernels (the backward in both of its forms), with the
time of ``scaled_dot_product_attention`` beside all four as a yardstick;
the full-width ViT-B/32 towers with and without the kernels; zero-shot
classification through ``swat_tpu_torch.cli.main``; one full-width ViT-B/32
cutmix train step, kernel against plain attention, timed and profiled; one
attentivemix train step (heatmaps through the heads-first forward); one
cutmix train step with the heads-first backward (``bwd="fused"``); and
stage-1 finetuning through ``swat_tpu_torch.cli.main`` with cutmix,
attentivemix and mixup.  The data are a synthetic
JPEG dataset (few-shot, retrieved and test splits) and a seeded
OpenCLIP-format checkpoint.  Any failure raises and exits non-zero.  The
last line is a JSON object naming the device.  Without a GPU, or without
the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# (name, batch, seq, heads, width, causal): the attention calls of the main
# path (B/32 image tower, text tower) and of the other supported towers
KERNEL_SHAPES = [
    ("vitb32_image", 256, 50, 12, 768, False),
    ("text", 1024, 77, 8, 512, True),
    ("vitb16_image", 128, 197, 12, 768, False),
    ("vitl14_image", 64, 257, 16, 1024, False),
]
# kernel vs plain: both round the output (and, in bf16, p) to the input
# dtype; fp32 differs only in summation order, bf16 by at most a rounding
# flip of the output (one bf16 ulp is 2^-7 relative): allow two
TOLERANCE = {"float32": (2e-5, 2e-4), "bfloat16": (1e-2, 1.6e-2)}
# backward vs plain: fp32 differs in summation order only (delta and the
# three products over S keys), a few ulps of values of order 1; bf16 by a
# rounding flip of ds or pb (one bf16 ulp of an element) or of an output
# (two ulps, as for the forward)
TOLERANCE_BWD = {"float32": (5e-5, 2e-4), "bfloat16": (1e-2, 1.6e-2)}
# that bf16 bound cannot tell the rounding points apart (delta from the
# fp32 p, pb only in dv, ds rounded): with the same points, summation order
# alone flips about 2 in 10^4 elements of an output; one point done wrong
# leaves 58-78 % of an output bit-equal (tests/test_torch_attention_bwd.py)
BWD_MIN_EQUAL_SHARE = 0.99


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[card] nvidia-smi: {smi} | torch: {name} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi, name


def phase_build():
    from swat_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load()
    secs = time.perf_counter() - t0
    with open(lib_path.replace(_build.LIB_NAME, "build.log")) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    log(f"[build] {lib_path} in {secs:.2f} s; ptxas: {' | '.join(ptxas)}")
    return secs


def _qkv(batch, seq, width, dtype, gen, strided):
    import torch

    if strided:  # the three thirds of one qkv projection, row stride 3*width
        qkv = torch.randn(batch, seq, 3 * width, generator=gen,
                          device="cuda").to(dtype)
        return qkv.split(width, dim=-1)
    return tuple(torch.randn(batch, seq, width, generator=gen,
                             device="cuda").to(dtype) for _ in range(3))


def phase_kernel_vs_plain():
    """Every main-path shape, fp32 and bf16, contiguous and strided."""
    import torch

    from swat_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for name, b, s, h, w, causal in KERNEL_SHAPES:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            atol, rtol = TOLERANCE[dname]
            for strided in (False, True):
                q, k, v = _qkv(b, s, w, dtype, gen, strided)
                got = FA.mha_packed_fwd(q, k, v, h, causal)
                ref = FA.mha_packed_reference(q, k, v, h, causal)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs()
                bound = atol + rtol * ref.float().abs()
                ok = bool((err <= bound).all()) and bool(
                    torch.isfinite(got).all())
                max_err = float(err.max())
                worst[(name, dname)] = max(worst.get((name, dname), 0.0),
                                           max_err)
                log(f"[kernel] {name} B={b} S={s} H={h} HD={w} "
                    f"causal={causal} {dname} "
                    f"{'strided' if strided else 'contiguous'}: "
                    f"max_abs_err={max_err:.3e} "
                    f"(tol {atol:g} + {rtol:g}*|ref|) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel disagrees at {name} "
                                         f"{dname} strided={strided}")
    return worst


def _time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_timing(smi):
    """Kernel and plain version on the same strided inputs, in turns
    plain, kernel, kernel, plain; launches made here are not counted."""
    import torch

    from swat_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(1)
    times = {}
    for name, b, s, h, w, causal in KERNEL_SHAPES[:2]:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            q, k, v = _qkv(b, s, w, dtype, gen, strided=True)

            def kernel():
                FA.mha_packed_fwd(q, k, v, h, causal)

            def plain():
                FA.mha_packed_reference(q, k, v, h, causal)

            p1, k1, k2, p2 = (_time_ms(plain), _time_ms(kernel),
                              _time_ms(kernel), _time_ms(plain))
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            times[(name, dname)] = (ms, plain_ms)
            log(f"[timing] {name} B={b} S={s} H={h} HD={w} {dname}: "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"(runs {k1:.4f}/{k2:.4f} vs {p1:.4f}/{p2:.4f}) on {smi}")
    return times


def phase_bwd_kernel_vs_plain():
    """dq, dk, dv of the backward kernel against mha_bwd_reference at every
    main-path shape, fp32 and bf16, contiguous and strided q/k/v; in bf16
    each output must also be bit-equal in BWD_MIN_EQUAL_SHARE of its
    elements."""
    import torch

    from swat_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    for name, b, s, h, w, causal in KERNEL_SHAPES:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            atol, rtol = TOLERANCE_BWD[dname]
            for strided in (False, True):
                q, k, v = _qkv(b, s, w, dtype, gen, strided)
                do = torch.randn(b, s, w, generator=gen,
                                 device="cuda").to(dtype)
                got = FA.mha_packed_bwd(q, k, v, do, h, causal).split(w, -1)
                ref = FA.mha_bwd_reference(q, k, v, do, h, causal)
                torch.cuda.synchronize()
                errs, shares = [], []
                ok = True
                for g, r in zip(got, ref):
                    err = (g.float() - r.float()).abs()
                    ok &= bool((err <= atol + rtol * r.float().abs()).all())
                    ok &= bool(torch.isfinite(g).all())
                    errs.append(float(err.max()))
                    shares.append(float((g == r).float().mean()))
                if dtype == torch.bfloat16:
                    ok &= min(shares) >= BWD_MIN_EQUAL_SHARE
                worst[(name, dname)] = max(worst.get((name, dname), 0.0),
                                           *errs)
                log(f"[bwd-kernel] {name} B={b} S={s} H={h} HD={w} "
                    f"causal={causal} {dname} "
                    f"{'strided' if strided else 'contiguous'}: max_abs_err "
                    f"dq={errs[0]:.3e} dk={errs[1]:.3e} dv={errs[2]:.3e} "
                    f"(tol {atol:g} + {rtol:g}*|ref|), bit-equal "
                    f"{'/'.join(f'{x:.5f}' for x in shares)}"
                    f"{f' (min {BWD_MIN_EQUAL_SHARE})' if dtype == torch.bfloat16 else ''} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"backward kernel disagrees at "
                                         f"{name} {dname} strided={strided}")
    return worst


def phase_bwd_timing(smi):
    """The backward kernel and mha_bwd_reference on the same strided
    inputs, in turns plain, kernel, kernel, plain."""
    import torch

    from swat_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(3)
    times = {}
    for name, b, s, h, w, causal in KERNEL_SHAPES[:2]:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            q, k, v = _qkv(b, s, w, dtype, gen, strided=True)
            do = torch.randn(b, s, w, generator=gen, device="cuda").to(dtype)

            def kernel():
                FA.mha_packed_bwd(q, k, v, do, h, causal)

            def plain():
                FA.mha_bwd_reference(q, k, v, do, h, causal)

            p1, k1, k2, p2 = (_time_ms(plain), _time_ms(kernel),
                              _time_ms(kernel), _time_ms(plain))
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            times[(name, dname)] = (ms, plain_ms)
            log(f"[bwd-timing] {name} B={b} S={s} H={h} HD={w} {dname}: "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"(runs {k1:.4f}/{k2:.4f} vs {p1:.4f}/{p2:.4f}) on {smi}")
    return times


# the card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory rate, and operation rates by type: fp32 outside the tensor cores
# (the port computes fp32 in full fp32), bf16 in them
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}


def _bound_ms(kind, b, s, h, d, dname, causal):
    """The least time the card could take for one attention call: the
    larger of its bytes (forward: q, k, v read and o written; backward: q,
    k, v, do read and dq, dk, dv written, once each) over the memory rate
    and its operations (2 matrix products forward, 5 backward, of 2*D
    operations for each query-key pair that is not masked) over the peak
    rate of the type -> (ms, 'bytes' | 'operations')."""
    itemsize = 4 if dname == "float32" else 2
    tensors, products = (4, 2) if kind == "fwd" else (7, 5)
    pairs = s * (s + 1) // 2 if causal else s * s
    t_bytes = tensors * b * h * s * d * itemsize / HBM_BYTES_PER_S
    t_ops = products * 2 * b * h * pairs * d / PEAK_OPS_PER_S[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _heads_first(batch, seq, heads, width, dtype, gen, views, n=3):
    """n tensors [B, H, S, D]: contiguous, or the transposed views of one
    [B, S, n*H*D] projection output, as the towers pass them."""
    import torch

    d = width // heads
    if views:
        x = torch.randn(batch, seq, n * width, generator=gen,
                        device="cuda").to(dtype)
        return tuple(t.reshape(batch, seq, heads, d).transpose(1, 2)
                     for t in x.chunk(n, dim=-1))
    return tuple(torch.randn(batch, heads, seq, d, generator=gen,
                             device="cuda").to(dtype) for _ in range(n))


def phase_flash_kernels_vs_plain():
    """The heads-first forward kernel, and the heads-first backward kernel
    in both forms (keep_dtype off: the gradient of flash_attention; on: the
    backward of bwd='fused'), against their plain versions at every shape,
    fp32 and bf16, contiguous and as transposed views."""
    import torch

    from swat_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {}
    for name, b, s, h, w, causal in KERNEL_SHAPES:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            for views in (False, True):
                q, k, v, do = _heads_first(b, s, h, w, dtype, gen, views, 4)
                layout = "views" if views else "contiguous"
                head = (f"{name} B={b} H={h} S={s} D={w // h} "
                        f"causal={causal} {dname} {layout}")
                atol, rtol = TOLERANCE[dname]
                got = FA.flash_attention_fwd(q, k, v, causal)
                ref = FA.flash_attention_reference(q, k, v, causal)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs()
                ok = bool((err <= atol + rtol * ref.float().abs()).all()) \
                    and bool(torch.isfinite(got).all())
                share = float((got == ref).float().mean())
                if dtype == torch.bfloat16:
                    ok &= share >= BWD_MIN_EQUAL_SHARE
                key = ("flash_fwd", name, dname)
                worst[key] = max(worst.get(key, 0.0), float(err.max()))
                log(f"[flash-kernel] fwd {head}: max_abs_err="
                    f"{float(err.max()):.3e} (tol {atol:g} + {rtol:g}*|ref|)"
                    f", bit-equal {share:.5f} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"heads-first forward kernel "
                                         f"disagrees at {head}")
                atol, rtol = TOLERANCE_BWD[dname]
                for keep in (False, True):
                    got = FA.flash_attention_bwd(q, k, v, do, causal, keep)
                    ref = FA.flash_attention_bwd_reference(q, k, v, do,
                                                           causal, keep)
                    torch.cuda.synchronize()
                    errs, shares = [], []
                    ok = True
                    for g, r in zip(got, ref):
                        err = (g.float() - r.float()).abs()
                        ok &= bool((err <= atol
                                    + rtol * r.float().abs()).all())
                        ok &= bool(torch.isfinite(g).all())
                        errs.append(float(err.max()))
                        shares.append(float((g == r).float().mean()))
                    if dtype == torch.bfloat16:
                        ok &= min(shares) >= BWD_MIN_EQUAL_SHARE
                    key = ("flash_bwd", name, dname)
                    worst[key] = max(worst.get(key, 0.0), *errs)
                    log(f"[flash-kernel] bwd keep_dtype={keep} {head}: "
                        f"max_abs_err dq={errs[0]:.3e} dk={errs[1]:.3e} "
                        f"dv={errs[2]:.3e} (tol {atol:g} + {rtol:g}*|ref|), "
                        f"bit-equal {'/'.join(f'{x:.5f}' for x in shares)} "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"heads-first backward kernel (keep_dtype="
                            f"{keep}) disagrees at {head}")
    return worst


def phase_flash_timing(smi):
    """The heads-first kernels and their plain versions on the towers'
    transposed views, in turns plain, kernel, kernel, plain; the backward of
    bwd='fused' against the packed-head backward on the same packed
    operands; and, as the yardstick for all four kernels, one
    scaled_dot_product_attention call (forward) and the gradient of one
    (backward) on the same views.  The library call is timed here and used
    nowhere in the port.  Launches made here are not counted."""
    import torch
    import torch.nn.functional as F

    from swat_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(5)
    times = {}
    for name, b, s, h, w, causal in KERNEL_SHAPES[:2]:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            q, k, v, do = _heads_first(b, s, h, w, dtype, gen, True, 4)
            head = f"{name} B={b} H={h} S={s} D={w // h} {dname}"

            def quad(kernel, plain):
                p1, k1, k2, p2 = (_time_ms(plain), _time_ms(kernel),
                                  _time_ms(kernel), _time_ms(plain))
                return ((k1 + k2) / 2, (p1 + p2) / 2,
                        f"runs {k1:.4f}/{k2:.4f} vs {p1:.4f}/{p2:.4f}")

            ms, plain_ms, runs = quad(
                lambda: FA.flash_attention_fwd(q, k, v, causal),
                lambda: FA.flash_attention_reference(q, k, v, causal))
            times[("flash_fwd", name, dname)] = (ms, plain_ms)
            log(f"[flash-timing] fwd {head}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms ({runs}) on {smi}")
            for keep in (False, True):
                ms, plain_ms, runs = quad(
                    lambda: FA.flash_attention_bwd(q, k, v, do, causal, keep),
                    lambda: FA.flash_attention_bwd_reference(q, k, v, do,
                                                             causal, keep))
                times[("flash_bwd", keep, name, dname)] = (ms, plain_ms)
                log(f"[flash-timing] bwd keep_dtype={keep} {head}: kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms ({runs}) on {smi}")
            # bwd='fused' against bwd='pallas': two kernels, one math
            pq, pk, pv, pdo = (t.transpose(1, 2).reshape(b, s, w)
                               for t in (q, k, v, do))
            fused, packed, runs = quad(
                lambda: FA._fused_bwd(pq, pk, pv, pdo, h, causal),
                lambda: FA.mha_packed_bwd(pq, pk, pv, pdo, h, causal))
            same = torch.equal(FA._fused_bwd(pq, pk, pv, pdo, h, causal),
                               FA.mha_packed_bwd(pq, pk, pv, pdo, h, causal))
            log(f"[flash-timing] bwd='fused' {head}: heads-first backward "
                f"{fused:.4f} ms, packed-head backward {packed:.4f} ms "
                f"({runs}), gradients bit-equal: {same} on {smi}")
            if not same:
                raise AssertionError(f"bwd='fused' and bwd='pallas' differ "
                                     f"at {head}")
            # the library's attention on the same views
            lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
            lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
            out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
            lib_bwd = _time_ms(lambda: torch.autograd.grad(
                out, (lq, lk, lv), do, retain_graph=True))
            ref = FA.flash_attention_reference(q, k, v, causal)
            lib_err = float((out.detach().float() - ref.float()).abs().max())
            times[("library", name, dname)] = (lib_fwd, lib_bwd)
            log(f"[flash-timing] library {head}: "
                f"scaled_dot_product_attention forward {lib_fwd:.4f} ms, "
                f"its gradient {lib_bwd:.4f} ms (forward + backward "
                f"{lib_fwd + lib_bwd:.4f} ms), max abs difference from the "
                f"plain forward {lib_err:.3e} on {smi}")
            bounds = [_bound_ms(kind, b, s, h, w // h, dname, causal)
                      for kind in ("fwd", "bwd")]
            log(f"[flash-timing] bound {head}: forward "
                f"{bounds[0][0]:.4f} ms ({bounds[0][1]}), backward "
                f"{bounds[1][0]:.4f} ms ({bounds[1][1]}) at "
                f"{HBM_BYTES_PER_S / 1e12:g} TB/s and "
                f"{PEAK_OPS_PER_S[dname] / 1e12:g} TFLOP/s")
            del out
    return times


MODEL_CFG = "vitb32_openclip_laion400m"
# kernel vs plain attention through all 12 layers of a tower: fp32 is the
# parity bar; in bf16 one flipped rounding per layer feeds the next layer
TOWER_MIN_COS = {"float32": 1 - 1e-5, "bfloat16": 1 - 1e-3}


def phase_towers(workdir, smi):
    """Seeded OpenCLIP-format ViT-B/32 state dict (saved for phase 6), then
    both full-width towers with the kernel and with plain attention."""
    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.models.clip import CLIPModel
    from swat_tpu_torch.models.configs import get_model_config

    cfg = get_model_config(MODEL_CFG)
    model = CLIPModel(cfg).init_random(torch.Generator().manual_seed(0))
    ckpt = f"{workdir}/{MODEL_CFG}_seed0.pt"
    torch.save(model.state_dict(), ckpt)
    model.cuda().eval()
    gen = torch.Generator().manual_seed(1)
    n_px = cfg.vision.image_size
    images = torch.randn(64, n_px, n_px, 3, generator=gen).cuda()
    ctx, vocab = cfg.text.context_length, cfg.text.vocab_size
    tokens = torch.zeros(64, ctx, dtype=torch.long)
    for i in range(64):
        n = 2 + i % (ctx - 3)
        tokens[i, 0] = vocab - 2
        tokens[i, 1:n] = torch.randint(1, vocab - 3, (n - 1,), generator=gen)
        tokens[i, n] = vocab - 1                     # EOT, the max id
    tokens = tokens.cuda()
    for dname, precision in (("float32", FP32_PRECISION),
                             ("bfloat16", DEFAULT_PRECISION)):
        precision.apply_backend_flags()
        model.precision = precision
        with torch.inference_mode():
            outs = {}
            for attn_name, attn in (("kernel", FA.mha_qkv),
                                    ("plain", FA.mha_qkv_reference)):
                outs[attn_name] = (
                    model.encode_image(images, normalize=True,
                                       attention=attn),
                    model.encode_text(tokens, normalize=True,
                                      attention=attn))
            torch.cuda.synchronize()
        for i, tower in enumerate(("image", "text")):
            got, ref = outs["kernel"][i], outs["plain"][i]
            if not (got.shape == (64, cfg.embed_dim)
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"{tower} tower output malformed")
            cos = float((got * ref).sum(-1).min())
            ok = cos >= TOWER_MIN_COS[dname]
            log(f"[towers] {MODEL_CFG} {tower} tower (12 layers, B=64) "
                f"{dname}: min cosine kernel vs plain = {cos:.8f} "
                f"(bound {TOWER_MIN_COS[dname]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tower} tower disagrees ({dname})")
        # the image tower's forward at the eval batch (256), kernel vs
        # plain attention, in turns plain, kernel, kernel, plain
        batch = images.repeat(4, 1, 1, 1)
        with torch.inference_mode():
            t = [_time_ms(lambda a=attn: model.encode_image(batch,
                                                            attention=a),
                          iters=5, warmup=1)
                 for attn in (FA.mha_qkv_reference, FA.mha_qkv,
                              FA.mha_qkv, FA.mha_qkv_reference)]
        log(f"[towers] {MODEL_CFG} image tower forward B=256 {dname}: "
            f"kernel attention {(t[1] + t[2]) / 2:.3f} ms, plain attention "
            f"{(t[0] + t[3]) / 2:.3f} ms ({256e3 * 2 / (t[1] + t[2]):.1f} "
            f"images/s with the kernel) on {smi}")
    del model
    torch.cuda.empty_cache()
    return ckpt


def _write_dataset(root, n_classes=10, n_test_per_class=30, seed=0):
    """<root>/smoke10: class-colored JPEGs of camera-like sizes, test.txt,
    a few-shot split and the metrics json the prompts come from."""
    import os

    import numpy as np
    from PIL import Image

    name = "smoke10"
    ddir = os.path.join(root, name)
    os.makedirs(os.path.join(ddir, "imgs"), exist_ok=True)
    rng = np.random.default_rng(seed)
    colors = rng.integers(30, 225, (n_classes, 3))
    for split, per_class, fewshot in (("test.txt", n_test_per_class, 0),
                                      ("fewshot4_seed1.txt", 4, 1)):
        lines = []
        for c in range(n_classes):
            for i in range(per_class):
                h, w = rng.integers(240, 400, 2)
                arr = (colors[c] + rng.integers(-40, 40, (h, w, 3))
                       ).clip(0, 255).astype(np.uint8)
                rel = f"imgs/{split[:4]}_{c}_{i}.jpg"
                Image.fromarray(arr).save(os.path.join(ddir, rel),
                                          quality=90)
                lines.append(f"{rel} {c} {fewshot}")
        with open(os.path.join(ddir, split), "w") as f:
            f.write("\n".join(lines) + "\n")
    metrics = {str(c): {"name": f"class {c}",
                        "most_common_name": f"thing number {c}"}
               for c in range(n_classes)}
    with open(os.path.join(ddir, f"{name}_metrics-LAION400M.json"), "w") as f:
        json.dump(metrics, f)
    with open(os.path.join(root, "config.yml"), "w") as f:
        f.write(f"dataset_path: {root}\nretrieved_path: {root}\n")
    return name, n_classes * n_test_per_class


def phase_cli(workdir, ckpt, smi):
    """The zero-shot slice through swat_tpu_torch.cli.main at full width,
    fp32 and bf16, resident and streaming eval.  LAUNCHES is set to 0 just
    before the four runs and read just after them."""
    import contextlib
    import io
    import math
    import re

    from swat_tpu_torch.cli.main import main as cli_main
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.models.configs import get_model_config

    cfg = get_model_config(MODEL_CFG)
    dataset, n_test = _write_dataset(workdir)
    runs = [(dt, res) for dt in ("float32", "bfloat16") for res in ("on", "off")]
    accs = {}
    FA.LAUNCHES = 0
    for dtype, resident in runs:
        before = FA.LAUNCHES
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_main(["--dataset", dataset, "--method", "zeroshot",
                      "--model_cfg", MODEL_CFG, "--checkpoint_path", ckpt,
                      "--config_yml", f"{workdir}/config.yml",
                      "--folder", f"{workdir}/output_{dtype}_{resident}",
                      "--compute_dtype", dtype, "--resident", resident,
                      "--recal_prompt", "--num_workers", "8",
                      "--device", "cuda"])
        out = buf.getvalue()
        summary = [ln for ln in out.splitlines()
                   if ln.startswith(f"{dataset},zeroshot,")]
        if len(summary) != 1:
            raise AssertionError(f"no summary line printed:\n{out[-2000:]}")
        acc = float(summary[0].split(",")[-1])
        if not (0.0 <= acc <= 100.0) or math.isnan(acc):
            raise AssertionError(f"bad accuracy in {summary[0]}")
        rate = re.search(r"Zero-shot validate: (\d+) images in ([\d.]+) s "
                         r"\(([\d.]+) images/s", out)
        launches = FA.LAUNCHES - before
        # one launch per layer per batch: prompts (10 rows, one text batch)
        # and the test split in batches of 256 (resident) or 128
        img_batches = math.ceil(n_test / (256 if resident == "on" else 128))
        need = cfg.text.layers + cfg.vision.layers * img_batches
        accs[(dtype, resident)] = acc
        log(f"[cli] {dtype} resident={resident}: {summary[0]} | validate "
            f"{rate.group(1)} images in {rate.group(2)} s = {rate.group(3)} "
            f"images/s (decode included) on {smi} | kernel launches "
            f"{launches} (need >= {need})")
        if launches < need:
            raise AssertionError("the main path did not go through the kernel")
    total = FA.LAUNCHES
    for dtype in ("float32", "bfloat16"):
        if accs[(dtype, "on")] != accs[(dtype, "off")]:
            raise AssertionError(f"resident and streaming disagree in {dtype}: "
                                 f"{accs[(dtype, 'on')]} vs "
                                 f"{accs[(dtype, 'off')]}")
    log(f"[cli] resident and streaming agree; {total} kernel launches in the "
        f"four runs")
    return total


TRAIN_BSZ = 256
# kernel vs plain attention, gradients of every visual tensor after one
# cutmix step's backward through 12 layers: fp32 differs in summation
# order; in bf16 a flipped rounding in one layer feeds every later one
GRAD_MIN_COS = {"float32": 1 - 1e-4, "bfloat16": 0.99}


def _device_split(prof, steps):
    """Device ms per step by kernel family from a torch.profiler run, and
    the largest kernels of the 'other' family."""
    from torch.autograd import DeviceType

    split = {"mha_fwd": 0.0, "mha_bwd": 0.0, "gemm": 0.0, "optimizer": 0.0,
             "other": 0.0}
    others = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = evt.key.lower()
        ms = evt.self_device_time_total / 1e3 / steps
        if "attention_fwd" in name:
            fam = "mha_fwd"
        elif "attention_bwd" in name:
            fam = "mha_bwd"
        # cuBLAS on Hopper names its GEMMs nvjet_*, older ones *gemm*
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma")):
            fam = "gemm"
        elif "adam" in name or "multi_tensor" in name:
            fam = "optimizer"
        else:
            fam = "other"
            others.append((ms, evt.key[:60]))
        split[fam] += ms
    return split, sorted(others, reverse=True)[:5]


def _train_setup(ckpt):
    """The full-width model from the seeded checkpoint, one batch of
    TRAIN_BSZ random uint8 canvases on the card, and a random head."""
    import numpy as np
    import torch

    from swat_tpu_torch.models.clip import CLIPModel
    from swat_tpu_torch.models.configs import get_model_config
    from swat_tpu_torch.train.steps import batch_to_device

    cfg = get_model_config(MODEL_CFG)
    model = CLIPModel(cfg)
    model.load_state_dict(torch.load(ckpt))
    model.cuda()
    rng = np.random.default_rng(0)
    n_classes = 10
    valid_hw = np.stack([rng.integers(160, 257, TRAIN_BSZ),
                         np.full(TRAIN_BSZ, 256)], axis=1)
    valid_hw[::2] = valid_hw[::2, ::-1]
    canvases = torch.from_numpy(rng.integers(
        0, 256, (TRAIN_BSZ, 256, 256, 3), dtype=np.uint8)).cuda()
    batch = batch_to_device(
        {"canvases": canvases,
         "labels": rng.integers(0, n_classes, TRAIN_BSZ),
         "source": rng.integers(0, 2, TRAIN_BSZ)}, torch.device("cuda"))
    batch["valid_hw"] = valid_hw
    head = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((n_classes, cfg.embed_dim)).astype(np.float32)),
        dim=-1)
    return cfg, model, batch, head, rng


def phase_train_step(ckpt, smi):
    """One full-width ViT-B/32 cutmix step at bsz 256 from uint8 canvases
    on the card (augment, cutmix, forward and backward, AdamW), fp32 and
    bf16: the visual gradients with the kernels against plain attention
    (autograd through mha_qkv_reference), then steps timed in turns
    plain, kernel, kernel, plain, then a profiler split of kernel steps
    with the device's idle share of the same profiled window.
    Launches made here are not counted for the main path."""
    import numpy as np
    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import (StepDraws, make_encode_loss,
                                            make_mix_fn, make_mixing_step,
                                            make_sampler)
    from swat_tpu_torch.train.losses import cross_entropy

    cfg, model, batch, head, rng = _train_setup(ckpt)
    n_px = cfg.vision.image_size
    sample = make_sampler("cutmix", mix_prob=1.0, image_size=n_px)
    results = {}
    for dname, precision in (("float32", FP32_PRECISION),
                             ("bfloat16", DEFAULT_PRECISION)):
        precision.apply_backend_flags()
        model.precision = precision
        state = create_train_state(model, head, "cutmix", total_iter=100)
        draws = sample(rng, batch)
        assert isinstance(draws, StepDraws) and draws.mix.gate
        mix = make_mix_fn("cutmix", image_size=n_px)
        grads = {}
        for attn_name, attn in (("kernel", FA.mha_qkv),
                                ("plain", FA.mha_qkv_reference)):
            state.optimizer.zero_grad(set_to_none=True)
            loss = make_encode_loss(cross_entropy, attn)(
                state, mix(state, batch, draws))
            loss.backward()
            grads[attn_name] = (loss.item(), {
                n: p.grad.detach().float().flatten().clone()
                for n, p in model.named_parameters() if p.grad is not None})
        (lk, gk), (lp, gp) = grads["kernel"], grads["plain"]
        if not (np.isfinite(lk) and len(gk) == len(gp) > 0):
            raise AssertionError(f"train step malformed ({dname})")
        cos = {n: float(torch.nn.functional.cosine_similarity(
            gk[n], gp[n], dim=0)) for n in gk if gp[n].abs().max() > 0}
        worst = min(cos, key=cos.get)
        ok = cos[worst] >= GRAD_MIN_COS[dname]
        log(f"[train-step] {MODEL_CFG} cutmix bsz {TRAIN_BSZ} {dname}: loss "
            f"kernel {lk:.6f} / plain {lp:.6f}; min cosine of {len(cos)} "
            f"visual grads kernel vs plain = {cos[worst]:.8f} ({worst}; "
            f"bound {GRAD_MIN_COS[dname]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"train-step gradients disagree ({dname})")
        del grads, gk, gp
        state.optimizer.zero_grad(set_to_none=True)

        steps = {a: make_mixing_step("cutmix", image_size=n_px, attention=f)
                 for a, f in (("kernel", FA.mha_qkv),
                              ("plain", FA.mha_qkv_reference))}

        def run(name):
            return steps[name](state, batch, draws)

        t = [_time_ms(lambda n=n: run(n), iters=5, warmup=1)
             for n in ("plain", "kernel", "kernel", "plain")]
        ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        log(f"[train-step] {dname}: kernel attention {ms:.2f} ms/step "
            f"({TRAIN_BSZ * 1e3 / ms:.1f} images/s), plain attention "
            f"{plain_ms:.2f} ms/step ({TRAIN_BSZ * 1e3 / plain_ms:.1f} "
            f"images/s); runs {t[1]:.2f}/{t[2]:.2f} vs {t[0]:.2f}/{t[3]:.2f} "
            f"on {smi}")
        # busy time (the kernels' device time in the trace) and the window
        # (CUDA events around the same steps) come from one run of steps
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(3):
                run("kernel")
            end.record()
            torch.cuda.synchronize()
        window = start.elapsed_time(end) / 3
        split, others = _device_split(prof, 3)
        busy = sum(split.values())
        parts = ", ".join(f"{k} {v:.2f} ({100 * v / max(busy, 1e-9):.1f} %)"
                          for k, v in split.items())
        log(f"[train-step] {dname} profile, device ms per kernel step: "
            f"{busy:.2f} busy of a {window:.2f} ms window (idle "
            f"{100 * (1 - busy / window):.1f} %; the same profiled steps) "
            f"({parts}) on {smi}; largest "
            f"'other': " + "; ".join(f"{t:.2f} {n}" for t, n in others))
        results[dname] = (ms, plain_ms, cos[worst], split)
        del state, steps
    del model
    torch.cuda.empty_cache()
    return results


def _plain_heads_first(qkv, heads, causal):
    """The towers' heads-first attention on the plain version of the
    heads-first forward (kernels.attention.heads_first_attention with
    flash_attention_reference in the kernel's place)."""
    from swat_tpu_torch.kernels import flash_attention as FA

    b, s, w3 = qkv.shape
    d = w3 // 3 // heads
    q, k, v = (t.reshape(b, s, heads, d).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    out = FA.flash_attention_reference(q, k, v, causal)
    return out.transpose(1, 2).reshape(b, s, heads * d)


def _reset_counts(FA):
    FA.LAUNCHES = FA.LAUNCHES_BWD = 0
    FA.LAUNCHES_FLASH = FA.LAUNCHES_FLASH_BWD = 0


def _counts(FA):
    return (FA.LAUNCHES, FA.LAUNCHES_BWD, FA.LAUNCHES_FLASH,
            FA.LAUNCHES_FLASH_BWD)


# heatmaps (cosines in [-1, 1]) with the heads-first kernel against its
# plain version through 12 layers: fp32 differs in summation order; in bf16
# a flipped rounding of a layer's output feeds every later layer
HEATMAP_ATOL = {"float32": 1e-4, "bfloat16": 5e-2}


def phase_attentive_step(ckpt, smi):
    """One full-width ViT-B/32 attentivemix step at bsz 256 from uint8
    canvases, fp32 and bf16: the heatmaps through the heads-first forward
    kernel (one launch a layer), forward and backward through the
    packed-head kernels.  Before it, the heatmaps with the kernel against
    its plain version, and the share of images whose peak cell agrees
    (reported; a near-tie may move a peak).  The four counts are set to 0
    just before the step and read just after."""
    import numpy as np
    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.eval.heatmap import clip_attention_heatmap
    from swat_tpu_torch.kernels import augment as aug
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import make_mixing_step, make_sampler

    cfg, model, batch, head, rng = _train_setup(ckpt)
    n_px, layers = cfg.vision.image_size, cfg.vision.layers
    sample = make_sampler("attentivemix", mix_prob=1.0, image_size=n_px)
    total = 0
    for dname, precision in (("float32", FP32_PRECISION),
                             ("bfloat16", DEFAULT_PRECISION)):
        precision.apply_backend_flags()
        model.precision = precision
        state = create_train_state(model, head, "attentivemix",
                                   total_iter=100)
        draws = sample(rng, batch)
        with torch.no_grad():
            images = aug.train_augment(batch["canvases"], draws.crops, n_px)
            got = clip_attention_heatmap(model, images)
            ref = clip_attention_heatmap(model, images,
                                         attention=_plain_heads_first)
            torch.cuda.synchronize()
        grid = n_px // cfg.vision.patch_size
        if got.shape != (TRAIN_BSZ, grid, grid) or not bool(
                torch.isfinite(got).all()):
            raise AssertionError(f"heatmaps malformed ({dname})")
        err = float((got - ref).abs().max())
        peaks = float((got.flatten(1).argmax(-1)
                       == ref.flatten(1).argmax(-1)).float().mean())
        ok = err <= HEATMAP_ATOL[dname]
        log(f"[attentive-step] {MODEL_CFG} heatmaps [{TRAIN_BSZ}, {grid}, "
            f"{grid}] {dname}: heads-first kernel vs plain max_abs_err="
            f"{err:.3e} (tol {HEATMAP_ATOL[dname]:g}), peak cell agrees in "
            f"{100 * peaks:.1f} % of images {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"heatmaps disagree ({dname})")
        step = make_mixing_step(
            "attentivemix", image_size=n_px,
            heatmap_fn=lambda m, x, y: clip_attention_heatmap(m, x))
        _reset_counts(FA)
        loss = step(state, batch, draws)
        torch.cuda.synchronize()
        counts = _counts(FA)
        ms = _time_ms(lambda: step(state, batch, draws), iters=3, warmup=0)
        log(f"[attentive-step] {dname}: loss {float(loss):.6f} (summed over "
            f"the batch), launches fwd {counts[0]} bwd {counts[1]} "
            f"heads-first fwd {counts[2]} heads-first bwd {counts[3]} (need "
            f"{layers}, {layers}, {layers}, 0); {ms:.2f} ms/step "
            f"({TRAIN_BSZ * 1e3 / ms:.1f} images/s) on {smi}")
        if not np.isfinite(float(loss)) or counts != (layers, layers,
                                                      layers, 0):
            raise AssertionError(f"attentivemix step did not go through the "
                                 f"kernels as expected ({dname}): {counts}")
        total += counts[2]
        del state, step
    del model
    torch.cuda.empty_cache()
    return total


def phase_fused_step(ckpt, smi):
    """One full-width ViT-B/32 cutmix step at bsz 256 with bwd='fused' (the
    packed-head forward, the heads-first backward kernel in its keep-dtype
    form as its gradient), fp32 and bf16: the visual gradients against
    bwd='pallas', then the step itself with the counts set to 0 just before
    it and read just after."""
    import numpy as np
    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.train.losses import cross_entropy
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import (make_encode_loss, make_mix_fn,
                                            make_mixing_step, make_sampler)

    def fused(qkv, heads, causal):
        return FA.mha_qkv(qkv, heads, causal, "fused")

    cfg, model, batch, head, rng = _train_setup(ckpt)
    n_px, layers = cfg.vision.image_size, cfg.vision.layers
    sample = make_sampler("cutmix", mix_prob=1.0, image_size=n_px)
    mix = make_mix_fn("cutmix", image_size=n_px)
    total = 0
    for dname, precision in (("float32", FP32_PRECISION),
                             ("bfloat16", DEFAULT_PRECISION)):
        precision.apply_backend_flags()
        model.precision = precision
        state = create_train_state(model, head, "cutmix", total_iter=100)
        draws = sample(rng, batch)
        grads = {}
        for attn_name, attn in (("fused", fused), ("pallas", FA.mha_qkv)):
            state.optimizer.zero_grad(set_to_none=True)
            loss = make_encode_loss(cross_entropy, attn)(
                state, mix(state, batch, draws))
            loss.backward()
            grads[attn_name] = (loss.item(), {
                n: p.grad.detach().float().flatten().clone()
                for n, p in model.named_parameters() if p.grad is not None})
        (lf, gf), (lp, gp) = grads["fused"], grads["pallas"]
        cos = {n: float(torch.nn.functional.cosine_similarity(
            gf[n], gp[n], dim=0)) for n in gf if gp[n].abs().max() > 0}
        worst = min(cos, key=cos.get)
        equal = sum(bool(torch.equal(gf[n], gp[n])) for n in gf)
        ok = lf == lp and cos[worst] >= GRAD_MIN_COS[dname]
        log(f"[fused-step] {MODEL_CFG} cutmix bsz {TRAIN_BSZ} {dname}: loss "
            f"fused {lf:.6f} / pallas {lp:.6f}; min cosine of {len(cos)} "
            f"visual grads bwd='fused' vs bwd='pallas' = {cos[worst]:.8f} "
            f"({worst}; bound {GRAD_MIN_COS[dname]}), {equal} of {len(gf)} "
            f"tensors bit-equal {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"bwd='fused' gradients disagree ({dname})")
        del grads, gf, gp
        state.optimizer.zero_grad(set_to_none=True)
        step = make_mixing_step("cutmix", image_size=n_px, attention=fused)
        _reset_counts(FA)
        loss = step(state, batch, draws)
        torch.cuda.synchronize()
        counts = _counts(FA)
        ms = _time_ms(lambda: step(state, batch, draws), iters=3, warmup=0)
        log(f"[fused-step] {dname}: loss {float(loss):.6f}, launches fwd "
            f"{counts[0]} bwd {counts[1]} heads-first fwd {counts[2]} "
            f"heads-first bwd {counts[3]} (need {layers}, 0, 0, {layers}); "
            f"{ms:.2f} ms/step ({TRAIN_BSZ * 1e3 / ms:.1f} images/s) on "
            f"{smi}")
        if not np.isfinite(float(loss)) or counts != (layers, 0, 0, layers):
            raise AssertionError(f"bwd='fused' step did not go through the "
                                 f"heads-first backward ({dname}): {counts}")
        total += counts[3]
        del state, step
    del model
    torch.cuda.empty_cache()
    return total


def _write_retrieved(root, dataset, n_per_class, n_classes=10, seed=1):
    """A retrieved split beside the smoke dataset's few-shot and test
    splits (retrieved data lives under retrieved_path/<dataset>)."""
    import os

    import numpy as np
    from PIL import Image

    ddir = os.path.join(root, dataset)
    rng = np.random.default_rng(seed)
    colors = np.random.default_rng(0).integers(30, 225, (n_classes, 3))
    lines = []
    for c in range(n_classes):
        for i in range(n_per_class):
            h, w = rng.integers(240, 400, 2)
            arr = (colors[c] + rng.integers(-40, 40, (h, w, 3))
                   ).clip(0, 255).astype(np.uint8)
            rel = f"imgs/retr_{c}_{i}.jpg"
            Image.fromarray(arr).save(os.path.join(ddir, rel), quality=90)
            lines.append(f"{rel} {c} 0")
    with open(os.path.join(ddir, RETRIEVAL_SPLIT), "w") as f:
        f.write("\n".join(lines) + "\n")
    return n_classes * n_per_class


RETRIEVAL_SPLIT = "retrieved_smoke.txt"
CLI_BSZ = 64


def _train_cli_run(workdir, ckpt, dataset, method, dtype, resident, smi,
                   extra=()):
    """One stage-1 run of ``method`` through swat_tpu_torch.cli.main at full
    width (2 epochs at bsz CLI_BSZ, --skip_stage2), its summary line,
    loss.csv and output files checked.  The four counts are set to 0 just
    before the run and read just after -> (counts, steps)."""
    import contextlib
    import csv
    import io
    import math
    import os
    import re

    from swat_tpu_torch.cli.main import main as cli_main
    from swat_tpu_torch.kernels import flash_attention as FA

    folder = f"{workdir}/train_{method}_{dtype}_{resident}"
    _reset_counts(FA)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(["--dataset", dataset, "--method", method,
                  "--data_source", "fewshot+retrieved",
                  "--retrieval_split", RETRIEVAL_SPLIT,
                  "--shots", "4", "--epochs", "2", "--skip_stage2",
                  "--bsz", str(CLI_BSZ), "--model_cfg", MODEL_CFG,
                  "--checkpoint_path", ckpt,
                  "--config_yml", f"{workdir}/config.yml",
                  "--folder", folder, "--compute_dtype", dtype,
                  "--resident", resident, "--num_workers", "8",
                  "--recal_prompt", "--device", "cuda", *extra])
    counts = _counts(FA)
    out = buf.getvalue()
    summary = [ln for ln in out.splitlines()
               if ln.startswith(f"{dataset},{method},")]
    if len(summary) != 1 or len(summary[0].split(",")) != 11:
        raise AssertionError(f"no 11-field summary line:\n{out[-2000:]}")
    accs = [float(x) for x in summary[0].split(",")[7:]]
    if not all(0.0 <= a <= 100.0 for a in accs[:2]) or \
            accs[2:] != [-1.0, -1.0]:
        raise AssertionError(f"bad accuracies in {summary[0]}")
    (run_dir,) = [r for r, _, files in os.walk(folder)
                  if "loss.csv" in files]
    with open(os.path.join(run_dir, "loss.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["Train_loss"]) for r in rows]
    if len(rows) != 2 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"loss.csv malformed: {rows}")
    files = sorted(os.listdir(run_dir))
    want = ["stage1_test_confusion_matrix.npy", "stage1_test_scores.json",
            "stage1_val_confusion_matrix_best.npy",
            "stage1_val_scores_best.json"]
    bundles = [f for f in files if re.fullmatch(
        r"stage1_model_best-epoch_\d+_best\.pt(\.json)?", f)]
    missing = [w for w in want if w not in files]
    if missing or len(bundles) != 2:
        raise AssertionError(f"stage-1 outputs missing: {missing} "
                             f"(bundle files {bundles})")
    resident_run = "resident epochs" in out
    rate = re.findall(r"Epoch \d+, Iter \d+, .*?, (\d+) img/s", out)
    steps = len(rows) * ((40 + 220) // CLI_BSZ)
    log(f"[train-cli] {method} {dtype} resident={resident}"
        f"{' (resident epochs)' if resident_run else ' (streaming)'}: "
        f"{summary[0]} | train loss {losses[0]:.6f} -> {losses[1]:.6f} | "
        f"{steps} steps at bsz {CLI_BSZ}, epoch rates {'/'.join(rate)} "
        f"images/s (host clock, decode included when streaming) on {smi} | "
        f"kernel launches fwd {counts[0]} bwd {counts[1]} heads-first fwd "
        f"{counts[2]} heads-first bwd {counts[3]}")
    return counts, steps, resident_run


def phase_train_cli(workdir, ckpt, dataset, smi):
    """Stage-1 finetuning through swat_tpu_torch.cli.main at full width:
    cutmix in fp32 with resident train data, fp32 streaming and bf16
    resident; attentivemix (streaming, its heatmaps through the heads-first
    forward at every step: --mix_prob 1) and mixup (resident) in fp32.
    -> the four counts summed over the runs, each run counted from 0."""
    from swat_tpu_torch.models.configs import get_model_config

    layers = get_model_config(MODEL_CFG).vision.layers
    _write_retrieved(workdir, dataset, 22)
    total = [0, 0, 0, 0]
    runs = [("cutmix", "float32", "auto", (), True),
            ("cutmix", "float32", "off", (), False),
            ("cutmix", "bfloat16", "auto", (), True),
            ("attentivemix", "float32", "auto", ("--mix_prob", "1.0"), False),
            ("mixup", "float32", "auto", (), True)]
    for method, dtype, resident, extra, want_resident in runs:
        counts, steps, resident_run = _train_cli_run(
            workdir, ckpt, dataset, method, dtype, resident, smi, extra)
        need = layers * steps
        need_flash = need if method == "attentivemix" else 0
        log(f"[train-cli] {method}: need >= {need} fwd and bwd, "
            f"{need_flash} heads-first fwd, 0 heads-first bwd")
        if (counts[0] < need or counts[1] < need or counts[2] != need_flash
                or counts[3] != 0):
            raise AssertionError(f"stage-1 {method} training did not go "
                                 f"through the attention kernels: {counts}")
        if resident_run != want_resident:
            raise AssertionError(f"{method} resident={resident}: resident "
                                 f"epochs {resident_run}, expected "
                                 f"{want_resident}")
        total = [t + c for t, c in zip(total, counts)]
    return total


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs a GPU",
              file=sys.stderr)
        return 1
    try:
        import swat_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: swat_tpu_torch not found; run it from the root "
              "of the repository", file=sys.stderr)
        return 1

    import tempfile

    smi, name = phase_card()
    phase_build()
    worst = phase_kernel_vs_plain()
    times = phase_timing(smi)
    worst_bwd = phase_bwd_kernel_vs_plain()
    times_bwd = phase_bwd_timing(smi)
    worst_flash = phase_flash_kernels_vs_plain()
    times_flash = phase_flash_timing(smi)
    with tempfile.TemporaryDirectory(prefix="swat_smoke_") as workdir:
        ckpt = phase_towers(workdir, smi)
        launches = phase_cli(workdir, ckpt, smi)
        phase_train_step(ckpt, smi)
        step_flash = phase_attentive_step(ckpt, smi)
        step_flash_bwd = phase_fused_step(ckpt, smi)
        cli_counts = phase_train_cli(workdir, ckpt, "smoke10", smi)
    # each kernel at the CLI default (fp32) and the B/32 image shape
    # (B=256, H=12, S=50, D=64).  launches: the zero-shot runs, the stage-1
    # runs and the train-step phases that drive a kernel's path, each
    # counted from 0.  The heads-first backward is reached through
    # bwd='fused' (the train-step phase); no flag of the CLI selects it, as
    # in the JAX package.
    shape = ("vitb32_image", "float32")
    _, b, s, h, w, causal = KERNEL_SHAPES[0]
    lib_fwd, lib_bwd = times_flash[("library", *shape)]

    def entry(name, source, line, kind, n_launches, err, ms_pair, lib):
        bound, by = _bound_ms(kind, b, s, h, w // h, "float32", causal)
        return {"name": name, "route": "cuda",
                "source": f"swat_tpu_torch/csrc/{source}",
                "replaces": f"swat_tpu/kernels/flash_attention.py:{line}",
                "launches": n_launches, "max_abs_err": err,
                "ms": ms_pair[0], "plain_ms": ms_pair[1], "bound_ms": bound,
                "bound_by": by, "library_ms": lib}

    kernels = [
        entry("mha_fwd", "mha_fwd.cu", 159, "fwd", launches + cli_counts[0],
              worst[shape], times[shape], lib_fwd),
        entry("mha_bwd", "mha_bwd.cu", 187, "bwd", cli_counts[1],
              worst_bwd[shape], times_bwd[shape], lib_bwd),
        entry("flash_fwd", "flash_fwd.cu", 39, "fwd",
              step_flash + cli_counts[2], worst_flash[("flash_fwd", *shape)],
              times_flash[("flash_fwd", *shape)], lib_fwd),
        entry("flash_bwd", "flash_bwd.cu", 61, "bwd", step_flash_bwd,
              worst_flash[("flash_bwd", *shape)],
              times_flash[("flash_bwd", False, *shape)], lib_bwd)]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was launched no time on its "
                                 f"path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
