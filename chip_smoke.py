#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``swat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each: the card; the CUDA kernels' build; the attention
forward kernel and the backward kernel against their plain PyTorch versions
at the main path's shapes, and their timings; the full-width ViT-B/32
towers with and without the kernels; zero-shot classification through
``swat_tpu_torch.cli.main``; one full-width ViT-B/32 cutmix train step,
kernel against plain attention, timed and profiled; and stage-1 cutmix
finetuning through ``swat_tpu_torch.cli.main``.  The data are a synthetic
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
        if "mha_fwd" in name:
            fam = "mha_fwd"
        elif "mha_bwd" in name:
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
    from swat_tpu_torch.models.clip import CLIPModel
    from swat_tpu_torch.models.configs import get_model_config
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import (StepDraws, batch_to_device,
                                            make_encode_loss, make_mix_fn,
                                            make_mixing_step, make_sampler)
    from swat_tpu_torch.train.losses import cross_entropy

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
                state, mix(batch, draws))
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


def phase_train_cli(workdir, ckpt, dataset, smi):
    """Stage-1 cutmix finetuning through swat_tpu_torch.cli.main at full
    width: fp32 with resident train data, fp32 streaming, bf16 resident.
    LAUNCHES and LAUNCHES_BWD are set to 0 just before each run and read
    just after it."""
    import contextlib
    import csv
    import io
    import math
    import os
    import re

    from swat_tpu_torch.cli.main import main as cli_main
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.models.configs import get_model_config

    cfg = get_model_config(MODEL_CFG)
    n_train = 40 + _write_retrieved(workdir, dataset, 22)
    steps = 2 * (n_train // CLI_BSZ)
    need = cfg.vision.layers * steps
    total = [0, 0]
    for dtype, resident in (("float32", "auto"), ("float32", "off"),
                            ("bfloat16", "auto")):
        folder = f"{workdir}/train_{dtype}_{resident}"
        FA.LAUNCHES = FA.LAUNCHES_BWD = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_main(["--dataset", dataset, "--method", "cutmix",
                      "--data_source", "fewshot+retrieved",
                      "--retrieval_split", RETRIEVAL_SPLIT,
                      "--shots", "4", "--epochs", "2", "--skip_stage2",
                      "--bsz", str(CLI_BSZ), "--model_cfg", MODEL_CFG,
                      "--checkpoint_path", ckpt,
                      "--config_yml", f"{workdir}/config.yml",
                      "--folder", folder, "--compute_dtype", dtype,
                      "--resident", resident, "--num_workers", "8",
                      "--recal_prompt", "--device", "cuda"])
        fwd, bwd = FA.LAUNCHES, FA.LAUNCHES_BWD
        total[0] += fwd
        total[1] += bwd
        out = buf.getvalue()
        summary = [ln for ln in out.splitlines()
                   if ln.startswith(f"{dataset},cutmix,")]
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
        want = ["stage1_model_best-epoch_2_best.pt",
                "stage1_model_best-epoch_2_best.pt.json",
                "stage1_test_confusion_matrix.npy",
                "stage1_test_scores.json",
                "stage1_val_confusion_matrix_best.npy",
                "stage1_val_scores_best.json"]
        missing = [w for w in want if w not in files]
        if missing:
            raise AssertionError(f"stage-1 outputs missing: {missing}")
        rate = re.findall(r"Epoch \d+, Iter \d+, .*?, (\d+) img/s", out)
        log(f"[train-cli] {dtype} resident={resident}: {summary[0]} | train "
            f"loss {losses[0]:.6f} -> {losses[1]:.6f} | {steps} steps at bsz "
            f"{CLI_BSZ}, epoch rates {'/'.join(rate)} images/s (host clock, "
            f"decode included when streaming) on {smi} | kernel launches "
            f"fwd {fwd} bwd {bwd} (need >= {need} each)")
        if fwd < need or bwd < need:
            raise AssertionError("stage-1 training did not go through the "
                                 "attention kernels")
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
    with tempfile.TemporaryDirectory(prefix="swat_smoke_") as workdir:
        ckpt = phase_towers(workdir, smi)
        launches = phase_cli(workdir, ckpt, smi)
        phase_train_step(ckpt, smi)
        train_fwd, train_bwd = phase_train_cli(workdir, ckpt, "smoke10", smi)
    # the CLI default (fp32) at the B/32 image shape; launches: the
    # zero-shot runs and the stage-1 runs, each counted from 0
    ms, plain_ms = times[("vitb32_image", "float32")]
    ms_bwd, plain_ms_bwd = times_bwd[("vitb32_image", "float32")]
    print(json.dumps({"kernels": [{
        "name": "mha_fwd", "route": "cuda",
        "source": "swat_tpu_torch/csrc/mha_fwd.cu",
        "replaces": "swat_tpu/kernels/flash_attention.py:159",
        "launches": launches + train_fwd,
        "max_abs_err": worst[("vitb32_image", "float32")],
        "ms": ms, "plain_ms": plain_ms}, {
        "name": "mha_bwd", "route": "cuda",
        "source": "swat_tpu_torch/csrc/mha_bwd.cu",
        "replaces": "swat_tpu/kernels/flash_attention.py:187",
        "launches": train_bwd,
        "max_abs_err": worst_bwd[("vitb32_image", "float32")],
        "ms": ms_bwd, "plain_ms": plain_ms_bwd}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
