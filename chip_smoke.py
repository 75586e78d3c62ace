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
cutmix train step with the heads-first backward (``bwd="fused"``); the
flagship SWAT run through ``swat_tpu_torch.cli.main`` (stage-1 cutmix,
WiSE-FT, tau-norm, stage-2 probing on the few-shot snapshot features and
few-shot finetuning, its time by stage and its stage-2 launches), stage 2
alone from its stage-1 bundle (``--skip_stage1``), ``--save_ckpt`` then
``--resume``, and stage-1 finetuning with cutmix (streaming, bf16, the host
PIL transform), attentivemix and mixup; then the three block-fused layer
kernels (block
forward, MLP backward, attention backward) against their plain versions and
timed beside their bounds and a library-built block, both full-width towers
through ``use_mega``, and a full-width cutmix train step whose image tower
runs through them.  The data are a synthetic
JPEG dataset (few-shot, retrieved and test splits) and a seeded
OpenCLIP-format checkpoint.  Any failure raises and exits non-zero.  The
last line is a JSON object naming the device.  Without a GPU, or without
the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
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
# the forwards' one rounding point below fp32 is p: rounded to bf16 before
# p.v (packed-head) or not (heads-first).  Two ulps cannot tell the two
# apart either; the share can: a forward is bit-equal to its own plain
# version in FWD_MIN_EQUAL_SHARE of a bf16 output and to the other's in at
# most FWD_MAX_OTHER_SHARE (measured 0.58-0.61 on an H100)
FWD_MIN_EQUAL_SHARE = 0.99
FWD_MAX_OTHER_SHARE = 0.9


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


def _product_blocks(regs, dtype, a_kcontig, b_kcontig):
    """(shared-memory bytes, blocks an SM) of one instantiation of the block
    kernels' tensor-core product: the fewer of what its registers allow
    (65,536 a SM, allocated 256 a warp) and what its shared memory allows
    (233,472 bytes a SM, 1,024 reserved a block)."""
    from swat_tpu_torch.kernels import megablock as MB

    smem = MB.product_smem_bytes(dtype, a_kcontig, b_kcontig)
    warps = MB._WARPS[dtype][0] * MB._WARPS[dtype][1]
    warp_regs = -(-regs * 32 // 256) * 256
    return smem, min(65536 // (warp_regs * warps), 233472 // (smem + 1024))


def _ptxas_report(log_path):
    """ptxas' registers and spill bytes by kernel from the build's log ->
    (the forward attention template's instantiations of mha_fwd.cu and
    flash_fwd.cu as 'kernel type/DP/NT=registers+spill bytes', every
    instantiation of the backward attention template as 'source
    type/DP/rounding/kernel=registers+spill bytes', every instantiation of
    the block kernels' tensor-core product as 'source type/AB/epilogue=
    registers+spill bytes (shared KB, blocks an SM)' (A, B: k- or
    i-contiguous), the most registers of the other kernels by source, the
    spill bytes of all kernels)."""
    import re

    import torch

    fwd, bwd, other, spills, spilled = [], [], {}, 0, 0
    products = []
    source = entry = None
    with open(log_path) as f:
        for ln in f:
            m = re.search(r"csrc/(\w+)\.cu$", ln.strip())
            if m and " -c " in ln:
                source = m.group(1)
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            if m:
                spilled = int(m.group(1)) + int(m.group(2))
                spills += spilled
            m = re.search(r"Used (\d+) registers", ln)
            if not (m and entry):
                continue
            regs = f"{m.group(1)}{f'+{spilled}B' if spilled else ''}"
            t = re.search(r"attention_fwd_kernelI(13__nv_bfloat16|f)Li(\d+)E"
                          r"Lb[01]ELi(\d+)ELb([01])E", entry)
            u = re.search(r"attention_bwd_(head|dq|dkv)_kernelI"
                          r"(13__nv_bfloat16|f)Li(\d+)ELb([01])E(S\d*_|f)"
                          r"(?:Li(\d+)E)?E", entry)
            p = re.search(r"mma_gemm_kernelI(13__nv_bfloat16|f)Lb([01])E"
                          r"Lb([01])E.*?\d+(Epi[A-Za-z0-9]*?)(?:I|E)", entry)
            if p:
                dtype = torch.float32 if p.group(1) == "f" else torch.bfloat16
                smem, blocks = _product_blocks(int(m.group(1)), dtype,
                                               p.group(2) == "1",
                                               p.group(3) == "1")
                products.append(
                    f"{source} {'fp32' if p.group(1) == 'f' else 'bf16'}/"
                    f"{'ik'[int(p.group(2))]}{'ik'[int(p.group(3))]}/"
                    f"{p.group(4)}={regs} ({smem / 1024:.1f} KB, {blocks} "
                    f"an SM)")
            elif t and source in ("mha_fwd", "flash_fwd"):
                fwd.append(f"{source} {'bf16' if t.group(1) != 'f' else 'fp32'}"
                           f"/{t.group(2)}/{t.group(3)}"
                           f"{'s' if t.group(4) == '1' else ''}={regs}")
            elif u:
                bwd.append(f"{source} {'bf16' if u.group(2) != 'f' else 'fp32'}"
                           f"/{u.group(3)}/{'round' if u.group(4) == '1' else 'keep'}"
                           f"/{u.group(1)}{u.group(6) or ''}={regs}")
            elif not t:
                other[source] = max(other.get(source, 0), int(m.group(1)))
            entry = None
    return fwd, bwd, products, other, spills


def phase_build():
    from swat_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load()
    secs = time.perf_counter() - t0
    fwd, bwd, products, other, spills = _ptxas_report(
        lib_path.replace(_build.LIB_NAME, "build.log"))
    log(f"[build] {lib_path} ({len(_build.SOURCES)} sources) in {secs:.2f} s; "
        f"ptxas registers of the forward attention template "
        f"(type/DP/NT; s: rows shared by several warps; +nB: bytes spilled, "
        f"stores and loads): {', '.join(fwd)}; "
        f"of the backward attention template (type/DP/pb and ds rounded or "
        f"kept/kernel: head4, head5, head8 = one block a head with that many "
        f"row tiles, dq and dkv = the pair for longer rows): "
        f"{', '.join(bwd)}; "
        f"of the block kernels' tensor-core product (type/A B k- or "
        f"i-contiguous/epilogue, shared memory, blocks an SM): "
        f"{', '.join(products)}; "
        f"most registers of the other kernels by source: "
        f"{', '.join(f'{k} {v}' for k, v in sorted(other.items()))}; "
        f"spill bytes over all kernels: {spills}")
    if not fwd:
        raise AssertionError("no forward attention kernel in the build log")
    if not any(b.startswith(("mha_bwd", "flash_bwd")) for b in bwd):
        raise AssertionError("no backward attention kernel in the build log")
    if not products:
        raise AssertionError("no tensor-core product in the build log")
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
    """Every main-path shape, fp32 and bf16, contiguous and strided; in
    bf16 the output must also be bit-equal to the plain version in
    FWD_MIN_EQUAL_SHARE of its elements, and to the plain version that does
    not round p in at most FWD_MAX_OTHER_SHARE."""
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
                other = FA.flash_attention_reference(
                    *(FA._heads_view(t, h) for t in (q, k, v)),
                    causal).transpose(1, 2).reshape(b, s, w)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs()
                bound = atol + rtol * ref.float().abs()
                ok = bool((err <= bound).all()) and bool(
                    torch.isfinite(got).all())
                share = float((got == ref).float().mean())
                share_other = float((got == other).float().mean())
                if dtype == torch.bfloat16:
                    ok &= (share >= FWD_MIN_EQUAL_SHARE
                           and share_other <= FWD_MAX_OTHER_SHARE)
                max_err = float(err.max())
                worst[(name, dname)] = max(worst.get((name, dname), 0.0),
                                           max_err)
                log(f"[kernel] {name} B={b} S={s} H={h} HD={w} "
                    f"causal={causal} {dname} "
                    f"{'strided' if strided else 'contiguous'}: "
                    f"max_abs_err={max_err:.3e} "
                    f"(tol {atol:g} + {rtol:g}*|ref|), bit-equal "
                    f"{share:.5f}, to the plain version with p unrounded "
                    f"{share_other:.5f}"
                    f"{f' (need >= {FWD_MIN_EQUAL_SHARE} and <= {FWD_MAX_OTHER_SHARE})' if dtype == torch.bfloat16 else ''} "
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


def _against(ms, bound, library_ms):
    """How a kernel's time stands: its bound's share of it, and its factor
    against the library call."""
    return (f"bound {bound[0]:.4f} ms ({bound[1]}) = {100 * bound[0] / ms:.1f}"
            f" % of the kernel's time, library {library_ms:.4f} ms: the "
            f"kernel takes {ms / library_ms:.2f}x the library call")


def phase_timing(smi):
    """Kernel and plain version on the same strided inputs, in turns
    plain, kernel, kernel, plain, beside the call's bound and one
    scaled_dot_product_attention call on the heads-first views of the same
    inputs (the yardstick; the port calls it nowhere); launches made here
    are not counted."""
    import torch
    import torch.nn.functional as F

    from swat_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(1)
    times = {}
    for name, b, s, h, w, causal in KERNEL_SHAPES:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            q, k, v = _qkv(b, s, w, dtype, gen, strided=True)
            views = [FA._heads_view(t, h) for t in (q, k, v)]

            def kernel():
                FA.mha_packed_fwd(q, k, v, h, causal)

            def plain():
                FA.mha_packed_reference(q, k, v, h, causal)

            def library():
                F.scaled_dot_product_attention(*views, is_causal=causal)

            p1, k1, l1, k2, p2 = (_time_ms(plain), _time_ms(kernel),
                                  _time_ms(library), _time_ms(kernel),
                                  _time_ms(plain))
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            times[(name, dname)] = (ms, plain_ms)
            bound = _bound_ms("fwd", b, s, h, w // h, dname, causal)
            log(f"[timing] {name} B={b} S={s} H={h} HD={w} {dname}: "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"(runs {k1:.4f}/{k2:.4f} vs {p1:.4f}/{p2:.4f}), "
                f"{_against(ms, bound, l1)} on {smi}")
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


def _library_gradient(q, k, v, do, causal):
    """The gradient of one scaled_dot_product_attention call on heads-first
    views -> (ms, the name of the library's backward kernel by
    torch.profiler): the yardstick of the backward kernels, used nowhere in
    the port."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType

    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)

    def grad():
        torch.autograd.grad(out, (lq, lk, lv), do, retain_graph=True)

    ms = _time_ms(grad)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        grad()
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    return ms, kernels[0][1][:120] if kernels else "not traced"


def phase_bwd_timing(smi):
    """The backward kernel and mha_bwd_reference on the same strided
    inputs, in turns plain, kernel, kernel, plain, at every shape, beside
    the call's bound and the gradient of one scaled_dot_product_attention
    call on the heads-first views of the same inputs."""
    import torch

    from swat_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(3)
    times = {}
    for name, b, s, h, w, causal in KERNEL_SHAPES:
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
            lib_ms, lib_name = _library_gradient(
                *(FA._heads_view(t, h) for t in (q, k, v, do)), causal)
            bound = _bound_ms("bwd", b, s, h, w // h, dname, causal)
            log(f"[bwd-timing] {name} B={b} S={s} H={h} HD={w} {dname}: "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"(runs {k1:.4f}/{k2:.4f} vs {p1:.4f}/{p2:.4f}), "
                f"{_against(ms, bound, lib_ms)}; the library's backward "
                f"kernel: {lib_name} on {smi}")
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
                # the plain version that rounds p: the packed-head one
                other = FA._heads_view(FA.mha_packed_reference(
                    *(t.transpose(1, 2).reshape(b, s, w) for t in (q, k, v)),
                    h, causal), h)
                share_other = float((got == other).float().mean())
                if dtype == torch.bfloat16:
                    ok &= (share >= FWD_MIN_EQUAL_SHARE
                           and share_other <= FWD_MAX_OTHER_SHARE)
                key = ("flash_fwd", name, dname)
                worst[key] = max(worst.get(key, 0.0), float(err.max()))
                log(f"[flash-kernel] fwd {head}: max_abs_err="
                    f"{float(err.max()):.3e} (tol {atol:g} + {rtol:g}*|ref|)"
                    f", bit-equal {share:.5f}, to the plain version with p "
                    f"rounded {share_other:.5f}"
                    f"{f' (need >= {FWD_MIN_EQUAL_SHARE} and <= {FWD_MAX_OTHER_SHARE})' if dtype == torch.bfloat16 else ''} "
                    f"{'ok' if ok else 'FAIL'}")
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
    from torch.autograd import DeviceType

    from swat_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(5)
    times = {}
    for name, b, s, h, w, causal in KERNEL_SHAPES:
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
            fwd_ms, fwd_runs = ms, runs
            lib_bwd, lib_bwd_name = _library_gradient(q, k, v, do, causal)
            bounds = [_bound_ms(kind, b, s, h, w // h, dname, causal)
                      for kind in ("fwd", "bwd")]
            for keep in (False, True):
                ms, plain_ms, runs = quad(
                    lambda: FA.flash_attention_bwd(q, k, v, do, causal, keep),
                    lambda: FA.flash_attention_bwd_reference(q, k, v, do,
                                                             causal, keep))
                times[("flash_bwd", keep, name, dname)] = (ms, plain_ms)
                log(f"[flash-timing] bwd keep_dtype={keep} {head}: kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms ({runs}), "
                    f"{_against(ms, bounds[1], lib_bwd)} on {smi}")
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
            lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
            out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
            ref = FA.flash_attention_reference(q, k, v, causal)
            lib_err = float((out.float() - ref.float()).abs().max())
            times[("library", name, dname)] = (lib_fwd, lib_bwd)
            # what the library runs for this type (the name says whether an
            # fp32 call goes through the tensor cores)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                F.scaled_dot_product_attention(q, k, v, is_causal=causal)
                torch.cuda.synchronize()
            lib_kernels = sorted(
                ((e.self_device_time_total, e.key)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA), reverse=True)
            lib_name = lib_kernels[0][1][:120] if lib_kernels else "not traced"
            log(f"[flash-timing] library {head}: "
                f"scaled_dot_product_attention forward {lib_fwd:.4f} ms, "
                f"its gradient {lib_bwd:.4f} ms (forward + backward "
                f"{lib_fwd + lib_bwd:.4f} ms), max abs difference from the "
                f"plain forward {lib_err:.3e}; its forward kernel: {lib_name}"
                f"; its backward kernel: {lib_bwd_name} on {smi}")
            log(f"[flash-timing] fwd {head}: kernel {fwd_ms:.4f} ms, plain "
                f"{times[('flash_fwd', name, dname)][1]:.4f} ms "
                f"({fwd_runs}), {_against(fwd_ms, bounds[0], lib_fwd)} on "
                f"{smi}")
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
        # the text tower's forward over 1024 prompts (a 1000-class label
        # set), the same turns
        prompts = tokens.repeat(16, 1)
        with torch.inference_mode():
            t = [_time_ms(lambda a=attn: model.encode_text(prompts,
                                                           attention=a),
                          iters=3, warmup=1)
                 for attn in (FA.mha_qkv_reference, FA.mha_qkv,
                              FA.mha_qkv, FA.mha_qkv_reference)]
        log(f"[towers] {MODEL_CFG} text tower forward, {len(prompts)} "
            f"prompts, {dname}: kernel attention {(t[1] + t[2]) / 2:.3f} ms, "
            f"plain attention {(t[0] + t[3]) / 2:.3f} ms on {smi}")
        # where a forward's device time goes, by kernel family
        for tower, forward in (
                ("image B=256", lambda: model.encode_image(batch)),
                (f"text {len(prompts)} prompts",
                 lambda: model.encode_text(prompts))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.inference_mode(), torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                start.record()
                for _ in range(3):
                    forward()
                end.record()
                torch.cuda.synchronize()
            window = start.elapsed_time(end) / 3
            split, _ = _device_split(prof, 3)
            busy = sum(split.values())
            parts = ", ".join(
                f"{k} {v:.2f} ({100 * v / max(busy, 1e-9):.1f} %)"
                for k, v in split.items() if v > 0)
            log(f"[towers] {tower} forward {dname} profile, device ms per "
                f"forward: {busy:.2f} busy of a {window:.2f} ms window "
                f"(idle {100 * (1 - busy / window):.1f} %) ({parts}) on {smi}")
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
        ms = _time_ms(lambda: step(state, batch, draws), iters=3, warmup=1)
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
        ms = _time_ms(lambda: step(state, batch, draws), iters=3, warmup=1)
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
N_FEWSHOT, N_RETRIEVED, N_TEST = 40, 220, 300   # the smoke splits
# the flagship run's batch: few-shot finetuning's drop-last loader refuses
# a batch larger than the 40 few-shot images, in both packages
FLAGSHIP_BSZ = 32
STAGE_FILES = ("test_confusion_matrix.npy", "test_scores.json",
               "val_confusion_matrix_best.npy", "val_scores_best.json")


@contextlib.contextmanager
def _stage2_counts(FA):
    """The four launch counts of each stage-2 entry point of the runs made
    inside: SwatPipeline.run_stage2_probing / run_stage2_fsft wrapped to
    read the counts before and after -> {name: counts}."""
    from swat_tpu_torch.train import stages

    per = {}
    saved = {}
    for name in ("run_stage2_probing", "run_stage2_fsft"):
        fn = saved[name] = getattr(stages.SwatPipeline, name)

        def wrapped(self, *args, _fn=fn, _name=name):
            before = _counts(FA)
            try:
                return _fn(self, *args)
            finally:
                per[_name] = tuple(a - b for a, b in
                                   zip(_counts(FA), before))

        setattr(stages.SwatPipeline, name, wrapped)
    try:
        yield per
    finally:
        for name, fn in saved.items():
            setattr(stages.SwatPipeline, name, fn)


def _train_cli_run(workdir, ckpt, dataset, method, dtype, resident, smi,
                   extra=(), bsz=CLI_BSZ, tag="", rows_want=2, stage2=False):
    """One run of ``method`` through swat_tpu_torch.cli.main at full width
    (2 epochs at ``bsz`` unless ``extra`` says otherwise; --skip_stage2
    unless ``stage2``), its summary line, loss.csv (``rows_want`` rows) and
    output files checked.  The four counts are set to 0 just before the run
    and read just after -> dict of what it gave."""
    import csv
    import io
    import math
    import os
    import re

    from swat_tpu_torch.cli.main import main as cli_main
    from swat_tpu_torch.kernels import flash_attention as FA

    folder = f"{workdir}/train_{method}_{dtype}_{resident}{tag}"
    _reset_counts(FA)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_main(["--dataset", dataset, "--method", method,
                  "--data_source", "fewshot+retrieved",
                  "--retrieval_split", RETRIEVAL_SPLIT,
                  "--shots", "4", "--epochs", "2",
                  *(() if stage2 else ("--skip_stage2",)),
                  "--bsz", str(bsz), "--model_cfg", MODEL_CFG,
                  "--checkpoint_path", ckpt,
                  "--config_yml", f"{workdir}/config.yml",
                  "--folder", folder, "--compute_dtype", dtype,
                  "--resident", resident, "--num_workers", "8",
                  "--recal_prompt", "--device", "cuda", *extra])
    wall = time.perf_counter() - t0
    counts = _counts(FA)
    out = buf.getvalue()
    summary = [ln for ln in out.splitlines()
               if ln.startswith(f"{dataset},{method},")]
    if len(summary) != 1 or len(summary[0].split(",")) != 11:
        raise AssertionError(f"no 11-field summary line:\n{out[-2000:]}")
    accs = [float(x) for x in summary[0].split(",")[7:]]
    skipped_stage1 = "--skip_stage1" in extra
    ran = accs[2:] if skipped_stage1 else accs if stage2 else accs[:2]
    if not all(0.0 <= a <= 100.0 for a in ran) or (
            not stage2 and accs[2:] != [-1.0, -1.0]) or (
            skipped_stage1 and accs[:2] != [-1.0, -1.0]):
        raise AssertionError(f"bad accuracies in {summary[0]}")
    (run_dir,) = [r for r, _, files in os.walk(folder)
                  if "loss.csv" in files]
    with open(os.path.join(run_dir, "loss.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["Train_loss"]) for r in rows]
    if len(rows) != rows_want or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"loss.csv malformed: {rows}")
    files = sorted(os.listdir(run_dir))
    stages = (2, 3) if skipped_stage1 else (1, 2, 3) if stage2 else (1,)
    # a run stopped before its last epoch takes no best snapshot, so it has
    # no validation confusion matrix
    want = [f"stage{n}_{name}" for n in stages for name in STAGE_FILES
            if not ("--stop_epochs" in extra and name.startswith("val_c"))]
    bundles = [f for f in files if re.fullmatch(
        r"stage\d_model_best-epoch_-?\d+_best\.msgpack(\.json)?", f)]
    missing = [w for w in want if w not in files]
    arrays = {f for f in bundles if f.endswith(".msgpack")}
    # a bundle (the resumed run's folder keeps the stopped run's too) and
    # its sidecar for each stage that ran
    if missing or {f + ".json" for f in arrays} != set(bundles) - arrays \
            or {f[:6] for f in arrays} != {f"stage{n}" for n in stages}:
        raise AssertionError(f"outputs missing: {missing} (bundle files "
                             f"{bundles})")
    resident_run = "resident epochs" in out
    rate = re.findall(r"Epoch \d+, Iter \d+, .*?, (\d+) img/s", out)
    steps = len(rows) * ((N_FEWSHOT + N_RETRIEVED) // bsz)
    log(f"[train-cli] {method} {dtype} resident={resident}{tag}"
        f"{' (resident epochs)' if resident_run else ' (streaming)'}: "
        f"{summary[0]} | train loss "
        f"{' -> '.join(f'{x:.6f}' for x in losses[:2])} | "
        f"{len(rows)} loss.csv rows at bsz {bsz} in {wall:.3f} s, rates "
        f"{'/'.join(rate[:4])} images/s (host clock, decode included when "
        f"streaming) on {smi} | kernel launches fwd {counts[0]} bwd "
        f"{counts[1]} heads-first fwd {counts[2]} heads-first bwd "
        f"{counts[3]}")
    return {"counts": counts, "steps": steps, "resident": resident_run,
            "out": out, "run_dir": run_dir, "rows": rows,
            "summary": summary[0], "wall": wall}


def _check_stage1_counts(run, method, layers):
    need = layers * run["steps"]
    need_flash = need if method == "attentivemix" else 0
    counts = run["counts"]
    log(f"[train-cli] {method}: need >= {need} fwd and bwd, {need_flash} "
        f"heads-first fwd, 0 heads-first bwd")
    if (counts[0] < need or counts[1] < need or counts[2] != need_flash
            or counts[3] != 0):
        raise AssertionError(f"{method} training did not go through the "
                             f"attention kernels: {counts}")


def _flagship(workdir, ckpt, dataset, smi, layers):
    """The flagship SWAT run at full width: stage 1 (cutmix, fp32, resident
    canvases), WiSE-FT, tau-norm, stage-2 probing on the few-shot
    train-transform snapshot features, few-shot finetuning; then stage 2
    alone from its stage-1 bundle (--skip_stage1).  -> (the runs' summed
    counts, the stage-2 counts)."""
    import glob
    import math
    import re

    from swat_tpu_torch.kernels import flash_attention as FA

    with _stage2_counts(FA) as per:
        full = _train_cli_run(workdir, ckpt, dataset, "cutmix", "float32",
                              "auto", smi, bsz=FLAGSHIP_BSZ, rows_want=22,
                              stage2=True)
    stage2 = dict(per)
    out = full["out"]
    walls = {name: float(re.search(rf"{name} wall time: ([\d.]+) s",
                                   out).group(1))
             for name in ("Stage 1", "Stage 2 probing", "Stage 2 FSFT")}
    rates = re.findall(r"Extracted (\w+) features: (\d+) images in ([\d.]+) "
                       r"s \(([\d.]+) images/s", out)
    fsft_steps = 10 * (N_FEWSHOT // FLAGSHIP_BSZ)
    need_probe = layers * (math.ceil(N_FEWSHOT / 128)
                           + math.ceil(N_TEST / 256))
    need_fsft = layers * (fsft_steps + 1 + math.ceil(N_TEST / 256))
    probe, fsft = stage2["run_stage2_probing"], stage2["run_stage2_fsft"]
    log(f"[flagship] {full['summary']} on {smi} | wall {full['wall']:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
        + " | stage-2 extraction "
        + ", ".join(f"{tag} {n} images in {secs} s = {rate} images/s"
                    for tag, n, secs, rate in rates)
        + f" (decode included) | stage-2 launches: probing fwd {probe[0]} "
        f"bwd {probe[1]} (need >= {need_probe} fwd), FSFT fwd {fsft[0]} bwd "
        f"{fsft[1]} (need >= {need_fsft} fwd, >= {layers * fsft_steps} "
        f"bwd)")
    if (probe[0] < need_probe or probe[1] != 0 or fsft[0] < need_fsft
            or fsft[1] < layers * fsft_steps or probe[2:] != (0, 0)
            or fsft[2:] != (0, 0)):
        raise AssertionError("stage 2 did not go through the attention "
                             f"kernels: probing {probe}, FSFT {fsft}")
    _check_stage1_counts({"counts": tuple(
        c - p - f for c, p, f in zip(full["counts"], probe, fsft)),
        "steps": 2 * ((N_FEWSHOT + N_RETRIEVED) // FLAGSHIP_BSZ)},
        "cutmix", layers)

    (bundle,) = glob.glob(f"{full['run_dir']}/stage1_model_best-epoch_*"
                          "_best.msgpack")
    skip = _train_cli_run(workdir, ckpt, dataset, "cutmix", "float32",
                          "auto", smi, bsz=FLAGSHIP_BSZ, tag="_skip_stage1",
                          rows_want=20, stage2=True,
                          extra=("--skip_stage1", "--stage1_model_path",
                                 bundle))
    a, b = full["summary"].split(","), skip["summary"].split(",")
    log(f"[flagship] --skip_stage1 from {bundle.rsplit('/', 1)[-1]}: stage-2 "
        f"fields {b[9:]} (full run {a[9:]}) | loss rows (full | skip):")
    for r, q in zip(full["rows"][2:], skip["rows"]):
        log(f"    {','.join(r.values())} | {','.join(q.values())}")
    if b[9:] != a[9:]:
        raise AssertionError("--skip_stage1 from the stage-1 bundle gave "
                             f"other stage-2 fields: {b[9:]} vs {a[9:]}")
    return ([x + y for x, y in zip(full["counts"], skip["counts"])],
            stage2)


def _resume(workdir, ckpt, dataset, smi, layers):
    """--save_ckpt through 2 of 3 epochs (--stop_epochs 2), then --resume:
    the resumed run restores the epoch-2 checkpoint and trains epoch 3
    alone -> the two runs' summed counts."""
    import os

    first = _train_cli_run(workdir, ckpt, dataset, "cutmix", "float32",
                           "auto", smi, tag="_resume",
                           extra=("--epochs", "3", "--stop_epochs", "2",
                                  "--save_ckpt", "True", "--save_freq", "2"))
    steps = (N_FEWSHOT + N_RETRIEVED) // CLI_BSZ
    ckpts = sorted(os.listdir(f"{first['run_dir']}/model_ckpts"))
    if ckpts != [f"ckpt_ep2_it{2 * steps}.msgpack",
                 f"ckpt_ep2_it{2 * steps}.msgpack.json"]:
        raise AssertionError(f"train checkpoints: {ckpts}")
    resumed = _train_cli_run(workdir, ckpt, dataset, "cutmix", "float32",
                             "auto", smi, tag="_resume", rows_want=1,
                             extra=("--epochs", "3", "--resume", "True"))
    row = resumed["rows"][0]
    log(f"[resume] {ckpts[0]} -> resumed loss.csv row {dict(row)}")
    if (row["Epoch"], row["Iter"]) != ("3", str(3 * steps)) or \
            "Resumed from" not in resumed["out"]:
        raise AssertionError("--resume did not go on at epoch 3")
    _check_stage1_counts(resumed, "cutmix", layers)
    return [x + y for x, y in zip(first["counts"], resumed["counts"])]


def phase_train_cli(workdir, ckpt, dataset, smi):
    """Training through swat_tpu_torch.cli.main at full width: the flagship
    run (stage 1 cutmix fp32 resident, then stage 2) and stage 2 alone from
    its bundle; stage-1 cutmix fp32 streaming, bf16 resident, with the host
    PIL transform (--aug_mode host), and --save_ckpt then --resume;
    attentivemix (streaming, its heatmaps through the heads-first forward
    at every step: --mix_prob 1) and mixup (resident) in fp32.  -> (the four
    counts summed over the runs, each run counted from 0; the stage-2
    counts of the flagship run)."""
    from swat_tpu_torch.models.configs import get_model_config

    layers = get_model_config(MODEL_CFG).vision.layers
    _write_retrieved(workdir, dataset, N_RETRIEVED // 10)
    total, stage2 = _flagship(workdir, ckpt, dataset, smi, layers)
    total = [t + c for t, c in zip(total, _resume(workdir, ckpt, dataset,
                                                  smi, layers))]
    runs = [("cutmix", "float32", "off", (), False),
            ("cutmix", "bfloat16", "auto", (), True),
            ("cutmix", "float32", "auto", ("--aug_mode", "host"), False),
            ("attentivemix", "float32", "auto", ("--mix_prob", "1.0"), False),
            ("mixup", "float32", "auto", (), True)]
    for method, dtype, resident, extra, want_resident in runs:
        run = _train_cli_run(workdir, ckpt, dataset, method, dtype, resident,
                             smi, extra,
                             tag="".join(f"_{x.lstrip('-')}" for x in extra))
        _check_stage1_counts(run, method, layers)
        if run["resident"] != want_resident:
            raise AssertionError(f"{method} resident={resident}: resident "
                                 f"epochs {run['resident']}, expected "
                                 f"{want_resident}")
        total = [t + c for t, c in zip(total, run["counts"])]
    return total, stage2


# ---------------------------------------------------------------------------
# the block-fused layer kernels (kernels/megablock.py) and the use_mega route

# (name, batch, seq, width, heads, mlp, causal, quick_gelu): the B/32 image
# tower's block at the train batch, the text tower's (a quarter of the 1024
# prompts of a zero-shot run), one exact-gelu case and B/16's sequence
MEGA_SHAPES = [
    ("vitb32_image", 256, 50, 768, 12, 3072, False, True),
    ("text", 256, 77, 512, 8, 2048, True, True),
    ("vitb32_image_gelu", 16, 50, 768, 12, 3072, False, False),
    ("vitb16_image", 8, 197, 768, 12, 3072, False, True),
]
MEGA_OUTPUTS = {
    "mega_fwd": ("y", "x2"),
    "mega_mlp_bwd": ("dx2", "d_fc_w", "d_fc_b", "d_proj_w", "d_proj_b",
                     "d_ln2_w", "d_ln2_b"),
    "mega_attn_bwd": ("dx", "d_in_w", "d_in_b", "d_out_w", "d_out_b",
                      "d_ln1_w", "d_ln1_b")}
# kernel vs plain, each output against its own largest value.  fp32: the two
# differ in summation order only (a weight gradient sums over all B*S rows).
MEGA_FP32_TOL = 5e-5
# bf16, an output in bf16: a rounding flip of it or of what feeds it, two
# ulps of the element plus one of the largest; an fp32 gradient: a few
# flipped bf16 roundings among the B*S terms of each sum
MEGA_BF16_TOL = (1.6e-2, 4e-3)
MEGA_BF16_GRAD_TOL = 2e-3
# the share of a bf16 output that is bit-equal to the plain version's.  With
# the same rounding points a last fp32 bit flips one value in 10^3-10^4, but
# one flipped hidden value moves the 768- to 3072-term sum it feeds, so at
# full width the flips multiply down the chain of roundings (y: 0.87-0.98
# bit-equal on an H100).  The yardstick is therefore measured in the same
# run: the plain version against itself with every weight product summed in
# another order (two halves of the depth; its attention and LayerNorm sums
# stay as they are, so it understates the noise where S is long).  The
# kernel may differ from the plain version in at most MEGA_FLIP_FACTOR times
# as many elements as that reordering does, plus MEGA_FLIP_FLOOR of them.
# At width 64-96 every output keeps >= 0.99 (tests/test_torch_cuda.py; bf16
# dx of the attention backward against the plain version with the card's
# own mma sums, tests/torch_port_lib.py's mma_sum_dot), and the plain
# versions are bit-equal to the TPU kernels in interpret mode
# (tests/test_torch_megablock.py, where a moved rounding point falls below
# 0.99 even at width 64)
MEGA_FLIP_FACTOR = 3.0
MEGA_FLIP_FLOOR = 0.01


def _split_depth_dot(a, b):
    """kernels.megablock._dot with the depth summed in two halves."""
    import torch

    a, b = a.float(), b.float()
    k = a.shape[-1] // 2
    return (torch.matmul(a[..., :k], b[..., :k, :])
            + torch.matmul(a[..., k:], b[..., k:, :]))


def _mega_inputs(b, s, d, f, dtype, gen):
    """x, x2, dy, dx2 [B, S, D] and one block's weights (LayerNorm scale and
    bias random, so that their rounding shows) on the card in ``dtype``."""
    import torch

    from swat_tpu_torch.kernels.megablock import BlockWeights

    def normal(shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std
                + mean).to(dtype)

    acts = [normal((b, s, d)) for _ in range(4)]
    w = BlockWeights(
        normal((3 * d, d), d ** -0.5), normal((3 * d,), 0.1),
        normal((d, d), d ** -0.5), normal((d,), 0.1),
        normal((d,), 0.1, 1.0), normal((d,), 0.1), normal((d,), 0.1, 1.0),
        normal((d,), 0.1), normal((f, d), d ** -0.5), normal((f,), 0.1),
        normal((d, f), f ** -0.5), normal((d,), 0.1))
    return acts, w


def _mega_calls(MB, acts, w, heads, causal, quick):
    """{kernel: (kernel call, plain call)} on one set of inputs."""
    x, x2, dy, dx2 = acts
    return {
        "mega_fwd": (
            lambda: MB.megablock_fwd(x, w, heads, causal, quick),
            lambda: MB.block_fwd_reference(x, w, heads, causal, quick)),
        "mega_mlp_bwd": (
            lambda: MB.megablock_mlp_bwd(x2, dy, w, quick),
            lambda: MB.mlp_bwd_reference(x2, dy, w, quick)),
        "mega_attn_bwd": (
            lambda: MB.megablock_attn_bwd(x, dx2, w, heads, causal),
            lambda: MB.attn_bwd_reference(x, dx2, w, heads, causal))}


def phase_mega_kernels():
    """Each block kernel against its plain version at every MEGA_SHAPES
    shape, fp32 and bf16 -> the largest absolute error by (kernel, shape,
    dtype)."""
    import torch

    from swat_tpu_torch.kernels import megablock as MB

    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = {}
    for name, b, s, d, heads, f, causal, quick in MEGA_SHAPES:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            acts, w = _mega_inputs(b, s, d, f, dtype, gen)
            for kernel, (run, plain) in _mega_calls(MB, acts, w, heads,
                                                    causal, quick).items():
                got, ref = run(), plain()
                reordered = ref
                if dtype == torch.bfloat16:
                    dot, MB._dot = MB._dot, _split_depth_dot
                    try:
                        reordered = plain()
                    finally:
                        MB._dot = dot
                torch.cuda.synchronize()
                ok, parts, max_err = True, [], 0.0
                for out, g, r, r2 in zip(MEGA_OUTPUTS[kernel], got, ref,
                                         reordered):
                    g32, r32 = g.float(), r.float()
                    err = (g32 - r32).abs()
                    scale = float(r32.abs().max())
                    ok &= g.shape == r.shape and g.dtype == r.dtype
                    ok &= bool(torch.isfinite(g).all())
                    note = f"{out} {float(err.max()):.2e}/{scale:.2e}"
                    if dtype == torch.float32:
                        ok &= float(err.max()) <= MEGA_FP32_TOL * scale
                    elif g.dtype == torch.bfloat16:
                        rtol, atol = MEGA_BF16_TOL
                        ok &= bool((err <= rtol * r32.abs()
                                    + atol * scale).all())
                        share = float((g == r).float().mean())
                        noise = float((r2 == r).float().mean())
                        least = 1 - (MEGA_FLIP_FACTOR * (1 - noise)
                                     + MEGA_FLIP_FLOOR)
                        ok &= share >= least
                        note += (f" bit-equal {share:.4f} (plain reordered "
                                 f"{noise:.4f}, so at least {least:.4f})")
                    else:
                        ok &= float(err.max()) <= MEGA_BF16_GRAD_TOL * scale
                    parts.append(note)
                    max_err = max(max_err, float(err.max()))
                worst[(kernel, name, dname)] = max_err
                log(f"[mega-kernels] {kernel} {name} B={b} S={s} D={d} "
                    f"H={heads} F={f} causal={causal} "
                    f"{'quick-gelu' if quick else 'gelu'} {dname}: max abs "
                    f"err / largest value: {'; '.join(parts)} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{kernel} disagrees with its plain "
                                         f"version at {name} {dname}")
    return worst


def _mega_work(kernel, b, s, d, heads, f, dname, causal):
    """One call of a block kernel -> (operations, bytes): its activations and
    weights read once, its outputs written once (parameter gradients are
    fp32).  Operations per token row, 2 a multiply-add: forward 8 D^2 +
    4 D F; MLP backward 10 D F (the fc recompute, dWp, dg, dWfc, dh2);
    attention backward 22 D^2 (the qkv recompute, dWo, do, dWqkv, dh1); and
    per image and head 2 (forward) or 6 (attention backward: s and p.v
    again, dv, dp, dq, dk) products of 2 * hd over the query-key pairs that
    are not masked (per image, not over the TPU kernel's batch block)."""
    itemsize = 4 if dname == "float32" else 2
    n = b * s
    pairs = s * (s + 1) // 2 if causal else s * s
    attn = b * heads * pairs * 2 * (d // heads)
    if kernel == "mega_fwd":
        ops = n * (8 * d * d + 4 * d * f) + 2 * attn
        nbytes = (3 * n * d + 4 * d * d + 2 * d * f + 9 * d + f) * itemsize
    elif kernel == "mega_mlp_bwd":
        ops = n * 10 * d * f
        nbytes = ((3 * n * d + 2 * d * f + f + 2 * d) * itemsize
                  + (2 * d * f + f + 3 * d) * 4)
    else:
        ops = n * 22 * d * d + 6 * attn
        nbytes = ((3 * n * d + 4 * d * d + 5 * d) * itemsize
                  + (4 * d * d + 6 * d) * 4)
    return ops, nbytes


def _mega_bound_ms(kernel, b, s, d, heads, f, dname, causal):
    """The least time the card could take for one call of a block kernel:
    the larger of its bytes (``_mega_work``) over the memory rate and its
    operations over the peak rate of the type -> (ms, 'bytes' |
    'operations')."""
    ops, nbytes = _mega_work(kernel, b, s, d, heads, f, dname, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _library_halves(w, heads, causal, quick):
    """The block built from library calls (layer_norm, linear = cuBLAS,
    scaled_dot_product_attention), as its two halves: x -> x2 and x2 -> y.
    Timed as the yardstick; the port calls none of it."""
    import torch
    import torch.nn.functional as F

    def attn_half(x):
        b, s, d = x.shape
        h = F.layer_norm(x, (d,), w.ln1_w, w.ln1_b)
        q, k, v = (t.reshape(b, s, heads, -1).transpose(1, 2)
                   for t in F.linear(h, w.in_w, w.in_b).chunk(3, dim=-1))
        o = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        o = o.transpose(1, 2).reshape(b, s, d)
        return x + F.linear(o, w.out_w, w.out_b)

    def mlp_half(x2):
        h = F.layer_norm(x2, (x2.shape[-1],), w.ln2_w, w.ln2_b)
        m = F.linear(h, w.fc_w, w.fc_b)
        g = m * torch.sigmoid(1.702 * m) if quick else F.gelu(m)
        return x2 + F.linear(g, w.proj_w, w.proj_b)

    return attn_half, mlp_half


def phase_mega_timing(smi):
    """The three block kernels at the B/32 image shape, fp32 and bf16, in
    turns plain, kernel, kernel, plain; beside them the bound, and the
    library-built block: its forward for the forward kernel, and for each
    backward kernel the forward and backward of its half through autograd
    (the backward kernels recompute their half's forward too).  Launches
    made here are not counted."""
    import torch

    from swat_tpu_torch.kernels import megablock as MB

    gen = torch.Generator(device="cuda").manual_seed(7)
    name, b, s, d, heads, f, causal, quick = MEGA_SHAPES[0]
    times = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        acts, w = _mega_inputs(b, s, d, f, dtype, gen)
        x, x2, dy, dx2 = acts
        attn_half, mlp_half = _library_halves(w, heads, causal, quick)
        with torch.no_grad():
            lib_fwd = _time_ms(lambda: mlp_half(attn_half(x)), iters=5,
                               warmup=2)

        leaves = MB.BlockWeights(*(t.detach().requires_grad_(True)
                                   for t in w))
        attn_leaf, mlp_leaf = _library_halves(leaves, heads, causal, quick)

        def fwd_bwd(half, inp, grad, params):
            leaf = inp.detach().requires_grad_(True)
            return lambda: torch.autograd.grad(half(leaf), (leaf, *params),
                                               grad)

        lib = {
            "mega_fwd": lib_fwd,
            "mega_mlp_bwd": _time_ms(fwd_bwd(
                mlp_leaf, x2, dy,
                (leaves.ln2_w, leaves.ln2_b, leaves.fc_w, leaves.fc_b,
                 leaves.proj_w, leaves.proj_b)), iters=5, warmup=2),
            "mega_attn_bwd": _time_ms(fwd_bwd(
                attn_leaf, x, dx2,
                (leaves.in_w, leaves.in_b, leaves.out_w, leaves.out_b,
                 leaves.ln1_w, leaves.ln1_b)), iters=5, warmup=2)}
        for kernel, (run, plain) in _mega_calls(MB, acts, w, heads, causal,
                                                quick).items():
            p1, k1, k2, p2 = (_time_ms(fn, iters=5, warmup=2)
                              for fn in (plain, run, run, plain))
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            bound, by = _mega_bound_ms(kernel, b, s, d, heads, f, dname,
                                       causal)
            kind = kernel[len("mega_"):]
            scratch = MB.scratch_bytes(kind, b, s, d, f, heads, dtype)
            ops, _ = _mega_work(kernel, b, s, d, heads, f, dname, causal)
            times[(kernel, dname)] = (ms, plain_ms, lib[kernel], bound, by)
            log(f"[mega-timing] {kernel} {name} B={b} S={s} D={d} H={heads} "
                f"F={f} {dname}: kernel {ms:.3f} ms "
                f"({ops / ms / 1e9:.1f} TFLOP/s of its operations), plain "
                f"{plain_ms:.3f} ms "
                f"(runs {k1:.3f}/{k2:.3f} vs {p1:.3f}/{p2:.3f}), bound "
                f"{bound:.3f} ms ({by}), library "
                f"{'forward' if kind == 'fwd' else 'forward + backward of its half'} "
                f"{lib[kernel]:.3f} ms, scratch {scratch / 1e6:.1f} MB a "
                f"call on {smi}")
        # where one call of each kernel spends its device time: a profile
        # drops the kernels launched while its tracing starts, so the calls
        # run twice and only the second, active step is read
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                 active=1)) as prof:
            for step in range(2):
                for run, _ in _mega_calls(MB, acts, w, heads, causal,
                                          quick).values():
                    run()
                torch.cuda.synchronize()
                if step == 0:
                    prof.step()
        split = _mega_device_split(prof)
        log(f"[mega-timing] {dname} profile, device ms of one call of each "
            f"of the three kernels: "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f" (sum {sum(split.values()):.3f}) on {smi}")
    return times


def _mega_device_split(prof):
    """Device ms by launch family from a torch.profiler run of the block
    kernels: the tensor-core products of all three (megablock_mma.cuh),
    split into the weight gradients (both operands read down their
    columns), the join of their depth splits and the other products; the
    attention templates; and the LayerNorm and column-sum launches."""
    from torch.autograd import DeviceType

    split = {"weight-gradient products": 0.0, "split-K join": 0.0,
             "other products": 0.0, "attention": 0.0,
             "layernorm and column sums": 0.0}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        name, ms = evt.key, evt.self_device_time_total / 1e3
        if "mma_gemm_kernel" in name:
            wgrad = "false, false" in name.replace("(bool)0", "false")
            split["weight-gradient products" if wgrad
                  else "other products"] += ms
        elif "split_join_kernel" in name:
            split["split-K join"] += ms
        elif "attention_" in name:
            split["attention"] += ms
        elif "ln_" in name or "colsum" in name:
            split["layernorm and column sums"] += ms
    return split


def _reset_mega(MB):
    MB.LAUNCHES_MEGA = MB.LAUNCHES_MEGA_MLP_BWD = 0
    MB.LAUNCHES_MEGA_ATTN_BWD = 0


def _mega_counts(MB):
    return (MB.LAUNCHES_MEGA, MB.LAUNCHES_MEGA_MLP_BWD,
            MB.LAUNCHES_MEGA_ATTN_BWD)


def phase_mega_towers(ckpt, smi):
    """Both full-width ViT-B/32 towers through use_mega (image B=256, 64
    prompts) against the ordinary route (the packed-head attention kernels
    between torch's products), fp32 and bf16.  The counts are set to 0 just
    before each use_mega encode and read just after: one launch of the
    block-forward kernel a layer -> its launches."""
    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.kernels import megablock as MB
    from swat_tpu_torch.models.clip import CLIPModel
    from swat_tpu_torch.models.configs import get_model_config

    cfg = get_model_config(MODEL_CFG)
    model = CLIPModel(cfg)
    model.load_state_dict(torch.load(ckpt))
    model.cuda().eval()
    gen = torch.Generator().manual_seed(2)
    n_px = cfg.vision.image_size
    images = torch.randn(TRAIN_BSZ, n_px, n_px, 3, generator=gen).cuda()
    ctx, vocab = cfg.text.context_length, cfg.text.vocab_size
    tokens = torch.randint(1, vocab - 3, (64, ctx), generator=gen)
    tokens[:, 0] = vocab - 2
    for i in range(64):
        tokens[i, 2 + i % (ctx - 3):] = 0
        tokens[i, 2 + i % (ctx - 3)] = vocab - 1     # EOT, the max id
    tokens = tokens.cuda()
    total = 0
    for dname, precision in (("float32", FP32_PRECISION),
                             ("bfloat16", DEFAULT_PRECISION)):
        precision.apply_backend_flags()
        model.precision = precision
        for tower, encode, inp, layers in (
                ("image", model.encode_image, images, cfg.vision.layers),
                ("text", model.encode_text, tokens, cfg.text.layers)):
            with torch.inference_mode():
                ref = encode(inp, normalize=True)
                _reset_mega(MB)
                got = encode(inp, normalize=True, use_mega=True)
                torch.cuda.synchronize()
                counts = _mega_counts(MB)
            if not (got.shape == (len(inp), cfg.embed_dim)
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"{tower} tower output malformed")
            cos = float((got * ref).sum(-1).min())
            ok = cos >= TOWER_MIN_COS[dname] and counts == (layers, 0, 0)
            log(f"[mega-towers] {MODEL_CFG} {tower} tower ({layers} layers, "
                f"B={len(inp)}) {dname}: min cosine use_mega vs the ordinary "
                f"route = {cos:.8f} (bound {TOWER_MIN_COS[dname]}), launches "
                f"{counts} (need ({layers}, 0, 0)) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tower} tower through use_mega "
                                     f"disagrees ({dname})")
            total += counts[0]
        with torch.inference_mode():
            t = [_time_ms(lambda m=mega: model.encode_image(images,
                                                            use_mega=m),
                          iters=3, warmup=1)
                 for mega in (False, True, True, False)]
        log(f"[mega-towers] {MODEL_CFG} image tower forward B={TRAIN_BSZ} "
            f"{dname}: use_mega {(t[1] + t[2]) / 2:.3f} ms "
            f"({TRAIN_BSZ * 2e3 / (t[1] + t[2]):.1f} images/s), ordinary "
            f"route {(t[0] + t[3]) / 2:.3f} ms on {smi}")
    del model
    torch.cuda.empty_cache()
    return total


def phase_mega_step(ckpt, smi):
    """The full-width ViT-B/32 cutmix step at bsz 256 from uint8 canvases
    with the image tower through use_mega, fp32 and bf16: all visual
    gradients against the ordinary route, then one step with AdamW with
    every count set to 0 just before it and read just after (12 launches
    each of the three block kernels, none of the packed-head attention
    kernels), then timed steps -> the three kernels' launches."""
    import numpy as np
    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.kernels import megablock as MB
    from swat_tpu_torch.train.losses import cross_entropy
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import (make_encode_loss, make_mix_fn,
                                            make_mixing_step, make_sampler)

    cfg, model, batch, head, rng = _train_setup(ckpt)
    n_px, layers = cfg.vision.image_size, cfg.vision.layers
    sample = make_sampler("cutmix", mix_prob=1.0, image_size=n_px)
    mix = make_mix_fn("cutmix", image_size=n_px)
    total = [0, 0, 0]
    for dname, precision in (("float32", FP32_PRECISION),
                             ("bfloat16", DEFAULT_PRECISION)):
        precision.apply_backend_flags()
        model.precision = precision
        state = create_train_state(model, head, "cutmix", total_iter=100)
        draws = sample(rng, batch)
        grads = {}
        for route, mega in (("use_mega", True), ("ordinary", False)):
            state.optimizer.zero_grad(set_to_none=True)
            loss = make_encode_loss(cross_entropy, use_mega=mega)(
                state, mix(state, batch, draws))
            loss.backward()
            grads[route] = (loss.item(), {
                n: p.grad.detach().float().flatten().clone()
                for n, p in model.named_parameters() if p.grad is not None})
        (lm, gm), (lo, go) = grads["use_mega"], grads["ordinary"]
        if not (np.isfinite(lm) and len(gm) == len(go) > 0):
            raise AssertionError(f"use_mega train step malformed ({dname})")
        cos = {n: float(torch.nn.functional.cosine_similarity(
            gm[n], go[n], dim=0)) for n in gm if go[n].abs().max() > 0}
        worst = min(cos, key=cos.get)
        ok = cos[worst] >= GRAD_MIN_COS[dname]
        log(f"[mega-step] {MODEL_CFG} cutmix bsz {TRAIN_BSZ} {dname}: loss "
            f"use_mega {lm:.6f} / ordinary {lo:.6f}; min cosine of "
            f"{len(cos)} visual grads use_mega vs the ordinary route = "
            f"{cos[worst]:.8f} ({worst}; bound {GRAD_MIN_COS[dname]}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"use_mega gradients disagree ({dname})")
        del grads, gm, go
        state.optimizer.zero_grad(set_to_none=True)
        step = make_mixing_step("cutmix", image_size=n_px, use_mega=True)
        _reset_counts(FA)
        _reset_mega(MB)
        loss = step(state, batch, draws)
        torch.cuda.synchronize()
        counts, attn_counts = _mega_counts(MB), _counts(FA)
        ms = _time_ms(lambda: step(state, batch, draws), iters=3, warmup=1)
        log(f"[mega-step] {dname}: loss {float(loss):.6f}, launches block "
            f"fwd {counts[0]} mlp bwd {counts[1]} attn bwd {counts[2]} (need "
            f"{layers} each), attention kernels {attn_counts} (need all 0); "
            f"{ms:.2f} ms/step ({TRAIN_BSZ * 1e3 / ms:.1f} images/s) on "
            f"{smi}")
        if (not np.isfinite(float(loss)) or counts != (layers,) * 3
                or attn_counts != (0, 0, 0, 0)):
            raise AssertionError(f"the use_mega step did not go through the "
                                 f"block kernels ({dname}): {counts}, "
                                 f"{attn_counts}")
        total = [t + c for t, c in zip(total, counts)]
        del state, step
    del model
    torch.cuda.empty_cache()
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

    t_start = time.perf_counter()
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
        cli_counts, stage2_counts = phase_train_cli(workdir, ckpt,
                                                    "smoke10", smi)
        worst_mega = phase_mega_kernels()
        times_mega = phase_mega_timing(smi)
        tower_mega = phase_mega_towers(ckpt, smi)
        step_mega = phase_mega_step(ckpt, smi)
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
    # the block kernels at the same dtype and the B/32 image block (B=256,
    # S=50, D=768, H=12, F=3072); launches: the use_mega towers and train
    # steps, each counted from 0.  No flag of the CLI selects use_mega, as in
    # the JAX package.
    mega_launches = {"mega_fwd": tower_mega + step_mega[0],
                     "mega_mlp_bwd": step_mega[1],
                     "mega_attn_bwd": step_mega[2]}
    for kernel, line in (("mega_fwd", 138), ("mega_mlp_bwd", 184),
                         ("mega_attn_bwd", 228)):
        ms, plain_ms, lib_ms, bound, by = times_mega[(kernel, "float32")]
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": f"swat_tpu_torch/csrc/megablock_{kernel[5:]}.cu",
            "replaces": f"swat_tpu/kernels/megablock.py:{line}",
            "launches": mega_launches[kernel],
            "max_abs_err": worst_mega[(kernel, "vitb32_image", "float32")],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms})
    probe, fsft = (stage2_counts[k] for k in ("run_stage2_probing",
                                               "run_stage2_fsft"))
    log(f"[launches] mha_fwd {kernels[0]['launches']}, of which stage 2 "
        f"{probe[0] + fsft[0]} (probing {probe[0]}, FSFT {fsft[0]}); mha_bwd "
        f"{kernels[1]['launches']}, of which stage 2 {fsft[1]} (FSFT)")
    log(f"[total] {time.perf_counter() - t_start:.1f} s, the kernels' build "
        f"included, on {smi}")
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
