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
PIL transform), attentivemix and mixup; stage 1 of the twin-loader methods
through the CLI (cutmix-fs resident, mixup-fs, CMO resident with
``--utrain``, finetune-mixed with ``--optim SGD``) and cutmix with
``--accum 4`` and with ``--remat full``, each run's training launches
counted exactly; stage 1 of REAL-Linear (streaming), CMLP (on a
train-transform snapshot's features, and streaming with
``--use_attribute``) and FLYP (on into stage 2, and with ``--locked_text
--lr_projector``) through the CLI, their training launches counted exactly;
stage 1 of fixmatch (mu 2, its mask rates), finetune-multitask (on into
stage 2) and dataset-cls (no summary row) through the CLI, their training
launches counted exactly;
one full-width step of each twin-loader method, kernel against plain
attention; one full-width FLYP step (both towers, the text tower's causal
attention through the kernels with a gradient), kernel against plain
attention, timed, profiled and its peak memory; RandAugment on the card
(its time and launches, the integral ops bit-equal to the CPU, the strong
view against the CPU) and one full-width FixMatch step (768 rows a
forward), kernel against plain attention, timed, profiled and its peak
memory; one full-width step each of finetune-multitask and dataset-cls,
kernel against plain attention; the cutmix step under every remat policy and
gradient accumulation, its peak memory, time and launches, its gradients
against no remat; the RN50 towers (seeded, their BN statistics calibrated)
on the card against the CPU and in bf16, with no attention launch in the
image tower and 12 for a prompt batch; one RN50 cutmix step on the card
against the CPU at 4 images, then timed and profiled at bsz 256; RN50
through the CLI (the flagship run into stage 2; FLYP and ``--accum 2``
refused, as ``swat_tpu`` fails on both); one cutmix step of ViT-B/16 at bsz
128 and of ViT-L/14 at bsz 64, kernel against plain attention, counted,
timed and profiled (the attention kernels' share of the step); L/14's step
under no remat, full remat, ``--accum 2`` and ``auto_memory_policy``'s
pick, with its peak memory; then the three block-fused layer kernels (block
forward, MLP backward, attention backward) against their plain versions and
timed beside their bounds and a library-built block, both full-width towers
through ``use_mega``, and a full-width cutmix train step whose image tower
runs through them.  Between the two: the serving side, through the entry
points a user calls: the checkpoint through ``swat_tpu_torch.cli.convert``
(fp32 and int8 bundles); ``swat_tpu_torch.cli.test`` on the flagship run's
stage-1 bundle with each ``--which_head``, ``--tau``, ``--predict_labels``
and ``--utrain_out``, on the card and on the CPU (the same line, labels
and utrain file), and from the converted ``.msgpack`` as
``--checkpoint_path`` (the ``.pt``'s line); ``--test_imagenet_ood`` over
synthetic ImageNet-V2 / -A / -R trees with a 1000-class prompt head, card
against CPU; the W8A8 int8 towers card against CPU and against fp32,
ViT-L/14's int8 image tower, ``--quantize int8``, and the image tower's
forward at B = 256 in fp32, bf16 and int8 over each, timed, profiled and
its peak memory; then the retrieval pipeline through
``swat_tpu_torch.retrieval.cli``: captionmap, extract of a synthetic mined
tree (10 classes x 52 JPEGs) on the card in bf16 and with ``--quantize
int8`` and on the CPU, sample with every strategy on the fused engine on
the card, the per-class engine on the card and the fused engine on the
CPU (the same files), filter-synonyms card against CPU, and the fused
sampler against the per-class oracle at 1000 classes x 2000 candidates,
timed by stage.  After the training phases through the CLI, ``[dist]``:
the stage-1 cutmix fp32 streaming run through ``torch.distributed.run
--nproc_per_node 1`` on NCCL (``--mesh_data 1``) beside the same run
without a launcher (the same summary line, ``loss.csv`` and attention
launches), and B/32's two towers
cut into two tensor-parallel shards, both run in one process through the
kernels at H / 2 heads with a sum in place of the all-reduce, forward and
backward, fp32 and bf16, against the whole towers (the card has one GPU:
no multi-GPU number comes from it).  Then ``[tooling]``: the
reproduction runbook ``swat_tpu_torch.cli.repro --device cuda --execute``
(zero-shot and SWAT for one epoch: its preflight on the card, plan, rows
and score section, both CSVs) and the flagship run again under
``--trace_dir``: the trace's mha_fwd / mha_bwd kernel events against the
launches counted, its summary line and ``loss.csv`` against the untraced
run's, the trace's size and the profiler's cost.  The data are a synthetic
JPEG dataset (few-shot, retrieved, unlabeled and test splits, and
dataset-cls's flagged splits over the first two) and a seeded
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


# a torch.profiler trace now and then comes back without a single device
# event; such a trace is taken again, this many times in all, and a split
# that stays empty is reported as not measured (it checks nothing)
TRACE_TRIES = 3


def _device_kernels(prof):
    """[(device ms, name)] of the device events of a torch.profiler run,
    most first."""
    from torch.autograd import DeviceType

    return sorted(((e.self_device_time_total / 1e3, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)


def _trace(run, n=1, cpu=True):
    """run() n times under torch.profiler (the host's side too unless
    cpu=False) inside a window of CUDA events -> (the profile, window ms
    per call); a trace with no device time is taken again."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    for attempt in range(1, TRACE_TRIES + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=activities) as prof:
            start.record()
            for _ in range(n):
                run()
            end.record()
            torch.cuda.synchronize()
        if any(ms > 0 for ms, _ in _device_kernels(prof)):
            break
        log(f"[trace] trace {attempt} of {TRACE_TRIES} holds no device time")
    return prof, start.elapsed_time(end) / n


def _profiled(run, n, split_fn):
    """run() n times under _trace -> (busy ms per call, window ms per call,
    split, largest 'other')."""
    prof, window = _trace(run, n)
    split, others = split_fn(prof, n)
    return sum(split.values()), window, split, others


def _pct(part, whole):
    """part's share of whole, or 'not measured' where the trace held no
    device time."""
    return f"{100 * part / whole:.1f} %" if whole > 0 else "not measured"


def _idle(busy, window):
    """The share of the window in which the device was idle."""
    return _pct(window - busy, window) if busy > 0 else "not measured"


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

    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)

    def grad():
        torch.autograd.grad(out, (lq, lk, lv), do, retain_graph=True)

    ms = _time_ms(grad)
    kernels = _device_kernels(_trace(grad, cpu=False)[0])
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
            lib_kernels = _device_kernels(_trace(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal), cpu=False)[0])
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
            with torch.inference_mode():
                busy, window, split, _ = _profiled(forward, 3, _device_split)
            parts = ", ".join(
                f"{k} {v:.2f} ({100 * v / max(busy, 1e-9):.1f} %)"
                for k, v in split.items() if v > 0)
            log(f"[towers] {tower} forward {dname} profile, device ms per "
                f"forward: {busy:.2f} busy of a {window:.2f} ms window "
                f"(idle {_idle(busy, window)}) ({parts}) on {smi}")
    del model
    torch.cuda.empty_cache()
    return ckpt


def _write_dataset(root, n_classes=10, n_test_per_class=15, seed=0):
    """<root>/smoke10: class-colored JPEGs of camera-like sizes, test.txt,
    a few-shot split, FixMatch's unlabeled split (N_UNLABELED images) and
    the metrics json the prompts come from."""
    import os

    import numpy as np
    from PIL import Image

    name = "smoke10"
    ddir = os.path.join(root, name)
    os.makedirs(os.path.join(ddir, "imgs"), exist_ok=True)
    rng = np.random.default_rng(seed)
    colors = rng.integers(30, 225, (n_classes, 3))
    for split, per_class, fewshot in (("test.txt", n_test_per_class, 0),
                                      ("fewshot4_seed1.txt", 4, 1),
                                      (UNLABELED_SPLIT,
                                       N_UNLABELED // n_classes, 0)):
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


def _canvas_batch(rng, n, n_classes, device):
    """n random uint8 canvases (256 x 256, camera-like valid sizes), labels
    and source flags."""
    import numpy as np
    import torch

    from swat_tpu_torch.train.steps import batch_to_device

    valid_hw = np.stack([rng.integers(160, 257, n), np.full(n, 256)], axis=1)
    valid_hw[::2] = valid_hw[::2, ::-1]
    batch = batch_to_device(
        {"canvases": torch.from_numpy(rng.integers(
            0, 256, (n, 256, 256, 3), dtype=np.uint8)),
         "labels": rng.integers(0, n_classes, n),
         "source": rng.integers(0, 2, n)}, device)
    batch["valid_hw"] = valid_hw
    return batch


def _train_setup(ckpt):
    """The full-width model from the seeded checkpoint, one batch of
    TRAIN_BSZ random uint8 canvases on the card, and a random head."""
    import numpy as np
    import torch

    from swat_tpu_torch.models.clip import CLIPModel
    from swat_tpu_torch.models.configs import get_model_config

    cfg = get_model_config(MODEL_CFG)
    model = CLIPModel(cfg)
    model.load_state_dict(torch.load(ckpt))
    model.cuda()
    rng = np.random.default_rng(0)
    n_classes = 10
    batch = _canvas_batch(rng, TRAIN_BSZ, n_classes, torch.device("cuda"))
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
        busy, window, split, others = _profiled(lambda: run("kernel"), 3,
                                                _device_split)
        parts = ", ".join(f"{k} {v:.2f} ({100 * v / max(busy, 1e-9):.1f} %)"
                          for k, v in split.items())
        log(f"[train-step] {dname} profile, device ms per kernel step: "
            f"{busy:.2f} busy of a {window:.2f} ms window (idle "
            f"{_idle(busy, window)}; the same profiled steps) "
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


def _twin_batch(rng, n):
    """``n`` seeded random uint8 canvases on the card, with their valid
    sizes, labels and source, as a twin loader's batch (*_fs keys)."""
    import numpy as np
    import torch

    valid_hw = np.stack([rng.integers(160, 257, n), np.full(n, 256)],
                        axis=1)
    valid_hw[1::2] = valid_hw[1::2, ::-1]
    return {"canvases_fs": torch.from_numpy(rng.integers(
                0, 256, (n, 256, 256, 3), dtype=np.uint8)).cuda(),
            "valid_hw_fs": valid_hw,
            "labels_fs": torch.from_numpy(rng.integers(0, 10, n)).cuda(),
            "source_fs": torch.ones(n, dtype=torch.long).cuda()}


def _visual_grads(model):
    return {n: p.grad.detach().float().flatten().clone()
            for n, p in model.named_parameters() if p.grad is not None}


def _compare_grads(got, ref):
    """-> (min cosine over the tensors, the tensor, bit-equal share of all
    elements)."""
    import torch

    cos = {n: float(torch.nn.functional.cosine_similarity(
        got[n].double(), ref[n].double(), dim=0))
        for n in got if ref[n].abs().max() > 0}
    worst = min(cos, key=cos.get)
    equal = sum(int((got[n] == ref[n]).sum()) for n in got)
    total = sum(got[n].numel() for n in got)
    return cos[worst], worst, equal / total


# the twin methods and their twin batch: half the batch for the two that
# join it (fewshot_ratio 0.5), the whole batch for the two that mix row
# against row
TWIN_STEP = (("cutmix-fs", TRAIN_BSZ // 2), ("mixup-fs", TRAIN_BSZ),
             ("CMO", TRAIN_BSZ), ("finetune-mixed", TRAIN_BSZ // 2))


def phase_twin_step(ckpt, smi):
    """One full-width ViT-B/32 step at bsz 256 of each twin-loader method
    (cutmix-fs, mixup-fs, CMO, finetune-mixed; mix_prob 1), fp32 and bf16,
    from seeded uint8 canvases, the twin batch at its own size: the visual
    gradients with the kernels against plain attention, then one step with
    the counts set to 0 just before it and read just after (one encode a
    step: 12 launches each, on the joined batch for cutmix-fs and
    finetune-mixed), then 3 steps timed."""
    import numpy as np
    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.train.losses import cross_entropy
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import (make_ce_step, make_encode_loss,
                                            make_mix_fn, make_mixing_step,
                                            make_sampler)

    cfg, model, batch, head, rng = _train_setup(ckpt)
    n_px, layers = cfg.vision.image_size, cfg.vision.layers
    results = {}
    for method, twin_bsz in TWIN_STEP:
        twin = dict(batch, **_twin_batch(rng, twin_bsz))
        sample = make_sampler(method, mix_prob=1.0, image_size=n_px)
        for dname, precision in (("float32", FP32_PRECISION),
                                 ("bfloat16", DEFAULT_PRECISION)):
            precision.apply_backend_flags()
            model.precision = precision
            state = create_train_state(model, head, method, total_iter=100)
            draws = sample(rng, twin)
            mix = make_mix_fn(method, image_size=n_px)
            grads = {}
            for attn_name, attn in (("kernel", FA.mha_qkv),
                                    ("plain", FA.mha_qkv_reference)):
                state.optimizer.zero_grad(set_to_none=True)
                loss = make_encode_loss(cross_entropy, attn)(
                    state, mix(state, twin, draws))
                loss.backward()
                grads[attn_name] = (loss.item(), _visual_grads(model))
            (lk, gk), (lp, gp) = grads["kernel"], grads["plain"]
            cos, worst, share = _compare_grads(gk, gp)
            del grads, gk, gp
            state.optimizer.zero_grad(set_to_none=True)
            step = (make_ce_step(image_size=n_px, concat_fs=True)
                    if method == "finetune-mixed"
                    else make_mixing_step(method, image_size=n_px))
            _reset_counts(FA)
            val = float(step(state, twin, draws))
            torch.cuda.synchronize()
            counts = _counts(FA)
            ms = _time_ms(lambda: step(state, twin, draws), iters=3,
                          warmup=0)
            encode = TRAIN_BSZ + (twin_bsz if method in (
                "cutmix-fs", "finetune-mixed") else 0)
            ok = (np.isfinite(lk) and np.isfinite(val)
                  and cos >= GRAD_MIN_COS[dname]
                  and counts == (layers, layers, 0, 0))
            log(f"[twin-step] {MODEL_CFG} {method} bsz {TRAIN_BSZ} + twin "
                f"{twin_bsz} (encode {encode}) {dname}: loss kernel "
                f"{lk:.6f} / plain {lp:.6f}; min cosine of the visual grads "
                f"kernel vs plain = {cos:.8f} ({worst}; bound "
                f"{GRAD_MIN_COS[dname]}), bit-equal share {share:.4f}; "
                f"launches fwd {counts[0]} bwd {counts[1]} heads-first "
                f"{counts[2]}/{counts[3]} (need {layers}, {layers}, 0, 0); "
                f"{ms:.2f} ms/step ({encode * 1e3 / ms:.1f} encoded "
                f"images/s) on {smi} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{method} step failed ({dname})")
            results[(method, dname)] = ms
            del state, step
    del model
    torch.cuda.empty_cache()
    return results


def _prompt_tokens(rng, n, text_cfg):
    """``n`` seeded token rows as the tokenizer makes them: the start
    token, 3-40 word ids, the end token (the largest id, where the text
    tower pools), zeros to the context length."""
    import numpy as np

    ctx, vocab = text_cfg.context_length, text_cfg.vocab_size
    tokens = np.zeros((n, ctx), np.int64)
    for i, length in enumerate(rng.integers(4, 42, n)):
        tokens[i, 0] = vocab - 2
        tokens[i, 1:length] = rng.integers(1, vocab - 2, length - 1)
        tokens[i, length] = vocab - 1
    return tokens


def phase_flyp_step(ckpt, smi):
    """One full-width ViT-B/32 FLYP step at bsz 256 (seeded canvases and
    prompt rows on the card: augment, both towers forward and backward, the
    [256, 256] contrastive loss both ways, AdamW over both towers), fp32
    and bf16: the loss and the gradients of both towers, both projections
    and logit_scale with the kernels against plain attention; one step with
    the counts set to 0 just before it and read just after (12 image + 12
    text causal launches of each packed-head kernel); after a warm-up step,
    3 steps timed with the peak allocated memory over them, and 2 steps
    profiled (busy time by kernel family, idle share of the window)."""
    import numpy as np
    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.train.losses import cross_entropy
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import (make_flyp_loss, make_flyp_step,
                                            make_sampler)

    cfg, model, batch, head, rng = _train_setup(ckpt)
    n_px = cfg.vision.image_size
    layers = cfg.vision.layers + cfg.text.layers
    batch["prompt_tokens"] = torch.from_numpy(
        _prompt_tokens(rng, TRAIN_BSZ, cfg.text)).cuda()
    draws = make_sampler("FLYP", image_size=n_px)(rng, batch)
    results = {}
    for dname, precision in (("float32", FP32_PRECISION),
                             ("bfloat16", DEFAULT_PRECISION)):
        precision.apply_backend_flags()
        model.precision = precision
        state = create_train_state(model, head, "FLYP", total_iter=100)
        grads = {}
        for attn_name, attn in (("kernel", FA.mha_qkv),
                                ("plain", FA.mha_qkv_reference)):
            state.optimizer.zero_grad(set_to_none=True)
            loss = make_flyp_loss(cross_entropy, n_px, attn)(state, batch,
                                                             draws)
            loss.backward()
            g = _visual_grads(model)
            g["logit_scale"] = state.logit_scale.grad.detach().flatten()
            grads[attn_name] = (loss.item(), g)
        (lk, gk), (lp, gp) = grads["kernel"], grads["plain"]
        n_text = sum(not n.startswith("visual.") for n in gk) - 1
        cos, worst, share = _compare_grads(gk, gp)
        del grads, gk, gp
        state.optimizer.zero_grad(set_to_none=True)
        step = make_flyp_step(image_size=n_px)
        _reset_counts(FA)
        val = float(step(state, batch, draws))
        torch.cuda.synchronize()
        counts = _counts(FA)
        torch.cuda.reset_peak_memory_stats()
        resting = torch.cuda.memory_allocated()
        ms = _time_ms(lambda: step(state, batch, draws), iters=3, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        busy, window, split, others = _profiled(
            lambda: step(state, batch, draws), 2, _device_split)
        need = (layers, layers, 0, 0)
        ok = (np.isfinite(lk) and np.isfinite(val) and n_text > 0
              and cos >= GRAD_MIN_COS[dname] and counts == need)
        log(f"[flyp-step] {MODEL_CFG} FLYP bsz {TRAIN_BSZ} {dname}: loss "
            f"kernel {lk:.6f} / plain {lp:.6f}; min cosine of the gradients "
            f"of both towers ({n_text} text tensors), both projections and "
            f"logit_scale kernel vs plain = {cos:.8f} ({worst}; bound "
            f"{GRAD_MIN_COS[dname]}), bit-equal share {share:.4f}; launches "
            f"fwd {counts[0]} bwd {counts[1]} heads-first "
            f"{counts[2]}/{counts[3]} (need {need}); {ms:.2f} ms/step "
            f"({TRAIN_BSZ * 1e3 / ms:.1f} image-text pairs/s), peak "
            f"{peak / 2 ** 30:.3f} GiB allocated (at rest "
            f"{resting / 2 ** 30:.3f}); profiled: {busy:.2f} ms busy of a "
            f"{window:.2f} ms window (idle {_idle(busy, window)}; "
            + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
            + "; largest 'other': "
            + "; ".join(f"{t:.2f} {n}" for t, n in others[:3])
            + f") on {smi} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"FLYP step failed ({dname}): {counts}")
        results[dname] = (ms, peak, busy, window)
        del state, step
    del model
    torch.cuda.empty_cache()
    return results


def _unlabeled_batch(rng, n):
    """``n`` seeded random uint8 canvases on the card with their valid
    sizes, as FixMatch's unlabeled batch (*_u keys)."""
    import numpy as np
    import torch

    valid_hw = np.stack([rng.integers(160, 257, n), np.full(n, 256)],
                        axis=1)
    valid_hw[1::2] = valid_hw[1::2, ::-1]
    return {"canvases_u": torch.from_numpy(rng.integers(
                0, 256, (n, 256, 256, 3), dtype=np.uint8)).cuda(),
            "valid_hw_u": valid_hw}


def _launches_of(prof):
    """(kernels, copies and sets, device ms, the three kernels of most
    device time as (ms, count, name)) of a torch.profiler run."""
    from torch.autograd import DeviceType

    kernels = copies = 0
    ms = 0.0
    top = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms += evt.self_device_time_total / 1e3
        if evt.key.startswith(("Memcpy", "Memset")):
            copies += evt.count
        else:
            kernels += evt.count
            top.append((evt.self_device_time_total / 1e3, evt.count,
                        evt.key[:50]))
    return kernels, copies, ms, sorted(top, reverse=True)[:3]


# RandAugment on the card against the CPU, the same draws: the ops that
# are integral on integral pixels must agree bit for bit; the whole strong
# view (the crop, whose fp32 products round differently on the two, then
# RandAugment, whose truncations can flip on that) in all but this share
RA_MAX_SHARE = 0.005
RA_EXACT_OPS = ("op_posterize", "op_solarize", "op_equalize",
                "op_translate_x", "op_translate_y")


def _rand_augment_checks(batch, draws, n_px, smi):
    """RandAugment(2, 10) of the strong view's 256 crops (224 x 224) on the
    card: its ms by CUDA events (10 calls after 2), its kernel launches and
    copies in one profiled call; the integral ops (each at the draws' first
    values, on the crops rounded to integers) bit-equal on the card and the
    CPU; the strong view (crop + flip + RandAugment) on the card against
    the CPU -> (ms, kernels, copies, share of values off by more than
    1e-3)."""
    import torch

    from swat_tpu_torch.kernels import augment as aug
    from swat_tpu_torch.kernels import randaugment as RA

    ra = draws.rand_augment
    cutout = n_px // 2

    def strong(canvases):
        crops = aug.hflip(aug.random_resized_crop(
            canvases, draws.strong.boxes, n_px), draws.strong.flips)
        return crops, RA.rand_augment(crops, ra, cutout)

    crops, s_card = strong(batch["canvases_u"])
    ms = _time_ms(lambda: RA.rand_augment(crops, ra, cutout), iters=10,
                  warmup=2)
    kernels, copies, busy, top = _launches_of(
        _trace(lambda: RA.rand_augment(crops, ra, cutout))[0])
    ints = crops.round().clamp(0, 255)
    exact = []
    for op, (fn, *_) in enumerate(RA.POOL):
        if fn.__name__ not in RA_EXACT_OPS:
            continue
        values = RA.op_values(op, ra.magnitudes[:, 0], ra.signs[:, 0])
        card = RA.apply_op(op, ints, values).cpu()
        host = RA.apply_op(op, ints.cpu(), values)
        exact.append((fn.__name__, torch.equal(card, host)))
    boxes = RA.cutout_box(ra.cutout, n_px, n_px, cutout)
    exact.append(("cutout", torch.equal(RA.cutout_abs(ints, boxes).cpu(),
                                        RA.cutout_abs(ints.cpu(), boxes))))
    crops_cpu, s_cpu = strong(batch["canvases_u"].cpu())
    crop_err = float((crops.cpu() - crops_cpu).abs().max())
    diff = (s_card.cpu() - s_cpu).abs()
    share = float((diff > 1e-3).float().mean())
    applied = int(ra.gates.sum())
    ok = all(e for _, e in exact) and share < RA_MAX_SHARE
    log(f"[fixmatch-step] RandAugment(2, 10) of {ra.ops.shape[0]} crops "
        f"{n_px} x {n_px}, cutout {cutout}, {applied} ops gated on: "
        f"{ms:.3f} ms a call (CUDA events), {kernels} kernel launches + "
        f"{copies} copies a call, {busy:.3f} ms of device time, the most in "
        + "; ".join(f"{t:.3f} ms x {n} {k}" for t, n, k in top)
        + "; integral ops card vs CPU bit-equal: "
        + ", ".join(f"{n} {e}" for n, e in exact)
        + f"; the strong view card vs CPU: crop max |diff| {crop_err:.3e}, "
        f"after RandAugment {100 * share:.4f} % of values off by > 1e-3 "
        f"(bound {100 * RA_MAX_SHARE} %), max {float(diff.max()):.3e} on "
        f"{smi} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("RandAugment on the card disagrees with the "
                             "CPU")
    return ms, kernels, copies, share


# every unlabeled row passes at threshold 0: the strong view is in the loss
# of each row, so its gradient is compared too
FIXMATCH_STEP_THRESHOLD = 0.0


def phase_fixmatch_step(ckpt, smi):
    """One full-width ViT-B/32 FixMatch step at bsz 256, mu 1: 256 labeled
    and 256 unlabeled seeded canvases on the card, the labeled crops, the
    weak view (crop, flip) and the strong view (crop, flip, RandAugment)
    encoded in one forward of 768 rows, fp32 and bf16.  RandAugment alone
    first (_rand_augment_checks); then the loss, mask rate and the
    gradients of the visual tensors and the head with the kernels against
    plain attention; one step with the counts set to 0 just before it and
    read just after (12 of each packed-head kernel); after a warm-up step,
    3 steps timed with the peak allocated memory over them, and 2 steps
    profiled (busy time by kernel family, idle share of the window)."""
    import numpy as np
    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import (make_fixmatch_loss,
                                            make_fixmatch_step, make_sampler)

    cfg, model, batch, head, rng = _train_setup(ckpt)
    n_px, layers = cfg.vision.image_size, cfg.vision.layers
    batch.update(_unlabeled_batch(rng, TRAIN_BSZ))
    draws = make_sampler("fixmatch")(rng, batch)
    ra = _rand_augment_checks(batch, draws, n_px, smi)
    rows = 3 * TRAIN_BSZ
    results = {"rand_augment": ra}
    for dname, precision in (("float32", FP32_PRECISION),
                             ("bfloat16", DEFAULT_PRECISION)):
        precision.apply_backend_flags()
        model.precision = precision
        state = create_train_state(model, head, "fixmatch", total_iter=100)
        grads = {}
        for attn_name, attn in (("kernel", FA.mha_qkv),
                                ("plain", FA.mha_qkv_reference)):
            state.optimizer.zero_grad(set_to_none=True)
            loss, rate, loss_u = make_fixmatch_loss(
                FIXMATCH_STEP_THRESHOLD, 1.0, n_px, attn)(state, batch, draws)
            loss.backward()
            g = _visual_grads(model)
            g["head"] = state.head.grad.detach().flatten().clone()
            grads[attn_name] = (loss.item(), rate.item(), loss_u.item(), g)
        (lk, rk, uk, gk), (lp, rp, up, gp) = grads["kernel"], grads["plain"]
        cos, worst, share = _compare_grads(gk, gp)
        del grads, gk, gp
        state.optimizer.zero_grad(set_to_none=True)
        step = make_fixmatch_step(FIXMATCH_STEP_THRESHOLD, 1.0, n_px)
        _reset_counts(FA)
        val = float(step(state, batch, draws))
        torch.cuda.synchronize()
        counts = _counts(FA)
        torch.cuda.reset_peak_memory_stats()
        resting = torch.cuda.memory_allocated()
        ms = _time_ms(lambda: step(state, batch, draws), iters=3, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        busy, window, split, others = _profiled(
            lambda: step(state, batch, draws), 2, _device_split)
        need = (layers, layers, 0, 0)
        same_loss = dname != "float32" or abs(lk - lp) <= 1e-5 * abs(lp)
        ok = (np.isfinite(lk) and np.isfinite(val) and rk == rp == 1.0
              and cos >= GRAD_MIN_COS[dname] and counts == need
              and same_loss and not state.logit_scale.requires_grad)
        log(f"[fixmatch-step] {MODEL_CFG} fixmatch bsz {TRAIN_BSZ} mu 1 "
            f"({rows} rows a forward) {dname}: loss kernel {lk:.6f} / plain "
            f"{lp:.6f} (loss_u {uk:.6f} / {up:.6f}, mask rate {rk:.3f} / "
            f"{rp:.3f} at threshold {FIXMATCH_STEP_THRESHOLD}); min cosine "
            f"of the visual and head gradients kernel vs plain = {cos:.8f} "
            f"({worst}; bound {GRAD_MIN_COS[dname]}), bit-equal share "
            f"{share:.4f}; launches fwd {counts[0]} bwd {counts[1]} "
            f"heads-first {counts[2]}/{counts[3]} (need {need}); {ms:.2f} "
            f"ms/step ({rows * 1e3 / ms:.1f} encoded images/s), peak "
            f"{peak / 2 ** 30:.3f} GiB allocated (at rest "
            f"{resting / 2 ** 30:.3f}); profiled: {busy:.2f} ms busy of a "
            f"{window:.2f} ms window (idle {_idle(busy, window)}; "
            + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
            + "; largest 'other': "
            + "; ".join(f"{t:.2f} {n}" for t, n in others[:3])
            + f") on {smi} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fixmatch step failed ({dname}): {counts}")
        results[dname] = (ms, peak, busy, window)
        del state, step
    del model
    torch.cuda.empty_cache()
    return results


def phase_head_steps(ckpt, smi):
    """One full-width ViT-B/32 step at bsz 256, fp32, of finetune-multitask
    (the class head and a seeded binary dataset head) and of dataset-cls (a
    binary head, the source flag as the label), from seeded canvases on the
    card: the loss and the gradients of the visual tensors and the heads
    with the kernels against plain attention; one step with the counts set
    to 0 just before it and read just after (12 of each packed-head
    kernel); 3 steps timed after a warm-up step."""
    import numpy as np
    import torch

    from swat_tpu_torch.core.precision import FP32_PRECISION
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.models.head import init_head_random
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import (make_dataset_cls_loss,
                                            make_dataset_cls_step,
                                            make_multitask_loss,
                                            make_multitask_step,
                                            make_sampler)

    cfg, model, batch, head, rng = _train_setup(ckpt)
    n_px, layers, dim = cfg.vision.image_size, cfg.vision.layers, \
        cfg.embed_dim
    FP32_PRECISION.apply_backend_flags()
    model.precision = FP32_PRECISION
    results = {}
    for method in ("finetune-multitask", "dataset-cls"):
        multitask = method == "finetune-multitask"
        state = create_train_state(
            model, head if multitask else init_head_random(1, 2, dim, "cuda"),
            method, total_iter=100,
            dataset_head=init_head_random(2, 2, dim, "cuda") if multitask
            else None)
        draws = make_sampler(method, image_size=n_px)(rng, batch)
        grads = {}
        for attn_name, attn in (("kernel", FA.mha_qkv),
                                ("plain", FA.mha_qkv_reference)):
            state.optimizer.zero_grad(set_to_none=True)
            loss_fn = (make_multitask_loss(image_size=n_px, attention=attn)
                       if multitask else
                       make_dataset_cls_loss(image_size=n_px, attention=attn))
            loss = loss_fn(state, batch, draws)
            loss.backward()
            g = _visual_grads(model)
            g["head"] = state.head.grad.detach().flatten().clone()
            if multitask:
                g["dataset_head"] = state.dataset_head.grad.detach(
                    ).flatten().clone()
            grads[attn_name] = (loss.item(), g)
        (lk, gk), (lp, gp) = grads["kernel"], grads["plain"]
        cos, worst, share = _compare_grads(gk, gp)
        del grads, gk, gp
        state.optimizer.zero_grad(set_to_none=True)
        step = (make_multitask_step(image_size=n_px) if multitask
                else make_dataset_cls_step(image_size=n_px))
        _reset_counts(FA)
        val = float(step(state, batch, draws))
        torch.cuda.synchronize()
        counts = _counts(FA)
        ms = _time_ms(lambda: step(state, batch, draws), iters=3, warmup=1)
        need = (layers, layers, 0, 0)
        ok = (np.isfinite(lk) and np.isfinite(val)
              and cos >= GRAD_MIN_COS["float32"] and counts == need
              and abs(lk - lp) <= 1e-5 * abs(lp))
        log(f"[head-step] {MODEL_CFG} {method} bsz {TRAIN_BSZ} float32: "
            f"loss kernel {lk:.6f} / plain {lp:.6f}; min cosine of the "
            f"visual and head gradients kernel vs plain = {cos:.8f} ({worst}; "
            f"bound {GRAD_MIN_COS['float32']}), bit-equal share {share:.4f}; "
            f"launches fwd {counts[0]} bwd {counts[1]} heads-first "
            f"{counts[2]}/{counts[3]} (need {need}); {ms:.2f} ms/step "
            f"({TRAIN_BSZ * 1e3 / ms:.1f} images/s) on {smi} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{method} step failed: {counts}")
        results[method] = ms
        del state, step
    del model
    torch.cuda.empty_cache()
    return results


# the remat / accum policies of the [memory] phase: (name, remat, accum)
MEMORY_POLICIES = (("none", False, 1), ("full", "full", 1),
                   ("first4", "first4", 1), ("dots", "dots", 1),
                   ("dots_all", "dots_all", 1), ("accum2", False, 2),
                   ("accum8", False, 8))
# remat recomputes the same arithmetic: bit-equal is expected, and these
# bounds only catch a wrong recompute.  Accumulation sums the microbatches'
# gradients in another order (fp32); in bf16 each microbatch's weight
# gradient is also rounded to bf16 before the sum (the gradient of the
# bf16 copy of an fp32 weight), as in swat_tpu: the bf16 tower bound
REMAT_MIN_COS = {"float32": 1 - 1e-6, "bfloat16": 1 - 1e-3}
ACCUM_MIN_COS = {"float32": 1 - 1e-5, "bfloat16": 1 - 1e-3}


def phase_memory(ckpt, smi):
    """The full-width ViT-B/32 cutmix step at bsz 256, fp32 and bf16, under
    each remat policy and gradient accumulation (MEMORY_POLICIES): first
    the visual gradients of each against no remat on the same draws and
    weights (bit-equal share and cosine; accumulation also its loss), then
    per policy one untimed step, the peak-memory counter reset, one step
    with the launch counts set to 0 just before it and read just after
    (mha_fwd 12 x accum plus the recomputed blocks, mha_bwd 12 x accum),
    3 steps timed (the peak is torch.cuda.max_memory_allocated over those
    4 steps), and one step profiled (device busy time by kernel family)."""
    import numpy as np
    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.models.clip import resolve_remat_policy
    from swat_tpu_torch.train.losses import cross_entropy
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import (accum_backward, make_encode_loss,
                                            make_mix_fn, make_mixing_step,
                                            make_sampler)

    cfg, model, batch, head, rng = _train_setup(ckpt)
    n_px, layers = cfg.vision.image_size, cfg.vision.layers
    sample = make_sampler("cutmix", mix_prob=1.0, image_size=n_px)
    mix = make_mix_fn("cutmix", image_size=n_px)
    encode_loss = make_encode_loss(cross_entropy)
    results = {}
    for dname, precision in (("float32", FP32_PRECISION),
                             ("bfloat16", DEFAULT_PRECISION)):
        precision.apply_backend_flags()
        model.precision = precision
        state = create_train_state(model, head, "cutmix", total_iter=100)
        draws = sample(rng, batch)
        ref = None
        for name, remat, accum in MEMORY_POLICIES:
            model.remat = remat
            state.optimizer.zero_grad(set_to_none=True)
            if accum > 1:
                with torch.no_grad():
                    mixed = mix(state, batch, draws)
                loss = accum_backward(state, encode_loss, mixed, accum)
            else:
                loss = encode_loss(state, mix(state, batch, draws))
                loss.backward()
            grads = (loss.item(), _visual_grads(model))
            if ref is None:
                ref = grads
                continue
            cos, worst, share = _compare_grads(grads[1], ref[1])
            bound = (ACCUM_MIN_COS if accum > 1 else REMAT_MIN_COS)[dname]
            ok = cos >= bound and (accum > 1 or grads[0] == ref[0])
            log(f"[memory] {dname} {name}: loss {grads[0]:.6f} (no remat "
                f"{ref[0]:.6f}); visual grads against no remat: bit-equal "
                f"share {share:.6f}, min cosine {cos:.10f} ({worst}; bound "
                f"{bound}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} gradients disagree ({dname})")
            del grads
        del ref
        state.optimizer.zero_grad(set_to_none=True)
        for name, remat, accum in MEMORY_POLICIES:
            model.remat = remat
            _, _, first_k = resolve_remat_policy(remat)
            recomputed = 0 if not remat else min(first_k or layers, layers)
            step = make_mixing_step("cutmix", image_size=n_px, accum=accum)
            step(state, batch, draws)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resting = torch.cuda.memory_allocated()
            _reset_counts(FA)
            val = float(step(state, batch, draws))
            torch.cuda.synchronize()
            counts = _counts(FA)
            ms = _time_ms(lambda: step(state, batch, draws), iters=3,
                          warmup=0)
            peak = torch.cuda.max_memory_allocated()
            # one more step profiled: device busy time by kernel family in
            # a window of CUDA events around it
            busy, window, split, _ = _profiled(
                lambda: step(state, batch, draws), 1, _device_split)
            need = ((layers + recomputed) * accum, layers * accum, 0, 0)
            ok = np.isfinite(val) and counts == need
            log(f"[memory] {MODEL_CFG} cutmix bsz {TRAIN_BSZ} {dname} "
                f"{name}: peak {peak / 2 ** 30:.3f} GiB allocated (at rest "
                f"{resting / 2 ** 30:.3f} GiB: weights, gradients, optimizer "
                f"state, the batch), {ms:.2f} ms/step ({TRAIN_BSZ * 1e3 / ms:.1f}"
                f" images/s); profiled step: {busy:.2f} ms busy of a "
                f"{window:.2f} ms window (idle "
                f"{_idle(busy, window)}; "
                + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
                + f"); launches fwd {counts[0]} bwd {counts[1]} "
                f"heads-first {counts[2]}/{counts[3]} (need {need[0]}, "
                f"{need[1]}, 0, 0) on {smi} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} step failed ({dname}): "
                                     f"{counts}")
            results[(name, dname)] = (peak, ms)
            del step
        model.remat = False
        del state
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
UNLABELED_SPLIT = "u_train_in_oracle.txt"
N_UNLABELED = 130
CLI_BSZ = 64
N_FEWSHOT, N_RETRIEVED, N_TEST = 40, 220, 150   # the smoke splits
# the flagship run's batch: few-shot finetuning's drop-last loader refuses
# a batch larger than the 40 few-shot images, in both packages
FLAGSHIP_BSZ = 32
STAGE_FILES = ("test_confusion_matrix.npy", "test_scores.json",
               "val_confusion_matrix_best.npy", "val_scores_best.json")


@contextlib.contextmanager
def _entry_counts(FA, *names):
    """The four launch counts of each named SwatPipeline entry point of the
    runs made inside (by default the two of stage 2), each wrapped to read
    the counts before and after -> {name: counts}."""
    from swat_tpu_torch.train import stages

    per = {}
    saved = {}
    for name in names or ("run_stage2_probing", "run_stage2_fsft"):
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


@contextlib.contextmanager
def _train_loop_counts(FA):
    """The launch counts of the training steps alone of each train_loop run
    inside (SwatPipeline.train_method's, stage 2's included): the counts
    over the loop less those made by its validate_fn and test_fn ->
    [counts, ...] in the order of the loops."""
    from swat_tpu_torch.train import stages

    per = []
    real = stages.train_loop

    def counted(*, validate_fn, test_fn, **kw):
        evals = [0, 0, 0, 0]

        def counting(fn):
            def wrapped(state):
                before = _counts(FA)
                try:
                    return fn(state)
                finally:
                    for i, (a, b) in enumerate(zip(_counts(FA), before)):
                        evals[i] += a - b
            return wrapped

        before = _counts(FA)
        try:
            return real(validate_fn=counting(validate_fn),
                        test_fn=counting(test_fn), **kw)
        finally:
            per.append(tuple(a - b - e for a, b, e in
                             zip(_counts(FA), before, evals)))

    stages.train_loop = counted
    try:
        yield per
    finally:
        stages.train_loop = real


def _train_cli_run(workdir, ckpt, dataset, method, dtype, resident, smi,
                   extra=(), bsz=CLI_BSZ, tag="", rows_want=2, stage2=False,
                   summary_row=True, model_cfg=MODEL_CFG, launcher=False):
    """One run of ``method`` through swat_tpu_torch.cli.main at full width
    (2 epochs at ``bsz`` unless ``extra`` says otherwise; --skip_stage2
    unless ``stage2``), its summary line, loss.csv (``rows_want`` rows) and
    output files checked; without ``summary_row`` (dataset-cls) the run
    must print no summary line and write no stage file.  The four counts
    are set to 0 just before the run and read just after -> dict of what
    it gave.  ``launcher``: the run is one process started by
    ``torch.distributed.run --standalone --nproc_per_node 1`` (on NCCL),
    which counts its own launches (``_dist_child``)."""
    import csv
    import io
    import math
    import os
    import re

    from swat_tpu_torch.cli.main import main as cli_main
    from swat_tpu_torch.kernels import flash_attention as FA

    folder = f"{workdir}/train_{model_cfg}_{method}_{dtype}_{resident}{tag}"
    argv = ["--dataset", dataset, "--method", method,
            "--data_source", "fewshot+retrieved",
            "--retrieval_split", RETRIEVAL_SPLIT,
            "--shots", "4", "--epochs", "2",
            *(() if stage2 else ("--skip_stage2",)),
            "--bsz", str(bsz), "--model_cfg", model_cfg,
            "--checkpoint_path", ckpt,
            "--config_yml", f"{workdir}/config.yml",
            "--folder", folder, "--compute_dtype", dtype,
            "--resident", resident, "--num_workers", "8",
            "--recal_prompt", "--device", "cuda", *extra]
    if launcher:
        out, counts, loops, wall = _launched_cli(workdir, argv)
    else:
        _reset_counts(FA)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), \
                _train_loop_counts(FA) as loops:
            cli_main(argv)
        wall = time.perf_counter() - t0
        counts = _counts(FA)
        out = buf.getvalue()
    summary = [ln for ln in out.splitlines()
               if ln.startswith(f"{dataset},{method},")]
    if not summary_row:
        if summary:
            raise AssertionError(f"{method} printed a summary row: {summary}")
        summary = [f"{dataset},{method}: no summary row"]
    elif len(summary) != 1 or len(summary[0].split(",")) != 11:
        raise AssertionError(f"no 11-field summary line:\n{out[-2000:]}")
    else:
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
    stages = (() if not summary_row else (2, 3) if skipped_stage1
              else (1, 2, 3) if stage2 else (1,))
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
            or {f[:6] for f in arrays} != {f"stage{n}" for n in stages} \
            or (not stages and any(f.startswith("stage") for f in files)):
        raise AssertionError(f"outputs missing: {missing} (bundle files "
                             f"{bundles})")
    resident_run = "resident epochs" in out
    rate = re.findall(r"Epoch \d+, Iter \d+, .*?, (\d+) img/s", out)
    # the steps of the rows' stage: a resumed run counts on from its
    # checkpoint's iteration
    steps = len(rows) * (int(rows[0]["Iter"]) // int(rows[0]["Epoch"]))
    log(f"[{'dist' if launcher else 'train-cli'}] {model_cfg} {method} "
        f"{dtype} resident={resident}{tag}"
        f"{' (resident epochs)' if resident_run else ' (streaming)'}: "
        f"{summary[0]} | train loss "
        f"{' -> '.join(f'{x:.6f}' for x in losses[:2])} | "
        f"{len(rows)} loss.csv rows, {steps} steps at bsz {bsz} in "
        f"{wall:.3f} s, rates "
        f"{'/'.join(rate[:4])} images/s (host clock, decode included when "
        f"streaming) on {smi} | kernel launches fwd {counts[0]} bwd "
        f"{counts[1]} heads-first fwd {counts[2]} heads-first bwd "
        f"{counts[3]}; the training steps' own fwd {loops[0][0]} bwd "
        f"{loops[0][1]}")
    return {"counts": counts, "loops": loops, "steps": steps,
            "resident": resident_run,
            "out": out, "run_dir": run_dir, "rows": rows,
            "summary": summary[0], "wall": wall}


def _check_stage1_counts(run, method, layers, accum=1, remat=False):
    """Stage 1's training steps (the first train_loop of the run) launched
    exactly layers x accum x steps of mha_fwd plus the blocks remat
    recomputes, and as many mha_bwd; attentivemix as many heads-first
    forwards (its heatmaps, mix_prob 1); the whole run at least those."""
    from swat_tpu_torch.models.clip import resolve_remat_policy

    _, _, first_k = resolve_remat_policy(remat)
    recomputed = 0 if not remat else min(first_k or layers, layers)
    micro = accum * run["steps"]
    need = ((layers + recomputed) * micro, layers * micro,
            layers * run["steps"] if method == "attentivemix" else 0, 0)
    counts, train = run["counts"], run["loops"][0]
    log(f"[train-cli] {method}: stage-1 steps launched {train} (need "
        f"{need}: {run['steps']} steps x accum {accum}, remat {remat!r}); "
        f"the whole run {counts}")
    if train != need or any(c < n for c, n in zip(counts, need)):
        raise AssertionError(f"{method} training did not go through the "
                             f"attention kernels as counted: {train}, "
                             f"{counts}")


def _flagship(workdir, ckpt, dataset, smi, layers):
    """The flagship SWAT run at full width: stage 1 (cutmix, fp32, resident
    canvases), WiSE-FT, tau-norm, stage-2 probing on the few-shot
    train-transform snapshot features, few-shot finetuning; then stage 2
    alone from its stage-1 bundle (--skip_stage1).  -> (the runs' summed
    counts, the stage-2 counts, the full run's dict)."""
    import glob
    import math
    import re

    from swat_tpu_torch.kernels import flash_attention as FA

    with _entry_counts(FA) as per:
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
        "loops": full["loops"],
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
            stage2, full)


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


def _write_pseudo(root, dataset, n):
    """A --utrain file over the first ``n`` test images, one
    ``<path> <label>`` line each (the pseudo-labels of a model's dump;
    every fifth one wrong) -> its path."""
    import os

    ddir = os.path.join(root, dataset)
    with open(os.path.join(ddir, "test.txt")) as f:
        lines = f.read().split()
    path = os.path.join(root, "pseudo_labels.txt")
    with open(path, "w") as f:
        for i in range(n):
            rel, label = lines[3 * i], int(lines[3 * i + 1])
            f.write(f"{os.path.join(ddir, rel)} "
                    f"{(label + (i % 5 == 0)) % 10}\n")
    return path


N_PSEUDO = 60
# the twin-loader methods and the memory levers through the CLI at the
# flagship batch: (method, --resident, extra flags, tag, resident epochs
# expected, accum, remat)
TWIN_CLI_RUNS = (
    ("cutmix-fs", "auto", (), "", True, 1, False),
    ("mixup-fs", "off", ("--mix_prob", "1.0"), "_mix_prob1", False, 1,
     False),
    ("CMO", "auto", ("--utrain", None), "_utrain", True, 1, False),
    ("finetune-mixed", "off", ("--optim", "SGD"), "_sgd", False, 1, False),
    ("cutmix", "off", ("--accum", "4"), "_accum4", False, 4, False),
    ("cutmix", "auto", ("--remat", "full"), "_remat_full", True, 1, "full"))


def phase_twin_cli(workdir, ckpt, dataset, smi):
    """Stage 1 of the twin-loader methods and the memory levers through
    swat_tpu_torch.cli.main at full width, fp32, bsz 32, 2 epochs:
    cutmix-fs with its twin resident, mixup-fs streaming at mix_prob 1, CMO
    resident with --utrain (a pseudo-label file over 60 test images),
    finetune-mixed streaming with --optim SGD, cutmix streaming with
    --accum 4 and resident with --remat full.  Each run's summary line,
    loss.csv rows and output files are checked, its training steps'
    launches exactly.  -> the four counts summed over the runs."""
    from swat_tpu_torch.models.configs import get_model_config

    layers = get_model_config(MODEL_CFG).vision.layers
    pseudo = _write_pseudo(workdir, dataset, N_PSEUDO)
    total = [0, 0, 0, 0]
    for (method, resident, extra, tag, want_resident, accum,
         remat) in TWIN_CLI_RUNS:
        extra = tuple(pseudo if x is None else x for x in extra)
        n_train = N_FEWSHOT + N_RETRIEVED + (N_PSEUDO if method == "CMO"
                                             else 0)
        run = _train_cli_run(workdir, ckpt, dataset, method, "float32",
                             resident, smi, extra, bsz=FLAGSHIP_BSZ, tag=tag)
        # finetune-mixed's config takes half the batch from each loader
        bsz = FLAGSHIP_BSZ // (2 if method == "finetune-mixed" else 1)
        if run["steps"] != 2 * (n_train // bsz):
            raise AssertionError(f"{method}{tag}: {run['steps']} steps, "
                                 f"expected {2 * (n_train // bsz)}")
        _check_stage1_counts(run, method, layers, accum, remat)
        if run["resident"] != want_resident:
            raise AssertionError(f"{method}{tag}: resident epochs "
                                 f"{run['resident']}, expected "
                                 f"{want_resident}")
        if method == "CMO" and f"({N_PSEUDO} samples)" not in run["out"]:
            raise AssertionError("--utrain samples were not loaded")
        total = [t + c for t, c in zip(total, run["counts"])]
    return total


# the attribute corpus of CMLP --use_attribute, each class's
ATTRIBUTES = ("Has a smooth surface", "round shape", "bright color")
# the frozen methods and FLYP through the CLI: (method, bsz, extra flags,
# tag, through stage 2).  CMLP halves its batch; the bank of 10 class
# prompts (one template) gives a batch of 8 text rows, the attribute bank's
# 40 a batch of 16
METHOD_CLI_RUNS = (
    ("REAL-Linear", FLAGSHIP_BSZ, (), "", False),
    ("CMLP", 16, ("--pre_extracted",), "_pre_extracted", False),
    ("CMLP", FLAGSHIP_BSZ, ("--use_attribute", "True"), "_use_attribute",
     False),
    ("FLYP", FLAGSHIP_BSZ, (), "_stage2", True),
    ("FLYP", FLAGSHIP_BSZ, ("--locked_text", "--lr_projector", "1e-5"),
     "_locked_text", False))


def _method_need(method, extra, steps, cfg, n_prompts):
    """The exact launch counts (mha_fwd, mha_bwd, heads-first) of stage
    1's training steps: the probes encode without a graph when they stream
    (none on a snapshot's features); FLYP encodes and differentiates both
    towers, the text tower only where it trains (not under --locked_text:
    text_projection's gradient needs no backward through the tower), and
    rebuilds its head from the prompts, in batches of 1024, once (its one
    validating epoch)."""
    import math

    lv, lt = cfg.vision.layers, cfg.text.layers
    if method == "FLYP":
        bwd_text = 0 if "--locked_text" in extra else lt
        return ((lv + lt) * steps + lt * math.ceil(n_prompts / 1024),
                (lv + bwd_text) * steps, 0, 0)
    if "--pre_extracted" in extra:
        return (0, 0, 0, 0)
    return (lv * steps, 0, 0, 0)


def phase_method_cli(workdir, ckpt, dataset, smi):
    """Stage 1 of REAL-Linear (streaming), CMLP (a snapshot's features;
    streaming with --use_attribute over an attribute file written into the
    dataset) and FLYP (on into stage 2; --locked_text --lr_projector 1e-5)
    through swat_tpu_torch.cli.main at full width, fp32, 2 epochs.  Each
    run's summary line, loss.csv rows and output files are checked, its
    training steps' launches exactly (_method_need).  -> the four counts
    summed over the runs."""
    import os

    from swat_tpu_torch.models.configs import get_model_config

    cfg = get_model_config(MODEL_CFG)
    n_classes = 10
    attrs = {str(c): {"corpus": list(ATTRIBUTES)} for c in range(n_classes)}
    os.makedirs(f"{workdir}/{dataset}/prompts", exist_ok=True)
    with open(f"{workdir}/{dataset}/prompts/visual-attrs-{dataset}.json",
              "w") as f:
        json.dump(attrs, f)
    total = [0, 0, 0, 0]
    for method, bsz, extra, tag, stage2 in METHOD_CLI_RUNS:
        run = _train_cli_run(workdir, ckpt, dataset, method, "float32",
                             "auto", smi, extra, bsz=bsz, tag=tag,
                             rows_want=22 if stage2 else 2, stage2=stage2)
        step_bsz = bsz // 2 if method == "CMLP" else bsz
        steps = 2 * ((N_FEWSHOT + N_RETRIEVED) // step_bsz)
        need = _method_need(method, extra, steps, cfg, n_classes)
        train = run["loops"][0]
        ok = train == need and all(c >= n for c, n in
                                   zip(run["counts"], need))
        if method == "CMLP" and "--use_attribute" in extra:
            ok = ok and "CMLP: attribute prompts from" in run["out"]
        log(f"[train-cli] {method}{tag}: stage-1 steps launched {train} "
            f"(need {need}: {steps} steps at bsz {step_bsz}); the whole run "
            f"{run['counts']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{method}{tag} did not go through the "
                                 f"attention kernels as counted: {train}, "
                                 f"{run['counts']}")
        total = [t + c for t, c in zip(total, run["counts"])]
    return total


def _write_dataset_cls_splits(root, dataset):
    """dataset-cls's split files in the dataset: the few-shot images
    flagged 1 and the retrieved ones 0, each line with its absolute path
    (these splits' root is empty) -> the number of lines."""
    import os

    ddir = os.path.join(root, dataset)
    lines = []
    for name, flag in (("fewshot4_seed1.txt", 1), (RETRIEVAL_SPLIT, 0)):
        with open(os.path.join(ddir, name)) as f:
            for rel, label, _ in (ln.split() for ln in f if ln.strip()):
                lines.append(f"{os.path.join(ddir, rel)} {label} {flag}")
    for name in ("dataset_train.txt", "dataset_val.txt", "dataset_test.txt"):
        with open(os.path.join(ddir, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return len(lines)


# fixmatch through the CLI: the max softmax of the unscaled logits of a
# random tower over 10 classes lies in [1/10, 0.105) (no row passed 0.105
# on an H100), so at 1/10 every row passes and the strong view is in the
# loss of every step
FIXMATCH_CLI_THRESHOLD = 0.1


def phase_semi_cli(workdir, ckpt, dataset, smi):
    """Stage 1 of fixmatch (its unlabeled split streamed as canvases, mu 2,
    the labeled loader cycled beside it; each step's mask rate recorded by
    building the pipeline's step with aux=True), finetune-multitask (on
    into stage 2) and dataset-cls (--data_source dataset-cls: the few-shot
    and retrieved images flagged; no summary row, no stage file) through
    swat_tpu_torch.cli.main at full width, fp32, bsz 32, 2 epochs.  Each
    run's loss.csv rows and outputs are checked, its training steps'
    launches exactly (12 + 12 a step).  -> the four counts summed over the
    runs."""
    from swat_tpu_torch.models.configs import get_model_config
    from swat_tpu_torch.train import stages

    layers = get_model_config(MODEL_CFG).vision.layers
    n_flagged = _write_dataset_cls_splits(workdir, dataset)
    rates = []
    real = stages.make_fixmatch_step

    def recording(*args, **kw):
        step = real(*args, aux=True, **kw)

        def run(state, batch, draws):
            val, rate, _ = step(state, batch, draws)
            rates.append(rate)
            return val

        return run

    stages.make_fixmatch_step = recording
    try:
        fixmatch = _train_cli_run(
            workdir, ckpt, dataset, "fixmatch", "float32", "auto", smi,
            ("--mu", "2", "--threshold", str(FIXMATCH_CLI_THRESHOLD)),
            bsz=FLAGSHIP_BSZ, tag="_mu2")
    finally:
        stages.make_fixmatch_step = real
    steps = 2 * (N_UNLABELED // (2 * FLAGSHIP_BSZ))
    rates = [float(r) for r in rates]
    log(f"[train-cli] fixmatch: {fixmatch['steps']} steps (need {steps}: "
        f"{N_UNLABELED} unlabeled images at {2 * FLAGSHIP_BSZ} a step), "
        f"mask rates at threshold {FIXMATCH_CLI_THRESHOLD}: "
        + ", ".join(f"{r:.4f}" for r in rates))
    if fixmatch["steps"] != steps or len(rates) != steps:
        raise AssertionError(f"fixmatch ran {fixmatch['steps']} steps")
    _check_stage1_counts(fixmatch, "fixmatch", layers)
    multitask = _train_cli_run(workdir, ckpt, dataset, "finetune-multitask",
                               "float32", "auto", smi, bsz=FLAGSHIP_BSZ,
                               tag="_stage2", rows_want=22, stage2=True)
    if (multitask["out"].count("Dataset Val Acc:") != 2
            or multitask["out"].count("Dataset Test Acc:") != 2):
        raise AssertionError("multitask did not validate its dataset head "
                             "every epoch")
    # the rows of stage 2 follow stage 1's two
    _check_stage1_counts(dict(multitask, steps=2 * (
        (N_FEWSHOT + N_RETRIEVED) // FLAGSHIP_BSZ)), "finetune-multitask",
        layers)
    dscls = _train_cli_run(workdir, ckpt, dataset, "dataset-cls", "float32",
                           "auto", smi, ("--data_source", "dataset-cls"),
                           bsz=FLAGSHIP_BSZ, summary_row=False)
    if dscls["steps"] != 2 * (n_flagged // FLAGSHIP_BSZ) or \
            "dataset-cls run complete" not in dscls["out"]:
        raise AssertionError(f"dataset-cls ran {dscls['steps']} steps")
    _check_stage1_counts(dscls, "dataset-cls", layers)
    return [a + b + c for a, b, c in zip(fixmatch["counts"],
                                         multitask["counts"],
                                         dscls["counts"])]


# the stage-1 cutmix fp32 streaming run's flags: a one-device mesh, which
# changes nothing without a launcher, so that [dist] (a) repeats the run
# through the launcher as it is
DIST_RUN_EXTRA = ("--mesh_data", "1")


def phase_train_cli(workdir, ckpt, dataset, smi):
    """Training through swat_tpu_torch.cli.main at full width: the flagship
    run (stage 1 cutmix fp32 resident, then stage 2) and stage 2 alone from
    its bundle; stage-1 cutmix fp32 streaming, bf16 resident, with the host
    PIL transform (--aug_mode host), and --save_ckpt then --resume;
    attentivemix (streaming, its heatmaps through the heads-first forward
    at every step: --mix_prob 1) and mixup (resident) in fp32.  -> (the four
    counts summed over the runs, each run counted from 0; the stage-2
    counts of the flagship run; the stage-1 cutmix fp32 streaming run's
    dict, which [dist] repeats through the launcher; the flagship run's
    dict, which [tooling] repeats under --trace_dir)."""
    from swat_tpu_torch.models.configs import get_model_config

    layers = get_model_config(MODEL_CFG).vision.layers
    _write_retrieved(workdir, dataset, N_RETRIEVED // 10)
    total, stage2, flagship = _flagship(workdir, ckpt, dataset, smi, layers)
    total = [t + c for t, c in zip(total, _resume(workdir, ckpt, dataset,
                                                  smi, layers))]
    runs = [("cutmix", "float32", "off", DIST_RUN_EXTRA, False),
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
        if extra == DIST_RUN_EXTRA:
            plain = run
        total = [t + c for t, c in zip(total, run["counts"])]
    return total, stage2, plain, flagship


# ---------------------------------------------------------------------------
# [dist]: the parallel layer on the one card (core/mesh.py,
# core/distributed.py, models/clip.py's tensor parallelism).  The machine
# has one GPU and NCCL takes one rank a device, so the card runs world size
# 1 through the real launcher and the two tensor-parallel shards in one
# process; the sharded math at world sizes 2 and 4 is held on gloo CPU
# ranks by the tests (tests/test_torch_multichip.py, _multihost.py).


def _dist_child(args_path: str) -> int:
    """The launcher's one process: ``swat_tpu_torch.cli.main`` on the argv
    in ``args_path``, its four counts set to 0 just before and read just
    after, printed with the training loops' own as the last line."""
    from swat_tpu_torch.cli.main import main as cli_main
    from swat_tpu_torch.kernels import flash_attention as FA

    with open(args_path) as f:
        argv = json.load(f)
    _reset_counts(FA)
    t0 = time.perf_counter()
    with _train_loop_counts(FA) as loops:
        cli_main(argv)
    wall = time.perf_counter() - t0
    print("DIST_CHILD " + json.dumps({"counts": _counts(FA),
                                      "loops": loops, "wall": wall}),
          flush=True)
    return 0


def _launched_cli(workdir, argv):
    """``argv`` through ``torch.distributed.run --standalone
    --nproc_per_node 1`` -> (its standard output, counts, training-loop
    counts, wall seconds of the CLI inside it)."""
    import os

    path = f"{workdir}/dist_argv.json"
    with open(path, "w") as f:
        json.dump(argv, f)
    here = os.path.abspath(__file__)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", here, "--dist-child", path],
        cwd=os.path.dirname(here), capture_output=True, text=True,
        timeout=600)
    launched = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the launched CLI run failed:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("DIST_CHILD ")][-1]
    got = json.loads(line[len("DIST_CHILD "):])
    log(f"[dist] launcher process: {launched:.3f} s wall, the CLI inside "
        f"{got['wall']:.3f} s")
    return (proc.stdout, tuple(got["counts"]),
            [tuple(c) for c in got["loops"]], got["wall"])


def phase_dist_launcher(workdir, ckpt, dataset, smi, plain):
    """(a) The stage-1 cutmix fp32 streaming run through the launcher on
    one card, ``--mesh_data 1``, on NCCL, beside the same run without a
    launcher (``plain``, ``[train-cli]``'s): the same summary line,
    ``loss.csv`` rows and mha_fwd / mha_bwd launches.  At world size 1 the
    mesh runs no collective: only the process group's start and end touch
    NCCL (``tests/test_torch_cuda.py`` drives every collective through a
    one-rank NCCL group).  -> the launched run's counts."""
    launched = _train_cli_run(
        workdir, ckpt, dataset, "cutmix", "float32", "off", smi,
        DIST_RUN_EXTRA, tag="_launcher", launcher=True)
    rows = [[r[k] for k in r] for r in plain["rows"]]
    rows_l = [[r[k] for k in r] for r in launched["rows"]]
    group = [ln for ln in launched["out"].splitlines()
             if "Process group:" in ln]
    log(f"[dist] (a) launcher, 1 process, --mesh_data 1: {launched['summary']}"
        f" | without: {plain['summary']} | {group[0].split(' - ')[-1] if group else 'no process group logged'}"
        f" | launches fwd/bwd {launched['counts'][:2]} vs {plain['counts'][:2]}"
        f" | wall {launched['wall']:.3f} / {plain['wall']:.3f} s on {smi}")
    for a, b in zip(rows_l, rows):
        log(f"    {','.join(a)} | {','.join(b)}")
    if (launched["summary"] != plain["summary"] or rows_l != rows
            or launched["counts"][:2] != plain["counts"][:2]
            or not any("backend nccl, 1 process" in g for g in group)):
        raise AssertionError("the launched run differs from the run "
                             "without a launcher")
    return list(launched["counts"])


# ---------------------------------------------------------------------------
# [tooling]: the reproduction runbook (cli/repro.py, scored by
# analysis/results.py) and --trace_dir (utils/profiling.py) on the card.

REPRO_CONFIGS = ("zeroshot", "swat")
# the device kernels a launch of each wrapper runs, by the name the trace
# gives them: the forward one kernel a call; the backward one kernel a call
# up to S = 128 rows (the head kernel), else a dq / dkv pair, whose dq
# kernel is counted
TRACE_KERNELS = {"mha_fwd": ("attention_fwd_kernel",),
                 "mha_bwd": ("attention_bwd_head_kernel",
                             "attention_bwd_dq_kernel")}


def _repro_run(workdir, ckpt, dataset, smi):
    """(a) ``python -m swat_tpu_torch.cli.repro --device cuda
    --allow_hash_tokenizer --configs zeroshot swat --epochs_override 1
    --execute`` on the smoke dataset (4 shots, seed 1, the smoke's
    retrieved split), run in this process so that its launches count: the
    preflight (the checkpoint encoded on the card), the plan, both runs'
    rows, both CSVs and the score section.  -> its four counts."""
    import io
    import os
    import re

    from swat_tpu_torch.cli import repro
    from swat_tpu_torch.kernels import flash_attention as FA

    out_dir = f"{workdir}/repro"
    argv = ["--checkpoint", ckpt, "--model_cfg", MODEL_CFG,
            "--dataset_path", workdir, "--retrieved_path", workdir,
            "--retrieval_split", RETRIEVAL_SPLIT, "--datasets", dataset,
            "--configs", *REPRO_CONFIGS, "--shots", "4", "--seeds", "1",
            "--epochs_override", "1", "--allow_hash_tokenizer",
            "--out", out_dir, "--execute", "--device", "cuda"]
    _reset_counts(FA)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = repro.run(argv)
    wall = time.perf_counter() - t0
    counts = _counts(FA)
    out = buf.getvalue()
    # the runbook's own lines; the runs' log lines carry a timestamp
    for line in out.splitlines():
        if line.strip() and not re.match(r"\d{4}-\d\d-\d\d ", line):
            log(f"[tooling] (a) | {line}")
    rows = {}
    for cname in REPRO_CONFIGS:
        path = os.path.join(out_dir, f"{cname}_{dataset}.csv")
        with open(path) as f:
            rows[cname] = f.read().splitlines()
    log(f"[tooling] (a) repro --device cuda, configs {' '.join(REPRO_CONFIGS)}"
        f": exit {rc} in {wall:.3f} s on {smi} | launches fwd {counts[0]} "
        f"bwd {counts[1]} heads-first {counts[2]} / {counts[3]}")
    accs = [float(x) for r in rows.values() for x in r[-1].split(",")[7:]]
    if (rc != 0 or "== score vs paper ==" not in out
            or any(len(r) != 2 or r[0] != repro.CSV_HEADER
                   or len(r[1].split(",")) != 11 for r in rows.values())
            or not all(a == -1.0 or 0.0 <= a <= 100.0 for a in accs)):
        raise AssertionError(f"the runbook failed or its CSVs are malformed "
                             f"(exit {rc}): {rows}\n{out[-2000:]}")
    if counts[0] <= 0 or counts[1] <= 0 or counts[2:] != (0, 0):
        raise AssertionError(f"the runbook's runs did not go through mha_fwd "
                             f"and mha_bwd: {counts}")
    return counts


def _trace_kernels(trace_dir):
    """The Chrome traces under trace_dir -> (their paths, MB, the kernels
    of TRACE_KERNELS counted, every device kernel event, their device ms,
    the attention kernels' names)."""
    import glob
    import os
    import re

    from swat_tpu_torch.utils.profiling import TRACE_SUFFIX

    paths = sorted(glob.glob(f"{trace_dir}/*{TRACE_SUFFIX}"))
    found = {k: 0 for k in TRACE_KERNELS}
    n_kernels, busy_us, names = 0, 0.0, set()
    for path in paths:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        for e in events:
            if e.get("cat") != "kernel":
                continue
            n_kernels += 1
            busy_us += e.get("dur", 0)
            for family, marks in TRACE_KERNELS.items():
                if any(m in e.get("name", "") for m in marks):
                    found[family] += 1
                    m = re.search(r"attention_\w+_kernel<[^>]*>", e["name"])
                    names.add(m.group(0) if m else e["name"][:90])
    mb = sum(os.path.getsize(p) for p in paths) / 1e6
    return paths, mb, found, n_kernels, busy_us / 1e3, sorted(names)


def _traced_flagship(workdir, ckpt, dataset, smi, flagship):
    """(b) The flagship run again (``[flagship]``'s flags, stage 2
    included) with ``--trace_dir`` and ``--recal_fea`` (so that it extracts
    its stage-2 features as the first run did, not from that run's cache):
    one trace that parses, whose device events name mha_fwd's and mha_bwd's
    kernels as often as the wrappers counted launches inside the traced
    window, ``SwatPipeline.run`` (the pipeline's start, which encodes the
    prompts, lies before it, as in ``swat_tpu``); the summary line and
    loss.csv of the untraced run; the trace's size and the profiler's cost
    in wall time.  -> the run's four counts."""
    from swat_tpu_torch.kernels import flash_attention as FA

    trace_dir = f"{workdir}/trace"
    with _entry_counts(FA, "run") as per:
        traced = _train_cli_run(
            workdir, ckpt, dataset, "cutmix", "float32", "auto", smi,
            bsz=FLAGSHIP_BSZ, tag="_traced", rows_want=22, stage2=True,
            extra=("--recal_fea", "--trace_dir", trace_dir))
    t0 = time.perf_counter()
    paths, mb, found, n_kernels, busy, names = _trace_kernels(trace_dir)
    parse = time.perf_counter() - t0
    launched = dict(zip(TRACE_KERNELS, per["run"]))
    rows = [list(r.values()) for r in traced["rows"]]
    plain_rows = [list(r.values()) for r in flagship["rows"]]
    log(f"[tooling] (b) --trace_dir: {len(paths)} trace(s), {mb:.1f} MB, "
        f"parsed in {parse:.3f} s | {n_kernels} device kernel events, "
        f"{busy:.3f} ms of device time | trace mha_fwd {found['mha_fwd']} "
        f"mha_bwd {found['mha_bwd']}, wrappers' launches inside the trace "
        f"{launched} (the whole run {traced['counts'][:2]}) | kernels "
        f"{names}")
    log(f"[tooling] (b) traced {traced['summary']} | untraced "
        f"{flagship['summary']} | loss.csv rows equal: {rows == plain_rows}"
        f" | wall traced {traced['wall']:.3f} s, untraced "
        f"{flagship['wall']:.3f} s: the profiler costs "
        f"{100 * (traced['wall'] / flagship['wall'] - 1):.1f} % on {smi}")
    if len(paths) != 1 or n_kernels == 0:
        raise AssertionError(f"the trace holds no device event: {paths}")
    if found != launched or traced["counts"][2:] != (0, 0):
        raise AssertionError(f"the trace's attention kernels {found} are not "
                             f"the launches counted {per['run']}")
    if traced["summary"] != flagship["summary"] or rows != plain_rows:
        raise AssertionError("the traced run differs from the untraced one")
    return traced["counts"]


def phase_tooling(workdir, ckpt, dataset, smi, flagship):
    """[tooling]: (a) the runbook, (b) the traced flagship run.  -> the four
    counts summed over both."""
    a = _repro_run(workdir, ckpt, dataset, smi)
    b = _traced_flagship(workdir, ckpt, dataset, smi, flagship)
    return [x + y for x, y in zip(a, b)]


# the two tensor-parallel shards of a tower against the whole tower
# through its 12 layers (B/32 image) or 12 (text): fp32 differs in the
# order the shards' partial products are summed; in bf16 each shard's
# partial output is rounded before the sum, which a flipped rounding then
# carries through every later layer
TP_REL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TP_MIN_COSINE = {"float32": 1 - 1e-7, "bfloat16": 0.999}
# (name, batch, seq, heads of a shard, width of a shard, causal): the
# attention calls of B/32's towers cut in two
TP_SHAPES = [("vitb32_image_tp2", 256, 50, 6, 384, False),
             ("text_tp2", 1024, 77, 4, 256, True)]


def _rel_err(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def _cosine(got, ref):
    a, b = got.double().flatten(), ref.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def phase_dist_tp(ckpt, smi):
    """(b) B/32's image and text towers cut into two tensor-parallel shards
    by the port's splitter (models.clip.tp_shard_state_dict), both shards'
    blocks run on cuda:0 through mha_qkv with H / 2 heads, their partial
    outputs summed where the all-reduce would stand
    (models.clip.lockstep_transformer), forward and backward, fp32 and bf16:
    the output and the gradients of a fixed loss (the input's, and the
    first block's qkv weight, the shards' joined) against the whole tower;
    the H / 2-head kernel calls against their plain versions at those
    shapes, with the bit-equal share in bf16.  -> the launches of the
    sharded towers (fwd, bwd)."""
    import torch

    from swat_tpu_torch.core.precision import (DEFAULT_PRECISION,
                                               FP32_PRECISION)
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.models.clip import (CLIPModel, TensorParallel,
                                            lockstep_transformer, tp_join,
                                            tp_shard_state_dict)
    from swat_tpu_torch.models.configs import get_model_config
    from swat_tpu_torch.models.loader import load_torch_checkpoint

    gen = torch.Generator(device="cuda").manual_seed(11)
    for name, b, s, h, w, causal in TP_SHAPES:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            atol, rtol = TOLERANCE[dname]
            batl, brtol = TOLERANCE_BWD[dname]
            q, k, v = _qkv(b, s, w, dtype, gen, True)
            do = torch.randn(b, s, w, generator=gen, device="cuda").to(dtype)
            got = FA.mha_packed_fwd(q, k, v, h, causal)
            ref = FA.mha_packed_reference(q, k, v, h, causal)
            grads = FA.mha_packed_bwd(q, k, v, do, h, causal).split(w, -1)
            grads_ref = FA.mha_bwd_reference(q, k, v, do, h, causal)
            torch.cuda.synchronize()
            errs = [float((got.float() - ref.float()).abs().max())]
            ok = bool(((got.float() - ref.float()).abs()
                       <= atol + rtol * ref.float().abs()).all())
            shares = [float((got == ref).float().mean())]
            for g, r in zip(grads, grads_ref):
                e = (g.float() - r.float()).abs()
                ok &= bool((e <= batl + brtol * r.float().abs()).all())
                errs.append(float(e.max()))
                shares.append(float((g == r).float().mean()))
            if dtype == torch.bfloat16:
                ok &= (shares[0] >= FWD_MIN_EQUAL_SHARE
                       and min(shares[1:]) >= BWD_MIN_EQUAL_SHARE)
            log(f"[dist] (b) kernel {name} B={b} S={s} H={h} HD={w} "
                f"causal={causal} {dname}: max_abs_err out={errs[0]:.3e} "
                f"dq/dk/dv={'/'.join(f'{x:.3e}' for x in errs[1:])}, "
                f"bit-equal {'/'.join(f'{x:.5f}' for x in shares)} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"H/2 kernels disagree at {name} "
                                     f"{dname}")

    cfg = get_model_config(MODEL_CFG)
    sd, _ = load_torch_checkpoint(ckpt)
    fwd = bwd = 0
    for dname, precision in (("float32", FP32_PRECISION),
                             ("bfloat16", DEFAULT_PRECISION)):
        full = CLIPModel(cfg, precision=precision)
        full.load_state_dict(sd)
        full.cuda()
        shards = []
        for r in range(2):
            m = CLIPModel(cfg, precision=precision).tensor_parallel_(
                TensorParallel(2, r, lambda t: t))
            m.load_state_dict(tp_shard_state_dict(sd, cfg, 2, r))
            shards.append(m.cuda())
        for tower, causal, b, seq, width, heads in (
                ("image", False, 64, 50, cfg.vision.width, cfg.vision.heads),
                ("text", True, 64, 77, cfg.text.width, cfg.text.heads)):
            def stack(m):
                return m.visual.transformer if tower == "image" \
                    else m.transformer
            x0 = torch.randn(b, seq, width, generator=gen, device="cuda")
            wt = torch.randn(b, seq, width, generator=gen, device="cuda")
            outs = []
            for models in ([full], shards):
                x = x0.to(precision.compute_dtype).detach().clone() \
                    .requires_grad_(True)
                for m in models:
                    m.zero_grad(set_to_none=True)
                _reset_counts(FA)
                if len(models) == 1:
                    y = stack(full)(x, causal, precision, FA.mha_qkv)
                else:
                    y = lockstep_transformer([stack(m) for m in models], x,
                                             causal, precision, FA.mha_qkv)
                (y.float() * wt).sum().backward()
                torch.cuda.synchronize()
                if len(models) == 2:
                    fwd += FA.LAUNCHES
                    bwd += FA.LAUNCHES_BWD
                    launched = (FA.LAUNCHES, FA.LAUNCHES_BWD)
                w_grad = tp_join("qkv", [stack(m).resblocks[0].attn
                                         .in_proj_weight.grad
                                         for m in models], heads) \
                    if len(models) == 2 else \
                    stack(full).resblocks[0].attn.in_proj_weight.grad
                outs.append((y.detach(), x.grad, w_grad))
            layers = len(stack(full).resblocks)
            checks = []
            for what, got, ref in zip(("out", "d_in", "d_qkv_w"), outs[1],
                                      outs[0]):
                checks.append((what, _rel_err(got, ref), _cosine(got, ref)))
            ok = all(e <= TP_REL_TOL[dname] and c >= TP_MIN_COSINE[dname]
                     for _, e, c in checks)
            ok &= launched == (2 * layers, 2 * layers)
            log(f"[dist] (b) {tower} tower B={b} S={seq} {layers} layers, "
                f"2 shards x {heads // 2} heads, {dname}: "
                + ", ".join(f"{what} max rel err {e:.3e} cosine {c:.9f}"
                            for what, e, c in checks)
                + f" (tol {TP_REL_TOL[dname]:g}, cosine >= "
                f"{TP_MIN_COSINE[dname]}) | launches fwd/bwd {launched} "
                f"(need {2 * layers} each) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the tensor-parallel {tower} tower "
                                     f"differs from the whole ({dname})")
        del full, shards
        torch.cuda.empty_cache()
    log(f"[dist] (b) on {smi}: one process, the all-reduce a sum; the "
        "card has one GPU, so no multi-GPU number is measured here")
    return fwd, bwd


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


# ---------------------------------------------------------------------------
# the RN50 image tower (models/resnet.py) and the ViT-B/16 and ViT-L/14
# towers' train steps

RN50_CFG = "rn50_openclip_openai"
# card against CPU, fp32: eval features (cosine), train-mode features and
# the new BN running statistics (relative to each tensor's largest value):
# cuDNN's and the CPU's fp32 convolutions sum in other orders
RN50_MIN_COS = 1 - 1e-5
RN50_REL = 1e-4
# bf16 against fp32 on the card: 16 bottlenecks of bf16 activations
RN50_BF16_MIN_COS = 0.99
RN50_STEP_BSZ = 256
RN50_CPU_ROWS = 4


def _rn50_images(n, n_px, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    return torch.randn(n, n_px, n_px, 3, generator=gen)


def _bn_stats(model):
    return {k: v.detach().float().cpu() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _max_rel(got, ref):
    """The largest |got - ref| / max|ref| over the tensors of two dicts ->
    (value, name)."""
    rel = {k: float((got[k].float().cpu() - ref[k].float().cpu()).abs().max()
                    / max(float(ref[k].abs().max()), 1e-30)) for k in ref}
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def phase_rn50_towers(workdir, smi):
    """The registry's RN50 at full width (224 px), its weights seeded by
    ``CLIPModel.init_random`` (He-normal convolutions, every bottleneck's
    bn3 weight N(0, 0.1) where OpenCLIP zeroes it, the running statistics
    calibrated by one batch-statistics pass over 4 seeded images), saved as
    an OpenCLIP-format checkpoint for the CLI phase.  TF32 is off for cuDNN
    too.  On 4 images, fp32, the card against the CPU: the eval-mode
    features, the train-mode features and every BN batch statistic;
    bf16 against fp32 on the card; the image tower launches none of the
    four attention kernels, a prompt batch through the text tower exactly
    12 of mha_fwd.  -> the checkpoint's path."""
    import numpy as np
    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.models.clip import CLIPModel
    from swat_tpu_torch.models.configs import get_model_config

    cfg = get_model_config(RN50_CFG)
    t0 = time.perf_counter()
    model = CLIPModel(cfg, precision=FP32_PRECISION).init_random(
        torch.Generator().manual_seed(0))
    init_s = time.perf_counter() - t0
    ckpt = f"{workdir}/{RN50_CFG}_seed0.pt"
    torch.save(model.state_dict(), ckpt)
    n_params = sum(p.numel() for p in model.parameters())
    FP32_PRECISION.apply_backend_flags()
    if torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on after apply_backend_flags")
    images = _rn50_images(RN50_CPU_ROWS, cfg.vision.image_size, 1)
    out = {}
    for device in ("cpu", "cuda"):
        model.to(device)
        x = images.to(device)
        with torch.no_grad():
            ev = model.encode_image(x, normalize=True)
            upd = {}
            tr = model.encode_image(x, normalize=True, updates=upd)
        names = {m: n for n, m in model.named_modules()}
        stats = {f"{names[bn]}.{k}": t.cpu() for bn, (mean, var) in
                 upd.items() for k, t in (("batch_mean", mean),
                                          ("batch_var", var))}
        out[device] = (ev.cpu(), tr.cpu(), stats)
    (ev_c, tr_c, st_c), (ev_g, tr_g, st_g) = out["cpu"], out["cuda"]
    cos_eval = float((ev_c * ev_g).sum(-1).min())
    cos_train = float((tr_c * tr_g).sum(-1).min())
    rel_train, _ = _max_rel({"f": tr_g}, {"f": tr_c})
    rel_bn, worst_bn = _max_rel(st_g, st_c)
    model.precision = DEFAULT_PRECISION
    DEFAULT_PRECISION.apply_backend_flags()
    with torch.no_grad():
        ev_bf = model.encode_image(images.cuda(), normalize=True).cpu()
    cos_bf = float((ev_bf * ev_g).sum(-1).min())
    # launches: the image tower none, a prompt batch 12 (the text tower)
    tokens = torch.from_numpy(_prompt_tokens(
        np.random.default_rng(0), 10, cfg.text)).cuda()
    _reset_counts(FA)
    with torch.no_grad():
        model.encode_image(images.cuda())
        model.encode_image(images.cuda(), updates={})
        model.encode_image_tokens(images.cuda())
    image_counts = _counts(FA)
    with torch.no_grad():
        txt = model.encode_text(tokens, normalize=True)
    torch.cuda.synchronize()
    text_counts = tuple(a - b for a, b in zip(_counts(FA), image_counts))
    need_text = (cfg.text.layers, 0, 0, 0)
    ok = (cos_eval >= RN50_MIN_COS and cos_train >= RN50_MIN_COS
          and rel_train <= RN50_REL and rel_bn <= RN50_REL
          and cos_bf >= RN50_BF16_MIN_COS and image_counts == (0, 0, 0, 0)
          and text_counts == need_text and bool(torch.isfinite(txt).all())
          and len(st_g) == 2 * 55)
    log(f"[rn50-towers] {RN50_CFG} ({n_params / 1e6:.1f} M parameters, "
        f"init_random {init_s:.1f} s) {RN50_CPU_ROWS} images, card against "
        f"CPU fp32: eval-mode min cosine {cos_eval:.9f}, train-mode min "
        f"cosine {cos_train:.9f} (max rel {rel_train:.2e}), BN batch "
        f"statistics ({len(st_g)} tensors) max rel {rel_bn:.2e} "
        f"({worst_bn}; bounds cosine {RN50_MIN_COS}, rel {RN50_REL}); bf16 "
        f"against fp32 on the card: min cosine {cos_bf:.6f} (bound "
        f"{RN50_BF16_MIN_COS}); cudnn.allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32}; launches: image tower "
        f"{image_counts}, a batch of 10 prompts {text_counts} (need "
        f"{need_text}) on {smi} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("RN50 towers failed")
    del model
    torch.cuda.empty_cache()
    return ckpt


def _rn50_split(prof, steps):
    """Device ms per step of a ResNet step by kernel family: cuDNN's
    convolutions (forward, data and weight gradients, its FFT and Winograd
    transforms included), other GEMMs (the attention pool, the head, the
    GEMMs cuDNN calls for 1x1 convolutions), AdamW, the elementwise and
    reduction kernels (BatchNorm's statistics and affine, ReLU, pooling,
    their gradients) and the rest -> (split, the largest kernels of the
    elementwise family and of the rest)."""
    from torch.autograd import DeviceType

    split = {"conv": 0.0, "gemm": 0.0, "bn-elementwise": 0.0,
             "optimizer": 0.0, "other": 0.0}
    largest = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = evt.key.lower()
        ms = evt.self_device_time_total / 1e3 / steps
        if any(t in name for t in ("conv", "fprop", "dgrad", "wgrad",
                                   "implicit", "winograd", "cudnn", "fft",
                                   "region_transform",
                                   "pointwise_mult_and_sum")):
            fam = "conv"
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma")):
            fam = "gemm"
        elif "adam" in name or "multi_tensor" in name:
            fam = "optimizer"
        elif any(t in name for t in ("elementwise", "reduce", "pool",
                                     "batch_norm", "vectorized")):
            fam = "bn-elementwise"
            largest.append((ms, evt.key[:70]))
        else:
            fam = "other"
            largest.append((ms, evt.key[:70]))
        split[fam] += ms
    return split, sorted(largest, reverse=True)[:4]


def phase_rn50_step(ckpt, smi):
    """One full-width RN50 cutmix step (augment, cutmix, batch-statistics
    BN forward and backward, AdamW, the BN statistics folded after it):
    first at 4 images, fp32, the card against the CPU on the same weights,
    canvases and draws (the loss, every gradient, the folded statistics);
    then at bsz 256, fp32 and bf16: a warm-up step, 3 steps timed, the
    peak allocated memory over them, 2 steps profiled (busy time by kernel
    family: convolutions, GEMMs, BN and elementwise, AdamW; the idle share
    of the window).  -> {dtype: (ms, busy, window, peak)}."""
    import copy

    import numpy as np
    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.models.clip import CLIPModel
    from swat_tpu_torch.models.configs import get_model_config
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import make_mixing_step, make_sampler

    cfg = get_model_config(RN50_CFG)
    n_px = cfg.vision.image_size
    base = CLIPModel(cfg, precision=FP32_PRECISION)
    base.load_state_dict(torch.load(ckpt))
    rng = np.random.default_rng(3)
    n_classes = 10
    head = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((n_classes, cfg.embed_dim)).astype(np.float32)),
        dim=-1)
    sample = make_sampler("cutmix", mix_prob=1.0, image_size=n_px)
    step = make_mixing_step("cutmix", image_size=n_px)
    FP32_PRECISION.apply_backend_flags()
    small = _canvas_batch(rng, RN50_CPU_ROWS, n_classes, torch.device("cpu"))
    draws = sample(rng, small)
    res = {}
    for device in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(device)
        state = create_train_state(model, head, "cutmix", total_iter=100)
        batch = {k: v.to(device) if isinstance(v, torch.Tensor) else v
                 for k, v in small.items()}
        loss = float(step(state, batch, draws))
        grads = {n: p.grad.detach().float().flatten().cpu()
                 for n, p in model.named_parameters() if p.grad is not None}
        res[device] = (loss, grads, _bn_stats(model))
        del state, model
    (lc, gc, sc), (lg, gg, sg) = res["cpu"], res["cuda"]
    # the attention pool's key bias shifts every score of a query alike,
    # which the softmax cancels: its gradient is rounding noise in both
    kb = "visual.attnpool.k_proj.bias"
    kb_rel = float(gg[kb].abs().max() / gg["visual.attnpool.k_proj.weight"]
                   .abs().max())
    del gg[kb], gc[kb]
    cos, worst, _ = _compare_grads(gg, gc)
    rel_bn, worst_bn = _max_rel(sg, sc)
    moved = _max_rel(sc, _bn_stats(base))[0]
    rel_loss = abs(lg - lc) / abs(lc)
    ok = (rel_loss <= RN50_REL and cos >= GRAD_MIN_COS["float32"]
          and rel_bn <= RN50_REL and moved > 0 and kb_rel < 1e-4
          and len(gg) == len(gc) > 150)
    log(f"[rn50-step] {RN50_CFG} cutmix {RN50_CPU_ROWS} images fp32, card "
        f"against CPU: loss {lg:.7f} / {lc:.7f} (rel {rel_loss:.2e}, bound "
        f"{RN50_REL}); min cosine of {len(gg)} visual gradients "
        f"{cos:.8f} ({worst}; bound {GRAD_MIN_COS['float32']}; the key "
        f"bias's, noise, at {kb_rel:.1e} of the key weight's); BN "
        f"statistics after the fold max rel {rel_bn:.2e} ({worst_bn}; bound "
        f"{RN50_REL}; moved {moved:.2e} from the checkpoint's) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("RN50 step disagrees with the CPU")
    del res, gc, gg

    model = base.cuda()
    batch = _canvas_batch(rng, RN50_STEP_BSZ, n_classes, torch.device("cuda"))
    draws = sample(rng, batch)
    results = {}
    for dname, precision in (("float32", FP32_PRECISION),
                             ("bfloat16", DEFAULT_PRECISION)):
        precision.apply_backend_flags()
        model.precision = precision
        state = create_train_state(model, head, "cutmix", total_iter=100)
        step(state, batch, draws)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resting = torch.cuda.memory_allocated()
        _reset_counts(FA)
        ms = _time_ms(lambda: step(state, batch, draws), iters=3, warmup=0)
        peak = torch.cuda.max_memory_allocated()
        counts = _counts(FA)
        busy, window, split, others = _profiled(
            lambda: step(state, batch, draws), 2, _rn50_split)
        val = float(step(state, batch, draws))
        ok = np.isfinite(val) and counts == (0, 0, 0, 0)
        log(f"[rn50-step] {RN50_CFG} cutmix bsz {RN50_STEP_BSZ} {dname}: "
            f"{ms:.2f} ms/step ({RN50_STEP_BSZ * 1e3 / ms:.1f} images/s), "
            f"peak {peak / 2 ** 30:.3f} GiB allocated (at rest "
            f"{resting / 2 ** 30:.3f} GiB); profiled: {busy:.2f} ms busy of "
            f"a {window:.2f} ms window (idle {_idle(busy, window)}; "
            + ", ".join(
                f"{k} {v:.2f} ({100 * v / max(busy, 1e-9):.1f} %)"
                for k, v in split.items())
            + "; largest elementwise or other kernels: "
            + "; ".join(f"{t:.2f} {n}" for t, n in others)
            + f"); attention launches {counts} on {smi} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"RN50 step failed ({dname}): {counts}")
        results[dname] = (ms, busy, window, peak)
        del state
    del model, base
    torch.cuda.empty_cache()
    return results


def phase_rn50_cli(workdir, ckpt, dataset, smi):
    """RN50 through swat_tpu_torch.cli.main at full width: the flagship run
    (cutmix, fewshot+retrieved, bsz 32, fp32) through stage 2 to its
    11-field summary line, its training steps launching no attention kernel
    (the image tower has none); then FLYP (its projector group names
    visual.proj, which the ResNet has none of) and --accum 2, each of
    which must raise its ValueError before any epoch, as both fail in
    swat_tpu.  -> the flagship run's four counts, counted from 0."""
    steps = 2 * ((N_FEWSHOT + N_RETRIEVED) // FLAGSHIP_BSZ)
    run = _train_cli_run(workdir, ckpt, dataset, "cutmix", "float32", "auto",
                         smi, (), bsz=FLAGSHIP_BSZ, tag="_rn50", rows_want=22,
                         stage2=True, model_cfg=RN50_CFG)
    train = run["loops"][0]
    ok = train == (0, 0, 0, 0)
    log(f"[rn50-cli] cutmix: stage-1 steps launched {train} (need none: "
        f"{steps} steps at bsz {FLAGSHIP_BSZ}); the whole run "
        f"{run['counts']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"RN50 cutmix launches {train}")
    for method, extra, why in (("FLYP", (), "no such tensor"),
                               ("cutmix", ("--accum", "2"), "ViT-only")):
        try:
            _train_cli_run(workdir, ckpt, dataset, method, "float32", "auto",
                           smi, extra, bsz=FLAGSHIP_BSZ,
                           tag=f"_rn50_refused_{method}", model_cfg=RN50_CFG)
        except ValueError as e:
            if why not in str(e):
                raise
            log(f"[rn50-cli] {method} {' '.join(extra)} raised ValueError: "
                f"{e}")
        else:
            raise AssertionError(f"{method} {extra} on RN50 ran")
    return list(run["counts"])


# (registry name, bsz): the two towers the long-row kernels serve
VIT_TOWERS = (("vitb16_openclip_laion400m", 128),
              ("vitl14_openclip_laion400m", 64))


def _vit_model(name, precision):
    """The registry's ``name`` at full depth and width, seeded by
    init_random, on the card (no checkpoint file)."""
    import torch

    from swat_tpu_torch.models.clip import CLIPModel
    from swat_tpu_torch.models.configs import get_model_config

    cfg = get_model_config(name)
    t0 = time.perf_counter()
    model = CLIPModel(cfg, precision=precision).init_random(
        torch.Generator().manual_seed(0)).cuda()
    return cfg, model, time.perf_counter() - t0


def phase_vit_towers(smi):
    """One full-width cutmix step of ViT-B/16 at bsz 128 (S = 197) and of
    ViT-L/14 at bsz 64 (S = 257, 24 layers), fp32 and bf16: the visual
    gradients with the kernels against plain attention; one step with the
    counts set to 0 just before it and read just after (mha_fwd and
    mha_bwd once a layer); a warm-up step, 3 steps timed with the peak
    allocated memory, 2 steps profiled (busy time by kernel family, the
    attention kernels' share of it, the idle share of the window).
    -> ({(name, dtype): (ms, busy, window, attention share, peak)}, the
    four counts summed over the counted steps)."""
    import numpy as np
    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.train.losses import cross_entropy
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import (make_encode_loss, make_mix_fn,
                                            make_mixing_step, make_sampler)

    results, total = {}, [0, 0, 0, 0]
    for name, bsz in VIT_TOWERS:
        cfg, model, init_s = _vit_model(name, FP32_PRECISION)
        n_px, layers = cfg.vision.image_size, cfg.vision.layers
        rng = np.random.default_rng(4)
        batch = _canvas_batch(rng, bsz, 10, torch.device("cuda"))
        head = torch.nn.functional.normalize(torch.from_numpy(
            rng.standard_normal((10, cfg.embed_dim)).astype(np.float32)),
            dim=-1)
        draws = make_sampler("cutmix", mix_prob=1.0, image_size=n_px)(
            rng, batch)
        mix = make_mix_fn("cutmix", image_size=n_px)
        step = make_mixing_step("cutmix", image_size=n_px)
        for dname, precision in (("float32", FP32_PRECISION),
                                 ("bfloat16", DEFAULT_PRECISION)):
            precision.apply_backend_flags()
            model.precision = precision
            state = create_train_state(model, head, "cutmix", total_iter=100)
            grads = {}
            for attn_name, attn in (("kernel", FA.mha_qkv),
                                    ("plain", FA.mha_qkv_reference)):
                state.optimizer.zero_grad(set_to_none=True)
                loss = make_encode_loss(cross_entropy, attn)(
                    state, mix(state, batch, draws))
                loss.backward()
                grads[attn_name] = (loss.item(), _visual_grads(model))
            (lk, gk), (lp, gp) = grads["kernel"], grads["plain"]
            cos, worst, _ = _compare_grads(gk, gp)
            del grads, gk, gp
            state.optimizer.zero_grad(set_to_none=True)
            step(state, batch, draws)
            torch.cuda.synchronize()
            _reset_counts(FA)
            step(state, batch, draws)
            torch.cuda.synchronize()
            counts = _counts(FA)
            total = [t + c for t, c in zip(total, counts)]
            torch.cuda.reset_peak_memory_stats()
            ms = _time_ms(lambda: step(state, batch, draws), iters=3,
                          warmup=0)
            peak = torch.cuda.max_memory_allocated()
            busy, window, split, others = _profiled(
                lambda: step(state, batch, draws), 2, _device_split)
            attn = split["mha_fwd"] + split["mha_bwd"]
            need = (layers, layers, 0, 0)
            ok = (np.isfinite(lk) and cos >= GRAD_MIN_COS[dname]
                  and counts == need)
            log(f"[vit-towers] {name} cutmix bsz {bsz} (S = "
                f"{cfg.vision.seq_len}, {layers} layers, init_random "
                f"{init_s:.1f} s) {dname}: loss kernel {lk:.6f} / plain "
                f"{lp:.6f}; min cosine of the visual gradients kernel vs "
                f"plain {cos:.8f} ({worst}; bound {GRAD_MIN_COS[dname]}); "
                f"launches {counts} (need {need}); {ms:.2f} ms/step "
                f"({bsz * 1e3 / ms:.1f} images/s), peak "
                f"{peak / 2 ** 30:.3f} GiB allocated; profiled: {busy:.2f} "
                f"ms busy of a {window:.2f} ms window (idle "
                f"{_idle(busy, window)}; "
                + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
                + f"); attention kernels {attn:.2f} ms = "
                f"{_pct(attn, busy)} of busy (mha_fwd "
                f"{split['mha_fwd']:.2f}, mha_bwd {split['mha_bwd']:.2f}) on "
                f"{smi} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} step failed ({dname})")
            results[(name, dname)] = (ms, busy, window,
                                      attn / busy if busy else None, peak)
            del state
        del model, batch
        torch.cuda.empty_cache()
    return results, total


def phase_l14_memory(smi):
    """ViT-L/14 cutmix at bsz 64, fp32 and bf16, under no remat, full
    remat, --accum 2 and auto_memory_policy's own pick for the run (the
    port keeps swat_tpu's decision): per policy a warm-up step, the
    peak-memory counter reset, 3 steps timed, the peak allocated memory
    over them, one step profiled (busy / window).  Does an 80 GB card need
    the trigger swat_tpu measured on its own accelerator?"""
    import numpy as np
    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.train.stages import auto_memory_policy
    from swat_tpu_torch.train.state import create_train_state
    from swat_tpu_torch.train.steps import make_mixing_step, make_sampler

    name, bsz = VIT_TOWERS[1]
    cfg, model, _ = _vit_model(name, FP32_PRECISION)
    n_px = cfg.vision.image_size
    rng = np.random.default_rng(5)
    batch = _canvas_batch(rng, bsz, 10, torch.device("cuda"))
    head = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((10, cfg.embed_dim)).astype(np.float32)), dim=-1)
    draws = make_sampler("cutmix", mix_prob=1.0, image_size=n_px)(rng, batch)
    # the policy's own pick runs once, under its own name unless it is one
    # of these
    auto = auto_memory_policy(name, False, 1, bsz, 1, "cutmix")
    policies = [("none", False, 1), ("full", "full", 1), ("accum2", False, 2)]
    same = [label for label, *pick in policies if tuple(pick) == auto]
    if not same:
        policies.append((f"auto={auto[0]!r},{auto[1]}", *auto))
    results = {}
    total = torch.cuda.get_device_properties(0).total_memory
    for dname, precision in (("float32", FP32_PRECISION),
                             ("bfloat16", DEFAULT_PRECISION)):
        precision.apply_backend_flags()
        model.precision = precision
        state = create_train_state(model, head, "cutmix", total_iter=100)
        for label, remat, accum in policies:
            model.remat = remat
            step = make_mixing_step("cutmix", image_size=n_px, accum=accum)
            step(state, batch, draws)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = _time_ms(lambda: step(state, batch, draws), iters=3,
                          warmup=0)
            peak = torch.cuda.max_memory_allocated()
            busy, window, split, _ = _profiled(
                lambda: step(state, batch, draws), 1, _device_split)
            log(f"[l14-memory] {name} cutmix bsz {bsz} {dname} {label}: "
                f"peak {peak / 2 ** 30:.3f} GiB allocated of "
                f"{total / 2 ** 30:.1f} GiB, {ms:.2f} ms/step "
                f"({bsz * 1e3 / ms:.1f} images/s); profiled step {busy:.2f} "
                f"ms busy of a {window:.2f} ms window (idle "
                f"{_idle(busy, window)}) on {smi}")
            results[(label, dname)] = (peak, ms, busy, window)
            del step
        model.remat = False
        del state
    need = {d: results[("none", d)][0] for d in ("float32", "bfloat16")}
    log(f"[l14-memory] auto_memory_policy picks remat={auto[0]!r}, accum="
        f"{auto[1]} ({same[0] if same else 'its own line'}) for {name} at "
        f"bsz {bsz} on one device; without it the "
        f"step peaks at {need['float32'] / 2 ** 30:.3f} GiB fp32, "
        f"{need['bfloat16'] / 2 ** 30:.3f} GiB bf16 of the card's "
        f"{total / 2 ** 30:.1f} GiB")
    del model, batch
    torch.cuda.empty_cache()
    return results


def _new_tower_phases(workdir, smi):
    """[rn50-towers], [rn50-step], [rn50-cli] (on the smoke dataset the
    earlier CLI phases wrote), [vit-towers] and [l14-memory] -> the four
    counts summed over the RN50 CLI runs and the counted ViT steps."""
    dataset = "smoke10"
    t0 = time.perf_counter()
    ckpt = phase_rn50_towers(workdir, smi)
    phase_rn50_step(ckpt, smi)
    rn50_counts = phase_rn50_cli(workdir, ckpt, dataset, smi)
    t1 = time.perf_counter()
    _, vit_counts = phase_vit_towers(smi)
    phase_l14_memory(smi)
    log(f"[new-towers] RN50 phases {t1 - t0:.1f} s, ViT phases "
        f"{time.perf_counter() - t1:.1f} s; launches: RN50 CLI runs "
        f"{rn50_counts}, ViT steps {vit_counts}")
    return [a + b for a, b in zip(rn50_counts, vit_counts)]


# ---------------------------------------------------------------------------
# the serving side: swat_tpu_torch.cli.convert, swat_tpu_torch.cli.test, the
# ImageNet OOD sweep and W8A8 int8 inference

SERVE_BSZ = 256
# the best_tau_head and wsft_head runs (card and CPU) read the first
# SERVE_HEAD_TEST images of the test split: the CPU's run is the slow one
SERVE_HEAD_TEST, SERVE_HEAD_SPLIT = 64, "test_head64.txt"
# the OOD sweep's batch: its trees are small, and the CPU's run encodes
# whole padded batches
OOD_BSZ = 32
# int8 towers, card against CPU: the same codes and int32 sums except where
# the float work between the products (LayerNorm, attention, GELU) summed in
# another order moves an activation across a rounding boundary; such a code
# moves its element by a whole quantization step, the size of int8's own
# error against fp32, so a few per layer part the towers by up to that
# error (int8 against fp32: mean cosine 1 - 1.4e-4 image, 1 - 4.6e-4 text)
INT8_CARD_MIN_COS = 1 - 1e-3
# int8 against fp32 towers: swat_tpu's own bounds (tests/test_quant.py), on
# the mean cosine
INT8_MIN_MEAN_COS = {"image": 0.995, "text": 0.99}
N_OOD_PER_TREE, N_OOD_TEST, OOD_CLASSES = 24, 20, 1000


def _cli_test(argv, device, bsz=SERVE_BSZ):
    """One run of swat_tpu_torch.cli.test at ``bsz``; the four counts
    are set to 0 just before it and read just after -> dict: the
    '{dataset},{split},{acc}' line, the OOD sweep's JSON line (or None),
    whether it encoded its prompts, the counts, the wall time, the log."""
    import io

    from swat_tpu_torch.cli.test import main as test_main
    from swat_tpu_torch.kernels import flash_attention as FA

    dataset = argv[argv.index("--dataset") + 1]
    split = (argv[argv.index("--split") + 1] if "--split" in argv
             else "test.txt")
    buf = io.StringIO()
    _reset_counts(FA)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        test_main([*argv, "--bsz", str(bsz), "--num_workers", "8",
                   "--device", device])
    wall = time.perf_counter() - t0
    counts = _counts(FA)
    out = buf.getvalue()
    lines = [ln for ln in out.splitlines()
             if ln.startswith(f"{dataset},{split},")]
    ood = [ln for ln in out.splitlines() if ln.startswith('{"imagenet')]
    if len(lines) != 1 or len(ood) > 1:
        raise AssertionError(f"cli.test printed no result line:\n"
                             f"{out[-2000:]}")
    return {"line": lines[0], "ood": ood[0] if ood else None,
            "encoded_prompts": "Saved prompt tensors" in out,
            "counts": counts, "wall": wall, "out": out}


def _need_fwd(run, image_batches, n_prompts=10):
    """mha_fwd launches a cli.test run on the card must make: a layer of
    the image tower a batch, and a layer of the text tower a prompt batch
    (of up to 1024) if it encoded its prompts (else it read the cache)."""
    import math

    from swat_tpu_torch.models.configs import get_model_config

    cfg = get_model_config(MODEL_CFG)
    text = (cfg.text.layers * math.ceil(n_prompts / 1024)
            if run["encoded_prompts"] else 0)
    return cfg.vision.layers * image_batches + text


def _check_counts(tag, run, need):
    if run["counts"] != (need, 0, 0, 0):
        raise AssertionError(f"{tag}: launches {run['counts']}, need "
                             f"({need}, 0, 0, 0)")


def phase_convert(workdir, ckpt, smi):
    """The seeded ViT-B/32 .pt through swat_tpu_torch.cli.convert, fp32 and
    int8 (--device cuda: the round trip compared on the card) -> the two
    bundles' paths."""
    import io
    import os

    from swat_tpu_torch.cli.convert import main as convert_main

    paths = {}
    for quantize in ("none", "int8"):
        out = f"{workdir}/serve/{MODEL_CFG}_{quantize}.msgpack"
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            convert_main(["--checkpoint", ckpt, "--model_cfg", MODEL_CFG,
                          "--output", out, "--quantize", quantize,
                          "--device", "cuda"])
        wall = time.perf_counter() - t0
        report = json.loads(buf.getvalue().strip().splitlines()[-1])
        if report["roundtrip_mismatches"] or (
                (report.get("quantize") == "int8") != (quantize == "int8")):
            raise AssertionError(f"convert {quantize}: {report}")
        paths[quantize] = out
        log(f"[w8a8] cli.convert --quantize {quantize}: {report['num_params']}"
            f" parameters, round trip bit-equal on the card, bundle "
            f"{os.path.getsize(out) / 2 ** 20:.1f} MiB in {wall:.2f} s "
            f"(host clock) on {smi}")
    return paths


def phase_eval_cli(workdir, ckpt, bundle, converted, smi):
    """swat_tpu_torch.cli.test at full ViT-B/32 width on the flagship run's
    stage-1 bundle, each --which_head (head with --predict_labels and
    --utrain_out over the test split; best_tau_head with --tau 0.5 and
    wsft_head over its first SERVE_HEAD_TEST images, ``--split``), on the
    card and then on the CPU: the same line, the same predicted labels and
    the same utrain file; then --checkpoint_path given the converted
    .msgpack against the .pt.  -> mha_fwd launches of the card's runs."""
    import math

    import numpy as np

    base = ["--dataset", "smoke10", "--dataset_path", workdir,
            "--retrieved_path", workdir, "--model_cfg", MODEL_CFG,
            "--folder", f"{workdir}/serve/eval"]
    with open(f"{workdir}/smoke10/test.txt") as f:
        head_lines = f.readlines()[:SERVE_HEAD_TEST]
    with open(f"{workdir}/smoke10/{SERVE_HEAD_SPLIT}", "w") as f:
        f.writelines(head_lines)
    total = 0
    heads = (("head", ["--which_head", "head", "--predict_labels",
                       "{d}/pred_{dev}.txt", "--utrain_out",
                       "{d}/utrain_{dev}.txt"], N_TEST),
             ("best_tau_head", ["--which_head", "best_tau_head", "--tau",
                                "0.5", "--split", SERVE_HEAD_SPLIT],
              SERVE_HEAD_TEST),
             ("wsft_head", ["--which_head", "wsft_head", "--split",
                            SERVE_HEAD_SPLIT], SERVE_HEAD_TEST))
    for name, extra, n_images in heads:
        runs = {}
        for dev in ("cuda", "cpu"):
            args = [a.format(d=f"{workdir}/serve", dev=dev) for a in extra]
            runs[dev] = _cli_test(base + ["--checkpoint_path", ckpt,
                                          "--model_path", bundle, *args],
                                  dev)
        card, cpu = runs["cuda"], runs["cpu"]
        batches = math.ceil(n_images / SERVE_BSZ)
        need = _need_fwd(card, batches)
        _check_counts(f"[eval-cli] {name}", card, need)
        _check_counts(f"[eval-cli] {name} on the CPU", cpu, 0)
        same = card["line"] == cpu["line"]
        extra_note = ""
        if name == "head":
            pred = {dev: np.loadtxt(f"{workdir}/serve/pred_{dev}.txt")
                    for dev in runs}
            utrain = {}
            for dev in runs:
                with open(f"{workdir}/serve/utrain_{dev}.txt", "rb") as f:
                    utrain[dev] = f.read()
            rel = float(np.max(np.abs(pred["cuda"][:, 1] - pred["cpu"][:, 1])
                               / np.abs(pred["cpu"][:, 1]).max()))
            same = (same and pred["cuda"].shape == (N_TEST, 2)
                    and np.array_equal(pred["cuda"][:, 0], pred["cpu"][:, 0])
                    and utrain["cuda"] == utrain["cpu"])
            extra_note = (f"; {N_TEST} predicted labels equal, max logits "
                          f"differ by {rel:.2e} of the largest, utrain files "
                          f"byte-equal ({len(utrain['cuda'])} bytes)")
        flags = " ".join(a for a in extra[2:] if a.startswith("--")
                         or not a.startswith("{"))
        log(f"[eval-cli] --which_head {name} {flags}: card "
            f"'{card['line']}' in {card['wall']:.2f} s, CPU '{cpu['line']}' "
            f"in {cpu['wall']:.2f} s (host clock, decode included){extra_note}"
            f" | mha_fwd launches {card['counts'][0]} (need {need}: "
            f"{batches} image batches x 12 layers"
            f"{', prompts encoded' if card['encoded_prompts'] else ''}), "
            f"CPU 0 on {smi} {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"cli.test --which_head {name}: card and "
                                 "CPU disagree")
        total += card["counts"][0]
    batches = math.ceil(N_TEST / SERVE_BSZ)
    runs = {}
    for tag, path in (("pt", ckpt), ("msgpack", converted["none"])):
        runs[tag] = _cli_test(base + ["--checkpoint_path", path], "cuda")
        need = _need_fwd(runs[tag], batches)
        _check_counts(f"[eval-cli] --checkpoint_path .{tag}", runs[tag], need)
        total += runs[tag]["counts"][0]
    ok = runs["pt"]["line"] == runs["msgpack"]["line"]
    log(f"[eval-cli] --checkpoint_path the converted .msgpack: "
        f"'{runs['msgpack']['line']}', the .pt: '{runs['pt']['line']}' on "
        f"{smi} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a converted bundle as --checkpoint_path gave "
                             "another line than its .pt")
    return total


def _write_ood_trees(workdir, ckpt):
    """<workdir>/smoke1000: 1000 synthetic class names (the prompt-built
    head's) and a test split of N_OOD_TEST images; the OOD trees under
    <workdir>: imagenet_v2 (numeric folders), imagenet_adv/imagenet-a and
    imagenet_ren/imagenet-r (wnid folders of their 200-class subsets),
    N_OOD_PER_TREE class-colored images each, every image in the folder of
    the class the card's towers and prompt head predict for it (among the
    subset's classes for -A / -R), so that a right sweep scores 100 % on
    the card.  -> ({tree: images}, the smallest nonzero top-1 / top-2
    logit gap, the images whose top two classes tie)."""
    import glob
    import io
    import os

    import numpy as np
    import torch
    from PIL import Image

    from swat_tpu_torch.core.config import RunConfig
    from swat_tpu_torch.data.pipeline import EvalLoader
    from swat_tpu_torch.data.splits import Sample
    from swat_tpu_torch.eval.ood import (_load_asset, ood_index_subset)
    from swat_tpu_torch.models.head import head_logits
    from swat_tpu_torch.train.stages import SwatPipeline

    rng = np.random.default_rng(5)
    ddir = f"{workdir}/smoke1000"
    os.makedirs(f"{ddir}/imgs", exist_ok=True)
    with open(f"{ddir}/smoke1000_metrics-LAION400M.json", "w") as f:
        json.dump({str(c): {"name": f"item {c}",
                            "most_common_name": f"object kind {c}"}
                   for c in range(OOD_CLASSES)}, f)

    def image(path):
        h, w = rng.integers(240, 400, 2)
        color = rng.integers(30, 225, 3)
        arr = (color + rng.integers(-40, 40, (h, w, 3))).clip(0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(path, quality=90)

    lines = []
    for i in range(N_OOD_TEST):
        image(f"{ddir}/imgs/test_{i}.jpg")
        lines.append(f"imgs/test_{i}.jpg {rng.integers(OOD_CLASSES)} 0")
    with open(f"{ddir}/test.txt", "w") as f:
        f.write("\n".join(lines) + "\n")

    with contextlib.redirect_stdout(io.StringIO()):
        pipe = SwatPipeline(RunConfig(
            dataset="smoke1000", dataset_path=workdir,
            retrieved_path=workdir, model_cfg=MODEL_CFG,
            checkpoint_path=ckpt, method="zeroshot", num_workers=8,
            folder=f"{workdir}/serve/ood_helper", device="cuda").derived())
    # the sweep's cli.test run encodes the 1000 prompts itself
    for path in glob.glob(f"{ddir}/prompts/*.npz"):
        os.remove(path)
    asset = _load_asset()
    trees = {"imagenet_v2": "imagenet_v2",
             "imagenet_adv": "imagenet_adv/imagenet-a",
             "imagenet_ren": "imagenet_ren/imagenet-r"}
    exts = (".jpg", ".JPEG", ".png")
    gaps, ties = [], 0
    for name, rel in trees.items():
        stage = f"{workdir}/serve/stage_{name}"
        os.makedirs(stage)
        paths = [f"{stage}/img{i}{exts[i % 3]}"
                 for i in range(N_OOD_PER_TREE)]
        for p in paths:
            image(p)
        loader = EvalLoader([Sample(p, 0, 0) for p in paths],
                            batch_size=OOD_BSZ,
                            n_px=pipe.model_cfg.vision.image_size,
                            num_workers=8)
        with torch.inference_mode():
            (batch,) = list(loader)
            feats = pipe.model.encode_image(
                torch.from_numpy(batch["images"]).cuda(), normalize=True)
            logits = head_logits(pipe.zeroshot_head, feats)
        sub = ood_index_subset(name)
        if sub is not None:
            logits = logits[:, torch.as_tensor(sub, device=logits.device)]
        logits = logits[:len(paths)]
        # the sweep's own argmax (the first of tied classes: names whose
        # prompts tokenize alike give equal head rows)
        preds = logits.argmax(dim=-1)
        top = logits.topk(2, dim=-1).values
        gap = top[:, 0] - top[:, 1]
        ties += int((gap == 0).sum())
        gaps += gap[gap > 0].tolist()
        for p, pred in zip(paths, preds.tolist()):
            idx = pred if sub is None else sub[pred]
            folder = str(idx) if sub is None else asset["all_wnids"][idx]
            os.makedirs(f"{workdir}/{rel}/{folder}", exist_ok=True)
            os.rename(p, f"{workdir}/{rel}/{folder}/{os.path.basename(p)}")
    del pipe
    torch.cuda.empty_cache()
    return ({name: N_OOD_PER_TREE for name in trees},
            min(gaps, default=0.0), ties)


def phase_ood(workdir, ckpt, smi):
    """--test_imagenet_ood through swat_tpu_torch.cli.test on the smoke1000
    dataset (1000 class names: the prompt encode runs the causal forward
    at B = 1000) over the three synthetic trees, card against CPU: equal
    accuracies, 100 % on the card.  -> mha_fwd launches of the card run."""
    import math

    trees, gap, ties = _write_ood_trees(workdir, ckpt)
    base = ["--dataset", "smoke1000", "--dataset_path", workdir,
            "--retrieved_path", workdir, "--model_cfg", MODEL_CFG,
            "--checkpoint_path", ckpt, "--test_imagenet_ood",
            "--folder", f"{workdir}/serve/ood"]
    card = _cli_test(base, "cuda", OOD_BSZ)
    cpu = _cli_test(base, "cpu", OOD_BSZ)
    image_batches = math.ceil(N_OOD_TEST / OOD_BSZ) + sum(
        math.ceil(n / OOD_BSZ) for n in trees.values())
    need = _need_fwd(card, image_batches, n_prompts=OOD_CLASSES)
    _check_counts("[ood] card", card, need)
    _check_counts("[ood] CPU", cpu, 0)
    accs = json.loads(card["ood"])
    ok = (card["ood"] == cpu["ood"] and card["line"] == cpu["line"]
          and sorted(accs) == sorted(trees)
          and all(a == 100.0 for a in accs.values()))
    log(f"[ood] --test_imagenet_ood over {trees} images (a 1000-class "
        f"prompt head, prompts encoded: {card['encoded_prompts']}): card "
        f"{card['ood']} in {card['wall']:.2f} s, CPU {cpu['ood']} in "
        f"{cpu['wall']:.2f} s (host clock); smallest nonzero top-1/top-2 "
        f"logit gap of the trees' images {gap:.2e}, {ties} exact ties "
        f"(tied head rows); mha_fwd launches "
        f"{card['counts'][0]} (need {need}) on {smi} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the OOD sweep disagrees between card and CPU")
    return card["counts"][0]


def _w8a8_split(prof, n):
    """Device ms per forward by family: attention (kernel #1), int8 GEMMs
    (cuBLASLt's s8 / i8 kernels), float GEMMs, and the rest (LayerNorm,
    GELU, residual adds, and in an int8 forward the quantize and
    dequantize passes) -> (split, the largest kernels of each family)."""
    from torch.autograd import DeviceType

    split = {"attention": 0.0, "int8 gemm": 0.0, "gemm": 0.0, "other": 0.0}
    names: dict = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = evt.key.lower()
        ms = evt.self_device_time_total / 1e3 / n
        gemm = any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma",
                                       "imma"))
        if "attention_fwd" in name:
            fam = "attention"
        elif gemm and any(t in name for t in ("s8", "i8", "int8", "imma")):
            fam = "int8 gemm"
        elif gemm:
            fam = "gemm"
        else:
            fam = "other"
        split[fam] += ms
        names.setdefault(fam, []).append((round(ms, 3), evt.key[:60]))
    return split, {k: sorted(v, reverse=True)[:2] for k, v in names.items()}


def _tokens(n, cfg, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    ctx, vocab = cfg.text.context_length, cfg.text.vocab_size
    tokens = torch.zeros(n, ctx, dtype=torch.long)
    for i in range(n):
        k = 2 + (7 * i) % (ctx - 3)
        tokens[i, 0] = vocab - 2
        tokens[i, 1:k] = torch.randint(1, vocab - 3, (k - 1,), generator=gen)
        tokens[i, k] = vocab - 1
    return tokens


def phase_w8a8(workdir, ckpt, converted, smi):
    """W8A8 int8 inference: the int8 towers from the converted bundle on the
    card against the same on the CPU and against the fp32 towers; one int8
    forward of the full-width ViT-L/14 image tower (K = 588, padded);
    cli.test --quantize int8 from the .pt and from the int8 bundle; the
    image tower's forward at B = 256 in fp32, bf16, int8 over fp32 and int8
    over bf16, each timed, profiled and its peak memory.  -> mha_fwd
    launches of the counted runs."""
    import math

    import torch

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.models.clip import CLIPModel
    from swat_tpu_torch.models.configs import get_model_config
    from swat_tpu_torch.models.loader import (jax_params_from_state_dict,
                                              load_torch_checkpoint,
                                              state_dict_from_jax_params)
    from swat_tpu_torch.models.quant import quantize_tree

    cfg = get_model_config(MODEL_CFG)
    FP32_PRECISION.apply_backend_flags()

    def model_from(path, device):
        sd, _ = load_torch_checkpoint(path)
        return CLIPModel(cfg, precision=FP32_PRECISION).load_weights(
            sd).to(device).eval()

    fp32 = model_from(ckpt, "cuda")
    int8 = model_from(converted["int8"], "cuda")
    int8_cpu = model_from(converted["int8"], "cpu")
    gen = torch.Generator().manual_seed(11)
    n_px = cfg.vision.image_size
    images = torch.randn(8, n_px, n_px, 3, generator=gen)
    tokens = _tokens(8, cfg, 12)
    total = 0
    with torch.inference_mode():
        feats = {}
        for tag, model, dev in (("fp32", fp32, "cuda"), ("int8", int8, "cuda"),
                                ("int8_cpu", int8_cpu, "cpu")):
            _reset_counts(FA)
            feats[tag] = [model.encode_image(images.to(dev),
                                             normalize=True).cpu(),
                          model.encode_text(tokens.to(dev),
                                            normalize=True).cpu()]
            if tag == "int8":
                run = {"counts": _counts(FA)}
                _check_counts("[w8a8] int8 towers", run,
                              cfg.vision.layers + cfg.text.layers)
                total += run["counts"][0]
    ok = True
    for i, tower in enumerate(("image", "text")):
        got, ref, f32 = (feats[t][i] for t in ("int8", "int8_cpu", "fp32"))
        finite = bool(torch.isfinite(got).all()) and got.shape == (
            8, cfg.embed_dim)
        cos_cpu = float((got * ref).sum(-1).min())
        cos32 = (got * f32).sum(-1)
        good = (finite and cos_cpu >= INT8_CARD_MIN_COS
                and float(cos32.mean()) > INT8_MIN_MEAN_COS[tower])
        ok = ok and good
        log(f"[w8a8] {MODEL_CFG} int8 {tower} tower (B=8): min cosine card "
            f"vs CPU {cos_cpu:.8f} (bound {INT8_CARD_MIN_COS}), max abs "
            f"{float((got - ref).abs().max()):.2e}; against fp32 on the card "
            f"mean cosine {float(cos32.mean()):.6f} (bound "
            f"{INT8_MIN_MEAN_COS[tower]}), min {float(cos32.min()):.6f} "
            f"{'ok' if good else 'FAIL'}")
    del int8_cpu, feats
    if not ok:
        raise AssertionError("[w8a8] the int8 towers disagree")

    # ViT-L/14's image tower in int8: its patch embedding has K = 588
    lcfg = get_model_config("vitl14_openclip_laion400m")
    big = CLIPModel(lcfg, precision=FP32_PRECISION).init_random(
        torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    qtree = quantize_tree(jax_params_from_state_dict(big.state_dict())[0])
    quant_s = time.perf_counter() - t0
    big = big.cuda().eval()
    big_q = CLIPModel(lcfg, precision=FP32_PRECISION).load_weights(
        state_dict_from_jax_params(qtree, 0.0)).cuda().eval()
    del qtree
    n_px = lcfg.vision.image_size
    limages = torch.randn(16, n_px, n_px, 3, generator=gen).cuda()
    with torch.inference_mode():
        ref = big.encode_image(limages, normalize=True)
        _reset_counts(FA)
        got = big_q.encode_image(limages, normalize=True)
        torch.cuda.synchronize()
        counts = _counts(FA)
    _check_counts("[w8a8] vitl14 int8 image tower", {"counts": counts},
                  lcfg.vision.layers)
    cos = (got * ref).sum(-1)
    good = (bool(torch.isfinite(got).all())
            and got.shape == (16, lcfg.embed_dim)
            and float(cos.mean()) > INT8_MIN_MEAN_COS["image"])
    log(f"[w8a8] vitl14 int8 image tower (B=16, K = "
        f"{3 * lcfg.vision.patch_size ** 2} padded to "
        f"{3 * lcfg.vision.patch_size ** 2 + (-3 * lcfg.vision.patch_size ** 2) % 8}"
        f"; quantize_tree {quant_s:.2f} s on the host): mean cosine against "
        f"fp32 {float(cos.mean()):.6f}, min {float(cos.min()):.6f}; "
        f"launches {counts} {'ok' if good else 'FAIL'}")
    if not good:
        raise AssertionError("[w8a8] the int8 ViT-L/14 tower failed")
    total += counts[0]
    del big, big_q, limages
    torch.cuda.empty_cache()

    # cli.test --quantize int8, from the .pt and from the int8 bundle
    base = ["--dataset", "smoke10", "--dataset_path", workdir,
            "--retrieved_path", workdir, "--model_cfg", MODEL_CFG,
            "--folder", f"{workdir}/serve/w8a8"]
    batches = math.ceil(N_TEST / SERVE_BSZ)
    runs = {}
    for tag, extra in (("--quantize int8", ["--checkpoint_path", ckpt,
                                            "--quantize", "int8"]),
                       ("int8 bundle", ["--checkpoint_path",
                                        converted["int8"]]),
                       ("fp32", ["--checkpoint_path", ckpt])):
        runs[tag] = _cli_test(base + extra, "cuda")
        if tag != "fp32":
            need = _need_fwd(runs[tag], batches)
            _check_counts(f"[w8a8] cli.test {tag}", runs[tag], need)
            total += runs[tag]["counts"][0]
    ok = runs["--quantize int8"]["line"] == runs["int8 bundle"]["line"]
    log(f"[w8a8] cli.test --quantize int8: '{runs['--quantize int8']['line']}'"
        f" in {runs['--quantize int8']['wall']:.2f} s; --checkpoint_path the "
        f"int8 bundle: '{runs['int8 bundle']['line']}'; fp32: "
        f"'{runs['fp32']['line']}' (host clock, decode included) on {smi} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[w8a8] --quantize int8 and the int8 bundle "
                             "disagree")

    # the image tower's forward at the eval batch, four ways, timed in
    # turns, then each profiled with its peak memory
    n_px = cfg.vision.image_size
    batch = torch.randn(SERVE_BSZ, n_px, n_px, 3, generator=gen).cuda()
    variants = (("fp32", fp32, FP32_PRECISION),
                ("bf16", fp32, DEFAULT_PRECISION),
                ("int8/fp32", int8, FP32_PRECISION),
                ("int8/bf16", int8, DEFAULT_PRECISION))

    def forward(model, precision):
        precision.apply_backend_flags()
        model.precision = precision
        return lambda: model.encode_image(batch)

    with torch.inference_mode():
        times = {name: [] for name, _, _ in variants}
        for order in (variants, variants[::-1]):
            for name, model, precision in order:
                times[name].append(_time_ms(forward(model, precision),
                                            iters=5, warmup=2))
        stats = {}
        for name, model, precision in variants:
            fn = forward(model, precision)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            busy, window, split, top = _profiled(fn, 2, _w8a8_split)
            stats[name] = (sum(times[name]) / 2, busy, window, split, peak,
                           top)
    FP32_PRECISION.apply_backend_flags()
    for name, (ms, busy, window, split, peak, top) in stats.items():
        float_other = stats["bf16" if "bf16" in name else "fp32"][3]["other"]
        qdq = (f"; quantize/dequantize passes ~{split['other'] - float_other:.3f}"
               f" ms (other minus the float forward's)"
               if name.startswith("int8") else "")
        log(f"[w8a8] {MODEL_CFG} image tower forward B={SERVE_BSZ} {name}: "
            f"{ms:.3f} ms ({SERVE_BSZ * 1e3 / ms:.1f} images/s; turns "
            f"{', '.join(f'{t:.3f}' for t in times[name])}), peak "
            f"{peak / 2 ** 30:.3f} GiB allocated; profiled {busy:.3f} ms busy "
            f"of a {window:.3f} ms window (idle "
            f"{_idle(busy, window)}): "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f"{qdq}; largest {top} on {smi}")
    del fp32, int8, batch
    torch.cuda.empty_cache()
    return total


def _serving_phases(workdir, ckpt, smi):
    """[w8a8]'s conversions, [eval-cli] on the flagship run's stage-1
    bundle, [ood] and [w8a8] -> their mha_fwd launches."""
    import glob
    import os

    os.makedirs(f"{workdir}/serve", exist_ok=True)
    (bundle,) = glob.glob(f"{workdir}/train_{MODEL_CFG}_cutmix_float32_auto/"
                          "**/stage1_model_best-epoch_*_best.msgpack",
                          recursive=True)
    t0 = time.perf_counter()
    converted = phase_convert(workdir, ckpt, smi)
    launches = phase_eval_cli(workdir, ckpt, bundle, converted, smi)
    t1 = time.perf_counter()
    launches += phase_ood(workdir, ckpt, smi)
    t2 = time.perf_counter()
    launches += phase_w8a8(workdir, ckpt, converted, smi)
    log(f"[serve] eval-cli {t1 - t0:.1f} s, ood {t2 - t1:.1f} s, w8a8 "
        f"{time.perf_counter() - t2:.1f} s; mha_fwd launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# retrieval: swat_tpu_torch.retrieval.cli (captionmap, extract, sample,
# filter-synonyms) on a mined tree, and the fused sampler on a pool of an
# ImageNet retrieval's size

MINED_CLASSES, MINED_PER_CLASS = 10, 52
EXTRACT_BSZ = 256
CPU_EXTRACT_CLASSES = 1
MINED_SAMPLES = 20
MINED_FEWSHOT = 4
# the sample runs read the extracted features rounded to multiples of
# 2^-10 (|x| <= 1, D = 512): every product and sum of the ranking is then
# exact in fp32 whatever the order of its terms, on the card and on the
# CPU, so the engines and devices agree bit for bit and ties are real
SAMPLE_GRID = 2.0 ** -10
# class names and candidate synonyms for filter-synonyms: the seeded random
# towers' text features lie close together, so these were picked for an
# argmax margin (>= 4e-3 on the CPU) well past how far the card's and the
# CPU's logits part; 7 land on their own class
SYNONYMS = {
    "0": ("red thing", ["ember", "rose"]),
    "1": ("green thing", ["fern", "clover"]),
    "2": ("blue thing", ["lagoon", "glacier"]),
    "3": ("small dog", ["badger", "otter"]),
    "4": ("large cat", ["jaguar", "owl"]),
    "5": ("old car", ["castle", "carpet"]),
    "6": ("tall tree", ["hazel", "hill"]),
    "7": ("white bird", ["pigeon", "spider"]),
    "8": ("wooden chair", ["comet", "squirrel"]),
    "9": ("ocean wave", ["willow", "harbor"]),
}
# the pool of an ImageNet retrieval: 1000 classes x 2000 candidates at
# D = 512, on a grid of 1/32 (products exact, as above); its C * N = 2e9 is
# past rank.MAX_DENSE_ELEMS, so the ranking streams in chunks by itself
RANK_CLASSES, RANK_PER_CLASS, RANK_DIM, RANK_SAMPLES = 1000, 2000, 512, 500
RANK_FEWSHOT = 4


def _write_mined(root, seed=2):
    """<root>/mined/<class>/<i>.jpg: MINED_PER_CLASS seeded noise JPEGs of
    varied sizes a class, and <root>/meta.json, the download metadata with a
    caption an image."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    metadata = {}
    for c in range(MINED_CLASSES):
        os.makedirs(f"{root}/mined/{c}")
        metadata[str(c)] = {}
        for i in range(MINED_PER_CLASS):
            h, w = 64 + 7 * (i % 9), 96 - 5 * (i % 7)
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            img[: h // 2] //= 1 + c % 3
            Image.fromarray(img).save(f"{root}/mined/{c}/{i}.jpg")
            metadata[str(c)][str(i)] = {
                "caption": f"photo {i} of a {SYNONYMS[str(c)][0]}"}
    with open(f"{root}/meta.json", "w") as f:
        json.dump(metadata, f)


def _retrieval_cli(argv, device=None):
    """One run of swat_tpu_torch.retrieval.cli; the four counts are set to
    0 just before it and read just after -> (counts, wall s, stdout)."""
    import io

    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.retrieval.cli import main as retrieval_main

    buf = io.StringIO()
    _reset_counts(FA)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        retrieval_main(argv + (["--device", device] if device else []))
    return _counts(FA), time.perf_counter() - t0, buf.getvalue()


def _load_npz(path):
    import numpy as np

    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _cosine_rows(a, b):
    import numpy as np

    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                * np.linalg.norm(b, axis=-1))


def _retrieval_extract(root, ckpt, smi):
    """captionmap, then extract on the card (bf16, the default), again with
    --quantize int8, and on the CPU over the first CPU_EXTRACT_CLASSES
    classes; card against CPU at the towers' bf16 bound -> (the card's bf16
    bundle path, mha_fwd launches)."""
    import math
    import shutil

    import numpy as np

    from swat_tpu_torch.models.configs import get_model_config

    cfg = get_model_config(MODEL_CFG)
    _retrieval_cli(["captionmap", "--metadata", f"{root}/meta.json",
                    "--output", f"{root}/cmap.json"])
    n = MINED_CLASSES * MINED_PER_CLASS
    batches = math.ceil(n / EXTRACT_BSZ)
    need = (cfg.vision.layers + cfg.text.layers) * batches
    base = ["extract", "--mined_dir", f"{root}/mined", "--caption_map",
            f"{root}/cmap.json", "--model_cfg", MODEL_CFG,
            "--checkpoint_path", ckpt, "--bsz", str(EXTRACT_BSZ)]
    # the CPU's run (bf16 on the host: ~0.2 s a pair there) takes the same
    # command over the first CPU_EXTRACT_CLASSES class folders
    for c in range(CPU_EXTRACT_CLASSES):
        shutil.copytree(f"{root}/mined/{c}", f"{root}/mined_cpu/{c}")
    runs = {}
    for tag, device, extra in (("card", "cuda", []),
                               ("int8", "cuda", ["--quantize", "int8"]),
                               ("cpu", "cpu", ["--mined_dir",
                                               f"{root}/mined_cpu"])):
        out = f"{root}/mined_{tag}.npz"
        counts, wall, _ = _retrieval_cli(base + extra + ["--output", out],
                                         device)
        runs[tag] = (_load_npz(out), counts, wall)
        want = (need if device == "cuda" else 0, 0, 0, 0)
        if counts != want:
            raise AssertionError(f"[retrieval] extract {tag}: launches "
                                 f"{counts}, need {want}")
    card, cpu, int8 = (runs[t][0] for t in ("card", "cpu", "int8"))
    m = CPU_EXTRACT_CLASSES * MINED_PER_CLASS
    paths = [p.replace("/mined_cpu/", "/mined/") for p in cpu["file_paths"]]
    ok = (paths == list(card["file_paths"][:m])
          and np.array_equal(card["labels"][:m], cpu["labels"])
          and np.array_equal(card["captions"][:m], cpu["captions"])
          and all(np.array_equal(card[k], int8[k])
                  for k in ("labels", "file_paths", "captions")))
    notes = []
    for k in ("image_features", "caption_features"):
        got = card[k]
        ok = ok and got.shape == (n, cfg.embed_dim) and bool(
            np.isfinite(got).all()) and got.dtype == np.float32
        cos = float(_cosine_rows(got[:m], cpu[k]).min())
        cos8 = float(_cosine_rows(int8[k], got).mean())
        tower = "image" if k.startswith("image") else "text"
        ok = (ok and cos >= TOWER_MIN_COS["bfloat16"]
              and cos8 > INT8_MIN_MEAN_COS[tower])
        notes.append(f"{k}: card vs CPU min cosine {cos:.6f} (bound "
                     f"{TOWER_MIN_COS['bfloat16']}), int8 vs bf16 card mean "
                     f"{cos8:.6f} (bound {INT8_MIN_MEAN_COS[tower]})")
    log(f"[retrieval] extract {n} pairs at bsz {EXTRACT_BSZ}, {MODEL_CFG} "
        f"bf16: card {runs['card'][2]:.2f} s ({n / runs['card'][2]:.1f} "
        f"pairs/s, decode included), int8 {runs['int8'][2]:.2f} s, CPU "
        f"{runs['cpu'][2]:.2f} s for the first {m} (host clock); mha_fwd "
        f"launches "
        f"{runs['card'][1][0]} / {runs['int8'][1][0]} (need {need}: "
        f"{batches} image + {batches} caption batches x 12 layers), CPU 0; "
        + "; ".join(notes) + f" on {smi} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[retrieval] extract: card and CPU disagree")
    return f"{root}/mined_card.npz", runs["card"][1][0] + runs["int8"][1][0]


def _retrieval_sample(root, features, smi):
    """Each strategy, and T2T-rank with --remove_duplicates and
    --zeroshot_filter, through `sample` with the fused engine on the card,
    the per-class engine on the card and the fused engine on the CPU, on
    the extracted features rounded to SAMPLE_GRID: their four files
    byte-equal."""
    import numpy as np

    from swat_tpu_torch.data.prompts import save_prompt_tensors
    from swat_tpu_torch.retrieval.sampler import STRATEGIES

    feats = _load_npz(features)
    for k in ("image_features", "caption_features"):
        feats[k] = (np.round(feats[k] / SAMPLE_GRID)
                    * SAMPLE_GRID).astype(np.float32)
    np.savez(f"{root}/mined_grid.npz", **feats)
    # a class's prompt: the normalized sum of its images' and captions'
    # normalized means (on the grid), so that the gates (0.25, 0.65) split
    # the scores of the random towers' features
    labels = feats["labels"]
    prompts = {}
    for c in range(MINED_CLASSES):
        v = sum(m / np.linalg.norm(m) for m in (
            feats[k][labels == c].mean(0)
            for k in ("image_features", "caption_features")))
        v = np.round(v / np.linalg.norm(v) / SAMPLE_GRID) * SAMPLE_GRID
        prompts[str(c)] = {"all": v[None].astype(np.float32),
                           "mean": v.astype(np.float32)}
    save_prompt_tensors(f"{root}/prompts.npz", prompts)
    # few-shot exemplars: MINED_FEWSHOT a class (a power of two, so their
    # mean is exact too), each the normalized sum of a pool pair's image
    # and caption features (on the grid), so that the I2I and I2T gates
    # split the scores too
    pick = np.concatenate([np.flatnonzero(labels == c)[:MINED_FEWSHOT]
                           for c in range(MINED_CLASSES)])
    fs = sum(x / np.linalg.norm(x, axis=1, keepdims=True) for x in (
        feats[k][pick] for k in ("image_features", "caption_features")))
    fs = np.round(fs / np.linalg.norm(fs, axis=1, keepdims=True)
                  / SAMPLE_GRID) * SAMPLE_GRID
    np.savez(f"{root}/fewshot.npz", image_features=fs.astype(np.float32),
             labels=labels[pick])
    cases = [(s, []) for s in STRATEGIES]
    cases.append(("T2T-rank", ["--remove_duplicates", "--zeroshot_filter"]))
    names = ("split.txt", "split_sampled_list.txt",
             "split_filtered_list.txt", "split_num_imgs_sampled.json")
    t0 = time.perf_counter()
    sampled = []
    for strategy, flags in cases:
        outs = {}
        for tag, engine, device in (("fused", "fused", "cuda"),
                                    ("per-class", "per-class", "cuda"),
                                    ("cpu", "fused", "cpu")):
            d = f"{root}/sample/{strategy}{''.join(flags)}/{tag}"
            _retrieval_cli([
                "sample", "--features", f"{root}/mined_grid.npz",
                "--prompts", f"{root}/prompts.npz", "--fewshot_features",
                f"{root}/fewshot.npz", "--strategy", strategy,
                "--num_samples", str(MINED_SAMPLES), "--engine", engine,
                "--relative_to", f"{root}/mined", *flags,
                "--output", f"{d}/split.txt"], device)
            files = []
            for name in names:
                with open(f"{d}/{name}", "rb") as f:
                    files.append(f.read())
            outs[tag] = files
        fused, oracle = outs["fused"], outs["per-class"]
        extra = _filtered_beyond(fused[2], oracle[2])
        ok = fused == outs["cpu"] and fused[:2] == oracle[:2] \
            and fused[3] == oracle[3] and extra is not None
        n_lines = fused[0].count(b"\n")
        sampled.append(f"{strategy}{' ' + ' '.join(flags) if flags else ''}"
                       f" {n_lines} ({extra} tied)")
        if not ok or n_lines == 0:
            raise AssertionError(f"[retrieval] sample {strategy} {flags}: "
                                 f"fused, per-class and CPU files differ "
                                 f"({n_lines} lines)")
    log(f"[retrieval] sample, {len(cases)} runs x (fused card, per-class "
        f"card, fused CPU) on {MINED_CLASSES * MINED_PER_CLASS} candidates, "
        f"--num_samples {MINED_SAMPLES}: card and CPU files byte-equal, "
        f"per-class split files, sampled lists and counts byte-equal to "
        f"fused, its filtered lists fused's plus lines tied at a class's "
        f"cutoff; lines kept (tied filtered lines): {', '.join(sampled)}; "
        f"{time.perf_counter() - t0:.2f} s on {smi} ok")


def _filtered_beyond(fused, oracle):
    """The fused engine lists a filtered candidate only when it outranks its
    class's cutoff strictly; the per-class walk also lists those tied with
    the cutoff that it meets before the quota fills (as swat_tpu's engines
    do) -> how many lines the oracle lists beyond the fused engine's, or
    None when the fused engine lists one the oracle does not."""
    got = fused.split(b"\n") if fused else []
    ref = oracle.split(b"\n") if oracle else []
    if not set(got) <= set(ref):
        return None
    return len(ref) - len(got)


def _retrieval_synonyms(root, ckpt, smi):
    """filter-synonyms on the card and on the CPU: the same kept lists;
    each synonym's argmax margin beside how far the two devices' logits
    part -> mha_fwd launches of the card's run."""
    import numpy as np

    from swat_tpu_torch.data.features import batched_encode, make_text_encoder
    from swat_tpu_torch.models.tokenizer import get_tokenizer
    from swat_tpu_torch.retrieval.cli import load_model

    names = {k: {"query_name": q, "synonyms": {s: 1 for s in syns}}
             for k, (q, syns) in SYNONYMS.items()}
    with open(f"{root}/synonyms.json", "w") as f:
        json.dump(names, f)
    outs, counts = {}, {}
    for device in ("cuda", "cpu"):
        out = f"{root}/synonyms_{device}.json"
        counts[device], _, _ = _retrieval_cli(
            ["filter-synonyms", "--synonyms", f"{root}/synonyms.json",
             "--model_cfg", MODEL_CFG, "--checkpoint_path", ckpt,
             "--output", out], device)
        with open(out, "rb") as f:
            outs[device] = f.read()
    texts = ([f"a photo of a {q}" for q, _ in SYNONYMS.values()]
             + [f"a photo of a {s}" for _, syns in SYNONYMS.values()
                for s in syns])
    logits = {}
    for device in ("cuda", "cpu"):
        model = load_model(MODEL_CFG, ckpt, device)
        tokens = get_tokenizer(None, vocab_size=model.cfg.text.vocab_size)(
            texts, model.cfg.text.context_length)
        f = batched_encode(make_text_encoder(model), np.asarray(tokens))
        c = len(SYNONYMS)
        logits[device] = f[c:] @ f[:c].T
    top = np.sort(logits["cuda"], axis=1)
    margin = float((top[:, -1] - top[:, -2]).min())
    apart = float(np.abs(logits["cuda"] - logits["cpu"]).max())
    kept = sum(len(v["synonyms_filtered"])
               for v in json.loads(outs["cuda"]).values())
    ok = (outs["cuda"] == outs["cpu"] and counts["cuda"] == (12, 0, 0, 0)
          and counts["cpu"] == (0, 0, 0, 0) and margin > apart)
    log(f"[retrieval] filter-synonyms, {len(texts)} prompts: card and CPU "
        f"keep the same {kept} of {len(texts) - len(SYNONYMS)} synonyms "
        f"(smallest argmax margin {margin:.2e} > card and CPU logits part "
        f"by {apart:.2e}); mha_fwd launches {counts['cuda'][0]} (need 12: one "
        f"batch x 12 layers) on {smi} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[retrieval] filter-synonyms: card and CPU "
                             "disagree")
    return counts["cuda"][0]


def _rank_pool(seed=4):
    """The ImageNet-sized pool, made on the card from a seeded generator and
    brought to the host: each class's images a shared center plus noise,
    its few-shot exemplars twice the center plus noise (so that the I2I
    gate at 0.65 splits the pool), captions the class prompt plus noise
    (scores on a grid of 2^-10: ties in every class); every 97th candidate
    an exact copy of one three rows up, which the dedup drops -> (MinedPool,
    prompts, few-shot exemplars)."""
    import numpy as np
    import torch

    from swat_tpu_torch.retrieval.sampler import MinedPool

    g = torch.Generator(device="cuda").manual_seed(seed)
    c, per, d = RANK_CLASSES, RANK_PER_CLASS, RANK_DIM
    n = c * per

    def draw(rows, lo, hi):
        return torch.randint(lo, hi + 1, (rows, d), generator=g,
                             device="cuda").float() / 32

    center, prompt = draw(c, -1, 1), draw(c, -1, 1)
    labels = torch.arange(c, device="cuda").repeat_interleave(per)
    rows = torch.arange(n, device="cuda")
    src = torch.where(rows % 97 == 5, rows - 3, rows)
    img = (center[labels] + draw(n, -2, 2))[src].cpu().numpy()
    cap = (prompt[labels] + draw(n, -2, 2))[src].cpu().numpy()
    fewshot = (2 * center.repeat_interleave(RANK_FEWSHOT, 0)
               + draw(c * RANK_FEWSHOT, -1, 1)).cpu().numpy()
    files = [f"/pool/{i // per}/{i % per:05d}.jpg" for i in range(n)]
    pool = MinedPool(files, labels.cpu().numpy(), img, cap)
    prompts = {str(k): {"mean": v} for k, v in
               enumerate(prompt.cpu().numpy())}
    fs = {k: fewshot[k * RANK_FEWSHOT:(k + 1) * RANK_FEWSHOT]
          for k in range(c)}
    return pool, prompts, fs


class _StageClock:
    """Wraps module functions of the fused sampler: the host wall and the
    CUDA-event time of each call, summed by stage."""

    def __init__(self):
        self.wall, self.device, self._saved = {}, {}, []

    def wrap(self, module, name, stage):
        import torch

        fn = getattr(module, name)

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            torch.cuda.synchronize()
            self.wall[stage] = (self.wall.get(stage, 0.0)
                                + time.perf_counter() - t0)
            self.device[stage] = (self.device.get(stage, 0.0)
                                  + start.elapsed_time(end) / 1e3)
            return out

        self._saved.append((module, name, fn))
        setattr(module, name, timed)

    def restore(self):
        for module, name, fn in self._saved:
            setattr(module, name, fn)


def _retrieval_rank(smi):
    """sample_retrieved_fused (T2T-rank-I2I-tshd, RANK_SAMPLES a class,
    dedup) against sample_retrieved on the card at RANK_CLASSES x
    RANK_PER_CLASS candidates: the same selections, sampled lines and
    counts, filtered lines as _filtered_beyond allows; the
    fused sampler's time by stage, its rate and peak memory, and the
    ranking's device busy share."""
    import torch

    from swat_tpu_torch.retrieval import rank as R
    from swat_tpu_torch.retrieval import sampler as S

    t0 = time.perf_counter()
    pool, prompts, fs = _rank_pool()
    n = len(pool.file_paths)
    t_pool = time.perf_counter() - t0
    kw = dict(strategy="T2T-rank-I2I-tshd", num_samples=RANK_SAMPLES,
              fewshot_feats_by_class=fs, remove_duplicates=True,
              device="cuda")
    clock = _StageClock()
    clock.wrap(R, "rank_candidates", "rank")
    clock.wrap(R, "near_duplicate_indices_by_class", "dedup")
    clock.wrap(R, "rowwise_p2p_scores", "scores")
    clock.wrap(S, "_rowwise_scores", "scores")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        fused = S.sample_retrieved_fused(pool, prompts, **kw)
        torch.cuda.synchronize()
    finally:
        clock.restore()
    t_fused = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    oracle = S.sample_retrieved(pool, prompts, **kw)
    t_oracle = time.perf_counter() - t0
    keys = ("file_list", "label_list", "num_sampled", "sampled_info")
    tied = _filtered_beyond("\n".join(fused["filtered_info"]).encode(),
                            "\n".join(oracle["filtered_info"]).encode())
    ok = all(fused[k] == oracle[k] for k in keys) and tied is not None
    kept = len(fused["file_list"])
    full = sum(v == RANK_SAMPLES for v in fused["num_sampled"].values())
    # the ranking alone, profiled: the device's busy share of its window
    W, X, C = S._strategy_matrices(pool, prompts, kw["strategy"], fs)
    X = R._f32(X, "cuda")
    cls = pool.labels.copy()
    prof, window = _trace(lambda: R.rank_candidates(W, X, cls, RANK_SAMPLES,
                                                    device="cuda"), cpu=False)
    kernels = _device_kernels(prof)
    busy = sum(ms for ms, _ in kernels)
    top = "; ".join(f"{name[:40]} {ms:.2f} ms" for ms, name in kernels[:3])
    stages = ", ".join(f"{s} {clock.wall[s] * 1e3:.1f} ms wall / "
                       f"{clock.device[s] * 1e3:.1f} ms device"
                       for s in ("scores", "dedup", "rank"))
    rest = t_fused - sum(clock.wall.values())
    log(f"[retrieval] fused sampler at {RANK_CLASSES} classes x "
        f"{RANK_PER_CLASS} = {n} candidates, D = {RANK_DIM} "
        f"(T2T-rank-I2I-tshd, --num_samples {RANK_SAMPLES}, dedup; C * N = "
        f"{RANK_CLASSES * n:.2e} > MAX_DENSE_ELEMS, chunked): {t_fused:.2f} s "
        f"wall ({n / t_fused:,.0f} candidates/s; {stages}; host lines and "
        f"masks {rest * 1e3:.1f} ms), peak allocated {peak:.3f} GiB; the "
        f"ranking alone busy {busy:.2f} of {window:.2f} ms (idle "
        f"{_idle(busy, window)}; most: {top}); per-class oracle {t_oracle:.2f} s; pool "
        f"made in {t_pool:.2f} s; {kept} kept, {full} of {RANK_CLASSES} "
        f"classes full, {len(fused['filtered_info'])} filtered lines (the "
        f"oracle {tied} more, tied at a cutoff): fused and per-class "
        f"selections {'equal' if ok else 'DIFFER'} on {smi} "
        f"{'ok' if ok and kept else 'FAIL'}")
    if not ok or not kept:
        raise AssertionError("[retrieval] the fused sampler and the per-class "
                             "oracle disagree at the pool's size")


def phase_retrieval(workdir, ckpt, smi):
    """[retrieval]: the CLI's captionmap, extract (card bf16 and int8, CPU),
    sample (every strategy, fused and per-class, card and CPU) and
    filter-synonyms on a synthetic mined tree of the full-width ViT-B/32,
    then the fused sampler against the per-class oracle at an ImageNet
    retrieval's pool size -> mha_fwd launches of the card's CLI runs."""
    import os

    from swat_tpu_torch.core.precision import DEFAULT_PRECISION

    DEFAULT_PRECISION.apply_backend_flags()
    root = f"{workdir}/retrieval"
    os.makedirs(root)
    t0 = time.perf_counter()
    _write_mined(root)
    features, launches = _retrieval_extract(root, ckpt, smi)
    _retrieval_sample(root, features, smi)
    launches += _retrieval_synonyms(root, ckpt, smi)
    t1 = time.perf_counter()
    _retrieval_rank(smi)
    log(f"[retrieval] CLI runs {t1 - t0:.1f} s, the pool's ranking "
        f"{time.perf_counter() - t1:.1f} s; mha_fwd launches {launches}")
    return launches


# wall seconds of each phase of main(), printed before the total
PHASE_SECONDS: dict = {}


def timed(name, fn, *args):
    """``fn(*args)``, its wall seconds added to ``PHASE_SECONDS[name]``."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = (PHASE_SECONDS.get(name, 0.0)
                               + time.perf_counter() - t0)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-child":
        return _dist_child(sys.argv[2])
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
    smi, name = timed("card", phase_card)
    timed("build", phase_build)
    worst = timed("kernel-vs-plain", phase_kernel_vs_plain)
    times = timed("timing", phase_timing, smi)
    worst_bwd = timed("bwd-kernel-vs-plain", phase_bwd_kernel_vs_plain)
    times_bwd = timed("bwd-timing", phase_bwd_timing, smi)
    worst_flash = timed("flash-kernels-vs-plain",
                        phase_flash_kernels_vs_plain)
    times_flash = timed("flash-timing", phase_flash_timing, smi)
    with tempfile.TemporaryDirectory(prefix="swat_smoke_") as workdir:
        ckpt = timed("towers", phase_towers, workdir, smi)
        launches = timed("cli", phase_cli, workdir, ckpt, smi)
        timed("train-step", phase_train_step, ckpt, smi)
        step_flash = timed("attentive-step", phase_attentive_step, ckpt, smi)
        step_flash_bwd = timed("fused-step", phase_fused_step, ckpt, smi)
        cli_counts, stage2_counts, plain, flagship = timed(
            "train-cli", phase_train_cli, workdir, ckpt, "smoke10", smi)
        twin_counts = timed("twin-cli", phase_twin_cli, workdir, ckpt,
                            "smoke10", smi)
        method_counts = timed("method-cli", phase_method_cli, workdir, ckpt,
                              "smoke10", smi)
        semi_counts = timed("semi-cli", phase_semi_cli, workdir, ckpt,
                            "smoke10", smi)
        t_dist = time.perf_counter()
        dist_counts = timed("dist", phase_dist_launcher, workdir, ckpt,
                            "smoke10", smi, plain)
        tp_fwd, tp_bwd = timed("dist", phase_dist_tp, ckpt, smi)
        dist_counts[0] += tp_fwd
        dist_counts[1] += tp_bwd
        log(f"[dist] {time.perf_counter() - t_dist:.1f} s of the run, "
            f"launches fwd {dist_counts[0]} bwd {dist_counts[1]}, on {smi}")
        tool_counts = timed("tooling", phase_tooling, workdir, ckpt,
                            "smoke10", smi, flagship)
        cli_counts = [c + t + m + f + d + o for c, t, m, f, d, o in zip(
            cli_counts, twin_counts, method_counts, semi_counts,
            dist_counts, tool_counts)]
        timed("twin-step", phase_twin_step, ckpt, smi)
        timed("flyp-step", phase_flyp_step, ckpt, smi)
        timed("fixmatch-step", phase_fixmatch_step, ckpt, smi)
        timed("head-steps", phase_head_steps, ckpt, smi)
        timed("memory", phase_memory, ckpt, smi)
        tower_counts = timed("new-towers", _new_tower_phases, workdir, smi)
        cli_counts = [c + t for c, t in zip(cli_counts, tower_counts)]
        cli_counts[0] += timed("serving", _serving_phases, workdir, ckpt,
                               smi)
        cli_counts[0] += timed("retrieval", phase_retrieval, workdir, ckpt,
                               smi)
        worst_mega = timed("mega-kernels", phase_mega_kernels)
        times_mega = timed("mega-timing", phase_mega_timing, smi)
        tower_mega = timed("mega-towers", phase_mega_towers, ckpt, smi)
        step_mega = timed("mega-step", phase_mega_step, ckpt, smi)
    # each kernel at the CLI default (fp32) and the B/32 image shape
    # (B=256, H=12, S=50, D=64).  launches: the zero-shot runs, the stage-1
    # runs, the train-step phases and the serving phases that drive a
    # kernel's path, each counted from 0.  The heads-first backward is reached through
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
    log("[phases] " + ", ".join(f"{k} {v:.1f} s"
                                for k, v in PHASE_SECONDS.items())
        + f" on {smi}")
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
