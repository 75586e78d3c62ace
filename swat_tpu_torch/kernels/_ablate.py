"""Ablations of the attention templates and of the block kernels' product
on the card.

    python -m swat_tpu_torch.kernels._ablate [name ...]

Each ablation is the committed ``csrc/attention_fwd.cuh``,
``csrc/attention_bwd.cuh``, their shared ``csrc/attention_mma.cuh`` or the
block kernels' tensor-core product ``csrc/megablock_mma.cuh`` (with the
activations of its epilogues in ``csrc/megablock.cuh``) with one design
decision taken back by a textual patch (``ABLATIONS``; a patch whose
text is no longer in its header raises).  A name that starts with ``bwd_``
is a variant of the backward template and is compiled over ``mha_bwd.cu``
and ``flash_bwd.cu``, one that starts with ``mega_`` a variant of the
product and is compiled over ``megablock_fwd.cu``, ``megablock_mlp_bwd.cu``
and ``megablock_attn_bwd.cu``, any other one of the forward template over
``mha_fwd.cu`` and ``flash_fwd.cu``; ``committed`` is the attention
templates as they stand, ``mega_committed`` the product.  All variants are
compiled together (one ``nvcc`` each, into a temporary directory), then
timed in turns.  The attention variants at the towers' four attention
shapes in fp32 and bf16 on the strided thirds of one qkv tensor, each
beside its largest difference from the plain version: the forward variants
through ``swat_mha_fwd``, the backward ones through ``swat_mha_bwd`` and,
in bf16, ``swat_flash_bwd`` without ``keep_dtype`` (p and ds in two terms).
The product variants at the ViT-B/32 image block (B=256, S=50, D=768,
H=12, F=3072) in fp32 and bf16 through ``swat_mega_fwd``,
``swat_mega_mlp_bwd`` and ``swat_mega_attn_bwd``, each beside its largest
difference from the plain
version relative to that output's largest value and the share of its bf16
outputs bit-equal to the plain version's, and beside a block built
from library calls (timed as a yardstick); for the committed product also
the device time of each of its launches by ``torch.profiler``.  It is a
developer's tool: the port never imports it, and the numbers that
``PERF.md`` quotes for the designs' choices come from it.  ``staging_only``
and ``compute_only`` compute nothing meaningful: they split a kernel's time.
Before the times it lists, from ``cuobjdump -sass`` of the committed
variants, the tensor-core, ``ldmatrix``, ``cp.async`` and CUDA-core
multiply-add instructions of each head-dim-64 instantiation of both
attention templates and of each instantiation of the product.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

from swat_tpu_torch.kernels import _build

FWD, BWD, MMA = "attention_fwd.cuh", "attention_bwd.cuh", "attention_mma.cuh"
MEGA, PRODUCT = "megablock.cuh", "megablock_mma.cuh"
HEADERS = (FWD, BWD, MMA, MEGA, PRODUCT)
MEGA_WIDE = [
    (PRODUCT, "BM = 128, BN = 128, WM = 2, WN = 4;\n"
              "  static constexpr int kStages = kStages16, kMinBlocks = 2;",
     "BM = 128, BN = 256, WM = 2, WN = 4;\n"
     "  static constexpr int kStages = kStages16, kMinBlocks = 1;"),
    (PRODUCT, "constexpr int kSplitBlocks = 528;",
     "constexpr int kSplitBlocks = 264;")]
MEGA_DEPTH_64 = (PRODUCT, "constexpr int kDepth = 32;",
                 "constexpr int kDepth = 64;")
BOUNDS = ("kShared ? kMaxWarps * 32 : NT * 32,\n"
          "    Planes<T>::n == 3 ? (kShared ? 1 : kMaxWarps / NT) : 0)")
ONE_ACCUMULATOR = [
    ("float(&acc)[2][4] = i + j == 0 ? lead : corr;",
     "float(&acc)[2][4] = lead;"),
    ("(NP == 1 || i + j == 0) ? lead : corr;", "lead;")]
MASK_EVERY_TILE = ("if (last >= seq || (causal && last > row0)) {",
                   "if (true) {")
NO_LOADS = (MMA, "if (in_head && first + r < seq)", "if (false)")
# name -> [(header, text of the committed header, its replacement), ...]
ABLATIONS = {
    "committed": [],
    # fp32: k and v side by side in shared memory (as bf16 has them)
    "fp32_v_beside_k": [(FWD, "planes == 3 ? 1 - pass : pass", "pass")],
    # fp32: no bound on the registers a thread
    "fp32_registers_free": [
        (FWD, BOUNDS, "kShared ? kMaxWarps * 32 : NT * 32)")],
    # bf16: held to 128 registers by a minimum of blocks, as fp32 is
    "bf16_min_blocks": [(FWD, BOUNDS, BOUNDS.replace(
        "Planes<T>::n == 3 ? (kShared ? 1 : kMaxWarps / NT) : 0",
        "kShared ? 1 : kMaxWarps / NT"))],
    # fp32: the five correction terms into the leading term's accumulator
    "one_accumulator": [(FWD, *sub) for sub in ONE_ACCUMULATOR],
    # every key tile tests its keys against the mask
    "mask_every_tile": [(FWD, *MASK_EVERY_TILE)],
    # loads and barriers only / everything but the loads from device memory
    "staging_only": [(FWD, "const bool live = row0 < seq;",
                      "const bool live = false;")],
    "compute_only": [NO_LOADS],
    # ---- the backward template
    # p and ds always beside k and v, never in their place
    "bwd_exchange_beside_kv": [
        (BWD, "const int alias = NA * (s_pad + 8) <= NP * LD;",
         "const int alias = 0;")],
    # short rows through the pair of kernels too: the statistics handed over
    # in scratch, s and dp three times instead of once
    "bwd_pair_for_short_rows": [(BWD, "if (!one_block<T>(a.seq))",
                                 "if (true)")],
    # the one-block kernel held to 128 registers by a minimum of blocks
    "bwd_registers_128": [
        (BWD, "__global__ void __launch_bounds__(NT * 32)\n"
              "    attention_bwd_head_kernel",
         "__global__ void __launch_bounds__(NT * 32, 16 / NT)\n"
         "    attention_bwd_head_kernel")],
    "bwd_one_accumulator": [(BWD, *sub) for sub in ONE_ACCUMULATOR],
    "bwd_mask_every_tile": [(BWD, *MASK_EVERY_TILE)],
    # (one-block kernel) loads, barriers and stores only / no loads
    "bwd_staging_only": [
        (BWD, "const int n_steps = causal ? warp + 1 : steps;",
         "const int n_steps = 0;"),
        (BWD, "for (int i = first; i < steps; ++i) {",
         "for (int i = steps; i < steps; ++i) {")],
    "bwd_compute_only": [NO_LOADS],
    # ---- the block kernels' product (megablock_mma.cuh)
    "mega_committed": [],
    # the weight gradients in one split each
    "mega_no_split_k": [(PRODUCT, "constexpr int kMaxSplits = 16;",
                         "constexpr int kMaxSplits = 1;")],
    # bf16 without the ring: load a step, then multiply it (fp32 does so
    # as committed)
    "mega_one_stage": [(PRODUCT, "kStages16 = 3, kStages32 = 1;",
                        "kStages16 = 1, kStages32 = 1;")],
    # fp32 with register prefetch: step k + 1 loaded into registers before
    # step k's mma, split and stored into a second buffer after them
    "mega_fp32_prefetch": [(PRODUCT, "kStages16 = 3, kStages32 = 1;",
                            "kStages16 = 3, kStages32 = 2;")],
    # the leading term chained through the tensor cores' accumulator, not
    # summed afresh each step (bf16) or k16 (fp32) and added by the CUDA
    # cores
    "mega_chained_sums": [
        (PRODUCT, """          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int h = 0; h < H; ++h)
            mma_bf16(t, af[h], bf[h][j][0], bf[h][j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[0][i][j][e] += t[e];""",
         """#pragma unroll
          for (int h = 0; h < H; ++h)
            mma_bf16(acc[0][i][j], af[h], bf[h][j][0], bf[h][j][1]);"""),
        (PRODUCT, """            float t[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(t, af[0][i], bf[0][j][0], bf[0][j][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[0][i][j][e] += t[e];""",
         """            mma_bf16(acc[0][i][j], af[0][i], bf[0][j][0], bf[0][j][1]);""")],
    # the activations by expf and an IEEE division, not the special-function
    # unit
    "mega_exact_act": [
        (MEGA, "__fdividef(1.f, 1.f + 0.3275911f * ax)",
         "1.f / (1.f + 0.3275911f * ax)"),
        (MEGA, "poly * __expf(-ax * ax)", "poly * expf(-ax * ax)"),
        (MEGA, "__fdividef(1.f, 1.f + __expf(-x))", "1.f / (1.f + expf(-x))"),
        (MEGA, "__expf(-0.5f * m * m)", "expf(-0.5f * m * m)")],
    # bf16 with 4 warps of 64 x 64 (up to 255 registers), not 8 of 64 x 32
    "mega_bf16_four_warps": [(PRODUCT, "BN = 128, WM = 2, WN = 4;",
                              "BN = 128, WM = 2, WN = 2;")],
    # fp32 free of the 128-register cap, one block an SM
    "mega_fp32_one_block": [(PRODUCT, "kStages = kStages32, kMinBlocks = 2;",
                             "kStages = kStages32, kMinBlocks = 1;")],
    # bf16 with a 4-stage ring, not 3
    "mega_bf16_four_stages": [(PRODUCT, "kStages16 = 3, kStages32 = 1;",
                               "kStages16 = 4, kStages32 = 1;")],
    # bf16 128 x 256 tiles, warps of 64 x 64, one block an SM (the weight
    # gradients keep their number of splits)
    "mega_bf16_wide_warps": MEGA_WIDE,
    # steps 64 deep, not 32 (both dtypes)
    "mega_depth_64": [MEGA_DEPTH_64],
    "mega_bf16_wide_depth_64": MEGA_WIDE + [MEGA_DEPTH_64],
}
BOTH = "fp32_first_design"
SHAPES = [("vitb32_image", 256, 50, 12, 768, False),
          ("text", 1024, 77, 8, 512, True),
          ("vitb16_image", 128, 197, 12, 768, False),
          ("vitl14_image", 64, 257, 16, 1024, False)]


def _is_bwd(name: str) -> bool:
    return name.startswith("bwd_")


def _is_mega(name: str) -> bool:
    return name.startswith("mega_")


def _patched(headers: dict, name: str) -> dict:
    """{header name: text} with the ablation's patches applied."""
    subs = (ABLATIONS["fp32_v_beside_k"] + ABLATIONS["fp32_registers_free"]
            if name == BOTH else ABLATIONS[name])
    out = dict(headers)
    for header, old, new in subs:
        if old not in out[header]:
            raise KeyError(f"ablation {name!r}: {header} no longer has "
                           f"{old!r}")
        out[header] = out[header].replace(old, new)
    return out


def read_headers() -> dict:
    headers = {}
    for header in HEADERS:
        with open(os.path.join(_build.CSRC_DIR, header)) as f:
            headers[header] = f.read()
    return headers


def _sources(name: str):
    fwd, bwd = ["mha_fwd.cu", "flash_fwd.cu"], ["mha_bwd.cu", "flash_bwd.cu"]
    if _is_mega(name):
        return ["megablock_fwd.cu", "megablock_mlp_bwd.cu",
                "megablock_attn_bwd.cu"]
    return fwd + bwd if name == "committed" else (bwd if _is_bwd(name)
                                                  else fwd)


def _build_variants(names, workdir):
    """One shared library per variant, all compiled at once -> {name: CDLL}."""
    headers = read_headers()
    nvcc, procs = _build.find_nvcc(), {}
    for name in names:
        d = os.path.join(workdir, name)
        os.makedirs(d)
        for header, text in _patched(headers, name).items():
            with open(os.path.join(d, header), "w") as f:
                f.write(text)
        for src in _sources(name):
            with open(os.path.join(_build.CSRC_DIR, src)) as f, \
                    open(os.path.join(d, src), "w") as g:
                g.write(f.read())
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
             os.path.join(d, "lib.so"),
             *(os.path.join(d, src) for src in _sources(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out[-3000:]}")
        lib = ctypes.CDLL(os.path.join(workdir, name, "lib.so"))
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if _is_mega(name):
            lib.swat_mega_fwd.restype = i
            lib.swat_mega_fwd.argtypes = [ptr] * 5 + [i] * 8 + [ptr]
            lib.swat_mega_mlp_bwd.restype = i
            lib.swat_mega_mlp_bwd.argtypes = [ptr] * 6 + [ll] * 2 + [i] * 5 + [
                ptr]
            lib.swat_mega_attn_bwd.restype = i
            lib.swat_mega_attn_bwd.argtypes = [ptr] * 6 + [ll] * 2 + [
                i] * 6 + [ptr]
            libs[name] = lib
            continue
        if not _is_bwd(name):
            lib.swat_mha_fwd.restype = i
            lib.swat_mha_fwd.argtypes = [ptr] * 4 + [i] * 5 + [ll] * 8 + [
                ctypes.c_float, i, ptr]
        if _is_bwd(name) or name == "committed":
            lib.swat_mha_bwd.restype = i
            lib.swat_mha_bwd.argtypes = [ptr] * 8 + [i] * 5 + [ll] * 14 + [
                ctypes.c_float, i, ptr]
            lib.swat_flash_bwd.restype = i
            lib.swat_flash_bwd.argtypes = [ptr] * 8 + [i] * 5 + [
                ctypes.POINTER(ll), ctypes.c_float, i, i, ptr]
        libs[name] = lib
    return libs


def _product_label(name):
    """'source dtype/AB/epilogue' of an instantiation of the block kernels'
    product (A, B: k = k-contiguous, i = i-contiguous), from its mangled or
    demangled name, else None."""
    import re

    t = re.search(r"(megablock_\w+?)_cu.*?2tc15mma_gemm_kernel"
                  r"I(13__nv_bfloat16|f)Lb([01])ELb([01])E.*?(\d+)(Epi\w*)",
                  name)
    if t:
        dtype, a, b = t.group(2), t.group(3), t.group(4)
        epi = t.group(6)[:int(t.group(5))]     # a mangled name: length, name
        return (f"{t.group(1)} {'fp32' if dtype == 'f' else 'bf16'}/"
                f"{'ik'[int(a)]}{'ik'[int(b)]}/{epi}")
    t = re.search(r"tc::mma_gemm_kernel<(float|__nv_bfloat16), "
                  r"(true|false), (true|false), .*?(Epi\w+)", name)
    if t:
        return (f"{'fp32' if t.group(1) == 'float' else 'bf16'}/"
                f"{'k' if t.group(2) == 'true' else 'i'}"
                f"{'k' if t.group(3) == 'true' else 'i'}/{t.group(4)}")
    return None


def _sass_report(lib_path):
    """Instruction counts of the head-dim-64 kernels of both attention
    templates and of every instantiation of the block kernels' product in a
    library: HMMA (mma.sync), LDSM (ldmatrix), LDGSTS (cp.async), FFMA."""
    import re

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    counts, kernel = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            kernel = None
            t = re.search(r"(mha|flash)_fwd_cu.*attention_fwd_kernelI"
                          r"(13__nv_bfloat16|f)Li64ELb[01]ELi(\d+)ELb([01])E",
                          m.group(1))
            if t:
                kernel = (f"{t.group(1)}_fwd "
                          f"{'fp32' if t.group(2) == 'f' else 'bf16'}/64/"
                          f"{t.group(3)}{'s' if t.group(4) == '1' else ''}")
            t = re.search(r"(mha|flash)_bwd_cu.*attention_bwd_(head|dq|dkv)_"
                          r"kernelI(13__nv_bfloat16|f)Li64ELb([01])E"
                          r"(?:S\d*_|f)(?:Li(\d+)E)?E", m.group(1))
            if t:
                kernel = (f"{t.group(1)}_bwd "
                          f"{'fp32' if t.group(3) == 'f' else 'bf16'}/64/"
                          f"{'round' if t.group(4) == '1' else 'keep'}/"
                          f"{t.group(2)}{t.group(5) or ''}")
            product = _product_label(m.group(1))
            if product:
                kernel = f"product {product}"
            continue
        m = re.search(r"\b(HMMA|LDSM|LDGSTS|FFMA)\b[.\w]*", ln)
        if kernel and m:
            per = counts.setdefault(kernel, {})
            per[m.group(0)] = per.get(m.group(0), 0) + 1
    for kernel, per in sorted(counts.items()):
        print(f"[ablate] sass {kernel}: " + ", ".join(
            f"{k} x{v}" for k, v in sorted(per.items())), flush=True)


def _time_ms(fn, iters=50, warmup=5):
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


# the ViT-B/32 image block at the train batch: batch, seq, width, heads, mlp
MEGA_SHAPE = (256, 50, 768, 12, 3072)


def _library_block(w, heads):
    """The block's two halves from library calls (layer_norm, linear,
    scaled_dot_product_attention; quick-gelu), the yardstick of
    chip_smoke.py."""
    import torch
    import torch.nn.functional as F

    def attn_half(x):
        b, s, d = x.shape
        h = F.layer_norm(x, (d,), w.ln1_w, w.ln1_b)
        q, k, v = (t.reshape(b, s, heads, -1).transpose(1, 2)
                   for t in F.linear(h, w.in_w, w.in_b).chunk(3, dim=-1))
        o = F.scaled_dot_product_attention(q, k, v)
        return x + F.linear(o.transpose(1, 2).reshape(b, s, d), w.out_w,
                            w.out_b)

    def mlp_half(x2):
        h = F.layer_norm(x2, (x2.shape[-1],), w.ln2_w, w.ln2_b)
        m = F.linear(h, w.fc_w, w.fc_b)
        return x2 + F.linear(m * torch.sigmoid(1.702 * m), w.proj_w,
                             w.proj_b)

    return attn_half, mlp_half


def _mega_times(libs, smi, gen):
    """The product variants through the block forward, the MLP backward and
    the attention backward at MEGA_SHAPE, fp32 and bf16: each variant's ms
    in turns, its largest difference from the plain version (relative to
    each output's largest value), the library-built block's ms (its forward;
    for a backward the forward and backward of its half), and for the
    committed variant each launch's device ms and each product's TFLOP/s."""
    import torch
    from torch.autograd import DeviceType

    from swat_tpu_torch.kernels import flash_attention as FA
    from swat_tpu_torch.kernels import megablock as MB

    b, s, d, heads, f = MEGA_SHAPE
    n = b * s
    stream = torch.cuda.current_stream().cuda_stream
    kinds = ("fwd", "mlp_bwd", "attn_bwd")
    # multiply-adds of each product launch, in launch order
    flops = {"fwd": [2 * n * 3 * d * d, 2 * n * d * d, 2 * n * f * d,
                     2 * n * d * f],
             "mlp_bwd": [2 * n * f * d] * 5,
             # qkv, dWo, do, d in_proj_weight, dh1
             "attn_bwd": [2 * n * 3 * d * d, 2 * n * d * d, 2 * n * d * d,
                          2 * n * 3 * d * d, 2 * n * 3 * d * d]}
    for dtype in (torch.float32, torch.bfloat16):
        def normal(shape, std=1.0, mean=0.0):
            return (torch.randn(shape, generator=gen, device="cuda") * std
                    + mean).to(dtype)

        x, x2, dy, dx2_in = (normal((b, s, d)) for _ in range(4))
        w = MB.BlockWeights(
            normal((3 * d, d), d ** -0.5), normal((3 * d,), 0.1),
            normal((d, d), d ** -0.5), normal((d,), 0.1),
            normal((d,), 0.1, 1.0), normal((d,), 0.1),
            normal((d,), 0.1, 1.0), normal((d,), 0.1),
            normal((f, d), d ** -0.5), normal((f,), 0.1),
            normal((d, f), f ** -0.5), normal((d,), 0.1))
        ref = {"fwd": MB.block_fwd_reference(x, w, heads, False, True),
               "mlp_bwd": MB.mlp_bwd_reference(x2, dy, w, True),
               "attn_bwd": MB.attn_bwd_reference(x, dx2_in, w, heads, False)}
        y, x2_out, dx2, dx = (torch.empty_like(x) for _ in range(4))
        grads = {kind: [torch.empty(shape, device="cuda") for shape in shapes]
                 for kind, shapes in (
                     ("mlp_bwd", ((f, d), (f,), (d, f), (d,), (d,), (d,))),
                     ("attn_bwd", ((3 * d, d), (3 * d,), (d, d), (d,), (d,),
                                   (d,))))}
        scratch = {kind: [torch.empty(shape, dtype=dt, device="cuda")
                          for shape, dt in MB.scratch_shapes(
                              kind, b, s, d, f, heads, dtype)]
                   for kind in kinds}
        out = {"fwd": (y, x2_out), "mlp_bwd": (dx2, *grads["mlp_bwd"]),
               "attn_bwd": (dx, *grads["attn_bwd"])}
        ptr = {"w": MB._pointers(w),
               "mlp_w": MB._pointers((w.fc_w, w.fc_b, w.proj_w, w.ln2_w,
                                      w.ln2_b)),
               "attn_w": MB._pointers((w.in_w, w.in_b, w.out_w, w.ln1_w,
                                       w.ln1_b)),
               **{f"{kind}_grads": MB._pointers(grads[kind])
                  for kind in grads},
               **{kind: MB._pointers(scratch[kind]) for kind in kinds}}
        code, dname = FA._DTYPE_CODE[dtype], str(dtype)[6:]

        def calls(name, lib):
            def check(err, kind):
                if err:
                    raise RuntimeError(f"mega_{kind} ({name}): CUDA error "
                                       f"{err}")

            def fwd():
                check(lib.swat_mega_fwd(
                    x.data_ptr(), ptr["w"], y.data_ptr(), x2_out.data_ptr(),
                    ptr["fwd"], b, s, d, heads, f, code, 0, 1, stream),
                    "fwd")

            def mlp_bwd():
                check(lib.swat_mega_mlp_bwd(
                    x2.data_ptr(), dy.data_ptr(), ptr["mlp_w"],
                    dx2.data_ptr(), ptr["mlp_bwd_grads"], ptr["mlp_bwd"],
                    scratch["mlp_bwd"][-2].numel(),
                    scratch["mlp_bwd"][-1].numel(), n, d, f, code, 1,
                    stream), "mlp_bwd")

            def attn_bwd():
                check(lib.swat_mega_attn_bwd(
                    x.data_ptr(), dx2_in.data_ptr(), ptr["attn_w"],
                    dx.data_ptr(), ptr["attn_bwd_grads"], ptr["attn_bwd"],
                    scratch["attn_bwd"][-2].numel(),
                    scratch["attn_bwd"][-1].numel(), b, s, d, heads, code, 0,
                    stream), "attn_bwd")
            return {"fwd": fwd, "mlp_bwd": mlp_bwd, "attn_bwd": attn_bwd}

        attn_half, mlp_half = _library_block(w, heads)
        with torch.no_grad():
            lib_ms = {"fwd": _time_ms(lambda: mlp_half(attn_half(x)),
                                      iters=10, warmup=3)}
        leaves = MB.BlockWeights(*(t.detach().requires_grad_(True)
                                   for t in w))
        attn_leaf, mlp_leaf = _library_block(leaves, heads)
        for kind, half, inp, grad, params in (
                ("mlp_bwd", mlp_leaf, x2, dy,
                 (leaves.ln2_w, leaves.ln2_b, leaves.fc_w, leaves.fc_b,
                  leaves.proj_w, leaves.proj_b)),
                ("attn_bwd", attn_leaf, x, dx2_in,
                 (leaves.in_w, leaves.in_b, leaves.out_w, leaves.out_b,
                  leaves.ln1_w, leaves.ln1_b))):
            leaf = inp.detach().requires_grad_(True)
            lib_ms[kind] = _time_ms(
                lambda h=half, x0=leaf, g=grad, p=params: torch.autograd.grad(
                    h(x0), (x0, *p), g), iters=10, warmup=3)
        for kind in kinds:
            runs = {name: calls(name, lib)[kind] for name, lib in libs.items()}
            order = list(runs) + list(reversed(runs))
            times = {name: [] for name in runs}
            for name in order:
                times[name].append(_time_ms(runs[name], iters=10, warmup=2))
            for name in runs:
                for t in out[kind]:
                    t.zero_()
                runs[name]()
                torch.cuda.synchronize()
                diff = max(float((g.float() - r.float()).abs().max())
                           / max(float(r.float().abs().max()), 1e-30)
                           for g, r in zip(out[kind], ref[kind]))
                shares = [f"{float((g == r).float().mean()):.4f}"
                          for g, r in zip(out[kind], ref[kind])
                          if g.dtype == torch.bfloat16]
                ms = sum(times[name]) / len(times[name])
                print(f"[ablate] mega_{kind} B={b} S={s} D={d} H={heads} "
                      f"F={f} {dname} {name}: {ms:.3f} ms (runs "
                      f"{'/'.join(f'{t:.3f}' for t in times[name])}), "
                      f"library {lib_ms[kind]:.3f} ms, largest difference "
                      f"from the plain version / its output's largest value "
                      f"{diff:.2e}"
                      f"{', bf16 outputs bit-equal to it ' if shares else ''}"
                      f"{'/'.join(shares)} on {smi}", flush=True)
            if "mega_committed" not in runs:
                continue
            # a profile drops the kernels launched while its tracing
            # starts: the call runs twice and the second, active step is read
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA],
                    schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                     active=1)) as prof:
                for step in range(2):
                    runs["mega_committed"]()
                    torch.cuda.synchronize()
                    if step == 0:
                        prof.step()
            parts, products = [], iter(flops[kind])
            for evt in prof.events():
                if evt.device_type != DeviceType.CUDA:
                    continue
                us = evt.time_range.elapsed_us()
                label = _product_label(evt.name)
                if label and "join" not in evt.name:
                    rate = next(products, 0) / us / 1e6
                    parts.append(f"{label} {us / 1e3:.3f} ({rate:.0f} "
                                 f"TFLOP/s)")
                else:
                    short = evt.name.split("(")[0].split("<")[0].split("::")
                    parts.append(f"{short[-1]} {us / 1e3:.3f}")
            print(f"[ablate] mega_{kind} {dname} mega_committed launches, "
                  f"device ms: {'; '.join(parts)} on {smi}", flush=True)


def main(argv) -> int:
    import torch

    from swat_tpu_torch.kernels import flash_attention as FA

    names = argv or [*ABLATIONS, BOTH]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory(prefix="swat_ablate_") as workdir:
        libs = _build_variants(names, workdir)
        for name in ("committed", "mega_committed"):
            if name in libs:
                _sass_report(os.path.join(workdir, name, "lib.so"))
        mega = {k: v for k, v in libs.items() if _is_mega(k)}
        libs = {k: v for k, v in libs.items() if not _is_mega(k)}
        if mega:
            _mega_times(mega, smi, gen)
        stream = torch.cuda.current_stream().cuda_stream
        for shape, b, s, h, w, causal in (SHAPES if libs else []):
            for dtype in (torch.float32, torch.bfloat16):
                qkv = torch.randn(b, s, 3 * w, generator=gen,
                                  device="cuda").to(dtype)
                q, k, v = qkv.split(w, dim=-1)
                do = torch.randn(b, s, w, generator=gen,
                                 device="cuda").to(dtype)
                d = w // h
                code, scale = FA._DTYPE_CODE[dtype], 1.0 / d ** 0.5
                head = (f"[ablate] {shape} B={b} S={s} H={h} D={d} "
                        f"{str(dtype)[6:]}")
                ref = FA.mha_packed_reference(q, k, v, h, causal).float()
                out = torch.empty(b, s, w, dtype=dtype, device="cuda")
                bwd_ref = torch.cat(
                    FA.mha_bwd_reference(q, k, v, do, h, causal), -1).float()
                views = [FA._heads_view(t, h) for t in (q, k, v, do)]
                keep_ref = torch.cat([
                    t.transpose(1, 2).reshape(b, s, w)
                    for t in FA.flash_attention_bwd_reference(
                        *views, causal, False)], -1).float()
                dqkv = torch.empty(b, s, 3 * w, dtype=dtype, device="cuda")
                thirds = dqkv.split(w, dim=-1)
                # every variant gets the scratch, whatever rows it needs it at
                stats = torch.empty(3 * b * h * s, device="cuda")
                strides = [x for t in (*views, *(FA._heads_view(t, h)
                                                 for t in thirds))
                           for x in t.stride()[:3]]
                c_strides = (ctypes.c_longlong * len(strides))(*strides)
                for name, lib in libs.items():
                    def fwd():
                        err = lib.swat_mha_fwd(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), b, s, h, d, code, q.stride(0),
                            q.stride(1), k.stride(0), k.stride(1),
                            v.stride(0), v.stride(1), out.stride(0),
                            out.stride(1), scale, int(causal), stream)
                        _build.check(lib, err, f"mha_fwd ({name})")

                    def bwd():
                        err = lib.swat_mha_bwd(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), *(t.data_ptr() for t in thirds),
                            stats.data_ptr(), b, s, h, d, code,
                            *(x for t in (q, k, v, do, *thirds)
                              for x in t.stride()[:2]),
                            scale, int(causal), stream)
                        _build.check(lib, err, f"mha_bwd ({name})")

                    def bwd_keep():
                        err = lib.swat_flash_bwd(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), *(t.data_ptr() for t in thirds),
                            stats.data_ptr(), b, s, h, d, code, c_strides,
                            scale, int(causal), 0, stream)
                        _build.check(lib, err, f"flash_bwd ({name})")

                    calls = []
                    if not _is_bwd(name):
                        calls.append(("mha_fwd", fwd, out, ref))
                    if _is_bwd(name) or name == "committed":
                        calls.append(("mha_bwd", bwd, dqkv, bwd_ref))
                        if dtype == torch.bfloat16:
                            calls.append(("flash_bwd keep_dtype=0", bwd_keep,
                                          dqkv, keep_ref))
                    for what, call, result, plain in calls:
                        result.zero_()
                        ms = _time_ms(call)
                        diff = float((result.float() - plain).abs().max())
                        print(f"{head} {name}: {what} {ms:.4f} ms, max abs "
                              f"difference from the plain version "
                              f"{diff:.3e} on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
