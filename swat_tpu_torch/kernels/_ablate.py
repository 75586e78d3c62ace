"""Ablations of the attention templates on the card.

    python -m swat_tpu_torch.kernels._ablate [name ...]

Each ablation is the committed ``csrc/attention_fwd.cuh``,
``csrc/attention_bwd.cuh`` or their shared ``csrc/attention_mma.cuh`` with
one design decision taken back by a textual patch (``ABLATIONS``; a patch
whose text is no longer in its header raises).  A name that starts with
``bwd_`` is a variant of the backward template and is compiled over
``mha_bwd.cu`` and ``flash_bwd.cu``, any other one of the forward template
over ``mha_fwd.cu`` and ``flash_fwd.cu``; ``committed`` is both as they
stand.  All variants are compiled together (one ``nvcc`` each, into a
temporary directory), then timed in turns at the towers' four attention
shapes in fp32 and bf16 on the strided thirds of one qkv tensor, each beside
its largest difference from the plain version: the forward variants through
``swat_mha_fwd``, the backward ones through ``swat_mha_bwd`` and, in bf16,
``swat_flash_bwd`` without ``keep_dtype`` (p and ds in two terms).  It is a
developer's tool: the port never imports it, and the numbers that
``PERF.md`` quotes for the designs' choices come from it.  ``staging_only``
and ``compute_only`` compute nothing meaningful: they split a kernel's time.
Before the times it lists, from ``cuobjdump -sass`` of the committed
variant, the tensor-core, ``ldmatrix``, ``cp.async`` and CUDA-core
multiply-add instructions of each head-dim-64 instantiation of both
templates.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

from swat_tpu_torch.kernels import _build

FWD, BWD, MMA = "attention_fwd.cuh", "attention_bwd.cuh", "attention_mma.cuh"
HEADERS = (FWD, BWD, MMA)
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
}
BOTH = "fp32_first_design"
SHAPES = [("vitb32_image", 256, 50, 12, 768, False),
          ("text", 1024, 77, 8, 512, True),
          ("vitb16_image", 128, 197, 12, 768, False),
          ("vitl14_image", 64, 257, 16, 1024, False)]


def _is_bwd(name: str) -> bool:
    return name.startswith("bwd_")


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


def _sass_report(lib_path):
    """Instruction counts of the head-dim-64 kernels of both templates in a
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
        if "committed" in libs:
            _sass_report(os.path.join(workdir, "committed", "lib.so"))
        stream = torch.cuda.current_stream().cuda_stream
        for shape, b, s, h, w, causal in SHAPES:
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
