"""Ablations of the forward attention template on the card.

    python -m swat_tpu_torch.kernels._ablate [name ...]

Each ablation is the committed ``csrc/attention_fwd.cuh`` with one design
decision taken back by a textual patch (``ABLATIONS``; a patch whose text is
no longer in the header raises).  All variants are compiled together
(``mha_fwd.cu`` and ``flash_fwd.cu`` alone, one ``nvcc`` each, into a
temporary directory), then timed in turns at the towers' four attention
shapes in fp32 and bf16 on the strided thirds of one qkv tensor, each
beside its largest difference from the plain version.  It is a developer's
tool: the port never imports it, and the numbers that ``PERF.md`` quotes
for the design's choices come from it.  ``staging_only`` and
``compute_only`` compute nothing meaningful: they split the kernel's time.
Before the times it lists, from ``cuobjdump -sass`` of the committed
variant, the tensor-core, ``ldmatrix``, ``cp.async`` and CUDA-core
multiply-add instructions of each head-dim-64 instantiation.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

from swat_tpu_torch.kernels import _build

BOUNDS = ("kShared ? kMaxWarps * 32 : NT * 32,\n"
          "    Planes<T>::n == 3 ? (kShared ? 1 : kMaxWarps / NT) : 0)")
# name -> [(text of the committed header, its replacement), ...]
ABLATIONS = {
    "committed": [],
    # fp32: k and v side by side in shared memory (as bf16 has them)
    "fp32_v_beside_k": [("planes == 3 ? 1 - pass : pass", "pass")],
    # fp32: no bound on the registers a thread
    "fp32_registers_free": [(BOUNDS, "kShared ? kMaxWarps * 32 : NT * 32)")],
    # bf16: held to 128 registers by a minimum of blocks, as fp32 is
    "bf16_min_blocks": [(BOUNDS, BOUNDS.replace(
        "Planes<T>::n == 3 ? (kShared ? 1 : kMaxWarps / NT) : 0",
        "kShared ? 1 : kMaxWarps / NT"))],
    # fp32: the five correction terms into the leading term's accumulator
    "one_accumulator": [
        ("float(&acc)[2][4] = i + j == 0 ? lead : corr;",
         "float(&acc)[2][4] = lead;"),
        ("(NP == 1 || i + j == 0) ? lead : corr;", "lead;")],
    # every key tile tests its keys against the mask
    "mask_every_tile": [("if (last >= seq || (causal && last > row0)) {",
                         "if (true) {")],
    # loads and barriers only / everything but the loads from device memory
    "staging_only": [("const bool live = row0 < seq;",
                      "const bool live = false;")],
    "compute_only": [("if (in_head && first + r < seq)", "if (false)")],
}
BOTH = "fp32_first_design"
SHAPES = [("vitb32_image", 256, 50, 12, 768, False),
          ("text", 1024, 77, 8, 512, True),
          ("vitb16_image", 128, 197, 12, 768, False),
          ("vitl14_image", 64, 257, 16, 1024, False)]


def _patched(header: str, name: str) -> str:
    subs = (ABLATIONS["fp32_v_beside_k"] + ABLATIONS["fp32_registers_free"]
            if name == BOTH else ABLATIONS[name])
    for old, new in subs:
        if old not in header:
            raise KeyError(f"ablation {name!r}: the header no longer has "
                           f"{old!r}")
        header = header.replace(old, new)
    return header


def _build_variants(names, workdir):
    """One shared library per variant, all compiled at once -> {name: CDLL}."""
    with open(os.path.join(_build.CSRC_DIR, "attention_fwd.cuh")) as f:
        header = f.read()
    nvcc, procs = _build.find_nvcc(), {}
    for name in names:
        d = os.path.join(workdir, name)
        os.makedirs(d)
        with open(os.path.join(d, "attention_fwd.cuh"), "w") as f:
            f.write(_patched(header, name))
        for src in ("mha_fwd.cu", "flash_fwd.cu"):
            with open(os.path.join(_build.CSRC_DIR, src)) as f, \
                    open(os.path.join(d, src), "w") as g:
                g.write(f.read())
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "mha_fwd.cu"),
             os.path.join(d, "flash_fwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out[-3000:]}")
        lib = ctypes.CDLL(os.path.join(workdir, name, "lib.so"))
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.swat_mha_fwd.restype = i
        lib.swat_mha_fwd.argtypes = [ptr] * 4 + [i] * 5 + [ll] * 8 + [
            ctypes.c_float, i, ptr]
        libs[name] = lib
    return libs


def _sass_report(lib_path):
    """Instruction counts of the head-dim-64 forward kernels in a library:
    HMMA (mma.sync), LDSM (ldmatrix), LDGSTS (cp.async), FFMA."""
    import re

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    counts, kernel = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            t = re.search(r"(mha|flash)_fwd_cu.*attention_fwd_kernelI"
                          r"(13__nv_bfloat16|f)Li64ELb[01]ELi(\d+)ELb([01])E",
                          m.group(1))
            kernel = t and (f"{t.group(1)}_fwd "
                            f"{'fp32' if t.group(2) == 'f' else 'bf16'}/64/"
                            f"{t.group(3)}{'s' if t.group(4) == '1' else ''}")
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
                ref = FA.mha_packed_reference(q, k, v, h, causal).float()
                out = torch.empty(b, s, w, dtype=dtype, device="cuda")
                d = w // h
                for name, lib in libs.items():
                    def call():
                        err = lib.swat_mha_fwd(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), b, s, h, d,
                            FA._DTYPE_CODE[dtype], q.stride(0), q.stride(1),
                            k.stride(0), k.stride(1), v.stride(0),
                            v.stride(1), out.stride(0), out.stride(1),
                            1.0 / d ** 0.5, int(causal), stream)
                        _build.check(lib, err, f"mha_fwd ({name})")

                    out.zero_()
                    ms = _time_ms(call)
                    diff = float((out.float() - ref).abs().max())
                    print(f"[ablate] {shape} B={b} S={s} H={h} D={d} "
                          f"{str(dtype)[6:]} {name}: mha_fwd {ms:.4f} ms, "
                          f"max abs difference from the plain version "
                          f"{diff:.3e} on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
