"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

The sources under ``swat_tpu_torch/csrc`` have a plain C interface, so they
compile in seconds (no PyTorch headers): one ``nvcc -c`` per source, all
started together, then one ``nvcc -shared`` link (14.5-14.9 s on an H100
host with 8 cores for the two packed-head sources, against 21.3-21.5 s for
one ``nvcc`` over both, measured in one run) into
``build/swat_tpu_torch/<digest>/libswat_kernels.so`` at the root of the
checkout, a directory that ``.gitignore`` lists.  ``<digest>`` hashes the
sources, the headers they share and the flags: an edited source builds
anew, an unchanged one is loaded as it is.  The build happens at first use,
never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build",
                          "swat_tpu_torch")
# one translation unit per kernel; the packed-head and the heads-first
# kernels instantiate the templates of attention_fwd.cuh and
# attention_bwd.cuh, the three block-fused layer kernels those,
# megablock.cuh and (forward and MLP backward) megablock_mma.cuh;
# layer_norm.cu and batch_norm.cu stand alone
SOURCES = ("mha_fwd.cu", "mha_bwd.cu", "flash_fwd.cu", "flash_bwd.cu",
           "megablock_fwd.cu", "megablock_mlp_bwd.cu",
           "megablock_attn_bwd.cu", "layer_norm.cu", "batch_norm.cu")
# sm_90a: the Hopper target with wgmma / setmaxnreg (plain sm_90 lacks them);
# -Xptxas -v writes each kernel's registers and spills into build.log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libswat_kernels.so"


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's usual home."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found: swat_tpu_torch builds its CUDA kernels with nvcc "
        "at first use. Install the CUDA toolkit and put its bin/ on PATH "
        "or set CUDA_HOME.")


def source_digest() -> str:
    """Hash of the flags and of every source and header under csrc/: an
    edited header rebuilds all that include it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(n for n in os.listdir(CSRC_DIR)
                       if n.endswith((".cu", ".cuh"))):
        h.update(name.encode())
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_library() -> str:
    """Compile the sources (unless this digest is built) -> path of the .so.
    Raises RuntimeError when nvcc is missing or fails."""
    out_dir = os.path.join(BUILD_ROOT, source_digest())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    nvcc = find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    # build under per-process names, then rename: concurrent builds never
    # load a half-written library
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(out_dir, f"{src}.{tag}.o") for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, src)]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    runs = [(cmd, p.communicate()[0], p.returncode)
            for cmd, p in zip(cmds, procs)]
    if all(rc == 0 for *_, rc in runs):
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", f"{lib_path}.{tag}", *objs]
        p = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        runs.append((cmd, p.stdout, p.returncode))
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.writelines(" ".join(cmd) + "\n" + out for cmd, out, _ in runs)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    for cmd, out, rc in runs:
        if rc:
            raise RuntimeError(f"nvcc failed (exit {rc}) on {cmd[-1]}:\n"
                               f"{out[-4000:]}")
    os.replace(f"{lib_path}.{tag}", lib_path)
    return lib_path


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built kernel library with its entry points' signatures set."""
    lib = ctypes.CDLL(build_library())
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.swat_mha_fwd.restype = i
    lib.swat_mha_fwd.argtypes = [p, p, p, p, i, i, i, i, i,
                                 ll, ll, ll, ll, ll, ll, ll, ll,
                                 ctypes.c_float, i, p]
    lib.swat_mha_bwd.restype = i
    lib.swat_mha_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                 *([ll] * 14), ctypes.c_float, i, p]
    lib.swat_flash_fwd.restype = i
    lib.swat_flash_fwd.argtypes = [p, p, p, p, i, i, i, i, i, *([ll] * 12),
                                   ctypes.c_float, i, p]
    lib.swat_flash_bwd.restype = i
    lib.swat_flash_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                   ctypes.POINTER(ll), ctypes.c_float, i, i,
                                   p]
    lib.swat_mega_fwd.restype = i
    lib.swat_mega_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.swat_mega_mlp_bwd.restype = i
    lib.swat_mega_mlp_bwd.argtypes = [p, p, p, p, p, p, ll, ll, i, i, i, i,
                                      i, p]
    lib.swat_mega_attn_bwd.restype = i
    lib.swat_mega_attn_bwd.argtypes = [p, p, p, p, p, p, ll, ll, i, i, i,
                                       i, i, i, p]
    lib.swat_ln_fwd.restype = i
    lib.swat_ln_fwd.argtypes = [p, ll, i, p, p, p, ll, p, p, i, i, i,
                                ctypes.c_float, p]
    lib.swat_ln_bwd.restype = i
    lib.swat_ln_bwd.argtypes = [p, ll, i, p, ll, p, p, p, p, ll, p, p, p, i,
                                i, p]
    f = ctypes.c_float
    lib.swat_bn_fwd.restype = i
    lib.swat_bn_fwd.argtypes = [p, i, i, i, i, i, i, p, p, f, f, i, p, p,
                                p, p, p, p, p, p]
    lib.swat_bn_bwd.restype = i
    lib.swat_bn_bwd.argtypes = [p, p, i, i, i, i, i, i, p, p, p, p, p, i,
                                p, p, p, p, p, p]
    lib.swat_cuda_error_string.restype = ctypes.c_char_p
    lib.swat_cuda_error_string.argtypes = [i]
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.swat_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} "
                           f"({msg})")
