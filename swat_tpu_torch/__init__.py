"""swat_tpu_torch: the PyTorch + CUDA port of ``swat_tpu`` for NVIDIA Hopper.

Same layout as ``swat_tpu`` so each module's counterpart is easy to find:

core     precision policies, run configuration
kernels  hand-written CUDA kernels (``csrc/``), their build step and wrappers
models   CLIP towers with OpenCLIP state-dict names, loader, tokenizer, head
data     eval transforms, threaded eval loader, feature extraction
eval     streaming validation and the GPU-resident eval engine
train    losses, steps, the epoch loop and the stage orchestration
cli      ``python -m swat_tpu_torch.cli.main`` (the flags of swat_tpu's CLI),
         ``cli.test``, ``cli.convert``, ``cli.repro``, ``cli.prepare_data``
analysis the paper's tables and the analysis figures
utils    logging, ``--trace_dir`` (torch.profiler), native builds

The package imports ``torch`` and never ``jax``.  Importing it builds
nothing: kernels compile with nvcc at first use on a CUDA tensor.
"""

__version__ = "0.1.0"
