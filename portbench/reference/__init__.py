"""The plain reference the benchmark holds the program against.

Plain PyTorch in float32 with TF32 off, written from the published
descriptions: OpenCLIP's ViT image tower (``vit.py``), SWAT's stage-1
cutmix step with its train transform and AdamW (``train.py``).  It imports neither ``jax`` nor
either SWAT package, and takes nothing the program made: it gets the
seed's weights from ``portbench.weights`` and the inputs from the
benchmark, and draws the step's random crops and boxes again with its own
frozen copy of the sampler's arithmetic.

``Rounding`` puts a lower precision into every product of the tower (the
control of step 2 of the benchmark's correctness rule): TF32 operands for
an fp32 cell, per-tensor scaled fp8 (e4m3 forward, e5m2 gradients) for a
bf16 one.
"""
