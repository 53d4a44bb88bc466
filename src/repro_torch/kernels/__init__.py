"""The hand-written Hopper kernels (B1-B8) and their plain PyTorch
versions (port of ``repro.kernels``, which exports no names): ``build``
compiles ``csrc/*.cu`` for ``sm_90a``; each wrapper module launches its
kernel on a CUDA tensor and runs its plain version on a CPU one."""
