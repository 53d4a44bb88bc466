"""PyTorch / CUDA port of ``repro`` for an NVIDIA H100 (see ROADMAP.md).

Imports ``torch``, numpy and ``ml_dtypes``, never ``jax`` and nothing of
``repro``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
