"""PyTorch / CUDA port of open_musiclm_tpu.

Module paths mirror the JAX package (``core/``, ``ops/``, ``models/``,
``config.py``); the JAX package is the reference every module is tested
against. This package imports torch and numpy only (and joblib, when
``import_torch`` reads a k-means dump). The hand-written
Hopper kernels live in ``csrc/`` and are built on first use
(``ops/cuda_lib.py``).
"""
