"""videomv_tpu_torch: the PyTorch/CUDA port of ``videomv_tpu``.

The package mirrors the subpackages of ``videomv_tpu`` (the JAX reference
it is held against) and runs the text-to-multiview main path on one NVIDIA
H100: CLIP text tower → 50-step CFG DDIM over ``UNetSD_T2VBase`` → VAE
decode. Its two hot kernels (flash attention, fused GEGLU feed-forward)
are hand-written CUDA C++ under ``csrc/``, built on first use by
``ops/_build.py``; on CPU tensors each falls back to its plain PyTorch twin.

The package imports ``torch`` and never ``jax``, ``flax`` or
``videomv_tpu``. Importing it is cheap: submodules load on demand.
"""

__version__ = "0.1.0"

__all__ = ["config", "data", "diffusion", "inference", "models", "ops", "training", "utils"]
