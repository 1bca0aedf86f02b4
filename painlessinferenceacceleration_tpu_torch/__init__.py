"""PyTorch + CUDA port of painlessinferenceacceleration_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
nothing from it and nothing from JAX. Module names mirror the JAX package's,
so each counterpart is easy to find. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; every TPU kernel of the ported path is a
hand-written CUDA kernel under ``csrc/``, built on first use by
``_build.py``, with a plain torch version beside its wrapper.
"""
