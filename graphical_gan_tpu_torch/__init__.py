"""PyTorch/CUDA port of graphical_gan_tpu.

The JAX package ``graphical_gan_tpu`` is the reference; this package imports
nothing of it (nor of JAX). Parameters keep the JAX names and TF layouts
(conv HWIO, deconv ``(k, k, out, in)``, linear ``[in, out]``), images are NHWC
inside the networks and flat NCHW-ordered at the entry points, so a JAX npz
checkpoint loads as it is. The TPU's Pallas kernels on the ported paths are
hand-written CUDA kernels under ``csrc/``, built with ``nvcc`` at first use.
"""
