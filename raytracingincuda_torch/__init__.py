"""PyTorch and CUDA port of the path tracer, for NVIDIA Hopper (H100).

The JAX package ``raytracingincuda_tpu`` beside it is the reference; this
package imports ``torch`` and never ``jax``. The forward render's kernel
(``csrc/regen_render.cu``) is built by ``nvcc`` at first use.
"""
