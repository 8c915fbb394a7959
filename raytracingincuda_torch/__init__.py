"""PyTorch and CUDA port of the path tracer, for NVIDIA Hopper (H100).

The JAX package ``raytracingincuda_tpu`` beside it is the reference; this
package imports ``torch`` and never ``jax``. The kernels (``csrc/``) are
built by ``nvcc`` at first use. Scenes go on the card unless the caller
passes ``device='cpu'`` (``device.py``). The top level re-exports the names
the JAX package's top level re-exports.
"""
from .models.camera import Camera, CameraConfig, initialize  # noqa: F401
from .models.scene import Scene, SceneParams, build_scene  # noqa: F401
from .ops.tracer import render  # noqa: F401
