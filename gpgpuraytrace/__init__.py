"""gpgpuraytrace — a differentiable procedural-terrain ray-marcher in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``MadrMan/gpgpuraytrace`` (a C++/D3D11 DirectCompute sphere-tracer over
Perlin/fBm noise terrain; see BASELINE.json:5): per-pixel camera-ray
generation (the role of ``camerarays.hlsl``), adaptive-step sphere-trace
marching against a procedural fBm terrain field (the role of
``tracescreen.hlsl``), gradient normals, Lambert shading, fog and sky —
plus two capabilities the reference never had: end-to-end pixel gradients
(w.r.t. noise parameters, camera pose and material constants) and
multi-device/multi-host sharding over a ``jax.sharding.Mesh``.

Layout:
  ops/       pure-JAX compute path: noise, camera, field, march, shade, render
  kernels/   fused Pallas GPU kernels, Triton route (the D3D11-dispatch analogue)
  models/    scene parameter pytrees (the "model" of this framework)
  parallel/  mesh construction, sharded render/fit (shard_map + psum)
  utils/     image IO, checkpointing, param packing
"""

__version__ = "0.1.0"

from gpgpuraytrace.models.scene import (  # noqa: F401
    Camera,
    Materials,
    NoiseParams,
    RenderConfig,
    Scene,
    default_scene,
)
from gpgpuraytrace.ops.render import render  # noqa: F401
