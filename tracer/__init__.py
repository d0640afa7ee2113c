"""tracer — a differentiable ray tracing framework in JAX.

Built from scratch as the wavefront counterpart of the reference real-time
OpenCL ray tracer (`itmanager85/real-time-opencl-raytracer`; capability spec
in BASELINE.json / SURVEY.md — the reference mount was empty, so parity is
against the binding capability list: camera ray generation, BVH-accelerated
Moller-Trumbore intersection, shading/shadow rays, scene loading).

Layer map (SURVEY.md section 1.2):
  core/    - math + geometry primitives (rays, camera, intersection)
  bvh/     - on-device LBVH / triangle-cluster acceleration structure
  kernels/ - the traversal hot loop: the sorted walk (a Pallas Triton
             kernel on the GPU, plain XLA on the CPU) and the jnp tier
  render/  - Whitted-style light transport (shading, shadow rays, bounces)
  diff/    - differentiable rendering (custom VJPs, edge reparameterization)
  dist/    - multi-chip / multi-host sharding (mesh, tile DP, ring geometry)
  scene/   - scene IO (OBJ) + procedural fixtures
  refcpu/  - CPU oracle for correctness validation
  utils/   - config, image IO, profiling
"""

__version__ = "0.1.0"

from tracer.api import render, grad_step, benchmark  # noqa: F401
