"""raytrace_tpu — general-relativistic ray tracing in the Kerr spacetime on the GPU.

A brand-new JAX/XLA/Pallas framework with the capabilities of the reference
CPU code (wilkinsdr/raytrace_cpu, itself a port of the CUDAKerr GPU code of
Wilkins & Fabian 2012): batched integration of null geodesics in
Boyer-Lindquist coordinates driven by the conserved constants of motion
(k, h, Q), with lamppost point-source and backward-traced image-plane ray
sources, pluggable termination surfaces, full GR redshift via observer
tetrads, and the science applications built on top (emissivity profiles,
disc images, caustic maps, returning radiation, reverberation transfer
functions, outflow line profiles).

Design (see SURVEY.md §7):
  * Rays are a struct-of-arrays batch (`RayBatch`) marched in lock-step by
    masked fixed-shape loops, or by a GPU kernel that keeps each ray in
    registers — the data-parallel replacement for the reference's
    per-ray OpenMP loop (`src/raytracer/raytracer.cpp:104`).
  * All physics is pure functions over jnp arrays (geometry/), unit-tested
    against closed forms.
  * Reductions (radial bins, image pixels) are on-device segment sums;
    multi-chip runs shard the ray axis over a 1-D mesh and merge with psum.
  * Double precision is enabled globally: Boyer-Lindquist coordinates near
    the horizon and image planes at D = 10^4 r_g are precision-sensitive
    (the reference instantiates double for all live apps). Hot kernels can
    opt down to f32 explicitly.
"""

import jax

# f64 must be enabled before any array is created. The reference's live apps
# all instantiate Raytracer<double> (src/raytracer/raytracer.cpp:1896).
jax.config.update("jax_enable_x64", True)

from raytrace_tpu.geometry import kerr  # noqa: E402
from raytrace_tpu.rays import RayBatch  # noqa: E402

__version__ = "0.1.0"

__all__ = ["kerr", "RayBatch", "__version__"]
