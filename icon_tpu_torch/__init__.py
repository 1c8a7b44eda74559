"""icon_tpu_torch — the PyTorch/CUDA port of icon_tpu for NVIDIA Hopper.

The JAX package ``icon_tpu`` stays the reference; every module here mirrors
the module path and function names of its JAX counterpart. The port imports
``torch`` and never ``jax``; from ``icon_tpu`` it uses only jax-free code
(``icon_tpu.config``, ``icon_tpu.native``, the numpy helpers of
``icon_tpu.utils.synthetic``).

Layout: ``ops`` (stateless tensor ops, the differentiable rasterizer, mesh
losses, the host remesher), ``models`` (HGPIFuNet filter and query, the
NormalNet, the SMPL-family body model, the local affine deformation),
``render`` (camera and renders), ``infer`` (the demo's fit and cloth
loops), ``kernels`` + ``csrc`` (hand-written CUDA kernels with plain
PyTorch twins), ``recon`` (coarse-to-fine engine, lattice marching, the
frames), ``utils`` (synthetic inputs, JAX -> torch weight and body model
conversion).

Images are NHWC at the public boundary (``HGPIFuNet.filter``), NCHW inside;
point sets are ``[B, N, 3]``.
"""
