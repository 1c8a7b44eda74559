"""icon_tpu_torch — the PyTorch/CUDA port of icon_tpu for NVIDIA Hopper.

The JAX package ``icon_tpu`` stays the reference; every module here mirrors
the module path and function names of its JAX counterpart. The port imports
``torch`` and never ``jax``, and nothing of ``icon_tpu``: where it needs
framework-free code of that package (the config tree and its YAML loader,
the mesh IO, the synthetic body, the lattice decoder, the detector, the
crop) it keeps its own copy, pinned to the original by the tests.

Layout: ``apps`` (the demo CLI, ``python -m icon_tpu_torch.apps.infer``;
the trainers ``train`` and ``train_normal``; the dataset renderer
``render``; ``tetrahedronize``), ``data`` (the photo dataset: crop, PyMAF
estimate; the demo's calib; the training datasets and the offline
renders), ``training`` (steps, checkpoints, logs), ``eval``, ``ops``
(stateless tensor ops, the differentiable rasterizer, mesh losses, the
host remesher, screened Poisson), ``models`` (HGPIFuNet filter and query
for the icon, pamir and pifu priors, PaMIR's volume encoder, the NormalNet,
VGG19's perceptual features, the body
estimators, the detector and the matting net, the SMPL-family body model
with its tetrahedral variant and its asset registry, the local affine
deformation), ``render`` (camera and renders),
``infer`` (the demo's fit and cloth loops), ``kernels`` + ``csrc``
(hand-written CUDA kernels with plain PyTorch twins), ``recon``
(coarse-to-fine engine, lattice marching, the frames), ``utils`` (mesh IO,
synthetic inputs, JAX -> torch weight and body model conversion).

Images are NHWC at the public boundary (``HGPIFuNet.filter``), NCHW inside;
point sets are ``[B, N, 3]``.
"""
