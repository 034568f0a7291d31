"""skyhdr_torch — the PyTorch/CUDA port of `skyhdr` for NVIDIA Hopper.

Serves the same LDR sky panorama -> HDR radiance map path as `skyhdr` with
the same parameter trees, holding the JAX package as its reference. Layout
mirrors `skyhdr/`:

  skyhdr_torch.ops      — mu-law HDR, bilinear resize, distortion-aware (DA)
                          conv tables and plain form; ops.kernels holds the
                          hand-written CUDA kernels (csrc/) and their
                          autograd glue.
  skyhdr_torch.models   — Generator, SunPoseNet, Grad-CAM, SunRadNet.
  skyhdr_torch.train    — build_models and make_inference_fn.
  skyhdr_torch.utils    — weight transplant, dtype casts, .hdr and .png I/O.
  skyhdr_torch.cli      — the inference CLI.

Public tensors are NHWC, like the JAX package. The package imports neither
`jax` nor `skyhdr`.
"""

__version__ = "0.1.0"

from skyhdr_torch.config import Config, DataConfig, ModelConfig, TrainConfig  # noqa: F401
