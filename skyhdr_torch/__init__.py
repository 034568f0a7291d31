"""skyhdr_torch — the PyTorch/CUDA port of `skyhdr` for NVIDIA Hopper.

Serves, trains and evaluates the same LDR sky panorama -> HDR radiance map
models as `skyhdr`, with the same parameter trees, holding the JAX package
as its reference. Layout mirrors `skyhdr/`:

  skyhdr_torch.ops      — mu-law HDR, bilinear resize, distortion-aware (DA)
                          conv tables and plain form, CRF, JPEG, DoG, EMD,
                          geometry; ops.kernels holds the hand-written CUDA
                          kernels (csrc/) and their autograd glue.
  skyhdr_torch.models   — Generator, SunPoseNet, Grad-CAM, SunRadNet,
                          discriminator, VGG16.
  skyhdr_torch.data     — TFRecord reading and writing, the input pipeline,
                          the degradation model, the Laval HDR database.
  skyhdr_torch.train    — serving (build_models, make_inference_fn), the GAN
                          and sun-pretrain train and eval steps with their
                          optimizers and storage knobs, TrainLoop,
                          checkpoints, evaluation metrics, the import of
                          `skyhdr` checkpoints.
  skyhdr_torch.parallel — data-parallel train steps over torch.distributed.
  skyhdr_torch.utils    — weight transplant, dtype casts, .hdr and .png I/O,
                          the checkpoint export format.
  skyhdr_torch.cli      — every CLI of `skyhdr`: inference, train,
                          train_sun, evaluate, convert_real_eval,
                          dataset_generator, and import_checkpoint.
  skyhdr_torch.tools    — the DA-conv probe tools.

Public tensors are NHWC, like the JAX package. The package imports neither
`jax` nor `skyhdr`.
"""

__version__ = "0.1.0"

from skyhdr_torch.config import Config, DataConfig, ModelConfig, TrainConfig  # noqa: F401
