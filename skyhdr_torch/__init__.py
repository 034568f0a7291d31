"""skyhdr_torch — the PyTorch/CUDA port of `skyhdr` for NVIDIA Hopper.

Serves, trains and evaluates the same LDR sky panorama -> HDR radiance map
models as `skyhdr`, with the same parameter trees, holding the JAX package
as its reference. Layout mirrors `skyhdr/`, and each subpackage re-exports
what its `skyhdr` counterpart does, under the same names:

  skyhdr_torch.ops      — mu-law HDR and the colour helpers, bilinear
                          resize, distortion-aware (DA) conv tables and
                          plain form (stride 1: `skyhdr`'s strided form is
                          not ported, see `ops.distortion.STRIDE_DEFECT`),
                          CRF, JPEG, the DoG losses and pyramid, EMD,
                          geometry; ops.kernels holds the hand-written CUDA
                          kernels (csrc/) and their autograd glue, imported
                          and built by the ops that launch them.
  skyhdr_torch.models   — Generator, SunPoseNet, Grad-CAM, SunRadNet,
                          discriminator, VGG16, and the layers of
                          `skyhdr.models.layers` (FC2D, DFC2D, avgpool2 too).
  skyhdr_torch.data     — TFRecord reading and writing, the input pipeline,
                          the degradation model, the Laval HDR database.
  skyhdr_torch.train    — serving (build_models, make_inference_fn), the GAN
                          and sun-pretrain train and eval steps with their
                          optimizers and storage knobs, TrainLoop,
                          checkpoints, evaluation metrics, the import of
                          `skyhdr` checkpoints.
  skyhdr_torch.parallel — training over torch.distributed: data parallel,
                          ZeRO-3 sharded state (`fsdp.py`), and the width
                          ring (`spatial.py`: halo exchange, the DA conv on
                          width shards, the width-sharded GAN step).
  skyhdr_torch.utils    — weight transplant, dtype casts, .hdr and .png I/O,
                          the checkpoint export format.
  skyhdr_torch.cli      — every CLI of `skyhdr`: inference, train,
                          train_sun, evaluate, convert_real_eval,
                          dataset_generator, and import_checkpoint.
  skyhdr_torch.tools    — the DA-conv probe tools, the synthetic sky set
                          (`make_synth_dataset`) and the quality runs of
                          `skyhdr`'s tools/quality_run*.sh (`quality_run`).

Public tensors are NHWC, like the JAX package. The package imports neither
`jax` nor `skyhdr`.
"""

__version__ = "0.1.0"

from skyhdr_torch.config import Config, DataConfig, ModelConfig, TrainConfig  # noqa: F401
