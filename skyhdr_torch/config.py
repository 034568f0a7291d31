"""Configuration tree of the PyTorch port.

A field-for-field copy of `skyhdr.config` (same dataclasses, names and
defaults; `tests/test_torch_tables.py` holds the two equal). It is a copy and
not an import because the port must run where the JAX package is absent:
importing `skyhdr.config` pulls in the `skyhdr` package. The rationale of
each knob is documented in `skyhdr/config.py`. Knobs that only steer the
TPU build (`da_backend`, `fold_tiny_convs`, `steps_per_dispatch`) are
carried so one tree serves both packages; the port does not read them
(`TrainLoop` accepts only `steps_per_dispatch=1`). `fused_instance_norm`
is read: it routes every InstanceNorm through the fused K8/K9 op.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    im_height: int = 32
    im_width: int = 128
    channels: int = 3
    enc_filters: Tuple[int, int, int] = (32, 64, 128)
    num_res_blocks: int = 6
    dec_filters: Tuple[int, int] = (64, 32)
    da_kernel_size: int = 3
    dilation_rate: int = 1
    use_da_conv: bool = False
    da_backend: str = "auto"
    fold_tiny_convs: bool = True
    fused_instance_norm: bool = False
    # Conv stacks may run bf16; norms' statistics, the sun-pose softmax and
    # the radiance head stay float32.
    compute_dtype: str = "float32"
    valid_dr: float = 10.0
    alpha_threshold: float = 0.12
    sun_rad_clip: float = 30000.0
    vmf_kappa: float = 80.0

    @property
    def imshape(self) -> Tuple[int, int, int]:
        return (self.im_height, self.im_width, self.channels)

    @property
    def num_bins(self) -> int:
        return self.im_height * self.im_width


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset_dir: str = "dataset_128_32/tfrecord"
    batch_size: int = 32
    shuffle_buffer: int = 10000
    n_train_exposures: int = 600
    n_test_exposures: int = 7
    dorf_path: Optional[str] = None
    jpeg_quality_lo: float = 90.0
    jpeg_quality_hi: float = 100.0
    jpeg_chroma_subsample: bool = True
    sigma_s_scale: float = 0.08 / 6.0
    sigma_c_scale: float = 0.005
    train_split_count: int = 30000
    img_bias: float = 0.00955794


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    epochs: int = 1000
    w_sun: float = 1.0
    w_dog: float = 1000.0
    w_adv: float = 1.0
    w_l1: float = 10.0
    w_perceptual: float = 0.01
    ckpt_every_epochs: int = 10
    ckpt_max_to_keep: int = 5
    checkpoint_dir: str = "checkpoints"
    tensorboard_dir: str = "tensorboard"
    vgg_path: Optional[str] = None
    seed: int = 0
    opt_state_dtype: str = "float32"
    param_dtype: str = "float32"
    grad_dtype: str = "float32"
    steps_per_dispatch: int = 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data_parallel: int = 1
    width_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
