"""The model zoo (`skyhdr.models`): Generator, PatchGAN discriminator,
SunPoseNet, SunRadNet, Grad-CAM and the frozen VGG16."""

from skyhdr_torch.models.generator import Generator, ResBlock  # noqa: F401
from skyhdr_torch.models.discriminator import Discriminator  # noqa: F401
from skyhdr_torch.models.sunpose import SunPoseNet  # noqa: F401
from skyhdr_torch.models.sunrad import SunRadNet  # noqa: F401
from skyhdr_torch.models.gradcam import sunpose_with_cams  # noqa: F401
from skyhdr_torch.models.vgg16 import (  # noqa: F401
    load_vgg16_npy,
    perceptual_l1,
    random_vgg16_weights,
    vgg16_features,
)
