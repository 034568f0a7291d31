"""The training engine (`skyhdr.train`): losses, the train, eval and
serving steps, optimizers, checkpoints, metrics and the TensorBoard
writer."""

from skyhdr_torch.train.losses import (  # noqa: F401
    kl_divergence,
    lsgan_disc_loss,
    lsgan_gen_loss,
)
from skyhdr_torch.train.engine import (  # noqa: F401
    GanState,
    SunState,
    create_gan_state,
    create_sun_state,
    generator_forward,
    make_gan_eval_step,
    make_gan_train_step,
    make_inference_fn,
    make_sun_eval_step,
    make_sun_train_step,
)
