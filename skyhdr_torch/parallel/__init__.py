"""Parallel training of the port (`skyhdr.parallel`), over
`torch.distributed`:

  * mesh.py — process groups (NCCL on the card, gloo on the CPU or for
              several ranks on one card), the (data, width) layout and the
              batch placement: a rank's rows of a host batch, rank 0's copy
              of a replicated tensor
  * dp.py   — data-parallel GAN and sun train steps: the batch sharded over
              `data`, the state replicated, the gradients all-reduced, and
              the batch's couplings (train-mode BatchNorm, the sun-pose
              maximum, the degradation's draws and JPEG ramp) taken over the
              whole batch

`skyhdr`'s `fsdp.py` (ZeRO-3) and `spatial.py` (the width-sharded ring halo)
are not ported yet.
"""

from skyhdr_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    initialize_distributed,
    make_mesh,
    replicated,
    vector_sharding,
)
from skyhdr_torch.parallel.dp import (  # noqa: F401
    make_parallel_gan_train_step,
    make_parallel_sun_train_step,
    replicas_agree,
    replicate_state,
)
