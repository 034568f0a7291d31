"""Parallel training of the port (`skyhdr.parallel`), over
`torch.distributed`:

  * mesh.py    — process groups (NCCL on the card, gloo on the CPU or for
                 several ranks on one card), the (data, width) layout, the
                 batch placement (a rank's rows, and with `shard_width` its
                 width columns), rank 0's copy of a replicated tensor, and
                 the all-gather and reduce-scatter of `fsdp.py`
  * dp.py      — data-parallel GAN and sun train steps: the batch sharded
                 over `data`, the state replicated, the gradients
                 all-reduced, and the batch's couplings (train-mode
                 BatchNorm, the sun-pose maximum, the degradation's draws
                 and JPEG ramp) taken over the whole batch; the GAN step
                 with `shard_width=True` also shards the panorama's width
                 over `width`, every layer on the width ring
  * fsdp.py    — ZeRO-3: `dp.py`'s steps with the big tensors of the state
                 (parameters, moments, master) sharded over `data`
                 (`skyhdr`'s plan), all-gathered for the step and their
                 gradients reduce-scattered (the GAN step with
                 `shard_width=True` as `dp.py`'s, its gradients summed over
                 the width ring first)
  * spatial.py — the width ring: a cyclic halo exchange with a backward,
                 `ring_conv2d`, the DA conv `ring_deformable_conv2d` (K1-K3,
                 or K5-K7, on each rank's width shard), and the width
                 context (`WidthRing`, `width_across`) of the width-sharded
                 step

The sun-pretrain step has no width-sharded form, as in `skyhdr`.
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
from skyhdr_torch.parallel.fsdp import (  # noqa: F401
    fsdp_plan,
    make_fsdp_gan_train_step,
    make_fsdp_sun_train_step,
    unshard_state,
)
from skyhdr_torch.parallel.spatial import (  # noqa: F401
    WidthRing,
    ring_conv2d,
    ring_da_plan,
    ring_deformable_conv2d,
    width_across,
)
