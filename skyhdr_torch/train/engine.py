"""Model construction, the serving forward and the two train steps
(`skyhdr.train.engine`).

  build_models, make_inference_fn          — serving.
  create_gan_state, make_gan_train_step    — the GAN step: one RMSprop
      update over generator + sun-pose parameters together from the total
      generator loss (the adversarial term through a discriminator forward
      with FROZEN BatchNorm statistics), then the discriminator's RMSprop
      update on the detached prediction with batch statistics, its running
      statistics chained through the real and then the generated forward.
  create_sun_state, make_sun_train_step    — the sun-pose pretrain step
      (KL + DoG, Adam).
  make_gan_eval_step, make_sun_eval_step   — the test passes: the same
      losses, no update, frozen BatchNorm statistics.
  state_dict, load_state, replace_sun_params — checkpoints and the SUN ->
      GAN hand-off of the sun-pose weights.

A train step is `step(state, batch, generator) -> (state, metrics)`: it
draws the degradation from the `torch.Generator`, then runs its core
`step.train_on(state, hdr_t, ldr, sunpose_gt)`, which tests feed with the
pair the JAX package degraded. The state is updated IN PLACE (parameters,
optimizer moments, BatchNorm buffers) and returned; metrics are 0-d device
tensors with the JAX package's names. An eval step is `step(state, batch,
generator) -> (metrics, outputs)` around its core `step.eval_on`.
`ModelConfig.compute_dtype="bfloat16"` runs the layers that take the compute
dtype in bfloat16, as the JAX package does: the activations and the gradients
they carry round where `skyhdr`'s do, and the gradients reach the parameters
through the casts.

The storage knobs of `cfg.train` (`train.optim` says how the optimizers run
them): `param_dtype="bfloat16"` stores the `params` leaves in bfloat16 (never
the BatchNorm buffers) beside the optimizer's float32 master, and every
layer promotes them against its input as Flax does, so a gradient for a
bfloat16 leaf arrives rounded through the cast; `grad_dtype` casts the
gradients after `torch.autograd.grad`; `opt_state_dtype` is the moments'.
"""

from __future__ import annotations

import torch

from skyhdr_torch.data.degradation import degrade_batch
from skyhdr_torch.models.discriminator import Discriminator
from skyhdr_torch.models.generator import Generator
from skyhdr_torch.models.gradcam import sunpose_with_cams
from skyhdr_torch.models.sunpose import SunPoseNet
from skyhdr_torch.models.vgg16 import perceptual_l1, vgg_constants
from skyhdr_torch.ops import width
from skyhdr_torch.ops.dog import dog_l1_loss
from skyhdr_torch.ops.geometry import sunpose_gt_from_elevation
from skyhdr_torch.ops.hdr import hdr_log_compression, hdr_log_decompression
from skyhdr_torch.train import losses
from skyhdr_torch.train.optim import Adam, RMSprop, storage_dtype


def _act_dtype(cfg):
    """The activations' dtype: the compute dtype, float32 by default."""
    return torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32


def build_models(cfg, device="cuda"):
    """(Generator, SunPoseNet) for `cfg` (a Config) with empty weights on
    `device`, in eval mode and requiring no gradients (serving); fill them
    with `skyhdr_torch.utils.transplant.load_model_vars`."""
    gen = Generator(cfg.model, device=device)
    sun = SunPoseNet(cfg.model, device=device)
    for m in (gen, sun):
        m.eval().requires_grad_(False)
    return gen, sun


def make_inference_fn(cfg):
    """LDR [b,h,w,3] in [0,1] -> dict of NHWC HDR predictions, as the JAX
    `make_inference_fn`: forward(gen, sun, ldr) with the models built once
    by `build_models`. Grad-CAM differentiates the sun-pose net, so that
    part runs with autograd on; everything else runs without it."""
    vdr = cfg.model.valid_dr
    thr = cfg.model.alpha_threshold
    h, w = cfg.model.im_height, cfg.model.im_width
    act_dtype = _act_dtype(cfg)

    @torch.no_grad()
    def forward(gen: Generator, sun: SunPoseNet, ldr: torch.Tensor):
        res_out = gen.encode(ldr)
        sky_pred_gamma = gen.sky_decode(res_out, ldr)
        sky_pred_lin = hdr_log_decompression(sky_pred_gamma, vdr)

        # y_c = max probability.
        sm, (cam1, cam2, cam3) = sunpose_with_cams(sun, ldr, act_dtype)
        sunpose_pred = sm.reshape(-1, h, w, 1)

        alpha = torch.amax(sky_pred_lin, dim=3)
        alpha = torch.clamp(torch.clamp(alpha - 1.0 + thr, min=0.0) / thr, max=1.0)
        alpha_c3 = alpha[..., None].expand(sky_pred_lin.shape)

        sun_rad_lin, _, _ = gen.sun_rad_estimation(ldr, cam1, cam2, cam3,
                                                   sunpose_pred)
        sun_rad_gamma = hdr_log_compression(sun_rad_lin, vdr)
        sun_pred_gamma = gen.sun_decode(res_out, sun_rad_gamma)

        sky_pred_gamma = (1.0 - alpha_c3) * sky_pred_gamma
        sun_pred_gamma = alpha_c3 * sun_pred_gamma
        y_final_gamma = gen.blending(sky_pred_gamma, sun_pred_gamma)
        return {
            "y_final_lin": hdr_log_decompression(y_final_gamma, vdr),
            "sky_pred_lin": hdr_log_decompression(sky_pred_gamma, vdr),
            "sun_pred_lin": hdr_log_decompression(sun_pred_gamma, vdr),
            "alpha": alpha_c3,
            "sunpose_pred": sunpose_pred,
        }

    return forward


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

class GanState:
    """Generator, sun-pose net and discriminator (parameters requiring
    gradients, stored in `param_dtype`), `opt_gen` (RMSprop over generator
    then sun parameters), `opt_disc` (RMSprop over the discriminator's),
    the step count and the epoch count (set by `train.loop.TrainLoop`)."""

    kind = "gan"

    def __init__(self, gen, sun, disc, opt_gen, opt_disc, param_dtype="float32"):
        self.gen, self.sun, self.disc = gen, sun, disc
        self.opt_gen, self.opt_disc = opt_gen, opt_disc
        self.param_dtype = param_dtype
        self.step = 0
        self.epoch = 0

    def modules(self) -> dict:
        return {"gen": self.gen, "sun": self.sun, "disc": self.disc}

    def optimizers(self) -> dict:
        return {"opt_gen": self.opt_gen, "opt_disc": self.opt_disc}


class SunState:
    """The sun-pose net, its Adam optimizer, the step and epoch counts."""

    kind = "sun"

    def __init__(self, sun, opt, param_dtype="float32"):
        self.sun, self.opt = sun, opt
        self.param_dtype = param_dtype
        self.step = 0
        self.epoch = 0

    def modules(self) -> dict:
        return {"sun": self.sun}

    def optimizers(self) -> dict:
        return {"opt": self.opt}


def _param_dtype(cfg) -> str:
    return cfg.train.param_dtype or "float32"


def _optimizer(cls, cfg, params):
    t = cfg.train
    return cls(list(params), t.learning_rate, opt_state_dtype=t.opt_state_dtype,
               param_dtype=_param_dtype(cfg))


@torch.no_grad()
def _store_params(cfg, *modules):
    """Reallocate the modules' parameters (not their buffers) in the stored
    dtype, unfilled; the optimizer's master gives them their values."""
    dtype = storage_dtype(_param_dtype(cfg))
    for m in modules:
        for p in m.parameters():
            if p.dtype != dtype:
                p.data = torch.empty_like(p, dtype=dtype)


def empty_gan_state(cfg, device="cuda") -> GanState:
    """A GAN state with its tensors allocated on `device` but not filled
    (zero moments): for `create_gan_state` and a checkpoint restore. The
    parameters are in `cfg.train.param_dtype`, the moments in its
    `opt_state_dtype`."""
    gen, sun = build_models(cfg, device)
    disc = Discriminator(cfg.model.channels, device=device)
    for m in (gen, sun, disc):
        m.requires_grad_(True)
    _store_params(cfg, gen, sun, disc)
    return GanState(gen, sun, disc,
                    _optimizer(RMSprop, cfg, [*gen.parameters(), *sun.parameters()]),
                    _optimizer(RMSprop, cfg, disc.parameters()), _param_dtype(cfg))


def empty_sun_state(cfg, device="cuda") -> SunState:
    """A sun-pretrain state allocated on `device`, not filled."""
    sun = SunPoseNet(cfg.model, device=device).requires_grad_(True)
    _store_params(cfg, sun)
    return SunState(sun, _optimizer(Adam, cfg, sun.parameters()), _param_dtype(cfg))


def load_weights(state, trees) -> None:
    """Fill `state`'s modules (in `state.modules()` order) from Flax-layout
    trees: the `params` into the parameters, or under bfloat16 parameters
    into the optimizers' float32 master, the parameters then written as it
    rounded; the BatchNorm statistics into the buffers."""
    from skyhdr_torch.utils.transplant import load_model_vars

    master = {p: m for opt in state.optimizers().values()
              for p, m in opt.moments().get("master", {}).items()}
    for module, tree in zip(state.modules().values(), trees):
        if master:
            load_model_vars(module, tree, target_of=master.__getitem__,
                            collections=("params",))
            load_model_vars(module, tree, collections=("batch_stats",))
        else:
            load_model_vars(module, tree)
    for opt in state.optimizers().values():
        opt.sync_params()


def create_gan_state(cfg, seed: int = 0, device="cuda") -> GanState:
    """The GAN state with the weights of `utils.transplant.init_gan_vars(cfg,
    seed)` on `device` and zero RMSprop moments (under bfloat16 parameters
    the float32 draw is the master, as `skyhdr`'s optimizer init sees the
    float32 parameters before the stored copy is cast)."""
    from skyhdr_torch.utils.transplant import init_gan_vars

    state = empty_gan_state(cfg, device)
    load_weights(state, init_gan_vars(cfg, seed))
    return state


def create_sun_state(cfg, seed: int = 0, device="cuda") -> SunState:
    """The sun-pretrain state: the sun-pose weights of
    `init_model_vars(cfg, seed)` on `device`, zero Adam moments."""
    from skyhdr_torch.utils.transplant import init_model_vars

    state = empty_sun_state(cfg, device)
    load_weights(state, [init_model_vars(cfg, seed)[1]])
    return state


def state_dict(state) -> dict:
    """Everything a resume needs, as tensors on the state's device: the
    modules' parameters and buffers, the optimizers' moments (Adam's count,
    the float32 master under bfloat16 parameters), each in its own dtype,
    the step, the epoch and the parameters' dtype."""
    return {"kind": state.kind, "step": state.step, "epoch": state.epoch,
            "param_dtype": state.param_dtype,
            "modules": {n: m.state_dict() for n, m in state.modules().items()},
            "optimizers": {n: o.state() for n, o in state.optimizers().items()}}


def load_state(blob: dict, cfg, device="cuda"):
    """The state of a `state_dict` (read anywhere, e.g. to the host),
    rebuilt on `device` for `cfg` without drawing seeded weights. The
    moments keep their saved values and the next step stores them in
    `cfg.train.opt_state_dtype`, as `skyhdr`'s restore keeps the saved
    dtype. Raises ValueError for a checkpoint saved under another
    `param_dtype`, as `skyhdr`'s resume does (its optimizer state has
    another tree structure there); the serving CLIs and the SUN hand-off
    read any."""
    saved = blob.get("param_dtype", "float32")
    if saved != _param_dtype(cfg):
        raise ValueError(
            f"checkpoint saved with param_dtype={saved!r}, the run has "
            f"param_dtype={_param_dtype(cfg)!r}: resume it with --param-dtype {saved}")
    make = {"gan": empty_gan_state, "sun": empty_sun_state}[blob["kind"]]
    state = make(cfg, device)
    with torch.no_grad():
        for name, module in state.modules().items():
            module.load_state_dict(blob["modules"][name])
    for name, opt in state.optimizers().items():
        opt.load_moments(blob["optimizers"][name])
    state.step, state.epoch = int(blob["step"]), int(blob["epoch"])
    return state


@torch.no_grad()
def replace_sun_params(cfg, state: GanState, sun_params: dict) -> GanState:
    """SUN -> GAN weight hand-off (reference train.py:223-230,
    `skyhdr.train.engine.replace_sun_params`): the sun-pose net's
    parameters (a `SunPoseNet.state_dict()`, as a SUN checkpoint holds it
    under modules/sun, in any param_dtype) copied into the GAN state. Under
    bfloat16 parameters the optimizer's master takes their float32 values
    and the stored copy their rounding, so that the first update does not
    revert the hand-off. The RMSprop moments stay as they are."""
    state.sun.load_state_dict(sun_params)
    if state.opt_gen.master is not None:
        master = state.opt_gen.moments()["master"]
        for name, p in state.sun.named_parameters():
            master[p].copy_(sun_params[name])
        state.opt_gen.sync_params()
    return state


def _grads(cfg, total, params, reduce=None):
    """The gradients of `total`, through `reduce(grads, params)` (a
    data-parallel step's all-reduce, an FSDP step's reduce-scatter) where
    given, then cast to `cfg.train.grad_dtype` unless that is float32
    (`skyhdr`'s `grad_store`, which casts after its GSPMD step's
    reduction). `reduce` gets the gradients as a list it may overwrite
    entry by entry, so that each unreduced gradient is freed once its
    reduced one exists."""
    grads = list(torch.autograd.grad(total, params))
    if reduce is not None:
        grads = reduce(grads, params)
    if storage_dtype(cfg.train.grad_dtype) == torch.float32:
        return grads
    return [g.to(storage_dtype(cfg.train.grad_dtype)) for g in grads]


def degrade(cfg, banks, generator, hdr, shard=(0, 1)):
    """`degrade_batch` with `cfg.data`'s JPEG and noise settings: the
    degradation of the train and eval steps and of `cli.evaluate`; `shard`
    as there (a data-parallel rank's rows)."""
    d = cfg.data
    return degrade_batch(generator, hdr, banks, shard, jpeg_lo=d.jpeg_quality_lo,
                         jpeg_hi=d.jpeg_quality_hi, sigma_s_scale=d.sigma_s_scale,
                         sigma_c_scale=d.sigma_c_scale,
                         chroma_subsample=d.jpeg_chroma_subsample)


def with_degradation(cfg, banks, core, name: str = "train_on", shard=(0, 1)):
    """`step(state, batch, generator)`: the vMF ground truth from the
    batch's elevations, the degradation drawn from `generator` (`shard`: a
    data-parallel rank's rows, as `degrade` takes them), then `core` (kept
    as `step.train_on`, or as `step.<name>`)."""

    def step(state, batch, generator: torch.Generator):
        sunpose_gt = sunpose_gt_from_elevation(cfg.model, batch["elevation"])
        hdr_t, ldr = degrade(cfg, banks, generator, batch["hdr"], shard)
        return core(state, hdr_t, ldr, sunpose_gt)

    setattr(step, name, core)
    return step


def generator_forward(cfg, gen, sun, disc, ldr, hdr_t, sunpose_gt, vgg,
                      train: bool):
    """The generator-side graph and losses (`skyhdr.train.engine.
    generator_forward`); `vgg` from `vgg_constants`. Returns (total, aux).
    With `train` SunRadNet's BatchNorm uses batch statistics and refreshes
    its buffers in place; the discriminator always runs with its frozen
    statistics here.

    In a width context (`ops.width`) ldr and hdr_t are width shards, and
    every map of the graph is too, but the sun-pose softmax, whole on every
    process of the ring, of which `sunpose_pred` keeps the shard's columns.
    Each loss is this process's share of the whole batch's (the shares sum
    to it over the ring): the means of the shards' sums over the whole
    count, the KL (of whole tensors) over the ring's size. The
    backward of each rank is then its share of the gradient, which the
    step sums over the ring."""
    m = cfg.model
    thr, vdr = m.alpha_threshold, m.valid_dr
    hdr_t_gamma = hdr_log_compression(hdr_t, vdr)

    res_out = gen.encode(ldr)
    sky_pred_gamma = gen.sky_decode(res_out, ldr)
    sky_pred_lin = hdr_log_decompression(sky_pred_gamma, vdr)

    # One sun-pose forward serves the KL path and the CAMs; the CAMs carry
    # no gradient, the outer loss reaches the net through `sm` only (an eval
    # step, under no_grad, keeps no graph).
    sm, (cam1, cam2, cam3) = sunpose_with_cams(sun, ldr, _act_dtype(cfg), sunpose_gt,
                                               keep_graph=torch.is_grad_enabled())
    sunpose_pred = sm.reshape(-1, m.im_height, m.im_width, 1)
    ring = width.current()
    if ring is not None:
        sunpose_pred = sunpose_pred[:, :, ring.cols(m.im_width)]

    alpha = torch.amax(sky_pred_lin, dim=3)
    alpha = torch.clamp(torch.clamp(alpha - 1.0 + thr, min=0.0) / thr, max=1.0)
    alpha_c3 = alpha[..., None].expand(sky_pred_lin.shape).detach()

    sun_rad_lin, gamma, beta = gen.sun_rad_estimation(
        ldr, cam1, cam2, cam3, sunpose_pred, train)
    sun_pred_gamma = gen.sun_decode(res_out, hdr_log_compression(sun_rad_lin, vdr))

    sky_pred_gamma = (1.0 - alpha_c3) * sky_pred_gamma
    sun_pred_gamma = alpha_c3 * sun_pred_gamma
    y_final_gamma = gen.blending(sky_pred_gamma, sun_pred_gamma)
    y_final_lin = hdr_log_decompression(y_final_gamma, vdr)

    disc_generated = disc(ldr, y_final_lin, train=False)

    t = cfg.train
    sun_loss = losses.kl_divergence(sunpose_gt, sm)
    if ring is not None:
        sun_loss = sun_loss / ring.n
    perceptual = perceptual_l1(vgg, y_final_gamma, hdr_t_gamma, dtype=_act_dtype(cfg))
    dog = dog_l1_loss(y_final_lin, hdr_t)
    l1 = losses.l1_loss(y_final_lin, hdr_t)
    adv = losses.lsgan_gen_loss(disc_generated, _logits_width(ldr))
    total = (t.w_sun * sun_loss + t.w_dog * dog + t.w_adv * adv + t.w_l1 * l1
             + t.w_perceptual * perceptual)
    aux = {
        "y_final_gamma": y_final_gamma,
        "y_final_lin": y_final_lin,
        "sky_pred_lin": hdr_log_decompression(sky_pred_gamma, vdr),
        "sun_pred_lin": hdr_log_decompression(sun_pred_gamma, vdr),
        "alpha_c3": alpha_c3,
        "sunpose_pred": sunpose_pred,
        "sun_rad_lin": sun_rad_lin,
        "gamma_max": torch.max(gamma),
        "beta_max": torch.max(beta),
        "losses": {"gen_total": total, "l1": l1, "kl": sun_loss, "dog": dog,
                   "adv": adv, "perceptual": perceptual},
    }
    return total, aux


def _logits_width(ldr):
    """On width shards the whole width of the discriminator's logits of
    ldr's panorama, else None."""
    ring = width.current()
    return None if ring is None else Discriminator.logits_width(ldr.shape[1],
                                                               ldr.shape[2] * ring.n)


def make_gan_train_step(cfg, banks, vgg_weights, reduce_grads=None):
    """The GAN train step for states from `create_gan_state`, on the device
    of `banks` (from `data.degradation.make_banks`); `vgg_weights` is the
    NumPy weight dict of `models.vgg16`. `reduce_grads(grads, params)`:
    applied to each update's float32 gradients before the `grad_dtype` cast
    (`parallel.dp`'s all-reduce, `parallel.fsdp`'s reduce-scatter)."""
    vgg = vgg_constants(vgg_weights, banks.crfs.device)

    def train_on(state: GanState, hdr_t, ldr, sunpose_gt):
        total, aux = generator_forward(cfg, state.gen, state.sun, state.disc,
                                       ldr, hdr_t, sunpose_gt, vgg, train=True)
        grads = _grads(cfg, total, state.opt_gen.params, reduce_grads)
        state.opt_gen.step(grads)
        del grads

        y_final_lin = aux["y_final_lin"].detach()
        real = state.disc(ldr, hdr_t, train=True)
        generated = state.disc(ldr, y_final_lin, train=True)
        disc_total, real_l, gen_l = losses.lsgan_disc_loss(real, generated,
                                                           _logits_width(ldr))
        state.opt_disc.step(_grads(cfg, disc_total, state.opt_disc.params, reduce_grads))
        state.step += 1

        metrics = dict(aux["losses"], disc_total=disc_total, disc_real=real_l,
                       disc_generated=gen_l, g_out=aux["gamma_max"],
                       b_out=aux["beta_max"])
        return state, {k: v.detach() for k, v in metrics.items()}

    return with_degradation(cfg, banks, train_on)


_GAN_OUTPUTS = ("y_final_lin", "sky_pred_lin", "sun_pred_lin", "alpha_c3",
                "sunpose_pred", "sun_rad_lin")


def make_gan_eval_step(cfg, banks, vgg_weights):
    """The GAN test step (`skyhdr.train.engine.make_gan_eval_step`): the
    generator losses and the discriminator's on the real and generated
    pairs, every BatchNorm with its frozen statistics, no update. Returns
    (metrics, outputs), the outputs named as in JAX."""
    vgg = vgg_constants(vgg_weights, banks.crfs.device)

    @torch.no_grad()
    def eval_on(state: GanState, hdr_t, ldr, sunpose_gt):
        _, aux = generator_forward(cfg, state.gen, state.sun, state.disc, ldr, hdr_t,
                                   sunpose_gt, vgg, train=False)
        real = state.disc(ldr, hdr_t, train=False)
        generated = state.disc(ldr, aux["y_final_lin"], train=False)
        disc_total, real_l, gen_l = losses.lsgan_disc_loss(real, generated)
        metrics = dict(aux["losses"], disc_total=disc_total, disc_real=real_l,
                       disc_generated=gen_l, g_out=aux["gamma_max"],
                       b_out=aux["beta_max"])
        return metrics, {k: aux[k] for k in _GAN_OUTPUTS}

    return with_degradation(cfg, banks, eval_on, "eval_on")


def make_sun_train_step(cfg, banks, reduce_grads=None):
    """The sun-pretrain step for states from `create_sun_state`: KL + DoG of
    the sun-pose PDF against the vMF ground truth, one Adam update. Its
    Grad-CAM maps feed nothing in this step, so they are not computed (the
    JAX step drops them as dead code). `reduce_grads` as in
    `make_gan_train_step`."""
    h, w = cfg.model.im_height, cfg.model.im_width

    def train_on(state: SunState, hdr_t, ldr, sunpose_gt):
        sm, _ = state.sun(ldr)
        kl = losses.kl_divergence(sunpose_gt, sm)
        dog = dog_l1_loss(sm.reshape(-1, h, w, 1), sunpose_gt.reshape(-1, h, w, 1))
        total = kl + dog
        state.opt.step(_grads(cfg, total, state.opt.params, reduce_grads))
        state.step += 1
        return state, {"sun_total": total.detach(), "kl": kl.detach(),
                       "dog": dog.detach()}

    return with_degradation(cfg, banks, train_on)


def make_sun_eval_step(cfg, banks):
    """The sun-pretrain test step (`skyhdr.train.engine.make_sun_eval_step`):
    KL + DoG, no update, and the Grad-CAM maps seeded at the ground truth's
    bin. Returns ({"sun_total", "kl", "dog"}, {"pred", "gt", "cams"})."""
    h, w = cfg.model.im_height, cfg.model.im_width

    @torch.no_grad()
    def eval_on(state: SunState, hdr_t, ldr, sunpose_gt):
        sm, cams = sunpose_with_cams(state.sun, ldr, _act_dtype(cfg), sunpose_gt)
        pred_img, gt_img = sm.reshape(-1, h, w, 1), sunpose_gt.reshape(-1, h, w, 1)
        kl = losses.kl_divergence(sunpose_gt, sm)
        dog = dog_l1_loss(pred_img, gt_img)
        return ({"sun_total": kl + dog, "kl": kl, "dog": dog},
                {"pred": pred_img, "gt": gt_img, "cams": cams})

    return with_degradation(cfg, banks, eval_on, "eval_on")
