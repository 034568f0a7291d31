"""Entry point twin of `__graft_entry__.entry`: the serving forward on the
flagship model (the default config, 32x128 with plain convs) and its
example arguments."""

from __future__ import annotations

import torch

from skyhdr_torch.config import Config


def entry(device: str = "cuda"):
    """(fn, (gen, sun, ldr)) with fn(gen, sun, ldr) -> y_final_lin [b,h,w,3];
    the weights are those of `skyhdr`'s `create_gan_state(Config(),
    PRNGKey(0))`, as `__graft_entry__.entry` takes them."""
    from skyhdr_torch.train.engine import build_models, gan_init_keys, make_inference_fn
    from skyhdr_torch.utils.transplant import draw_model_vars

    cfg = Config()  # reference resolution 32x128
    gen, sun = build_models(cfg, device)
    gen_key, sun_key, _ = gan_init_keys(0)
    draw_model_vars(gen, gen_key)
    draw_model_vars(sun, sun_key)
    infer = make_inference_fn(cfg)
    ldr = torch.zeros((1, cfg.model.im_height, cfg.model.im_width, 3),
                      dtype=torch.float32, device=device)

    def fn(gen, sun, x):
        return infer(gen, sun, x)["y_final_lin"]

    return fn, (gen, sun, ldr)
