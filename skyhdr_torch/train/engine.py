"""Model construction and the serving forward (`skyhdr.train.engine`:
`build_models`, `make_inference_fn`)."""

from __future__ import annotations

import torch

from skyhdr_torch.models.generator import Generator
from skyhdr_torch.models.gradcam import sunpose_with_cams
from skyhdr_torch.models.sunpose import SunPoseNet
from skyhdr_torch.ops.hdr import hdr_log_compression, hdr_log_decompression


def build_models(cfg, device="cpu"):
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
    act_dtype = (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
                 else torch.float32)

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
