"""Grad-CAM (`skyhdr.models.gradcam`), serving and training forms.

The CAM gradient is d(sum_b y_c)/d(activation): one backward pass of a
one-hot seed at argmax(sm) (at argmax(sunpose_gt) in training), taken with
`torch.autograd.grad` w.r.t. zero perturbations added to the three
activations (the derivative at eps = 0 is the derivative w.r.t. the
activation). cam = relu(sum_c mean_hw(grad)_c * A_c), one channel. The
pull asks for the activations' gradients only, so the DA layers' backward
runs dx alone there (`input_grads_only`), even when the weights require
gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from skyhdr_torch.ops.kernels.deform_conv import input_grads_only


def yc_seed(sm: torch.Tensor, sunpose_gt=None) -> torch.Tensor:
    """One-hot [b, bins] at argmax(sm), or at argmax(sunpose_gt) if given."""
    src = sm if sunpose_gt is None else sunpose_gt
    idx = torch.argmax(src, dim=-1, keepdim=True)
    # scatter, not F.one_hot: one_hot range-checks on the host, a device sync.
    return torch.zeros_like(sm).scatter_(-1, idx, 1.0)


def cam_from_grad(grad: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """relu(einsum('bc,bhwc->bhw')) with GAP channel weights -> [b, h, w, 1]."""
    weights = grad.mean(dim=(1, 2))
    cam = torch.einsum("bc,bhwc->bhw", weights, act)
    return F.relu(cam)[..., None]


def sunpose_with_cams(sun, x: torch.Tensor, act_dtype: torch.dtype,
                      sunpose_gt=None, keep_graph: bool = False):
    """Run the sun-pose net once and build the three Grad-CAM maps from
    that forward.

    `act_dtype` is the dtype of the activations (the compute dtype).
    Returns (sm [b, bins], (cam1, cam2, cam3)). The CAMs carry no gradient.
    `sm` is detached, unless `keep_graph` (training): then it stays on the
    forward's graph, so an outer loss differentiates the sun-pose net
    through `sm` only."""
    with torch.enable_grad():
        eps = tuple(torch.zeros(s, dtype=act_dtype, device=x.device,
                                requires_grad=True)
                    for s in sun.activation_shapes(x.shape[0]))
        sm, acts = sun(x, eps)
        with input_grads_only():
            deps = torch.autograd.grad(sm, eps, retain_graph=keep_graph,
                                       grad_outputs=yc_seed(sm.detach(), sunpose_gt))
    cams = tuple(cam_from_grad(g, a.detach()) for g, a in zip(deps, acts))
    return (sm if keep_graph else sm.detach()), cams
