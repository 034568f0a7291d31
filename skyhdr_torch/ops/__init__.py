"""The port's numeric ops (`skyhdr.ops`), re-exported under `skyhdr`'s
names: geometry, mu-law HDR and colour helpers, CRF application, the DoG
pyramid and losses, EMD, bilinear resize, the JPEG model and the
distortion-aware conv. The CUDA kernels (`ops.kernels`) are imported by
the ops that launch them, at their first call, and built there."""

from skyhdr_torch.ops.geometry import (  # noqa: F401
    positional_encoding,
    sphere2world,
    sunpose_bins,
    vmf_pdf,
)
from skyhdr_torch.ops.hdr import (  # noqa: F401
    bgr2rgb,
    hdr_log_compression,
    hdr_log_decompression,
    rgb2bgr,
    rgb2gray,
)
from skyhdr_torch.ops.crf import (  # noqa: F401
    apply_rf,
    apply_rf_chebyshev,
    chebyshev_fit,
    interp1d_batched,
)
from skyhdr_torch.ops.dog import (  # noqa: F401
    dog_l1_loss,
    dog_l1_loss_conv,
    dog_pyramid,
    gaussian_filter2d,
)
from skyhdr_torch.ops.emd import compare_luminance, wasserstein_1d  # noqa: F401
from skyhdr_torch.ops.resize import resize_bilinear  # noqa: F401
from skyhdr_torch.ops.jpeg import jpeg_simulate, quant_table  # noqa: F401
from skyhdr_torch.ops.distortion import (  # noqa: F401
    DAConv,
    DADeconv,
    deformable_conv2d,
    distortion_offsets,
    gather_tables,
)
