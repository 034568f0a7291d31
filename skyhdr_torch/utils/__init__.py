"""Host-side utilities (`skyhdr.utils`): the exposure sweep, the DoRF
curves and their inverse, the .hdr codec, run directories; beside them the
weight transplant, dtype casts, .png I/O and the checkpoint export format."""

from skyhdr_torch.utils.io import (  # noqa: F401
    get_exposure_lists,
    inverse_rf,
    load_dorf_curves,
    read_hdr,
    write_hdr,
)
from skyhdr_torch.utils.dirs import create_new_dir, timestamp  # noqa: F401
