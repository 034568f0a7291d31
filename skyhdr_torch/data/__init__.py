"""The data layer (`skyhdr.data`): the TFRecord codec, the Laval
extraction, the host input pipeline and the on-device degradation."""

from skyhdr_torch.data.degradation import (  # noqa: F401
    DegradationBanks,
    degrade_batch,
    make_banks,
)
from skyhdr_torch.data.records import (  # noqa: F401
    decode_example,
    encode_example,
    read_tfrecord_examples,
    write_tfrecord,
)
from skyhdr_torch.data.pipeline import PanoramaDataset, prepare_sample  # noqa: F401
