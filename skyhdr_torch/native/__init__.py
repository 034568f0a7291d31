"""Native (C) runtime pieces of the port, built lazily with the system
compiler and loaded via ctypes: the masked CRC32C of TFRecord framing (a
copy of `skyhdr.native`). Without a C compiler a pure-Python CRC takes over,
which is slow (about a second per 200 KB record)."""

from skyhdr_torch.native.build import crc32c, has_native, masked_crc32c  # noqa: F401
