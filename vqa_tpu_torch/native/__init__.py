"""Native (C++) host components of the port, built with g++ at first use and
loaded with ctypes: the batched JPEG decoder (:mod:`.jpeg`)."""

from .jpeg import decode_batch_native, native_available

__all__ = ["decode_batch_native", "native_available"]
