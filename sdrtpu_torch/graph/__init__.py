"""Stream-op protocol and chain composition."""

from .block import Chain, StreamOp  # noqa: F401
