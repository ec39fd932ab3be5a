"""File IQ ingest and audio egress."""

from . import wav  # noqa: F401
