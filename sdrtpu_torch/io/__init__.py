"""File IQ ingest, audio egress and soft-symbol (.s) files."""

from . import symbols, wav  # noqa: F401
