"""Bit-level decoders: CCSDS frames (Meteor LRPT) and RDS."""
