"""Wideband captures, one module a kind, found by the ``capture.kind`` of
a configuration: ``make(cfg, n, seed, device)`` returns ``n`` complex64
samples at the configuration's rate, made on ``device`` from ``seed``."""
