"""DSP stream ops and the hand-written kernels' wrappers."""
