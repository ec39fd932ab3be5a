"""Forward error correction: convolutional code + Viterbi, Reed-Solomon."""
