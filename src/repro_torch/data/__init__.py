"""Synthetic MIPS datasets drawn on the device, the trainer's token
corpus and ALS factorization."""
