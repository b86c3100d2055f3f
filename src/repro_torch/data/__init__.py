"""Synthetic MIPS datasets drawn on the device."""
