"""Decoder-only LM stack and the LSH-decode vocabulary head (port of
``repro/models``: the dense attention-only family)."""
