"""Serving launcher (port of ``repro/launch/serve.py``)."""
