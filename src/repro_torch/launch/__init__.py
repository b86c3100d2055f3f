"""Serving and training launchers (ports of ``repro/launch/serve.py``,
``train.py`` and ``runtime.py``)."""
