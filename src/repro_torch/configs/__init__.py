"""Model configurations (port of ``repro/configs``): the same
published hyper-parameters, as plain dataclasses."""
