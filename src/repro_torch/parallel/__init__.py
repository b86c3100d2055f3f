"""Cost models of a model step (port of ``repro/parallel``): the analytic
FLOP/byte model and the roofline against the card's peaks."""
