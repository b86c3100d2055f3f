"""calibrate_s: seconds of ``planner.calibrate`` in set-up (host clock,
ending in a synchronise): the held-out queries' exact top-k and their
positions in the probe order."""


def read(r):
    return r.setup.get("calibrate_s")
