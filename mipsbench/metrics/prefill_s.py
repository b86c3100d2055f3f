"""prefill_s: seconds set-up spends prefilling the batch's prompts into
the caches (``BatchedServer.prefill``, host clock, ending in a
synchronise)."""


def read(r):
    return r.setup.get("prefill_s")
