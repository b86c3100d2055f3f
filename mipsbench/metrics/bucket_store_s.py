"""bucket_store_s: seconds of ``build_bucket_index`` in set-up (host
clock, ending in a synchronise): the host sort of the catalogue into
(range, code, id) order and the move of the store to the device."""


def read(r):
    return r.setup.get("bucket_store_s")
