"""flash_roofline.prefill: the attention of the prefills traced after the
window (a forward a layer over the cache, ``ops/flash_fwd.py``), its
least time at the chip's peaks over the flash kernels' device time, in
percent."""


def read(rec):
    return rec.roofline(("flash_fwd",)) if rec.kind == "serve" else None
