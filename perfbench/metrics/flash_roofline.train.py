"""flash_roofline.train: the attention that the steps traced after the
window need (a forward writing ``lse`` and a backward a layer, counted
once by the frozen formulas of ``ops/flash_fwd.py`` and
``ops/flash_bwd.py``), its least time at the chip's peaks over the
device time of the flash kernels (the recompute's forward included), in
percent."""


def read(rec):
    return rec.roofline(("flash_fwd", "flash_bwd")) \
        if rec.kind == "train" else None
