"""ssd_roofline.train: the SSD scan that the steps traced after the window
need (a forward and a backward a Mamba2 layer, ``ops/ssd_fwd.py`` and
``ops/ssd_bwd.py``), its least time at the chip's peaks over the device
time of the SSD kernels (the recompute's forward included), in
percent."""


def read(rec):
    return rec.roofline(("ssd_fwd", "ssd_bwd")) \
        if rec.kind == "train" else None
