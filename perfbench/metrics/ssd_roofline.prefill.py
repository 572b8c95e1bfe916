"""ssd_roofline.prefill: the SSD scans of the prefills traced after the
window (a forward a Mamba2 layer over the batch's tokens,
``ops/ssd_fwd.py``), their least time at the chip's peaks over the
device time of the SSD kernels (decode's single-token step launches
none), in percent."""


def read(rec):
    return rec.roofline(("ssd_fwd",)) if rec.kind == "serve" else None
