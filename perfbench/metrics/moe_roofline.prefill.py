"""moe_roofline.prefill: the routed expert products of the prefills traced
after the window (a grouped call an MoE layer over the batch's tokens,
``ops/moe_experts.py``), their least time at the chip's peaks over the
device time of the grouped prefill kernels, in percent."""


def read(rec):
    return rec.roofline(("moe_experts",)) if rec.kind == "serve" else None
