"""mfu.train: the whole training step's share of the chip's bf16 dense
peak, in percent: the model FLOPs of the window's steps (three
forwards' worth: the forward and a backward of twice its work; the
recompute of remat not counted) over their host time."""


def read(rec):
    steps = rec.steps if rec.kind == "train" else []
    if not steps:
        return None
    flops = 3.0 * rec.forward_flops(rec.shape["rows"], rec.shape["seq_len"])
    spent = steps[-1]["t1"] - steps[0]["t0"]
    return 100.0 * flops * len(steps) / spent \
        / rec.peaks["bf16_dense_flops_per_s"]
