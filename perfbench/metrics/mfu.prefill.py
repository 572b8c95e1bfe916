"""mfu.prefill: the prefills' share of the cards' bf16 dense peak, in
percent: the model FLOPs of the window's prefills over their host time
(from a batch's sending to its first tokens on the host), over the peak
of all the cards the cell runs on."""


def read(rec):
    batches = rec.batches if rec.kind == "serve" else []
    if not batches:
        return None
    flops = sum(rec.forward_flops(b["rows"], b["len"]) for b in batches)
    spent = sum(b["t_first"] - b["t_send"] for b in batches)
    return 100.0 * flops / spent / (
        rec.cell.chips * rec.peaks["bf16_dense_flops_per_s"])
