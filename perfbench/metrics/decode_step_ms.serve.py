"""decode_step_ms.serve: the decode phases' host time (from a batch's
first tokens on the host to all of its tokens there) over the decode
steps they ran, in ms."""


def read(rec):
    batches = rec.batches if rec.kind == "serve" else []
    steps = sum(rec.shape["gen_tokens"] - 1 for _ in batches)
    if not batches or steps == 0:
        return None
    return 1e3 * sum(b["t_done"] - b["t_first"] for b in batches) / steps
