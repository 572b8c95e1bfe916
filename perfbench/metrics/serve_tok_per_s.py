"""serve_tok_per_s: the prompt and generated tokens of every request
completed in the window, over the whole window."""


def read(rec):
    if rec.kind != "serve" or not rec.batches:
        return None
    gen = rec.shape["gen_tokens"]
    return sum(b["rows"] * (b["len"] + gen) for b in rec.batches) \
        / rec.window_s
