"""train_tok_per_s: the tokens of every training step completed in the
window, over the whole window (which closes at the end of the step in
flight once ``--seconds`` have passed)."""


def read(rec):
    if rec.kind != "train" or not rec.steps:
        return None
    return sum(s["tokens"] for s in rec.steps) / rec.window_s
