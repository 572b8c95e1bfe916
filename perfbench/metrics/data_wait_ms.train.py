"""data_wait_ms.train: the carousel's delivery, as the trainer waits on
it: the mean host time a window step spends in ``next()`` on the
delivery (``DeliveryIterator`` and the device copy), in ms."""


def read(rec):
    steps = rec.steps if rec.kind == "train" else []
    if not steps:
        return None
    return 1e3 * sum(s["wait_s"] for s in steps) / len(steps)
