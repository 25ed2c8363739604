"""Peak bytes allocated on the card over the training window
(torch.cuda.max_memory_allocated from the window's start), in GB."""


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec.get("peak_bytes") else None
