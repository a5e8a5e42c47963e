"""The benchmark's host-clock span around the round's ``mask_combine`` call,
closed by a device synchronize, averaged over the traced rounds."""


def read(record):
    spans = record.spans.get("mask_combine")
    return sum(spans) / len(spans) * 1e3 if spans else None
