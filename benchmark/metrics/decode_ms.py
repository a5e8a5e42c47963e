"""The benchmark's host-clock span around the round's ``decode`` call,
closed by a device synchronize, averaged over the traced rounds."""


def read(record):
    spans = record.spans.get("decode")
    return sum(spans) / len(spans) * 1e3 if spans else None
