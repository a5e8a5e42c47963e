"""The measured window over the rounds completed in it."""


def read(record):
    if record.trace is not None or not record.rounds:
        return None
    return record.window_s / record.rounds * 1e3
