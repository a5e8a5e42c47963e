"""One chunk of participants a round in one engine call: share, combine and
reconstruct in a single launch (``aggregate_mxu8_kernel``)."""


def aggregate(engine, store, chunks, p_chunk, seed, lanes):
    (c,) = chunks
    return engine.aggregate_mxu8_kernel(store.chunk_rows(c), seed, p_count=p_chunk, lanes=lanes)
