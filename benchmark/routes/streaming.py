"""Chunks streamed from the resident store, one engine launch each onto a
running accumulator, then the reconstruction
(``aggregate_mxu8_kernel_streaming``)."""


def aggregate(engine, store, chunks, p_chunk, seed, lanes):
    return engine.aggregate_mxu8_kernel_streaming([store.chunk_rows(c) for c in chunks], p_chunk,
                                                  seed0=seed, lanes=lanes)
