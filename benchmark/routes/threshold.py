"""The resident chunks streamed onto a running accumulator, one launch each,
then the reveal from the clerks that reported: the reconstruction
threshold (``secret_count + privacy_threshold``) of the committee,
distinct and sorted, drawn from the round's kernel seed
(``aggregate_mxu8_kernel_streaming`` with ``clerks=``).

A round draws its chunks from more cohorts than int64 counts (128 of 80
resident), so loading this route installs :mod:`benchmark.core.wide_walk`."""

import numpy as np

from benchmark.core import wide_walk

wide_walk.install()

# participants a launch: the kernel's uint32 carry chain sums at most
# 65,793 operand rows, and at 728 clerks 128 participants make 128 x 400
# secret rows and 2,790 randomness rows, 53,990
LAUNCH = 128


def reporting_clerks(spec, seed: int) -> list[int]:
    count = spec.secret_count + spec.randomness_count
    return sorted(np.random.default_rng(seed).choice(spec.share_count, count, replace=False)
                  .tolist())


def aggregate(engine, store, chunks, p_chunk, seed, lanes):
    if p_chunk > LAUNCH:
        raise ValueError(f"a chunk of {p_chunk} passes the launch's {LAUNCH} participants")
    return engine.aggregate_mxu8_kernel_streaming([store.chunk_rows(c) for c in chunks], p_chunk,
                                                  seed0=seed, lanes=lanes,
                                                  clerks=reporting_clerks(engine.spec, seed))
