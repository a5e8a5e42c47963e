"""From process start to the first measured round: imports, the CUDA
context, kernels built or loaded, the inputs made from the seed and the
warm-up rounds."""


def read(record):
    return record.setup_s
