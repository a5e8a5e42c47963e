"""Floor probes: kernels that move a real kernel's bytes and nothing else.

Port of the no-op Pallas kernels of the reference's measurement tools
(``tools/measure_latency_floor.py``, ``measure_lane_batch_floor.py`` and
``measure_config3_variants.py``). Each tool times a probe beside the real
kernel to split a step into a launch floor, a copy floor and kernel work.
The probes are hand-written CUDA kernels (``csrc/probes.cu``):

- **T1** (:func:`probe_t1`): the floor of one B1 launch of the config-2
  single job; **T2** (:func:`probe_t2`): the same at the 512-job lane batch.
  Both launch B1's grid, one 256-thread block per 128 lanes, and each block
  reads the column slice of every row that B1 stages.
- **T3** (:func:`probe_t3`): the floor of one B2 call, through B2's split
  grid: ``NBP / 128`` lane blocks times ``splits`` blocks, block ``(b, s)``
  reading the 64-row tiles of split ``s`` of B2's partition
  (:func:`~sda_tpu_torch.ops.mxu8.split_ranges`) in lane block ``b``'s
  column slice; split 0 writes the output tile once.
- **T1'** (:func:`probe_t1_bare`): the bare launch floor, one block, a 1 KB
  input and a 4 KB output.

**Every byte is read.** The TPU copied each input block into VMEM whether
the kernel body read it or not; a GPU kernel moves only what it loads. So
each probe loads its whole input tile, folds it into an XOR, and writes one
XOR word per block to a ``sink`` beside the seed-filled output. The XOR of
the sinks equals the XOR of the input read as uint32 words
(:func:`xor_words`): that check proves the copy floor is real.

Outputs are int32 tensors holding the uint32 bit patterns. Each wrapper runs
the kernel for a CUDA tensor and its plain version for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from sda_tpu_torch.ops.mxu8 import KT, split_ranges

__all__ = [
    "probe_t1",
    "probe_t1_bare",
    "probe_t2",
    "probe_t3",
    "xor_words",
    "probe_bytes",
    "library_probe",
    "KERNEL_VARIANTS",
]

_T = 128  # lanes per block: B1 and B2's tile
_M32 = 0xFFFFFFFF

# Launches of each probe (one per call on a CUDA tensor).
probe_launches = {"probe_t1": 0, "probe_t1_bare": 0, "probe_t2": 0, "probe_t3": 0}

# The probes' build of csrc/probes.cu: name -> (source, defines).
KERNEL_VARIANTS = {"probes": ("probes.cu", ())}


def _i32(seed: int) -> int:
    """The int32 whose bits are ``seed mod 2^32``."""
    seed &= _M32
    return seed - (1 << 32) if seed > 0x7FFFFFFF else seed


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of ``x`` along ``dim`` (a halving tree)."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        head = x[:half] ^ x[half : 2 * half]
        x = torch.cat([head, x[2 * half :]]) if x.shape[0] % 2 else head
    return x[0]


def xor_words(x: torch.Tensor) -> int:
    """XOR of every 32-bit word of ``x``'s bytes (little-endian), as an int
    in ``[0, 2^32)``: what the XOR of a probe's sinks must equal."""
    words = x.contiguous().view(-1).view(torch.int32)
    return int(_xor_reduce(words, 0)) & _M32


def _sink_plain(x: torch.Tensor, n_chunks: int = 1, splits: int | None = None) -> torch.Tensor:
    """Per 128-lane block, the XOR of the block's column slice over every
    row; with ``splits`` (T3), per block ``(split s, lane block b)`` in that
    order, over the rows of split ``s``'s pieces of B2's partition."""
    rows, nbp = x.shape
    words = x.contiguous().view(torch.int32).view(rows, nbp // _T, _T // 4)
    if splits is None:
        return _xor_reduce(_xor_reduce(words, 2), 0)
    rows_c = rows // n_chunks
    zero = torch.zeros(nbp // _T, dtype=torch.int32, device=x.device)
    sinks = []
    for pieces in split_ranges(-(-rows_c // KT), n_chunks, splits):
        acc = zero
        for c, b, e in pieces:
            r0, r1 = c * rows_c + b * KT, c * rows_c + min(e * KT, rows_c)
            acc = acc ^ _xor_reduce(_xor_reduce(words[r0:r1], 2), 0)
        sinks.append(acc)
    return torch.cat(sinks)


def _check_lanes(x: torch.Tensor, n_chunks: int):
    if x.dtype != torch.int8 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("a probe's input must be a contiguous 2-D int8 tensor")
    rows, nbp = x.shape
    if nbp < _T or nbp % _T:
        raise ValueError(f"NBP={nbp} must be a positive multiple of {_T}")
    if n_chunks < 1 or rows % n_chunks or rows == 0:
        raise ValueError("the input's rows must divide evenly into n_chunks >= 1")


def _lib():
    from sda_tpu_torch.ops.cuda_build import load_kernel_library

    lib = load_kernel_library(*KERNEL_VARIANTS["probes"])
    lib.sda_probe_lanes.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.sda_probe_lanes.restype = ctypes.c_int
    lib.sda_probe_bare.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]
    lib.sda_probe_bare.restype = ctypes.c_int
    return lib


def _lanes(x: torch.Tensor, out_rows: int, seed: int, n_chunks: int, splits: int | None,
           name: str):
    """T1/T2 (``splits`` None) and T3: ``(out [out_rows, NBP] int32 filled
    with seed, sink [NBP / 128] int32, T3: [splits * NBP / 128])``."""
    _check_lanes(x, n_chunks)
    if splits is not None and splits < 1:
        raise ValueError("splits must be >= 1")
    rows, nbp = x.shape
    out = torch.empty((out_rows, nbp), dtype=torch.int32, device=x.device)
    if x.device.type == "cpu":
        out.fill_(_i32(seed))
        return out, _sink_plain(x, n_chunks, splits)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    sink = torch.empty((splits or 1) * (nbp // _T), dtype=torch.int32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sda_probe_lanes(x.data_ptr(), rows // n_chunks, n_chunks, nbp, out.data_ptr(),
                                  out_rows, seed & _M32, sink.data_ptr(), int(splits is not None),
                                  splits or 1, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    probe_launches[name] += 1
    return out, sink


def probe_t1(x: torch.Tensor, out_rows: int, seed: int):
    """T1: B1's grid over one job's ``[rows, NBP]`` planar operand."""
    return _lanes(x, out_rows, seed, 1, None, "probe_t1")


def probe_t2(x: torch.Tensor, out_rows: int, seed: int):
    """T2: B1's grid over a lane batch's ``[rows, NBP]`` planar operand."""
    return _lanes(x, out_rows, seed, 1, None, "probe_t2")


def probe_t3(x: torch.Tensor, out_rows: int, n_chunks: int, seed: int, splits: int):
    """T3: B2's split grid over ``n_chunks`` stacked chunks, ``splits`` the
    split count of the B2 call it stands for
    (:func:`~sda_tpu_torch.ops.mxu8.launch_splits`); split 0 of each lane
    block writes its output tile once."""
    return _lanes(x, out_rows, seed, n_chunks, splits, "probe_t3")


def probe_t1_bare(x: torch.Tensor, out_words: int, seed: int):
    """T1': one block reads all of ``x`` (a multiple of 16 bytes) and writes
    ``out_words`` (a multiple of 4) words of ``seed``: ``(out [out_words]
    int32, sink [1] int32)``."""
    if not x.is_contiguous() or (x.numel() * x.element_size()) % 16 or out_words % 4:
        raise ValueError("T1' takes a contiguous input of 16-byte words and 4-word outputs")
    out = torch.empty(out_words, dtype=torch.int32, device=x.device)
    if x.device.type == "cpu":
        out.fill_(_i32(seed))
        return out, torch.tensor([_i32(xor_words(x))], dtype=torch.int32)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    sink = torch.empty(1, dtype=torch.int32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sda_probe_bare(x.data_ptr(), x.numel() * x.element_size(), out.data_ptr(),
                                 out_words, seed & _M32, sink.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"probe_t1_bare launch failed: cudaError {err}")
    probe_launches["probe_t1_bare"] += 1
    return out, sink


def probe_bytes(x: torch.Tensor, out: torch.Tensor, sink: torch.Tensor) -> int:
    """The bytes a probe must move: its input read once, its output and sink
    written once."""
    return sum(t.numel() * t.element_size() for t in (x, out, sink))


def library_probe(x: torch.Tensor, out: torch.Tensor, seed: int) -> torch.Tensor:
    """The same bytes through PyTorch's own kernels: one streaming read of
    ``x`` (a sum of its words) and a fill of ``out``; a yardstick beside the
    probes, used by nothing else."""
    total = x.view(torch.int32).sum(dtype=torch.int64)
    out.fill_(_i32(seed))
    return total
